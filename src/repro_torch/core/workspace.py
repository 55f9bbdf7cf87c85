"""Fused metadata workspace and the shared workspace arena (OpSparse
§5.3–§5.5), the port of ``repro/core/workspace.py``.

The paper sums up the binning metadata (the ``bins`` array, ``bin_size``,
``bin_offset``, the max-row-size cell) and allocates it with ONE
``cudaMalloc``.  :class:`WorkspacePlan` is that layout, and
:func:`bin_rows_into` writes both binning passes into the one int32 buffer
it is given, in place (the reference donates the buffer to XLA instead).

Layout (int32 cells):   [ bins : M | bin_size : NB | bin_offset : NB | max : 1 ]

The second half generalizes the discipline across PLANS: an :class:`Arena`
of pow-2-size-bucketed device buffers that specialized plans *lease* at
dispatch and return at finalize.  A leased pair is the storage of the
steady state's product expansion (``core/esc.expand_products(out=...)``),
so one block of device memory serves request after request of every plan
in its size bucket: the §5.4 alloc/exec overlap, process-wide instead of
per plan.  The arena keeps exact host-side byte accounting (in use,
reserved, peak, lease hit/miss) so a memory governor
(:class:`repro_torch.engine.autotune.MemoryGovernor`) can bound the total
and degrade gracefully under pressure.
"""
from __future__ import annotations

import dataclasses
import threading
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.binning_histogram import binning_histogram

from .binning import Binning, classify
from .csr import Device, resolve_device


def next_bucket(n: int, *, minimum: int = 16) -> int:
    """Pow-2 shape bucket: bounds padding waste (<2x) and the number of
    distinct static shapes a plan can take.

    The ONE shared copy: storage/capacity buckets, the hash drivers'
    per-rung row-count buckets (``minimum=8``), the engine's progressive
    allocation and the arena's free lists all bucket through here.
    """
    b = minimum
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class WorkspacePlan:
    """The fused metadata layout of one binning: (M, NUM_BIN) alone fix
    it."""

    m: int
    num_bins: int

    @property
    def size(self) -> int:
        return self.m + 2 * self.num_bins + 1

    def alloc(self, device: Device = "cuda") -> torch.Tensor:
        """The single fused allocation."""
        return torch.zeros(self.size, dtype=torch.int32,
                           device=resolve_device(device))

    def views(self, buf: torch.Tensor) -> Binning:
        m, nb = self.m, self.num_bins
        return Binning(
            bins=buf[:m],
            bin_size=buf[m:m + nb],
            bin_offset=buf[m + nb:m + 2 * nb],
            bin_of_row=torch.zeros(m, dtype=torch.int32, device=buf.device),
            max_size=buf[m + 2 * nb],
        )


def bin_rows_into(sizes: torch.Tensor,
                  buf: torch.Tensor, *,  # opslint: donates=buf
                  upper: Tuple[int, ...], num_bins: int,
                  m: int) -> torch.Tensor:
    """Two-pass binning writing ALL metadata into the fused buffer ``buf``,
    in place; returns ``buf``.

    The math of ``binning.bin_rows``.  Pass 1 (rows per rung and the
    largest row) is the ``binning_histogram`` kernel on a CUDA tensor,
    which writes straight into the ``bin_size`` and ``max`` cells, and its
    plain version on a CPU tensor.  The offsets are an exclusive sum and
    pass 2 the stable counting-sort scatter, as tensor ops.
    """
    nb = num_bins
    if sizes.shape != (m,):
        raise ValueError(f"sizes must have shape ({m},), got "
                         f"{tuple(sizes.shape)}")
    if (buf.dtype != torch.int32 or buf.shape != (m + 2 * nb + 1,)
            or not buf.is_contiguous() or buf.device != sizes.device):
        raise ValueError(
            f"buf must be a contiguous ({m + 2 * nb + 1},) int32 tensor on "
            f"{sizes.device}, got {tuple(buf.shape)} {buf.dtype} on "
            f"{buf.device}")
    bin_size, bin_offset = buf[m:m + nb], buf[m + nb:m + 2 * nb]
    binning_histogram(sizes, upper=upper, num_bins=nb,
                      out=(bin_size, buf[m + 2 * nb]))
    bin_offset[:1] = 0
    torch.cumsum(bin_size[:-1], 0, dtype=torch.int32, out=bin_offset[1:])
    buf[:m] = torch.argsort(classify(sizes, upper), stable=True)
    return buf


def binning_from_buffer(buf: torch.Tensor, sizes: torch.Tensor,
                        plan: WorkspacePlan, upper) -> Binning:
    """The :class:`Binning` whose arrays are views of a filled buffer."""
    m, nb = plan.m, plan.num_bins
    return Binning(
        bins=buf[:m],
        bin_size=buf[m:m + nb],
        bin_offset=buf[m + nb:m + 2 * nb],
        bin_of_row=classify(sizes, upper),
        max_size=buf[m + 2 * nb],
    )


# ---------------------------------------------------------------------------
# Shared size-bucketed workspace arena (§5.4 alloc/exec overlap, plan-wide).
# ---------------------------------------------------------------------------

class ArenaPressureError(RuntimeError):
    """The governor cap left no room for a workspace lease and every
    degradation rung (reclaim, forced trim, fused->two-pass spill) was
    exhausted: the caller must apply backpressure (finalize in-flight
    work to return leases) or raise the cap."""


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown value dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class LeaseSpec:
    """Size class of one plan's leased workspace: an int32 buffer (the
    expansion's row and column ids) plus a value-dtype buffer (the
    expansion's products), both in pow-2 cell counts so same-bucket plans
    share the arena's free-list entries.  ``val_dtype`` is spelled as the
    reference spells it (``"float32"``)."""

    i32_cells: int
    val_cells: int
    val_dtype: str

    @property
    def nbytes(self) -> int:
        return (4 * int(self.i32_cells)
                + _torch_dtype(self.val_dtype).itemsize * int(self.val_cells))


def _lease_device(device: Optional[Device]) -> torch.device:
    """The device a lease's buffers live on: the card unless the caller
    names another; a CUDA device without an index is the current one."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Lease:
    """One checked-out workspace (a pair of device buffers).

    Lifecycle: ``active`` from :meth:`Arena.acquire` until either
    :meth:`Arena.release` (buffers recycled into the free lists) or
    :meth:`Arena.forfeit` (cache eviction while in flight: the buffers may
    still be written by queued device work, so they are *dropped from
    accounting* rather than recycled: recycling them would hand a buffer
    still in use to the next plan).
    """

    __slots__ = ("spec", "i32", "val", "state", "device", "keys")

    def __init__(self, spec: LeaseSpec, i32: torch.Tensor, val: torch.Tensor,
                 device: Optional[torch.device] = None, keys=None):
        self.spec = spec
        self.i32 = i32
        self.val = val
        self.state = "active"
        self.device = device    # free-list key part: buffers are per device
        # Free-list keys, computed once at acquire: release/forfeit sit on
        # the per-request hot path.
        self.keys = keys if keys is not None else Arena._buckets(spec, device)

    @property
    def active(self) -> bool:
        return self.state == "active"


class Arena:
    """Process-wide pool of pow-2-bucketed workspace buffers.

    Free lists are keyed by ``(dtype, pow-2 cell bucket, device)``;
    acquiring a spec whose buckets have idle buffers is a *lease hit* (zero
    new bytes), otherwise the missing buffers are allocated (a *miss*) and
    counted against ``bytes_reserved``.  All accounting is host-side Python
    int (exact, wrap-proof):

      bytes_in_use    bytes leased out right now (dispatch -> finalize)
      bytes_free      idle bytes parked in the free lists
      bytes_reserved  in_use + free: what the arena holds in device
                      memory, the quantity a governor cap bounds
      peak_bytes      high-water mark of ``bytes_in_use``
                      (:meth:`reset_peak` re-arms it after warmup)

    Thread-safe; the engine serializes leases per dispatch but caches may
    force-release (:meth:`forfeit`) from another thread.
    """

    def __init__(self, *, faults=None):
        # ``faults`` threads a ``repro_torch.core.faults.FaultPlan`` through
        # the arena: a scheduled ``lease_denial`` makes try_acquire behave
        # as if the cap were binding.  (The engine consults its own plan at
        # the same site; attach a plan to the arena OR the engine, not
        # both, or the site's visit counter advances twice per
        # acquisition.)
        self.faults = faults
        self._lock = threading.Lock()
        self._free: Dict[Tuple, List[torch.Tensor]] = {}  # guarded-by: _lock
        self.bytes_in_use = 0       # guarded-by: _lock
        self.bytes_free = 0         # guarded-by: _lock
        self.peak_bytes = 0         # guarded-by: _lock
        self.lease_hits = 0         # guarded-by: _lock
        self.lease_misses = 0       # guarded-by: _lock
        self.pressure_events = 0    # guarded-by: _lock

    # -- introspection ------------------------------------------------------
    @property
    def bytes_reserved(self) -> int:
        return self.bytes_in_use + self.bytes_free

    @property
    def hit_rate(self) -> float:
        total = self.lease_hits + self.lease_misses
        return self.lease_hits / total if total else 0.0

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_bytes = self.bytes_in_use

    # -- lease lifecycle ----------------------------------------------------
    @staticmethod
    @lru_cache(maxsize=1024)
    def _buckets(spec: LeaseSpec, device: Optional[torch.device] = None):
        """Free-list keys for a spec (memoized: specs are as few as the
        cached plans)."""
        dtype = str(_torch_dtype(spec.val_dtype)).removeprefix("torch.")
        return (("int32", next_bucket(max(int(spec.i32_cells), 1)), device),
                (dtype, next_bucket(max(int(spec.val_cells), 1)), device))

    @staticmethod
    @lru_cache(maxsize=64)
    def _bucket_bytes(key) -> int:
        return _torch_dtype(key[0]).itemsize * key[1]

    def try_acquire(self, spec: LeaseSpec,
                    cap_bytes: Optional[int] = None,
                    device: Optional[Device] = None) -> Optional[Lease]:
        """Lease a buffer pair, or ``None`` when allocating the missing
        buffers would push ``bytes_reserved`` past ``cap_bytes``.  A spec
        fully served from the free lists always succeeds (no new bytes),
        even over an already-exceeded cap: reuse never makes things worse.
        New buffers are ``torch.empty`` on ``device`` (the card when
        ``None``; raises without one); free lists are per device, so a
        buffer never migrates between devices through the pool."""
        if self.faults is not None \
                and self.faults.fire("lease_denial") is not None:
            return None
        dev = _lease_device(device)
        keys = self._buckets(spec, dev)
        with self._lock:
            free = [self._free.get(k) for k in keys]
            need_new = sum(self._bucket_bytes(k)
                           for k, f in zip(keys, free) if not f)
            if need_new and cap_bytes is not None \
                    and self.bytes_reserved + need_new > cap_bytes:
                return None
            bufs = []
            for k, f in zip(keys, free):
                if f:
                    bufs.append(f.pop())
                    self.bytes_free -= self._bucket_bytes(k)
                    self.lease_hits += 1
                else:
                    bufs.append(torch.empty(k[1], dtype=_torch_dtype(k[0]),
                                            device=dev))
                    self.lease_misses += 1
                self.bytes_in_use += self._bucket_bytes(k)
            self.peak_bytes = max(self.peak_bytes, self.bytes_in_use)
            return Lease(spec, bufs[0], bufs[1], device=dev, keys=keys)

    def acquire(self, spec: LeaseSpec, cap_bytes: Optional[int] = None,
                device: Optional[Device] = None) -> Lease:
        lease = self.try_acquire(spec, cap_bytes, device)
        if lease is None:
            raise ArenaPressureError(
                f"lease of {spec.nbytes} bytes would exceed the governor "
                f"cap ({cap_bytes} bytes; {self.bytes_reserved} reserved)")
        return lease

    def release(self, lease: Lease,
                rebind: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> None:
        """Return a lease's buffers to the free lists.

        ``rebind`` replaces the buffers that are recycled (the reference
        recycles the arrays its executable returned in place of the
        donated ones; the port's pipelines write the leased buffers in
        place and pass none).  Idempotent, and a no-op for a lease the
        cache already forfeited."""
        with self._lock:
            if not lease.active:
                return
            lease.state = "released"
            if rebind is not None:
                lease.i32, lease.val = rebind
            for key, buf in zip(lease.keys, (lease.i32, lease.val)):
                self._free.setdefault(key, []).append(buf)
                nbytes = self._bucket_bytes(key)
                self.bytes_in_use -= nbytes
                self.bytes_free += nbytes

    def forfeit(self, lease: Lease) -> int:
        """Drop an in-flight lease from accounting WITHOUT recycling its
        buffers (cache eviction: queued device work may still write them).
        The memory returns to torch's allocator when the last reference to
        the buffers goes; the later :meth:`release` at finalize is a no-op.
        Returns the bytes dropped."""
        with self._lock:
            if not lease.active:
                return 0
            lease.state = "forfeited"
            nbytes = sum(self._bucket_bytes(k) for k in lease.keys)
            self.bytes_in_use -= nbytes
            return nbytes

    def reclaim(self) -> int:
        """Drop every idle free-list buffer (pressure rung 0); returns the
        bytes given back to torch's allocator."""
        with self._lock:
            freed = self.bytes_free
            self._free.clear()
            self.bytes_free = 0
            return freed

    def note_pressure(self) -> None:
        with self._lock:
            self.pressure_events += 1


# The process-wide default arena: every engine not handed an explicit Arena
# shares this one, so multi-engine traffic in one process is memory-bounded
# TOGETHER.
_DEFAULT_ARENA: Optional[Arena] = None
_DEFAULT_ARENA_LOCK = threading.Lock()


def default_arena() -> Arena:
    global _DEFAULT_ARENA
    with _DEFAULT_ARENA_LOCK:
        if _DEFAULT_ARENA is None:
            _DEFAULT_ARENA = Arena()
        return _DEFAULT_ARENA


def reset_default_arena() -> None:
    """Drop the shared arena (tests that need clean accounting)."""
    global _DEFAULT_ARENA
    with _DEFAULT_ARENA_LOCK:
        _DEFAULT_ARENA = None
