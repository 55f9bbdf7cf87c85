"""CSR sparse-matrix container (frozen dataclass of torch tensors).

The paper (OpSparse §2.1.1) uses CSR for A, B and C.  As in the reference
package, ``col``/``val`` may be *padded* beyond the true number of nonzeros
so that operands in one pow-2 capacity bucket present identical shapes; the
authoritative nnz is ``rpt[-1]`` (a device value).  Padded ``col`` entries
are 0 and padded ``val`` entries are 0, so a masked consumer that forgets
the mask still gathers in bounds.

Index arrays are stored as int32, like the reference (x64 disabled); they
are widened to int64 only where torch indexes with them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """The device an entry point builds on; CUDA unless the caller asks
    for the CPU.  A CUDA request on a machine without a card raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix.

    Attributes:
      rpt:   (M+1,) int32 row pointers.  ``rpt[-1]`` is the true nnz.
      col:   (cap,) int32 column indices, ``cap >= nnz`` (padded with 0).
      val:   (cap,) values, same cap (padded with 0).
      shape: (M, N).
    """

    rpt: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        """Storage capacity (>= true nnz)."""
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col.device

    def nnz(self) -> torch.Tensor:
        """True number of nonzeros (device scalar)."""
        return self.rpt[-1]

    def nnz_per_row(self) -> torch.Tensor:
        """(M,) int32 row sizes: what the paper calls n_nz per row."""
        return self.rpt[1:] - self.rpt[:-1]

    def entry_mask(self) -> torch.Tensor:
        """(cap,) bool: True for real entries, False for padding."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.nnz()

    def row_ids(self) -> torch.Tensor:
        """(cap,) int32 row index of every stored entry (M for padding)."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.device)
        rows = torch.searchsorted(self.rpt, idx, right=True,
                                  out_int32=True) - 1
        return torch.where(self.entry_mask(), rows,
                           torch.full_like(rows, self.nrows))

    # -- conversions ---------------------------------------------------------
    @classmethod
    def from_numpy(cls, rpt, col, val, shape, *,
                   device: Device = "cuda") -> "CSR":
        """CSR from host arrays (rpt/col become int32, val keeps its type)."""
        dev = resolve_device(device)
        val = np.asarray(val)
        return cls(
            rpt=torch.from_numpy(np.asarray(rpt, np.int32).copy()).to(dev),
            col=torch.from_numpy(np.asarray(col, np.int32).copy()).to(dev),
            val=torch.from_numpy(val.copy()).to(dev),
            shape=(int(shape[0]), int(shape[1])),
        )

    @classmethod
    def from_dense(cls, dense, *, device: Device = "cuda") -> "CSR":
        """Exact (unpadded) CSR from a dense matrix.  Host-side."""
        if isinstance(dense, torch.Tensor):
            dense = dense.detach().cpu().numpy()
        dense = np.asarray(dense)
        m, n = dense.shape
        rows, cols = np.nonzero(dense)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        vals = dense[rows, cols]
        rpt = np.zeros(m + 1, dtype=np.int32)
        np.add.at(rpt, rows + 1, 1)
        rpt = np.cumsum(rpt).astype(np.int32)
        if len(cols) == 0:      # keep capacity >= 1 (zero-size gathers)
            cols = np.zeros(1, np.int32)
            vals = np.zeros(1, dense.dtype)
        return cls.from_numpy(rpt, cols, vals, (m, n), device=device)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rpt, col, val) as host arrays, storage padding included."""
        return (self.rpt.cpu().numpy(), self.col.cpu().numpy(),
                self.val.cpu().numpy())

    def to_dense(self) -> torch.Tensor:
        """Dense (M, N) matrix.  For tests and oracles only."""
        m, n = self.shape
        rows = self.row_ids().long()
        mask = self.entry_mask()
        flat = torch.zeros((m + 1) * n, dtype=self.val.dtype,
                           device=self.device)
        lin = torch.where(mask, rows * n + self.col.long(),
                          torch.full_like(rows, m * n))
        flat.index_add_(0, lin, torch.where(mask, self.val,
                                            torch.zeros_like(self.val)))
        return flat[: m * n].reshape(m, n)

    def with_capacity(self, cap: int) -> "CSR":
        """Pad / truncate storage to a new capacity."""
        cur = self.capacity
        if cap == cur:
            return self
        if cap > cur:
            col = torch.zeros(cap, dtype=self.col.dtype, device=self.device)
            val = torch.zeros(cap, dtype=self.val.dtype, device=self.device)
            col[:cur] = self.col
            val[:cur] = self.val
        else:
            col, val = self.col[:cap], self.val[:cap]
        return CSR(rpt=self.rpt, col=col, val=val, shape=self.shape)

    def to(self, device: Device) -> "CSR":
        """The same matrix on ``device`` (itself when already there)."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return CSR(rpt=self.rpt.to(dev), col=self.col.to(dev),
                   val=self.val.to(dev), shape=self.shape)

    def row_slice(self, start: int, stop: int, *,
                  nrows: Optional[int] = None,
                  capacity: Optional[int] = None) -> "CSR":
        """Rows ``[start, stop)`` as a new CSR with rebased row pointers.

        The substrate of row-block sharding: each shard of A is a
        ``row_slice`` whose product with the full B is an ordinary SpGEMM.
        ``nrows`` / ``capacity`` pad the slice to static buckets (trailing
        empty rows, zero-filled storage), so every same-bucket slice has
        the same shapes.  The bounds and sizes are host ints; the entry
        offsets stay on the device, so slicing never syncs the host.

        A ``capacity`` below the slice's nnz truncates silently, as in the
        reference (the engine checks the slice sizes at finalize).  The
        truncated slice keeps its leading entries, and its row pointers
        are clamped to the capacity so that it stays a valid CSR: torch
        raises on the out-of-range gathers that JAX clamps.
        """
        n_real = stop - start
        out_rows = nrows if nrows is not None else n_real
        if not 0 <= start <= stop <= self.nrows:
            raise ValueError(f"row slice [{start}, {stop}) of "
                             f"{self.nrows} rows")
        if out_rows < n_real:
            raise ValueError(f"nrows {out_rows} < the slice's {n_real}")
        cap = int(capacity) if capacity is not None else self.capacity
        if cap < 1:
            raise ValueError(f"capacity {cap} < 1")
        dev = self.device
        rpt_w = self.rpt[start:stop + 1]          # (n_real+1,), on device
        base = rpt_w[0]
        rpt = torch.empty(out_rows + 1, dtype=torch.int32, device=dev)
        rpt[:n_real + 1] = (rpt_w - base).clamp(max=cap)
        rpt[n_real + 1:] = rpt[n_real]            # padding rows are empty
        idx = base + torch.arange(cap, dtype=torch.int32, device=dev)
        valid = idx < rpt_w[-1]
        safe = idx.clamp(0, self.capacity - 1).long()
        return CSR(rpt=rpt, col=self.col[safe].masked_fill(~valid, 0),
                   val=self.val[safe].masked_fill(~valid, 0),
                   shape=(out_rows, self.ncols))


def gather_rows(A: CSR, rows: torch.Tensor, valid: torch.Tensor,
                nnz_capacity: Optional[int] = None) -> CSR:
    """Sub-CSR of the given rows (padded row slots allowed).

    Used by the global-memory-analog fallback rung: rows too large for the
    top shared-memory hash table are gathered and handed to the ESC
    accumulator.  ``rows`` may hold out-of-range ids where ``valid`` is
    False.  No host sync: every size is static.
    """
    dev = A.device
    r_cap = rows.shape[0]
    cap = int(nnz_capacity) if nnz_capacity is not None else A.capacity
    safe_rows = rows.clamp(0, A.nrows - 1).long()
    sizes = A.nnz_per_row()[safe_rows].masked_fill(~valid, 0)
    rpt_sub = torch.zeros(r_cap + 1, dtype=torch.int32, device=dev)
    rpt_sub[1:] = torch.cumsum(sizes, 0)
    t = torch.arange(cap, dtype=torch.int32, device=dev)
    sr = torch.searchsorted(rpt_sub[:-1], t, right=True, out_int32=True) - 1
    sr = sr.clamp(0, r_cap - 1).long()
    off = t - rpt_sub[sr]
    src = (A.rpt[safe_rows[sr]] + off).clamp(max=max(A.capacity - 1, 0))
    src = src.long()
    pad = t >= rpt_sub[-1]
    return CSR(rpt=rpt_sub, col=A.col[src].masked_fill(pad, 0),
               val=A.val[src].masked_fill(pad, 0), shape=(r_cap, A.ncols))


def _threefry2x32(key: Tuple[int, int], count: Tuple[int, int]):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as JAX computes
    it: two uint32 words of ``count`` under ``key``."""
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (count[0] + ks[0]) & mask, (count[1] + ks[1]) & mask
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & mask
    return x0, x1


def prng_key_seed(s: int) -> int:
    """The int seed that the reference's ``random_csr`` draws from
    ``jax.random.PRNGKey(s)``: ``jax.random.bits(key, uint32)`` with
    ``jax_threefry_partitionable`` on (JAX's default), computed without
    JAX, for 0 <= s < 2^32 (the key is then the words (0, s)).
    ``random_csr(prng_key_seed(s), ...)`` is the reference's
    ``random_csr(jax.random.PRNGKey(s), ...)``."""
    if not 0 <= s < 2 ** 32:
        raise ValueError(f"seed {s} outside [0, 2^32)")
    b0, b1 = _threefry2x32((0, int(s)), (0, 0))
    return b0 ^ b1


def random_csr(seed: int, m: int, n: int, *, avg_nnz_per_row: float,
               max_nnz_per_row: Optional[int] = None,
               dtype: torch.dtype = torch.float32,
               distribution: str = "uniform",
               device: Device = "cuda") -> CSR:
    """Synthetic sparse matrix generator (host-side numpy RNG).

    For an int ``seed`` this draws exactly what the reference generator
    (``repro.core.csr.random_csr``) draws, so both packages build the same
    matrix bit for bit.

    ``distribution``:
      - "uniform":  row size ~ Poisson(avg) clipped to [0, max].
      - "powerlaw": heavy-tailed row sizes (a few very large rows), like
        webbase-1M with max_nnz/row >> mean.
      - "banded":   FEM-like band structure (rows hit nearby columns), like
        cant/consph/pwtk with high compression ratios.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    max_r = max_nnz_per_row or max(1, int(avg_nnz_per_row * 8))
    max_r = min(max_r, n)
    if distribution == "uniform":
        sizes = rng.poisson(avg_nnz_per_row, size=m)
    elif distribution == "powerlaw":
        sizes = np.minimum(
            (rng.pareto(1.5, size=m) + 1.0) * avg_nnz_per_row * 0.5, max_r)
    elif distribution == "banded":
        sizes = rng.normal(avg_nnz_per_row, avg_nnz_per_row * 0.15, size=m)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    sizes = np.clip(sizes.astype(np.int64), 0, max_r)

    cols_list = []
    for i in range(m):
        s = int(sizes[i])
        if s == 0:
            cols_list.append(np.empty(0, dtype=np.int32))
            continue
        if distribution == "banded":
            center = int(i * n / max(m, 1))
            lo = max(0, center - 2 * s)
            hi = min(n, lo + 4 * s + 1)
            cand = rng.choice(hi - lo, size=min(s, hi - lo),
                              replace=False) + lo
        else:
            cand = rng.choice(n, size=s, replace=False)
        cols_list.append(np.sort(cand).astype(np.int32))
    sizes = np.array([len(c) for c in cols_list], dtype=np.int32)
    rpt = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cap = max(int(rpt[-1]), 1)     # capacity >= 1 (zero-size gathers)
    col = np.zeros(cap, np.int32)
    if rpt[-1]:
        col[:rpt[-1]] = np.concatenate(cols_list).astype(np.int32)
    val = np.zeros(cap, np.float32)
    val[:rpt[-1]] = rng.standard_normal(int(rpt[-1]))
    return CSR(rpt=torch.from_numpy(rpt).to(dev),
               col=torch.from_numpy(col).to(dev),
               val=torch.from_numpy(val).to(device=dev, dtype=dtype),
               shape=(m, n))
