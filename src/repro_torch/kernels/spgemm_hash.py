"""Per-bin hash-table SpGEMM phases (OpSparse §5.2, §5.6) for the H100.

Three kernels, written by hand in CUDA C++ for ``sm_90a``
(``csrc/spgemm_hash.cu``), replace the reference's three Pallas TPU
kernels in ``repro/kernels/spgemm_hash.py``:

  symbolic_bin_call  distinct columns per row from a keys-only table, and
                     the table accesses per row (cold path, step 3);
  numeric_bin_call   (col, val) tables on the numeric ladder, dumped raw
                     (cold path, step 6, and the overflow redo);
  fused_bin_call     one (col, val) table build per row emitting nnz, the
                     raw table and the accesses (the steady state).

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch version on CPU tensors; nothing else decides.  The plain versions
(``*_plain``) take a bin's rows in parallel and each row's products in
order, with the reference's hash (key*107 in int32, AND or floor mod),
linear probing, probe guard (2*t_size) and access accounting, so they
reproduce the reference's tables slot for slot and its access counts
exactly.  On the card, concurrent inserts change slot positions, access
counts and the order of float sums: a kernel matches its plain version in
nnz and in each row's sorted columns exactly, in values within a
tolerance, and in accesses by invariants only.

Probe disciplines (paper §5.2, Fig. 9):
  * ``single_access=True``: Algorithms 4/5, one table transaction per
    probe (on the card, the atomicCAS is the probe).
  * ``single_access=False``: the nsparse/spECK check-then-CAS baseline, a
    second transaction whenever an empty slot is claimed.

Raw tables have stride ``t_size``: the 128-lane padding of the reference's
TPU tiles has no meaning here, and :func:`numeric_epilogue` takes whatever
stride its tables have.  The sort/condense epilogue, the ESC fallback rung
and the binning stay torch ops, as they were jnp outside any kernel.  The
drivers mark the fallback rung and the epilogue with profiler ranges
(``hash_fallback``, ``hash_epilogue``) so a trace splits their time.

Rows too large for the top rung go to the ESC accumulator (``core/esc``),
the analog of the paper's global-memory kernels.  The reference's
``vmem_extended`` ladders (tables up to 1,048,576 entries) do not fit a
block's shared memory; the wrappers refuse them on the card.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import esc
from repro_torch.core.analysis import exclusive_sum_in_place, nprod_into_rpt
from repro_torch.core.binning import Binning
from repro_torch.core.binning_ranges import BinLadder
from repro_torch.core.csr import CSR, gather_rows
from repro_torch.core.workspace import next_bucket

from . import build

HASH_SCALE = 107  # nsparse's multiplicative constant, kept (§5.2 "same way")
_PROBE_GUARD_FACTOR = 2  # safety: bail after 2*t_size probes (misuse guard)
_ROW_BUCKET_MIN = 8      # smallest per-rung row-count bucket
_PROBE_WINDOW = 32       # slots the plain version examines per probe step

INT32_MAX = np.iinfo(np.int32).max


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def _hash_init(key: torch.Tensor, t_size: int) -> torch.Tensor:
    """The reference's first slot: key*107 wrapped to int32, then AND for a
    power-of-two table and a floor mod otherwise (int64 result)."""
    p = (key.long() * HASH_SCALE) & 0xFFFFFFFF
    p = torch.where(p >= 2 ** 31, p - 2 ** 32, p)
    if _is_pow2(t_size):
        return p & (t_size - 1)
    return torch.remainder(p, t_size)


# ---------------------------------------------------------------------------
# Plain versions: rows of the bin in parallel, each row's products in order.
# ---------------------------------------------------------------------------

def _bin_products(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                  rows_cap: int, with_values: bool):
    """Every product of the bin's rows in kernel order (row, A entry, B
    entry): (valid_row, keys, prods, nprod_row, first_product_of_row)."""
    dev = rows.device
    lane = torch.arange(rows_cap, device=dev)
    valid = lane < count
    r = rows.long().masked_fill(~valid, 0)
    a_lo = a_rpt[r].long().masked_fill(~valid, 0)
    na = (a_rpt[r + 1].long() - a_lo).masked_fill(~valid, 0)
    row_of_e = torch.repeat_interleave(lane, na)
    e = a_lo[row_of_e] + torch.arange(row_of_e.shape[0], device=dev) \
        - (torch.cumsum(na, 0) - na)[row_of_e]
    k = a_col[e].long()
    b_lo = b_rpt[k].long()
    nb = b_rpt[k + 1].long() - b_lo
    e_of_p = torch.repeat_interleave(
        torch.arange(e.shape[0], device=dev), nb)
    bidx = b_lo[e_of_p] + torch.arange(e_of_p.shape[0], device=dev) \
        - (torch.cumsum(nb, 0) - nb)[e_of_p]
    keys = b_col[bidx].long()
    prods = a_val[e][e_of_p] * b_val[bidx] if with_values else None
    nprod_row = torch.zeros(rows_cap, dtype=torch.int64, device=dev)
    nprod_row.index_add_(0, row_of_e, nb)
    first = torch.cumsum(nprod_row, 0) - nprod_row
    return valid, keys, prods, nprod_row, first


def _hash_tables_plain(rows, count, a_rpt, a_col, a_val, b_rpt, b_col,
                       b_val, *, t_size: int, rows_cap: int,
                       single_access: bool, with_values: bool):
    """The three kernels' shared body.  Returns (nnz, col_tabs, val_tabs,
    accesses); val_tabs is None without values.

    Step s inserts the s-th product of every row at once.  A probe step
    reads ``_PROBE_WINDOW`` consecutive slots of each pending row and takes
    the first that is empty or holds the key: the probe the reference's
    loop ends on.  Every slot before it held another key and cost one
    access; the terminal one costs one more with check-then-CAS when it
    was empty.  A row that reaches the guard stops with ``guard`` accesses
    and no insert, as in the reference.
    """
    dev = rows.device
    valid, keys, prods, nprod_row, first = _bin_products(
        rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, rows_cap,
        with_values)
    t = t_size
    guard = _PROBE_GUARD_FACTOR * t
    width = min(t, _PROBE_WINDOW)
    window = torch.arange(width, device=dev)
    col_tabs = torch.full((rows_cap, t), -1, dtype=torch.int32, device=dev)
    flat_cols = col_tabs.view(-1)
    val_tabs = flat_vals = None
    if with_values:
        val_tabs = torch.zeros((rows_cap, t), dtype=a_val.dtype, device=dev)
        flat_vals = val_tabs.view(-1)
    nnz = torch.zeros(rows_cap, dtype=torch.int64, device=dev)
    acc = torch.zeros(rows_cap, dtype=torch.int64, device=dev)
    row_base = torch.arange(rows_cap, device=dev) * t
    last = max(keys.shape[0] - 1, 0)
    steps = int(nprod_row.max()) if rows_cap else 0

    for s in range(steps):
        pending = nprod_row > s
        p = (first + s).clamp(max=last)
        key = keys[p]
        start = _hash_init(key, t)
        before = torch.zeros(rows_cap, dtype=torch.int64, device=dev)
        while True:
            slots = (start[:, None] + window) % t
            cur = col_tabs.gather(1, slots)
            stop = (cur == -1) | (cur == key[:, None])
            pos = torch.where(stop, window, width).amin(1)
            found = pos < width
            term = before + pos                  # index of the last probe
            done = pending & found & (term < guard)
            gave_up = pending & ~done & (found | (before + width >= guard))
            pick = pos.clamp(max=width - 1)[:, None]
            slot = slots.gather(1, pick).squeeze(1)
            old = cur.gather(1, pick).squeeze(1)
            claimed = done & (old == -1)
            lin = row_base + slot
            flat_cols[lin] = torch.where(claimed, key, old).to(torch.int32)
            if with_values:
                v = flat_vals[lin]
                flat_vals[lin] = torch.where(done, v + prods[p], v)
            cost = term + 1 if single_access else term + 1 + claimed
            acc += torch.where(done, cost,
                               torch.where(gave_up, guard, 0))
            nnz += claimed
            pending = pending & ~done & ~gave_up
            if not bool(pending.any()):
                break
            before += width
            start = (start + width) % t

    nnz = nnz.masked_fill(~valid, 0).to(torch.int32)
    acc = acc.masked_fill(~valid, 0).to(torch.int32)
    return nnz, col_tabs, val_tabs, acc


def symbolic_bin_plain(rows, count, a_rpt, a_col, b_rpt, b_col, *,
                       t_size: int, rows_cap: int, pack: int = 1,
                       single_access: bool = True):
    """Plain version of :func:`symbolic_bin_call` -> (nnz, accesses)."""
    _check_pack(rows_cap, pack)
    nnz, _, _, acc = _hash_tables_plain(
        rows, count, a_rpt, a_col, None, b_rpt, b_col, None, t_size=t_size,
        rows_cap=rows_cap, single_access=single_access, with_values=False)
    return nnz, acc


def numeric_bin_plain(rows, count, a_rpt, a_col, a_val, b_rpt, b_col,
                      b_val, *, t_size: int, rows_cap: int,
                      single_access: bool):
    """Plain version of :func:`numeric_bin_call` ->
    (col_tabs, val_tabs, accesses)."""
    _, col_tabs, val_tabs, acc = _hash_tables_plain(
        rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
        t_size=t_size, rows_cap=rows_cap, single_access=single_access,
        with_values=True)
    return col_tabs, val_tabs, acc


def fused_bin_plain(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                    *, t_size: int, rows_cap: int, pack: int = 1,
                    single_access: bool = True):
    """Plain version of :func:`fused_bin_call` ->
    (nnz, col_tabs, val_tabs, accesses)."""
    _check_pack(rows_cap, pack)
    return _hash_tables_plain(
        rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
        t_size=t_size, rows_cap=rows_cap, single_access=single_access,
        with_values=True)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_pack(rows_cap: int, pack: int) -> None:
    if pack < 1 or pack & (pack - 1) or rows_cap % pack:
        raise ValueError(f"pack={pack} must be a power of two dividing "
                         f"rows_cap={rows_cap}")


def launch_geometry(t_size: int, pack: int) -> Tuple[int, int]:
    """(rows_per_cta, threads_per_row) of a rung's launch.

    ``pack > 1`` puts ``pack`` rows in one block, a warp each (the GPU
    form of the reference's row packing).  Otherwise one block owns one
    row, with a thread for about every 8 table entries (32 to 1024): the
    rung's table size bounds its rows' distinct columns, hence its work.
    """
    if pack > 1:
        return pack, 32
    threads = 32
    while threads < 1024 and threads * 8 < t_size:
        threads *= 2
    return 1, threads


@functools.lru_cache(maxsize=None)
def _max_smem_bytes(device_index: int) -> int:
    out = torch.zeros(1, dtype=torch.int32)
    lib = build.library("spgemm_hash")
    with torch.cuda.device(device_index):
        build.check(lib.hash_max_smem_bytes(out.data_ptr()),
                    "hash_max_smem_bytes")
    return int(out[0])


def _cuda_launch_args(device: torch.device, t_size: int, pack: int,
                      with_values: bool) -> Tuple[int, int]:
    rows_per_cta, threads = launch_geometry(t_size, pack)
    need = rows_per_cta * t_size * (8 if with_values else 4) \
        + 8 * rows_per_cta
    limit = _max_smem_bytes(device.index if device.index is not None
                            else torch.cuda.current_device())
    if need > limit:
        raise ValueError(
            f"a hash table of {t_size} entries x {rows_per_cta} rows needs "
            f"{need} B of shared memory; this card allows {limit} B per "
            "block.  The vmem_extended ladders need a global-memory rung, "
            "which is not ported yet.")
    return rows_per_cta, threads


def _check_cuda_inputs(rows, count, ints, floats, rows_cap: int) -> None:
    dev = rows.device
    for name, x in [("rows", rows), ("count", count), *ints]:
        if x.device != dev or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    for name, x in floats:
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernels take contiguous "
                             f"float32 values on {dev}, got {x.dtype} on "
                             f"{x.device}")
    if rows.shape != (rows_cap,) or count.numel() != 1:
        raise ValueError(f"rows {tuple(rows.shape)} / count "
                         f"{tuple(count.shape)} do not fit rows_cap="
                         f"{rows_cap}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def symbolic_bin_call(rows, count, a_rpt, a_col, b_rpt, b_col, *,
                      t_size: int, rows_cap: int, pack: int = 1,
                      single_access: bool = True):
    """Symbolic hash kernel over one bin -> (nnz, accesses), both
    (rows_cap,) int32.

    rows: (rows_cap,) int32 row ids (padded); count: (1,) int32 valid rows,
    read on the device.  ``pack`` rows share one block (a warp each).
    """
    if not rows.is_cuda:
        return symbolic_bin_plain(rows, count, a_rpt, a_col, b_rpt, b_col,
                                  t_size=t_size, rows_cap=rows_cap,
                                  pack=pack, single_access=single_access)
    _check_pack(rows_cap, pack)
    _check_cuda_inputs(rows, count, [("a_rpt", a_rpt), ("a_col", a_col),
                                     ("b_rpt", b_rpt), ("b_col", b_col)],
                       [], rows_cap)
    dev = rows.device
    rows_per_cta, threads = _cuda_launch_args(dev, t_size, pack, False)
    nnz = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    if rows_cap:
        with torch.cuda.device(dev):
            err = build.library("spgemm_hash").symbolic_bin(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), b_rpt.data_ptr(), b_col.data_ptr(),
                t_size, rows_cap, rows_per_cta, threads, int(single_access),
                nnz.data_ptr(), acc.data_ptr(), _stream(dev))
        build.check(err, "symbolic_bin")
        symbolic_bin_call.launches += 1
    return nnz, acc


symbolic_bin_call.launches = 0


def numeric_bin_call(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                     *, t_size: int, rows_cap: int, single_access: bool):
    """Numeric hash kernel over one bin -> (col_tabs, val_tabs, accesses):
    col_tabs (rows_cap, t_size) int32 raw tables (-1 = empty), val_tabs
    (rows_cap, t_size) float32, accesses (rows_cap,) int32.  Never packs.
    """
    if not rows.is_cuda:
        return numeric_bin_plain(rows, count, a_rpt, a_col, a_val, b_rpt,
                                 b_col, b_val, t_size=t_size,
                                 rows_cap=rows_cap,
                                 single_access=single_access)
    _check_cuda_inputs(rows, count, [("a_rpt", a_rpt), ("a_col", a_col),
                                     ("b_rpt", b_rpt), ("b_col", b_col)],
                       [("a_val", a_val), ("b_val", b_val)], rows_cap)
    dev = rows.device
    _, threads = _cuda_launch_args(dev, t_size, 1, True)
    col_tabs = torch.empty((rows_cap, t_size), dtype=torch.int32, device=dev)
    val_tabs = torch.empty((rows_cap, t_size), dtype=torch.float32,
                           device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    if rows_cap:
        with torch.cuda.device(dev):
            err = build.library("spgemm_hash").numeric_bin(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), a_val.data_ptr(), b_rpt.data_ptr(),
                b_col.data_ptr(), b_val.data_ptr(), t_size, rows_cap,
                threads, int(single_access), col_tabs.data_ptr(),
                val_tabs.data_ptr(), acc.data_ptr(), _stream(dev))
        build.check(err, "numeric_bin")
        numeric_bin_call.launches += 1
    return col_tabs, val_tabs, acc


numeric_bin_call.launches = 0


def fused_bin_call(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                   *, t_size: int, rows_cap: int, pack: int = 1,
                   single_access: bool = True):
    """Fused symbolic->numeric hash kernel over one bin ->
    (nnz, col_tabs, val_tabs, accesses):
      nnz      (rows_cap,) int32 distinct columns per row;
      col_tabs (rows_cap, t_size) int32 raw tables (-1 = empty);
      val_tabs (rows_cap, t_size) float32 accumulated values;
      accesses (rows_cap,) int32 table transactions per row.
    """
    if not rows.is_cuda:
        return fused_bin_plain(rows, count, a_rpt, a_col, a_val, b_rpt,
                               b_col, b_val, t_size=t_size,
                               rows_cap=rows_cap, pack=pack,
                               single_access=single_access)
    _check_pack(rows_cap, pack)
    _check_cuda_inputs(rows, count, [("a_rpt", a_rpt), ("a_col", a_col),
                                     ("b_rpt", b_rpt), ("b_col", b_col)],
                       [("a_val", a_val), ("b_val", b_val)], rows_cap)
    dev = rows.device
    rows_per_cta, threads = _cuda_launch_args(dev, t_size, pack, True)
    nnz = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    col_tabs = torch.empty((rows_cap, t_size), dtype=torch.int32, device=dev)
    val_tabs = torch.empty((rows_cap, t_size), dtype=torch.float32,
                           device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    if rows_cap:
        with torch.cuda.device(dev):
            err = build.library("spgemm_hash").fused_bin(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), a_val.data_ptr(), b_rpt.data_ptr(),
                b_col.data_ptr(), b_val.data_ptr(), t_size, rows_cap,
                rows_per_cta, threads, int(single_access), nnz.data_ptr(),
                col_tabs.data_ptr(), val_tabs.data_ptr(), acc.data_ptr(),
                _stream(dev))
        build.check(err, "fused_bin")
        fused_bin_call.launches += 1
    return nnz, col_tabs, val_tabs, acc


fused_bin_call.launches = 0

KERNELS = (symbolic_bin_call, numeric_bin_call, fused_bin_call)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Epilogue: condense + sort the dumped tables into CSR storage.
# ---------------------------------------------------------------------------

def numeric_epilogue(col_tabs, val_tabs, bin_rows, count, rpt, c_col, c_val,
                     *, nnz_capacity: int):
    """Sort each row's table by column id and scatter it into C storage.

    The paper's condense + sort phases, vectorized: a sort over each table
    (empties keyed to INT32_MAX sort last), then a masked scatter to
    ``c_col/c_val`` at ``rpt[row] + j``.  ``c_col``/``c_val`` hold
    ``nnz_capacity + 1`` entries; the last is the dump slot for dropped
    writes.  They are written in place and returned.
    """
    dev = col_tabs.device
    rows_cap, stride = col_tabs.shape
    sort_key = col_tabs.masked_fill(col_tabs < 0, INT32_MAX)
    col_sorted, order = torch.sort(sort_key, dim=1)
    val_sorted = val_tabs.gather(1, order)
    nnz_row = (col_tabs >= 0).sum(1)
    valid_row = torch.arange(rows_cap, device=dev) < count
    lane = torch.arange(stride, device=dev)[None, :]
    mask = (lane < nnz_row[:, None]) & valid_row[:, None]
    start = rpt[bin_rows.long().masked_fill(~valid_row, 0)].long()[:, None]
    target = torch.where(mask, start + lane, nnz_capacity)
    target = target.clamp(max=nnz_capacity).view(-1)
    c_col[target] = col_sorted.view(-1)
    c_val[target] = val_sorted.view(-1)
    return c_col, c_val


def scatter_sub_rows(subC: CSR, orig_rows, valid, rpt, c_col, c_val, *,
                     nnz_capacity: int):
    """Copy the rows of a sub-CSR result into C storage (in place; the
    buffers hold ``nnz_capacity + 1`` entries, the last a dump slot)."""
    dev = subC.device
    sub_rows = subC.row_ids().long()              # sub-row of each entry
    entry_ok = subC.entry_mask() & (sub_rows < subC.nrows)
    safe_sub = sub_rows.clamp(max=subC.nrows - 1)
    row_ok = entry_ok & valid[safe_sub]
    orig = orig_rows[safe_sub].long()
    offs = torch.arange(subC.capacity, device=dev) - subC.rpt[safe_sub]
    target = rpt[orig.clamp(max=rpt.shape[0] - 2)] + offs
    target = torch.where(row_ok, target, nnz_capacity)
    target = target.clamp(max=nnz_capacity)
    c_col[target] = subC.col
    c_val[target] = subC.val
    return c_col, c_val


# ---------------------------------------------------------------------------
# Schedule-driven drivers (called by the engine and the binned wrappers).
#
# The launch schedule (which rungs run, with how many padded rows each) is
# plain host data: ``row_buckets`` gives a pow-2 row-count capacity per
# rung (last entry = the ESC fallback rung), 0 meaning the rung is absent.
# With the schedule fixed, a phase runs with no host sync; callers verify
# afterwards that the actual bin sizes fit the buckets (the engine folds
# that check into its single finalize sync and grows the plan on overflow).
# ---------------------------------------------------------------------------

def _fallback_rows(binning: Binning, ladder: BinLadder, cap: int, m: int):
    """Fallback-rung row ids padded to ``cap`` (+ validity mask)."""
    rows, count = binning.rows_of_bin(len(ladder.table_sizes), cap)
    valid = torch.arange(cap, dtype=torch.int32, device=rows.device) < count
    return rows.masked_fill(~valid, m), valid


def _check_schedule(row_buckets, ladder: BinLadder, fallback_prod_capacity):
    assert len(row_buckets) == ladder.num_bins, (row_buckets, ladder)
    assert not row_buckets[-1] or fallback_prod_capacity > 0, \
        "active fallback rung needs a sub-product capacity"


def nprod_of_rows(A: CSR, B: CSR, rows: torch.Tensor) -> torch.Tensor:
    """n_prod of the given rows (ids past the last row read the last row),
    gathered from :func:`nprod_into_rpt`: O(nnz(A)) instead of the
    reference's O(rows x capacity) mask."""
    nprod = nprod_into_rpt(A, B)
    return nprod[rows.long().clamp(max=A.nrows - 1)]


def _fallback_sub_prod(A: CSR, B: CSR, rows, valid) -> torch.Tensor:
    return nprod_of_rows(A, B, rows).masked_fill(~valid, 0).sum()


def _scatter_nnz(nnz_buf, rows, valid, nnz_rows, m: int) -> None:
    """nnz_buf[rows] = nnz_rows for valid rows; the rest go to slot m+1."""
    nnz_buf[rows.long().masked_fill(~valid, m + 1)] = nnz_rows


def symbolic_scheduled(A: CSR, B: CSR, binning: Binning, ladder: BinLadder,
                       *, row_buckets, fallback_prod_capacity: int = 0,
                       single_access: bool = True, row_packing: bool = False,
                       collect_accesses: bool = False):
    """Symbolic phase over a bucketed schedule, with no host sync.

    Rungs are dispatched LARGEST first (the §5.5 launch-order rule),
    beginning with the ESC fallback rung.  Returns ``(nnz_buf, sub_prod,
    accesses)``: the (M+1,) n_nz buffer, the fallback rung's product total
    (the caller verifies it against ``fallback_prod_capacity``: an
    overflowed fallback truncates its expansion) and the summed table
    accesses (0 unless ``collect_accesses``).  ``row_packing`` packs
    ``ladder.rows_per_block[b]`` rows per block (``row_buckets`` must then
    be multiples of the pack, as ``host_schedule(packs=...)`` makes them).
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m = A.nrows
    dev = A.device
    nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=dev)
    accesses = torch.zeros((), dtype=torch.int64, device=dev)
    sub_prod = torch.zeros((), dtype=torch.int64, device=dev)

    if row_buckets[-1]:
        # Global-memory-analog rung: ESC on the gathered sub-matrix.
        with record_function("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            sub_nnz = esc.symbolic(sub, B,
                                   prod_capacity=fallback_prod_capacity)
            _scatter_nnz(nnz_buf, rows, valid, sub_nnz[:rows.shape[0]], m)

    for b in range(len(ladder.table_sizes) - 1, -1, -1):
        rows_cap = row_buckets[b]
        if not rows_cap:
            continue
        pack = min(ladder.rows_per_block[b] if row_packing else 1, rows_cap)
        rows, count = binning.rows_of_bin(b, rows_cap)
        nnz_bin, acc_bin = symbolic_bin_call(
            rows, count.reshape(1), A.rpt, A.col, B.rpt, B.col,
            t_size=ladder.table_sizes[b], rows_cap=rows_cap, pack=pack,
            single_access=single_access)
        valid = torch.arange(rows_cap, device=dev) < count
        _scatter_nnz(nnz_buf, rows, valid, nnz_bin, m)
        if collect_accesses:
            accesses = accesses + acc_bin.masked_fill(~valid, 0).sum()

    return nnz_buf[:m + 1], sub_prod, accesses


def schedule_bucket(count: int, *, m_cap: int, headroom: float,
                    pack: int = 1) -> int:
    """Pow-2 bin-count bucket for one rung's observed row count.

    With headroom the bucket must strictly EXCEED the headroom target (an
    observed count already on a pow-2 would otherwise learn a bucket with
    zero margin); headroom=1.0 keeps exact buckets.  ``pack`` floors the
    bucket at a rung's pow-2 rows-per-block so packed launches get whole
    blocks.
    """
    count = int(count)
    if not count:
        return 0
    lo = max(_ROW_BUCKET_MIN, int(pack))
    strict = 1 if headroom > 1.0 else 0
    return min(max(m_cap, lo),
               next_bucket(int(np.ceil(count * headroom)) + strict,
                           minimum=lo))


def fallback_capacity_bucket(sub_prod: int, *, headroom: float) -> int:
    """Pow-2 capacity bucket for the fallback rung's ESC expansion (same
    strict-exceed rule as :func:`schedule_bucket`; host int math)."""
    strict = 1 if headroom > 1.0 else 0
    return next_bucket(int(np.ceil(max(int(sub_prod), 1) * headroom))
                       + strict, minimum=_ROW_BUCKET_MIN)


def host_schedule(A: CSR, B: CSR, binning: Binning, ladder: BinLadder, *,
                  headroom: float = 1.0, packs: Optional[Tuple[int, ...]] = None):
    """Host-side schedule derivation (the cold path's metadata sync).

    Reads the bin sizes, buckets each rung's row count to a pow-2 capacity
    (0 = empty rung, skipped), and, when the fallback rung is populated,
    reads its product total to size the ESC expansion.  ``headroom``
    over-provisions the buckets so steady-state bin-count jitter stays
    inside them; ``packs`` (per table rung) floors each populated rung's
    bucket at its rows-per-block.
    """
    sizes = binning.bin_size.tolist()           # host sync: launch schedule
    m_cap = next_bucket(binning.bins.shape[0], minimum=_ROW_BUCKET_MIN)
    row_buckets = tuple(
        schedule_bucket(
            s, m_cap=m_cap, headroom=headroom,
            pack=(packs[b] if packs is not None and b < len(packs) else 1))
        for b, s in enumerate(sizes))
    fallback_prod_capacity = 0
    if row_buckets[-1]:
        rows, valid = _fallback_rows(binning, ladder, row_buckets[-1],
                                     A.nrows)
        sub_prod = int(_fallback_sub_prod(A, B, rows, valid))  # host sync
        fallback_prod_capacity = fallback_capacity_bucket(
            sub_prod, headroom=headroom)
    return row_buckets, fallback_prod_capacity


def symbolic_binned(A: CSR, B: CSR, binning: Binning, ladder: BinLadder, *,
                    single_access: bool = True, row_packing: bool = False,
                    collect_accesses: bool = False):
    """Host-orchestrated symbolic phase (cold / standalone path).

    Reads the bin sizes once for an exact schedule, then runs
    :func:`symbolic_scheduled`.  Returns the (M+1,) n_nz buffer (and the
    total table accesses with ``collect_accesses``).
    """
    packs = ladder.rows_per_block if row_packing else None
    row_buckets, fall_cap = host_schedule(A, B, binning, ladder, packs=packs)
    nnz_buf, _, accesses = symbolic_scheduled(
        A, B, binning, ladder, row_buckets=row_buckets,
        fallback_prod_capacity=fall_cap, single_access=single_access,
        row_packing=row_packing, collect_accesses=collect_accesses)
    if collect_accesses:
        return nnz_buf, accesses
    return nnz_buf


def numeric_scheduled(A: CSR, B: CSR, rpt: torch.Tensor, binning: Binning,
                      ladder: BinLadder, *, row_buckets, nnz_capacity: int,
                      fallback_prod_capacity: int = 0,
                      single_access: bool = True,
                      collect_accesses: bool = False):
    """Numeric phase over a bucketed schedule, with no host sync.

    Mirrors :func:`symbolic_scheduled`.  Returns ``(C, sub_prod,
    accesses)``; the caller verifies ``sub_prod`` against
    ``fallback_prod_capacity``.
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m, n = A.nrows, B.ncols
    dev = A.device
    c_col = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
    c_val = torch.zeros(nnz_capacity + 1, dtype=A.val.dtype, device=dev)
    accesses = torch.zeros((), dtype=torch.int64, device=dev)
    sub_prod = torch.zeros((), dtype=torch.int64, device=dev)

    if row_buckets[-1]:
        with record_function("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            subC = esc.spgemm_fused(sub, B,
                                    prod_capacity=fallback_prod_capacity,
                                    nnz_capacity=fallback_prod_capacity)
            scatter_sub_rows(subC, rows, valid, rpt, c_col, c_val,
                             nnz_capacity=nnz_capacity)

    for b in range(len(ladder.table_sizes) - 1, -1, -1):
        rows_cap = row_buckets[b]
        if not rows_cap:
            continue
        rows, count = binning.rows_of_bin(b, rows_cap)
        col_tabs, val_tabs, acc_bin = numeric_bin_call(
            rows, count.reshape(1), A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=ladder.table_sizes[b], rows_cap=rows_cap,
            single_access=single_access)
        with record_function("hash_epilogue"):
            numeric_epilogue(col_tabs, val_tabs, rows, count, rpt, c_col,
                             c_val, nnz_capacity=nnz_capacity)
        if collect_accesses:
            valid = torch.arange(rows_cap, device=dev) < count
            accesses = accesses + acc_bin.masked_fill(~valid, 0).sum()

    C = CSR(rpt=rpt, col=c_col[:nnz_capacity], val=c_val[:nnz_capacity],
            shape=(m, n))
    return C, sub_prod, accesses


def numeric_binned(A: CSR, B: CSR, rpt: torch.Tensor, binning: Binning,
                   ladder: BinLadder, *, nnz_capacity: int,
                   single_access: bool = True,
                   collect_accesses: bool = False):
    """Host-orchestrated numeric phase (cold / standalone path) -> CSR."""
    row_buckets, fall_cap = host_schedule(A, B, binning, ladder)
    C, _, accesses = numeric_scheduled(
        A, B, rpt, binning, ladder, row_buckets=row_buckets,
        nnz_capacity=nnz_capacity, fallback_prod_capacity=fall_cap,
        single_access=single_access, collect_accesses=collect_accesses)
    if collect_accesses:
        return C, accesses
    return C


def fused_scheduled(A: CSR, B: CSR, binning: Binning, ladder: BinLadder, *,
                    row_buckets, nnz_capacity: int,
                    fallback_prod_capacity: int = 0,
                    single_access: bool = True, row_packing: bool = False,
                    collect_accesses: bool = False):
    """Fused symbolic->numeric phase over a bucketed schedule, no host sync.

    ONE binning (by n_prod, the symbolic ladder) and ONE table build per
    row: each populated rung's :func:`fused_bin_call` emits per-row nnz AND
    the accumulated (col, val) tables; the fallback rung runs the
    single-expansion ESC (its n_nz read off the sub-result's rpt).  Once
    every row's nnz is known the row pointers are an exclusive sum and the
    dumped tables condense/sort/scatter into C.  Symbolic-ladder tables
    are sized by n_prod (>= n_nz), so they never overflow.

    Returns ``(C, nnz, sub_prod, accesses)``: the assembled CSR, the (M,)
    per-row nnz, the fallback rung's product total to verify against
    ``fallback_prod_capacity``, and the summed table accesses (0 unless
    ``collect_accesses``).
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m, n = A.nrows, B.ncols
    dev = A.device
    nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=dev)
    accesses = torch.zeros((), dtype=torch.int64, device=dev)
    sub_prod = torch.zeros((), dtype=torch.int64, device=dev)
    fallback = None
    kept = []

    if row_buckets[-1]:
        # Global-memory-analog rung, fused form: one ESC expansion yields
        # both the sub-result values AND (via its rpt) the per-row nnz.
        with record_function("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            subC = esc.spgemm_fused(sub, B,
                                    prod_capacity=fallback_prod_capacity,
                                    nnz_capacity=fallback_prod_capacity)
            _scatter_nnz(nnz_buf, rows, valid, subC.nnz_per_row(), m)
        fallback = (subC, rows, valid)

    for b in range(len(ladder.table_sizes) - 1, -1, -1):
        rows_cap = row_buckets[b]
        if not rows_cap:
            continue
        pack = min(ladder.rows_per_block[b] if row_packing else 1, rows_cap)
        rows, count = binning.rows_of_bin(b, rows_cap)
        nnz_bin, col_tabs, val_tabs, acc_bin = fused_bin_call(
            rows, count.reshape(1), A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=ladder.table_sizes[b], rows_cap=rows_cap, pack=pack,
            single_access=single_access)
        valid = torch.arange(rows_cap, device=dev) < count
        _scatter_nnz(nnz_buf, rows, valid, nnz_bin, m)
        if collect_accesses:
            accesses = accesses + acc_bin.masked_fill(~valid, 0).sum()
        kept.append((rows, count, col_tabs, val_tabs))

    nnz_buf = nnz_buf[:m + 1]
    nnz = nnz_buf[:m]
    rpt = exclusive_sum_in_place(nnz_buf)
    c_col = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
    c_val = torch.zeros(nnz_capacity + 1, dtype=A.val.dtype, device=dev)
    if fallback is not None:
        subC, rows, valid = fallback
        with record_function("hash_fallback"):
            scatter_sub_rows(subC, rows, valid, rpt, c_col, c_val,
                             nnz_capacity=nnz_capacity)
    with record_function("hash_epilogue"):
        for rows, count, col_tabs, val_tabs in kept:
            numeric_epilogue(col_tabs, val_tabs, rows, count, rpt, c_col,
                             c_val, nnz_capacity=nnz_capacity)

    C = CSR(rpt=rpt, col=c_col[:nnz_capacity], val=c_val[:nnz_capacity],
            shape=(m, n))
    return C, nnz, sub_prod, accesses


def fused_binned(A: CSR, B: CSR, binning: Binning, ladder: BinLadder, *,
                 nnz_capacity: int, single_access: bool = True,
                 row_packing: bool = False, collect_accesses: bool = False):
    """Host-orchestrated fused pipeline (cold / standalone path) -> CSR.

    ``binning`` must be the n_prod binning on the SYMBOLIC ladder.
    """
    packs = ladder.rows_per_block if row_packing else None
    row_buckets, fall_cap = host_schedule(A, B, binning, ladder, packs=packs)
    C, _, _, accesses = fused_scheduled(
        A, B, binning, ladder, row_buckets=row_buckets,
        nnz_capacity=nnz_capacity, fallback_prod_capacity=fall_cap,
        single_access=single_access, row_packing=row_packing,
        collect_accesses=collect_accesses)
    if collect_accesses:
        return C, accesses
    return C
