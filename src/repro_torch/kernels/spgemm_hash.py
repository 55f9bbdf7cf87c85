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
counts and, in the atomic kernels, the order of float sums: a kernel
matches its plain version in nnz and in each row's sorted columns exactly,
in values within a tolerance (bit for bit in the fixed-order mode below),
and in accesses by invariants only.

Probe disciplines (paper §5.2, Fig. 9):
  * ``single_access=True``: Algorithms 4/5, one table transaction per
    probe (on the card, the atomicCAS is the probe).
  * ``single_access=False``: the nsparse/spECK check-then-CAS baseline, a
    second transaction whenever an empty slot is claimed.

Raw tables have stride ``t_size``: the 128-lane padding of the reference's
TPU tiles has no meaning here, and :func:`numeric_epilogue` takes whatever
stride its tables have.  On the card the tables of a bin's padding rows
(rows at or past ``count``) are left unwritten: their blocks exit before
building anything, and the epilogue masks those rows.  The plain versions
still write them empty (-1 / 0), as the reference does.  The
sort/condense epilogue, the ESC fallback rung and the binning stay torch
ops, as they were jnp outside any kernel.  The
drivers split their device work into profiler ranges, so a trace names
each part's time: ``hash_rungs`` (the table rungs, their row ids, masks
and output fills), ``hash_fallback`` (the ESC rung), ``hash_alloc`` (the
exclusive sum and C's storage) and ``hash_epilogue`` (the sort and
condense into C); :func:`host_schedule` names its reads (``sync:bins``,
``sync:fall``).

Rows too large for the top rung go to the ESC accumulator (``core/esc``),
as in the reference.  The reference's ``vmem_extended`` ladders add rungs
whose tables (32,768 to 1,048,576 entries) do not fit a block's shared
memory; its TPU kernels keep them in VMEM all the same.  On the card
:func:`hash_route` picks each launch's kernel from the table's size and
the card's shared memory per block alone: a table that a thread-block
cluster of at most 8 blocks holds in its shared memory runs on
``cluster_rows_kernel`` (one row a cluster, the table split over the
blocks' shared memory and probed through distributed shared memory;
``CLUSTER_SIZES`` gives each rung's cluster), a larger one on
``global_rows_kernel`` (the paper's kernel8 / kernel7: one row a block,
its table built in its own output row, or for ``symbolic_bin`` in a
scratch table).  The shared-memory rungs keep their kernels.  Each
wrapper counts its launches (``launches``) and, of those, the cluster
ones (``launches_cluster``) and the global ones (``launches_global``).

The fixed-order value mode: under ``torch.use_deterministic_algorithms
(True)`` :func:`fused_bin_call` and :func:`numeric_bin_call` launch the
ORDERED instance of their kernel on every route (the ``*_ordered`` entry
points).  It inserts the keys in parallel as the atomic kernels do, then
adds each row's products in the reference's order (A entry by A entry,
each B row in order, a rounded multiply and a rounded add per product), so
its tables are the plain version's value for value, bit for bit, on every
run: all of a row's warps make its batches of products, and each adds those
whose slot it owns.  On the shared-memory route that takes a stage of
about 12 B a thread beside the tables (:func:`ordered_smem_bytes`; a
launch whose tables and stage pass the card's limit is refused).  Those
launches are also counted in ``launches_ordered``.  The
atomic kernels stay the default; ``symbolic_bin`` builds no values.  On
the CPU the plain versions already add in that order and serve both
modes.

Value types: the kernels that build values take float32, bfloat16 or
float16 (``VALUE_TYPES``; ``a_val``, ``b_val`` and the value tables all of
one type; anything else raises).  Tables hold that type and each product
is rounded to it and added in it, as the reference's tables in
``a_val.dtype`` are, so a 16-bit call is the plain version's (and the
reference's) arithmetic and not a float32 one.  In 16-bit values both
``fused_bin`` and ``numeric_bin`` run on ``slot_rows_kernel``: a table
entry is one 64-bit word (the key, the value's bits above it), and one
64-bit CAS claims a slot and adds a product, where a 16-bit add to a
value array would be a CAS loop on the word it shares with its neighbour.
float32 ``fused_bin`` keeps ``hash_rows_kernel`` (keys and values side by
side), also 8 B an entry; so every table entry is 8 B in every type, the
routes do not depend on the type, and on the default fused ladder (one
block a row, t/8 threads) the threads, not the 8 B, bound the blocks an
SM holds up to the top rung, which holds one in any layout.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import esc
from repro_torch.core.analysis import exclusive_sum_in_place, nprod_into_rpt
from repro_torch.core.binning import Binning
from repro_torch.core.binning_ranges import BinLadder
from repro_torch.core.csr import CSR, gather_rows
from repro_torch.core.workspace import next_bucket

from . import build, scatter

HASH_SCALE = 107  # nsparse's multiplicative constant, kept (§5.2 "same way")
_PROBE_GUARD_FACTOR = 2  # safety: bail after 2*t_size probes (misuse guard)
_ROW_BUCKET_MIN = 8      # smallest per-rung row-count bucket
_PROBE_WINDOW = 32       # slots the plain version examines per probe step
_GRAPH_ROUNDS = 16       # the plain version's probe rounds a graph replays

INT32_MAX = np.iinfo(np.int32).max
# The value types of the CUDA kernels, by the suffix of their C entry points.
VALUE_TYPES = {torch.float32: "", torch.bfloat16: "_bf16",
               torch.float16: "_f16"}


def _range(name: str):
    """``engine.telemetry.profiler_range``, bound at the first call (the
    engine package imports this module, so this one cannot import it)."""
    global _range
    from repro_torch.engine.telemetry import profiler_range as _range
    return _range(name)


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

    Each row keeps its own cursor: the product it is inserting and the
    probes that product has taken so far.  A round moves every unfinished
    row one probe window on: it reads ``_PROBE_WINDOW`` consecutive slots
    from the row's current probe and takes the first that is empty or
    holds the key, the probe the reference's loop ends on.  Every slot
    before it held another key and cost one access; the terminal one costs
    one more with check-then-CAS when it was empty.  A row that reaches the
    guard stops that product with ``guard`` accesses and no insert, as in
    the reference.  Rows never touch each other's tables, so each row
    inserts its products in order whatever the others do.

    A round is a fixed sequence of tensor ops with no host read, so
    rounds run back to back: at least as many as the longest row has
    products, then more while a row is unfinished.  On the card the round
    is captured once in a CUDA graph (``_GRAPH_ROUNDS`` rounds a replay)
    and replayed, since a round's host cost is its ~40 launches; rounds
    after every row has finished change nothing.
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
    steps = int(nprod_row.max()) if rows_cap else 0
    if steps == 0:
        return (nnz.to(torch.int32), col_tabs, val_tabs, acc.to(torch.int32))
    row_base = torch.arange(rows_cap, device=dev) * t
    last = keys.shape[0] - 1
    start_of = _hash_init(keys, t)       # each product's first slot
    cur = torch.zeros(rows_cap, dtype=torch.int64, device=dev)
    before = torch.zeros(rows_cap, dtype=torch.int64, device=dev)

    def probe_round():
        pending = cur < nprod_row
        p = (first + cur).clamp(max=last)
        key = keys[p]
        slots = (start_of[p] + before)[:, None].add(window).remainder(t)
        tab = col_tabs.gather(1, slots)
        stop = (tab == -1) | (tab == key[:, None])
        pos = torch.where(stop, window, width).amin(1)
        found = pos < width
        term = before + pos                      # index of the last probe
        done = pending & found & (term < guard)
        gave_up = pending & ~done & (found | (before + width >= guard))
        pick = pos.clamp(max=width - 1)[:, None]
        slot = slots.gather(1, pick).squeeze(1)
        old = tab.gather(1, pick).squeeze(1)
        claimed = done & (old == -1)
        lin = row_base + slot
        flat_cols[lin] = torch.where(claimed, key, old).to(torch.int32)
        if with_values:
            v = flat_vals[lin]
            flat_vals[lin] = torch.where(done, v + prods[p], v)
        cost = term + 1 if single_access else term + 1 + claimed
        acc.add_(torch.where(done, cost, torch.where(gave_up, guard, 0)))
        nnz.add_(claimed)
        moved = done | gave_up
        cur.add_(moved)
        before.copy_(torch.where(moved, 0, before + width * pending))

    run = _round_runner(probe_round, dev)
    run(steps)
    while bool((cur < nprod_row).any()):
        run(1)

    nnz = nnz.masked_fill(~valid, 0).to(torch.int32)
    acc = acc.masked_fill(~valid, 0).to(torch.int32)
    return nnz, col_tabs, val_tabs, acc


def _round_runner(probe_round, dev):
    """-> run(n): at least n more calls of ``probe_round``, which updates
    its tensors in place and reads nothing on the host.  On a CPU device
    it calls the function n times; on the card the first call runs
    eagerly on a side stream (the warm-up a capture needs), the next
    ``_GRAPH_ROUNDS`` are captured in one CUDA graph, and the rest are its
    replays, rounded up."""
    if dev.type != "cuda":
        def run_eager(n):
            for _ in range(n):
                probe_round()
        return run_eager

    graph = None

    def run_graph(n):
        nonlocal graph
        if graph is None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                probe_round()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(_GRAPH_ROUNDS):
                    probe_round()
            n -= 1
        for _ in range(-(-n // _GRAPH_ROUNDS)):
            graph.replay()
    return run_graph


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


NUMERIC_ROWS_PER_CTA = 8   # rows of a block on the one-warp numeric rungs


def numeric_launch_geometry(t_size: int) -> Tuple[int, int]:
    """(rows_per_cta, threads_per_row) of a :func:`numeric_bin_call`
    launch: :func:`launch_geometry`'s threads per row, and
    ``NUMERIC_ROWS_PER_CTA`` rows (a warp each) in a block where that is
    one warp (t_size <= 255), so those rungs are not held to the card's
    32 resident blocks (1024 threads) per SM."""
    _, threads = launch_geometry(t_size, 1)
    return (NUMERIC_ROWS_PER_CTA if threads == 32 else 1), threads


def hash_mod(t_size: int) -> Tuple[int, int, int]:
    """(magic, shift, wrap): the constants of the kernels' divide-free
    floor mod by a ``t_size`` that is not a power of two (Granlund &
    Montgomery 1994, Fig. 4.1, for 32-bit dividends).  With l = ceil(log2
    t_size): magic = floor(2^32 (2^l - t_size) / t_size) + 1 < 2^32,
    shift = l - 1, and wrap = 2^32 mod t_size, which a negative int32 hash
    takes away.  Power-of-two sizes hash with an AND: (0, 0, 0)."""
    if _is_pow2(t_size):
        return 0, 0, 0
    lg = t_size.bit_length()
    return ((2 ** 32 * (2 ** lg - t_size)) // t_size + 1, lg - 1,
            2 ** 32 % t_size)


@functools.lru_cache(maxsize=None)
def _max_smem_bytes(device_index: int) -> int:
    out = torch.zeros(1, dtype=torch.int32)
    lib = build.library("spgemm_hash")
    with torch.cuda.device(device_index):
        build.check(lib.hash_max_smem_bytes(out.data_ptr()),
                    "hash_max_smem_bytes")
    return int(out[0])


def _smem_limit(device: Optional[torch.device]) -> int:
    dev = torch.device("cuda") if device is None else device
    return _max_smem_bytes(dev.index if dev.index is not None
                           else torch.cuda.current_device())


# The kernel ids of hash_ctas_per_sm (the fixed-order instances of
# numeric_bin and fused_bin: their ids plus 2).
_KERNEL_IDS = {"symbolic_bin": 0, "numeric_bin": 1, "fused_bin": 2}


def ctas_per_sm(t_size: int, pack: int = 1, *, kernel: str,
                single_access: bool = True,
                device: Optional[torch.device] = None,
                dtype: torch.dtype = torch.float32,
                ordered: bool = False) -> int:
    """CTAs of one rung's launch of ``kernel`` (symbolic_bin, numeric_bin
    or fused_bin, in the geometry and on the kernel its wrapper launches,
    :func:`hash_route`, with values of ``dtype``) that fit on one SM at
    once, by the CUDA occupancy calculator; with ``ordered``, of its
    fixed-order instance (numeric_bin and fused_bin on the shared-memory
    route, the value pass's stage included).  A ``"cluster"`` rung raises:
    its residency is :func:`clusters_in_flight`."""
    if ordered and kernel == "symbolic_bin":
        raise ValueError("symbolic_bin has no fixed-order instance")
    rows_per_cta, threads = (numeric_launch_geometry(t_size)
                             if kernel == "numeric_bin"
                             else launch_geometry(t_size, pack))
    out = torch.zeros(1, dtype=torch.int32)
    lib = build.library("spgemm_hash")
    with_values = kernel != "symbolic_bin"
    suffix = VALUE_TYPES[dtype] if with_values else ""
    with torch.cuda.device(device):
        route = hash_route(t_size, rows_per_cta, with_values,
                           _smem_limit(device))
        if route == "cluster":
            raise ValueError(f"{kernel} t_size={t_size} runs in clusters: "
                             f"see clusters_in_flight")
        if route == "global":
            if ordered:
                raise ValueError(f"{kernel} t_size={t_size} runs on the "
                                 "global route: ctas_per_sm(ordered=True) "
                                 "takes shared-memory rungs")
            entry = "hash_global_ctas_per_sm" + suffix
            build.check(getattr(lib, entry)(
                int(with_values), int(single_access), threads,
                out.data_ptr()), entry)
        else:
            entry = "hash_ctas_per_sm" + suffix
            build.check(getattr(lib, entry)(
                _KERNEL_IDS[kernel] + (2 if ordered else 0),
                int(single_access), t_size, rows_per_cta, threads,
                out.data_ptr()), entry)
    return int(out[0])


def clusters_in_flight(t_size: int, *, kernel: str,
                       single_access: bool = True,
                       device: Optional[torch.device] = None,
                       dtype: torch.dtype = torch.float32) -> int:
    """Clusters of one ``"cluster"`` rung's launch of ``kernel`` (at the
    rung's :func:`cluster_size`, values of ``dtype``) that fit on the whole
    card at once, by the CUDA occupancy calculator.  Any other rung
    raises: its residency is :func:`ctas_per_sm`."""
    threads = launch_geometry(t_size, 1)[1]
    with_values = kernel != "symbolic_bin"
    entry = "hash_cluster_occupancy" + (VALUE_TYPES[dtype] if with_values
                                        else "")
    out = torch.zeros(1, dtype=torch.int32)
    lib = build.library("spgemm_hash")
    with torch.cuda.device(device):
        limit = _smem_limit(device)
        route = hash_route(t_size, 1, with_values, limit)
        if route != "cluster":
            raise ValueError(f"{kernel} t_size={t_size} runs on the "
                             f"{route} route: see ctas_per_sm")
        build.check(getattr(lib, entry)(
            int(with_values), int(single_access), t_size,
            cluster_size(t_size, with_values, limit), threads,
            out.data_ptr()), entry)
    return int(out[0])


GLOBAL_MAX_T_SIZE = 2 ** 30   # the probe guard, 2*t_size, is an int32
CLUSTER_MAX = 8               # the portable thread-block cluster size
ROW_COUNTER_BYTES = 8         # a row's nnz and accesses counters
# What each block of a cluster holds besides its share of the table: the
# row's counters (16 B, padded) and its copy of the row's entry list
# (1,024 entries of 16 B, and 32 scan sums): csrc/spgemm_hash.cu,
# cluster_smem_bytes.
CLUSTER_ROW_BYTES = 16 + (4 * 1024 + 32) * 4
# Blocks of the cluster of each cluster rung, by (with values, t_size),
# chosen by `python -m repro_torch.kernels.ablate --parts cluster` on
# mono_500Hz's rungs (PERF.md, section 6); a rung not listed takes the
# smallest cluster that holds its table (:func:`smallest_cluster`).  A
# larger cluster spreads a row over more warps and, with slices of 64 KB
# or less, fits two blocks an SM, until the per-row fixed costs (fill,
# entry list, barriers) of rows of few products take over.
CLUSTER_SIZES = {
    (False, 65536): 4,     # symbolic_bin: 2 close behind, 8 far behind
    (True, 65536): 8,      # fused_bin: ahead of 4
    (True, 32768): 4,      # numeric_bin: 2 close behind, 8 far behind
    (True, 131072): 8,     # numeric_bin: the only cluster that holds it
}


def _slot_bytes(with_values: bool) -> int:
    """A cluster table's slot: the 64-bit key+value word with values in
    every value type, the 4-byte key without."""
    return 8 if with_values else 4


def table_bytes(t_size: int, rows_per_cta: int, with_values: bool) -> int:
    """Shared memory of a block of ``rows_per_cta`` tables of ``t_size``
    entries and their counters: a 4-byte key an entry, and with values 4
    more in every value type (a float32 value beside its key, or the
    64-bit slot of the slot kernel; csrc/spgemm_hash.cu, smem_bytes)."""
    entries = rows_per_cta * t_size
    return (8 if with_values else 4) * entries \
        + rows_per_cta * ROW_COUNTER_BYTES


def ordered_smem_bytes(t_size: int, rows_per_cta: int,
                       threads_per_row: int) -> int:
    """Shared memory of a block of a fixed-order launch on the
    shared-memory route: :func:`table_bytes` with values, and where the
    block's one row has W > 1 warps the value pass's stage at the next
    8-byte boundary: an 8-byte (slot, product) pair a thread and a 4-byte
    word for each batch and owner, W (W + 1) of them (csrc/spgemm_hash.cu,
    stage_bytes, which this mirrors).  A block of several rows of several
    warps each has no stage: the kernel refuses it."""
    if rows_per_cta > 1 and threads_per_row > 32:
        raise ValueError(f"no fixed-order launch of {rows_per_cta} rows of "
                         f"{threads_per_row} threads a block")
    warps = threads_per_row // 32
    stage = 8 * threads_per_row + 4 * warps * (warps + 1) + 4 \
        if warps > 1 else 0
    return table_bytes(t_size, rows_per_cta, True) + stage


def cluster_slice_bytes(t_size: int, cluster: int, with_values: bool) -> int:
    """Shared memory of each block of a cluster of ``cluster`` blocks that
    holds one ``t_size`` table: its even share of the slots, the row's
    counters and the row's entry list (``CLUSTER_ROW_BYTES``)."""
    return t_size // cluster * _slot_bytes(with_values) + CLUSTER_ROW_BYTES


def smallest_cluster(t_size: int, with_values: bool,
                     smem_limit: int) -> Optional[int]:
    """The fewest blocks (a power of two, 2 to ``CLUSTER_MAX``) whose
    shared memory holds a power-of-two ``t_size`` table split evenly, each
    slice within ``smem_limit`` bytes; None if no cluster does."""
    if not _is_pow2(t_size):
        return None
    cluster = 2
    while cluster <= min(CLUSTER_MAX, t_size // 4):
        if cluster_slice_bytes(t_size, cluster, with_values) <= smem_limit:
            return cluster
        cluster *= 2
    return None


def cluster_size(t_size: int, with_values: bool, smem_limit: int) -> int:
    """Blocks of the cluster a ``"cluster"`` rung launches:
    ``CLUSTER_SIZES`` where it lists the rung, never fewer than
    :func:`smallest_cluster`."""
    least = smallest_cluster(t_size, with_values, smem_limit)
    if least is None:
        raise ValueError(f"no cluster of at most {CLUSTER_MAX} blocks holds "
                         f"a table of {t_size} entries")
    return max(least, CLUSTER_SIZES.get((with_values, t_size), least))


def hash_route(t_size: int, rows_per_cta: int, with_values: bool,
               smem_limit: int) -> str:
    """Which kernel a rung's launch takes, from its tables and a block's
    shared-memory limit (232,448 B on the H100) alone:

      ``"smem"``     the block's ``rows_per_cta`` tables fit its shared
                     memory (:func:`table_bytes`, 8 B an entry with values
                     in every type): the shared-memory kernels;
      ``"cluster"``  one table fits the shared memory of a cluster of at
                     most ``CLUSTER_MAX`` blocks (:func:`smallest_cluster`):
                     ``cluster_rows_kernel``;
      ``"global"``   neither: ``global_rows_kernel``, the table in device
                     memory.

    Raises where no kernel takes the rung: several rows to a block past
    shared memory, or a table past ``GLOBAL_MAX_T_SIZE``."""
    need = table_bytes(t_size, rows_per_cta, with_values)
    if need <= smem_limit:
        return "smem"
    if rows_per_cta != 1:
        raise ValueError(
            f"{rows_per_cta} tables of {t_size} entries to a block need "
            f"{need} B of shared memory (this card allows {smem_limit} B), "
            "and the cluster and global-memory kernels take one row a "
            "block: pack=1")
    if smallest_cluster(t_size, with_values, smem_limit) is not None:
        return "cluster"
    if t_size > GLOBAL_MAX_T_SIZE:
        raise ValueError(f"a table of {t_size} entries is past the global-"
                         f"memory kernel's {GLOBAL_MAX_T_SIZE}")
    return "global"


def rung_route(t_size: int, rows_per_cta: int, with_values: bool,
               device: Optional[torch.device] = None) -> str:
    """:func:`hash_route` at the shared-memory limit of ``device``'s card."""
    return hash_route(t_size, rows_per_cta, with_values,
                      _smem_limit(device))


def _launch_extended(fn, route, dev, rows, count, a_rpt, a_col, a_val,
                     b_rpt, b_col, b_val, *, t_size, rows_cap, threads,
                     single_access, nnz, col_tabs, val_tabs, acc,
                     ordered: bool = False) -> None:
    """One launch of a rung past a block's shared memory, counted on the
    wrapper ``fn``: ``route`` ``"cluster"`` takes ``hash_bin_cluster``
    (``val_tabs`` None: keys only, nothing dumped), ``"global"``
    ``hash_bin_global`` (``val_tabs`` None: keys only, built in
    ``col_tabs``, a scratch table).  ``nnz`` None skips the nnz.
    ``ordered`` takes their fixed-order instances (values only).  A
    refused launch raises; nothing falls back."""
    def ptr(x):
        return None if x is None else x.data_ptr()
    with_values = val_tabs is not None
    lib = build.library("spgemm_hash")
    inputs = (rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
              a_col.data_ptr(), ptr(a_val), b_rpt.data_ptr(),
              b_col.data_ptr(), ptr(b_val), t_size, rows_cap)
    entry = (f"hash_bin_{route}" + ("_ordered" if ordered else "")
             + (VALUE_TYPES[val_tabs.dtype] if with_values else ""))
    with torch.cuda.device(dev):
        if route == "cluster":
            err = getattr(lib, entry)(
                int(with_values), int(single_access), *inputs,
                cluster_size(t_size, with_values, _smem_limit(dev)),
                threads, ptr(nnz), ptr(col_tabs), ptr(val_tabs),
                acc.data_ptr(), _stream(dev))
        else:
            err = getattr(lib, entry)(
                int(single_access), *inputs, threads, ptr(nnz),
                col_tabs.data_ptr(), ptr(val_tabs), acc.data_ptr(),
                _stream(dev))
    build.check(err, entry)
    fn.launches += 1
    fn.launches_ordered += int(ordered)
    if route == "cluster":
        fn.launches_cluster += 1
    else:
        fn.launches_global += 1


def _check_cuda_inputs(rows, count, ints, floats, rows_cap: int) -> None:
    """Raises unless the ints are contiguous int32 on ``rows``' device
    and the values contiguous, on that device and all of one of
    ``VALUE_TYPES``."""
    dev = rows.device
    for name, x in [("rows", rows), ("count", count), *ints]:
        if x.device != dev or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    for name, x in floats:
        if x.device != dev or x.dtype not in VALUE_TYPES \
                or x.dtype != floats[0][1].dtype or not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernels take contiguous "
                             f"float32, bfloat16 or float16 values of one "
                             f"type on {dev}, got {x.dtype} on {x.device} "
                             f"({floats[0][0]} is {floats[0][1].dtype})")
    if rows.shape != (rows_cap,) or count.numel() != 1:
        raise ValueError(f"rows {tuple(rows.shape)} / count "
                         f"{tuple(count.shape)} do not fit rows_cap="
                         f"{rows_cap}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def entry_point(kernel: str, dtype: torch.dtype, ordered: bool) -> str:
    """The C entry point of a shared-memory launch of ``kernel``
    (``numeric_bin`` or ``fused_bin``) with values of ``dtype``: its
    fixed-order instance with ``ordered``.  Both kernels' bfloat16 and
    float16 entry points launch ``slot_rows_kernel``; float32
    ``fused_bin`` launches ``hash_rows_kernel``."""
    return kernel + ("_ordered" if ordered else "") + VALUE_TYPES[dtype]


def symbolic_bin_call(rows, count, a_rpt, a_col, b_rpt, b_col, *,
                      t_size: int, rows_cap: int, pack: int = 1,
                      single_access: bool = True):
    """Symbolic hash kernel over one bin -> (nnz, accesses), both
    (rows_cap,) int32, 0 on the padding rows.

    rows: (rows_cap,) int32 row ids (padded); count: (1,) int32 valid rows,
    read on the device.  ``pack`` rows share one block (a warp each).  On
    the card a block whose rows are all padding writes their zeros and
    exits.
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
    rows_per_cta, threads = launch_geometry(t_size, pack)
    nnz = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    route = rung_route(t_size, rows_per_cta, False, dev) if rows_cap \
        else "smem"
    if route != "smem":
        # The cluster kernel keeps the table on chip: no scratch table.
        scratch = (torch.empty((rows_cap, t_size), dtype=torch.int32,
                               device=dev) if route == "global" else None)
        _launch_extended(symbolic_bin_call, route, dev, rows, count, a_rpt,
                         a_col, None, b_rpt, b_col, None, t_size=t_size,
                         rows_cap=rows_cap, threads=threads,
                         single_access=single_access, nnz=nnz,
                         col_tabs=scratch, val_tabs=None, acc=acc)
    elif rows_cap:
        with torch.cuda.device(dev):
            err = build.library("spgemm_hash").symbolic_bin(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), b_rpt.data_ptr(), b_col.data_ptr(),
                t_size, rows_cap, rows_per_cta, threads, int(single_access),
                nnz.data_ptr(), acc.data_ptr(), _stream(dev))
        build.check(err, "symbolic_bin")
        symbolic_bin_call.launches += 1
    return nnz, acc


symbolic_bin_call.launches = symbolic_bin_call.launches_global = 0
symbolic_bin_call.launches_cluster = symbolic_bin_call.launches_ordered = 0


def numeric_bin_call(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                     *, t_size: int, rows_cap: int, single_access: bool):
    """Numeric hash kernel over one bin -> (col_tabs, val_tabs, accesses):
    col_tabs (rows_cap, t_size) int32 raw tables (-1 = empty), val_tabs
    (rows_cap, t_size) in ``a_val.dtype``, accesses (rows_cap,) int32 (0
    on the padding rows).

    On the card the tables of rows at or past ``count`` are NOT written
    (``torch.empty``: they hold whatever the memory held); only rows below
    ``count`` carry tables.  The plain version writes them empty.

    The reference never packs rows here: packing is a layout of its VMEM
    tiles, which the card does not have.  On the card the launch takes
    :func:`numeric_launch_geometry`: 8 rows to a block, a warp each, on
    the rungs where one row gets one warp, one row to a block above.  The
    output is (rows_cap, t_size) per row either way.  A table entry is one
    64-bit word in shared memory (the key and the value's bits), so a
    single 64-bit CAS claims a slot and adds the value; the hash's mod
    by t_size (2^k - 1 on the numeric ladder) is a multiply-high by the
    constants of :func:`hash_mod`, with the reference's slots.  A rung
    whose tables exceed shared memory (the extended ladder's 32,768 and
    up) runs on the cluster or the global-memory kernel instead
    (:func:`hash_route`).  Under ``torch.use_deterministic_algorithms(True)``
    every route takes its fixed-order instance.
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
    rows_per_cta, threads = numeric_launch_geometry(t_size)
    col_tabs = torch.empty((rows_cap, t_size), dtype=torch.int32, device=dev)
    val_tabs = torch.empty((rows_cap, t_size), dtype=a_val.dtype,
                           device=dev)
    acc = torch.empty(rows_cap, dtype=torch.int32, device=dev)
    ordered = torch.are_deterministic_algorithms_enabled()
    route = rung_route(t_size, rows_per_cta, True, dev) if rows_cap \
        else "smem"
    if route != "smem":
        _launch_extended(numeric_bin_call, route, dev, rows, count, a_rpt,
                         a_col, a_val, b_rpt, b_col, b_val, t_size=t_size,
                         rows_cap=rows_cap, threads=threads,
                         single_access=single_access, nnz=None,
                         col_tabs=col_tabs, val_tabs=val_tabs, acc=acc,
                         ordered=ordered)
    elif rows_cap:
        entry = entry_point("numeric_bin", a_val.dtype, ordered)
        with torch.cuda.device(dev):
            err = getattr(build.library("spgemm_hash"), entry)(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), a_val.data_ptr(), b_rpt.data_ptr(),
                b_col.data_ptr(), b_val.data_ptr(), t_size, rows_cap,
                rows_per_cta, threads, int(single_access), *hash_mod(t_size),
                col_tabs.data_ptr(), val_tabs.data_ptr(), acc.data_ptr(),
                _stream(dev))
        build.check(err, entry)
        numeric_bin_call.launches += 1
        numeric_bin_call.launches_ordered += int(ordered)
    return col_tabs, val_tabs, acc


numeric_bin_call.launches = numeric_bin_call.launches_global = 0
numeric_bin_call.launches_cluster = numeric_bin_call.launches_ordered = 0


def fused_outputs(rows_cap: int, t_size: int, device,
                  dtype: torch.dtype = torch.float32) -> Tuple:
    """Uninitialised (nnz, col_tabs, val_tabs, accesses) for one fused
    launch with values of ``dtype``, allocated on the current stream."""
    return (torch.empty(rows_cap, dtype=torch.int32, device=device),
            torch.empty((rows_cap, t_size), dtype=torch.int32, device=device),
            torch.empty((rows_cap, t_size), dtype=dtype, device=device),
            torch.empty(rows_cap, dtype=torch.int32, device=device))


def fused_bin_call(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val,
                   *, t_size: int, rows_cap: int, pack: int = 1,
                   single_access: bool = True, out: Optional[Tuple] = None):
    """Fused symbolic->numeric hash kernel over one bin ->
    (nnz, col_tabs, val_tabs, accesses):
      nnz      (rows_cap,) int32 distinct columns per row (0 on padding);
      col_tabs (rows_cap, t_size) int32 raw tables (-1 = empty);
      val_tabs (rows_cap, t_size) accumulated values in ``a_val.dtype``;
      accesses (rows_cap,) int32 table transactions per row (0 on padding).

    On the card the tables of rows at or past ``count`` are NOT written
    (their blocks exit first); the plain version writes them empty.
    ``out`` (CUDA only) takes the four outputs from :func:`fused_outputs`,
    so a caller can allocate them on another stream than the launch's.
    Under ``torch.use_deterministic_algorithms(True)`` every route takes
    its fixed-order instance.  In bfloat16 and float16 the shared-memory
    rungs run on ``numeric_bin``'s slot kernel (:func:`entry_point`): one
    64-bit CAS claims a slot and adds, the row's nnz its claimed slots.
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
    rows_per_cta, threads = launch_geometry(t_size, pack)
    nnz, col_tabs, val_tabs, acc = (
        fused_outputs(rows_cap, t_size, dev, a_val.dtype) if out is None
        else out)
    if val_tabs.dtype != a_val.dtype:
        raise ValueError(f"val_tabs is {val_tabs.dtype}, the values "
                         f"{a_val.dtype}")
    ordered = torch.are_deterministic_algorithms_enabled()
    route = rung_route(t_size, rows_per_cta, True, dev) if rows_cap \
        else "smem"
    if route != "smem":
        _launch_extended(fused_bin_call, route, dev, rows, count, a_rpt,
                         a_col, a_val, b_rpt, b_col, b_val, t_size=t_size,
                         rows_cap=rows_cap, threads=threads,
                         single_access=single_access, nnz=nnz,
                         col_tabs=col_tabs, val_tabs=val_tabs, acc=acc,
                         ordered=ordered)
    elif rows_cap:
        entry = entry_point("fused_bin", a_val.dtype, ordered)
        with torch.cuda.device(dev):
            err = getattr(build.library("spgemm_hash"), entry)(
                rows.data_ptr(), count.data_ptr(), a_rpt.data_ptr(),
                a_col.data_ptr(), a_val.data_ptr(), b_rpt.data_ptr(),
                b_col.data_ptr(), b_val.data_ptr(), t_size, rows_cap,
                rows_per_cta, threads, int(single_access), nnz.data_ptr(),
                col_tabs.data_ptr(), val_tabs.data_ptr(), acc.data_ptr(),
                _stream(dev))
        build.check(err, entry)
        fused_bin_call.launches += 1
        fused_bin_call.launches_ordered += int(ordered)
    return nnz, col_tabs, val_tabs, acc


fused_bin_call.launches = fused_bin_call.launches_global = 0
fused_bin_call.launches_cluster = fused_bin_call.launches_ordered = 0

KERNELS = (symbolic_bin_call, numeric_bin_call, fused_bin_call)


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts (all, cluster, global,
    fixed-order) to 0."""
    for fn in KERNELS:
        fn.launches = fn.launches_cluster = fn.launches_global = 0
        fn.launches_ordered = 0


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
    scatter.scatter_kept(c_col, target, col_sorted.view(-1),
                         limit=nnz_capacity)
    scatter.scatter_kept(c_val, target, val_sorted.view(-1),
                         limit=nnz_capacity)
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
    scatter.scatter_kept(c_col, target, subC.col, limit=nnz_capacity)
    scatter.scatter_kept(c_val, target, subC.val, limit=nnz_capacity)
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
    scatter.scatter_kept(nnz_buf, rows.long().masked_fill(~valid, m + 1),
                         nnz_rows, limit=m + 1)


def symbolic_scheduled(A: CSR, B: CSR, binning: Binning, ladder: BinLadder,
                       *, row_buckets, fallback_prod_capacity: int = 0,
                       single_access: bool = True, row_packing: bool = False,
                       collect_accesses: bool = False,
                       workspace: Optional[esc.Workspace] = None):
    """Symbolic phase over a bucketed schedule, with no host sync.

    Rungs are dispatched LARGEST first (the §5.5 launch-order rule),
    beginning with the ESC fallback rung.  Returns ``(nnz_buf, sub_prod,
    accesses)``: the (M+1,) n_nz buffer, the fallback rung's product total
    (the caller verifies it against ``fallback_prod_capacity``: an
    overflowed fallback truncates its expansion) and the summed table
    accesses (0 unless ``collect_accesses``).  ``row_packing`` packs
    ``ladder.rows_per_block[b]`` rows per block (``row_buckets`` must then
    be multiples of the pack, as ``host_schedule(packs=...)`` makes them).
    ``workspace`` (an arena lease's buffers) is the fallback rung's
    expansion storage (``esc.expand_products(out=...)``).
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m = A.nrows
    dev = A.device
    with _range("hash_rungs"):
        nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=dev)
        accesses = torch.zeros((), dtype=torch.int64, device=dev)
        sub_prod = torch.zeros((), dtype=torch.int64, device=dev)

    if row_buckets[-1]:
        # Global-memory-analog rung: ESC on the gathered sub-matrix.
        with _range("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            sub_nnz = esc.symbolic(sub, B,
                                   prod_capacity=fallback_prod_capacity,
                                   workspace=workspace)
            _scatter_nnz(nnz_buf, rows, valid, sub_nnz[:rows.shape[0]], m)

    with _range("hash_rungs"):
        for b in range(len(ladder.table_sizes) - 1, -1, -1):
            rows_cap = row_buckets[b]
            if not rows_cap:
                continue
            pack = min(ladder.rows_per_block[b] if row_packing else 1,
                       rows_cap)
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
                  headroom: float = 1.0,
                  packs: Optional[Tuple[int, ...]] = None, read=None):
    """Host-side schedule derivation (the cold path's metadata sync).

    Reads the bin sizes, buckets each rung's row count to a pow-2 capacity
    (0 = empty rung, skipped), and, when the fallback rung is populated,
    reads its product total to size the ESC expansion.  ``headroom``
    over-provisions the buckets so steady-state bin-count jitter stays
    inside them; ``packs`` (per table rung) floors each populated rung's
    bucket at its rows-per-block.  Each read runs inside ``read(name)``
    (``sync:bins``, ``sync:fall``): the engine's steps path passes its
    ``StepTimer.read``, which counts it; alone, a read gets its profiler
    range.
    """
    read = read or _range
    with read("sync:bins"):
        sizes = binning.bin_size.tolist()       # host sync: launch schedule
    m_cap = next_bucket(binning.bins.shape[0], minimum=_ROW_BUCKET_MIN)
    row_buckets = tuple(
        schedule_bucket(
            s, m_cap=m_cap, headroom=headroom,
            pack=(packs[b] if packs is not None and b < len(packs) else 1))
        for b, s in enumerate(sizes))
    fallback_prod_capacity = 0
    if row_buckets[-1]:
        with read("sync:fall"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1],
                                         A.nrows)
            sub_prod = int(_fallback_sub_prod(A, B, rows, valid))  # sync
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
                      collect_accesses: bool = False,
                      workspace: Optional[esc.Workspace] = None):
    """Numeric phase over a bucketed schedule, with no host sync.

    Mirrors :func:`symbolic_scheduled` (``workspace`` included).  Returns
    ``(C, sub_prod, accesses)``; the caller verifies ``sub_prod`` against
    ``fallback_prod_capacity``.
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m, n = A.nrows, B.ncols
    dev = A.device
    with _range("hash_alloc"):
        c_col = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
        c_val = torch.zeros(nnz_capacity + 1, dtype=A.val.dtype, device=dev)
    with _range("hash_rungs"):
        accesses = torch.zeros((), dtype=torch.int64, device=dev)
        sub_prod = torch.zeros((), dtype=torch.int64, device=dev)

    if row_buckets[-1]:
        with _range("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            subC = esc.spgemm_fused(sub, B,
                                    prod_capacity=fallback_prod_capacity,
                                    nnz_capacity=fallback_prod_capacity,
                                    workspace=workspace)
            scatter_sub_rows(subC, rows, valid, rpt, c_col, c_val,
                             nnz_capacity=nnz_capacity)

    for b in range(len(ladder.table_sizes) - 1, -1, -1):
        rows_cap = row_buckets[b]
        if not rows_cap:
            continue
        with _range("hash_rungs"):
            rows, count = binning.rows_of_bin(b, rows_cap)
            col_tabs, val_tabs, acc_bin = numeric_bin_call(
                rows, count.reshape(1), A.rpt, A.col, A.val, B.rpt, B.col,
                B.val, t_size=ladder.table_sizes[b], rows_cap=rows_cap,
                single_access=single_access)
        with _range("hash_epilogue"):
            numeric_epilogue(col_tabs, val_tabs, rows, count, rpt, c_col,
                             c_val, nnz_capacity=nnz_capacity)
        if collect_accesses:
            with _range("hash_rungs"):
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


class FusedRung(NamedTuple):
    """One populated table rung of a fused launch schedule."""
    b: int
    t_size: int
    rows_cap: int
    pack: int
    rows: torch.Tensor     # (rows_cap,) int32 row ids, padded
    count: torch.Tensor    # (1,) int32 valid rows, on the device


def fused_rungs(binning: Binning, ladder: BinLadder, row_buckets, *,
                row_packing: bool = False) -> List[FusedRung]:
    """The schedule's populated table rungs, largest tables first (the
    §5.5 launch-order rule), with their row ids and counts."""
    out = []
    for b in range(len(ladder.table_sizes) - 1, -1, -1):
        rows_cap = row_buckets[b]
        if not rows_cap:
            continue
        pack = min(ladder.rows_per_block[b] if row_packing else 1, rows_cap)
        rows, count = binning.rows_of_bin(b, rows_cap)
        out.append(FusedRung(b, ladder.table_sizes[b], rows_cap, pack, rows,
                             count.reshape(1)))
    return out


def launch_fused_rungs(A: CSR, B: CSR, rungs: List[FusedRung], *,
                       single_access: bool = True) -> List[Tuple]:
    """:func:`fused_bin_call` for each rung, in the given order ->
    one (nnz, col_tabs, val_tabs, accesses) per rung.

    On the card each rung runs on its own side stream, so the rungs
    overlap: a rung's tail (the top rung holds one CTA per SM) leaves SMs
    to the others.  The outputs are allocated on the current stream before
    the fork, and the current stream waits on every side stream before this
    returns: whatever the caller enqueues next, including the completion
    event that ``SpgemmEngine.submit``/``drain`` record after a dispatch,
    runs after every rung, and the caching allocator cannot hand the
    outputs or the inputs to other work early.  No host sync.
    """
    def launch(rung, out=None):
        return fused_bin_call(
            rung.rows, rung.count, A.rpt, A.col, A.val, B.rpt, B.col, B.val,
            t_size=rung.t_size, rows_cap=rung.rows_cap, pack=rung.pack,
            single_access=single_access, out=out)

    if A.device.type != "cuda":
        return [launch(rung) for rung in rungs]
    dev = A.device
    outs = [fused_outputs(rung.rows_cap, rung.t_size, dev, A.val.dtype)
            for rung in rungs]
    current = torch.cuda.current_stream(dev)
    fork = torch.cuda.Event()
    fork.record(current)
    for rung, out in zip(rungs, outs):
        stream = torch.cuda.Stream(device=dev)     # from torch's pool
        stream.wait_event(fork)
        with torch.cuda.stream(stream):
            launch(rung, out)
        current.wait_stream(stream)
    return outs


def fused_scheduled(A: CSR, B: CSR, binning: Binning, ladder: BinLadder, *,
                    row_buckets, nnz_capacity: int,
                    fallback_prod_capacity: int = 0,
                    single_access: bool = True, row_packing: bool = False,
                    collect_accesses: bool = False,
                    workspace: Optional[esc.Workspace] = None):
    """Fused symbolic->numeric phase over a bucketed schedule, no host sync.

    ONE binning (by n_prod, the symbolic ladder) and ONE table build per
    row: each populated rung's :func:`fused_bin_call` emits per-row nnz AND
    the accumulated (col, val) tables; the fallback rung runs the
    single-expansion ESC (its n_nz read off the sub-result's rpt).  Once
    every row's nnz is known the row pointers are an exclusive sum and the
    dumped tables condense/sort/scatter into C.  Symbolic-ladder tables
    are sized by n_prod (>= n_nz), so they never overflow.

    On the card the table rungs run concurrently
    (:func:`launch_fused_rungs`): forked from the current stream after the
    fallback rung, one side stream each, largest tables first, and joined
    back into the current stream before the exclusive sum.  On the CPU they
    run one after another in the same order.  The fallback rung, and with
    it ``workspace`` (the expansion's storage, as in
    :func:`symbolic_scheduled`), stays on the current stream.

    Returns ``(C, nnz, sub_prod, accesses)``: the assembled CSR, the (M,)
    per-row nnz, the fallback rung's product total to verify against
    ``fallback_prod_capacity``, and the summed table accesses (0 unless
    ``collect_accesses``).
    """
    _check_schedule(row_buckets, ladder, fallback_prod_capacity)
    m, n = A.nrows, B.ncols
    dev = A.device
    with _range("hash_rungs"):
        nnz_buf = torch.zeros(m + 2, dtype=torch.int32, device=dev)
        accesses = torch.zeros((), dtype=torch.int64, device=dev)
        sub_prod = torch.zeros((), dtype=torch.int64, device=dev)
    fallback = None
    kept = []

    if row_buckets[-1]:
        # Global-memory-analog rung, fused form: one ESC expansion yields
        # both the sub-result values AND (via its rpt) the per-row nnz.
        with _range("hash_fallback"):
            rows, valid = _fallback_rows(binning, ladder, row_buckets[-1], m)
            sub = gather_rows(A, rows, valid)
            sub_prod = _fallback_sub_prod(A, B, rows, valid)
            subC = esc.spgemm_fused(sub, B,
                                    prod_capacity=fallback_prod_capacity,
                                    nnz_capacity=fallback_prod_capacity,
                                    workspace=workspace)
            _scatter_nnz(nnz_buf, rows, valid, subC.nnz_per_row(), m)
        fallback = (subC, rows, valid)

    with _range("hash_rungs"):
        rungs = fused_rungs(binning, ladder, row_buckets,
                            row_packing=row_packing)
        outs = launch_fused_rungs(A, B, rungs, single_access=single_access)
        for rung, (nnz_bin, col_tabs, val_tabs, acc_bin) in zip(rungs, outs):
            rows, count = rung.rows, rung.count
            valid = torch.arange(rung.rows_cap, device=dev) < count
            _scatter_nnz(nnz_buf, rows, valid, nnz_bin, m)
            if collect_accesses:
                accesses = accesses + acc_bin.masked_fill(~valid, 0).sum()
            kept.append((rows, count, col_tabs, val_tabs))

    nnz_buf = nnz_buf[:m + 1]
    nnz = nnz_buf[:m]
    with _range("hash_alloc"):
        rpt = exclusive_sum_in_place(nnz_buf)
        c_col = torch.zeros(nnz_capacity + 1, dtype=torch.int32, device=dev)
        c_val = torch.zeros(nnz_capacity + 1, dtype=A.val.dtype, device=dev)
    if fallback is not None:
        subC, rows, valid = fallback
        with _range("hash_fallback"):
            scatter_sub_rows(subC, rows, valid, rpt, c_col, c_val,
                             nnz_capacity=nnz_capacity)
    with _range("hash_epilogue"):
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
