// Per-bin hash-table SpGEMM kernels for Hopper (sm_90a): OpSparse §5.2, §5.6.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/spgemm_hash.py:
//   symbolic_bin  <- symbolic_bin_call / _make_symbolic_kernel (keys only:
//                    distinct columns per row + table accesses per row)
//   numeric_bin   <- numeric_bin_call / _make_numeric_kernel ((col, val)
//                    tables on the numeric ladder, raw tables dumped)
//   fused_bin     <- fused_bin_call / _make_fused_kernel (one (col, val)
//                    table build per row: nnz, raw tables and accesses)
//
// What each computes is the TPU kernel's function, not its block layout.
// Four kernel bodies: hash_rows_kernel runs symbolic_bin and float32
// fused_bin, slot_rows_kernel numeric_bin and 16-bit fused_bin, both with
// tables in shared memory;
// on the rungs whose tables do not fit a block's shared memory (the
// vmem_extended ladders) cluster_rows_kernel runs all three where the
// table fits the shared memory of a thread-block cluster of up to 8
// blocks, and global_rows_kernel where it does not.  Common to all:
//   * Row mapping.  A group of `threads_per_row` threads owns one output row
//     and its table; a CTA holds `rows_per_cta` such groups (a warp each
//     when there are several).  Inside a row, warp w takes A entries
//     a_lo+w, a_lo+w+W, ..., fetched 32 at a time (column, value, B row
//     bounds), one per lane, so the dependent global loads are paid once
//     per 32 entries.
//   * Tables live in (dynamic) shared memory, one `t_size` slice per row
//     (split over a cluster's blocks in cluster_rows_kernel), but for
//     global_rows_kernel's.  The fused top rung of the default
//     ladder (24576 entries x 8 B = 196,608 B) needs the opt-in above 48 KB.
//   * Hash: key*107 as a uint32 product (no signed overflow), reduced with
//     AND for a power-of-two table and with a floor mod of the int32 value
//     otherwise: the reference's slot for every key, never a negative one.
//     Linear probing; the probe guard is 2*t_size slots as in the
//     reference.
//   * The bin size is read from device memory (`count`), never from the
//     host.  Rows at or past it emit nnz 0 and accesses 0, and their tables
//     are NOT written: the wrappers allocate the tables with torch.empty,
//     so a padding row's table holds whatever the memory held.  The one
//     consumer, numeric_epilogue, masks rows >= count.  A CTA whose first
//     row is at or past `count` writes its rows' zeros and returns before
//     it touches shared memory; a CTA that holds a valid row and, packed,
//     some padding rows writes empty tables for those.
//   * Raw tables go out with stride t_size (no TPU lane padding), with
//     16-byte stores from the first 16-byte boundary of the CTA's range
//     (numeric-ladder sizes, 2^k - 1, are not multiples of 4, so the ends
//     go word by word).
//
// hash_rows_kernel (symbolic_bin, fused_bin in float32): the lanes of a
// warp stride over one B row at a time (j = lo + lane), and every lane
// inserts with `insert`: keys with a 32-bit atomicCAS, values with
// atomicAdd (a CAS loop for float).
// Accesses per row: one per probe with single access (Alg 4/5: the CAS is
// the probe), and with check-then-CAS one for the read plus one for the
// CAS whenever an empty slot is claimed.  fused_scheduled (spgemm_hash.py)
// launches its rungs on side streams, so a rung's tail, where few CTAs of
// the top rung hold most SMs' shared memory, overlaps the other rungs.
//
// slot_rows_kernel (numeric_bin; fused_bin in bfloat16 and float16) walks a
// row's products as hash_rows_kernel does (entry by entry, the lanes
// striding the entry's B row), with:
//   * One 64-bit slot per entry, the key in the low word and the value's
//     bits in the high word (empty: key -1, +0.0).  One 64-bit atomicCAS
//     claims an empty slot and stores the value; a hit on the row's own key
//     adds by CAS on the value it saw.  This replaces the key CAS plus the
//     value atomicAdd: on float a CAS spin loop (ATOMS.CAST.SPIN), on a
//     16-bit value a CAS loop on the 32-bit word it shares with its
//     neighbour's (ATOM.E.CAS), which linear probing's neighbouring claims
//     make fail and retry.  8 B per entry, as a float32 key and value side
//     by side take, so CTAs per SM do not change.  The dump splits the
//     slots into col_tabs and val_tabs; for fused_bin the 16-bit instances
//     count each row's occupied slots after the inserts (its nnz).
//   * No divide in the hash: the floor mod by a t_size that is not a power
//     of two (the numeric ladder's 2^k - 1) is a multiply-high by constants
//     the wrapper computes once per t_size (HashMod below), exact for every
//     key.
//   * rows_per_cta rows to a CTA, a warp each, where the wrapper packs
//     (numeric_launch_geometry); the last CTA may hold fewer rows when
//     rows_per_cta does not divide rows_cap.
//   * At most 32 registers a thread (__launch_bounds__(1024, 2)), so two
//     1024-thread CTAs still fit an SM on the top rungs.  (hash_rows_kernel
//     in 16-bit values held 40, which left room for one.)
//   On fused_bin's default ladder (one block a row, t_size / 8 threads) the
//   threads bound the blocks an SM holds, 32 down to 2, not the 8 B an
//   entry; the top rung (24,576 entries, 196,616 B) holds one, as it would
//   at 6 B.
//   Accesses per row: one per shared-memory transaction on the table.
//   Single access: each atomicCAS is one; a product claims an empty slot
//   in one, adds to its own key in two (the CAS that expected an empty
//   slot returns the current value, the next one adds to it), and pays one
//   per slot held by another key and one per CAS lost to another lane.
//   Check-then-CAS: every read of a slot is one, and every CAS after it
//   one more.  So each product costs at least one access (accesses >=
//   n_prod on a valid row), padding rows 0, and per product single access
//   never costs more than check-then-CAS, whose claims and hits cost two.
//   The lost CAS races do not count against the probe guard, which counts
//   slots.
//
// global_rows_kernel (the tables no cluster holds: on the extended ladders
// symbolic 1,048,576, fused 262,144 and 1,048,576, numeric 524,288, 2 to
// 8 MB a row): one row to a 1024-thread CTA, which fills its own output row
// of col_tabs / val_tabs (a scratch table for symbolic_bin) with -1 / 0,
// waits at a barrier, and inserts there with the same `insert` as
// hash_rows_kernel, now on device memory: a 32-bit atomicCAS on the key and
// a native float atomicAdd on the value, the reference's hash (AND on these
// power-of-two sizes), linear probing and the 2*t_size guard.  Nothing is
// dumped: the table is the output.  Row offsets are 64-bit (a bucket of
// 4,096 rows of 524,288 entries holds 2^31 of them).  Padding rows write
// nnz 0 and accesses 0 and leave their tables unwritten, as above.  At most
// 32 registers a thread (__launch_bounds__(1024, 2)), the ORDERED instance
// too, whose value pass stages in 12 KB of static shared memory.  The
// tables of the CTAs in flight (264 x 2 MB and up) exceed the 50 MB L2, so
// part of the atomics reach HBM.
//
// cluster_rows_kernel (tables of 32,768 to 262,144 entries that a cluster
// holds: 8 B a slot with values, 4 B without, t_size / C slots a block,
// C <= 8, each block's share within its shared memory; the wrapper picks C,
// spgemm_hash.py: hash_route and CLUSTER_SIZES): one row a cluster, the
// way the reference keeps each row's table in its core's VMEM.
//   * Slot h lives in rank h / (t_size / C) at offset h % (t_size / C);
//     every probe goes to the slot's block through distributed shared
//     memory (mapa to a shared::cluster address, then atom / ld / red
//     .shared::cluster; the SASS shows generic ATOM.E / LD.E on the shared
//     window, no ATOMG), its own block's slots too, with the reference's
//     hash (AND on these power-of-two sizes), linear probing that wraps
//     across ranks and the 2*t_size guard.  With values a slot is 64 bits
//     as in slot_rows_kernel (one CAS claims and adds, no float atomic on
//     remote shared memory), keys only a 32-bit CAS as in hash_rows_kernel.
//   * Work split by chunks, not by A entries: each block loads the row's A
//     entries (a window of up to blockDim.x at a time) into shared memory
//     with each B row's bounds and an exclusive scan of its chunk counts
//     (32 products a chunk), and chunk g goes to warp g mod (C x warps a
//     block) of the cluster, its lanes on the chunk's 32 B entries.  On
//     mono_500Hz the first split (warp w of the cluster took entries w, w +
//     W, ... and strode each whole B row) left the warp with the longest B
//     rows 3-5 times the chunks of the mean warp, and the row waited for it.
//   * Each block fills its slice empty, then cluster.sync() (every block of
//     the cluster has started and filled before the first remote access);
//     each warp adds its nnz and accesses to rank 0's counters; a second
//     cluster.sync() ends the inserts, after which no block touches a
//     peer's memory: rank 0 writes the row's counts and each block dumps
//     its own slice to col_tabs / val_tabs at row * t_size + rank * slice
//     (64-bit offsets, 16-byte stores; symbolic_bin dumps nothing).  A
//     padding row's blocks all leave before the first barrier.
//   * At most 32 registers a thread (__launch_bounds__(1024, 2)), so that
//     two blocks fit an SM where the slices are 64 KB or less; the row,
//     rank and thread indices are read again from their special registers
//     after the loops rather than held across them; the ORDERED instance
//     too (its table re-reads them at each find).  Its value pass runs
//     between the second cluster.sync() and a third, reading the peers'
//     keys, and stages in the entry list's memory.
//
// What bounds them on the card: device-memory bytes for the valid rows (B
// reads, the raw table dump), and, inside a row, the latency of the chain
// A entry -> B row pointers -> B entries -> shared (or, on the global rungs,
// L2) atomics.
//
// The fixed-order value mode (the *_ordered entry points, which the
// wrappers launch under torch.use_deterministic_algorithms(True)): an
// ORDERED instance of each body that builds values (hash_rows_kernel_ordered,
// slot_rows_kernel, global_rows_kernel, cluster_rows_kernel) inserts a
// row's keys as the atomic kernels do, then adds its products in the
// reference's order, so its values are the plain version's bit for bit,
// run after run.  All of the row's warps share that value pass: each makes
// batches of the row's products in turn (loads, rounded product, slot) and
// adds those whose slot it owns (ordered_values below).  Its stage takes
// about 12 B a thread of shared memory beside the tables (stage_bytes).
// The ORDERED instances keep to 32 registers (__launch_bounds__(1024, 2))
// without a spill, as the atomic ones do.
//
// Value types: every body that builds values is a template on its value
// type V, float, __nv_bfloat16 or __half (template argument VT = 0, 1, 2;
// the entry points of the 16-bit types end in _bf16 / _f16).  Tables hold
// V, and each product is rounded to V and added in V, as the reference's
// tables in a_val.dtype are: a 16-bit value is never widened to float32
// in a table.  The products and sums are taken in float32 and rounded to V
// once (exact for the product of two 16-bit values; for the sum, float32
// has more than twice V's digits plus two, so the one rounding of the
// float32 sum to V is V's correctly rounded sum), so the ORDERED instances
// are the plain version's value for value in every type.  Where a type
// changes a table's size: hash_rows_kernel, whose value add is atomicAdd on
// V, takes float32 only (fused_bin's 16-bit launches go to
// slot_rows_kernel); slot_rows_kernel and cluster_rows_kernel keep their
// 64-bit key+value slot in every type (the 16-bit value's bits in bits
// 32-47), so the one 64-bit CAS still claims a slot and adds, and every
// shared-memory table takes 8 B an entry in every type; global_rows_kernel's
// tables are its outputs (int32 keys, V values), its value add atomicAdd on
// V (on device memory, native on sm_90 for all three).
//
// Every entry point returns cudaGetLastError() right after its launch (or
// the error of the shared-memory opt-in); the Python wrapper raises on
// anything but 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// A value type's conversions: to and from float32 (from: rounded to
// nearest even), and its bits.  round(f) is f rounded to V and back.
template <int VT>
struct Val;

template <>
struct Val<0> {
  using T = float;
  using Bits = unsigned;
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float f) { return f; }
  __device__ static Bits bits(float f) { return __float_as_uint(f); }
  __device__ static float of_bits(Bits b) { return __uint_as_float(b); }
  __device__ static float round(float f) { return f; }
};

template <>
struct Val<1> {
  using T = __nv_bfloat16;
  using Bits = unsigned short;
  __device__ static float to_f(T v) { return __bfloat162float(v); }
  __device__ static T from_f(float f) { return __float2bfloat16_rn(f); }
  __device__ static Bits bits(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ static float of_bits(Bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  __device__ static float round(float f) { return of_bits(bits(f)); }
};

template <>
struct Val<2> {
  using T = __half;
  using Bits = unsigned short;
  __device__ static float to_f(T v) { return __half2float(v); }
  __device__ static T from_f(float f) { return __float2half_rn(f); }
  __device__ static Bits bits(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
  __device__ static float of_bits(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  __device__ static float round(float f) { return of_bits(bits(f)); }
};

template <int VT>
using ValT = typename Val<VT>::T;

constexpr int kEmpty = -1;
constexpr unsigned kHashScale = 107u;
constexpr int kGuardFactor = 2;
constexpr int kMaxRowThreads = 1024;  // a row's threads: a block at most

__device__ __forceinline__ int hash_init(int key, int t_size, bool pow2) {
  unsigned p = static_cast<unsigned>(key) * kHashScale;
  if (pow2) return static_cast<int>(p & static_cast<unsigned>(t_size - 1));
  int h = static_cast<int>(p) % t_size;  // int32 wrap, then floor mod
  return h < 0 ? h + t_size : h;
}

__device__ __forceinline__ int hash_next(int h, int t_size) {
  return h + 1 == t_size ? 0 : h + 1;
}

// The thread's index, the block's size and the block's index, read from
// their special registers anew at each call (asm volatile), so that they
// need no register across a loop.
__device__ __forceinline__ int thread_index_now() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int block_threads_now() {
  int v;
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned block_index_now() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// ---------------------------------------------------------------------------
// The fixed-order value pass of the ORDERED instances.
//
// The row's keys go in first, in parallel, as in the atomic kernels (the
// same probes, so the same access counts), with no values.  After a
// barrier all W warps of the row add its products in the reference's order
// -- A's entries in order, each entry's B row in order -- in batches of 32
// products, a product a lane, W batches a round:
//   * Every warp walks the row's A entries 32 at a time (an entry a lane,
//     an inclusive scan of their B rows' lengths), so all of them number
//     the same batches.  Warp w makes batch w of each round: for each
//     lane's product it finds the entry (a binary search over the lanes'
//     scan), loads b_col and b_val, rounds the product to V and finds its
//     slot by a read-only probe of the final keys.  It stages the batch's
//     (slot, product) pairs in shared memory sorted by owner, in lane
//     order within an owner, with each owner's place and count
//     (stage_batch).  The loads and probes of a round thus go W ways at
//     once.  Warp w owns the slots s with s % W == w: the slot is the
//     key's multiplicative hash (key * 107, then linear probing), not the
//     column, so a banded row's columns spread over the warps.
//   * After a barrier each warp gathers the products it owns from the
//     round's batches, batch after batch, and adds them 32 at a time
//     (add_staged).  A second barrier frees the stage.
//   * Within such 32 the products of one slot are added by its lowest
//     lane (the leader), in lane order (add_in_lane_order): when the
//     slots are all distinct that is one add a lane, and with repeats one
//     more step for each peer of the largest group.
// With one warp a row (the packed rows, W = 1) the warp adds each batch
// from its registers as soon as it has made it: no stage, no barrier.
//
// Why every value is the plain version's left fold ((0 + p1) + p2) + ...,
// bit for bit: all products of a key land in the key's one slot, and the
// slot's one owner adds them round after round, batch after batch within
// a round and lane after lane within a batch (the staging keeps that
// order), which is the reference's order.  Adds to other slots interleave with them in any order, which
// changes no value.  Each product is __fmul_rn(a, b) and each add
// __fadd_rn, which round every step and which nvcc never contracts into
// an FMA, each rounded to the value type V (Val<VT>::round; nothing for
// float).  Where a slot lands does not matter, since the epilogue sorts
// each row by column.  The lookups of this pass are not the reference's
// table transactions and are not counted.
//
// A table type gives find(key) (the slot holding the key, or -1 when this
// block adds nothing for it) and load / store of a slot's value (as float,
// a V value exactly), and its value type VT.
// ---------------------------------------------------------------------------

constexpr unsigned kAllLanes = 0xffffffffu;

// Adds each lane's product to its slot (slot < 0: nothing to add); the
// products of one slot are summed by its lowest lane, in lane order.  The
// loop takes as many steps as the largest group has peers.
template <class Table>
__device__ __forceinline__ void add_in_lane_order(const Table& table,
                                                  int slot, float prod,
                                                  int lane) {
  using Ops = Val<Table::VT>;
  const unsigned lanes = __ballot_sync(kAllLanes, slot >= 0);
  if (lanes == 0) return;  // warp uniform
  if ((lanes & (lanes - 1)) == 0) {  // one product: nothing to order
    if (slot >= 0)
      table.store(slot, Ops::round(__fadd_rn(table.load(slot), prod)));
  } else {
    const unsigned peers =
        __match_any_sync(kAllLanes, slot >= 0 ? slot : -1 - lane);
    const bool leader = slot >= 0 && __ffs(peers) - 1 == lane;
    float acc = 0.0f;
    unsigned rest = 0;  // the leader's peers still to add, lowest first
    if (leader) {
      acc = Ops::round(__fadd_rn(table.load(slot), prod));
      rest = peers & (peers - 1);
    }
    for (int steps = __reduce_max_sync(kAllLanes, __popc(rest)); steps > 0;
         --steps) {
      const float p =
          __shfl_sync(kAllLanes, prod, rest ? __ffs(rest) - 1 : lane);
      if (rest) {
        acc = Ops::round(__fadd_rn(acc, p));
        rest &= rest - 1;
      }
    }
    if (leader) table.store(slot, acc);
  }
  __syncwarp();  // the next batch's adds read these values
}

// The inclusive scan of v over the warp's lanes.
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int o = 1; o < 32; o *= 2) {
    const int t = __shfl_up_sync(kAllLanes, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Lane i holds a range of a list (end: the inclusive scan of the ranges'
// lengths); returns the lane whose range holds item t: the number of lanes
// that end at or before t (a binary search over the lanes), at most 31.
__device__ __forceinline__ int range_lane(int end, int t) {
  int s = 0;
  for (int step = 16; step > 0; step /= 2) {
    const int at = __shfl_sync(kAllLanes, end, s + step - 1);
    if (at <= t) s += step;
  }
  return min(s, 31);
}

// Product q + lane of a window of up to 32 A entries, one a lane (lane i:
// its A value av, end, the inclusive scan of the window's B rows' lengths,
// and off, where its B row starts less where its products start in the
// window; the window holds `total` products): returns the product's slot
// (-1 past the window's end, or where find has none) and sets *prod to the
// product rounded to V.
template <class Table>
__device__ __forceinline__ int product_slot(
    const Table& table, const int* __restrict__ b_col,
    const ValT<Table::VT>* __restrict__ b_val, int off, float av, int end,
    int total, int q, int lane, float* prod) {
  using Ops = Val<Table::VT>;
  const int t = q + lane;
  const int s = range_lane(end, t);
  const int j = __shfl_sync(kAllLanes, off, s) + t;
  const float a = __shfl_sync(kAllLanes, av, s);
  if (t >= total) return -1;
  *prod = Ops::round(__fmul_rn(a, Ops::to_f(b_val[j])));
  return table.find(b_col[j]);
}

// The stage of a row of `warps` (<= 32) warps: the round's batches, 32
// (slot, product bits) pairs each, then for each batch b and owner w the
// word counts[(warps + 1) * b + w] = (the owner's first place in the
// batch) | (its products there) << 16 (padded by one word a batch, so that
// the owner's reads of its column hit distinct banks).
__host__ __device__ constexpr int stage_words(int warps) {
  return 2 * 32 * warps + warps * (warps + 1);
}

// The warp of `warps` that owns a slot.
__device__ __forceinline__ int slot_owner(int slot, int warps) {
  return (warps & (warps - 1)) == 0 ? slot & (warps - 1) : slot % warps;
}

// Stages batch `warp` of a round: each lane's product (slot < 0: none)
// goes to the batch's 32 pairs sorted by owner, in lane order within an
// owner, and the batch's word of each owner is written.
__device__ __forceinline__ void stage_batch(int2* stage, int slot, float prod,
                                            int warp, int warps, int lane) {
  int* counts = reinterpret_cast<int*>(stage + 32 * warps) +
                (warps + 1) * warp;
  const int owner = slot < 0 ? 32 : slot_owner(slot, warps);
  const unsigned peers = __match_any_sync(kAllLanes, owner);
  if (lane < warps) counts[lane] = 0;
  __syncwarp();
  if (owner < 32 && __ffs(peers) - 1 == lane) counts[owner] = __popc(peers);
  __syncwarp();
  const int n = lane < warps ? counts[lane] : 0;  // owner `lane`'s products
  const int first = warp_inclusive_scan(n, lane) - n;
  if (lane < warps) counts[lane] = first | n << 16;
  const int at = __shfl_sync(kAllLanes, first, owner & 31) +
                 __popc(peers & ((1u << lane) - 1));
  if (owner < 32) stage[32 * warp + at] = make_int2(slot, __float_as_int(prod));
}

// Adds, in order, the products of the `made` staged batches of a round
// whose slots warp `warp` of `warps` owns: batch after batch, 32 at a time
// (add_in_lane_order).  Block barriers before (the round is staged) and
// after (the stage may be reused).
template <class Table>
__device__ __forceinline__ void add_staged(const Table& table,
                                           const int2* stage, int made,
                                           int warp, int warps, int lane) {
  __syncthreads();
  const int word = lane < made ? reinterpret_cast<const int*>(
                                     stage + 32 * warps)[(warps + 1) * lane +
                                                         warp]
                               : 0;
  const int n = word >> 16, first = word & 0xffff;  // batch `lane`'s
  const int end = warp_inclusive_scan(n, lane);
  const int total = __shfl_sync(kAllLanes, end, 31);
  for (int q = 0; q < total; q += 32) {
    const int t = q + lane;
    const int b = range_lane(end, t);
    const int at = 32 * b + __shfl_sync(kAllLanes, first, b) + t -
                   (__shfl_sync(kAllLanes, end, b) -
                    __shfl_sync(kAllLanes, n, b));
    int slot = -1;
    float prod = 0.0f;
    if (t < total) {
      const int2 st = stage[at];
      slot = st.x;
      prod = __int_as_float(st.y);
    }
    add_in_lane_order(table, slot, prod, lane);
  }
  __syncthreads();
}

// A row's fixed-order value pass (A entries [a_lo, a_hi)), which each of
// the row's `warps` warps (<= 32) runs.  With more than one warp the block
// holds this one row, whose barriers are the block's, its warps are the
// block's (warp threadIdx.x / 32), and `stage` is stage_words(warps) words
// of its shared memory (8-byte aligned); with one, stage is not read.  The
// lane is read from its special register at each use, which keeps the
// ORDERED instances within 32 registers without a spill.
template <class Table>
__device__ __forceinline__ void ordered_values(
    const Table& table, int2* stage, const int* __restrict__ a_col,
    const ValT<Table::VT>* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const ValT<Table::VT>* __restrict__ b_val,
    int a_lo, int a_hi, int warps) {
  using Ops = Val<Table::VT>;
  const int warp = threadIdx.x / 32;
  int made = 0;  // batches of this round made so far, by every warp
  for (int base = a_lo; base < a_hi; base += 32) {
    const int e = base + thread_index_now() % 32;
    int len = 0, off = 0;
    float av = 0.0f;
    if (e < a_hi) {
      const int k = a_col[e];
      av = Ops::to_f(a_val[e]);
      off = b_rpt[k];
      len = b_rpt[k + 1] - off;
    }
    // Where this entry's products end in the window.
    const int end = warp_inclusive_scan(len, thread_index_now() % 32);
    const int total = __shfl_sync(kAllLanes, end, 31);
    off -= end - len;
    for (int q = 0; q < total; q += 32) {
      if (warps == 1) {
        float prod = 0.0f;
        const int slot =
            product_slot(table, b_col, b_val, off, av, end, total, q,
                         thread_index_now() % 32, &prod);
        add_in_lane_order(table, slot, prod, thread_index_now() % 32);
        continue;
      }
      if (made == warp) {
        float prod = 0.0f;
        const int slot =
            product_slot(table, b_col, b_val, off, av, end, total, q,
                         thread_index_now() % 32, &prod);
        stage_batch(stage, slot, prod, warp, warps, thread_index_now() % 32);
      }
      if (++made == warps) {
        add_staged(table, stage, made, warp, warps, thread_index_now() % 32);
        made = 0;
      }
    }
  }
  if (made > 0) {  // the last round
    add_staged(table, stage, made, warp, warps, thread_index_now() % 32);
  }
}

// A row's table as keys[] and vals[] side by side (hash_rows_kernel in
// shared memory, global_rows_kernel in device memory), probed with the
// reference's hash and linear probing.  Volatile: the keys were written by
// other warps' atomics, the values by other lanes.
template <int VT_>
struct KeyValTable {
  static constexpr int VT = VT_;
  using Bits = typename Val<VT>::Bits;
  const int* keys;
  ValT<VT>* vals;
  int t_size;
  bool pow2;

  __device__ int find(int key) const {
    int h = hash_init(key, t_size, pow2);
    for (int probed = 0; probed < kGuardFactor * t_size; ++probed) {
      const int k = reinterpret_cast<const volatile int*>(keys)[h];
      if (k == key) return h;
      if (k == kEmpty) return -1;
      h = hash_next(h, t_size);
    }
    return -1;
  }
  __device__ float load(int h) const {
    return Val<VT>::of_bits(reinterpret_cast<volatile Bits*>(vals)[h]);
  }
  __device__ void store(int h, float v) const {
    reinterpret_cast<volatile Bits*>(vals)[h] = Val<VT>::bits(v);
  }
};

// Inserts one product into a row's table; returns the table accesses it
// took and sets *inserted when it claimed an empty slot.  The value is
// added with atomicAdd on V (native on sm_90 for float, bf16 and half).
template <bool SINGLE_ACCESS, bool WITH_VALUES, class V>
__device__ __forceinline__ int insert(int* keys, V* vals, int key,
                                      V prod, int t_size, bool pow2,
                                      int guard, int* inserted) {
  int h = hash_init(key, t_size, pow2);
  int probes = 0;
  while (probes < guard) {
    if (SINGLE_ACCESS) {
      int old = atomicCAS(&keys[h], kEmpty, key);  // the one transaction
      probes += 1;
      if (old == kEmpty || old == key) {
        if (old == kEmpty) *inserted += 1;
        if (WITH_VALUES) atomicAdd(&vals[h], prod);
        break;
      }
    } else {
      int cur = reinterpret_cast<volatile int*>(keys)[h];  // transaction 1
      probes += 1;
      if (cur == key) {
        if (WITH_VALUES) atomicAdd(&vals[h], prod);
        break;
      }
      if (cur == kEmpty) {
        int old = atomicCAS(&keys[h], kEmpty, key);        // transaction 2
        probes += 1;
        if (old == kEmpty || old == key) {
          if (old == kEmpty) *inserted += 1;
          if (WITH_VALUES) atomicAdd(&vals[h], prod);
          break;
        }
        // Another key took the slot first: keep probing.
      }
    }
    h = hash_next(h, t_size);
  }
  return probes;
}

// Copies n elements (4 or 2 bytes: W = unsigned or unsigned short) from a
// shared-memory table to device memory: element by element up to dst's
// first 16-byte boundary, then 16-byte stores, then the tail.
template <class W>
__device__ __forceinline__ void dump_words(W* __restrict__ dst, const W* src,
                                           int n) {
  constexpr int kPer = 16 / sizeof(W);
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                          15) / static_cast<int>(sizeof(W)));
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int quads = (n - head) / kPer;
  const bool src_aligned =
      (static_cast<uint32_t>(__cvta_generic_to_shared(src + head)) & 15) == 0;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const int j = head + kPer * i;
    union {
      uint4 q;
      W e[kPer];
    } v;
    if (src_aligned) {
      v.q = *reinterpret_cast<const uint4*>(src + j);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) v.e[k] = src[j + k];
    }
    *reinterpret_cast<uint4*>(dst + j) = v.q;
  }
  for (int i = head + kPer * quads + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// Words of shared memory a block's value tables take (V padded to a word).
__host__ __device__ constexpr int value_words(int entries, int value_bytes) {
  return (entries * value_bytes + 3) / 4;
}

// The body of hash_rows_kernel and of its ORDERED instance.
template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED, int VT>
__device__ __forceinline__ void hash_rows(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const ValT<VT>* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const ValT<VT>* __restrict__ b_val,
    int t_size, int rows_per_cta, int threads_per_row,
    int* __restrict__ nnz_out, int* __restrict__ col_out,
    ValT<VT>* __restrict__ val_out, int* __restrict__ acc_out) {
  using V = ValT<VT>;
  using Ops = Val<VT>;
  using Bits = typename Ops::Bits;
  const int n_valid = *count;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  if (first >= n_valid) {
    // Padding CTA: counts only; its tables stay unwritten.
    if (threadIdx.x < rows_per_cta) {
      if (nnz_out) nnz_out[first + threadIdx.x] = 0;
      acc_out[first + threadIdx.x] = 0;
    }
    return;
  }

  extern __shared__ int smem[];
  const int cta_entries = rows_per_cta * t_size;
  int* keys = smem;
  V* vals = reinterpret_cast<V*>(smem + cta_entries);
  int* row_nnz =
      smem + cta_entries +
      (WITH_VALUES ? value_words(cta_entries, sizeof(V)) : 0);
  int* row_acc = row_nnz + rows_per_cta;

  for (int i = threadIdx.x; i < cta_entries; i += blockDim.x) {
    keys[i] = kEmpty;
    if (WITH_VALUES) vals[i] = Ops::from_f(0.0f);
  }
  if (threadIdx.x < rows_per_cta) {
    row_nnz[threadIdx.x] = 0;
    row_acc[threadIdx.x] = 0;
  }
  __syncthreads();

  const int local = threadIdx.x / threads_per_row;
  const int tid = threadIdx.x % threads_per_row;
  const int warps = threads_per_row / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long idx = first + local;
  const bool pow2 = (t_size & (t_size - 1)) == 0;
  const int guard = kGuardFactor * t_size;

  if (idx < n_valid) {   // uniform across a warp: a row is whole warps
    const int r = rows[idx];
    const int a_lo = a_rpt[r], a_hi = a_rpt[r + 1];
    int* row_keys = keys + local * t_size;
    V* row_vals = WITH_VALUES ? vals + local * t_size : nullptr;
    int inserted = 0, accesses = 0;
    // The warp's entries are a_lo + warp + warps*s, s = 0, 1, ...; lane l
    // fetches entry s0 + l of each batch of 32.
    for (int base = a_lo + warp; base < a_hi; base += 32 * warps) {
      const int e = base + lane * warps;
      int b_lo = 0, b_hi = 0;
      float av = 0.0f;
      if (e < a_hi) {
        const int k = a_col[e];
        if (WITH_VALUES) av = Ops::to_f(a_val[e]);
        b_lo = b_rpt[k];
        b_hi = b_rpt[k + 1];
      }
      const int batch = min(32, (a_hi - base + warps - 1) / warps);
      for (int s = 0; s < batch; ++s) {
        const int lo = __shfl_sync(0xffffffffu, b_lo, s);
        const int hi = __shfl_sync(0xffffffffu, b_hi, s);
        const float a = WITH_VALUES ? __shfl_sync(0xffffffffu, av, s) : 0.0f;
        for (int j = lo + lane; j < hi; j += 32) {
          const V prod =
              Ops::from_f(WITH_VALUES ? a * Ops::to_f(b_val[j]) : 0.0f);
          accesses += insert<SINGLE_ACCESS, WITH_VALUES && !ORDERED>(
              row_keys, row_vals, b_col[j], prod, t_size, pow2, guard,
              &inserted);
        }
      }
    }
    if (inserted) atomicAdd(&row_nnz[local], inserted);
    if (accesses) atomicAdd(&row_acc[local], accesses);
  }
  if (ORDERED) {
    __syncthreads();  // every key of the block's rows is in place
    if (n_valid > idx) {  // every warp of the row (the block's, if several)
      const int r = rows[idx];
      const KeyValTable<VT> table{keys + local * t_size,
                                  vals + local * t_size, t_size, pow2};
      ordered_values(table, reinterpret_cast<int2*>(smem) +
                                (row_acc + rows_per_cta - smem + 1) / 2,
                     a_col, a_val, b_rpt, b_col, b_val, a_rpt[r],
                     a_rpt[r + 1], warps);
    }
  }
  __syncthreads();

  if (threadIdx.x < rows_per_cta) {
    const bool valid = first + threadIdx.x < n_valid;
    if (nnz_out) nnz_out[first + threadIdx.x] = valid ? row_nnz[threadIdx.x] : 0;
    acc_out[first + threadIdx.x] = valid ? row_acc[threadIdx.x] : 0;
  }
  if (col_out) {
    const long long base = first * t_size;
    dump_words(reinterpret_cast<unsigned*>(col_out) + base,
               reinterpret_cast<const unsigned*>(keys), cta_entries);
    if (WITH_VALUES)
      dump_words(reinterpret_cast<Bits*>(val_out) + base,
                 reinterpret_cast<const Bits*>(vals), cta_entries);
  }
}

#define HASH_ROWS_PARAMS                                                     \
  const int *__restrict__ rows, const int *__restrict__ count,               \
      const int *__restrict__ a_rpt, const int *__restrict__ a_col,          \
      const ValT<VT> *__restrict__ a_val, const int *__restrict__ b_rpt,     \
      const int *__restrict__ b_col, const ValT<VT> *__restrict__ b_val,     \
      int t_size, int rows_per_cta, int threads_per_row,                     \
      int *__restrict__ nnz_out, int *__restrict__ col_out,                  \
      ValT<VT> *__restrict__ val_out, int *__restrict__ acc_out
#define HASH_ROWS_ARGS                                                       \
  rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,             \
      rows_per_cta, threads_per_row, nnz_out, col_out, val_out, acc_out

template <bool SINGLE_ACCESS, bool WITH_VALUES, int VT = 0>
__global__ void hash_rows_kernel(HASH_ROWS_PARAMS) {
  hash_rows<SINGLE_ACCESS, WITH_VALUES, false, VT>(HASH_ROWS_ARGS);
}

// The ORDERED instance (float32 fused_bin in the fixed-order mode): at
// most 32 registers a thread, so that two 1024-thread blocks fit an SM
// where their tables do (the 8,192- and 12,288-entry rungs).
template <bool SINGLE_ACCESS, int VT = 0>
__global__ void __launch_bounds__(1024, 2)
    hash_rows_kernel_ordered(HASH_ROWS_PARAMS) {
  hash_rows<SINGLE_ACCESS, true, true, VT>(HASH_ROWS_ARGS);
}

#undef HASH_ROWS_PARAMS
#undef HASH_ROWS_ARGS

// Dynamic shared memory of hash_rows_kernel: the keys, the values (of
// value_bytes each, padded to a word; none without values) and the rows'
// two counters.
size_t smem_bytes(int t_size, int rows_per_cta, bool with_values,
                  int value_bytes = 4) {
  const int entries = rows_per_cta * t_size;
  return 4 * (static_cast<size_t>(entries) +
              (with_values ? value_words(entries, value_bytes) : 0)) +
         2 * sizeof(int) * rows_per_cta;
}

// Shared memory the ORDERED instances add after their tables and counters
// for the value pass's stage (stage_words, at the next 8-byte boundary)
// where a block's one row has more than one warp; none with one warp a
// row.  A block of several rows of several warps each has no stage, and
// its ORDERED launch is refused.
size_t stage_bytes(int rows_per_cta, int threads_per_row) {
  return rows_per_cta == 1 && threads_per_row > 32
             ? 4 * static_cast<size_t>(stage_words(threads_per_row / 32)) + 4
             : 0;
}

bool stage_shape_ok(int rows_per_cta, int threads_per_row) {
  return rows_per_cta == 1 || threads_per_row == 32;
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED = false,
          int VT = 0>
int launch(const int* rows, const int* count, const int* a_rpt,
           const int* a_col, const ValT<VT>* a_val, const int* b_rpt,
           const int* b_col, const ValT<VT>* b_val, int t_size, int rows_cap,
           int rows_per_cta, int threads_per_row, int* nnz_out, int* col_out,
           ValT<VT>* val_out, int* acc_out, cudaStream_t stream) {
  if (ORDERED && !stage_shape_ok(rows_per_cta, threads_per_row))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_cap == 0) return 0;
  auto kernel = hash_rows_kernel<SINGLE_ACCESS, WITH_VALUES, VT>;
  if constexpr (ORDERED) kernel = hash_rows_kernel_ordered<SINGLE_ACCESS, VT>;
  const size_t smem =
      smem_bytes(t_size, rows_per_cta, WITH_VALUES, sizeof(ValT<VT>)) +
      (ORDERED ? stage_bytes(rows_per_cta, threads_per_row) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(rows_cap / rows_per_cta);
  const dim3 block(rows_per_cta * threads_per_row);
  kernel<<<grid, block, smem, stream>>>(
      rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
      rows_per_cta, threads_per_row, nnz_out, col_out, val_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool WITH_VALUES, bool ORDERED = false, int VT = 0>
int dispatch(int single_access, const int* rows, const int* count,
             const int* a_rpt, const int* a_col, const ValT<VT>* a_val,
             const int* b_rpt, const int* b_col, const ValT<VT>* b_val,
             int t_size, int rows_cap, int rows_per_cta, int threads_per_row,
             int* nnz_out, int* col_out, ValT<VT>* val_out, int* acc_out,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (single_access)
    return launch<true, WITH_VALUES, ORDERED, VT>(
        rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
        rows_cap, rows_per_cta, threads_per_row, nnz_out, col_out, val_out,
        acc_out, s);
  return launch<false, WITH_VALUES, ORDERED, VT>(
      rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
      rows_cap, rows_per_cta, threads_per_row, nnz_out, col_out, val_out,
      acc_out, s);
}

// ---------------------------------------------------------------------------
// slot_rows_kernel: numeric_bin, and fused_bin in 16-bit values (see the
// header).
// ---------------------------------------------------------------------------

// A numeric slot: the key in the low word, the value's bits in the high
// word (a 16-bit value in its low half, the rest 0).  Empty: key -1, value
// +0.0 (all bits 0 in every type).
constexpr unsigned long long kEmptySlot = 0x00000000ffffffffull;

// Exact floor mod of a key's hash by a t_size that is not a power of two,
// with no divide (Granlund & Montgomery 1994, Fig. 4.1, N = 32): for every
// uint32 p, q = (t1 + ((p - t1) >> 1)) >> shift with t1 = umulhi(magic, p)
// is floor(p / t_size).  The int32 value of p is p - 2^32 when negative,
// so its floor mod takes away wrap = 2^32 mod t_size and adds t_size back
// if that went below 0.  The wrapper computes (magic, shift, wrap) once per
// t_size (spgemm_hash.py: hash_mod).
struct HashMod {
  unsigned magic;
  int shift;
  unsigned wrap;
};

__device__ __forceinline__ int hash_slot(int key, int t_size, bool pow2,
                                         HashMod mod) {
  const unsigned p = static_cast<unsigned>(key) * kHashScale;
  if (pow2) return static_cast<int>(p) & (t_size - 1);
  const unsigned t1 = __umulhi(mod.magic, p);
  const unsigned q = (t1 + ((p - t1) >> 1)) >> mod.shift;
  int r = static_cast<int>(p - q * static_cast<unsigned>(t_size));
  if (static_cast<int>(p) < 0) {
    r -= static_cast<int>(mod.wrap);
    if (r < 0) r += t_size;
  }
  return r;
}

// The value goes in rounded to V (exact for a sum already rounded).
template <int VT = 0>
__device__ __forceinline__ unsigned long long pack_slot(int key, float val) {
  return (static_cast<unsigned long long>(Val<VT>::bits(val)) << 32) |
         static_cast<unsigned>(key);
}

__device__ __forceinline__ int slot_key(unsigned long long slot) {
  return static_cast<int>(static_cast<unsigned>(slot));
}

template <int VT = 0>
__device__ __forceinline__ float slot_val(unsigned long long slot) {
  return Val<VT>::of_bits(
      static_cast<typename Val<VT>::Bits>(slot >> 32));
}

// Inserts one product into a row's 64-bit slots; returns the table
// accesses it took.  The guard (2 * t_size) counts the slots probed: the
// CAS races a product loses on its own key do not count, or a row of
// heavy duplicates could drop a product.  prod and the sums are V values
// held in float; each sum is rounded to V as it goes into the slot.
template <bool SINGLE_ACCESS, int VT = 0>
__device__ __forceinline__ int insert_slot(unsigned long long* slots, int key,
                                           float prod, int t_size, bool pow2,
                                           HashMod mod, int guard) {
  int h = hash_slot(key, t_size, pow2, mod);
  int txn = 0, probed = 0;
  unsigned long long seen = kEmptySlot;  // single access: the slot as seen
  while (probed < guard) {
    if (SINGLE_ACCESS) {
      // One 64-bit CAS: claims the slot if it is as last seen (empty at
      // first) and adds the value in the same transaction.
      const unsigned long long old = atomicCAS(
          &slots[h], seen, pack_slot<VT>(key, slot_val<VT>(seen) + prod));
      txn += 1;
      if (old == seen) break;
      if (slot_key(old) == key) {  // its own key: add to what it holds
        seen = old;
        continue;
      }
      seen = kEmptySlot;
    } else {
      const unsigned long long cur =
          reinterpret_cast<volatile unsigned long long*>(slots)[h];
      txn += 1;
      if (slot_key(cur) == key || slot_key(cur) == kEmpty) {
        const unsigned long long old = atomicCAS(
            &slots[h], cur, pack_slot<VT>(key, slot_val<VT>(cur) + prod));
        txn += 1;
        if (old == cur) break;
        continue;  // lost a race here: read the slot again
      }
    }
    probed += 1;
    h = hash_next(h, t_size);
  }
  return txn;
}

// slot_rows_kernel's table for the ordered value pass: the key in a slot's
// low word, the value in its high word.
template <int VT_>
struct SlotTable {
  static constexpr int VT = VT_;
  using Bits = typename Val<VT>::Bits;
  unsigned long long* slots;
  int t_size;
  bool pow2;
  HashMod mod;

  __device__ int find(int key) const {
    int h = hash_slot(key, t_size, pow2, mod);
    for (int probed = 0; probed < kGuardFactor * t_size; ++probed) {
      const int k = reinterpret_cast<const volatile int*>(slots + h)[0];
      if (k == key) return h;
      if (k == kEmpty) return -1;
      h = hash_next(h, t_size);
    }
    return -1;
  }
  // The value's bits sit at byte 4 of the slot.
  __device__ float load(int h) const {
    return Val<VT>::of_bits(
        reinterpret_cast<volatile Bits*>(slots + h)[4 / sizeof(Bits)]);
  }
  __device__ void store(int h, float v) const {
    reinterpret_cast<volatile Bits*>(slots + h)[4 / sizeof(Bits)] =
        Val<VT>::bits(v);
  }
};

// The value bits of a slot (Bits: unsigned, or unsigned short for a
// 16-bit V), as a V table stores them.
template <class Bits>
__device__ __forceinline__ Bits slot_bits(unsigned long long slot) {
  return static_cast<Bits>(slot >> 32);
}

// Splits n (key, value) slots into dst_cols / dst_vals (V values): element
// by element up to the first 16-byte boundary of dst_cols, then four slots
// a thread with a 16-byte store of their keys and one store of their four
// values (16 or 8 bytes) where dst_vals is aligned for it there, then the
// tail.
template <class V>
__device__ __forceinline__ void dump_slots(int* __restrict__ dst_cols,
                                           V* __restrict__ dst_vals,
                                           const unsigned long long* src,
                                           int n) {
  using Bits = typename std::conditional<sizeof(V) == 4, unsigned,
                                         unsigned short>::type;
  Bits* vals = reinterpret_cast<Bits*>(dst_vals);
  const int head0 = static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(dst_cols) & 15)) & 15) / 4;
  // Four values from slot head0 on take one aligned store: for float the
  // two outputs share their alignment, for 16-bit values vals + head0 is
  // 8-byte aligned.
  const uintptr_t v = reinterpret_cast<uintptr_t>(dst_vals);
  const bool same =
      sizeof(Bits) == 4
          ? ((reinterpret_cast<uintptr_t>(dst_cols) ^ v) & 15) == 0
          : ((v + head0 * sizeof(Bits)) & 7) == 0;
  const int head = same ? min(n, head0) : n;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    dst_cols[i] = slot_key(src[i]);
    vals[i] = slot_bits<Bits>(src[i]);
  }
  const int quads = (n - head) / 4;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const int j = head + 4 * i;
    const unsigned long long s0 = src[j], s1 = src[j + 1], s2 = src[j + 2],
                             s3 = src[j + 3];
    *reinterpret_cast<int4*>(dst_cols + j) =
        make_int4(slot_key(s0), slot_key(s1), slot_key(s2), slot_key(s3));
    const unsigned v0 = slot_bits<Bits>(s0), v1 = slot_bits<Bits>(s1),
                   v2 = slot_bits<Bits>(s2), v3 = slot_bits<Bits>(s3);
    if constexpr (sizeof(Bits) == 4) {
      *reinterpret_cast<uint4*>(vals + j) = make_uint4(v0, v1, v2, v3);
    } else {
      *reinterpret_cast<uint2*>(vals + j) =
          make_uint2(v0 | (v1 << 16), v2 | (v3 << 16));
    }
  }
  for (int i = head + 4 * quads + threadIdx.x; i < n; i += blockDim.x) {
    dst_cols[i] = slot_key(src[i]);
    vals[i] = slot_bits<Bits>(src[i]);
  }
}

// At most 32 registers a thread, so that two 1024-thread CTAs (the top
// rungs) fit an SM as with hash_rows_kernel; the ORDERED instance too.
// The 16-bit instances (VT != 0) serve fused_bin as well as numeric_bin:
// unless nnz_out is nullptr (numeric_bin; the float32 instances never read
// it) they count each row's occupied slots after the inserts, its nnz, and
// write them there, so that numeric_bin pays no count in its insert loop.
// To stay within the 32 registers without a spill, they compute the
// block's first row and its row count anew after the inserts rather than
// hold them and the bin size across the loop, and take a padding row for
// one whose counters stayed 0.  (Reading the lane and the row's place in
// the block anew as well was slower on the card: they stay held.)
template <bool SINGLE_ACCESS, bool ORDERED = false, int VT = 0>
__global__ void __launch_bounds__(1024, 2) slot_rows_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const ValT<VT>* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const ValT<VT>* __restrict__ b_val,
    int t_size, int rows_cap, int rows_per_cta, int threads_per_row,
    HashMod mod, int* __restrict__ col_out, ValT<VT>* __restrict__ val_out,
    int* __restrict__ acc_out, int* __restrict__ nnz_out) {
  using Ops = Val<VT>;
  constexpr bool kNnz = VT != 0;
  const int n_valid = *count;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  // The last CTA may hold fewer rows when rows_per_cta does not divide
  // rows_cap.
  const int rows_here = static_cast<int>(
      min(static_cast<long long>(rows_per_cta), rows_cap - first));
  if (first >= n_valid) {
    // Padding CTA: counts only; its tables stay unwritten.
    if (threadIdx.x < rows_here) {
      acc_out[first + threadIdx.x] = 0;
      if (kNnz && nnz_out) nnz_out[first + threadIdx.x] = 0;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char slot_smem[];
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(slot_smem);
  // The rows' counters: accesses, then (16-bit) nnz.
  int* row_acc = reinterpret_cast<int*>(slots + rows_per_cta * t_size);
  const int cta_entries = rows_here * t_size;
  for (int i = threadIdx.x; i < cta_entries; i += blockDim.x)
    slots[i] = kEmptySlot;
  if (threadIdx.x < rows_per_cta) row_acc[threadIdx.x] = 0;
  if (kNnz && threadIdx.x < rows_per_cta)
    row_acc[rows_per_cta + threadIdx.x] = 0;
  __syncthreads();

  const int local = threadIdx.x / threads_per_row;
  const int tid = threadIdx.x % threads_per_row;
  const int warps = threads_per_row / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long idx = first + local;
  const bool pow2 = (t_size & (t_size - 1)) == 0;
  const int guard = kGuardFactor * t_size;

  if (local < rows_here && idx < n_valid) {  // uniform across a warp
    const int r = rows[idx];
    const int a_lo = a_rpt[r], a_hi = a_rpt[r + 1];
    unsigned long long* row_slots = slots + local * t_size;
    int accesses = 0;
    // The warp's entries are a_lo + warp + warps*s, s = 0, 1, ...; lane l
    // fetches entry s0 + l of each batch of 32, and the warp walks them
    // entry by entry, its lanes striding the entry's B row.
    for (int base = a_lo + warp; base < a_hi; base += 32 * warps) {
      const int e = base + lane * warps;
      int b_lo = 0, b_hi = 0;
      float av = 0.0f;
      if (e < a_hi) {
        const int k = a_col[e];
        av = Ops::to_f(a_val[e]);
        b_lo = b_rpt[k];
        b_hi = b_rpt[k + 1];
      }
      const int batch = min(32, (a_hi - base + warps - 1) / warps);
      for (int s = 0; s < batch; ++s) {
        const int lo = __shfl_sync(0xffffffffu, b_lo, s);
        const int hi = __shfl_sync(0xffffffffu, b_hi, s);
        const float a = __shfl_sync(0xffffffffu, av, s);
        for (int j = lo + lane; j < hi; j += 32) {
          accesses += insert_slot<SINGLE_ACCESS, VT>(
              row_slots, b_col[j],
              ORDERED ? 0.0f : Ops::round(a * Ops::to_f(b_val[j])), t_size,
              pow2, mod, guard);
        }
      }
    }
    if (accesses) atomicAdd(&row_acc[local], accesses);
  }
  // What the 16-bit instances read anew (see above).
  const long long first_now =
      kNnz ? static_cast<long long>(block_index_now()) * rows_per_cta
           : first;
  const int rows_here_now =
      kNnz ? static_cast<int>(min(static_cast<long long>(rows_per_cta),
                                  rows_cap - first_now))
           : rows_here;
  if (ORDERED) {
    __syncthreads();  // every key of the block's rows is in place
    if (kNnz ? local < rows_here_now && row_acc[local] > 0
             : idx < n_valid && local < rows_here) {  // every warp of the row
      const int r = rows[kNnz ? first_now + local : idx];
      const SlotTable<VT> table{slots + local * t_size, t_size, pow2, mod};
      // The stage follows the counters' 8 bytes a row.
      ordered_values(table,
                     reinterpret_cast<int2*>(slots + rows_per_cta * t_size +
                                             rows_per_cta),
                     a_col, a_val, b_rpt, b_col, b_val, a_rpt[r],
                     a_rpt[r + 1], warps);
    }
  }
  __syncthreads();
  if constexpr (kNnz) {
    if (nnz_out) {  // block-uniform
      int occupied = 0;
      if (local < rows_here_now) {
        for (int i = thread_index_now() - local * threads_per_row;
             i < t_size; i += threads_per_row)
          occupied += slot_key(slots[local * t_size + i]) != kEmpty;
      }
      occupied = __reduce_add_sync(kAllLanes, occupied);  // a row's warp
      if (occupied && lane == 0)
        atomicAdd(&row_acc[rows_per_cta + local], occupied);
      __syncthreads();
    }
  }

  if (threadIdx.x < rows_here_now) {
    const bool valid = kNnz || first + threadIdx.x < n_valid;
    acc_out[first_now + threadIdx.x] = valid ? row_acc[threadIdx.x] : 0;
    if (kNnz && nnz_out)
      nnz_out[first_now + threadIdx.x] = row_acc[rows_per_cta + threadIdx.x];
  }
  const long long base = first_now * t_size;
  dump_slots(col_out + base, val_out + base, slots,
             kNnz ? rows_here_now * t_size : cta_entries);
}

template <bool SINGLE_ACCESS, bool ORDERED = false, int VT = 0>
int launch_slot(HashMod mod, const int* rows, const int* count,
                const int* a_rpt, const int* a_col, const ValT<VT>* a_val,
                const int* b_rpt, const int* b_col, const ValT<VT>* b_val,
                int t_size, int rows_cap, int rows_per_cta,
                int threads_per_row, int* col_out, ValT<VT>* val_out,
                int* acc_out, int* nnz_out, cudaStream_t stream) {
  if (ORDERED && !stage_shape_ok(rows_per_cta, threads_per_row))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_cap == 0) return 0;
  auto kernel = slot_rows_kernel<SINGLE_ACCESS, ORDERED, VT>;
  const size_t smem =
      smem_bytes(t_size, rows_per_cta, true) +
      (ORDERED ? stage_bytes(rows_per_cta, threads_per_row) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows_cap + rows_per_cta - 1) / rows_per_cta);
  const dim3 block(rows_per_cta * threads_per_row);
  kernel<<<grid, block, smem, stream>>>(
      rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
      rows_cap, rows_per_cta, threads_per_row, mod, col_out, val_out,
      acc_out, nnz_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool ORDERED = false, int VT = 0>
int slot_dispatch(HashMod mod, int single_access, const int* rows,
                  const int* count, const int* a_rpt, const int* a_col,
                  const ValT<VT>* a_val, const int* b_rpt, const int* b_col,
                  const ValT<VT>* b_val, int t_size, int rows_cap,
                  int rows_per_cta, int threads_per_row, int* col_out,
                  ValT<VT>* val_out, int* acc_out, void* stream,
                  int* nnz_out = nullptr) {
  auto s = static_cast<cudaStream_t>(stream);
  if (single_access)
    return launch_slot<true, ORDERED, VT>(
        mod, rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
        rows_cap, rows_per_cta, threads_per_row, col_out, val_out, acc_out,
        nnz_out, s);
  return launch_slot<false, ORDERED, VT>(
      mod, rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
      rows_cap, rows_per_cta, threads_per_row, col_out, val_out, acc_out,
      nnz_out, s);
}

// The constants of hash_slot's floor mod by t_size, as the wrapper's
// spgemm_hash.hash_mod computes them for numeric_bin (l = ceil(log2
// t_size): magic = floor(2^32 (2^l - t_size) / t_size) + 1, shift l - 1,
// wrap 2^32 mod t_size; all 0 for a power of two).  fused_bin's entry
// points take none: its 16-bit launches compute them here.
HashMod hash_mod_of(int t_size) {
  if ((t_size & (t_size - 1)) == 0) return HashMod{0u, 0, 0u};
  int lg = 0;
  while ((1 << lg) < t_size) ++lg;
  const unsigned long long two32 = 1ull << 32;
  return HashMod{
      static_cast<unsigned>(two32 * ((1ull << lg) - t_size) / t_size + 1),
      lg - 1, static_cast<unsigned>(two32 % t_size)};
}

// ---------------------------------------------------------------------------
// global_rows_kernel: the vmem_extended rungs of all three (see the header).
// ---------------------------------------------------------------------------

// Sets n words of a table in device memory to `value`: 16-byte stores when
// the table starts on a 16-byte boundary and n is a multiple of 4 (every
// power-of-two table of the extended ladders), else word by word.
__device__ __forceinline__ void fill_words(int* dst, int value, int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (n & 3) == 0) {
    const int4 v = make_int4(value, value, value, value);
    int4* quads = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) quads[i] = v;
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = value;
  }
}

// One row a CTA; the row's table is its own output row in device memory
// (col_tabs / val_tabs at row * t_size, 64-bit offsets), filled empty and
// then built there with `insert`, so nothing is dumped.  val_tabs ==
// nullptr with WITH_VALUES false (symbolic_bin: the keys go to a scratch
// table the wrapper allocates); nnz_out may be nullptr (numeric_bin).
template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED = false,
          int VT = 0>
__global__ void __launch_bounds__(1024, 2) global_rows_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const ValT<VT>* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const ValT<VT>* __restrict__ b_val,
    int t_size, int* __restrict__ nnz_out, int* __restrict__ col_tabs,
    ValT<VT>* __restrict__ val_tabs, int* __restrict__ acc_out) {
  using V = ValT<VT>;
  using Ops = Val<VT>;
  const long long row = blockIdx.x;
  if (row >= *count) {
    // Padding row: counts only; its table stays unwritten.
    if (threadIdx.x == 0) {
      if (nnz_out) nnz_out[row] = 0;
      acc_out[row] = 0;
    }
    return;
  }

  __shared__ int row_nnz, row_acc;
  int* table_keys = col_tabs + row * t_size;
  V* table_vals = WITH_VALUES ? val_tabs + row * t_size : nullptr;
  fill_words(table_keys, kEmpty, t_size);
  if (WITH_VALUES) {
    if (sizeof(V) == 4 || (t_size & 1) == 0) {  // +0.0 is all bits 0
      fill_words(reinterpret_cast<int*>(table_vals), 0,
                 t_size * static_cast<int>(sizeof(V)) / 4);
    } else {
      for (int i = threadIdx.x; i < t_size; i += blockDim.x)
        table_vals[i] = Ops::from_f(0.0f);
    }
  }
  if (threadIdx.x == 0) {
    row_nnz = 0;
    row_acc = 0;
  }
  __syncthreads();   // the fill is seen by every thread of the block

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool pow2 = (t_size & (t_size - 1)) == 0;
  const int guard = kGuardFactor * t_size;
  const int r = rows[row];
  const int a_lo = a_rpt[r], a_hi = a_rpt[r + 1];
  int inserted = 0, accesses = 0;
  // As in hash_rows_kernel: warp w takes entries a_lo + w + warps*s, lane
  // l fetches entry s0 + l of each batch of 32, and the warp's lanes
  // stride each entry's B row.
  for (int base = a_lo + warp; base < a_hi; base += 32 * warps) {
    const int e = base + lane * warps;
    int b_lo = 0, b_hi = 0;
    float av = 0.0f;
    if (e < a_hi) {
      const int k = a_col[e];
      if (WITH_VALUES) av = Ops::to_f(a_val[e]);
      b_lo = b_rpt[k];
      b_hi = b_rpt[k + 1];
    }
    const int batch = min(32, (a_hi - base + warps - 1) / warps);
    for (int s = 0; s < batch; ++s) {
      const int lo = __shfl_sync(0xffffffffu, b_lo, s);
      const int hi = __shfl_sync(0xffffffffu, b_hi, s);
      const float a = WITH_VALUES ? __shfl_sync(0xffffffffu, av, s) : 0.0f;
      for (int j = lo + lane; j < hi; j += 32) {
        const V prod =
            Ops::from_f(WITH_VALUES ? a * Ops::to_f(b_val[j]) : 0.0f);
        accesses += insert<SINGLE_ACCESS, WITH_VALUES && !ORDERED>(
            table_keys, table_vals, b_col[j], prod, t_size, pow2, guard,
            &inserted);
      }
    }
  }
  if (inserted) atomicAdd(&row_nnz, inserted);
  if (accesses) atomicAdd(&row_acc, accesses);
  __syncthreads();  // (ORDERED: every key of the row is in place)
  if (ORDERED) {
    __shared__ int2 stage[ORDERED ? stage_words(kMaxRowThreads / 32) / 2
                                  : 1];
    const KeyValTable<VT> table{table_keys, table_vals, t_size, pow2};
    ordered_values(table, stage, a_col, a_val, b_rpt, b_col, b_val, a_lo,
                   a_hi, warps);
  }
  if (threadIdx.x == 0) {
    if (nnz_out) nnz_out[row] = row_nnz;
    acc_out[row] = row_acc;
  }
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED = false,
          int VT = 0>
int launch_global(const int* rows, const int* count, const int* a_rpt,
                  const int* a_col, const ValT<VT>* a_val, const int* b_rpt,
                  const int* b_col, const ValT<VT>* b_val, int t_size,
                  int rows_cap, int threads, int* nnz_out, int* col_tabs,
                  ValT<VT>* val_tabs, int* acc_out, cudaStream_t stream) {
  if (rows_cap == 0) return 0;
  global_rows_kernel<SINGLE_ACCESS, WITH_VALUES, ORDERED, VT>
      <<<rows_cap, threads, 0, stream>>>(rows, count, a_rpt, a_col, a_val,
                                         b_rpt, b_col, b_val, t_size,
                                         nnz_out, col_tabs, val_tabs,
                                         acc_out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// cluster_rows_kernel: the vmem_extended rungs whose table fits the shared
// memory of a thread-block cluster (see the header).
// ---------------------------------------------------------------------------

// The shared::cluster address of the byte at `local` (a shared::cta address
// of this block) in the block of rank `rank` of the cluster: PTX `mapa`,
// which cooperative_groups' map_shared_rank wraps for generic pointers.
// The 32-bit shared::cluster form keeps every table access a
// distributed-shared-memory instruction.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// The table accesses, at .cluster scope (the slot's block and its peers
// are the only threads that touch it).
__device__ __forceinline__ int dsmem_cas32(uint32_t addr, int expected,
                                           int desired) {
  int old;
  asm volatile(
      "atom.relaxed.cluster.shared::cluster.cas.b32 %0, [%1], %2, %3;"
      : "=r"(old) : "r"(addr), "r"(expected), "r"(desired) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long dsmem_cas64(
    uint32_t addr, unsigned long long expected,
    unsigned long long desired) {
  unsigned long long old;
  asm volatile(
      "atom.relaxed.cluster.shared::cluster.cas.b64 %0, [%1], %2, %3;"
      : "=l"(old) : "r"(addr), "l"(expected), "l"(desired) : "memory");
  return old;
}

__device__ __forceinline__ int dsmem_load32(uint32_t addr) {
  int v;
  asm volatile("ld.relaxed.cluster.shared::cluster.b32 %0, [%1];"
               : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long dsmem_load64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.shared::cluster.b64 %0, [%1];"
               : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void dsmem_add32(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}

// This block's rank in its cluster and the cluster's size, read from their
// special registers anew at each call (asm volatile), so that they need no
// register across the insert loop; the thread's index, the block's size and
// the block's index likewise (thread_index_now above).
__device__ __forceinline__ unsigned cluster_rank_now() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned cluster_blocks_now() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}


// Inserts one product into a row's table spread over the cluster: slot h
// lives in rank h >> rank_shift at offset h & (2^rank_shift - 1) (t_size
// and the slice are powers of two), reached through distributed shared
// memory, its own block's slots too (plain shared-memory atomics on them
// lost on the card: the warp then splits in two).  With values a slot is
// 64 bits and the probe follows insert_slot (one CAS claims a slot and
// adds, a hit adds by CAS on the value it saw); keys only, it follows
// insert's single access and check-then-CAS.  Accesses are counted by
// insert_slot's rules in both, and the guard (2 * t_size) counts slots.
// Returns the accesses; sets *inserted when it claimed an empty slot.
template <bool SINGLE_ACCESS, bool WITH_VALUES, int VT = 0>
__device__ __forceinline__ int cluster_insert(uint32_t table, int rank_shift,
                                              int key, float prod,
                                              int t_size, int* inserted) {
  constexpr int kSlotShift = WITH_VALUES ? 3 : 2;
  int h = static_cast<int>(static_cast<unsigned>(key) * kHashScale) &
          (t_size - 1);
  int txn = 0;
  unsigned long long seen = kEmptySlot;  // single access: the slot as seen
  for (int probed = 0; probed < kGuardFactor * t_size;) {
    const uint32_t at = cluster_addr(
        table + (static_cast<uint32_t>(h & ((1 << rank_shift) - 1))
                 << kSlotShift),
        static_cast<uint32_t>(h >> rank_shift));
    if (WITH_VALUES && SINGLE_ACCESS) {
      const unsigned long long old = dsmem_cas64(
          at, seen, pack_slot<VT>(key, slot_val<VT>(seen) + prod));
      txn += 1;
      if (old == seen) {
        if (slot_key(seen) == kEmpty) *inserted += 1;
        break;
      }
      if (slot_key(old) == key) {  // its own key: add to what it holds
        seen = old;
        continue;
      }
      seen = kEmptySlot;
    } else if (WITH_VALUES) {
      const unsigned long long cur = dsmem_load64(at);
      txn += 1;
      if (slot_key(cur) == key || slot_key(cur) == kEmpty) {
        const unsigned long long old = dsmem_cas64(
            at, cur, pack_slot<VT>(key, slot_val<VT>(cur) + prod));
        txn += 1;
        if (old == cur) {
          if (slot_key(cur) == kEmpty) *inserted += 1;
          break;
        }
        continue;  // lost a race here: read the slot again
      }
    } else if (SINGLE_ACCESS) {
      const int old = dsmem_cas32(at, kEmpty, key);
      txn += 1;
      if (old == kEmpty || old == key) {
        if (old == kEmpty) *inserted += 1;
        break;
      }
    } else {
      const int cur = dsmem_load32(at);
      txn += 1;
      if (cur == key) break;
      if (cur == kEmpty) {
        const int old = dsmem_cas32(at, kEmpty, key);
        txn += 1;
        if (old == kEmpty || old == key) {
          if (old == kEmpty) *inserted += 1;
          break;
        }
      }
    }
    probed += 1;
    h = (h + 1) & (t_size - 1);
  }
  return txn;
}

// Each block of a cluster holds, in its dynamic shared memory, a window of
// the row's A entries first (one entry a thread, so a window holds
// blockDim.x <= 1024 entries): per entry its B row's bounds, its first
// chunk (32 products a chunk: the B row's entries [lo + 32c, lo + 32c +
// 32)) and its A value, then the scan's per-warp sums; then the row's two
// counters (nnz, accesses; only rank 0's are used), padded to 16 B; then
// its slice of the table.  At fixed offsets, so no address of theirs takes
// a register.
constexpr int kEntryWindow = 1024;
constexpr int kCountersOffset = (4 * kEntryWindow + 32) * sizeof(int);
constexpr int kSliceOffset = kCountersOffset + 16;
// The ORDERED instance stages its value pass in the entry list's memory.
static_assert(kCountersOffset >= 4 * stage_words(kMaxRowThreads / 32),
              "the value pass's stage must fit the entry list");

extern __shared__ __align__(16) unsigned char cluster_smem[];

__device__ __forceinline__ int* entry_lo() {
  return reinterpret_cast<int*>(cluster_smem);
}
__device__ __forceinline__ int* entry_hi() { return entry_lo() + kEntryWindow; }
__device__ __forceinline__ int* entry_chunk() {
  return entry_lo() + 2 * kEntryWindow;
}
__device__ __forceinline__ float* entry_av() {
  return reinterpret_cast<float*>(entry_lo() + 3 * kEntryWindow);
}
__device__ __forceinline__ int* entry_sums() {
  return entry_lo() + 4 * kEntryWindow;
}
__device__ __forceinline__ int* row_counters() {
  return reinterpret_cast<int*>(cluster_smem + kCountersOffset);
}

// cluster_rows_kernel's table for the ordered value pass: the key of slot h
// is read from its block through distributed shared memory; find returns
// the slot's offset in this block's slice when this block holds it, else
// -1 (the block that holds it adds its products).
// The block's rank, the slice's address and its size are read again at
// each find rather than held.
template <int VT_>
struct ClusterTable {
  static constexpr int VT = VT_;
  using Bits = typename Val<VT>::Bits;
  int t_size;

  __device__ int find(int key) const {
    const uint32_t table = static_cast<uint32_t>(
        __cvta_generic_to_shared(cluster_smem + kSliceOffset));
    // log2 of the slots a block (t_size and the cluster: powers of two)
    const int rank_shift =
        __ffs(t_size) - __ffs(static_cast<int>(cluster_blocks_now()));
    int h = static_cast<int>(static_cast<unsigned>(key) * kHashScale) &
            (t_size - 1);
    const int mask = (1 << rank_shift) - 1;
    for (int probed = 0; probed < kGuardFactor * t_size; ++probed) {
      const int k = dsmem_load32(cluster_addr(
          table + (static_cast<uint32_t>(h & mask) << 3),
          static_cast<uint32_t>(h >> rank_shift)));
      if (k == key) {
        return (h >> rank_shift) == static_cast<int>(cluster_rank_now())
                   ? (h & mask)
                   : -1;
      }
      if (k == kEmpty) return -1;
      h = (h + 1) & (t_size - 1);
    }
    return -1;
  }
  // The value's bits sit at byte 4 of the 8-byte slot.
  __device__ float load(int i) const {
    return Val<VT>::of_bits(reinterpret_cast<volatile Bits*>(
        cluster_smem + kSliceOffset + 8 * i + 4)[0]);
  }
  __device__ void store(int i, float v) const {
    reinterpret_cast<volatile Bits*>(cluster_smem + kSliceOffset + 8 * i +
                                     4)[0] = Val<VT>::bits(v);
  }
};

// Loads A entries [first, first + n) of the row (n <= blockDim.x) into the
// list, with each entry's first chunk: an exclusive scan of the entries'
// chunk counts over the block.  Returns the window's chunks.  Every thread
// of the block calls it (two barriers inside); the first chunks are read
// by other threads only after the caller's next barrier.  The thread's
// index and the block's size come from their special registers here, so
// that nothing of this function is held across the insert loop that
// brackets its second call.
template <bool WITH_VALUES, int VT = 0>
__device__ __forceinline__ int load_entries(const int* __restrict__ a_col,
                                            const ValT<VT>* __restrict__ a_val,
                                            const int* __restrict__ b_rpt,
                                            int first, int n) {
  const int i = thread_index_now();
  const int warps = block_threads_now() / 32;
  const int lane = i % 32, w = i / 32;
  int chunks = 0;
  if (i < n) {
    const int k = a_col[first + i];
    const int lo = b_rpt[k], hi = b_rpt[k + 1];
    entry_lo()[i] = lo;
    entry_hi()[i] = hi;
    if (WITH_VALUES) entry_av()[i] = Val<VT>::to_f(a_val[first + i]);
    chunks = (hi - lo + 31) / 32;
  }
  int incl = chunks;
  for (int o = 1; o < 32; o *= 2) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) entry_sums()[w] = incl;
  __syncthreads();
  if (w == 0) {
    int v = lane < warps ? entry_sums()[lane] : 0;
    for (int o = 1; o < 32; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    entry_sums()[lane] = v;
  }
  __syncthreads();
  if (i < n) entry_chunk()[i] = (w ? entry_sums()[w - 1] : 0) + incl - chunks;
  return entry_sums()[block_threads_now() / 32 - 1];
}

// The entry (< n) that holds chunk g: the last one whose first chunk is at
// most g (entries without products share their successor's first chunk).
// Warp-uniform g; two rounds of 32 compares and a ballot.
__device__ __forceinline__ int entry_of_chunk(const int* chunk, int n, int g,
                                              int lane) {
  const int p1 = lane * 32;
  const unsigned seg =
      __ballot_sync(0xffffffffu, p1 < n && chunk[p1] <= g);
  const int s0 = (31 - __clz(seg)) * 32;
  const int p2 = s0 + lane;
  const unsigned in = __ballot_sync(0xffffffffu, p2 < n && chunk[p2] <= g);
  return s0 + 31 - __clz(in);
}

// One row a cluster of C blocks (C = the launch's cluster size, a power of
// two dividing t_size); each block holds its copy of the row's entry list,
// the row's counters and t_size / C slots of the row's table in its shared
// memory (kSliceOffset above).  The
// row's products go out in chunks of 32 (one B row's entries, a lane
// each), chunk g to warp g mod (C x warps a block) of the cluster, so a
// long B row is spread over many warps instead of serialising one.
// nnz_out may be nullptr (numeric_bin); without values nothing is dumped
// (symbolic_bin), with values col_tabs / val_tabs get the table at
// row * t_size.
template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED = false,
          int VT = 0>
__global__ void __launch_bounds__(1024, 2) cluster_rows_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const ValT<VT>* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const ValT<VT>* __restrict__ b_val,
    int t_size, int* __restrict__ nnz_out, int* __restrict__ col_tabs,
    ValT<VT>* __restrict__ val_tabs, int* __restrict__ acc_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long first_row = block_index_now() / cluster_blocks_now();
  if (first_row >= *count) {
    // Padding row: every block of the cluster leaves before any barrier
    // or remote access; rank 0 writes the counts, the table stays
    // unwritten.
    if (cluster_rank_now() == 0 && threadIdx.x == 0) {
      if (nnz_out) nnz_out[first_row] = 0;
      acc_out[first_row] = 0;
    }
    return;
  }
  const int slice = t_size / static_cast<int>(cluster_blocks_now());
  if (WITH_VALUES) {
    const ulonglong2 empty = make_ulonglong2(kEmptySlot, kEmptySlot);
    ulonglong2* pairs =
        reinterpret_cast<ulonglong2*>(cluster_smem + kSliceOffset);
    for (int i = threadIdx.x; i < slice / 2; i += blockDim.x)
      pairs[i] = empty;
  } else {
    const int4 empty = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    int4* quads = reinterpret_cast<int4*>(cluster_smem + kSliceOffset);
    for (int i = threadIdx.x; i < slice / 4; i += blockDim.x)
      quads[i] = empty;
  }
  if (threadIdx.x < 2) row_counters()[threadIdx.x] = 0;
  const int r = rows[first_row];
  const int a_hi = a_rpt[r + 1];
  int first = a_rpt[r];
  int n = min(a_hi - first, static_cast<int>(blockDim.x));
  int chunks = load_entries<WITH_VALUES, VT>(a_col, a_val, b_rpt, first, n);
  // Every slice is filled, and every block of the cluster is running,
  // before the first remote access; the entry list is in place.
  cluster.sync();

  const uint32_t table = static_cast<uint32_t>(
      __cvta_generic_to_shared(cluster_smem + kSliceOffset));
  const int rank_shift = __ffs(slice) - 1;
  const int lane = threadIdx.x % 32;
  int inserted = 0, accesses = 0;
  while (true) {
    const int warps = static_cast<int>(cluster_blocks_now() * blockDim.x) / 32;
    for (int g = static_cast<int>(cluster_rank_now() * blockDim.x +
                                  threadIdx.x) / 32;
         g < chunks; g += warps) {
      const int e = entry_of_chunk(entry_chunk(), n, g, lane);
      const int j = entry_lo()[e] + (g - entry_chunk()[e]) * 32 + lane;
      if (j < entry_hi()[e]) {
        accesses += cluster_insert<SINGLE_ACCESS, WITH_VALUES, VT>(
            table, rank_shift, b_col[j],
            WITH_VALUES && !ORDERED
                ? Val<VT>::round(entry_av()[e] * Val<VT>::to_f(b_val[j]))
                : 0.0f,
            t_size, &inserted);
      }
    }
    first += n;
    if (first >= a_hi) break;
    // The next window of a row of more than blockDim.x entries: this
    // block's list only, so a block barrier does.
    __syncthreads();
    n = min(a_hi - first, static_cast<int>(blockDim.x));
    chunks = load_entries<WITH_VALUES, VT>(a_col, a_val, b_rpt, first, n);
    __syncthreads();
  }
  inserted = __reduce_add_sync(0xffffffffu, inserted);
  accesses = __reduce_add_sync(0xffffffffu, accesses);
  // The row, the rank and the slice are read again here rather than held
  // across the loop.
  const unsigned rank = cluster_rank_now();
  const long long row = block_index_now() / cluster_blocks_now();
  const int slice_now = t_size / static_cast<int>(cluster_blocks_now());
  const uint32_t counters =
      static_cast<uint32_t>(__cvta_generic_to_shared(row_counters()));
  if (lane == 0) {   // to rank 0's counters
    if (inserted) dsmem_add32(cluster_addr(counters, 0), inserted);
    if (accesses) dsmem_add32(cluster_addr(counters + 4, 0), accesses);
  }
  // Every insert and count has landed; after this no block touches a
  // peer's shared memory, so each may dump its own slice and leave.
  cluster.sync();
  if (ORDERED) {
    // Each block's warps add, in the reference's order, the products whose
    // slots its slice holds, reading the other blocks' keys; the stage is
    // the entry list's memory, free since the barrier above.  The barrier
    // after it keeps every block (and its keys) until all are done.
    const int r = rows[row];
    ordered_values(ClusterTable<VT>{t_size},
                   reinterpret_cast<int2*>(entry_lo()), a_col, a_val, b_rpt,
                   b_col, b_val, a_rpt[r], a_rpt[r + 1],
                   block_threads_now() / 32);
    cluster.sync();
  }

  if (rank == 0 && threadIdx.x == 0) {
    if (nnz_out) nnz_out[row] = row_counters()[0];
    acc_out[row] = row_counters()[1];
  }
  if (WITH_VALUES) {
    const long long off =
        row * t_size + static_cast<long long>(rank) * slice_now;
    dump_slots(col_tabs + off, val_tabs + off,
               reinterpret_cast<const unsigned long long*>(cluster_smem +
                                                           kSliceOffset),
               slice_now);
  }
}

size_t cluster_smem_bytes(int t_size, int cluster, bool with_values) {
  return kSliceOffset +
         static_cast<size_t>(t_size / cluster) * (with_values ? 8 : 4);
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, int VT = 0>
const void* cluster_rows_fn() {
  return reinterpret_cast<const void*>(
      cluster_rows_kernel<SINGLE_ACCESS, WITH_VALUES, false, VT>);
}

// A cluster launch of `threads` threads a block, `cluster` blocks a row:
// the grid, the cluster dimension and the slice's dynamic shared memory.
cudaLaunchConfig_t cluster_config(int t_size, int rows_cap, int cluster,
                                  int threads, bool with_values,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows_cap) * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = cluster_smem_bytes(t_size, cluster, with_values);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The kernel's own limits: a power-of-two table and cluster, a slice of at
// least 4 slots, and whole warps, one entry of the list a thread.  The
// cluster's size is the runtime's to refuse (past the portable 8, which
// the launch does not opt out of).
bool cluster_shape_ok(int t_size, int cluster, int threads) {
  const bool pow2 = t_size > 0 && (t_size & (t_size - 1)) == 0;
  return pow2 && cluster >= 1 && (cluster & (cluster - 1)) == 0 &&
         t_size / cluster >= 4 && threads >= 32 && threads % 32 == 0 &&
         threads <= kEntryWindow;
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, bool ORDERED = false,
          int VT = 0>
int launch_cluster(const int* rows, const int* count, const int* a_rpt,
                   const int* a_col, const ValT<VT>* a_val, const int* b_rpt,
                   const int* b_col, const ValT<VT>* b_val, int t_size,
                   int rows_cap, int cluster, int threads, int* nnz_out,
                   int* col_tabs, ValT<VT>* val_tabs, int* acc_out,
                   cudaStream_t stream) {
  if (!cluster_shape_ok(t_size, cluster, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_cap == 0) return 0;
  auto kernel = cluster_rows_kernel<SINGLE_ACCESS, WITH_VALUES, ORDERED, VT>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(
      t_size, rows_cap, cluster, threads, WITH_VALUES, &attr, stream);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(config.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, kernel, rows, count, a_rpt, a_col, a_val,
                           b_rpt, b_col, b_val, t_size, nnz_out, col_tabs,
                           val_tabs, acc_out);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, int VT = 0>
const void* global_rows_fn() {
  return reinterpret_cast<const void*>(
      global_rows_kernel<SINGLE_ACCESS, WITH_VALUES, false, VT>);
}

template <bool SINGLE_ACCESS, bool WITH_VALUES, int VT = 0>
const void* hash_rows_fn() {
  return reinterpret_cast<const void*>(
      hash_rows_kernel<SINGLE_ACCESS, WITH_VALUES, VT>);
}

template <bool SINGLE_ACCESS, int VT = 0>
const void* hash_rows_ordered_fn() {
  return reinterpret_cast<const void*>(
      hash_rows_kernel_ordered<SINGLE_ACCESS, VT>);
}

template <bool SINGLE_ACCESS, int VT = 0, bool ORDERED = false>
const void* slot_rows_fn() {
  return reinterpret_cast<const void*>(
      slot_rows_kernel<SINGLE_ACCESS, ORDERED, VT>);
}

// The bodies of the entry points below, by value type VT.  The keys-only
// launches (symbolic_bin) exist for VT = 0 only: a 16-bit entry point asked
// for one returns cudaErrorInvalidValue.

// kernel: 0 symbolic_bin, 1 numeric_bin, 2 fused_bin; 3 numeric_bin and 4
// fused_bin in the fixed-order mode (their ORDERED instances, with the
// value pass's stage).
template <int VT>
int ctas_per_sm(int kernel, int single_access, int t_size, int rows_per_cta,
                int threads_per_row, int* out) {
  const bool ordered = kernel > 2;
  if (kernel < 0 || kernel > 4 || (VT != 0 && kernel == 0) ||
      (ordered && !stage_shape_ok(rows_per_cta, threads_per_row)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int body = ordered ? kernel - 2 : kernel;
  const bool sa = single_access != 0;
  const void* fn;
  if (body == 0) {
    fn = sa ? hash_rows_fn<true, false>() : hash_rows_fn<false, false>();
  } else if (body == 1) {
    fn = ordered ? (sa ? slot_rows_fn<true, VT, true>()
                       : slot_rows_fn<false, VT, true>())
                 : (sa ? slot_rows_fn<true, VT>() : slot_rows_fn<false, VT>());
  } else if constexpr (VT != 0) {  // fused_bin in 16-bit: the slot kernel
    fn = ordered ? (sa ? slot_rows_fn<true, VT, true>()
                       : slot_rows_fn<false, VT, true>())
                 : (sa ? slot_rows_fn<true, VT>() : slot_rows_fn<false, VT>());
  } else {
    fn = ordered ? (sa ? hash_rows_ordered_fn<true>()
                       : hash_rows_ordered_fn<false>())
                 : (sa ? hash_rows_fn<true, true>()
                       : hash_rows_fn<false, true>());
  }
  const size_t smem =
      smem_bytes(t_size, rows_per_cta, body != 0) +
      (ordered ? stage_bytes(rows_per_cta, threads_per_row) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, rows_per_cta * threads_per_row, smem));
}

template <int VT>
int global_ctas_per_sm(int with_values, int single_access, int threads,
                       int* out) {
  if (VT != 0 && !with_values) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      with_values ? (single_access ? global_rows_fn<true, true, VT>()
                                   : global_rows_fn<false, true, VT>())
                  : (single_access ? global_rows_fn<true, false>()
                                   : global_rows_fn<false, false>());
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, 0));
}

template <int VT>
int cluster_occupancy(int with_values, int single_access, int t_size,
                      int cluster, int threads, int* out) {
  if (!cluster_shape_ok(t_size, cluster, threads) ||
      (VT != 0 && !with_values))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      with_values ? (single_access ? cluster_rows_fn<true, true, VT>()
                                   : cluster_rows_fn<false, true, VT>())
                  : (single_access ? cluster_rows_fn<true, false>()
                                   : cluster_rows_fn<false, false>());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(
      t_size, 1, cluster, threads, with_values != 0, &attr, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(config.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &config));
}

template <int VT, bool ORDERED>
int bin_cluster(int with_values, int single_access, const int* rows,
                const int* count, const int* a_rpt, const int* a_col,
                const void* a_val, const int* b_rpt, const int* b_col,
                const void* b_val, int t_size, int rows_cap, int cluster,
                int threads, int* nnz_out, int* col_tabs, void* val_tabs,
                int* acc_out, void* stream) {
  using V = ValT<VT>;
  auto s = static_cast<cudaStream_t>(stream);
  const V* av = static_cast<const V*>(a_val);
  const V* bv = static_cast<const V*>(b_val);
  V* vt = static_cast<V*>(val_tabs);
  if (!with_values) {
    if constexpr (VT != 0 || ORDERED) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      auto fn = single_access ? &launch_cluster<true, false>
                              : &launch_cluster<false, false>;
      return fn(rows, count, a_rpt, a_col, av, b_rpt, b_col, bv, t_size,
                rows_cap, cluster, threads, nnz_out, col_tabs, vt, acc_out,
                s);
    }
  }
  if (ORDERED && !val_tabs) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = single_access ? &launch_cluster<true, true, ORDERED, VT>
                          : &launch_cluster<false, true, ORDERED, VT>;
  return fn(rows, count, a_rpt, a_col, av, b_rpt, b_col, bv, t_size,
            rows_cap, cluster, threads, nnz_out, col_tabs, vt, acc_out, s);
}

template <int VT, bool ORDERED>
int bin_global(int single_access, const int* rows, const int* count,
               const int* a_rpt, const int* a_col, const void* a_val,
               const int* b_rpt, const int* b_col, const void* b_val,
               int t_size, int rows_cap, int threads, int* nnz_out,
               int* col_tabs, void* val_tabs, int* acc_out, void* stream) {
  using V = ValT<VT>;
  auto s = static_cast<cudaStream_t>(stream);
  const V* av = static_cast<const V*>(a_val);
  const V* bv = static_cast<const V*>(b_val);
  V* vt = static_cast<V*>(val_tabs);
  if (!val_tabs) {
    if constexpr (VT != 0 || ORDERED) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      auto fn = single_access ? &launch_global<true, false>
                              : &launch_global<false, false>;
      return fn(rows, count, a_rpt, a_col, av, b_rpt, b_col, bv, t_size,
                rows_cap, threads, nnz_out, col_tabs, vt, acc_out, s);
    }
  }
  auto fn = single_access ? &launch_global<true, true, ORDERED, VT>
                          : &launch_global<false, true, ORDERED, VT>;
  return fn(rows, count, a_rpt, a_col, av, b_rpt, b_col, bv, t_size,
            rows_cap, threads, nnz_out, col_tabs, vt, acc_out, s);
}

template <int VT, bool ORDERED>
int numeric(const int* rows, const int* count, const int* a_rpt,
            const int* a_col, const void* a_val, const int* b_rpt,
            const int* b_col, const void* b_val, int t_size, int rows_cap,
            int rows_per_cta, int threads_per_row, int single_access,
            unsigned hash_magic, int hash_shift, unsigned hash_wrap,
            int* col_out, void* val_out, int* acc_out, void* stream) {
  using V = ValT<VT>;
  const HashMod mod{hash_magic, hash_shift, hash_wrap};
  return slot_dispatch<ORDERED, VT>(
      mod, single_access, rows, count, a_rpt, a_col,
      static_cast<const V*>(a_val), b_rpt, b_col,
      static_cast<const V*>(b_val), t_size, rows_cap, rows_per_cta,
      threads_per_row, col_out, static_cast<V*>(val_out), acc_out, stream);
}

// fused_bin: float32 on hash_rows_kernel, 16-bit values on
// slot_rows_kernel with its nnz count (one 64-bit CAS claims a slot and
// adds a product).

template <int VT, bool ORDERED>
int fused(const int* rows, const int* count, const int* a_rpt,
          const int* a_col, const void* a_val, const int* b_rpt,
          const int* b_col, const void* b_val, int t_size, int rows_cap,
          int rows_per_cta, int threads_per_row, int single_access,
          int* nnz_out, int* col_out, void* val_out, int* acc_out,
          void* stream) {
  using V = ValT<VT>;
  if constexpr (VT != 0) {
    return slot_dispatch<ORDERED, VT>(
        hash_mod_of(t_size), single_access, rows, count, a_rpt, a_col,
        static_cast<const V*>(a_val), b_rpt, b_col,
        static_cast<const V*>(b_val), t_size, rows_cap, rows_per_cta,
        threads_per_row, col_out, static_cast<V*>(val_out), acc_out, stream,
        nnz_out);
  } else {
    return dispatch<true, ORDERED>(
        single_access, rows, count, a_rpt, a_col, static_cast<const V*>(a_val),
        b_rpt, b_col, static_cast<const V*>(b_val), t_size, rows_cap,
        rows_per_cta, threads_per_row, nnz_out, col_out,
        static_cast<V*>(val_out), acc_out, stream);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of this kernel may use on the card.
int hash_max_smem_bytes(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(err);
}

int symbolic_bin(const int* rows, const int* count, const int* a_rpt,
                 const int* a_col, const int* b_rpt, const int* b_col,
                 int t_size, int rows_cap, int rows_per_cta,
                 int threads_per_row, int single_access, int* nnz_out,
                 int* acc_out, void* stream) {
  return dispatch<false>(single_access, rows, count, a_rpt, a_col, nullptr,
                         b_rpt, b_col, nullptr, t_size, rows_cap,
                         rows_per_cta, threads_per_row, nnz_out, nullptr,
                         nullptr, acc_out, stream);
}

// The entry points of one value type: float (no suffix), bfloat16 (_bf16)
// and float16 (_f16); values are passed as void pointers to that type.
//
// hash_ctas_per_sm: CTAs of one rung's launch that fit on one SM at once
//   (the runtime's occupancy calculator: threads, registers and shared
//   memory together); kernel 0 symbolic_bin, 1 numeric_bin, 2 fused_bin,
//   3 / 4 numeric_bin / fused_bin's ORDERED instance.
// hash_global_ctas_per_sm: the same for one global_rows_kernel launch.
// hash_cluster_occupancy: clusters of one cluster_rows_kernel launch
//   (`cluster` blocks of `threads` threads a row) resident at once.
// hash_bin_cluster[_ordered]: the three kernels' rungs whose table fits a
//   cluster's shared memory: one row a cluster of `cluster` blocks of
//   `threads` threads (t_size a power of two, cluster a power of two up to
//   8).  with_values == 0 builds keys only and dumps nothing (symbolic_bin:
//   col_tabs and val_tabs nullptr); nnz_out == nullptr skips the nnz
//   (numeric_bin).  The fixed-order instance takes values only.
// hash_bin_global[_ordered]: the tables above shared memory (the
//   vmem_extended rungs): one row a CTA of `threads` threads, its table
//   built in col_tabs / val_tabs (rows_cap x t_size).  val_tabs == nullptr
//   builds keys only (symbolic_bin, col_tabs then a scratch table);
//   nnz_out == nullptr skips the nnz (numeric_bin).
// numeric_bin[_ordered], fused_bin[_ordered]: the shared-memory rungs.
#define HASH_VALUE_ENTRIES(SUFFIX, VT)                                       \
  int hash_ctas_per_sm##SUFFIX(int kernel, int single_access, int t_size,    \
                               int rows_per_cta, int threads_per_row,        \
                               int* out) {                                   \
    return ctas_per_sm<VT>(kernel, single_access, t_size, rows_per_cta,      \
                           threads_per_row, out);                            \
  }                                                                          \
  int hash_global_ctas_per_sm##SUFFIX(int with_values, int single_access,    \
                                      int threads, int* out) {               \
    return global_ctas_per_sm<VT>(with_values, single_access, threads, out); \
  }                                                                          \
  int hash_cluster_occupancy##SUFFIX(int with_values, int single_access,     \
                                     int t_size, int cluster, int threads,   \
                                     int* out) {                             \
    return cluster_occupancy<VT>(with_values, single_access, t_size,         \
                                 cluster, threads, out);                     \
  }                                                                          \
  int hash_bin_cluster##SUFFIX(                                              \
      int with_values, int single_access, const int* rows, const int* count, \
      const int* a_rpt, const int* a_col, const void* a_val,                 \
      const int* b_rpt, const int* b_col, const void* b_val, int t_size,     \
      int rows_cap, int cluster, int threads, int* nnz_out, int* col_tabs,   \
      void* val_tabs, int* acc_out, void* stream) {                          \
    return bin_cluster<VT, false>(                                           \
        with_values, single_access, rows, count, a_rpt, a_col, a_val, b_rpt, \
        b_col, b_val, t_size, rows_cap, cluster, threads, nnz_out, col_tabs, \
        val_tabs, acc_out, stream);                                          \
  }                                                                          \
  int hash_bin_cluster_ordered##SUFFIX(                                      \
      int with_values, int single_access, const int* rows, const int* count, \
      const int* a_rpt, const int* a_col, const void* a_val,                 \
      const int* b_rpt, const int* b_col, const void* b_val, int t_size,     \
      int rows_cap, int cluster, int threads, int* nnz_out, int* col_tabs,   \
      void* val_tabs, int* acc_out, void* stream) {                          \
    return bin_cluster<VT, true>(                                            \
        with_values, single_access, rows, count, a_rpt, a_col, a_val, b_rpt, \
        b_col, b_val, t_size, rows_cap, cluster, threads, nnz_out, col_tabs, \
        val_tabs, acc_out, stream);                                          \
  }                                                                          \
  int hash_bin_global##SUFFIX(                                               \
      int single_access, const int* rows, const int* count,                  \
      const int* a_rpt, const int* a_col, const void* a_val,                 \
      const int* b_rpt, const int* b_col, const void* b_val, int t_size,     \
      int rows_cap, int threads, int* nnz_out, int* col_tabs,                \
      void* val_tabs, int* acc_out, void* stream) {                          \
    return bin_global<VT, false>(single_access, rows, count, a_rpt, a_col,   \
                                 a_val, b_rpt, b_col, b_val, t_size,         \
                                 rows_cap, threads, nnz_out, col_tabs,       \
                                 val_tabs, acc_out, stream);                 \
  }                                                                          \
  int hash_bin_global_ordered##SUFFIX(                                       \
      int single_access, const int* rows, const int* count,                  \
      const int* a_rpt, const int* a_col, const void* a_val,                 \
      const int* b_rpt, const int* b_col, const void* b_val, int t_size,     \
      int rows_cap, int threads, int* nnz_out, int* col_tabs,                \
      void* val_tabs, int* acc_out, void* stream) {                          \
    return bin_global<VT, true>(single_access, rows, count, a_rpt, a_col,    \
                                a_val, b_rpt, b_col, b_val, t_size,          \
                                rows_cap, threads, nnz_out, col_tabs,        \
                                val_tabs, acc_out, stream);                  \
  }                                                                          \
  int numeric_bin##SUFFIX(                                                   \
      const int* rows, const int* count, const int* a_rpt, const int* a_col, \
      const void* a_val, const int* b_rpt, const int* b_col,                 \
      const void* b_val, int t_size, int rows_cap, int rows_per_cta,         \
      int threads_per_row, int single_access, unsigned hash_magic,           \
      int hash_shift, unsigned hash_wrap, int* col_out, void* val_out,       \
      int* acc_out, void* stream) {                                          \
    return numeric<VT, false>(rows, count, a_rpt, a_col, a_val, b_rpt,       \
                              b_col, b_val, t_size, rows_cap, rows_per_cta,  \
                              threads_per_row, single_access, hash_magic,    \
                              hash_shift, hash_wrap, col_out, val_out,       \
                              acc_out, stream);                              \
  }                                                                          \
  int numeric_bin_ordered##SUFFIX(                                           \
      const int* rows, const int* count, const int* a_rpt, const int* a_col, \
      const void* a_val, const int* b_rpt, const int* b_col,                 \
      const void* b_val, int t_size, int rows_cap, int rows_per_cta,         \
      int threads_per_row, int single_access, unsigned hash_magic,           \
      int hash_shift, unsigned hash_wrap, int* col_out, void* val_out,       \
      int* acc_out, void* stream) {                                          \
    return numeric<VT, true>(rows, count, a_rpt, a_col, a_val, b_rpt, b_col, \
                             b_val, t_size, rows_cap, rows_per_cta,          \
                             threads_per_row, single_access, hash_magic,     \
                             hash_shift, hash_wrap, col_out, val_out,        \
                             acc_out, stream);                               \
  }                                                                          \
  int fused_bin##SUFFIX(                                                     \
      const int* rows, const int* count, const int* a_rpt, const int* a_col, \
      const void* a_val, const int* b_rpt, const int* b_col,                 \
      const void* b_val, int t_size, int rows_cap, int rows_per_cta,         \
      int threads_per_row, int single_access, int* nnz_out, int* col_out,    \
      void* val_out, int* acc_out, void* stream) {                           \
    return fused<VT, false>(rows, count, a_rpt, a_col, a_val, b_rpt, b_col,  \
                            b_val, t_size, rows_cap, rows_per_cta,           \
                            threads_per_row, single_access, nnz_out,         \
                            col_out, val_out, acc_out, stream);              \
  }                                                                          \
  int fused_bin_ordered##SUFFIX(                                             \
      const int* rows, const int* count, const int* a_rpt, const int* a_col, \
      const void* a_val, const int* b_rpt, const int* b_col,                 \
      const void* b_val, int t_size, int rows_cap, int rows_per_cta,         \
      int threads_per_row, int single_access, int* nnz_out, int* col_out,    \
      void* val_out, int* acc_out, void* stream) {                           \
    return fused<VT, true>(rows, count, a_rpt, a_col, a_val, b_rpt, b_col,   \
                           b_val, t_size, rows_cap, rows_per_cta,            \
                           threads_per_row, single_access, nnz_out, col_out, \
                           val_out, acc_out, stream);                        \
  }

HASH_VALUE_ENTRIES(, 0)
HASH_VALUE_ENTRIES(_bf16, 1)
HASH_VALUE_ENTRIES(_f16, 2)

#undef HASH_VALUE_ENTRIES

}  // extern "C"
