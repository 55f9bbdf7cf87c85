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
// What each computes is the TPU kernel's function, not its block layout:
//   * Row mapping.  A group of `threads_per_row` threads owns one output row
//     and its table; a CTA holds `rows_per_cta` such groups.  rows_per_cta=1
//     is one CTA per row (the large rungs); rows_per_cta>1 with a warp per
//     row is the GPU form of the reference's row packing (several small
//     rows' sub-tables in one block).  Inside a row, warp w takes A entries
//     a_lo+w, a_lo+w+W, ... and its lanes stride over that B row, so short
//     B rows still keep most lanes busy.
//   * Tables live in (dynamic) shared memory, one `t_size` slice per row.
//     Keys go in with atomicCAS, values with atomicAdd.  The fused top rung
//     (24576 entries x 8 B = 196,608 B) needs the opt-in above 48 KB.
//   * Hash: key*107 as a uint32 product (no signed overflow), reduced with
//     AND for a power-of-two table and with a floor mod of the int32 value
//     otherwise: the reference's slot for every key, never a negative one.
//     Linear probing; the probe guard is 2*t_size as in the reference.
//   * Accesses per row: one per probe with single access (Alg 4/5: the CAS
//     is the probe), and with check-then-CAS one for the read plus one for
//     the CAS whenever an empty slot is claimed.
//   * The bin size is read from device memory (`count`), never from the
//     host.  Rows at or past it emit nnz 0 and accesses 0, and their tables
//     are NOT written: the wrappers allocate the tables with torch.empty,
//     so a padding row's table holds whatever the memory held.  The one
//     consumer, numeric_epilogue, masks rows >= count.  (A CTA that holds a
//     valid row and, packed, some padding rows writes empty tables for
//     those.)
//   * Raw tables go out with stride t_size (no TPU lane padding).
//
// What bounds it on the card: device-memory bytes for the valid rows (B
// reads, the raw table dump), and, inside a row, the latency of the chain
// A entry -> B row pointers -> B entries -> shared atomics.  The schedule
// pads each bin to a pow-2 bucket with headroom, so most of a bucket's rows
// can be padding; what the design does about each:
//   * A CTA whose first row is at or past `count` writes nnz/accesses 0 and
//     returns before it touches shared memory: no table fill, no probe, no
//     dump.  Padding costs one launch slot and two stores per row.
//   * A warp fetches the next 32 of its A entries (column, value, B row
//     bounds) at once, one per lane, and walks them from registers through
//     shuffles, so the dependent global loads are paid once per 32 entries.
//   * Tables are dumped with 16-byte stores (4 words a thread), starting at
//     the first 16-byte boundary of the row range; numeric-ladder sizes
//     (2^k - 1) are not multiples of 4, so the ends go word by word.
//   * fused_scheduled (spgemm_hash.py) launches its rungs on side
//     streams, so a rung's tail, where few CTAs of the top rung hold most
//     SMs' shared memory, overlaps the other rungs.
//
// Every entry point returns cudaGetLastError() right after its launch (or
// the error of the shared-memory opt-in); the Python wrapper raises on
// anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kHashScale = 107u;
constexpr int kGuardFactor = 2;

__device__ __forceinline__ int hash_init(int key, int t_size, bool pow2) {
  unsigned p = static_cast<unsigned>(key) * kHashScale;
  if (pow2) return static_cast<int>(p & static_cast<unsigned>(t_size - 1));
  int h = static_cast<int>(p) % t_size;  // int32 wrap, then floor mod
  return h < 0 ? h + t_size : h;
}

__device__ __forceinline__ int hash_next(int h, int t_size) {
  return h + 1 == t_size ? 0 : h + 1;
}

// Inserts one product into a row's table; returns the table accesses it
// took and sets *inserted when it claimed an empty slot.
template <bool SINGLE_ACCESS, bool WITH_VALUES>
__device__ __forceinline__ int insert(int* keys, float* vals, int key,
                                      float prod, int t_size, bool pow2,
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

// Copies n words from a shared-memory table to device memory: word by word
// up to dst's first 16-byte boundary, then 16-byte stores, then the tail.
__device__ __forceinline__ void dump_words(int* __restrict__ dst,
                                           const int* src, int n) {
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                          15) / 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const int quads = (n - head) / 4;
  const bool src_aligned =
      (static_cast<uint32_t>(__cvta_generic_to_shared(src + head)) & 15) == 0;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const int j = head + 4 * i;
    int4 v;
    if (src_aligned) {
      v = *reinterpret_cast<const int4*>(src + j);
    } else {
      v = make_int4(src[j], src[j + 1], src[j + 2], src[j + 3]);
    }
    *reinterpret_cast<int4*>(dst + j) = v;
  }
  for (int i = head + 4 * quads + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

template <bool SINGLE_ACCESS, bool WITH_VALUES>
__global__ void hash_rows_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const float* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const float* __restrict__ b_val,
    int t_size, int rows_per_cta, int threads_per_row,
    int* __restrict__ nnz_out, int* __restrict__ col_out,
    float* __restrict__ val_out, int* __restrict__ acc_out) {
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
  float* vals = reinterpret_cast<float*>(smem + cta_entries);
  int* row_nnz = WITH_VALUES ? smem + 2 * cta_entries : smem + cta_entries;
  int* row_acc = row_nnz + rows_per_cta;

  for (int i = threadIdx.x; i < cta_entries; i += blockDim.x) {
    keys[i] = kEmpty;
    if (WITH_VALUES) vals[i] = 0.0f;
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
    float* row_vals = WITH_VALUES ? vals + local * t_size : nullptr;
    int inserted = 0, accesses = 0;
    // The warp's entries are a_lo + warp + warps*s, s = 0, 1, ...; lane l
    // fetches entry s0 + l of each batch of 32.
    for (int base = a_lo + warp; base < a_hi; base += 32 * warps) {
      const int e = base + lane * warps;
      int b_lo = 0, b_hi = 0;
      float av = 0.0f;
      if (e < a_hi) {
        const int k = a_col[e];
        if (WITH_VALUES) av = a_val[e];
        b_lo = b_rpt[k];
        b_hi = b_rpt[k + 1];
      }
      const int batch = min(32, (a_hi - base + warps - 1) / warps);
      for (int s = 0; s < batch; ++s) {
        const int lo = __shfl_sync(0xffffffffu, b_lo, s);
        const int hi = __shfl_sync(0xffffffffu, b_hi, s);
        const float a = WITH_VALUES ? __shfl_sync(0xffffffffu, av, s) : 0.0f;
        for (int j = lo + lane; j < hi; j += 32) {
          const float prod = WITH_VALUES ? a * b_val[j] : 0.0f;
          accesses += insert<SINGLE_ACCESS, WITH_VALUES>(
              row_keys, row_vals, b_col[j], prod, t_size, pow2, guard,
              &inserted);
        }
      }
    }
    if (inserted) atomicAdd(&row_nnz[local], inserted);
    if (accesses) atomicAdd(&row_acc[local], accesses);
  }
  __syncthreads();

  if (threadIdx.x < rows_per_cta) {
    const bool valid = first + threadIdx.x < n_valid;
    if (nnz_out) nnz_out[first + threadIdx.x] = valid ? row_nnz[threadIdx.x] : 0;
    acc_out[first + threadIdx.x] = valid ? row_acc[threadIdx.x] : 0;
  }
  if (col_out) {
    const long long base = first * t_size;
    dump_words(col_out + base, keys, cta_entries);
    if (WITH_VALUES)
      dump_words(reinterpret_cast<int*>(val_out) + base,
                 reinterpret_cast<const int*>(vals), cta_entries);
  }
}

size_t smem_bytes(int t_size, int rows_per_cta, bool with_values) {
  const size_t entries = static_cast<size_t>(rows_per_cta) * t_size;
  return entries * (with_values ? 8 : 4) + 2 * sizeof(int) * rows_per_cta;
}

template <bool SINGLE_ACCESS, bool WITH_VALUES>
int launch(const int* rows, const int* count, const int* a_rpt,
           const int* a_col, const float* a_val, const int* b_rpt,
           const int* b_col, const float* b_val, int t_size, int rows_cap,
           int rows_per_cta, int threads_per_row, int* nnz_out, int* col_out,
           float* val_out, int* acc_out, cudaStream_t stream) {
  if (rows_cap == 0) return 0;
  auto kernel = hash_rows_kernel<SINGLE_ACCESS, WITH_VALUES>;
  const size_t smem = smem_bytes(t_size, rows_per_cta, WITH_VALUES);
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

template <bool WITH_VALUES>
int dispatch(int single_access, const int* rows, const int* count,
             const int* a_rpt, const int* a_col, const float* a_val,
             const int* b_rpt, const int* b_col, const float* b_val,
             int t_size, int rows_cap, int rows_per_cta, int threads_per_row,
             int* nnz_out, int* col_out, float* val_out, int* acc_out,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (single_access)
    return launch<true, WITH_VALUES>(
        rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
        rows_cap, rows_per_cta, threads_per_row, nnz_out, col_out, val_out,
        acc_out, s);
  return launch<false, WITH_VALUES>(
      rows, count, a_rpt, a_col, a_val, b_rpt, b_col, b_val, t_size,
      rows_cap, rows_per_cta, threads_per_row, nnz_out, col_out, val_out,
      acc_out, s);
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

// CTAs of one rung's launch that fit on one SM at once (the runtime's
// occupancy calculator: threads, registers and shared memory together).
int hash_ctas_per_sm(int with_values, int single_access, int t_size,
                     int rows_per_cta, int threads_per_row, int* out) {
  const size_t smem = smem_bytes(t_size, rows_per_cta, with_values != 0);
  const void* kernel =
      with_values
          ? (single_access
                 ? reinterpret_cast<const void*>(hash_rows_kernel<true, true>)
                 : reinterpret_cast<const void*>(hash_rows_kernel<false, true>))
          : (single_access
                 ? reinterpret_cast<const void*>(hash_rows_kernel<true, false>)
                 : reinterpret_cast<const void*>(
                       hash_rows_kernel<false, false>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, rows_per_cta * threads_per_row, smem));
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

int numeric_bin(const int* rows, const int* count, const int* a_rpt,
                const int* a_col, const float* a_val, const int* b_rpt,
                const int* b_col, const float* b_val, int t_size,
                int rows_cap, int threads_per_row, int single_access,
                int* col_out, float* val_out, int* acc_out, void* stream) {
  return dispatch<true>(single_access, rows, count, a_rpt, a_col, a_val,
                        b_rpt, b_col, b_val, t_size, rows_cap, 1,
                        threads_per_row, nullptr, col_out, val_out, acc_out,
                        stream);
}

int fused_bin(const int* rows, const int* count, const int* a_rpt,
              const int* a_col, const float* a_val, const int* b_rpt,
              const int* b_col, const float* b_val, int t_size, int rows_cap,
              int rows_per_cta, int threads_per_row, int single_access,
              int* nnz_out, int* col_out, float* val_out, int* acc_out,
              void* stream) {
  return dispatch<true>(single_access, rows, count, a_rpt, a_col, a_val,
                        b_rpt, b_col, b_val, t_size, rows_cap, rows_per_cta,
                        threads_per_row, nnz_out, col_out, val_out, acc_out,
                        stream);
}

}  // extern "C"
