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
//     host; rows at or past it emit nnz 0, accesses 0 and empty tables.
//   * Raw tables go out with stride t_size (no TPU lane padding).
//
// What bounds it on the card: device-memory bytes.  Each product costs a
// few bytes of B reads and a few shared-memory atomics; the raw table dump
// (rows_cap x t_size x 8 B for the value-carrying kernels) is the largest
// single stream, so the kernels are written to read A and B once per
// product and to write the tables with coalesced stores.
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

template <bool SINGLE_ACCESS, bool WITH_VALUES>
__global__ void hash_rows_kernel(
    const int* __restrict__ rows, const int* __restrict__ count,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const float* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const float* __restrict__ b_val,
    int t_size, int rows_per_cta, int threads_per_row,
    int* __restrict__ nnz_out, int* __restrict__ col_out,
    float* __restrict__ val_out, int* __restrict__ acc_out) {
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

  const int n_valid = *count;
  const int local = threadIdx.x / threads_per_row;
  const int tid = threadIdx.x % threads_per_row;
  const int warps = threads_per_row / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long idx = static_cast<long long>(blockIdx.x) * rows_per_cta
                        + local;
  const bool pow2 = (t_size & (t_size - 1)) == 0;
  const int guard = kGuardFactor * t_size;

  if (idx < n_valid) {
    const int r = rows[idx];
    const int a_lo = a_rpt[r], a_hi = a_rpt[r + 1];
    int* row_keys = keys + local * t_size;
    float* row_vals = WITH_VALUES ? vals + local * t_size : nullptr;
    int inserted = 0, accesses = 0;
    for (int e = a_lo + warp; e < a_hi; e += warps) {
      const int k = a_col[e];
      const float av = WITH_VALUES ? a_val[e] : 0.0f;
      const int b_lo = b_rpt[k], b_hi = b_rpt[k + 1];
      for (int j = b_lo + lane; j < b_hi; j += 32) {
        const float prod = WITH_VALUES ? av * b_val[j] : 0.0f;
        accesses += insert<SINGLE_ACCESS, WITH_VALUES>(
            row_keys, row_vals, b_col[j], prod, t_size, pow2, guard,
            &inserted);
      }
    }
    if (inserted) atomicAdd(&row_nnz[local], inserted);
    if (accesses) atomicAdd(&row_acc[local], accesses);
  }
  __syncthreads();

  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  if (threadIdx.x < rows_per_cta) {
    const bool valid = first + threadIdx.x < n_valid;
    if (nnz_out) nnz_out[first + threadIdx.x] = valid ? row_nnz[threadIdx.x] : 0;
    acc_out[first + threadIdx.x] = valid ? row_acc[threadIdx.x] : 0;
  }
  if (col_out) {
    const long long base = first * t_size;
    for (int i = threadIdx.x; i < cta_entries; i += blockDim.x) {
      col_out[base + i] = keys[i];
      if (WITH_VALUES) val_out[base + i] = vals[i];
    }
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
