// Block-CSR sparse x dense product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/bsr_spmm.py
// (bsr_spmm): for every stored (bm x bk) block of block row r and block
// column c, out[r*bm:(r+1)*bm] += block @ dense[c*bk:(c+1)*bk], summed in
// float32 and written once in the dense operand's type.
//
// What differs from the TPU kernel:
//   * The TPU grid is one sequential step per stored block, carrying the
//     block row's sum in VMEM from step to step.  Here nothing carries over
//     between CTAs, so the work is split by OUTPUT tile instead: one CTA per
//     (block row, 64-row slice of it, 64-column tile of N).  It walks its
//     block row's stored blocks in order, between row pointers the wrapper
//     builds on the device from the sorted block-row ids, so the stripe is
//     written exactly once: no atomics, a fixed summation order.
//   * Block rows with no stored block are written as zeros (the TPU kernel
//     never visits them and leaves them unwritten).  Entries with a block
//     row outside [0, n_block_rows) fall outside every row pointer range
//     and add nothing; padding entries with zero blocks add zeros.
//   * Each CTA stages a 64 x 16 slice of the block (transposed) and the
//     matching 16 x 64 slice of the dense stripe in shared memory as float32
//     and keeps a 4 x 4 tile of float32 sums per thread in registers: plain
//     CUDA-core FMAs.  Ragged edges (bm, bk or N not multiples of the tile)
//     are masked on load and on store.
//
// What bounds it on the card: at the realistic shape (128 x 128 blocks,
// N = 4096) the float32 FMAs, 2*nnzb*bm*bk*N operations, against the
// CUDA-core float32 peak; in bf16 the reads and writes come closer.  A
// tensor-core (wgmma) version is later work.
//
// Every entry point returns cudaGetLastError() right after its launch; the
// Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;       // output rows per CTA
constexpr int kTN = 64;       // output columns per CTA
constexpr int kKC = 16;       // depth of one shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ blk_cols,
                const T* __restrict__ blocks, const T* __restrict__ dense,
                T* __restrict__ out, int bm, int bk, int n, int m_tiles) {
  __shared__ float s_a[kKC][kTM];   // block slice, transposed
  __shared__ float s_b[kKC][kTN];   // dense stripe slice

  const int r = blockIdx.x / m_tiles;           // block row
  const int m0 = (blockIdx.x % m_tiles) * kTM;  // first row inside it
  const int n0 = blockIdx.y * kTN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int lo = ptr[r];
  const int hi = ptr[r + 1];
  for (int e = lo; e < hi; ++e) {
    const T* blk = blocks + static_cast<size_t>(e) * bm * bk;
    const T* stripe = dense + static_cast<size_t>(blk_cols[e]) * bk * n;
    for (int kc = 0; kc < bk; kc += kKC) {
#pragma unroll
      for (int q = 0; q < kTM * kKC / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        const int row = idx / kKC;
        const int kk = idx % kKC;
        const bool ok = m0 + row < bm && kc + kk < bk;
        s_a[kk][row] = ok ? to_float(blk[static_cast<size_t>(m0 + row) * bk +
                                         kc + kk])
                          : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kKC * kTN / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        const int kk = idx / kTN;
        const int col = idx % kTN;
        const bool ok = kc + kk < bk && n0 + col < n;
        s_b[kk][col] = ok ? to_float(stripe[static_cast<size_t>(kc + kk) * n +
                                            n0 + col])
                          : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = s_a[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = s_b[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= bm) continue;
    T* dst = out + (static_cast<size_t>(r) * bm + row) * n;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) dst[col] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const int* ptr, const int* blk_cols, const T* blocks,
           const T* dense, T* out, int n_block_rows, int bm, int bk, int n,
           void* stream) {
  if (n_block_rows < 0 || bm < 1 || bk < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0 || n == 0) return 0;
  const int m_tiles = (bm + kTM - 1) / kTM;
  const long long gx = static_cast<long long>(n_block_rows) * m_tiles;
  const int gy = (n + kTN - 1) / kTN;
  if (gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bsr_spmm_kernel<T><<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ptr, blk_cols, blocks, dense, out, bm, bk, n, m_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ptr: (n_block_rows + 1,) int32 row pointers into the stored blocks;
// blk_cols: (nnzb,) int32; blocks: (nnzb, bm, bk); dense: (K, n);
// out: (n_block_rows * bm, n).  All on the device, contiguous.
int bsr_spmm_f32(const int* ptr, const int* blk_cols, const float* blocks,
                 const float* dense, float* out, int n_block_rows, int bm,
                 int bk, int n, void* stream) {
  return launch<float>(ptr, blk_cols, blocks, dense, out, n_block_rows, bm,
                       bk, n, stream);
}

int bsr_spmm_bf16(const int* ptr, const int* blk_cols, const void* blocks,
                  const void* dense, void* out, int n_block_rows, int bm,
                  int bk, int n, void* stream) {
  return launch<__nv_bfloat16>(
      ptr, blk_cols, static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const __nv_bfloat16*>(dense),
      static_cast<__nv_bfloat16*>(out), n_block_rows, bm, bk, n, stream);
}

}  // extern "C"
