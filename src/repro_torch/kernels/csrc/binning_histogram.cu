// Binning pass 1 (OpSparse Alg. 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/binning_pallas.py
// (binning_histogram / _make_kernel): each block of `block` rows classifies
// its row sizes against the rung bounds, keeps a local histogram, adds it
// once into the global bin_size, and folds its rows' maximum size into the
// global max.
//
// What differs from the TPU kernel:
//   * The TPU grid runs in order and accumulates into one output line.  Here
//     CTAs run in parallel: the local histogram lives in shared memory
//     (atomicAdd there), and each CTA adds it with one global atomicAdd per
//     non-empty bin -- the paper's own s_bin_size -> d_bin_size staging.
//   * The max is a warp reduction (__reduce_max_sync), then a CTA reduction
//     through shared memory, then one atomicMax per CTA.
//   * The rung bounds (at most 16) travel by value in the kernel's parameter
//     struct; nothing is copied to the device per call.
//   * The two outputs are zeroed by the caller before the launch (a zeroing
//     CTA inside the kernel would race with the others' atomics).
//   * Rows at or past m count nowhere; sizes above the last bound land in
//     rung n_upper; a bin index at or past num_bins is not counted, as in the
//     reference's `for b in range(num_bins)` loop.
//
// What bounds it on the card: device-memory bytes.  It reads each size once
// (4 B a row) and writes num_bins + 1 ints; the classification is a few
// compares a row.  Reads are coalesced: thread t of a CTA takes rows
// t, t + blockDim, ... of the CTA's block.
//
// The entry point returns cudaGetLastError() right after the launch; the
// Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxUpper = 16;
constexpr int kMaxBins = 32;
constexpr int kThreads = 256;

struct Rungs {
  int upper[kMaxUpper];
  int n_upper;
  int num_bins;
};

__global__ void __launch_bounds__(kThreads)
binning_histogram_kernel(const int* __restrict__ sizes, int64_t m, int block,
                         Rungs rungs, int* __restrict__ hist,
                         int* __restrict__ max_out) {
  __shared__ int s_hist[kMaxBins];
  __shared__ int s_max[kThreads / 32];
  for (int b = threadIdx.x; b < kMaxBins; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();

  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  int local_max = 0;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const int64_t idx = base + i;
    if (idx >= m) break;
    const int v = sizes[idx];
    int bin = 0;
#pragma unroll
    for (int j = 0; j < kMaxUpper; ++j)
      if (j < rungs.n_upper) bin += v > rungs.upper[j];
    if (bin < rungs.num_bins) atomicAdd(&s_hist[bin], 1);
    local_max = max(local_max, v);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  local_max = __reduce_max_sync(0xffffffffu, local_max);
  if (lane == 0) s_max[warp] = local_max;
  __syncthreads();

  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int v = lane < n_warps ? s_max[lane] : 0;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0 && v > 0) atomicMax(max_out, v);
  }
  for (int b = threadIdx.x; b < rungs.num_bins; b += blockDim.x)
    if (s_hist[b]) atomicAdd(&hist[b], s_hist[b]);
}

}  // namespace

extern "C" {

// sizes: (m,) int32 on the device.  upper: n_upper rung bounds on the host.
// hist: (num_bins,) int32 and max_out: (1,) int32, both zeroed beforehand.
int binning_histogram(const int* sizes, long long m, int block,
                      const int* upper, int n_upper, int num_bins, int* hist,
                      int* max_out, void* stream) {
  if (block < 1 || n_upper < 0 || n_upper > kMaxUpper || num_bins < 1 ||
      num_bins > kMaxBins || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  Rungs rungs{};
  for (int j = 0; j < n_upper; ++j) rungs.upper[j] = upper[j];
  rungs.n_upper = n_upper;
  rungs.num_bins = num_bins;
  const long long grid = (m + block - 1) / block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // Every warp is full: the reductions use all 32 lanes.
  const int threads = block >= kThreads ? kThreads : ((block + 31) / 32) * 32;
  binning_histogram_kernel<<<static_cast<unsigned>(grid), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      sizes, m, block, rungs, hist, max_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
