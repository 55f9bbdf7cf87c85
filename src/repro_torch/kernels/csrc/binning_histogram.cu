// Binning pass 1 (OpSparse Alg. 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/binning_pallas.py
// (binning_histogram / _make_kernel): each row's size is classified against
// the rung bounds (its rung is the number of bounds it exceeds), the rows of
// each rung are counted into bin_size, and the largest size into max_size.
//
// What differs from the TPU kernel:
//   * The TPU grid runs in order and accumulates into one output line.  Here
//     CTAs run in parallel and meet only at the end: one global atomicAdd
//     per (CTA, non-empty bin) and one atomicMax per CTA.
//   * No atomic per row.  A row's rung, sum_j [v > upper_j], does not depend
//     on the order of the bounds, so the entry point sorts them.  Each
//     thread then counts in registers, for every bound j, its rows with
//     v > upper_j: with the bounds sorted that is the number of its rows in
//     rung j + 1 or above, so bin b is the difference of two neighbouring
//     counts (the count for b = 0 is the rows seen), and a rung at or past
//     num_bins is left out as before.  The same compares as classifying
//     each row; the histogram of a contended rung costs nothing more.
//   * The number of bounds is a template parameter, so the compares of a
//     row are unrolled exactly, with no guard per bound.
//   * The max is kept per thread too.  Both are reduced by warp reductions
//     (__reduce_add_sync, __reduce_max_sync), then across the CTA through
//     shared memory.
//   * A grid the size of the card (CTAs per SM from the occupancy calculator
//     times the SMs, fewer when m needs fewer).  Each CTA walks the rows in
//     steps of `block` rows (the reference's rows per grid step; no result
//     depends on it), 16 bytes a load, two steps' loads in flight at once.
//     A start that is not 16-byte aligned, and m % 4, are read by scalar
//     loads in the first CTA.
//   * The rung bounds (at most 16) travel by value in the kernel's parameter
//     struct; nothing is copied to the device per call.
//   * The entry point zeroes the two outputs before the launch, with one
//     memset when they are adjacent (a zeroing CTA inside the kernel would
//     race with the others' atomics), so a caller allocates them empty.
//   * Rows at or past m count nowhere; sizes above the last bound land in
//     rung n_upper; a bin index at or past num_bins is not counted, as in the
//     reference's `for b in range(num_bins)` loop.
//
// What bounds it on the card: device-memory bytes.  It reads each size once
// (4 B a row) and writes num_bins + 1 ints; the classification is a compare
// and an add a row and bound.
//
// The entry point returns cudaGetLastError() right after the launch; the
// Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kMaxUpper = 16;
constexpr int kMaxBins = 32;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Rungs {
  int upper[kMaxUpper];       // sorted ascending
  int num_bins;
};

// One thread's counts: rows seen, rows above each of the N bounds, and the
// largest size.
template <int N>
struct Counts {
  int above[N > 0 ? N : 1];
  int rows = 0;
  int largest = 0;

  __device__ __forceinline__ Counts() {
#pragma unroll
    for (int j = 0; j < N; ++j) above[j] = 0;
  }
  __device__ __forceinline__ void row(int v, const Rungs& rungs) {
#pragma unroll
    for (int j = 0; j < N; ++j) above[j] += v > rungs.upper[j];
    rows += 1;
    largest = max(largest, v);
  }
  __device__ __forceinline__ void chunk(int4 v, const Rungs& rungs) {
    row(v.x, rungs);
    row(v.y, rungs);
    row(v.z, rungs);
    row(v.w, rungs);
  }
};

// sizes[0:head] and sizes[head + 4 * n_chunks : m] are read one by one, the
// n_chunks 16-byte chunks between them as int4.  A CTA's step is
// `chunks_per_step` chunks; step s of CTA c is step s * gridDim.x + c.
template <int N>
__global__ void __launch_bounds__(kThreads)
binning_histogram_kernel(const int* __restrict__ sizes, int64_t m, int head,
                         int64_t n_chunks, int chunks_per_step, Rungs rungs,
                         int* __restrict__ hist, int* __restrict__ max_out) {
  __shared__ int s_sum[kThreads / 32][N + 1];
  __shared__ int s_max[kThreads / 32];

  Counts<N> c;
  const int4* body = reinterpret_cast<const int4*>(sizes + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * chunks_per_step;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * chunks_per_step;
       base < n_chunks; base += 2 * stride) {
    for (int i = threadIdx.x; i < chunks_per_step; i += blockDim.x) {
      const int64_t q0 = base + i, q1 = q0 + stride;
      const bool ok0 = q0 < n_chunks, ok1 = q1 < n_chunks;
      int4 v0 = make_int4(0, 0, 0, 0), v1 = v0;
      if (ok0) v0 = __ldg(body + q0);
      if (ok1) v1 = __ldg(body + q1);
      if (ok0) c.chunk(v0, rungs);
      if (ok1) c.chunk(v1, rungs);
    }
  }
  if (blockIdx.x == 0) {
    const int tail = static_cast<int>(m - head - 4 * n_chunks);
    const int t = threadIdx.x;
    if (t < head + tail)
      c.row(sizes[t < head ? t : head + 4 * n_chunks + (t - head)], rungs);
  }

  // Counter 0 is the rows seen (rung >= 0), counter j + 1 the rows above
  // bound j (rung >= j + 1).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rows = __reduce_add_sync(0xffffffffu, c.rows);
  if (lane == 0) s_sum[warp][0] = rows;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int v = __reduce_add_sync(0xffffffffu, c.above[j]);
    if (lane == 0) s_sum[warp][j + 1] = v;
  }
  const int local_max = __reduce_max_sync(0xffffffffu, c.largest);
  if (lane == 0) s_max[warp] = local_max;
  __syncthreads();

  // Thread b < num_bins: bin b is (rung >= b) - (rung >= b + 1).
  const int b = threadIdx.x;
  if (b < rungs.num_bins && b <= N) {
    int ge = 0, gt = 0;
    for (int w = 0; w < n_warps; ++w) {
      ge += s_sum[w][b];
      if (b < N) gt += s_sum[w][b + 1];
    }
    if (ge - gt) atomicAdd(&hist[b], ge - gt);
  }
  if (warp == 0) {
    int v = lane < n_warps ? s_max[lane] : 0;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0 && v > 0) atomicMax(max_out, v);
  }
}

using Kernel = void (*)(const int*, int64_t, int, int64_t, int, Rungs, int*,
                        int*);

// The kernel for n bounds, 0 <= n <= kMaxUpper.
template <int... N>
Kernel kernel_for(int n, std::integer_sequence<int, N...>) {
  Kernel k = nullptr;
  ((k = n == N ? binning_histogram_kernel<N> : k), ...);
  return k;
}

// CTAs of `threads` threads of the kernel for n_upper bounds that fit on
// one SM, times the SMs (the occupancy calculator's answer does not change
// between calls: kept per device, kernel and block size).
int resident_ctas(Kernel kernel, int n_upper, int threads, cudaError_t* err) {
  static int cache[kMaxDevices][kMaxUpper + 1][kThreads / 32 + 1];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  int* slot = dev < kMaxDevices ? &cache[dev][n_upper][threads / 32]
                                : nullptr;
  if (slot && *slot) return *slot;
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, 0);
  if (*err != cudaSuccess) return 0;
  const int ctas = per_sm * sms > 0 ? per_sm * sms : 1;
  if (slot) *slot = ctas;
  return ctas;
}

}  // namespace

extern "C" {

// sizes: (m,) int32 on the device.  upper: n_upper rung bounds on the host,
// in any order.  hist: (num_bins,) int32 and max_out: (1,) int32 on the
// device, zeroed here.  block: rows a CTA takes per step.
int binning_histogram(const int* sizes, long long m, int block,
                      const int* upper, int n_upper, int num_bins, int* hist,
                      int* max_out, void* stream) {
  if (block < 1 || n_upper < 0 || n_upper > kMaxUpper || num_bins < 1 ||
      num_bins > kMaxBins || m < 0 ||
      (reinterpret_cast<uintptr_t>(sizes) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool adjacent = max_out == hist + num_bins;
  cudaError_t err = cudaMemsetAsync(hist, 0, (num_bins + adjacent) * 4, s);
  if (err == cudaSuccess && !adjacent)
    err = cudaMemsetAsync(max_out, 0, 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  Rungs rungs{};
  for (int j = 0; j < n_upper; ++j) {     // insertion sort, at most 16
    int k = j;
    for (; k > 0 && rungs.upper[k - 1] > upper[j]; --k)
      rungs.upper[k] = rungs.upper[k - 1];
    rungs.upper[k] = upper[j];
  }
  rungs.num_bins = num_bins;
  const Kernel kernel = kernel_for(
      n_upper, std::make_integer_sequence<int, kMaxUpper + 1>{});
  const long long to_aligned =
      ((16 - (reinterpret_cast<uintptr_t>(sizes) & 15)) & 15) / 4;
  const int head = static_cast<int>(m < to_aligned ? m : to_aligned);
  const long long n_chunks = (m - head) / 4;
  const int chunks_per_step = (block + 3) / 4;
  // Every warp is full: the reductions use all 32 lanes.
  const int threads = chunks_per_step >= kThreads
                          ? kThreads
                          : ((chunks_per_step + 31) / 32) * 32;
  const int resident = resident_ctas(kernel, n_upper, threads, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long steps = (n_chunks + chunks_per_step - 1) / chunks_per_step;
  const int grid = static_cast<int>(
      steps < 1 ? 1 : (steps < resident ? steps : resident));
  kernel<<<grid, threads, 0, s>>>(sizes, m, head, n_chunks, chunks_per_step,
                                  rungs, hist, max_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
