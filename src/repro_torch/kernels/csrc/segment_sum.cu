// Segment sums in order for Hopper (sm_90a): the ESC accumulator's value
// sums.
//
// The reference's ESC accumulator (src/repro/core/esc.py, numeric and
// spgemm_fused) sums each (row, col) key's products with a scatter-add,
// which applies them one at a time in product order: a left fold ((0 +
// p1) + p2) + ... over the key's products as the stable (row, col) sort
// left them.  It is jnp, not a Pallas kernel.  torch.segment_reduce sums
// them on the card in another order (a segmented tree reduction), so the
// port's _compress (src/repro_torch/core/esc.py) launches this kernel: a
// row gets the reference's bits, and the same bits whichever of the two
// accumulators (ESC, or the hash kernels' fixed-order instances) the
// ladder sends it to.
//
// One thread a segment (an output slot): it walks its segment's values in
// order, adding each with one rounding (no FMA contraction; a 16-bit sum
// is rounded from float32, which is exact for a sum of two 16-bit values
// before that rounding, as the CPU rounds it), and writes the sum;
// segments at or past n_real (the dump slot of dropped and padding
// products) are written 0 without being read.  Segments are a few
// products long (a key's duplicates), so neighbouring threads read
// neighbouring values and write neighbouring sums.  What bounds it on the
// card: device-memory bytes (each value read once, two offsets and one
// sum a segment).
//
// The entry point returns cudaGetLastError() right after the launch; the
// Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

template <typename T>
struct Sum;

template <>
struct Sum<float> {
  __device__ static float zero() { return 0.0f; }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Sum<double> {
  __device__ static double zero() { return 0.0; }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

template <>
struct Sum<__nv_bfloat16> {
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <>
struct Sum<__half> {
  __device__ static __half zero() { return __float2half_rn(0.f); }
  __device__ static __half add(__half a, __half b) {
    return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
  }
};

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ vals,
                                   const long long* __restrict__ offsets,
                                   long long n_real, long long n_out,
                                   T* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n_out; k += step) {
    T acc = Sum<T>::zero();
    if (k < n_real) {
      const long long hi = offsets[k + 1];
      for (long long j = offsets[k]; j < hi; ++j)
        acc = Sum<T>::add(acc, vals[j]);
    }
    out[k] = acc;
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename T>
int launch(const void* vals, const long long* offsets, long long n_real,
           long long n_out, void* out, cudaStream_t stream) {
  const long long blocks =
      std::min(kMaxBlocks, (n_out + kThreads - 1) / kThreads);
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const T*>(vals), offsets,
                                    n_real, n_out, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[k] = the in-order sum of vals[offsets[k] : offsets[k + 1]] for
// k < n_real, 0 for n_real <= k < n_out (offsets holds n_out + 1 entries).
// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16.
int segment_sum(const void* vals, const long long* offsets, long long n_real,
                long long n_out, void* out, int dtype, void* stream) {
  if (n_out <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(vals, offsets, n_real, n_out, out, s);
    case 1: return launch<double>(vals, offsets, n_real, n_out, out, s);
    case 2: return launch<__nv_bfloat16>(vals, offsets, n_real, n_out, out, s);
    case 3: return launch<__half>(vals, offsets, n_real, n_out, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
