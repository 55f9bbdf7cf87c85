// Scatters with a drop target for Hopper (sm_90a): the port's dump-slot
// writes.
//
// The hash drivers, the ESC accumulator, the binning and the sharded
// merge write by index, sending every write they drop (padding lanes,
// empty table slots, products past a capacity) to one dump slot past the
// end (src/repro_torch/kernels/spgemm_hash.py numeric_epilogue,
// scatter_sub_rows, _scatter_nnz; src/repro_torch/core/esc.py;
// src/repro_torch/core/binning.py; src/repro_torch/engine/executor.py's
// merge).  torch's index_put_ / index_add_ would make every dropped write
// too, and the dump slot's share is hundreds of millions on mono_500Hz;
// under torch.use_deterministic_algorithms(True) they sort the indices
// and one thread walks each run of equal ones, so a steady call takes
// minutes.  The results need no order: each kept target gets one value
// (or equal values), and integer counts commute.  So the port calls these
// kernels on the card (the reference's jnp scatters have no Pallas kernel
// behind them):
//   scatter_kept: dst[index[i]] = src[i] where index[i] < limit (2-, 4- or
//                 8-byte elements, moved as bits); dropped writes are
//                 skipped, and so is their read of src;
//   count_into:   dst[index[i]] += src[i] where index[i] < limit (int32).
//                 The indices arrive sorted (ESC's rows, a row's bin), so
//                 a warp's lanes mostly share a target: the lanes with
//                 one target (__match_any_sync) sum their addends
//                 (__reduce_add_sync) and the lowest of them adds once.
// One thread an element, grid-stride.  What bounds them on the card:
// device-memory bytes (each index read once; each kept value or addend
// read once; each kept value written once, each count once).
//
// Every entry point returns cudaGetLastError() right after its launch;
// the Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename T>
__global__ void scatter_kept_kernel(T* __restrict__ dst,
                                    const long long* __restrict__ index,
                                    const T* __restrict__ src, long long n,
                                    long long limit) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const long long t = index[i];
    if (t >= 0 && t < limit) dst[t] = src[i];
  }
}

__global__ void count_into_kernel(int* __restrict__ dst,
                                  const long long* __restrict__ index,
                                  const int* __restrict__ src, long long n,
                                  long long limit) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // Every lane of a warp makes the same trips (n rounded up to a warp;
  // blockDim and step are multiples of 32), so the warp meets whole.
  const long long n_warps = (n + 31) & ~31LL;
  const int lane = threadIdx.x & 31;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_warps; i += step) {
    const long long t = i < n ? index[i] : -1;
    const bool kept = t >= 0 && t < limit;
    const int v = kept ? src[i] : 0;      // a dropped addend is not read
    const bool keep = kept && v != 0;
    const unsigned peers = __match_any_sync(0xffffffffu, keep ? t : -1LL);
    const int sum = __reduce_add_sync(peers, v);
    if (keep && lane == __ffs(peers) - 1) atomicAdd(&dst[t], sum);
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>(
      std::min(kMaxBlocks, (n + kThreads - 1) / kThreads));
}

template <typename T>
int launch_kept(void* dst, const long long* index, const void* src,
                long long n, long long limit, cudaStream_t stream) {
  scatter_kept_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<T*>(dst), index, static_cast<const T*>(src), n, limit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scatter_kept(void* dst, const long long* index, const void* src,
                 long long n, long long limit, int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return launch_kept<uint16_t>(dst, index, src, n, limit, s);
    case 4: return launch_kept<uint32_t>(dst, index, src, n, limit, s);
    case 8: return launch_kept<uint64_t>(dst, index, src, n, limit, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int count_into(int* dst, const long long* index, const int* src, long long n,
               long long limit, void* stream) {
  if (n <= 0) return 0;
  count_into_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(dst, index, src, n,
                                                           limit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
