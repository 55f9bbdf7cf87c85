// Block-CSR sparse x dense product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/bsr_spmm.py
// (bsr_spmm): for every stored (bm x bk) block of block row r and block
// column c, out[r*bm:(r+1)*bm] += block @ dense[c*bk:(c+1)*bk], summed in
// float32 and written once in the dense operand's type.
//
// What both entry points do differently from the TPU kernel:
//   * The TPU grid is one sequential step per stored block, carrying the
//     block row's sum in VMEM from step to step.  Here nothing carries over
//     between CTAs, so the work is split by OUTPUT tile instead: one CTA per
//     (block row, row slice of it, column tile of N).  It walks its block
//     row's stored blocks in order, between row pointers the wrapper builds
//     on the device from the sorted block-row ids, so the stripe is written
//     exactly once: no atomics, a fixed summation order.
//   * Block rows with no stored block are written as zeros (the TPU kernel
//     never visits them and leaves them unwritten).  Entries with a block
//     row outside [0, n_block_rows) fall outside every row pointer range
//     and add nothing; padding entries with zero blocks add zeros.
//
// bfloat16 and float16 (bsr_spmm_bf16, bsr_spmm_f16: one kernel template,
// bsr_spmm_tc_kernel<F16>, whose two instances differ in the wgmma type and
// the output's rounding only): tensor cores.  What bounds it on the card is
// the operations, 2*nnzb*bm*bk*N at 989 TFLOP/s; the bytes (blocks, dense
// stripes and output once each) come second.  One CTA computes a 128 x 128
// output tile with two consumer warpgroups, each issuing
// wgmma.mma_async m64n128k16 (bf16 in, float32 sums in registers) on its
// 64 rows.  The CTA walks its block row's blocks as one long K loop in
// 64-deep stages.  A ring of three stages in shared memory holds the block
// slice (A, 128 x 64, K-major) and the dense stripe slice (B, 64 x 128,
// N-major), both in the 128-byte swizzled layout that wgmma's descriptors
// take; every thread fills it with 16-byte cp.async copies, so the loads of
// stage k+2 run while the tensor cores work on stage k.  Ragged edges (bm,
// bk or N not a multiple of the tile, rows not 16-byte aligned) are one
// code path: a 16-byte chunk that is not whole or not aligned is read
// element by element and zero-filled in shared memory, and the store is
// masked.  About 97 KB of shared memory and at most 128 registers a thread
// let two CTAs share an SM, so one CTA's epilogue overlaps the other's
// K loop.
//
// float32 (bsr_spmm_f32): CUDA cores, in full float32 (TF32 would keep
// about three decimal digits).  What bounds it is the float32 FMAs against
// the 67 TFLOP/s CUDA-core peak, so the design keeps the FMA pipes fed:
//   * One CTA of 256 threads computes a 128 x 128 output tile; each thread
//     holds 8 x 8 sums, two 4 x 4 quads 64 rows and 64 columns apart, and
//     reads its A and B fragments with 16-byte shared loads: 64 FMAs for 4
//     loads.  A warp covers 4 x 8 threads, so each load of a warp touches 4
//     (A) or 8 (B) distinct chunks and takes one pass of the banks.
//   * B (the dense stripe, N-major) goes straight into s_b[k][n] by 16-byte
//     cp.async.  A (row-major bm x bk) is read 16 bytes at a time along k
//     into registers and stored transposed into s_a[k][m], its 16-byte
//     chunks XOR-swizzled by depth so a warp's stores hit all 32 banks.
//   * A ring of two 16-deep stages: the loads of stage k+1 are in flight
//     while the FMAs run on stage k (three stages measured 5 % slower:
//     the ablation's `bsr_f32` part).  The CTA walks its block row's blocks
//     as one long K loop, so the ring does not drain at block boundaries.
//   * Ragged edges take the bf16 kernel's one code path: a chunk that is not
//     whole or not aligned is read element by element and zero-filled, and
//     the store is masked.
//   * At most 128 registers a thread and 32 KB of shared memory let two
//     CTAs share an SM.  Column tiles vary fastest in the grid, so the CTAs
//     of one block row run together and read its blocks from L2.  Taking
//     the block rows longest first did not pay on the card (the ablation's
//     `bsr_f32` part measures it).

// Every entry point returns cudaGetLastError() right after its launch; the
// Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Shared by both kernels: cp.async groups.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs, an SGEMM-style register tile over a cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kFM = 128;          // output rows per CTA
constexpr int kFN = 128;          // output columns per CTA
constexpr int kFK = 16;           // depth of one stage
constexpr int kF32Stages = 2;
constexpr int kFThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kFStageFloats = kFK * (kFM + kFN);
constexpr int kFSmemBytes = kF32Stages * kFStageFloats * 4;
// Each thread moves two 16-byte chunks of A and two of B per stage, and
// the depths of a stage span at most the 4 swizzles of a_swizzle.
static_assert(kFM * kFK / 4 == 2 * kFThreads && kFK * kFN / 4 == 2 * kFThreads,
              "two chunks of A and of B per thread and stage");
static_assert(kFSmemBytes <= 48 * 1024,
              "above 48 KB the ring needs the dynamic shared memory opt-in");

// One 16-byte chunk (4 floats) from global memory: a vector load when all
// 4 elements exist and the source is 16-byte aligned, otherwise the
// `valid` leading elements one by one and zeros after them.
__device__ __forceinline__ float4 load_chunk_f32(const float* src,
                                                 int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(src));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (valid > 0) v.x = __ldg(src);
  if (valid > 1) v.y = __ldg(src + 1);
  if (valid > 2) v.z = __ldg(src + 2);
  if (valid > 3) v.w = __ldg(src + 3);
  return v;
}

// The same chunk into shared memory: cp.async when whole and aligned.
__device__ __forceinline__ void copy_chunk_f32(float* dst, const float* src,
                                               int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
    return;
  }
  *reinterpret_cast<float4*>(dst) = load_chunk_f32(src, valid);
}

// Stores 4 consecutive outputs of one row, masked at the ragged edge.
__device__ __forceinline__ void store_quad(float* dst, int col, int n,
                                           float4 v) {
  if (col + 3 < n && (reinterpret_cast<uintptr_t>(dst + col) & 15) == 0) {
    *reinterpret_cast<float4*>(dst + col) = v;
    return;
  }
  if (col < n) dst[col] = v.x;
  if (col + 1 < n) dst[col + 1] = v.y;
  if (col + 2 < n) dst[col + 2] = v.z;
  if (col + 3 < n) dst[col + 3] = v.w;
}

// Stage layout: s_a[k][m] (the block slice transposed) then s_b[k][n] (the
// dense stripe slice), kFK x 128 floats each.  In s_a, the 16-byte chunk
// of rows 4c..4c+3 at depth k sits at chunk c ^ a_swizzle(k), so that the
// transposing stores of a warp (8 rows x 4 depths) hit all 32 banks.
__device__ __forceinline__ int a_swizzle(int k) { return ((k >> 2) & 3) << 1; }

__global__ void __launch_bounds__(kFThreads, 2)
bsr_spmm_f32_kernel(const int* __restrict__ ptr,
                    const int* __restrict__ blk_cols,
                    const float* __restrict__ blocks,
                    const float* __restrict__ dense, float* __restrict__ out,
                    int bm, int bk, int n, int m_tiles, int n_tiles,
                    int k_steps) {
  extern __shared__ float4 smem_f32[];
  float* const smem = reinterpret_cast<float*>(smem_f32);

  const int nt = blockIdx.x % n_tiles;
  const int slot = blockIdx.x / n_tiles;
  const int r = slot / m_tiles;                 // block row
  const int m0 = (slot % m_tiles) * kFM;        // first row in it
  const int n0 = nt * kFN;
  const int tid = threadIdx.x;
  const int lo = ptr[r];
  const int total = (ptr[r + 1] - lo) * k_steps;  // stages of the K loop

  // A warp covers 4 x 8 threads of the 16 x 16 grid: it reads 4 distinct
  // A chunks and 8 distinct B chunks per depth, each set in one pass.
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // rows 4ty.., 64 + 4ty..
  const int tx = (warp & 1) * 8 + (lane & 7);     // cols 4tx.., 64 + 4tx..

  // Chunks this thread moves per stage: A (128 x 16 floats) and B (16 x
  // 128 floats) are 512 chunks each, two per thread.  The next stage to
  // load is depth kc of block e; `advance` steps it on.
  int e = lo, kc = 0;
  auto advance = [&]() {
    kc += kFK;
    if (kc >= bk) {
      kc = 0;
      ++e;
    }
  };
  float4 a_next[2];
  auto load_a = [&]() {
    const float* blk = blocks + static_cast<size_t>(e) * bm * bk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kFThreads;
      const int row = q >> 2, c = q & 3;     // 4 chunks along k per row
      const int gr = m0 + row, gk = kc + c * 4;
      a_next[i] = load_chunk_f32(blk + static_cast<size_t>(gr) * bk + gk,
                                 gr < bm ? bk - gk : 0);
    }
  };
  auto store_a = [&](int t) {
    float* sa = smem + (t % kF32Stages) * kFStageFloats;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kFThreads;
      const int row = q >> 2, c = q & 3;
      const int at = (((row >> 2) ^ a_swizzle(c * 4)) << 2) | (row & 3);
      sa[(c * 4 + 0) * kFM + at] = a_next[i].x;
      sa[(c * 4 + 1) * kFM + at] = a_next[i].y;
      sa[(c * 4 + 2) * kFM + at] = a_next[i].z;
      sa[(c * 4 + 3) * kFM + at] = a_next[i].w;
    }
  };
  auto load_b = [&](int t) {
    const float* stripe = dense + static_cast<size_t>(blk_cols[e]) * bk * n;
    float* sb = smem + (t % kF32Stages) * kFStageFloats + kFK * kFM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kFThreads;
      const int k = q >> 5, cn = q & 31;     // 32 chunks per B row
      const int gk = kc + k, gn = n0 + cn * 4;
      copy_chunk_f32(sb + k * kFN + cn * 4,
                     stripe + static_cast<size_t>(gk) * n + gn,
                     gk < bk ? n - gn : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // Offset of this thread's first A chunk at depths 4s..4s+3 (its second
  // is 64 floats on).
  int a_off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) a_off[s] = (ty ^ a_swizzle(s * 4)) << 2;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < total) {
      load_a();
      load_b(s);
      advance();
    }
    cp_async_commit();
    if (s < total) store_a(s);
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kF32Stages - 2>();   // stage t's B has landed (mine)
    __syncthreads();                   // ... everyone's, A too, and the
                                       // slot of stage t - 1 is free
    const int tn = t + kF32Stages - 1;
    if (tn < total) {
      load_a();                        // into registers, stored below
      load_b(tn);
      advance();
    }
    cp_async_commit();
    const float* sa = smem + (t % kF32Stages) * kFStageFloats;
    const float* sb = sa + kFK * kFM;
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const int off = a_off[k >> 2];
      const float4 a0 = *reinterpret_cast<const float4*>(sa + k * kFM + off);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sa + k * kFM + 64 + off);
      const float4 b0 =
          *reinterpret_cast<const float4*>(sb + k * kFN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + k * kFN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (tn < total) store_a(tn);       // the slot of stage t - 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= bm) continue;
    float* dst = out + (static_cast<size_t>(r) * bm + row) * n;
    store_quad(dst, n0 + tx * 4, n,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    store_quad(dst, n0 + 64 + tx * 4, n,
               make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores over a cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // output rows per CTA (2 warpgroups x 64)
constexpr int kBN = 128;          // output columns per CTA
constexpr int kBK = 64;           // depth of a stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kTcThreads = 256;   // two consumer warpgroups
constexpr int kATileBytes = kBM * kBK * 2;            // 16 KB
constexpr int kBTileBytes = kBK * kBN * 2;            // 16 KB
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kTcSmemBytes = kStages * kStageBytes + 1024;  // + 1 KB to align
// Shared-memory strides of the swizzled tiles, in bytes.  A (K-major): row
// m at m*128, 8-row groups 1024 apart.  B (N-major): for each 64-column
// half h, row k at h*kBHalf + k*128, so 8-row (k) groups are 1024 apart.
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kGroupBytes = 1024;
constexpr uint32_t kBHalf = kBK * kRowBytes;          // 8192
// wgmma descriptor offsets (bytes).  A: LBO is unused for a swizzled
// K-major tile, SBO = stride between 8-row groups.  B (N-major): LBO =
// stride between 64-column halves, SBO = stride between 8-row (k) groups.
constexpr uint32_t kALbo = 16;
constexpr uint32_t kASbo = kGroupBytes;
constexpr uint32_t kBLbo = kBHalf;
constexpr uint32_t kBSbo = kGroupBytes;

// Matrix descriptor of a shared-memory operand in the 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;    // 128-byte swizzle
  return d;
}

// D(64 x 128, f32) += A(64 x 16, K-major) * B(16 x 128, N-major), A and B
// in bf16 (F16 false) or f16 (F16 true).
#define WGMMA_M64N128K16(TYPE)                                   \
  asm volatile(                                                  \
      "{\n"                                                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, 1, 1, 1, 0, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db))

template <bool F16>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  if constexpr (F16) {
    WGMMA_M64N128K16("f16");
  } else {
    WGMMA_M64N128K16("bf16");
  }
}
#undef WGMMA_M64N128K16

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes (cp.async and plain stores)
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 16-byte chunk (8 bf16) from global to shared: a cp.async when all 8
// elements exist and the source is 16-byte aligned, otherwise the `valid`
// leading elements one by one and zeros after them.
__device__ __forceinline__ void copy_chunk(uint32_t dst,
                                           const unsigned short* src,
                                           int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
    return;
  }
  unsigned short v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < valid ? __ldg(src + j) : 0;
  const uint32_t w0 = v[0] | (static_cast<uint32_t>(v[1]) << 16);
  const uint32_t w1 = v[2] | (static_cast<uint32_t>(v[3]) << 16);
  const uint32_t w2 = v[4] | (static_cast<uint32_t>(v[5]) << 16);
  const uint32_t w3 = v[6] | (static_cast<uint32_t>(v[7]) << 16);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w0), "r"(w1), "r"(w2), "r"(w3)
               : "memory");
}

// The output type of the tensor-core kernel: bf16, or f16 with F16.
template <bool F16>
struct TcOut {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  __device__ static T one(float v) { return __float2bfloat16_rn(v); }
  __device__ static T2 two(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <>
struct TcOut<true> {
  using T = __half;
  using T2 = __half2;
  __device__ static T one(float v) { return __float2half_rn(v); }
  __device__ static T2 two(float a, float b) { return __floats2half2_rn(a, b); }
};

template <bool F16>
__global__ void __launch_bounds__(kTcThreads, 2)
bsr_spmm_tc_kernel(const int* __restrict__ ptr,
                   const int* __restrict__ blk_cols,
                   const unsigned short* __restrict__ blocks,
                   const unsigned short* __restrict__ dense,
                   typename TcOut<F16>::T* __restrict__ out, int bm, int bk,
                   int n, int m_tiles, int k_steps) {
  using Out = TcOut<F16>;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is a function of the address bits, so each tile starts on
  // a 1024-byte boundary.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int r = blockIdx.x / m_tiles;           // block row
  const int m0 = (blockIdx.x % m_tiles) * kBM;  // first row inside it
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lo = ptr[r];
  const int total = (ptr[r + 1] - lo) * k_steps;  // stages of the K loop

  // Stage t holds rows m0.. of block lo + t / k_steps, columns kc..kc+63
  // (A), and rows kc..kc+63, columns n0..n0+127 of its dense stripe (B).
  auto load_stage = [&](int t) {
    const int e = lo + t / k_steps;
    const int kc = (t % k_steps) * kBK;
    const uint32_t sa = base + (t % kStages) * kStageBytes;
    const uint32_t sb = sa + kATileBytes;
    const unsigned short* blk = blocks + static_cast<size_t>(e) * bm * bk;
    const unsigned short* stripe =
        dense + static_cast<size_t>(blk_cols[e]) * bk * n;
#pragma unroll
    for (int i = 0; i < kATileBytes / 16 / kTcThreads; ++i) {
      const int q = tid + i * kTcThreads;
      const int row = q >> 3, c = q & 7;        // 8 chunks per 128-B row
      const int gr = m0 + row, gk = kc + c * 8;
      copy_chunk(sa + row * kRowBytes + ((c ^ (row & 7)) << 4),
                 blk + static_cast<size_t>(gr) * bk + gk,
                 gr < bm ? bk - gk : 0);
    }
#pragma unroll
    for (int i = 0; i < kBTileBytes / 16 / kTcThreads; ++i) {
      const int q = tid + i * kTcThreads;
      const int k = q >> 4, cn = q & 15;        // 16 chunks per B row
      const int h = cn >> 3, c = cn & 7;
      const int gk = kc + k, gn = n0 + cn * 8;
      copy_chunk(sb + h * kBHalf + k * kRowBytes + ((c ^ (k & 7)) << 4),
                 stripe + static_cast<size_t>(gk) * n + gn,
                 gk < bk ? n - gn : 0);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();   // stage t has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                // ... every thread's, and stage t-1 is
                                    // free: both warpgroups waited on it
    if (t + kStages - 1 < total) load_stage(t + kStages - 1);
    cp_async_commit();
    const uint32_t sa = base + (t % kStages) * kStageBytes +
                        wg * 64 * kRowBytes;
    const uint32_t sb = base + (t % kStages) * kStageBytes + kATileBytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      wgmma_m64n128k16<F16>(acc, wgmma_desc(sa + 32 * j, kALbo, kASbo),
                       wgmma_desc(sb + 16 * kRowBytes * j, kBLbo, kBSbo));
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  // Accumulator layout of m64nNk16: thread (warp w, lane l) of a warpgroup
  // holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1), j = 0..15.
  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= bm) continue;
    typename Out::T* dst = out + (static_cast<size_t>(r) * bm + row) * n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (col + 1 < n && (reinterpret_cast<uintptr_t>(dst + col) & 3) == 0) {
        *reinterpret_cast<typename Out::T2*>(dst + col) = Out::two(v0, v1);
      } else {
        if (col < n) dst[col] = Out::one(v0);
        if (col + 1 < n) dst[col + 1] = Out::one(v1);
      }
    }
  }
}

// The tensor-core kernel's opt-in above 48 KB of dynamic shared memory,
// and the largest shared-memory carveout so that two CTAs share an SM.
template <bool F16>
cudaError_t set_tc_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_tc_kernel<F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bsr_spmm_tc_kernel<F16>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The tensor-core kernel's grid: (block row x row slice, column tile).
bool grid_of(int n_block_rows, int bm, int n, int* m_tiles, dim3* grid) {
  *m_tiles = (bm + kBM - 1) / kBM;
  const long long gx = static_cast<long long>(n_block_rows) * *m_tiles;
  const int gy = (n + kBN - 1) / kBN;
  if (gx > 0x7fffffffLL || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), gy);
  return true;
}

template <bool F16>
int bsr_spmm_tc(const int* ptr, const int* blk_cols, const void* blocks,
                const void* dense, void* out, int n_block_rows, int bm, int bk,
                int n, void* stream) {
  if (n_block_rows < 0 || bm < 1 || bk < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0 || n == 0) return 0;
  int m_tiles;
  dim3 grid;
  if (!grid_of(n_block_rows, bm, n, &m_tiles, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_tc_attributes<F16>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_steps = (bk + kBK - 1) / kBK;
  bsr_spmm_tc_kernel<F16><<<grid, kTcThreads, kTcSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      ptr, blk_cols, static_cast<const unsigned short*>(blocks),
      static_cast<const unsigned short*>(dense),
      static_cast<typename TcOut<F16>::T*>(out), bm, bk, n, m_tiles, k_steps);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's dynamic shared memory per CTA, and how many of
// its CTAs fit on one SM at once (the runtime's occupancy calculator).
template <bool F16>
int tc_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = kTcSmemBytes;
  const cudaError_t err = set_tc_attributes<F16>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, bsr_spmm_tc_kernel<F16>, kTcThreads, kTcSmemBytes));
}

}  // namespace

extern "C" {

// ptr: (n_block_rows + 1,) int32 row pointers into the stored blocks;
// blk_cols: (nnzb,) int32; blocks: (nnzb, bm, bk); dense: (K, n);
// out: (n_block_rows * bm, n).  All on the device, contiguous.
int bsr_spmm_f32(const int* ptr, const int* blk_cols, const float* blocks,
                 const float* dense, float* out, int n_block_rows, int bm,
                 int bk, int n, void* stream) {
  if (n_block_rows < 0 || bm < 1 || bk < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_block_rows == 0 || n == 0) return 0;
  const int m_tiles = (bm + kFM - 1) / kFM;
  const int n_tiles = (n + kFN - 1) / kFN;
  const long long grid =
      static_cast<long long>(n_block_rows) * m_tiles * n_tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int k_steps = (bk + kFK - 1) / kFK;
  bsr_spmm_f32_kernel<<<static_cast<unsigned>(grid), kFThreads, kFSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      ptr, blk_cols, blocks, dense, out, bm, bk, n, m_tiles, n_tiles,
      k_steps);
  return static_cast<int>(cudaGetLastError());
}

int bsr_spmm_bf16(const int* ptr, const int* blk_cols, const void* blocks,
                  const void* dense, void* out, int n_block_rows, int bm,
                  int bk, int n, void* stream) {
  return bsr_spmm_tc<false>(ptr, blk_cols, blocks, dense, out, n_block_rows,
                            bm, bk, n, stream);
}

int bsr_spmm_f16(const int* ptr, const int* blk_cols, const void* blocks,
                 const void* dense, void* out, int n_block_rows, int bm,
                 int bk, int n, void* stream) {
  return bsr_spmm_tc<true>(ptr, blk_cols, blocks, dense, out, n_block_rows,
                           bm, bk, n, stream);
}

// The f32 kernel's dynamic shared memory per CTA, and how many of its CTAs
// fit on one SM at once (the runtime's occupancy calculator).
int bsr_spmm_f32_occupancy(int* smem_bytes, int* ctas_per_sm) {
  *smem_bytes = kFSmemBytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, bsr_spmm_f32_kernel, kFThreads, kFSmemBytes));
}

int bsr_spmm_bf16_occupancy(int* smem_bytes, int* ctas_per_sm) {
  return tc_occupancy<false>(smem_bytes, ctas_per_sm);
}

int bsr_spmm_f16_occupancy(int* smem_bytes, int* ctas_per_sm) {
  return tc_occupancy<true>(smem_bytes, ctas_per_sm);
}

}  // extern "C"
