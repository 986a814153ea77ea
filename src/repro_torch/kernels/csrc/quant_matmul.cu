// Dequantizing matrix product for int8 / int4 weight shards:
//   out (M, N) = x (M, K) @ (q (K, N) * scale (N,)), accumulated in fp32,
// x and out fp32, fp16 or bf16 (one type), scale fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/streamed_matmul.py ::
// quantized_matmul (kernel body _quant_matmul_kernel, _dequant_tile).  It
// computes the same function: q is int8 (K, N) for 8 bits, or uint8
// (ceil(K/2), N) for 4 bits with row 2i in the low nibble and row 2i+1 in
// the high nibble, each nibble sign-extended; scale is per output column.
// The scale is applied once per output column to the fp32 accumulator
// (sum_k x[m,k] q[k,n]) * s[n], not per tile to the weight as the Pallas
// body does: the two agree within fp32 rounding.  Any M, N and K are
// taken (the launcher applies the TPU kernel's divisibility contract only
// to tiles a caller asks for); for 4 bits an odd K's padding nibble meets
// x = 0.
//
// What bounds it on the H100:
//  * Decode (M = B <= 4): bytes.  Each weight byte feeds 2 * M flops (int8)
//    or 4 * M (int4), far below the fp32 balance point of ~20 flop/byte,
//    so the least time is the quantized weight read once at 3.35 TB/s.
//  * Prefill (M = 128): fp32 operations on the CUDA cores (2 M K N flops
//    against K N bytes of weight).
//
// What the design does about it:
//  * skinny_kernel (M <= kSkinnyM): one M tile, so every weight byte is
//    read from device memory once per launch.  A thread owns 16 columns
//    and loads a row's 16 bytes (int8: 16 values; int4: 32 values of two
//    rows) as one 16-byte vector, dequantizes in registers and FMAs into
//    4 x 16 accumulators.  256 threads = 4 column lanes (64 contiguous
//    bytes of a row per 4 threads) x 64 K lanes; the K lanes are reduced
//    by warp shuffles and shared memory.  Four rows' loads are issued
//    before their FMAs.  Narrow N (1024 columns = 16 blocks) would leave
//    most SMs idle, so the launcher also splits K across blocks; the
//    splits' partial sums go to a workspace and finalize_kernel adds them
//    in a fixed order (no atomics: results do not vary from run to run).
//  * M > kSkinnyM: mm_tiles.cuh's tile body, shared with
//    streamed_matmul.cu, over an int8 or int4 weight loader: the weight
//    tile is dequantized to fp32 in shared memory (the scale applied to
//    the accumulator at the end).  The caller's or the autotuned
//    (block_m, block_n, block_k) give the block's output region, its
//    register tile (64 or 128 per edge) and the K rows per stage (8, 16 or
//    32), as for streamed_matmul.cu; 64 x 64 with 32-row stages when
//    neither is given.
//  * fp32 FMA on the CUDA cores, no TF32.  wgmma, TMA and an int8 tensor
//    core path are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_tiles.cuh"

namespace {

using namespace elem;

constexpr int kSkinnyM = 4;                    // launcher: SKINNY_M
constexpr int kVec = 16;                       // bytes a thread loads per row
constexpr int kLanesN = 4;
constexpr int kLanesK = 64;                    // launcher: LANES_K
constexpr int kThreads = kLanesN * kLanesK;    // 256
constexpr int kBlockN = kLanesN * kVec;        // launcher: BLOCK_N (64)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float lo4(uint32_t b) {   // b: one byte
  return (float)((int)(b << 28) >> 28);
}
__device__ __forceinline__ float hi4(uint32_t b) {
  return (float)((int)(b << 24) >> 28);
}
__device__ __forceinline__ float s8(uint32_t b) {
  return (float)((int)(b << 24) >> 24);
}

// The 16 bytes of stored row r at columns [col0, col0 + 16); columns past
// N read as 0.  VEC: N % 16 == 0 and a 16-byte aligned base, so a chunk is
// wholly inside or wholly outside the row.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ w, int r,
                                        int col0, int N) {
  const size_t off = (size_t)r * N + col0;
  if (VEC) {
    if (col0 >= N) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(w + off));
  }
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (col0 + j < N) word[j / 4] |= (uint32_t)__ldg(w + off + j) << (8 * (j % 4));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// acc[m][j] += sum over the stored row r's K values of x[m, k] * q[k, col0 + j]
template <int BITS, class T>
__device__ __forceinline__ void accumulate(float (&acc)[kSkinnyM][kVec],
                                           const uint4 wv,
                                           const T* __restrict__ x, int r,
                                           int M, int K) {
  const uint32_t word[4] = {wv.x, wv.y, wv.z, wv.w};
  if (BITS == 8) {
    float xv[kSkinnyM];
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
      xv[m] = m < M ? ld(x + (size_t)m * K + r) : 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float q = s8((word[j / 4] >> (8 * (j % 4))) & 0xffu);
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m) acc[m][j] = fmaf(xv[m], q, acc[m][j]);
    }
  } else {
    const int k0 = 2 * r, k1 = 2 * r + 1;
    float xl[kSkinnyM], xh[kSkinnyM];
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m) {
      xl[m] = m < M ? ld(x + (size_t)m * K + k0) : 0.f;
      xh[m] = (m < M && k1 < K) ? ld(x + (size_t)m * K + k1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t b = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
      const float ql = lo4(b), qh = hi4(b);
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m) {
        acc[m][j] = fmaf(xl[m], ql, acc[m][j]);
        acc[m][j] = fmaf(xh[m], qh, acc[m][j]);
      }
    }
  }
}

// grid (ceil(N / kBlockN), splits), kThreads threads.  Split s walks stored
// rows [s * rows_per_split, min(rows, (s + 1) * rows_per_split)).  With
// part == nullptr (one split) it writes out * scale; else raw sums to
// part (splits, M, N).
template <int BITS, bool VEC, class T>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out,
              float* __restrict__ part, int M, int K, int N, int rows,
              int rows_per_split) {
  __shared__ float red[kWarps][kLanesN][kSkinnyM][kVec];
  const int lane_n = threadIdx.x % kLanesN;
  const int lane_k = threadIdx.x / kLanesN;
  const int col0 = blockIdx.x * kBlockN + lane_n * kVec;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);

  float acc[kSkinnyM][kVec];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

  for (int r0 = r_begin + lane_k; r0 < r_end; r0 += kUnroll * kLanesK) {
    uint4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kLanesK;
      wv[u] = r < r_end ? load16<VEC>(w, r, col0, N) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kLanesK;
      if (r < r_end) accumulate<BITS>(acc, wv[u], x, r, M, K);
    }
  }

  // Reduce the K lanes: the 8 of a warp (thread bits 2..4) by shuffles,
  // then the kWarps warps through shared memory.
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < kLanesN) {
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][lane_n][m][j] = acc[m][j];
  }
  __syncthreads();
  // one output (m, c) of the block's kSkinnyM x kBlockN per thread
  static_assert(kSkinnyM * kBlockN == kThreads, "one output per thread");
  const int m = threadIdx.x / kBlockN, c = threadIdx.x % kBlockN;
  const int col = blockIdx.x * kBlockN + c;
  if (m >= M || col >= N) return;
  float s = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) s += red[wi][c / kVec][m][c % kVec];
  if (part == nullptr)
    out[(size_t)m * N + col] = from_f32<T>(s * scale[col]);
  else
    part[((size_t)blockIdx.y * M + m) * N + col] = s;
}

// out[m, n] = scale[n] * sum over splits of part[s, m, n], splits in order.
template <class T>
__global__ void finalize_kernel(const float* __restrict__ part,
                                const float* __restrict__ scale,
                                T* __restrict__ out, int splits, int M,
                                int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * mn + i];
  out[i] = from_f32<T>(s * scale[i % N]);
}

// The weight loaders of mm_tiles.cuh's tile body: a K stage of the
// quantized (K, N) weight as fp32 integers (the scale is applied to the
// accumulator); past the edge, 0.
struct Int8B {
  const uint8_t* w;
  int K, N;
  __device__ float get(int k, int n) const {
    return (k < K && n < N) ? s8(__ldg(w + (size_t)k * N + n)) : 0.f;
  }
  template <int KC, int BN>
  __device__ __forceinline__ void stage(float (&ws)[KC][BN], int k0,
                                        int n0) const {
    mm::stage_elements(*this, ws, k0, n0);
  }
};

// Rows 2i (low nibble) and 2i + 1 (high) in byte row i: each byte is
// read once and fills two rows of the stage (KC and k0 are even).
struct Int4B {
  const uint8_t* w;
  int K, N;
  template <int KC, int BN>
  __device__ __forceinline__ void stage(float (&ws)[KC][BN], int k0,
                                        int n0) const {
#pragma unroll
    for (int i = 0; i < KC / 2 * BN / mm::kThreads; ++i) {
      const int e = threadIdx.x + i * mm::kThreads;
      const int pr = e / BN, nn = e % BN;
      const int k = k0 + 2 * pr, n = n0 + nn;
      const uint32_t b =
          (k < K && n < N) ? __ldg(w + (size_t)(k >> 1) * N + n) : 0u;
      ws[2 * pr][nn] = lo4(b);
      ws[2 * pr + 1][nn] = k + 1 < K ? hi4(b) : 0.f;
    }
  }
};

template <int BITS, class T>
int launch(const T* x, const uint8_t* w, const float* scale, T* out,
           float* part, int M, int K, int N, int splits, int rows_per_split,
           bool vec, int rm, int rn, int bm, int bn, int kc,
           cudaStream_t stream) {
  const int rows = BITS == 8 ? K : (K + 1) / 2;
  if (M > kSkinnyM) {
    if (BITS == 8)
      return mm::launch(rm, rn, bm, bn, kc, x, Int8B{w, K, N}, scale, out, M,
                        K, N, stream);
    return mm::launch(rm, rn, bm, bn, kc, x, Int4B{w, K, N}, scale, out, M,
                      K, N, stream);
  }
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits);
  float* dst = splits > 1 ? part : nullptr;
  if (vec)
    skinny_kernel<BITS, true, T><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, M, K, N, rows, rows_per_split);
  else
    skinny_kernel<BITS, false, T><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, M, K, N, rows, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits <= 1) return (int)e;
  const size_t mn = (size_t)M * N;
  finalize_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, scale, out, splits, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) and out (M, N) of the storage type `dtype` (elem::DType); w:
// int8 (K, N) for bits 8, uint8 (ceil(K/2), N) for bits 4; scale (N,) f32;
// all contiguous, M, N, K > 0.  For M <= 4: splits (>= 1) K splits of
// rows_per_split stored rows each, part (splits, M, N) f32 when splits > 1
// (else unused); vec: N % 16 == 0 and w 16-byte aligned.  For M > 4:
// blocks own rm x rn output regions, walked in the bm x bn register tile,
// (bm, bn) in {64, 128}^2, with kc in {8, 16, 32} K rows per stage.
// Returns the CUDA error of the launches (0 = none).
extern "C" int repro_quant_matmul(const void* x, const uint8_t* w,
                                  const float* scale, void* out, float* part,
                                  int M, int K, int N, int bits, int splits,
                                  int rows_per_split, int vec, int rm, int rn,
                                  int bm, int bn, int kc, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (bits == 8)
      return launch<8>(xt, w, scale, ot, part, M, K, N, splits,
                       rows_per_split, vec != 0, rm, rn, bm, bn, kc, st);
    return launch<4>(xt, w, scale, ot, part, M, K, N, splits, rows_per_split,
                     vec != 0, rm, rn, bm, bn, kc, st);
  });
}
