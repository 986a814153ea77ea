// Dequantizing matrix product for int8 / int4 weight shards, fp32:
//   out (M, N) = x (M, K) @ (q (K, N) * scale (N,)), accumulated in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/streamed_matmul.py ::
// quantized_matmul (kernel body _quant_matmul_kernel, _dequant_tile).  It
// computes the same function: q is int8 (K, N) for 8 bits, or uint8
// (ceil(K/2), N) for 4 bits with row 2i in the low nibble and row 2i+1 in
// the high nibble, each nibble sign-extended; scale is per output column.
// The scale is applied once per output column to the fp32 accumulator
// (sum_k x[m,k] q[k,n]) * s[n], not per tile to the weight as the Pallas
// body does: the two agree within fp32 rounding.  Any M, N and K are
// taken (the TPU kernel's 256/256/512 divisibility does not apply); for
// 4 bits an odd K's padding nibble meets x = 0.
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
//  * tiled_kernel (M > kSkinnyM): a 64 x 64 output tile per block, 32-deep
//    K steps through shared memory (x tile transposed, weight tile
//    dequantized to fp32 there), 4 x 4 outputs per thread at a 16-element
//    stride so shared-memory reads do not collide in a bank.
//  * fp32 FMA on the CUDA cores, no TF32.  wgmma, TMA and an int8 tensor
//    core path are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSkinnyM = 4;                    // launcher: SKINNY_M
constexpr int kVec = 16;                       // bytes a thread loads per row
constexpr int kLanesN = 4;
constexpr int kLanesK = 64;                    // launcher: LANES_K
constexpr int kThreads = kLanesN * kLanesK;    // 256
constexpr int kBlockN = kLanesN * kVec;        // launcher: BLOCK_N (64)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

constexpr int kTM = 64, kTN = 64, kTK = 32;    // tiled_kernel

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
template <int BITS>
__device__ __forceinline__ void accumulate(float (&acc)[kSkinnyM][kVec],
                                           const uint4 wv,
                                           const float* __restrict__ x, int r,
                                           int M, int K) {
  const uint32_t word[4] = {wv.x, wv.y, wv.z, wv.w};
  if (BITS == 8) {
    float xv[kSkinnyM];
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
      xv[m] = m < M ? __ldg(x + (size_t)m * K + r) : 0.f;
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
      xl[m] = m < M ? __ldg(x + (size_t)m * K + k0) : 0.f;
      xh[m] = (m < M && k1 < K) ? __ldg(x + (size_t)m * K + k1) : 0.f;
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
template <int BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out,
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
    out[(size_t)m * N + col] = s * scale[col];
  else
    part[((size_t)blockIdx.y * M + m) * N + col] = s;
}

// out[m, n] = scale[n] * sum over splits of part[s, m, n], splits in order.
__global__ void finalize_kernel(const float* __restrict__ part,
                                const float* __restrict__ scale,
                                float* __restrict__ out, int splits, int M,
                                int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * mn + i];
  out[i] = s * scale[i % N];
}

// grid (ceil(N / kTN), ceil(M / kTM)), 256 threads.
template <int BITS>
__global__ void __launch_bounds__(256)
tiled_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, int M,
             int K, int N, int rows) {
  __shared__ float xs[kTK][kTM + 1];   // x tile, transposed: xs[k][m]
  __shared__ float ws[kTK][kTN];       // dequantized weight tile (no scale)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < kTM * kTK / 256; ++i) {
      const int e = tid + i * 256, mm = e / kTK, kk = e % kTK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.f;
    }
    if (BITS == 8) {
#pragma unroll
      for (int i = 0; i < kTK * kTN / 256; ++i) {
        const int e = tid + i * 256, kk = e / kTN, nn = e % kTN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N) ? s8(__ldg(w + (size_t)gk * N + gn)) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTK / 2 * kTN / 256; ++i) {
        const int e = tid + i * 256, pr = e / kTN, nn = e % kTN;
        const int gr = k0 / 2 + pr, gn = n0 + nn;
        const uint32_t b = (gr < rows && gn < N) ? __ldg(w + (size_t)gr * N + gn) : 0u;
        ws[2 * pr][nn] = lo4(b);
        ws[2 * pr + 1][nn] = hi4(b);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

template <int BITS>
int launch(const float* x, const uint8_t* w, const float* scale, float* out,
           float* part, int M, int K, int N, int splits, int rows_per_split,
           bool vec, cudaStream_t stream) {
  const int rows = BITS == 8 ? K : (K + 1) / 2;
  if (M > kSkinnyM) {
    const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    tiled_kernel<BITS><<<grid, 256, 0, stream>>>(x, w, scale, out, M, K, N, rows);
    return (int)cudaGetLastError();
  }
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits);
  float* dst = splits > 1 ? part : nullptr;
  if (vec)
    skinny_kernel<BITS, true><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, M, K, N, rows, rows_per_split);
  else
    skinny_kernel<BITS, false><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, M, K, N, rows, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits <= 1) return (int)e;
  const size_t mn = (size_t)M * N;
  finalize_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, scale, out, splits, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32; w: int8 (K, N) for bits 8, uint8 (ceil(K/2), N) for bits 4;
// scale (N,) f32; out (M, N) f32; all contiguous, M, N, K > 0.  For
// M <= 4: splits (>= 1) K splits of rows_per_split stored rows each, part
// (splits, M, N) f32 when splits > 1 (else unused); vec: N % 16 == 0 and
// w 16-byte aligned.  Returns the CUDA error of the launches (0 = none).
extern "C" int repro_quant_matmul_f32(const float* x, const uint8_t* w,
                                      const float* scale, float* out,
                                      float* part, int M, int K, int N,
                                      int bits, int splits,
                                      int rows_per_split, int vec,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return launch<8>(x, w, scale, out, part, M, K, N, splits, rows_per_split,
                     vec != 0, st);
  if (bits == 4)
    return launch<4>(x, w, scale, out, part, M, K, N, splits, rows_per_split,
                     vec != 0, st);
  return (int)cudaErrorInvalidValue;
}
