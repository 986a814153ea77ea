// Tiled matrix-product body shared by streamed_matmul.cu (dense weights)
// and quant_matmul.cu's tiled path (int8 / int4 weights):
//   out (M, N) = x (M, K) @ w (K, N) [* col_scale (N,)], fp32 accumulation.
//
// x and out are fp32, fp16 or bf16 (T); the weight is read through a
// Loader that fills a K stage of it as fp32 (dense T, int8 or packed int4).
// Every product is an fp32 FMA on the CUDA cores: no TF32 and no tensor
// cores, so fp32 inputs keep fp32 accuracy.  wgmma / TMA are later work.
//
// Tiling:
//  * One block of kThreads = 256 threads owns an RM x RN region of the
//    output (the launcher's block_m x block_n, any size) and walks it in
//    BM x BN register tiles, (BM, BN) in {64, 128}^2: each thread holds a
//    (BM / 16) x (BN / 16) micro-tile at a 16-element stride, so
//    shared-memory reads do not collide in a bank.  A region of 256 rows
//    is two 128-row tiles in turn; one of at most the tile's edge is one
//    tile, its rows or columns past the region masked.
//  * K is walked in stages of KC rows (8, 16 or 32, compiled in): the
//    stage's x tile is staged transposed (xs[k][m], rows padded by one)
//    and the weight tile as fp32 (ws[k][n]) in static shared memory,
//    4 * KC * (BM + 1 + BN) bytes, at most 4 * 32 * (129 + 128) = 32,896 B.
//    A launcher maps the reference's block_k onto KC: its 256 x 512 fp32
//    x tile alone would be 512 KiB, far over shared memory, so a block_k
//    step is staged as block_k / KC sub-chunks of KC rows.
//  * Any M, N and K: rows, columns and K rows past the edge load as 0 and
//    are not stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace mm {

using namespace elem;

constexpr int kThreads = 256;

// Fills a KC x BN weight stage element by element through w.get(k, n)
// (fp32 of element (k, n), 0 past the edge); neighbouring threads walk N.
template <int KC, int BN, class Loader>
__device__ __forceinline__ void stage_elements(const Loader& w,
                                               float (&ws)[KC][BN], int k0,
                                               int n0) {
#pragma unroll
  for (int i = 0; i < KC * BN / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int kk = e / BN, nn = e % BN;
    ws[kk][nn] = w.get(k0 + kk, n0 + nn);
  }
}

// Dense (K, N) weight of type T.
template <class T>
struct DenseB {
  const T* w;
  int K, N;
  __device__ float get(int k, int n) const {
    return (k < K && n < N) ? ld(w + (size_t)k * N + n) : 0.f;
  }
  template <int KC, int BN>
  __device__ __forceinline__ void stage(float (&ws)[KC][BN], int k0,
                                        int n0) const {
    stage_elements(*this, ws, k0, n0);
  }
};

// grid (ceil(N / RN), ceil(M / RM)), kThreads threads: the block's RM x RN
// region of x @ w [* col_scale], x (M, K) of type T, w through Loader, in
// BM x BN tiles with KC K rows per shared-memory stage; col_scale NULL
// means none.
template <int BM, int BN, int KC, class T, class Loader>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const T* __restrict__ x, Loader w,
          const float* __restrict__ col_scale, T* __restrict__ out, int M,
          int K, int N, int RM, int RN) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float xs[KC][BM + 1];   // x stage, transposed
  __shared__ float ws[KC][BN];       // weight stage, as fp32
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * RM, c0 = blockIdx.x * RN;
  const int m_end = min(M, r0 + RM), n_end = min(N, c0 + RN);
  for (int m0 = r0; m0 < m_end; m0 += BM) {
    for (int n0 = c0; n0 < n_end; n0 += BN) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
        for (int i = 0; i < BM * KC / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int mm = e / KC, kk = e % KC;      // neighbours walk K
          const int gm = m0 + mm, gk = k0 + kk;
          xs[kk][mm] =
              (gm < m_end && gk < K) ? ld(x + (size_t)gm * K + gk) : 0.f;
        }
        w.template stage<KC, BN>(ws, k0, n0);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
          float a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty + 16 * i;
        if (gm >= m_end) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gn = n0 + tx + 16 * j;
          if (gn >= n_end) continue;
          const float v = col_scale ? acc[i][j] * col_scale[gn] : acc[i][j];
          out[(size_t)gm * N + gn] = from_f32<T>(v);
        }
      }
    }
  }
}

template <int BM, int BN, int KC, class T, class Loader>
int launch_tile(const T* x, const Loader& w, const float* col_scale, T* out,
                int M, int K, int N, int rm, int rn, cudaStream_t st) {
  const dim3 grid((N + rn - 1) / rn, (M + rm - 1) / rm);
  mm_kernel<BM, BN, KC, T, Loader><<<grid, kThreads, 0, st>>>(
      x, w, col_scale, out, M, K, N, rm, rn);
  return (int)cudaGetLastError();
}

template <int BM, int BN, class T, class Loader>
int launch_kc(int kc, const T* x, const Loader& w, const float* col_scale,
              T* out, int M, int K, int N, int rm, int rn, cudaStream_t st) {
  switch (kc) {
    case 8:
      return launch_tile<BM, BN, 8>(x, w, col_scale, out, M, K, N, rm, rn,
                                    st);
    case 16:
      return launch_tile<BM, BN, 16>(x, w, col_scale, out, M, K, N, rm, rn,
                                     st);
    case 32:
      return launch_tile<BM, BN, 32>(x, w, col_scale, out, M, K, N, rm, rn,
                                     st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches blocks of rm x rn output regions (rm, rn > 0) walked in the
// (bm, bn) register tile with kc-row stages; anything else is
// cudaErrorInvalidValue.
template <class T, class Loader>
int launch(int rm, int rn, int bm, int bn, int kc, const T* x,
           const Loader& w, const float* col_scale, T* out, int M, int K,
           int N, cudaStream_t st) {
  if (rm <= 0 || rn <= 0) return (int)cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return launch_kc<64, 64>(kc, x, w, col_scale, out, M, K, N, rm, rn, st);
  if (bm == 64 && bn == 128)
    return launch_kc<64, 128>(kc, x, w, col_scale, out, M, K, N, rm, rn, st);
  if (bm == 128 && bn == 64)
    return launch_kc<128, 64>(kc, x, w, col_scale, out, M, K, N, rm, rn, st);
  if (bm == 128 && bn == 128)
    return launch_kc<128, 128>(kc, x, w, col_scale, out, M, K, N, rm, rn,
                               st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mm
