// The skinny dequantizing product, M <= 4 rows of x against an int8 / int4
// weight read once, shared by quant_matmul.cu (one product) and
// quant_matmul_batched.cu (one product per head: W_uv's column slices).
//
//   out (M, N) = x (M, K) @ (q (K, N) * scale (N,)), accumulated in fp32;
// q int8 (K, N) for 8 bits, or nibble-packed (ceil(K/2), N) with row 2i in
// the low nibble and row 2i+1 in the high one, each sign-extended.
//
// Bound by bytes: each weight byte feeds 2 M (int8) or 4 M (int4) flops.
// A thread owns 16 columns and loads a stored row's 16 bytes (int8: 16
// values; int4: 32 values of two rows) as one 16-byte vector, dequantizes
// in registers and FMAs into 4 x 16 accumulators on the CUDA cores (at
// M <= 4 the tensor cores would idle on zero rows).  256 threads = 4
// column lanes (64 contiguous bytes of a row per 4 threads) x 64 K lanes;
// the K lanes are reduced by warp shuffles and shared memory.  Four rows'
// loads are issued before their FMAs.  Narrow N would leave most SMs
// idle, so the launcher also splits K across blocks; each split stores its
// partial sums, and the last split to finish a column tile (an int counter
// per tile) adds them in split order and writes the output: one launch, no
// float atomics, results that do not vary from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace qskinny {

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

// One product's operands, or one head's: blockIdx.z selects head h, whose
// x, w (bytes, and scale entries) and out start h hx, h hw and h ho
// elements in; ldx, ldw and ldo are the row strides.
struct Strides {
  int ldx, ldw, ldo;
  size_t hx, hw, ho;
};

// The 16 bytes of stored row r at columns [col0, col0 + 16); columns past
// N read as 0.  VEC: the chunk's address is 16-byte aligned and N % 16 ==
// 0, so a chunk is wholly inside or wholly outside the row.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ w, int r,
                                        int col0, int N, int ldw) {
  const size_t off = (size_t)r * ldw + col0;
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
// (MR rows held; rows past M read 0)
template <int BITS, int MR, class T>
__device__ __forceinline__ void accumulate(float (&acc)[MR][kVec],
                                           const uint4 wv,
                                           const T* __restrict__ x, int r,
                                           int M, int K, int ldx) {
  const uint32_t word[4] = {wv.x, wv.y, wv.z, wv.w};
  if (BITS == 8) {
    float xv[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      xv[m] = m < M ? ld(x + (size_t)m * ldx + r) : 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float q = s8((word[j / 4] >> (8 * (j % 4))) & 0xffu);
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m][j] = fmaf(xv[m], q, acc[m][j]);
    }
  } else {
    const int k0 = 2 * r, k1 = 2 * r + 1;
    float xl[MR], xh[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      xl[m] = m < M ? ld(x + (size_t)m * ldx + k0) : 0.f;
      xh[m] = (m < M && k1 < K) ? ld(x + (size_t)m * ldx + k1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t b = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
      const float ql = lo4(b), qh = hi4(b);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        acc[m][j] = fmaf(xl[m], ql, acc[m][j]);
        acc[m][j] = fmaf(xh[m], qh, acc[m][j]);
      }
    }
  }
}

// Reduces a lane's V sums over the warp's K lanes (lane bits BIT down to
// LOWEST) by a reduce-scatter: each level keeps the half of the lane's N
// values its bit selects and adds the partner's copy of that half (past
// one value a level adds the partner's whole value); base gains the
// offset of the values the lane keeps.
template <int V, int N, int BIT, int LOWEST>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane,
                                               int& base) {
  if constexpr (BIT >= LOWEST) {
    if constexpr (N >= 2) {
      constexpr int H = N / 2;
      const bool hi = lane & BIT;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? v[i] : v[i + H];
        const float keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
      }
      if (hi) base += H;
      reduce_scatter<V, H, BIT / 2, LOWEST>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], BIT);
      reduce_scatter<V, N, BIT / 2, LOWEST>(v, lane, base);
    }
  }
}

// grid (ceil(N / (LN kVec)), splits, heads), kThreads threads; M <= MR rows
// of x held; LN column lanes of kVec columns each (kLanesN, or 1: a block
// of 16 columns whose 256 threads all walk K).  Split s walks stored rows
// [s * rows_per_split, min(rows, (s + 1) * rows_per_split)).  With part ==
// nullptr (one split) it writes out * scale; else raw sums to part (heads,
// splits, M, N), and the last split of each column tile (counters: one
// zeroed int per (head, tile), left zeroed) writes out.  A warp's K lanes
// are reduced by an all-reduce of their 3 MR kVec sums (LN = kLanesN), or
// by a reduce-scatter over all 32 lanes (LN = 1: about MR kVec shuffles
// a thread, each lane left with one or two sums).
template <int BITS, bool VEC, class T, int MR = kSkinnyM, int LN = kLanesN>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int M,
              int K, int N, int rows, int rows_per_split, Strides sd) {
  static_assert(LN == kLanesN || LN == 1, "column lanes");
  constexpr int LK = kThreads / LN, BN = LN * kVec;   // K lanes, columns
  __shared__ float red[kWarps][LN][MR][kVec];
  const int h = blockIdx.z;
  x += h * sd.hx;
  w += h * sd.hw;
  scale += h * sd.hw;
  out += h * sd.ho;
  const int lane_n = threadIdx.x % LN;
  const int lane_k = threadIdx.x / LN;
  const int col0 = blockIdx.x * BN + lane_n * kVec;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);

  float acc[MR][kVec];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

  for (int r0 = r_begin + lane_k; r0 < r_end; r0 += kUnroll * LK) {
    uint4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * LK;
      wv[u] = r < r_end ? load16<VEC>(w, r, col0, N, sd.ldw)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * LK;
      if (r < r_end) accumulate<BITS, MR>(acc, wv[u], x, r, M, K, sd.ldx);
    }
  }

  // Reduce the K lanes: a warp's by shuffles, then the kWarps warps
  // through shared memory.
  const int warp = threadIdx.x / 32;
  if constexpr (LN == 1) {
    constexpr int V = MR * kVec;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = acc[i / kVec][i % kVec];
    const int lane = threadIdx.x & 31;
    int base = 0;
    reduce_scatter<V, V, 16, 1>(v, lane, base);
    constexpr int NF = V >= 64 ? V / 32 : 1;   // sums a lane keeps
#pragma unroll
    for (int i = 0; i < NF; ++i) (&red[warp][0][0][0])[base + i] = v[i];
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = acc[m][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[m][j] = v;
      }
    if ((threadIdx.x & 31) < kLanesN) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < kVec; ++j) red[warp][lane_n][m][j] = acc[m][j];
    }
  }
  __syncthreads();
  // one output (m, c) of the block's MR x BN per thread
  static_assert(kSkinnyM * kBlockN == kThreads, "one output per thread");
  const int m = threadIdx.x / BN, c = threadIdx.x % BN;
  const int col = blockIdx.x * BN + c;
  const bool mine = m < M && m < MR && col < N;
  float s = 0.f;
  if (m < MR) {
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][c / kVec][m][c % kVec];
  }
  if (part == nullptr) {
    if (mine) out[(size_t)m * sd.ldo + col] = from_f32<T>(s * scale[col]);
    return;
  }
  // K split: store this split's sums; the last split of the column tile
  // adds every split's in split order.
  const size_t mn = (size_t)M * N;
  part += (size_t)h * gridDim.y * mn;
  counters += (size_t)h * gridDim.x;
  if (mine) part[blockIdx.y * mn + (size_t)m * N + col] = s;
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (threadIdx.x == 0)
    is_last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (mine) {   // 8 splits' loads in flight at a time, summed in order
    const float* p = part + (size_t)m * N + col;
    const int splits = gridDim.y;
    float v = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        u[i] = s0 + i < splits ? __ldcg(p + (s0 + i) * mn) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) v += u[i];
    }
    out[(size_t)m * sd.ldo + col] = from_f32<T>(v * scale[col]);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// Launches skinny_kernel on grid (ceil(N / (LN kVec)), splits, heads);
// vec: every head's chunks are 16-byte aligned (see load16).
template <int BITS, class T, int MR = kSkinnyM, int LN = kLanesN>
int launch_skinny(const T* x, const uint8_t* w, const float* scale, T* out,
                  float* part, int* counters, int M, int K, int N, int heads,
                  int splits, int per_split, bool vec, Strides sd,
                  cudaStream_t stream) {
  if (M > MR || splits < 1 || per_split <= 0 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rows = BITS == 8 ? K : (K + 1) / 2;
  const dim3 grid((N + LN * kVec - 1) / (LN * kVec), splits, heads);
  float* dst = splits > 1 ? part : nullptr;
  if (vec)
    skinny_kernel<BITS, true, T, MR, LN><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, counters, M, K, N, rows, per_split, sd);
  else
    skinny_kernel<BITS, false, T, MR, LN><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, counters, M, K, N, rows, per_split, sd);
  return (int)cudaGetLastError();
}

}  // namespace qskinny
