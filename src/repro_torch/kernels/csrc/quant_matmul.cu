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
//    or 4 * M (int4), far below any balance point, so the least time is
//    the quantized weight read once at 3.35 TB/s (0.3 us for 1 MB).  A
//    call of a few microseconds is launch- and host-bound: the design
//    makes it one launch.
//  * Prefill (M = 128): operations.  On fp32 x the fastest fp32-input
//    rate is TF32's 495 TFLOP/s (2 M K N flops); the kernel spends three
//    bf16 tensor-core passes (989 TFLOP/s each) to keep fp32's accuracy.
//    At N = 1024 the output is only 2 x 16 tiles of 64 x 64 for 132 SMs.
//
// What the design does about it:
//  * skinny_kernel (M <= kSkinnyM): one M tile, so every weight byte is
//    read from device memory once per launch.  A thread owns 16 columns
//    and loads a row's 16 bytes (int8: 16 values; int4: 32 values of two
//    rows) as one 16-byte vector, dequantizes in registers and FMAs into
//    4 x 16 accumulators on the CUDA cores (at M <= 4 the tensor cores
//    would idle on zero rows).  256 threads = 4 column lanes (64
//    contiguous bytes of a row per 4 threads) x 64 K lanes; the K lanes
//    are reduced by warp shuffles and shared memory.  Four rows' loads are
//    issued before their FMAs.  Narrow N (1024 columns = 16 blocks) would
//    leave most SMs idle, so the launcher also splits K across blocks;
//    each split stores its partial sums, and the last split to finish a
//    column tile (an int counter per tile) adds them in split order and
//    writes the output: one launch, no float atomics, results that do not
//    vary from run to run.
//  * M > kSkinnyM: mm_tiles.cuh's tensor-core tile body, shared with
//    streamed_matmul.cu, over an int8 or int4 weight loader.  Each int8 /
//    int4 value is exact in bf16 and fp16, so a weight fragment is
//    converted in registers from the stored bytes as it is read (on the
//    integer / fp32 ALUs: one byte_perm and one add per value, one 2- or
//    4-byte shared-memory read serving 2 or 4 n8 tiles); fp32 x runs as
//    three bf16 passes, x = hi + mid + lo exactly, split once per stage
//    into shared planes, which gives the FMA loop's products exactly (only
//    the fp32 sums' order differs); fp16 / bf16 x run one pass in their
//    type.  The scale multiplies the
//    fp32 accumulator in the epilogue.  The caller's or the autotuned
//    (block_m, block_n, block_k) give the block's output region, its
//    tile (64 or 128 per edge) and the K rows per stage (16, 32 or 64), as
//    for streamed_matmul.cu; 64 x 64 with 64-row stages when neither is
//    given.  The launcher splits K (whole stages, in split order, as
//    above) whenever the output's blocks would leave the SMs under-filled:
//    (128, 4096, 1024) runs 32 regions x 5 splits.
//
// A batched entry (repro_quant_matmul_batched) runs H heads' products in one
// launch, the MLA decode's absorbed products: head h multiplies x[:, h, :]
// (M, K) by a K x N slice of one quantized weight, either the columns
// [h N, (h + 1) N) of q (K, ld) with their scales (W_uv's un-absorption), or
// the transpose of the columns [h K, (h + 1) K) of q (N, ld), whose scales
// then lie along K and are folded into x as it is staged (W_uk's
// absorption, whose int4 packing runs along N).  Bound by bytes (M is the
// decode batch): each block stages its head's 64 x 64 weight tile once per
// 4 rows of x, dequantized into fp32 in shared memory through coalesced
// reads in the weight's own row order, and each thread sums one output on
// the CUDA cores.  Simple and exact rather than fast: the decode rounds
// that call it are bound by the host.
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
// part (splits, M, N), and the last split of each column tile (counters:
// one zeroed int per tile, left zeroed) writes out.
template <int BITS, bool VEC, class T>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int M,
              int K, int N, int rows, int rows_per_split) {
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
  const bool mine = m < M && col < N;
  float s = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) s += red[wi][c / kVec][m][c % kVec];
  if (part == nullptr) {
    if (mine) out[(size_t)m * N + col] = from_f32<T>(s * scale[col]);
    return;
  }
  // K split: store this split's sums; the last split of the column tile
  // adds every split's in split order.
  const size_t mn = (size_t)M * N;
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
    out[(size_t)m * N + col] = from_f32<T>(v * scale[col]);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// The weight loaders of mm_tiles.cuh's tile body: the stored bytes are
// staged as they are; B fragments convert them in registers (each value
// exact in bf16 / fp16; the scale is applied to the accumulator).  Both
// are grouped (mm::Tile::col): one 2- or 4-byte read of a stage row
// serves 2 or 4 n8 tiles.
struct Int8B {
  using Raw = int8_t;
  static constexpr int kPack = 1;
  static constexpr int kPad = 16;
  static constexpr bool kGrouped = true;
  const int8_t* w;
  // tile j of group h: rows kk + 2t, kk + 2t + 1 (b[.][0]) and
  // kk + 2t + 8, + 9 (b[.][1]); q + 128 is the byte with its top bit
  // flipped
  template <class Op, int NT, int G>
  __device__ __forceinline__ static void frags(const int8_t* ws, int ld,
                                               int kk, int col0, int g,
                                               int t, uint32_t (&b)[NT][2]) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(ws) +
                       (kk + 2 * t) * ld + col0 + G * g;
#pragma unroll
    for (int h = 0; h < NT / G; ++h) {
      const uint8_t* p = s + 8 * G * h;
      const uint32_t w0 = mm::ld_bytes<G>(p) ^ 0x80808080u;
      const uint32_t w1 = mm::ld_bytes<G>(p + ld) ^ 0x80808080u;
      const uint32_t w8 = mm::ld_bytes<G>(p + 8 * ld) ^ 0x80808080u;
      const uint32_t w9 = mm::ld_bytes<G>(p + 9 * ld) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        b[G * h + j][0] = mm::pack_bytes<128>(Op{}, w0, w1, j);
        b[G * h + j][1] = mm::pack_bytes<128>(Op{}, w8, w9, j);
      }
    }
  }
};

// Rows 2i (low nibble) and 2i + 1 (high) in byte row i: the MMA's pair of
// rows (2t, 2t + 1) is one byte; q + 8 is a nibble with its top bit
// flipped.
struct Int4B {
  using Raw = uint8_t;
  static constexpr int kPack = 2;
  static constexpr int kPad = 32;
  static constexpr bool kGrouped = true;
  const uint8_t* w;
  template <class Op, int NT, int G>
  __device__ __forceinline__ static void frags(const uint8_t* ws, int ld,
                                               int kk, int col0, int g,
                                               int t, uint32_t (&b)[NT][2]) {
    const uint8_t* s = ws + (kk / 2 + t) * ld + col0 + G * g;
#pragma unroll
    for (int h = 0; h < NT / G; ++h) {
      const uint8_t* p = s + 8 * G * h;
      const uint32_t w0 = mm::ld_bytes<G>(p) ^ 0x88888888u;
      const uint32_t w4 = mm::ld_bytes<G>(p + 4 * ld) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const uint32_t x0 = w0 >> (8 * j), x4 = w4 >> (8 * j);
        b[G * h + j][0] =
            mm::pack_biased<8>(Op{}, x0 & 0xfu, (x0 >> 4) & 0xfu);
        b[G * h + j][1] =
            mm::pack_biased<8>(Op{}, x4 & 0xfu, (x4 >> 4) & 0xfu);
      }
    }
  }
};

template <int BITS, class T>
int launch(const T* x, const uint8_t* w, const float* scale, T* out,
           float* part, int* counters, int M, int K, int N, int splits,
           int per_split, bool vec, int rm, int rn, int bm, int bn, int kc,
           cudaStream_t stream) {
  if (M > kSkinnyM) {
    if (BITS == 8)
      return mm::launch(rm, rn, bm, bn, kc, x,
                        Int8B{reinterpret_cast<const int8_t*>(w)}, scale,
                        out, part, counters, splits, per_split, M, K, N,
                        stream);
    return mm::launch(rm, rn, bm, bn, kc, x, Int4B{w}, scale, out, part,
                      counters, splits, per_split, M, K, N, stream);
  }
  if (splits < 1 || per_split <= 0 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rows = BITS == 8 ? K : (K + 1) / 2;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits);
  float* dst = splits > 1 ? part : nullptr;
  if (vec)
    skinny_kernel<BITS, true, T><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, counters, M, K, N, rows, per_split);
  else
    skinny_kernel<BITS, false, T><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, dst, counters, M, K, N, rows, per_split);
  return (int)cudaGetLastError();
}

// ---- batched heads ----------------------------------------------------------
constexpr int kBatM = 4, kBatN = 64, kBatK = 64;
constexpr int kBatThreads = kBatM * kBatN;       // one output per thread

// grid (ceil(N / kBatN), H, ceil(M / kBatM)).  x (M, H, K), out (M, H, N).
// TRANS 0: W_h[k, n] = q[k, h N + n] * scale[h N + n], q (K rows, ldw);
// TRANS 1: W_h[k, n] = q[n, h K + k] * scale[h K + k], q (N rows, ldw);
// for 4 bits the stored rows are packed in pairs (row 2i low nibble).
template <int BITS, int TRANS, class T>
__global__ void __launch_bounds__(kBatThreads)
batched_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, T* __restrict__ out, int M,
               int H, int K, int N, int ldw) {
  __shared__ float xs[kBatM][kBatK];
  __shared__ float ws[kBatK][kBatN + 1];
  const int n0 = blockIdx.x * kBatN, h = blockIdx.y, m0 = blockIdx.z * kBatM;
  const int t = threadIdx.x;
  const int mm = t / kBatN, nn = t - mm * kBatN;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBatK) {
    {   // x rows m0.., columns k0.., with W_uk's scales folded in
      const int m = m0 + t / kBatK, k = k0 + t % kBatK;
      float v = 0.f;
      if (m < M && k < K) {
        v = ld(x + ((size_t)m * H + h) * K + k);
        if (TRANS) v *= scale[(size_t)h * K + k];
      }
      xs[t / kBatK][t % kBatK] = v;
    }
    for (int i = t; i < kBatK * kBatN; i += kBatThreads) {
      // walk the stored rows' contiguous axis: n without TRANS, k with it
      const int a = i / (TRANS ? kBatK : kBatN);
      const int c = i - a * (TRANS ? kBatK : kBatN);
      const int kk = TRANS ? c : a, nc = TRANS ? a : c;
      const int k = k0 + kk, n = n0 + nc;
      float v = 0.f;
      if (k < K && n < N) {
        const int r = TRANS ? n : k;                       // stored row
        const size_t col = TRANS ? (size_t)h * K + k : (size_t)h * N + n;
        if (BITS == 8) {
          v = (float)reinterpret_cast<const int8_t*>(w)[(size_t)r * ldw + col];
        } else {
          const uint32_t byte = w[(size_t)(r >> 1) * ldw + col];
          v = (r & 1) ? hi4(byte) : lo4(byte);
        }
      }
      ws[kk][nc] = v;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kBatK; ++kk) acc = fmaf(xs[mm][kk], ws[kk][nn], acc);
    __syncthreads();
  }
  const int m = m0 + mm, n = n0 + nn;
  if (m < M && n < N) {
    const float s = TRANS ? 1.f : scale[(size_t)h * N + n];
    out[((size_t)m * H + h) * N + n] = from_f32<T>(acc * s);
  }
}

template <int BITS, class T>
int launch_batched(const T* x, const uint8_t* w, const float* scale, T* out,
                   int M, int H, int K, int N, int ldw, int trans,
                   cudaStream_t st) {
  const dim3 grid((N + kBatN - 1) / kBatN, H, (M + kBatM - 1) / kBatM);
  if (trans)
    batched_kernel<BITS, 1, T><<<grid, kBatThreads, 0, st>>>(x, w, scale, out,
                                                             M, H, K, N, ldw);
  else
    batched_kernel<BITS, 0, T><<<grid, kBatThreads, 0, st>>>(x, w, scale, out,
                                                             M, H, K, N, ldw);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, H, K) and out (M, H, N) of the storage type `dtype`; w int8 (bits 8)
// or nibble-packed uint8 (bits 4) with row stride ldw: without trans, (K or
// ceil(K/2)) x ldw with head h's columns [h N, (h + 1) N) and scale (H N,);
// with trans, (N or ceil(N/2)) x ldw with head h's columns [h K, (h + 1) K)
// and scale (H K,) along K.  All contiguous, M, H, K, N > 0.  One launch;
// returns its CUDA error (0 = none).
extern "C" int repro_quant_matmul_batched(const void* x, const uint8_t* w,
                                          const float* scale, void* out,
                                          int M, int H, int K, int N, int ldw,
                                          int bits, int trans, int dtype,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bits != 8 && bits != 4) || M <= 0 || H <= 0 || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (bits == 8)
      return launch_batched<8>(xt, w, scale, ot, M, H, K, N, ldw, trans, st);
    return launch_batched<4>(xt, w, scale, ot, M, H, K, N, ldw, trans, st);
  });
}

// x (M, K) and out (M, N) of the storage type `dtype` (elem::DType); w:
// int8 (K, N) for bits 8, uint8 (ceil(K/2), N) for bits 4; scale (N,) f32;
// all contiguous, M, N, K > 0.  splits (>= 1) K splits of per_split rows
// each; part (splits, M, N) f32 and counters (one zeroed int per column
// tile or output region, left zeroed) when splits > 1, else unused.  For
// M <= 4, per_split counts stored rows; vec: N % 16 == 0 and w 16-byte
// aligned.  For M > 4, per_split counts logical K rows, a multiple of
// 2 * kc; blocks own rm x rn output regions, walked in the bm x bn tile,
// (bm, bn) in {64, 128}^2, with 2 * kc K rows per stage, kc in {8, 16,
// 32}.  One launch; returns its CUDA error (0 = none).
extern "C" int repro_quant_matmul(const void* x, const uint8_t* w,
                                  const float* scale, void* out, float* part,
                                  int* counters, int M, int K, int N,
                                  int bits, int splits, int per_split,
                                  int vec, int rm, int rn, int bm, int bn,
                                  int kc, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (bits == 8)
      return launch<8>(xt, w, scale, ot, part, counters, M, K, N, splits,
                       per_split, vec != 0, rm, rn, bm, bn, kc, st);
    return launch<4>(xt, w, scale, ot, part, counters, M, K, N, splits,
                     per_split, vec != 0, rm, rn, bm, bn, kc, st);
  });
}
