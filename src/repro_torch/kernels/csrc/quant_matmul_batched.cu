// H heads' dequantizing products in one launch: MLA's absorbed decode
// products (quant_matmul.cu's batched entry; the same int8 / int4 layouts).
// Head h multiplies x[:, h, :] (M, K) by a K x N slice of one quantized
// weight:
//  * trans 0 (W_uv's un-absorption): the columns [h N, (h + 1) N) of q
//    (K or ceil(K/2) stored rows, row stride ldw) with their scales;
//  * trans 1 (W_uk's absorption): the transpose of the columns [h K, (h +
//    1) K) of q (N or ceil(N/2) stored rows, int4 packed along N), whose
//    scales then lie along K and are folded into x.
//
// Replaces, with quant_matmul.cu, the Pallas TPU kernel
// src/repro/kernels/streamed_matmul.py :: quantized_matmul; the reference's
// mla_decode multiplies its dequantized w_uk / w_uv per head (jnp einsum).
//
// What bounds it on the H100: bytes.  M is the decode batch (2 at the
// serving path's shape), so each weight byte feeds 2 M (int8) or 4 M
// (int4) flops; at minicpm3_4b's widths (40 heads, latent 256, head 64) a
// call reads 655 KB of int8 weight (0.2 us at 3.35 TB/s) and is a few
// microseconds of latency: the design fills the SMs and reads every byte
// once, as a 16-byte vector.
//
// What the design does about it:
//  * trans 0, M <= 4: quant_skinny.cuh's skinny_kernel with the heads on
//    the grid's z axis and the weight's row stride: 16-byte loads of the
//    stored rows, int4 nibbles unpacked by row pair, dequantization in
//    registers, the M rows in registers (M rounded up to 1, 2 or 4).  A
//    block takes 16 columns of a head (one 16-byte vector a row), so 40
//    heads of N 64 are 160 blocks, and all its 256 threads split K, their
//    sums met by a reduce-scatter over each warp's 32 lanes and then
//    across the warps, in a fixed order.  Where the heads' column tiles
//    still leave the SMs under-filled, K is split across blocks as well
//    (the host's kernels/quant_matmul.py::head_k_splits), the splits'
//    partial sums added in split order by the last split of each (head,
//    column tile): the same bits on every call.
//  * trans 1, M <= 4: trans_kernel.  Each output n is the dot product of a
//    stored row's K bytes (int4: two outputs per row, one per nibble) with
//    x_h times the scales.  A block stages its head's x * scale (M x K
//    fp32) in shared memory, four lanes take one stored row and read it as
//    16-byte vectors (the first issued before the staging), and the four
//    lanes' sums meet by warp shuffles: 32 stored rows per block of 128
//    threads, 8 (int4: 4) blocks per head at N 256.
//  * M > 4 (and trans 1 with K past kTransMaxK): batched_kernel, an exact
//    tile route: each block stages its head's 64 x 64 weight tile once per
//    4 rows of x, dequantized into fp32 shared memory, and each thread sums
//    one output on the CUDA cores.
#include "quant_skinny.cuh"

namespace {

using namespace elem;
using qskinny::hi4;
using qskinny::kSkinnyM;
using qskinny::lo4;
using qskinny::s8;

// ---- trans 1, M <= 4 -------------------------------------------------------
constexpr int kTransThreads = 128;
constexpr int kTransLanes = 4;                          // lanes per stored row
constexpr int kTransRows = kTransThreads / kTransLanes;   // launcher: TRANS_ROWS
constexpr int kTransMaxK = 2048;        // x * scale: kSkinnyM x K fp32 in smem

// 16 bytes of stored row wr from byte k0; bytes past K read 0.  VEC: the
// chunk is 16-byte aligned and K % 16 == 0.
template <bool VEC>
__device__ __forceinline__ uint4 load_row16(const uint8_t* __restrict__ wr,
                                            int k0, int K) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(wr + k0));
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k0 + j < K) word[j / 4] |= (uint32_t)__ldg(wr + k0 + j) << (8 * (j % 4));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// grid (ceil(stored rows / kTransRows), H), kTransThreads threads, 16 K
// bytes of dynamic shared memory.  x (M, H, K), out (M, H, N); stored row
// r of head h is q[r, h K .. h K + K): output n = r (8 bits), or n = 2 r
// (low nibbles) and 2 r + 1 (high).
template <int BITS, bool VEC, class T>
__global__ void __launch_bounds__(kTransThreads)
trans_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ scale, T* __restrict__ out, int M,
             int H, int K, int N, int ldw) {
  extern __shared__ float xs[];   // [kSkinnyM][K]: x[m, h, k] scale[h K + k]
  constexpr int NO = BITS == 8 ? 1 : 2;             // outputs per stored row
  const int h = blockIdx.y;
  const int sub = threadIdx.x % kTransLanes;
  const int r = blockIdx.x * kTransRows + threadIdx.x / kTransLanes;
  const int rows = BITS == 8 ? N : (N + 1) / 2;
  const bool live = r < rows;
  const uint8_t* wr = w + (size_t)(live ? r : 0) * ldw + (size_t)h * K;
  // the row's first chunk in flight while x is staged
  uint4 wv = live && 16 * sub < K ? load_row16<VEC>(wr, 16 * sub, K)
                                  : make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kSkinnyM * K; i += kTransThreads) {
    const int m = i / K, k = i - m * K;
    xs[i] = m < M ? ld(x + ((size_t)m * H + h) * K + k) *
                        scale[(size_t)h * K + k]
                  : 0.f;
  }
  __syncthreads();
  float acc[NO][kSkinnyM];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m) acc[o][m] = 0.f;
  for (int k0 = 16 * sub; live && k0 < K; k0 += 16 * kTransLanes) {
    if (k0 != 16 * sub) wv = load_row16<VEC>(wr, k0, K);
    const uint32_t word[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (!VEC && k0 + j >= K) break;
      const uint32_t b = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
      const float* xk = xs + k0 + j;
      if (BITS == 8) {
        const float q = s8(b);
#pragma unroll
        for (int m = 0; m < kSkinnyM; ++m)
          acc[0][m] = fmaf(xk[m * K], q, acc[0][m]);
      } else {
        const float ql = lo4(b), qh = hi4(b);
#pragma unroll
        for (int m = 0; m < kSkinnyM; ++m) {
          acc[0][m] = fmaf(xk[m * K], ql, acc[0][m]);
          acc[NO - 1][m] = fmaf(xk[m * K], qh, acc[NO - 1][m]);
        }
      }
    }
  }
  // the row's four lanes (adjacent in the warp) meet
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m) {
      float v = acc[o][m];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[o][m] = v;
    }
  if (sub != 0 || !live) return;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int n = NO * r + o;
    if (n >= N) continue;
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
      if (m < M) out[((size_t)m * H + h) * N + n] = from_f32<T>(acc[o][m]);
  }
}

// ---- M > 4: the exact tile route ------------------------------------------
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
int launch(const T* x, const uint8_t* w, const float* scale, T* out,
           float* part, int* counters, int M, int H, int K, int N, int ldw,
           int trans, int splits, int per_split, bool vec, cudaStream_t st) {
  if (M <= kSkinnyM && !trans) {   // rows held: M rounded up to 1, 2, 4
    const qskinny::Strides sd{H * K, ldw, H * N, (size_t)K, (size_t)N,
                              (size_t)N};
    if (M == 1)
      return qskinny::launch_skinny<BITS, T, 1, 1>(
          x, w, scale, out, part, counters, M, K, N, H, splits, per_split,
          vec, sd, st);
    if (M == 2)
      return qskinny::launch_skinny<BITS, T, 2, 1>(
          x, w, scale, out, part, counters, M, K, N, H, splits, per_split,
          vec, sd, st);
    return qskinny::launch_skinny<BITS, T, kSkinnyM, 1>(
        x, w, scale, out, part, counters, M, K, N, H, splits, per_split, vec,
        sd, st);
  }
  if (M <= kSkinnyM && K <= kTransMaxK) {
    const int rows = BITS == 8 ? N : (N + 1) / 2;
    const dim3 grid((rows + kTransRows - 1) / kTransRows, H);
    const size_t smem = sizeof(float) * kSkinnyM * K;
    if (vec)
      trans_kernel<BITS, true, T><<<grid, kTransThreads, smem, st>>>(
          x, w, scale, out, M, H, K, N, ldw);
    else
      trans_kernel<BITS, false, T><<<grid, kTransThreads, smem, st>>>(
          x, w, scale, out, M, H, K, N, ldw);
    return (int)cudaGetLastError();
  }
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
// and scale (H K,) along K.  All contiguous, M, H, K, N > 0.  Without
// trans and M <= 4: splits (>= 1) K splits of per_split stored rows, part
// (H, splits, M, N) f32 and counters (one zeroed int per head and column
// tile of 64, left zeroed) when splits > 1; vec: N % 16 == 0, ldw % 16 ==
// 0 and w 16-byte aligned.  With trans and M <= 4: vec: K % 16 == 0, ldw %
// 16 == 0 and w 16-byte aligned.  One launch; returns its CUDA error (0 =
// none).
extern "C" int repro_quant_matmul_batched(const void* x, const uint8_t* w,
                                          const float* scale, void* out,
                                          float* part, int* counters, int M,
                                          int H, int K, int N, int ldw,
                                          int bits, int trans, int splits,
                                          int per_split, int vec, int dtype,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bits != 8 && bits != 4) || M <= 0 || H <= 0 || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (bits == 8)
      return launch<8>(xt, w, scale, ot, part, counters, M, H, K, N, ldw,
                       trans, splits, per_split, vec != 0, st);
    return launch<4>(xt, w, scale, ot, part, counters, M, H, K, N, ldw,
                     trans, splits, per_split, vec != 0, st);
  });
}
