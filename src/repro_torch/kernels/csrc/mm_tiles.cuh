// Tensor-core tile body shared by streamed_matmul.cu (dense weights) and
// quant_matmul.cu's tiled path (int8 / int4 weights):
//   out (M, N) = x (M, K) @ w (K, N) [* col_scale (N,)], fp32 accumulation.
//
// x and out are fp32, fp16 or bf16 (T); the weight is read through a
// Loader (dense T, int8, or int4 packed two rows to a byte) that names its
// stored element and turns a stage of it into the MMA's B fragments.
//
// Arithmetic: mma.sync on the tensor cores, fp32 accumulators in
// registers, and a split of fp32 operands so that fp32 inputs keep fp32
// accuracy (the plain version is an fp32 matmul; the limit is 1e-4 of the
// output's scale):
//  * fp32 x against an int8 / int4 weight: m16n8k16 bf16.  Every weight
//    value (|q| <= 128) is exact in bf16.  x = hi + mid + lo, three bf16
//    values taken by truncation (hi: x's top 16 bits; mid: those of
//    x - hi; lo: x - hi - mid, which has at most 8 significant bits), is
//    exact for |x| >= 2^-110 (the remainders stay normal; below, the error
//    is under 2^-133), so the three passes give the exact products and
//    only the order of the fp32 sums differs from an FMA loop.
//  * fp32 x against an fp32 weight: 3xTF32, m16n8k8.  a = ah + al with
//    ah = a without its low 13 mantissa bits and al the same of a - ah
//    (likewise b); acc += ah bh + ah bl + al bh.  Per product the dropped
//    al bl is below 2^-20 |ab| and each truncated remainder below
//    2^-21 |a| or |b|: under 2^-19 ~ 2e-6 of |ab|, summed in fp32.  The
//    tensor cores' fp32 accumulation adds its own rounding: at (256, 1024,
//    4096) the whole error is ~1e-5 of the output's scale on the H100,
//    against the 1e-4 limit.
//  * fp16 / bf16 x: one m16n8k16 pass in x's type (a 16-bit weight and
//    any int8 / int4 value are exact there).
//  The output is rounded to T once, from the fp32 accumulator.
//
// What bounds it on the H100: operations at the main paths' prefill and
// autotune shapes (M = 128 or 256 rows, K and N 1024-4096); the tensor
// cores' peak is 989 TFLOP/s for bf16 / fp16 and 495 for TF32, and the
// fp32 splits spend three passes.  This body issues mma.sync (not wgmma)
// from fragments read out of shared memory by ordinary loads and
// converted in registers; on the card it runs far below that peak (one
// bf16 pass at (256, 1024, 4096) ~90 TFLOP/s, PERF.md section 6).  wgmma
// with TMA-fed stages is the next step.
//
// Tiling (the launcher's cta_tile, kernels/streamed_matmul.py):
//  * A block of kThreads = 256 threads (8 warps) owns an RM x RN region of
//    the output and walks it in BM x BN tiles, (BM, BN) in {64, 128}^2.
//    The warps form a (BM / 32) x (8 / (BM / 32)) grid; each owns 32 rows
//    (two m16 tiles) and BN / that many columns (n8 tiles).
//  * K is walked in stages of KS = 2 * KC logical rows (KC = 8, 16 or 32,
//    the launcher's band of block_k, compiled in).  A ring of kStages = 3
//    shared-memory stages is filled by cp.async (16-byte chunks, zero-
//    filled past an edge) while the previous stage computes: one
//    cp.async.wait_group + __syncthreads per stage, no synchronous
//    staging.  Each stage holds the x tile (BM x KS of T) and the stored
//    weight tile as they are in device memory (rows padded so the MMA
//    fragment reads do not collide in a shared-memory bank).  fp32 x
//    against an integer weight is split once per landed stage into three
//    bf16 planes that every warp reads (one more __syncthreads), so the
//    split is not repeated by each of the block's column warps; the
//    dequantization and the TF32 split happen in registers as fragments
//    are read.  At most 3 x 70,656 B = 211,968 B (fp32 x and weight,
//    128 x 128, KS 64), dynamic shared memory.
//  * Rows whose byte stride is not a multiple of 16, or an unaligned base,
//    take a predicated element copy into the same stage layout (e.g.
//    K = 66 fp32, N = 33 int8).  Rows, columns and K rows past an edge are
//    0 and are not stored; an odd K's int4 padding nibble meets x = 0.
//
// K split (split-K): grid.z = splits.  Split s walks logical K rows
// [s * k_per_split, min(K, (s + 1) * k_per_split)), a whole number of
// stages (so an int4 split starts on an even row).  With one split the
// block writes out directly.  Otherwise each block stores its fp32
// partial sums to part (splits, M, N), and the last block to finish a
// region (a per-region counter, atomicAdd on an int) adds the splits'
// partials in split order 0, 1, ... and writes out, then resets the
// counter to 0.  No float atomics: results do not vary from run to run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace mm {

using namespace elem;
using namespace tc;

constexpr int kThreads = 256;
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kMaxSplits = 8;   // launcher: streamed_matmul.MAX_SPLITS

// Two small signed integers q0, q1, given biased as u = q + BIAS in
// [0, 255], as one exact 32-bit MMA operand (q0 in the low half), on the
// integer / fp32 ALUs rather than the slower conversion unit: bf16 from
// the fp32 2^23 + u - (2^23 + BIAS), whose low 16 bits are 0; fp16 from
// the fp16 1024 + u - (1024 + BIAS).
template <int BIAS>
__device__ __forceinline__ uint32_t pack_biased(Bf16, uint32_t u0,
                                                uint32_t u1) {
  constexpr float kOff = 8388608.f + BIAS;
  const float f0 = __uint_as_float(0x4B000000u | u0) - kOff;
  const float f1 = __uint_as_float(0x4B000000u | u1) - kOff;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}
template <int BIAS>
__device__ __forceinline__ uint32_t pack_biased(F16, uint32_t u0,
                                                uint32_t u1) {
  const uint32_t h = 0x64006400u | u0 | (u1 << 16);
  const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                            __half2half2(__ushort_as_half(
                                (unsigned short)(0x6400u + BIAS))));
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The same for byte j of w0 (low half) and of w1, bytes biased by BIAS:
// one byte_perm builds each fp32 / the fp16 pair (j is a constant once
// the caller's loop is unrolled).
template <int BIAS>
__device__ __forceinline__ uint32_t pack_bytes(Bf16, uint32_t w0,
                                               uint32_t w1, int j) {
  constexpr float kOff = 8388608.f + BIAS;
  const float f0 = __uint_as_float(__byte_perm(w0, 0x4B000000u, 0x7540u + j));
  const float f1 = __uint_as_float(__byte_perm(w1, 0x4B000000u, 0x7540u + j));
  return __byte_perm(__float_as_uint(f0 - kOff), __float_as_uint(f1 - kOff),
                     0x7632);
}
template <int BIAS>
__device__ __forceinline__ uint32_t pack_bytes(F16, uint32_t w0,
                                               uint32_t w1, int j) {
  const uint32_t u = __byte_perm(w0, w1, j | ((4 + j) << 8)) & 0x00ff00ffu;
  return pack_biased<BIAS>(F16{}, u & 0xffu, u >> 16);
}

// ---- operand splits ----------------------------------------------------
constexpr uint32_t kBf16Mask = 0xffff0000u;   // a bf16 is an fp32's top half

// x0, x1 -> bf16 pairs with x = hi + mid + lo exactly (|x| >= 2^-110).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  u0 = __float_as_uint(__uint_as_float(u0) - __uint_as_float(u0 & kBf16Mask));
  u1 = __float_as_uint(__uint_as_float(u1) - __uint_as_float(u1 & kBf16Mask));
  mid = __byte_perm(u0, u1, 0x7632);
  u0 = __float_as_uint(__uint_as_float(u0) - __uint_as_float(u0 & kBf16Mask));
  u1 = __float_as_uint(__uint_as_float(u1) - __uint_as_float(u1 & kBf16Mask));
  lo = __byte_perm(u0, u1, 0x7632);
}

// Unsigned integer of E's size: stages copy bits, not values.
template <class E>
using Bits = std::conditional_t<
    sizeof(E) == 4, uint32_t,
    std::conditional_t<sizeof(E) == 2, uint16_t, uint8_t>>;

// dst[r * LD + c] = src[(r0 + r) * ld_src + c0 + c] for the ROWS x COLS
// tile, 0 where r0 + r >= r_end or c0 + c >= c_end.  vec: 16-byte rows
// and base, so a 16-byte chunk is wholly inside or outside (c0, c_end and
// ld_src multiples of the chunk); cp.async.  Else element copies.
template <int ROWS, int COLS, int LD, class E>
__device__ __forceinline__ void load_tile(E* dst, const E* src, int ld_src,
                                          int r0, int r_end, int c0,
                                          int c_end, bool vec) {
  constexpr int CH = 16 / sizeof(E);
  static_assert(COLS % CH == 0 && (LD * sizeof(E)) % 16 == 0, "tile");
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS / CH; i += kThreads) {
      const int r = i / (COLS / CH), c = (i % (COLS / CH)) * CH;
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async16(dst + r * LD + c,
                 ok ? src + (size_t)(r0 + r) * ld_src + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] = (r0 + r < r_end && c0 + c < c_end)
                            ? src[(size_t)(r0 + r) * ld_src + c0 + c]
                            : E(0);
    }
  }
}

// Loaders: Raw (the stored element), kPack (logical K rows per stored
// row), kPad (stage row padding, in Raw elements, for conflict-free
// fragment reads), kGrouped (see Tile::col) and frags, the B fragments of
// a warp's NT n8 tiles at K offset kk of the stage.

// Dense (K, N) weight of type T.
template <class T>
struct DenseB {
  using Raw = T;
  static constexpr int kPack = 1;
  static constexpr int kPad = sizeof(T) == 2 ? 8 : 4;
  static constexpr bool kGrouped = false;
  const T* w;
  // b[j][0]: rows kk + 2t, kk + 2t + 1; b[j][1]: rows kk + 2t + 8, + 9
  // of column col0 + 8 j + g (16-bit T only).
  template <class Op, int NT, int G>
  __device__ __forceinline__ static void frags(const T* ws, int ld, int kk,
                                               int col0, int g, int t,
                                               uint32_t (&b)[NT][2]) {
    const uint16_t* s =
        reinterpret_cast<const uint16_t*>(ws) + (kk + 2 * t) * ld + col0 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = s[8 * j] | (uint32_t)s[ld + 8 * j] << 16;
      b[j][1] = s[8 * ld + 8 * j] | (uint32_t)s[9 * ld + 8 * j] << 16;
    }
  }
};

// G = 2 or 4 consecutive bytes of a shared-memory row as one word (low
// byte first).
template <int G>
__device__ __forceinline__ uint32_t ld_bytes(const uint8_t* p) {
  static_assert(G == 2 || G == 4, "a group is 2 or 4 n8 tiles");
  if constexpr (G == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const uint16_t*>(p);
}

template <int BM, int BN, int KC, class T, class Loader>
struct Tile {
  using Raw = typename Loader::Raw;
  static constexpr bool kTf32 =
      std::is_same<T, float>::value && std::is_same<Raw, float>::value;
  static constexpr bool kSplit3 = std::is_same<T, float>::value && !kTf32;
  using Op = std::conditional_t<
      kTf32, Tf32, std::conditional_t<std::is_same<T, __half>::value, F16,
                                      Bf16>>;
  static constexpr int KS = 2 * KC;                  // logical K per stage
  static constexpr int KSTEP = kTf32 ? 8 : 16;       // MMA depth
  static constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N, MT = 2, NT = WN / 8;
  static constexpr int XLD = KS + 8;                 // x stage row, elements
  static constexpr int WROWS = KS / Loader::kPack;   // stored rows per stage
  static constexpr int WLD = BN + Loader::kPad;
  // A grouped loader's n8 tiles are interleaved by column within groups
  // of G tiles: lane g of tile j reads stored column 8 G (j / G) + G g +
  // j % G of the warp's slice, so one G-byte read serves G tiles; its
  // output column c of tile j is that column's.
  static constexpr int G = Loader::kGrouped ? (NT >= 4 ? 4 : NT) : 1;
  __host__ __device__ static constexpr int col(int j, int c) {
    return 8 * G * (j / G) + G * c + j % G;
  }
  static constexpr int X_BYTES = BM * XLD * (int)sizeof(T);
  static constexpr int STAGE_BYTES = X_BYTES + WROWS * WLD * (int)sizeof(Raw);
  static constexpr int P = kSplit3 ? 3 : 1;          // bf16 parts of x
  // fp32 x against an integer weight: each landed x stage is split once
  // into P bf16 planes (BM x XLD) that every warp reads
  static constexpr int PLANE_BYTES = kSplit3 ? P * BM * XLD * 2 : 0;
  static constexpr int SMEM = kStages * STAGE_BYTES + PLANE_BYTES;
  static_assert(SMEM <= 232448, "stage ring over the opt-in shared memory");
  static_assert(X_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "alignment");
};

// grid (ceil(N / RN), ceil(M / RM), splits), kThreads threads, L::SMEM
// bytes of dynamic shared memory: the block's RM x RN region of
// x @ w [* col_scale] over its K split (see the note at the top).
// col_scale NULL means none; part and counters are used when splits > 1.
template <int BM, int BN, int KC, class T, class Loader>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const T* __restrict__ x, Loader w,
          const float* __restrict__ col_scale, T* __restrict__ out,
          float* __restrict__ part, int* __restrict__ counters, int M, int K,
          int N, int RM, int RN, int k_per_split) {
  using L = Tile<BM, BN, KC, T, Loader>;
  using Raw = typename Loader::Raw;
  using XB = Bits<T>;
  using WB = Bits<Raw>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % L::WARPS_M, wn = warp / L::WARPS_M;
  const int splits = gridDim.z;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int r0 = blockIdx.y * RM, c0 = blockIdx.x * RN;
  const int m_end = min(M, r0 + RM), n_end = min(N, c0 + RN);
  const int w_end = (ke + Loader::kPack - 1) / Loader::kPack;
  const bool vec_x = (K * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = (N * sizeof(Raw)) % 16 == 0 &&
                     (RN * sizeof(Raw)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w.w) % 16 == 0;
  const int nk = (ke - kb + L::KS - 1) / L::KS;      // stages of this split

  for (int m0 = r0; m0 < m_end; m0 += BM) {
    for (int n0 = c0; n0 < n_end; n0 += BN) {
      auto load_stage = [&](int slot, int k0) {
        unsigned char* base = smem + slot * L::STAGE_BYTES;
        load_tile<BM, L::KS, L::XLD>(reinterpret_cast<XB*>(base),
                                     reinterpret_cast<const XB*>(x), K, m0,
                                     m_end, k0, ke, vec_x);
        load_tile<L::WROWS, BN, L::WLD>(
            reinterpret_cast<WB*>(base + L::X_BYTES),
            reinterpret_cast<const WB*>(w.w), N, k0 / Loader::kPack, w_end,
            n0, n_end, vec_w);
      };

      float acc[L::MT][L::NT][4];
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) load_stage(s, kb + s * L::KS);
        cp_async_commit();
      }
      for (int it = 0; it < nk; ++it) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // stage `it` landed; stage it - 1 is free
        const int nxt = it + kStages - 1;
        if (nxt < nk) load_stage(nxt % kStages, kb + nxt * L::KS);
        cp_async_commit();

        const unsigned char* base = smem + (it % kStages) * L::STAGE_BYTES;
        const Raw* ws = reinterpret_cast<const Raw*>(base + L::X_BYTES);
        // A operands as 16-bit pairs: x itself, or its bf16 planes
        const uint16_t* abase = reinterpret_cast<const uint16_t*>(base);
        if constexpr (L::kSplit3) {
          const float* xf = reinterpret_cast<const float*>(base);
          uint32_t* planes =
              reinterpret_cast<uint32_t*>(smem + kStages * L::STAGE_BYTES);
          constexpr int PW = BM * L::XLD / 2;   // 32-bit words per plane
#pragma unroll
          for (int p = tid; p < BM * L::KS / 2; p += kThreads) {
            const int w2 = (p / (L::KS / 2)) * (L::XLD / 2) + p % (L::KS / 2);
            const float2 v = *reinterpret_cast<const float2*>(xf + 2 * w2);
            split3(v.x, v.y, planes[w2], planes[PW + w2], planes[2 * PW + w2]);
          }
          __syncthreads();   // the planes of stage `it` are written
          abase = reinterpret_cast<const uint16_t*>(planes);
        }
#pragma unroll
        for (int kk = 0; kk < L::KS; kk += L::KSTEP) {
          if constexpr (L::kTf32) {
            // k permuted within the step, alike for A and B: slot t is
            // row 2t and slot t + 4 row 2t + 1, so A reads float2s.
            uint32_t ah[L::MT][4], al[L::MT][4];
            uint32_t bh[L::NT][2], bl[L::NT][2];
#pragma unroll
            for (int i = 0; i < L::MT; ++i) {
              const float* p = reinterpret_cast<const float*>(base) +
                               (wm * 32 + i * 16 + g) * L::XLD + kk + 2 * t;
              const float2 v0 = *reinterpret_cast<const float2*>(p);
              const float2 v1 =
                  *reinterpret_cast<const float2*>(p + 8 * L::XLD);
              split_tf32(v0.x, ah[i][0], al[i][0]);
              split_tf32(v1.x, ah[i][1], al[i][1]);
              split_tf32(v0.y, ah[i][2], al[i][2]);
              split_tf32(v1.y, ah[i][3], al[i][3]);
            }
#pragma unroll
            for (int j = 0; j < L::NT; ++j) {
              const float* q = reinterpret_cast<const float*>(ws) +
                               (kk + 2 * t) * L::WLD + wn * L::WN + g + 8 * j;
              split_tf32(q[0], bh[j][0], bl[j][0]);
              split_tf32(q[L::WLD], bh[j][1], bl[j][1]);
            }
            // small products first; a pass over every accumulator between
            // two products into the same one
#pragma unroll
            for (int i = 0; i < L::MT; ++i)
#pragma unroll
              for (int j = 0; j < L::NT; ++j)
                mma(Tf32{}, acc[i][j], al[i], bh[j]);
#pragma unroll
            for (int i = 0; i < L::MT; ++i)
#pragma unroll
              for (int j = 0; j < L::NT; ++j)
                mma(Tf32{}, acc[i][j], ah[i], bl[j]);
#pragma unroll
            for (int i = 0; i < L::MT; ++i)
#pragma unroll
              for (int j = 0; j < L::NT; ++j)
                mma(Tf32{}, acc[i][j], ah[i], bh[j]);
          } else {
            constexpr int P = L::P;
            uint32_t a[P][L::MT][4], b[L::NT][2];
#pragma unroll
            for (int q = 0; q < P; ++q)
#pragma unroll
              for (int i = 0; i < L::MT; ++i) {
                // [0]: (g, kk + 2t..), [1]: (g + 8, ..), [2]: (g,
                // kk + 2t + 8..), [3]: (g + 8, kk + 2t + 8..)
                const uint16_t* p = abase + q * BM * L::XLD +
                                    (wm * 32 + i * 16 + g) * L::XLD + kk +
                                    2 * t;
                a[q][i][0] = *reinterpret_cast<const uint32_t*>(p);
                a[q][i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * L::XLD);
                a[q][i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
                a[q][i][3] =
                    *reinterpret_cast<const uint32_t*>(p + 8 * L::XLD + 8);
              }
            Loader::template frags<typename L::Op, L::NT, L::G>(
                ws, L::WLD, kk, wn * L::WN, g, t, b);
#pragma unroll
            for (int q = P - 1; q >= 0; --q)   // smallest part first
#pragma unroll
              for (int i = 0; i < L::MT; ++i)
#pragma unroll
                for (int j = 0; j < L::NT; ++j)
                  mma(typename L::Op{}, acc[i][j], a[q][i], b[j]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // the ring is free for the region's next tile

#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gm = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
            const int gn = n0 + wn * L::WN + L::col(j, 2 * t + (e & 1));
            if (gm >= m_end || gn >= n_end) continue;
            const float v = acc[i][j][e];
            if (splits == 1)
              out[(size_t)gm * N + gn] =
                  from_f32<T>(col_scale ? v * col_scale[gn] : v);
            else
              part[((size_t)blockIdx.z * M + gm) * N + gn] = v;
          }
    }
  }
  if (splits == 1) return;

  // The last split to finish this region adds all splits in order.
  __threadfence();
  __syncthreads();
  const int region = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counters + region, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Every split's loads are issued before the in-order sum; 4 columns
  // at a time where rows of part are 16-byte aligned.
  const int rows = m_end - r0, cols = n_end - c0;
  const size_t mn = (size_t)M * N;
  if (N % 4 == 0 && c0 % 4 == 0 && cols % 4 == 0) {
    for (int e = 4 * tid; e < rows * cols; e += 4 * kThreads) {
      const int gm = r0 + e / cols, gn = c0 + e % cols;
      const float* p = part + (size_t)gm * N + gn;
      float4 v[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) v[s] = __ldcg(reinterpret_cast<const float4*>(p + s * mn));
      float a[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
      for (int s = 1; s < kMaxSplits; ++s)
        if (s < splits) {
          a[0] += v[s].x;
          a[1] += v[s].y;
          a[2] += v[s].z;
          a[3] += v[s].w;
        }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(size_t)gm * N + gn + c] =
            from_f32<T>(col_scale ? a[c] * col_scale[gn + c] : a[c]);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int gm = r0 + e / cols, gn = c0 + e % cols;
      const float* p = part + (size_t)gm * N + gn;
      float v[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) v[s] = __ldcg(p + s * mn);
      float a = v[0];
#pragma unroll
      for (int s = 1; s < kMaxSplits; ++s)
        if (s < splits) a += v[s];
      out[(size_t)gm * N + gn] =
          from_f32<T>(col_scale ? a * col_scale[gn] : a);
    }
  }
  if (tid == 0) counters[region] = 0;
}

namespace {
// Whether a kernel's shared-memory opt-in is done: one flag per kernel and
// per shared library (internal linkage, so two libraries that build the
// same kernel, each with its own runtime, never share one).
template <int BM, int BN, int KC, class T, class Loader>
bool& opted_in() {
  static bool done = false;
  return done;
}
}  // namespace

template <int BM, int BN, int KC, class T, class Loader>
int launch_tile(const T* x, const Loader& w, const float* col_scale, T* out,
                float* part, int* counters, int splits, int k_per_split,
                int M, int K, int N, int rm, int rn, cudaStream_t st) {
  using L = Tile<BM, BN, KC, T, Loader>;
  auto kernel = mm_kernel<BM, BN, KC, T, Loader>;
  bool& done = opted_in<BM, BN, KC, T, Loader>();   // one card
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  const dim3 grid((N + rn - 1) / rn, (M + rm - 1) / rm, splits);
  kernel<<<grid, kThreads, L::SMEM, st>>>(x, w, col_scale, out, part,
                                          counters, M, K, N, rm, rn,
                                          k_per_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, class T, class Loader>
int launch_kc(int kc, const T* x, const Loader& w, const float* col_scale,
              T* out, float* part, int* counters, int splits,
              int k_per_split, int M, int K, int N, int rm, int rn,
              cudaStream_t st) {
  switch (kc) {
    case 8:
      return launch_tile<BM, BN, 8>(x, w, col_scale, out, part, counters,
                                    splits, k_per_split, M, K, N, rm, rn, st);
    case 16:
      return launch_tile<BM, BN, 16>(x, w, col_scale, out, part, counters,
                                     splits, k_per_split, M, K, N, rm, rn,
                                     st);
    case 32:
      return launch_tile<BM, BN, 32>(x, w, col_scale, out, part, counters,
                                     splits, k_per_split, M, K, N, rm, rn,
                                     st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches blocks of rm x rn output regions (rm, rn > 0) walked in the
// (bm, bn) tile with 2 * kc K rows per stage, over `splits` K splits of
// k_per_split rows (a multiple of 2 * kc; part (splits, M, N) fp32 and
// counters, one zeroed int per region, when splits > 1; splits at most
// kMaxSplits); anything else is cudaErrorInvalidValue.
template <class T, class Loader>
int launch(int rm, int rn, int bm, int bn, int kc, const T* x,
           const Loader& w, const float* col_scale, T* out, float* part,
           int* counters, int splits, int k_per_split, int M, int K, int N,
           cudaStream_t st) {
  if (rm <= 0 || rn <= 0 || splits < 1 || splits > kMaxSplits ||
      k_per_split <= 0 ||
      k_per_split % (2 * kc) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return launch_kc<64, 64>(kc, x, w, col_scale, out, part, counters,
                             splits, k_per_split, M, K, N, rm, rn, st);
  if (bm == 64 && bn == 128)
    return launch_kc<64, 128>(kc, x, w, col_scale, out, part, counters,
                              splits, k_per_split, M, K, N, rm, rn, st);
  if (bm == 128 && bn == 64)
    return launch_kc<128, 64>(kc, x, w, col_scale, out, part, counters,
                              splits, k_per_split, M, K, N, rm, rn, st);
  if (bm == 128 && bn == 128)
    return launch_kc<128, 128>(kc, x, w, col_scale, out, part, counters,
                               splits, k_per_split, M, K, N, rm, rn, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mm
