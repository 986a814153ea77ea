// Bodies shared by the attention kernels, for fp32, fp16 and bf16 inputs.
//
// Every kernel here computes scores q.k * scale, masked scores -1e30, an
// online softmax over the keys and acc / max(l, 1e-30), as the Pallas
// kernels do.  The kernels differ only in where a key's K/V row lives (a
// dense (B, S, KV, dh) cache, or a paged (P, page, KV, dh) pool read
// through a block table) and in which keys a query row may see.  Those two
// things are the template arguments below (Src, Tile); the loads, the
// softmax and the products are written once.
//
//  * decode_kernel<Src, L, GT>: one query token per (b, kv head, q head
//    in the group), L the lane layout of a K/V row (DecLanes for a dense or
//    paged cache, LatentLanes for MLA's latent cache).  Bound by bytes:
//    each K/V row is used by G query heads for 2 G dh flops, so the work
//    stays on the CUDA cores and the design is about keeping loads in
//    flight.  One block of kDecWarps warps per
//    (S-split, kv head, b, group of GT q heads); each warp walks its own
//    contiguous run of the split's keys.  A key's K and V rows come
//    straight from device memory into the registers of LPK lanes (16-byte
//    vectors where dh * sizeof(T) allows, else one element per lane), U
//    keys per lane group in flight; q.k is lane-parallel over dh with a
//    shuffle reduction, and the online softmax and the P V accumulators
//    live in registers.  No __syncthreads in the key loop: the warps merge
//    once, through shared memory, at the end.  With more than one split
//    the blocks store fp32 (o, m, l) partials to a workspace, and the last
//    block of each (b, kv head, group) to finish (a __threadfence and an
//    atomicAdd on a zeroed int32 counter, which it resets) merges them in
//    split order (each split's weight computed once per row into shared
//    memory): one launch per call, and the same bits on every call.
//    flash_decode.cu (dense cache + valid mask, and the latent cache) and
//    paged_decode.cu (block table) instantiate it.
//  * attend_tile<DQK, DV, NKW, Tile>: FlashAttention-2 on mma.sync.  A block
//    of four warps owns 64 or 16 query rows (the host's plan, so that
//    blocks reach the SMs).  In a 64-row block each warp owns 16 rows; a
//    16-row block's warps take a quarter of each key tile each (NKW = 4)
//    and merge their (o, m, l) once at the end, so a small prefill has
//    four times the blocks and still four warps in each.  K and V tiles of BK keys
//    land in shared memory in their storage type through a 2-stage
//    cp.async ring (one __syncthreads per tile), rows padded so fragment
//    reads do not collide in a bank.  The score fragment S = Q K^T stays in
//    registers, row max and sum use quad shuffles, and P becomes the A
//    fragment of the P V product in registers.  fp16 / bf16: one m16n8k16
//    pass, fp32 accumulators, P rounded to the input type for P V as the
//    Pallas kernel does (p.astype(v.dtype)).  fp32: 3xTF32 (m16n8k8) for
//    both products, a = ah + al, acc += al bh + ah bl + ah bh, about 2^-19
//    of sum |a| |b| per dot product, so fp32 inputs keep fp32 accuracy.
//    q and K rows are DQK wide, V and out rows DV (MLA's prefill: 96 and
//    64; every other caller DQK = DV).  flash_attention.cu (causal /
//    windowed prefill) and paged_decode.cu (paged verify) instantiate it.
//
// Src (decode) provides:
//   using T                           storage type of q, k, v and out
//   int length(int b)                 slots of row b to walk
//   bool ok(int b, int s)             unmasked?
// and what its lane layout L reads (DecLanes: const T* k, * v and size_t
// row(int b, int s, int kvh), the element offset of slot s's K/V row;
// LatentLanes: const T* c, * kr and int S).
// Tile (attend_tile) provides:
//   using T; const T* k, * v
//   int kt_begin, kt_end              key tiles (of BK keys) to walk
//   int n_keys                        keys below it are read; the rest
//                                     weigh exactly 0
//   const T* q_row(int r)             block-local query row r (nullptr:
//   T* out_row(int r)                 past the rows, not written)
//   float* lse_row(int r)             where row r's log-sum-exp goes
//                                     (nullptr: not written)
//   size_t key_row(int slot)          index of the key's K/V row: K at
//                                     key_row * DQK, V at key_row * DV
//   bool allowed(int r, int slot)     unmasked?
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"
#include "mma.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using namespace elem;
using namespace tc;

// ---------------------------------------------------------------------------
// Decode: grid (n_split, KV * ceil(G / GT), B), kDecThreads threads.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecMaxDH = 256;      // the scalar layout's row
constexpr int kDecGroup = 8;        // q heads per block when G > 1
constexpr int kDecMaxSplits = 64;   // launcher: flash_decode.MAX_SPLITS
static_assert(kDecMaxSplits % 32 == 0, "a warp holds the splits' m, l");

// How a warp's lanes share K/V rows.  DH > 0: rows of DH elements read as
// 16-byte chunks of E elements, LPK lanes per row (CPL chunks each);
// DH == 0: any dh up to kDecMaxDH, one element per lane, 32 lanes per row.
// A warp reads KPL keys per load and keeps U loads in flight, so KPL * U
// keys per step, within about 64 registers of K and V per lane (32 when
// the lane also holds GT > 1 heads' q and accumulators).
//
// A lane layout L gives decode_kernel: NK key (and q) and NE value (and
// accumulator) elements per lane, LPK lanes per key, KPL keys per load, U
// loads in flight (KS = KPL * U keys per warp step), RW the output row
// elements the lanes of one key cover, dq(dh) / dv(dh) the q and output
// row widths, load_q, load_kv, and elem(li, e), the output element of lane
// li's value e.
template <class T, int DH, int GT>
struct DecLanes {
  static constexpr bool kVec = DH > 0;
  static constexpr int E = kVec ? 16 / (int)sizeof(T) : 1;
  static constexpr int R = kVec ? DH / E : kDecMaxDH;
  static constexpr int LPK = R < 32 ? R : 32;
  static constexpr int CPL = R / LPK;
  static constexpr int NE = CPL * E;                  // elements per lane
  static constexpr int NK = NE;
  static constexpr int RW = NE * LPK;
  static constexpr int KPL = 32 / LPK;
  static constexpr int KV_REGS = GT == 1 ? 64 : 32;   // K and V floats
  static constexpr int U0 = KV_REGS / (2 * NE) < 1 ? 1 : KV_REGS / (2 * NE);
  static constexpr int U = U0 * KPL > 8 ? (8 / KPL < 1 ? 1 : 8 / KPL) : U0;
  static constexpr int KS = KPL * U;                  // keys per warp step
  static_assert(!kVec || (DH % E == 0 && (R & (R - 1)) == 0),
                "vector rows are a power of two of 16-byte chunks");
  static_assert(KS <= 8, "a warp step is at most one warp tile");

  static __device__ __forceinline__ int dq(int dh) {
    return kVec ? DH : dh;
  }
  static __device__ __forceinline__ int dv(int dh) {
    return kVec ? DH : dh;
  }

  // NE fp32 values of a row held by lane li (vector layout: chunks li,
  // li + LPK, ...; scalar layout: elements li, li + 32, ... below dh).
  static __device__ __forceinline__ void load_row(const T* row, int li,
                                                  int dh, float (&out)[NE]) {
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        unpack16<T>(__ldg(reinterpret_cast<const uint4*>(row) + li + c * LPK),
                    out + c * E);
    } else {
#pragma unroll
      for (int c = 0; c < NE; ++c) {
        const int d = li + 32 * c;
        out[c] = d < dh ? ld(row + d) : 0.f;
      }
    }
  }
  static __device__ __forceinline__ void load_q(const T* row, int li, int dh,
                                                float (&out)[NK]) {
    load_row(row, li, dh, out);
  }
  template <class Src>
  static __device__ __forceinline__ void load_kv(const Src& src, int b,
                                                 int key, int kvh, int li,
                                                 int dh, float (&kf)[NK],
                                                 float (&vf)[NE]) {
    const size_t off = src.row(b, key, kvh);
    load_row(src.k + off, li, dh, kf);
    load_row(src.v + off, li, dh, vf);
  }
  static __device__ __forceinline__ int elem(int li, int e) {
    if constexpr (kVec) return (li + (e / E) * LPK) * E + e % E;
    else return li + 32 * e;
  }
};

// MLA's latent cache (flash_decode.cu's LatentKV: c (B, S, DC), kr (B, S,
// DR)): slot s's key row is [c_s, kr_s] (DC + DR = 288 wide) and its value
// row c_s (DC = 256), so one read of c serves both products.  A warp reads
// one key at a time, its 32 lanes holding 16-byte chunks of c (NE
// elements) and one element of kr each: NK = NE + 1 key elements, of which
// the first NE are the lane's values.  A K row wider than kDecMaxDH, and
// wider than its V row, so the dense layout's one row width does not
// apply.  The q row is [q_c, q_r] of 288.
template <class T, int GT>
struct LatentLanes {
  static constexpr int DC = 256, DR = 32;
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int LPK = 32;
  static constexpr int CPL = DC / E / LPK;
  static constexpr int NE = CPL * E;                  // c elements per lane
  static constexpr int NK = NE + 1;                   // and one of kr
  static constexpr int RW = NE * LPK;
  static constexpr int KPL = 1;
  static constexpr int U = GT == 1 ? 4 : 2;           // ~NK * U registers
  static constexpr int KS = KPL * U;
  static_assert(DC % (E * LPK) == 0 && DR == LPK, "latent lane layout");

  static __device__ __forceinline__ int dq(int) { return DC + DR; }
  static __device__ __forceinline__ int dv(int) { return DC; }
  static __device__ __forceinline__ void load_c(const T* row, int li,
                                                float* out) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      unpack16<T>(__ldg(reinterpret_cast<const uint4*>(row) + li + c * LPK),
                  out + c * E);
  }
  static __device__ __forceinline__ void load_q(const T* row, int li, int,
                                                float (&out)[NK]) {
    load_c(row, li, out);
    out[NE] = ld(row + DC + li);
  }
  template <class Src>
  static __device__ __forceinline__ void load_kv(const Src& src, int b,
                                                 int key, int, int li, int,
                                                 float (&kf)[NK],
                                                 float (&vf)[NE]) {
    const size_t slot = (size_t)b * src.S + key;
    load_c(src.c + slot * DC, li, kf);
    kf[NE] = ld(src.kr + slot * DR + li);
#pragma unroll
    for (int e = 0; e < NE; ++e) vf[e] = kf[e];
  }
  static __device__ __forceinline__ int elem(int li, int e) {
    return (li + (e / E) * LPK) * E + e % E;
  }
};

// (m, l, acc) <- the merge with another partial (m2, l2, acc2).
template <int N>
__device__ __forceinline__ void merge_partial(float& m, float& l,
                                              float (&acc)[N], float m2,
                                              float l2, const float (&acc2)[N]) {
  const float mm = fmaxf(m, m2);
  const float a = expf(m - mm), c = expf(m2 - mm);
  l = l * a + l2 * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acc2[e] * c;
  m = mm;
}

// Writes the result for (b, kv, g) row `row` at element d: o / max(l,
// 1e-30) in T when `normalize`, else fp32 o with m, l (by the thread of
// element 0).
template <class T>
__device__ __forceinline__ void decode_store(void* out, float* out_m,
                                             float* out_l, size_t row, int dh,
                                             int d, float o, float m, float l) {
  if (out_m == nullptr) {
    static_cast<T*>(out)[row * dh + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
  } else {
    static_cast<float*>(out)[row * dh + d] = o;
    if (d == 0) {
      out_m[row] = m;
      out_l[row] = l;
    }
  }
}

// out: (B, KV, G, dh) of T (out_m == nullptr: normalised) or fp32 o with
// fp32 out_m, out_l (B, KV, G).  work (n_split > 1): fp32 partials o
// (n_split, B, KV, G, dh), then m and l (n_split, B, KV, G); counters: one
// zeroed int32 per (b, kv, group) block column.  chunk: keys per split, a
// multiple of kDecWarps (each warp walks chunk / kDecWarps of them).
template <class Src, class L, int GT>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(Src src, const typename Src::T* __restrict__ q,
              void* __restrict__ out, float* __restrict__ out_m,
              float* __restrict__ out_l, float* __restrict__ work,
              int* __restrict__ counters, int B, int KV, int G, int dh,
              int chunk, float scale) {
  using T = typename Src::T;
  constexpr int NE = L::NE, NK = L::NK, U = L::U, RW = L::RW;
  __shared__ float s_o[kDecWarps][GT][RW];
  __shared__ float s_m[kDecWarps][GT], s_l[kDecWarps][GT];
  __shared__ float s_w[GT][kDecMaxSplits], s_lw[GT][kDecMaxSplits];
  __shared__ int is_last;

  const int D = L::dv(dh), DQ = L::dq(dh);   // output and q row widths
  const int n_split = gridDim.x, split = blockIdx.x, b = blockIdx.z;
  const int n_gt = (G + GT - 1) / GT;
  const int kvh = blockIdx.y / n_gt, g0 = (blockIdx.y - kvh * n_gt) * GT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % L::LPK, kg = lane / L::LPK;
  const size_t rows = (size_t)B * KV * G;
  const size_t row0 = ((size_t)b * KV + kvh) * G;   // (b, kvh, g = 0)

  float qr[GT][NK], acc[GT][NE], m[GT], l[GT];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[gi][e] = 0.f;
    if (g0 + gi < G) {
      L::load_q(q + (row0 + g0 + gi) * DQ, li, dh, qr[gi]);
#pragma unroll
      for (int e = 0; e < NK; ++e) qr[gi][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < NK; ++e) qr[gi][e] = 0.f;
    }
  }

  // this warp's keys: a contiguous run of the split, walked KS at a time
  const int kpw = chunk / kDecWarps;
  const int w0 = split * chunk + warp * kpw;
  const int w1 = min(src.length(b), w0 + kpw);
  for (int base = w0; base < w1; base += L::KS) {
    float kf[U][NK], vf[U][NE];
    bool rd[U], ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * L::KPL + kg;
      rd[u] = key < w1;
      ok[u] = false;
      if (rd[u]) {
        L::load_kv(src, b, key, kvh, li, dh, kf[u], vf[u]);
        ok[u] = src.ok(b, key);
      } else {
#pragma unroll
        for (int e = 0; e < NK; ++e) kf[u][e] = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < NK; ++e) s = fmaf(qr[gi][e], kf[u][e], s);
#pragma unroll
        for (int o = L::LPK / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(kFull, s, o);
        // a slot past the walk weighs exactly 0; a masked one -1e30
        sc[u] = !rd[u] ? -INFINITY : (ok[u] ? s : kNegInf);
      }
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u]);
      const float corr = expf(m[gi] - mx);
      float lsum = l[gi] * corr;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[gi][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(sc[u] - mx);
        lsum += p;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e]);
      }
      l[gi] = lsum;
      m[gi] = mx;
    }
  }

  // merge the warp's key groups (lanes li of groups kg hold one element)
#pragma unroll
  for (int o = L::LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float other[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e)
        other[e] = __shfl_xor_sync(kFull, acc[gi][e], o);
      const float m2 = __shfl_xor_sync(kFull, m[gi], o);
      const float l2 = __shfl_xor_sync(kFull, l[gi], o);
      merge_partial(m[gi], l[gi], acc[gi], m2, l2, other);
    }
  }
  if (lane < L::LPK) {
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = L::elem(li, e);
        if (d < D) s_o[warp][gi][d] = acc[gi][e];
      }
      if (lane == 0) {
        s_m[warp][gi] = m[gi];
        s_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // merge the warps in order; one split writes out, else its partial
  float* part_o = work;
  float* part_m = work + (size_t)n_split * rows * D;
  float* part_l = part_m + (size_t)n_split * rows;
  for (int i = tid; i < GT * D; i += kDecThreads) {
    const int gi = i / D, d = i - gi * D;
    if (g0 + gi >= G) break;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, s_m[w][gi]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = expf(s_m[w][gi] - mm);
      ll = fmaf(s_l[w][gi], c, ll);
      o = fmaf(s_o[w][gi][d], c, o);
    }
    const size_t row = row0 + g0 + gi;
    if (n_split == 1) {
      decode_store<T>(out, out_m, out_l, row, D, d, o, mm, ll);
    } else {
      part_o[((size_t)split * rows + row) * D + d] = o;
      if (d == 0) {
        part_m[split * rows + row] = mm;
        part_l[split * rows + row] = ll;
      }
    }
  }
  if (n_split == 1) return;

  // The last split to finish this block column merges all, in order.
  __threadfence();
  __syncthreads();
  const int column = blockIdx.z * gridDim.y + blockIdx.y;
  if (tid == 0) is_last = atomicAdd(counters + column, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each split's weight exp(m_s - m*) per row, once (a warp per row), and
  // l* summed in split order; then every element sums its splits in order
  for (int gi = warp; gi < GT && g0 + gi < G; gi += kDecWarps) {
    const size_t row = row0 + g0 + gi;
    float ms[kDecMaxSplits / 32], ls[kDecMaxSplits / 32];   // splits lane + 32h
    float mm = kNegInf;
#pragma unroll
    for (int h = 0; h < kDecMaxSplits / 32; ++h) {
      const int s = lane + 32 * h;
      ms[h] = s < n_split ? __ldcg(part_m + s * rows + row) : kNegInf;
      ls[h] = s < n_split ? __ldcg(part_l + s * rows + row) : 0.f;
      mm = fmaxf(mm, ms[h]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(kFull, mm, o));
#pragma unroll
    for (int h = 0; h < kDecMaxSplits / 32; ++h) {
      const int s = lane + 32 * h;
      if (s < n_split) {
        const float w = expf(ms[h] - mm);
        s_w[gi][s] = w;
        s_lw[gi][s] = ls[h] * w;
      }
    }
    __syncwarp();
    if (lane == 0) {
      float ll = 0.f;
      for (int s = 0; s < n_split; ++s) ll += s_lw[gi][s];
      s_m[0][gi] = mm;
      s_l[0][gi] = ll;
    }
  }
  __syncthreads();
  for (int i = tid; i < GT * D; i += kDecThreads) {
    const int gi = i / D, d = i - gi * D;
    if (g0 + gi >= G) break;
    const size_t row = row0 + g0 + gi;
    const float* po = part_o + row * D + d;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      o = fmaf(__ldcg(po + s * rows * D), s_w[gi][s], o);
    decode_store<T>(out, out_m, out_l, row, D, d, o, s_m[0][gi], s_l[0][gi]);
  }
  if (tid == 0) counters[column] = 0;
}

template <class Src, class L, int GT>
int launch_decode_gt(const Src& src, const typename Src::T* q, void* out,
                     float* out_m, float* out_l, float* work, int* counters,
                     int B, int KV, int G, int dh, int n_split, int chunk,
                     float scale, cudaStream_t st) {
  const dim3 grid(n_split, KV * ((G + GT - 1) / GT), B);
  decode_kernel<Src, L, GT><<<grid, kDecThreads, 0, st>>>(
      src, q, out, out_m, out_l, work, counters, B, KV, G, dh, chunk, scale);
  return (int)cudaGetLastError();
}

// One layout family, GT = 1 for G == 1 and kDecGroup heads per block else.
template <class Src, template <class, int> class Lanes>
int launch_decode_lanes(const Src& src, const typename Src::T* q, void* out,
                        float* out_m, float* out_l, float* work,
                        int* counters, int B, int KV, int G, int dh,
                        int n_split, int chunk, float scale,
                        cudaStream_t st) {
  using T = typename Src::T;
  if (G == 1)
    return launch_decode_gt<Src, Lanes<T, 1>, 1>(
        src, q, out, out_m, out_l, work, counters, B, KV, G, dh, n_split,
        chunk, scale, st);
  return launch_decode_gt<Src, Lanes<T, kDecGroup>, kDecGroup>(
      src, q, out, out_m, out_l, work, counters, B, KV, G, dh, n_split, chunk,
      scale, st);
}

template <int DH>
struct DenseLanes {
  template <class T, int GT>
  using type = DecLanes<T, DH, GT>;
};

// The launch arguments every decode layout needs.
inline bool decode_args_ok(int G, int n_split, int chunk, const float* work,
                           const int* counters, const float* out_m,
                           const float* out_l) {
  return G > 0 && n_split >= 1 && n_split <= kDecMaxSplits && chunk > 0 &&
         chunk % kDecWarps == 0 && (n_split == 1 || (work && counters)) &&
         ((out_m == nullptr) == (out_l == nullptr));
}

// Launches decode_kernel (see above).  vec: dh * sizeof(T) is a multiple
// of 16 and q and the K/V bases are 16-byte aligned (the wrapper checks);
// then dh of 32, 64, 128 or 256 takes the 16-byte layout, any other dh up
// to kDecMaxDH the scalar one.  Anything else is cudaErrorInvalidValue.
template <class Src>
int launch_decode(const Src& src, const typename Src::T* q, void* out,
                  float* out_m, float* out_l, float* work, int* counters,
                  int B, int KV, int G, int dh, int n_split, int chunk,
                  int vec, float scale, cudaStream_t st) {
  if (dh <= 0 || dh > kDecMaxDH ||
      !decode_args_ok(G, n_split, chunk, work, counters, out_m, out_l))
    return (int)cudaErrorInvalidValue;
#define REPRO_DECODE_DH(N)                                                  \
  launch_decode_lanes<Src, DenseLanes<N>::template type>(                   \
      src, q, out, out_m, out_l, work, counters, B, KV, G, dh, n_split,     \
      chunk, scale, st)
  if (vec) {
    switch (dh) {
      case 32: return REPRO_DECODE_DH(32);
      case 64: return REPRO_DECODE_DH(64);
      case 128: return REPRO_DECODE_DH(128);
      case 256: return REPRO_DECODE_DH(256);
      default: break;
    }
  }
  return REPRO_DECODE_DH(0);
#undef REPRO_DECODE_DH
}

// Launches decode_kernel on MLA's latent cache (LatentLanes): one virtual
// KV head, G query heads; out (B, 1, G, DC) normalised in T when out_m and
// out_l are NULL, else fp32 unnormalised o with fp32 m, l (B, 1, G), the
// partials of the slots given (a model rank's slice of a sequence-sharded
// cache).  q, c and kr must be 16-byte aligned (the wrapper checks).
template <class Src>
int launch_latent_decode(const Src& src, const typename Src::T* q, void* out,
                         float* out_m, float* out_l, float* work,
                         int* counters, int B, int G, int n_split, int chunk,
                         float scale, cudaStream_t st) {
  if (!decode_args_ok(G, n_split, chunk, work, counters, out_m, out_l))
    return (int)cudaErrorInvalidValue;
  return launch_decode_lanes<Src, LatentLanes>(
      src, q, out, out_m, out_l, work, counters, B, 1, G,
      LatentLanes<typename Src::T, 1>::DC, n_split, chunk, scale, st);
}

// ---------------------------------------------------------------------------
// Attention tiles: grid (ceil(rows / bq), ..., ...), block (2 bq, NKW).
// ---------------------------------------------------------------------------
constexpr int kTileWarps = 4;
constexpr int kMaxTileThreads = 32 * kTileWarps;
constexpr int kMaxBQ = 16 * kTileWarps;       // query rows per block, at most

// A block holds bq / 16 row warps (16 query rows each) times NKW key warps:
// a 64-row block is four row warps (NKW = 1), a 16-row block four key
// warps (NKW = kTileWarps) that take a quarter of each key tile each, keep
// their own online softmax and merge once at the end.
template <int DQK, int DV, class T, int NKW>
struct AttnShape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kWide = kF32 && (DQK == 256 || DV == 256);  // 32 keys
  static constexpr int BK = kWide ? 32 : 64;        // keys per tile
  static constexpr int KW = BK / NKW;               // keys per warp per tile
  static constexpr int CH = 16 / (int)sizeof(T);    // elements per cp.async
  static constexpr int RQ = DQK / CH, RV = DV / CH; // 16-byte chunks per row
  // padded rows (elements): fp32 Q / K fragments are float2 reads (row
  // stride = 8 mod 32 words), fp32 V reads take rows 2t, 2t + 1 (4 mod 16);
  // 16-bit rows are 4 or 20 mod 32 words (DQK 96: 52 words), either of
  // which spreads a fragment read's 8 rows x 4 words over the 32 banks
  static constexpr int QLD = DQK + 8, KLD = DQK + 8;
  static constexpr int VLD = kF32 ? DV + 4 : DV + 8;
  static constexpr int NS = KW / 8;                 // n8 tiles of a warp's keys
  static constexpr int NO = DV / 8;                 // n8 tiles of an out row
  // fp32 scores: the three products in three accumulators (more MMAs in
  // flight) when the warp's keys are few, else in one
  static constexpr int NACC = kF32 && NS <= 2 ? 3 : 1;
  static constexpr int STAGE = BK * (KLD + VLD);    // elements per stage
  // the key warps' merge: fp32 O (16 x DV) and m, l (16 each) per warp,
  // in the stages once they are drained
  static constexpr size_t MERGE = 4 * kTileWarps * 16 * (DV + 2);
  static constexpr size_t smem(int bq) {
    return sizeof(T) * ((size_t)bq * QLD + 2 * (size_t)STAGE);
  }
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && DQK % CH == 0 &&
                    DV % CH == 0, "head_dim");
  // every lane runs every iteration of load_kv's copy loops (shuffles)
  static_assert((BK * RQ) % kMaxTileThreads == 0 &&
                    (BK * RV) % kMaxTileThreads == 0, "tile copy loops");
  static_assert(KW % (kF32 ? 8 : 16) == 0, "whole MMA steps of keys");
  static_assert(MERGE <= sizeof(T) * 2 * (size_t)STAGE, "merge buffer");
  static_assert(smem(kMaxBQ) <= 232448, "tiles over the smem limit");
};

template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Two consecutive outputs of a row (2-element aligned).
template <class T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(a, b);
}

template <int DQK, int DV, int NKW, class Tile>
__device__ __forceinline__ void attend_tile(const Tile& t, float scale) {
  using T = typename Tile::T;
  using A = AttnShape<DQK, DV, T, NKW>;
  using Op = std::conditional_t<std::is_same<T, __half>::value, F16, Bf16>;
  constexpr int BK = A::BK, KW = A::KW, QLD = A::QLD, KLD = A::KLD;
  constexpr int VLD = A::VLD, NS = A::NS, NO = A::NO;
  constexpr int RQ = A::RQ, RV = A::RV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  // blockDim (2 bq, NKW): warp (wq, wk) = (threadIdx.x / 32, y)
  const int bq = blockDim.x / 2, nthreads = blockDim.x * NKW;
  T* stage0 = q_s + bq * QLD;

  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5, wk = threadIdx.y;
  const int warp = wk * (bq / 16) + wq;
  const int tid = warp * 32 + lane;
  const int g = lane >> 2, tq = lane & 3;

  // K/V rows of tile kt into stage `slot`; each warp first resolves the
  // tile's row indices (lane l: rows l and l + 32), then hands them out by
  // shuffles (BK * RQ and BK * RV are multiples of the block's threads, so
  // every lane runs every iteration); K rows are DQK wide, V rows DV
  auto load_kv = [&](int kt, int slot) {
    T* k_s = stage0 + slot * A::STAGE;
    T* v_s = k_s + BK * KLD;
    const int k0 = kt * BK;
    unsigned long long idx[BK / 32];
#pragma unroll
    for (int h = 0; h < BK / 32; ++h) {
      const int key = k0 + 32 * h + lane;
      idx[h] = key < t.n_keys ? t.key_row(key) : 0;
    }
    auto row_of = [&](int j) {
      unsigned long long o = __shfl_sync(kFull, idx[0], j & 31);
      if constexpr (BK == 64) {
        const unsigned long long o1 = __shfl_sync(kFull, idx[1], j & 31);
        if (j & 32) o = o1;
      }
      return o;
    };
    for (int i = tid; i < BK * RQ; i += nthreads) {
      const int j = i / RQ, c = (i - j * RQ) * A::CH;
      const unsigned long long o = row_of(j);
      cp_async16(k_s + j * KLD + c, t.k + o * DQK + c, k0 + j < t.n_keys);
    }
    for (int i = tid; i < BK * RV; i += nthreads) {
      const int j = i / RV, c = (i - j * RV) * A::CH;
      const unsigned long long o = row_of(j);
      cp_async16(v_s + j * VLD + c, t.v + o * DV + c, k0 + j < t.n_keys);
    }
  };
  for (int i = tid; i < bq * RQ; i += nthreads) {
    const int r = i / RQ, c = (i - r * RQ) * A::CH;
    const T* qr = t.q_row(r);
    cp_async16(q_s + r * QLD + c, qr ? qr + c : t.k, qr != nullptr);
  }
  if (t.kt_begin < t.kt_end) load_kv(t.kt_begin, 0);
  cp_async_commit();

  // scores in the log2 domain: exp2(s * log2 e) = exp(s)
  const float sl2 = scale * 1.4426950408889634f;
  const int r_lo = wq * 16 + g, r_hi = r_lo + 8;   // this lane's rows
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int kt = t.kt_begin; kt < t.kt_end; ++kt) {
    const int it = kt - t.kt_begin;
    cp_async_wait<0>();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < t.kt_end) load_kv(kt + 1, (it + 1) & 1);
    cp_async_commit();
    const T* k_s = stage0 + (it & 1) * A::STAGE;
    const T* v_s = k_s + BK * KLD;

    {
      const int kb = NKW == 1 ? 0 : wk * KW;       // the warp's first key
      // S = Q K^T for this warp's 16 rows: s[j] is keys kb + 8j ..
      float s[NS][4];
      if constexpr (A::kF32) {
        // 3xTF32 (with NACC == 3 each pass in its own accumulator), k
        // permuted within a step alike for A and B: slot tq is d = kk + 2
        // tq and slot tq + 4 is d + 1, so fragments are float2s
        constexpr int NACC = A::NACC;
        float s3[NACC][NS][4];
#pragma unroll
        for (int p = 0; p < NACC; ++p)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s3[p][j][e] = 0.f;
        const float* qf = reinterpret_cast<const float*>(q_s) + r_lo * QLD;
        const float* kf = reinterpret_cast<const float*>(k_s) +
                          (kb + g) * KLD + 2 * tq;
#pragma unroll 8
        for (int kk = 0; kk < DQK; kk += 8) {
          const float2 v0 =
              *reinterpret_cast<const float2*>(qf + kk + 2 * tq);
          const float2 v1 =
              *reinterpret_cast<const float2*>(qf + 8 * QLD + kk + 2 * tq);
          uint32_t ah[4], al[4];
          split_tf32(v0.x, ah[0], al[0]);
          split_tf32(v1.x, ah[1], al[1]);
          split_tf32(v0.y, ah[2], al[2]);
          split_tf32(v1.y, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float2 kv =
                *reinterpret_cast<const float2*>(kf + 8 * j * KLD + kk);
            uint32_t bh[2], bl[2];
            split_tf32(kv.x, bh[0], bl[0]);
            split_tf32(kv.y, bh[1], bl[1]);
            mma(Tf32{}, s3[0][j], al, bh);
            mma(Tf32{}, s3[NACC > 1 ? 1 : 0][j], ah, bl);
            mma(Tf32{}, s3[NACC > 1 ? 2 : 0][j], ah, bh);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = NACC > 1 ? s3[NACC - 1][j][e] +
                                     (s3[NACC > 1 ? 1 : 0][j][e] + s3[0][j][e])
                               : s3[0][j][e];
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const uint16_t* qh = reinterpret_cast<const uint16_t*>(q_s) +
                             r_lo * QLD + 2 * tq;
        const uint16_t* kh = reinterpret_cast<const uint16_t*>(k_s) +
                             (kb + g) * KLD + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < DQK; kk += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(qh + kk);
          a[1] = *reinterpret_cast<const uint32_t*>(qh + 8 * QLD + kk);
          a[2] = *reinterpret_cast<const uint32_t*>(qh + kk + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(qh + 8 * QLD + kk + 8);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const uint16_t* kp = kh + 8 * j * KLD + kk;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                   *reinterpret_cast<const uint32_t*>(kp + 8)};
            mma(Op{}, s[j], a, b);
          }
        }
      }

      // mask, then the online softmax of rows r_lo (e = 0, 1) and r_hi
      const int k0 = kt * BK + kb;
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = k0 + 8 * j + 2 * tq + (e & 1);
          const int r = e < 2 ? r_lo : r_hi;
          float v = s[j][e] * sl2;
          if (slot >= t.n_keys) v = -INFINITY;         // not read: weighs 0
          else if (!t.allowed(r, slot)) v = kNegInf;   // masked
          s[j][e] = v;
          if (e < 2) mx_lo = fmaxf(mx_lo, v);
          else mx_hi = fmaxf(mx_hi, v);
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, x));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, x));
      }
      const float c_lo = exp2f(m_lo - mx_lo), c_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = exp2f(s[j][0] - mx_lo);
        s[j][1] = exp2f(s[j][1] - mx_lo);
        s[j][2] = exp2f(s[j][2] - mx_hi);
        s[j][3] = exp2f(s[j][3] - mx_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      l_lo = l_lo * c_lo + sum_lo;   // this lane's share; quad sum at the end
      l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= c_lo;
        o[n][1] *= c_lo;
        o[n][2] *= c_hi;
        o[n][3] *= c_hi;
      }

      // O += P V, P from the score registers
      if constexpr (A::kF32) {
        const float* vf = reinterpret_cast<const float*>(v_s);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // slot tq is key kb + 8j + 2tq, slot tq + 4 the key after it
          uint32_t ah[4], al[4];
          split_tf32(s[j][0], ah[0], al[0]);
          split_tf32(s[j][2], ah[1], al[1]);
          split_tf32(s[j][1], ah[2], al[2]);
          split_tf32(s[j][3], ah[3], al[3]);
          const float* vp = vf + (kb + 8 * j + 2 * tq) * VLD + g;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t bh[2], bl[2];
            split_tf32(vp[8 * n], bh[0], bl[0]);
            split_tf32(vp[VLD + 8 * n], bh[1], bl[1]);
            mma(Tf32{}, o[n], al, bh);
            mma(Tf32{}, o[n], ah, bl);
            mma(Tf32{}, o[n], ah, bh);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          // P rounded to T, as the Pallas kernel's p.astype(v.dtype)
          uint32_t a[4];
          a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
          a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
          a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          const uint16_t* vp = reinterpret_cast<const uint16_t*>(v_s) +
                               (kb + 16 * kk + 2 * tq) * VLD + g;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const uint16_t* p = vp + 8 * n;
            const uint32_t b[2] = {p[0] | (uint32_t)p[VLD] << 16,
                                   p[8 * VLD] | (uint32_t)p[9 * VLD] << 16};
            mma(Op{}, o[n], a, b);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, x);
    l_hi += __shfl_xor_sync(kFull, l_hi, x);
  }
  // the row's natural log-sum-exp, m + log(l) (m in the log2 domain here),
  // for the backward's recompute; written only where the Tile asks
  constexpr float kLn2 = 0.6931471805599453f;
  if constexpr (NKW == 1) {   // one key warp: the registers are the result
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    T* out_lo = t.out_row(r_lo);
    T* out_hi = t.out_row(r_hi);
    if (tq == 0) {
      float* lse_lo = t.lse_row(r_lo);
      float* lse_hi = t.lse_row(r_hi);
      if (lse_lo) *lse_lo = m_lo * kLn2 + logf(fmaxf(l_lo, 1e-30f));
      if (lse_hi) *lse_hi = m_hi * kLn2 + logf(fmaxf(l_hi, 1e-30f));
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tq;
      if (out_lo) store2(out_lo + c, o[n][0] * inv_lo, o[n][1] * inv_lo);
      if (out_hi) store2(out_hi + c, o[n][2] * inv_hi, o[n][3] * inv_hi);
    }
    return;
  }
  // merge the key warps of each row warp, through the drained stages
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(stage0);   // [warp][16][DV]
  float* red_m = red_o + kTileWarps * 16 * DV;       // [warp][16]
  float* red_l = red_m + kTileWarps * 16;
  float* mine = red_o + warp * 16 * DV;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(mine + g * DV + c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * DV + c) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tq == 0) {
    red_m[warp * 16 + g] = m_lo;
    red_m[warp * 16 + g + 8] = m_hi;
    red_l[warp * 16 + g] = l_lo;
    red_l[warp * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  const int n_wq = bq / 16;
  for (int i = tid; i < bq * DV; i += nthreads) {
    const int r = i / DV, d = i - r * DV;
    T* out = t.out_row(r);
    if (!out) continue;
    const int q16 = r / 16, rr = r - q16 * 16;
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < NKW; ++k)
      mm = fmaxf(mm, red_m[(q16 + n_wq * k) * 16 + rr]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int k = 0; k < NKW; ++k) {   // in key-warp order
      const int w = q16 + n_wq * k;
      const float c = exp2f(red_m[w * 16 + rr] - mm);
      ll = fmaf(red_l[w * 16 + rr], c, ll);
      oo = fmaf(red_o[(w * 16 + rr) * DV + d], c, oo);
    }
    out[d] = from_f32<T>(oo / fmaxf(ll, 1e-30f));
    float* lse = d == 0 ? t.lse_row(r) : nullptr;
    if (lse) *lse = mm * kLn2 + logf(fmaxf(ll, 1e-30f));
  }
}

// Launches a tile kernel with NKW key warps on `grid`, blocks of rows
// query rows, opting into its shared memory on the first call (`opted`:
// one flag per kernel and per library).
template <int DQK, int DV, class T, int NKW, class... Params, class... Args>
int launch_tile(void (*kernel)(Params...), bool& opted, dim3 grid, int rows,
                cudaStream_t st, Args... args) {
  using A = AttnShape<DQK, DV, T, NKW>;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)A::smem(kMaxBQ));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  kernel<<<grid, dim3(2 * rows, NKW), A::smem(rows), st>>>(args...);
  return (int)cudaGetLastError();
}

// Launches the tile kernel for rows query rows per block: `split`
// (kTileWarps key warps) for 16 rows, `whole` (one) for 64.
template <int DQK, int DV, class T, class K1, class K4, class... Args>
int launch_tiles(K1 whole, K4 split, bool (&opted)[2], dim3 grid, int rows,
                 cudaStream_t st, Args... args) {
  if (rows == 16)
    return launch_tile<DQK, DV, T, kTileWarps>(split, opted[1], grid, rows,
                                               st, args...);
  if (rows == kMaxBQ)
    return launch_tile<DQK, DV, T, 1>(whole, opted[0], grid, rows, st,
                                      args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
