// Tile bodies shared by the attention kernels, for fp32, fp16 and bf16
// inputs with fp32 arithmetic.
//
// Every kernel here computes scores q.k * scale, masked scores -1e30, an
// online softmax over key tiles and acc / max(l, 1e-30), as the Pallas
// kernels do.  The kernels differ only in where a key's K/V row lives
// (a dense (B, S, KV, dh) cache, or a paged (P, page, KV, dh) pool read
// through a block table) and in which keys a query row may see.  Those
// two things are the template arguments below; the loads, the softmax and
// the products are written once.  The storage type T (float, __half or
// __nv_bfloat16) is the Src / Tile's: every load is converted to fp32 in
// registers, shared memory holds fp32, scores, probabilities and
// accumulators are fp32 (the probabilities stay fp32 for the PV product,
// as the plain versions in kernels/ref.py keep them), and only the
// normalised output is rounded to T.  Unnormalised (o, m, l) partials are
// fp32 whatever T is.
//
//  * decode_kernel<Src>: one query token per (b, kv head, q head in the
//    group), one block per (S-split, kv head, b), 128 threads.  Each K/V
//    tile is loaded once into shared memory for all G query heads.
//    flash_decode.cu (dense cache + valid mask) and paged_decode.cu (block
//    table) instantiate it; combine_kernel merges the splits' (o, m, l).
//  * attend_tile<DH, Tile>: a 64-row query tile against 64-key tiles, 256
//    threads computing 4 x 4 score and 4 x (DH / 16) output register
//    micro-tiles, shared rows padded so column reads do not collide in a
//    bank.  flash_attention.cu (causal / windowed prefill) and
//    paged_decode.cu (paged verify) instantiate it.
//
// Src (decode) provides:
//   using T                           storage type of q, k, v and out
//   const T* k, * v                   pool / cache base pointers
//   static constexpr bool kVec4       load rows 4 elements at a time
//                                     (dh % 4 == 0, 4-element aligned rows)
//   int length(int b)                 slots of row b to walk
//   size_t row(int b, int s, int kvh) element offset of slot s's K/V row
//   bool ok(int b, int s)             unmasked?
// Tile (attend_tile) provides:
//   using T; const T* k, * v; static constexpr bool kVec4
//   int kt_begin, kt_end              key tiles to walk
//   int n_keys                        keys below it are read; the rest
//                                     weigh exactly 0
//   const T* q_row(int r)             block-local query row r (nullptr:
//   T* out_row(int r)                 past the rows, not written)
//   size_t key_row(int slot)          element offset of the key's K/V row
//   bool allowed(int r, int slot)     unmasked?
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace attn {

constexpr float kNegInf = -1e30f;

using namespace elem;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Decode: grid (n_split, KV, B), kDecThreads threads.
// ---------------------------------------------------------------------------
constexpr int kDecTile = 64;       // slots per shared-memory tile
constexpr int kDecThreads = 128;

inline size_t decode_smem_bytes(int G, int dh) {
  return sizeof(float) *
         ((size_t)G * dh + kDecTile * (dh + 1) + kDecTile * dh +
          (size_t)G * kDecTile + (size_t)G * dh + 3 * (size_t)G);
}

// Writes, per (split, b, kv, g): o (dh values of OutT) and, unless
// `normalize`, m and l.  Normalising divides o by max(l, 1e-30).  OutT is
// float for partials and Src::T for a normalised output.
template <class Src, class OutT>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(Src src, const typename Src::T* __restrict__ q,
              OutT* __restrict__ o_out, float* __restrict__ m_out,
              float* __restrict__ l_out, int B, int KV, int G, int dh,
              int chunk, float scale, int normalize) {
  using T = typename Src::T;
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int ks = dh + 1;             // padded K row: conflict-free reads
  const int gd = G * dh;
  float* q_s = smem;                 // G * dh (pre-scaled queries)
  float* k_s = q_s + gd;             // kDecTile * ks
  float* v_s = k_s + kDecTile * ks;  // kDecTile * dh
  float* p_s = v_s + kDecTile * dh;  // G * kDecTile (scores, then probs)
  float* acc_s = p_s + G * kDecTile; // G * dh
  float* m_s = acc_s + gd;           // G
  float* l_s = m_s + G;              // G
  float* c_s = l_s + G;              // G (per-tile rescale factor)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kDecThreads / 32;
  const T* qb = q + (size_t)(b * KV + kvh) * gd;
  for (int i = tid; i < gd; i += kDecThreads) {
    q_s[i] = ld(qb + i) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int s_begin = split * chunk;
  const int s_end = min(src.length(b), s_begin + chunk);

  for (int t0 = s_begin; t0 < s_end; t0 += kDecTile) {
    const int n = min(kDecTile, s_end - t0);
    __syncthreads();  // previous tile fully consumed (and q_s/m_s ready)
    if constexpr (Src::kVec4) {
      const int d4 = dh / 4;
      for (int i = tid; i < n * d4; i += kDecThreads) {
        const int j = i / d4, c = (i - j * d4) * 4;
        const size_t off = src.row(b, t0 + j, kvh) + c;
        const float4 kk = ld4(src.k + off);
        const float4 vv = ld4(src.v + off);
        float* kr = k_s + j * ks + c;
        kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
        float* vr = v_s + j * dh + c;
        vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      }
    } else {
      for (int i = tid; i < n * dh; i += kDecThreads) {
        const int j = i / dh, d = i - j * dh;
        const size_t off = src.row(b, t0 + j, kvh) + d;
        k_s[j * ks + d] = ld(src.k + off);
        v_s[j * dh + d] = ld(src.v + off);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * kDecTile; i += kDecThreads) {
      const int g = i / kDecTile, j = i - g * kDecTile;
      float s = -INFINITY;  // past the walked range: exp() gives exactly 0
      if (j < n) {
        if (src.ok(b, t0 + j)) {
          const float* qg = q_s + g * dh;
          const float* kj = k_s + j * ks;
          float a = 0.f;
          for (int d = 0; d < dh; ++d) a = fmaf(qg[d], kj[d], a);
          s = a;
        } else {
          s = kNegInf;
        }
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += n_warps) {
      float* pg = p_s + g * kDecTile;
      float mx = -INFINITY;
      for (int j = lane; j < kDecTile; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kDecTile; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < gd; i += kDecThreads) {
      const int g = i / dh, d = i - g * dh;
      const float* pg = p_s + g * kDecTile;
      float a = acc_s[i] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pg[j], v_s[j * dh + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  const size_t head = ((size_t)split * B + b) * KV + kvh;  // (split, b, kv)
  for (int i = tid; i < gd; i += kDecThreads) {
    const int g = i / dh;
    float a = acc_s[i];
    if (normalize) a /= fmaxf(l_s[g], 1e-30f);
    o_out[head * gd + i] = from_f32<OutT>(a);
  }
  if (!normalize) {
    for (int g = tid; g < G; g += kDecThreads) {
      m_out[head * G + g] = m_s[g];
      l_out[head * G + g] = l_s[g];
    }
  }
}

// One block per (b, kv, g) row: merges n_split partials laid out
// (n_split, rows, ...) the way the sharded decode combines shards.  A split
// past the row's length has l = 0 and m = -1e30, so it weighs exactly 0.
// With m_out (and l_out) NULL it writes o / max(l, 1e-30) as OutT, else
// the merged fp32 partials.
template <class OutT>
__global__ void combine_kernel(const float* __restrict__ po,
                               const float* __restrict__ pm,
                               const float* __restrict__ pl,
                               OutT* __restrict__ o_out,
                               float* __restrict__ m_out,
                               float* __restrict__ l_out, int rows, int dh,
                               int n_split) {
  const int r = blockIdx.x;
  float m_star = kNegInf;
  for (int i = 0; i < n_split; ++i) m_star = fmaxf(m_star, pm[(size_t)i * rows + r]);
  float l_star = 0.f;
  for (int i = 0; i < n_split; ++i)
    l_star += pl[(size_t)i * rows + r] * expf(pm[(size_t)i * rows + r] - m_star);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float o = 0.f;
    for (int i = 0; i < n_split; ++i)
      o += po[((size_t)i * rows + r) * dh + d] * expf(pm[(size_t)i * rows + r] - m_star);
    o_out[(size_t)r * dh + d] =
        from_f32<OutT>(m_out ? o : o / fmaxf(l_star, 1e-30f));
  }
  if (m_out && threadIdx.x == 0) {
    m_out[r] = m_star;
    l_out[r] = l_star;
  }
}

// Sets the dynamic shared memory a kernel needs when it is above the
// 48 KB that needs no opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches decode_kernel over (n_split, KV, B) and, with n_split > 1,
// combine_kernel.  part_o/m/l hold fp32 (n_split, B, KV, G[, dh])
// partials; out_m/out_l NULL means normalise into out_o as Src::T, else
// out_o, out_m, out_l receive the fp32 partials.  chunk: slots per split
// (a multiple of the tile, chunk * n_split covering every row's length).
template <class Src>
int launch_decode(const Src& src, const typename Src::T* q, float* part_o,
                  float* part_m, float* part_l, void* out_o, float* out_m,
                  float* out_l, int B, int KV, int G, int dh, int n_split,
                  int chunk, float scale, cudaStream_t st) {
  using T = typename Src::T;
  const size_t smem = decode_smem_bytes(G, dh);
  const dim3 grid(n_split, KV, B);
  const bool normalize = out_m == nullptr;
  cudaError_t e;
  if (n_split == 1 && normalize) {
    e = allow_smem(decode_kernel<Src, T>, smem);
    if (e != cudaSuccess) return (int)e;
    decode_kernel<Src, T><<<grid, kDecThreads, smem, st>>>(
        src, q, static_cast<T*>(out_o), nullptr, nullptr, B, KV, G, dh,
        chunk, scale, 1);
    return (int)cudaGetLastError();
  }
  e = allow_smem(decode_kernel<Src, float>, smem);
  if (e != cudaSuccess) return (int)e;
  if (n_split == 1) {
    decode_kernel<Src, float><<<grid, kDecThreads, smem, st>>>(
        src, q, static_cast<float*>(out_o), out_m, out_l, B, KV, G, dh,
        chunk, scale, 0);
    return (int)cudaGetLastError();
  }
  decode_kernel<Src, float><<<grid, kDecThreads, smem, st>>>(
      src, q, part_o, part_m, part_l, B, KV, G, dh, chunk, scale, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = B * KV * G;
  const int threads = dh < 128 ? dh : 128;
  if (normalize)
    combine_kernel<T><<<rows, threads, 0, st>>>(
        part_o, part_m, part_l, static_cast<T*>(out_o), nullptr, nullptr,
        rows, dh, n_split);
  else
    combine_kernel<float><<<rows, threads, 0, st>>>(
        part_o, part_m, part_l, static_cast<float*>(out_o), out_m, out_l,
        rows, dh, n_split);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 64 x 64 tiles: kBQ query rows per block, kBK keys per tile, kTileThreads.
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kTileThreads = 256;   // 16 x 16

template <int DH>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
          (size_t)kBQ * (kBK + 1) + 2 * kBQ);
}

template <int DH, class Tile>
__device__ __forceinline__ void attend_tile(const Tile& t, float scale) {
  using T = typename Tile::T;
  constexpr int QS = DH + 1, KS = DH + 1, SS = kBK + 1, NC = DH / 16;
  constexpr int D4 = DH / 4;
  constexpr int kLoads = Tile::kVec4 ? kBK * D4 : kBK * DH;
  extern __shared__ float smem[];
  float* q_s = smem;               // kBQ * QS (pre-scaled)
  float* k_s = q_s + kBQ * QS;     // kBK * KS
  float* v_s = k_s + kBK * KS;     // kBK * DH
  float* s_s = v_s + kBK * DH;     // kBQ * SS (scores, then probabilities)
  float* corr_s = s_s + kBQ * SS;  // kBQ
  float* l_s = corr_s + kBQ;       // kBQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int i = tid; i < kBQ * DH; i += kTileThreads) {
    const int r = i / DH, d = i - r * DH;
    const T* qr = t.q_row(r);
    q_s[r * QS + d] = qr ? ld(qr + d) * scale : 0.f;
  }

  const int srow = tid >> 2, spart = tid & 3;  // softmax: 4 threads per row
  float m_run = kNegInf, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int kt = t.kt_begin; kt < t.kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed (and q_s ready)
    for (int i = tid; i < kLoads; i += kTileThreads) {
      if constexpr (Tile::kVec4) {
        const int j = i / D4, c = (i - j * D4) * 4;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
        if (k0 + j < t.n_keys) {
          const size_t off = t.key_row(k0 + j) + c;
          kk = ld4(t.k + off);
          vv = ld4(t.v + off);
        }
        float* kr = k_s + j * KS + c;
        kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
        float* vr = v_s + j * DH + c;
        vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      } else {
        const int j = i / DH, d = i - j * DH;
        const bool in = k0 + j < t.n_keys;
        const size_t off = in ? t.key_row(k0 + j) + d : 0;
        k_s[j * KS + d] = in ? ld(t.k + off) : 0.f;
        v_s[j * DH + d] = in ? ld(t.v + off) : 0.f;
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int slot = k0 + c;
        float s = sc[i][j];
        if (slot >= t.n_keys) s = -INFINITY;         // not read: exp() gives 0
        else if (!t.allowed(r, slot)) s = kNegInf;   // masked
        s_s[r * SS + c] = s;
      }
    }
    __syncthreads();

    {
      float* sr = s_s + srow * SS;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) mx = fmaxf(mx, sr[spart + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const float p = expf(sr[spart + 4 * jj] - m_new);
        sr[spart + 4 * jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (spart == 0) corr_s[srow] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) w[j] = v_s[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    T* o = t.out_row(r);
    if (!o) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// Sets the tile kernel's shared memory and launches it on `grid`.  Staging
// is fp32 whatever the storage type: at DH = 256 that is
// tile_smem_bytes<256>() = 214,272 B, under the 232,448 B a block may opt
// into on an H100, so one block fits on an SM.
template <int DH, class... Params, class... Args>
int launch_tiles(void (*kernel)(Params...), dim3 grid, cudaStream_t st,
                 Args... args) {
  const size_t smem = tile_smem_bytes<DH>();
  static_assert(tile_smem_bytes<DH>() <= 232448, "tile over the smem limit");
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kTileThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace attn
