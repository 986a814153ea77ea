// Flash decoding for one query token per sequence against a dense KV cache,
// in the grouped-query layout, fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py ::
// flash_decode_partial / flash_decode (kernel body _decode_kernel).  It
// computes the same function: scores q.k * 1/sqrt(dh), masked scores set to
// -1e30, an online softmax over key tiles, and either the unnormalised
// (o, m, l) partials or o / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each key/value row is used by G query
// heads for 2*G*dh flops per 8*dh bytes, far below the card's ~20 flop/byte
// fp32 balance point, so the least time is the cache read at 3.35 TB/s.
//
// What the design does about it:
//  * The Pallas call site broadcasts the grouped cache to G copies before
//    the kernel (a G-fold read and a materialised copy).  Here the kernel
//    takes q (B, KV, G, dh) and the cache (B, S, KV, dh) directly: one block
//    per (b, kv head, S-split) loads each K/V tile into shared memory once
//    and serves all G query heads from it.
//  * A TPU grid runs in order on one core; here blocks run in parallel.  The
//    sequence is split across blocks (n_split) so that small batches still
//    fill the SMs, and a second small kernel merges the per-split (o, m, l)
//    exactly as the sharded decode path merges shards.
//  * Any S is allowed: keys past S in the last tile contribute exactly zero
//    (the TPU kernel's S % block_k assertion does not apply).
// Loads are plain coalesced fp32 reads and the dot products run on the
// CUDA cores; a TMA/cp.async pipeline is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // keys per shared-memory tile
constexpr int kThreads = 128;   // threads per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (n_split, KV, B).  Writes, per (split, b, kv, g): o (dh floats) and,
// unless `normalize`, m and l.  Normalising divides o by max(l, 1e-30).
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ valid,
              float* __restrict__ o_out, float* __restrict__ m_out,
              float* __restrict__ l_out, int B, int S, int KV, int G, int dh,
              int chunk, float scale, int normalize) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int ks = dh + 1;          // padded K row: conflict-free column reads
  const int gd = G * dh;
  float* q_s = smem;              // G * dh   (pre-scaled queries)
  float* k_s = q_s + gd;          // kTile * ks
  float* v_s = k_s + kTile * ks;  // kTile * dh
  float* p_s = v_s + kTile * dh;  // G * kTile (scores, then probabilities)
  float* acc_s = p_s + G * kTile; // G * dh
  float* m_s = acc_s + gd;        // G
  float* l_s = m_s + G;           // G
  float* c_s = l_s + G;           // G (per-tile rescale factor)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kThreads / 32;
  const float* qb = q + (size_t)(b * KV + kvh) * gd;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = qb[i] * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const size_t row = (size_t)KV * dh;  // stride between cache positions
  const float* kb = k + (size_t)b * S * row + (size_t)kvh * dh;
  const float* vb = v + (size_t)b * S * row + (size_t)kvh * dh;
  const uint8_t* valb = valid + (size_t)b * S;
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int n = min(kTile, s_end - t0);
    __syncthreads();  // previous tile fully consumed (and q_s/m_s ready)
    for (int i = tid; i < n * dh; i += kThreads) {
      const int j = i / dh, d = i - j * dh;
      k_s[j * ks + d] = kb[(size_t)(t0 + j) * row + d];
      v_s[j * dh + d] = vb[(size_t)(t0 + j) * row + d];
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      float s = -INFINITY;  // past S: exp() gives exactly 0
      if (j < n) {
        if (valb[t0 + j]) {
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
      float* pg = p_s + g * kTile;
      float mx = -INFINITY;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
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
    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / dh, d = i - g * dh;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * c_s[g];
      for (int j = 0; j < n; ++j) a = fmaf(pg[j], v_s[j * dh + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  const size_t head = ((size_t)split * B + b) * KV + kvh;  // (split, b, kv)
  for (int i = tid; i < gd; i += kThreads) {
    const int g = i / dh;
    float a = acc_s[i];
    if (normalize) a /= fmaxf(l_s[g], 1e-30f);
    o_out[head * gd + i] = a;
  }
  if (!normalize) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[head * G + g] = m_s[g];
      l_out[head * G + g] = l_s[g];
    }
  }
}

// One block per (b, kv, g) row: merges n_split partials laid out
// (n_split, rows, ...) the way the sharded decode combines shards.
__global__ void combine_kernel(const float* __restrict__ po,
                               const float* __restrict__ pm,
                               const float* __restrict__ pl,
                               float* __restrict__ o_out,
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
    o_out[(size_t)r * dh + d] = m_out ? o : o / fmaxf(l_star, 1e-30f);
  }
  if (m_out && threadIdx.x == 0) {
    m_out[r] = m_star;
    l_out[r] = l_star;
  }
}

size_t decode_smem_bytes(int G, int dh) {
  return sizeof(float) *
         ((size_t)G * dh + kTile * (dh + 1) + kTile * dh + (size_t)G * kTile +
          (size_t)G * dh + 3 * (size_t)G);
}

}  // namespace

// q (B, KV, G, dh); k, v (B, S, KV, dh); valid (B, S) bytes, all contiguous.
// out_o (B, KV, G, dh).  out_m, out_l (B, KV, G), or both NULL to normalise.
// With n_split > 1, part_o/m/l hold (n_split, B, KV, G[, dh]) partials.
// chunk: keys per split (a multiple of the tile, chunk * n_split >= S).
extern "C" int repro_flash_decode_f32(
    const float* q, const float* k, const float* v, const uint8_t* valid,
    float* part_o, float* part_m, float* part_l, float* out_o, float* out_m,
    float* out_l, int B, int S, int KV, int G, int dh, int n_split, int chunk,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = decode_smem_bytes(G, dh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_split, KV, B);
  const int normalize = out_m == nullptr;
  if (n_split == 1) {
    decode_kernel<<<grid, kThreads, smem, st>>>(q, k, v, valid, out_o, out_m,
                                                out_l, B, S, KV, G, dh, chunk,
                                                scale, normalize);
    return (int)cudaGetLastError();
  }
  decode_kernel<<<grid, kThreads, smem, st>>>(q, k, v, valid, part_o, part_m,
                                              part_l, B, S, KV, G, dh, chunk,
                                              scale, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = B * KV * G;
  const int threads = dh < 128 ? dh : 128;
  combine_kernel<<<rows, threads, 0, st>>>(
      part_o, part_m, part_l, out_o, out_m, out_l, rows, dh, n_split);
  return (int)cudaGetLastError();
}
