// Causal (optionally sliding-window) flash attention for prefill, in the
// grouped-query layout, fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (kernel body _flash_kernel).  It computes the same
// function: scores q.k * 1/sqrt(dh), keys above the causal diagonal or
// outside the window masked to -1e30, an online softmax over key tiles and
// acc / max(l, 1e-30).  The JAX package runs its jnp chunked_attention on
// this path; both compute the same attention.
//
// What bounds it on the H100: operations.  A 64-row query tile reuses each
// key/value row 64 times, so at prefill lengths the flops (4 * dh per
// unmasked query-key pair) outweigh the bytes.  It runs in full fp32 on the
// CUDA cores (67 TFLOP/s peak): tensor cores would mean TF32, which breaks
// fp32 parity with the reference.  A tensor-core (wgmma) design is later
// work.
//
// What the design does about it:
//  * The Pallas kernel walks all Sk/256 key tiles of every query tile.  Here
//    one block per (b, kv head, q head in group, 64-row query tile) loops
//    only over the key tiles that hold an unmasked key: tiles wholly above
//    the causal diagonal or wholly outside the window are skipped, which
//    halves the causal work.
//  * q is (B, Sq, KV, G, dh) and k/v (B, Sk, KV, dh), the layout gqa_prefill
//    has, so K/V are never broadcast to the G query heads.
//  * 256 threads compute the 64x64 score tile and the 64 x dh output tile
//    as 4 x 4 and 4 x (dh / 16) register micro-tiles; shared rows are padded
//    so column reads do not collide in a bank.
//  * Any Sq / Sk is allowed: rows past Sq are not written and keys past Sk
//    contribute exactly zero.  A row that no key may attend (possible only
//    with Sq > Sk) is not defined to match the reference.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr size_t attn_smem_floats() {
  return (size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) + (size_t)kBK * DH +
         (size_t)kBQ * (kBK + 1) + 2 * kBQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int Sq,
            int Sk, int KV, int G, int causal, int window, int q_offset,
            float scale) {
  constexpr int QS = DH + 1, KS = DH + 1, SS = kBK + 1, NC = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // kBQ * QS (pre-scaled)
  float* k_s = q_s + kBQ * QS;     // kBK * KS
  float* v_s = k_s + kBK * KS;     // kBK * DH
  float* s_s = v_s + kBK * DH;     // kBQ * SS (scores, then probabilities)
  float* corr_s = s_s + kBQ * SS;  // kBQ
  float* l_s = corr_s + kBQ;       // kBQ

  const int q0 = blockIdx.x * kBQ;
  const int kvh = blockIdx.y / G, g = blockIdx.y - (blockIdx.y / G) * G;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = (size_t)KV * G * DH;  // stride between query rows
  const size_t k_row = (size_t)KV * DH;      // stride between key rows
  const float* qb = q + (size_t)b * Sq * q_row + ((size_t)kvh * G + g) * DH;
  const float* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    q_s[r * QS + d] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * q_row + d] * scale : 0.f;
  }

  // key tiles holding at least one key some valid row of this tile may see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;         // exclusive
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt_begin = k_lo / kBK;
  const int kt_end = (k_hi + kBK - 1) / kBK;

  // softmax phase: 4 threads per query row
  const int srow = tid >> 2, spart = tid & 3;
  float m_run = kNegInf, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed (and q_s ready)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const bool in = k0 + r < Sk;
      k_s[r * KS + d] = in ? kb[(size_t)(k0 + r) * k_row + d] : 0.f;
      v_s[r * DH + d] = in ? vb[(size_t)(k0 + r) * k_row + d] : 0.f;
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
      const int qa = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int ka = k0 + c;
        float s = sc[i][j];
        if (ka >= Sk) {
          s = -INFINITY;  // past Sk: exp() gives exactly 0
        } else {
          bool ok = true;
          if (causal) ok = ok && ka <= qa;
          if (window > 0) ok = ok && ka > qa - window;
          if (!ok) s = kNegInf;
        }
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
  float* ob = out + (size_t)b * Sq * q_row + ((size_t)kvh * G + g) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(size_t)(q0 + r) * q_row + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Sk, int KV, int G, int causal, int window, int q_offset,
           float scale, cudaStream_t st) {
  const size_t smem = attn_smem_floats<DH>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, KV * G, B);
  attn_kernel<DH><<<grid, kThreads, smem, st>>>(q, k, v, out, Sq, Sk, KV, G,
                                                causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV, G, dh); k, v (B, Sk, KV, dh); out like q; all contiguous.
// window <= 0 means no window.  dh must be 32, 64 or 128.
extern "C" int repro_flash_attention_f32(const float* q, const float* k,
                                         const float* v, float* out, int B,
                                         int Sq, int Sk, int KV, int G, int dh,
                                         int causal, int window, int q_offset,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
