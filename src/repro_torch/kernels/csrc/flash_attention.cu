// Causal (optionally sliding-window) or non-causal flash attention for
// prefill, in the grouped-query layout, for fp32, fp16 and bf16 inputs
// (fp32 arithmetic, output in the inputs' type), head_dim 32, 64, 128 or
// 256.
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
// CUDA cores (67 TFLOP/s peak) whatever the storage type: tensor cores
// would mean TF32 for fp32 inputs, which breaks fp32 parity with the
// reference.  A tensor-core (wgmma) design for fp16 / bf16 is later work.
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
//    so column reads do not collide in a bank.  Q, K and V are staged in
//    shared memory as fp32 whatever the storage type: at dh = 256 that is
//    214,272 B, under the H100's 232,448 B per-block limit (one block per
//    SM), and 64 fp32 accumulators per thread.  That body is attn_tiles.cuh's
//    attend_tile, shared with the paged verify; this file supplies the
//    dense addressing, the causal / window mask and the tile range.
//  * Any Sq / Sk is allowed: rows past Sq are not written and keys past Sk
//    contribute exactly zero.  A row that no key may attend (with a window,
//    once q_offset + row - window + 1 >= Sk) gets what the reference gives
//    it, the mean of V over all Sk keys (every score is -1e30): a block
//    holding such a row walks every key tile, and for its other rows the
//    extra masked keys weigh exactly zero.
#include "attn_tiles.cuh"

namespace {

// One (b, kv head, q head in group, 64-row query tile) of a dense causal /
// windowed prefill; attn_tiles.cuh's attend_tile walks its key tiles.
template <int DH, class Elem>
struct CausalTile {
  using T = Elem;
  static constexpr bool kVec4 = false;
  const T* q;
  const T* k;
  const T* v;
  T* out;
  size_t q_base, kv_base;   // offsets of (b, row 0, this head)
  size_t q_stride, k_stride;
  int Sq, q0, qa0;          // qa0: absolute position of row q0
  int causal, window;
  int kt_begin, kt_end, n_keys;
  __device__ const T* q_row(int r) const {
    return q0 + r < Sq ? q + q_base + (size_t)(q0 + r) * q_stride : nullptr;
  }
  __device__ T* out_row(int r) const {
    return q0 + r < Sq ? out + q_base + (size_t)(q0 + r) * q_stride : nullptr;
  }
  __device__ size_t key_row(int slot) const {
    return kv_base + (size_t)slot * k_stride;
  }
  __device__ bool allowed(int r, int slot) const {
    const int qa = qa0 + r;
    bool ok = true;
    if (causal) ok = ok && slot <= qa;
    if (window > 0) ok = ok && slot > qa - window;
    return ok;
  }
};

// grid (ceil(Sq / 64), KV * G, B)
template <int DH, class T>
__global__ void __launch_bounds__(attn::kTileThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
            int KV, int G, int causal, int window, int q_offset,
            float scale) {
  using attn::kBK;
  using attn::kBQ;
  CausalTile<DH, T> t;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = blockIdx.y / G, g = blockIdx.y - (blockIdx.y / G) * G;
  const int b = blockIdx.z;
  t.q = q; t.k = k; t.v = v; t.out = out;
  t.q_stride = (size_t)KV * G * DH;  // between query rows
  t.k_stride = (size_t)KV * DH;      // between key rows
  t.q_base = (size_t)b * Sq * t.q_stride + ((size_t)kvh * G + g) * DH;
  t.kv_base = (size_t)b * Sk * t.k_stride + (size_t)kvh * DH;
  t.Sq = Sq; t.q0 = q0; t.qa0 = q_offset + q0;
  t.causal = causal; t.window = window; t.n_keys = Sk;

  // key tiles holding at least one key some valid row of this tile may see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;         // exclusive
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  // the last row sees no key at all: walk every tile, as the reference does
  const bool row_unseen = window > 0 && q_last - window + 1 >= Sk;
  t.kt_begin = row_unseen ? 0 : k_lo / kBK;
  t.kt_end = row_unseen ? (Sk + kBK - 1) / kBK : (k_hi + kBK - 1) / kBK;
  attn::attend_tile<DH>(t, scale);
}

template <int DH, class T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int KV, int G, int causal, int window, int q_offset,
           float scale, cudaStream_t st) {
  const dim3 grid((Sq + attn::kBQ - 1) / attn::kBQ, KV * G, B);
  return attn::launch_tiles<DH>(
      attn_kernel<DH, T>, grid, st, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      Sq, Sk, KV, G, causal, window, q_offset, scale);
}

}  // namespace

// q (B, Sq, KV, G, dh); k, v (B, Sk, KV, dh); out like q; all contiguous and
// of the storage type `dtype` (attn::DType).  window <= 0 means no window.
// dh must be 32, 64, 128 or 256.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int KV, int G, int dh, int causal,
                                     int window, int q_offset, float scale,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    switch (dh) {
      case 32:
        return launch<32, T>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
      case 64:
        return launch<64, T>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
      case 128:
        return launch<128, T>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
      case 256:
        return launch<256, T>(q, k, v, out, B, Sq, Sk, KV, G, causal, window, q_offset, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}
