// Causal (optionally sliding-window) or non-causal flash attention for
// prefill, in the grouped-query layout, for fp32, fp16 and bf16 inputs
// (output in the inputs' type), head_dim 32, 64, 128 or 256, and MLA's
// prefill heads: q / k rows of 96 (64 nope + 32 rope) and v rows of 64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (kernel body _flash_kernel).  It computes the same
// function: scores q.k * 1/sqrt(dh), keys above the causal diagonal or
// outside the window masked to -1e30, an online softmax over key tiles and
// acc / max(l, 1e-30).  The JAX package runs its jnp chunked_attention on
// this path; both compute the same attention.
//
// What bounds it on the H100: operations.  A query tile reuses each
// key/value row for all its rows, so at prefill lengths the flops (4 * dh
// per unmasked query-key pair) outweigh the bytes; at the serving path's
// shapes (one 128-token prompt, 16 heads) a call is also short enough that
// filling the 132 SMs matters as much.
//
// What the design does about it (attn_tiles.cuh's attend_tile):
//  * The products run on the tensor cores (mma.sync).  fp16 / bf16: one
//    m16n8k16 pass with fp32 accumulators, P rounded to the input type for
//    P V as the Pallas kernel does.  fp32: 3xTF32, which keeps the error
//    near 2^-19 of sum |a| |b| per dot product, inside the 1e-4 tolerance
//    against the fp32 plain version; there is no full-rate fp32 path.
//  * Query rows per block come from the host's plan (64 or 16;
//    kernels/flash_attention.py::block_rows), so that the grid reaches the
//    SMs: at the serving path's prefill 128 blocks of 16 rows where 64-row
//    tiles gave 32.  A 16-row block's four warps split each key tile and
//    merge at the end, so it keeps four warps at work.
//  * K and V tiles land in shared memory in their storage type through a
//    2-stage cp.async ring of 16-byte copies, the next tile in flight while
//    this one computes; scores and probabilities stay in registers.
//  * The Pallas kernel walks all Sk/256 key tiles of every query tile.  Here
//    a block loops only over the key tiles that hold an unmasked key: tiles
//    wholly above the causal diagonal or wholly outside the window are
//    skipped, which halves the causal work.
//  * q is (B, Sq, KV, G, dqk), k (B, Sk, KV, dqk) and v (B, Sk, KV, dv), the
//    layout gqa_prefill and mla_prefill have, so K/V are never broadcast to
//    the G query heads.  The tile body takes the q / k width and the v width
//    as two template parameters: at MLA's (96, 64) the score MMA runs 6
//    k-steps of 16 (12 of 8 in fp32) and P V is 64 wide, reading the 96-
//    and 64-wide rows as they are, with no padded copy.
//  * Any Sq / Sk is allowed: rows past Sq are not written and keys past Sk
//    contribute exactly zero.  A row that no key may attend (with a window,
//    once q_offset + row - window + 1 >= Sk) gets what the reference gives
//    it, the mean of V over all Sk keys (every score is -1e30): a block
//    holding such a row walks every key tile, and for its other rows the
//    extra masked keys weigh exactly zero.
//  * With a non-null lse pointer a block also writes each row's natural
//    log-sum-exp, m + log(l), which it holds anyway: the saved statistic of
//    the backward (flash_attention_bwd.cu).  Serving passes nullptr.
// This file supplies the dense addressing, the causal / window mask and the
// tile range.
#include "attn_tiles.cuh"

namespace {

// One (b, kv head, q head in group, query tile) of a dense causal /
// windowed prefill; attn_tiles.cuh's attend_tile walks its key tiles.
template <class Elem>
struct CausalTile {
  using T = Elem;
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* lse;               // (B, KV, G, Sq) fp32, or nullptr
  size_t q_base, o_base;    // offsets of (b, row 0, this head) in q, out
  size_t lse_base;          // offset of (b, this head, row 0) in lse
  size_t q_stride, o_stride;
  size_t kv_row0;           // row index of (b, slot 0, this kv head)
  int KV;
  int Sq, q0, qa0;          // qa0: absolute position of row q0
  int causal, window;
  int kt_begin, kt_end, n_keys;
  __device__ const T* q_row(int r) const {
    return q0 + r < Sq ? q + q_base + (size_t)(q0 + r) * q_stride : nullptr;
  }
  __device__ T* out_row(int r) const {
    return q0 + r < Sq ? out + o_base + (size_t)(q0 + r) * o_stride : nullptr;
  }
  __device__ float* lse_row(int r) const {
    return lse && q0 + r < Sq ? lse + lse_base + q0 + r : nullptr;
  }
  __device__ size_t key_row(int slot) const {
    return kv_row0 + (size_t)slot * KV;
  }
  __device__ bool allowed(int r, int slot) const {
    const int qa = qa0 + r;
    bool ok = true;
    if (causal) ok = ok && slot <= qa;
    if (window > 0) ok = ok && slot > qa - window;
    return ok;
  }
};

// grid (ceil(Sq / bq), KV * G, B), block (2 bq, NKW)
template <int DQK, int DV, class T, int NKW>
__global__ void __launch_bounds__(attn::kMaxTileThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out,
            float* __restrict__ lse, int Sq, int Sk, int KV, int G,
            int causal, int window, int q_offset, float scale) {
  constexpr int BK = attn::AttnShape<DQK, DV, T, NKW>::BK;
  const int bq = blockDim.x / 2;
  CausalTile<T> t;
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y / G, g = blockIdx.y - (blockIdx.y / G) * G;
  const int b = blockIdx.z;
  t.q = q; t.k = k; t.v = v; t.out = out; t.lse = lse;
  t.q_stride = (size_t)KV * G * DQK;  // between query rows
  t.o_stride = (size_t)KV * G * DV;   // between output rows
  t.q_base = (size_t)b * Sq * t.q_stride + ((size_t)kvh * G + g) * DQK;
  t.o_base = (size_t)b * Sq * t.o_stride + ((size_t)kvh * G + g) * DV;
  t.lse_base = (((size_t)b * KV + kvh) * G + g) * Sq;
  t.kv_row0 = (size_t)b * Sk * KV + kvh;
  t.KV = KV;
  t.Sq = Sq; t.q0 = q0; t.qa0 = q_offset + q0;
  t.causal = causal; t.window = window; t.n_keys = Sk;

  // key tiles holding at least one key some valid row of this tile may see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;         // exclusive
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  // the last row sees no key at all: walk every tile, as the reference does
  const bool row_unseen = window > 0 && q_last - window + 1 >= Sk;
  t.kt_begin = row_unseen ? 0 : k_lo / BK;
  t.kt_end = row_unseen ? (Sk + BK - 1) / BK : (k_hi + BK - 1) / BK;
  attn::attend_tile<DQK, DV, NKW>(t, scale);
}

template <int DQK, int DV, class T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int KV, int G, int causal,
           int window, int q_offset, int rows, float scale, cudaStream_t st) {
  static bool opted[2] = {false, false};   // this library's smem opt-ins
  const dim3 grid((Sq + rows - 1) / rows, KV * G, B);
  return attn::launch_tiles<DQK, DV, T>(
      attn_kernel<DQK, DV, T, 1>, attn_kernel<DQK, DV, T, attn::kTileWarps>,
      opted, grid, rows, st, static_cast<const T*>(q),
      static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, KV, G,
      causal, window, q_offset, scale);
}

}  // namespace

// q (B, Sq, KV, G, dqk); k (B, Sk, KV, dqk); v (B, Sk, KV, dv); out (B, Sq,
// KV, G, dv); all contiguous, 16-byte aligned and of the storage type
// `dtype` (attn::DType); lse: nullptr, or (B, KV, G, Sq) fp32 that gets
// each row's natural log-sum-exp (the backward's saved statistic; serving
// passes nullptr).  window <= 0 means no window.  (dqk, dv) must be
// (32, 32), (64, 64), (128, 128), (256, 256) or (96, 64)
// (kernels/flash_attention.py::HEAD_DIMS); rows (query rows per block) 16
// or 64.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int Sq,
                                     int Sk, int KV, int G, int dqk, int dv,
                                     int causal, int window, int q_offset,
                                     int rows, float scale, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
#define REPRO_ATTN(DQK, DV)                                                  \
  launch<DQK, DV, T>(q, k, v, out, lse, B, Sq, Sk, KV, G, causal, window,    \
                     q_offset, rows, scale, st)
    if (dqk == 96 && dv == 64) return REPRO_ATTN(96, 64);
    if (dqk != dv) return (int)cudaErrorInvalidValue;
    switch (dqk) {
      case 32: return REPRO_ATTN(32, 32);
      case 64: return REPRO_ATTN(64, 64);
      case 128: return REPRO_ATTN(128, 128);
      case 256: return REPRO_ATTN(256, 256);
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_ATTN
  });
}
