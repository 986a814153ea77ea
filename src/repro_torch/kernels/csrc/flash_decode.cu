// Flash decoding for one query token per sequence against a dense KV cache,
// in the grouped-query layout, for fp32, fp16 and bf16 caches (fp32
// arithmetic; output in the cache's type, partials in fp32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py ::
// flash_decode_partial / flash_decode (kernel body _decode_kernel).  It
// computes the same function: scores q.k * 1/sqrt(dh), masked scores set to
// -1e30, an online softmax over key tiles, and either the unnormalised
// (o, m, l) partials or o / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each key/value row is used by G query
// heads for 2*G*dh flops per 2*dh*sizeof(T) bytes, far below the card's
// ~20 flop/byte fp32 balance point, so the least time is the cache read at
// 3.35 TB/s.
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
// The tile body is attn_tiles.cuh's decode_kernel, shared with the paged
// decode; this file supplies the dense cache's addressing and valid mask.
// Loads are plain coalesced reads converted to fp32 in registers and the
// dot products run on the CUDA cores; a TMA/cp.async pipeline is later work.
#include "attn_tiles.cuh"

namespace {

// Slot s of row b at (B, S, KV, dh); any dh, so scalar loads.
template <class Elem>
struct DenseKV {
  using T = Elem;
  static constexpr bool kVec4 = false;
  const T* k;
  const T* v;
  const uint8_t* valid;   // (B, S)
  int S, KV, dh;
  __device__ int length(int) const { return S; }
  __device__ size_t row(int b, int s, int kvh) const {
    return ((size_t)b * S + s) * KV * dh + (size_t)kvh * dh;
  }
  __device__ bool ok(int b, int s) const { return valid[(size_t)b * S + s]; }
};

}  // namespace

// q (B, KV, G, dh); k, v (B, S, KV, dh); valid (B, S) bytes, all contiguous;
// q, k, v of the storage type `dtype` (attn::DType).  out_o (B, KV, G, dh)
// of that type when out_m and out_l are both NULL (normalise), else fp32
// unnormalised o with fp32 m, l (B, KV, G).  With n_split > 1,
// part_o/m/l hold fp32 (n_split, B, KV, G[, dh]) partials.  chunk: keys
// per split (a multiple of the tile, chunk * n_split >= S).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const uint8_t* valid,
    float* part_o, float* part_m, float* part_l, void* out_o, float* out_m,
    float* out_l, int B, int S, int KV, int G, int dh, int n_split, int chunk,
    float scale, int dtype, void* stream) {
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const DenseKV<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                         valid, S, KV, dh};
    return attn::launch_decode(src, static_cast<const T*>(q), part_o, part_m,
                               part_l, out_o, out_m, out_l, B, KV, G, dh,
                               n_split, chunk, scale,
                               static_cast<cudaStream_t>(stream));
  });
}
