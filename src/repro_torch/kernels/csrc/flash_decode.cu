// Flash decoding for one query token per sequence against a dense KV cache,
// in the grouped-query layout, for fp32, fp16 and bf16 caches (fp32
// arithmetic; output in the cache's type, partials in fp32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py ::
// flash_decode_partial / flash_decode (kernel body _decode_kernel).  It
// computes the same function: scores q.k * 1/sqrt(dh), masked scores set to
// -1e30, an online softmax over the keys, and either the unnormalised
// (o, m, l) partials or o / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each key/value row is used by G query
// heads for 2*G*dh flops per 2*dh*sizeof(T) bytes, far below the card's
// balance point, so the least time is the cache read at 3.35 TB/s; at the
// serving path's shapes (4 rows of up to 160 keys) a call is a few
// microseconds of device time, so launches and host time count as much.
//
// What the design does about it (attn_tiles.cuh's decode_kernel):
//  * The Pallas call site broadcasts the grouped cache to G copies before
//    the kernel.  Here the kernel takes q (B, KV, G, dh) and the cache
//    (B, S, KV, dh) directly and reads each K/V row once for up to 8 query
//    heads of its kv head.
//  * A TPU grid runs in order on one core; here blocks run in parallel.  The
//    sequence is split across blocks so that small batches still fill the
//    SMs (kernels/flash_decode.py::splits), and the last block of each
//    (b, kv head) merges the splits' (o, m, l) in split order inside the
//    same launch: one launch per call, normalised or not.
//  * Rows go from device memory straight into registers, 16-byte vectors
//    when dh * sizeof(T) is a multiple of 16 and the bases are aligned
//    (the wrapper checks), several keys in flight per warp, with no shared
//    memory and no __syncthreads in the key loop.
//  * Any S is allowed: keys past S contribute exactly zero (the TPU
//    kernel's S % block_k assertion does not apply); dh up to 256.
//  * MLA's absorbed decode (repro/models/attention.py::mla_decode) attends
//    all its query heads to one virtual KV head whose key row is [c_s,
//    kr_s] (256 + 32) and whose value row is c_s: K wider than V, and wider
//    than the dense layout's 256.  The reference builds concat(c, kr) and
//    runs its jnp decode, since the Pallas kernel needs K and V of one
//    width.  repro_flash_decode_latent reads the latent cache c (B, S, 256)
//    and the rope cache kr (B, S, 32) where they are, through its own lane
//    layout (attn_tiles.cuh's LatentLanes: one read of c serves the score
//    and the value), with no concatenated copy; its 40 heads run as 5
//    blocks of 8 per (b, split), each reading the rows once.  Like the
//    dense entry it returns the normalised output or the unnormalised
//    fp32 (o, m, l) (flash_decode_partial on the latent layout): under a
//    device mesh the latent cache is split by sequence over the model
//    ranks, each rank takes the partials of its slots, and the ranks
//    merge them (repro/models/attention.py::flash_decode under a ctx).
// This file supplies the dense and the latent caches' addressing and valid
// mask.
#include "attn_tiles.cuh"

namespace {

// Slot s of row b at (B, S, KV, dh).
template <class Elem>
struct DenseKV {
  using T = Elem;
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

// Slot s of row b in MLA's latent cache: c (B, S, 256), kr (B, S, 32).
template <class Elem>
struct LatentKV {
  using T = Elem;
  const T* c;
  const T* kr;
  const uint8_t* valid;   // (B, S)
  int S;
  __device__ int length(int) const { return S; }
  __device__ bool ok(int b, int s) const { return valid[(size_t)b * S + s]; }
};

}  // namespace

// q (B, KV, G, dh); k, v (B, S, KV, dh); valid (B, S) bytes, all contiguous;
// q, k, v of the storage type `dtype` (attn::DType).  out_o (B, KV, G, dh)
// of that type when out_m and out_l are both NULL (normalise), else fp32
// unnormalised o with fp32 m, l (B, KV, G).  n_split splits of `chunk` keys
// (a multiple of attn::kDecWarps, chunk * n_split >= S); with n_split > 1,
// work holds n_split * B * KV * G * (dh + 2) floats and counters
// B * KV * ceil(G / GT) zeroed ints (left zeroed).  vec: see
// attn::launch_decode.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const uint8_t* valid,
    void* out_o, float* out_m, float* out_l, float* work, int* counters,
    int B, int S, int KV, int G, int dh, int n_split, int chunk, int vec,
    float scale, int dtype, void* stream) {
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const DenseKV<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                         valid, S, KV, dh};
    return attn::launch_decode(src, static_cast<const T*>(q), out_o, out_m,
                               out_l, work, counters, B, KV, G, dh, n_split,
                               chunk, vec, scale,
                               static_cast<cudaStream_t>(stream));
  });
}

// q (B, 1, G, 288); c (B, S, 256); kr (B, S, 32); valid (B, S) bytes; all
// contiguous, q, c and kr of the storage type `dtype` and 16-byte aligned.
// out_o (B, 1, G, 256) of that type, normalised, when out_m and out_l are
// both NULL; else fp32 unnormalised o with fp32 m, l (B, 1, G) over the S
// slots given (the partials a sequence-sharded cache's ranks merge).
// n_split, chunk, work and counters as for repro_flash_decode at KV = 1,
// dh = 256.
extern "C" int repro_flash_decode_latent(
    const void* q, const void* c, const void* kr, const uint8_t* valid,
    void* out_o, float* out_m, float* out_l, float* work, int* counters,
    int B, int S, int G, int n_split, int chunk, float scale, int dtype,
    void* stream) {
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const LatentKV<T> src{static_cast<const T*>(c), static_cast<const T*>(kr),
                          valid, S};
    return attn::launch_latent_decode(src, static_cast<const T*>(q), out_o,
                                      out_m, out_l, work, counters, B, G,
                                      n_split, chunk, scale,
                                      static_cast<cudaStream_t>(stream));
  });
}
