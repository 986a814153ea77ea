// Paged flash decoding and paged stacked-query attention ("verify") against
// a paged KV cache read through per-row block tables, for fp32, fp16 and
// bf16 pools (fp32 arithmetic, output in the pools' type).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_decode.py:
//  * paged_flash_decode (body _paged_kernel): one query token per
//    (row, kv head, q head in group) against the pool; slots >= lengths[b]
//    masked; normalised output.
//  * paged_flash_verify (body _paged_verify_kernel): W stacked query tokens
//    per row; query w attends slots <= lengths[b] - W + w.  Chunked prefill
//    runs it at W = the chunk width, speculative verify at W = depth + 1.
// Both compute scores q.k * 1/sqrt(dh), masked scores -1e30, an online
// softmax over key tiles and acc / max(l, 1e-30), like the Pallas kernels.
//
// Layout (the scheduler's pool, read in place, never densified or laid out
// again): pools (P, page, KV, dh); tables (B, NB) int32 page ids, padded
// with page 0; lengths (B,) int32.  Slot s of row b lives at page
// tables[b, s / page], offset s % page.
//
// What bounds them on the H100:
//  * decode: bytes.  Each gathered K/V row is used by G query heads for
//    2*G*dh flops per 2*dh*sizeof(T) bytes, far below the fp32 balance
//    point, so the least time is the valid slots' K/V read at 3.35 TB/s.
//  * verify at the chunked-prefill width (W = 64): operations.  A 64-row
//    query tile reuses each gathered K/V row 64 times; it runs in full fp32
//    on the CUDA cores (67 TFLOP/s), as flash_attention.cu does.
//
// What the design does about it:
//  * The Pallas grid walks (b, kv, g, block) and re-reads each K/V page once
//    per q head of the group.  Here a block owns (b, kv head, ...) and reads
//    each gathered slot once for all G query heads (decode) or all W*G query
//    rows of its tile (verify).
//  * The TPU pipeline gathers one page per grid step, so a page of 1 token
//    is a 1-row tile.  Here slots are gathered into 64-slot shared-memory
//    tiles whatever the page size: each thread resolves its slot's page from
//    the table, and loads are 4-element vectors (dh % 4 == 0), converted to
//    fp32 in registers.
//  * Slots >= lengths[b] (the tail of the last page, and padded table
//    entries, which point at page 0 — possibly another request's live page)
//    are never read: the reference's masked slots contribute exact zeros, so
//    skipping them is exact.  Verify walks only up to its tile's largest
//    causal frontier.
//  * Blocks run in parallel, not in grid order: decode splits the slot range
//    across blocks so a small batch still fills the 132 SMs, and a second
//    small kernel merges the per-split (o, m, l) as flash_decode.cu does.
// The tile bodies are attn_tiles.cuh's, shared with flash_decode.cu (decode)
// and flash_attention.cu (verify); this file supplies the block-table
// addressing and the verify's per-row frontier.  Loads are plain coalesced
// reads and the products run on the CUDA cores; a TMA / wgmma pipeline is
// later work.
//
// Preconditions the wrapper cannot check without a device sync: table
// entries lie in [0, P); decode takes 1 <= lengths[b]; verify takes
// W <= lengths[b].  Lengths above NB * page are clamped to it (no read past
// the table).
#include "attn_tiles.cuh"

namespace {

// Offset (in elements) of slot `slot`'s K/V row for kv head `kvh`, through
// row b's block table `tab`.
__device__ __forceinline__ size_t paged_row(const int* tab, int slot,
                                           int page, int KV, int dh,
                                           int kvh) {
  const int pid = tab[slot / page];
  return ((size_t)pid * page + (slot % page)) * (size_t)KV * dh +
         (size_t)kvh * dh;
}

// Decode: row b walks slots [0, min(lengths[b], NB * page)), all unmasked.
template <class Elem>
struct PagedKV {
  using T = Elem;
  static constexpr bool kVec4 = true;
  const T* k;
  const T* v;
  const int* tables;    // (B, NB)
  const int* lengths;   // (B,)
  int page, NB, KV, dh;
  __device__ int length(int b) const { return min(lengths[b], NB * page); }
  __device__ size_t row(int b, int s, int kvh) const {
    return paged_row(tables + (size_t)b * NB, s, page, KV, dh, kvh);
  }
  __device__ bool ok(int, int) const { return true; }
};

// Verify: a tile of 64 (w, g) query rows of one (b, kv head); query row r
// is (w, g) = (r / G, r % G), with frontier lengths[b] - W + w.
template <int DH, class Elem>
struct PagedVerifyTile {
  using T = Elem;
  static constexpr bool kVec4 = true;
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* tab;       // row b's block table
  int page, KV, G, W, b, kvh, r0, rows, len;
  int kt_begin, kt_end, n_keys;
  // q / out index of query row r: ((b * W + w) * KV + kvh) * G + g
  __device__ size_t index(int r) const {
    const int w = r / G, g = r - (r / G) * G;
    return ((((size_t)b * W + w) * KV + kvh) * G + g) * DH;
  }
  __device__ const T* q_row(int r) const {
    return r0 + r < rows ? q + index(r0 + r) : nullptr;
  }
  __device__ T* out_row(int r) const {
    return r0 + r < rows ? out + index(r0 + r) : nullptr;
  }
  __device__ size_t key_row(int slot) const {
    return paged_row(tab, slot, page, KV, DH, kvh);
  }
  __device__ bool allowed(int r, int slot) const {
    return slot <= len - W + (r0 + r) / G;
  }
};

// grid (ceil(W * G / 64), KV, B)
template <int DH, class T>
__global__ void __launch_bounds__(attn::kTileThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int W, int KV, int G, int page, int NB, float scale) {
  PagedVerifyTile<DH, T> t;
  const int b = blockIdx.z;
  t.q = q; t.k = kp; t.v = vp; t.out = out;
  t.tab = tables + (size_t)b * NB;
  t.page = page; t.KV = KV; t.G = G; t.W = W; t.b = b; t.kvh = blockIdx.y;
  t.r0 = blockIdx.x * attn::kBQ; t.rows = W * G; t.len = lengths[b];
  // slots up to the block's largest frontier, never past the table
  const int w_last = (min(t.r0 + attn::kBQ, t.rows) - 1) / G;
  t.n_keys = min(t.len - W + w_last + 1, NB * page);   // exclusive
  t.kt_begin = 0;
  t.kt_end = t.n_keys > 0 ? (t.n_keys + attn::kBK - 1) / attn::kBK : 0;
  attn::attend_tile<DH>(t, scale);
}

template <int DH, class T>
int launch_verify(const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lengths, void* out, int B,
                  int W, int KV, int G, int page, int NB, float scale,
                  cudaStream_t st) {
  const dim3 grid((W * G + attn::kBQ - 1) / attn::kBQ, KV, B);
  return attn::launch_tiles<DH>(
      paged_verify_kernel<DH, T>, grid, st, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp), tables, lengths,
      static_cast<T*>(out), W, KV, G, page, NB, scale);
}

}  // namespace

// q (B, KV, G, dh); k_pages, v_pages (P, page, KV, dh); tables (B, NB) int32;
// lengths (B,) int32; out (B, KV, G, dh); all contiguous, dh % 4 == 0; q,
// the pools and out of the storage type `dtype` (attn::DType).  With
// n_split > 1, part_o/m/l hold fp32 (n_split, B, KV, G[, dh]) partials.
// chunk: slots per split (a multiple of the tile, chunk * n_split >=
// NB * page).
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const int* tables,
    const int* lengths, float* part_o, float* part_m, float* part_l,
    void* out, int B, int KV, int G, int dh, int page, int NB, int n_split,
    int chunk, float scale, int dtype, void* stream) {
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const PagedKV<T> src{static_cast<const T*>(kp), static_cast<const T*>(vp),
                         tables, lengths, page, NB, KV, dh};
    return attn::launch_decode(src, static_cast<const T*>(q), part_o, part_m,
                               part_l, out, nullptr, nullptr, B, KV, G, dh,
                               n_split, chunk, scale,
                               static_cast<cudaStream_t>(stream));
  });
}

// q, out (B, W, KV, G, dh); pools, tables, lengths as above.  dh is 32, 64,
// 128 or 256.
extern "C" int repro_paged_verify(const void* q, const void* kp,
                                  const void* vp, const int* tables,
                                  const int* lengths, void* out, int B, int W,
                                  int KV, int G, int dh, int page, int NB,
                                  float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    switch (dh) {
      case 32:
        return launch_verify<32, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, scale, st);
      case 64:
        return launch_verify<64, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, scale, st);
      case 128:
        return launch_verify<128, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, scale, st);
      case 256:
        return launch_verify<256, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}
