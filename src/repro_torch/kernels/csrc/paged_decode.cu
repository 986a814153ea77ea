// Paged flash decoding and paged stacked-query attention ("verify") against
// a paged KV cache read through per-row block tables, for fp32, fp16 and
// bf16 pools (output in the pools' type).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_decode.py:
//  * paged_flash_decode (body _paged_kernel): one query token per
//    (row, kv head, q head in group) against the pool; slots >= lengths[b]
//    masked; normalised output.
//  * paged_flash_verify (body _paged_verify_kernel): W stacked query tokens
//    per row; query w attends slots <= lengths[b] - W + w.  Chunked prefill
//    runs it at W = the chunk width, speculative verify at W = depth + 1.
// Both compute scores q.k * 1/sqrt(dh), masked scores -1e30, an online
// softmax over the keys and acc / max(l, 1e-30), like the Pallas kernels.
//
// Layout (the scheduler's pool, read in place, never densified or laid out
// again): pools (P, page, KV, dh); tables (B, NB) int32 page ids, padded
// with page 0; lengths (B,) int32.  Slot s of row b lives at page
// tables[b, s / page], offset s % page.
//
// What bounds them on the H100:
//  * decode: bytes.  Each gathered K/V row is used by G query heads for
//    2*G*dh flops per 2*dh*sizeof(T) bytes, far below the balance point,
//    so the least time is the valid slots' K/V read at 3.35 TB/s.
//  * verify at the chunked-prefill width (W = 64): bytes at the serving
//    path's shapes (a 64-row query tile against up to 128 slots), turning
//    to operations as the rows grow; its products run on the tensor cores.
//
// What the design does about it:
//  * The Pallas grid walks (b, kv, g, block) and re-reads each K/V page once
//    per q head of the group.  Here a block owns (b, kv head, ...) and reads
//    each gathered slot once for all G query heads (decode, up to 8 per
//    block) or all W*G query rows of its tile (verify).
//  * The TPU pipeline gathers one page per grid step, so a page of 1 token
//    is a 1-row tile.  Here each lane group (decode) or each cp.async copy
//    (verify) resolves its slot's page from the table, whatever the page
//    size.
//  * Slots >= lengths[b] (the tail of the last page, and padded table
//    entries, which point at page 0 -- possibly another request's live page)
//    are never read: the reference's masked slots contribute exact zeros, so
//    skipping them is exact.  Verify walks only up to its tile's largest
//    causal frontier.
//  * Blocks run in parallel, not in grid order: decode splits the slot range
//    across blocks so a small batch still fills the 132 SMs, and the last
//    block of each (row, kv head) merges the splits' (o, m, l) in order
//    inside the same launch, as flash_decode.cu does.
// The bodies are attn_tiles.cuh's decode_kernel (shared with
// flash_decode.cu) and attend_tile (shared with flash_attention.cu); this
// file supplies the block-table addressing and the verify's per-row
// frontier.
//
// Preconditions the wrapper cannot check without a device sync: table
// entries lie in [0, P); decode takes 1 <= lengths[b]; verify takes
// W <= lengths[b].  Lengths above NB * page are clamped to it (no read past
// the table).
#include "attn_tiles.cuh"

namespace {

// Index of slot `slot`'s K/V row for kv head `kvh` in the (P * page * KV,
// dh) pool, through row b's block table `tab`.
__device__ __forceinline__ size_t paged_index(const int* tab, int slot,
                                             int page, int KV, int kvh) {
  const int pid = tab[slot / page];
  return ((size_t)pid * page + (slot % page)) * (size_t)KV + kvh;
}

// Decode: row b walks slots [0, min(lengths[b], NB * page)), all unmasked.
template <class Elem>
struct PagedKV {
  using T = Elem;
  const T* k;
  const T* v;
  const int* tables;    // (B, NB)
  const int* lengths;   // (B,)
  int page, NB, KV, dh;
  __device__ int length(int b) const { return min(lengths[b], NB * page); }
  __device__ size_t row(int b, int s, int kvh) const {
    return paged_index(tables + (size_t)b * NB, s, page, KV, kvh) * dh;
  }
  __device__ bool ok(int, int) const { return true; }
};

// Verify: a tile of bq (w, g) query rows of one (b, kv head); query row r
// is (w, g) = (r / G, r % G), with frontier lengths[b] - W + w.
template <int DH, class Elem>
struct PagedVerifyTile {
  using T = Elem;
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
  __device__ float* lse_row(int) const { return nullptr; }
  __device__ size_t key_row(int slot) const {
    return paged_index(tab, slot, page, KV, kvh);
  }
  __device__ bool allowed(int r, int slot) const {
    return slot <= len - W + (r0 + r) / G;
  }
};

// grid (ceil(W * G / bq), KV, B), block (2 bq, NKW)
template <int DH, class T, int NKW>
__global__ void __launch_bounds__(attn::kMaxTileThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int W, int KV, int G, int page, int NB, float scale) {
  constexpr int BK = attn::AttnShape<DH, DH, T, NKW>::BK;
  const int bq = blockDim.x / 2;
  PagedVerifyTile<DH, T> t;
  const int b = blockIdx.z;
  t.q = q; t.k = kp; t.v = vp; t.out = out;
  t.tab = tables + (size_t)b * NB;
  t.page = page; t.KV = KV; t.G = G; t.W = W; t.b = b; t.kvh = blockIdx.y;
  t.r0 = blockIdx.x * bq; t.rows = W * G; t.len = lengths[b];
  // slots up to the block's largest frontier, never past the table
  const int w_last = (min(t.r0 + bq, t.rows) - 1) / G;
  t.n_keys = min(t.len - W + w_last + 1, NB * page);   // exclusive
  t.kt_begin = 0;
  t.kt_end = t.n_keys > 0 ? (t.n_keys + BK - 1) / BK : 0;
  attn::attend_tile<DH, DH, NKW>(t, scale);
}

template <int DH, class T>
int launch_verify(const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lengths, void* out, int B,
                  int W, int KV, int G, int page, int NB, int rows,
                  float scale, cudaStream_t st) {
  static bool opted[2] = {false, false};   // this library's smem opt-ins
  const dim3 grid((W * G + rows - 1) / rows, KV, B);
  return attn::launch_tiles<DH, DH, T>(
      paged_verify_kernel<DH, T, 1>,
      paged_verify_kernel<DH, T, attn::kTileWarps>, opted, grid, rows, st,
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(out), W,
      KV, G, page, NB, scale);
}

}  // namespace

// q (B, KV, G, dh); k_pages, v_pages (P, page, KV, dh); tables (B, NB) int32;
// lengths (B,) int32; out (B, KV, G, dh); all contiguous; q, the pools and
// out of the storage type `dtype` (attn::DType).  n_split, chunk, work,
// counters and vec as for repro_flash_decode (chunk * n_split >= NB * page).
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const int* tables,
    const int* lengths, void* out, float* work, int* counters, int B, int KV,
    int G, int dh, int page, int NB, int n_split, int chunk, int vec,
    float scale, int dtype, void* stream) {
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const PagedKV<T> src{static_cast<const T*>(kp), static_cast<const T*>(vp),
                         tables, lengths, page, NB, KV, dh};
    return attn::launch_decode(src, static_cast<const T*>(q), out, nullptr,
                               nullptr, work, counters, B, KV, G, dh, n_split,
                               chunk, vec, scale,
                               static_cast<cudaStream_t>(stream));
  });
}

// q, out (B, W, KV, G, dh); pools, tables, lengths as above, q and the pools
// 16-byte aligned.  dh is 32, 64, 128 or 256; rows (query rows per block)
// 16 or 64.
extern "C" int repro_paged_verify(const void* q, const void* kp,
                                  const void* vp, const int* tables,
                                  const int* lengths, void* out, int B, int W,
                                  int KV, int G, int dh, int page, int NB,
                                  int rows, float scale, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    switch (dh) {
      case 32:
        return launch_verify<32, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, rows, scale, st);
      case 64:
        return launch_verify<64, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, rows, scale, st);
      case 128:
        return launch_verify<128, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, rows, scale, st);
      case 256:
        return launch_verify<256, T>(q, kp, vp, tables, lengths, out, B, W, KV, G, page, NB, rows, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}
