// Backward of the prefill flash attention (flash_attention.cu), in the
// grouped-query layout, for fp32, fp16 and bf16 inputs (gradients in the
// inputs' type), at every (q / k, v) head-dim pair flash_attention.cu takes:
// (32, 32), (64, 64), (128, 128), (256, 256) and MLA's (96, 64).
//
// Replaces no Pallas kernel: the JAX package trains through a custom VJP in
// jnp, src/repro/models/attention.py :: _flash_fn (its f_bwd).  It computes
// the same recompute backward from the forward's saved (q, k, v, out, lse):
//   qs = q / sqrt(dqk);  delta = rowsum(d_out * out)
//   P  = exp(qs k^T - lse)          (masked keys weigh 0)
//   dP = d_out v^T;  dS = P * (dP - delta)
//   dq = dS k / sqrt(dqk);  dk = dS^T qs;  dv = P^T d_out
// with the forward's causal / window masks, and GQA's sum over the G query
// heads of a KV head folded into dk and dv.
//
// What bounds it on the H100: operations.  A call does the work of five
// attention-sized matrix products (S and dP in both kernels' recompute,
// then dq, dk, dv), 2 (3 dqk + 2 dv) flops per unmasked query-key pair,
// against bytes that grow with the sequence only linearly.
//
// What the design does about it: this first version is simple and exact,
// not fast.  Its products run on the CUDA cores in plain fp32 FMA (no
// tensor cores, no 3xTF32), every input converted to fp32 as it lands in
// shared memory, and accumulated in fp32.  wgmma / TMA tiles are later work.
//  * bwd_dq_kernel: one block per (b, query head, tile of ROWS query rows).
//    It computes delta for its rows (written to a workspace the second
//    kernel reads), then walks the key tiles the forward walks (tiles wholly
//    above the causal diagonal or outside the window skipped), recomputing P
//    and dS for its rows and accumulating dq in registers.
//  * bwd_dkv_kernel: one block per (b, KV head, tile of ROWS keys).  It
//    walks the G query heads of its group and, for each, the query tiles
//    that can see one of its keys, accumulating dk and dv in registers, so
//    the sum over G and over query tiles is done inside the block.
//  Neither kernel uses atomics: every gradient element is written once by
//  the block that owns it, in the same order on every call.
//  * A thread owns one row of its block's tile and D / TPR of its columns
//    (TPR = 4 threads per row, 8 when a head is 256 wide), so the dq, dk and
//    dv accumulators stay in registers; tiles sit in shared memory with rows
//    padded by one word so a warp's reads spread over the 32 banks.
// A row that no key may attend (a window past Sk) is outside its domain:
// the launcher refuses such calls (training never makes one).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

using namespace elem;

constexpr int kThreads = 128;
constexpr int kCols = 32;          // rows of the other tile per step
constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV>
struct BwdShape {
  static constexpr int TPR = (DQK > 128 || DV > 128) ? 8 : 4;  // threads/row
  static constexpr int ROWS = kThreads / TPR;                   // own rows
  static constexpr int NQ = DQK / TPR, NV = DV / TPR;           // cols/thread
  static constexpr int NS = kCols / TPR;        // score entries per thread
  static constexpr int QLD = DQK + 1, VLD = DV + 1, SLD = kCols + 1;
  // own tiles (ROWS rows of q and of d_out, or of k and v), the other
  // tiles (kCols rows), and the (ROWS x kCols) P / dS exchange, as fp32
  static constexpr size_t smem() {
    return sizeof(float) * ((size_t)ROWS * (QLD + VLD) +
                            (size_t)kCols * (QLD + VLD) + 2 * ROWS * SLD);
  }
  static_assert(DQK % TPR == 0 && DV % TPR == 0, "head dims");
  static_assert(kCols % TPR == 0, "score columns");
};

struct Geo {
  int Sq, Sk, KV, G, causal, window, q_offset;
  __device__ bool allowed(int r, int c) const {   // r: local query row
    const int qa = q_offset + r;
    bool ok = c < Sk && r < Sq;
    if (causal) ok = ok && c <= qa;
    if (window > 0) ok = ok && c > qa - window;
    return ok;
  }
};

// rows [r0, r0 + n) of a (.., D)-row tensor into s (row stride LD), as
// fp32; `row(i)` gives row i's element offset, rows past `valid` read 0
template <int D, int LD, class T, class Row>
__device__ __forceinline__ void load_rows(float* s, const T* __restrict__ g,
                                          int n, int valid, Row row,
                                          float mul = 1.f) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    s[r * LD + d] = r < valid ? ld(g + row(r) + d) * mul : 0.f;
  }
}

// grid (ceil(Sq / ROWS), KV * G, B).  dq (B, Sq, KV, G, DQK); delta
// (B, KV, G, Sq) fp32, written here for bwd_dkv_kernel.
template <int DQK, int DV, class T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ out,
              const T* __restrict__ dout, const float* __restrict__ lse,
              T* __restrict__ dq, float* __restrict__ delta, Geo geo,
              float scale) {
  using S = BwdShape<DQK, DV>;
  constexpr int TPR = S::TPR, ROWS = S::ROWS, QLD = S::QLD, VLD = S::VLD;
  constexpr int SLD = S::SLD;
  extern __shared__ float smem[];
  float* qs = smem;                     // [ROWS][QLD], q * scale
  float* dos = qs + ROWS * QLD;         // [ROWS][VLD]
  float* ks = dos + ROWS * VLD;         // [kCols][QLD]
  float* vs = ks + kCols * QLD;         // [kCols][VLD]
  float* ds = vs + kCols * VLD;         // [ROWS][SLD]
  float* stat = ds + ROWS * SLD;        // lse * log2e, delta: [ROWS] each

  const int Sq = geo.Sq, Sk = geo.Sk, KV = geo.KV, G = geo.G;
  const int q0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y / G, g = blockIdx.y - kvh * G;
  const int b = blockIdx.z;
  const int row = threadIdx.x / TPR, sub = threadIdx.x - row * TPR;
  const int nrows = min(ROWS, Sq - q0);
  auto qrow = [&](int r) {   // element offset of query row q0 + r / DQK
    return ((((size_t)b * Sq + q0 + r) * KV + kvh) * G + g);
  };
  auto krow = [&](int c) { return ((size_t)b * Sk + c) * KV + kvh; };
  const size_t stat0 = (((size_t)b * KV + kvh) * G + g) * Sq + q0;

  load_rows<DQK, QLD>(qs, q, ROWS, nrows,
                      [&](int r) { return qrow(r) * DQK; }, scale);
  load_rows<DV, VLD>(dos, dout, ROWS, nrows,
                     [&](int r) { return qrow(r) * DV; });
  __syncthreads();
  // delta = rowsum(d_out * out) for this block's rows (TPR threads a row)
  {
    float acc = 0.f;
    if (row < nrows) {
      const T* o = out + qrow(row) * DV;
      for (int d = sub; d < DV; d += TPR) acc = fmaf(ld(o + d), dos[row * VLD + d], acc);
    }
#pragma unroll
    for (int x = 1; x < TPR; x <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (sub == 0) {
      stat[ROWS + row] = acc;
      stat[row] = row < nrows ? lse[stat0 + row] * kLog2e : 0.f;
      if (row < nrows) delta[stat0 + row] = acc;
    }
  }

  // key tiles holding a key one of these rows may see (as the forward)
  const int q_first = geo.q_offset + q0, q_last = q_first + nrows - 1;
  const int k_hi = geo.causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = geo.window > 0 ? max(0, q_first - geo.window + 1) : 0;

  float acc[S::NQ];
#pragma unroll
  for (int j = 0; j < S::NQ; ++j) acc[j] = 0.f;

  for (int c0 = (k_lo / kCols) * kCols; c0 < k_hi; c0 += kCols) {
    const int nk = min(kCols, Sk - c0);
    __syncthreads();   // the previous tile's ks / vs / ds are consumed
    load_rows<DQK, QLD>(ks, k, kCols, nk,
                        [&](int c) { return krow(c0 + c) * DQK; });
    load_rows<DV, VLD>(vs, v, kCols, nk,
                       [&](int c) { return krow(c0 + c) * DV; });
    __syncthreads();
    const float l2 = stat[row], dl = stat[ROWS + row];
#pragma unroll
    for (int j = 0; j < S::NS; ++j) {
      const int c = sub + TPR * j;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DQK; ++d) s = fmaf(qs[row * QLD + d], ks[c * QLD + d], s);
      for (int d = 0; d < DV; ++d) dp = fmaf(dos[row * VLD + d], vs[c * VLD + d], dp);
      const float p = geo.allowed(q0 + row, c0 + c) ? exp2f(s * kLog2e - l2) : 0.f;
      ds[row * SLD + c] = p * (dp - dl);
    }
    __syncthreads();
    for (int c = 0; c < kCols; ++c) {
      const float w = ds[row * SLD + c];
#pragma unroll
      for (int j = 0; j < S::NQ; ++j)
        acc[j] = fmaf(w, ks[c * QLD + sub + TPR * j], acc[j]);
    }
  }
  if (row < nrows) {
    T* o = dq + qrow(row) * DQK;
#pragma unroll
    for (int j = 0; j < S::NQ; ++j) o[sub + TPR * j] = from_f32<T>(acc[j] * scale);
  }
}

// grid (ceil(Sk / ROWS), KV, B).  dk (B, Sk, KV, DQK), dv (B, Sk, KV, DV).
template <int DQK, int DV, class T>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, Geo geo, float scale) {
  using S = BwdShape<DQK, DV>;
  constexpr int TPR = S::TPR, ROWS = S::ROWS, QLD = S::QLD, VLD = S::VLD;
  constexpr int SLD = S::SLD;
  extern __shared__ float smem[];
  float* ks = smem;                     // [ROWS][QLD]
  float* vs = ks + ROWS * QLD;          // [ROWS][VLD]
  float* qs = vs + ROWS * VLD;          // [kCols][QLD], q * scale
  float* dos = qs + kCols * QLD;        // [kCols][VLD]
  float* pt = dos + kCols * VLD;        // [ROWS][SLD]: P^T
  float* dst = pt + ROWS * SLD;         // [ROWS][SLD]: dS^T
  __shared__ float st_l[kCols], st_d[kCols];   // lse * log2e, delta

  const int Sq = geo.Sq, Sk = geo.Sk, KV = geo.KV, G = geo.G;
  const int c0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int row = threadIdx.x / TPR, sub = threadIdx.x - row * TPR;
  const int nk = min(ROWS, Sk - c0);
  auto krow = [&](int c) { return ((size_t)b * Sk + c0 + c) * KV + kvh; };

  load_rows<DQK, QLD>(ks, k, ROWS, nk, [&](int c) { return krow(c) * DQK; });
  load_rows<DV, VLD>(vs, v, ROWS, nk, [&](int c) { return krow(c) * DV; });

  // query rows that may see a key of this tile
  const int c_last = c0 + nk - 1;
  const int r_lo = geo.causal ? max(0, c0 - geo.q_offset) : 0;
  const int r_hi = geo.window > 0
                       ? min(Sq, c_last + geo.window - geo.q_offset)
                       : Sq;                                  // exclusive

  float ak[S::NQ], av[S::NV];
#pragma unroll
  for (int j = 0; j < S::NQ; ++j) ak[j] = 0.f;
#pragma unroll
  for (int j = 0; j < S::NV; ++j) av[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    auto qrow = [&](int r) {
      return (((size_t)b * Sq + r) * KV + kvh) * G + g;
    };
    const size_t stat0 = (((size_t)b * KV + kvh) * G + g) * Sq;
    for (int r0 = (r_lo / kCols) * kCols; r0 < r_hi; r0 += kCols) {
      const int nr = min(kCols, Sq - r0);
      __syncthreads();   // the previous tile's qs / dos / pt / dst consumed
      load_rows<DQK, QLD>(qs, q, kCols, nr,
                          [&](int r) { return qrow(r0 + r) * DQK; }, scale);
      load_rows<DV, VLD>(dos, dout, kCols, nr,
                         [&](int r) { return qrow(r0 + r) * DV; });
      if (threadIdx.x < kCols) {
        const int r = threadIdx.x;
        st_l[r] = r < nr ? lse[stat0 + r0 + r] * kLog2e : 0.f;
        st_d[r] = r < nr ? delta[stat0 + r0 + r] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < S::NS; ++j) {
        const int r = sub + TPR * j;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < DQK; ++d) s = fmaf(ks[row * QLD + d], qs[r * QLD + d], s);
        for (int d = 0; d < DV; ++d) dp = fmaf(vs[row * VLD + d], dos[r * VLD + d], dp);
        const float p = (row < nk && geo.allowed(r0 + r, c0 + row))
                            ? exp2f(s * kLog2e - st_l[r]) : 0.f;
        pt[row * SLD + r] = p;
        dst[row * SLD + r] = p * (dp - st_d[r]);
      }
      __syncthreads();
      for (int r = 0; r < kCols; ++r) {
        const float p = pt[row * SLD + r], w = dst[row * SLD + r];
#pragma unroll
        for (int j = 0; j < S::NV; ++j)
          av[j] = fmaf(p, dos[r * VLD + sub + TPR * j], av[j]);
#pragma unroll
        for (int j = 0; j < S::NQ; ++j)
          ak[j] = fmaf(w, qs[r * QLD + sub + TPR * j], ak[j]);
      }
    }
  }
  if (row < nk) {
    T* ok = dk + krow(row) * DQK;
    T* ov = dv + krow(row) * DV;
#pragma unroll
    for (int j = 0; j < S::NQ; ++j) ok[sub + TPR * j] = from_f32<T>(ak[j]);
#pragma unroll
    for (int j = 0; j < S::NV; ++j) ov[sub + TPR * j] = from_f32<T>(av[j]);
  }
}

template <class K>
int opt_in(K kernel, bool& opted, size_t bytes) {
  if (opted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  opted = true;
  return 0;
}

template <int DQK, int DV, class T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, Geo geo, float scale, cudaStream_t st) {
  using S = BwdShape<DQK, DV>;
  static bool opted[2] = {false, false};   // this library's smem opt-ins
  const size_t smem_q = S::smem() + 2 * S::ROWS * sizeof(float);
  const size_t smem_kv = S::smem();
  auto kq = bwd_dq_kernel<DQK, DV, T>;
  auto kkv = bwd_dkv_kernel<DQK, DV, T>;
  int err = opt_in(kq, opted[0], smem_q);
  if (!err) err = opt_in(kkv, opted[1], smem_kv);
  if (err) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  kq<<<dim3((geo.Sq + S::ROWS - 1) / S::ROWS, geo.KV * geo.G, B), kThreads,
       smem_q, st>>>(qt, kt, vt, static_cast<const T*>(out),
                     static_cast<const T*>(dout), lse, static_cast<T*>(dq),
                     delta, geo, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  kkv<<<dim3((geo.Sk + S::ROWS - 1) / S::ROWS, geo.KV, B), kThreads,
        smem_kv, st>>>(qt, kt, vt, static_cast<const T*>(dout), lse, delta,
                       static_cast<T*>(dk), static_cast<T*>(dv), geo, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV, G, dqk), out / dout (B, Sq, KV, G, dv), k (B, Sk, KV, dqk),
// v (B, Sk, KV, dv) of the storage type `dtype` (elem::DType); lse (B, KV,
// G, Sq) fp32 (natural log, the forward's m + log l); dq, dk, dv shaped as
// q, k, v; delta: a (B, KV, G, Sq) fp32 workspace.  All contiguous.
// window <= 0 means no window; every query row must see a key.  (dqk, dv)
// as repro_flash_attention takes them.  Two launches; returns the CUDA
// error (0 = none).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int B, int Sq, int Sk, int KV, int G, int dqk, int dvd,
    int causal, int window, int q_offset, float scale, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo{Sq, Sk, KV, G, causal, window, q_offset};
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
#define REPRO_BWD(DQK, DV)                                                  \
  launch<DQK, DV, T>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, geo,    \
                     scale, st)
    if (dqk == 96 && dvd == 64) return REPRO_BWD(96, 64);
    if (dqk != dvd) return (int)cudaErrorInvalidValue;
    switch (dqk) {
      case 32: return REPRO_BWD(32, 32);
      case 64: return REPRO_BWD(64, 64);
      case 128: return REPRO_BWD(128, 128);
      case 256: return REPRO_BWD(256, 256);
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_BWD
  });
}
