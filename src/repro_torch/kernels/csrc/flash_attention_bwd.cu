// Backward of the prefill flash attention (flash_attention.cu), in the
// grouped-query layout, for fp32, fp16 and bf16 inputs (gradients in the
// inputs' type), at every (q / k, v) head-dim pair flash_attention.cu takes:
// (32, 32), (64, 64), (128, 128), (256, 256) and MLA's (96, 64).
//
// Replaces no Pallas kernel: the JAX package trains through a custom VJP in
// jnp, src/repro/models/attention.py :: _flash_fn (its f_bwd).  It computes
// the same recompute backward from the forward's saved (q, k, v, out, lse):
//   delta = rowsum(d_out * out)
//   P  = exp(scale q k^T - lse)     (masked keys weigh 0)
//   dP = d_out v^T;  dS = P * (dP - delta)
//   dq = scale dS k;  dk = scale dS^T q;  dv = P^T d_out
// with the forward's causal / window masks, and GQA's sum over the G query
// heads of a KV head folded into dk and dv.
//
// What bounds it on the H100: operations at training lengths.  Five
// attention-sized matrix products (S, dP, dv, dk, dq), 2 (3 dqk + 2 dv)
// flops per unmasked query-key pair, against bytes that grow with the
// sequence only linearly; at short prefills (32 rows) the call is a few
// microseconds of latency.
//
// What the design does about it (FlashAttention-2's backward on mma.sync):
//  * Three launches: bwd_prep_kernel writes delta (fp32, (B, KV, G, Sq))
//    and zeroes an fp32 dq workspace; bwd_kernel does the products;
//    bwd_finish_kernel scales dq into the inputs' type and, where the grid
//    slices a key tile's work, sums dk / dv's fp32 partials over the
//    slices in slice order.
//  * bwd_kernel: one block per (tile of BKEY keys, KV head, slice, b).  A
//    key tile's work is its G query heads times the query tiles (BQ rows)
//    that can see one of its keys (causal, window and q_offset as the
//    forward); the slices cut that sequence of (head, query tile) steps
//    into equal runs, as many as the host plans
//    (kernels/flash_attention_bwd.py::plan) so that the grid reaches the
//    132 SMs at GQA shapes and short sequences.  Each warp owns 16 of the
//    block's keys.  K and V tiles land in shared memory once, in their
//    storage type; the block walks its run, staging q, d_out, lse and
//    delta through a 2-stage cp.async ring, the next tile in flight while
//    this one computes.  Per query tile, on the tensor cores:
//      S^T = K Q^T and dP^T = V dO^T, each once, in registers (the
//        forward's fragment layout with keys as the rows);
//      P^T = exp2(S^T scale log2e - lse log2e); dS^T = P^T (dP^T - delta);
//      dV += P^T dO and dK += dS^T Q, P^T and dS^T used in registers as
//        the A fragments (as the forward uses P for P V);
//      dS goes to shared memory, and dQ (BQ x dqk) += dS K, split over
//        the warps, is added to the fp32 workspace by atomicAdd.
//    So S and dP are computed once per (query tile, key tile) pair: five
//    products, where PR 25's two kernels recomputed both in each (seven).
//  * fp16 / bf16: m16n8k16 with fp32 accumulators, P and dS rounded to the
//    input type before their products, as the forward rounds P.  fp32:
//    3xTF32 (m16n8k8, a = hi + lo, acc += al bh + ah bl + ah bh), as the
//    forward, which keeps the fp32 tolerance of 1e-4.
//  * dK and dV accumulate in registers, except at head dim 256 (two 256-
//    wide fp32 accumulators would not fit a thread's 255 registers): there
//    they accumulate in fp32 shared memory, each warp on its own rows, 64
//    columns at a time, with 32-key blocks of two warps.  The query tile is
//    64 rows for 16-bit heads up to 64 wide, else 32, and 32 / 16 in fp32,
//    so that a thread's fragments stay within its registers.
//  * Determinism: dq's atomics add the key tiles' contributions in the
//    order the blocks reach them, so dq may differ in its last bits from
//    call to call (within the stated tolerances); dk and dv are written by
//    the block that owns their keys, or summed in slice order, and are the
//    same on every call.
//  * wgmma / TMA are later work; the tile body keeps the forward's fragment
//    layout so that both move together.
// A row that no key may attend (a window past Sk) is outside its domain:
// the launcher refuses such calls (training never makes one).
#include "attn_tiles.cuh"

namespace {

using namespace elem;
using namespace tc;
using attn::pack2;
using attn::store2;

constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV, class T>
struct BwdShape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // head dim 256: dK / dV accumulate in fp32 shared memory
  static constexpr bool kAccSmem = DQK + DV > 256;
  static constexpr int BKEY = kAccSmem ? 32 : 64;      // launcher: key_rows
  static constexpr int NW = BKEY / 16;                 // warps, 16 keys each
  static constexpr int kThreads = 32 * NW;
  static constexpr int BQ = kF32 ? (DQK + DV > 160 ? 16 : 32)
                                 : (DQK + DV > 128 ? 32 : 64);
  static constexpr int CH = 16 / (int)sizeof(T);       // elements per cp.async
  // padded rows (elements): a fragment read's 8 rows x 4 words spread over
  // the banks (fp32 column reads meet 2-way conflicts)
  static constexpr int KLD = DQK + 8, VLD = DV + 8;
  static constexpr int QLD = DQK + 8, OLD = DV + 8;
  static constexpr int DSLD = BKEY + 8;
  static constexpr int KLDA = DQK + 8, VLDA = DV + 8;  // fp32 accumulators
  // byte offsets in shared memory
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = K_OFF + sizeof(T) * BKEY * KLD;
  static constexpr size_t ST_OFF = V_OFF + sizeof(T) * BKEY * VLD;
  static constexpr size_t ST_Q = 0;
  static constexpr size_t ST_O = ST_Q + sizeof(T) * BQ * QLD;
  static constexpr size_t ST_L = ST_O + sizeof(T) * BQ * OLD;
  static constexpr size_t ST_D = ST_L + sizeof(float) * BQ;
  static constexpr size_t STAGE = ST_D + sizeof(float) * BQ;
  static constexpr size_t DS_OFF = ST_OFF + 2 * STAGE;
  static constexpr size_t ACC_OFF = DS_OFF + sizeof(T) * BQ * DSLD;
  static constexpr size_t SMEM =
      ACC_OFF + (kAccSmem ? sizeof(float) * BKEY * (KLDA + VLDA) : 0);
  // dQ units: (BQ / 16 row groups) x (column parts of NQT n8 tiles, at
  // most 64 columns), at least one per warp where the columns divide
  static constexpr int nqt() {
    int n = DQK / 8;
    while ((n > 8 || (BQ / 16) * (DQK / 8 / n) < NW) && n % 2 == 0) n /= 2;
    return n;
  }
  static constexpr int NQT = nqt();
  static constexpr int NUNITS = (BQ / 16) * (DQK / 8 / NQT);
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims");
  static_assert(STAGE % 16 == 0 && DS_OFF % 16 == 0 && ACC_OFF % 16 == 0,
                "16-byte aligned tiles");
  static_assert(SMEM <= 232448, "tiles over the smem limit");
  static_assert(!kAccSmem || (DQK % 64 == 0 && DV % 64 == 0),
                "shared accumulators in 64-column chunks");
};

struct Geo {
  int Sq, Sk, KV, G, causal, window, q_offset;
  __device__ bool allowed(int r, int c) const {   // r: query row, c: key
    const int qa = q_offset + r;
    bool ok = c < Sk && r < Sq;
    if (causal) ok = ok && c <= qa;
    if (window > 0) ok = ok && c > qa - window;
    return ok;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// ---- warp products: C (16 x 8 NT) += A (16 x KD) B (KD x 8 NT) ------------
// fp16 / bf16: a(kk, uint32_t[4]) and b(kk, j, uint32_t[2]) give the
// m16n8k16 fragments of k-step kk (16 wide) and n8 tile j.
template <class Op, int KD, int NT, class AF, class BF>
__device__ __forceinline__ void gemm16(float (&c)[NT][4], AF a, BF b) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    a(kk, af);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bf[2];
      b(kk, j, bf);
      mma(Op{}, c[j], af, bf);
    }
  }
}

// fp32, 3xTF32: a(kk, float[4]) and b(kk, j, float[2]) give the operands of
// k-step kk (8 wide) in fragment order, with k permuted alike for A and B
// (slot tq holds k = kk + 2 tq, slot tq + 4 holds k + 1).  With few n8
// tiles the two small products go to accumulators of their own (more MMAs
// in flight), added at the end, as the forward does; not at depth 256,
// whose tiles have no registers to spare.
template <int KD, int NT, class AF, class BF>
__device__ __forceinline__ void gemm32(float (&c)[NT][4], AF a, BF b) {
  constexpr bool kSplit = NT <= 4 && KD <= 128;
  float cx[kSplit ? 2 : 1][NT][4];
#pragma unroll
  for (int p = 0; p < (kSplit ? 2 : 1); ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cx[p][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 8) {
    float av[4];
    a(kk, av);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float bv[2];
      b(kk, j, bv);
      uint32_t bh[2], bl[2];
      split_tf32(bv[0], bh[0], bl[0]);
      split_tf32(bv[1], bh[1], bl[1]);
      if constexpr (kSplit) {
        mma(Tf32{}, cx[0][j], al, bh);
        mma(Tf32{}, cx[1][j], ah, bl);
      } else {
        mma(Tf32{}, c[j], al, bh);
        mma(Tf32{}, c[j], ah, bl);
      }
      mma(Tf32{}, c[j], ah, bh);
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += cx[1][j][e] + cx[0][j][e];
  }
}

// Operand readers.  lane = 4 g + tq.  "rows": 16 rows of A (p: row 0),
// contiguous along k.  "krows": B's n rows contiguous along k (B = R^T, as
// the forward reads K for Q K^T).  "vrows": B's k rows contiguous along n
// (as the forward reads V for P V).  "frags": A from 16-row accumulator
// fragments c[n8 tile][4] whose columns are the k index (as the forward
// turns S into P's A fragment).
template <class T>
struct Frag {   // fp16 / bf16
  static __device__ __forceinline__ uint32_t w(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t h(const T* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
  static __device__ __forceinline__ void rows(const T* p, int ld, int kk,
                                              int g, int tq, uint32_t (&a)[4]) {
    const T* r = p + g * ld + kk + 2 * tq;
    a[0] = w(r);
    a[1] = w(r + 8 * ld);
    a[2] = w(r + 8);
    a[3] = w(r + 8 * ld + 8);
  }
  static __device__ __forceinline__ void krows(const T* p, int ld, int kk,
                                               int j, int g, int tq,
                                               uint32_t (&b)[2]) {
    const T* r = p + (8 * j + g) * ld + kk + 2 * tq;
    b[0] = w(r);
    b[1] = w(r + 8);
  }
  static __device__ __forceinline__ void vrows(const T* p, int ld, int kk,
                                               int j, int g, int tq,
                                               uint32_t (&b)[2]) {
    const T* r = p + (kk + 2 * tq) * ld + 8 * j + g;
    b[0] = h(r) | h(r + ld) << 16;
    b[1] = h(r + 8 * ld) | h(r + 9 * ld) << 16;
  }
  template <int N>
  static __device__ __forceinline__ void frags(const float (&c)[N][4],
                                               int kk, uint32_t (&a)[4]) {
    const int s = kk / 16;
    a[0] = pack2<T>(c[2 * s][0], c[2 * s][1]);
    a[1] = pack2<T>(c[2 * s][2], c[2 * s][3]);
    a[2] = pack2<T>(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[3] = pack2<T>(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
};

template <>
struct Frag<float> {
  static __device__ __forceinline__ void rows(const float* p, int ld, int kk,
                                              int g, int tq, float (&a)[4]) {
    const float* r = p + g * ld + kk + 2 * tq;
    const float2 v0 = *reinterpret_cast<const float2*>(r);
    const float2 v1 = *reinterpret_cast<const float2*>(r + 8 * ld);
    a[0] = v0.x;
    a[1] = v1.x;
    a[2] = v0.y;
    a[3] = v1.y;
  }
  static __device__ __forceinline__ void krows(const float* p, int ld,
                                               int kk, int j, int g, int tq,
                                               float (&b)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(
        p + (8 * j + g) * ld + kk + 2 * tq);
    b[0] = v.x;
    b[1] = v.y;
  }
  static __device__ __forceinline__ void vrows(const float* p, int ld,
                                               int kk, int j, int g, int tq,
                                               float (&b)[2]) {
    const float* r = p + (kk + 2 * tq) * ld + 8 * j + g;
    b[0] = r[0];
    b[1] = r[ld];
  }
  template <int N>
  static __device__ __forceinline__ void frags(const float (&c)[N][4],
                                               int kk, float (&a)[4]) {
    const int j = kk / 8;
    a[0] = c[j][0];
    a[1] = c[j][2];
    a[2] = c[j][1];
    a[3] = c[j][3];
  }
};

// C (16 x 8 NT) += A (16 x KD) B (KD x 8 NT) for the storage type T, with
// A and B given by the readers above (as lambdas of (kk[, j], frag)).
template <class T, int KD, int NT, class AF, class BF>
__device__ __forceinline__ void gemm(float (&c)[NT][4], AF a, BF b) {
  if constexpr (std::is_same<T, float>::value) {
    gemm32<KD, NT>(c, a, b);
  } else {
    using Op = std::conditional_t<std::is_same<T, __half>::value, F16, Bf16>;
    gemm16<Op, KD, NT>(c, a, b);
  }
}

template <class T>
using FragA = std::conditional_t<std::is_same<T, float>::value, float[4],
                                 uint32_t[4]>;
template <class T>
using FragB = std::conditional_t<std::is_same<T, float>::value, float[2],
                                 uint32_t[2]>;

// ---- delta = rowsum(d_out * out), and the zeroed dq workspace ------------
// One warp per query row (b, q, kv head, g) in out's order; delta (B, KV,
// G, Sq); dq_acc (B, Sq, KV, G, dqk) fp32.
template <int DV, class T>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                float* __restrict__ delta, float* __restrict__ dq_acc,
                int rows, int Sq, int KVG, int dqk) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = 4 * lane; d < DV; d += 128) {
    const float4 o = ld4(out + (size_t)row * DV + d);
    const float4 g = ld4(dout + (size_t)row * DV + d);
    acc = fmaf(o.x, g.x, fmaf(o.y, g.y, fmaf(o.z, g.z, fmaf(o.w, g.w, acc))));
  }
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    const int q = (row / KVG) % Sq, b = row / KVG / Sq, hh = row % KVG;
    delta[((size_t)b * KVG + hh) * Sq + q] = acc;
  }
  float4* z = reinterpret_cast<float4*>(dq_acc + (size_t)row * dqk);
  for (int d = lane; d < dqk / 4; d += 32) z[d] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- the products ----------------------------------------------------------
// grid (ceil(Sk / BKEY), KV * slices, B), 32 NW threads.  Slice s walks
// steps [s n / slices, (s + 1) n / slices) of its key tile's n (head,
// query tile) steps; with part_k == nullptr (one slice) dk / dv are written
// in T, else as fp32 partials (slices, B, Sk, KV, d) for
// bwd_finish_kernel.
template <int DQK, int DV, class T>
__global__ void __launch_bounds__(BwdShape<DQK, DV, T>::kThreads)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq_acc, T* __restrict__ dk,
           T* __restrict__ dv, float* __restrict__ part_k,
           float* __restrict__ part_v, Geo geo, int slices, float scale) {
  using S = BwdShape<DQK, DV, T>;
  using F = Frag<T>;
  constexpr int BKEY = S::BKEY, BQ = S::BQ, NW = S::NW, CH = S::CH;
  constexpr int KLD = S::KLD, VLD = S::VLD, QLD = S::QLD, OLD = S::OLD;
  constexpr int DSLD = S::DSLD, NQ8 = BQ / 8;
  constexpr bool kAcc = S::kAccSmem;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + S::K_OFF);
  T* v_s = reinterpret_cast<T*>(smem + S::V_OFF);
  T* ds_s = reinterpret_cast<T*>(smem + S::DS_OFF);
  float* acck_s = reinterpret_cast<float*>(smem + S::ACC_OFF);
  float* accv_s = acck_s + BKEY * S::KLDA;

  const int Sq = geo.Sq, Sk = geo.Sk, KV = geo.KV, G = geo.G;
  const int kvh = blockIdx.y / slices, slice = blockIdx.y % slices;
  const int b = blockIdx.z, c0 = blockIdx.x * BKEY;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = min(BKEY, Sk - c0);

  // query rows that may see a key of this tile
  const int c_last = c0 + nk - 1;
  const int r_lo = geo.causal ? max(0, c0 - geo.q_offset) : 0;
  const int r_hi = geo.window > 0
                       ? min(Sq, c_last + geo.window - geo.q_offset)
                       : Sq;                                   // exclusive
  const int n_rt = r_hi > r_lo ? (r_hi - r_lo + BQ - 1) / BQ : 0;
  const int it0 = (int)((long long)slice * G * n_rt / slices);
  const int n_it = (int)((long long)(slice + 1) * G * n_rt / slices) - it0;

  auto krow = [&](int c) { return ((size_t)b * Sk + c0 + c) * KV + kvh; };
  // K / V rows of the tile, in their storage type (rows past Sk read 0)
  for (int i = tid; i < BKEY * (DQK / CH); i += S::kThreads) {
    const int r = i / (DQK / CH), c = (i % (DQK / CH)) * CH;
    const bool ok = r < nk;
    cp_async16(k_s + r * KLD + c, ok ? k + krow(r) * DQK + c : k, ok);
  }
  for (int i = tid; i < BKEY * (DV / CH); i += S::kThreads) {
    const int r = i / (DV / CH), c = (i % (DV / CH)) * CH;
    const bool ok = r < nk;
    cp_async16(v_s + r * VLD + c, ok ? v + krow(r) * DV + c : v, ok);
  }
  // step it0 + it: query head (it0 + it) / n_rt, rows r_lo + ((it0 + it)
  // % n_rt) BQ ..
  auto stage_of = [&](int slot) { return smem + S::ST_OFF + slot * S::STAGE; };
  auto load_stage = [&](int it, int slot) {
    const int hg = (it0 + it) / n_rt, r0 = r_lo + ((it0 + it) % n_rt) * BQ;
    unsigned char* st = stage_of(slot);
    T* q_s = reinterpret_cast<T*>(st + S::ST_Q);
    T* o_s = reinterpret_cast<T*>(st + S::ST_O);
    auto qrow = [&](int r) {
      return (((size_t)b * Sq + r0 + r) * KV + kvh) * G + hg;
    };
    for (int i = tid; i < BQ * (DQK / CH); i += S::kThreads) {
      const int r = i / (DQK / CH), c = (i % (DQK / CH)) * CH;
      const bool ok = r0 + r < Sq;
      cp_async16(q_s + r * QLD + c, ok ? q + qrow(r) * DQK + c : q, ok);
    }
    for (int i = tid; i < BQ * (DV / CH); i += S::kThreads) {
      const int r = i / (DV / CH), c = (i % (DV / CH)) * CH;
      const bool ok = r0 + r < Sq;
      cp_async16(o_s + r * OLD + c, ok ? dout + qrow(r) * DV + c : dout, ok);
    }
    const size_t stat0 = (((size_t)b * KV + kvh) * G + hg) * Sq + r0;
    for (int r = tid; r < BQ; r += S::kThreads) {
      const bool ok = r0 + r < Sq;
      cp_async4(st + S::ST_L + 4 * r, ok ? lse + stat0 + r : lse, ok);
      cp_async4(st + S::ST_D + 4 * r, ok ? delta + stat0 + r : delta, ok);
    }
  };
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  constexpr int NKR = kAcc ? 1 : DQK / 8, NVR = kAcc ? 1 : DV / 8;
  float dk_r[NKR][4], dv_r[NVR][4];
#pragma unroll
  for (int j = 0; j < NKR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_r[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NVR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_r[j][e] = 0.f;
  if constexpr (kAcc) {   // each warp zeroes its own 16 rows
    for (int i = lane; i < 16 * S::KLDA; i += 32)
      acck_s[warp * 16 * S::KLDA + i] = 0.f;
    for (int i = lane; i < 16 * S::VLDA; i += 32)
      accv_s[warp * 16 * S::VLDA + i] = 0.f;
    __syncwarp();
  }

  const float sl2 = scale * kLog2e;
  const T* kw = k_s + warp * 16 * KLD;    // the warp's 16 keys
  const T* vw = v_s + warp * 16 * VLD;
  const int key_lo = c0 + warp * 16 + g, key_hi = key_lo + 8;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // tile it landed; every warp is done with it - 1
    if (it + 1 < n_it) load_stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int hg = (it0 + it) / n_rt, r0 = r_lo + ((it0 + it) % n_rt) * BQ;
    const unsigned char* st = stage_of(it & 1);
    const T* q_s = reinterpret_cast<const T*>(st + S::ST_Q);
    const T* o_s = reinterpret_cast<const T*>(st + S::ST_O);
    const float* l_s = reinterpret_cast<const float*>(st + S::ST_L);
    const float* d_s = reinterpret_cast<const float*>(st + S::ST_D);

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BQ queries
    float s[NQ8][4], dp[NQ8][4];
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm<T, DQK, NQ8>(
        s, [&](int kk, FragA<T>& a) { F::rows(kw, KLD, kk, g, tq, a); },
        [&](int kk, int j, FragB<T>& bb) {
          F::krows(q_s, QLD, kk, j, g, tq, bb);
        });
    gemm<T, DV, NQ8>(
        dp, [&](int kk, FragA<T>& a) { F::rows(vw, VLD, kk, g, tq, a); },
        [&](int kk, int j, FragB<T>& bb) {
          F::krows(o_s, OLD, kk, j, g, tq, bb);
        });
    // P^T and dS^T in place of S^T and dP^T; masked pairs weigh 0
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * tq + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        const float p = geo.allowed(r0 + qi, key)
                            ? exp2f(s[j][e] * sl2 - l_s[qi] * kLog2e)
                            : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - d_s[qi]);
      }
    // dV += P^T dO and dK += dS^T Q (k = the tile's queries)
    auto pa = [&](int kk, FragA<T>& a) { F::frags(s, kk, a); };
    auto dsa = [&](int kk, FragA<T>& a) { F::frags(dp, kk, a); };
    if constexpr (!kAcc) {
      gemm<T, BQ, DV / 8>(dv_r, pa, [&](int kk, int j, FragB<T>& bb) {
        F::vrows(o_s, OLD, kk, j, g, tq, bb);
      });
      gemm<T, BQ, DQK / 8>(dk_r, dsa, [&](int kk, int j, FragB<T>& bb) {
        F::vrows(q_s, QLD, kk, j, g, tq, bb);
      });
    } else {   // 64 columns at a time through the warp's shared rows
      auto chunked = [&](float* acc, int ald, int width, const T* bsrc,
                         int bld, auto afrag) {
        for (int c8 = 0; c8 < width; c8 += 64) {
          float c[8][4];
          float* r_lo_p = acc + (warp * 16 + g) * ald + c8 + 2 * tq;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 a0 = *reinterpret_cast<float2*>(r_lo_p + 8 * j);
            const float2 a1 =
                *reinterpret_cast<float2*>(r_lo_p + 8 * ald + 8 * j);
            c[j][0] = a0.x; c[j][1] = a0.y; c[j][2] = a1.x; c[j][3] = a1.y;
          }
          gemm<T, BQ, 8>(c, afrag, [&](int kk, int j, FragB<T>& bb) {
            F::vrows(bsrc + c8, bld, kk, j, g, tq, bb);
          });
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<float2*>(r_lo_p + 8 * j) =
                make_float2(c[j][0], c[j][1]);
            *reinterpret_cast<float2*>(r_lo_p + 8 * ald + 8 * j) =
                make_float2(c[j][2], c[j][3]);
          }
        }
      };
      chunked(accv_s, S::VLDA, DV, o_s, OLD, pa);
      chunked(acck_s, S::KLDA, DQK, q_s, QLD, dsa);
    }
    // dS (queries x keys) to shared memory for dQ, in T
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * tq + (e & 1);
        const int kl = warp * 16 + g + (e < 2 ? 0 : 8);
        ds_s[qi * DSLD + kl] = from_f32<T>(dp[j][e]);
      }
    __syncthreads();
    // dQ += dS K (unscaled; bwd_finish_kernel scales), unit by unit
    for (int u = warp; u < S::NUNITS; u += NW) {
      constexpr int NQT = S::NQT;
      const int rg = u % (BQ / 16), col0 = (u / (BQ / 16)) * NQT * 8;
      float c[NQT][4];
#pragma unroll
      for (int j = 0; j < NQT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
      gemm<T, BKEY, NQT>(
          c,
          [&](int kk, FragA<T>& a) {
            F::rows(ds_s + rg * 16 * DSLD, DSLD, kk, g, tq, a);
          },
          [&](int kk, int j, FragB<T>& bb) {
            F::vrows(k_s + col0, KLD, kk, j, g, tq, bb);
          });
      const int ra = r0 + rg * 16 + g, rb = ra + 8;
      float* qa = dq_acc + ((((size_t)b * Sq + ra) * KV + kvh) * G + hg) * DQK
                  + col0 + 2 * tq;
      float* qb = qa + (size_t)8 * KV * G * DQK;
#pragma unroll
      for (int j = 0; j < NQT; ++j) {
        if (ra < Sq) {
          atomicAdd(qa + 8 * j, c[j][0]);
          atomicAdd(qa + 8 * j + 1, c[j][1]);
        }
        if (rb < Sq) {
          atomicAdd(qb + 8 * j, c[j][2]);
          atomicAdd(qb + 8 * j + 1, c[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dk = scale dS^T q and dv, in T, or as this slice's fp32 partials
  const size_t n_rows = (size_t)gridDim.z * Sk * KV;   // rows of dk / dv
  float* pk = part_k ? part_k + (size_t)slice * n_rows * DQK : nullptr;
  float* pv = part_v ? part_v + (size_t)slice * n_rows * DV : nullptr;
  auto put = [&](T* dst, float* pdst, size_t off, float x0, float x1) {
    if (pdst) *reinterpret_cast<float2*>(pdst + off) = make_float2(x0, x1);
    else store2<T>(dst + off, x0, x1);
  };
  if constexpr (!kAcc) {
    const int kl = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (kl < nk)
        put(dk, pk, krow(kl) * DQK + col, dk_r[j][0] * scale,
            dk_r[j][1] * scale);
      if (kl + 8 < nk)
        put(dk, pk, krow(kl + 8) * DQK + col, dk_r[j][2] * scale,
            dk_r[j][3] * scale);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (kl < nk) put(dv, pv, krow(kl) * DV + col, dv_r[j][0], dv_r[j][1]);
      if (kl + 8 < nk)
        put(dv, pv, krow(kl + 8) * DV + col, dv_r[j][2], dv_r[j][3]);
    }
  } else {   // the warp's own rows of the shared accumulators
    __syncwarp();
    for (int i = lane; i < 16 * (DQK / 2); i += 32) {
      const int kl = warp * 16 + i / (DQK / 2), c = 2 * (i % (DQK / 2));
      const float* a = acck_s + kl * S::KLDA + c;
      if (kl < nk) put(dk, pk, krow(kl) * DQK + c, a[0] * scale, a[1] * scale);
    }
    for (int i = lane; i < 16 * (DV / 2); i += 32) {
      const int kl = warp * 16 + i / (DV / 2), c = 2 * (i % (DV / 2));
      const float* a = accv_s + kl * S::VLDA + c;
      if (kl < nk) put(dv, pv, krow(kl) * DV + c, a[0], a[1]);
    }
  }
}

template <class T>
__device__ __forceinline__ void store4(T* p, float4 x) {
  store2<T>(p, x.x, x.y);
  store2<T>(p + 2, x.z, x.w);
}

// ---- dq = scale dq_acc in T; dk / dv = the sum of their slices' partials
// (nq, nk, nv in float4s; nk = nv = 0 when the grid did not split G)
template <class T>
__global__ void __launch_bounds__(256)
bwd_finish_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                  size_t nq, float scale, const float* __restrict__ part_k,
                  T* __restrict__ dk, size_t nk,
                  const float* __restrict__ part_v, T* __restrict__ dv,
                  size_t nv, int slices) {
  const size_t total = nq + nk + nv;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < nq) {
      const float4 a = reinterpret_cast<const float4*>(dq_acc)[i];
      store4(dq + 4 * i,
             make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale));
      continue;
    }
    const bool is_k = i < nq + nk;
    const size_t j = is_k ? i - nq : i - nq - nk, n = is_k ? nk : nv;
    const float4* p = reinterpret_cast<const float4*>(is_k ? part_k : part_v)
                      + j;
    float4 s = p[0];
    for (int t = 1; t < slices; ++t) {   // in slice order
      const float4 u = p[(size_t)t * n];
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    store4((is_k ? dk : dv) + 4 * j, s);
  }
}

template <int DQK, int DV, class T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, float* dq_acc, float* part_k, float* part_v, int B,
           Geo geo, int slices, float scale, cudaStream_t st) {
  using S = BwdShape<DQK, DV, T>;
  static bool opted = false;   // this instantiation's smem opt-in
  auto kb = bwd_kernel<DQK, DV, T>;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  if ((slices > 1) != (part_k != nullptr) || (part_k == nullptr) !=
      (part_v == nullptr))
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const int rows = B * geo.Sq * geo.KV * geo.G;
  bwd_prep_kernel<DV, T><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, dq_acc,
      rows, geo.Sq, geo.KV * geo.G, DQK);
  int err = (int)cudaGetLastError();
  if (err) return err;
  kb<<<dim3((geo.Sk + S::BKEY - 1) / S::BKEY, geo.KV * slices, B),
       S::kThreads, S::SMEM, st>>>(
      qt, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), part_k, part_v, geo, slices, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t kv_rows = (size_t)B * geo.Sk * geo.KV;
  const size_t nq = (size_t)rows * DQK / 4;
  const size_t nk = slices > 1 ? kv_rows * DQK / 4 : 0;
  const size_t nv = slices > 1 ? kv_rows * DV / 4 : 0;
  const size_t blocks = min((nq + nk + nv + 255) / 256, (size_t)132 * 16);
  bwd_finish_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      dq_acc, static_cast<T*>(dq), nq, scale, part_k, static_cast<T*>(dk),
      nk, part_v, static_cast<T*>(dv), nv, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV, G, dqk), out / dout (B, Sq, KV, G, dv), k (B, Sk, KV, dqk),
// v (B, Sk, KV, dv) of the storage type `dtype` (elem::DType), 16-byte
// aligned; lse (B, KV, G, Sq) fp32 (natural log, the forward's m + log l);
// dq, dk, dv shaped as q, k, v.  Workspaces, fp32: delta (B, KV, G, Sq);
// dq_acc shaped as q; with slices > 1 (blocks per key tile), part_k /
// part_v (slices, B, Sk, KV, dqk / dv), else nullptr.  All contiguous.  window <= 0 means no window; every query row must see a
// key.  (dqk, dv) as repro_flash_attention takes them.  Three launches;
// returns the CUDA error (0 = none).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, float* dq_acc, float* part_k, float* part_v, int B, int Sq,
    int Sk, int KV, int G, int dqk, int dvd, int causal, int window,
    int q_offset, int slices, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo{Sq, Sk, KV, G, causal, window, q_offset};
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || G <= 0 || slices <= 0)
    return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
#define REPRO_BWD(DQK, DV)                                                  \
  launch<DQK, DV, T>(q, k, v, out, dout, lse, dq, dk, dv, delta, dq_acc,    \
                     part_k, part_v, B, geo, slices, scale, st)
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
