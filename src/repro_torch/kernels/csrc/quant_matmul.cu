// Dequantizing matrix product for int8 / int4 weight shards:
//   out (M, N) = x (M, K) @ (q (K, N) * scale (N,)), accumulated in fp32,
// x and out fp32, fp16 or bf16 (one type), scale fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/streamed_matmul.py ::
// quantized_matmul (kernel body _quant_matmul_kernel, _dequant_tile).  It
// computes the same function: q is int8 (K, N) for 8 bits, or uint8
// (ceil(K/2), N) for 4 bits with row 2i in the low nibble and row 2i+1 in
// the high nibble, each nibble sign-extended; scale is per output column.
// The scale is applied once per output column to the fp32 accumulator
// (sum_k x[m,k] q[k,n]) * s[n], not per tile to the weight as the Pallas
// body does: the two agree within fp32 rounding.  Any M, N and K are
// taken (the launcher applies the TPU kernel's divisibility contract only
// to tiles a caller asks for); for 4 bits an odd K's padding nibble meets
// x = 0.
//
// What bounds it on the H100:
//  * Decode (M = B <= 4): bytes.  Each weight byte feeds 2 * M flops (int8)
//    or 4 * M (int4), far below any balance point, so the least time is
//    the quantized weight read once at 3.35 TB/s (0.3 us for 1 MB).  A
//    call of a few microseconds is launch- and host-bound: the design
//    makes it one launch.
//  * Prefill (M = 128): operations.  On fp32 x the fastest fp32-input
//    rate is TF32's 495 TFLOP/s (2 M K N flops); the kernel spends three
//    bf16 tensor-core passes (989 TFLOP/s each) to keep fp32's accuracy.
//    At N = 1024 the output is only 2 x 16 tiles of 64 x 64 for 132 SMs.
//
// What the design does about it:
//  * M <= kSkinnyM: quant_skinny.cuh's skinny_kernel, one M tile, so every
//    weight byte is read from device memory once per launch, as 16-byte
//    vectors dequantized in registers; narrow N (1024 columns = 16 blocks)
//    would leave most SMs idle, so the launcher also splits K across
//    blocks, the splits' partial sums added in split order by the last
//    split of each column tile: one launch, no float atomics, results that
//    do not vary from run to run.
//  * M > kSkinnyM: mm_tiles.cuh's tensor-core tile body, shared with
//    streamed_matmul.cu, over an int8 or int4 weight loader.  Each int8 /
//    int4 value is exact in bf16 and fp16, so a weight fragment is
//    converted in registers from the stored bytes as it is read (on the
//    integer / fp32 ALUs: one byte_perm and one add per value, one 2- or
//    4-byte shared-memory read serving 2 or 4 n8 tiles); fp32 x runs as
//    three bf16 passes, x = hi + mid + lo exactly, split once per stage
//    into shared planes, which gives the FMA loop's products exactly (only
//    the fp32 sums' order differs); fp16 / bf16 x run one pass in their
//    type.  The scale multiplies the
//    fp32 accumulator in the epilogue.  The caller's or the autotuned
//    (block_m, block_n, block_k) give the block's output region, its
//    tile (64 or 128 per edge) and the K rows per stage (16, 32 or 64), as
//    for streamed_matmul.cu; 64 x 64 with 64-row stages when neither is
//    given.  The launcher splits K (whole stages, in split order, as
//    above) whenever the output's blocks would leave the SMs under-filled:
//    (128, 4096, 1024) runs 32 regions x 5 splits.
//
// MLA's batched absorbed products (all heads in one launch) are
// quant_matmul_batched.cu, a library of its own so that it builds beside
// this one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_tiles.cuh"
#include "quant_skinny.cuh"

namespace {

using namespace elem;
using qskinny::kSkinnyM;

// The weight loaders of mm_tiles.cuh's tile body: the stored bytes are
// staged as they are; B fragments convert them in registers (each value
// exact in bf16 / fp16; the scale is applied to the accumulator).  Both
// are grouped (mm::Tile::col): one 2- or 4-byte read of a stage row
// serves 2 or 4 n8 tiles.
struct Int8B {
  using Raw = int8_t;
  static constexpr int kPack = 1;
  static constexpr int kPad = 16;
  static constexpr bool kGrouped = true;
  const int8_t* w;
  // tile j of group h: rows kk + 2t, kk + 2t + 1 (b[.][0]) and
  // kk + 2t + 8, + 9 (b[.][1]); q + 128 is the byte with its top bit
  // flipped
  template <class Op, int NT, int G>
  __device__ __forceinline__ static void frags(const int8_t* ws, int ld,
                                               int kk, int col0, int g,
                                               int t, uint32_t (&b)[NT][2]) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(ws) +
                       (kk + 2 * t) * ld + col0 + G * g;
#pragma unroll
    for (int h = 0; h < NT / G; ++h) {
      const uint8_t* p = s + 8 * G * h;
      const uint32_t w0 = mm::ld_bytes<G>(p) ^ 0x80808080u;
      const uint32_t w1 = mm::ld_bytes<G>(p + ld) ^ 0x80808080u;
      const uint32_t w8 = mm::ld_bytes<G>(p + 8 * ld) ^ 0x80808080u;
      const uint32_t w9 = mm::ld_bytes<G>(p + 9 * ld) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        b[G * h + j][0] = mm::pack_bytes<128>(Op{}, w0, w1, j);
        b[G * h + j][1] = mm::pack_bytes<128>(Op{}, w8, w9, j);
      }
    }
  }
};

// Rows 2i (low nibble) and 2i + 1 (high) in byte row i: the MMA's pair of
// rows (2t, 2t + 1) is one byte; q + 8 is a nibble with its top bit
// flipped.
struct Int4B {
  using Raw = uint8_t;
  static constexpr int kPack = 2;
  static constexpr int kPad = 32;
  static constexpr bool kGrouped = true;
  const uint8_t* w;
  template <class Op, int NT, int G>
  __device__ __forceinline__ static void frags(const uint8_t* ws, int ld,
                                               int kk, int col0, int g,
                                               int t, uint32_t (&b)[NT][2]) {
    const uint8_t* s = ws + (kk / 2 + t) * ld + col0 + G * g;
#pragma unroll
    for (int h = 0; h < NT / G; ++h) {
      const uint8_t* p = s + 8 * G * h;
      const uint32_t w0 = mm::ld_bytes<G>(p) ^ 0x88888888u;
      const uint32_t w4 = mm::ld_bytes<G>(p + 4 * ld) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const uint32_t x0 = w0 >> (8 * j), x4 = w4 >> (8 * j);
        b[G * h + j][0] =
            mm::pack_biased<8>(Op{}, x0 & 0xfu, (x0 >> 4) & 0xfu);
        b[G * h + j][1] =
            mm::pack_biased<8>(Op{}, x4 & 0xfu, (x4 >> 4) & 0xfu);
      }
    }
  }
};

template <int BITS, class T>
int launch(const T* x, const uint8_t* w, const float* scale, T* out,
           float* part, int* counters, int M, int K, int N, int splits,
           int per_split, bool vec, int rm, int rn, int bm, int bn, int kc,
           cudaStream_t stream) {
  if (M > kSkinnyM) {
    if (BITS == 8)
      return mm::launch(rm, rn, bm, bn, kc, x,
                        Int8B{reinterpret_cast<const int8_t*>(w)}, scale,
                        out, part, counters, splits, per_split, M, K, N,
                        stream);
    return mm::launch(rm, rn, bm, bn, kc, x, Int4B{w}, scale, out, part,
                      counters, splits, per_split, M, K, N, stream);
  }
  return qskinny::launch_skinny<BITS>(x, w, scale, out, part, counters, M,
                                      K, N, 1, splits, per_split, vec,
                                      qskinny::Strides{K, N, N, 0, 0, 0},
                                      stream);
}

}  // namespace

// x (M, K) and out (M, N) of the storage type `dtype` (elem::DType); w:
// int8 (K, N) for bits 8, uint8 (ceil(K/2), N) for bits 4; scale (N,) f32;
// all contiguous, M, N, K > 0.  splits (>= 1) K splits of per_split rows
// each; part (splits, M, N) f32 and counters (one zeroed int per column
// tile or output region, left zeroed) when splits > 1, else unused.  For
// M <= 4, per_split counts stored rows; vec: N % 16 == 0 and w 16-byte
// aligned.  For M > 4, per_split counts logical K rows, a multiple of
// 2 * kc; blocks own rm x rn output regions, walked in the bm x bn tile,
// (bm, bn) in {64, 128}^2, with 2 * kc K rows per stage, kc in {8, 16,
// 32}.  One launch; returns its CUDA error (0 = none).
extern "C" int repro_quant_matmul(const void* x, const uint8_t* w,
                                  const float* scale, void* out, float* part,
                                  int* counters, int M, int K, int N,
                                  int bits, int splits, int per_split,
                                  int vec, int rm, int rn, int bm, int bn,
                                  int kc, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (bits == 8)
      return launch<8>(xt, w, scale, ot, part, counters, M, K, N, splits,
                       per_split, vec != 0, rm, rn, bm, bn, kc, st);
    return launch<4>(xt, w, scale, ot, part, counters, M, K, N, splits,
                     per_split, vec != 0, rm, rn, bm, bn, kc, st);
  });
}
