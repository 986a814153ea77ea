// Streamed (weight-streaming) matrix product, x (M, K) @ w (K, N) -> (M, N),
// for fp32, fp16 and bf16 (x, w and the output of one type), accumulated
// in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/streamed_matmul.py ::
// streamed_matmul (kernel body _matmul_kernel).  It computes the same
// function: an fp32 accumulator over K, the output rounded to x's type once
// at the end.  The TPU kernel's (block_m, block_n, block_k) grid walks
// weight tiles through VMEM; the launcher (kernels/streamed_matmul.py)
// keeps its contract (each tile clamped to the shape must divide it) and
// maps the tiles onto this card's:
//  * (block_m, block_n) is the block's output region, as the TPU grid's
//    output tile is, walked in a tile compiled here, 64 x 64, 64 x 128,
//    128 x 64 or 128 x 128 (each edge 64 when the region's is at most 64,
//    else 128): a 256-row region is two 128-row tiles in turn;
//  * block_k selects the K rows per shared-memory stage, 2 * kc = 16, 32
//    or 64 (block_k <= 128, <= 256, else): the reference's 256 x 512 fp32
//    x tile alone is 512 KiB, far over the 227 KB of shared memory a block
//    may use, so each block_k step is staged as block_k / (2 kc) stages of
//    a 3-deep cp.async ring.
//
// What bounds it on the H100: operations at the shapes autotune times
// (M = 256 tokens: 2 M K N flops against (M K + K N + M N) * 4 bytes is
// ~100 flop/byte in fp32), and the weight read at decode-sized M.  The
// fastest rate at which the card multiplies fp32 inputs is TF32's 495
// TFLOP/s on the tensor cores; fp16 / bf16 run at 989.
//
// What the design does about it: mm_tiles.cuh's tensor-core body, shared
// with quant_matmul.cu's tiled path.  fp32 runs as 3xTF32 (m16n8k8): each
// operand a = ah + al, both TF32 (a's top 19 bits, then those of a - ah),
// and acc += ah bh + ah bl + al bh in fp32.  Error budget: per product the
// dropped al bl is below 2^-20 |ab| and each operand's truncated remainder
// below 2^-21 of it, under ~2e-6 |ab| in all, with fp32 accumulation in
// the tensor cores; measured ~1e-5 of the output's scale at (256, 1024,
// 4096), against the 1e-4 limit.  fp16 / bf16 run one m16n8k16 pass in
// their type.  When the output's blocks would leave the SMs under-filled
// (a 256 x 256 region at (256, 1024, 4096) makes 16 blocks), the launcher
// splits K into whole stages, summed in split order by the last split of
// each region.
#include "mm_tiles.cuh"

// x (M, K), w (K, N), out (M, N), all contiguous and of the storage type
// `dtype` (elem::DType); M, N, K > 0.  Blocks own rm x rn output regions,
// walked in the (bm, bn) tile, (bm, bn) in {64, 128}^2, with 2 * kc K rows
// per stage, kc in {8, 16, 32}; splits (>= 1) K splits of k_per_split rows
// (a multiple of 2 * kc), with part (splits, M, N) f32 and counters (one
// zeroed int per region, left zeroed) when splits > 1.  One launch;
// returns its CUDA error (0 = none).
extern "C" int repro_streamed_matmul(const void* x, const void* w, void* out,
                                     float* part, int* counters, int M,
                                     int K, int N, int rm, int rn, int bm,
                                     int bn, int kc, int splits,
                                     int k_per_split, int dtype,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const mm::DenseB<T> wl{static_cast<const T*>(w)};
    return mm::launch(rm, rn, bm, bn, kc, static_cast<const T*>(x), wl,
                      nullptr, static_cast<T*>(out), part, counters, splits,
                      k_per_split, M, K, N, st);
  });
}
