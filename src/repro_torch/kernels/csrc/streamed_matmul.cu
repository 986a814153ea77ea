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
//    output tile is, walked in a register tile compiled here, 64 x 64,
//    64 x 128, 128 x 64 or 128 x 128 (each edge 64 when the region's is at
//    most 64, else 128): a 256-row region is two 128-row tiles in turn;
//  * block_k selects the K rows per shared-memory stage, kc = 8, 16 or 32
//    (block_k <= 128, <= 256, else): the reference's 256 x 512 fp32 x tile
//    alone is 512 KiB, far over the 227 KB of shared memory a block may
//    use, so each block_k step is staged as block_k / kc sub-chunks.
//
// What bounds it on the H100: fp32 operations at the shapes autotune times
// (M = 256 tokens: 2 M K N flops against (M K + K N + M N) * 4 bytes is
// ~100 flop/byte, above the ~20 flop/byte fp32 balance point), and the
// weight read at decode-sized M.  The product runs as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak): a TF32 tensor-core path would not keep
// fp32's 1e-4 accuracy.  The tile body is mm_tiles.cuh's, shared with
// quant_matmul.cu's tiled path; wgmma / TMA and a 3xTF32 split are later
// work.
#include "mm_tiles.cuh"

// x (M, K), w (K, N), out (M, N), all contiguous and of the storage type
// `dtype` (elem::DType); M, N, K > 0.  Blocks own rm x rn output regions,
// walked in the (bm, bn) register tile, (bm, bn) in {64, 128}^2; kc in
// {8, 16, 32}.  Returns the launch's CUDA error (0 = none).
extern "C" int repro_streamed_matmul(const void* x, const void* w, void* out,
                                     int M, int K, int N, int rm, int rn,
                                     int bm, int bn, int kc, int dtype,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const mm::DenseB<T> wl{static_cast<const T*>(w), K, N};
    return mm::launch(rm, rn, bm, bn, kc, static_cast<const T*>(x), wl,
                      nullptr, static_cast<T*>(out), M, K, N, st);
  });
}
