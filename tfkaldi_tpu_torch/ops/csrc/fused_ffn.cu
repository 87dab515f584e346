// Fused FFN block: out = act((x @ w + b) * scale + shift), f32 accumulation.
//
// Replaces the TPU kernel tfkaldi_tpu/ops/fused_mlp.py::_ffn_kernel (launched
// by _fused_ffn_block): the eval-mode forward of every DNN hidden layer, with
// the batchnorm inference affine and the relu folded into the epilogue.
//
// What bounds it on an H100: at the recipe's shapes ([N,440]x[440,2048] and
// [N,2048]x[2048,2048], N = 8,192 decode .. 65,536 validation rows) the
// product does 2*N*K*M operations on (N*K + K*M + N*M) elements, hundreds
// of operations per byte, so it is bound by arithmetic: the tensor cores
// for bf16 (989 TFLOP/s), the f32 FMA units for f32 (67 TFLOP/s; the
// reference contracts f32 at HIGHEST, fused_mlp.py:48-53, so no TF32).
//
// What the design does about it: the product runs on the GEMM core of
// gemm_sm90.cuh with x as the K-major A operand and w [K, M] as an
// MN-major B (read as it lies, no transpose): TMA loads into a 4-stage
// swizzled ring, wgmma for bf16, FMAs straight from shared memory for f32.
// The epilogue applies bias, scale/shift and relu to the f32 accumulator
// and rounds once to x's dtype, so the pre-activation never reaches HBM.
// Shapes the TMA cannot describe take the core's SIMT edge route.
//
// Below one wave of tiles (the streamed DNN's 8..600 rows) the product
// is bound by the bytes of w (at n <= 72: 16.8 MB f32 / 8.4 MB bf16 at K
// 2048) or, at f32 n = 600, by the FMAs, and not by one CTA's whole-K
// tile: the route "splitk" cuts K over
// grid z so that the CTAs fill the card, each streaming its slice of w
// once, then a second kernel sums the f32 partials in a fixed order and
// applies this epilogue (gemm_sm90.cuh, launch_splitk). ops/gemm_plan.py
// decides the route, the tile and the split: `route` is 1 for TMA, 0 for
// SIMT, 2 for split-K, `bm` the tile's rows on the first two (0 or the
// dtype's 128: the full tile; 64: the half tile, which spreads n in the
// hundreds over twice the CTAs), `ws` the split's [splits, N, M] f32
// workspace, `slabs` the BK-deep slabs of a split.

#include "gemm_sm90.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* scale, const void* shift,
           void* out, int n, int k, int m, int relu, int route, int bm, void* ws, int splits, int slabs,
           void* stream) {
  const tkgemm::FfnEpi<T> epi{static_cast<T*>(out), m, static_cast<const float*>(bias),
                              static_cast<const float*>(scale), static_cast<const float*>(shift), relu};
  const tkgemm::Plan plan{bm, static_cast<float*>(ws), splits, slabs};
  return tkgemm::launch<T, false>(route, static_cast<const T*>(x), static_cast<const T*>(w), n, m, k, epi,
                                  static_cast<cudaStream_t>(stream), plan);
}

}  // namespace

extern "C" int tk_fused_ffn_f32(const void* x, const void* w, const void* bias, const void* scale,
                                const void* shift, void* out, int n, int k, int m, int relu, int route,
                                int bm, void* ws, int splits, int slabs, void* stream) {
  return launch<float>(x, w, bias, scale, shift, out, n, k, m, relu, route, bm, ws, splits, slabs, stream);
}

extern "C" int tk_fused_ffn_bf16(const void* x, const void* w, const void* bias, const void* scale,
                                 const void* shift, void* out, int n, int k, int m, int relu, int route,
                                 int bm, void* ws, int splits, int slabs, void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, scale, shift, out, n, k, m, relu, route, bm, ws, splits, slabs,
                               stream);
}

// dynamic shared memory of the TMA and split routes for a dtype (0 = f32,
// 1 = bf16) and a tile of bm rows (128 or 64; -1 for another), and the
// blocks of it an SM holds, read by ops/gemm_plan.py's users to hold the
// plan to the source
extern "C" int tk_gemm_smem(int bf16, int bm) {
  using tkgemm::HALF_BM;
  using tkgemm::TmaLayout;
  if (bm != 128 && bm != HALF_BM) return -1;
  if (bf16) return bm == HALF_BM ? TmaLayout<__nv_bfloat16, HALF_BM>::SMEM : TmaLayout<__nv_bfloat16>::SMEM;
  return bm == HALF_BM ? TmaLayout<float, HALF_BM>::SMEM : TmaLayout<float>::SMEM;
}

extern "C" int tk_gemm_blocks_per_sm(int bf16, int bm) {
  using tkgemm::HALF_BM;
  using tkgemm::tma_blocks_per_sm;
  if (bm != 128 && bm != HALF_BM) return -1;
  if (bf16) return bm == HALF_BM ? tma_blocks_per_sm<__nv_bfloat16, HALF_BM>() : tma_blocks_per_sm<__nv_bfloat16, 128>();
  return bm == HALF_BM ? tma_blocks_per_sm<float, HALF_BM>() : tma_blocks_per_sm<float, 128>();
}
