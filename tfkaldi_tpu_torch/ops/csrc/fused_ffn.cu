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
// Shapes the TMA cannot describe take the core's SIMT edge route
// (ops/gemm_plan.py decides; `route` is 1 for TMA, 0 for SIMT).

#include "gemm_sm90.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* scale, const void* shift,
           void* out, int n, int k, int m, int relu, int route, void* stream) {
  const tkgemm::FfnEpi<T> epi{static_cast<T*>(out), m, static_cast<const float*>(bias),
                              static_cast<const float*>(scale), static_cast<const float*>(shift), relu};
  return tkgemm::launch<T, false>(route, static_cast<const T*>(x), static_cast<const T*>(w), n, m, k, epi,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int tk_fused_ffn_f32(const void* x, const void* w, const void* bias, const void* scale,
                                const void* shift, void* out, int n, int k, int m, int relu, int route,
                                void* stream) {
  return launch<float>(x, w, bias, scale, shift, out, n, k, m, relu, route, stream);
}

extern "C" int tk_fused_ffn_bf16(const void* x, const void* w, const void* bias, const void* scale,
                                 const void* shift, void* out, int n, int k, int m, int relu, int route,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, scale, shift, out, n, k, m, relu, route, stream);
}

// dynamic shared memory of the TMA route for a dtype (0 = f32, 1 = bf16),
// read by ops/gemm_plan.py's users to hold the plan to the source
extern "C" int tk_gemm_smem(int bf16) {
  return bf16 ? tkgemm::TmaLayout<__nv_bfloat16>::SMEM : tkgemm::TmaLayout<float>::SMEM;
}
