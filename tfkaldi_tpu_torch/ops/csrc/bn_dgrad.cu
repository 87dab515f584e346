// Fused BN-backward data gradient of a relu(maskedBN(h @ w + b)) layer:
//   dz = r*dpre - m*(c1 + xhat*c2),  dpre = bn > 0 ? g : 0,
//   xhat = z - mean,  bn = round_cd(xhat*r + beta),
//   dh = round_cd(dz) @ w^T   (f32 accumulation, stored in g's dtype).
//
// Replaces the TPU kernel tfkaldi_tpu/ops/bn_fused_bwd.py::_dgrad_kernel
// (launched by _fused_dgrad inside the custom VJP bn_relu_layer): the
// backward of every hidden layer of the hybrid DNN in training. The moment
// sums S1, S2 (hence c1 = r*S1/n, c2 = r^3*S2/n), db = sum(dz) and the
// weight gradient dW = h^T @ dz stay outside, as in the JAX package.
//
// What bounds it on an H100: at the recipe's shape (N = 65,536 rows =
// batch 128 x 512 frames, H = K = 2048) the product does 2*N*H*K =
// 549.8 GFLOP: 8.2 ms at the 67 TFLOP/s f32-FMA rate (f32 contracts in
// full f32, as the reference, tfkaldi_tpu/ops/fused_mlp.py:48-53), 0.56 ms
// on the bf16 tensor cores. dz alone moves g, z in and dz out (1.6 GB f32,
// 0.8 GB bf16): 0.48 / 0.24 ms at 3.35 TB/s. Layer 0 (dh not needed) is
// that dz pass alone, bound by bytes.
//
// What the design does about it: two launches. (1) bn_dz: an elementwise
// pass bound by bytes. Each thread owns 16 bytes of columns (4 f32 or 8
// bf16) and keeps their five [H] parameters in registers while it walks
// rows, reading g and z with 16-byte loads and writing dz once; the
// arithmetic uses __f*_rn intrinsics so nvcc cannot contract it into FMAs,
// and dz is bit-equal to the plain PyTorch version. (2) dh = dz @ w^T on
// the GEMM core of gemm_sm90.cuh: dz is the K-major A operand and w [K, H]
// is a K-major B (its rows are the columns of w^T), so w^T is never
// materialised; TMA + wgmma for bf16, TMA + FMA for f32, a plain store
// epilogue. The trainer needs dz in HBM anyway (db, and dW = h^T @ dz), so
// the split costs one more read of dz by the product and takes away the
// recomputation of dz by every column block of a fused prologue. Shapes
// the TMA cannot describe run the dz pass with scalar loads and the core's
// SIMT edge route (ops/gemm_plan.py decides: `route` 1 = TMA and the
// vector dz pass, 0 = SIMT and the scalar dz pass). With dh == nullptr the
// product is skipped.

#include "gemm_sm90.cuh"

namespace {

// round an f32 value to the compute dtype and back (exact widening)
template <typename T>
__device__ __forceinline__ float round_cd(float v);
template <>
__device__ __forceinline__ float round_cd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V consecutive elements through one 16-byte access (V = 16 / sizeof(T)),
// or one scalar (V = 1)
template <typename T, int V>
struct Vec {
  static __device__ __forceinline__ void load(const T* p, float* out) {
    if constexpr (V == 1) {
      out[0] = tkgemm::to_f32(p[0]);
    } else if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&words[i]);
        out[2 * i] = __low2float(pair);
        out[2 * i + 1] = __high2float(pair);
      }
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    if constexpr (V == 1) {
      tkgemm::store1(p, v[0]);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint32_t words[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        words[i] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
};

constexpr int DZ_THREADS = 128;
constexpr int DZ_ROW_BLOCKS = 1024;  // blocks along the rows; each walks n / 1024 rows

// dz of rows blockIdx.y, blockIdx.y + gridDim.y, ...; columns
// V * (blockIdx.x * 128 + threadIdx.x) .. + V - 1
template <typename T, int V>
__global__ void __launch_bounds__(DZ_THREADS)
bn_dz_kernel(const T* __restrict__ g, const T* __restrict__ z, const float* __restrict__ mask,
             const float* __restrict__ mean, const float* __restrict__ r,
             const float* __restrict__ beta, const float* __restrict__ c1,
             const float* __restrict__ c2, T* __restrict__ dz, int n, int h) {
  const int c0 = V * (blockIdx.x * DZ_THREADS + threadIdx.x);
  if (c0 >= h) return;  // V divides h on the vector route
  float pm[V], pr[V], pb[V], p1[V], p2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    pm[i] = mean[c0 + i]; pr[i] = r[c0 + i]; pb[i] = beta[c0 + i];
    p1[i] = c1[c0 + i]; p2[i] = c2[c0 + i];
  }
#pragma unroll 4
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y) {
    const int64_t off = row * h + c0;
    float zv[V], gv[V], out[V];
    Vec<T, V>::load(z + off, zv);
    Vec<T, V>::load(g + off, gv);
    const float m = mask[row];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xhat = __fsub_rn(zv[i], pm[i]);
      const float bn = round_cd<T>(__fadd_rn(__fmul_rn(xhat, pr[i]), pb[i]));
      const float dpre = bn > 0.0f ? gv[i] : 0.0f;
      const float fb = __fmul_rn(m, __fadd_rn(p1[i], __fmul_rn(xhat, p2[i])));
      out[i] = __fsub_rn(__fmul_rn(pr[i], dpre), fb);
    }
    Vec<T, V>::store(dz + off, out);
  }
}

template <typename T>
int launch(const void* g, const void* z, const void* mask, const void* w, const void* mean,
           const void* r, const void* beta, const void* c1, const void* c2, void* dh, void* dz,
           int n, int h, int k, int route, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  const int v = route == 1 ? V : 1;
  const int chunks = (h + v - 1) / v;
  const dim3 grid((chunks + DZ_THREADS - 1) / DZ_THREADS, n < DZ_ROW_BLOCKS ? n : DZ_ROW_BLOCKS);
  const T* gp = static_cast<const T*>(g);
  const T* zp = static_cast<const T*>(z);
  const float* f[6] = {static_cast<const float*>(mask), static_cast<const float*>(mean),
                       static_cast<const float*>(r), static_cast<const float*>(beta),
                       static_cast<const float*>(c1), static_cast<const float*>(c2)};
  if (route == 1) {
    bn_dz_kernel<T, V><<<grid, DZ_THREADS, 0, s>>>(gp, zp, f[0], f[1], f[2], f[3], f[4], f[5],
                                                   static_cast<T*>(dz), n, h);
  } else {
    bn_dz_kernel<T, 1><<<grid, DZ_THREADS, 0, s>>>(gp, zp, f[0], f[1], f[2], f[3], f[4], f[5],
                                                   static_cast<T*>(dz), n, h);
  }
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || dh == nullptr) return code;
  // dh [n, k] = dz [n, h] @ w^T, w [k, h] read as the K-major B operand
  const tkgemm::StoreEpi<T> epi{static_cast<T*>(dh), k};
  return tkgemm::launch<T, true>(route, static_cast<const T*>(dz), static_cast<const T*>(w), n, k, h, epi, s);
}

}  // namespace

extern "C" int tk_bn_dgrad_f32(const void* g, const void* z, const void* mask, const void* w,
                               const void* mean, const void* r, const void* beta, const void* c1,
                               const void* c2, void* dh, void* dz, int n, int h, int k, int route,
                               void* stream) {
  return launch<float>(g, z, mask, w, mean, r, beta, c1, c2, dh, dz, n, h, k, route, stream);
}

extern "C" int tk_bn_dgrad_bf16(const void* g, const void* z, const void* mask, const void* w,
                                const void* mean, const void* r, const void* beta, const void* c1,
                                const void* c2, void* dh, void* dz, int n, int h, int k, int route,
                                void* stream) {
  return launch<__nv_bfloat16>(g, z, mask, w, mean, r, beta, c1, c2, dh, dz, n, h, k, route, stream);
}
