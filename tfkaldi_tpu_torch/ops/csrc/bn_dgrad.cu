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
// What bounds it on an H100: at the flagship shape (N = 65,536 rows =
// batch 128 x 512 frames, H = K = 2048, f32) the product does
// 2*N*H*K = 549.8 GFLOP, 8.2 ms at the 67 TFLOP/s f32-FMA rate, while the
// bytes it must move (g, z, w in; dz, dh out: 2.16 GB) take 0.64 ms at
// 3.35 TB/s, so it is bound by arithmetic. The 440-wide layer 0 is
// 118.1 GFLOP (1.76 ms) if dh is computed; there dh is not needed and the
// kernel only writes dz, which is bound by bytes (g, z in, dz out: 1.6 GB,
// 0.48 ms). f32 operands contract in full f32 (no TF32), as the reference
// does (tfkaldi_tpu/ops/fused_mlp.py:48-53), so the tensor cores are out
// and the ceiling is the FMA units.
//
// What the design does about it: the register-blocked SGEMM of
// fused_ffn.cu (a 128x128 output tile per block of 256 threads, depth
// steps of 8, an 8x8 accumulator per thread read as float4 shared loads,
// the next slab loaded into registers while the current one is multiplied,
// two shared buffers, one barrier per step), with the BN backward formula
// in the A-slab loader: each thread turns 4 (g, z) pairs into 4 dz values
// on the way into shared memory, so dz is never read back from HBM for
// dh. The blocks of column 0 store dz exactly once (rounded to the compute
// dtype, the A operand the product uses); the other column blocks
// recompute it from g and z, which they find in L2. Two blocks share an SM
// (at most 128 registers a thread), and g, z and w rows are read with
// 16-byte loads where a row allows it. The arithmetic of dz
// uses __f*_rn intrinsics so nvcc cannot contract it into FMAs: dz is
// bit-equal to the plain PyTorch version, and dh differs from it only in
// summation order. w^T is not materialised: the B loader reads w [K, H]
// row by row (4 consecutive h of one k per thread) and stores it
// transposed into shared memory. Edges fall back to scalar masked loads,
// so any N, H, K works. With dh == nullptr (the first layer,
// whose input needs no gradient) the grid has one column of blocks and the
// kernel skips the product. The bf16 instantiation widens to f32 while
// staging, accumulates in f32, and stores bf16. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows of dz / dh per block
constexpr int BN = 128;  // columns of dh (rows of w) per block
constexpr int BK = 8;    // depth (hidden units) staged per step
constexpr int THREADS = 256;
constexpr int PER_THREAD = BM * BK / THREADS;  // 4 consecutive depth values of one row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void load_vec4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}
// round an f32 value to the compute dtype and back (exact widening)
template <typename T>
__device__ __forceinline__ float round_cd(float v);
template <>
__device__ __forceinline__ float round_cd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bn_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ z,
                const float* __restrict__ mask, const T* __restrict__ w,
                const float* __restrict__ mean, const float* __restrict__ r,
                const float* __restrict__ beta, const float* __restrict__ c1,
                const float* __restrict__ c2, T* __restrict__ dh, T* __restrict__ dz,
                int n, int h, int k) {
  __shared__ __align__(16) float as[2][BK][BM];  // dz slab, transposed: as[kk][row]
  __shared__ __align__(16) float bs[2][BK][BN];  // w^T slab: bs[kk][col] = w[col][kk]

  const bool gemm = dh != nullptr;
  const bool store_dz = blockIdx.x == 0;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  // this thread's share of each slab: one row (A) / one column of dh (B),
  // 4 consecutive depth values
  const int ld_idx = tid / (BK / PER_THREAD);                // 0..127
  const int ld_k = (tid % (BK / PER_THREAD)) * PER_THREAD;   // 0 or 4
  const int64_t a_row = row0 + ld_idx;
  const bool a_row_ok = a_row < n;
  const float m = a_row_ok ? mask[a_row] : 0.0f;
  const int64_t b_col = col0 + ld_idx;
  const bool b_col_ok = b_col < k;

  float a_reg[PER_THREAD];
  float b_reg[PER_THREAD];
  // 4 consecutive elements: one 16-byte (f32) or 8-byte (bf16) load when
  // the row is aligned for it, else scalar loads with the edge masked
  constexpr uintptr_t kVecBytes = 4 * sizeof(T);
  const bool vec_ok = h % 4 == 0 && reinterpret_cast<uintptr_t>(g) % kVecBytes == 0 &&
                      reinterpret_cast<uintptr_t>(z) % kVecBytes == 0 &&
                      reinterpret_cast<uintptr_t>(w) % kVecBytes == 0;
  auto load4 = [&](const T* p, int valid, float* out) {
    if (vec_ok && valid == 4) {
      load_vec4(p, out);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = i < valid ? to_f32(p[i]) : 0.0f;
    }
  };
  auto load_slab = [&](int k0) {
    const int c0 = k0 + ld_k;
    const int valid = max(0, min(PER_THREAD, h - c0));
    float zv[PER_THREAD], gv[PER_THREAD];
    if (a_row_ok && valid > 0) {
      load4(z + a_row * h + c0, valid, zv);
      load4(g + a_row * h + c0, valid, gv);
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int c = c0 + i;
      float v = 0.0f;
      if (a_row_ok && i < valid) {
        const float xhat = __fsub_rn(zv[i], mean[c]);
        const float rc = r[c];
        const float bn = round_cd<T>(__fadd_rn(__fmul_rn(xhat, rc), beta[c]));
        const float dpre = bn > 0.0f ? gv[i] : 0.0f;
        const float fb = __fmul_rn(m, __fadd_rn(c1[c], __fmul_rn(xhat, c2[c])));
        v = round_cd<T>(__fsub_rn(__fmul_rn(rc, dpre), fb));
        if (store_dz) store(dz + a_row * h + c, v);
      }
      a_reg[i] = v;
    }
    if (gemm) {
      if (b_col_ok && valid > 0) {
        load4(w + b_col * h + c0, valid, b_reg);
      } else {
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j) b_reg[j] = 0.0f;
      }
    }
  };
  auto store_slab = [&](int buf) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      as[buf][ld_k + i][ld_idx] = a_reg[i];
      bs[buf][ld_k + i][ld_idx] = b_reg[i];
    }
  };

  if (!gemm) {  // dz only: no product, no shared memory
    for (int k0 = 0; k0 < h; k0 += BK) load_slab(k0);
    return;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_slab(0);
  store_slab(0);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < h; k0 += BK) {
    const bool more = k0 + BK < h;
    if (more) load_slab(k0 + BK);  // in flight while this slab is multiplied

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (more) store_slab(buf ^ 1);  // the other buffer: nobody reads it now
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    if (col >= k) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (row >= n) continue;
      store(dh + row * k + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* g, const void* z, const void* mask, const void* w, const void* mean,
           const void* r, const void* beta, const void* c1, const void* c2, void* dh,
           void* dz, int n, int h, int k, void* stream) {
  if (n > 0) {
    const int grid_x = dh != nullptr && k > 0 ? (k + BN - 1) / BN : 1;
    dim3 grid(grid_x, (n + BM - 1) / BM);
    bn_dgrad_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const T*>(z), static_cast<const float*>(mask),
        static_cast<const T*>(w), static_cast<const float*>(mean), static_cast<const float*>(r),
        static_cast<const float*>(beta), static_cast<const float*>(c1),
        static_cast<const float*>(c2), static_cast<T*>(dh), static_cast<T*>(dz), n, h, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tk_bn_dgrad_f32(const void* g, const void* z, const void* mask, const void* w,
                               const void* mean, const void* r, const void* beta,
                               const void* c1, const void* c2, void* dh, void* dz, int n,
                               int h, int k, void* stream) {
  return launch<float>(g, z, mask, w, mean, r, beta, c1, c2, dh, dz, n, h, k, stream);
}

extern "C" int tk_bn_dgrad_bf16(const void* g, const void* z, const void* mask, const void* w,
                                const void* mean, const void* r, const void* beta,
                                const void* c1, const void* c2, void* dh, void* dz, int n,
                                int h, int k, void* stream) {
  return launch<__nv_bfloat16>(g, z, mask, w, mean, r, beta, c1, c2, dh, dz, n, h, k, stream);
}
