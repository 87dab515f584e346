// Shared parts of the bidirectional recurrence kernels (lstm_bidi.cu,
// gru_bidi.cu): the per-step products, the pointer blocks of a direction,
// the host loop that launches one step after another, and the host side
// of each entry (run_fwd, run_bwd).
//
// One launch is one time step of BOTH directions of a layer (blockIdx.z is
// the direction), as the TPU kernels interleave them; the launch boundary
// is the step's grid-wide barrier. A block owns BM batch rows x BJ hidden
// units j. Each thread owns RPT = 4 consecutive rows of one unit, and so
// holds every gate column (g*H + j) of its (row, j) pairs: the step's
// elementwise math runs in the thread that finished the product, with no
// exchange between threads.
//
// Forward product (per direction): gates[b, g*H + j] = sum_k
// round_cd(h[b, k]) * W_h[k, g*H + j], K = H, f32 accumulation.
// Backward product: dh[b, j] = sum_k round_cd(dg_prev[b, k]) * W_h[j, k],
// K = G*H; W_h^T is never formed: the B loader reads W_h row j along k.
// bf16 operands are widened to f32 while they are staged into shared
// memory, so both dtypes run on the FMA units; the products of bf16 values
// are exact in f32 and only the summation order differs from the plain
// version. The rounding to the compute dtype uses __float2bfloat16_rn, as
// .to(torch.bfloat16) does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tk_rnn {

constexpr int BM = 32;       // batch rows per block
constexpr int BJ = 16;       // hidden units per block
constexpr int BK = 32;       // depth staged per shared-memory pass
constexpr int RPT = 4;       // rows per thread (one float4 of the A slab)
constexpr int THREADS = BJ * (BM / RPT);  // 128
constexpr int PTRS = 9;      // pointers per direction passed from the host

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_cd(float v) { return to_f32(from_f32<T>(v)); }

// The rounded ops below (__f*_rn) keep nvcc from contracting the cell's
// elementwise arithmetic into FMAs, so it rounds where the plain version
// does; sigmoid and tanh are computed in f32 (expf, tanhf).
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.0f, add(1.0f, expf(-x))); }

// Forward pointers of one direction (the host passes PTRS per direction,
// in this order; an unused one is null).
struct FwdDir {
  const float* gx;  // [T, B, G*H] input projections + bias
  const void* wh;   // [H, G*H] compute dtype
  float* ys;        // [T, B, H]  h_t * m_t
  float* acts;      // [T, B, G*H] post-activation gates (residual) or null
  float* state;     // [T, B, H] c_t (LSTM) / h_t (GRU) (residual) or null
  void* hcd;        // [T, B, H] round_cd(h_{t-1}) (residual) or null
  float* ghn;       // [T, B, H] recurrent n projection (GRU residual) or null
  float* h;         // [2, B, H] ping-pong carry; h[0] zero on entry
  float* c;         // [B, H] cell carry (LSTM), zero on entry
};

// Backward pointers of one direction.
struct BwdDir {
  const float* dy;     // [T, B, H]
  const float* acts;   // [T, B, G*H]
  const float* state;  // [T, B, H] cs (LSTM) / hs (GRU)
  const float* ghn;    // [T, B, H] (GRU)
  const void* wh;      // [H, G*H] compute dtype
  float* dgx;          // [T, B, G*H]
  float* dgh;          // [T, B, G*H] (GRU)
  float* dh;           // [B, H] carry: dh before the next step's product
  float* dc;           // [B, H] cell carry (LSTM)
};

inline FwdDir fwd_dir(const void* const* p) {
  return FwdDir{static_cast<const float*>(p[0]), p[1], (float*)p[2], (float*)p[3],
                (float*)p[4], (void*)p[5], (float*)p[6], (float*)p[7], (float*)p[8]};
}

inline BwdDir bwd_dir(const void* const* p) {
  return BwdDir{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), p[4],
                (float*)p[5], (float*)p[6], (float*)p[7], (float*)p[8]};
}

// acc[r][g] += sum_k round_cd(h[row0 + rg*RPT + r, k]) * w[k, g*H + j0 + jl]
template <int G, typename T>
__device__ __forceinline__ void fwd_product(const float* __restrict__ h, const T* __restrict__ w,
                                            int B, int H, int row0, int j0,
                                            float (&acc)[RPT][G]) {
  __shared__ __align__(16) float as[BK][BM + 4];  // h slab, transposed: as[kk][row]
  __shared__ float bs[BK][G * BJ];                // w slab: bs[kk][g*BJ + jj]
  const int tid = threadIdx.x;
  const int jl = tid % BJ;
  const int rg = tid / BJ;
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, row = row0 + r, k = k0 + kk;
      as[kk][r] = (row < B && k < H) ? round_cd<T>(h[static_cast<int64_t>(row) * H + k]) : 0.0f;
    }
    for (int e = tid; e < BK * G * BJ; e += THREADS) {
      const int jj = e % BJ, g = (e / BJ) % G, kk = e / (BJ * G), k = k0 + kk, j = j0 + jj;
      bs[kk][g * BJ + jj] =
          (k < H && j < H) ? to_f32(w[static_cast<int64_t>(k) * (G * H) + g * H + j]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][rg * RPT]);
      const float av[RPT] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float b = bs[kk][g * BJ + jl];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r][g] = fmaf(av[r], b, acc[r][g]);
      }
    }
    __syncthreads();
  }
}

// acc[r] += sum_k round_cd(dg[row0 + rg*RPT + r, k]) * w[j0 + jl, k], K = G*H
template <int G, typename T>
__device__ __forceinline__ void bwd_product(const float* __restrict__ dg, const T* __restrict__ w,
                                            int B, int H, int row0, int j0, float (&acc)[RPT]) {
  __shared__ __align__(16) float as[BK][BM + 4];  // dg slab, transposed: as[kk][row]
  __shared__ float bs[BK][BJ + 1];                // W_h^T slab: bs[kk][jj] = w[j0 + jj, k0 + kk]
  const int K = G * H;
  const int tid = threadIdx.x;
  const int jl = tid % BJ;
  const int rg = tid / BJ;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, row = row0 + r, k = k0 + kk;
      as[kk][r] = (row < B && k < K) ? round_cd<T>(dg[static_cast<int64_t>(row) * K + k]) : 0.0f;
    }
    for (int e = tid; e < BK * BJ; e += THREADS) {
      const int jj = e / BK, kk = e % BK, j = j0 + jj, k = k0 + kk;
      bs[kk][jj] = (j < H && k < K) ? to_f32(w[static_cast<int64_t>(j) * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][rg * RPT]);
      const float b = bs[kk][jl];
      acc[0] = fmaf(a.x, b, acc[0]);
      acc[1] = fmaf(a.y, b, acc[1]);
      acc[2] = fmaf(a.z, b, acc[2]);
      acc[3] = fmaf(a.w, b, acc[3]);
    }
    __syncthreads();
  }
}

// A step kernel: (direction 0, direction 1, mask [T, B], T, B, H, step s).
template <typename Dir>
using StepKernel = void (*)(Dir, Dir, const float*, int, int, int, int);

// The time loop on the host: T launches of one step kernel on the caller's
// stream, no synchronisation; returns the first launch error (0 if none).
template <typename Dir>
int launch_steps(StepKernel<Dir> kernel, const Dir& d0, const Dir& d1, int dirs,
                 const float* mask, int t_len, int b, int h, void* stream) {
  if (dirs < 1 || dirs > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (t_len <= 0 || b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((h + BJ - 1) / BJ, (b + BM - 1) / BM, dirs);
  for (int s = 0; s < t_len; ++s) {
    kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(d0, d1, mask, t_len, b, h, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The host side of a forward entry: unpack the pointer blocks (PTRS per
// direction, FwdDir order) and run the step kernel with or without residuals.
inline int run_fwd(StepKernel<FwdDir> with_residuals, StepKernel<FwdDir> without_residuals,
                   const void* const* p, const void* mask, int dirs, int t_len, int b, int h,
                   int residuals, void* stream) {
  const FwdDir d0 = fwd_dir(p);
  const FwdDir d1 = dirs > 1 ? fwd_dir(p + PTRS) : d0;
  return launch_steps<FwdDir>(residuals ? with_residuals : without_residuals, d0, d1, dirs,
                              static_cast<const float*>(mask), t_len, b, h, stream);
}

// The host side of a backward entry (BwdDir order).
inline int run_bwd(StepKernel<BwdDir> step, const void* const* p, const void* mask, int dirs,
                   int t_len, int b, int h, void* stream) {
  const BwdDir d0 = bwd_dir(p);
  const BwdDir d1 = dirs > 1 ? bwd_dir(p + PTRS) : d0;
  return launch_steps<BwdDir>(step, d0, d1, dirs, static_cast<const float*>(mask), t_len, b, h,
                              stream);
}

}  // namespace tk_rnn
