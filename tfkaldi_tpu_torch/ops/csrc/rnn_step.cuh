// Shared parts of the bidirectional recurrence kernels (lstm_bidi.cu,
// gru_bidi.cu): the persistent forward (kernels 4 and 6), the per-step
// forward and backward products, the pointer blocks of a direction, the
// host loop that launches one step after another, and the host side of
// each entry (run_persistent_fwd, run_fwd, run_bwd).
//
// THE PERSISTENT FORWARD (persistent_fwd; replaces the one-launch-per-step
// forward wherever the wrapper's launch plan, ops/rnn_bidi.py::fwd_plan,
// finds that a CTA's W_h slice fits in shared memory and the grid fits one
// CTA per SM; the plan decides from the shape and the dtype before launch). One cooperative launch runs a
// whole layer call: both directions (blockIdx.z), all T steps in a loop
// inside the kernel. A CTA owns P_UNITS = 16 hidden units j of one
// direction, all G gate columns of them (g*H + j), and one or more row
// tiles of P_ROWS = 64 batch rows (tiles blockIdx.y, blockIdx.y +
// gridDim.y, ...; at most P_MAXR). It loads its W_h slice [H, G*16] into
// shared memory once (cp.async), and keeps it there for every step. Per
// step and row tile it stages round_cd(h_{t-1}) [64, H] from L2 in
// K-chunks with cp.async (all chunks of a 512-wide bf16 tile in flight at
// once), runs the product (bf16: mma.sync m16n8k16 on the tensor cores,
// f32 accumulate; f32: FMA, TF32 stays off), then the cell's elementwise
// step in the thread that holds the accumulators of its (row, j) pairs:
// 8 warps = 4 row groups of 16 x 2 unit groups of 8, each thread owning
// rows {r, r+8} x units {j, j+1} with every gate of them (the mma
// accumulator layout puts gate g of a pair in n-tile g at the same place).
// The f32 carries h and c stay in that thread's registers for the whole
// sequence (rotated through a fixed register array when a CTA loops over
// several row tiles). Only round_cd(h_t) leaves the CTA: it is published
// to a [B, H] slot in the compute dtype that the other CTAs' products read
// next step; with residuals that slot is the h_cd residual of step t+1
// itself (one buffer serves both), without them two ping-pong slots. The
// steps of one direction are ordered by a counter barrier per direction
// (arrive: red.release once the published h is written; wait: spin on an
// ld.acquire), the two directions never wait for each other. Between
// arrive and wait the CTA writes the step's other outputs and loads the
// gx and mask of the next step into registers, so both hide behind the
// wait. The grid must be co-resident or the barrier deadlocks: the host
// side checks the occupancy calculator against the grid and launches with
// cudaLaunchCooperativeKernel, which refuses a grid that does not fit;
// either raises in the wrapper.
//
// THE STEP KERNELS (the backward, kernels 5 and 7, and the forward on the
// shapes the persistent plan refuses). One launch is one time step of BOTH
// directions of a layer (blockIdx.z is the direction), as the TPU kernels
// interleave them; the launch boundary is the step's grid-wide barrier. A
// block owns BM batch rows x BJ hidden units j. Each thread owns RPT = 4
// consecutive rows of one unit, and so holds every gate column (g*H + j)
// of its (row, j) pairs: the step's elementwise math runs in the thread
// that finished the product, with no exchange between threads.
//
// Forward product (per direction): gates[b, g*H + j] = sum_k
// round_cd(h[b, k]) * W_h[k, g*H + j], K = H, f32 accumulation.
// Backward product: dh[b, j] = sum_k round_cd(dg_prev[b, k]) * W_h[j, k],
// K = G*H; W_h^T is never formed: the B loader reads W_h row j along k.
// In the step kernels bf16 operands are widened to f32 while they are
// staged into shared memory, so both dtypes run on the FMA units; the
// products of bf16 values are exact in f32 and only the summation order
// differs from the plain version, as in the persistent kernel's mma. The
// rounding to the compute dtype uses __float2bfloat16_rn, as
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
  void* h;          // step kernels: f32 [2, B, H] ping-pong carry, h[0] zero on entry;
                    // persistent kernel without residuals: [2, B, H] compute-dtype
                    // exchange slots of round_cd(h) (no initial value needed)
  float* c;         // [B, H] cell carry (LSTM, step kernels), zero on entry
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
                (float*)p[4], (void*)p[5], (float*)p[6], (void*)p[7], (float*)p[8]};
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


// ---------------------------------------------------------------------------
// The persistent forward (see the note at the top). The tiling constants
// are mirrored by ops/rnn_bidi.py::fwd_plan; tk_rnn_fwd_smem reports the
// shared-memory size so a card test can hold the two together.
// ---------------------------------------------------------------------------

constexpr int P_ROWS = 64;      // batch rows of a row tile: 4 warps x 16
constexpr int P_UNITS = 16;     // hidden units of a CTA: 2 warps x 8
constexpr int P_THREADS = 256;  // 8 warps
constexpr int P_MAXR = 4;       // row tiles one CTA may loop over

// The staging of h: K-chunks of KC columns in a ring of NST stages; rows
// padded by PADK (h) and PADN (W_h) elements (16 bytes), so the ldmatrix
// and float4 reads of 8 rows hit 8 different bank groups.
template <typename T>
struct Pipe;
template <>
struct Pipe<__nv_bfloat16> {
  static constexpr int KC = 64, NST = 8, PADK = 8, PADN = 8;
};
template <>
struct Pipe<float> {
  static constexpr int KC = 32, NST = 4, PADK = 4, PADN = 4;
};

// Dynamic shared memory of a CTA: W_h slice [KR][G*16 + PADN] and the h
// ring [NST][64][KC + PADK], KR = H rounded up to KC.
template <typename T>
inline size_t persistent_smem(int gates, int h) {
  using Pp = Pipe<T>;
  const size_t kr = static_cast<size_t>((h + Pp::KC - 1) / Pp::KC) * Pp::KC;
  return (kr * (gates * P_UNITS + Pp::PADN) +
          static_cast<size_t>(Pp::NST) * P_ROWS * (Pp::KC + Pp::PADK)) * sizeof(T);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared through L2 only (.cg: the published h is never
// read from a stale L1); zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
// c += a @ b on the tensor cores: a [16 x 16] bf16 (row), b [16 x 8] bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ws[k][g*16 + jj] = w[k, g*H + u0 + jj] for k < KR (zero where k >= H or
// u0 + jj >= H): the CTA's W_h slice, loaded once per call.
template <int G, typename T>
__device__ void stage_w(T* ws, const T* __restrict__ w, int H, int KR, int u0, bool vec) {
  constexpr int NP = G * P_UNITS + Pipe<T>::PADN;
  if (vec) {
    constexpr int EPP = 16 / sizeof(T);           // elements per 16-byte piece
    constexpr int PPR = G * P_UNITS / EPP;        // pieces per k row
    for (int e = threadIdx.x; e < KR * PPR; e += P_THREADS) {
      const int k = e / PPR, n = (e % PPR) * EPP, j = u0 + n % P_UNITS;
      const bool ok = k < H && j < H;  // H % EPP == 0: a piece is all in or all out
      cp_async16(ws + k * NP + n, ok ? w + static_cast<int64_t>(k) * G * H + (n / P_UNITS) * H + j : w, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = threadIdx.x; e < KR * G * P_UNITS; e += P_THREADS) {
      const int k = e / (G * P_UNITS), n = e % (G * P_UNITS), j = u0 + n % P_UNITS;
      ws[k * NP + n] = (k < H && j < H) ? w[static_cast<int64_t>(k) * G * H + (n / P_UNITS) * H + j]
                                        : from_f32<T>(0.0f);
    }
  }
  __syncthreads();
}

// dst[r][kk] = src[row0 + r, k0 + kk] for one K-chunk of a row tile, zero
// outside [B, H]; src is a published [B, H] slot of round_cd(h).
template <typename T>
__device__ __forceinline__ void stage_h(T* dst, const T* src, int B, int H, int row0, int k0, bool vec) {
  using Pp = Pipe<T>;
  constexpr int LD = Pp::KC + Pp::PADK;
  if (vec) {
    constexpr int EPP = 16 / sizeof(T);
    constexpr int PPR = Pp::KC / EPP;
    for (int e = threadIdx.x; e < P_ROWS * PPR; e += P_THREADS) {
      const int r = e / PPR, kk = (e % PPR) * EPP, row = row0 + r, k = k0 + kk;
      const bool ok = row < B && k < H;
      cp_async16(dst + r * LD + kk, ok ? src + static_cast<int64_t>(row) * H + k : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < P_ROWS * Pp::KC; e += P_THREADS) {
      const int r = e / Pp::KC, kk = e % Pp::KC, row = row0 + r, k = k0 + kk;
      dst[r * LD + kk] = (row < B && k < H) ? src[static_cast<int64_t>(row) * H + k] : from_f32<T>(0.0f);
    }
  }
}

// acc[g][p] += sum over one staged K-chunk: the warp's 16 rows x 8 units of
// each gate g. bf16: mma.sync, A from the h ring (ldmatrix), B from the
// resident W_h slice (ldmatrix.trans).
template <int G>
__device__ __forceinline__ void chunk_product(const __nv_bfloat16* hs, const __nv_bfloat16* ws, int k0,
                                              float (&acc)[G][4]) {
  using Pp = Pipe<__nv_bfloat16>;
  constexpr int LD = Pp::KC + Pp::PADK, NP = G * P_UNITS + Pp::PADN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const __nv_bfloat16* a_row = hs + ((warp % 4) * 16 + lane % 16) * LD + (lane / 16) * 8;
  const __nv_bfloat16* b_row = ws + (k0 + lane % 16) * NP + (warp / 4) * 8;
#pragma unroll
  for (int kk = 0; kk < Pp::KC; kk += 16) {
    unsigned a[4];
    ldsm_x4(a, a_row + kk);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      unsigned b[2];
      ldsm_x2_trans(b, b_row + kk * NP + g * P_UNITS);
      mma_bf16(acc[g], a, b);
    }
  }
}

// f32: FMA over the same ownership (rows r, r+8 x units j, j+1 of each gate).
template <int G>
__device__ __forceinline__ void chunk_product(const float* hs, const float* ws, int k0, float (&acc)[G][4]) {
  using Pp = Pipe<float>;
  constexpr int LD = Pp::KC + Pp::PADK, NP = G * P_UNITS + Pp::PADN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* h0 = hs + ((warp % 4) * 16 + lane / 4) * LD;
  const float* h1 = h0 + 8 * LD;
  const float* wc = ws + k0 * NP + (warp / 4) * 8 + (lane % 4) * 2;
#pragma unroll 2
  for (int kk = 0; kk < Pp::KC; kk += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(h0 + kk);
    const float4 x1 = *reinterpret_cast<const float4*>(h1 + kk);
    const float a0[4] = {x0.x, x0.y, x0.z, x0.w}, a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 w = *reinterpret_cast<const float2*>(wc + (kk + q) * NP + g * P_UNITS);
        acc[g][0] = fmaf(a0[q], w.x, acc[g][0]);
        acc[g][1] = fmaf(a0[q], w.y, acc[g][1]);
        acc[g][2] = fmaf(a1[q], w.x, acc[g][2]);
        acc[g][3] = fmaf(a1[q], w.y, acc[g][3]);
      }
    }
  }
}

// The barrier between the steps of one direction, split in two so the
// residual stores and the next gx loads run while the other CTAs arrive
// (the pattern of CUTLASS's GenericBarrier): arrive once the CTA's
// published h is written (the block sync orders every thread's stores
// before thread 0's release), wait until `target` CTAs in all have
// arrived (thread 0's acquire, then the block sync). A step takes
// microseconds; a wait of 2^26 polls (tens of seconds) means a CTA of the
// grid is not running, and the kernel traps (a launch error the wrapper
// raises) rather than hang the card.
__device__ __forceinline__ void dir_arrive(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
}
__device__ __forceinline__ void dir_wait(const unsigned* ctr, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(ctr) : "memory");
      if (++polls == (1u << 26)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// base[i] = a, base[i + 1] = b (if `both`), in the element type of base;
// one 8-byte (bf16: 4-byte) store when `pair` (i even, so aligned).
__device__ __forceinline__ void put2(float* base, int64_t i, float a, float b, bool pair, bool both) {
  if (pair) {
    *reinterpret_cast<float2*>(base + i) = make_float2(a, b);
  } else {
    base[i] = a;
    if (both) base[i + 1] = b;
  }
}
__device__ __forceinline__ void put2(__nv_bfloat16* base, int64_t i, float a, float b, bool pair,
                                     bool both) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(base + i) = __floats2bfloat162_rn(a, b);
  } else {
    base[i] = __float2bfloat16_rn(a);
    if (both) base[i + 1] = __float2bfloat16_rn(b);
  }
}

template <int N>
__device__ __forceinline__ void rotate(float (&x)[N][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float first = x[0][p];
#pragma unroll
    for (int i = 0; i + 1 < N; ++i) x[i][p] = x[i + 1][p];
    x[N - 1][p] = first;
  }
}

// Cell: G and step(gx[G], acc[G], m, h, c, act[G], state, ghn), the
// elementwise step of one (row, j) pair (lstm_bidi.cu, gru_bidi.cu).
// Grid (ceil(H/16), row CTAs, dirs), P_THREADS threads, persistent_smem bytes.
template <class Cell, typename T, bool RES>
__global__ void __launch_bounds__(P_THREADS, 1)
persistent_fwd(FwdDir d0, FwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
               unsigned* __restrict__ bar) {
  constexpr int G = Cell::G;
  using Pp = Pipe<T>;
  constexpr int LD = Pp::KC + Pp::PADK;
  constexpr int EPP = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.z;
  const FwdDir d = dir == 0 ? d0 : d1;
  const T* w = static_cast<const T*>(d.wh);
  T* hx = static_cast<T*>(RES ? d.hcd : d.h);  // the published round_cd(h) slots
  const int KR = (H + Pp::KC - 1) / Pp::KC * Pp::KC;
  const int nchunks = KR / Pp::KC;
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hs = ws + static_cast<size_t>(KR) * (G * P_UNITS + Pp::PADN);
  const int u0 = blockIdx.x * P_UNITS;
  const bool vec = H % EPP == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(hx)) & 15) == 0;
  stage_w<G, T>(ws, w, H, KR, u0, vec);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r_own = (warp % 4) * 16 + lane / 4;             // rows r_own, r_own + 8 of a tile
  const int j_own = u0 + (warp / 4) * 8 + (lane % 4) * 2;   // units j_own, j_own + 1
  const int tiles = (B + P_ROWS - 1) / P_ROWS;
  const int row_ctas = static_cast<int>(gridDim.y);
  const int mine = (tiles - static_cast<int>(blockIdx.y) + row_ctas - 1) / row_ctas;
  const unsigned ctas = gridDim.x * gridDim.y;  // CTAs of this direction

  float hc[P_MAXR][4] = {}, cc[P_MAXR][4] = {};  // the f32 carries, pair p = 2 * (row + 8?) + (j + 1?)
  float gxr[G][4], mr[2];                        // gx and mask of the next work item

  // The units j_own, j_own + 1 of a row are adjacent: with H even they move
  // as one 8-byte pair (4 bytes in bf16), so a warp's access covers whole
  // 32-byte sectors.
  const bool pairs = H % 2 == 0;
  auto step_t = [&](int s) { return dir == 0 ? s : t_len - 1 - s; };
  auto fetch = [&](int s, int i) {  // gx and mask of step s, this CTA's row tile i
    const int64_t tb = static_cast<int64_t>(step_t(s)) * B;
    const int row0 = (blockIdx.y + i * gridDim.y) * P_ROWS;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = row0 + r_own + 8 * rh;
      const bool ok = row < B && j_own < H;
      const float* src = d.gx + (tb + row) * G * H + j_own;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float2 v = make_float2(0.0f, 0.0f);
        if (ok && pairs) {
          v = *reinterpret_cast<const float2*>(src + g * H);
        } else if (ok) {
          v.x = src[g * H];
          if (j_own + 1 < H) v.y = src[g * H + 1];
        }
        gxr[g][2 * rh] = v.x;
        gxr[g][2 * rh + 1] = v.y;
      }
      mr[rh] = row < B ? mask[tb + row] : 0.0f;
    }
  };

  fetch(0, 0);
  for (int s = 0; s < t_len; ++s) {
    const int t = step_t(s);
    const T* h_in = hx + static_cast<int64_t>(RES ? t : (s & 1)) * B * H;  // round_cd(h_{t-1}), s > 0
    T* h_out = s + 1 < t_len ? hx + static_cast<int64_t>(RES ? step_t(s + 1) : ((s + 1) & 1)) * B * H
                             : nullptr;
#pragma unroll 1
    for (int i = 0; i < P_MAXR; ++i) {
      if (i < mine) {
        const int row0 = (blockIdx.y + i * gridDim.y) * P_ROWS;
        float acc[G][4] = {};
        if (s > 0) {  // h_{-1} = 0: the first step has no product
          __syncthreads();  // the ring's readers of the previous tile are done
#pragma unroll
          for (int c = 0; c < Pp::NST - 1; ++c) {
            if (c < nchunks) stage_h<T>(hs + c * P_ROWS * LD, h_in, B, H, row0, c * Pp::KC, vec);
            cp_async_commit();
          }
          for (int c = 0; c < nchunks; ++c) {
            cp_async_wait<Pp::NST - 2>();
            __syncthreads();  // chunk c is in; stage (c - 1) % NST is free
            const int n = c + Pp::NST - 1;
            if (n < nchunks) stage_h<T>(hs + (n % Pp::NST) * P_ROWS * LD, h_in, B, H, row0, n * Pp::KC, vec);
            cp_async_commit();
            chunk_product<G>(hs + (c % Pp::NST) * P_ROWS * LD, ws, c * Pp::KC, acc);
          }
        }
        float act[2][2][G], state[2][2], ghn[2][2];  // [row r / r + 8][unit j / j + 1]
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float gx[G], pre[G];
#pragma unroll
          for (int g = 0; g < G; ++g) gx[g] = gxr[g][p], pre[g] = acc[g][p];
          Cell::step(gx, pre, mr[p / 2], hc[0][p], cc[0][p], act[p / 2][p % 2], state[p / 2][p % 2],
                     ghn[p / 2][p % 2]);
        }
        const bool both = pairs || j_own + 1 < H;
        // publish round_cd(h_t) first: it is all the next step waits for
        if (h_out != nullptr && j_own < H) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int row = row0 + r_own + 8 * rh;
            if (row < B) {
              put2(h_out, static_cast<int64_t>(row) * H + j_own, hc[0][2 * rh], hc[0][2 * rh + 1], pairs, both);
            }
          }
        }
        if (i + 1 == mine && s + 1 < t_len) dir_arrive(bar + dir);  // the CTA's last tile of the step
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = row0 + r_own + 8 * rh;
          if (row < B && j_own < H) {
            const float m = mr[rh];
            const int64_t at = (static_cast<int64_t>(t) * B + row) * H + j_own;  // [T, B, H] streams
            put2(d.ys, at, mul(hc[0][2 * rh], m), mul(hc[0][2 * rh + 1], m), pairs, both);
            if (RES) {
              const int64_t at_g = (static_cast<int64_t>(t) * B + row) * G * H + j_own;  // [T, B, G*H]
#pragma unroll
              for (int g = 0; g < G; ++g) put2(d.acts, at_g + g * H, act[rh][0][g], act[rh][1][g], pairs, both);
              put2(d.state, at, state[rh][0], state[rh][1], pairs, both);
              if (G == 3) put2(d.ghn, at, ghn[rh][0], ghn[rh][1], pairs, both);
              if (s == 0) put2(hx, at, 0.0f, 0.0f, pairs, both);  // h_cd of the first step
            }
          }
        }
        if (i + 1 < mine) {
          fetch(s, i + 1);
        } else if (s + 1 < t_len) {
          fetch(s + 1, 0);  // in flight while this CTA waits at the barrier
        }
      }
      rotate(hc);
      rotate(cc);
    }
    if (s + 1 < t_len) dir_wait(bar + dir, static_cast<unsigned>(s + 1) * ctas);
  }
}

// The host side of a persistent forward entry: checks that the grid
// (ceil(H/16), row_ctas, dirs) can be co-resident, then one cooperative
// launch. bar: 2 zeroed counters (one per direction). Returns a CUDA error
// code (cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident).
template <class Cell, typename T>
int run_persistent_fwd(const void* const* p, const void* mask, int dirs, int t_len, int b, int h,
                       int residuals, int row_ctas, void* bar, void* stream) {
  if (dirs < 1 || dirs > 2 || row_ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t_len <= 0 || b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (b + P_ROWS - 1) / P_ROWS;
  if (row_ctas > tiles || (tiles + row_ctas - 1) / row_ctas > P_MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdDir d0 = fwd_dir(p);
  FwdDir d1 = dirs > 1 ? fwd_dir(p + PTRS) : d0;
  void (*kernel)(FwdDir, FwdDir, const float*, int, int, int, unsigned*) =
      residuals ? persistent_fwd<Cell, T, true> : persistent_fwd<Cell, T, false>;
  const size_t smem = persistent_smem<T>(Cell::G, h);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P_THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((h + P_UNITS - 1) / P_UNITS, row_ctas, dirs);
  if (static_cast<int64_t>(per_sm) * sms < static_cast<int64_t>(grid.x) * grid.y * grid.z)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* m = static_cast<const float*>(mask);
  unsigned* counters = static_cast<unsigned*>(bar);
  void* args[] = {&d0, &d1, &m, &t_len, &b, &h, &counters};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, dim3(P_THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tk_rnn
