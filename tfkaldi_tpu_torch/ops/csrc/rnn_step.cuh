// Shared parts of the bidirectional recurrence kernels (lstm_bidi.cu,
// gru_bidi.cu): the persistent forward (kernels 4 and 6) and backward
// (kernels 5 and 7), the per-step forward and backward products, the
// pointer blocks of a direction, the host loop that launches one step
// after another, and the host side of each entry (run_persistent_fwd,
// run_persistent_bwd, run_fwd, run_bwd).
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
// THE PERSISTENT BACKWARD (persistent_bwd; wherever ops/rnn_bidi.py::bwd_plan
// takes the shape, as the forward's plan does). The same machinery in
// reverse time: one cooperative launch per layer call, both directions,
// all T steps. A CTA owns P_UNITS = 16 hidden units j of one direction and
// one or more 64-row tiles; per step and tile it computes dh = dh_carry +
// round_cd(dg_prev) @ W_h^T for its [64, 16] block, then the cell's
// elementwise backward, which yields the G gate cotangents of each of its
// (row, j) pairs. Its W_h rows [16, G*H] (W_h^T's columns, k contiguous,
// the mma B operand as ldmatrix reads it) are loaded into shared memory
// once a call; the f32 carries dh (and dc) stay in registers. The product's
// depth is K = G*H (2048 for the LSTM at H 512), so the staged operand, the
// published round_cd(dg_prev) of the tile's 64 rows, is [64, K]: 4x the
// forward's, 256 KB in bf16 each step. It streams through a ring of
// K-chunks (bf16 128 columns, f32 64), each two 2-d TMA boxes of 64 rows x
// 128 bytes with the 128-byte swizzle, issued by one thread and awaited on
// an mbarrier a stage, NST - 1 chunks in flight while the CTA multiplies
// the chunk that has landed (TMA rather than cp.async: a step of 16-byte
// cp.async copies is bound in each SM, not by what L2 serves). The output
// block is only [64, 16], so the 8 warps split K rather than the output:
// warp w takes columns [w*KW, (w+1)*KW) of every chunk and holds a partial sum of the
// whole block (bf16: 4 x 2 mma tiles, 8 independent accumulator chains;
// f32: 8 rows x 4 units of exact FMAs a thread); the 8 partial blocks are
// summed through shared memory (the ring, which is free by then), and
// each thread takes 4 adjacent units of one row for the elementwise step,
// so its inputs and outputs move as 16-byte vectors. Only round_cd(dg_t)
// of the CTA's [rows, G x 16] columns leaves it: it is published first to
// one of two [B, G*H] compute-dtype exchange slots, then the CTA arrives at
// its direction's counter barrier, stores dgx (and dgh) and loads the next
// step's dy, acts, state, gh_n and mask while it waits.
//
// THE STEP KERNELS (the forward and the backward on the shapes the
// persistent plans refuse). One launch is one time step of BOTH
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

#include "gemm_sm90.cuh"  // tkgemm: tensor maps, TMA loads and mbarrier waits

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
  void* dh;            // step kernels: f32 [B, H] carry, dh before the next step's product;
                       // persistent kernel: [2, B, G*H] compute-dtype exchange slots of
                       // round_cd(dg) (no initial value needed)
  float* dc;           // [B, H] cell carry (LSTM, step kernels)
};

inline FwdDir fwd_dir(const void* const* p) {
  return FwdDir{static_cast<const float*>(p[0]), p[1], (float*)p[2], (float*)p[3],
                (float*)p[4], (void*)p[5], (float*)p[6], (void*)p[7], (float*)p[8]};
}

inline BwdDir bwd_dir(const void* const* p) {
  return BwdDir{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), p[4],
                (float*)p[5], (float*)p[6], (void*)p[7], (float*)p[8]};
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

// The host side shared by the persistent entries: checks the row split,
// that the grid (ceil(H/16), row_ctas, dirs) can be co-resident with
// `smem` bytes a CTA, then one cooperative launch of `kernel` with `args`.
// Returns a CUDA error code (cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be resident).
inline int launch_persistent(const void* kernel, size_t smem, int dirs, int b, int h, int row_ctas, void** args,
                             void* stream) {
  const int tiles = (b + P_ROWS - 1) / P_ROWS;
  if (row_ctas > tiles || (tiles + row_ctas - 1) / row_ctas > P_MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
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
  err = cudaLaunchCooperativeKernel(kernel, grid, dim3(P_THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The host side of a persistent forward entry. bar: 2 zeroed counters (one
// per direction).
template <class Cell, typename T>
int run_persistent_fwd(const void* const* p, const void* mask, int dirs, int t_len, int b, int h,
                       int residuals, int row_ctas, void* bar, void* stream) {
  if (dirs < 1 || dirs > 2 || row_ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t_len <= 0 || b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  FwdDir d0 = fwd_dir(p);
  FwdDir d1 = dirs > 1 ? fwd_dir(p + PTRS) : d0;
  void (*kernel)(FwdDir, FwdDir, const float*, int, int, int, unsigned*) =
      residuals ? persistent_fwd<Cell, T, true> : persistent_fwd<Cell, T, false>;
  const float* m = static_cast<const float*>(mask);
  unsigned* counters = static_cast<unsigned*>(bar);
  void* args[] = {&d0, &d1, &m, &t_len, &b, &h, &counters};
  return launch_persistent(reinterpret_cast<const void*>(kernel), persistent_smem<T>(Cell::G, h), dirs, b, h,
                           row_ctas, args, stream);
}


// ---------------------------------------------------------------------------
// The persistent backward (see the note at the top). Its tiling constants
// are mirrored by ops/rnn_bidi.py::bwd_plan; tk_rnn_bwd_smem reports the
// shared-memory size so a card test can hold the two together.
// ---------------------------------------------------------------------------

constexpr int P_WARPS = P_THREADS / 32;                       // 8
constexpr int RED_FLOATS = P_WARPS * P_ROWS * P_UNITS;        // the warps' partial [64, 16] blocks

// The staging of round_cd(dg_prev): K-chunks of KC = 8 warps x KW columns
// in a ring of NST stages, each chunk two TMA boxes of [64 rows, 128
// bytes] side by side, 128-byte swizzle (the 16-byte piece q of row r lies
// at q ^ (r % 8), so the ldmatrix and float4 reads of 8 rows hit 8
// different bank groups); W_h's rows padded by PADN elements for the same
// reason.
template <typename T>
struct BwdPipe;
template <>
struct BwdPipe<__nv_bfloat16> {
  static constexpr int KC = 128, KW = 16, NST = 8, PADN = 8;
};
template <>
struct BwdPipe<float> {
  static constexpr int KC = 64, KW = 8, NST = 5, PADN = 4;
};
constexpr int BOX_BYTES = P_ROWS * 128;     // one TMA box: 64 rows of 128 bytes
constexpr int STAGE_BYTES = 2 * BOX_BYTES;  // a chunk: two boxes side by side
static_assert(BwdPipe<float>::NST * STAGE_BYTES >= RED_FLOATS * 4, "the ring holds the partial sums");

// Dynamic shared memory of a backward CTA: W_h rows [16][KR + PADN], KR =
// G*H rounded up to KC, up to 1 KB to align the ring, the ring (which also
// holds the partial sums) and one mbarrier per stage.
template <typename T>
inline size_t persistent_bwd_smem(int gates, int h) {
  using Pp = BwdPipe<T>;
  const size_t kr = static_cast<size_t>((gates * h + Pp::KC - 1) / Pp::KC) * Pp::KC;
  return P_UNITS * (kr + Pp::PADN) * sizeof(T) + 1024 + static_cast<size_t>(Pp::NST) * (STAGE_BYTES + 8);
}

// ws[jj][k] = w[u0 + jj, k] for k < KR (zero where k >= K or u0 + jj >= H):
// the CTA's W_h rows, loaded once per call.
template <typename T>
__device__ void stage_wt(T* ws, const T* __restrict__ w, int H, int K, int KR, int u0, bool vec) {
  const int np = KR + BwdPipe<T>::PADN;
  if (vec) {  // K % EPP == 0: a piece is all in or all out
    constexpr int EPP = 16 / sizeof(T);
    const int ppr = KR / EPP;
    for (int e = threadIdx.x; e < P_UNITS * ppr; e += P_THREADS) {
      const int jj = e / ppr, k = (e % ppr) * EPP, j = u0 + jj;
      const bool ok = j < H && k < K;
      cp_async16(ws + jj * np + k, ok ? w + static_cast<int64_t>(j) * K + k : w, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = threadIdx.x; e < P_UNITS * KR; e += P_THREADS) {
      const int jj = e / KR, k = e % KR, j = u0 + jj;
      ws[jj * np + k] = (j < H && k < K) ? w[static_cast<int64_t>(j) * K + k] : from_f32<T>(0.0f);
    }
  }
  __syncthreads();
}

// One warp's share of a staged K-chunk, and its partial [64, 16] block.
template <typename T>
struct BwdWarp;

// bf16: columns [w*16, w*16 + 16) of the chunk, mma.sync m16n8k16: A (the
// ring, 4 row tiles of 16) by ldmatrix, B (W_h^T, 2 unit tiles of 8) by one
// ldmatrix.x4 from the resident rows; acc[mt*2 + nt] is the mma tile (mt, nt).
template <>
struct BwdWarp<__nv_bfloat16> {
  static __device__ __forceinline__ void chunk(const unsigned char* as, const __nv_bfloat16* ws, int np, int k0,
                                               float (&acc)[8][4]) {
    using Pp = BwdPipe<__nv_bfloat16>;
    const int lane = threadIdx.x % 32, kk = (threadIdx.x / 32) * Pp::KW;
    unsigned b[4];  // (units 0-7, k 0-7), (units 0-7, k 8-15), (units 8-15, k 0-7), (units 8-15, k 8-15)
    ldsm_x4(b, ws + (lane % 8 + 8 * (lane / 16)) * np + k0 + kk + 8 * ((lane / 8) % 2));
    const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    // columns kk + (lane / 16) * 8 of the chunk: box kk / 64, 16-byte piece (kk % 64) / 8 + lane / 16
    const unsigned char* box = as + (kk / 64) * BOX_BYTES;
    const int piece = (kk % 64) / 8 + lane / 16;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      unsigned a[4];
      const int r = mt * 16 + lane % 16;
      ldsm_x4(a, box + r * 128 + ((piece ^ (r % 8)) << 4));
      mma_bf16(acc[mt * 2], a, b0);
      mma_bf16(acc[mt * 2 + 1], a, b1);
    }
  }
  // the warp's partial block into red [64][16]
  static __device__ __forceinline__ void partials(float* red, const float (&acc)[8][4]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* at = red + (mt * 16 + lane / 4) * P_UNITS + nt * 8 + 2 * (lane % 4);
        *reinterpret_cast<float2*>(at) = make_float2(acc[mt * 2 + nt][0], acc[mt * 2 + nt][1]);
        *reinterpret_cast<float2*>(at + 8 * P_UNITS) = make_float2(acc[mt * 2 + nt][2], acc[mt * 2 + nt][3]);
      }
    }
  }
};

// f32: columns [w*8, w*8 + 8) of the chunk, exact FMAs (TF32 off); a thread
// holds rows rg + 8i (i < 8) x units ug + 4q (q < 4), rg = lane / 4, ug =
// lane % 4, in acc[i][q], and reads them as float4 along k.
template <>
struct BwdWarp<float> {
  static __device__ __forceinline__ void chunk(const unsigned char* as, const float* ws, int np, int k0,
                                               float (&acc)[8][4]) {
    using Pp = BwdPipe<float>;
    const int lane = threadIdx.x % 32, kk = (threadIdx.x / 32) * Pp::KW;
    // rows lane / 4 + 8i (all with r % 8 = lane / 4) of box kk / 32
    const unsigned char* a0 = as + (kk / 32) * BOX_BYTES + (lane / 4) * 128;
    const float* b0 = ws + (lane % 4) * np + k0 + kk;
#pragma unroll
    for (int kq = 0; kq < Pp::KW; kq += 4) {
      float4 a[8], b[4];
      const int at = (((kk % 32 + kq) / 4) ^ (lane / 4)) << 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + 8 * i * 128 + at);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = *reinterpret_cast<const float4*>(b0 + 4 * q * np + kq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = fmaf(a[i].x, b[q].x, acc[i][q]);
          acc[i][q] = fmaf(a[i].y, b[q].y, acc[i][q]);
          acc[i][q] = fmaf(a[i].z, b[q].z, acc[i][q]);
          acc[i][q] = fmaf(a[i].w, b[q].w, acc[i][q]);
        }
      }
    }
  }
  static __device__ __forceinline__ void partials(float* red, const float (&acc)[8][4]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(lane / 4 + 8 * i) * P_UNITS + lane % 4 + 4 * q] = acc[i][q];
    }
  }
};

// 4 adjacent values of an f32 stream, zero past the n valid ones.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int64_t i, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) v.x = p[i];
  if (n > 1) v.y = p[i + 1];
  if (n > 2) v.z = p[i + 2];
  if (n > 3) v.w = p[i + 3];
  return v;
}
__device__ __forceinline__ float at4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
// base[i + e] = v[e] for the n valid ones, in the element type of base;
// one 16-byte (bf16: 8-byte) store when vec and all 4 are valid.
__device__ __forceinline__ void put4(float* base, int64_t i, const float (&v)[4], int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(base + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < n && e < 4; ++e) base[i + e] = v[e];
  }
}
__device__ __forceinline__ void put4(__nv_bfloat16* base, int64_t i, const float (&v)[4], int n, bool vec) {
  if (vec && n >= 4) {
    __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(base + i) = *reinterpret_cast<const uint2*>(pair);
  } else {
    for (int e = 0; e < n && e < 4; ++e) base[i + e] = __float2bfloat16_rn(v[e]);
  }
}

// Cell: G and step(act[G], dy, state, state_prev, ghn, m, acc, dh, dc,
// dgx[G], dgw[G]), the elementwise backward of one (row, j) pair
// (lstm_bidi.cu, gru_bidi.cu); dgw is what the next step's product and the
// weight gradient take (dgh for the GRU, dgx for the LSTM).
// Grid (ceil(H/16), row CTAs, dirs), P_THREADS threads, persistent_bwd_smem
// bytes; map0 / map1: each direction's two exchange slots as one [2B, G*H]
// tensor, boxes of [64 rows, 128 bytes].
template <class Cell, typename T>
__global__ void __launch_bounds__(P_THREADS, 1)
persistent_bwd(BwdDir d0, BwdDir d1, const __grid_constant__ CUtensorMap map0,
               const __grid_constant__ CUtensorMap map1, const float* __restrict__ mask, int t_len, int B,
               int H, unsigned* __restrict__ bar) {
  constexpr int G = Cell::G;
  using Pp = BwdPipe<T>;
  constexpr int EPP = 16 / sizeof(T);
  constexpr int BOX = 128 / sizeof(T);  // columns of a box
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dir = blockIdx.z;
  const BwdDir d = dir == 0 ? d0 : d1;
  const CUtensorMap* map = dir == 0 ? &map0 : &map1;
  const T* w = static_cast<const T*>(d.wh);
  T* slots = static_cast<T*>(d.dh);  // the two published round_cd(dg) slots [2, B, K]
  const int K = G * H;
  const int KR = (K + Pp::KC - 1) / Pp::KC * Pp::KC;
  const int nchunks = KR / Pp::KC;
  const int np = KR + Pp::PADN;
  T* ws = reinterpret_cast<T*>(smem_raw);
  // the ring, 1024-byte aligned as the 128-byte swizzle wants, then a full mbarrier per stage
  const unsigned raw = smem_addr(smem_raw);
  const unsigned ring_at = (raw + P_UNITS * np * static_cast<unsigned>(sizeof(T)) + 1023) & ~1023u;
  unsigned char* ring = smem_raw + (ring_at - raw);
  float* red = reinterpret_cast<float*>(ring);  // the partial sums, once the ring is drained
  const unsigned full0 = ring_at + Pp::NST * STAGE_BYTES;
  const int u0 = blockIdx.x * P_UNITS;
  if (threadIdx.x == 0) {
    for (int st = 0; st < Pp::NST; ++st) tkgemm::mbar_init(full0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_wt<T>(ws, w, H, K, KR, u0, K % EPP == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0);

  // the elementwise step's pairs: row r_own of a tile, units j_own .. j_own + 3
  const int r_own = threadIdx.x / 4;
  const int j_own = u0 + (threadIdx.x % 4) * 4;
  const int nj = H - j_own;  // units of the 4 that exist (<= 0: none)
  // f32 streams as float4 (the bf16 slot as 8 bytes) when H % 4 == 0 and aligned
  const bool vec4 = H % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(d.dy) | reinterpret_cast<uintptr_t>(d.acts) |
                      reinterpret_cast<uintptr_t>(d.state) | reinterpret_cast<uintptr_t>(d.ghn) |
                      reinterpret_cast<uintptr_t>(d.dgx) | reinterpret_cast<uintptr_t>(d.dgh) |
                      reinterpret_cast<uintptr_t>(slots)) & 15) == 0;
  const int tiles = (B + P_ROWS - 1) / P_ROWS;
  const int row_ctas = static_cast<int>(gridDim.y);
  const int mine = (tiles - static_cast<int>(blockIdx.y) + row_ctas - 1) / row_ctas;
  const unsigned ctas = gridDim.x * gridDim.y;  // CTAs of this direction

  float dhc[P_MAXR][4] = {}, dcc[P_MAXR][4] = {};  // the f32 carries of units j_own + e
  // the inputs of the next work item
  float4 dyr, actr[G], str, prevr, ghnr;
  float mr;

  // cotangents flow against each direction
  auto step_t = [&](int s) { return dir == 0 ? t_len - 1 - s : s; };
  auto fetch = [&](int s, int i) {
    const int t = step_t(s), tp = dir == 0 ? t - 1 : t + 1;  // tp: the step whose state t consumed
    const int row = (blockIdx.y + i * gridDim.y) * P_ROWS + r_own;
    const int n = row < B ? nj : 0;
    const int64_t tb = static_cast<int64_t>(t) * B + row;
    dyr = load4(d.dy, tb * H + j_own, n, vec4);
#pragma unroll
    for (int g = 0; g < G; ++g) actr[g] = load4(d.acts, tb * K + g * H + j_own, n, vec4);
    str = G == 4 ? load4(d.state, tb * H + j_own, n, vec4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    prevr = load4(d.state, (static_cast<int64_t>(tp) * B + row) * H + j_own, tp >= 0 && tp < t_len ? n : 0,
                  vec4);
    ghnr = G == 3 ? load4(d.ghn, tb * H + j_own, n, vec4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    mr = row < B ? mask[tb] : 0.0f;
  };

  unsigned q0 = 0;  // ring uses so far
  fetch(0, 0);
  for (int s = 0; s < t_len; ++s) {
    const int t = step_t(s);
    T* g_out = s + 1 < t_len ? slots + static_cast<int64_t>((s + 1) & 1) * B * K : nullptr;
#pragma unroll 1
    for (int i = 0; i < P_MAXR; ++i) {
      if (i < mine) {
        const int row0 = (blockIdx.y + i * gridDim.y) * P_ROWS;
        float4 dsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the product at this thread's 4 pairs
        if (s > 0) {  // dg_{-1} = 0: the first step has no product
          float acc[8][4] = {};
          // chunk c of the tile's rows of the published slot into ring use q: two boxes, one barrier
          const int slot_row = (s & 1) * B + row0;
          auto issue = [&](unsigned q, int c) {
            const unsigned st = q % Pp::NST, dst = ring_at + st * STAGE_BYTES, full = full0 + 8 * st;
            tkgemm::mbar_arrive_expect_tx(full, STAGE_BYTES);  // the whole boxes, even where they clip
            tkgemm::tma_load_2d(dst, map, full, c * Pp::KC, slot_row);
            tkgemm::tma_load_2d(dst + BOX_BYTES, map, full, c * Pp::KC + BOX, slot_row);
          };
          __syncthreads();  // the ring's readers of the previous tile are done
          if (threadIdx.x == 0) {
            // the slot was written by other CTAs' stores (the generic proxy) and is read by the TMA
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            for (int c = 0; c < Pp::NST - 1 && c < nchunks; ++c) issue(q0 + c, c);
          }
          for (int c = 0; c < nchunks; ++c) {
            const unsigned q = q0 + c;
            tkgemm::mbar_wait(full0 + 8 * (q % Pp::NST), (q / Pp::NST) & 1);
            __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
            if (threadIdx.x == 0 && c + Pp::NST - 1 < nchunks) issue(q + Pp::NST - 1, c + Pp::NST - 1);
            BwdWarp<T>::chunk(ring + (q % Pp::NST) * STAGE_BYTES, ws, np, c * Pp::KC, acc);
          }
          q0 += nchunks;
          __syncthreads();  // the ring is drained: it takes the warps' partial blocks
          BwdWarp<T>::partials(red + (threadIdx.x / 32) * P_ROWS * P_UNITS, acc);
          __syncthreads();
#pragma unroll
          for (int wp = 0; wp < P_WARPS; ++wp) {
            const float4 p = *reinterpret_cast<const float4*>(red + wp * P_ROWS * P_UNITS + r_own * P_UNITS +
                                                              (threadIdx.x % 4) * 4);
            dsum.x = add(dsum.x, p.x);
            dsum.y = add(dsum.y, p.y);
            dsum.z = add(dsum.z, p.z);
            dsum.w = add(dsum.w, p.w);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // red's stores, before the next boxes
        }
        float dgx[G][4], dgw[G][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float act[G], ox[G], ow[G];
#pragma unroll
          for (int g = 0; g < G; ++g) act[g] = at4(actr[g], e);
          Cell::step(act, at4(dyr, e), at4(str, e), at4(prevr, e), at4(ghnr, e), mr, at4(dsum, e), dhc[0][e],
                     dcc[0][e], ox, ow);
#pragma unroll
          for (int g = 0; g < G; ++g) dgx[g][e] = ox[g], dgw[g][e] = ow[g];
        }
        const int row = row0 + r_own;
        const int n = row < B ? nj : 0;
        // publish round_cd(dg_t) first: it is all the next step waits for
        if (g_out != nullptr) {
#pragma unroll
          for (int g = 0; g < G; ++g) put4(g_out, static_cast<int64_t>(row) * K + g * H + j_own, dgw[g], n, vec4);
        }
        if (s + 1 < t_len && i + 1 == mine) dir_arrive(bar + dir);  // the CTA's last tile of the step
        const int64_t at_g = (static_cast<int64_t>(t) * B + row) * K + j_own;  // [T, B, G*H] streams
#pragma unroll
        for (int g = 0; g < G; ++g) {
          put4(d.dgx, at_g + g * H, dgx[g], n, vec4);
          if (G == 3) put4(d.dgh, at_g + g * H, dgw[g], n, vec4);
        }
        if (i + 1 < mine) {
          fetch(s, i + 1);
        } else if (s + 1 < t_len) {
          fetch(s + 1, 0);  // in flight while this CTA waits at the barrier
        }
      }
      rotate(dhc);
      rotate(dcc);
    }
    if (s + 1 < t_len) dir_wait(bar + dir, (s + 1u) * ctas);
  }
}

// The host side of a persistent backward entry (BwdDir order; dh: the
// exchange slots, [2, B, G*H] in the compute dtype, 16-byte aligned with
// rows of whole 16-byte pieces, as the TMA wants; dc unused): a tensor map
// per direction, then the shared launch. Returns a CUDA error code, or a
// negative one when cuTensorMapEncodeTiled refuses a map.
template <class Cell, typename T>
int run_persistent_bwd(const void* const* p, const void* mask, int dirs, int t_len, int b, int h, int row_ctas,
                       void* bar, void* stream) {
  if (dirs < 1 || dirs > 2 || row_ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (t_len <= 0 || b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if ((Cell::G * h * sizeof(T)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdDir d0 = bwd_dir(p);
  BwdDir d1 = dirs > 1 ? bwd_dir(p + PTRS) : d0;
  CUtensorMap map0, map1;
  const int64_t k = static_cast<int64_t>(Cell::G) * h;
  int code = tkgemm::encode_2d(&map0, static_cast<const T*>(d0.dh), k, 2 * static_cast<int64_t>(b),
                               128 / static_cast<int>(sizeof(T)), P_ROWS);
  if (code == 0)
    code = tkgemm::encode_2d(&map1, static_cast<const T*>(d1.dh), k, 2 * static_cast<int64_t>(b),
                             128 / static_cast<int>(sizeof(T)), P_ROWS);
  if (code != 0) return code;
  void (*kernel)(BwdDir, BwdDir, const CUtensorMap, const CUtensorMap, const float*, int, int, int, unsigned*) =
      persistent_bwd<Cell, T>;
  const float* m = static_cast<const float*>(mask);
  unsigned* counters = static_cast<unsigned*>(bar);
  void* args[] = {&d0, &d1, &map0, &map1, &m, &t_len, &b, &h, &counters};
  return launch_persistent(reinterpret_cast<const void*>(kernel), persistent_bwd_smem<T>(Cell::G, h), dirs, b, h,
                           row_ctas, args, stream);
}

}  // namespace tk_rnn
