// The GEMM core shared by kernels 1 (fused_ffn.cu) and 3 (bn_dgrad.cu):
//   C[M, N] = A[M, K] @ B[K, N], f32 accumulation, an epilogue functor on
//   the accumulator (Epi::apply, apply2x2), masked stores.
// A is K-major (row-major [M, K]). B is either K-major (the rows of a
// [N, K] matrix, i.e. B = w^T for kernel 3's dh = dz @ w^T) or MN-major
// (row-major [K, N], kernel 1's w).
//
// Replaces the main loops of the TPU kernels tfkaldi_tpu/ops/fused_mlp.py::
// _ffn_kernel and tfkaldi_tpu/ops/bn_fused_bwd.py::_dgrad_kernel, which
// Mosaic lowered onto the TPU's 128x128 matrix unit.
//
// What bounds it on an H100: at the recipe's shapes (M = 8,192..65,536
// rows, K in {440, 2048}, N in {440, 2048}) a product does hundreds of
// operations per byte, so it is bound by arithmetic: bf16 operands by the
// tensor cores (989 TFLOP/s dense), f32 operands by the FMA units
// (67 TFLOP/s; no TF32, because the reference contracts f32 at HIGHEST,
// tfkaldi_tpu/ops/fused_mlp.py:48-53). Both need the operands delivered
// to the math without the math's threads spending issue slots on copies.
//
// What the design does about it (route "tma", tma_gemm below): one block
// per output tile of BM x BN, 384 threads. Warpgroup 0 is the producer: one
// thread issues TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of the
// A and B tiles of each BK-deep slab into a ring of STAGES shared-memory
// stages, each with a full and an empty mbarrier; out-of-range rows and k
// are zero-filled by the TMA, so ragged M, N and K need no masking on the
// load side. Warpgroups 1 and 2 consume:
//   - bf16: wgmma.mma_async m64n256k16 from shared-memory descriptors whose
//     swizzle matches the TMA's, one 64-row half of the 128 x 256 tile per
//     warpgroup, 128 f32 accumulators a thread; B K-major or MN-major by
//     the descriptor's transpose bit (no w^T is materialised). A stage is
//     released one wgmma group late (wait_group 1), so the tensor cores
//     always have the next slab queued. bf16 x bf16 products are exact in
//     f32, so only the summation order differs from the plain versions.
//   - f32: a 128 x 128 tile, 8 x 8 outputs a thread (rows ty + 16i), exact
//     f32 FMAs; the operands are read straight from the swizzled ring with
//     16-byte shared loads (A along k; B along k when K-major, along n when
//     MN-major), conflict-free because of the swizzle, and each stage is
//     released once per 32-deep slab: no register staging and no block-wide
//     barrier in the main loop.
// Shapes the TMA cannot describe (a row pitch that is not a multiple of 16
// bytes, an operand not 16-byte aligned: ops/gemm_plan.py decides) take the
// route "simt" (simt_gemm below): a 128 x 128 register-blocked SGEMM with
// scalar masked loads, slower but valid for any shape.
//
// Below one wave of tiles (route "splitk", launch_splitk below): kernel 1
// in the streamed DNN runs [n, K] @ [K, 2048] at n = 8..600 rows, where
// the TMA grid is 16 x 1..5 f32 tiles or 8 x 1..5 bf16 tiles on 132 SMs
// and each CTA streams all of K. There the work is bound by reading w
// once (16.8 MB f32 / 8.4 MB bf16 at K 2048: 5.0 / 2.5 us at n <= 72) or,
// at f32 n = 600, by the FMAs (75 us), and the whole-K tile by neither:
// one SM runs all 2 * 128 * 128 * 2048 FMAs of its tile. The split route
// cuts K into `splits` disjoint ranges of `slabs` BK-deep slabs (grid
// z), so tiles x splits CTAs fill the card and each streams its range of
// w exactly once, through the same TMA ring and consumers; f32 consumers
// skip the row blocks past the last real row (a warp's rows are 2w,
// 2w + 1 + 16 i, so the skip is warp-uniform), which leaves a few rows
// bound by the bytes of w. Each CTA stores its f32 partial tile to a
// workspace [splits, rows, cols]; splitk_reduce then sums the splits in
// the fixed order z = 0, 1, ..., applies the epilogue and rounds once to
// T. No atomics: two calls on the same inputs are bit-identical.
//
// The half tile (HALF_BM = 64 rows, kernel 1 on either route): at n in
// the hundreds a 128-row tile leaves the card few, long CTAs, and at a few
// rows a bf16 CTA runs the tensor work of 128 rows for 8. The half tile's
// A box is 64 rows; f32 warps hold 4 x 8 outputs each (rows ty + 16 i,
// i < 4) and an SM holds two such blocks (100,928 B of shared memory and
// 80 registers a thread each), so one block's ring fill, waits and stores
// overlap the other's FMAs; the two bf16 warpgroups each take one
// 128-column half of the 64 x 256 tile with wgmma m64n128k16 (B's
// descriptor offset by two 64-column boxes), half the tensor work of the
// full tile for the same bytes of w.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tkgemm {

// ---------------------------------------------------------------------------
// tiles (mirrored in ops/gemm_plan.py)
// ---------------------------------------------------------------------------

template <typename T>
struct TmaCfg;
template <>
struct TmaCfg<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
};
template <>
struct TmaCfg<float> {
  static constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
};

constexpr int TMA_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int SWIZZLE_BYTES = 128;  // TMA box inner extent = swizzle span
constexpr int EPI_PARAMS = 3;  // [BN] f32 vectors an epilogue may stage per tile

// HALF_BM: the half tile's rows (BM 64 for either dtype, kernel 1's
// MN-major products only; see "Below one wave of tiles" above)
constexpr int HALF_BM = 64;

// The ring's layout for a tile of BM rows (TmaCfg's, or HALF_BM)
template <typename T, int BM = TmaCfg<T>::BM>
struct TmaLayout {
  using C = TmaCfg<T>;
  static constexpr int A_BYTES = BM * C::BK * (int)sizeof(T);
  static constexpr int B_BYTES = C::BN * C::BK * (int)sizeof(T);
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // MN-major B arrives as BN / BOX_N boxes of [BK k-rows, 128 bytes of n]
  static constexpr int BOX_N = SWIZZLE_BYTES / (int)sizeof(T);
  static constexpr int B_BOX_BYTES = C::BK * SWIZZLE_BYTES;
  // ring + full/empty barriers + the epilogue's [3, BN] f32 parameters +
  // slack to align the ring to 1024 bytes
  static constexpr int SMEM = C::STAGES * STAGE_BYTES + 2 * C::STAGES * 8 + EPI_PARAMS * C::BN * 4 + 1024;
};

// ---------------------------------------------------------------------------
// epilogues: stage() copies what the tile's columns need into shared memory
// (sp, EPI_PARAMS x bn floats) before the main loop, then apply() works on
// one accumulator element (apply2x2 on two adjacent columns of two rows);
// the caller masks rows and columns, apply2x2 masks the rows
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// C = acc, stored in T
template <typename T>
struct StoreEpi {
  static constexpr bool VEC4 = false;  // no apply4
  T* out;
  int64_t ldc;
  __device__ __forceinline__ void stage(float*, int, int64_t, int64_t, int, int) {}
  __device__ __forceinline__ void apply(int64_t row, int64_t col, float v) const {
    store1(out + row * ldc + col, v);
  }
  // whether a pair of adjacent columns may be stored as one word
  __device__ __forceinline__ bool pairs() const { return ldc % 2 == 0; }
  __device__ __forceinline__ void apply2x2(int64_t row, int64_t rstep, int64_t m, int64_t col, float v00,
                                           float v01, float v10, float v11) const {
    if (row < m) store2(out + row * ldc + col, v00, v01);
    if (row + rstep < m) store2(out + (row + rstep) * ldc + col, v10, v11);
  }
};

// C = act((acc + bias) * scale + shift), stored in T (scale/shift may be null)
template <typename T>
struct FfnEpi {
  static constexpr bool VEC4 = false;
  T* out;
  int64_t ldc;
  const float* bias;
  const float* scale;
  const float* shift;
  int relu;
  const float* sp = nullptr;  // staged [bias; scale; shift] of columns col0 .. col0 + bn - 1
  int bn = 0;
  int64_t col0 = 0;
  // the parameters of the tile's columns into shared memory, read once per
  // tile (identity scale and shift where they are absent)
  __device__ __forceinline__ void stage(float* s, int bn_, int64_t col0_, int64_t n, int tid, int nthreads) {
    for (int c = tid; c < bn_; c += nthreads) {
      const int64_t col = col0_ + c;
      const bool ok = col < n;
      s[c] = ok ? bias[col] : 0.0f;
      s[bn_ + c] = ok && scale ? scale[col] : 1.0f;
      s[2 * bn_ + c] = ok && shift ? shift[col] : 0.0f;
    }
    sp = s;
    bn = bn_;
    col0 = col0_;
  }
  __device__ __forceinline__ float f(int64_t col, float v) const {
    const int c = static_cast<int>(col - col0);
    v = (v + sp[c]) * sp[bn + c] + sp[2 * bn + c];
    return relu ? fmaxf(v, 0.0f) : v;
  }
  __device__ __forceinline__ void apply(int64_t row, int64_t col, float v) const {
    store1(out + row * ldc + col, f(col, v));
  }
  __device__ __forceinline__ bool pairs() const { return ldc % 2 == 0; }
  // columns col, col + 1 (col even) of rows row and row + rstep: the
  // parameters are read once, as 8-byte shared loads, for the four values
  __device__ __forceinline__ void apply2x2(int64_t row, int64_t rstep, int64_t m, int64_t col, float v00,
                                           float v01, float v10, float v11) const {
    const int c = static_cast<int>(col - col0);  // even, so the float2 loads are aligned
    const float2 b = *reinterpret_cast<const float2*>(sp + c);
    const float2 s = *reinterpret_cast<const float2*>(sp + bn + c);
    const float2 h = *reinterpret_cast<const float2*>(sp + 2 * bn + c);
    auto act = [&](float v, float bj, float sj, float hj) {
      v = (v + bj) * sj + hj;
      return relu ? fmaxf(v, 0.0f) : v;
    };
    if (row < m) store2(out + row * ldc + col, act(v00, b.x, s.x, h.x), act(v01, b.y, s.y, h.y));
    if (row + rstep < m)
      store2(out + (row + rstep) * ldc + col, act(v10, b.x, s.x, h.x), act(v11, b.y, s.y, h.y));
  }
  // f() with the parameters read from global memory: splitk_reduce's
  // epilogue, which stages nothing
  __device__ __forceinline__ float finish(int64_t col, float v) const {
    v = (v + bias[col]) * (scale ? scale[col] : 1.0f) + (shift ? shift[col] : 0.0f);
    return relu ? fmaxf(v, 0.0f) : v;
  }
};

// The split route's partial tiles: the f32 accumulator of split z stored
// to ws[z, row, col] (out points at plane z of the [splits, rows, ldc] f32
// workspace), nothing applied
struct PartialEpi : StoreEpi<float> {
  static constexpr bool VEC4 = true;  // apply4: four adjacent columns as one 16-byte store
  // columns col .. col + 3 of one row, those below n
  __device__ __forceinline__ void apply4(int64_t row, int64_t col, int64_t n, const float (&v)[4]) const {
    float* p = out + row * ldc + col;
    if (col + 3 < n && ldc % 4 == 0) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < n) p[c] = v[c];
  }
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a protocol fault) traps after 2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// 2-d TMA load of one box at (c0 = inner coordinate, c1 = outer) into dst,
// completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29,
// stride byte offset >> 4 in 32-45; base offset 0 (every stage is
// 1024-byte aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], bf16 in, f32 accumulators;
// TRANS_B = 1 when B is MN-major in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: the half tile's wgmma, each
// consumer warpgroup on one 128-column half of the 64 x 256 tile
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// the consumers' math, one specialisation per operand type; `nk` is the
// number of slabs the block streams through its ring (all of K, or its
// split's range), SKIP lets f32 warps skip the rows past the last one
// ---------------------------------------------------------------------------

template <typename T, bool B_KMAJOR, int BM = TmaCfg<T>::BM>
struct Consumer;

// bf16: two warpgroups on the tensor cores, each 64 rows x 256 columns of
// the 128 x 256 tile, or (the half tile, BM 64) the tile's 64 rows x one
// 128-column half
template <bool B_KMAJOR, int BM>
struct Consumer<__nv_bfloat16, B_KMAJOR, BM> {
  using L = TmaLayout<__nv_bfloat16, BM>;
  using C = TmaCfg<__nv_bfloat16>;
  static constexpr int WN = BM == C::BM ? C::BN : C::BN / 2;  // a warpgroup's columns
  static_assert(BM == C::BM || BM == HALF_BM, "bf16 tiles are 128 or 64 rows");

  template <bool SKIP, class Epi>
  static __device__ __forceinline__ void run(uint32_t ring, uint32_t full, uint32_t empty, int nk,
                                             int ctid, int64_t row0, int64_t col0, int64_t m,
                                             int64_t n, const Epi& epi) {
    const int wg = ctid / 128;  // 0 or 1: rows 64*wg .. of the tile, or columns WN*wg .. of the half tile
    const int lane = ctid % 32;
    constexpr bool HALF = WN != C::BN;
    float d[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) d[i] = 0.0f;
    // a warpgroup's A rows and B columns in a stage: MN-major B's columns
    // are boxes of BOX_N, K-major B's are 128-byte rows
    const uint32_t a_off = HALF ? 0 : wg * 64 * SWIZZLE_BYTES;
    const uint32_t b_off = !HALF ? 0 : B_KMAJOR ? wg * WN * SWIZZLE_BYTES : wg * (WN / L::BOX_N) * L::B_BOX_BYTES;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(full + 8 * s, (kt / C::STAGES) & 1);
      const uint32_t a = ring + s * L::STAGE_BYTES + a_off;
      const uint32_t b = ring + s * L::STAGE_BYTES + L::A_BYTES + b_off;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        // K-major: 16 k = 32 bytes along the swizzled 128-byte row, 8-row
        // groups 1024 bytes apart. MN-major: 16 k-rows = 2048 bytes, 8-k
        // groups 1024 bytes apart, 64-column boxes B_BOX_BYTES apart.
        const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
        const uint64_t db = B_KMAJOR ? sw128_desc(b + kk * 32, 16, 1024)
                                     : sw128_desc(b + kk * 16 * SWIZZLE_BYTES, L::B_BOX_BYTES, 1024);
        if constexpr (HALF)
          wgmma_m64n128k16<B_KMAJOR ? 0 : 1>(d, da, db);
        else
          wgmma_m64n256k16<B_KMAJOR ? 0 : 1>(d, da, db);
      }
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous slab's products are done: free its stage
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    fence_acc(d);

    // accumulator layout of m64nNk16: register i of thread t holds
    // row 16*(t/32) + (t%32)/4 + 8*((i/2)%2), column 2*(t%4) + i%2 + 8*(i/4)
    // registers i, i + 1 (row r) and i + 2, i + 3 (row r + 8) share their
    // two columns
    const int warp = (ctid % 128) / 32;
    const bool pairs = epi.pairs();
    const int64_t row = row0 + (HALF ? 0 : wg * 64) + warp * 16 + lane / 4;
    const int64_t wcol0 = col0 + (HALF ? wg * WN : 0);
#pragma unroll
    for (int i = 0; i < WN / 2; i += 4) {
      const int64_t col = wcol0 + 2 * (lane % 4) + 8 * (i / 4);
      if (pairs && col + 1 < n) {
        epi.apply2x2(row, 8, m, col, d[i], d[i + 1], d[i + 2], d[i + 3]);
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r >= m) continue;
        if (col < n) epi.apply(row + 8 * r, col, d[i + 2 * r]);
        if (col + 1 < n) epi.apply(row + 8 * r, col + 1, d[i + 2 * r + 1]);
      }
    }
  }
};

// f32: 256 threads, 8 x 8 outputs each (4 x 8 on the half tile), exact
// FMAs from the swizzled ring
template <bool B_KMAJOR, int BM>
struct Consumer<float, B_KMAJOR, BM> {
  using L = TmaLayout<float, BM>;
  using C = TmaCfg<float>;
  static_assert(BM == C::BM || BM == HALF_BM, "f32 tiles are 128 or 64 rows");

  // The thread's rows ty + 16 i for i < I (I = BM / 16: the whole tile;
  // fewer where the rows past I are past the last row), its 8 columns.
  template <int I, class Epi>
  static __device__ __forceinline__ void rows(uint32_t ring, uint32_t full, uint32_t empty, int nk,
                                              int ctid, int64_t row0, int64_t col0, int64_t m,
                                              int64_t n, const Epi& epi) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const int tx = ctid % 16;
    const int ty = ctid / 16;
    const int lane = ctid % 32;
    constexpr int IA = I > 0 ? I : 1;
    float acc[IA][8];
#pragma unroll
    for (int i = 0; i < IA; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    // The 128-byte swizzle stores the 16-byte chunk q of a 128-byte row r at
    // chunk q ^ (r % 8), i.e. at byte (16q) ^ (16 (r % 8)) of the row, the
    // rows being 1024-byte aligned in groups of 8. A's rows are ty + 16i, so
    // r % 8 = ty % 8 for all of them; B's (K-major) are tx + 16j; an
    // MN-major B's k-rows are k of a box of [BK, 32 columns]. So one XOR
    // mask a thread, and each 16-byte load is a base plus an immediate.
    const uint32_t xa = (ty & 7) << 4;
    const uint32_t xb = (tx & 7) << 4;
    const uint32_t a_row = ty * SWIZZLE_BYTES;
    const uint32_t b_row = B_KMAJOR ? tx * SWIZZLE_BYTES : (tx / 8) * L::B_BOX_BYTES;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(full + 8 * s, (kt / C::STAGES) & 1);
      const uint8_t* a = smem_raw + (ring - raw) + s * L::STAGE_BYTES + a_row;
      const uint8_t* b = smem_raw + (ring - raw) + s * L::STAGE_BYTES + L::A_BYTES + b_row;
#pragma unroll
      for (int kq = 0; kq < (I > 0 ? C::BK / 4 : 0); ++kq) {
        const uint32_t ka = (kq << 4) ^ xa;
        float4 av[IA];
#pragma unroll
        for (int i = 0; i < I; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + ka + i * 16 * SWIZZLE_BYTES);
        if (B_KMAJOR) {
          // columns tx + 16j: the 16 rows a warp reads fall on 8 chunk
          // positions (2 wavefronts for 256 bytes)
          const uint32_t kb = (kq << 4) ^ xb;
          float4 bv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bv[j] = *reinterpret_cast<const float4*>(b + kb + j * 16 * SWIZZLE_BYTES);
#pragma unroll
          for (int i = 0; i < I; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
              acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
              acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
              acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
            }
        } else {
          // columns 64h + 4tx + {0..3}: box 2h + tx/8, k-row k, chunk
          // (tx % 8) ^ (k % 8); k % 8 = 4 (kq % 2) + kk
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t kb = (kq * 4 + kk) * SWIZZLE_BYTES + ((((kq & 1) * 4 + kk) << 4) ^ xb);
            float bj[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 v = *reinterpret_cast<const float4*>(b + kb + 2 * h * L::B_BOX_BYTES);
              bj[4 * h + 0] = v.x; bj[4 * h + 1] = v.y; bj[4 * h + 2] = v.z; bj[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < I; ++i) {
              const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bj[j], acc[i][j]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    if constexpr (Epi::VEC4 && !B_KMAJOR) {
      // columns 64h + 4tx + {0..3} of each row: one 16-byte store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t col = col0 + h * 64 + tx * 4;
        if (col >= n) continue;
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const int64_t row = row0 + ty + 16 * i;
          const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
          if (row < m) epi.apply4(row, col, n, v);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t col = col0 + (B_KMAJOR ? tx + 16 * j : (j / 4) * 64 + tx * 4 + j % 4);
        if (col >= n) continue;
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const int64_t row = row0 + ty + 16 * i;
          if (row < m) epi.apply(row, col, acc[i][j]);
        }
      }
    }
  }

  // rows<I> for the largest I <= TOP with I == TOP or I <= ni
  template <int TOP, class Epi>
  static __device__ __forceinline__ void rows_upto(int ni, uint32_t ring, uint32_t full, uint32_t empty, int nk,
                                                   int ctid, int64_t row0, int64_t col0, int64_t m, int64_t n,
                                                   const Epi& epi) {
    if constexpr (TOP == 0) {
      rows<0>(ring, full, empty, nk, ctid, row0, col0, m, n, epi);
    } else {
      if (ni >= TOP)
        rows<TOP>(ring, full, empty, nk, ctid, row0, col0, m, n, epi);
      else
        rows_upto<TOP - 1>(ni, ring, full, empty, nk, ctid, row0, col0, m, n, epi);
    }
  }

  template <bool SKIP, class Epi>
  static __device__ __forceinline__ void run(uint32_t ring, uint32_t full, uint32_t empty, int nk,
                                             int ctid, int64_t row0, int64_t col0, int64_t m,
                                             int64_t n, const Epi& epi) {
    if constexpr (!SKIP) {
      rows<BM / 16>(ring, full, empty, nk, ctid, row0, col0, m, n, epi);
    } else {
      // warp w holds ty = 2w, 2w + 1: its row blocks i with row0 + 2w + 16 i < m
      const int64_t left = m - row0 - 2 * (ctid / 32);
      const int ni = left <= 0 ? 0 : static_cast<int>(left >= BM ? BM / 16 : (left + 15) / 16);
      rows_upto<BM / 16>(ni, ring, full, empty, nk, ctid, row0, col0, m, n, epi);
    }
  }
};

// ---------------------------------------------------------------------------
// the TMA route
// ---------------------------------------------------------------------------

// A launch's plan beyond its route (ops/gemm_plan.py's GemmPlan): the
// tile's rows (0: TmaCfg's BM; HALF_BM: the half tile), and the split
// route's f32 partials ws [splits, m, n] and the slabs of a split (unused
// by the other routes).
struct Plan {
  int bm = 0;
  float* ws = nullptr;
  int splits = 1;
  int slabs = 0;
};

// Blocks an SM holds: two of the f32 half tile (100,928 B of shared
// memory and at most 80 registers a thread each), so that one block's
// ring fill and partial stores overlap the other's FMAs; one otherwise.
template <typename T, int BM>
constexpr int tma_blocks_per_sm() {
  return sizeof(T) == 4 && BM == HALF_BM ? 2 : 1;
}

// SPLIT: the route "splitk"'s first pass: block z streams slabs
// [z * slabs, z * slabs + slabs) of K (the last range may be shorter), f32
// warps skipping the rows past the last one, and stores its f32 partial
// tile to ws[z] (epi is splitk_reduce's). Otherwise every block streams
// all of K and applies epi to its accumulator (split is unused).
template <typename T, bool B_KMAJOR, class Epi, bool SPLIT = false, int BM = TmaCfg<T>::BM>
__global__ void __launch_bounds__(TMA_THREADS, tma_blocks_per_sm<T, BM>())
tma_gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
         int m, int n, int k, Plan split, Epi epi) {
  using C = TmaCfg<T>;
  using L = TmaLayout<T, BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t full = ring + C::STAGES * L::STAGE_BYTES;
  const uint32_t empty = full + 8 * C::STAGES;
  float* params = reinterpret_cast<float*>(smem_raw + (empty + 8 * C::STAGES - raw));
  const int nk_all = (k + C::BK - 1) / C::BK;
  const int kt0 = SPLIT ? static_cast<int>(blockIdx.z) * split.slabs : 0;
  const int nk = SPLIT ? min(split.slabs, nk_all - kt0) : nk_all;  // the slabs this block streams
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * C::BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread drives the ring
    if (threadIdx.x != 0) return;
    for (int it = 0; it < nk; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);  // the first pass finds every stage free
      const uint32_t a = ring + s * L::STAGE_BYTES;
      const uint32_t b = a + L::A_BYTES;
      const uint32_t bar = full + 8 * s;
      const int kt = kt0 + it;
      // the count is the full boxes even where the TMA clips at an edge
      mbar_arrive_expect_tx(bar, L::STAGE_BYTES);
      tma_load_2d(a, &map_a, bar, kt * C::BK, static_cast<int>(row0));
      if (B_KMAJOR) {
        tma_load_2d(b, &map_b, bar, kt * C::BK, static_cast<int>(col0));
      } else {
#pragma unroll
        for (int j = 0; j < C::BN / L::BOX_N; ++j)
          tma_load_2d(b + j * L::B_BOX_BYTES, &map_b, bar, static_cast<int>(col0) + j * L::BOX_N, kt * C::BK);
      }
    }
    return;
  }
  const int ctid = threadIdx.x - 128;
  if constexpr (!SPLIT) {
    // consumers: stage the epilogue's parameters while the first slabs load
    Epi e = epi;
    e.stage(params, C::BN, col0, n, ctid, 256);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the 256 consumer threads only
    Consumer<T, B_KMAJOR, BM>::template run<false>(ring, full, empty, nk, ctid, row0, col0, m, n, e);
  } else {
    const int64_t plane = static_cast<int64_t>(m) * n;
    const PartialEpi part{{split.ws + blockIdx.z * plane, n}};
    Consumer<T, B_KMAJOR, BM>::template run<true>(ring, full, empty, nk, ctid, row0, col0, m, n, part);
  }
}

// The split route's second pass: out[r, c] = Epi::finish(c, sum over z of
// ws[z, r, c]), the splits added in the order z = 0, 1, ..., rounded once
// to T; V adjacent columns a thread (4 where the row pitch allows 16-byte
// loads, else 1). The partials are f32 and L2-resident (written just
// before), and the pass spreads over the whole card, so it costs about one
// read of the partials and one write of the output. (Summing a tile in
// its last-arriving CTA instead, in the first pass's tail, measured slower
// at every streamed shape: one CTA's loads of a tile's partials wait on
// L2 in turn.)
constexpr int REDUCE_THREADS = 256;

template <typename T, int V, class Epi>
__global__ void __launch_bounds__(REDUCE_THREADS)
splitk_reduce(const float* __restrict__ ws, int splits, int64_t rows, int cols, Epi epi) {
  const int64_t plane = rows * cols;
  const int64_t total = plane / V;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS + threadIdx.x; q < total;
       q += static_cast<int64_t>(gridDim.x) * REDUCE_THREADS) {
    const int64_t e = q * V;
    const int64_t col = e % cols;
    float v[V];
    if constexpr (V == 4) {
      const float4 p = *reinterpret_cast<const float4*>(ws + e);
      v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
      for (int z = 1; z < splits; ++z) {
        const float4 r = *reinterpret_cast<const float4*>(ws + z * plane + e);
        v[0] += r.x; v[1] += r.y; v[2] += r.z; v[3] += r.w;
      }
    } else {
      v[0] = ws[e];
      for (int z = 1; z < splits; ++z) v[0] += ws[z * plane + e];
    }
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = epi.finish(col + c, v[c]);
    T* out = epi.out + (e / cols) * epi.ldc + col;
    if constexpr (V == 4) {
      store2(out, v[0], v[1]);
      store2(out + 2, v[2], v[3]);
    } else {
      store1(out, v[0]);
    }
  }
}

// ---------------------------------------------------------------------------
// the edge route: any shape, any alignment
// ---------------------------------------------------------------------------

constexpr int SIMT_BM = 128, SIMT_BN = 128, SIMT_BK = 8, SIMT_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A 128 x 128 tile per block of 256 threads, depth steps of 8 staged in two
// shared buffers through registers (the next slab is loaded while the
// current one is multiplied), 8 x 8 outputs a thread read as float4 shared
// loads; masked scalar global loads, so no shape or alignment is refused.
template <typename T, bool B_KMAJOR, class Epi>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_gemm(const T* __restrict__ a, const T* __restrict__ b, int m, int n, int k, Epi epi) {
  constexpr int BM = SIMT_BM, BN = SIMT_BN, BK = SIMT_BK;
  __shared__ __align__(16) float as[2][BK][BM];  // A slab, transposed: as[kk][row]
  __shared__ __align__(16) float bs[2][BK][BN];  // B slab: bs[kk][col]
  __shared__ __align__(16) float params[EPI_PARAMS * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  // A: one row, 4 consecutive k a thread; B K-major likewise (one column of
  // C, 4 consecutive k); B MN-major: one k, 4 consecutive columns
  const int ld_idx = tid / 2;
  const int ld_k = (tid % 2) * 4;
  const int bm_k = tid / 32;
  const int bm_col = (tid % 32) * 4;
  Epi e = epi;
  e.stage(params, BN, col0, n, tid, SIMT_THREADS);  // visible after the first barrier below

  float a_reg[4], b_reg[4];
  auto load_slab = [&](int k0) {
    const int64_t row = row0 + ld_idx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + ld_k + i;
      a_reg[i] = (row < m && gk < k) ? to_f32(a[row * k + gk]) : 0.0f;
    }
    if (B_KMAJOR) {
      const int64_t col = col0 + ld_idx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + ld_k + i;
        b_reg[i] = (col < n && gk < k) ? to_f32(b[col * k + gk]) : 0.0f;
      }
    } else {
      const int gk = k0 + bm_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = col0 + bm_col + j;
        b_reg[j] = (gk < k && col < n) ? to_f32(b[static_cast<int64_t>(gk) * n + col]) : 0.0f;
      }
    }
  };
  auto store_slab = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[buf][ld_k + i][ld_idx] = a_reg[i];
    if (B_KMAJOR) {
#pragma unroll
      for (int i = 0; i < 4; ++i) bs[buf][ld_k + i][ld_idx] = b_reg[i];
    } else {
      *reinterpret_cast<float4*>(&bs[buf][bm_k][bm_col]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_slab(0);
  store_slab(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k; k0 += BK) {
    const bool more = k0 + BK < k;
    if (more) load_slab(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_slab(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    if (col >= n) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (row < m) e.apply(row, col, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Error codes of the launchers: a cudaError_t (> 0), or, for a tensor map
// cuTensorMapEncodeTiled refused, -(CUresult) (-1000 if its entry point is
// missing).
constexpr int NO_ENCODER = -1000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through cudaGetDriverEntryPoint, so the
// library needs no -lcuda
inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major [outer, inner] matrix as a 2-d tensor map with boxes of
// [box_outer, box_inner], 128-byte swizzle, out-of-range elements read as 0
template <typename T>
inline int encode_2d(CUtensorMap* map, const T* ptr, int64_t inner, int64_t outer, int box_inner,
                     int box_outer) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = fn(map, type, 2, const_cast<T*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// C[m, n] = A[m, k] @ B on the TMA route with BM-row tiles (SPLIT: the
// split route, K in split.splits ranges on grid z); B is [n, k]
// (B_KMAJOR) or [k, n]. Returns 0 or an error code (see NO_ENCODER).
template <typename T, bool B_KMAJOR, class Epi, bool SPLIT = false, int BM = TmaCfg<T>::BM>
int launch_tma(const T* a, const T* b, int m, int n, int k, const Epi& epi, cudaStream_t stream,
               const Plan& split = Plan{}) {
  using C = TmaCfg<T>;
  using L = TmaLayout<T, BM>;
  if (m <= 0 || n <= 0) return 0;
  CUtensorMap map_a, map_b;
  int code = encode_2d(&map_a, a, k, m, C::BK, BM);
  if (code != 0) return code;
  code = B_KMAJOR ? encode_2d(&map_b, b, k, n, C::BK, C::BN) : encode_2d(&map_b, b, n, k, L::BOX_N, C::BK);
  if (code != 0) return code;
  auto kernel = tma_gemm<T, B_KMAJOR, Epi, SPLIT, BM>;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((n + C::BN - 1) / C::BN, (m + BM - 1) / BM, SPLIT ? split.splits : 1);
  kernel<<<grid, TMA_THREADS, L::SMEM, stream>>>(map_a, map_b, m, n, k, split, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool B_KMAJOR, class Epi>
int launch_simt(const T* a, const T* b, int m, int n, int k, const Epi& epi, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + SIMT_BN - 1) / SIMT_BN, (m + SIMT_BM - 1) / SIMT_BM);
  simt_gemm<T, B_KMAJOR, Epi><<<grid, SIMT_THREADS, 0, stream>>>(a, b, m, n, k, epi);
  return static_cast<int>(cudaGetLastError());
}

// The split route: split.ws is [splits, m, n] f32 (the wrapper's
// workspace); the first pass stores each split's partial tile there,
// splitk_reduce sums them and applies epi. splits * slabs slabs cover K
// and each of the splits ranges holds at least one (ops/gemm_plan.py
// plans both).
template <typename T, bool B_KMAJOR, class Epi, int BM>
int launch_splitk(const T* a, const T* b, int m, int n, int k, const Epi& epi, const Plan& split,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const int nk = (k + TmaCfg<T>::BK - 1) / TmaCfg<T>::BK;
  if (split.ws == nullptr || split.splits < 1 || split.slabs < 1 || (split.splits - 1) * split.slabs >= nk ||
      split.splits * split.slabs < nk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int code = launch_tma<T, B_KMAJOR, Epi, true, BM>(a, b, m, n, k, epi, stream, split);
  if (code != 0) return code;
  const bool vec = n % 4 == 0;
  const int64_t total = static_cast<int64_t>(m) * n / (vec ? 4 : 1);
  const int blocks = static_cast<int>(
      total < 1024LL * REDUCE_THREADS ? (total + REDUCE_THREADS - 1) / REDUCE_THREADS : 1024);
  if (vec)
    splitk_reduce<T, 4, Epi><<<blocks, REDUCE_THREADS, 0, stream>>>(split.ws, split.splits, m, n, epi);
  else
    splitk_reduce<T, 1, Epi><<<blocks, REDUCE_THREADS, 0, stream>>>(split.ws, split.splits, m, n, epi);
  return static_cast<int>(cudaGetLastError());
}

// route: 1 = tma, 0 = simt, 2 = splitk, on plan.bm-row tiles (0: TmaCfg's
// BM; HALF_BM), as ops/gemm_plan.py plans; only kernel 1's MN-major
// products split or take the half tile, so a K-major B refuses both
template <typename T, bool B_KMAJOR, class Epi>
int launch(int route, const T* a, const T* b, int m, int n, int k, const Epi& epi, cudaStream_t stream,
           const Plan& plan = Plan{}) {
  constexpr int FULL = TmaCfg<T>::BM;
  if (route == 0) return launch_simt<T, B_KMAJOR>(a, b, m, n, k, epi, stream);
  const bool half = plan.bm == HALF_BM;
  if ((route != 1 && route != 2) || (plan.bm != 0 && plan.bm != FULL && !half))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (B_KMAJOR) {
    if (route == 2 || half) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tma<T, B_KMAJOR>(a, b, m, n, k, epi, stream);
  } else {
    if (route == 2)
      return half ? launch_splitk<T, B_KMAJOR, Epi, HALF_BM>(a, b, m, n, k, epi, plan, stream)
                  : launch_splitk<T, B_KMAJOR, Epi, FULL>(a, b, m, n, k, epi, plan, stream);
    return half ? launch_tma<T, B_KMAJOR, Epi, false, HALF_BM>(a, b, m, n, k, epi, stream)
                : launch_tma<T, B_KMAJOR>(a, b, m, n, k, epi, stream);
  }
}

}  // namespace tkgemm
