// Preemphasis + end masking + overlapping framing, in native f64 (kernel 2).
//
// Replaces the TPU kernel tfkaldi_tpu/ops/pallas_frontend.py::_kernel
// (launched by frame_preemph_split). The TPU has no f64, so that kernel
// computed y[n] = x[n] - c*x[n-1] as double-float arithmetic and emitted a
// three-term f32 split (a, b, lo) of every frame for double-float DFT
// matmuls; it also laid the signal out as [S/g, g] rows (g = gcd of frame
// length and step) to satisfy Mosaic's 128-lane offsets. Hopper has native
// f64, so this kernel writes the frames themselves as f64 [B, T, wl] for the
// f64 DFT product, with no split and no row layout.
//
// What bounds it on an H100: the HBM write of the f64 frames. At 25 ms
// frames every 10 ms (wl 400, ws 160) each sample lands in 2.5 frames, so
// [16, 80000] f32 (5.1 MB read) becomes [16, 498, 400] f64 (25.5 MB
// written): 9.1 us at 3.35 TB/s. Two f64 operations a sample are nothing
// beside that.
//
// What the design does about it (ops/frame_preemph.py::frame_plan picks the
// route, the tile depth F and the grid; tk_frame_smem gives this file's
// shared-memory size for the plan to be checked against):
//  - A tile is F consecutive frames of one utterance. Its input is one span
//    of (F-1)*ws + wl samples plus the halo sample before it; its output
//    out[u, t0 : t0+F, :] is one contiguous run of F*wl doubles, because
//    the frames of an utterance are adjacent in [B, T, wl].
//  - A persistent grid (a few blocks an SM) walks the tiles, tile i+1's
//    span loading while tile i is computed and stored.
//  - The preemphasised span y is computed once a sample into shared memory
//    (f64, zero at or past eff_len), and the frames are expanded from it:
//    no sample is read or preemphasised 2.5 times from global memory.
//  - Route "bulk" (the signal's base and row pitch 16-byte aligned, wl
//    even): each span is one cp.async.bulk copy (start rounded down, end
//    rounded up, to 16 bytes) into one of two shared buffers, completing
//    on that buffer's mbarrier. The frames leave as 16-byte stores from
//    registers, a warp writing 512 contiguous bytes. (Expanding them into
//    shared output tiles written out by cp.async.bulk stores measured
//    slower on the H100: PERF.md, section 6.)
//  - Route "edge" (odd wl, a row pitch or a base that is not 16-byte
//    aligned): the same tiles and grid; the span is read with plain loads
//    straight into y, and the frames leave as 8-byte stores.
//  - All index math inside a tile is 32-bit and incremental: one division
//    a tile and none an element.
// __dmul_rn/__dsub_rn keep nvcc from contracting x - c*prev into an FMA,
// so the result is bit-identical to the plain f64 version (two roundings).
// Samples at or past eff_len[u] (snip_edges, batch padding) and frames that
// run past the end of the signal read as zeros, which is the reference's
// zero-padding to whole frames.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"  // tkgemm: smem_u32 and the mbarrier helpers

namespace {

constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 232448;  // the most shared memory a Hopper block may use
constexpr int ROUTE_EDGE = 0, ROUTE_BULK = 1;

__host__ __device__ inline long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

// A block's shared memory, in bytes from its base (mirrored by
// ops/frame_preemph.py::frame_smem):
//   [y: a full tile's span f64, rounded up to 16 bytes]
//   [2 staged spans of xs f32]  route "bulk" only
//   [2 mbarriers]               route "bulk" only
struct Layout {
  int xs;  // floats a staged span holds: the span, the halo and 16-byte rounding at both ends
  int xbuf, bar;
  long long total;
};

__host__ __device__ inline Layout layout(int wl, int ws, int frames, int route) {
  Layout l;
  const long long span = static_cast<long long>(frames - 1) * ws + wl;
  const long long xs = round_up(span + 8, 4);
  const long long xbuf = round_up(span * 8, 16);
  const long long bar = xbuf + (route == ROUTE_BULK ? 2 * xs * 4 : 0);
  l.total = bar + (route == ROUTE_BULK ? 16 : 0);
  l.xs = static_cast<int>(xs);
  l.xbuf = static_cast<int>(xbuf);
  l.bar = static_cast<int>(bar);
  return l;
}

struct Problem {
  const float* sig;
  const int* eff_len;
  double* out;
  int s, t_max, wl, ws, frames, tiles_per_utt, tiles;
  double c;
};

struct Tile {
  int u;         // utterance
  int s0;        // its first sample: t0 * ws
  int len;       // samples its frames cover: (nf - 1) * ws + wl
  int nf;        // frames: F, or fewer at the end of an utterance
  int lim;       // samples at or past lim read as zero: min(eff_len[u], S)
  int64_t out0;  // its first output element: (u * t_max + t0) * wl
};

__device__ __forceinline__ Tile tile_at(const Problem& p, int tile) {
  Tile t;
  t.u = tile / p.tiles_per_utt;  // the one division of a tile
  const int t0 = (tile - t.u * p.tiles_per_utt) * p.frames;
  t.nf = min(p.frames, p.t_max - t0);
  t.s0 = t0 * p.ws;
  t.len = (t.nf - 1) * p.ws + p.wl;
  t.lim = max(0, min(p.eff_len[t.u], p.s));
  t.out0 = (static_cast<int64_t>(t.u) * p.t_max + t0) * p.wl;
  return t;
}

// Route "bulk": the samples [a0, a1) a tile stages, from its halo sample
// rounded down to 16 bytes to the end of its real samples rounded up (<= S,
// since S is a multiple of 4 on this route); empty when none is real.
__device__ __forceinline__ int2 staged_range(const Tile& t) {
  const int a0 = max(t.s0 - 1, 0) & ~3;
  const int a1 = min(static_cast<int>(round_up(t.s0 + t.len, 4)), static_cast<int>(round_up(t.lim, 4)));
  return make_int2(a0, max(a0, a1));
}

// One thread: arm the buffer's mbarrier with the span's bytes and issue
// its bulk copy (none for an empty span: the arrival alone completes it).
__device__ __forceinline__ void stage_span(const Problem& p, const Tile& t, float* dst, uint32_t bar) {
  const int2 r = staged_range(t);
  const uint32_t bytes = static_cast<uint32_t>(r.y - r.x) * 4u;
  tkgemm::mbar_arrive_expect_tx(bar, bytes);
  if (bytes != 0) {
    const float* src = p.sig + static_cast<int64_t>(t.u) * p.s + r.x;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            tkgemm::smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// y[i] = x[s0+i] - c * x[s0+i-1] over the tile's span, 0 at or past lim;
// sample g is read from x[g - a0] (a staged span, or a row of the signal
// with a0 = 0).
__device__ __forceinline__ void preemph_span(const Problem& p, const Tile& t, const float* x, int a0,
                                             double* y) {
  for (int i = threadIdx.x; i < t.len; i += THREADS) {
    const int g = t.s0 + i;
    double v = 0.0;
    if (g < t.lim) {
      const double cur = static_cast<double>(x[g - a0]);
      const double prev = g > 0 ? static_cast<double>(x[g - 1 - a0]) : 0.0;
      v = __dsub_rn(cur, __dmul_rn(p.c, prev));
    }
    y[i] = v;
  }
}

// The tile's frames from y: element j = f*wl + n of the tile is y[f*ws + n].
// A thread takes W adjacent elements (of one frame, since wl % W == 0) every
// W*THREADS, stepping (f, n) and k = f*ws + n without dividing: W = 2 on
// route "bulk" (a 16-byte store: wl is even and out 16-byte aligned), 1 on
// route "edge".
template <int ROUTE>
__device__ __forceinline__ void expand(const Problem& p, const Tile& t, const double* y) {
  constexpr int W = ROUTE == ROUTE_BULK ? 2 : 1;
  const int total = t.nf * p.wl;
  int j = W * threadIdx.x;
  int f = j / p.wl;
  int n = j - f * p.wl;
  int k = f * p.ws + n;
  for (; j < total; j += W * THREADS) {
    if constexpr (W == 1) {
      p.out[t.out0 + j] = y[k];
    } else {
      double2 v;
      v.x = y[k];
      v.y = y[k + 1];
      *reinterpret_cast<double2*>(p.out + t.out0 + j) = v;
    }
    n += W * THREADS;
    k += W * THREADS;
    while (n >= p.wl) {
      n -= p.wl;
      k += p.ws - p.wl;
    }
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(THREADS) frame_preemph_kernel(Problem p, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* y = reinterpret_cast<double*>(smem);
  float* xbuf = reinterpret_cast<float*>(smem + l.xbuf);
  const uint32_t bar = tkgemm::smem_u32(smem + l.bar);  // two mbarriers, 8 bytes apart
  int tile = blockIdx.x;
  if constexpr (ROUTE == ROUTE_BULK) {
    if (threadIdx.x == 0) {
      tkgemm::mbar_init(bar, 1);
      tkgemm::mbar_init(bar + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (tile < p.tiles) stage_span(p, tile_at(p, tile), xbuf, bar);
    }
    __syncthreads();
  }
  for (int i = 0; tile < p.tiles; ++i, tile += gridDim.x) {
    const Tile t = tile_at(p, tile);
    const int buf = i & 1;
    if constexpr (ROUTE == ROUTE_BULK) {
      const int next = tile + gridDim.x;
      if (threadIdx.x == 0 && next < p.tiles) {
        // the other buffer was last read (tile i-1's y) before the block's
        // last barrier; order those reads before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage_span(p, tile_at(p, next), xbuf + (buf ^ 1) * l.xs, bar + 8 * (buf ^ 1));
      }
      tkgemm::mbar_wait(bar + 8 * buf, (i >> 1) & 1);
      preemph_span(p, t, xbuf + buf * l.xs, staged_range(t).x, y);
    } else {
      preemph_span(p, t, p.sig + static_cast<int64_t>(t.u) * p.s, 0, y);
    }
    __syncthreads();  // y is complete
    expand<ROUTE>(p, t, y);
    __syncthreads();  // the next tile rewrites y
  }
}

template <int ROUTE>
cudaError_t launch(const Problem& p, const Layout& l, int grid, cudaStream_t stream) {
  auto kernel = frame_preemph_kernel<ROUTE>;
  const int smem = static_cast<int>(l.total);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p, l);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of a block of the plan (route 0 edge / 1 bulk), capped at
// 2^31 - 1; -1 for an unknown route.
extern "C" int tk_frame_smem(int wl, int ws, int frames, int route) {
  if ((route != ROUTE_EDGE && route != ROUTE_BULK) || wl < 1 || ws < 1 || frames < 1) return -1;
  const long long total = layout(wl, ws, frames, route).total;
  return static_cast<int>(total < (1LL << 31) ? total : (1LL << 31) - 1);
}

// frames [b, t_max, wl] f64 from sig [b, s] f32 and eff_len [b] int32, on
// the route (0 edge / 1 bulk), tile depth (frames) and grid of frame_plan.
// Returns cudaErrorInvalidValue for a plan this file cannot run (an unknown
// route, shared memory past the block's limit, a span past 32-bit sample
// indices), else the launch's error.
extern "C" int tk_frame_preemph_f64(const void* sig, const void* eff_len, void* out, int b, int s, int t_max,
                                    int wl, int ws, double c, int route, int frames, int grid, void* stream) {
  if ((route != ROUTE_EDGE && route != ROUTE_BULK) || b < 0 || s < 1 || t_max < 0 || wl < 1 || ws < 1 ||
      frames < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(t_max) * ws + wl >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(wl, ws, frames, route);
  if (l.total > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.sig = static_cast<const float*>(sig);
  p.eff_len = static_cast<const int*>(eff_len);
  p.out = static_cast<double*>(out);
  p.s = s;
  p.t_max = t_max;
  p.wl = wl;
  p.ws = ws;
  p.frames = frames;
  p.tiles_per_utt = (t_max + frames - 1) / frames;
  const long long tiles = static_cast<long long>(b) * p.tiles_per_utt;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.c = c;
  if (p.tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(route == ROUTE_EDGE ? launch<ROUTE_EDGE>(p, l, grid, st)
                                              : launch<ROUTE_BULK>(p, l, grid, st));
}
