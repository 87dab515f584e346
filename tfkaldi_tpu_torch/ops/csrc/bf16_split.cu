// The exact three-term bf16 split of an f32 tensor, in one pass, written in
// the zero-padded layout the tensor-core GEMMs that read it want.
//
// layers.product's tensor-core route feeds the f32 cotangent of a bf16
// product to bf16 GEMMs whole: g [batch, m, n] f32 becomes
// out [batch, m8, 3, n8] bf16 (m8, n8: m and n rounded up to 8) with
//   g1 = bf16(g), g2 = bf16(g - g1), g3 = bf16(g - g1 - g2)
// in rows 0..m-1 and columns 0..n-1 of each of the three blocks, and zeros
// in the padding (round to nearest even, as torch's f32 -> bf16 cast; each
// subtraction is exact in f32, and __fsub_rn keeps it a plain subtraction),
// so that g1 + g2 + g3 == g wherever the terms are normal bf16 values. The
// plain version is ops/bf16_split.py::split3_ref, which this kernel equals
// bit for bit. cuBLAS takes its Hopper kernels only for a contraction and
// an output width that are multiples of 16 bytes; the padding gives the
// GEMMs that read out both, and the zeros add nothing to their sums.
//
// What bounds it: HBM, 4 bytes read and 6 written an element. Done as
// torch element-wise ops the split takes five passes and about 38 bytes an
// element. Here each thread writes four consecutive columns of one padded
// row of all three blocks (8-byte stores), reading them with one 16-byte
// load where n is a multiple of 4 and g is 16-byte aligned (VEC_IN 4), else
// with four guarded scalar loads, on a grid-stride loop, with 32-bit index
// math when the output allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ void split_one(float x, __nv_bfloat16& a, __nv_bfloat16& b, __nv_bfloat16& c) {
  a = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(a));
  b = __float2bfloat16_rn(r1);
  c = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(b)));
}

template <int VEC_IN, typename Index>
__global__ void __launch_bounds__(THREADS) split3_kernel(const float* __restrict__ g, __nv_bfloat16* __restrict__ out,
                                                        Index groups, Index m, Index n, Index m8, Index n8) {
  const Index row_groups = n8 / 4;
  const Index stride = static_cast<Index>(gridDim.x) * THREADS;
  for (Index i = static_cast<Index>(blockIdx.x) * THREADS + threadIdx.x; i < groups; i += stride) {
    const Index orow = i / row_groups;
    const Index col = (i - orow * row_groups) * 4;
    const Index bat = orow / m8;
    const Index r = orow - bat * m8;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < m) {
      const float* src = g + (bat * m + r) * n + col;
      if constexpr (VEC_IN == 4) {
        if (col < n) {
          const float4 q = *reinterpret_cast<const float4*>(src);
          v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) v[j] = src[j];
      }
    }
    __align__(8) __nv_bfloat16 t[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_one(v[j], t[0][j], t[1][j], t[2][j]);
    __nv_bfloat16* dst = out + orow * 3 * n8 + col;
#pragma unroll
    for (int j = 0; j < 3; ++j) *reinterpret_cast<uint2*>(dst + j * n8) = *reinterpret_cast<const uint2*>(t[j]);
  }
}

template <int VEC_IN>
cudaError_t launch(const float* g, __nv_bfloat16* out, long long batch, long long m, long long n, long long m8,
                   long long n8, cudaStream_t st) {
  const long long groups = batch * m8 * (n8 / 4);
  const long long blocks = (groups + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  if (3 * batch * m8 * n8 < (1LL << 31))
    split3_kernel<VEC_IN, int><<<grid, THREADS, 0, st>>>(g, out, static_cast<int>(groups), static_cast<int>(m),
                                                         static_cast<int>(n), static_cast<int>(m8),
                                                         static_cast<int>(n8));
  else
    split3_kernel<VEC_IN, long long><<<grid, THREADS, 0, st>>>(g, out, groups, m, n, m8, n8);
  return cudaGetLastError();
}

}  // namespace

// out [batch, m8, 3, n8] bf16 from g [batch, m, n] f32, both contiguous;
// m8 >= m and n8 >= n multiples of 8; vec_in 4 needs n a multiple of 4 and
// g 16-byte aligned, vec_in 1 takes any. Returns cudaErrorInvalidValue for
// arguments this file cannot run, else the launch's error.
extern "C" int tk_split3_bf16(const void* g, void* out, long long batch, long long m, long long n, long long m8,
                              long long n8, int vec_in, void* stream) {
  if (batch < 0 || m < 0 || n < 1 || m8 < m || n8 < n || m8 % 8 != 0 || n8 % 8 != 0 || (vec_in != 1 && vec_in != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_in == 4 && (n % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch * m8 == 0) return 0;
  const float* src = static_cast<const float*>(g);
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec_in == 4 ? launch<4>(src, dst, batch, m, n, m8, n8, st)
                                      : launch<1>(src, dst, batch, m, n, m8, n8, st));
}
