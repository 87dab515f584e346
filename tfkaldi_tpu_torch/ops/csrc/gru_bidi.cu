// Both directions of a (Bi)GRU layer:
//   kernel 6, the forward: gh = round_cd(h_{t-1}) @ W_h; r = sig(gx_r +
//     gh_r), z = sig(gx_z + gh_z), n = tanh(gx_n + r*gh_n), h = (1-z)*n +
//     z*h_{t-1}, frozen where the mask is 0; ys = h*m; with the residuals
//     acts (r, z, n), hs, h_cd = round_cd(h_{t-1}) and gh_n. The persistent
//     kernel (rnn_step.cuh::persistent_fwd with GruCell, one cooperative
//     launch per layer call) or, on the shapes the launch plan refuses
//     (ops/rnn_bidi.py::fwd_plan), gru_fwd_step, one launch per time step;
//   kernel 7, the backward: dh = dh_carry + round_cd(dgh_prev) @ W_h^T,
//     then the elementwise backward of this step -> dgx and dgh (whose n
//     block carries the reset-gate factor r), and the dh carry. The
//     persistent kernel (rnn_step.cuh::persistent_bwd with GruBwdCell, one
//     cooperative launch per layer call) or, on the shapes
//     ops/rnn_bidi.py::bwd_plan refuses, gru_bwd_step, one launch per time
//     step.
//
// Replaces the TPU kernels tfkaldi_tpu/ops/pallas_gru.py::_make_fwd_kernel
// (launched by _fwd_call) and ::_make_bwd_kernel (launched by _bwd_call),
// behind the custom VJP gru_scan_bidi. Directions, time order, what bounds
// it and the design are those of lstm_bidi.cu (see rnn_step.cuh) with three
// gate blocks instead of four: 0.40 GFLOP a step for both directions at
// B = 128, H = 512 (0.41 us at the bf16 tensor-core rate, 6.1 us at the f32
// FMA rate); a persistent CTA holds a W_h slice of 512 x 48 (48 KB bf16,
// 96 KB f32). The backward's product is [B, 3H] x [3H, H]: a persistent
// CTA stages the published round_cd(dgh) of its 64 rows, [64, 1536], 192
// KB in bf16 each step, and holds W_h's 16 rows [16, 1536] (48 KB bf16,
// 96 KB f32). The weight gradient (h_cd^T @ dgh) stays outside, as one
// torch.matmul.

#include "rnn_step.cuh"

namespace {

using namespace tk_rnn;

// The elementwise step of one (row, j) pair for persistent_fwd; the op
// order and roundings of gru_fwd_step. c is unused (the GRU has no cell).
struct GruCell {
  static constexpr int G = 3;
  static __device__ __forceinline__ void step(const float (&gx)[3], const float (&acc)[3], float m, float& h,
                                              float& c, float (&act)[3], float& state, float& ghn) {
    const float gr = sigmoid(add(gx[0], acc[0]));
    const float gz = sigmoid(add(gx[1], acc[1]));
    ghn = acc[2];
    const float gn = tanhf(add(gx[2], mul(gr, ghn)));
    const float h_cand = add(mul(sub(1.0f, gz), gn), mul(gz, h));
    h = m != 0.0f ? h_cand : h;  // a select: garbage in padded gx cannot leak
    act[0] = gr, act[1] = gz, act[2] = gn;
    state = h;
    (void)c;
  }
};

// The elementwise backward of one (row, j) pair for persistent_bwd; the op
// order and roundings of gru_bwd_step. dh is the carry (before this step's
// product is added); prev: hs_{t_in}; dc and state are unused.
struct GruBwdCell {
  static constexpr int G = 3;
  static __device__ __forceinline__ void step(const float (&act)[3], float dy, float state, float prev, float ghn,
                                              float m, float acc, float& dh_c, float& dc_c, float (&dgx)[3],
                                              float (&dgw)[3]) {
    const float gr = act[0], gz = act[1], gn = act[2];
    const float dh = add(dh_c, acc);
    const float dh_cand = mul(m, add(dh, dy));
    float dh_prev = mul(sub(1.0f, m), dh);
    const float dn = mul(sub(1.0f, gz), dh_cand);
    const float dz = mul(sub(prev, gn), dh_cand);
    dh_prev = add(dh_prev, mul(gz, dh_cand));
    const float dpre_n = mul(sub(1.0f, mul(gn, gn)), dn);
    const float dr = mul(dpre_n, ghn);
    const float dpre_r = mul(mul(gr, sub(1.0f, gr)), dr);
    const float dpre_z = mul(mul(gz, sub(1.0f, gz)), dz);
    dgx[0] = dpre_r, dgx[1] = dpre_z, dgx[2] = dpre_n;
    dgw[0] = dpre_r, dgw[1] = dpre_z, dgw[2] = mul(dpre_n, gr);
    dh_c = dh_prev;
    (void)dc_c;
    (void)state;
  }
};

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
gru_fwd_step(FwdDir d0, FwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
             int s) {
  const FwdDir d = blockIdx.z == 0 ? d0 : d1;
  const int t = blockIdx.z == 0 ? s : t_len - 1 - s;
  const float* h_in = static_cast<float*>(d.h) + static_cast<int64_t>(s & 1) * B * H;
  float* h_out = static_cast<float*>(d.h) + static_cast<int64_t>((s + 1) & 1) * B * H;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BJ;
  float acc[RPT][3] = {};
  fwd_product<3, T>(h_in, static_cast<const T*>(d.wh), B, H, row0, j0, acc);
  const int j = j0 + threadIdx.x % BJ;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + (threadIdx.x / BJ) * RPT + r;
    if (row >= B) break;
    const int64_t bt = static_cast<int64_t>(t) * B + row;
    const int64_t bh = static_cast<int64_t>(row) * H + j;
    const int64_t q = bt * 3 * H + j;  // gate r of (t, row, j); z, n follow at +H
    const float m = mask[bt];
    const float h = h_in[bh];
    const float gr = sigmoid(add(d.gx[q], acc[r][0]));
    const float gz = sigmoid(add(d.gx[q + H], acc[r][1]));
    const float ghn = acc[r][2];
    const float gn = tanhf(add(d.gx[q + 2 * H], mul(gr, ghn)));
    const float h_cand = add(mul(sub(1.0f, gz), gn), mul(gz, h));
    const float h_new = m != 0.0f ? h_cand : h;  // a select: garbage in padded gx cannot leak
    h_out[bh] = h_new;
    d.ys[bt * H + j] = mul(h_new, m);
    if (RES) {
      d.acts[q] = gr;
      d.acts[q + H] = gz;
      d.acts[q + 2 * H] = gn;
      d.state[bt * H + j] = h_new;
      static_cast<T*>(d.hcd)[bt * H + j] = from_f32<T>(h);
      d.ghn[bt * H + j] = ghn;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_bwd_step(BwdDir d0, BwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
             int s) {
  const BwdDir d = blockIdx.z == 0 ? d0 : d1;
  const int t = blockIdx.z == 0 ? t_len - 1 - s : s;   // cotangents flow against each direction
  const int t_done = blockIdx.z == 0 ? t + 1 : t - 1;  // the previous launch's step
  const int t_in = blockIdx.z == 0 ? t - 1 : t + 1;    // the step whose h this step consumed
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BJ;
  float acc[RPT] = {};
  if (s > 0) {  // the first step has no product: its carry is zero
    bwd_product<3, T>(d.dgh + static_cast<int64_t>(t_done) * B * 3 * H,
                      static_cast<const T*>(d.wh), B, H, row0, j0, acc);
  }
  const int j = j0 + threadIdx.x % BJ;
  if (j >= H) return;
  const bool has_prev = t_in >= 0 && t_in < t_len;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + (threadIdx.x / BJ) * RPT + r;
    if (row >= B) break;
    const int64_t bt = static_cast<int64_t>(t) * B + row;
    const int64_t bh = static_cast<int64_t>(row) * H + j;
    const int64_t q = bt * 3 * H + j;
    const float m = mask[bt];
    const float dh = s > 0 ? add(static_cast<const float*>(d.dh)[bh], acc[r]) : 0.0f;
    const float gr = d.acts[q], gz = d.acts[q + H], gn = d.acts[q + 2 * H];
    const float hp = has_prev ? d.state[(static_cast<int64_t>(t_in) * B + row) * H + j] : 0.0f;
    // the op order of gru_scan._backward
    const float dh_cand = mul(m, add(dh, d.dy[bt * H + j]));
    float dh_prev = mul(sub(1.0f, m), dh);
    const float dn = mul(sub(1.0f, gz), dh_cand);
    const float dz = mul(sub(hp, gn), dh_cand);
    dh_prev = add(dh_prev, mul(gz, dh_cand));
    const float dpre_n = mul(sub(1.0f, mul(gn, gn)), dn);
    const float dr = mul(dpre_n, d.ghn[bt * H + j]);
    const float dpre_r = mul(mul(gr, sub(1.0f, gr)), dr);
    const float dpre_z = mul(mul(gz, sub(1.0f, gz)), dz);
    d.dgx[q] = dpre_r;
    d.dgx[q + H] = dpre_z;
    d.dgx[q + 2 * H] = dpre_n;
    d.dgh[q] = dpre_r;
    d.dgh[q + H] = dpre_z;
    d.dgh[q + 2 * H] = mul(dpre_n, gr);
    static_cast<float*>(d.dh)[bh] = dh_prev;  // only this thread reads or writes dh[row, j]
  }
}

}  // namespace

// ptrs: PTRS pointers per direction (FwdDir / BwdDir order), dirs = 1 or 2.
// The persistent forward: row_ctas CTAs along the batch, bar 2 zeroed
// unsigned counters.
extern "C" int tk_gru_fwd_persistent_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                         int b, int h, int residuals, int row_ctas, void* bar,
                                         void* stream) {
  return tk_rnn::run_persistent_fwd<GruCell, float>(ptrs, mask, dirs, t_len, b, h, residuals, row_ctas,
                                                    bar, stream);
}
extern "C" int tk_gru_fwd_persistent_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                          int b, int h, int residuals, int row_ctas, void* bar,
                                          void* stream) {
  return tk_rnn::run_persistent_fwd<GruCell, __nv_bfloat16>(ptrs, mask, dirs, t_len, b, h, residuals,
                                                            row_ctas, bar, stream);
}
// The step route of the forward: one launch per time step.
extern "C" int tk_gru_fwd_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                              int b, int h, int residuals, void* stream) {
  return tk_rnn::run_fwd(gru_fwd_step<float, true>, gru_fwd_step<float, false>, ptrs, mask,
                         dirs, t_len, b, h, residuals, stream);
}
extern "C" int tk_gru_fwd_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                               int b, int h, int residuals, void* stream) {
  return tk_rnn::run_fwd(gru_fwd_step<__nv_bfloat16, true>, gru_fwd_step<__nv_bfloat16, false>,
                         ptrs, mask, dirs, t_len, b, h, residuals, stream);
}
// The persistent backward: dh slot of each block the [2, B, 3H] exchange
// slots in the compute dtype; row_ctas and bar as for the forward.
extern "C" int tk_gru_bwd_persistent_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                         int b, int h, int row_ctas, void* bar, void* stream) {
  return tk_rnn::run_persistent_bwd<GruBwdCell, float>(ptrs, mask, dirs, t_len, b, h, row_ctas, bar, stream);
}
extern "C" int tk_gru_bwd_persistent_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                          int b, int h, int row_ctas, void* bar, void* stream) {
  return tk_rnn::run_persistent_bwd<GruBwdCell, __nv_bfloat16>(ptrs, mask, dirs, t_len, b, h, row_ctas, bar,
                                                               stream);
}
// The step route of the backward: one launch per time step.
extern "C" int tk_gru_bwd_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                              int b, int h, void* stream) {
  return tk_rnn::run_bwd(gru_bwd_step<float>, ptrs, mask, dirs, t_len, b, h, stream);
}
extern "C" int tk_gru_bwd_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                               int b, int h, void* stream) {
  return tk_rnn::run_bwd(gru_bwd_step<__nv_bfloat16>, ptrs, mask, dirs, t_len, b, h, stream);
}
