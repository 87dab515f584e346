// Both directions of a (Bi)LSTM layer:
//   kernel 4, the forward: gates = gx_t + round_cd(h_{t-1}) @ W_h; i, f, g,
//     o; c = f*c + i*g, h = o*tanh(c), frozen where the mask is 0; ys = h*m;
//     with the residuals acts (gates after activation), cs and h_cd =
//     round_cd(h_{t-1}). Two routes, picked by the wrapper's launch plan
//     (ops/rnn_bidi.py::fwd_plan) from the shape and dtype: the persistent
//     kernel (rnn_step.cuh::persistent_fwd with LstmCell: one cooperative
//     launch per layer call), or, where the W_h slice does not fit in
//     shared memory or the grid could not be co-resident, lstm_fwd_step,
//     one launch per time step;
//   kernel 5, the backward: the reverse-time LSTM backward of both
//     directions: dh = dh_carry + round_cd(dgates_prev) @ W_h^T, then the
//     elementwise backward of this step -> dgates (= dgx), dh/dc carries.
//     Two routes, picked by ops/rnn_bidi.py::bwd_plan: the persistent
//     kernel (rnn_step.cuh::persistent_bwd with LstmBwdCell, one
//     cooperative launch per layer call), or lstm_bwd_step, one launch per
//     time step.
//
// Replaces the TPU kernels tfkaldi_tpu/ops/pallas_lstm.py::_make_fwd_kernel
// (launched by _fwd_call) and ::_make_bwd_kernel (launched by _bwd_call),
// behind the custom VJP lstm_scan_bidi. The direction-0 stream walks
// t = 0..T-1 forward and T-1..0 in the backward, direction 1 the other way;
// outputs stay in natural time order. The weight gradient (h_cd^T @ dgx)
// stays outside, as one torch.matmul, as in the JAX package.
//
// What bounds it on an H100: a step is a [B, H] x [H, 4H] product per
// direction that depends on the previous step. At B = 128, H = 512 both
// directions do 0.54 GFLOP a step (275 GFLOP over T = 512): 0.55 us a step
// at the 989 TFLOP/s bf16 tensor-core rate, 8.1 us at the 67 TFLOP/s f32
// FMA rate. Its bytes from device memory (gx, the outputs and residuals,
// W_h once) take about 1.6 us a step; what a step cannot hide is its
// dependency on the step before: a barrier across the CTAs of a direction
// and the L2 round trip of the published h.
// What the design does about it (the persistent route): W_h stays in
// shared memory for the whole call (64 KB bf16 / 128 KB f32 a CTA at H
// 512), so no step re-reads it; the bf16 product runs on the tensor cores;
// h and c stay in registers, and only round_cd(h) goes through L2, in the
// h_cd residual the backward needs anyway; the next step's gx is loaded
// while the CTA waits at the barrier; a step costs a barrier per direction
// instead of a launch. At the recipe's shape the grid is 2 directions x 2
// row tiles of 64 x 32 tiles of 16 units = 128 CTAs, one per SM.
// The backward does the same work (its product is [B, 4H] x [4H, H]) and
// adds one cost the forward does not have: every CTA needs the whole
// published round_cd(dgates) of its 64 rows, [64, 2048], 256 KB in bf16
// (512 KB in f32) from L2 each step, 32 MB a step over the 128 CTAs, where
// the forward stages 64 KB a CTA. The persistent backward keeps W_h's 16
// rows of a CTA in shared memory (64 KB bf16 / 128 KB f32), dh and dc in
// registers, streams the dgates tile by TMA through a ring of 8 (bf16) / 5
// (f32) chunks so the copy of the next chunks overlaps the product of the
// one that has landed, and splits the depth of 2048 across its 8 warps so
// each warp runs 8 independent mma chains (see rnn_step.cuh).
//
// Any T, B, H: the loaders and the epilogue mask every edge.

#include "rnn_step.cuh"

namespace {

using namespace tk_rnn;

// The elementwise step of one (row, j) pair for persistent_fwd; the op
// order and roundings of lstm_fwd_step.
struct LstmCell {
  static constexpr int G = 4;
  static __device__ __forceinline__ void step(const float (&gx)[4], const float (&acc)[4], float m, float& h,
                                              float& c, float (&act)[4], float& state, float& ghn) {
    const float gi = sigmoid(add(gx[0], acc[0]));
    const float gf = sigmoid(add(gx[1], acc[1]));
    const float gg = tanhf(add(gx[2], acc[2]));
    const float go = sigmoid(add(gx[3], acc[3]));
    const float c_cand = add(mul(gf, c), mul(gi, gg));
    const float h_cand = mul(go, tanhf(c_cand));
    const bool keep = m != 0.0f;  // a select: garbage in padded gx cannot leak
    h = keep ? h_cand : h;
    c = keep ? c_cand : c;
    act[0] = gi, act[1] = gf, act[2] = gg, act[3] = go;
    state = c;
    ghn = 0.0f;
  }
};

// The elementwise backward of one (row, j) pair for persistent_bwd; the op
// order and roundings of lstm_bwd_step. dh and dc are the carries (dh
// before this step's product is added); state: cs_t; prev: cs_{t_in}.
struct LstmBwdCell {
  static constexpr int G = 4;
  static __device__ __forceinline__ void step(const float (&act)[4], float dy, float state, float prev, float ghn,
                                              float m, float acc, float& dh_c, float& dc_c, float (&dgx)[4],
                                              float (&dgw)[4]) {
    const float i = act[0], f = act[1], g = act[2], o = act[3];
    const float dh = add(dh_c, acc);
    const float dc = dc_c;
    const float dh_cand = mul(m, add(dh, dy));
    const float dh_prev = mul(sub(1.0f, m), dh);
    float dc_cand = mul(m, dc);
    float dc_prev = mul(sub(1.0f, m), dc);
    const float tc = tanhf(state);
    const float do_gate = mul(tc, dh_cand);
    dc_cand = add(dc_cand, mul(mul(o, sub(1.0f, mul(tc, tc))), dh_cand));
    const float df_gate = mul(prev, dc_cand);
    dc_prev = add(dc_prev, mul(f, dc_cand));
    const float di_gate = mul(g, dc_cand);
    const float dg_gate = mul(i, dc_cand);
    dgx[0] = mul(mul(i, sub(1.0f, i)), di_gate);
    dgx[1] = mul(mul(f, sub(1.0f, f)), df_gate);
    dgx[2] = mul(sub(1.0f, mul(g, g)), dg_gate);
    dgx[3] = mul(mul(o, sub(1.0f, o)), do_gate);
    for (int q = 0; q < 4; ++q) dgw[q] = dgx[q];
    dh_c = dh_prev;
    dc_c = dc_prev;
    (void)ghn;
  }
};

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_step(FwdDir d0, FwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
              int s) {
  const FwdDir d = blockIdx.z == 0 ? d0 : d1;
  const int t = blockIdx.z == 0 ? s : t_len - 1 - s;
  const float* h_in = static_cast<float*>(d.h) + static_cast<int64_t>(s & 1) * B * H;
  float* h_out = static_cast<float*>(d.h) + static_cast<int64_t>((s + 1) & 1) * B * H;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BJ;
  float acc[RPT][4] = {};
  fwd_product<4, T>(h_in, static_cast<const T*>(d.wh), B, H, row0, j0, acc);
  const int j = j0 + threadIdx.x % BJ;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + (threadIdx.x / BJ) * RPT + r;
    if (row >= B) break;
    const int64_t bt = static_cast<int64_t>(t) * B + row;
    const int64_t bh = static_cast<int64_t>(row) * H + j;
    const int64_t q = bt * 4 * H + j;  // gate i of (t, row, j); f, g, o follow at +H
    const float m = mask[bt];
    const float h = h_in[bh];
    const float c = d.c[bh];
    const float gi = sigmoid(add(d.gx[q], acc[r][0]));
    const float gf = sigmoid(add(d.gx[q + H], acc[r][1]));
    const float gg = tanhf(add(d.gx[q + 2 * H], acc[r][2]));
    const float go = sigmoid(add(d.gx[q + 3 * H], acc[r][3]));
    const float c_cand = add(mul(gf, c), mul(gi, gg));
    const float h_cand = mul(go, tanhf(c_cand));
    const bool keep = m != 0.0f;  // a select: garbage in padded gx cannot leak
    const float h_new = keep ? h_cand : h;
    const float c_new = keep ? c_cand : c;
    h_out[bh] = h_new;
    d.c[bh] = c_new;  // only this thread reads or writes c[row, j]
    d.ys[bt * H + j] = mul(h_new, m);
    if (RES) {
      d.acts[q] = gi;
      d.acts[q + H] = gf;
      d.acts[q + 2 * H] = gg;
      d.acts[q + 3 * H] = go;
      d.state[bt * H + j] = c_new;
      static_cast<T*>(d.hcd)[bt * H + j] = from_f32<T>(h);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_step(BwdDir d0, BwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
              int s) {
  const BwdDir d = blockIdx.z == 0 ? d0 : d1;
  // cotangents flow against each direction
  const int t = blockIdx.z == 0 ? t_len - 1 - s : s;
  const int t_done = blockIdx.z == 0 ? t + 1 : t - 1;  // the previous launch's step
  const int t_in = blockIdx.z == 0 ? t - 1 : t + 1;    // the step whose cell state t consumed
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BJ;
  float acc[RPT] = {};
  if (s > 0) {  // the first step has no product: its carries are zero
    bwd_product<4, T>(d.dgx + static_cast<int64_t>(t_done) * B * 4 * H,
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
    const int64_t q = bt * 4 * H + j;
    const float m = mask[bt];
    const float dh = s > 0 ? add(static_cast<const float*>(d.dh)[bh], acc[r]) : 0.0f;
    const float dc = s > 0 ? d.dc[bh] : 0.0f;
    const float i = d.acts[q], f = d.acts[q + H], g = d.acts[q + 2 * H], o = d.acts[q + 3 * H];
    const float cp = has_prev ? d.state[(static_cast<int64_t>(t_in) * B + row) * H + j] : 0.0f;
    // the op order of lstm_scan._backward
    const float dh_cand = mul(m, add(dh, d.dy[bt * H + j]));
    const float dh_prev = mul(sub(1.0f, m), dh);
    float dc_cand = mul(m, dc);
    float dc_prev = mul(sub(1.0f, m), dc);
    const float tc = tanhf(d.state[bt * H + j]);
    const float do_gate = mul(tc, dh_cand);
    dc_cand = add(dc_cand, mul(mul(o, sub(1.0f, mul(tc, tc))), dh_cand));
    const float df_gate = mul(cp, dc_cand);
    dc_prev = add(dc_prev, mul(f, dc_cand));
    const float di_gate = mul(g, dc_cand);
    const float dg_gate = mul(i, dc_cand);
    d.dgx[q] = mul(mul(i, sub(1.0f, i)), di_gate);
    d.dgx[q + H] = mul(mul(f, sub(1.0f, f)), df_gate);
    d.dgx[q + 2 * H] = mul(sub(1.0f, mul(g, g)), dg_gate);
    d.dgx[q + 3 * H] = mul(mul(o, sub(1.0f, o)), do_gate);
    static_cast<float*>(d.dh)[bh] = dh_prev;  // only this thread reads or writes dh[row, j], dc[row, j]
    d.dc[bh] = dc_prev;
  }
}

}  // namespace

// ptrs: PTRS pointers per direction (FwdDir / BwdDir order), dirs = 1 or 2.
// The persistent forward: row_ctas CTAs along the batch, bar 2 zeroed
// unsigned counters.
extern "C" int tk_lstm_fwd_persistent_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                          int b, int h, int residuals, int row_ctas, void* bar,
                                          void* stream) {
  return tk_rnn::run_persistent_fwd<LstmCell, float>(ptrs, mask, dirs, t_len, b, h, residuals, row_ctas,
                                                     bar, stream);
}
extern "C" int tk_lstm_fwd_persistent_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                           int b, int h, int residuals, int row_ctas, void* bar,
                                           void* stream) {
  return tk_rnn::run_persistent_fwd<LstmCell, __nv_bfloat16>(ptrs, mask, dirs, t_len, b, h, residuals,
                                                             row_ctas, bar, stream);
}
// Dynamic shared memory of a persistent CTA (bytes), for the wrapper's plan.
extern "C" int tk_rnn_fwd_smem(int gates, int h, int bf16) {
  return static_cast<int>(bf16 ? tk_rnn::persistent_smem<__nv_bfloat16>(gates, h)
                               : tk_rnn::persistent_smem<float>(gates, h));
}
// The step route of the forward: one launch per time step.
extern "C" int tk_lstm_fwd_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                               int b, int h, int residuals, void* stream) {
  return tk_rnn::run_fwd(lstm_fwd_step<float, true>, lstm_fwd_step<float, false>, ptrs, mask,
                         dirs, t_len, b, h, residuals, stream);
}
extern "C" int tk_lstm_fwd_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                int b, int h, int residuals, void* stream) {
  return tk_rnn::run_fwd(lstm_fwd_step<__nv_bfloat16, true>, lstm_fwd_step<__nv_bfloat16, false>,
                         ptrs, mask, dirs, t_len, b, h, residuals, stream);
}
// The persistent backward: dh slot of each block the [2, B, 4H] exchange
// slots in the compute dtype; row_ctas and bar as for the forward.
extern "C" int tk_lstm_bwd_persistent_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                          int b, int h, int row_ctas, void* bar, void* stream) {
  return tk_rnn::run_persistent_bwd<LstmBwdCell, float>(ptrs, mask, dirs, t_len, b, h, row_ctas, bar, stream);
}
extern "C" int tk_lstm_bwd_persistent_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                           int b, int h, int row_ctas, void* bar, void* stream) {
  return tk_rnn::run_persistent_bwd<LstmBwdCell, __nv_bfloat16>(ptrs, mask, dirs, t_len, b, h, row_ctas, bar,
                                                                stream);
}
// Dynamic shared memory of a persistent backward CTA (bytes), for the wrapper's plan.
extern "C" int tk_rnn_bwd_smem(int gates, int h, int bf16) {
  return static_cast<int>(bf16 ? tk_rnn::persistent_bwd_smem<__nv_bfloat16>(gates, h)
                               : tk_rnn::persistent_bwd_smem<float>(gates, h));
}
// The step route of the backward: one launch per time step.
extern "C" int tk_lstm_bwd_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                               int b, int h, void* stream) {
  return tk_rnn::run_bwd(lstm_bwd_step<float>, ptrs, mask, dirs, t_len, b, h, stream);
}
extern "C" int tk_lstm_bwd_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                int b, int h, void* stream) {
  return tk_rnn::run_bwd(lstm_bwd_step<__nv_bfloat16>, ptrs, mask, dirs, t_len, b, h, stream);
}
