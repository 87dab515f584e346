// Both directions of a (Bi)LSTM layer, one launch per time step:
//   kernel 4, lstm_fwd_step: gates = gx_t + round_cd(h_{t-1}) @ W_h; i, f, g, o;
//     c = f*c + i*g, h = o*tanh(c), frozen where the mask is 0; ys = h*m; with
//     the residuals acts (gates after activation), cs and h_cd = round_cd(h_{t-1});
//   kernel 5, lstm_bwd_step: the reverse-time LSTM backward of both
//     directions: dh = dh_carry + round_cd(dgates_prev) @ W_h^T, then the
//     elementwise backward of this step -> dgates (= dgx), dh/dc carries.
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
// directions do 0.54 GFLOP a step (275 GFLOP over T = 512), 8.1 us a step at
// the 67 TFLOP/s f32 FMA rate, while its bytes (W_h twice in bf16: 4 MB from
// L2; gx, acts and the streams: ~1.3 MB) take about a microsecond: bound by
// arithmetic, and by the step-to-step dependency, which no launch can hide.
// What the design does about it: nothing clever yet. One launch per step
// (the grid-wide barrier), tiles of 32 rows x 16 units (256 blocks of 128
// threads with both directions), the gate math fused after the product so
// the gates never go to device memory before their activation. A
// persistent kernel that keeps W_h slices in shared memory and runs the
// product on the tensor cores is later work (ROADMAP.md, queue 2).
//
// Any T, B, H: the loaders and the epilogue mask every edge.

#include "rnn_step.cuh"

namespace {

using namespace tk_rnn;

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_step(FwdDir d0, FwdDir d1, const float* __restrict__ mask, int t_len, int B, int H,
              int s) {
  const FwdDir d = blockIdx.z == 0 ? d0 : d1;
  const int t = blockIdx.z == 0 ? s : t_len - 1 - s;
  const float* h_in = d.h + static_cast<int64_t>(s & 1) * B * H;
  float* h_out = d.h + static_cast<int64_t>((s + 1) & 1) * B * H;
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
    const float dh = s > 0 ? add(d.dh[bh], acc[r]) : 0.0f;
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
    d.dh[bh] = dh_prev;  // only this thread reads or writes dh[row, j], dc[row, j]
    d.dc[bh] = dc_prev;
  }
}

}  // namespace

// ptrs: PTRS pointers per direction (FwdDir / BwdDir order), dirs = 1 or 2
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
extern "C" int tk_lstm_bwd_f32(const void* const* ptrs, const void* mask, int dirs, int t_len,
                               int b, int h, void* stream) {
  return tk_rnn::run_bwd(lstm_bwd_step<float>, ptrs, mask, dirs, t_len, b, h, stream);
}
extern "C" int tk_lstm_bwd_bf16(const void* const* ptrs, const void* mask, int dirs, int t_len,
                                int b, int h, void* stream) {
  return tk_rnn::run_bwd(lstm_bwd_step<__nv_bfloat16>, ptrs, mask, dirs, t_len, b, h, stream);
}
