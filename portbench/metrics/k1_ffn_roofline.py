"""``k1_ffn_roofline``: kernel 1 (``ops/csrc/fused_ffn.cu`` on the GEMM core,
every route) in the traced window's decode batches: Σ bound of each
batch's hidden layers at its padded rows ÷ Σ device time of the
``tkgemm::`` launches, in %."""

from portbench import roofline
from portbench.metrics import GEMM_CORE, model_dims, roofline_pct


def read(rec):
    if not rec.batches:
        return None
    d = model_dims(rec)
    fan_ins = [d["inputs"]] + [d["units"]] * (d["layers"] - 1)
    bounds = [sum(roofline.ffn_bound_s(b["rows"], k, d["units"], rec.compute_dtype) for k in fan_ins)
              for b in rec.batches]
    return roofline_pct(rec, "portbench.decode_batch", GEMM_CORE.search, bounds)
