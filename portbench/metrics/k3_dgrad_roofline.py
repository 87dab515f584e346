"""``k3_dgrad_roofline``: kernel 3 (``ops/csrc/bn_dgrad.cu``: the dz pass, then
``dh = dz @ wᵀ`` on the GEMM core) in the traced window's train steps:
Σ bound of each step's padded shape ÷ Σ device time of its launches, in %.
Kernel names: ``bn_dz_kernel`` and the ``tkgemm::`` core, which only kernel
3 launches inside a train step."""

from portbench import roofline
from portbench.metrics import GEMM_CORE, K3_DZ, model_dims, roofline_pct


def read(rec):
    if not rec.steps:
        return None
    d = model_dims(rec)
    bounds = [roofline.dnn_kernel3_step_bound_s(s["batch"] * s["t_pad"], d["inputs"], d["layers"], d["units"],
                                                rec.compute_dtype) for s in rec.steps]
    return roofline_pct(rec, "train_step", lambda n: GEMM_CORE.search(n) or K3_DZ.search(n), bounds)
