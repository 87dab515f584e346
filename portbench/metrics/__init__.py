"""One reader a metric: ``portbench/metrics/<metric>.py`` defines
``read(rec) -> float | None`` over a :class:`portbench.record.Record`
(``None`` where the run has nothing for it to read, and the metric is then
left out of the line). The helpers below are shared by the readers."""

from __future__ import annotations

import re

# the GEMM core of kernels 1 and 3 (ops/csrc/gemm_sm90.cuh), kernel 3's dz
# pass (bn_dgrad.cu)
GEMM_CORE = re.compile(r"tkgemm::(tma_gemm|splitk_reduce|simt_gemm)\b")
K3_DZ = re.compile(r"\bbn_dz_kernel\b")


def roofline_pct(rec, span: str, match, bounds: list[float]) -> float | None:
    """100 × Σ bound ÷ Σ device time of the operations ``match`` accepts
    launched inside the ``span`` annotations of the traced window; the
    i-th span's bound is ``bounds[i]``, counted where it launched any."""
    if rec.trace is None:
        return None
    groups = rec.trace.ops_by_span(span, lambda name: bool(match(name)))
    if len(groups) != len(bounds):
        return None
    bound = sum(b for ops, b in zip(groups, bounds) if ops)
    took = sum(op.end - op.start for ops in groups for op in ops) * 1e-6
    return 100.0 * bound / took if took > 0 else None


def idle_pct(rec) -> float | None:
    if rec.trace is None or rec.trace_extent is None:
        return None
    lo, hi = rec.trace_extent
    return 100.0 * (1.0 - rec.trace.busy_us(lo, hi) / (hi - lo)) if hi > lo else None


def model_dims(rec) -> dict:
    n = rec.nnet
    cw = int(n["context_width"])
    return {"inputs": rec.config["feat_dim"] * (2 * cw + 1), "layers": int(n["num_hidden_layers"]),
            "units": int(n["num_hidden_units"]), "labels": rec.config["num_labels"]}


def forward_flops(rec) -> float:
    from portbench import roofline

    d = model_dims(rec)
    return roofline.dnn_forward_flops(d["inputs"], d["layers"], d["units"], d["labels"])
