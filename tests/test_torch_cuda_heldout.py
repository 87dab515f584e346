"""The held-out accuracy gates of ``tfkaldi_tpu_torch.heldout``, trained
and decoded on the card through ``Nnet``.

The seven gates that twin tests/test_heldout_accuracy.py start from the
JAX package's initial weights (``tests/heldout_init/<gate>.npz``);
``flagship`` (the recipe's 440 -> 6 x 2048 DNN on a 26-class corpus,
batches of 128) from the port's seeded init. Every gate runs in f32;
``flagship`` and the three recipes whose shipped config computes in bf16
(``ctc``: config_AURORA4_ctc.cfg, ``conformer_transducer``:
config_AURORA4_transducer.cfg, ``conformer_attention``:
config_AURORA4_attention.cfg) also with ``[nnet] compute_dtype =
bfloat16``, held to the f32 gate's own limit. A gate fails on a value past
its limit or on a kernel its row names (``Gate.kernels``) that never
launched, and the launches it reports must be the counters' change over
its run.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_heldout.py --noconftest -q -m cuda -s
"""

import json
import os

import pytest
import torch

from tfkaldi_tpu_torch import heldout

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "heldout_init")
RUNS = [(name, "float32") for name in heldout.JAX_GATES] + [
    ("flagship", "float32"), ("flagship", "bfloat16"), ("ctc", "bfloat16"), ("conformer_transducer", "bfloat16"),
    ("conformer_attention", "bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("name,dtype", RUNS, ids=[f"{name}-{dtype}" for name, dtype in RUNS])
def test_heldout_gate(cuda, name, dtype, tmp_path):
    gate = heldout.GATES[name]
    init = os.path.join(FIXTURES, f"{name}.npz") if gate.source else None
    before = heldout.kernel_counts()
    result = heldout.run_gate(gate, str(tmp_path), device=cuda, init=init, compute_dtype=dtype)
    after = heldout.kernel_counts()
    keys = ("compute_dtype", "init", "metric", "limit", "values", "steps", "final_loss", "seconds", "launches")
    print(json.dumps({k: result[k] for k in keys}))  # shown with -s
    assert result["compute_dtype"] == dtype
    assert {k: {r: after[k][r] - before[k].get(r, 0) for r in after[k]} for k in after} == result["launches"]
    assert heldout.failures(gate, result) == []
