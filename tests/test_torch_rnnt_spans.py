"""The transducer's ``torch.profiler`` spans and lattice counters on a CPU
training step: ``rnnt.encode``, ``rnnt.predict``, ``rnnt.joint`` (in the
forward and again in the checkpoint's recompute) and ``rnnt.lattice`` each
open, and ``trainer.rnnt_lattice`` counts the lattice's rows, real cells
and padded cells as a hand count of the batch gives them."""

import json

import pytest
import torch

from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models.transducer import TransducerConfig
from tfkaldi_tpu_torch.train import trainer as trainer_mod
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

SPANS = ("rnnt.encode", "rnnt.predict", "rnnt.joint", "rnnt.lattice")
EXTRA = (("num_blocks", "1"), ("d_model", "16"), ("num_heads", "2"), ("ffn_dim", "16"), ("conv_kernel", "4"),
         ("subsample", "4"), ("pos_enc", "relative"), ("frontend", "conv2d"), ("conv_bn_scale", "True"))


def _step(prune_s, tmp_path):
    cfg = TransducerConfig(input_dim=8, num_labels=5, enc_type="conformer", pred_units=8, embed_dim=4, joint_units=8,
                           enc_extra=EXTRA, joint_chunk_t=2, prune_s=prune_s, dropout=0.9)
    trainer = Trainer(cfg, TrainerConfig(loss_type="rnnt", num_steps=10), device="cpu")
    state = trainer.init_state(0)
    lengths = torch.tensor([32, 21, 13], dtype=torch.int32)  # T' 7, 4, 2
    label_lengths = torch.tensor([5, 3, 1], dtype=torch.int32)
    batch = PaddedBatch(torch.randn(3, 32, 8), torch.randint(0, 5, (3, 6), dtype=torch.int32), lengths,
                        label_lengths)
    before = dict(trainer_mod.rnnt_lattice)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.update(state, batch)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    counts = {name: sum(e.get("cat") == "user_annotation" and e.get("name") == name for e in events)
              for name in SPANS}
    return counts, {k: trainer_mod.rnnt_lattice[k] - before[k] for k in before}


@pytest.mark.parametrize("route,prune_s,width", [("dense", 0, 7), ("banded", 3, 3)])
def test_spans_and_lattice_counters(tmp_path, route, prune_s, width):
    counts, lattice = _step(prune_s, tmp_path)
    # T' = 7 in blocks of 2 frames: 4 joint blocks, each opened again by its recompute
    assert counts["rnnt.encode"] == counts["rnnt.predict"] == 1 and counts["rnnt.joint"] == 2 * 4
    assert counts["rnnt.lattice"] >= 1
    # rows T' = 7; real cells Σ T'_b·min(U_b+1, W); padded = B·T'·W − real
    real = 7 * min(6, width) + 4 * min(4, width) + 2 * min(2, width)
    assert lattice == {"rows": 7, "real_cells": real, "padded_cells": 3 * 7 * width - real}
