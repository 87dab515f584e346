"""The port's update on a grid of gloo ranks against the JAX package's
single-device update on the whole batch (tests/test_parallel.py on
``torch.distributed``).

One module fixture starts one world of 4 CPU ranks, each a fresh Python
process that imports the port only (a worker script written below). Each
case builds the port's state from the JAX state
(:func:`tfkaldi_tpu_torch.convert.train_state_from_jax`), splits it over its
grid (:func:`tfkaldi_tpu_torch.parallel.shard_state`), takes two steps on
its rows of two seeded global batches, gathers the whole state back and
saves it; meanwhile this process runs the JAX ``Trainer`` on the whole
batches. The grid's rank-ordered local batches concatenate to the JAX
batch. Two steps, since the JAX init's output layer is zero: the first step
moves only the output layer, the second every layer, through the column
gathers and kernel 3's plain twin on the rank's rows.

Bounds: the losses within 1e-5 relative and every parameter within 1e-5
absolute for the DNN, TDNN, CNN, transformer and conformer (the JAX
test_parallel.py bounds); the data-split families within their own parity
tests' bounds (tests/test_torch_rnn.py, test_torch_ctc.py,
test_torch_transducer.py, test_torch_seq2seq.py: the losses within 1e-5
relative, the parameters within 2e-5, an attention key bias within 2 x
steps x lr). Two more cases hold the port against itself: the grid against
one process with dropout < 1, SpecAugment and micro-batches, and the split
state gathered back to the whole.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tfkaldi_tpu import models as jm
from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch import models as pm
from tfkaldi_tpu_torch.convert import train_state_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan
from tfkaldi_tpu_torch.parallel import Mesh, shard_state, split_dims
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 2
LR = 1e-3
IN, OUT, T = 24, 10, 16
TEXT_V, TEXT_L = 8, 4  # text families: 7 labels + the blank / SOS-EOS; at most 4 labels an utterance

# (name, family, (data, model), ranks); cases on disjoint ranks run at once
CASES = [
    ("dnn_4x1", "dnn", (4, 1), (0, 1, 2, 3)),
    ("dnn_2x2", "dnn", (2, 2), (0, 1, 2, 3)),
    ("dnn_1x4", "dnn", (1, 4), (0, 1, 2, 3)),
    ("tdnn_2x2", "tdnn", (2, 2), (0, 1, 2, 3)),
    ("cnn_2x2", "cnn", (2, 2), (0, 1, 2, 3)),
    ("transformer_2x2", "transformer", (2, 2), (0, 1, 2, 3)),
    ("conformer_2x2", "conformer", (2, 2), (0, 1, 2, 3)),
    ("lstm_ce_2x1", "lstm_ce", (2, 1), (0, 1)),
    ("lstm_ctc_2x1", "lstm_ctc", (2, 1), (2, 3)),
    ("transducer_2x1", "transducer", (2, 1), (0, 1)),
    ("seq2seq_2x1", "seq2seq", (2, 1), (2, 3)),
    ("dnn_micro_2x1", "dnn_micro", (2, 1), (0, 1)),
    ("dnn_dropout_2x2", "dnn_dropout", (2, 2), (0, 1, 2, 3)),
]
JAX_CASES = [c for c in CASES if c[1] != "dnn_dropout"]

_WORKER = textwrap.dedent("""
    import os, pickle, sys, types
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from tfkaldi_tpu_torch.convert import train_state_from_jax
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.parallel import full_state_dict, make_mesh, multihost, shard_batch, shard_state
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev, _ = multihost.initialize("cpu")
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    for case in cases:
        mesh = make_mesh(*case["grid"], ranks=case["ranks"])
        if mesh is None:
            continue
        state = train_state_from_jax(types.SimpleNamespace(**case["state"]), case["config"])
        whole = {{k: v.clone() for k, v in state.model.state_dict().items()}}
        trainer = Trainer(case["config"], TrainerConfig(**case["trainer"]), device=dev, mesh=mesh)
        state = shard_state(state, mesh)
        shapes = {{k: tuple(v.shape) for k, v in state.model.state_dict().items()}}
        back = full_state_dict(state.model, mesh)
        roundtrip = sorted(back) == sorted(whole) and all(torch.equal(back[k], v) for k, v in whole.items())
        losses = []
        for arrays in case["batches"]:
            state, loss = trainer.update(state, shard_batch(PaddedBatch(*arrays), mesh, dev))
            losses.append(float(loss))
        result = dict(losses=losses, model=full_state_dict(state.model, mesh), shapes=shapes, roundtrip=roundtrip,
                      adam_t=state.adam_t)
        if mesh.writer:
            torch.save(result, os.path.join(tmp, case["name"] + ".pt"))
        else:
            torch.save(losses, os.path.join(tmp, case["name"] + f".losses{{mesh.index}}.pt"))
    multihost.barrier("done")
    multihost.shutdown()
""")


def _family(family: str):
    """``(JAX model, port config, trainer kwargs, batch kind, global batch)``."""
    ce = dict(init_learning_rate=LR, num_steps=20)
    if family in ("dnn", "dnn_micro", "dnn_dropout"):
        kw = dict(input_dim=IN, num_labels=OUT, num_hidden_layers=2, num_hidden_units=32, batch_norm=True)
        jax_model = jm.DNN(jm.DNNConfig(**kw))
        if family == "dnn_micro":  # micro-batch 1 of 3 spans both ranks' rows
            return jax_model, pm.DNNConfig(**kw), {**ce, "micro_batches": 3}, "frames", 12
        if family == "dnn_dropout":
            return (jax_model, pm.DNNConfig(**kw, dropout=0.8),
                    {**ce, "micro_batches": 2, "spec_augment": True, "spec_time_width": 4, "spec_freq_width": 6},
                    "frames", 8)
        return jax_model, pm.DNNConfig(**kw), ce, "frames", 8
    if family == "tdnn":
        kw = dict(input_dim=IN, num_labels=OUT, num_hidden_layers=2, num_hidden_units=32, context="-1,0,1;-3,0,3")
        return jm.TDNN(jm.TDNNConfig(**kw)), pm.TDNNConfig(**kw), ce, "frames", 8
    if family == "cnn":
        kw = dict(input_dim=IN, num_labels=OUT, filters="4,6", kernels="5x3;3x3", pool="2,1", num_channels=1,
                  num_hidden_layers=2, num_hidden_units=32)
        return jm.CNN(jm.CNNConfig(**kw)), pm.CNNConfig(**kw), ce, "frames", 8
    if family in ("transformer", "conformer"):
        kw = dict(input_dim=IN, num_labels=OUT, num_blocks=2, d_model=16, num_heads=2, ffn_dim=32,
                  conformer=family == "conformer")
        return jm.Transformer(jm.TransformerConfig(**kw)), pm.TransformerConfig(**kw), ce, "frames", 8
    if family in ("lstm_ce", "lstm_ctc"):
        labels = OUT if family == "lstm_ce" else TEXT_V
        kw = dict(input_dim=IN, num_labels=labels, num_layers=1, hidden_units=16, bidirectional=True)
        jax_model = jm.LSTM(jm.RNNConfig(scan_unroll=1, **kw))
        if family == "lstm_ce":
            return jax_model, pm.RNNConfig(cell="lstm", **kw), ce, "frames", 8
        return (jax_model, pm.RNNConfig(cell="lstm", **kw), {**ce, "loss_type": "ctc", "ctc_blank_id": TEXT_V - 1},
                "text", 8)
    if family == "transducer":
        kw = dict(input_dim=IN, num_labels=TEXT_V - 1, enc_type="lstm", enc_layers=1, enc_units=8, pred_layers=1,
                  pred_units=8, embed_dim=6, joint_units=10, joint_chunk_t=3)
        return (jm.Transducer(jm.TransducerConfig(**kw)), pm.TransducerConfig(**kw), {**ce, "loss_type": "rnnt"},
                "text", 8)
    if family == "seq2seq":
        kw = dict(input_dim=IN, num_labels=TEXT_V - 1, enc_type="lstm", enc_layers=1, enc_units=8, dec_blocks=1,
                  d_model=12, num_heads=2, ffn_dim=16, ctc_weight=0.3, label_smoothing=0.1)
        return (jm.AttentionSeq2Seq(jm.Seq2SeqConfig(**kw)), pm.Seq2SeqConfig(**kw),
                {**ce, "loss_type": "attention"}, "text", 8)
    raise ValueError(family)


def _batches(kind: str, b: int, seed: int) -> list[tuple]:
    """``STEPS`` seeded global batches: ragged lengths (4-16 frames; 8-16
    for text targets of 1-4 labels), padding frames zero."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        lengths = rng.integers(8 if kind == "text" else 4, T + 1, b).astype(np.int32)
        x = rng.standard_normal((b, T, IN)).astype(np.float32)
        x[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
        if kind == "frames":
            out.append((x, rng.integers(0, OUT, (b, T)).astype(np.int32), lengths, lengths))
        else:
            tl = rng.integers(1, TEXT_L + 1, b).astype(np.int32)
            y = rng.integers(0, TEXT_V - 1, (b, TEXT_L)).astype(np.int32) * (np.arange(TEXT_L)[None, :] < tl[:, None])
            out.append((x, y.astype(np.int32), lengths, tl))
    return out


def _jax_start(jax_model, trainer_kw):
    jtrainer = JaxTrainer(jax_model, JaxTrainerConfig(**{k: v for k, v in trainer_kw.items()
                                                         if not k.startswith("spec")}))
    return jtrainer, jtrainer.init_state(jax.random.PRNGKey(0))


def _numpy_state(jstate) -> dict:
    """The attributes ``train_state_from_jax`` reads, as numpy: no JAX type
    crosses into the port's worker processes."""
    fields = ("params", "model_state", "adam_m", "adam_v", "adam_t", "step", "lr_fact")
    return {f: jax.tree.map(np.asarray, getattr(jstate, f)) for f in fields}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4-rank world on every case, run the JAX references and the
    port's one-process runs while it works, then collect."""
    tmp = tmp_path_factory.mktemp("parallel")
    starts, cases = {}, []
    for name, family, grid, ranks in CASES:
        jax_model, cfg, trainer_kw, kind, b = _family(family)
        jtrainer, jstate = _jax_start(jax_model, trainer_kw)
        batches = _batches(kind, b, seed=sum(map(ord, family)))  # a family's cases share their batches
        starts[name] = (jtrainer, jstate, cfg, trainer_kw, batches)
        cases.append(dict(name=name, grid=grid, ranks=ranks, config=cfg, trainer=trainer_kw, batches=batches,
                          state=_numpy_state(jstate)))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(root=ROOT))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD), port, str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    # meanwhile: the JAX single-device references and the port alone
    refs = {}
    try:
        for name, family, _, _ in CASES:
            jtrainer, jstate, cfg, trainer_kw, batches = starts[name]
            if family == "dnn_dropout":
                state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
                trainer = Trainer(cfg, TrainerConfig(**trainer_kw), device="cpu")
                losses = []
                for arrays in batches:
                    state, loss = trainer.update(state, PaddedBatch(*(torch.from_numpy(a) for a in arrays)))
                    losses.append(float(loss))
                refs[name] = (losses, {k: v.detach().clone() for k, v in state.model.state_dict().items()})
                continue
            if name in ("dnn_2x2", "dnn_1x4"):  # the same reference as dnn_4x1
                refs[name] = refs["dnn_4x1"]
                continue
            losses = []
            for arrays in batches:
                jstate, jloss = jtrainer.update(jstate, JaxPaddedBatch(*arrays))
                losses.append(float(jloss))
            want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
            refs[name] = (losses, dict(want.model.state_dict()))
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    results = {}
    for name, *_ in CASES:
        results[name] = torch.load(tmp / f"{name}.pt", weights_only=False)
        others = sorted(tmp.glob(f"{name}.losses*.pt"))
        results[name]["other_ranks"] = [torch.load(p, weights_only=False) for p in others]
    return results, refs


def _bounds(family: str, name: str) -> float:
    if family in ("lstm_ce", "lstm_ctc", "transducer", "seq2seq"):
        # their parity tests' bounds; a key bias's gradient is rounding noise
        return 2 * STEPS * LR if name.endswith(".bk") else 2e-5
    return 1e-5


@pytest.mark.parametrize("name,family,grid,ranks", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_grid_update_matches_jax_single_device(world, name, family, grid, ranks):
    results, refs = world
    got, (want_losses, want) = results[name], refs[name]
    assert got["adam_t"] == STEPS
    for step, (a, b) in enumerate(zip(got["losses"], want_losses)):
        assert abs(a - b) <= 1e-5 * abs(b), (step, a, b)
    # every rank logged the same global loss
    for other in got["other_ranks"]:
        assert other == got["losses"]
    for key, ref in want.items():
        mine = got["model"][key]
        assert mine.shape == ref.shape, key
        if key == "depth":
            assert torch.equal(mine, ref)
            continue
        atol = _bounds(family, key) if not key.startswith(("bn_", "enc.bn_")) else 1e-6
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=atol, rtol=0, err_msg=f"{name} {key}")


def test_grid_matches_one_process_with_dropout_specaugment_and_micro_batches(world):
    """Port against port: dropout (keep 0.8) and SpecAugment draw the whole
    batch's masks on every rank and keep their rows and columns, and the two
    micro-batches run on their own ranks, so the 2x2 grid takes the
    trajectory of one process."""
    results, refs = world
    got, (want_losses, want) = results["dnn_dropout_2x2"], refs["dnn_dropout_2x2"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=0)
    for other in got["other_ranks"]:
        assert other == got["losses"]
    for key, ref in want.items():
        np.testing.assert_allclose(got["model"][key].numpy(), ref.numpy(), atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["dnn_2x2", "dnn_1x4", "tdnn_2x2", "cnn_2x2", "conformer_2x2"])
def test_split_state_gathers_back_to_the_whole_state(world, name):
    assert world[0][name]["roundtrip"] is True


def test_split_parameters_hold_their_blocks(world):
    """The blocks a rank of the 2x2 grid holds (tests/test_parallel.py:57-66):
    hidden columns, the output's rows, the moving stats with their columns;
    the conformer's heads and FFNs by Megatron's rule."""
    dnn = world[0]["dnn_2x2"]["shapes"]
    assert dnn["hidden.0.w"] == (IN, 16) and dnn["hidden.1.w"] == (32, 16)
    assert dnn["hidden.0.b"] == dnn["hidden.0.beta"] == (16,)
    assert dnn["out.w"] == (16, OUT) and dnn["out.b"] == (OUT,)
    assert dnn["bn_mean"] == dnn["bn_var"] == (2, 16)
    assert world[0]["dnn_1x4"]["shapes"]["hidden.0.w"] == (IN, 8)
    assert world[0]["dnn_4x1"]["shapes"]["hidden.0.w"] == (IN, 32)
    conf = world[0]["conformer_2x2"]["shapes"]
    assert conf["blocks.0.attn.wq"] == (16, 8) and conf["blocks.0.attn.bq"] == (8,)
    assert conf["blocks.0.attn.wo"] == (8, 16) and conf["blocks.0.attn.bo"] == (16,)
    assert conf["blocks.1.ffn1.w1"] == (16, 16) and conf["blocks.1.ffn1.w2"] == (16, 16)
    assert conf["blocks.0.conv.w_in"] == (16, 32) and conf["in_proj.w"] == (IN, 16) and conf["out.w"] == (16, OUT)
    cnn = world[0]["cnn_2x2"]["shapes"]
    assert cnn["conv.0.w"] == (4, 1, 5, 3) and cnn["hidden.1.w"] == (32, 16) and cnn["out.w"] == (16, OUT)


@pytest.mark.parametrize("family", ["lstm_ce", "transducer", "seq2seq", "dnn", "cnn", "conformer"])
def test_split_rules_follow_the_jax_shardings(family):
    """``split_dims`` names exactly what ``_param_shardings`` splits
    (tfkaldi_tpu/parallel/mesh.py:48-139): nothing of the recurrent, the
    transducer and the seq2seq models (their encoders sit under ``enc``)."""
    model = pm.build_model(_family(family)[1])
    dims = split_dims(model)
    if family in ("lstm_ce", "transducer", "seq2seq"):
        assert dims == {}
    elif family in ("dnn", "cnn"):
        assert dims == {"hidden.0.w": 1, "hidden.0.b": 0, "hidden.0.beta": 0, "hidden.1.w": 1, "hidden.1.b": 0,
                        "hidden.1.beta": 0, "out.w": 0, "bn_mean": 1, "bn_var": 1}
    else:
        assert {k for k in dims if k.startswith("blocks.0.")} == {
            f"blocks.0.{m}.{p}" for m, ps in (("attn", ("wq", "bq", "wk", "bk", "wv", "bv", "wo")),
                                              ("ffn", ("w1", "b1", "w2")), ("ffn1", ("w1", "b1", "w2")))
            for p in ps}
        assert dims["blocks.1.attn.wo"] == 0 and dims["blocks.1.ffn.w1"] == 1


def test_heads_that_do_not_divide_raise():
    model = pm.build_model(pm.TransformerConfig(IN, OUT, num_blocks=1, d_model=12, num_heads=3, ffn_dim=16))
    state = Trainer(model.config, TrainerConfig(), device="cpu").init_state(0)
    mesh = Mesh(data=1, model=2, ranks=(0, 1), rank=0, data_group=None, model_group=None, host_group=None)
    with pytest.raises(ValueError, match="num_heads 3 does not divide over model_parallel 2"):
        shard_state(state, mesh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel3_plan_takes_the_column_block_on_the_tma_route(dtype):
    """Kernel 3 under the column split: ``dz [N, H/m] @ wᵀ`` with ``w [K,
    H/m]`` (2048 / 2 = 1024 columns, K 2048 and 440) plans the TMA route,
    as the whole layer does."""
    for k in (2048, 440):
        plan = gemm_plan(8192, 1024, k, dtype, "k", (0, 256, 1024))
        assert plan.route == "tma", (k, plan)
    assert gemm_plan(8192, 1024, 2048, dtype, "mn", (0, 256)).route == "tma"  # kernel 1's eval forward
