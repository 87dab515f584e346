"""A dry run of multi-process training on a grid of ranks, checked against
one process.

Port of ``__graft_entry__.py::dryrun_multichip`` (:60) onto
``torch.distributed``::

    python -m tfkaldi_tpu_torch.parallel.dryrun --nproc 4 --device cpu

spawns ``--nproc`` ranks (gloo on the CPU, NCCL with ``--device cuda``, one
card a rank) on a ``data x model`` grid (``model = 2`` when ``nproc`` is
even and at least 4, as the JAX dry run picks it) and, at toy widths:

1. one update of every family the JAX dry run takes a step of (the DNN with
   batchnorm and two micro-batches, the BiLSTM on CE and on CTC, the TDNN,
   the CNN, the BiGRU, the conformer, the transducer dense and pruned, the
   conformer-transducer and the attention seq2seq) and one validation
   pass, each on the global batch split over the grid;
2. the training controller on a seeded featdir: layerwise growth with
   checkpoints, a save → restore → resume that must end bit-equal, a
   rollback under a divergent learning rate, and the likelihood emission of
   the final model on every rank's shard of the utterances.

With ``--flagship`` (for cards) it also takes 3 steps and one validation
pass of the flagship f32 DNN (440 → 6×2048 relu+BN → 2000, batch 128 × 512
frames) on the grid: kernel 3 then runs on the rank's rows and ``2048 /
model`` columns, kernel 1 on its column block; the losses are held to one
process's and the steps timed on the host clock after a synchronise.

The parent process runs the same schedule in one process meanwhile, and
every number of the grid is held against it: the losses within
``LOSS_RTOL``, the parameters after a step within ``PARAM_ATOL``, the
controller's loss trajectory within ``CTRL_RTOL`` and its likelihoods
within ``LIKE_ATOL``. It raises on the first difference and prints one
summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import socket
import sys
import tempfile
import time

import numpy as np
import torch

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5  # one Adam step from the same state: the rounding of the reductions' order
# the controller's 8 steps: a global batch of the grid holds the rows of one
# process's batch in another order (the strided shards), and Adam carries
# the rounding of the reordered sums from step to step
CTRL_RTOL = 1e-4
LIKE_ATOL = 1e-3
FEAT_DIM, CONTEXT, NUM_PDFS = 6, 1, 5


def _families(data: int):
    """``(name, model config, trainer config, batch kind)`` of step 1 at
    toy widths (the JAX dry run's), and the global batch size."""
    from tfkaldi_tpu_torch.models import (CNNConfig, DNNConfig, RNNConfig, Seq2SeqConfig, TDNNConfig,
                                          TransducerConfig, TransformerConfig)
    from tfkaldi_tpu_torch.train.trainer import TrainerConfig

    f, o = 48, 16
    ce = TrainerConfig(init_learning_rate=1e-3, num_steps=10)
    rnnt = TrainerConfig(init_learning_rate=1e-3, num_steps=10, loss_type="rnnt")
    small = dict(pred_layers=1, pred_units=16, embed_dim=8, joint_units=16)
    families = [
        ("dnn_bn", DNNConfig(f, o, num_hidden_layers=3, num_hidden_units=64, batch_norm=True),
         dataclasses.replace(ce, micro_batches=2), "frames"),
        ("lstm_ce", RNNConfig(f, o, num_layers=1, hidden_units=32, bidirectional=True), ce, "frames"),
        ("lstm_ctc", RNNConfig(f, o, num_layers=1, hidden_units=32, bidirectional=True),
         dataclasses.replace(ce, loss_type="ctc", ctc_blank_id=15), "text"),
        ("tdnn", TDNNConfig(f, o, num_hidden_layers=2, num_hidden_units=32, context="-1,0,1;-3,0,3"), ce, "frames"),
        ("cnn", CNNConfig(f, o, filters="8,8", kernels="5x3;3x3", pool="2,1", num_hidden_layers=2,
                          num_hidden_units=32), ce, "frames"),
        ("gru", RNNConfig(f, o, num_layers=1, hidden_units=32, bidirectional=True, cell="gru"), ce, "frames"),
        ("conformer", TransformerConfig(f, o, num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conformer=True,
                                        conv_kernel=7), ce, "frames"),
        ("transducer", TransducerConfig(f, 15, enc_layers=1, enc_units=32, **small), rnnt, "text"),
        ("transducer_pruned", TransducerConfig(f, 15, enc_layers=1, enc_units=32, prune_s=4, prune_band="guided",
                                               prune_proxy_stride=2, **small), rnnt, "text"),
        ("conformer_transducer", TransducerConfig(
            f, 15, enc_type="conformer", enc_extra=(("num_blocks", "2"), ("d_model", "32"), ("num_heads", "2"),
                                                    ("ffn_dim", "64"), ("conv_kernel", "7"), ("subsample", "2")),
            **small), rnnt, "text"),
        ("seq2seq", Seq2SeqConfig(f, 15, enc_type="lstm", enc_layers=1, enc_units=32, dec_blocks=1, d_model=32,
                                  num_heads=2, ffn_dim=48, ctc_weight=0.3),
         TrainerConfig(init_learning_rate=1e-3, num_steps=10, loss_type="attention"), "text"),
    ]
    return families, 2 * data * 2


def _global_batches(b: int):
    """The seeded global batches: frame targets and text targets (8 labels
    of 15), ragged lengths of 16-24 frames, 48-dim inputs."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch

    rng = np.random.default_rng(0)
    t, l_max = 24, 8
    lengths = rng.integers(16, t + 1, b).astype(np.int32)
    x = rng.standard_normal((b, t, 48)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    frames = PaddedBatch(x, rng.integers(0, 16, (b, t)).astype(np.int32), lengths, lengths)
    text = PaddedBatch(x, rng.integers(0, 15, (b, l_max)).astype(np.int32), lengths,
                       rng.integers(4, l_max + 1, b).astype(np.int32))
    return {"frames": frames, "text": text}


def run_families(device, mesh) -> dict:
    """Step 1 on the grid: one update and one validation pass of every
    family; returns ``{name: (loss, valid loss, whole parameters)}``."""
    from tfkaldi_tpu_torch.parallel.mesh import full_state_dict, shard_batch
    from tfkaldi_tpu_torch.train.trainer import Trainer

    families, b = _families(mesh.data)
    batches = _global_batches(b)
    out = {}
    for i, (name, cfg, tcfg, kind) in enumerate(families):
        trainer = Trainer(cfg, tcfg, device=device, mesh=mesh)
        state = trainer.init_state(100 + i)
        batch = shard_batch(batches[kind], mesh, device)
        state, loss = trainer.update(state, batch)
        valid = trainer.evaluate(state, [batch])
        params = {k: v for k, v in full_state_dict(state.model, mesh).items()
                  if k in dict(state.model.named_parameters())}
        out[name] = (float(loss), float(valid), params)
    return out


def _controller(root: str, savedir: str, device, mesh, *, lr: float, valid_adapt: bool, valid_retries: int,
                add_layer_period: int, num_epochs: int = 2, starting_step: int = 0, losses=None):
    """The training controller on the featdir's scp (this rank's shard of
    it on a grid), DNN 3x18 -> 5 with batchnorm."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.sharding import shard_path
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.models import DNNConfig
    from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig, TrainingController

    featdir, alifile = os.path.join(root, "featdir"), os.path.join(root, "pdf.all.gz")
    data = 1 if mesh is None else mesh.data
    scp = os.path.join(featdir, "feats.trimmed.scp")
    if data > 1:
        scp = shard_path(scp, data, mesh.data_index)
    batch_size = _CTRL_BATCH
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(scp, os.path.join(featdir, "cmvn.scp"), os.path.join(featdir, "utt2spk"), CONTEXT,
                           max_length)
    disp = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS), batch_size // data,
                                   alifile)
    cfg = DNNConfig(FEAT_DIM * (2 * CONTEXT + 1), NUM_PDFS, num_hidden_layers=3, num_hidden_units=18,
                    batch_norm=True, layerwise_init=add_layer_period > 0)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=lr, num_steps=int(disp.num_batches * num_epochs)),
                      device=device, mesh=mesh)
    opts = NnetTrainOptions(savedir=savedir, num_epochs=num_epochs, batch_size=batch_size, valid_batches=1,
                            valid_frequency=2, valid_adapt=valid_adapt, valid_retries=valid_retries, check_freq=2,
                            add_layer_period=add_layer_period, num_hidden_layers=3, starting_step=starting_step)

    def hook(loss, **_):
        if losses is not None:
            losses.append(loss)

    batcher = DeviceBatcher(fixed_input_length=max_length, fixed_target_length=max_length)
    ctrl = TrainingController(trainer, disp, batcher, opts, metrics_hook=hook)
    try:
        return ctrl.train(), int(disp.num_batches * num_epochs)
    finally:
        reader.close()


_CTRL_BATCH = 8
_CTRL_UTTS = 2 * 2 * _CTRL_BATCH  # 2 speakers


def make_controller_featdir(root: str, data: int) -> None:
    """The controller's featdir and its scp cut to a multiple of ``data``,
    with the ``data`` strided shards of it written (the parent does this
    before the ranks start)."""
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.data.sharding import shard_scp

    featdir, _, _ = synthetic.make_featdir(root, num_speakers=2, utts_per_speaker=_CTRL_UTTS // 2,
                                           feat_dim=FEAT_DIM, num_labels=NUM_PDFS, learnable=True)
    with open(os.path.join(featdir, "feats.scp")) as f:
        lines = f.readlines()
    trimmed = os.path.join(featdir, "feats.trimmed.scp")
    with open(trimmed, "w") as f:
        f.writelines(lines[: len(lines) - len(lines) % data])
    for i in range(data if data > 1 else 0):
        shard_scp(trimmed, num_shards=data, shard_index=i, drop_remainder=True)


def run_controller(root: str, device, mesh) -> dict:
    """Step 2 on a grid (``mesh``) or alone: growth + checkpoints, resume,
    rollback, emission. Returns the trajectory, the end state's parameters,
    the rollback's ``lr_fact`` and steps, and the likelihoods (the
    grid's first rank returns every rank's)."""
    import torch.distributed as dist

    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.parallel.mesh import full_state_dict

    tag = "grid" if mesh is not None else "single"
    base = os.path.join(root, tag)
    losses: list = []
    # growth + checkpoints
    state_a, _ = _controller(root, os.path.join(base, "a"), device, mesh, lr=1e-2, valid_adapt=False,
                             valid_retries=0, add_layer_period=2, losses=losses)
    if int(state_a.model.depth) < 1 or state_a.step < 4:
        raise AssertionError(f"{tag}: layerwise growth never fired (depth {int(state_a.model.depth)}, "
                             f"step {state_a.step})")
    # save -> restore -> resume from step 2 of run a, bit-equal at the end
    state_b, _ = _controller(root, os.path.join(base, "a"), device, mesh, lr=1e-2, valid_adapt=False,
                             valid_retries=0, add_layer_period=2, starting_step=2)
    full_a, full_b = full_state_dict(state_a.model, mesh), full_state_dict(state_b.model, mesh)
    for name, a in full_a.items():
        if not torch.equal(a, full_b[name]):
            raise AssertionError(f"{tag}: resume from step 2 is not bit-equal at {name}")
    # rollback under a divergent learning rate
    state_d, planned = _controller(root, os.path.join(base, "d"), device, mesh, lr=500.0, valid_adapt=True,
                                   valid_retries=1, add_layer_period=0, num_epochs=4)
    if not state_d.lr_fact < 1.0 or not state_d.step < planned:
        raise AssertionError(f"{tag}: the rollback never fired (lr_fact {state_d.lr_fact}, step {state_d.step} "
                             f"of {planned})")
    # emission of final.pt on every rank's shard of the utterances, with the whole model
    from tfkaldi_tpu_torch.data.sharding import shard_scp
    from tfkaldi_tpu_torch.models import DNNConfig, build_model

    featdir = os.path.join(root, "featdir")
    rank, world = (dist.get_rank(), dist.get_world_size()) if mesh is not None else (0, 1)
    model = build_model(DNNConfig(FEAT_DIM * (2 * CONTEXT + 1), NUM_PDFS, num_hidden_layers=3,
                                  num_hidden_units=18, batch_norm=True, layerwise_init=True))
    model.load_state_dict(load_checkpoint(os.path.join(base, "a")))
    prior = np.load(os.path.join(base, "a", "prior.npy"))
    scp = shard_scp(os.path.join(featdir, "feats.scp"), num_shards=world, shard_index=rank)
    reader = FeatureReader(scp, os.path.join(featdir, "cmvn.scp"), os.path.join(featdir, "utt2spk"), CONTEXT, 0)
    out_scp = os.path.join(base, f"likes.p{rank}.scp")
    with ArkWriter(out_scp, os.path.join(base, f"likes.p{rank}.ark")) as writer:
        Decoder(model.to(device), prior).decode_to_writer(reader, writer, batch_size=4, bucket_multiple=16)
    reader.close()
    if mesh is not None:
        mesh.barrier()
    likes = {}
    for p in range(world):
        with ArkReader(os.path.join(base, f"likes.p{p}.scp")) as r:
            likes.update({utt: m for utt, m in r})
    return {"losses": losses, "params": {k: v for k, v in full_a.items() if k != "depth"},
            "rollback": (state_d.lr_fact, state_d.step, planned), "likes": likes}


FLAGSHIP_STEPS = 3
# (input dim, hidden units, hidden layers, pdfs, batch, frames): the f32 flagship at bench.py's batch
FLAGSHIP_SHAPE = (440, 2048, 6, 2000, 128, 512)


def run_flagship(device, mesh) -> dict:
    """The flagship DNN's 3 steps and one validation pass, on the grid
    (``mesh``) or alone: the losses, the step times (s, host clock after a
    synchronise), kernels 1 and 3's launches by route in this process, the
    whole parameters."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.models import DNNConfig
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
    from tfkaldi_tpu_torch.parallel.mesh import full_state_dict, shard_batch
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    f, h, layers, pdfs, b, t = FLAGSHIP_SHAPE
    cfg = DNNConfig(f, pdfs, num_hidden_layers=layers, num_hidden_units=h, batch_norm=True)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=1e-3, num_steps=100), device=device, mesh=mesh)
    state = trainer.init_state(7)
    rng = np.random.default_rng(7)
    for counts in (fused_mlp.launches_by_route, bn_fused_bwd.launches_by_route):
        for route in counts:
            counts[route] = 0
    losses, times = [], []
    for _ in range(FLAGSHIP_STEPS):
        lengths = rng.integers(t * 3 // 5, t + 1, b).astype(np.int32)
        x = rng.standard_normal((b, t, f)).astype(np.float32)
        x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
        batch = shard_batch(PaddedBatch(x, rng.integers(0, pdfs, (b, t)).astype(np.int32), lengths, lengths), mesh,
                            device)
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        t0 = time.perf_counter()
        state, loss = trainer.update(state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    valid = trainer.evaluate(state, [batch])
    params = {k: v for k, v in full_state_dict(state.model, mesh).items() if k != "depth"}
    return {"losses": losses, "valid": valid, "step_s": times, "params": params,
            "fused_ffn": dict(fused_mlp.launches_by_route), "bn_dgrad": dict(bn_fused_bwd.launches_by_route)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, device: str, model_axis: int, root: str, flagship: bool) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from tfkaldi_tpu_torch.parallel import make_mesh, multihost

    dev, _ = multihost.initialize(device)
    try:
        mesh = make_mesh(model=model_axis)
        families = run_families(dev, mesh)
        controller = run_controller(root, dev, mesh)
        big = run_flagship(dev, mesh) if flagship else None
        if rank == 0:
            torch.save({"families": families, "controller": controller, "flagship": big},
                       os.path.join(root, "grid.pt"))
        multihost.barrier("done")
    finally:
        multihost.shutdown()


def _compare(grid: dict, single: dict) -> list[str]:
    lines = []
    for name, (loss, valid, params) in single["families"].items():
        g_loss, g_valid, g_params = grid["families"][name]
        for what, a, b in (("loss", g_loss, loss), ("valid loss", g_valid, valid)):
            if not (np.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b)):
                raise AssertionError(f"{name}: {what} {a!r} on the grid, {b!r} alone")
        err = max(float((g_params[k] - v).abs().max()) for k, v in params.items())
        if not err <= PARAM_ATOL:
            raise AssertionError(f"{name}: parameters differ by {err} (tol {PARAM_ATOL})")
        lines.append(f"{name} {g_loss:.4f}")
    gc, sc = grid["controller"], single["controller"]
    if len(gc["losses"]) != len(sc["losses"]) or not np.allclose(gc["losses"], sc["losses"], rtol=CTRL_RTOL,
                                                                   atol=0):
        raise AssertionError(f"controller trajectory: grid {gc['losses']} vs alone {sc['losses']}")
    err = max(float((gc["params"][k] - v).abs().max()) for k, v in sc["params"].items())
    if gc["rollback"] != sc["rollback"]:
        raise AssertionError(f"rollback (lr_fact, step, planned): grid {gc['rollback']} vs alone {sc['rollback']}")
    if sorted(gc["likes"]) != sorted(sc["likes"]):
        raise AssertionError("emission: the grid's utterances differ from one process's")
    like_err = max(float(np.abs(gc["likes"][u] - m).max()) for u, m in sc["likes"].items())
    if not like_err <= LIKE_ATOL or not all(np.isfinite(m).all() for m in gc["likes"].values()):
        raise AssertionError(f"emission: likelihoods differ by {like_err} (tol {LIKE_ATOL}) or are not finite")
    lines.append(f"controller: {len(gc['losses'])} steps, end params max|diff| {err:.3g}, rollback lr_fact "
                 f"{gc['rollback'][0]} at step {gc['rollback'][1]} of {gc['rollback'][2]}, "
                 f"{len(gc['likes'])} utterances emitted (max|diff| {like_err:.3g})")
    gf, sf = grid.get("flagship"), single.get("flagship")
    if sf is not None:
        rel = max(abs(a - b) / abs(b) for a, b in zip(gf["losses"] + [gf["valid"]], sf["losses"] + [sf["valid"]]))
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"flagship losses: grid {gf['losses']} {gf['valid']} vs alone {sf['losses']} "
                                 f"{sf['valid']}")
        if not (sum(gf["bn_dgrad"].values()) > 0 and sum(gf["fused_ffn"].values()) > 0):
            raise AssertionError(f"flagship: kernels 3 {gf['bn_dgrad']} and 1 {gf['fused_ffn']} must launch")
        err = max(float((gf["params"][k] - v).abs().max()) for k, v in sf["params"].items())
        lines.append(f"flagship f32 DNN: losses {gf['losses']} (max rel diff {rel:.3g}), params max|diff| "
                     f"{err:.3g}, step s grid {gf['step_s']} alone {sf['step_s']}, rank 0's kernel 3 "
                     f"{gf['bn_dgrad']} kernel 1 {gf['fused_ffn']}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--nproc", type=int, default=4, help="ranks to spawn (default 4)")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL, one card a rank) or cpu (gloo)")
    parser.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    parser.add_argument("--flagship", action="store_true",
                        help="also 3 steps of the full-width f32 DNN on the grid (for cards)")
    args = parser.parse_args(argv)
    import torch.multiprocessing as mp

    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.parallel import dryrun as this

    device = resolve_device(args.device if args.device == "cpu" else "cuda")
    if device.type == "cuda" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"--nproc {args.nproc} NCCL ranks need {args.nproc} cards, "
                           f"{torch.cuda.device_count()} visible")
    model_axis = 2 if args.nproc % 2 == 0 and args.nproc >= 4 else 1
    data = args.nproc // model_axis
    root = args.workdir or tempfile.mkdtemp(prefix="tk_dryrun_")
    t0 = time.perf_counter()
    try:
        make_controller_featdir(root, data)
        ctx = mp.start_processes(this._worker, args=(args.nproc, _free_port(), args.device, model_axis, root,
                                                     args.flagship),
                                 nprocs=args.nproc, join=False, start_method="spawn")
        torch.set_num_threads(1)
        # the same schedule alone, while the ranks run (the flagship after them, so that its steps are timed
        # on a card of their own)
        single = {"families": _single_families(data, device), "controller": run_controller(root, device, None)}
        while not ctx.join():
            pass
        single["flagship"] = run_flagship(device, None) if args.flagship else None
        grid = torch.load(os.path.join(root, "grid.pt"), weights_only=False)
        lines = _compare(grid, single)
    finally:
        if args.workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    print(f"dryrun OK: {data}x{model_axis} grid of {args.nproc} {args.device} ranks, against one process "
          f"({time.perf_counter() - t0:.1f} s): " + "; ".join(lines), flush=True)
    return 0


def _single_families(data: int, device) -> dict:
    """Step 1 alone on the grid's global batches."""
    from tfkaldi_tpu_torch.train.trainer import Trainer

    families, b = _families(data)
    batches = _global_batches(b)
    out = {}
    for i, (name, cfg, tcfg, kind) in enumerate(families):
        trainer = Trainer(cfg, tcfg, device=device)
        state = trainer.init_state(100 + i)
        batch = batches[kind].to(device)
        state, loss = trainer.update(state, batch)
        valid = trainer.evaluate(state, [batch])
        out[name] = (float(loss), float(valid), {k: v.detach().cpu() for k, v in state.model.named_parameters()})
    return out


if __name__ == "__main__":
    sys.exit(main())
