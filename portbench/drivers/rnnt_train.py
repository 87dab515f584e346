"""The transducer training driver: the recipe's training controller with
``loss = rnnt`` over the seeded corpus and its word-piece transcripts,
measured from the end of its first steps for ``seconds``.

Set-up builds the trainer and the controller as ``Nnet.train`` builds them
from the ``[nnet]`` section (first, so that a program that cannot build the
model stops at once), writes the corpus and its token transcripts (one id a
run of the corpus's alignment, :func:`write_tokens`), loads the seeded
weights, and starts ``TrainingController.train`` on the bulk text loader
with ``AlignmentCoder``'s id alphabet. The first ``warmup_steps`` steps run
through the window's own loop, loader and update; the first
``check_steps`` of them give the program's side of the check, as in
:mod:`portbench.drivers.train` (Adam's first step moves each element by
about ``lr`` in the sign of its gradient, so only the later steps show the
moments). Then the window opens, and the hook ends the loop at the first
step boundary after the deadline. A traced run first traces
``trace_steps`` more steps, after one step that warms the profiler, and
opens the window when the trace is read (a step launches tens of
thousands of operations: a whole window's trace would take gigabytes to
write and read), so that the window is the untraced run's; besides the
trace it keeps each device operation's region (:mod:`portbench.regions`)
and adds their seconds to the line's ``window``.

After the window the state is freed and the plain reference
(:mod:`portbench.reference.conformer_rnnt`, in the configuration's
precision with its roundings mirrored) follows the same first steps from
the same weights, with the dropout masks of the trainer's own stream, on
batches it reads again from the corpus files and pads as the loader does.

Faults for the check of the check (``fault``): ``unchanged``,
``half_batch`` (as the DNN driver's), ``no_relpos`` (the attention's
``(q+v)·W_R R`` term left out), ``narrow_band`` (the pruned lattice at
``s = 4`` in place of the dense one) and ``no_momentum`` (Adam's first
moment not carried from one step to the next). The control is the
reference in ``fp8`` (:mod:`portbench.reference.conformer_rnnt`).
``portbench.calibrate`` maps a compute dtype to its control and lists
float32's alone, so this cell's readings are taken by

    python3 -m portbench.drivers.rnnt_train <portbench.calibrate's arguments>

which runs it with ``bfloat16 → fp8`` added to that map for the call.
"""

from __future__ import annotations

import configparser
import contextlib
import gc
import math
import os
import sys
import time
import types

import numpy as np
import torch

from portbench import calibrate, check, corpus as corpus_mod, weights as weights_mod
from portbench.drivers.train import StopWindow, _patched, _reference_precision
from portbench.record import Record
from portbench.reference import conformer_rnnt as ref, data as ref_data
from portbench.regions import RegionProfile
from portbench.trace import mark_window

FAULTS = ("unchanged", "half_batch", "no_relpos", "narrow_band", "no_momentum")
CONTROL = "fp8"


def ref_config(config: dict) -> ref.Config:
    n = config["nnet"]
    return ref.Config(feat_dim=int(config["feat_dim"]), num_labels=int(config["num_labels"]),
                      keep=float(n.get("dropout", 1)),
                      **{k: int(n[k]) for k in ("num_blocks", "d_model", "num_heads", "ffn_dim", "conv_kernel",
                                               "pred_units", "embed_dim", "joint_units")})


def make_weights(config: dict, seed: int, dev) -> dict[str, torch.Tensor]:
    """:func:`portbench.weights.make_weights` over the reference's shapes,
    then the gains of the norms (``*.g``, ``bn_gamma``) moved to ``1 +``
    their draw and the convolution kernels drawn ``N(0, 1)/sqrt(fan_in)``."""
    w = weights_mod.make_weights(ref.param_shapes(ref_config(config)), seed, dev)
    for name, t in w.items():
        if name.endswith((".g", ".bn_gamma")):
            w[name] = t + 1.0
        elif t.dim() > 2:
            w[name] = t * (10.0 / math.sqrt(t[0].numel()))
    return w


def write_tokens(corpus, path: str) -> dict[str, np.ndarray]:
    """One word-piece id a run of equal labels of each utterance's
    alignment, as a Kaldi ``text`` file of ids; returns the ids."""
    tokens = {}
    with open(path, "w") as f:
        for utt, ali in corpus.alignments.items():
            tokens[utt] = ali[np.flatnonzero(np.r_[True, ali[1:] != ali[:-1]])]
            f.write(f"{utt} {' '.join(str(int(a)) for a in tokens[utt])}\n")
    return tokens


def make_corpus(workdir: str, seed: int, config: dict, traffic: dict):
    c = corpus_mod.make_corpus(
        os.path.join(workdir, "corpus"), seed, num_utts=config["train_utterances"], speakers=traffic["speakers"],
        feat_dim=config["feat_dim"], targets="pdf", mean_s=traffic["mean_s"], sigma=traffic["sigma"],
        min_s=traffic["min_s"], max_s=traffic["max_s"], frame_rate=traffic["frame_rate"],
        num_pdfs=config["num_labels"], pdf_frames=tuple(traffic["token_frames"]))
    text = os.path.join(c.dirpath, "text")
    write_tokens(c, text)
    return c, text


def _nnet(config: dict, savedir_root: str, dev, fault: str | None):
    from tfkaldi_tpu_torch.nnet import Nnet

    conf = configparser.ConfigParser()
    conf["directories"] = {"expdir": savedir_root}
    conf["nnet"] = dict(config["nnet"], **({"rnnt_prune_s": "4"} if fault == "narrow_band" else {}))
    return Nnet(conf, input_dim=config["feat_dim"], num_labels=config["num_labels"], device=dev)


def _build(nnet, config: dict, corpus, text: str, dev, traffic: dict):
    """The dispenser, trainer, batcher and options, as ``cli.main``'s
    ``train_nnet`` and ``Nnet.train`` build them."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.bulk_loader import BulkTextBatchSource
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig

    c = nnet.conf
    bucket = int(traffic["bucket_multiple"])
    dispenser = BulkTextBatchSource(corpus.feats_scp, corpus.cmvn_scp, corpus.utt2spk_path, nnet.context_width,
                                    AlignmentCoder(identity_normalizer, config["num_labels"]), text,
                                    int(c["batch_size"]), bucket_multiple=bucket, max_input_length=corpus.max_length)
    opts = NnetTrainOptions.from_config(c, nnet.savedir)
    trainer_cfg = TrainerConfig(
        init_learning_rate=float(c.get("initial_learning_rate", 1e-3)),
        learning_rate_decay=float(c.get("learning_rate_decay", 1)),
        num_steps=int(dispenser.num_batches * opts.num_epochs),
        loss_type=nnet.loss_type,
        micro_batches=nnet._micro_batches(opts.batch_size),
        ctc_blank_id=nnet.blank_id,
    )
    trainer = Trainer(nnet.model.config, trainer_cfg, device=dev)
    return dispenser, DeviceBatcher(bucket_multiple=bucket), opts, trainer


def program_run(config: dict, traffic: dict, seed: int, seconds: float, dev, workdir: str, fault: str | None,
                trace: bool) -> dict:
    """Set up, run the window and read the program's side of the check."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.models import transformer
    from tfkaldi_tpu_torch.train import TrainingController, controller as ctl
    from tfkaldi_tpu_torch.train.trainer import TrainState

    nnet = _nnet(config, os.path.join(workdir, "exp"), dev, fault)
    corpus, text = make_corpus(workdir, seed, config, traffic)
    check_steps, warmup_steps = int(traffic["check_steps"]), int(traffic["warmup_steps"])
    trace_steps = int(traffic["trace_steps"])
    # a traced run: the profiler starts after the warm-up, warms on one step,
    # then traces trace_steps steps ahead of the window
    mark_at = warmup_steps + 1
    open_at = mark_at + trace_steps if trace else warmup_steps
    cuda = dev.type == "cuda"
    dispenser, batcher, opts, trainer = _build(nnet, config, corpus, text, dev, traffic)
    model = nnet.model.to(dev)
    weights_mod.load_into(model, make_weights(config, seed, dev))
    params = dict(model.named_parameters())
    state = TrainState(step=0, lr_fact=1.0, model=model, adam_m={n: torch.zeros_like(p) for n, p in params.items()},
                       adam_v={n: torch.zeros_like(p) for n, p in params.items()}, adam_t=0, seed=int(seed))
    p0 = {n: p.detach().clone() for n, p in params.items()}

    out = {"steps": [], "waits": [], "losses": [], "first_grad": None, "change": None, "failed": 0,
           "setup_failed": 0, "frames": 0, "validations": [], "rollbacks": 0, "recipe_stop": False,
           "corpus": corpus, "text": text}
    live = {"state": state, "open": None, "calls": 0, "profile": None}

    def update(st, batch):
        if fault == "half_batch":
            half = batch.inputs.shape[0] // 2
            batch = PaddedBatch(*(a[:half] for a in batch.fields()))
        if fault == "unchanged":
            _, loss, frames = trainer.gradients(st, batch, trainer.dropout_generator(st))
            live["state"] = st
            return st, loss / torch.clamp(frames, min=1.0)
        if fault == "no_momentum":
            for m in st.adam_m.values():
                m.zero_()
        st, loss = orig_update(st, batch)
        live["state"] = st
        return st, loss

    def hook(step, loss, step_time, num_frames, padded_length):
        now = time.perf_counter()
        live["calls"] += 1
        n = live["calls"]
        finite = math.isfinite(loss)
        if live["open"] is None:
            st = live["state"]
            out["setup_failed"] += 0 if finite else 1
            if n <= check_steps:
                out["losses"].append(float(loss))
            if n == 1:
                out["first_grad"] = {k: float(torch.linalg.vector_norm(m)) / (1 - ref.B1)
                                     for k, m in st.adam_m.items()}
            if n == check_steps:
                out["change"] = {k: float(torch.linalg.vector_norm(p.detach() - p0[k]))
                                 for k, p in st.model.named_parameters()}
                p0.clear()
            if trace and n == warmup_steps:
                live["profile"] = RegionProfile(os.path.join(workdir, "profile"), dev.type)
                live["profile"].start()
            if trace and n == mark_at:
                mark_window()
            if n == open_at:
                if cuda:
                    torch.cuda.synchronize(dev)
                if live["profile"] is not None:
                    out["trace"] = live["profile"].stop()
                out["t_open_wall"] = time.time()
                live["open"] = time.perf_counter()
                if seconds <= 0:
                    raise StopWindow
            return
        out["steps"].append({"frames": int(num_frames), "t_pad": int(padded_length), "batch": out["batch"],
                             "lengths": out["lengths"]})
        out["frames"] += int(num_frames)
        out["failed"] += 0 if finite else 1
        if now >= live["open"] + seconds:
            raise StopWindow

    def on_validation(step, loss):
        out["validations"].append((int(step), float(loss)))

    def evaluate(*a, **kw):
        loss = orig_evaluate(*a, **kw)
        if live["calls"] == 0:  # the baseline, ahead of the loop
            on_validation(0, loss)
        return loss

    def halve(st):
        out["rollbacks"] += 1
        live["state"] = orig_halve(st)
        return live["state"]

    class TimedSource(ctl.PrefetchingBatchSource):
        def next(self):
            t = time.perf_counter()
            b = super().next()
            if live["open"] is not None:
                out["waits"].append(time.perf_counter() - t)
            out["batch"] = int(b.inputs.shape[0])
            out["lengths"] = (b.input_lengths, b.target_lengths)  # read on the host after the window
            return b

    orig_update, orig_halve, orig_evaluate = trainer.update, trainer.halve_learning_rate, trainer.evaluate
    trainer.update, trainer.halve_learning_rate, trainer.evaluate = update, halve, evaluate
    controller = TrainingController(trainer, dispenser, batcher, opts, metrics_hook=hook,
                                    validation_hook=on_validation)
    loop = controller._train_loop

    def train_loop(*a, **kw):
        """The recipe's loop; its own stop ends the window there."""
        loop(*a, **kw)
        out["recipe_stop"] = True
        raise StopWindow

    controller._train_loop = train_loop
    shift = transformer.rel_shift
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with _patched(ctl, "PrefetchingBatchSource", TimedSource), \
            (_patched(transformer, "rel_shift", lambda x: shift(x) * 0.0) if fault == "no_relpos"
             else contextlib.nullcontext()):
        try:
            controller.train(state)
        except StopWindow:
            pass
    if cuda:
        torch.cuda.synchronize(dev)
    out["window_s"] = time.perf_counter() - live["open"] if live["open"] is not None else 0.0
    for st in out["steps"]:
        frames, labels = st.pop("lengths")
        st["utterances"] = [(int(t), int(u)) for t, u in zip(frames.cpu(), labels.cpu())]
    out["lr_fact"] = float(live["state"].lr_fact)
    if "trace" in out:
        trace_ = out["trace"]
        out["trace_extent"] = trace_.extent("train_step")
        out["busy_s"] = trace_.busy_us(*out["trace_extent"]) * 1e-6 if out["trace_extent"] else None
        if out["trace_extent"]:
            by_region = live["profile"].regions.device_s(*out["trace_extent"])
            out["device_s"] = {str(k): v for k, v in by_region.items()}
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del controller, trainer, state, model, params, live, nnet, dispenser
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------

def read_tokens(path: str) -> dict[str, np.ndarray]:
    with open(path) as f:
        return {u: np.asarray(ids, dtype=np.int64) for u, *ids in (line.split() for line in f if line.strip())}


def reference_batches(config: dict, traffic: dict, corpus_dir: str, text: str, steps: int, dev) -> list[dict]:
    """The first ``steps`` training batches, read again from the corpus
    files, padded to multiples of ``bucket_multiple`` (frames and labels)."""
    nnet = config["nnet"]
    feats = ref_data.Features(corpus_dir, 0)
    tokens = read_tokens(text)
    bucket = int(traffic["bucket_multiple"])
    out = []
    for utts in ref_data.train_batches(feats.order, int(nnet["batch_size"]), int(nnet["valid_batches"]), steps):
        xs, ys = [feats(u) for u in utts], [tokens[u] for u in utts]
        t_pad = -(-max(len(x) for x in xs) // bucket) * bucket
        u_pad = -(-max(len(y) for y in ys) // bucket) * bucket
        x = np.zeros((len(xs), t_pad, xs[0].shape[1]), np.float32)
        y = np.zeros((len(ys), u_pad), np.int64)
        for i, (a, b) in enumerate(zip(xs, ys)):
            x[i, :len(a)], y[i, :len(b)] = a, b
        out.append({"x": torch.as_tensor(x, device=dev), "labels": torch.as_tensor(y, device=dev),
                    "lengths": torch.as_tensor([len(a) for a in xs], device=dev),
                    "label_lengths": torch.as_tensor([len(b) for b in ys], device=dev)})
    return out


def dropout_masks(config: dict, seed: int, dev):
    """``masks(step)`` for the reference: the trainer's own dropout stream
    for ``(seed, step)`` (``Trainer.dropout_generator``), drawn as the
    program draws its keep masks; None without dropout."""
    from tfkaldi_tpu_torch.models import TransducerConfig
    from tfkaldi_tpu_torch.train import Trainer, TrainerConfig

    keep = float(config["nnet"].get("dropout", 1))
    if keep >= 1:
        return None
    model_cfg = TransducerConfig.from_config(config["nnet"], int(config["feat_dim"]), int(config["num_labels"]))
    trainer = Trainer(model_cfg, TrainerConfig(loss_type="rnnt"), device=dev)

    def masks(step):
        gen = trainer.dropout_generator(types.SimpleNamespace(seed=int(seed), step=step))
        return lambda shape: torch.rand(shape, generator=gen, device=dev) < keep
    return masks


def reference_mode(config: dict) -> str:
    return "bf16" if config["nnet"].get("compute_dtype", "float32") == "bfloat16" else "f32"


def reference_steps(config: dict, traffic: dict, corpus_dir: str, text: str, seed: int, dev, mode: str) -> dict:
    steps = int(traffic["check_steps"])
    with _reference_precision():
        return ref.steps(make_weights(config, seed, dev),
                         reference_batches(config, traffic, corpus_dir, text, steps, dev), ref_config(config),
                         lr=float(config["nnet"]["initial_learning_rate"]), mode=mode,
                         masks=dropout_masks(config, seed, dev))


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

def run(cell: dict, seed: int, seconds: float, trace: bool, device: str, t0_wall: float, workdir: str,
        fault: str | None = None, limits: dict | None = None) -> Record:
    config, traffic = cell["config_data"], cell["traffic_data"]
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: want one of {FAULTS}")
    dev = torch.device(device if device != "cuda" else "cuda:0")
    got = program_run(config, traffic, seed, seconds, dev, workdir, fault, trace)
    rec = Record(cell=cell["name"], config=config, traffic=traffic, chips=1)
    rec.setup_s = got["t_open_wall"] - t0_wall
    rec.window_s = got["window_s"]
    rec.frames = got["frames"]
    rec.steps = got["steps"]
    rec.data_waits_s = got["waits"]
    rec.attempted, rec.failed = len(got["steps"]), got["failed"]
    rec.memory_peak_bytes = got["memory_peak_bytes"]
    rec.window = {"validations": got["validations"], "rollbacks": got["rollbacks"], "lr_fact": got["lr_fact"],
                  "recipe_stop": got["recipe_stop"]}
    if trace:
        rec.trace, rec.trace_extent, rec.busy_s = got["trace"], got["trace_extent"], got["busy_s"]
        if "device_s" in got:
            rec.window["device_s"] = got["device_s"]
    if limits is not None:
        ref_out = reference_steps(config, traffic, got["corpus"].dirpath, got["text"], seed, dev,
                                  reference_mode(config))
        rec.numbers = check.train_numbers(got, ref_out)
        ok, rec.compared = check.judge(rec.numbers, limits)
        rec.correct = ok and rec.failed == 0 and got["setup_failed"] == 0
    rec.program = {k: got[k] for k in ("losses", "first_grad", "change")}
    return rec


def control_numbers(cell: dict, seed: int, device: str, workdir: str, mode: str) -> dict[str, float]:
    """The control: the reference in ``mode`` (``fp8``) put in the
    program's place, held to the reference in the configuration's
    precision."""
    config, traffic = cell["config_data"], cell["traffic_data"]
    corpus, text = make_corpus(workdir, seed, config, traffic)
    dev = torch.device(device if device != "cuda" else "cuda:0")
    want = reference_steps(config, traffic, corpus.dirpath, text, seed, dev, reference_mode(config))
    low = reference_steps(config, traffic, corpus.dirpath, text, seed, dev, mode)
    return check.train_numbers(low, want)


def calibrate_main(argv=None) -> int:
    """``portbench.calibrate`` with this cell's control for bfloat16."""
    with _patched(calibrate, "CONTROL", {**calibrate.CONTROL, "bfloat16": CONTROL}):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(calibrate_main())
