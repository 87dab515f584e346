"""The training driver: the recipe's training controller over the seeded
corpus, measured from the end of its first steps for ``seconds``.

Set-up writes the corpus, builds the trainer and the controller as
``Nnet.train`` builds them from the ``[nnet]`` section, loads the seeded
weights, and starts ``TrainingController.train``. Its first
``check_steps`` steps run through the window's own loop, loader and
update; the benchmark's metrics hook reads the program's readings from
them (each step's loss, the first clipped gradient from Adam's first
moment, each leaf's change after the last), then opens the window. The
hook ends the loop at the first step boundary after the deadline; the
validations, rollbacks and checkpoints that fall inside count, since
users pay for them per epoch. The recipe's own stop (``valid_adapt``
giving up after ``valid_retries`` rollbacks) closes the window early, and
the run says so. Every validation's step and loss (the baseline's at
step 0), the rollbacks and the learning rate's factor are kept for the
line.

After the window the state is freed and the plain reference follows the
same first steps from the same weights on batches it reads again from the
corpus files (:mod:`portbench.reference`).

Faults for the check of the check (``fault``): ``unchanged`` (a step that
returns its state as it was) and ``half_batch`` (the second half of every
batch left out, the mean over the rest).
"""

from __future__ import annotations

import configparser
import contextlib
import gc
import math
import os
import time

import numpy as np
import torch

from portbench import check, corpus as corpus_mod, weights as weights_mod
from portbench.record import Record
from portbench.reference import data as ref_data, models as ref_models, train as ref_train
from portbench.trace import Profile, mark_window

FAULTS = ("unchanged", "half_batch")


class StopWindow(Exception):
    """The window's deadline passed: the metrics hook ends the loop here."""


def model_shapes(config: dict) -> dict[str, tuple]:
    nnet = config["nnet"]
    inputs = config["feat_dim"] * (2 * int(nnet["context_width"]) + 1)
    return ref_models.dnn_shapes(inputs, int(nnet["num_hidden_layers"]), int(nnet["num_hidden_units"]),
                                 config["num_labels"])


def make_corpus(workdir: str, seed: int, config: dict, traffic: dict) -> corpus_mod.Corpus:
    return corpus_mod.make_corpus(
        os.path.join(workdir, "corpus"), seed, num_utts=config["train_utterances"], speakers=traffic["speakers"],
        feat_dim=config["feat_dim"], targets="pdf", mean_s=traffic["mean_s"], sigma=traffic["sigma"],
        min_s=traffic["min_s"], max_s=traffic["max_s"], frame_rate=traffic["frame_rate"],
        num_pdfs=config["num_labels"], pdf_frames=tuple(traffic["pdf_frames"]))


def _build(config: dict, corpus, savedir_root: str, dev, traffic: dict):
    """The dispenser, trainer, batcher and options, as ``cli.main``'s
    ``train_nnet`` and ``Nnet.train`` build them."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.bulk_loader import BulkAlignmentBatchSource
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig

    conf = configparser.ConfigParser()
    conf["directories"] = {"expdir": savedir_root}
    conf["nnet"] = config["nnet"]
    nnet = Nnet(conf, input_dim=config["feat_dim"], num_labels=config["num_labels"], device=dev)
    c = nnet.conf
    bucket = int(traffic["bucket_multiple"])
    dispenser = BulkAlignmentBatchSource(corpus.feats_scp, corpus.cmvn_scp, corpus.utt2spk_path, nnet.context_width,
                                         corpus.alignments, int(c["batch_size"]), bucket_multiple=bucket,
                                         num_labels=config["num_labels"], max_input_length=corpus.max_length)
    opts = NnetTrainOptions.from_config(c, nnet.savedir)
    trainer_cfg = TrainerConfig(
        init_learning_rate=float(c.get("initial_learning_rate", 1e-3)),
        learning_rate_decay=float(c.get("learning_rate_decay", 1)),
        num_steps=int(dispenser.num_batches * opts.num_epochs),
        loss_type=nnet.loss_type,
        micro_batches=nnet._micro_batches(opts.batch_size),
        spec_augment=str(c.get("specaugment", "False")) == "True",
        spec_raw_dim=nnet.raw_input_dim,
    )
    trainer = Trainer(nnet.model.config, trainer_cfg, device=dev)
    return nnet, dispenser, DeviceBatcher(bucket_multiple=bucket), opts, trainer


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def program_run(config: dict, traffic: dict, corpus, seed: int, seconds: float, dev, workdir: str,
                fault: str | None, trace: bool) -> dict:
    """Set up, run the window and read the program's side of the check."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.train import TrainingController, checkpoint as ckpt, controller as ctl
    from tfkaldi_tpu_torch.train.trainer import TrainState

    check_steps = int(traffic["check_steps"])
    cuda = dev.type == "cuda"
    nnet, dispenser, batcher, opts, trainer = _build(config, corpus, os.path.join(workdir, "exp"), dev, traffic)
    model = nnet.model.to(dev)
    weights_mod.load_into(model, weights_mod.make_weights(model_shapes(config), seed, dev))
    params = dict(model.named_parameters())
    state = TrainState(step=0, lr_fact=1.0, model=model, adam_m={n: torch.zeros_like(p) for n, p in params.items()},
                       adam_v={n: torch.zeros_like(p) for n, p in params.items()}, adam_t=0, seed=int(seed))
    p0 = {n: p.detach().clone() for n, p in params.items()}

    out = {"steps": [], "waits": [], "losses": [], "first_grad": None, "change": None, "failed": 0,
           "setup_failed": 0, "frames": 0, "validations": [], "rollbacks": 0, "recipe_stop": False}
    live = {"state": state, "open": None, "calls": 0, "profile": None}

    def update(st, batch):
        if fault == "half_batch":
            half = batch.inputs.shape[0] // 2
            batch = PaddedBatch(*(a[:half] for a in batch.fields()))
        if fault == "unchanged":
            _, loss, frames = trainer.gradients(st, batch, trainer.dropout_generator(st))
            live["state"] = st
            return st, loss / torch.clamp(frames, min=1.0)
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
            out["losses"].append(float(loss))
            out["setup_failed"] += 0 if finite else 1
            if n == 1:
                out["first_grad"] = {k: float(torch.linalg.vector_norm(m)) / (1 - ref_train.B1)
                                     for k, m in st.adam_m.items()}
            if n == check_steps - 1 and trace:
                live["profile"] = Profile(os.path.join(workdir, "profile"), dev.type)
                live["profile"].start()
            if n == check_steps:
                out["change"] = {k: float(torch.linalg.vector_norm(p.detach() - p0[k]))
                                 for k, p in st.model.named_parameters()}
                p0.clear()
                if cuda:
                    torch.cuda.synchronize(dev)
                if live["profile"] is not None:
                    mark_window()
                out["t_open_wall"] = time.time()
                live["open"] = time.perf_counter()
                if seconds <= 0:
                    raise StopWindow
            return
        out["steps"].append({"frames": int(num_frames), "t_pad": int(padded_length), "batch": out["batch"]})
        out["frames"] += int(num_frames)
        out["failed"] += 0 if finite else 1
        if now >= live["open"] + seconds:
            raise StopWindow

    def on_validation(step, loss):
        out["validations"].append((int(step), float(loss)))

    def evaluate(*a, **kw):
        with torch.profiler.record_function("portbench.validation"):
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
            with torch.profiler.record_function("portbench.data_wait"):
                b = super().next()
            if live["open"] is not None:
                out["waits"].append(time.perf_counter() - t)
            out["batch"] = int(b.inputs.shape[0])
            return b

    def spanned(name, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapped

    orig_update, orig_halve, orig_evaluate = trainer.update, trainer.halve_learning_rate, trainer.evaluate
    trainer.update, trainer.halve_learning_rate, trainer.evaluate = update, halve, evaluate
    controller = TrainingController(trainer, dispenser, batcher, opts, metrics_hook=hook,
                                    validation_hook=on_validation)
    loop = controller._train_loop

    def train_loop(*a, **kw):
        """The recipe's loop; its own stop (``valid_adapt`` giving up) ends
        the window there, ahead of the final save and the prior."""
        loop(*a, **kw)
        out["recipe_stop"] = True
        raise StopWindow

    controller._train_loop = train_loop
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with _patched(ctl, "PrefetchingBatchSource", TimedSource), \
            _patched(ckpt, "save_state", spanned("portbench.checkpoint", ckpt.save_state)), \
            _patched(ckpt, "save_validated", spanned("portbench.checkpoint", ckpt.save_validated)):
        try:
            controller.train(state)
        except StopWindow:
            pass
    if cuda:
        torch.cuda.synchronize(dev)
    out["window_s"] = time.perf_counter() - live["open"] if live["open"] is not None else 0.0
    out["lr_fact"] = float(live["state"].lr_fact)
    if live["profile"] is not None:
        trace_ = live["profile"].stop()
        out["trace"], out["trace_extent"] = trace_, trace_.extent("train_step")
        out["busy_s"] = trace_.busy_us(*out["trace_extent"]) * 1e-6 if out["trace_extent"] else None
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del controller, trainer, state, model, params, live, nnet, dispenser
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------

def reference_batches(config: dict, corpus, steps: int, dev) -> list[dict]:
    nnet = config["nnet"]
    feats = ref_data.Features(corpus.dirpath, int(nnet["context_width"]))
    out = []
    for batch in ref_data.train_batches(feats.order, int(nnet["batch_size"]), int(nnet["valid_batches"]), steps):
        out.append({"x": torch.as_tensor(np.concatenate([feats(u) for u in batch]), dtype=torch.float32, device=dev),
                    "y": torch.as_tensor(np.concatenate([corpus.alignments[u] for u in batch]),
                                         dtype=torch.int64, device=dev)})
    return out


def reference_steps(config: dict, corpus, seed: int, steps: int, dev, mode: str = "f32") -> dict:
    nnet = config["nnet"]
    w = weights_mod.make_weights(model_shapes(config), seed, dev)
    return ref_train.steps(w, reference_batches(config, corpus, steps, dev), int(nnet["num_hidden_layers"]),
                           float(config["assumed"].get("bn_eps", 1e-3)),
                           lr=float(nnet["initial_learning_rate"]), mode=mode)


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

def run(cell: dict, seed: int, seconds: float, trace: bool, device: str, t0_wall: float, workdir: str,
        fault: str | None = None, limits: dict | None = None) -> Record:
    config, traffic = cell["config_data"], cell["traffic_data"]
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: want one of {FAULTS}")
    corpus = make_corpus(workdir, seed, config, traffic)
    dev = torch.device(device if device != "cuda" else "cuda:0")
    got = program_run(config, traffic, corpus, seed, seconds, dev, workdir, fault, trace)
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
    if limits is not None:
        with _reference_precision():
            ref = reference_steps(config, corpus, seed, int(traffic["check_steps"]), dev)
        rec.numbers = check.train_numbers(got, ref)
        ok, rec.compared = check.judge(rec.numbers, limits)
        rec.correct = ok and rec.failed == 0 and got["setup_failed"] == 0
    rec.program = {k: got[k] for k in ("losses", "first_grad", "change")}
    return rec


def control_numbers(cell: dict, seed: int, device: str, workdir: str, mode: str) -> dict[str, float]:
    """The control: the reference in ``mode`` put in the program's place,
    held to the reference in float32."""
    config, traffic = cell["config_data"], cell["traffic_data"]
    corpus = make_corpus(workdir, seed, config, traffic)
    dev = torch.device(device if device != "cuda" else "cuda:0")
    steps = int(traffic["check_steps"])
    with _reference_precision():
        ref = reference_steps(config, corpus, seed, steps, dev)
        low = reference_steps(config, corpus, seed, steps, dev, mode=mode)
    return check.train_numbers(low, ref)


@contextlib.contextmanager
def _reference_precision():
    """TF32 off for the reference's float32 products."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
