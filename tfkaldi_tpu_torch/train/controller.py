"""Training controller: the reference ``Nnet.train`` state machine
(neuralNetworks/nnet.py:80-244).

Port of :mod:`tfkaldi_tpu.train.controller` for one device:

- carve off the validation set (the first ``valid_batches`` batches, then
  ``dispenser.split()``; nnet.py:88-96);
- resume from ``starting_step`` rounded down to ``check_freq``, with the
  dispenser fast-forwarded (nnet.py:101-108), and the persisted
  'validated' rollback point restored when its sidecar agrees with its
  state;
- the loop: batch → train step → periodic validation; on a regression
  (with ``valid_adapt``) rewind the consumed and prefetched batches,
  restore the last validated state, halve the learning rate, compound the
  halving into the rollback point and persist it, and give up after
  ``valid_retries`` retries (nnet.py:167-207);
- layerwise growth every ``add_layer_period`` steps (nnet.py:209-229);
- ``training/step{N}.pt`` every ``check_freq`` steps, ``final.pt`` at
  the end (optionally the mean of the last ``average_last`` checkpoints);
- the state prior = normalized target bincount → ``prior.npy``
  (nnet.py:240-244);
- with ``profile_steps > 0``, a torch.profiler trace of the steps
  ``[profile_start, profile_start + profile_steps)`` into
  ``<savedir>/profile`` (:class:`ProfileWindow`; controller.py:288-298),
  taken once and stopped on every way out of the window: its end, a
  validation rollback, termination or an exception.

On a grid of ranks (a :class:`~tfkaldi_tpu_torch.train.trainer.Trainer`
with a ``mesh``; tfkaldi_tpu/train/controller.py with a mesh) each rank
carves its validation batches from its own shard and rewinds and
fast-forwards its own loader; the validation loss is the global one
(:meth:`Trainer.evaluate`), so every rank takes the same rollback decision;
checkpoints and ``final.pt`` are gathered and written by the grid's first
rank (:mod:`tfkaldi_tpu_torch.train.checkpoint`); the prior's counts are
summed over the data group in int64 and the first rank writes
``prior.npy``, then a barrier (tfkaldi_tpu/train/controller.py:216-232);
the profile trace is the first rank's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from tfkaldi_tpu_torch.convert import save_checkpoint
from tfkaldi_tpu_torch.data.batching import DeviceBatcher, PaddedBatch
from tfkaldi_tpu_torch.data.dispenser import BatchDispenser
from tfkaldi_tpu_torch.data.prefetch import PrefetchingBatchSource
from tfkaldi_tpu_torch.parallel.mesh import shard_state
from tfkaldi_tpu_torch.train import checkpoint as ckpt
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainState
from tfkaldi_tpu_torch.utils.profiling import Trace

log = logging.getLogger(__name__)


class ProfileWindow:
    """The ``profile_steps`` trace (SURVEY §5: the reference has no
    tracing): :meth:`at_step` starts it when the loop reaches
    ``profile_start`` and ends it ``profile_steps`` steps later; :meth:`stop`
    ends it early (a rollback: the steps replayed after a rewind are not
    the window's) and after the loop. One window a run."""

    def __init__(self, options: "NnetTrainOptions"):
        self.start, self.steps = options.profile_start, options.profile_steps
        self.logdir = os.path.join(options.savedir, "profile")
        self._trace: Trace | None = None
        self._done = self.steps <= 0

    def at_step(self, step: int) -> None:
        if self._trace is None and not self._done and step == self.start:
            self._trace = Trace(self.logdir)
        elif self._trace is not None and step >= self.start + self.steps:
            self.stop()

    def stop(self) -> None:
        if self._trace is not None:
            log.info("profile trace written to %s", self._trace.stop())
            self._trace, self._done = None, True


@dataclasses.dataclass(frozen=True)
class NnetTrainOptions:
    """The ``[nnet]`` training-control knobs (config_AURORA4.cfg:74-100)."""

    savedir: str
    num_epochs: int = 10
    batch_size: int = 128
    valid_batches: int = 2
    valid_frequency: int = 10
    valid_adapt: bool = True
    valid_retries: int = 3
    check_freq: int = 10
    add_layer_period: int = 0
    num_hidden_layers: int = 6
    starting_step: int = 0
    seed: int = 0
    # capture a torch.profiler trace of steps [profile_start,
    # profile_start + profile_steps) into <savedir>/profile when > 0
    profile_steps: int = 0
    profile_start: int = 2
    # write final.pt as the parameter mean of the end state and the last
    # N-1 saved training/step*.pt checkpoints (0/1 = off); optimizer state
    # and batchnorm stats stay those of the end state
    average_last: int = 0

    @classmethod
    def from_config(cls, conf: dict, savedir: str) -> "NnetTrainOptions":
        return cls(
            savedir=savedir,
            num_epochs=int(conf.get("num_epochs", 10)),
            batch_size=int(conf.get("batch_size", 128)),
            valid_batches=int(conf.get("valid_batches", 2)),
            valid_frequency=int(conf.get("valid_frequency", 10)),
            valid_adapt=str(conf.get("valid_adapt", "True")) == "True",
            valid_retries=int(conf.get("valid_retries", 3)),
            check_freq=int(conf.get("check_freq", 10)),
            add_layer_period=int(conf.get("add_layer_period", 0)),
            num_hidden_layers=int(conf.get("num_hidden_layers", 6)),
            starting_step=0
            if conf.get("starting_step", "0") == "final"
            else int(conf.get("starting_step", 0)),
            seed=int(conf.get("seed", 0)),
            average_last=int(conf.get("average_last", 0)),
            profile_steps=int(conf.get("profile_steps", 0)),
        )


class TrainingController:
    def __init__(
        self,
        trainer: Trainer,
        dispenser: BatchDispenser,
        batcher: DeviceBatcher,
        options: NnetTrainOptions,
        metrics_hook=None,
        prefetch_depth: int = 2,
        validation_hook=None,
    ):
        self.trainer = trainer
        self.dispenser = dispenser
        self.batcher = batcher
        self.opt = options
        self.metrics_hook = metrics_hook or (lambda **kw: None)
        self.validation_hook = validation_hook or (lambda step, loss: None)
        self.prefetch_depth = prefetch_depth

    @property
    def device(self):
        return self.trainer.device

    def _step_path(self, step: int) -> str:
        return os.path.join(self.opt.savedir, "training", f"step{step}.pt")

    def train(self, state: TrainState | None = None) -> TrainState:
        opt = self.opt
        os.makedirs(os.path.join(opt.savedir, "training"), exist_ok=True)

        # validation split (nnet.py:88-96)
        val_batches: list[PaddedBatch] = []
        for _ in range(opt.valid_batches):
            val_batches.append(self.dispenser.get_padded_batch(self.batcher).to(self.device))
        self.dispenser.split()

        num_steps = int(self.dispenser.num_batches * opt.num_epochs)

        # resume: round starting_step down to a checkpoint and fast-forward
        step = opt.starting_step - opt.starting_step % opt.check_freq
        for _ in range(step):
            self.dispenser.skip_batch()

        if state is None:
            state = self.trainer.init_state(opt.seed)
        elif self.trainer.mesh is not None and state.mesh is None:
            state = shard_state(state, self.trainer.mesh)
        if step > 0:
            state = ckpt.restore_state(self._step_path(step), state)

        num_retries = 0
        validation_loss = None
        validation_step = step
        validated = None
        validated_path = os.path.join(opt.savedir, "training", "validated.pt")
        if val_batches:
            # crash durability: on resume, prefer the persisted rollback
            # point over re-baselining on the resumed state
            meta = ckpt.load_validated_meta(validated_path) if step > 0 else None
            restored = None
            if meta is not None and meta["step"] <= step:
                candidate = ckpt.restore_state(validated_path, state)
                # the sidecar is written only after the state, so a crash
                # can leave a NEWER state with an older sidecar; the state's
                # own step decides, and on a mismatch training re-baselines
                if candidate.step == meta["step"]:
                    restored = candidate
                else:
                    log.warning(
                        "validated checkpoint (step %d) and its sidecar "
                        "(step %d) disagree; re-baselining on the resumed state",
                        candidate.step, meta["step"],
                    )
            if restored is not None:
                validated = restored
                validation_loss = meta["loss"]
                validation_step = meta["step"]
                log.info(
                    "restored validated rollback point from step %d (loss %f)",
                    validation_step, validation_loss,
                )
            else:
                validation_loss = self.trainer.evaluate(state, val_batches)
                log.info("validation loss at step %d: %f", step, validation_loss)
                validated = ckpt.device_snapshot(state)
                ckpt.save_validated(validated_path, validated, validation_loss, step)

        source = PrefetchingBatchSource(
            self.dispenser, self.batcher, depth=self.prefetch_depth, device=self.device
        )
        profile = ProfileWindow(opt if ckpt.writes(state) else dataclasses.replace(opt, profile_steps=0))
        try:
            state = self._train_loop(
                state, source, step, num_steps, val_batches,
                validation_loss, validation_step, num_retries, validated, profile,
            )
        finally:
            profile.stop()
            source.close()

        if opt.average_last > 1:
            state = self._average_final(state)
        final = ckpt.model_state_dict(state)
        if ckpt.writes(state):
            save_checkpoint(opt.savedir, final)

        # state prior (nnet.py:240-244), over the global training set on a grid
        counts = self.dispenser.compute_target_count().astype(np.int64)
        if state.mesh is not None:
            summed = torch.from_numpy(counts).to(self.device)
            dist.all_reduce(summed, group=state.mesh.data_group)
            counts = summed.cpu().numpy()
        counts = counts.astype(np.float64)
        prior = (counts / counts.sum()).astype(np.float32)
        if ckpt.writes(state):
            ckpt.save_prior(os.path.join(opt.savedir, "prior.npy"), prior)
        ckpt.barrier(state)
        return state

    def _average_final(self, state: TrainState) -> TrainState:
        """Checkpoint averaging (``average_last = N``): the end state's
        parameters become the mean of theirs and those of the most recent
        ``N-1`` saved ``training/step*.pt`` checkpoints; optimizer moments
        and batchnorm stats stay the end state's."""
        opt = self.opt
        tdir = os.path.join(opt.savedir, "training")
        steps = sorted(
            int(m.group(1))
            for name in (os.listdir(tdir) if os.path.isdir(tdir) else [])
            if (m := re.fullmatch(r"step(\d+)\.pt", name)) and int(m.group(1)) != state.step
        )
        take = steps[-(opt.average_last - 1):]
        params_list = [state.params()]
        for s in take:
            params_list.append(ckpt.restore_state(self._step_path(s), state).params())
        log.info("checkpoint averaging: final = mean of steps %s", [state.step] + list(reversed(take)))
        averaged = ckpt.average_params(params_list)
        for name, p in state.model.named_parameters():
            p.data.copy_(averaged[name])
        return state

    def _train_loop(
        self,
        state,
        source,
        step,
        num_steps,
        val_batches,
        validation_loss,
        validation_step,
        num_retries,
        validated,
        profile: ProfileWindow,
    ):
        opt = self.opt
        validated_path = os.path.join(opt.savedir, "training", "validated.pt")
        while step < num_steps:
            profile.at_step(step)
            t0 = time.perf_counter()
            with torch.profiler.record_function("train_step"):  # the span a trace's step is read by
                batch = source.next()
                state, loss = self.trainer.update(state, batch)
                loss = float(loss)
            step_time = time.perf_counter() - t0
            log.info("step %d/%d loss: %f (%.3fs)", step, num_steps, loss, step_time)
            self.metrics_hook(
                step=step, loss=loss, step_time=step_time, num_frames=batch.num_frames,
                padded_length=int(batch.inputs.shape[1]),
            )
            step += 1

            # periodic validation with rollback (nnet.py:167-207)
            if val_batches and step % opt.valid_frequency == 0:
                current_loss = self.trainer.evaluate(state, val_batches)
                log.info("validation loss at step %d: %f", step, current_loss)
                self.validation_hook(step, current_loss)
                if opt.valid_adapt:
                    if current_loss > validation_loss:
                        profile.stop()
                        # rewind consumed + prefetched batches (nnet.py:179-181)
                        source.rewind(step - validation_step)
                        state = ckpt.device_snapshot(validated)
                        state = self.trainer.halve_learning_rate(state)
                        # carry the halved lr into the rollback point so
                        # consecutive retries compound 1/2 -> 1/4 -> ...
                        validated = dataclasses.replace(validated, lr_fact=state.lr_fact)
                        # re-persist so a crash mid-retry resumes with the
                        # compounded lr_fact rather than the stale one
                        ckpt.save_validated(validated_path, validated, validation_loss, validation_step)
                        step = validation_step
                        if num_retries == opt.valid_retries:
                            log.info("validation loss is worse, terminating training")
                            break
                        log.info(
                            "validation loss is worse, returning to the previously "
                            "validated model with halved learning rate"
                        )
                        num_retries += 1
                        continue
                    validation_loss = current_loss
                    validation_step = step
                    num_retries = 0
                    validated = ckpt.device_snapshot(state)
                    ckpt.save_validated(validated_path, validated, validation_loss, step)
                else:
                    validation_loss = current_loss

            # layerwise growth (nnet.py:209-229)
            if opt.add_layer_period > 0:
                if (
                    step % opt.add_layer_period == 0
                    and step // opt.add_layer_period < opt.num_hidden_layers
                ):
                    log.info(
                        "adding layer, the model now holds %d/%d layers",
                        step // opt.add_layer_period + 1,
                        opt.num_hidden_layers,
                    )
                    state = self.trainer.add_layer(state)
                    if val_batches:
                        validation_loss = self.trainer.evaluate(state, val_batches)
                        log.info("validation loss at step %d: %f", step, validation_loss)
                        validation_step = step
                        validated = ckpt.device_snapshot(state)
                        ckpt.save_validated(validated_path, validated, validation_loss, step)
                        num_retries = 0

            if step % opt.check_freq == 0:
                ckpt.save_state(self._step_path(step), state)

        return state
