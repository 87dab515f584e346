"""Training steps with the reference's exact optimizer semantics.

Port of :mod:`tfkaldi_tpu.train.trainer` for the hybrid recipe's
cross-entropy loss, the character recipe's CTC loss, the attention
recipe's joint loss and the transducer recipe's lattice loss:

- frame-summed cross-entropy over real frames only (trainer.py:264-275;
  1:1 frames, so no subsampling front-end), or the summed per-utterance
  CTC loss over ``logits.float()`` and the model's ``output_lengths``
  (:mod:`tfkaldi_tpu_torch.train.ctc`, trainer.py:276-295), divided by the
  real *input* frames (trainer.py:301-304);
- the attention loss (trainer.py:186-255): label-smoothed cross-entropy of
  the teacher-forced decoder over ``U+1`` positions with EOS at each row's
  length, ``(1-w)·attention + w·CTC`` with the CTC head's loss (blank =
  SOS/EOS) when ``ctc_weight = w > 0``, divided by the real input frames;
- gradients accumulated over microbatches in a Python loop that threads
  the batchnorm moving stats through (trainer.py:311-359), then divided by
  the batch's total frame count and clipped to ±1, in that order;
- ``lr = init · decay^(step/num_steps) · lr_fact``, with ``lr_fact``
  halved on validation regressions;
- TF-Adam written out: ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)`` computed in float32
  as JAX does, then ``p −= lr_t·m/(√v + ε)`` (ε outside the square root;
  ``torch.optim.Adam`` folds ε into the bias correction, a different
  update, so it is not used);
- the average loss reported as loss_sum / num_frames;
- SpecAugment (``TrainerConfig.spec_augment``, trainer.py:46-60, 361-405):
  time and frequency masks on the padded inputs of every training batch,
  before the micro-batch split, for every loss; evaluation never masks.
  :func:`spec_augment_draw` draws the bands with JAX's distribution and
  :func:`spec_augment_apply` applies them, a pure function of the bands
  and the batch.

On a grid of ranks (``Trainer(..., mesh=...)``, see
:mod:`tfkaldi_tpu_torch.parallel`) ``[nnet] batch_size`` is the global
batch, the ranks' local batches concatenated in the order of their data
index, and a step is the global batch's (tfkaldi_tpu/nnet.py:200-205): the
summed loss, the frame count and the summed gradients are all-reduced over
the data group in one collective, then divided by the global frame count
and clipped, in that order (DDP's average over ranks is another function).
Micro-batch ``j`` is global rows ``[j·B/k, (j+1)·B/k)``: each rank runs its
own rows of that range, none at all on some ranks, and joins every
collective. Batchnorm moments and dropout and SpecAugment draws are the
global batch's (:mod:`tfkaldi_tpu_torch.parallel.comm`), so the result
does not depend on the grid. Evaluation sums loss and frames over the data
group.

The state is a :class:`TrainState`; :meth:`Trainer.update` updates its
model and Adam slots in place and returns it. Dropout masks and
SpecAugment bands come from two generators seeded from ``(seed, step)``
with constants of their own (JAX's ``fold_in`` with 0x5EED and 0x5AEC),
so resume and rollback replay the same masks, and turning SpecAugment on
leaves the dropout stream as it was (the bits are the port's own: JAX's
threefry stream does not carry over).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.models import build_model
from tfkaldi_tpu_torch.ops import rnnt_loss
from tfkaldi_tpu_torch.parallel import comm
from tfkaldi_tpu_torch.parallel.mesh import batch_sharding, shard_state
from tfkaldi_tpu_torch.train import ctc

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# RNN-T loss calls by route since the last reset
rnnt_routes = {"banded": 0, "dense": 0}
# the RNN-T lattices of those calls: rows (the recursion's steps, the
# padded T'), real cells (Σ over rows b of T'_b·min(U_b+1, W), W the
# lattice's width: U_pad+1 dense, the band's S banded) and padded cells
# (B·T'·W less the real ones)
rnnt_lattice = {"rows": 0, "real_cells": 0, "padded_cells": 0}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    init_learning_rate: float = 1e-3
    learning_rate_decay: float = 1.0
    num_steps: int = 1000
    loss_type: str = "cross_entropy"  # cross_entropy | ctc | attention | rnnt
    micro_batches: int = 1  # grad-accumulation factor (1 = whole batch at once)
    ctc_blank_id: int = 0  # blank class for CTC (model emits num_labels+1 classes)
    # SpecAugment (Park et al., 2019; trainer.py:46-60): train-only input
    # masks. Frequency bands cut the raw (pre-splice) feature dim and repeat
    # across every spliced copy (spec_raw_dim = pre-splice dim; 0 masks the
    # whole input dim); time bands zero whole frames within each
    # utterance's real length. The loss masks are untouched.
    spec_augment: bool = False
    spec_time_masks: int = 2
    spec_time_width: int = 20
    spec_freq_masks: int = 2
    spec_freq_width: int = 8
    spec_raw_dim: int = 0


def spec_augment_draw(generator: torch.Generator, batch_size: int, n_masks: int, max_width: int,
                      limits: torch.Tensor, rows: slice | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_masks`` random bands per row, as JAX draws them
    (trainer.py:371-375): ``widths`` uniform on ``[0, max_width]`` and
    ``starts`` a uniform draw on ``[0, 2³¹−1)`` taken modulo
    ``max(limit − width, 1)``, ``limits [B]`` the rows' own bound (frames,
    or the raw feature dim). Both ``[B, n_masks]`` int64 on the
    generator's device. With ``rows``, ``batch_size`` rows are drawn and
    only ``rows`` of them kept (a rank's part of the global batch; then
    ``limits`` covers those rows)."""
    device = generator.device
    shape = (int(batch_size), int(n_masks))
    widths = torch.randint(0, int(max_width) + 1, shape, generator=generator, device=device)
    starts = torch.randint(0, 2**31 - 1, shape, generator=generator, device=device)
    if rows is not None:
        widths, starts = widths[rows], starts[rows]
    span = torch.clamp(limits.to(device=device, dtype=torch.int64)[:, None] - widths, min=1)
    return widths, starts % span


def _band_keep(widths: torch.Tensor, starts: torch.Tensor, size: int, dtype) -> torch.Tensor:
    """``[B, size]`` 0/1 in ``dtype``: 1 minus the union of the bands."""
    idx = torch.arange(size, device=widths.device)[None, :, None]
    in_band = (idx >= starts[:, None, :]) & (idx < (starts + widths)[:, None, :])
    return 1.0 - torch.any(in_band, dim=-1).to(dtype)


def spec_augment_apply(batch: PaddedBatch, time_bands, freq_bands, raw_dim: int = 0) -> PaddedBatch:
    """The batch with its inputs masked (trainer.py:376-399): ``time_bands``
    and ``freq_bands`` are ``(widths, starts)`` pairs from
    :func:`spec_augment_draw`, or None for no mask of that kind. The time
    keep-mask zeroes frames; the frequency band covers ``raw_dim`` columns
    (0: the whole input dim), tiled ``d // raw_dim`` times across the
    splice copies. The masks are in the inputs' dtype, as in JAX."""
    x = batch.inputs
    b, t, d = x.shape
    keep = torch.ones((b, t, 1), dtype=x.dtype, device=x.device)
    if time_bands is not None:
        keep = keep * _band_keep(*time_bands, t, x.dtype)[:, :, None]
    x = x * keep
    if freq_bands is not None:
        raw = raw_dim or d
        if d % raw:
            raise ValueError(f"spec_raw_dim {raw} does not divide the input dim {d}")
        fk = _band_keep(*freq_bands, raw, x.dtype).repeat(1, d // raw)
        x = x * fk[:, None, :]
    return dataclasses.replace(batch, inputs=x)


def _step_generator(device: torch.device, seed: int, step: int, salt: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` and a stream's
    own constant."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + salt) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


@dataclasses.dataclass
class TrainState:
    """All mutable training state: the step counter, the learning-rate
    factor, the model (parameters, batchnorm moving stats and the
    layerwise depth), TF-Adam's slots and power counter, and the seed of
    the dropout stream (trainer.py:63-80)."""

    step: int
    lr_fact: float
    model: torch.nn.Module  # DNN, LSTM, GRU, Transformer, AttentionSeq2Seq or Transducer
    adam_m: dict[str, torch.Tensor]
    adam_v: dict[str, torch.Tensor]
    adam_t: int
    seed: int
    mesh: object = None  # the grid of ranks the state is split over (parallel.mesh.shard_state), or None

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


class Trainer:
    """Train and validation steps on one device, resolved by
    :func:`~tfkaldi_tpu_torch.device.resolve_device` (``cuda`` unless the
    caller names the CPU), for the model its config describes
    (:func:`~tfkaldi_tpu_torch.models.build_model`: ``DNNConfig`` → DNN,
    ``RNNConfig`` → LSTM or GRU, ``TransformerConfig`` → Transformer,
    ``Seq2SeqConfig`` → AttentionSeq2Seq, ``TransducerConfig`` →
    Transducer). With ``mesh`` (a :class:`~tfkaldi_tpu_torch.parallel.mesh.Mesh`)
    the states it makes are split over that grid and its steps are the
    global batch's."""

    def __init__(self, model_config, config: TrainerConfig, device: str | torch.device = "cuda", mesh=None):
        if config.loss_type not in ("cross_entropy", "ctc", "attention", "rnnt"):
            raise ValueError(f"unknown loss {config.loss_type!r}")
        self.model_config = model_config
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> TrainState:
        """A fresh state: the model initialised from a CPU generator seeded
        with ``seed`` (the same weights on every device), zero Adam slots;
        split over the trainer's grid when it has one."""
        model = build_model(self.model_config)
        model.reset_parameters(torch.Generator().manual_seed(int(seed)))
        model.to(self.device)
        params = dict(model.named_parameters())
        state = TrainState(
            step=0,
            lr_fact=1.0,
            model=model,
            adam_m={n: torch.zeros_like(p) for n, p in params.items()},
            adam_v={n: torch.zeros_like(p) for n, p in params.items()},
            adam_t=0,
            seed=int(seed),
        )
        return state if self.mesh is None else shard_state(state, self.mesh)

    def dropout_generator(self, state: TrainState) -> torch.Generator | None:
        """The step's dropout generator, seeded from ``(seed, step)``; None
        when the model has no dropout."""
        if not self.model_config.dropout < 1:
            return None
        return _step_generator(self.device, state.seed, state.step, 0x5EED)

    def spec_augment(self, state: TrainState, batch: PaddedBatch) -> PaddedBatch:
        """The training batch under SpecAugment (trainer.py:361-405): the
        time bands bounded by each row's ``input_lengths``, the frequency
        bands by ``spec_raw_dim``, drawn on the state's device from a
        generator seeded from ``(seed, step)`` with its own constant (JAX's
        ``fold_in(rng, 0x5AEC)``), time first."""
        cfg = self.config
        b = batch.inputs.shape[0]
        gen = _step_generator(self.device, state.seed, state.step, 0x5AEC)
        n, rows = b, None
        if state.mesh is not None:  # this rank's rows of the global batch's draw
            n = b * state.mesh.data
            rows = batch_sharding(state.mesh, n)
        time_bands = freq_bands = None
        if cfg.spec_time_masks > 0 and cfg.spec_time_width > 0:
            time_bands = spec_augment_draw(gen, n, cfg.spec_time_masks, cfg.spec_time_width, batch.input_lengths,
                                           rows)
        if cfg.spec_freq_masks > 0 and cfg.spec_freq_width > 0:
            raw = cfg.spec_raw_dim or batch.inputs.shape[2]
            limits = torch.full((b,), raw, dtype=torch.int64, device=self.device)
            freq_bands = spec_augment_draw(gen, n, cfg.spec_freq_masks, cfg.spec_freq_width, limits, rows)
        return spec_augment_apply(batch, time_bands, freq_bands, cfg.spec_raw_dim)

    # ------------------------------------------------------------------
    # loss and gradients
    # ------------------------------------------------------------------

    @staticmethod
    def loss_sum(model: torch.nn.Module, batch: PaddedBatch, *, train: bool, generator=None,
                 loss_type: str = "cross_entropy", blank_id: int = 0):
        """The summed loss over real frames and its frame divisor (f32):
        frame CE over ``target_lengths`` frames, the CTC loss of every
        utterance over its ``output_lengths`` frames, the attention
        model's joint loss, or the transducer's lattice loss
        (trainer.py:121-304)."""
        if loss_type == "cross_entropy" and getattr(model, "subsample_factor", 1) != 1:
            raise ValueError("frame-level CE needs 1:1 frame alignment; subsample > 1 is a CTC-only front-end "
                             "(loss = ctc)")
        if loss_type in ("ctc", "attention"):
            # the CTC loss's route plan reads the labels on the host: copied
            # before the forward is queued, they wait only on what is already
            # queued (the batch's own copy; with micro-batches, the previous
            # one's backward), not on this forward
            labels = [ctc.host(a) for a in (batch.input_lengths, batch.targets, batch.target_lengths)]
            out_fn = getattr(model, "output_lengths", None)
            if out_fn is not None:  # a subsampling front-end emits ceil(T/s) frames
                labels[0] = out_fn(labels[0])
        if loss_type == "attention":
            return Trainer._attention_loss_sum(model, batch, labels, train, generator)
        if loss_type == "rnnt":
            return Trainer._rnnt_loss_sum(model, batch, train, generator)
        logits = model(batch.inputs, batch.input_lengths, train=train, generator=generator)
        if loss_type == "ctc":
            per_seq = ctc.ctc_loss(logits, *labels, blank_id)
            return torch.sum(per_seq), batch.input_lengths.sum().float()
        b, t, o = logits.shape
        if batch.targets.shape != (b, t):
            raise ValueError(
                f"frame-level CE needs targets [B, T] = {(b, t)}, got {tuple(batch.targets.shape)}"
            )
        ce = F.cross_entropy(
            logits.reshape(b * t, o), batch.targets.reshape(b * t).long(), reduction="none"
        ).reshape(b, t)
        frames = torch.arange(t, device=logits.device)[None, :]
        mask = frames < batch.target_lengths.to(logits.device)[:, None]
        loss = torch.sum(ce * mask)
        return loss, batch.target_lengths.sum().float()

    @staticmethod
    def _attention_loss_sum(model, batch: PaddedBatch, labels, train: bool, generator):
        """The attention model's summed loss (trainer.py:186-255): teacher-
        forced CE over positions ``0..U`` (EOS = ``sos_eos_id`` at each row's
        length), smoothed as ``(1-ε)·nll + ε·(−mean_V log p)``; with
        ``ctc_weight = w > 0``, ``(1-w)·that + w·`` the CTC head's loss
        (blank = ``sos_eos_id``) over ``labels`` = host ``(output_lengths,
        targets, target_lengths)``. The divisor is the real input frames."""
        cfg = model.config
        w = cfg.ctc_weight
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        if w > 0.0:
            logits, ctc_logits = model.apply_joint(*args, train=train, generator=generator)
            ctc_sum = torch.sum(ctc.ctc_loss(ctc_logits, *labels, model.sos_eos_id))
        else:
            logits = model.apply_seq2seq(*args, train=train, generator=generator)
        b, u1, _ = logits.shape
        device = logits.device
        pos = torch.arange(u1, device=device)[None, :]
        lengths = batch.target_lengths.to(device)[:, None]
        targets = torch.cat([batch.targets.to(device), torch.zeros(b, 1, dtype=batch.targets.dtype,
                                                                    device=device)], dim=1).long()
        targets = torch.where(pos == lengths, model.sos_eos_id, targets)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 2, targets[:, :, None])[..., 0]
        eps = cfg.label_smoothing
        if eps > 0.0:
            nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
        loss = torch.sum(nll * (pos <= lengths))
        if w > 0.0:
            loss = (1.0 - w) * loss + w * ctc_sum
        return loss, batch.input_lengths.sum().float()

    @staticmethod
    def _rnnt_loss_sum(model, batch: PaddedBatch, train: bool, generator):
        """The transducer's summed lattice NLL (trainer.py:121-190): the
        banded route when ``0 < prune_s <= U_pad``, else the dense one, over
        the encoder's ``output_lengths``; the divisor is the real input
        frames."""
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        enc_lengths = model.output_lengths(batch.input_lengths)
        # for the lattice counters: host copies taken before the forward is
        # queued, so they wait only on the batch's own copy
        real_t = model.output_lengths(ctc.host(batch.input_lengths).astype(np.int64))
        real_u1 = ctc.host(batch.target_lengths).astype(np.int64) + 1
        if 0 < model.config.prune_s <= batch.targets.shape[1]:
            lp_blank, lp_label, starts = model.lattice_scores_pruned(*args, train=train, generator=generator)
            per_seq = rnnt_loss.rnnt_alpha_loss_banded(lp_blank, lp_label, starts, enc_lengths,
                                                       batch.target_lengths)
            rnnt_routes["banded"] += 1
        else:
            lp_blank, lp_label = model.lattice_scores(*args, train=train, generator=generator)
            per_seq = rnnt_loss.rnnt_alpha_loss(lp_blank, rnnt_loss.mask_label_scores(lp_label, batch.target_lengths),
                                                enc_lengths, batch.target_lengths)
            rnnt_routes["dense"] += 1
        b, t_pad, width = lp_blank.shape
        real = int(np.sum(real_t * np.minimum(real_u1, width)))
        rnnt_lattice["rows"] += t_pad
        rnnt_lattice["real_cells"] += real
        rnnt_lattice["padded_cells"] += b * t_pad * width - real
        return torch.sum(per_seq), batch.input_lengths.sum().float()

    def _loss_sum(self, model, batch: PaddedBatch, *, train: bool, generator=None):
        return self.loss_sum(model, batch, train=train, generator=generator,
                             loss_type=self.config.loss_type, blank_id=self.config.ctc_blank_id)

    def gradients(self, state: TrainState, batch: PaddedBatch, generator=None):
        """Summed gradients over the microbatches, the summed loss and the
        frame count. Parameters that do not reach the loss (hidden layers
        past the depth selector) get zero gradients, as under autodiff. On
        a grid all three are the global batch's, summed over the data
        group."""
        model = state.model
        mesh = state.mesh
        for p in model.parameters():
            p.grad = None
        k = self.config.micro_batches
        b = batch.inputs.shape[0]
        n_global = b if mesh is None else b * mesh.data
        if n_global % k != 0:
            raise ValueError(f"batch size {n_global} not divisible by micro_batches {k}")
        micro = n_global // k
        first = 0 if mesh is None else b * mesh.data_index  # this rank's first global row
        loss_total = torch.zeros((), device=self.device)
        frames_total = torch.zeros((), device=self.device)
        for j in range(k):
            # this rank's rows of global micro-batch j (none on some ranks)
            lo, hi = max(j * micro, first), min((j + 1) * micro, first + b)
            lo, hi = (lo, hi) if hi > lo else (first, first)
            mb = PaddedBatch(*(a[lo - first: hi - first] for a in batch.fields()))
            split = (contextlib.nullcontext() if mesh is None
                     else comm.data_split(mesh.data_group, micro, lo - j * micro if hi > lo else 0))
            with split:
                loss, frames = self._loss_sum(model, mb, train=True, generator=generator)
                loss.backward()
            loss_total += loss.detach()
            frames_total += frames
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()
        }
        for p in model.parameters():
            p.grad = None
        if mesh is not None:  # the global batch's, in one all-reduce
            *summed, loss_total, frames_total = comm.all_reduce_tensors([*grads.values(), loss_total, frames_total],
                                                                        mesh.data_group)
            grads = dict(zip(grads, summed))
        return grads, loss_total, frames_total

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def learning_rate(self, state: TrainState) -> np.float32:
        """``init · decay^(step/num_steps) · lr_fact`` in float32
        (trainer.py:414-420)."""
        cfg = self.config
        f32 = np.float32
        return (
            f32(cfg.init_learning_rate)
            * np.power(f32(cfg.learning_rate_decay), f32(state.step) / f32(cfg.num_steps))
            * f32(state.lr_fact)
        )

    def update(self, state: TrainState, batch: PaddedBatch):
        """One optimizer step on a batch (on the state's device), in place;
        returns ``(state, average loss)`` with the loss a 0-d tensor."""
        if self.config.spec_augment:
            batch = self.spec_augment(state, batch)
        grads, loss, frames = self.gradients(state, batch, self.dropout_generator(state))
        frames_safe = torch.clamp(frames, min=1.0)
        f32 = np.float32
        t = state.adam_t + 1
        tf_ = f32(t)
        lr_t = (
            self.learning_rate(state)
            * np.sqrt(f32(1.0) - f32(ADAM_B2) ** tf_)
            / (f32(1.0) - f32(ADAM_B1) ** tf_)
        )
        lr_t = float(np.float32(lr_t))
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                # mean over frames then clip ±1, in that order (trainer.py:410-412)
                g = torch.clamp(grads[name] / frames_safe, -1.0, 1.0)
                m = state.adam_m[name]
                v = state.adam_v[name]
                m.copy_(ADAM_B1 * m + (1.0 - ADAM_B1) * g)
                v.copy_(ADAM_B2 * v + (1.0 - ADAM_B2) * torch.square(g))
                p.copy_(p - lr_t * m / (torch.sqrt(v) + ADAM_EPS))
        state.step += 1
        state.adam_t = t
        return state, loss / frames_safe

    def evaluate(self, state: TrainState, batches) -> float:
        """Average frame loss over validation batches with the eval forward
        (trainer.py:475-483: accumulate loss and frames, then divide), under
        a ``train.validate`` ``torch.profiler`` span."""
        total_loss, total_frames = 0.0, 0.0
        with torch.profiler.record_function("train.validate"), torch.inference_mode():
            for batch in batches:
                loss, frames = self._loss_sum(state.model, batch, train=False)
                total_loss += float(loss)
                total_frames += float(frames)
            if state.mesh is not None:  # the global validation set's, the same value on every rank
                sums = torch.tensor([total_loss, total_frames], dtype=torch.float64, device=self.device)
                dist.all_reduce(sums, group=state.mesh.data_group)
                total_loss, total_frames = (float(v) for v in sums.cpu())
        return total_loss / max(total_frames, 1.0)

    @staticmethod
    def halve_learning_rate(state: TrainState) -> TrainState:
        """The validation-rollback LR halving (trainer.py:140-142)."""
        return dataclasses.replace(state, lr_fact=state.lr_fact / 2)

    @staticmethod
    def add_layer(state: TrainState) -> TrainState:
        """Layerwise 'add' + 'init' (dnn.py:92, 112-122) of the DNN: advance
        the depth selector and re-zero the output layer and its Adam slots,
        in place."""
        model = state.model
        with torch.no_grad():
            model.depth.add_(1)
            model.reinit_output_layer()
            for name in ("out.w", "out.b"):
                state.adam_m[name].zero_()
                state.adam_v[name].zero_()
        return state
