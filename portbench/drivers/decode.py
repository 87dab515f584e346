"""The decode driver: the hybrid recipe's likelihood emission,
``Decoder.decode_to_writer``, over test jobs back to back.

Set-up writes one job of seeded test utterances (the size of one AURORA-4
test condition), makes the model's weights, its batch-norm moving
statistics and the state prior from the seed on the device, and decodes
the job once, which warms every shape the window uses. The window then
decodes the job again and again: the feature reader with CMVN and
splicing, batches of ``batch_size`` padded to ``bucket_multiple``, the
eval forward, softmax ÷ prior → floor → log, the copy to the host, and
every matrix serialised as a Kaldi ark record by the program's own
``write_ark_matrix``, into one reused in-memory buffer (arks on disk
would outgrow the disk in seconds). The writer keeps the bytes of a
seeded sample of utterances (the longest among them) and ends the window
at its first write after the deadline. A host clock splits the window's
time by phase: the feature reader's (read, CMVN, splice, batching), the
device's (``compute_batch`` and the copy of its likelihoods to the host)
and the serialiser's.

After the window the program is freed and the reference computes the
sample's log pseudo-likelihoods again from the corpus files, to compare
with what the ark bytes say. Fault ``altered``: every answer has one
value changed where it is produced.
"""

from __future__ import annotations

import configparser
import gc
import io
import os
import struct
import time

import numpy as np
import torch

from portbench import check, corpus as corpus_mod, weights as weights_mod
from portbench.drivers.train import StopWindow, _reference_precision, model_shapes
from portbench.record import Record
from portbench.reference import data as ref_data, models as ref_models
from portbench.trace import Profile, mark_window

FAULTS = ("altered",)


def make_stats(config: dict, seed: int, dev) -> dict[str, torch.Tensor]:
    """The moving statistics and the prior the cell decodes with."""
    nnet = config["nnet"]
    layers, units = int(nnet["num_hidden_layers"]), int(nnet["num_hidden_units"])
    g = weights_mod.generator(dev, seed, 2)
    return {"bn_mean": 0.5 * torch.randn(layers, units, generator=g, device=dev),
            "bn_var": torch.exp(0.5 * torch.randn(layers, units, generator=g, device=dev)),
            "prior": torch.softmax(torch.randn(config["num_labels"], generator=g, device=dev), 0)}


def make_corpus(workdir: str, seed: int, config: dict, traffic: dict) -> corpus_mod.Corpus:
    return corpus_mod.make_corpus(
        os.path.join(workdir, "corpus"), seed, num_utts=traffic["job_utterances"], speakers=traffic["speakers"],
        feat_dim=config["feat_dim"], targets="none", mean_s=traffic["mean_s"], sigma=traffic["sigma"],
        min_s=traffic["min_s"], max_s=traffic["max_s"], frame_rate=traffic["frame_rate"])


def check_sample(corpus, seed: int, traffic: dict) -> set[str]:
    """The utterances the check compares: the longest and a seeded draw."""
    rng = corpus_mod.rng_for(seed, 3)
    longest = max(corpus.utts, key=lambda u: corpus.frames[u])
    return {longest} | set(rng.choice(corpus.utts, int(traffic["check_utterances"]) - 1, replace=False).tolist())


class PhaseClock:
    """Host seconds of the window by phase: each call to :meth:`to` books
    the time since the last to the phase that just ended."""

    PHASES = ("read", "device", "serialise")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.mark = time.perf_counter()
        self.seconds = dict.fromkeys(self.PHASES, 0.0)

    def to(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] += now - self.mark
        self.mark = now


class SampleWriter:
    """``ArkWriter``'s surface: every matrix serialised by the program's
    ``write_ark_matrix`` into one reused buffer; the bytes of the sampled
    utterances kept; a record whose header does not say the utterance's
    frames and the model's labels counted as failed."""

    def __init__(self, frames: dict[str, int], labels: int, sample: set[str], clock: PhaseClock, deadline=None,
                 fault=None):
        from tfkaldi_tpu_torch.io.ark import write_ark_matrix

        self._write = write_ark_matrix
        self.frames, self.labels, self.sample = frames, labels, sample
        self.buf = io.BytesIO()
        self.kept: dict[str, bytes] = {}
        self.clock, self.deadline, self.fault = clock, deadline, fault
        self.count = self.failed = self.real_frames = 0

    def write_next_utt(self, utt_id: str, mat: np.ndarray) -> None:
        self.clock.to("device")  # the batch's likelihoods reached the host
        if self.fault == "altered":
            mat = np.array(mat)
            mat[mat.shape[0] // 2, int(self.count % mat.shape[1])] += 1.0
        self.buf.seek(0)
        offset = self._write(self.buf, utt_id, mat)
        end = self.buf.tell()
        view = self.buf.getbuffer()
        head = bytes(view[offset:offset + 15])
        rows, cols = struct.unpack("<i", head[6:10])[0], struct.unpack("<i", head[11:15])[0]
        if head[:5] != b"\x00BFM " or rows != self.frames.get(utt_id) or cols != self.labels:
            self.failed += 1
        if utt_id in self.sample:
            self.kept[utt_id] = bytes(view[offset:end])
        del view
        self.count += 1
        self.real_frames += rows
        self.clock.to("serialise")
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopWindow


def parse_record(data: bytes) -> np.ndarray:
    rows, cols = struct.unpack("<i", data[6:10])[0], struct.unpack("<i", data[11:15])[0]
    return np.frombuffer(data[15:15 + rows * cols * 4], dtype="<f4").reshape(rows, cols)


class BatchSpans:
    """Wraps the decoder's ``compute_batch``: a ``portbench.decode_batch``
    annotation around each call and the padded rows it computed."""

    def __init__(self, decoder, clock: PhaseClock):
        self.fn, self.rows, self.active, self.clock = decoder.compute_batch, [], False, clock

    def __call__(self, inputs, lengths):
        self.clock.to("read")  # the reader handed over the batch
        with torch.profiler.record_function("portbench.decode_batch"):
            out = self.fn(inputs, lengths)
        if self.active:
            self.rows.append(int(inputs.shape[0]) * int(inputs.shape[1]))
        return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str, t0_wall: float, workdir: str,
        fault: str | None = None, limits: dict | None = None) -> Record:
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.nnet import Nnet

    config, traffic = cell["config_data"], cell["traffic_data"]
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: want one of {FAULTS}")
    nnet_conf = config["nnet"]
    cw = int(nnet_conf["context_width"])
    corpus = make_corpus(workdir, seed, config, traffic)
    sample = check_sample(corpus, seed, traffic)

    conf = configparser.ConfigParser()
    conf["directories"] = {"expdir": os.path.join(workdir, "exp")}
    conf["nnet"] = nnet_conf
    nnet = Nnet(conf, input_dim=config["feat_dim"], num_labels=config["num_labels"], device=device)
    dev = nnet.device
    cuda = dev.type == "cuda"
    model = nnet.model.to(dev)
    weights_mod.load_into(model, weights_mod.make_weights(model_shapes(config), seed, dev))
    stats = make_stats(config, seed, dev)
    with torch.no_grad():
        model.bn_mean.copy_(stats["bn_mean"])
        model.bn_var.copy_(stats["bn_var"])
    decoder = Decoder(model, stats["prior"].cpu().numpy())
    clock = PhaseClock()
    spans = BatchSpans(decoder, clock)
    decoder.compute_batch = spans
    batch_size, bucket = int(traffic["batch_size"]), int(traffic["bucket_multiple"])

    def job(writer) -> None:
        """One job; an utterance that a finished job never wrote is failed."""
        reader = FeatureReader(corpus.feats_scp, corpus.cmvn_scp, corpus.utt2spk_path, cw, corpus.max_length)
        try:
            done = decoder.decode_to_writer(reader, writer, batch_size=batch_size, bucket_multiple=bucket)
        finally:
            reader.close()
        writer.failed += len(corpus.utts) - done

    labels = config["num_labels"]
    job(SampleWriter(corpus.frames, labels, set(), clock))  # warm-up: every shape of the job
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    profile = None
    if trace:
        profile = Profile(os.path.join(workdir, "profile"), dev.type)
        profile.start()
        try:  # the profiler's first batch, ahead of the window
            job(SampleWriter(corpus.frames, labels, set(), clock, deadline=time.perf_counter()))
        except StopWindow:
            pass
        mark_window()
    t_open_wall = time.time()
    t_open = time.perf_counter()
    spans.active = True
    clock.reset()
    writer = SampleWriter(corpus.frames, labels, sample, clock, deadline=t_open + seconds, fault=fault)
    try:
        while True:
            job(writer)
    except StopWindow:
        pass
    window_s = time.perf_counter() - t_open
    spans.active = False

    rec = Record(cell=cell["name"], config=config, traffic=traffic, chips=1)
    rec.setup_s = t_open_wall - t0_wall
    rec.window_s = window_s
    rec.frames = writer.real_frames
    rec.attempted, rec.failed = writer.count, writer.failed
    rec.batches = [{"rows": r} for r in spans.rows]
    rec.window = {f"{phase}_s": v for phase, v in clock.seconds.items()}
    if profile is not None:
        rec.trace = profile.stop()
        rec.trace_extent = rec.trace.extent("portbench.decode_batch")
        rec.busy_s = rec.trace.busy_us(*rec.trace_extent) * 1e-6 if rec.trace_extent else None
    rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kept = writer.kept
    del decoder, model, nnet, spans, writer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if limits is not None:
        with _reference_precision():
            gap = reference_gap(config, corpus, seed, dev, kept)
        rec.numbers = {"ll_gap": gap}
        ok, rec.compared = check.judge(rec.numbers, limits)
        # the sampled answers that the window wrote; one that a finished job
        # never wrote is already counted as failed
        rec.correct = ok and rec.failed == 0 and bool(kept)
    return rec


def reference_loglikes(config: dict, corpus, seed: int, dev, utts, mode: str = "f32") -> dict[str, np.ndarray]:
    """The reference's log pseudo-likelihoods of ``utts``: CMVN, splice, the
    eval forward on the moving statistics, softmax ÷ prior, the floor of
    exact zeros at float64's ε, log."""
    nnet = config["nnet"]
    layers = int(nnet["num_hidden_layers"])
    w = weights_mod.make_weights(model_shapes(config), seed, dev)
    st = make_stats(config, seed, dev)
    feats = ref_data.Features(corpus.dirpath, int(nnet["context_width"]))
    out = {}
    with torch.no_grad():
        for u in utts:
            x = torch.as_tensor(feats(u), dtype=torch.float32, device=dev)
            logits = ref_models.dnn_eval_logits(w, x, st["bn_mean"], st["bn_var"], layers,
                                                float(config["assumed"].get("bn_eps", 1e-3)), mode)
            likes = torch.softmax(logits, dim=-1) / st["prior"]
            likes = torch.where(likes == 0, float(np.finfo(np.float64).eps), likes)
            out[u] = torch.log(likes).cpu().numpy()
    return out


def reference_gap(config: dict, corpus, seed: int, dev, kept: dict[str, bytes]) -> float:
    ref = reference_loglikes(config, corpus, seed, dev, sorted(kept))
    gap = 0.0
    for u, data in kept.items():
        got = parse_record(data)
        if got.shape != ref[u].shape:
            return float("inf")
        gap = max(gap, float(np.max(np.abs(got.astype(np.float64) - ref[u]))))
    return gap


def control_numbers(cell: dict, seed: int, device: str, workdir: str, mode: str) -> dict[str, float]:
    """The control: the reference in ``mode`` in the program's place, held
    to the reference in float32 on the same sample."""
    config, traffic = cell["config_data"], cell["traffic_data"]
    corpus = make_corpus(workdir, seed, config, traffic)
    utts = sorted(check_sample(corpus, seed, traffic))
    dev = torch.device(device if device != "cuda" else "cuda:0")
    with _reference_precision():
        ref = reference_loglikes(config, corpus, seed, dev, utts)
        low = reference_loglikes(config, corpus, seed, dev, utts, mode)
    return {"ll_gap": max(float(np.max(np.abs(low[u].astype(np.float64) - ref[u]))) for u in utts)}
