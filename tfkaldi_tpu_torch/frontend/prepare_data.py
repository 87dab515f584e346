"""Feature preparation: wav corpus → Kaldi featdir on disk.

Port of :mod:`tfkaldi_tpu.frontend.prepare_data` (``prepare_data``,
``compute_cmvn`` and ``shuffle_examples``). Utterances are packed into padded batches (signal
lengths bucketed to whole seconds) and each batch is one device call. A
reader thread reads wavs ahead; the main thread dispatches batch k+1 to the
device before it copies batch k back and writes it, so the ark write
overlaps the device work. The featdir layout is identical: feats.ark/scp
(wav.scp order), cmvn.ark/scp, maxlength, and copied
utt2spk/spk2utt/text/wav.scp. ``speed_perturb = 0.9,1.0,1.1`` in the
features section adds a resampled copy of every utterance per factor under
a ``sp{f}-`` prefix (frontend/perturb.py), through the same batches.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import shutil
import threading

import numpy as np

from tfkaldi_tpu_torch.frontend.cmvn import cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.perturb import expand_metadata, factor_prefix, parse_factors, resample_signal
from tfkaldi_tpu_torch.io import (
    ArkReader,
    ArkWriter,
    read_segments,
    read_spk2utt,
    read_wav,
    read_wavfiles,
    scan_scp_shapes,
)

log = logging.getLogger(__name__)


def _signal_jobs(datadir: str):
    """Yield (utt_id, rate, signal) honoring an optional segments file
    (prepare_data.py:30-37, 55-64)."""
    wavfiles = read_wavfiles(os.path.join(datadir, "wav.scp"))
    segments_path = os.path.join(datadir, "segments")
    if os.path.isfile(segments_path):
        segments = read_segments(segments_path)
        for rec, wavfile in wavfiles.items():
            rate, sig = read_wav(wavfile)
            for seg_id, begin, end in segments.get(rec, []):
                yield seg_id, rate, sig[int(begin * rate) : int(end * rate)]
    else:
        log.warning("no segments file found, assuming each wav file is a separate utterance")
        for utt, wavfile in wavfiles.items():
            rate, sig = read_wav(wavfile)
            yield utt, rate, sig


def prepare_data(
    datadir: str,
    featdir: str,
    conf: dict,
    feat_type: str | None = None,
    dynamic: str | None = None,
    *,
    batch_size: int = 32,
    length_bucket_seconds: float = 1.0,
    device: str = "cuda",
) -> int:
    """Compute features for a Kaldi data dir and write the featdir.

    Returns the max utterance frame count (also written to ``maxlength``).
    """
    os.makedirs(featdir, exist_ok=True)
    conf = dict(conf)
    if feat_type:
        conf["type"] = feat_type
    if dynamic:
        conf["dynamic"] = dynamic
    opts = FeatureOpts.from_config(conf)
    # optional 3-way speed perturbation (Kaldi's sp0.9/1.0/1.1 recipe; the
    # reference has none): each utterance once per factor, resampled on the
    # host, its id prefixed (frontend/perturb.py)
    perturb_spec = str(conf.get("speed_perturb", "")).strip()
    factors = parse_factors(perturb_spec) if perturb_spec else (1.0,)

    ark_path = os.path.join(featdir, "feats.ark")
    if os.path.isfile(ark_path):
        os.remove(ark_path)

    extractor: FeatureExtractor | None = None
    max_length = 0
    pending: list[tuple[str, np.ndarray]] = []
    # dispatched batches not yet copied back: (utt_ids, feats on device, num_frames)
    in_flight: list[tuple[list[str], object, np.ndarray]] = []

    def dispatch():
        if not pending:
            return
        bucket = max(1, int(length_bucket_seconds * extractor.rate))
        s_pad = -(-max(len(s) for _, s in pending) // bucket) * bucket
        batch = np.zeros((len(pending), s_pad), dtype=np.float32)
        lengths = np.zeros(len(pending), dtype=np.int64)
        for i, (_, sig) in enumerate(pending):
            batch[i, : len(sig)] = sig
            lengths[i] = len(sig)
        feats, num_frames = extractor(batch, lengths)  # asynchronous on a card
        in_flight.append(([u for u, _ in pending], feats, num_frames))
        pending.clear()

    def drain(writer, keep: int = 0):
        nonlocal max_length
        while len(in_flight) > keep:
            utt_ids, feats, num_frames = in_flight.pop(0)
            feats = feats.cpu().numpy()  # waits for the device
            for i, utt_id in enumerate(utt_ids):
                n = int(num_frames[i])
                writer.write_next_utt(utt_id, feats[i, :n])
                max_length = max(max_length, n)

    # background wav reading: file IO overlaps device compute
    jobs: queue.Queue = queue.Queue(maxsize=2 * batch_size)
    end = object()
    stop = threading.Event()
    reader_error: list[BaseException] = []

    def read_all():
        try:
            for job in _signal_jobs(datadir):
                if stop.is_set():
                    break
                jobs.put(job)
        except BaseException as e:  # re-raised in the main thread below
            reader_error.append(e)
        finally:
            jobs.put(end)

    reader = threading.Thread(target=read_all, daemon=True)
    reader.start()
    try:
        with ArkWriter(os.path.join(featdir, "feats.scp"), ark_path) as writer:
            while True:
                job = jobs.get()
                if job is end:
                    break
                utt_id, rate, sig = job
                if extractor is None:
                    extractor = FeatureExtractor(opts, rate, device)
                elif rate != extractor.rate:
                    raise ValueError(f"mixed sample rates: {rate} vs {extractor.rate}")
                if sig.ndim > 1:  # multi-channel: first channel
                    sig = sig[:, 0]
                sig = np.asarray(sig, dtype=np.float32)
                for fac in factors:
                    pending.append((factor_prefix(fac) + utt_id, resample_signal(sig, fac)))
                    if len(pending) >= batch_size:
                        dispatch()
                        drain(writer, keep=1)
            dispatch()
            drain(writer, keep=0)
    finally:
        # stop, unblock and join the reader even when the main loop raised
        stop.set()
        while reader.is_alive():
            try:
                jobs.get(timeout=0.1)
            except queue.Empty:
                pass
        reader.join()
    if reader_error:
        raise reader_error[0]

    # copy metadata into the featdir (prepare_data.py:72-76); under speed
    # perturbation utt2spk/spk2utt/text are expanded with prefixed copies
    # instead, and wav.scp is not copied: it would hold only the unprefixed
    # third of the ids, and its audio is not the perturbed signal
    copy_names = ("utt2spk", "spk2utt", "text", "wav.scp")
    if factors != (1.0,):
        expand_metadata(datadir, featdir, factors)
        copy_names = ()
    for name in copy_names:
        src = os.path.join(datadir, name)
        if os.path.isfile(src):
            shutil.copyfile(src, os.path.join(featdir, name))

    with open(os.path.join(featdir, "maxlength"), "w") as fid:
        fid.write(str(max_length))
    return max_length


def compute_cmvn(featdir: str) -> None:
    """Per-speaker CMVN statistics over feats.scp → cmvn.ark/cmvn.scp
    (prepare_data.py:82-122; same [2, dim+1] stats layout)."""
    cmvn_ark = os.path.join(featdir, "cmvn.ark")
    if os.path.isfile(cmvn_ark):  # reruns must not append stale records
        os.remove(cmvn_ark)
    spk2utt = read_spk2utt(os.path.join(featdir, "spk2utt"))
    with ArkReader(os.path.join(featdir, "feats.scp")) as reader, ArkWriter(
        os.path.join(featdir, "cmvn.scp"), cmvn_ark
    ) as writer:
        for spk, utts in spk2utt.items():
            stats = None
            for utt_id in utts:
                s = cmvn_stats(reader.read_utt(utt_id))
                stats = s if stats is None else stats + s
            writer.write_next_utt(spk, stats)


def shuffle_examples(
    featdir: str,
    seed: int | None = None,
    length_bands: int = 0,
    valid_head: int = 0,
) -> None:
    """Shuffle feats.scp once on disk → feats_shuffled.scp (a copy of
    tfkaldi_tpu/frontend/prepare_data.py ``shuffle_examples``; reference
    prepare_data.py:124-141).

    ``length_bands > 1`` sorts the utterances by frame count (ark header
    reads), splits them into that many bands and shuffles within each band
    and the band order, so batches draw similar lengths. ``valid_head``
    reserves that many uniformly sampled utterances at the head, where the
    training controller carves its validation set.
    """
    with open(os.path.join(featdir, "feats.scp")) as f:
        lines = f.readlines()
    rng = random.Random(seed)

    if length_bands > 1:
        rng.shuffle(lines)  # uniform order; the head stays uniform
        head, rest = lines[:valid_head], lines[valid_head:]
        entries = []
        for line in rest:
            _, path_pos = line.strip().split(" ", 1)
            path, pos = path_pos.rsplit(":", 1)
            entries.append((path, int(pos)))
        counts = [rows for rows, _cols in scan_scp_shapes(entries)]
        order = sorted(range(len(rest)), key=lambda i: counts[i])
        band_size = max(1, -(-len(rest) // length_bands))
        bands = [
            [rest[i] for i in order[b : b + band_size]]
            for b in range(0, len(rest), band_size)
        ]
        for band in bands:
            rng.shuffle(band)
        rng.shuffle(bands)
        lines = head + [line for band in bands for line in band]
    else:
        rng.shuffle(lines)
    out = os.path.join(featdir, "feats_shuffled.scp")
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.writelines(lines)
    os.replace(tmp, out)
