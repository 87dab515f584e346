"""Persistent decode service over a filesystem spool, and the streaming
socket servers.

Port of :mod:`tfkaldi_tpu.serve`: :class:`DecodeService` (serve.py:35-175),
and the streaming half (serve.py:205-873): :func:`global_cmvn`,
:func:`build_streaming_transcriber`, the wire protocol,
:class:`StreamingServer`, :class:`MultiStreamServer` and the clients
:func:`stream_transcribe` and :func:`stream_words`. The model is loaded
once onto the device, then decode jobs or streams are served as they
arrive.

Job contract: a job is a directory dropped under ``watch_dir`` holding a
featdir (``feats.scp``, ``cmvn.scp`` unless CMVN is disabled, ``utt2spk``).
The service writes ``out_dir/<job>/likelihoods.ark`` with its ``feats.scp``
(the hybrid recipe) or ``out_dir/<job>/text`` (``loss = ctc | rnnt |
attention``: the decoder of :meth:`tfkaldi_tpu_torch.nnet.Nnet.
load_text_decoder`, whose CTC beam reads no ``lm_path`` here, as in the JAX
service) plus a ``DONE`` marker holding the utterance count, and skips
jobs already marked ``DONE`` or ``FAILED``, so it is restart-safe. A job
that raises is quarantined with a ``FAILED`` marker holding the traceback.

Streaming wire protocol, byte for byte the JAX package's (all integers
big-endian): a message is ``type:1 | length:4 | payload``. The client sends
``A`` (float32 LE PCM samples), ``F`` (finish) and the alignment requests
``S`` (timestamps), ``C`` (confidences) and ``W`` (words); the server
answers ``P`` (partial, UTF-8), ``T`` (final), ``M`` / ``c`` (float64 LE,
one value a label), ``J`` (UTF-8 JSON ``[{word, start, end,
confidence}]``) or ``E`` (error text, then close). A connection stays open
after ``T`` for alignment requests until the client hangs up. The
transcribers run under ``torch.inference_mode``, entered by every server
thread that drives one (grad mode is per thread in torch).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import queue
import socket as socketlib
import struct
import threading
import time
import traceback

import numpy as np
import torch

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.io import ArkReader, ArkWriter

log = logging.getLogger(__name__)


class DecodeService:
    """Model-resident decode worker over a filesystem spool."""

    def __init__(self, nnet, watch_dir: str, out_dir: str, *, coder=None, batch_size: int = 16):
        """``nnet``: a :class:`tfkaldi_tpu_torch.nnet.Nnet`; ``coder``: its
        text coder, required for the text-target losses."""
        self.nnet = nnet
        self.watch_dir = watch_dir
        self.out_dir = out_dir
        self.coder = coder
        self.batch_size = batch_size
        self.text = nnet.loss_type in ("ctc", "rnnt", "attention")
        os.makedirs(watch_dir, exist_ok=True)
        os.makedirs(out_dir, exist_ok=True)
        # weights loaded once
        if self.text:
            if coder is None:
                raise ValueError("text-decode service needs a target coder")
            self._decoder = nnet.load_text_decoder(coder, ctc_lm=False)
        else:
            self._decoder = nnet.load_decoder()

    def _pending_jobs(self) -> list[str]:
        jobs = []
        for name in sorted(os.listdir(self.watch_dir)):
            jobdir = os.path.join(self.watch_dir, name)
            if not os.path.isdir(jobdir):
                continue
            if not os.path.isfile(os.path.join(jobdir, "feats.scp")):
                continue  # not (yet) a complete job
            outdir = os.path.join(self.out_dir, name)
            if os.path.isfile(os.path.join(outdir, "DONE")):
                continue
            if os.path.isfile(os.path.join(outdir, "FAILED")):
                continue  # quarantined: an operator removes the marker to retry
            jobs.append(name)
        return jobs

    def process_job(self, name: str) -> int:
        """Decode one job directory; returns the number of utterances."""
        jobdir = os.path.join(self.watch_dir, name)
        outdir = os.path.join(self.out_dir, name)
        os.makedirs(outdir, exist_ok=True)
        cmvn = os.path.join(jobdir, "cmvn.scp")
        reader = FeatureReader(
            os.path.join(jobdir, "feats.scp"),
            cmvn if os.path.isfile(cmvn) else None,
            os.path.join(jobdir, "utt2spk"),
            self.nnet.context_width,
            0,  # max_input_length is not used by the decode stream
        )
        try:
            if self.text:
                count = self._decoder.decode_to_file(reader, os.path.join(outdir, "text"), batch_size=self.batch_size)
            else:
                ark = os.path.join(outdir, "likelihoods.ark")
                if os.path.isfile(ark):
                    os.remove(ark)
                with ArkWriter(os.path.join(outdir, "feats.scp"), ark) as writer:
                    count = self._decoder.decode_to_writer(reader, writer, batch_size=self.batch_size)
        finally:
            reader.close()
        with open(os.path.join(outdir, "DONE"), "w") as f:
            f.write(f"{count}\n")
        log.info("job %s: decoded %d utterances", name, count)
        return count

    def process_pending(self) -> int:
        """One spool sweep; returns the number of jobs processed. A failing
        job is quarantined instead of stopping the service."""
        done = 0
        for name in self._pending_jobs():
            try:
                self.process_job(name)
                done += 1
            except Exception:  # service boundary: record, quarantine, go on
                log.exception("job %s failed; quarantining", name)
                outdir = os.path.join(self.out_dir, name)
                os.makedirs(outdir, exist_ok=True)
                with open(os.path.join(outdir, "FAILED"), "w") as f:
                    f.write(traceback.format_exc())
        return done

    def run(self, poll_seconds: float = 1.0, stop=lambda: False) -> None:
        """Poll the spool until ``stop()`` returns True."""
        log.info("decode service watching %s", self.watch_dir)
        while not stop():
            if self.process_pending() == 0:
                time.sleep(poll_seconds)


def global_cmvn(featdir: str) -> np.ndarray:
    """The corpus-global CMVN stats: the sum of a featdir's per-speaker
    stats (``cmvn.scp``, Kaldi's ``[2, dim+1]`` layout). Live streams have
    no speaker statistics, so streaming serving normalises with the
    training corpus' pooled stats."""
    total = None
    with ArkReader(os.path.join(featdir, "cmvn.scp")) as reader:
        for speaker in list(reader.utt_ids):
            stats = np.asarray(reader.read_utt(speaker), np.float64)
            total = stats if total is None else total + stats
    if total is None:
        raise ValueError(f"no CMVN stats in {featdir}/cmvn.scp")
    return total


def build_streaming_transcriber(nnet, coder, samplerate: int, features_conf: dict, *, cmvn: np.ndarray | None = None,
                                beam_width: int | None = None, endpoint_config=None):
    """The streaming transcriber a trained config describes, its weights
    (``final.pt``) loaded once onto ``nnet.device``: the fused online
    front-end for ``dynamic = nodelta`` (the CMVN folded into its call), the
    lookahead-buffering ``OnlineDynamicExtractor`` for delta and ddelta
    (host features, CMVN'd by the transcriber on the model's device), then
    ``StreamingTranscriber`` for ``loss = ctc`` or
    ``StreamingTransducerTranscriber`` for ``loss = rnnt``, greedy or the
    beam of ``beam_width`` (default ``[nnet] beam_width``) fused with
    ``lm_path``. The CTC beam fuses through a ``FusionScorer`` over
    ``alphabet + ["<blank>"]``, as the offline CTC decode does (the JAX
    function hands the CTC beam a ``DenseFusionTable``, which its beam step
    cannot call); the transducer beam through a ``DenseFusionTable``.
    Spliced inputs (``context_width`` > 0) and the hybrid and attention
    recipes raise, as in the JAX package."""
    from tfkaldi_tpu_torch.decode.lm import ctc_scorer_from_config, fusion_from_config
    from tfkaldi_tpu_torch.decode.online import StreamingTranscriber
    from tfkaldi_tpu_torch.decode.transducer import StreamingTransducerTranscriber
    from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
    from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor, OnlineDynamicExtractor

    if nnet.loss_type not in ("ctc", "rnnt"):
        raise ValueError(f"loss_type {nnet.loss_type!r} has no streaming transcriber (hybrid/attention decoding "
                         "needs the full utterance; use the spool DecodeService)")
    if nnet.context_width:
        raise ValueError(f"[nnet] context_width = {nnet.context_width}: the model takes frames spliced with "
                         f"±{nnet.context_width} neighbours, and the streaming transcribers feed unspliced frames; "
                         "a model that streams is trained with context_width = 0")
    if nnet.loss_type == "rnnt" and endpoint_config is not None:
        raise ValueError("endpointing rides the CTC blank stream; the transducer transcriber does not support "
                         "endpoint_config")
    opts = FeatureOpts.from_config(features_conf)
    ext = FeatureExtractor(opts, samplerate, nnet.device)
    online_ext = FusedOnlineFeatureExtractor(ext) if opts.dynamic == "nodelta" else OnlineDynamicExtractor(ext)
    model = nnet._load_model()
    conf = nnet.conf
    if beam_width is None:
        beam_width = int(conf.get("beam_width", 1))
    if nnet.loss_type == "ctc":
        scorer = ctc_scorer_from_config(conf, coder, beam_width) if beam_width > 1 else None
        return StreamingTranscriber(online_ext, model, coder, nnet.blank_id, cmvn=cmvn, beam_width=beam_width,
                                    fusion_scorer=scorer, endpoint_config=endpoint_config)
    table = fusion_from_config(conf, coder, list(coder.alphabet), beam_width) if beam_width > 1 else None
    return StreamingTransducerTranscriber(online_ext, model, coder, cmvn=cmvn, beam_width=beam_width,
                                          fusion_table=table,
                                          max_symbols_per_frame=int(conf.get("max_symbols_per_frame", 4)))


# ----------------------------------------------------------------------
# streaming service: the wire protocol (serve.py:313-378)
# ----------------------------------------------------------------------

MSG_AUDIO = b"A"  # client -> server: float32 LE PCM samples
MSG_FINISH = b"F"  # client -> server: end of utterance
MSG_PARTIAL = b"P"  # server -> client: partial transcript (UTF-8)
MSG_FINAL = b"T"  # server -> client: final transcript (UTF-8)
MSG_ERROR = b"E"  # server -> client: error text (UTF-8), then close
MSG_TIMES_REQ = b"S"  # client -> server: request committed-label timestamps
MSG_TIMES = b"M"  # server -> client: float64 LE seconds, one per label
MSG_CONF_REQ = b"C"  # client -> server: request committed-label confidences
MSG_CONF = b"c"  # server -> client: float64 LE posteriors, one per label
MSG_WORDS_REQ = b"W"  # client -> server: request word alignments
MSG_WORDS = b"J"  # server -> client: UTF-8 JSON [{word,start,end,confidence}]

_HDR = 5  # 1-byte type + 4-byte big-endian payload length

#: alignment requests a transcriber answers at any time (greedy: the
#: committed alignment; beam: the current best hypothesis' backtrace)
_ALIGN_REQS = (MSG_TIMES_REQ, MSG_CONF_REQ, MSG_WORDS_REQ)


def _alignment_reply(tx, row: int, mtype: bytes) -> tuple[bytes, bytes]:
    """Answer one alignment request for one transcriber row."""
    if mtype == MSG_TIMES_REQ:
        return MSG_TIMES, np.ascontiguousarray(tx.timestamps()[row], "<f8").tobytes()
    if mtype == MSG_CONF_REQ:
        return MSG_CONF, np.ascontiguousarray(tx.confidences()[row], "<f8").tobytes()
    return MSG_WORDS, json.dumps([dataclasses.asdict(w) for w in tx.words()[row]]).encode()


def _send_msg(sock, mtype: bytes, payload: bytes) -> None:
    sock.sendall(mtype + struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def _recv_msg(sock, max_payload: int = 1 << 26):
    hdr = _recv_exact(sock, _HDR)
    if hdr is None:
        return None, None
    (length,) = struct.unpack(">I", hdr[1:])
    if length > max_payload:
        raise ValueError(f"oversized message: {length} bytes")
    return hdr[:1], _recv_exact(sock, length) if length else b""


def _drain(box) -> None:
    try:
        while True:
            box.get_nowait()
    except queue.Empty:
        pass


def _listen(host: str, port: int):
    sock = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
    sock.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen()
    return sock


def _accept_loop(server, stop, poll_seconds: float) -> None:
    """Accept until ``stop()`` or ``close()``; one thread a connection."""
    server._sock.settimeout(poll_seconds)
    while not (stop() or server._closing):
        try:
            conn, _ = server._sock.accept()
        except TimeoutError:
            continue
        except OSError:
            return  # closed
        threading.Thread(target=server._handle, args=(conn,), daemon=True).start()


class StreamingServer:
    """Socket front-end over a pool of batch-1 transcribers: one TCP
    connection an utterance, float32 PCM chunks in, a partial transcript
    after every chunk, the final on finish. A connection checks a
    transcriber out for its utterance and returns it on close;
    ``pool_size`` bounds the concurrent utterances (further connections
    wait). Alignment requests (``S``, ``C``, ``W``) are answered at any
    point, also after the final."""

    def __init__(self, make_transcriber, *, host: str = "127.0.0.1", port: int = 0, pool_size: int = 1):
        self._pool: queue.Queue = queue.Queue()
        for _ in range(pool_size):
            self._pool.put(make_transcriber())
        self._sock = _listen(host, port)
        self.host, self.port = self._sock.getsockname()
        self._closing = False

    def _handle(self, conn) -> None:
        tx = self._pool.get()
        try:
            with torch.inference_mode():
                tx.reset(1)
                while True:
                    mtype, payload = _recv_msg(conn)
                    if mtype is None:  # the client hung up
                        return
                    if mtype == MSG_AUDIO:
                        samples = np.frombuffer(payload, dtype="<f4")
                        partial = tx.push(samples[None, :], np.asarray([len(samples)]))
                        _send_msg(conn, MSG_PARTIAL, partial[0].encode())
                    elif mtype == MSG_FINISH:
                        _send_msg(conn, MSG_FINAL, tx.finish()[0].encode())
                    elif mtype in _ALIGN_REQS:
                        _send_msg(conn, *_alignment_reply(tx, 0, mtype))
                    else:
                        raise ValueError(f"unknown message type {mtype!r}")
        except Exception as exc:  # the session's error goes to its client
            log.exception("streaming session failed")
            try:
                _send_msg(conn, MSG_ERROR, str(exc).encode())
            except OSError:
                pass
        finally:
            conn.close()
            self._pool.put(tx)  # reset(1) at the next checkout clears its state

    def serve_forever(self, stop=lambda: False, poll_seconds: float = 0.2) -> None:
        """Accept loop, one thread a connection; returns when ``stop()`` is
        True or ``close()`` was called."""
        _accept_loop(self, stop, poll_seconds)

    def close(self) -> None:
        self._closing = True
        self._sock.close()


def _request(sock, req: bytes, want: bytes) -> bytes:
    _send_msg(sock, req, b"")
    mtype, payload = _recv_msg(sock)
    if mtype == MSG_ERROR:
        raise RuntimeError(payload.decode())
    assert mtype == want, mtype
    return payload


def _send_audio(sock, samples: np.ndarray, chunk_size: int):
    """Send the chunks, yielding each partial; return the final: an early
    ``T`` in reply to a chunk (a server-side endpoint), else the reply to
    ``F``."""
    for pos in range(0, len(samples), chunk_size):
        _send_msg(sock, MSG_AUDIO, samples[pos: pos + chunk_size].tobytes())
        mtype, payload = _recv_msg(sock)
        if mtype == MSG_ERROR:
            raise RuntimeError(payload.decode())
        if mtype == MSG_FINAL:
            return payload.decode()
        assert mtype == MSG_PARTIAL, mtype
        yield payload.decode()
    return _request(sock, MSG_FINISH, MSG_FINAL).decode()


def stream_transcribe(host: str, port: int, samples: np.ndarray, chunk_size: int, *, timestamps: bool = False,
                      timeout: float | None = None):
    """Client: stream ``samples`` (float32 PCM) in chunks of ``chunk_size``;
    yields each partial transcript and returns the final (``yield from``, or
    ``StopIteration.value``), with ``timestamps=True`` ``(final, times)``.
    An early ``T`` in reply to a chunk (the server endpointed the
    utterance) ends the stream with that final. ``timeout`` (seconds) bounds
    every socket operation."""
    samples = np.ascontiguousarray(samples, dtype="<f4")
    with socketlib.create_connection((host, port), timeout=timeout) as sock:
        final = yield from _send_audio(sock, samples, chunk_size)
        if not timestamps:
            return final
        return final, np.frombuffer(_request(sock, MSG_TIMES_REQ, MSG_TIMES), "<f8")


def stream_words(host: str, port: int, samples: np.ndarray, chunk_size: int, *, timeout: float | None = None):
    """Client: stream an utterance, returns ``(final, words)``, ``words`` a
    list of ``WordAlignment(word, start, end, confidence)``; the partials
    are consumed here."""
    from tfkaldi_tpu_torch.decode.words import WordAlignment

    samples = np.ascontiguousarray(samples, dtype="<f4")
    with socketlib.create_connection((host, port), timeout=timeout) as sock:
        gen = _send_audio(sock, samples, chunk_size)
        while True:
            try:
                next(gen)
            except StopIteration as end:
                final = end.value
                break
        words = [WordAlignment(**w) for w in json.loads(_request(sock, MSG_WORDS_REQ, MSG_WORDS))]
    return final, words


class MultiStreamServer:
    """Batched streaming service: the connections share ONE transcriber of
    ``num_slots`` rows.

    A single engine thread owns the transcriber and runs the tick loop:
    re-arm freshly claimed slots (one batched ``reset_rows``), take at most
    one pending message a slot, ``push`` all gathered audio as one
    ``[num_slots, chunk_size]`` batch (idle rows ride along with length 0,
    which leaves their state as it was), then ``finish_rows`` the finishing
    slots in one call. Connection threads never touch the transcriber; they
    talk to the engine through per-slot queues, so the device state has one
    owner and needs no locks. The wire protocol is :class:`StreamingServer`'s
    (``stream_transcribe`` works unchanged), and a slot's transcript equals
    a batch-1 transcriber's on the same audio.

    A transcriber built with an ``endpoint_config`` has rows whose endpoint
    latched finished by the server: the client's next reply is an early
    ``T``. A chunk longer than ``chunk_size`` samples is refused (``E``);
    audio or a finish after a stream's final is a protocol error until the
    slot is claimed again.

    ``ticks`` counts the pushes and ``rows_pushed`` the rows with audio in
    them (the batch's occupancy); ``tick_durations`` keeps the last 4096
    ticks' seconds (push, endpoint finals and finishes).
    """

    #: the JAX package's CLI default
    DEFAULT_SLOTS = 16

    def __init__(self, transcriber, *, num_slots: int = DEFAULT_SLOTS, chunk_size: int = 1600,
                 host: str = "127.0.0.1", port: int = 0, tick_seconds: float = 0.002):
        self.tx = transcriber
        self.num_slots = int(num_slots)
        self.chunk_size = int(chunk_size)
        self._tick_seconds = float(tick_seconds)  # coalescing window after a tick
        with torch.inference_mode():
            self.tx.reset(self.num_slots)
        self._has_endpoint = getattr(transcriber, "_endpointer", None) is not None
        self._inbox = [queue.Queue() for _ in range(self.num_slots)]
        self._outbox = [queue.Queue() for _ in range(self.num_slots)]
        self._free: queue.Queue = queue.Queue()
        for s in range(self.num_slots):
            self._free.put(s)
        self._claims: queue.Queue = queue.Queue()
        # a connection feeds a freshly claimed slot only once the ENGINE has
        # re-armed it: a tick that already drained the claims would push the
        # new stream's first chunk through the old stream's state
        self._armed = [threading.Event() for _ in range(self.num_slots)]
        self._work = threading.Event()  # a claim or a message is pending
        # slots whose stream ended (finish, endpoint or a failed re-arm);
        # engine thread only
        self._finished: set[int] = set()
        self._closing = False
        self.ticks = 0
        self.rows_pushed = 0
        self.tick_durations: collections.deque = collections.deque(maxlen=4096)
        self._sock = _listen(host, port)
        self.host, self.port = self._sock.getsockname()
        self._engine = threading.Thread(target=self._engine_loop, daemon=True)
        self._engine.start()

    # -- the engine thread: sole owner of the transcriber ---------------

    def _engine_loop(self) -> None:
        with torch.inference_mode():  # grad mode is per thread
            while not self._closing:
                if not self._work.wait(timeout=0.1):
                    continue
                self._work.clear()
                self._rearm_claims()
                audio_rows: dict[int, np.ndarray] = {}
                finish_slots: list[int] = []
                align_reqs: list[tuple[int, bytes]] = []
                for s in range(self.num_slots):
                    try:
                        mtype, samples = self._inbox[s].get_nowait()
                    except queue.Empty:
                        continue
                    if s in self._finished and mtype not in _ALIGN_REQS:
                        # pushing audio through a finished row would re-flush stale state
                        self._outbox[s].put((MSG_ERROR, "stream already finished (alignment requests only until "
                                                        "the slot is re-claimed)"))
                    elif mtype == MSG_AUDIO:
                        audio_rows[s] = samples
                    elif mtype in _ALIGN_REQS:
                        align_reqs.append((s, mtype))
                    else:
                        finish_slots.append(s)
                if not audio_rows and not finish_slots and not align_reqs:
                    continue
                try:
                    self._tick(audio_rows, finish_slots, align_reqs)
                except Exception as exc:  # fail the tick's streams, not the engine
                    log.exception("engine tick failed")
                    for s in list(audio_rows) + finish_slots + [s for s, _ in align_reqs]:
                        self._outbox[s].put((MSG_ERROR, str(exc)))
                if self._tick_seconds:  # let concurrent clients' next chunks land together
                    time.sleep(self._tick_seconds)
                self._work.set()  # look at the inboxes once more before waiting

    def _rearm_claims(self) -> None:
        """Re-arm the freshly claimed slots in one batched call; a dead
        connection's stale messages are drained here, on the sole consumer.
        A failure fails the claimed slots, not the engine."""
        claimed = []
        while True:
            try:
                claimed.append(self._claims.get_nowait())
            except queue.Empty:
                break
        if not claimed:
            return
        for s in claimed:
            _drain(self._inbox[s])
            _drain(self._outbox[s])
        try:
            self.tx.reset_rows(claimed)
            self._finished.difference_update(claimed)
        except Exception as exc:
            log.exception("slot re-arm failed")
            for s in claimed:
                self._outbox[s].put((MSG_ERROR, str(exc)))
                self._finished.add(s)  # refuse audio until claimed again
        finally:
            for s in claimed:
                self._armed[s].set()

    def _tick(self, audio_rows, finish_slots, align_reqs=()) -> None:
        t0 = time.perf_counter()
        if audio_rows:
            chunk = np.zeros((self.num_slots, self.chunk_size), np.float32)
            lengths = np.zeros((self.num_slots,), np.int64)
            for s, samples in audio_rows.items():
                chunk[s, : len(samples)] = samples
                lengths[s] = len(samples)
            partials = self.tx.push(chunk, lengths)
            self.ticks += 1
            self.rows_pushed += len(audio_rows)
            endpointed = self.tx.endpointed() if self._has_endpoint else None
            ep_rows = [s for s in audio_rows if endpointed is not None and bool(endpointed[s])]
            if ep_rows:
                finals = self.tx.finish_rows(ep_rows)
                self._finished.update(ep_rows)
                for s in ep_rows:
                    self._outbox[s].put((MSG_FINAL, finals[s]))
            for s in audio_rows:
                if s not in ep_rows:
                    self._outbox[s].put((MSG_PARTIAL, partials[s]))
        if finish_slots:
            finals = self.tx.finish_rows(finish_slots)
            self._finished.update(finish_slots)
            for s in finish_slots:
                self._outbox[s].put((MSG_FINAL, finals[s]))
        if audio_rows or finish_slots:
            self.tick_durations.append(time.perf_counter() - t0)
        # a slot's alignment stays readable after finish_rows, until the next claim re-arms it
        for s, mtype in align_reqs:
            try:
                self._outbox[s].put(_alignment_reply(self.tx, s, mtype))
            except RuntimeError as exc:
                self._outbox[s].put((MSG_ERROR, str(exc)))

    # -- connection threads ----------------------------------------------

    def _handle(self, conn) -> None:
        slot = self._free.get()
        self._armed[slot].clear()
        self._claims.put(slot)
        self._work.set()
        self._armed[slot].wait()
        try:
            while True:
                mtype, payload = _recv_msg(conn)
                if mtype is None:  # the client hung up
                    return
                if mtype == MSG_AUDIO:
                    samples = np.frombuffer(payload, dtype="<f4")
                    if len(samples) > self.chunk_size:
                        raise ValueError(f"chunk of {len(samples)} samples exceeds the server chunk_size "
                                         f"{self.chunk_size}")
                    self._inbox[slot].put((MSG_AUDIO, samples))
                elif mtype == MSG_FINISH or mtype in _ALIGN_REQS:
                    self._inbox[slot].put((mtype, None))
                else:
                    raise ValueError(f"unknown message type {mtype!r}")
                self._work.set()
                rtype, data = self._outbox[slot].get()
                if rtype == MSG_ERROR:
                    raise RuntimeError(data)
                _send_msg(conn, rtype, data if isinstance(data, bytes) else data.encode())
        except Exception as exc:  # the session's error goes to its client
            log.exception("multi-stream session failed")
            try:
                _send_msg(conn, MSG_ERROR, str(exc).encode())
            except OSError:
                pass
        finally:
            conn.close()
            # early clean-up of a mid-stream hang-up's traffic, both ways (the
            # engine drains both again when the slot is next claimed)
            _drain(self._inbox[slot])
            _drain(self._outbox[slot])
            self._free.put(slot)

    def serve_forever(self, stop=lambda: False, poll_seconds: float = 0.2) -> None:
        """Accept loop, one thread a connection; returns when ``stop()`` is
        True or ``close()`` was called."""
        _accept_loop(self, stop, poll_seconds)

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting, stop the engine thread (joined within
        ``timeout`` seconds) and close the socket."""
        self._closing = True
        self._work.set()
        self._sock.close()
        self._engine.join(timeout)
