"""The port's streaming servers and ``cli.serve --stream``, on the CPU,
against its batch-1 transcribers and the JAX package.

Twins of tests/test_serve.py's streaming cases, test_multistream_server.py,
test_serve_stream_cli.py and (at the socket) test_timestamps.py /
test_words_confidence.py, on 127.0.0.1 port 0. The models are the small
seeded ones of tests/test_torch_online_decode.py (a 1 x 16 GRU CTC, a
2-block conformer-s2 transducer), weights converted from JAX.

- ``StreamingServer`` and ``MultiStreamServer``: every final equals a
  batch-1 transcriber's on the same audio and chunks, and JAX's
  ``StreamingTranscriber`` on the same weights; JAX's own clients
  (``tfkaldi_tpu.serve.stream_transcribe`` / ``stream_words``) get the same
  finals, timestamps and words as the port's, so the wire protocol is the
  JAX package's byte for byte;
- the engine batches (``rows_pushed`` is the chunk count, ``ticks`` at most
  that), slots are reused, an oversized chunk, an unknown message, audio
  after a final (the client's finish or an endpoint) are ``E`` replies, and
  a failed re-arm fails one client while the engine lives on;
- ``cli.serve --stream --device cpu`` on a CTC config with ``final.pt``
  serves concurrent clients the finals of ``build_streaming_transcriber``
  and of JAX's transcriber with the same pooled CMVN;
  ``build_streaming_transcriber`` refuses a hybrid config, streams a delta
  front-end through ``OnlineDynamicExtractor`` as JAX's transcriber does,
  and builds the beam transducer for ``beam_width > 1``.

Every socket has a timeout (SOCKET_TIMEOUT), every server is closed in a
``finally`` and every join is bounded, so a hang fails instead of running
out the suite's clock.
"""

import os
import socket as socketlib
import threading
import time
from configparser import ConfigParser

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.synthetic import make_featdir
from tests.test_torch_online_decode import BLANK, CODER, _ext, _jext, ctc_model, transducer_model
from tests.test_torch_online_dynamic import _delta_gru
from tfkaldi_tpu import serve as jax_serve
from tfkaldi_tpu.decode.online import StreamingTranscriber as JaxStreamingTranscriber
from tfkaldi_tpu.frontend import FeatureExtractor as JaxFeatureExtractor
from tfkaldi_tpu.frontend import FeatureOpts as JaxFeatureOpts
from tfkaldi_tpu.frontend.online import OnlineDynamicExtractor as JaxDynamic
from tfkaldi_tpu.frontend.online import OnlineFeatureExtractor as JaxOnline
from tfkaldi_tpu_torch.cli import serve as cli_serve
from tfkaldi_tpu_torch.convert import rnn_from_jax, save_checkpoint
from tfkaldi_tpu_torch.decode.endpoint import EndpointConfig, EndpointRule
from tfkaldi_tpu_torch.decode.online import StreamingTranscriber
from tfkaldi_tpu_torch.decode.transducer import StreamingTransducerTranscriber
from tfkaldi_tpu_torch.frontend.cmvn import cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor, OnlineDynamicExtractor, OnlineFeatureExtractor
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.serve import (MSG_AUDIO, MSG_CONF, MSG_CONF_REQ, MSG_ERROR, MSG_FINAL, MSG_FINISH, MSG_TIMES,
                                     MSG_TIMES_REQ,
                                     MultiStreamServer, StreamingServer, _recv_msg, _send_msg,
                                     build_streaming_transcriber, global_cmvn, stream_transcribe, stream_words)

RATE = 8000
CHUNK = 1000
SOCKET_TIMEOUT = 60.0
JOIN = 120.0
CONF_TOL = 1e-5  # a shared batch's products may round otherwise than batch-1's (GEMM against GEMV)


@pytest.fixture(autouse=True)
def _socket_timeouts():
    """Sockets made without a timeout (JAX's clients, the servers' accepted
    connections) get SOCKET_TIMEOUT too."""
    old = socketlib.getdefaulttimeout()
    socketlib.setdefaulttimeout(SOCKET_TIMEOUT)
    yield
    socketlib.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def gru():
    return ctc_model("gru", seed=4)


def _audios(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(n)) * 300).astype(np.float32) for n in lengths]


def _ctc_tx(model, fused=False, **kw):
    ext = FusedOnlineFeatureExtractor(_ext()) if fused else OnlineFeatureExtractor(_ext())
    return StreamingTranscriber(ext, model, CODER, BLANK, **kw)


def _batch1(tx, audio, chunk=CHUNK):
    tx.reset(1)
    for pos in range(0, len(audio), chunk):
        c = audio[pos: pos + chunk][None, :]
        tx.push(c, np.asarray([c.shape[1]]))
    final = tx.finish()[0]
    return final, tx.timestamps()[0]


def _collect(client, host, port, audio, chunk=CHUNK, **kw):
    gen = client(host, port, audio, chunk, **kw)
    partials = []
    while True:
        try:
            partials.append(next(gen))
        except StopIteration as stop:
            return partials, stop.value


class _Serving:
    """A server's accept loop in a thread, closed and joined on exit."""

    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self.server

    def __exit__(self, *exc):
        self.server.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _run_clients(fn, n):
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as exc:  # re-raised on the test's thread
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=JOIN)
    assert not any(th.is_alive() for th in threads), "a client hung"
    assert not errors, errors
    return results


def test_streaming_server_matches_batch1_and_jax(gru):
    """Two pooled transcribers: the port's client and JAX's client get the
    batch-1 finals and timestamps, which equal JAX's transcriber's."""
    jm, params, state, model = gru
    audios = _audios(1, [5200, 3700])
    expected = [_batch1(_ctc_tx(model), a) for a in audios]
    for a, (final, times) in zip(audios, expected):
        jfinal, jtimes = _batch1(JaxStreamingTranscriber(JaxOnline(_jext()), jm, params, state, CODER, BLANK), a)
        assert final == jfinal and final
        np.testing.assert_array_equal(times, jtimes)
    with _Serving(StreamingServer(lambda: _ctc_tx(model, fused=True), pool_size=2)) as server:
        for client in (stream_transcribe, jax_serve.stream_transcribe):
            got = _run_clients(lambda i: _collect(client, server.host, server.port, audios[i], timestamps=True), 2)
            for (partials, (final, times)), a, (want, want_times) in zip(got, audios, expected):
                assert len(partials) == -(-len(a) // CHUNK)
                assert final == want
                np.testing.assert_array_equal(times, want_times)


def test_streaming_server_reports_errors(gru):
    """An unknown message type gets ``E``; the pooled transcriber serves
    the next session."""
    model = gru[3]
    with _Serving(StreamingServer(lambda: _ctc_tx(model), pool_size=1)) as server:
        with socketlib.create_connection((server.host, server.port), timeout=SOCKET_TIMEOUT) as sock:
            _send_msg(sock, b"Z", b"junk")
            mtype, payload = _recv_msg(sock)
            assert mtype == MSG_ERROR and b"unknown message type" in payload
        _, final = _collect(stream_transcribe, server.host, server.port, np.zeros(4000, np.float32))
        assert isinstance(final, str)


def test_multistream_concurrent_clients_match_batch1(gru):
    """5 concurrent clients through 3 slots (slots reused): every final
    equals the batch-1 run, with the port's and with JAX's client; the
    engine batched rows."""
    model = gru[3]
    rng = np.random.default_rng(5)
    audios = _audios(5, rng.integers(3000, 9000, size=5))
    expected = [_batch1(_ctc_tx(model), a)[0] for a in audios]
    server = MultiStreamServer(_ctc_tx(model, fused=True), num_slots=3, chunk_size=CHUNK)
    with _Serving(server):
        for client in (stream_transcribe, jax_serve.stream_transcribe):
            got = _run_clients(lambda i: _collect(client, server.host, server.port, audios[i])[1], 5)
            assert got == expected
    total_chunks = sum(-(-len(a) // CHUNK) for a in audios)
    assert server.rows_pushed == 2 * total_chunks
    assert 0 < server.ticks <= 2 * total_chunks
    assert 0 < len(server.tick_durations) <= server.ticks + 10


def test_multistream_sequential_slot_reuse_and_oversized_chunk(gru):
    """One slot: a chunk over ``chunk_size`` is refused and the slot freed;
    two sequential sessions each get the batch-1 final (the re-armed slot
    keeps nothing of the last stream)."""
    model = gru[3]
    audio = _audios(9, [5000])[0]
    expected = _batch1(_ctc_tx(model), audio)[0]
    with _Serving(MultiStreamServer(_ctc_tx(model), num_slots=1, chunk_size=CHUNK)) as server:
        with pytest.raises(RuntimeError, match="chunk_size"):
            next(stream_transcribe(server.host, server.port, np.zeros(2 * CHUNK, np.float32), 2 * CHUNK,
                                   timeout=SOCKET_TIMEOUT))
        for _ in range(2):
            partials, final = _collect(stream_transcribe, server.host, server.port, audio, timeout=SOCKET_TIMEOUT)
            assert len(partials) == -(-len(audio) // CHUNK)
            assert final == expected


@pytest.mark.parametrize("beam", [1, 4])
def test_multistream_transducer(beam):
    """The conformer-s2 transducer through the shared batch: concurrent
    finals and timestamps equal batch-1 runs, greedy and beam."""
    model = transducer_model("conformer", seed=3)[3]

    def make():
        return StreamingTransducerTranscriber(OnlineFeatureExtractor(_ext()), model, CODER, beam_width=beam,
                                              max_tokens=64)

    audios = _audios(23, [3500, 5200])
    expected = [_batch1(make(), a) for a in audios]
    assert any(f for f, _ in expected)
    with _Serving(MultiStreamServer(make(), num_slots=2, chunk_size=CHUNK)) as server:
        got = _run_clients(lambda i: _collect(stream_transcribe, server.host, server.port, audios[i],
                                              timestamps=True, timeout=SOCKET_TIMEOUT)[1], 2)
    for (final, times), (want, want_times) in zip(got, expected):
        assert final == want
        np.testing.assert_array_equal(times, want_times)


def test_multistream_endpoint_early_final_and_audio_after_final(gru):
    """A max-length endpoint rule finishes the stream server-side: an early
    ``T`` (fewer partials than chunks), the same again on the re-armed slot;
    a client that keeps sending audio after that ``T`` gets ``E``."""
    model = gru[3]
    audio = _audios(13, [8000])[0]
    cfg = EndpointConfig(rules=(EndpointRule(False, 0.0, 0.2),))
    with _Serving(MultiStreamServer(_ctc_tx(model, endpoint_config=cfg), num_slots=2, chunk_size=CHUNK)) as server:
        partials, final = _collect(stream_transcribe, server.host, server.port, audio, timeout=SOCKET_TIMEOUT)
        assert len(partials) < -(-len(audio) // CHUNK)
        assert isinstance(final, str) and final
        assert _collect(stream_transcribe, server.host, server.port, audio, timeout=SOCKET_TIMEOUT) == (
            partials, final)
        with socketlib.create_connection((server.host, server.port), timeout=SOCKET_TIMEOUT) as sock:
            saw_final = False
            for pos in range(0, len(audio), CHUNK):
                _send_msg(sock, MSG_AUDIO, audio[pos: pos + CHUNK].tobytes())
                mtype, payload = _recv_msg(sock)
                if saw_final:
                    assert mtype == MSG_ERROR and b"finished" in payload
                    break
                assert mtype != MSG_ERROR
                saw_final = mtype == MSG_FINAL
            assert saw_final


def test_multistream_audio_after_finish_is_protocol_error(gru):
    """After ``T`` a timestamps request is still answered, more audio is an
    ``E``; the slot then serves a well-behaved session."""
    model = gru[3]
    rng = np.random.default_rng(31)
    audio = rng.standard_normal(CHUNK).astype(np.float32)
    with _Serving(MultiStreamServer(_ctc_tx(model), num_slots=1, chunk_size=CHUNK)) as server:
        with socketlib.create_connection((server.host, server.port), timeout=SOCKET_TIMEOUT) as sock:
            _send_msg(sock, MSG_AUDIO, audio.tobytes())
            assert _recv_msg(sock)[0] != MSG_ERROR
            _send_msg(sock, MSG_FINISH, b"")
            assert _recv_msg(sock)[0] == MSG_FINAL
            _send_msg(sock, MSG_TIMES_REQ, b"")
            assert _recv_msg(sock)[0] == MSG_TIMES
            _send_msg(sock, MSG_AUDIO, audio.tobytes())
            mtype, payload = _recv_msg(sock)
            assert mtype == MSG_ERROR and b"finished" in payload
        good = _audios(32, [3000])[0]
        assert _collect(stream_transcribe, server.host, server.port, good)[1] == _batch1(_ctc_tx(model), good)[0]


def test_multistream_engine_survives_rearm_failure(gru):
    """A ``reset_rows`` that raises at claim time fails that client with
    ``E``; the next claim re-arms the slot and streams normally."""
    model = gru[3]
    audio = _audios(41, [3000])[0]
    expected = _batch1(_ctc_tx(model), audio)[0]

    class _FlakyRearm:
        def __init__(self, inner):
            self._inner, self._fails = inner, 1

        def reset_rows(self, rows):
            if self._fails:
                self._fails -= 1
                raise RuntimeError("injected re-arm failure")
            return self._inner.reset_rows(rows)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    with _Serving(MultiStreamServer(_FlakyRearm(_ctc_tx(model)), num_slots=1, chunk_size=CHUNK)) as server:
        with pytest.raises(RuntimeError, match="injected re-arm failure"):
            _collect(stream_transcribe, server.host, server.port, audio)
        assert _collect(stream_transcribe, server.host, server.port, audio)[1] == expected


@pytest.mark.parametrize("beam", [1, 4])
def test_alignments_over_socket(gru, beam):
    """Timestamps and words over both servers equal the batch-1
    transcriber's, the confidences within CONF_TOL; JAX's ``stream_words``
    reads the same words as the port's."""
    model = gru[3]
    audios = _audios(51, [6000, 4500])
    want = []
    for a in audios:
        tx = _ctc_tx(model, beam_width=beam)
        final, times = _batch1(tx, a)
        want.append((final, times, tx.confidences()[0], tx.words()[0]))
    for server in (StreamingServer(lambda: _ctc_tx(model, beam_width=beam), pool_size=2),
                   MultiStreamServer(_ctc_tx(model, beam_width=beam), num_slots=2, chunk_size=CHUNK)):
        with _Serving(server):
            for client in (stream_words, jax_serve.stream_words):
                got = _run_clients(lambda i: client(server.host, server.port, audios[i], CHUNK), 2)
                for (final, words), (w_final, _, _, w_words) in zip(got, want):
                    assert final == w_final
                    assert [(w.word, w.start, w.end) for w in words] == [(w.word, w.start, w.end) for w in w_words]
                    np.testing.assert_allclose([w.confidence for w in words], [w.confidence for w in w_words],
                                               rtol=0, atol=CONF_TOL)
            with socketlib.create_connection((server.host, server.port), timeout=SOCKET_TIMEOUT) as sock:
                for pos in range(0, len(audios[0]), CHUNK):
                    _send_msg(sock, MSG_AUDIO, audios[0][pos: pos + CHUNK].tobytes())
                    _recv_msg(sock)
                _send_msg(sock, MSG_FINISH, b"")
                assert _recv_msg(sock)[0] == MSG_FINAL
                _send_msg(sock, MSG_TIMES_REQ, b"")
                mtype, payload = _recv_msg(sock)
                assert mtype == MSG_TIMES
                np.testing.assert_array_equal(np.frombuffer(payload, "<f8"), want[0][1])
                _send_msg(sock, MSG_CONF_REQ, b"")
                mtype, payload = _recv_msg(sock)
                assert mtype == MSG_CONF
                np.testing.assert_allclose(np.frombuffer(payload, "<f8"), want[0][2], rtol=0, atol=CONF_TOL)


@pytest.fixture(scope="module")
def ctc_config(tmp_path_factory, gru):
    """A featdir and a streaming CTC GRU config with the converted weights
    as ``final.pt``."""
    tmp = tmp_path_factory.mktemp("stream_cli")
    featdir, _, _ = make_featdir(tmp, feat_dim=10)
    cfg_path = str(tmp / "stream.cfg")
    with open(cfg_path, "w") as f:
        f.write(f"""[directories]
expdir = {tmp}/exp
train_features = {os.path.dirname(featdir)}

[dnn-features]
name = {os.path.basename(featdir)}
type = fbank
dynamic = nodelta
nfilt = 10
nfft = 256

[nnet]
name = streamnet
model = gru
loss = ctc
normalizer = aurora4
context_width = 0
num_hidden_layers = 1
num_hidden_units = 16
bidirectional = False
""")
    config = ConfigParser()
    config.read(cfg_path)
    net = Nnet(config, 10, CODER.num_labels, device="cpu")
    jm, params, _, _ = gru
    save_checkpoint(net.savedir, rnn_from_jax(params))
    return cfg_path, featdir, config, net


def test_stream_cli_serves_concurrent_clients(ctc_config, gru, tmp_path):
    """``cli.serve --stream --device cpu`` with 2 slots: three concurrent
    clients get the finals of ``build_streaming_transcriber`` and of JAX's
    transcriber on the same weights and pooled CMVN."""
    cfg_path, featdir, config, net = ctc_config
    jm, params, state, _ = gru
    port_file = tmp_path / "port"
    stopping = threading.Event()
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli_serve.main(
        ["--config", cfg_path, "--stream", "--slots", "2", "--chunk-size", "800", "--rate", str(RATE),
         "--port-file", str(port_file), "--device", "cpu"], stop=stopping.is_set)), daemon=True)
    t.start()
    try:
        deadline = time.time() + 60
        while not port_file.exists() and time.time() < deadline and t.is_alive():
            time.sleep(0.05)
        assert port_file.exists(), "the server never wrote its port file"
        host, port = port_file.read_text().split()
        audios = _audios(17, [4000, 6500, 3000])
        stats = global_cmvn(featdir)
        np.testing.assert_array_equal(stats, jax_serve.global_cmvn(featdir))
        expected = []
        for a in audios:
            tx = build_streaming_transcriber(net, CODER, RATE, dict(config["dnn-features"]), cmvn=stats)
            final = _batch1(tx, a, 800)[0]
            jtx = JaxStreamingTranscriber(JaxOnline(_jext()), jm, params, state, CODER, BLANK, cmvn=stats)
            assert final == _batch1(jtx, a, 800)[0]
            expected.append(final)
        got = _run_clients(lambda i: _collect(stream_transcribe, host, int(port), audios[i], 800,
                                              timeout=SOCKET_TIMEOUT)[1], 3)
        assert got == expected
    finally:
        stopping.set()
        t.join(timeout=JOIN)
    assert rc == [0]


def test_build_streaming_transcriber_rules(ctc_config, tmp_path):
    """A hybrid config has no streaming transcriber; a delta front-end
    streams through ``OnlineDynamicExtractor`` and gives JAX's transcriber's
    final and timestamps on the same weights, audio and CMVN; a spliced
    input (``context_width`` > 0) is refused by name; and ``beam_width > 1``
    on an RNN-T config builds the beam transducer transcriber."""
    _, featdir, config, net = ctc_config
    feats = dict(config["dnn-features"])
    hybrid = ConfigParser()
    hybrid["directories"] = {"expdir": str(tmp_path / "exp")}
    hybrid["nnet"] = {"name": "hyb", "context_width": "0", "num_hidden_layers": "1", "num_hidden_units": "8"}
    with pytest.raises(ValueError, match="streaming"):
        build_streaming_transcriber(Nnet(hybrid, 10, 5, device="cpu"), CODER, RATE, feats)
    dcfg = ConfigParser()
    dcfg.read_dict({**config, "directories": {**config["directories"], "expdir": str(tmp_path / "exp_delta")}})
    dnet = Nnet(dcfg, 20, CODER.num_labels, device="cpu")
    jm, params, state, _ = _delta_gru()
    save_checkpoint(dnet.savedir, rnn_from_jax(params))
    delta_feats = {**feats, "dynamic": "delta"}
    audio = _audios(9, [5000])[0]
    delta_ext = FeatureExtractor(FeatureOpts.from_config(delta_feats), RATE, "cpu")
    cmvn = cmvn_stats(delta_ext.compute(audio))
    tx = build_streaming_transcriber(dnet, CODER, RATE, delta_feats, cmvn=cmvn)
    assert isinstance(tx.extractor, OnlineDynamicExtractor) and tx.cmvn is not None
    jext = JaxFeatureExtractor(JaxFeatureOpts.from_config(delta_feats), RATE, spectrum_precision="high")
    jtx = JaxStreamingTranscriber(JaxDynamic(jext), jm, params, state, CODER, BLANK, cmvn=cmvn)
    final, times = _batch1(tx, audio, 800)
    jfinal, jtimes = _batch1(jtx, audio, 800)
    assert final == jfinal
    np.testing.assert_array_equal(times, jtimes)
    spliced = ConfigParser()
    spliced.read_dict({**config, "nnet": {**config["nnet"], "context_width": "2"}})
    with pytest.raises(ValueError, match="context_width = 2: .* unspliced"):
        build_streaming_transcriber(Nnet(spliced, 10, CODER.num_labels, device="cpu"), CODER, RATE, feats)
    rcfg = ConfigParser()
    rcfg["directories"] = {"expdir": str(tmp_path / "exp")}
    rcfg["nnet"] = {"name": "rnnt_beam", "model": "transducer", "loss": "rnnt", "context_width": "0",
                    "enc_type": "gru", "num_hidden_layers": "1", "num_hidden_units": "12", "bidirectional": "False",
                    "pred_layers": "1", "pred_units": "8", "embed_dim": "4", "joint_units": "12", "beam_width": "4"}
    rnet = Nnet(rcfg, 10, CODER.num_labels, device="cpu")
    rnet.model.reset_parameters(torch.Generator().manual_seed(3))
    save_checkpoint(rnet.savedir, rnet.model.state_dict())
    tx = build_streaming_transcriber(rnet, CODER, RATE, feats)
    assert isinstance(tx, StreamingTransducerTranscriber) and tx.beam_width == 4
    audio = _audios(7, [4000])[0]
    final, times = _batch1(tx, audio, 800)
    direct = StreamingTransducerTranscriber(OnlineFeatureExtractor(_ext()), rnet.model, CODER, beam_width=4)
    want, want_times = _batch1(direct, audio, 800)
    assert final == want
    np.testing.assert_array_equal(times, want_times)
