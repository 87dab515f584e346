"""The streaming path on the card: chunked against offline, in f32 with TF32
off (``device.resolve_device`` pins it).

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_streaming.py --noconftest -q -m cuda

- a causal conformer-s4 (2 x 64, left context 16, kernel 15) streamed in
  chunks of 1, 3 and 7 frames and whole, then flushed, equals its own
  offline forward on the card within TOL of max|offline| (the attention
  sums run over another key count);
- the transducer's greedy stream (``OnlineTransducerDecoder`` at 10-frame
  chunks) gives ``TransducerDecoder``'s ids and frames on the offline
  features of the same batch;
- the CTC ``StreamingTranscriber`` over the fused front-end (a 2 x 64
  unidirectional LSTM) gives the offline ``CTCDecoder``'s ids and frames
  (the offline forward runs kernel 4 with one direction) on the offline
  extractor's features (kernel 2) with the same f32 CMVN;
- the fused front-end's frames equal the offline extractor's within
  FEAT_TOL in ``err / max(|ref|, 1)`` (the f64 DFT products of other row
  counts may round otherwise; both are cast to f32).
"""

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode.ctc import CTCDecoder
from tfkaldi_tpu_torch.decode.online import StreamingTranscriber
from tfkaldi_tpu_torch.decode.transducer import OnlineTransducerDecoder, TransducerDecoder
from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor
from tfkaldi_tpu_torch.models import LSTM, RNNConfig, Transducer, TransducerConfig, Transformer, TransformerConfig

pytestmark = pytest.mark.cuda

TOL = 1e-5
FEAT_TOL = 1e-6
RATE = 16000
CODER = TextCoder(aurora4_normalizer)
BLANK = CODER.num_labels
ENC = dict(num_blocks=2, d_model=64, num_heads=4, ffn_dim=128, conformer=True, conv_kernel=15, left_context=16,
           right_context=0, causal_conv=True, subsample=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _seeded(model, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        for p in model.parameters():  # every leaf redrawn, the output layers too
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model.to(device).eval()


def _wavs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [np.round(rng.standard_normal(n) * 3000).astype(np.float32) for n in lengths]


def _offline_feats(ext, wavs, cmvn):
    batch = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    feats, n = ext(batch, np.asarray([len(w) for w in wavs]))
    return (feats if cmvn is None else apply_cmvn(feats, cmvn)), n


def test_conformer_chunked_equals_offline(cuda):
    model = _seeded(Transformer(TransformerConfig(input_dim=40, num_labels=36, **ENC)), 0, cuda)
    lengths = torch.tensor([61, 40, 17, 0], device=cuda)
    x = torch.randn(4, 61, 40, generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.no_grad():
        full = model(x, lengths)
        want = model.output_lengths(lengths).tolist()
        for chunk in (1, 3, 7, 61):
            carry, outs = model.init_stream_carry(4), [[] for _ in range(4)]
            for t0 in range(0, 61, chunk):
                v = (lengths - t0).clamp(0, chunk)
                n = model.stream_output_lengths(carry, v).tolist()
                y, carry = model.apply_stream(x[:, t0: t0 + chunk], v, carry)
                for i, k in enumerate(n):
                    outs[i].append(y[i, :k])
            y, n, carry = model.apply_stream_flush(carry)
            for i, k in enumerate(n.tolist()):
                outs[i].append(y[i, :k])
            for i, k in enumerate(want):
                got = torch.cat(outs[i])
                assert got.shape[0] == k
                if k:
                    err = (got - full[i, :k]).abs().max().item() / full.abs().max().item()
                    assert err <= TOL, (chunk, i, err)


def test_transducer_greedy_chunked_equals_offline(cuda):
    extra = tuple((k, str(v)) for k, v in (("num_blocks", 2), ("d_model", 64), ("num_heads", 4), ("ffn_dim", 128),
                                           ("conv_kernel", 15), ("subsample", 4), ("attention_left_context", 16),
                                           ("attention_right_context", 0), ("causal_conv", "True")))
    model = _seeded(Transducer(TransducerConfig(input_dim=40, num_labels=BLANK, enc_type="conformer", pred_units=64,
                                                embed_dim=16, joint_units=64, enc_extra=extra)), 2, cuda)
    lengths = np.asarray([83, 57, 30])
    x = torch.randn(3, 83, 40, generator=torch.Generator().manual_seed(3)).numpy()
    offline = TransducerDecoder(model, CODER)
    want = offline.decode_batch(x, lengths)
    assert any(len(w) for w in want)
    online = OnlineTransducerDecoder(model)
    online.reset(3)
    got, frames = [[] for _ in range(3)], [[] for _ in range(3)]
    for t0 in range(0, 83, 10):
        ids = online.step(x[:, t0: t0 + 10], np.clip(lengths - t0, 0, 10))
        for i in range(3):
            got[i] += ids[i].tolist()
            frames[i] += online.last_label_frames[i].tolist()
    ids = online.finish()
    for i in range(3):
        got[i] += ids[i].tolist()
        frames[i] += online.last_label_frames[i].tolist()
        assert got[i] == want[i].tolist()
        assert frames[i] == offline.last_label_frames[i].tolist()


def test_ctc_transcriber_and_fused_frontend_equal_offline(cuda):
    ext = FeatureExtractor(FeatureOpts(nfilt=40), RATE, cuda)
    wavs = _wavs(4, [40000, 27321, 16001])
    raw, n = _offline_feats(ext, wavs, None)
    cmvn = cmvn_stats(raw.cpu().numpy(), n)
    # the fused front-end alone, 1600-sample pushes
    fused = FusedOnlineFeatureExtractor(ext)
    fused.reset(3)
    rows = [[] for _ in wavs]
    for pos in range(0, 40000, 1600):
        chunk = np.zeros((3, 1600), np.float32)
        lens = np.zeros(3, np.int64)
        for i, w in enumerate(wavs):
            part = w[pos: pos + 1600]
            chunk[i, : len(part)] = part
            lens[i] = len(part)
        feats, k = fused.step(chunk, lens)
        for i in range(3):
            rows[i].append(feats[i, : k[i]].cpu().numpy())
    feats, k = fused.flush()
    raw = raw.cpu().numpy()
    for i in range(3):
        rows[i].append(feats[i, : k[i]].cpu().numpy())
        got = np.concatenate(rows[i])
        assert got.shape == (n[i], 40)
        err = float(np.max(np.abs(got - raw[i, : n[i]]) / np.maximum(np.abs(raw[i, : n[i]]), 1.0)))
        assert err <= FEAT_TOL, err
    # the CTC transcriber against the offline decode (kernel 4, one direction)
    model = _seeded(LSTM(RNNConfig(input_dim=40, num_labels=BLANK + 1, num_layers=2, hidden_units=64)), 5, cuda)
    x, n = _offline_feats(ext, wavs, cmvn)
    offline = CTCDecoder(model, CODER, BLANK)
    want = offline.decode_batch(x, n)
    tx = StreamingTranscriber(FusedOnlineFeatureExtractor(ext), model, CODER, BLANK, cmvn=cmvn)
    tx.reset(3)
    for pos in range(0, 40000, 1600):
        chunk = np.zeros((3, 1600), np.float32)
        lens = np.zeros(3, np.int64)
        for i, w in enumerate(wavs):
            part = w[pos: pos + 1600]
            chunk[i, : len(part)] = part
            lens[i] = len(part)
        tx.push(chunk, lens)
    finals = tx.finish()
    for i in range(3):
        assert finals[i] == CODER.decode(want[i])
        np.testing.assert_array_equal(tx.timestamps()[i], offline.last_label_frames[i] * tx.frame_seconds)
