"""The port's TensorBoard event files against the JAX package's writer, on
the CPU (the cases of tests/test_tb_events.py, then byte identity).

With the wall time and the host name fixed, the port's writer and the JAX
writer give files with the same bytes for the same calls (the file names
carry the pid and the time, so the contents are compared), and each
package's ``read_events`` reads the other's files. The visualizer's tags
are the JAX visualizer's for the same converted parameters.
"""

import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.models.transformer import Transformer as JaxTransformer
from tfkaldi_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from tfkaldi_tpu.utils import tb_events as jax_tb
from tfkaldi_tpu.utils.visualize import TensorBoardVisualizer as JaxVisualizer
from tfkaldi_tpu_torch.convert import dnn_from_jax, rnn_from_jax, transformer_from_jax
from tfkaldi_tpu_torch.models import DNN, LSTM, DNNConfig, RNNConfig, Transformer, TransformerConfig
from tfkaldi_tpu_torch.utils import tb_events
from tfkaldi_tpu_torch.utils.visualize import TensorBoardVisualizer


def test_crc32c_known_vectors():
    """CRC-32C (Castagnoli) check values: a wrong polynomial or reflection
    would make TensorBoard reject every record."""
    assert tb_events.crc32c(b"") == 0
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    assert tb_events.crc32c(b"\x00" * 32) == 0x8A9136AA
    for data in (b"", b"abc", bytes(range(256))):
        assert tb_events.masked_crc(data) == jax_tb.masked_crc(data)


def test_scalar_roundtrip(tmp_path):
    w = tb_events.EventFileWriter(str(tmp_path))
    w.add_scalar("train/loss", 1.5, 3)
    w.add_scalar("train/loss", 1.25, 4)
    w.add_scalar("valid/loss", 2.0, 4)
    w.close()
    events = tb_events.read_events(w.path)
    assert events[0][1]["__file_version__"] == "brain.Event:2"
    assert events[1][0] == 3 and events[1][1]["train/loss"] == 1.5
    assert events[2][0] == 4 and events[2][1]["train/loss"] == 1.25
    assert events[3][1]["valid/loss"] == 2.0


def test_histogram_roundtrip(tmp_path):
    w = tb_events.EventFileWriter(str(tmp_path))
    w.add_histogram("params/w", np.random.default_rng(0).standard_normal(1000), 7)
    w.close()
    step, vals = tb_events.read_events(w.path)[1]
    assert step == 7 and vals["params/w"] == "histogram"


def test_corrupt_record_detected(tmp_path):
    w = tb_events.EventFileWriter(str(tmp_path))
    w.add_scalar("t", 1.0, 0)
    w.close()
    blob = bytearray(open(w.path, "rb").read())
    blob[-6] ^= 0xFF  # a payload byte of the last record
    bad = tmp_path / "bad_events"
    bad.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="crc"):
        tb_events.read_events(str(bad))
    with pytest.raises(IOError, match="crc"):
        jax_tb.read_events(str(bad))


def _write(module, logdir, calls):
    writer = module.EventFileWriter(str(logdir))
    for kind, tag, value, step in calls:
        getattr(writer, f"add_{kind}")(tag, value, step)
    writer.close()
    return writer.path


def test_files_byte_identical_to_the_jax_writer(tmp_path, monkeypatch):
    """Fixed wall time and host name: the same calls give the same bytes,
    and each package reads the other's file to the same events."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    rng = np.random.default_rng(1)
    calls = [("scalar", "train/loss", 7.6, 0), ("scalar", "train/loss", float(np.float32(3.14159)), 1),
             ("scalar", "valid/loss", 2.5, 2), ("histogram", "params['hidden'][0]['w']",
                                                rng.standard_normal((16, 8)).astype(np.float32), 2),
             ("histogram", "empty", np.zeros(0, np.float32), 3), ("scalar", "big/step", -1e30, 2**40)]
    port = _write(tb_events, tmp_path / "port", calls)
    ref = _write(jax_tb, tmp_path / "jax", calls)
    assert os.path.basename(port) == os.path.basename(ref)  # both name the fixed time, host and this pid
    assert open(port, "rb").read() == open(ref, "rb").read()
    assert tb_events.read_events(ref) == jax_tb.read_events(port) == tb_events.read_events(port)


def _dnn():
    cfg = dict(input_dim=12, num_labels=5, num_hidden_layers=2, num_hidden_units=8, batch_norm=True)
    jmodel = JaxDNN(JaxDNNConfig(**cfg))
    params, state = jmodel.init(jax.random.PRNGKey(0))
    model = DNN(DNNConfig(**cfg))
    model.load_state_dict(dnn_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    return params, model


def _lstm():
    cfg = dict(input_dim=6, num_labels=5, num_layers=2, hidden_units=4, bidirectional=True)
    params = JaxLSTM(JaxRNNConfig(**cfg)).init(jax.random.PRNGKey(1))[0]
    model = LSTM(RNNConfig(**cfg))
    model.load_state_dict(rnn_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


def _conformer():
    cfg = dict(input_dim=6, num_labels=5, num_blocks=1, d_model=8, num_heads=2, ffn_dim=8, conv_kernel=3,
               conformer=True)
    params, state = JaxTransformer(JaxTransformerConfig(**cfg)).init(jax.random.PRNGKey(2))
    model = Transformer(TransformerConfig(**cfg))
    model.load_state_dict(transformer_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    return params, model


def _events_by_tag(logdir):
    (name,) = [f for f in os.listdir(logdir) if f.startswith("events.out")]
    out = {}
    for step, vals in tb_events.read_events(os.path.join(logdir, name)):
        for tag, value in vals.items():
            out.setdefault(tag, []).append((step, value))
    return out


@pytest.mark.parametrize("build", [_dnn, _lstm, _conformer], ids=["dnn", "lstm", "conformer"])
def test_visualizer_tags_match_the_jax_visualizer(tmp_path, build):
    """The metrics hook, the validation hook and the parameter histograms
    write the JAX visualizer's tags; histograms are tagged by the JAX pytree
    path of the converted parameter, one per parameter."""
    params, model = build()
    port, ref = TensorBoardVisualizer(str(tmp_path / "port")), JaxVisualizer(str(tmp_path / "jax"))
    for viz in (port, ref):
        viz(step=0, loss=3.0, step_time=0.1, num_frames=1000)
        viz.validation(0, 2.5)
    port(step=1, loss=2.0, step_time=0.2, num_frames=500, padded_length=128)  # the port's hook has one more key
    port.params(1, model)
    ref.params(1, jax.tree.map(jnp.asarray, params))
    port.close()
    ref.close()
    got, want = _events_by_tag(tmp_path / "port"), _events_by_tag(tmp_path / "jax")
    assert {"train/loss", "train/step_time_s", "train/frames_per_sec", "valid/loss"} <= set(got)
    assert got["train/loss"] == [(0, 3.0), (1, 2.0)] and got["valid/loss"] == want["valid/loss"]
    hist = {t for t, v in got.items() if v == [(1, "histogram")]}
    assert hist == {t for t, v in want.items() if v[-1] == (1, "histogram")}
    assert len(hist) == len(list(model.parameters()))


def test_visualizer_widens_bf16_and_names_other_modules(tmp_path):
    """A module convert.py does not map is tagged by its state_dict names;
    bf16 parameters are widened to f32 on the host."""
    module = torch.nn.Linear(3, 2).to(torch.bfloat16)
    viz = TensorBoardVisualizer(str(tmp_path))
    viz.params(4, module)
    viz.close()
    assert _events_by_tag(tmp_path) == {"__file_version__": [(None, "brain.Event:2")],
                                        "weight": [(4, "histogram")], "bias": [(4, "histogram")]}
