"""Shared fixtures of the benchmark's tests: the cells cut to a CPU size.

Run here with ``python -m pytest portbench/tests -q`` from the checkout's
root; the tests marked ``cuda`` run on a card and skip without one.
"""

from __future__ import annotations

import copy

import pytest

from portbench import spec


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


def tiny(name: str) -> dict:
    """The cell ``name`` with its widths, corpus and batches cut so that a
    run takes seconds on the CPU (the cells themselves run at full size on
    the card)."""
    cell = copy.deepcopy(spec.cell(name))
    cfg, tr = cell["config_data"], cell["traffic_data"]
    nnet = cfg["nnet"]
    cfg["train_utterances"] = 64
    nnet.update(batch_size="8", valid_batches="1", valid_frequency="3", check_freq="3")
    nnet.update(num_hidden_units="32", num_hidden_layers="3")
    cfg["num_labels"] = 20
    tr.update(mean_s=0.5, min_s=0.2, max_s=1.0, speakers=4, pdf_frames=[2, 4])
    if tr["driver"] == "decode":
        tr.update(job_utterances=12, batch_size=4, check_utterances=4, speakers=3)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
