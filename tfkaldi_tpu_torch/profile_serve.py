"""Where the served path's time goes on one GPU: timed and profiled runs.

    python -m tfkaldi_tpu_torch.profile_serve [--out profile.json]

Builds the card suite's served-path workspace (:func:`synthetic.make_workspace`:
32 test wavs of 1-8 s, 4 speakers, 440 -> 6x2048 -> 2000 with batchnorm)
under ``build/profile_serve`` and then measures two phases:

1. features: ``prepare_data`` of the test set, once to warm up, 5 timed
   runs, then one run under ``torch.profiler``;
2. spool decode: one :class:`DecodeService` (model loaded once) over a spool
   of 3 jobs, each a copy of the test featdir; one sweep to warm up,
   5 timed sweeps, then one sweep under ``torch.profiler``.
   Between sweeps the outputs are removed so every job is pending again.

Wall times are host clock with the device synchronised at both ends. For a
profiled run it reports the wall time, the device's own time (the sum of
self device time over the profiler's device-side events: kernels and
copies), the idle share ``1 - device / wall``, and the device-side items
with the most time. Prints the card as ``nvidia-smi`` names it, and the
result as one JSON object on the last line (also written to ``--out``).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.frontend.prepare_data import prepare_data
from tfkaldi_tpu_torch.io import ArkReader
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.profile_ffn import self_device_us
from tfkaldi_tpu_torch.serve import DecodeService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "profile_serve")
NUM_PDFS, HIDDEN_UNITS, HIDDEN_LAYERS = 2000, 2048, 6
RUNS = 5  # timed runs per phase
TOP_ITEMS = 12


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled(fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall, device time, idle share
    and the items with the most device time."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall_s = _timed(fn)
    # device-side events only: a CPU op such as aten::copy_ also carries the
    # device time of what it launched, which would count it twice
    events = [(e.key, e.count, self_device_us(e)) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(us for _, _, us in events) / 1e3
    top = sorted((e for e in events if e[2] > 0), key=lambda e: -e[2])[:TOP_ITEMS]
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / (wall_s * 1e3),
        "top": [{"name": k[:160], "calls": n, "ms": us / 1e3, "share": us / 1e3 / device_ms}
                for k, n, us in top],
    }


def _frames(scp: str) -> int:
    with ArkReader(scp) as reader:
        return sum(mat.shape[0] for _, mat in reader)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", help="also write the result JSON here")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ws = synthetic.make_workspace(WORK, num_pdfs=NUM_PDFS, hidden_units=HIDDEN_UNITS,
                                  hidden_layers=HIDDEN_LAYERS)
    config, test_featdir = ws["config"], ws["test_featdir"]
    if cli_main.main(["--config", ws["cfg_path"], "--steps", "dnn_train_features,dnn_test_features"]) != 0:
        raise RuntimeError("feature extraction of the workspace failed")

    # ---- features ----
    datadir = config.get("directories", "test_data")
    feat_conf = dict(config.items("dnn-features"))
    featdir = os.path.join(WORK, "features")

    def features():
        prepare_data(datadir, featdir, feat_conf, device=device)

    features()
    feat_frames = _frames(os.path.join(featdir, "feats.scp"))
    feat_walls = [_timed(features) for _ in range(RUNS)]
    feat_profile = _profiled(features)

    # ---- spool decode ----
    spool_in, spool_out = os.path.join(WORK, "spool", "in"), os.path.join(WORK, "spool", "out")
    for job in ("job0", "job1", "job2"):
        shutil.copytree(test_featdir, os.path.join(spool_in, job))
    service = DecodeService(Nnet(config, 40, NUM_PDFS, device=device), spool_in, spool_out)

    def sweep():
        shutil.rmtree(spool_out)
        os.makedirs(spool_out)
        if service.process_pending() != 3:
            raise RuntimeError("a spool job failed; see the FAILED marker under " + spool_out)

    sweep()
    sweep_frames = 3 * _frames(os.path.join(test_featdir, "feats.scp"))
    sweep_walls = [_timed(sweep) for _ in range(RUNS)]
    sweep_profile = _profiled(sweep)

    result = {
        "card": card,
        "torch": torch.__version__,
        "features": {"frames": feat_frames, "wall_s": feat_walls,
                     "frames_per_s_median": feat_frames / statistics.median(feat_walls),
                     "profile": feat_profile},
        "spool_sweep": {"jobs": 3, "frames": sweep_frames, "batch_size": service.batch_size,
                        "wall_s": sweep_walls,
                        "frames_per_s_median": sweep_frames / statistics.median(sweep_walls),
                        "profile": sweep_profile},
    }
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
