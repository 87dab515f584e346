"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The run loads, warms up, measures for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON object as the last line of its standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones, read from a
torch.profiler trace of the window), ``device``, with ``--trace 1``
``breakdown``, ``window`` (what else the window saw: a training cell's
validations, rollbacks and recipe stop, a decode cell's host seconds by
phase), and last ``compared`` (each number of the check beside its
limit, also the last lines of standard error).

It exits non-zero and prints no result where the card or the cards the
cell asks for are missing, where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed, and where the program is
not beside it.
"""

from __future__ import annotations

import time

T0_WALL = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tfkaldi_tpu")


def fix_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernel build is ``build/tfkaldi_tpu_torch/``), and no
    library of the port's loading JAX by itself."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(got.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str, fault: str | None = None):
    """Run the cell's driver in a scratch directory under ``TMPDIR``."""
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return spec.driver(cell).run(cell, seed, seconds, trace, device, T0_WALL, workdir, fault=fault,
                                     limits=cell["limits"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def read_metrics(rec, cell: dict, trace: bool) -> dict:
    out = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(rec, cell: dict, trace: bool, device: dict) -> dict:
    line = {"correct": bool(rec.correct), "attempted": int(rec.attempted), "failed": int(rec.failed),
            "metrics": read_metrics(rec, cell, trace), "device": dict(device)}
    line["device"]["memory_peak_bytes"] = int(rec.memory_peak_bytes)
    if trace and rec.trace is not None and rec.trace_extent is not None:
        lo, hi = rec.trace_extent
        line["device"]["busy_s"] = rec.busy_s
        line["device"]["window_s"] = (hi - lo) * 1e-6
        line["breakdown"] = rec.trace.breakdown(lo, hi)
    line["window"] = rec.window
    line["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rec.compared}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_cache_dirs(spec.ROOT)
    cell = spec.cell(args.workload)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {cell['name']} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    # read after the run: the ranks of a multi-card cell own their cards alone
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "power_limit_w": power_limit_w()}
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: {', '.join(loaded)} loaded in the measuring process", file=sys.stderr)
        return 3
    line = result_line(rec, cell, bool(args.trace), device)
    print(f"portbench window: {json.dumps(rec.window)}", file=sys.stderr)
    for name, value, limit in rec.compared:
        print(f"portbench check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
