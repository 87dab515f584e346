"""Kernel 2 (preemphasis + framing, ``ops/csrc/frame_preemph.cu``) on one
GPU: the kernel's own device time beside the time of its Python wrapper.

    python3 tfkaldi_tpu_torch/profile_frame.py [--root DIR] [--sweep] [--out result.json]

At the two shapes of :data:`SHAPES` (16 x 5 s at 16 kHz, the kernel
table's batch, and 16 x 8 s, the longest bucket the served run pads to) it prints
and returns:

- ``device_ms``: the summed self device time of the kernel's own events
  under ``torch.profiler`` over 20 calls (one launch a call), divided by
  the calls (``profile_ffn.device_ms`` with the kernel's name);
- ``wrapper_ms``: CUDA events around 20 calls of the wrapper, the median
  of 3 windows (``profile_ffn.events_ms``); where the host enqueues slower
  than the card runs, this is the host's time;
- ``plain_ms`` (the plain PyTorch version) and ``bound_ms``
  (``profile_ffn.bound``: the bytes, the f32 signal and ``eff_len`` read
  once and the f64 frames written once, over the memory rate);
- the launch plan (route, frames a tile, grid, shared memory)
  where the package has ``frame_plan``.

``--root DIR`` times the ``tfkaldi_tpu_torch`` of another checkout (an
older commit unpacked with ``git archive``) with this code, so two
versions of the kernel are compared in one call. ``--sweep`` adds the
device time at every tile depth of :data:`SWEEP_FRAMES`.
Prints the card as ``nvidia-smi`` names it and the result as one JSON
object on the last line (also written to ``--out``). Needs one CUDA device
and ``nvcc``. The timers and the memory rate are ``profile_ffn``'s, of
this checkout whatever ``--root`` names.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

if __package__:
    from .profile_ffn import PEAK_F64, bound, device_ms, events_ms
else:  # run as a file: this directory heads sys.path
    from profile_ffn import PEAK_F64, bound, device_ms, events_ms

PREEMPH, WL, WS = 0.97, 400, 160  # 25 ms frames every 10 ms at 16 kHz
SHAPES = ((16, 5 * 16000), (16, 8 * 16000))  # [B, S]
KERNEL_NAME = "frame_preemph"  # a substring of the kernel's symbol
SWEEP_FRAMES = (2, 4, 8, 16, 32)  # frames a tile


def inputs(b: int, s: int, device="cuda"):
    """The kernel table's framing inputs: integer-valued f32 samples (as wav
    data is) and real lengths ``s - 97 i``; returns ``(signals, eff_len,
    args)``."""
    gen = torch.Generator().manual_seed(1)
    sig = (torch.randn(b, s, generator=gen) * 3000).round().to(device)
    eff = torch.tensor([s - 97 * i for i in range(b)], dtype=torch.int32, device=device)
    t_max = 1 + (s - WL) // WS
    return sig, eff, dict(preemph=PREEMPH, frame_step=WS, frame_len=WL, t_max=t_max)


def bound_ms(b: int, s: int, t_max: int) -> float:
    """``profile_ffn.bound`` of the work: two f64 operations a sample
    against the f32 signal and ``eff_len`` read once and the f64 frames
    written once, which bound it."""
    return bound(2 * b * s, b * s * 4 + b * 4 + b * t_max * WL * 8, PEAK_F64)["bound_ms"]


def plan_dict(plan) -> dict:
    return {"route": plan.route, "frames": plan.frames, "tiles": plan.tiles, "grid": plan.grid,
            "threads": plan.threads, "smem_bytes": plan.smem_bytes}


def profile_shape(fp, b: int, s: int, *, sweep: bool = False) -> dict:
    """Every reading above at ``[b, s]`` for the module ``fp``
    (``tfkaldi_tpu_torch.ops.frame_preemph`` of some checkout)."""
    sig, eff, args = inputs(b, s)
    t_max = args["t_max"]
    got = fp.frame_preemph(sig, eff, **args)
    want = fp.frame_preemph_ref(sig, eff, **args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"frame_preemph [{b},{s}] differs from its plain version")
    row = {"shape": [b, s, t_max, WL], "bound_ms": bound_ms(b, s, t_max)}
    row["device_ms"] = device_ms(lambda: fp.frame_preemph(sig, eff, **args), match=KERNEL_NAME)
    row["wrapper_ms"] = events_ms(lambda: fp.frame_preemph(sig, eff, **args))
    row["plain_ms"] = events_ms(lambda: fp.frame_preemph_ref(sig, eff, **args))
    plan_of = getattr(fp, "frame_plan", None)
    if plan_of is not None:
        row["plan"] = plan_dict(fp.plan_for(sig, got, t_max, WL, WS))
    if sweep and plan_of is not None:
        row["sweep"] = []
        for frames in SWEEP_FRAMES:
            plan = fp.plan_for(sig, got, t_max, WL, WS, frames=frames)
            out = fp.frame_preemph(sig, eff, **args, plan=plan)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"frame_preemph [{b},{s}] with {plan} differs from its plain version")
            ms = device_ms(lambda: fp.frame_preemph(sig, eff, **args, plan=plan), match=KERNEL_NAME)
            row["sweep"].append({**plan_dict(plan), "device_ms": ms})
    del sig, eff, got, want
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose tfkaldi_tpu_torch is timed (default: this one)")
    ap.add_argument("--sweep", action="store_true", help="also time every tile depth of SWEEP_FRAMES")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    here = os.path.dirname(os.path.abspath(__file__))
    # run as a file, this package's own directory heads sys.path: its
    # subpackages (io, data, ...) must not stand in for top-level modules
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.ops import _build
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    if not os.path.abspath(fp.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {fp.__file__}, not the checkout {root}")
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load()
    result = {"card": card, "root": root, "shapes": []}
    for b, s in SHAPES:
        row = profile_shape(fp, b, s, sweep=args.sweep)
        result["shapes"].append(row)
        print(f"frame_preemph [{b},{s}]: {json.dumps(row)} [{card}]", flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
