"""Where a step of the persistent recurrences goes (the forward, kernels 4
and 6, and the backward, kernels 5 and 7), on one GPU: builds with parts of
the kernels switched off, timed side by side.

    python -m tfkaldi_tpu_torch.profile_rnn [--out split.json]

Copies ``ops/csrc/{rnn_step.cuh,gemm_sm90.cuh,lstm_bidi.cu,gru_bidi.cu}`` under
``build/profile_rnn`` and compiles each cell's source in six variants of
``persistent_fwd`` and ``persistent_bwd`` (a variant's outputs are wrong;
only its time is read):

- ``full``: the kernels as shipped;
- ``no_barrier``: the direction barrier replaced by a block sync;
- ``no_product``: neither the staging of h (forward) or of the published
  dgates (backward) nor the product (nor, in the backward, the sum of the
  warps' partial blocks);
- ``no_mma``: the staging without the product;
- ``no_stage``: the product on whatever the ring holds, no staging (the
  backward issues no TMA load and waits for none);
- ``epilogue_only``: no barrier and no product.

Times each (``profile_ffn.events_ms``: CUDA events around 5 calls after
3) at one layer of the recipe's BiLSTM / BiGRU, T 512, B 128, H 512, both
directions, every frame real, in bf16 and f32: the forward with residuals (the training forward) and
without (eval), and the backward on the full build's residuals, also on
one direction alone (64 CTAs doing what each of the 128 does: whether the
staging is bound by what L2 serves all SMs or by each SM); reports µs a
step. The parts, by difference: barrier = full − no_barrier,
staging + product = full − no_product, staging = no_mma − no_product,
product = no_stage − no_product (the last two overlap in ``full``, so they
need not add up). Prints the card as ``nvidia-smi`` names it and the
result as one JSON object on the last line (also written to ``--out``).
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import torch

from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.ops import _build, gru_bidi, lstm_bidi
from tfkaldi_tpu_torch.profile_ffn import events_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "profile_rnn")
T, B, H = 512, 128, 512
# the statements of rnn_step.cuh::persistent_fwd and ::persistent_bwd a
# variant switches, each by a macro
SWITCHES = {
    # persistent_fwd
    "if (s + 1 < t_len) dir_wait(bar + dir, static_cast<unsigned>(s + 1) * ctas);":
        "if (s + 1 < t_len) { if (TK_BARRIER) dir_wait(bar + dir, static_cast<unsigned>(s + 1) * ctas);"
        " else __syncthreads(); }",
    "if (i + 1 == mine && s + 1 < t_len) dir_arrive(bar + dir);":
        "if (TK_BARRIER && i + 1 == mine && s + 1 < t_len) dir_arrive(bar + dir);",
    "if (s > 0) {  // h_{-1} = 0": "if (TK_PRODUCT && s > 0) {  // h_{-1} = 0",
    "if (c < nchunks) stage_h<T>(": "if (TK_STAGE && c < nchunks) stage_h<T>(",
    "if (n < nchunks) stage_h<T>(": "if (TK_STAGE && n < nchunks) stage_h<T>(",
    "chunk_product<G>(hs + (c % Pp::NST)": "if (TK_MMA) chunk_product<G>(hs + (c % Pp::NST)",
    # persistent_bwd
    "if (s + 1 < t_len) dir_wait(bar + dir, (s + 1u) * ctas);":
        "if (s + 1 < t_len) { if (TK_BARRIER) dir_wait(bar + dir, (s + 1u) * ctas); else __syncthreads(); }",
    "if (s + 1 < t_len && i + 1 == mine) dir_arrive(bar + dir);":
        "if (TK_BARRIER && s + 1 < t_len && i + 1 == mine) dir_arrive(bar + dir);",
    "if (s > 0) {  // dg_{-1} = 0": "if (TK_PRODUCT && s > 0) {  // dg_{-1} = 0",
    "for (int c = 0; c < Pp::NST - 1 && c < nchunks; ++c) issue(":
        "for (int c = 0; TK_STAGE && c < Pp::NST - 1 && c < nchunks; ++c) issue(",
    "if (threadIdx.x == 0 && c + Pp::NST - 1 < nchunks) issue(":
        "if (TK_STAGE && threadIdx.x == 0 && c + Pp::NST - 1 < nchunks) issue(",
    "tkgemm::mbar_wait(full0 + 8 * (q % Pp::NST), (q / Pp::NST) & 1);":
        "if (TK_STAGE) tkgemm::mbar_wait(full0 + 8 * (q % Pp::NST), (q / Pp::NST) & 1);",
    "BwdWarp<T>::chunk(ring": "if (TK_MMA) BwdWarp<T>::chunk(ring",
}
# (barrier, product, stage, mma)
VARIANTS = {"full": (1, 1, 1, 1), "no_barrier": (0, 1, 1, 1), "no_product": (1, 0, 1, 1),
            "no_mma": (1, 1, 1, 0), "no_stage": (1, 1, 0, 1), "epilogue_only": (0, 0, 1, 1)}
CELLS = {"lstm": lstm_bidi.CELL, "gru": gru_bidi.CELL}


def _sources() -> None:
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "rnn_step.cuh")) as f:
        src = f.read()
    for old, new in SWITCHES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"profile_rnn: rnn_step.cuh no longer holds exactly one {old!r}")
        src = src.replace(old, new)
    with open(os.path.join(WORK, "rnn_step.cuh"), "w") as f:
        f.write(src)
    for name in [f"{cell}_bidi.cu" for cell in CELLS] + ["gemm_sm90.cuh"]:  # the sources, and the header rnn_step.cuh takes
        shutil.copy(os.path.join(_build.CSRC_DIR, name), os.path.join(WORK, name))


def _build_variants() -> dict:
    """One shared library per (cell, variant), all nvcc runs in parallel."""
    jobs = {}
    for cell in CELLS:
        for name, (barrier, product, stage, mma) in VARIANTS.items():
            out = os.path.join(WORK, f"lib_{cell}_{name}.so")
            cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                   f"-DTK_BARRIER={barrier}", f"-DTK_PRODUCT={product}", f"-DTK_STAGE={stage}",
                   f"-DTK_MMA={mma}", "-o", out, os.path.join(WORK, f"{cell}_bidi.cu")]
            jobs[(cell, name)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                        text=True))
    libs = {}
    for (cell, name), (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {cell} {name}:\n{err}")
        lib = ctypes.CDLL(out)
        for entry, argtypes in _build._SIGNATURES.items():
            if entry.startswith(f"tk_{cell}_"):
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[(cell, name)] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _sources()
    libs = _build_variants()
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "shape": [T, B, H], "us_per_step": {}}
    saved = _build._lib
    try:
        for cell, c in CELLS.items():
            gxs = [torch.randn(T, B, c.gates * H, generator=gen).cuda() for _ in range(2)]
            whs = [(torch.randn(H, c.gates * H, generator=gen) / H ** 0.5).cuda() for _ in range(2)]
            dys = [torch.randn(T, B, H, generator=gen).cuda() for _ in range(2)]
            mask = torch.ones(T, B, 1, device="cuda")
            for cd in (torch.bfloat16, torch.float32):
                whs_cd = [w.to(cd) for w in whs]
                _build._lib = libs[(cell, "full")]
                res = [r for _, r in c.fwd(gxs, whs_cd, mask, residuals=True)]
                runs = {"fwd residuals": lambda: c.fwd(gxs, whs_cd, mask, residuals=True),
                        "fwd eval": lambda: c.fwd(gxs, whs_cd, mask, residuals=False),
                        "bwd": lambda: c.bwd(dys, res, mask, whs_cd),
                        # half the grid, the same work a CTA: half the bytes staged from L2 a step
                        "bwd one direction": lambda: c.bwd(dys[:1], res[:1], mask, whs_cd[:1])}
                for part, fn in runs.items():
                    times = {}
                    for name in VARIANTS:
                        _build._lib = libs[(cell, name)]
                        times[name] = events_ms(fn, calls=5, windows=1) * 1e3 / T
                    parts = {"barrier": times["full"] - times["no_barrier"],
                             "staging+product": times["full"] - times["no_product"],
                             "staging": times["no_mma"] - times["no_product"],
                             "product": times["no_stage"] - times["no_product"]}
                    key = f"{cell} {str(cd).replace('torch.', '')} {part}"
                    result["us_per_step"][key] = {"variants": times, "parts": parts}
                    print(f"{key}: us a step {times!r}; parts {parts!r} [{card}]", flush=True)
                del res
    finally:
        _build._lib = saved
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
