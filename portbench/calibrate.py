"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--fault half_batch --fault-seeds x,y,z] [--seconds 8] [--out FILE]

In one process, for each of ``--seeds``: the program's numbers against the
reference (a training cell's first steps, with no measured window; a
decode cell's window of ``--seconds``); for each of ``--control-seeds``:
the control's, the reference computed in the precision under the one the
configuration states (TF32 for float32) in the program's place; for each
of ``--fault-seeds``: the program's with the named fault planted. One JSON line a reading, on standard output and in
``--out``. PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from portbench import run as prun, spec

CONTROL = {"float32": "tf32"}


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    prun.fix_cache_dirs(spec.ROOT)
    cell = spec.cell(args.workload)
    driver = spec.driver(cell)
    mode = CONTROL[cell["config_data"]["nnet"].get("compute_dtype", "float32")]
    out = open(args.out, "a") if args.out else None

    def emit(kind: str, seed: int, numbers: dict, t0: float, **extra) -> None:
        line = json.dumps({"cell": cell["name"], "kind": kind, "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t0, **extra})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def readings(seeds: list[int], fault: str | None):
        """The program's record of each seed, a run each."""
        for seed in seeds:
            t0 = time.perf_counter()
            yield seed, prun.run_cell(cell, seed, args.seconds, False, args.device, fault=fault), t0

    for seed, rec, t0 in readings(_seeds(args.seeds), None):
        emit("program", seed, rec.numbers, t0, failed=rec.failed, attempted=rec.attempted,
             losses=rec.program.get("losses"))
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="portbench-")
        try:
            emit(f"control_{mode}", seed, driver.control_numbers(cell, seed, args.device, workdir, mode), t0)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    for seed, rec, t0 in readings(_seeds(args.fault_seeds), args.fault):
        emit(f"fault_{args.fault}", seed, rec.numbers, t0)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
