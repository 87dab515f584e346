"""Hybrid WFST decoding orchestration.

A copy of :mod:`tfkaldi_tpu.kaldi.decode_wfst`. Python equivalent of the
reference kaldi/decode.sh (82-line bash): split the likelihood "features"
into nj jobs and run ``latgen-faster-mapped`` over the HCLG graph, then
score. The port's log pseudo-likelihood ark (written by
:mod:`tfkaldi_tpu_torch.decode`) is the drop-in input. Kaldi decode defaults
pinned by the reference (decode.sh:4-16): beam 15.0, max_active 7000,
min_active 200, lattice_beam 8.0, acwt 0.1.
"""

from __future__ import annotations

import dataclasses
import os

from tfkaldi_tpu_torch.kaldi.gmm import run_checked


@dataclasses.dataclass(frozen=True)
class WfstDecodeOpts:
    nj: int = 4
    acwt: float = 0.1
    beam: float = 15.0
    max_active: int = 7000
    min_active: int = 200
    lattice_beam: float = 8.0
    num_threads: int = 1
    minimize: bool = False
    skip_scoring: bool = False
    cmd: str = "run.pl"
    iter: str = "final"


def decode_wfst(
    graphdir: str,
    data: str,
    decode_dir: str,
    kaldi_egs: str,
    opts: WfstDecodeOpts = WfstDecodeOpts(),
) -> None:
    """Run the lattice decode + scoring (decode.sh:40-77)."""
    srcdir = os.path.dirname(os.path.abspath(decode_dir))
    model = os.path.join(srcdir, f"{opts.iter}.mdl")
    os.makedirs(os.path.join(decode_dir, "log"), exist_ok=True)

    sdata = os.path.join(data, f"split{opts.nj}")
    run_checked(f"utils/split_data.sh {data} {opts.nj}", cwd=kaldi_egs)
    with open(os.path.join(decode_dir, "num_jobs"), "w") as f:
        f.write(f"{opts.nj}\n")

    thread_string = (
        f"-parallel --num-threads={opts.num_threads}" if opts.num_threads > 1 else ""
    )
    loglikes = f"ark,s,cs:copy-feats scp:{sdata}/JOB/feats.scp ark:- |"
    run_checked(
        f"{opts.cmd} --num-threads {opts.num_threads} JOB=1:{opts.nj} "
        f"{decode_dir}/log/decode.JOB.log "
        f"latgen-faster-mapped{thread_string} "
        f"--minimize={str(opts.minimize).lower()} --max-active={opts.max_active} "
        f"--min-active={opts.min_active} --beam={opts.beam} "
        f"--lattice-beam={opts.lattice_beam} --acoustic-scale={opts.acwt} "
        f"--allow-partial=true --word-symbol-table={graphdir}/words.txt "
        f'"{model}" {graphdir}/HCLG.fst "{loglikes}" '
        f'"ark:|gzip -c > {decode_dir}/lat.JOB.gz"',
        cwd=kaldi_egs,
    )

    if not opts.skip_scoring:
        run_checked(
            f'local/score.sh --cmd "{opts.cmd}" {data} {graphdir} {decode_dir}',
            cwd=kaldi_egs,
        )


def best_wer(decode_dir: str) -> str:
    """Scan wer_* files for the best WER line (main.py:198 equivalent,
    without shelling out to grep | best_wer.sh).

    Handles the real ``local/score.sh`` output family: ``wer_<lmwt>`` and
    ``wer_<lmwt>_<penalty>`` files containing full ``compute-wer`` output
    (echoed command line, ``%WER``/``%SER``/``Scored`` lines — see
    tests/test_score_parse.py for vendored fixtures). Malformed lines are
    skipped; ties break deterministically on the sorted filename; non-file
    ``wer_*`` entries (e.g. scoring subdirs) are ignored."""
    best: tuple[float, str] | None = None
    for name in sorted(os.listdir(decode_dir)):
        path = os.path.join(decode_dir, name)
        if not name.startswith("wer_") or not os.path.isfile(path):
            continue
        with open(path, errors="replace") as f:
            for line in f:
                if "%WER" in line:
                    try:
                        wer = float(line.split("%WER")[1].split()[0])
                    except (IndexError, ValueError):
                        continue
                    if best is None or wer < best[0]:
                        best = (wer, f"{line.strip()} [{name}]")
    return best[1] if best else "no wer_* files found"
