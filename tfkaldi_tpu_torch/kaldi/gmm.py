"""Kaldi GMM wrappers: monophone / triphone / LDA+MLLT.

A copy of :mod:`tfkaldi_tpu.kaldi.gmm`: the same script names, config
files, options and command lines. Template-method structure mirroring the
reference kaldi/gmm.py:7-218, with three fixes over it:

- subprocesses run with ``cwd=`` instead of ``os.chdir`` (no global state)
- return codes are checked (the reference ignores every one, gmm.py:31-44)
- the per-job transition-id → pdf-id conversion pipeline
  (``gunzip | ali-to-pdf | gzip``, gmm.py:70-76) is built from checked
  subprocesses, and the per-job archives can be merged in-process
  (replacing the ``cat`` at main.py:140-142).
"""

from __future__ import annotations

import gzip
import logging
import os
import shlex
import subprocess

log = logging.getLogger(__name__)


def merge_alignments(ali_dir: str, num_jobs: int) -> str:
    """Concatenate per-job pdf archives into ``pdf.all.gz`` in-process
    (replaces ``cat`` at main.py:140-142). gzip members concatenate
    legally, but we re-write one clean stream."""
    out_path = os.path.join(ali_dir, "pdf.all.gz")
    with gzip.open(out_path, "wt") as out:
        for i in range(1, num_jobs + 1):
            with gzip.open(os.path.join(ali_dir, f"pdf.{i}.gz"), "rt") as part:
                out.write(part.read())
    return out_path


def run_checked(cmd: str, cwd: str | None = None) -> None:
    """Run a shell command, raising on failure (unlike os.system).

    Runs under bash with ``pipefail`` so a failure anywhere in a pipeline
    (e.g. ``gunzip | ali-to-pdf | gzip``) is not masked by the last stage
    exiting 0 — without it the alignment conversion can silently truncate
    its output."""
    log.info("running: %s", cmd)
    subprocess.run(
        ["/bin/bash", "-o", "pipefail", "-c", cmd], cwd=cwd, check=True
    )


class GMM:
    """Base Kaldi GMM wrapper.

    ``conf`` is a configparser-style object with ``get(section, key)``
    (the reference passes the whole config, gmm.py:11-19).
    """

    name_key: tuple[str, str]  # (section, key) for the model name
    trainscript: str
    conf_file: str
    graphopts: str = ""

    def __init__(self, conf):
        self.conf = conf
        self.current_dir = os.getcwd()

    # -- config accessors ------------------------------------------------

    @property
    def name(self) -> str:
        section, key = self.name_key
        return self.conf.get(section, key)

    @property
    def kaldi_egs(self) -> str:
        return self.conf.get("directories", "kaldi_egs")

    @property
    def expdir(self) -> str:
        return os.path.join(self.conf.get("directories", "expdir"), self.name)

    @property
    def featdir(self) -> str:
        return os.path.join(
            self.conf.get("directories", "train_features"),
            self.conf.get("gmm-features", "name"),
        )

    @property
    def num_jobs(self) -> str:
        return self.conf.get("general", "num_jobs")

    @property
    def cmd(self) -> str:
        return self.conf.get("general", "cmd")

    @property
    def parent_gmm_alignments(self) -> str:
        return ""

    @property
    def trainops(self) -> str:
        return ""

    # -- operations (gmm.py:21-101) -------------------------------------

    def train(self) -> None:
        """Train the GMM and build its decoding graph."""
        config_arg = os.path.join(self.current_dir, "config", self.conf_file)
        run_checked(
            f"{self.trainscript} --cmd {self.cmd} --config {config_arg} {self.trainops} "
            f"{self.featdir} {self.conf.get('directories', 'language')} "
            f"{self.parent_gmm_alignments} {self.expdir}",
            cwd=self.kaldi_egs,
        )
        run_checked(
            f"utils/mkgraph.sh {self.graphopts} "
            f"{self.conf.get('directories', 'language_test')} {self.expdir} "
            f"{self.expdir}/graph",
            cwd=self.kaldi_egs,
        )

    def align(self) -> None:
        """Force-align the training set, then convert transition-ids to
        pdf-ids per job (gmm.py:49-79)."""
        config_arg = os.path.join(self.current_dir, "config", f"ali_{self.conf_file}")
        run_checked(
            f"steps/align_si.sh --nj {self.num_jobs} --cmd {self.cmd} "
            f"--config {config_arg} {self.featdir} "
            f"{self.conf.get('directories', 'language')} {self.expdir} {self.expdir}/ali",
            cwd=self.kaldi_egs,
        )
        for i in range(1, int(self.num_jobs) + 1):
            run_checked(
                f"gunzip -c {self.expdir}/ali/ali.{i}.gz | "
                f"ali-to-pdf {self.expdir}/ali/final.mdl ark:- ark,t:- | "
                f"gzip > {self.expdir}/ali/pdf.{i}.gz",
                cwd=self.kaldi_egs,
            )

    def merge_alignments(self) -> str:
        return merge_alignments(os.path.join(self.expdir, "ali"), int(self.num_jobs))

    def test(self) -> None:
        """Decode the test set with the GMM baseline (gmm.py:81-101)."""
        testfeats = os.path.join(
            self.conf.get("directories", "test_features"),
            self.conf.get("gmm-features", "name"),
        )
        run_checked(
            f"steps/decode.sh --cmd {self.cmd} --nj {self.num_jobs} "
            f"{self.expdir}/graph {testfeats} {self.expdir}/decode "
            f"| tee {self.expdir}/decode.log",
            cwd=self.kaldi_egs,
        )


class MonoGmm(GMM):
    """Monophone GMM (gmm.py:133-158)."""

    name_key = ("mono_gmm", "name")
    trainscript = "steps/train_mono.sh"
    conf_file = "mono.conf"
    graphopts = "--mono"

    @property
    def trainops(self) -> str:
        return f"--nj {self.num_jobs}"


class TriGmm(GMM):
    """Delta-feature triphone GMM (gmm.py:160-187)."""

    name_key = ("tri_gmm", "name")
    trainscript = "steps/train_deltas.sh"
    conf_file = "tri.conf"

    @property
    def parent_gmm_alignments(self) -> str:
        return os.path.join(
            self.conf.get("directories", "expdir"), self.conf.get("mono_gmm", "name"), "ali"
        )

    @property
    def trainops(self) -> str:
        return f"{self.conf.get('tri_gmm', 'num_leaves')} {self.conf.get('tri_gmm', 'tot_gauss')}"


class LdaGmm(GMM):
    """LDA+MLLT GMM (gmm.py:189-218)."""

    name_key = ("lda_mllt", "name")
    trainscript = "steps/train_lda_mllt.sh"
    conf_file = "lda_mllt.conf"

    @property
    def parent_gmm_alignments(self) -> str:
        return os.path.join(
            self.conf.get("directories", "expdir"), self.conf.get("tri_gmm", "name"), "ali"
        )

    @property
    def trainops(self) -> str:
        context = shlex.quote(f"--context_width={self.conf.get('lda_mllt', 'context_width')}")
        return (
            f"--context-opts {context} "
            f"{self.conf.get('lda_mllt', 'num_leaves')} {self.conf.get('lda_mllt', 'tot_gauss')}"
        )
