"""``python -m tfkaldi_tpu_torch.parallel.dryrun --nproc 4 --device cpu``:
every family's step and the training controller on a 2x2 grid of gloo
ranks, held against one process by the dry run itself
(tfkaldi_tpu_torch/parallel/dryrun.py), in a process that cannot import
``jax`` or ``tfkaldi_tpu``, nor can any rank it spawns."""

import subprocess
import sys

from tests.test_torch_distributed_cli import ROOT, blocked_env

FAMILIES = ("dnn_bn", "lstm_ce", "lstm_ctc", "tdnn", "cnn", "gru", "conformer", "transducer", "transducer_pruned",
            "conformer_transducer", "seq2seq")


def test_dryrun_on_a_2x2_grid_matches_one_process(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "tfkaldi_tpu_torch.parallel.dryrun", "--nproc", "4", "--device",
                           "cpu", "--workdir", str(tmp_path / "work")], env=blocked_env(str(tmp_path)),
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun OK: 2x2 grid of 4 cpu ranks"), line
    for family in FAMILIES:
        assert f" {family} " in line, family
    assert "controller: 8 steps" in line and "32 utterances emitted" in line, line
