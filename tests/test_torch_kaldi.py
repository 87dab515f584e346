"""The port's Kaldi orchestration (tfkaldi_tpu_torch/kaldi/) against the
contracts of tests/test_gmm.py, test_fake_kaldi.py and test_score_parse.py,
and against the JAX package's modules: every command line the port's
``run_checked`` receives is captured beside the one the JAX module's
receives for the same config, and the two must be equal. Also the
``--steps`` words of the port's ``cli.main`` against the JAX CLI's."""

import gzip
import os
import stat
import sys
from configparser import ConfigParser

import pytest

import tfkaldi_tpu.kaldi as jax_kaldi
from tests.test_score_parse import _aurora4_style
from tfkaldi_tpu.cli import main as jax_cli
from tfkaldi_tpu_torch import kaldi
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.kaldi import LdaGmm, MonoGmm, TriGmm
from tfkaldi_tpu_torch.kaldi.decode_wfst import WfstDecodeOpts, best_wer, decode_wfst


@pytest.fixture
def conf(tmp_path):
    c = ConfigParser()
    c["directories"] = {
        "expdir": str(tmp_path / "exp"),
        "train_features": str(tmp_path / "feat"),
        "test_features": str(tmp_path / "testfeat"),
        "language": "/lang",
        "language_test": "/lang_test",
        "kaldi_egs": str(tmp_path),
    }
    c["general"] = {"num_jobs": "2", "cmd": "run.pl"}
    c["gmm-features"] = {"name": "feats"}
    c["mono_gmm"] = {"name": "mono"}
    c["tri_gmm"] = {"name": "tri", "num_leaves": "100", "tot_gauss": "400"}
    c["lda_mllt"] = {"name": "lda", "context_width": "3", "num_leaves": "200", "tot_gauss": "800"}
    return c


@pytest.fixture
def captured(monkeypatch):
    """``run`` calls a port operation and its JAX twin with every
    subprocess captured, asserts the two command lists are equal and returns
    the port's ``[(cmd, cwd), ...]``."""
    calls = {"port": [], "jax": []}
    for side, package in (("port", "tfkaldi_tpu_torch"), ("jax", "tfkaldi_tpu")):
        def fake_run(cmd, cwd=None, _calls=calls[side]):
            _calls.append((cmd, cwd))

        for module in ("gmm", "decode_wfst"):
            monkeypatch.setattr(sys.modules[f"{package}.kaldi.{module}"], "run_checked", fake_run)

    def run(port_call, jax_call):
        port_call()
        jax_call()
        assert calls["port"] == calls["jax"]
        out = list(calls["port"])
        calls["port"].clear()
        calls["jax"].clear()
        return out

    return run


def _gmm(conf, captured, name, op):
    return captured(lambda: getattr(getattr(kaldi, name)(conf), op)(),
                    lambda: getattr(getattr(jax_kaldi, name)(conf), op)())


def test_mono_train_commands(conf, captured):
    calls = _gmm(conf, captured, "MonoGmm", "train")
    train_cmd, cwd = calls[0]
    assert train_cmd.startswith("steps/train_mono.sh --cmd run.pl --config ")
    assert "--nj 2" in train_cmd and "/lang " in train_cmd
    assert train_cmd.endswith(f"{conf.get('directories', 'expdir')}/mono")
    assert cwd == conf.get("directories", "kaldi_egs")
    graph_cmd, _ = calls[1]
    assert graph_cmd.startswith("utils/mkgraph.sh --mono /lang_test")
    assert graph_cmd.endswith("/mono/graph")


def test_tri_train_uses_mono_alignments(conf, captured):
    cmd, _ = _gmm(conf, captured, "TriGmm", "train")[0]
    assert cmd.startswith("steps/train_deltas.sh")
    assert "100 400" in cmd  # num_leaves tot_gauss
    assert os.path.join(conf.get("directories", "expdir"), "mono", "ali") in cmd


def test_lda_train_context_opts(conf, captured):
    cmd, _ = _gmm(conf, captured, "LdaGmm", "train")[0]
    assert cmd.startswith("steps/train_lda_mllt.sh")
    assert "--context-opts" in cmd and "--context_width=3" in cmd
    assert "200 800" in cmd
    assert os.path.join(conf.get("directories", "expdir"), "tri", "ali") in cmd


@pytest.mark.parametrize("name", ["MonoGmm", "TriGmm", "LdaGmm"])
def test_align_builds_ali_to_pdf_pipeline(conf, captured, name):
    calls = _gmm(conf, captured, name, "align")
    align_cmd, _ = calls[0]
    assert align_cmd.startswith("steps/align_si.sh --nj 2 --cmd run.pl")
    assert align_cmd.endswith("/ali")
    # one conversion pipe per job (gmm.py:70-76)
    pipes = [c for c, _ in calls[1:]]
    assert len(pipes) == 2
    for i, cmd in enumerate(pipes, start=1):
        assert "gunzip -c" in cmd and f"ali.{i}.gz" in cmd
        assert "ali-to-pdf" in cmd and f"pdf.{i}.gz" in cmd


@pytest.mark.parametrize("name", ["MonoGmm", "TriGmm", "LdaGmm"])
def test_gmm_test_command(conf, captured, name):
    cmd, _ = _gmm(conf, captured, name, "test")[0]
    assert cmd.startswith("steps/decode.sh --cmd run.pl --nj 2")
    assert conf.get("directories", "test_features") + "/feats" in cmd


def test_merge_alignments(conf, tmp_path):
    ali_dir = tmp_path / "exp" / "mono" / "ali"
    ali_dir.mkdir(parents=True)
    for i, content in ((1, "utt1 0 1\n"), (2, "utt2 2 3\n")):
        with gzip.open(ali_dir / f"pdf.{i}.gz", "wt") as f:
            f.write(content)
    out = MonoGmm(conf).merge_alignments()
    with gzip.open(out, "rt") as f:
        assert f.read() == "utt1 0 1\nutt2 2 3\n"
    assert cli_main.merge_alignments is kaldi.merge_alignments  # the CLI's merge is this one


def test_decode_wfst_latgen_command(conf, captured, tmp_path):
    decode_dir = tmp_path / "exp" / "nnet" / "decode"
    calls = captured(
        lambda: decode_wfst("/graph", "/data", str(decode_dir), str(tmp_path), WfstDecodeOpts(nj=2)),
        lambda: jax_kaldi.decode_wfst("/graph", "/data", str(decode_dir), str(tmp_path),
                                      jax_kaldi.WfstDecodeOpts(nj=2)),
    )
    split_cmd, _ = calls[0]
    assert split_cmd == "utils/split_data.sh /data 2"
    latgen, _ = calls[1]
    assert "latgen-faster-mapped " in latgen  # single-thread variant
    for flag in ("--max-active=7000", "--min-active=200", "--beam=15.0", "--lattice-beam=8.0",
                 "--acoustic-scale=0.1", "--allow-partial=true", "--word-symbol-table=/graph/words.txt",
                 "/graph/HCLG.fst", "copy-feats scp:/data/split2/JOB/feats.scp"):
        assert flag in latgen, flag
    score, _ = calls[2]
    assert score.startswith("local/score.sh")
    assert (decode_dir / "num_jobs").read_text() == "2\n"


def test_decode_wfst_parallel_variant(conf, captured, tmp_path):
    opts = dict(nj=1, num_threads=4, skip_scoring=True)
    calls = captured(
        lambda: decode_wfst("/graph", "/data", str(tmp_path / "d"), str(tmp_path), WfstDecodeOpts(**opts)),
        lambda: jax_kaldi.decode_wfst("/graph", "/data", str(tmp_path / "d"), str(tmp_path),
                                      jax_kaldi.WfstDecodeOpts(**opts)),
    )
    assert "latgen-faster-mapped-parallel --num-threads=4" in calls[1][0]
    assert len(calls) == 2  # no scoring call


def test_wfst_defaults_are_the_reference_decode():
    """decode.sh:4-16: beam 15, max_active 7000, min_active 200, lattice
    beam 8, acwt 0.1; every default equal to the JAX package's."""
    opts = WfstDecodeOpts()
    assert (opts.beam, opts.max_active, opts.min_active, opts.lattice_beam, opts.acwt) == (15.0, 7000, 200, 8.0, 0.1)
    assert vars(opts) == vars(jax_kaldi.WfstDecodeOpts())


def test_best_wer(tmp_path):
    (tmp_path / "wer_10").write_text("%WER 12.34 [ 100 / 810 ]\n")
    (tmp_path / "wer_11").write_text("%WER 11.50 [ 93 / 810 ]\n")
    (tmp_path / "other").write_text("%WER 1.0\n")
    out = best_wer(str(tmp_path))
    assert "11.5" in out and "wer_11" in out


def test_run_checked_raises_under_pipefail(tmp_path):
    """A failure anywhere in a pipeline propagates (``bash -o pipefail``),
    and the command runs in ``cwd``."""
    from tfkaldi_tpu_torch.kaldi.gmm import run_checked

    run_checked("pwd > where.txt", cwd=str(tmp_path))
    assert (tmp_path / "where.txt").read_text().strip() == str(tmp_path)
    with pytest.raises(Exception, match="returned non-zero"):
        run_checked("false | cat", cwd=str(tmp_path))


# ---------------------------------------------------------------------------
# against stub Kaldi scripts (tests/test_fake_kaldi.py)
# ---------------------------------------------------------------------------

def _write_exec(path, body):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("#!/bin/bash\nset -e\n" + body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


@pytest.fixture
def egs(tmp_path, monkeypatch):
    """The stub egs of tests/test_fake_kaldi.py: steps/utils scripts that
    check their invocation and leave what the next stage reads, and fake
    binaries on PATH."""
    egs = tmp_path / "egs"
    bindir = egs / "fakebin"
    _write_exec(str(bindir / "ali-to-pdf"),
                'awk \'{ printf "%s", $1; for (i=2; i<=NF; i++) printf " %d", int($i/2); print "" }\'\n')
    _write_exec(
        str(bindir / "run.pl"),
        'while [[ "$1" == --* ]]; do shift 2; done\n'
        "spec=$1; shift\nlog=$1; shift\n"
        'n=${spec##*:}\nfor j in $(seq 1 "$n"); do\n'
        '  thislog=${log//JOB/$j}\n  mkdir -p "$(dirname "$thislog")"\n'
        '  cmd="$*"\n  cmd=${cmd//JOB/$j}\n  bash -c "$cmd" > "$thislog" 2>&1\ndone\n',
    )
    path_line = f'export PATH="{bindir}:$PATH"\n'
    _write_exec(
        str(egs / "steps" / "train_mono.sh"),
        path_line + 'while [[ "$1" == --* ]]; do shift 2; done\n'
        'featdir=$1; lang=$2; expdir=${!#}\n'
        'test -f "$featdir/feats.scp"\n'
        'mkdir -p "$expdir"\necho fake-mdl > "$expdir/final.mdl"\n',
    )
    _write_exec(
        str(egs / "utils" / "mkgraph.sh"),
        'while [[ "$1" == --* ]]; do shift; done\n'
        'graph=${!#}\nmkdir -p "$graph"\necho 42 > "$graph/num_pdfs"\n'
        'echo fake-fst > "$graph/HCLG.fst"\necho "a 1" > "$graph/words.txt"\n',
    )
    _write_exec(
        str(egs / "steps" / "align_si.sh"),
        path_line + 'nj=2\nwhile [[ "$1" == --* ]]; do if [[ "$1" == --nj ]]; then nj=$2; fi; shift 2; done\n'
        'alidir=${!#}\nmkdir -p "$alidir"\ncp "$(dirname "$alidir")/final.mdl" "$alidir/final.mdl"\n'
        'for j in $(seq 1 "$nj"); do\n'
        '  echo "utt$j 2 4 6" | gzip > "$alidir/ali.$j.gz"\ndone\n',
    )
    _write_exec(
        str(egs / "utils" / "split_data.sh"),
        'data=$1; nj=$2\nfor j in $(seq 1 "$nj"); do\n'
        '  mkdir -p "$data/split$nj/$j"\n'
        '  cp "$data/feats.scp" "$data/split$nj/$j/feats.scp"\ndone\n',
    )
    _write_exec(
        str(egs / "local" / "score.sh"),
        'while [[ "$1" == --* ]]; do shift 2; done\n'
        'decode_dir=${!#}\necho "%WER 7.77 [ 77 / 990 ]" > "$decode_dir/wer_9"\n'
        'echo "%WER 8.88 [ 88 / 990 ]" > "$decode_dir/wer_10"\n',
    )
    _write_exec(str(bindir / "latgen-faster-mapped"), "cat > /dev/null || true\necho lat\n")
    _write_exec(str(bindir / "copy-feats"), "echo feats\n")
    monkeypatch.setenv("PATH", f"{bindir}:" + os.environ["PATH"])
    return egs


@pytest.fixture
def stub_conf(tmp_path, egs):
    c = ConfigParser()
    featdir = tmp_path / "feat" / "feats"
    featdir.mkdir(parents=True)
    (featdir / "feats.scp").write_text("utt1 a.ark:0\n")
    c["directories"] = {
        "expdir": str(tmp_path / "exp"),
        "train_features": str(tmp_path / "feat"),
        "test_features": str(tmp_path / "feat"),
        "language": "/lang",
        "language_test": "/lang_test",
        "kaldi_egs": str(egs),
    }
    c["general"] = {"num_jobs": "2", "cmd": "run.pl"}
    c["gmm-features"] = {"name": "feats"}
    c["mono_gmm"] = {"name": "mono"}
    return c


def test_mono_train_align_merge_against_stubs(stub_conf):
    gmm = MonoGmm(stub_conf)
    gmm.train()
    assert os.path.isfile(os.path.join(gmm.expdir, "final.mdl"))
    assert open(os.path.join(gmm.expdir, "graph", "num_pdfs")).read().strip() == "42"
    gmm.align()
    for j in (1, 2):
        with gzip.open(os.path.join(gmm.expdir, "ali", f"pdf.{j}.gz"), "rt") as f:
            # ali-to-pdf stub halves the transition ids 2 4 6 -> 1 2 3
            assert f.read().strip() == f"utt{j} 1 2 3"
    with gzip.open(gmm.merge_alignments(), "rt") as f:
        assert f.read() == "utt1 1 2 3\nutt2 1 2 3\n"


def test_decode_wfst_against_stubs(stub_conf, tmp_path, egs):
    srcdir = tmp_path / "exp" / "nnet"
    decode_dir = srcdir / "decode"
    srcdir.mkdir(parents=True)
    (srcdir / "final.mdl").write_text("fake\n")
    graph = tmp_path / "graph"
    graph.mkdir()
    (graph / "HCLG.fst").write_text("fst\n")
    (graph / "words.txt").write_text("a 1\n")
    decode_wfst(str(graph), str(tmp_path / "feat" / "feats"), str(decode_dir), str(egs), WfstDecodeOpts(nj=2))
    # the run.pl stub ran latgen once per job and wrote logs
    assert os.path.isfile(decode_dir / "log" / "decode.1.log")
    assert os.path.isfile(decode_dir / "log" / "decode.2.log")
    assert (decode_dir / "num_jobs").read_text() == "2\n"
    # the scoring stub wrote wer files; best_wer picks the lowest
    assert "7.77" in best_wer(str(decode_dir))


def test_gmm_steps_fail_loudly_without_kaldi(stub_conf, tmp_path):
    """A missing Kaldi script is an error, not a silent skip."""
    stub_conf.set("directories", "kaldi_egs", str(tmp_path))
    with pytest.raises(Exception, match="returned non-zero"):
        MonoGmm(stub_conf).train()


# ---------------------------------------------------------------------------
# best_wer on Kaldi's scoring output (tests/test_score_parse.py)
# ---------------------------------------------------------------------------

def test_aurora4_score_sh_format(tmp_path):
    d = str(tmp_path)
    _aurora4_style(d, 10, "0.0", 9.12, 120, 210, 1024)
    _aurora4_style(d, 14, "0.5", 8.31, 110, 190, 934)
    _aurora4_style(d, 17, "1.0", 8.77, 100, 250, 952)
    out = best_wer(d)
    assert out.startswith("%WER 8.31 [") and out.endswith("[wer_14_0.5]")
    assert "1234 / 14850" in out


def test_old_style_single_penalty(tmp_path):
    d = str(tmp_path)
    for lmwt, wer in [(9, 12.3), (10, 11.9), (11, 12.0)]:
        with open(os.path.join(d, f"wer_{lmwt}"), "w") as f:
            f.write("compute-wer --text --mode=present ark:t.txt ark,p:- \n")
            f.write(f"%WER {wer} [ {int(wer * 10)} / 1000, 3 ins, 4 del, 5 sub ]\n")
    assert "[wer_10]" in best_wer(d) and "%WER 11.9" in best_wer(d)


def test_tie_breaks_deterministically(tmp_path):
    d = str(tmp_path)
    _aurora4_style(d, 17, "1.0", 8.31, 100, 250, 952)
    _aurora4_style(d, 10, "0.0", 8.31, 120, 210, 1024)
    assert "[wer_10_0.0]" in best_wer(d)


def test_malformed_lines_skipped(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "wer_9"), "w") as f:
        f.write("%WER garbage [ x / y ]\n%WER\n")
    with open(os.path.join(d, "wer_10"), "w") as f:
        f.write("%WER 10.5 [ 105 / 1000, 1 ins, 2 del, 3 sub ]\n")
    out = best_wer(d)
    assert "%WER 10.5" in out and "[wer_10]" in out


def test_binary_garbage_does_not_crash(tmp_path):
    with open(tmp_path / "wer_9", "wb") as f:
        f.write(b"\xff\xfe%WER 9.9 [ 99 / 1000 ]\n\x00\x80")
    assert "%WER 9.9" in best_wer(str(tmp_path))


def test_no_wer_files(tmp_path):
    assert best_wer(str(tmp_path)) == "no wer_* files found"


def test_wer_named_directory_ignored(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "wer_details"))
    _aurora4_style(d, 10, "0.0", 8.31, 120, 210, 904)
    assert "%WER 8.31" in best_wer(d)


def test_best_wer_agrees_with_jax_on_every_fixture(tmp_path):
    d = str(tmp_path)
    for i, (lmwt, pen, wer) in enumerate([(10, "0.0", 9.12), (14, "0.5", 8.31), (17, "1.0", 8.31)]):
        _aurora4_style(d, lmwt, pen, wer, 100 + i, 200, 900)
    (tmp_path / "wer_9").write_bytes(b"%WER bad\n\xff")
    assert best_wer(d) == jax_kaldi.best_wer(d)


# ---------------------------------------------------------------------------
# --steps of cli.main
# ---------------------------------------------------------------------------

def test_steps_all_and_default_resolve_to_the_jax_step_sets():
    """``--steps all`` and ``--steps default`` name the JAX CLI's step sets
    (tfkaldi_tpu/cli/main.py:40-54, 160-169); the steps are the same list in
    the same order; an unknown step is refused."""
    assert cli_main.STEPS == jax_cli.STEPS
    assert cli_main.DEFAULT_STEPS == jax_cli.DEFAULT_STEPS
    assert cli_main.resolve_steps("all") == set(jax_cli.STEPS)
    assert cli_main.resolve_steps("default") == set(jax_cli.DEFAULT_STEPS)
    assert cli_main.resolve_steps(" train_nnet, test_nnet ") == {"train_nnet", "test_nnet"}
    assert cli_main.parse_args(["--config", "x.cfg"]).steps == jax_cli.parse_args(["--config", "x.cfg"]).steps
    with pytest.raises(ValueError, match="unknown steps: bogus"):
        cli_main.resolve_steps("train_nnet,bogus")
