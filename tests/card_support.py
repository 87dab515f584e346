"""What the card suite's recipe runs and chip_smoke.py share: the
synthetic workspaces under ``build/card_suite``, ``cli.main`` runs with the
kernels' launch counters reset before and read after, the batches and
readers the phases take from a workspace, and the ``cli.serve --stream``
server and clients.

Every ``cli_run`` of a process is kept in :data:`RUNS` by name, so that
what runs the card suite in-process (chip_smoke.py) reads the main paths'
launch counts and the models this very run trained, never files an earlier
tree left. Nothing here asserts more than that a run came back with rc 0;
the checks are the card tests'. The module imports no JAX.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import time
from configparser import ConfigParser

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "build", "card_suite")
WORK = os.path.join(SUITE, "served")
TRAIN_WORK = os.path.join(SUITE, "train")
# 800 utterances: 2 validation batches of 128 and 4.25 training batches; one epoch is 6 steps
TRAIN_UTTS = 800
LOWERED = {"num_epochs": 1, "valid_frequency": 2, "check_freq": 2}
# full width of the flagship recipe (config/config_AURORA4.cfg, bench.py:22)
NUM_PDFS = 2000
HIDDEN_UNITS = 2048
HIDDEN_LAYERS = 6
# the character-CTC recipe: 35 characters + the blank
CTC_CLASSES = 36
# the attention and transducer recipes' transcripts: at most T/8 labels (the CTC head sees every fourth frame)
ATT_TEXT_DENSITY = 8
STREAM_CHUNK = 1600  # samples a client chunk: 100 ms at 16 kHz
STREAM_CLIENT_TIMEOUT = 300.0  # seconds a client socket waits for a reply before the run fails

# every cli_run of this process by name (a name run again keeps its last run)
RUNS: dict = {}

def reset_counts() -> None:
    """Every counter :func:`counters` reads, to 0."""
    from tfkaldi_tpu_torch import layers
    from tfkaldi_tpu_torch.data import bulk_loader
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
    from tfkaldi_tpu_torch.ops import bf16_split, bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train import trainer as trainer_mod

    fused_mlp.launches = fp.launches = bn_fused_bwd.launches = 0
    for counts in (fused_mlp.launches_by_route, bn_fused_bwd.launches_by_route, fp.launches_by_route,
                   ctc.launches_by_route, ctc_decode.beam_runs, seq2seq_decode.rescored, trainer_mod.rnnt_routes,
                   bulk_loader.batches, bf16_split.launches_by_route, layers.product_routes):
        for route in counts:
            counts[route] = 0
    for c in (lstm_bidi.CELL, gru_bidi.CELL):
        c.reset_counts()


def counters() -> dict:
    """The seven kernels' launch counters (the recurrences' by route) and,
    by route, kernels 1, 2 and 3, the CTC loss, the CTC beams, the
    rescoring, the RNN-T loss, the bulk loader's batches, the split kernel
    and ``layers.product``."""
    from tfkaldi_tpu_torch import layers
    from tfkaldi_tpu_torch.data import bulk_loader
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
    from tfkaldi_tpu_torch.ops import bf16_split, bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train import trainer as trainer_mod

    kernels = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches, "bn_dgrad": bn_fused_bwd.launches}
    for name, c in (("lstm", lstm_bidi.CELL), ("gru", gru_bidi.CELL)):
        kernels.update({f"{name}_{k}": getattr(c, f"{k}_launches") for k in ("fwd_persistent", "fwd",
                                                                               "bwd_persistent", "bwd")})
    return {**kernels, "ffn_routes": dict(fused_mlp.launches_by_route),
            "bn_routes": dict(bn_fused_bwd.launches_by_route), "frame_routes": dict(fp.launches_by_route),
            "ctc_loss": dict(ctc.launches_by_route), "beams": dict(ctc_decode.beam_runs),
            "rescored": dict(seq2seq_decode.rescored), "rnnt": dict(trainer_mod.rnnt_routes),
            "bulk": dict(bulk_loader.batches), "split": dict(bf16_split.launches_by_route),
            "product": dict(layers.product_routes)}


@contextlib.contextmanager
def counting_validations():
    """The controller's validation passes (its ``validation loss at step``
    log lines, at INFO whatever the root logger's level) while a path runs;
    yields the list of their steps."""
    import logging

    seen = []
    handler = logging.Handler()
    handler.emit = lambda r: seen.append(r.args[0]) if r.getMessage().startswith("validation loss at step") else None
    logger = logging.getLogger("tfkaldi_tpu_torch.train.controller")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@contextlib.contextmanager
def decode_launches():
    """Kernel 1's launches inside ``Nnet.decode`` (``test_nnet``'s
    likelihoods), counted apart from the validations' in the same run."""
    from tfkaldi_tpu_torch import nnet as nnet_mod
    from tfkaldi_tpu_torch.ops import fused_mlp

    counted = {"fused_ffn": 0}
    original = nnet_mod.Nnet.decode

    def decode(self, *args, **kw):
        before = fused_mlp.launches
        try:
            return original(self, *args, **kw)
        finally:
            counted["fused_ffn"] += fused_mlp.launches - before

    nnet_mod.Nnet.decode = decode
    try:
        yield counted
    finally:
        nnet_mod.Nnet.decode = original


def log(*parts) -> None:
    print(*parts, flush=True)


@dataclasses.dataclass
class Run:
    """A ``cli.main`` run: its config, savedir, ``metrics.jsonl`` steps,
    :func:`counters` right after it, the validations' steps, and kernel 1's
    launches inside ``test_nnet``'s decode."""
    cfg_path: str
    config: ConfigParser
    savedir: str
    steps: list
    counts: dict
    validations: list
    in_decode: int

    @property
    def conf(self) -> dict:
        return dict(self.config.items("nnet"))


def variant_config(src: str, path: str, nnet: dict | None = None, dirs: dict | None = None) -> str:
    """``src`` with the ``[nnet]`` keys ``nnet`` and (``dirs``: kind ->
    featdir) the feature directories, written to ``path``."""
    config = ConfigParser()
    config.read(src)
    for kind, featdir in (dirs or {}).items():
        config.set("directories", f"{kind}_features", os.path.dirname(featdir))
    for key, value in (nnet or {}).items():
        config.set("nnet", key, str(value))
    with open(path, "w") as f:
        config.write(f)
    return path


def cli_run(ws: dict, name: str, nnet: dict | None = None, dirs: dict | None = None,
            steps: str = "train_nnet,test_nnet") -> Run:
    """``cli.main --steps steps`` on ``ws``'s config, or (``nnet``) on its
    variant ``config_<name>.cfg`` beside it; the counters reset before and
    read after."""
    from tfkaldi_tpu_torch.cli import main as cli_main

    cfg_path = ws["cfg_path"]
    if nnet or dirs:
        cfg_path = variant_config(cfg_path, os.path.join(os.path.dirname(cfg_path), f"config_{name}.cfg"), nnet,
                                  dirs)
    config = ConfigParser()
    config.read(cfg_path)
    savedir = os.path.join(config.get("directories", "expdir"), config.get("nnet", "name"))
    reset_counts()
    torch.cuda.synchronize()
    with counting_validations() as validations, decode_launches() as in_decode:
        rc = cli_main.main(["--config", cfg_path, "--steps", steps])
    torch.cuda.synchronize()
    assert rc == 0, f"cli.main {name}: rc {rc}"
    metrics = os.path.join(savedir, "metrics.jsonl")
    records = []
    if os.path.isfile(metrics):
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
    run = Run(cfg_path, config, savedir, records, counters(), list(validations), in_decode["fused_ffn"])
    RUNS[name] = run
    return run

def train_batch(featdir: str, conf: dict, *, text: bool, context: int = 0, alifile: str | None = None,
                lists: bool = False):
    """The batch of ``conf``'s ``batch_size`` utterances past the validation
    carve (``valid_batches``), from the featdir's shuffled scp (its scp where
    it has none): frame labels from ``alifile`` or (``text``) the featdir's
    transcripts; a padded batch on the host, or (``lists``) the inputs and
    targets as the dispenser reads them."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser, TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder, TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer, identity_normalizer

    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    scp = "feats_shuffled.scp" if os.path.isfile(os.path.join(featdir, "feats_shuffled.scp")) else "feats.scp"
    reader = FeatureReader(os.path.join(featdir, scp), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), context, max_length)
    size = int(conf["batch_size"])
    if text:
        dispenser = TextBatchDispenser(reader, TextCoder(aurora4_normalizer), size, os.path.join(featdir, "text"))
    else:
        dispenser = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS), size, alifile)
    for _ in range(int(conf["valid_batches"])):
        dispenser.skip_batch()
    batch = dispenser.get_batch() if lists else dispenser.get_padded_batch(DeviceBatcher())
    reader.close()
    return batch


def alifile_of(config) -> str:
    return os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz")


def eval_reader(featdir: str, context: int = 0):
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader

    return FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                         os.path.join(featdir, "utt2spk"), context, 0)

# ---------------------------------------------------------------------------
# the workspaces
# ---------------------------------------------------------------------------

def workspace(cfg_path: str) -> dict:
    """A synthetic workspace's config path, parsed config, featdirs, model
    dir and splice context, read back from its config."""
    config = ConfigParser()
    config.read(cfg_path)
    feat_name = config.get("dnn-features", "name")
    return {"cfg_path": cfg_path, "config": config,
            "train_featdir": os.path.join(config.get("directories", "train_features"), feat_name),
            "test_featdir": os.path.join(config.get("directories", "test_features"), feat_name),
            "savedir": os.path.join(config.get("directories", "expdir"), config.get("nnet", "name")),
            "context": config.getint("nnet", "context_width")}


def served_workspace() -> dict:
    """The served path at full width on a seeded workspace (32 + 32 wavs of
    1-8 s, 4 speakers; a seeded 440 -> 6x2048 -> 2000 batchnorm DNN):
    ``cli.main --steps dnn_train_features,dnn_test_features``, then ``--steps
    test_nnet``, then ``cli.serve --once`` answering 3 spool jobs; the
    counters reset before and read after."""
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.cli import serve as cli_serve

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ws = synthetic.make_workspace(WORK, num_pdfs=NUM_PDFS, hidden_units=HIDDEN_UNITS, hidden_layers=HIDDEN_LAYERS)
    spool_in, spool_out = os.path.join(WORK, "spool", "in"), os.path.join(WORK, "spool", "out")
    jobs = {"job0": ws["test_featdir"], "job1": ws["train_featdir"], "job2": ws["test_featdir"]}
    reset_counts()
    assert cli_main.main(["--config", ws["cfg_path"], "--steps", "dnn_train_features,dnn_test_features"]) == 0
    for name, src in jobs.items():
        shutil.copytree(src, os.path.join(spool_in, name))
    assert cli_main.main(["--config", ws["cfg_path"], "--steps", "test_nnet"]) == 0
    assert cli_serve.main(["--config", ws["cfg_path"], "--watch", spool_in, "--out", spool_out, "--once"]) == 0
    torch.cuda.synchronize()
    RUNS["served"] = Run(ws["cfg_path"], ws["config"], ws["savedir"], [], counters(), [], 0)
    return {**ws, "spool_out": spool_out, "jobs": jobs, "counts": RUNS["served"].counts}


def train_workspace() -> tuple[dict, Run]:
    """The training workspace (800 train wavs of 2-5.1 s, so T_pad = 512 and
    a batch of 128 is 65,536 frames; 32 test wavs; a pdf alignment over 2000
    pdfs) and the recipe's f32 DNN trained and decoded on it: ``cli.main
    --steps dnn_train_features,dnn_test_features,train_nnet,test_nnet``."""
    from tfkaldi_tpu_torch import synthetic

    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    os.makedirs(TRAIN_WORK)
    ws = synthetic.make_train_workspace(
        TRAIN_WORK, num_pdfs=NUM_PDFS, hidden_units=HIDDEN_UNITS, hidden_layers=HIDDEN_LAYERS,
        num_train=TRAIN_UTTS, num_test=32, min_seconds=2.0, max_seconds=5.1, nnet=LOWERED)
    return ws, cli_run(ws, "dnn", steps="dnn_train_features,dnn_test_features,train_nnet,test_nnet")


def attention_featdirs(ws: dict) -> dict:
    """The training workspace's features with transcripts of at most an
    eighth of each utterance's frames, written beside them (the attention
    and transducer recipes read them)."""
    from tfkaldi_tpu_torch import synthetic

    dirs = {}
    for kind, seed in (("train", 30), ("test", 31)):
        src = ws[f"{kind}_featdir"]
        root = os.path.join(TRAIN_WORK, "attention_features", kind)
        dirs[kind] = os.path.join(root, os.path.basename(src))
        shutil.rmtree(root, ignore_errors=True)
        synthetic.retext_featdir(src, dirs[kind], seed=seed, density=ATT_TEXT_DENSITY)
    return dirs


def recipe_nnet(kind: str) -> dict:
    """The ``[nnet]`` of a recipe as written, the three keys lowered:
    ``lstm`` / ``gru`` (the recurrent network under frame CE), ``ctc``,
    ``attention``, ``transducer``, ``tdnn``, ``cnn``."""
    from tfkaldi_tpu_torch import synthetic

    base = {"lstm": lambda: synthetic.recurrent_nnet("lstm"), "gru": lambda: synthetic.recurrent_nnet("gru"),
            "ctc": synthetic.ctc_nnet, "attention": synthetic.attention_nnet,
            "transducer": synthetic.transducer_nnet, "tdnn": synthetic.tdnn_nnet, "cnn": synthetic.cnn_nnet}[kind]
    return {**base(), **LOWERED}

# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stream_server(cfg_path: str, *flags: str):
    """``cli.serve.main([--config cfg, --stream, --port-file f, *flags],
    stop=...)`` in a thread; yields ``(host, port, server)`` once the port
    file is written (the ``MultiStreamServer`` caught as it is built). On
    exit the server is stopped and joined; an exception of ``main`` or a
    return code other than 0 raises."""
    import threading

    from tfkaldi_tpu_torch import serve as serve_mod
    from tfkaldi_tpu_torch.cli import serve as cli_serve

    os.makedirs(SUITE, exist_ok=True)
    port_file = os.path.join(SUITE, f"port_{time.perf_counter_ns()}")
    servers, rc, errors = [], [], []
    build = serve_mod.MultiStreamServer.__init__

    def init(self, *args, **kwargs):
        build(self, *args, **kwargs)
        servers.append(self)

    stop = threading.Event()

    def run():
        try:
            rc.append(cli_serve.main(["--config", cfg_path, "--stream", "--port-file", port_file, *flags],
                                     stop=stop.is_set))
        except BaseException as exc:  # re-raised on the phase's thread
            errors.append(exc)

    serve_mod.MultiStreamServer.__init__ = init
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        deadline = time.time() + 300
        address = []
        while len(address) != 2:
            if errors or not thread.is_alive() or time.time() > deadline:
                raise RuntimeError(f"cli.serve --stream {' '.join(flags)} did not come up: {errors or rc}")
            time.sleep(0.05)
            if os.path.exists(port_file):
                with open(port_file) as f:
                    address = f.read().split()
        yield address[0], int(address[1]), servers[0]
    finally:
        serve_mod.MultiStreamServer.__init__ = build
        stop.set()
        thread.join(timeout=120)
    if thread.is_alive():
        raise RuntimeError("the streaming server did not stop within 120 s")
    if errors:
        raise errors[0]
    if rc != [0]:
        raise RuntimeError(f"cli.serve --stream returned {rc}")


def stream_clients(host: str, port: int, audios: list, concurrency: int, requests: bool = False) -> dict:
    """``stream_transcribe`` clients, ``concurrency`` at once, over
    ``audios``: each one's final, its partial count and (``requests``) its
    timestamps, confidences and words read back on the same connection; the
    client-side reply latency of every chunk (send to reply) and of every
    finish; the wall time. A client's error, an ``E`` reply or a missing
    reply (the socket timeout) raises."""
    import queue
    import socket
    import threading

    from tfkaldi_tpu_torch import serve as serve_mod

    todo = queue.Queue()
    for i in range(len(audios)):
        todo.put(i)
    out = [None] * len(audios)
    chunk_s, finish_s, errors = [], [], []

    def one(i: int):
        samples = np.ascontiguousarray(audios[i], dtype="<f4")
        mine, partials, final = [], 0, None
        with socket.create_connection((host, port), timeout=STREAM_CLIENT_TIMEOUT) as sock:
            gen = serve_mod._send_audio(sock, samples, STREAM_CHUNK)
            while True:
                t = time.perf_counter()
                try:
                    next(gen)
                except StopIteration as end:
                    final = end.value
                    (finish_s if partials == -(-len(samples) // STREAM_CHUNK) else mine).append(
                        time.perf_counter() - t)
                    break
                mine.append(time.perf_counter() - t)
                partials += 1
            extra = {}
            if requests:
                extra["times"] = np.frombuffer(serve_mod._request(sock, serve_mod.MSG_TIMES_REQ, serve_mod.MSG_TIMES),
                                               "<f8")
                extra["confs"] = np.frombuffer(serve_mod._request(sock, serve_mod.MSG_CONF_REQ, serve_mod.MSG_CONF),
                                               "<f8")
                extra["words"] = json.loads(serve_mod._request(sock, serve_mod.MSG_WORDS_REQ, serve_mod.MSG_WORDS))
        chunk_s.extend(mine)
        return {"final": final, "partials": partials, "early": partials < -(-len(samples) // STREAM_CHUNK), **extra}

    def worker():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            try:
                out[i] = one(i)
            except Exception as exc:  # re-raised on the phase's thread
                errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or errors:
        raise RuntimeError(f"streaming clients failed: {errors or 'a client hung'}")
    return {"results": out, "chunk_s": chunk_s, "finish_s": finish_s, "wall_s": wall}
