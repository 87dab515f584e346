"""Nothing of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and nothing names the JAX package's
harness or its records."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tfkaldi_tpu"}


def _sources():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_import():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {name.split(".")[0] for name in _imports(os.path.join(ref, f))}
            assert "tfkaldi_tpu_torch" not in tops, f


def test_no_reference_to_the_jax_harness():
    words = ["bench" + ".py", "bench" + "marks/", "BENCH" + "_r", "MULTI" + "CHIP_", "BASE" + "LINE.json"]
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith((".py", ".json", ".md")):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert not [w for w in words if w in text], os.path.join(dirpath, f)


def test_harness_imports_with_jax_blocked():
    code = r"""
import importlib, os, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tfkaldi_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import portbench.run, portbench.calibrate
from portbench import spec
for c in spec.benchmark()["workloads"]:
    spec.driver(spec.cell(c["name"]))
for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
import tfkaldi_tpu_torch.nnet, tfkaldi_tpu_torch.train, tfkaldi_tpu_torch.decode.decoder
bad = sorted({n.split(".")[0] for n in sys.modules} & {"jax", "jaxlib", "flax", "tfkaldi_tpu"})
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    got = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
