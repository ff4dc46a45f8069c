"""The port stands alone: it loads no JAX, no flax and nothing of the JAX
package, and its entry points refuse to run on the CPU unasked."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import nornicdb_tpu_torch
from nornicdb_tpu_torch.embed.embedder import TorchEncoderEmbedder
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nornicdb_tpu_torch")

_PROBE = """
import importlib, json, pkgutil, sys
import nornicdb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nornicdb_tpu_torch.__path__,
                                               "nornicdb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nornicdb_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_modules_load_no_jax_in_a_fresh_process():
    # a subprocess: this test process has jax loaded by tests/conftest.py
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "nornicdb_tpu_torch.ops.topk" in result["imported"]
    assert "nornicdb_tpu_torch.db" in result["imported"]
    assert result["bad"] == []


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_port_sources_import_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "nornicdb_tpu"), (path, name)


@pytest.mark.parametrize("make", [
    lambda: nornicdb_tpu_torch.open(),
    lambda: nornicdb_tpu_torch.DB(),
    lambda: BruteForceIndex(),
    lambda: TorchEncoderEmbedder(),
    lambda: nornicdb_tpu_torch.resolve_device("cuda"),
])
def test_entry_points_default_to_cuda(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_resolve_device():
    assert nornicdb_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        nornicdb_tpu_torch.resolve_device("meta")
