"""The port stands alone: it loads no JAX, no flax, nothing of the JAX
package and no msgpack, ``cryptography`` only under an encryption
passphrase (the card's machine has neither), and ``grpc`` and
``google.protobuf`` only in the modules that serve gRPC, when a gRPC
surface is used; and its entry points refuse to run on the CPU unasked."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nornicdb_tpu_torch
from nornicdb_tpu_torch.embed.embedder import TorchEncoderEmbedder
from nornicdb_tpu_torch.ops.graph import pagerank_arrays
from nornicdb_tpu_torch.query.device_graph import DeviceGraphPlane
from nornicdb_tpu_torch.query.executor import CypherExecutor
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nornicdb_tpu",
                                    "msgpack", "cryptography"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


_LAZY_PROBE = """
import importlib, json, pkgutil, sys
import nornicdb_tpu_torch
for m in pkgutil.walk_packages(nornicdb_tpu_torch.__path__, "nornicdb_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("transformers", "safetensors", "optax"))))
"""


def test_port_imports_transformers_safetensors_and_optax_only_when_used():
    """The card's machine has no ``transformers``: the HF importers load it
    (and ``safetensors``) inside the functions that need them; the port
    never needs ``optax``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root != "optax", (path, name)
                assert not (id(node) in top and root in ("transformers", "safetensors")), \
                    (path, name)


_CRYPTO_PROBE = """
import json, sys, tempfile
import nornicdb_tpu_torch
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
loaded = []
for passphrase in (None, "secret"):
    d = tempfile.mkdtemp()
    db = nornicdb_tpu_torch.open(d, device="cpu", engine="python", auto_embed=False,
                                 embedder=HashEmbedder(), passphrase=passphrase)
    db.close()
    loaded.append("cryptography" in sys.modules)
print(json.dumps(loaded))
"""


def test_port_loads_cryptography_only_under_a_passphrase():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CRYPTO_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, True]


def test_port_modules_load_no_jax_in_a_fresh_process():
    # a subprocess: this test process has jax loaded by tests/conftest.py
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "nornicdb_tpu_torch.ops.topk" in result["imported"]
    assert "nornicdb_tpu_torch.db" in result["imported"]
    assert "nornicdb_tpu_torch.storage.codec" in result["imported"]
    for name in ("ops.kmeans", "search.device_quant", "search.tiered_store",
                 "storage.partition_store", "filters", "decay", "temporal",
                 "linkpredict", "inference", "ops.decay", "ops.linkpredict",
                 "ops.fastrp", "background", "background.device_plane",
                 "query.device_graph", "ops.graph", "search.microbatch",
                 "query.apoc", "query.apoc_bulk", "query.apoc_ext", "query.apoc_graph",
                 "query.apoc_algo", "query.apoc_admin", "query.apoc_io", "query.strict",
                 "query.strict_grammar", "storage.schema", "search.rerank",
                 "obs", "obs.metrics", "obs.tracing", "obs.events", "obs.tenant",
                 "obs.stages", "obs.dispatch", "obs.resources", "obs.cost", "obs.device",
                 "admission", "obs.audit", "obs.slo", "obs.fleet",
                 "heimdall", "heimdall.model", "heimdall.train", "heimdall.hf_import",
                 "heimdall.generators", "heimdall.scheduler", "heimdall.bifrost",
                 "heimdall.tools", "models.train", "models.pretrain", "models.hf_import",
                 "storage.txn", "encryption", "audit", "auth", "retention", "config",
                 "api", "api.http_server", "api.openapi", "api.mcp", "api.packstream",
                 "api.bolt", "embed.http_providers", "cli", "search.util", "search.ivfpq",
                 "search.ivf_hnsw", "vectorspace", "api.qdrant", "api.graphql",
                 "api.grpc_server", "api.qdrant_official_grpc", "api.proto",
                 "api.proto.nornic_pb2", "api.proto.qdrant_pb2"):
        assert "nornicdb_tpu_torch." + name in result["imported"]
    assert result["bad"] == []


_GRPC_MODULES = {os.path.join("api", "grpc_server.py"),
                 os.path.join("api", "qdrant_official_grpc.py"),
                 os.path.join("api", "proto", "nornic_pb2.py"),
                 os.path.join("api", "proto", "qdrant_pb2.py")}
_GRPC_IMPORTS = ("nornicdb_tpu_torch.api.grpc_server", "nornicdb_tpu_torch.api.qdrant_official_grpc",
                 "nornicdb_tpu_torch.api.proto")

_GRPC_PROBE = """
import importlib, json, pkgutil, sys
import nornicdb_tpu_torch
serving = ("nornicdb_tpu_torch.api.grpc_server", "nornicdb_tpu_torch.api.qdrant_official_grpc",
           "nornicdb_tpu_torch.api.proto.")
for m in pkgutil.walk_packages(nornicdb_tpu_torch.__path__, "nornicdb_tpu_torch."):
    if not m.name.startswith(serving):
        importlib.import_module(m.name)
from nornicdb_tpu_torch.api.graphql import GraphQLAPI
from nornicdb_tpu_torch.api.http_server import HttpServer
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
db = nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder())
q = db.qdrant_compat
q.create_collection("c", {"size": 2})
q.upsert_points("c", [{"id": 1, "vector": [1.0, 0.0]}])
q.search_points("c", [1.0, 0.0])
GraphQLAPI(db).execute("{ nodeCount }")
srv = HttpServer(db, port=0).start()
srv.route("GET", "/collections/c", b"", {})
srv.stop()
loaded = lambda: sorted(m for m in sys.modules if m.split(".")[0] == "grpc"
                        or m.startswith("google.protobuf"))
before = loaded()
from nornicdb_tpu_torch.api.grpc_server import GrpcServer
g = GrpcServer(db, port=0).start()
g.stop()
db.close()
print(json.dumps({"before": before, "after": bool(loaded())}))
"""


def test_port_loads_grpc_and_protobuf_only_when_a_grpc_surface_is_used():
    pytest.importorskip("grpc")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _GRPC_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"before": [], "after": True}


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
            assert top not in ("jax", "jaxlib", "flax", "nornicdb_tpu", "msgpack"), (path, name)
            # cryptography: only encryption.py, inside the function that
            # builds an Encryptor
            if top == "cryptography":
                assert os.path.basename(path) == "encryption.py" and node not in tree.body, \
                    (path, name)
            # grpc and protobuf: only the modules that serve gRPC, and
            # those modules only inside a function of any other module
            rel = os.path.relpath(path, PKG)
            if top in ("grpc", "google"):
                assert rel in _GRPC_MODULES, (path, name)
            if name.startswith(_GRPC_IMPORTS) and rel not in _GRPC_MODULES:
                assert node not in tree.body, (path, name)


_OBS_PROBE = """
import json, sys
import nornicdb_tpu_torch.obs as obs
import nornicdb_tpu_torch.admission as admission
obs.REGISTRY.render()
obs.device_summary()
obs.audit_summary()
obs.fleet_summary()
admission.scheduler_summary()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nornicdb_tpu"))
print(json.dumps({"bad": bad, "n": len(obs.__all__)}))
"""


def test_obs_alone_loads_no_jax_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _OBS_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == [] and result["n"] > 0


def test_only_obs_device_imports_torch():
    importers = set()
    for path in _sources():
        if os.sep + "obs" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "torch" for n in names):
                importers.add(os.path.basename(path))
    assert importers == {"device.py"}


def _heimdall_generate():
    from nornicdb_tpu_torch.heimdall import Manager, ModelSpec

    mgr = Manager()
    mgr.register(ModelSpec(name="slm"))
    return mgr.generate("hi")


def _train_encoder():
    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.models.train import create_train_state

    return create_train_state(EncoderConfig.tiny())


def _apoc_pagerank(ex):
    ex.execute("CREATE (:A)-[:R]->(:B)")
    return ex.execute("CALL apoc.algo.pageRank() YIELD node, score RETURN score")


def _qdrant_compat():
    from nornicdb_tpu_torch.api.qdrant import QdrantCompat

    return QdrantCompat(nornicdb_tpu_torch.storage.MemoryEngine())


def _vector_registry():
    from nornicdb_tpu_torch.vectorspace import VectorSpaceRegistry

    return VectorSpaceRegistry()


def _ivf_hnsw():
    from nornicdb_tpu_torch.search.ivf_hnsw import IVFHNSWIndex

    return IVFHNSWIndex()


@pytest.mark.parametrize("make", [
    lambda: nornicdb_tpu_torch.open(),
    lambda: nornicdb_tpu_torch.DB(),
    lambda: BruteForceIndex(),
    lambda: TorchEncoderEmbedder(),
    lambda: nornicdb_tpu_torch.resolve_device("cuda"),
    lambda: pagerank_arrays(np.zeros(1, np.int32), np.zeros(1, np.int32), 1),
    lambda: DeviceGraphPlane(None).device,
    lambda: _apoc_pagerank(CypherExecutor(nornicdb_tpu_torch.storage.MemoryEngine())),
    lambda: _heimdall_generate(),
    lambda: _train_encoder(),
    lambda: _qdrant_compat(),
    lambda: _vector_registry(),
    lambda: _ivf_hnsw(),
])
def test_entry_points_default_to_cuda(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_resolve_device():
    assert nornicdb_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        nornicdb_tpu_torch.resolve_device("meta")
