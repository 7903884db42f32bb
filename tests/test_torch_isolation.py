"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

- every module of ``src/repro_torch/`` and ``chip_smoke.py`` is scanned
  for an import of ``jax``/``jaxlib``/``repro``;
- every module of the package imports in a fresh interpreter in which
  ``jax`` and ``repro`` cannot be imported at all;
- the entry points default to CUDA and raise where it is absent.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import distributed as D
from repro_torch.core import engine as P
from repro_torch.core.graph import empty_graph
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import embeddings as PE
from repro_torch.models import recsys as PRS

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_every_kernel_source_has_its_wrapper():
    """Each CUDA source is built by ``_build.sources()`` and bound by a
    wrapper module of the same name (merge_topk's is ``topk``,
    distance_matrix's is ``distance``)."""
    from repro_torch.kernels import _build

    stems = {p.stem for p in _build.sources()}
    assert stems == {"gather_distance", "merge_topk",
                     "dequant_gather_distance", "adc_gather_distance",
                     "distance_matrix", "topk", "embedding_bag", "hop_step"}
    wrappers = {p.stem for p in (PACKAGE / "kernels").glob("*.py")}
    assert stems - {"merge_topk", "distance_matrix"} <= wrappers
    assert {"topk", "distance"} <= wrappers


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_without_jax():
    modules = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    for name in ("core.engine", "core.quant", "convert",
                 "kernels.dequant_gather_distance", "core.distributed",
                 "launch.mesh", "kernels.distance", "kernels.embedding_bag",
                 "models.embeddings", "models.recsys", "configs",
                 "configs.dlrm_rm2"):
        assert "repro_torch." + name in modules
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None  # any import of them now fails\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_build_raises_without_cuda(no_cuda):
    X = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine.build(X, M=4, ef_construction=8)
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine.build(X, M=4, ef_construction=8,
                              config=P.EngineConfig(device=None))
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine(X, empty_graph(20, 0, 4), P.EngineConfig())


@pytest.mark.parametrize("precision,fused", [("int8", False),
                                             ("float16", True)])
def test_quantized_and_fused_engines_raise_without_cuda(no_cuda, precision,
                                                        fused):
    X = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        P.WebANNSEngine(X, empty_graph(20, 0, 4), P.EngineConfig(
            precision=precision, fused=fused))


def test_engine_runs_on_cpu_only_when_asked():
    X = np.random.default_rng(0).standard_normal((60, 8)).astype(np.float32)
    eng = P.WebANNSEngine.build(X, M=4, ef_construction=16,
                                config=P.EngineConfig(device="cpu"))
    assert eng.device == torch.device("cpu")
    assert eng.store.cache.slab.device == torch.device("cpu")
    res = eng.search(P.SearchRequest(query=X[3], k=3, ef=16))
    assert res.ids[0] == 3


def test_shard_group_and_distributed_search_raise_without_cuda(no_cuda):
    """The substrate's entry points default to CUDA (NCCL) too: without a
    card the group helper, a CUDA group's search program and placing a
    shard all raise before any process group is touched."""
    with pytest.raises(RuntimeError, match="is_available"):
        M.make_shard_group(1)
    cuda_group = M.ShardGroup(n_shards=1, rank=0,
                              device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="is_available"):
        D.make_distributed_search(cuda_group, mode="flat")
    with pytest.raises(RuntimeError, match="is_available"):
        D.distributed_brute_force(cuda_group)
    X = np.random.default_rng(0).standard_normal((9, 4)).astype(np.float32)
    index = D.build_sharded_index(X, 1, hnsw=False)
    with pytest.raises(RuntimeError, match="is_available"):
        index.shard(0)
    assert index.shard(0, "cpu").device == torch.device("cpu")


@pytest.mark.parametrize("model", ["dlrm", "din", "autoint", "bst"])
def test_recsys_init_raises_without_cuda(no_cuda, model):
    """The recsys models and the embedding tables default to CUDA too:
    ``device=None`` without a card raises before anything is drawn."""
    cfg = PRS.RecsysConfig(model=model, n_sparse=2, embed_dim=4, vocab=10,
                          seq_len=3, bot_mlp=(4,), top_mlp=(4, 1),
                          attn_mlp=(4,), n_attn_layers=2, d_attn=2)
    with pytest.raises(RuntimeError, match="is_available"):
        PRS.init_recsys(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="is_available"):
        PRS.init_recsys(cfg, torch.Generator(), device=None)
    assert next(PRS.init_recsys(cfg, torch.Generator(), "cpu")
                .parameters()).device == torch.device("cpu")


def test_embedding_table_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="is_available"):
        PE.init_embedding_table(10, 4, torch.Generator())
    with pytest.raises(RuntimeError, match="is_available"):
        PE.init_embedding_table(10, 4, torch.Generator(), device=None)
    table = PE.init_embedding_table(10, 4, torch.Generator(), device="cpu")
    assert table["table"].device == torch.device("cpu")
