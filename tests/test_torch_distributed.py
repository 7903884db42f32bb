"""The port's distributed search substrate against the JAX package, on the
CPU.

- ``build_sharded_index`` gives the reference's arrays bit for bit;
- multi-rank parity: the reference runs once, in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
  ``tests/test_distributed.py`` does), on an (S, 1) ("data", "model")
  mesh; the port runs the same inputs in S gloo processes
  (``file://`` rendezvous under the test's tmp_path). Each rank process
  runs a code string that imports only the port, so nothing of this file
  has to be importable there;
- S = 1 runs in this process against the reference's one-device mesh;
- the raises: a batch that does not split over the shards, a world size
  other than the shard count.

Flat ids must equal the reference's but for near ties, with dists within
2e-4 (the reference's kernel tolerance); hnsw ids the same. A near tie is
two ids whose float64 distances lie within 2e-4 of each other.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.launch.mesh import make_host_mesh
from repro_torch import convert
from repro_torch.core import distributed as PD
from repro_torch.launch import mesh as PM

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4
K, EF = 10, 16
GRAPH = dict(M=4, ef_construction=20)  # both packages, seeds 0 + s

# name: (n, d, B, n_shards, k). n = 41 leaves S = 4 a last shard of 8 < k
# valid rows; n = 5 leaves S = 4 an empty tail shard (built over X[:1])
CASES = {
    "S2": (41, 16, 8, 2, K),
    "S4": (41, 16, 8, 4, K),
    "S4_empty_tail": (5, 16, 8, 4, 2),
}


def _inputs(n, d, B, seed=0):
    rng = np.random.default_rng(seed + n)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = (X[rng.integers(0, n, B)]
         + 0.3 * rng.standard_normal((B, d))).astype(np.float32)
    return X, Q


def _d64(Q, X):
    Q, X = Q.astype(np.float64), X.astype(np.float64)
    return ((Q[:, None, :] - X[None]) ** 2).sum(-1)


def assert_ids_equal_but_near_ties(ids_a, ids_b, Q, X, tol=TOL):
    """Equal id positions, or two in-range ids whose exact l2 distances lie
    within ``tol`` (ids past the corpus, which the reference keeps for the
    +inf entries of a short shard, must be equal)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    D64 = _d64(Q, X)
    rows, cols = np.nonzero(ids_a != ids_b)
    for r, c in zip(rows, cols):
        a, b = ids_a[r, c], ids_b[r, c]
        assert 0 <= a < len(X) and 0 <= b < len(X), (r, c, a, b)
        assert abs(D64[r, a] - D64[r, b]) <= tol, (r, c, a, b)


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as RD
from repro.launch.mesh import make_host_mesh

cases, graph, ef, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    int(sys.argv[3]), sys.argv[4]
res = {}
for name, (n, d, B, S, k) in cases.items():
    z = np.load(os.path.join(out, name + "_in.npz"))
    X, Q = z["X"], z["Q"]
    idx = RD.build_sharded_index(X, S, **graph)
    mesh = make_host_mesh(data=S, model=1)
    with mesh:
        fd, fi = RD.distributed_brute_force(mesh, k=k)(jnp.asarray(Q), idx)
        hd, hi = RD.make_distributed_search(mesh, k=k, ef=ef, mode="hnsw")(
            jnp.asarray(Q), idx)
    np.savez(os.path.join(out, name + "_ref.npz"), flat_d=np.asarray(fd),
             flat_i=np.asarray(fi), hnsw_d=np.asarray(hd),
             hnsw_i=np.asarray(hi))
print("DEVICES", len(jax.devices()))
"""

RANK = r"""
import json, os, sys
import numpy as np, torch
from repro_torch.core import distributed as PD
from repro_torch.launch import mesh as PM

name, S, rank, k, ef, graph, out, init = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]), json.loads(sys.argv[6]), sys.argv[7], sys.argv[8])
torch.set_num_threads(1)
z = np.load(os.path.join(out, name + "_in.npz"))
X, Q = z["X"], z["Q"]
group = PM.make_shard_group(S, device="cpu", init_method=init, rank=rank)
try:
    shard = PD.build_sharded_index(X, S, **graph).shard(rank, "cpu")
    fd, fi = PD.distributed_brute_force(group, k=k)(Q, shard)
    hd, hi = PD.make_distributed_search(group, k=k, ef=ef, mode="hnsw")(
        Q, shard)
    np.savez(os.path.join(out, f"{name}_port{rank}.npz"), flat_d=fd.numpy(),
             flat_i=fi.numpy(), hnsw_d=hd.numpy(), hnsw_i=hi.numpy())
finally:
    PM.destroy_shard_group()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on every case: {case: (X, Q, reference, port)}, each
    result a dict of flat/hnsw dists and ids over the whole batch."""
    out = tmp_path_factory.mktemp("substrate")
    for name, (n, d, B, S, k) in CASES.items():
        X, Q = _inputs(n, d, B)
        np.savez(out / f"{name}_in.npz", X=X, Q=Q)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CASES),
         json.dumps(GRAPH), str(EF), str(out)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    procs = []  # every case's ranks at once, beside the reference
    for name, (n, d, B, S, k) in CASES.items():
        init = f"file://{out / (name + '_rendezvous')}"
        for rank in range(S):
            procs.append((name, subprocess.Popen(
                [sys.executable, "-c", RANK, name, str(S), str(rank), str(k),
                 str(EF), json.dumps(GRAPH), str(out), init],
                cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )))
    for name, p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
    so, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    assert "DEVICES 4" in so
    result = {}
    for name, (n, d, B, S, k) in CASES.items():
        z = np.load(out / f"{name}_in.npz")
        parts = [np.load(out / f"{name}_port{r}.npz") for r in range(S)]
        port = {key: np.concatenate([p[key] for p in parts])
                for key in ("flat_d", "flat_i", "hnsw_d", "hnsw_i")}
        result[name] = (z["X"], z["Q"], dict(np.load(out / f"{name}_ref.npz")),
                        port)
    return result


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_scan_matches_reference_across_ranks(runs, case):
    X, Q, ref, port = runs[case]
    B, k = CASES[case][2], CASES[case][4]
    assert port["flat_i"].shape == (B, k) and port["flat_i"].dtype == np.int32
    assert_ids_equal_but_near_ties(port["flat_i"], ref["flat_i"], Q, X)
    np.testing.assert_allclose(port["flat_d"], ref["flat_d"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hnsw_mode_matches_reference_across_ranks(runs, case):
    X, Q, ref, port = runs[case]
    assert_ids_equal_but_near_ties(port["hnsw_i"], ref["hnsw_i"], Q, X)
    fin = np.isfinite(ref["hnsw_d"])
    assert np.array_equal(fin, np.isfinite(port["hnsw_d"]))
    np.testing.assert_allclose(port["hnsw_d"][fin], ref["hnsw_d"][fin],
                               rtol=TOL, atol=TOL)


def test_flat_scan_is_exact_across_ranks(runs):
    """With S·k candidates the flat scan finds the true top-k (the
    reference's own exactness check, on the port)."""
    X, Q, _, port = runs["S4"]
    truth = np.argsort(_d64(Q, X), axis=1, kind="stable")[:, :K]
    assert_ids_equal_but_near_ties(port["flat_i"], truth, Q, X)


# ------------------------------------------------------ the stacked index


@pytest.mark.parametrize("n,S", [(101, 1), (101, 2), (101, 3), (5, 4)])
def test_build_sharded_index_equals_reference(n, S):
    X, _ = _inputs(n, 12, 1)
    mine = PD.build_sharded_index(X, S, seed=2, **GRAPH)
    theirs = RD.build_sharded_index(X, S, seed=2, **GRAPH)
    back = convert.sharded_index_from_reference(theirs)
    for field in convert.SHARDED_FIELDS:
        a = getattr(mine, field).numpy()
        b = np.asarray(getattr(theirs, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert np.array_equal(getattr(back, field).numpy(), b), field
    assert (mine.n_shards, mine.rows) == (theirs.n_shards, theirs.rows)
    if n == 5:  # the empty tail shard: X[:1], no valid row, base n - 1
        assert not mine.row_valid[3].any() and int(mine.base_ids[3]) == 4


def test_index_without_graphs_serves_only_the_flat_scan(tmp_path):
    X, Q = _inputs(41, 16, 4)
    full = PD.build_sharded_index(X, 2, **GRAPH)
    flat = PD.build_sharded_index(X, 2, hnsw=False)
    for field in ("vectors", "row_valid", "base_ids"):
        assert torch.equal(getattr(full, field), getattr(flat, field))
    assert flat.neighbors.shape == (2, 0, 21, 0)
    group = PM.ShardGroup(n_shards=1, rank=0, device=torch.device("cpu"))
    one = PD.build_sharded_index(X, 1, hnsw=False).shard(0, "cpu")
    with pytest.raises(ValueError, match="hnsw=True"):
        PD._local_knn(torch.from_numpy(Q), one, K, EF, "l2")
    with pytest.raises(ValueError, match="unknown mode"):
        PD.make_distributed_search(group, mode="ivf")


def test_convert_refuses_mismatched_arrays():
    X, _ = _inputs(41, 16, 1)
    idx = RD.build_sharded_index(X, 2, **GRAPH)
    bad = type("Idx", (), {f: getattr(idx, f)
                           for f in convert.SHARDED_FIELDS})()
    bad.row_valid = np.asarray(idx.row_valid)[:1]
    with pytest.raises(ValueError, match="row_valid"):
        convert.sharded_index_from_reference(bad)


# ------------------------------------------------------ one rank in-process


@pytest.fixture
def gloo_world_one(tmp_path):
    group = PM.make_shard_group(1, device="cpu",
                                init_method=f"file://{tmp_path / 'rdv'}",
                                rank=0)
    yield group
    PM.destroy_shard_group()


@pytest.mark.parametrize("mode", ["flat", "hnsw"])
def test_world_of_one_matches_reference_one_device_mesh(gloo_world_one, mode):
    X, Q = _inputs(203, 16, 6)
    ridx = RD.build_sharded_index(X, 1, **GRAPH)
    mesh = make_host_mesh(1, 1)
    with mesh:
        rd, ri = RD.make_distributed_search(mesh, k=K, ef=EF, mode=mode)(
            jnp.asarray(Q), ridx)
    shard = convert.sharded_index_from_reference(ridx).shard(0, "cpu")
    pd_, pi = PD.make_distributed_search(gloo_world_one, k=K, ef=EF,
                                         mode=mode)(Q, shard)
    assert_ids_equal_but_near_ties(pi.numpy(), np.asarray(ri), Q, X)
    np.testing.assert_allclose(pd_.numpy(), np.asarray(rd), rtol=TOL,
                               atol=TOL)
    if mode == "flat":
        fd, fi = PD.distributed_brute_force(gloo_world_one, k=K)(Q, shard)
        assert torch.equal(fi, pi) and torch.equal(fd, pd_)


def test_world_size_other_than_shard_count_raises(gloo_world_one):
    with pytest.raises(ValueError, match="n_shards=2"):
        PM.make_shard_group(2, device="cpu")
    assert PM.make_shard_group(1, device="cpu") == gloo_world_one
    assert PM.backend_for(torch.device("cpu")) == "gloo"
    assert PM.backend_for(torch.device("cuda")) == "nccl"


def test_uninitialised_group_needs_a_rendezvous():
    with pytest.raises(ValueError, match="init_method"):
        PM.make_shard_group(1, device="cpu")


def test_batch_that_does_not_split_over_the_shards_raises():
    X, Q = _inputs(41, 16, 7)
    group = PM.ShardGroup(n_shards=2, rank=0, device=torch.device("cpu"))
    shard = PD.build_sharded_index(X, 2, hnsw=False).shard(0, "cpu")
    with pytest.raises(ValueError, match="divisible"):
        PD.distributed_brute_force(group, k=K)(Q, shard)
