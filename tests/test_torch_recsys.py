"""The port's recsys models, retrieval and config registry against the
JAX package, on the CPU.

Each architecture at its smoke config: the reference's ``init_recsys``
parameters go through ``convert.recsys_from_reference`` into the port's
module, and both packages' ``recsys_forward`` and ``recsys_loss`` run on
``click_batches(cfg, 8, 2, seed=0)``. Both compute in float32 with
matmuls and softmaxes that sum in their own orders, so the logits and
the loss match to rtol 1e-5, atol 1e-6 (measured on this CPU: at most
1.7e-8 abs, DLRM's, on logits of ~0.1 to 0.5;
``test_forward_and_loss_match_reference`` prints it under ``-s``); the
loss's gradient on every parameter matches ``jax.grad`` to the same
tolerance (measured: at most 6.1e-9 abs).
``retrieval_score`` is the flat scan (ip): ids equal, scores within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.data.synthetic import click_batches as r_click_batches
from repro.models import recsys as rR
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.data.synthetic import click_batches
from repro_torch.models import recsys as R

RTOL, ATOL = 1e-5, 1e-6
RECSYS = ["dlrm-rm2", "din", "autoint", "bst"]


def _ref_params(cfg, seed=0):
    rcfg = rR.RecsysConfig(**dataclasses.asdict(cfg))
    params = rR.init_recsys(jax.random.PRNGKey(seed), rcfg)
    return rcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arch", RECSYS)
def test_forward_and_loss_match_reference(arch):
    cfg = pconfigs.get(arch).make_smoke_config()
    rcfg, params = _ref_params(cfg)
    model = convert.recsys_from_reference(cfg, params, device="cpu")
    worst = 0.0
    for batch in click_batches(cfg, 8, 2, seed=0):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = np.asarray(rR.recsys_forward(params, rcfg, jb))
        with torch.inference_mode():
            got = R.recsys_forward(model, batch).numpy()
            got_loss = float(R.recsys_loss(model, batch))
        assert got.shape == (8,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(got - want).max()))
        want_loss = float(rR.recsys_loss(params, rcfg, jb))
        np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL,
                                   atol=ATOL)
    print(f"{arch}: max abs logit error {worst:.3g}")


@pytest.mark.parametrize("arch", RECSYS)
def test_loss_gradient_matches_reference(arch):
    """``recsys_loss`` stays differentiable: its gradient on every
    parameter against ``jax.grad`` of the reference's loss (the gradient
    tree goes through the same converter, so names line up)."""
    cfg = pconfigs.get(arch).make_smoke_config()
    rcfg, params = _ref_params(cfg, seed=3)
    model = convert.recsys_from_reference(cfg, params, device="cpu")
    batch = next(click_batches(cfg, 8, 1, seed=5))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: rR.recsys_loss(p, rcfg, jb))(params))
    want = dict(convert.recsys_from_reference(cfg, grads, device="cpu")
                .named_parameters())
    R.recsys_loss(model, batch).backward()
    worst = 0.0
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        worst = max(worst, float(np.abs(got - ref).max()))
    print(f"{arch}: max abs gradient error {worst:.3g}")


def test_conversion_draws_nothing(monkeypatch):
    """The converter builds its module on the meta device (shapes only)
    and fills uninitialised storage: no parameter is drawn only to be
    overwritten."""
    cfg = pconfigs.get("bst").make_smoke_config()
    meta = R.init_recsys(cfg, torch.Generator(), "meta")
    assert all(p.is_meta for p in meta.parameters())
    _, params = _ref_params(cfg, seed=4)

    def no_draw(*args, **kwargs):
        raise AssertionError("the converter drew parameters")

    monkeypatch.setattr(torch, "randn", no_draw)
    model = convert.recsys_from_reference(cfg, params, device="cpu")
    assert not any(p.is_meta for p in model.parameters())


@pytest.mark.parametrize("arch", RECSYS)
def test_converted_parameters_are_the_references_bits(arch):
    """Every reference array lands in the port's module unchanged (the
    weight layout is kept: ``x @ w`` with w of shape (d_in, d_out)), the
    stacked groups unstacked along their leading axis."""
    cfg = pconfigs.get(arch).make_smoke_config()
    _, params = _ref_params(cfg, seed=1)
    model = convert.recsys_from_reference(cfg, params, device="cpu")
    own = dict(model.named_parameters())
    if arch == "autoint":
        np.testing.assert_array_equal(own["layers.0.wk"].detach().numpy(),
                                      params["layers"]["wk"][0])
        assert len(model.layers) == cfg.n_attn_layers - 1
    if arch == "bst":
        np.testing.assert_array_equal(own["blocks.0.ff2"].detach().numpy(),
                                      params["blocks"]["ff2"][0])
    if arch == "dlrm-rm2":
        np.testing.assert_array_equal(own["top.w.1"].detach().numpy(),
                                      params["top"]["w"][1])
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in own.values()) == n_ref


def test_conversion_rejects_a_foreign_tree():
    cfg = pconfigs.get("din").make_smoke_config()
    _, params = _ref_params(cfg)
    del params["mlp"]
    with pytest.raises(ValueError, match="names differ"):
        convert.recsys_from_reference(cfg, params, device="cpu")
    _, params = _ref_params(cfg)
    params["item_table"] = params["item_table"][:-1]
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_from_reference(cfg, params, device="cpu")


@pytest.mark.parametrize("arch", RECSYS)
def test_init_is_seeded_and_device_independent(arch):
    cfg = pconfigs.get(arch).make_smoke_config()
    a = R.init_recsys(cfg, torch.Generator().manual_seed(4), "cpu")
    b = R.init_recsys(cfg, torch.Generator().manual_seed(4), "cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    batch = next(click_batches(cfg, 4, 1, seed=3))
    out = R.recsys_forward(a, batch)
    assert out.shape == (4,) and bool(torch.isfinite(out).all())


def test_unknown_model_raises():
    cfg = pconfigs.get("dlrm-rm2").make_smoke_config()
    with pytest.raises(ValueError):
        R.init_recsys(dataclasses.replace(cfg, model="wide_deep"),
                      torch.Generator(), "cpu")
    model = R.init_recsys(cfg, torch.Generator(), "cpu")
    model.cfg = dataclasses.replace(cfg, model="wide_deep")
    with pytest.raises(ValueError):
        R.recsys_forward(model, next(click_batches(cfg, 2, 1)))


def test_din_pools_an_all_padding_history_to_zero():
    """A history of nothing but padding gives uniform softmax weights
    times a zero mask: the pooled vector is 0, as in the reference."""
    cfg = pconfigs.get("din").make_smoke_config()
    rcfg, params = _ref_params(cfg, seed=2)
    model = convert.recsys_from_reference(cfg, params, device="cpu")
    batch = next(click_batches(cfg, 3, 1, seed=1))
    batch["hist"][1] = -1
    want = np.asarray(rR.recsys_forward(
        params, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.inference_mode():
        got = R.recsys_forward(model, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_retrieval_score_matches_reference():
    rng = np.random.default_rng(8)
    cands = rng.standard_normal((2_000, 32)).astype(np.float32)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    rd, ri = rR.retrieval_score(jnp.asarray(q), jnp.asarray(cands), k=10)
    d, i = R.retrieval_score(torch.from_numpy(q), torch.from_numpy(cands),
                             k=10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def test_click_batches_equal_the_reference():
    cfg = pconfigs.get("bst").make_smoke_config()
    for got, want in zip(click_batches(cfg, 5, 3, seed=9),
                         r_click_batches(cfg, 5, 3, seed=9)):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", RECSYS + ["webanns"])
def test_registry_equals_reference(arch):
    mine, theirs = pconfigs.get(arch), rconfigs.get(arch)
    assert (mine.arch_id, mine.family, mine.source, mine.notes) == (
        theirs.arch_id, theirs.family, theirs.source, theirs.notes)
    for make in ("make_config", "make_smoke_config"):
        a, b = getattr(mine, make)(), getattr(theirs, make)()
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b
    assert {k: (s.name, s.kind, s.params) for k, s in mine.shapes.items()} \
        == {k: (s.name, s.kind, s.params) for k, s in theirs.shapes.items()}


def test_unported_archs_name_their_roadmap_item():
    assert pconfigs.list_archs() == sorted(RECSYS + ["webanns"])
    for arch in set(rconfigs.list_archs()) - set(pconfigs.list_archs()):
        with pytest.raises(KeyError, match="A.9"):
            pconfigs.get(arch)
    with pytest.raises(KeyError, match="unknown"):
        pconfigs.get("no-such-arch")
