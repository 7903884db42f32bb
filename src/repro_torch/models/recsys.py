"""Recsys architectures of the port: DLRM-RM2, DIN, AutoInt, BST.

The port of ``repro.models.recsys``, as ``nn.Module``s. All four share
the template: a sparse embedding lookup (a plain gather,
:func:`repro_torch.models.embeddings.multi_field_lookup` or an indexed
table, as in the reference) → feature interaction (dot / target
attention / self-attention / transformer over the sequence) → small MLP
→ logit. Weights keep the reference's layout: a projection is ``x @ w``
with ``w`` of shape (d_in, d_out), nothing transposed, so the reference's
arrays load as they are (:func:`repro_torch.convert.recsys_from_reference`).
Attention is plain ``einsum`` and ``softmax``, masked with -1e30 as in the
reference.

``retrieval_score`` (1 query × 1e6 candidates at ``retrieval_cand``) is
the flat scan: kernels B.5 and B.6 on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.embeddings import multi_field_lookup
from repro_torch.models.layers import init_normal


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "dlrm-rm2"
    model: str = "dlrm"  # 'dlrm' | 'din' | 'autoint' | 'bst'
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab: int = 100_000  # rows per sparse table
    seq_len: int = 0  # user-history length (din/bst)
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    attn_mlp: Tuple[int, ...] = (80, 40)  # din
    n_attn_layers: int = 3  # autoint
    n_heads: int = 2
    d_attn: int = 32
    n_blocks: int = 1  # bst


def _param(shape, gen, dev, scale=None) -> nn.Parameter:
    return nn.Parameter(init_normal(shape, scale, gen, dev))


class MLPStack(nn.Module):
    """``x @ w[i] + b[i]`` for each width, ReLU between (and after the last
    with ``final_act``); biases start at zero."""

    def __init__(self, d_in: int, widths: Tuple[int, ...],
                 gen: torch.Generator, dev: torch.device):
        super().__init__()
        ws, bs = [], []
        for w in widths:
            ws.append(_param((d_in, w), gen, dev))
            bs.append(nn.Parameter(torch.zeros(w, device=dev)))
            d_in = w
        self.w = nn.ParameterList(ws)
        self.b = nn.ParameterList(bs)

    def forward(self, x: torch.Tensor, final_act: bool = False):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1 or final_act:
                x = torch.relu(x)
        return x


# ------------------------------------------------------------------ DLRM


class DLRM(nn.Module):
    """Bottom MLP over the dense features, the gram matrix of the F + 1
    vectors, its upper triangle, the top MLP."""

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        F, V, D = cfg.n_sparse, cfg.vocab, cfg.embed_dim
        n_vec = F + 1
        top_in = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
        self.tables = _param((F, V, D), generator, dev, scale=0.01)
        self.bot = MLPStack(cfg.n_dense, cfg.bot_mlp, generator, dev)
        self.top = MLPStack(top_in, cfg.top_mlp, generator, dev)

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor):
        """dense (B, n_dense), sparse (B, F) ids → logits (B,)."""
        x_d = self.bot(dense, final_act=True)  # (B, D)
        x_s = multi_field_lookup(self.tables, sparse)  # (B, F, D)
        vecs = torch.cat([x_d[:, None, :], x_s], dim=1)  # (B, F+1, D)
        gram = torch.einsum("bfd,bgd->bfg", vecs, vecs)
        F1 = vecs.shape[1]
        # the upper triangle, row-major (jnp.triu_indices's order)
        iu = torch.triu_indices(F1, F1, 1, device=vecs.device)
        inter = gram[:, iu[0], iu[1]]  # (B, F1·(F1−1)/2)
        return self.top(torch.cat([x_d, inter], dim=1))[:, 0]


# ------------------------------------------------------------------- DIN


class DIN(nn.Module):
    """Target attention over the user's history: an MLP scores each
    history item against the target, the masked softmax pools them."""

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        D = cfg.embed_dim
        self.item_table = _param((cfg.vocab, D), generator, dev, scale=0.01)
        # attention input: [hist, target, hist − target, hist · target]
        self.attn = MLPStack(4 * D, cfg.attn_mlp + (1,), generator, dev)
        self.mlp = MLPStack(2 * D, cfg.top_mlp[:-1] + (1,), generator, dev)

    def forward(self, hist: torch.Tensor, target: torch.Tensor):
        """hist (B, S) item ids (-1 pad), target (B,) → logits (B,)."""
        T = self.item_table
        V = T.shape[0]
        h = T[hist.long().clamp(0, V - 1)]  # (B, S, D)
        t = T[target.long().clamp(0, V - 1)]  # (B, D)
        tb = t[:, None, :].expand_as(h)
        a_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
        scores = self.attn(a_in)[..., 0]  # (B, S)
        mask = hist >= 0
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        w = torch.softmax(scores, dim=-1) * mask  # all-padding pools to 0
        pooled = torch.einsum("bs,bsd->bd", w, h)
        return self.mlp(torch.cat([pooled, t], -1))[:, 0]


# --------------------------------------------------------------- AutoInt


class AutoIntLayer(nn.Module):
    """Multi-head self-attention over the fields with a projected
    residual and a ReLU."""

    def __init__(self, d_in: int, n_heads: int, d_attn: int,
                 gen: torch.Generator, dev: torch.device):
        super().__init__()
        W = n_heads * d_attn
        self.n_heads, self.d_attn = n_heads, d_attn
        self.wq = _param((d_in, W), gen, dev)
        self.wk = _param((d_in, W), gen, dev)
        self.wv = _param((d_in, W), gen, dev)
        self.wres = _param((d_in, W), gen, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, _ = x.shape
        H, Da = self.n_heads, self.d_attn
        q = (x @ self.wq).reshape(B, F, H, Da)
        k = (x @ self.wk).reshape(B, F, H, Da)
        v = (x @ self.wv).reshape(B, F, H, Da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(Da)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, H * Da)
        return torch.relu(o + x @ self.wres)


class AutoInt(nn.Module):
    """``layer0`` projects D → W = heads · d_attn, then n_attn_layers − 1
    W → W layers (the reference stacks and scans them), then a linear
    logit over the flattened fields."""

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        F, V, D = cfg.n_sparse, cfg.vocab, cfg.embed_dim
        H, Da = cfg.n_heads, cfg.d_attn
        W = H * Da
        self.tables = _param((F, V, D), generator, dev, scale=0.01)
        self.layer0 = AutoIntLayer(D, H, Da, generator, dev)
        self.layers = nn.ModuleList(
            AutoIntLayer(W, H, Da, generator, dev)
            for _ in range(cfg.n_attn_layers - 1))
        self.out = _param((F * W, 1), generator, dev)

    def forward(self, sparse: torch.Tensor) -> torch.Tensor:
        """sparse (B, F) ids → logits (B,)."""
        x = self.layer0(multi_field_lookup(self.tables, sparse))
        for layer in self.layers:
            x = layer(x)
        return (x.reshape(x.shape[0], -1) @ self.out)[:, 0]


# ------------------------------------------------------------------- BST


class BSTBlock(nn.Module):
    """One transformer block over the sequence: masked multi-head
    attention with a residual, then a ReLU feed-forward with a residual."""

    def __init__(self, D: int, n_heads: int, gen: torch.Generator,
                 dev: torch.device):
        super().__init__()
        self.n_heads = n_heads
        self.wq = _param((D, D), gen, dev)
        self.wk = _param((D, D), gen, dev)
        self.wv = _param((D, D), gen, dev)
        self.wo = _param((D, D), gen, dev)
        self.ff1 = _param((D, 4 * D), gen, dev)
        self.ff2 = _param((4 * D, D), gen, dev)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, S1, D = x.shape
        H = self.n_heads
        hd = D // H
        q = (x @ self.wq).reshape(B, S1, H, hd)
        k = (x @ self.wk).reshape(B, S1, H, hd)
        v = (x @ self.wv).reshape(B, S1, H, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S1, D)
        x = x + o @ self.wo
        return x + torch.relu(x @ self.ff1) @ self.ff2


class BST(nn.Module):
    """Behavior Sequence Transformer: the history and the target item,
    plus position embeddings, through ``n_blocks`` blocks, then an MLP
    over the flattened sequence."""

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        D = cfg.embed_dim
        S1 = cfg.seq_len + 1  # history + target item
        self.item_table = _param((cfg.vocab, D), generator, dev, scale=0.01)
        self.pos_embed = _param((S1, D), generator, dev, scale=0.01)
        self.blocks = nn.ModuleList(
            BSTBlock(D, cfg.n_heads, generator, dev)
            for _ in range(cfg.n_blocks))
        self.mlp = MLPStack(S1 * D, cfg.top_mlp[:-1] + (1,), generator, dev)

    def forward(self, hist: torch.Tensor, target: torch.Tensor):
        """hist (B, S) item ids (-1 pad), target (B,) → logits (B,)."""
        T = self.item_table
        seq = torch.cat([hist.long(), target.long()[:, None]], dim=1)
        x = T[seq.clamp(0, T.shape[0] - 1)] + self.pos_embed[None]
        mask = (seq >= 0)[:, None, None, :]  # (B, 1, 1, S+1)
        for block in self.blocks:
            x = block(x, mask)
        return self.mlp(x.reshape(x.shape[0], -1))[:, 0]


# -------------------------------------------------------------- retrieval


def retrieval_score(
    query_vec: torch.Tensor,  # (B, D)
    candidates: torch.Tensor,  # (N, D)
    k: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score B queries against N candidates and return the top k by inner
    product, as ``(−scores, ids)``: the distance matrix (B.5), then the
    top-k (B.6)."""
    return ops.distance_topk(query_vec, candidates, k, metric="ip")


# ------------------------------------------------------------ entry point

ARCHS = {"dlrm": DLRM, "din": DIN, "autoint": AutoInt, "bst": BST}


def init_recsys(cfg: RecsysConfig, generator: torch.Generator,
                device: DeviceLike = None) -> nn.Module:
    """The model ``cfg.model`` names, its parameters drawn from
    ``generator`` and placed on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    if cfg.model not in ARCHS:
        raise ValueError(f"unknown recsys model {cfg.model!r}")
    return ARCHS[cfg.model](cfg, generator, device)


def _inputs(model: nn.Module, batch: Dict, *names):
    dev = next(model.parameters()).device
    return [torch.as_tensor(batch[n], device=dev) for n in names]


def recsys_forward(model: nn.Module, batch: Dict) -> torch.Tensor:
    """Logits (B,) of ``model`` on a batch of ``click_batches``'s form
    (numpy arrays or tensors), on the model's device. Differentiable: a
    server wraps it in ``torch.inference_mode()``."""
    kind = model.cfg.model
    if kind == "dlrm":
        return model(*_inputs(model, batch, "dense", "sparse"))
    if kind in ("din", "bst"):
        return model(*_inputs(model, batch, "hist", "target"))
    if kind == "autoint":
        return model(*_inputs(model, batch, "sparse"))
    raise ValueError(kind)


def recsys_loss(model: nn.Module, batch: Dict) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the reference's stable form; differentiable (the optimizer and the
    training step are not ported yet)."""
    logits = recsys_forward(model, batch)
    labels = torch.as_tensor(batch["label"], device=logits.device).float()
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )
