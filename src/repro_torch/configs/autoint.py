"""AutoInt: self-attention feature interaction [arXiv:1810.11921]."""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(ArchSpec(
    arch_id="autoint",
    family="recsys",
    source="arXiv:1810.11921",
    make_config=lambda: RecsysConfig(
        name="autoint", model="autoint", n_sparse=39, embed_dim=16,
        n_attn_layers=3, n_heads=2, d_attn=32, vocab=100_000,
    ),
    make_smoke_config=lambda: RecsysConfig(
        name="autoint-smoke", model="autoint", n_sparse=6, embed_dim=8,
        n_attn_layers=2, n_heads=2, d_attn=8, vocab=1000,
    ),
    shapes=RECSYS_SHAPES,
))
