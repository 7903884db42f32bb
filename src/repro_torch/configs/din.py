"""DIN: Deep Interest Network, target attention over user history [arXiv:1706.06978]."""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(ArchSpec(
    arch_id="din",
    family="recsys",
    source="arXiv:1706.06978",
    make_config=lambda: RecsysConfig(
        name="din", model="din", embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), top_mlp=(200, 80, 1), vocab=1_000_000,
    ),
    make_smoke_config=lambda: RecsysConfig(
        name="din-smoke", model="din", embed_dim=8, seq_len=10,
        attn_mlp=(16, 8), top_mlp=(16, 8, 1), vocab=1000,
    ),
    shapes=RECSYS_SHAPES,
))
