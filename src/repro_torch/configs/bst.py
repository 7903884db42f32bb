"""BST: Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874]."""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(ArchSpec(
    arch_id="bst",
    family="recsys",
    source="arXiv:1905.06874",
    make_config=lambda: RecsysConfig(
        name="bst", model="bst", embed_dim=32, seq_len=20, n_blocks=1,
        n_heads=8, top_mlp=(1024, 512, 256, 1), vocab=1_000_000,
    ),
    make_smoke_config=lambda: RecsysConfig(
        name="bst-smoke", model="bst", embed_dim=16, seq_len=6,
        n_blocks=1, n_heads=2, top_mlp=(32, 16, 1), vocab=1000,
    ),
    shapes=RECSYS_SHAPES,
))
