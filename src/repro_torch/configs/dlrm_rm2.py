"""DLRM-RM2: dot-interaction recsys [arXiv:1906.00091]."""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import RecsysConfig

register(ArchSpec(
    arch_id="dlrm-rm2",
    family="recsys",
    source="arXiv:1906.00091",
    make_config=lambda: RecsysConfig(
        name="dlrm-rm2", model="dlrm", n_dense=13, n_sparse=26,
        embed_dim=64, bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1), vocab=1_000_000,
    ),
    make_smoke_config=lambda: RecsysConfig(
        name="dlrm-smoke", model="dlrm", n_dense=13, n_sparse=4,
        embed_dim=8, bot_mlp=(16, 8), top_mlp=(16, 8, 1), vocab=1000,
    ),
    shapes=RECSYS_SHAPES,
))
