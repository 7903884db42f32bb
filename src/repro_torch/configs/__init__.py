"""Config registry: importing it registers every ported architecture."""

from repro_torch.configs import base  # noqa: F401
from repro_torch.configs.base import REGISTRY, get, list_archs  # noqa: F401

# one module per ported architecture (+ the paper's own)
from repro_torch.configs import (  # noqa: F401
    autoint,
    bst,
    din,
    dlrm_rm2,
    webanns,
)
