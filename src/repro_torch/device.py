"""Device policy of the port: the card unless the caller asks for the CPU.

Every entry point takes ``device=None``, and ``None`` means ``"cuda"``.
Without CUDA that raises: only an explicit ``device="cpu"`` runs on the
CPU (the tests pass it), so no run silently falls back to the host.
``"meta"`` is accepted too: it holds shapes only, no values, so nothing
can run there (a loader builds a model on it and fills it after
``to_empty``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch device an entry point should run on.

    Raises ``RuntimeError`` for a CUDA device (the default) when
    ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path on "
            "the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work, so a host clock read after it measures
    the work and not only its launch. A no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
