"""Shared building blocks of the port's models.

So far only what the recsys family needs: the parameter draw (the
reference's ``_init``; its ``Params`` alias has no use here, where
parameters live in ``nn.Module``s). The reference's RMSNorm, RoPE and LM
blocks (``repro.models.layers``) come with the LM models (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device


def init_normal(
    shape: Sequence[int], scale: Optional[float],
    generator: torch.Generator, device: DeviceLike = None,
) -> torch.Tensor:
    """A float32 tensor of standard normal draws times ``scale`` (by
    default ``(1 / shape[0]) ** 0.5``, as the reference's ``_init``),
    drawn on the generator's device and placed on ``device`` (CUDA unless
    the caller asks for the CPU), so a seeded CPU generator gives the same
    parameters on either device. On the ``meta`` device, which holds no
    values, nothing is drawn."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x.mul_(scale).to(dev)
