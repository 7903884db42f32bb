"""One ``torch.distributed`` process group of S ranks, one shard per rank.

The counterpart of the reference's ``make_shard_mesh`` and
``make_host_mesh``: where JAX lays a mesh over the devices one process
sees, the port runs one process per shard, and the collectives of the
search go through the process group. The backend follows the device: NCCL
for CUDA (one card a rank), gloo for the CPU. That is a choice by device,
not a fallback: a CUDA group never runs on gloo.

Nothing here discovers a cluster: the caller gives the rendezvous
(``init_method``, e.g. ``file:///tmp/x`` or ``tcp://localhost:<port>``),
the world size and the rank, or initialises ``torch.distributed`` itself
and passes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks that hold the shards of one index: ``n_shards`` ranks of
    the default process group, this process being ``rank`` and holding
    shard ``rank`` on ``device``."""

    n_shards: int
    rank: int
    device: torch.device


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for
    the CPU."""
    return BACKENDS[device.type]


def make_shard_group(
    n_shards: int,
    device: DeviceLike = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
) -> ShardGroup:
    """This process's place in a group of ``n_shards`` ranks.

    If ``torch.distributed`` is not initialised yet, initialise it with
    ``init_method`` and ``rank`` (both required then) and a world of
    ``n_shards``, on the device's backend; otherwise take the process
    group as it is. On CUDA the rank's device is card ``rank`` of this
    host (one card a rank), made current. Raises ``ValueError`` where the
    world size is not ``n_shards`` or the group's backend is not the
    device's, and ``RuntimeError`` for CUDA where it is absent (pass
    ``device="cpu"`` for gloo ranks on the CPU).
    """
    dev = resolve_device(device)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    backend = backend_for(dev)
    if not dist.is_initialized():
        if init_method is None or rank is None:
            raise ValueError(
                "torch.distributed is not initialised: pass init_method and "
                "rank (one process per shard)"
            )
        dist.init_process_group(backend, init_method=init_method,
                                world_size=n_shards, rank=rank)
    world = dist.get_world_size()
    if world != n_shards:
        raise ValueError(
            f"n_shards={n_shards} but the process group has {world} ranks "
            "(one rank per shard)"
        )
    if dist.get_backend() != backend:
        raise ValueError(
            f"a {dev.type} shard group runs on {backend}, but the process "
            f"group uses {dist.get_backend()}"
        )
    me = dist.get_rank()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", me % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return ShardGroup(n_shards=n_shards, rank=me, device=dev)


def destroy_shard_group() -> None:
    """Tear down the process group (a no-op if none is initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()
