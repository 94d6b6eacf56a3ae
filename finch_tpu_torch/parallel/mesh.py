"""A 1-D device mesh for the sharded engines.

The counterpart of ``finch_tpu/parallel/mesh.py``. JAX's `Mesh` names
every device of every process, and `shard_map` runs one program over
them. Here a `Mesh` holds this process's shards (a list of torch devices)
and, in multi-process mode, the `torch.distributed` process group that
joins the processes; `size` counts the shards of all processes, as
JAX's `mesh.devices.size` does. Every process holds the same number of
shards, and global shard `rank * len(devices) + i` is this process's
shard `i`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.engine import resolve_device


class Mesh:
    """Shards over `devices` (this process's), along `axis_name`.

    A device may repeat: repeated devices are logical shards that share
    one card (or the CPU). They split the work exactly as separate cards
    would, which is how a single card or the CPU checks the sharding
    logic, but their work shares one device (on a card, one stream) and
    moves no data between cards. `group`, when given, is the
    `torch.distributed` process group of a multi-process mesh; its rank
    and size are read from it.
    `axis_name` labels the one axis, as JAX's mesh names its axes; no
    program reads it."""

    def __init__(self, devices: Sequence, axis_name: str = "data",
                 group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise FinchMessageError("a mesh needs at least one device")
        self.axis_names = (axis_name,)
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
        else:
            self.rank, self.world_size = 0, 1
        self.size = len(self.devices) * self.world_size

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r}, rank={self.rank}, "
                f"world_size={self.world_size})")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device="cuda") -> Mesh:
    """1-D mesh over the first n CUDA devices (default: all). With
    device="cpu", a mesh of n CPU shards (default 1). Raises without a
    card unless device="cpu", and when fewer than n cards are present."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1), axis_name)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise FinchMessageError(f"a mesh of {n} CUDA devices needs that "
                                f"many cards; {count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis_name)
