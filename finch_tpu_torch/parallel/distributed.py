"""Multi-process initialization and the global mesh, on torch.distributed.

The counterpart of ``finch_tpu/parallel/distributed.py``. Every process
runs the same program on its own device; `torch.distributed` joins them
(NCCL between cards, gloo between CPU processes), and the sharded sketch
and distance programs (finch_tpu_torch.parallel) run unchanged over the
global mesh.

Typical use (the same command on every process, e.g. under torchrun):

    import finch_tpu_torch.parallel.distributed as dist
    dist.initialize()            # torchrun's MASTER_ADDR/WORLD_SIZE/RANK
    mesh = dist.global_mesh()    # 1-D "data" mesh over every process
    eng = ShardedSketchEngine(params, mesh, process_local=True)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist

from finch_tpu_torch.models.engine import resolve_device
from finch_tpu_torch.parallel.mesh import Mesh


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address   # tcp://host:port or file://path
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join this process to the process group.

    With no arguments, torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) describes the group; otherwise pass the
    coordinator ("host:port", or a tcp:// or file:// URL), the number of
    processes and this process's id. The backend is NCCL on the card
    (the default) and gloo with device="cpu"; without a card a CUDA
    request raises, and a group that cannot start raises too. On the
    card the process takes card LOCAL_RANK (default: its id modulo the
    cards present). Call once per process."""
    dev = resolve_device(device)
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    tdist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=_init_method(coordinator_address), **kwargs)


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh of one shard per process, over the world group: this
    process's card (NCCL) or the CPU (gloo)."""
    if tdist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Mesh([dev], axis, group=tdist.group.WORLD)


def is_primary() -> bool:
    """True on the process that should do I/O (rank 0, or the only
    process)."""
    return not tdist.is_initialized() or tdist.get_rank() == 0
