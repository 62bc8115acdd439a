"""Bring-up of a run across processes (counterpart of
``legion_tpu/parallel/multihost.py``).

JAX's multi-host design: the processes form a "host" axis that only
reduces gradients, and every process holds its own copy of the storage.
Here a process drives one card, so a process is a rank of
``torch.distributed``: JAX's command line carries over flag for flag
(``run.py --coordinator --num-processes --process-id``), one command a
process. The backend follows the device: NCCL for a card, gloo for the
CPU. A peer that dies fails the others at the group's timeout.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from legion_tpu_torch.config import MeshConfig
from legion_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device) -> None:
    """``init_process_group`` over ``tcp://coordinator_address`` (host:port
    of process 0), NCCL for a CUDA ``device`` (made the current card
    first) and gloo for the CPU, with a 300 s timeout; returns at once if
    a group exists, as JAX's does. A failed bring-up raises."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=300))


def make_multihost_mesh(clique_size: Optional[int] = None,
                        members: int = 1) -> Mesh:
    """The mesh over every rank of the initialized world, ``members``
    members a process; the clique size defaults to ``members``, as JAX's
    defaults to the devices of a host."""
    W = dist.get_world_size()
    cfg = MeshConfig.for_devices(W * members,
                                 clique_size=clique_size or members)
    return make_mesh(cfg, W, dist.get_rank())
