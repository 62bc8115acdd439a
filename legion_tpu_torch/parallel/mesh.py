"""The device mesh over ``torch.distributed`` ranks (counterpart of
``legion_tpu/parallel/mesh.py``).

JAX lays Legion's Kc NVLink cliques of Kg GPUs over two mesh axes,
("clique", "member"), with a leading "host" axis across processes. Every
axis is data-parallel; the member axis alone shares a cache. In JAX one
process drives many devices. Here one process drives one card, on which it
holds ``n_local`` members as a leading axis, and ``W`` processes (ranks)
make the world. Global member d = rank * n_local + i, JAX's row-major
order over ("host", "clique", "member") (``legion_tpu/train.py:526-533``).

Two layouts, and only these (``layout``):

  (a) the cliques lie inside a rank: Kg divides n_local (Kg = 1 is plain
      data parallel). The shape is JAX's multi-host mesh, {"host": W,
      "clique": n_local // Kg, "member": Kg} ({"clique", "member"} at W =
      1). Only the gradients, the loss, the counters and eval's sums cross
      ranks.
  (b) one card a member, the clique across ranks: n_local = 1 and Kg > 1
      divides W. The shape is JAX's single-host mesh laid over the cards,
      {"clique": W // Kg, "member": Kg}; each clique also exchanges its
      requests, rows and draws in its own process group.

Collectives go through ``all_reduce`` and ``all_to_all``, which refuse a
CUDA tensor on a gloo group and count each call and its bytes in
``COLLECTIVES`` (``reset_collective_counts`` zeroes them). A collective
captured in a CUDA graph is counted at each replay, not at capture
(``add_collective_counts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from legion_tpu_torch.config import MeshConfig

DP_AXES = ("clique", "member")

# collective calls and the bytes each rank sent, since the last reset, by
# kind (chip_smoke.py reads them per train step)
COLLECTIVES: Dict[str, Dict[str, int]] = {
    "all_reduce": {"calls": 0, "bytes": 0},
    "all_to_all": {"calls": 0, "bytes": 0}}


def reset_collective_counts() -> None:
    for c in COLLECTIVES.values():
        c.update(calls=0, bytes=0)


def collective_counts() -> Dict[str, Dict[str, int]]:
    """A copy of ``COLLECTIVES``."""
    return {k: dict(v) for k, v in COLLECTIVES.items()}


def add_collective_counts(counts: Dict[str, Dict[str, int]],
                          times: int = 1) -> None:
    """``COLLECTIVES`` += times * counts, by kind and field: the
    collectives of a captured step, which each replay runs again
    (``Trainer._replay``) and the capture does not (times -1)."""
    for k, v in counts.items():
        for f, n in v.items():
            COLLECTIVES[k][f] += times * n


@dataclass(frozen=True)
class Mesh:
    """JAX's mesh over ranks: its axes and their sizes (``shape``), this
    rank and the world's size, the members this rank holds
    (``first_member`` .. ``first_member + n_local - 1``), the process group
    of this rank's clique (layout (b) only) and the world's group (None
    when ``torch.distributed`` was not initialized: a mesh to inspect, not
    to train with)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    world: int
    n_local: int
    first_member: int
    clique_group: Optional[object]
    world_group: Optional[object]

    @property
    def clique_size(self) -> int:
        return self.shape["member"]


def layout(num_processes: int, n_local: int, clique_size: int) -> str:
    """"a" or "b" (module docstring) for W ranks of n_local members and
    cliques of Kg; a ValueError that states the rule for anything else."""
    W, n, Kg = num_processes, n_local, clique_size
    if W >= 1 and n >= 1 and Kg >= 1:
        if n % Kg == 0:
            return "a"
        if n == 1 and W % Kg == 0:
            return "b"
    raise ValueError(
        f"{W} processes of {n} members with cliques of {Kg}: a clique lies "
        "either inside a process (the clique size divides the members a "
        "process drives, --devices) or across processes of one member each "
        "(--devices 1, and the clique size divides --num-processes)")


def make_mesh(config: Optional[MeshConfig] = None, num_processes: int = 1,
              rank: int = 0) -> Mesh:
    """The mesh of ``config`` (all members of all processes: Kc cliques of
    Kg) over ``num_processes`` ranks, seen from ``rank``. With
    ``torch.distributed`` initialized, the world's group is the default
    group (also at W = 1, so that a one-rank world makes every collective
    call that a larger one makes), and in layout (b) every rank makes the
    group of every clique, in clique order, and keeps its own."""
    config = config or MeshConfig()
    W, n_dev, Kg = num_processes, config.num_devices, config.clique_size
    if W < 1 or not 0 <= rank < W or n_dev % W:
        raise ValueError(f"{n_dev} members over {W} processes, rank {rank}")
    n_local = n_dev // W
    kind = layout(W, n_local, Kg)
    if kind == "a":
        axes = (("host",) if W > 1 else ()) + DP_AXES
        sizes = ((W,) if W > 1 else ()) + (n_local // Kg, Kg)
    else:
        axes, sizes = DP_AXES, (W // Kg, Kg)
    world = clique = None
    if dist.is_initialized():
        if dist.get_world_size() != W or dist.get_rank() != rank:
            raise ValueError(
                f"mesh of {W} processes at rank {rank}, but torch.distributed"
                f" has {dist.get_world_size()} at rank {dist.get_rank()}")
        world = dist.group.WORLD
        if kind == "b":
            for c in range(W // Kg):
                g = dist.new_group(list(range(c * Kg, (c + 1) * Kg)))
                if c == rank // Kg:
                    clique = g
    return Mesh(axis_names=axes, shape=dict(zip(axes, sizes)), rank=rank,
                world=W, n_local=n_local, first_member=rank * n_local,
                clique_group=clique, world_group=world)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All mesh axes are data-parallel for training."""
    return tuple(mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def _check(name: str, t: torch.Tensor, group) -> None:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError(f"{name}: a CUDA tensor on a gloo group (the "
                         "backend follows the device: NCCL for a card)")


def _count(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind]["calls"] += 1
    COLLECTIVES[kind]["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (every rank gets the same
    bits); returns ``t``."""
    _check("all_reduce", t, group)
    _count("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [Kg, ...], block j for rank j of ``group`` -> [Kg, ...], block i
    from rank i: one ``all_to_all_single`` with equal splits."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all: {x.shape[0]} blocks for a group of "
                         f"{dist.get_world_size(group)}")
    _check("all_to_all", x, group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", x)
    dist.all_to_all_single(out, x, group=group)
    return out
