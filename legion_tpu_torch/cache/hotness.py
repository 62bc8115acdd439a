"""Presampling: per-vertex access counts and per-hop maxima before training
(port of ``legion_tpu/cache/hotness.py::presample_hotness``).

node_access[v] counts batches whose id set holds v (feature hotness);
edge_access[v] counts frontier expansions of v (adjacency hotness); the
per-hop maximum of ``batch.num_nodes`` sizes the trainer's buffer caps.
The counters are plain ``index_add_``. Map dedup samples with a fresh
position map of its own, as JAX's presample does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from legion_tpu_torch.sampling.access import fold_in
from legion_tpu_torch.sampling.sampler import NeighborSampler, count_ids


def presample_hotness(sampler: NeighborSampler, access,
                      seed_bank: torch.Tensor, num_steps: int, key: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``num_steps`` presampling batches over ``seed_bank``
    ([num_steps * batch] int32, -1 padded); batch ``lid`` draws with
    ``fold_in(key, lid)``. Returns (node_access [V], edge_access [V],
    max_unique_nodes [L+1]), all int32 on the bank's device."""
    V = sampler.num_nodes
    bs = sampler.config.batch_size
    L = sampler.config.num_hops
    dev = seed_bank.device
    na = torch.zeros((V,), dtype=torch.int32, device=dev)
    ea = torch.zeros((V,), dtype=torch.int32, device=dev)
    mx = torch.zeros((L + 1,), dtype=torch.int32, device=dev)
    pos_map = sampler.init_state(dev)
    for lid in range(num_steps):
        seeds = seed_bank[lid * bs:(lid + 1) * bs]
        batch = sampler.sample(access, seeds, fold_in(key, lid),
                               edge_access=ea, pos_map=pos_map)
        count_ids(na, batch.node_ids)
        mx = torch.maximum(mx, batch.num_nodes)
    return na, ea, mx
