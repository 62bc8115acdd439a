"""Multi-hop fanout sampling with static shapes (port of
``legion_tpu/sampling/sampler.py``, sort-dedup mode).

Same contract as the JAX sampler: -1 pads, seeds at local positions
[0, batch), global dedup (a node seen at an earlier hop is not expanded
again), reversed edges (src = sampled neighbour, dst = frontier node),
fanout-major lanes, and an optional lane-aligned last hop that skips
dedup (``SamplerConfig.dedup_last_hop=False``).

Dynamic offsets (the frontier slice, the compacted-block write) are index
tensors ``offset + arange(width)``, never ``.item()``, so a step makes no
host sync. The ``ids_len`` slack rule guarantees those windows stay inside
the buffer, which is where JAX's ``dynamic_slice`` would have clamped.
Map dedup (``_dedup_map``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.sampling.access import fold_in

INT32_MAX = 2 ** 31 - 1


@dataclass
class SampleBatch:
    """One sampled mini-batch (static shapes, -1 padded); fields as in
    ``legion_tpu/sampling/sampler.py::SampleBatch``."""

    node_ids: torch.Tensor               # [ids_len] int32 global ids
    num_nodes: torch.Tensor              # [L+1] int32 cumulative per hop
    edge_src: Tuple[torch.Tensor, ...]   # per hop [E_k] int32 local idx
    edge_dst: Tuple[torch.Tensor, ...]   # per hop [E_k] int32 local idx
    num_edges: torch.Tensor              # [L] int32 valid edges per hop
    hop_offsets: torch.Tensor            # [L] int32 first slot of hop k

    @property
    def num_hops(self) -> int:
        return len(self.edge_src)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


class NeighborSampler:
    """Fanout sampler over a device-resident graph access."""

    def __init__(self, config: SamplerConfig, num_nodes: int):
        if config.dedup != "sort":
            raise NotImplementedError(
                f"dedup={config.dedup!r}: the port has sort dedup only; "
                "map dedup is a ROADMAP item (queue A)")
        self.config = config
        self.num_nodes = num_nodes
        self.frontier_sizes = config.frontier_sizes()
        self.edge_sizes = config.edge_counts()
        self.cum_caps = config.cum_sizes()
        self.max_ids = config.max_ids
        self.capped = config.node_caps is not None
        self.aligned_last = not config.dedup_last_hop
        # with measured caps the ids buffer needs slack so frontier
        # windows never run past its end
        slack = max(self.frontier_sizes[1:], default=0) if self.capped \
            else 0
        self.ids_len = self.max_ids + slack
        # each deduped hop writes its compacted block, static width W_k,
        # at offset cum <= cum_caps[k]; the buffer must hold the window
        L = config.num_hops
        for k in range(L):
            if self.aligned_last and k == L - 1:
                continue
            W = min(self.edge_sizes[k], self.cum_caps[k + 1])
            self.ids_len = max(self.ids_len, self.cum_caps[k] + W)

    def _dedup_sort(self, cand: torch.Tensor, e_valid: torch.Tensor,
                    cum: torch.Tensor, ids: torch.Tensor, k: int):
        """Sort-based dedup (``legion_tpu/sampling/sampler.py:222-293``):
        one stable sort of (assigned prefix ++ candidates) puts each id's
        authority first (the existing entry, else the lowest lane); new
        runs get positions cum + rank in ascending-id order, up to the
        cap (the largest new ids drop); positions go back to lanes and
        the new ids are compacted into ``ids[cum:cum+W]``."""
        dev = cand.device
        E_k = cand.shape[0]
        cap_k = self.cum_caps[k + 1]
        P = self.cum_caps[k]
        W = min(E_k, cap_k)
        M = P + E_k
        imax = _i32(INT32_MAX, dev)

        prefix = ids[:P]
        keys = torch.cat([torch.where(prefix >= 0, prefix, imax),
                          torch.where(e_valid, cand, imax)])
        # tag < P: existing entry at position tag; tag >= P: lane tag - P.
        # A stable sort keeps assigned-before-candidate and lane order.
        skey, stag = torch.sort(keys, stable=True)
        stag = stag.to(torch.int32)
        valid_s = skey != INT32_MAX
        prev = torch.cat([_i32([-1], dev), skey[:-1]])
        run_start = valid_s & (skey != prev)
        is_exist = stag < P

        new_head = run_start & ~is_exist
        rank = torch.cumsum(new_head, 0, dtype=torch.int32) - 1
        pos_new = cum + rank
        kept_head = new_head & (pos_new < cap_k)
        minus1 = _i32(-1, dev)
        head_pos = torch.where(is_exist, stag,
                               torch.where(kept_head, pos_new, minus1))
        # fill-forward each run head's position across its run: the last
        # run start at or before j, by a running max of run-start indices
        starts = torch.where(run_start,
                             torch.arange(M, dtype=torch.int64, device=dev),
                             torch.zeros((), dtype=torch.int64, device=dev))
        last_start = torch.cummax(starts, 0).values
        src_pos = torch.where(valid_s, head_pos[last_start], minus1)

        # back to lane order: candidate entry with tag t goes to lane
        # t - P (existing entries land in a dump slot past the end)
        lane_idx = torch.where(is_exist, _i32(E_k, dev), stag - P).long()
        src_l = torch.empty((E_k + 1,), dtype=torch.int32, device=dev)
        src_l.scatter_(0, lane_idx, src_pos)
        src_l = src_l[:E_k]

        # compact the kept new ids to the front in position order
        n_new = kept_head.sum(dtype=torch.int32)
        block_idx = torch.where(kept_head, rank, _i32(W, dev)).long()
        new_block = torch.full((W + 1,), -1, dtype=torch.int32, device=dev)
        new_block.scatter_(0, block_idx, skey)
        ids = ids.index_copy(
            0, cum.long() + torch.arange(W, device=dev), new_block[:W])
        return src_l, n_new, ids

    # -- per-hop carry pieces, as in the JAX sampler ------------------------

    def begin(self, seeds: torch.Tensor) -> dict:
        """Register seeds and build the hop-loop carry."""
        batch_size = self.config.batch_size
        if tuple(seeds.shape) != (batch_size,):
            raise ValueError(f"seeds {tuple(seeds.shape)} != ({batch_size},)")
        dev = seeds.device
        seeds = seeds.to(torch.int32)
        ids = torch.full((self.ids_len,), -1, dtype=torch.int32, device=dev)
        ids[:batch_size] = seeds
        n_seeds = (seeds >= 0).sum(dtype=torch.int32)
        return dict(ids=ids, cum=n_seeds, frontier_off=_i32(0, dev),
                    num_nodes=(n_seeds,), num_edges=(), edge_src=(),
                    edge_dst=(), hop_offsets=())

    def hop_frontier(self, carry: dict, k: int) -> torch.Tensor:
        idx = carry["frontier_off"].long() + torch.arange(
            self.frontier_sizes[k], device=carry["ids"].device)
        return carry["ids"][idx]

    def hop_absorb(self, carry: dict, k: int, cand: torch.Tensor) -> dict:
        """Dedup hop k's candidates and record its edge lists."""
        dev = cand.device
        F_k = self.frontier_sizes[k]
        E_k = self.edge_sizes[k]
        L = self.config.num_hops
        ids = carry["ids"]
        cum, frontier_off = carry["cum"], carry["frontier_off"]
        e_valid = cand >= 0
        lane = torch.arange(E_k, dtype=torch.int32, device=dev)

        if self.aligned_last and k == L - 1:
            # lane-aligned last hop: no dedup, position = P_last + lane
            # (written in place: the carry owns its ids buffer)
            P_last = self.cum_caps[k]
            ids[P_last:P_last + E_k] = cand
            src_l = torch.where(e_valid, P_last + lane, _i32(-1, dev))
            n_new = e_valid.sum(dtype=torch.int32)
        else:
            src_l, n_new, ids = self._dedup_sort(cand, e_valid, cum, ids, k)

        e_ok = src_l >= 0
        dst_l = torch.where(e_ok, frontier_off + lane % F_k, _i32(-1, dev))
        return dict(
            ids=ids, cum=cum + n_new, frontier_off=cum,
            num_nodes=carry["num_nodes"] + (cum + n_new,),
            num_edges=carry["num_edges"] + (e_ok.sum(dtype=torch.int32),),
            edge_src=carry["edge_src"] + (src_l,),
            edge_dst=carry["edge_dst"] + (dst_l,),
            hop_offsets=carry["hop_offsets"] + (frontier_off,))

    def finish(self, carry: dict) -> SampleBatch:
        return SampleBatch(
            node_ids=carry["ids"],
            num_nodes=torch.stack(carry["num_nodes"]),
            edge_src=carry["edge_src"],
            edge_dst=carry["edge_dst"],
            num_edges=torch.stack(carry["num_edges"]),
            hop_offsets=torch.stack(carry["hop_offsets"]))

    def sample(self, access, seeds: torch.Tensor, key: int,
               edge_access: Optional[torch.Tensor] = None) -> SampleBatch:
        """Sample one batch. ``key`` is an int64 (hop k draws with
        ``fold_in(key, k)``). When ``edge_access`` [V] int32 is given,
        each expanded frontier vertex adds one to it (presampling)."""
        carry = self.begin(seeds)
        for k in range(self.config.num_hops):
            frontier = self.hop_frontier(carry, k)
            if edge_access is not None:
                count_ids(edge_access, frontier)
            cand = access.sample_neighbors(frontier, self.config.fanouts[k],
                                           fold_in(key, k))
            carry = self.hop_absorb(carry, k, cand)
        return self.finish(carry)


def count_ids(counter: torch.Tensor, ids: torch.Tensor) -> None:
    """counter[v] += 1 for every valid id (in place; pads add 0)."""
    counter.index_add_(0, ids.clamp(min=0).long(),
                       (ids >= 0).to(counter.dtype))
