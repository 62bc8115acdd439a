"""Multi-hop fanout sampling with static shapes (port of
``legion_tpu/sampling/sampler.py``, both dedup modes).

Same contract as the JAX sampler: -1 pads, seeds at local positions
[0, batch), global dedup (a node seen at an earlier hop is not expanded
again), reversed edges (src = sampled neighbour, dst = frontier node),
fanout-major lanes, and an optional lane-aligned last hop that skips
dedup (``SamplerConfig.dedup_last_hop=False``).

Two dedup modes, as in JAX. ``"map"`` (the config's default) is Legion's
own algorithm: a [V] int32 position map (``init_state``), seeds registered
in ``begin``, each hop's new ids claimed by their least lane and ranked in
lane order, and only the touched entries reset in ``finish``; the map is
changed in place and is all ``INT32_MAX`` again when ``finish`` returns.
``"sort"`` needs no state: one stable sort of (assigned prefix ++
candidates), new ids ranked in ascending id order. The two give the same
sets in different position orders.

The kernels: K9 ``dedup_map`` (``csrc/dedup_map.cu``: seed registration,
a hop's claim / rank / resolve / read-back, the clear; ``sample`` folds a
batch's registration and clear into its first and last map-deduped hops,
so that a batch with a lane-aligned last hop is one cooperative launch)
and K8 ``dedup_sort`` (``csrc/dedup_sort.cu``: the sort's keys, then
everything after the sort in one pass). Their wrappers and plain versions
live here; a wrapper runs the plain version for CPU tensors only.

Dynamic offsets (the frontier slice, the compacted-block write) are index
tensors ``offset + arange(width)`` or pointers read by a kernel, never
``.item()``, so a step makes no host sync. The ``ids_len`` slack rule
guarantees those windows stay inside the buffer, which is where JAX's
``dynamic_slice`` would have clamped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from legion_tpu_torch.config import SamplerConfig
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.sampling.access import hop_keys

INT32_MAX = 2 ** 31 - 1
INT32_MIN = -2 ** 31
# position-map claim tags live above any valid local index (ids_len < 2**30)
CLAIM_BASE = 1 << 30
# entries of a tile of K9 (csrc/dedup.cuh::kTile) and of K8
# (csrc/dedup_sort.cu::kSortTile)
_MAP_TILE, _SORT_TILE = 1024, 2048


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


def _i32(value: int, device, shape=()) -> torch.Tensor:
    """An int32 constant made on ``device`` by a fill: no copy from the
    host, which a captured CUDA graph could not hold."""
    return torch.full(shape, value, dtype=torch.int32, device=device)


def _check_i32(name: str, *tensors: torch.Tensor) -> None:
    """All int32 of at most one dimension, on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() > 1 or t.device != dev:
            raise ValueError(f"{name}: want 1-D int32 tensors on one device, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _cuda_args(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors, which must be contiguous; anything else raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _tiles(n: int, tile: int) -> int:
    """Tiles of a dedup kernel over n entries (at least one)."""
    return max(1, -(-n // tile))


def _outputs(E: int, n_scratch: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """src_l [E], n_new [] and the kernel's scratch, int32, carved from
    one allocation (the host's time a call counts: the step is
    host-bound). The scratch comes first, at the allocation's aligned
    start: the kernels keep 64-bit tile words there."""
    buf = torch.empty((n_scratch + E + 1,), dtype=torch.int32,
                      device=device)
    return buf[n_scratch:n_scratch + E], buf[n_scratch + E], buf[:n_scratch]


# ---------------------------------------------------------------------------
# K8 dedup_sort: everything after the sort of sort dedup
# ---------------------------------------------------------------------------

def dedup_keys_plain(ids: torch.Tensor, cand: torch.Tensor, P: int
                     ) -> torch.Tensor:
    """Plain K8 keys (``legion_tpu/sampling/sampler.py:250-254``): the
    assigned prefix ids[:P] ++ the candidates, INT32_MAX for pads."""
    imax = _i32(INT32_MAX, cand.device)
    prefix = ids[:P]
    return torch.cat([torch.where(prefix >= 0, prefix, imax),
                      torch.where(cand >= 0, cand, imax)])


def dedup_keys(ids: torch.Tensor, cand: torch.Tensor, P: int
               ) -> torch.Tensor:
    """K8's key build, as ``dedup_keys_plain``: one kernel in place of two
    ``where`` and a ``cat``. ids [>= P] and cand [E] int32."""
    _check_i32("dedup_keys", ids, cand)
    if not 0 <= P <= ids.shape[0]:
        raise ValueError(f"dedup_keys: P {P}, ids {ids.shape[0]}")
    if not _cuda_args("dedup_keys", ids, cand):
        return dedup_keys_plain(ids, cand, P)
    keys = torch.empty((P + cand.shape[0],), dtype=torch.int32,
                       device=cand.device)
    rc = kernels.lib().lt_dedup_keys(ids.data_ptr(), P, cand.data_ptr(),
                                     cand.shape[0], keys.data_ptr(),
                                     kernels.stream_handle())
    kernels.check("dedup_keys", rc)
    return keys


def dedup_sort_keys(ids: torch.Tensor, cand: torch.Tensor, P: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one stable sort of sort dedup: keys (assigned prefix ids[:P] ++
    candidates, INT32_MAX for pads) and their tags. Tag < P: the existing
    entry at position tag; tag >= P: lane tag - P. A stable sort puts each
    id's authority first (the existing entry, else the lowest lane)."""
    return torch.sort(dedup_keys(ids, cand, P), stable=True)


def dedup_sort_plain(skey: torch.Tensor, stag: torch.Tensor, P: int,
                     cum: torch.Tensor, ids: torch.Tensor, cap_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K8 (``legion_tpu/sampling/sampler.py:259-293`` after the sort):
    ``skey``/``stag`` are the stably sorted keys and tags of (assigned
    prefix of length P ++ E_k candidates), INT32_MAX for pads. Runs of an
    equal id lead with their authority (the existing entry, else the
    lowest lane); new runs get positions cum + rank in ascending-id order,
    up to ``cap_k``; positions go back to lane order. Writes the kept new
    ids and then -1 into ``ids[cum:cum+W]``, W = min(E_k, cap_k), in place.
    Returns (src_l [E_k] int32, n_new int32 scalar)."""
    dev = skey.device
    M = skey.shape[0]
    E_k = M - P
    W = min(E_k, cap_k)
    stag = stag.to(torch.int32)
    valid_s = skey != INT32_MAX
    prev = torch.cat([_i32(-1, dev, (1,)), skey[:-1]])
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

    # compact the kept new ids to the front in position order
    n_new = kept_head.sum(dtype=torch.int32)
    block_idx = torch.where(kept_head, rank, _i32(W, dev)).long()
    new_block = torch.full((W + 1,), -1, dtype=torch.int32, device=dev)
    new_block.scatter_(0, block_idx, skey)
    ids.index_copy_(0, cum.long() + torch.arange(W, device=dev),
                    new_block[:W])
    return src_l[:E_k], n_new


def dedup_sort(skey: torch.Tensor, stag: torch.Tensor, P: int,
               cum: torch.Tensor, ids: torch.Tensor, cap_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8, as ``dedup_sort_plain``: skey [M] int32 ascending, stag [M]
    int32 or int64 (``torch.sort``'s indices: a permutation of [0, M)),
    cum int32 scalar on the device (read by the kernel), ids [ids_len]
    int32 with ``cum_max + min(M - P, cap_k) <= ids_len``."""
    _check_i32("dedup_sort", skey, cum, ids)
    if stag.shape != skey.shape or stag.dtype not in (torch.int32,
                                                      torch.int64):
        raise ValueError(f"dedup_sort: stag {stag.dtype} "
                         f"{tuple(stag.shape)}, skey {tuple(skey.shape)}")
    M = skey.shape[0]
    if not 0 <= P <= M or M >= 2 ** 31 - 1 or cum.numel() != 1:
        raise ValueError(f"dedup_sort: P {P}, M {M}, cum {tuple(cum.shape)}")
    if not _cuda_args("dedup_sort", skey, stag, cum, ids):
        return dedup_sort_plain(skey, stag, P, cum, ids, cap_k)
    E_k = M - P
    # the tiles' 64-bit status words and the ticket
    src_l, n_new, scratch = _outputs(E_k, 2 * (_tiles(M, _SORT_TILE) + 1),
                                     skey.device)
    rc = kernels.lib().lt_dedup_sort(
        skey.data_ptr(), stag.data_ptr(), int(stag.dtype == torch.int64), M,
        P, cum.data_ptr(), cap_k, ids.data_ptr(), ids.shape[0],
        src_l.data_ptr(), n_new.data_ptr(), scratch.data_ptr(),
        kernels.stream_handle())
    kernels.check("dedup_sort", rc)
    return src_l, n_new


# ---------------------------------------------------------------------------
# K9 dedup_map: Legion's position map
# ---------------------------------------------------------------------------

def _scatter_min(pos_map: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor, keep: torch.Tensor) -> None:
    """pos_map[idx] = min(pos_map[idx], val) where ``keep``, in place."""
    pos_map.scatter_reduce_(0, torch.where(keep, idx, 0).long(),
                            torch.where(keep, val, INT32_MAX), "amin")


def _scatter_unset(pos_map: torch.Tensor, idx: torch.Tensor,
                   keep: torch.Tensor) -> None:
    """pos_map[idx] = INT32_MAX where ``keep``, in place."""
    pos_map.scatter_reduce_(
        0, torch.where(keep, idx, 0).long(),
        torch.where(keep, _i32(INT32_MAX, idx.device),
                    _i32(INT32_MIN, idx.device)), "amax")


def _in_map(pos_map: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return (idx >= 0) & (idx < pos_map.shape[0])


def map_register_plain(pos_map: torch.Tensor, seeds: torch.Tensor) -> None:
    """Plain K9 register (``legion_tpu/sampling/sampler.py:315-318``):
    pos_map[seed] = its lane for every seed in [0, V); a seed that occurs
    twice keeps its least lane (JAX's scatter leaves that order open)."""
    lane = torch.arange(seeds.shape[0], dtype=torch.int32,
                        device=seeds.device)
    _scatter_min(pos_map, seeds, lane, _in_map(pos_map, seeds))


def map_register(pos_map: torch.Tensor, seeds: torch.Tensor) -> None:
    """K9's seed registration, in place on a clean map."""
    _check_i32("map_register", pos_map, seeds)
    if not _cuda_args("map_register", pos_map, seeds):
        return map_register_plain(pos_map, seeds)
    rc = kernels.lib().lt_map_register(
        seeds.data_ptr(), seeds.shape[0], pos_map.data_ptr(),
        pos_map.shape[0], kernels.stream_handle())
    kernels.check("dedup_map", rc)


def dedup_map_plain(cand: torch.Tensor, pos_map: torch.Tensor,
                    cum: torch.Tensor, ids: torch.Tensor, cap_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K9 hop (``legion_tpu/sampling/sampler.py:190-220``): a new
    candidate id (map entry INT32_MAX) is claimed by its least lane
    (scatter-min of CLAIM_BASE + lane), winners are ranked in lane order,
    a winner at cum + rank < cap_k is kept (map entry and ids[cum + rank]
    set), claims past the cap are cleared, and every lane reads its id's
    position back (-1 where none). Candidates outside [0, V) count as
    pads. pos_map and ids change in place. Returns (src_l [E] int32, n_new
    int32 scalar)."""
    dev = cand.device
    E = cand.shape[0]
    imax = _i32(INT32_MAX, dev)
    e_valid = _in_map(pos_map, cand)
    safe = torch.where(e_valid, cand, 0).long()
    cur = torch.where(e_valid, pos_map[safe], imax)
    is_new = e_valid & (cur == INT32_MAX)
    lane = torch.arange(E, dtype=torch.int32, device=dev)
    claim = CLAIM_BASE + lane
    _scatter_min(pos_map, cand, claim, is_new)
    won = is_new & (pos_map[safe] == claim)
    rank = torch.cumsum(won, 0, dtype=torch.int32) - 1
    local_new = cum + rank
    kept = won & (local_new < cap_k)
    n_new = kept.sum(dtype=torch.int32)
    # a claimed entry holds CLAIM_BASE + lane > any position
    _scatter_min(pos_map, cand, local_new, kept)
    ext = torch.cat([ids, _i32(-1, dev, (1,))])
    ext.scatter_(0, torch.where(kept, local_new, ids.shape[0]).long(), cand)
    ids.copy_(ext[:-1])
    # winners past the cap: clear their claim tags
    stale = e_valid & (pos_map[safe] >= CLAIM_BASE)
    _scatter_unset(pos_map, cand, stale)
    src_l = torch.where(e_valid, pos_map[safe], imax)
    return torch.where(src_l == INT32_MAX, _i32(-1, dev), src_l), n_new


def _check_map_hop(name: str, cand: torch.Tensor, pos_map: torch.Tensor,
                   cum: torch.Tensor, ids: torch.Tensor, cap_k: int) -> None:
    _check_i32(name, cand, pos_map, cum, ids)
    E = cand.shape[0]
    if E >= CLAIM_BASE or cum.numel() != 1 or cap_k > ids.shape[0]:
        raise ValueError(f"{name}: E {E}, cum {tuple(cum.shape)}, cap "
                         f"{cap_k}, ids {ids.shape[0]}")


def dedup_map(cand: torch.Tensor, pos_map: torch.Tensor, cum: torch.Tensor,
              ids: torch.Tensor, cap_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's hop, as ``dedup_map_plain``: claim, rank, assign (positions,
    ids, the unkept winners' reset, n_new) and read-back in one
    cooperative launch. cum is an int32 scalar on the device, read by the
    kernel; cap_k <= ids.shape[0]."""
    _check_map_hop("dedup_map", cand, pos_map, cum, ids, cap_k)
    if not _cuda_args("dedup_map", cand, pos_map, cum, ids):
        return dedup_map_plain(cand, pos_map, cum, ids, cap_k)
    E = cand.shape[0]
    src_l, n_new, scratch = _outputs(E, 2 * _tiles(E, _MAP_TILE), cand.device)
    rc = kernels.lib().lt_dedup_map(
        cand.data_ptr(), E, pos_map.data_ptr(), pos_map.shape[0],
        cum.data_ptr(), cap_k, ids.data_ptr(), src_l.data_ptr(),
        n_new.data_ptr(), scratch.data_ptr(), kernels.stream_handle())
    kernels.check("dedup_map", rc)
    return src_l, n_new


def dedup_map_fused_plain(cand: torch.Tensor, pos_map: torch.Tensor,
                          cum: torch.Tensor, ids: torch.Tensor, cap_k: int,
                          seeds: Optional[torch.Tensor] = None,
                          clear_len: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K9 of one call of ``sample``: ``map_register_plain(seeds)``
    when seeds are given, the hop (``dedup_map_plain``), then
    ``map_clear_plain(ids[:clear_len])``."""
    if seeds is not None:
        map_register_plain(pos_map, seeds)
    src_l, n_new = dedup_map_plain(cand, pos_map, cum, ids, cap_k)
    map_clear_plain(pos_map, ids[:clear_len])
    return src_l, n_new


def dedup_map_fused(cand: torch.Tensor, pos_map: torch.Tensor,
                    cum: torch.Tensor, ids: torch.Tensor, cap_k: int,
                    seeds: Optional[torch.Tensor] = None, clear_len: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 as ``dedup_map_fused_plain``: the seeds' registration (when
    given), the hop, and the clear of ids[:clear_len] (when clear_len >
    0), in one cooperative launch. A launch the card refuses raises."""
    _check_map_hop("dedup_map", cand, pos_map, cum, ids, cap_k)
    if not 0 <= clear_len <= ids.shape[0]:
        raise ValueError(f"dedup_map: clear_len {clear_len}, ids "
                         f"{ids.shape[0]}")
    if seeds is not None:
        _check_i32("dedup_map", seeds, cand)
    with_seeds = (cand,) if seeds is None else (cand, seeds)
    if not _cuda_args("dedup_map", *with_seeds, pos_map, cum, ids):
        return dedup_map_fused_plain(cand, pos_map, cum, ids, cap_k, seeds,
                                     clear_len)
    E = cand.shape[0]
    src_l, n_new, scratch = _outputs(E, 2 * _tiles(E, _MAP_TILE), cand.device)
    rc = kernels.lib().lt_dedup_map_fused(
        None if seeds is None else seeds.data_ptr(),
        0 if seeds is None else seeds.shape[0], cand.data_ptr(), E,
        pos_map.data_ptr(), pos_map.shape[0], cum.data_ptr(), cap_k,
        ids.data_ptr(), src_l.data_ptr(), n_new.data_ptr(), clear_len,
        scratch.data_ptr(), kernels.stream_handle())
    kernels.check("dedup_map", rc)
    return src_l, n_new


def map_clear_plain(pos_map: torch.Tensor, touched: torch.Tensor) -> None:
    """Plain K9 clear (ClearPosMap, ``legion_tpu/sampling/sampler.py:
    376-383``): pos_map[t] = INT32_MAX for every touched id in [0, V)."""
    _scatter_unset(pos_map, touched, _in_map(pos_map, touched))


def map_clear(pos_map: torch.Tensor, touched: torch.Tensor) -> None:
    """K9's clear of only the touched entries, in place."""
    _check_i32("map_clear", pos_map, touched)
    if not _cuda_args("map_clear", pos_map, touched):
        return map_clear_plain(pos_map, touched)
    rc = kernels.lib().lt_map_clear(
        touched.data_ptr(), touched.shape[0], pos_map.data_ptr(),
        pos_map.shape[0], kernels.stream_handle())
    kernels.check("dedup_map", rc)


class NeighborSampler:
    """Fanout sampler over a device-resident graph access."""

    def __init__(self, config: SamplerConfig, num_nodes: int):
        if config.dedup not in ("map", "sort"):
            raise ValueError(f"dedup={config.dedup!r}: 'map' or 'sort'")
        self.config = config
        self.num_nodes = num_nodes
        self.sort_dedup = config.dedup == "sort"
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
        L = config.num_hops
        if self.sort_dedup:
            # each deduped hop writes its compacted block, static width W_k,
            # at offset cum <= cum_caps[k]; the buffer must hold the window
            for k in range(L):
                if self.aligned_last and k == L - 1:
                    continue
                W = min(self.edge_sizes[k], self.cum_caps[k + 1])
                self.ids_len = max(self.ids_len, self.cum_caps[k] + W)
        # claim tags (CLAIM_BASE + lane) must lie above every position
        if self.ids_len >= CLAIM_BASE or max(self.edge_sizes) >= CLAIM_BASE:
            raise ValueError(f"ids_len {self.ids_len} and edge sizes "
                             f"{self.edge_sizes} must stay below 2**30")
        # map dedup: the hops that go through the map (an aligned last hop
        # never does), and the prefix of ids whose entries a batch touches
        self.map_hops = () if self.sort_dedup else tuple(
            k for k in range(L) if not (self.aligned_last and k == L - 1))
        self.touched_len = self.cum_caps[L - 1] if self.aligned_last \
            else self.ids_len

    @property
    def state_size(self) -> int:
        """Length of the sampler state: the [V] position map for "map"
        dedup; a 1-element dummy for the stateless "sort" dedup."""
        return 1 if self.sort_dedup else self.num_nodes

    def init_state(self, device) -> torch.Tensor:
        """Fresh sampler state on ``device`` (INT32_MAX = unseen)."""
        return torch.full((self.state_size,), INT32_MAX, dtype=torch.int32,
                          device=device)

    def _dedup_sort(self, cand: torch.Tensor, cum: torch.Tensor,
                    ids: torch.Tensor, k: int):
        """Sort-based dedup (``legion_tpu/sampling/sampler.py:222-293``):
        one stable sort, then K8."""
        P = self.cum_caps[k]
        skey, stag = dedup_sort_keys(ids, cand, P)
        return dedup_sort(skey, stag, P, cum, ids, self.cum_caps[k + 1])

    # -- per-hop carry pieces, as in the JAX sampler ------------------------

    def begin(self, seeds: torch.Tensor,
              pos_map: Optional[torch.Tensor] = None) -> dict:
        """Register seeds (map dedup: into ``pos_map``, which must be
        clean) and build the hop-loop carry."""
        return self._begin(seeds, pos_map, register=True)

    def _begin(self, seeds: torch.Tensor, pos_map: Optional[torch.Tensor],
               register: bool) -> dict:
        """``begin``; with ``register`` False (``sample``) the seeds, which
        the carry holds at ids[:batch_size], are registered by the first
        map-deduped hop's call."""
        batch_size = self.config.batch_size
        if tuple(seeds.shape) != (batch_size,):
            raise ValueError(f"seeds {tuple(seeds.shape)} != ({batch_size},)")
        dev = seeds.device
        seeds = seeds.to(torch.int32)
        if not self.sort_dedup:
            if pos_map is None or tuple(pos_map.shape) != (self.num_nodes,) \
                    or pos_map.device != dev:
                raise ValueError(
                    "map dedup needs its [V] position map on the seeds' "
                    f"device (sampler.init_state); got "
                    f"{None if pos_map is None else tuple(pos_map.shape)}")
            if register:
                map_register(pos_map, seeds.contiguous())
        ids = torch.full((self.ids_len,), -1, dtype=torch.int32, device=dev)
        ids[:batch_size] = seeds
        n_seeds = (seeds >= 0).sum(dtype=torch.int32)
        return dict(ids=ids, pos_map=pos_map, cum=n_seeds,
                    frontier_off=_i32(0, dev), num_nodes=(n_seeds,),
                    num_edges=(), edge_src=(), edge_dst=(), hop_offsets=())

    def hop_frontier(self, carry: dict, k: int) -> torch.Tensor:
        idx = carry["frontier_off"].long() + torch.arange(
            self.frontier_sizes[k], device=carry["ids"].device)
        return carry["ids"][idx]

    def hop_absorb(self, carry: dict, k: int, cand: torch.Tensor) -> dict:
        """Dedup hop k's candidates and record its edge lists. The carry
        owns its ids buffer (and the map): both change in place."""
        return self._absorb(carry, k, cand, fused=False)

    def _absorb(self, carry: dict, k: int, cand: torch.Tensor,
                fused: bool) -> dict:
        """``hop_absorb``; with ``fused`` (``sample``) the first
        map-deduped hop also registers the seeds and the last clears the
        batch's touched ids, in the same call and launch."""
        dev = cand.device
        F_k = self.frontier_sizes[k]
        E_k = self.edge_sizes[k]
        L = self.config.num_hops
        ids = carry["ids"]
        cum, frontier_off = carry["cum"], carry["frontier_off"]
        lane = torch.arange(E_k, dtype=torch.int32, device=dev)

        if self.aligned_last and k == L - 1:
            # lane-aligned last hop: no dedup, position = P_last + lane
            e_valid = cand >= 0
            P_last = self.cum_caps[k]
            ids[P_last:P_last + E_k] = cand
            src_l = torch.where(e_valid, P_last + lane, _i32(-1, dev))
            n_new = e_valid.sum(dtype=torch.int32)
        elif self.sort_dedup:
            src_l, n_new = self._dedup_sort(cand, cum, ids, k)
        elif fused:
            src_l, n_new = dedup_map_fused(
                cand.contiguous(), carry["pos_map"], cum, ids,
                self.cum_caps[k + 1],
                seeds=ids[:self.config.batch_size]
                if k == self.map_hops[0] else None,
                clear_len=self.touched_len if k == self.map_hops[-1] else 0)
        else:
            src_l, n_new = dedup_map(cand.contiguous(), carry["pos_map"],
                                     cum, ids, self.cum_caps[k + 1])

        e_ok = src_l >= 0
        dst_l = torch.where(e_ok, frontier_off + lane % F_k, _i32(-1, dev))
        return dict(
            carry, cum=cum + n_new, frontier_off=cum,
            num_nodes=carry["num_nodes"] + (cum + n_new,),
            num_edges=carry["num_edges"] + (e_ok.sum(dtype=torch.int32),),
            edge_src=carry["edge_src"] + (src_l,),
            edge_dst=carry["edge_dst"] + (dst_l,),
            hop_offsets=carry["hop_offsets"] + (frontier_off,))

    def finish(self, carry: dict) -> SampleBatch:
        """ClearPosMap (map dedup) and the SampleBatch."""
        return self._finish(carry, clear=not self.sort_dedup)

    def _finish(self, carry: dict, clear: bool) -> SampleBatch:
        ids = carry["ids"]
        if clear:
            # reset only the touched entries
            map_clear(carry["pos_map"], ids[:self.touched_len])
        return SampleBatch(
            node_ids=ids,
            num_nodes=torch.stack(carry["num_nodes"]),
            edge_src=carry["edge_src"],
            edge_dst=carry["edge_dst"],
            num_edges=torch.stack(carry["num_edges"]),
            hop_offsets=torch.stack(carry["hop_offsets"]))

    def sample(self, access, seeds: torch.Tensor, key,
               edge_access: Optional[torch.Tensor] = None,
               pos_map: Optional[torch.Tensor] = None) -> SampleBatch:
        """Sample one batch. ``key`` is the [L, 4] int32 key words on the
        seeds' device (row k for hop k: K10 ``step_keys``' output in a
        train or eval step), or an int key, whose words ``hop_keys`` makes
        on the host and copies over once (hop k then draws with
        ``fold_in(key, k)``). Map dedup needs ``pos_map`` (``init_state``),
        clean again on return; sort dedup ignores it. When ``edge_access``
        [V] int32 is given, each expanded frontier vertex adds one to it
        (presampling). Map dedup registers the seeds in its first
        map-deduped hop's call and clears the touched ids in its last's:
        one ``dedup_map`` call a map-deduped hop, and none besides (the
        separate registration and clear run only when no hop dedups)."""
        L = self.config.num_hops
        keys = key if isinstance(key, torch.Tensor) \
            else hop_keys(key, L, seeds.device)
        if keys.dtype != torch.int32 or tuple(keys.shape) != (L, 4):
            raise ValueError(f"sample: key words {keys.dtype} "
                             f"{tuple(keys.shape)}, want int32 ({L}, 4)")
        fused = bool(self.map_hops)
        carry = self._begin(seeds, pos_map, register=not fused)
        for k in range(L):
            frontier = self.hop_frontier(carry, k)
            if edge_access is not None:
                count_ids(edge_access, frontier)
            cand = access.sample_neighbors(frontier, self.config.fanouts[k],
                                           keys[k])
            carry = self._absorb(carry, k, cand, fused)
        return self._finish(carry, clear=not self.sort_dedup and not fused)

    def sample_members(self, access, seeds: torch.Tensor, keys: torch.Tensor,
                       pos_map: Optional[torch.Tensor] = None
                       ) -> Tuple[SampleBatch, ...]:
        """One batch for each of n members in lockstep: seeds [n, batch],
        keys [n, L, 4] (K10's words of each member), pos_map [n, V] for
        map dedup (row d is member d's map). Every member begins, then each
        hop draws all members' frontiers in one call when the access takes
        them together (``access.members``: the clique topology cache, whose
        owners answer every member at once), else member by member; then
        each member absorbs its candidates and finishes. Member d's batch
        equals ``sample(access, seeds[d], keys[d], pos_map=pos_map[d])``
        for an access that draws member by member."""
        L = self.config.num_hops
        n = seeds.shape[0]
        if tuple(keys.shape) != (n, L, 4) or keys.dtype != torch.int32:
            raise ValueError(f"sample_members: key words {keys.dtype} "
                             f"{tuple(keys.shape)}, want int32 ({n}, {L}, 4)")
        fused = bool(self.map_hops)
        maps = [None] * n if pos_map is None else list(pos_map)
        carries = [self._begin(seeds[d], maps[d], register=not fused)
                   for d in range(n)]
        for k in range(L):
            fo = self.config.fanouts[k]
            frontier = torch.stack([self.hop_frontier(c, k)
                                    for c in carries])
            if getattr(access, "members", False):
                cand = access.sample_neighbors(frontier, fo, keys[:, k])
            else:
                cand = [access.sample_neighbors(f, fo, kw)
                        for f, kw in zip(frontier, keys[:, k])]
            carries = [self._absorb(c, k, cand[d], fused)
                       for d, c in enumerate(carries)]
        return tuple(self._finish(c, clear=not self.sort_dedup and not fused)
                     for c in carries)


def count_ids(counter: torch.Tensor, ids: torch.Tensor) -> None:
    """counter[v] += 1 for every valid id (in place; pads add 0)."""
    counter.index_add_(0, ids.clamp(min=0).long(),
                       (ids >= 0).to(counter.dtype))
