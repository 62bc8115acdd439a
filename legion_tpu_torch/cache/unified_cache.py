"""Feature sources and the unified cache (port of
``legion_tpu/cache/unified_cache.py``).

``DeviceFeatureSource``: the whole feature table on the card (the
reference's in-memory mode), fetched through K1; ``fetch_head`` fetches a
prefix only and leaves the aligned last hop's rows in the table, for K15
to read at layer 0.

``UnifiedCache``: the hot feature rows and the hot-vertex sub-CSR in
device memory, planned by the cost model (``cache/cost_model.py``) and
filled once (UnifiedCache::FillUp, cache.cu:553-611): from host storage
(``build_from_host``, the trainer's), or from a feature table and a CSR
already on the device (``build``).
Lookups are direct [V] int32 tables: ``slot_map[v]`` (feature cache slot)
and ``row_map[v]`` (sub-CSR row), -1 for a vertex not cached.

``CachedFeatureSource``: cache hits from device memory, misses read by K4
(``csrc/cached_gather.cu``) straight from the pinned host table, inside
the kernel, with no host sync and no staging copy. The wrapper sorts the
ids first, so that the kernel reads each distinct missed row once, in
address order. For a bf16 cache the host table holds bf16 rows, as the
JAX package ships a miss in the cache's dtype (``CachedFeatureSource.
_host_gather``): half the link's bytes of an f32 row, and the same bits
(``ops/host_memory.py::bf16_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from legion_tpu_torch.cache.cost_model import CostModelResult
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.hop_agg import TableRows
from legion_tpu_torch.ops.host_memory import HostTable


class DeviceFeatureSource:
    """All features in device memory."""

    def __init__(self, features: torch.Tensor):
        self.features = features

    def fetch(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows [N, F] with zero rows for ids < 0, count of valid ids).
        Through K1; features are data, so no gradient is taken."""
        rows = kernels.gather_rows(self.features, ids)
        return rows, (ids >= 0).sum(dtype=torch.int32)

    def fetch_head(self, ids: torch.Tensor, n_head: int
                   ) -> Tuple[TableRows, torch.Tensor]:
        """``fetch`` with the rows of ids[n_head:] left in the table:
        (TableRows of the rows of ids[:n_head], the table and ids; count of
        the valid ids among all of ids, as ``fetch`` counts them)."""
        rows = kernels.gather_rows(self.features, ids[:n_head])
        return TableRows(rows, self.features, ids), \
            (ids >= 0).sum(dtype=torch.int32)


def _id_map(ids, num_nodes: int) -> torch.Tensor:
    """[V] int32 map: m[ids[j]] = j, -1 elsewhere (ids a numpy array, or
    an int64 tensor whose device the map takes)."""
    ids = torch.as_tensor(ids)
    m = torch.full((num_nodes,), -1, dtype=torch.int32, device=ids.device)
    m[ids] = torch.arange(len(ids), dtype=torch.int32, device=ids.device)
    return m


def _hot(order: np.ndarray, cap: int, device) -> torch.Tensor:
    """The plan's first ``cap`` ids as int64 on ``device``."""
    return torch.from_numpy(np.asarray(order[:cap], np.int64)).to(device)


def _build_feature_cache(features: torch.Tensor, qf: np.ndarray, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cache_rows, slot_map): the hot rows of the device table, gathered
    by K1 (its plain version on the CPU), and their slots
    (``legion_tpu/cache/unified_cache.py::_build_feature_cache``)."""
    hot = _hot(qf, cap, features.device)
    rows = kernels.gather_rows(features, hot.to(torch.int32))
    return rows, _id_map(hot, features.shape[0])


def _build_topo_cache(indptr: torch.Tensor, indices: torch.Tensor,
                      hot: torch.Tensor, edge_budget: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sub_indptr, sub_indices, row_map) of the ``hot`` rows (int64):
    the hot sub-CSR by degree count, cumsum and gather over
    ``edge_budget`` edge slots, -1 past the hot rows' edges
    (``legion_tpu/cache/unified_cache.py::_build_topo_cache``, the analog
    of TopoFillUp, graph_storage_impl.cuh:27-53)."""
    dev = indptr.device
    V, cap = indptr.shape[0] - 1, hot.shape[0]
    deg = indptr[hot + 1] - indptr[hot]
    offs = torch.cumsum(deg, 0)
    total = offs[-1] if cap > 0 else torch.zeros((), dtype=torch.int64,
                                                 device=dev)
    starts = offs - deg
    sub_indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            offs]).clamp(max=edge_budget)
    # edge slot j belongs to cached row searchsorted(offs, j, 'right')
    j = torch.arange(edge_budget, dtype=torch.int64, device=dev)
    row = torch.searchsorted(offs, j, right=True)
    row_c = row.clamp(0, max(cap - 1, 0))
    src_pos = indptr[hot[row_c]] + (j - starts[row_c])
    valid = j < total
    if indices.shape[0]:
        nbr = indices[src_pos.clamp(0, indices.shape[0] - 1)]
    else:
        nbr = torch.full_like(j, -1, dtype=torch.int32)
    sub_indices = torch.where(valid, nbr, -1).to(torch.int32)
    return sub_indptr, sub_indices, _id_map(hot, V)


@dataclass
class UnifiedCache:
    """Device-resident unified cache of one device."""

    cache_rows: Optional[torch.Tensor]    # [C_f, F] f32 or bf16
    slot_map: Optional[torch.Tensor]      # [V] int32, -1 = miss
    sub_indptr: Optional[torch.Tensor]    # [C_t+1] int64
    sub_indices: Optional[torch.Tensor]   # [E_c] int32
    row_map: Optional[torch.Tensor]       # [V] int32, -1 = miss
    feature_capacity: int
    topo_capacity: int

    @classmethod
    def build(cls, plan: CostModelResult, features: torch.Tensor,
              csr: DeviceCSR) -> "UnifiedCache":
        """FillUp from device storage (``legion_tpu/cache/unified_cache.py::
        UnifiedCache.build``): the hot rows of ``features`` [V, F] (any
        float dtype, kept) and the hot sub-CSR of ``csr``, on their
        device. The sub-CSR spans max(the hot rows' degrees, 1) edge
        slots, as JAX's: a hot set of empty rows gives ``sub_indices ==
        [-1]``. Plain torch but K1: set-up, once."""
        cache_rows = slot_map = None
        sub_indptr = sub_indices = row_map = None
        if plan.feature_capacity > 0:
            cache_rows, slot_map = _build_feature_cache(
                features, plan.feature_order, plan.feature_capacity)
        if plan.topo_capacity > 0:
            indptr = csr.indptr.long()
            hot = _hot(plan.topo_order, plan.topo_capacity, indptr.device)
            edge_budget = int((indptr[hot + 1] - indptr[hot]).sum())
            sub_indptr, sub_indices, row_map = _build_topo_cache(
                indptr, csr.indices, hot, max(edge_budget, 1))
        return cls(cache_rows=cache_rows, slot_map=slot_map,
                   sub_indptr=sub_indptr, sub_indices=sub_indices,
                   row_map=row_map, feature_capacity=plan.feature_capacity,
                   topo_capacity=plan.topo_capacity)

    @classmethod
    def build_from_host(cls, plan: CostModelResult,
                        host_features: Optional[np.ndarray],
                        host_indptr: Optional[np.ndarray],
                        host_indices: Optional[np.ndarray],
                        num_nodes: int, feat_dtype: str = "float32",
                        device: torch.device = "cpu") -> "UnifiedCache":
        """FillUp from host storage: the hot feature rows and the hot
        sub-CSR are gathered on the host and copied to ``device`` once
        (FeatFillUp/TopoFillUp, cache_impl.cuh:183-188,
        graph_storage_impl.cuh:27-53). feat_dtype="bfloat16" stores the
        cache in bf16, rounded to nearest even as ``lg_gather_rows_bf16``
        rounds (pair with plan_cache(bytes_per_feat=2))."""
        cache_rows = slot_map = None
        sub_indptr = sub_indices = row_map = None
        V = num_nodes
        if plan.feature_capacity > 0 and host_features is not None:
            qf = np.asarray(plan.feature_order[:plan.feature_capacity],
                            np.int64)
            rows = torch.from_numpy(
                np.asarray(host_features, np.float32)[qf])
            if feat_dtype == "bfloat16":
                rows = rows.to(torch.bfloat16)
            cache_rows = rows.to(device)
            slot_map = _id_map(qf, V).to(device)
        if plan.topo_capacity > 0 and host_indptr is not None:
            qt = np.asarray(plan.topo_order[:plan.topo_capacity], np.int64)
            deg = host_indptr[qt + 1] - host_indptr[qt]
            offs = np.cumsum(deg)
            starts = offs - deg
            total = int(offs[-1]) if len(offs) else 0
            j = np.arange(total, dtype=np.int64)
            row = np.searchsorted(offs, j, side="right")
            src_pos = host_indptr[qt[row]] + (j - starts[row])
            sub_idx = np.asarray(host_indices)[src_pos].astype(np.int32)
            sub_ip = np.concatenate([[0], offs]).astype(np.int64)
            sub_indptr = torch.from_numpy(sub_ip).to(device)
            sub_indices = torch.from_numpy(sub_idx).to(device)
            row_map = _id_map(qt, V).to(device)
        return cls(cache_rows=cache_rows, slot_map=slot_map,
                   sub_indptr=sub_indptr, sub_indices=sub_indices,
                   row_map=row_map, feature_capacity=plan.feature_capacity,
                   topo_capacity=plan.topo_capacity)

    # ---- feature path ------------------------------------------------
    def find_feat(self, ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids -> (slot, hit); pad/-1 ids miss. (FindFeat, cache.cu:180)"""
        V = self.slot_map.shape[0]
        slot = torch.where(ids >= 0, self.slot_map[ids.clamp(0, V - 1)
                                                   .long()], -1)
        return slot, slot >= 0

    def gather_cached(self, slot: torch.Tensor) -> torch.Tensor:
        c = slot.clamp(0, self.cache_rows.shape[0] - 1).long()
        return self.cache_rows[c]


# ---------------------------------------------------------------------------
# K4 cached_gather
# ---------------------------------------------------------------------------

def check_host_table(name: str, host: torch.Tensor,
                     rows: torch.Tensor) -> None:
    """A host feature table that K4 or K13 reads for rows [*, F] of
    ``rows``' dtype: [V, P] with its pitch P >= F, f32, or bf16 for bf16
    rows (a bf16 table holds a bf16 cache's rows, already rounded)."""
    if host.dim() != 2 or host.shape[1] < rows.shape[1] or not (
            host.dtype == torch.float32
            or host.dtype == torch.bfloat16 == rows.dtype):
        raise ValueError(
            f"{name}: a host table {host.dtype} {tuple(host.shape)} for "
            f"rows {rows.dtype} {tuple(rows.shape)}: it must be f32, or "
            "bf16 for bf16 rows, at least as wide as the rows")


def cached_gather_plain(cache: UnifiedCache, host_rows: torch.Tensor,
                        ids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows in the cache's dtype: cached rows for hits, the first F values
    of the host row (f32 cast to the cache's dtype, round to nearest even;
    bf16 as it is) for misses, zero rows for ids < 0 and past the host
    table; and the hit count."""
    slot, hit = cache.find_feat(ids)
    cached = cache.gather_cached(slot)
    from_host = (ids >= 0) & ~hit & (ids < host_rows.shape[0])
    miss = host_rows[torch.where(from_host, ids, 0).long(),
                     :cached.shape[1]].to(cached.dtype)
    rows = torch.where(hit[:, None], cached,
                       torch.where(from_host[:, None], miss,
                                   torch.zeros_like(miss)))
    return rows, hit.sum(dtype=torch.int32)


def sort_ids(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's order: (the ids ascending, the position of each in ``ids``).
    The kernel writes the row of ``sorted_ids[j]`` to ``out[order[j]]``."""
    return torch.sort(ids)


# K4's grid: one block of 256 threads on half of the H100's 132 SMs. K4's
# time is the link's (about 250 M 128-byte lines a second, a few hundred
# in flight are enough), and 66 blocks keep thousands in flight, so K4
# alone takes as long as with 132 * 8 blocks, which hold every thread
# slot of every SM for the whole run (the warps walk the ids grid-stride).
# The other 66 SMs stay free for the update that an ``interbatch`` step
# runs beside it on the other stream (PERF.md, `interbatch`).
K4_BLOCKS = 66


def cached_gather(cache: UnifiedCache, host: HostTable, ids: torch.Tensor,
                  max_blocks: int = K4_BLOCKS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4. cache rows [C, F] (bf16 or f32) and slot_map [V] on the card,
    host [V, P] registered host memory (``check_host_table``), ids [N]
    int32 -> (rows [N, F] in the cache's dtype, hit count as a device int32
    scalar). The ids are sorted here (values and positions, on the card, no
    sync): equal ids become neighbours, and the kernel reads a missed host
    row once for all of them, in address order. ``max_blocks`` (> 0) caps
    the kernel's grid."""
    rows_c, slot_map = cache.cache_rows, cache.slot_map
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"cached_gather: ids {ids.dtype} "
                         f"{tuple(ids.shape)}")
    host_t = host.on(ids.device)     # raises if not readable there
    check_host_table("cached_gather", host_t, rows_c)
    if ids.device.type == "cpu":
        return cached_gather_plain(cache, host_t, ids)
    if not (rows_c.device == slot_map.device == ids.device):
        raise ValueError("cached_gather: cache and ids on different "
                         "devices")
    if rows_c.dtype not in (torch.bfloat16, torch.float32) \
            or slot_map.dtype != torch.int32:
        raise ValueError(
            f"cached_gather: cache {rows_c.dtype} {tuple(rows_c.shape)}, "
            f"slot_map {slot_map.dtype}")
    rows_c, slot_map = rows_c.contiguous(), slot_map.contiguous()
    sorted_ids, order = sort_ids(ids)
    F = rows_c.shape[1]
    out = torch.empty((ids.shape[0], F), dtype=rows_c.dtype,
                      device=ids.device)
    hits = torch.zeros((), dtype=torch.int32, device=ids.device)
    rc = kernels.lib().lt_cached_gather(
        rows_c.data_ptr(), slot_map.data_ptr(), slot_map.shape[0],
        host_t.data_ptr(), host_t.shape[0], host_t.stride(0),
        int(host_t.dtype == torch.bfloat16), sorted_ids.data_ptr(),
        order.data_ptr(), ids.shape[0], F,
        int(rows_c.dtype == torch.bfloat16), out.data_ptr(),
        hits.data_ptr(), int(max_blocks), kernels.stream_handle())
    kernels.check("cached_gather", rc)
    return out, hits


class CachedFeatureSource:
    """Device hot-row cache + host-memory fallback through K4: Legion's
    zero-copy UVA feature read (multiGPU_feat_cache_lookup's gidx < 0
    branch, cache_impl.cuh:239-272), with no host round trip."""

    def __init__(self, cache: UnifiedCache, host: HostTable):
        self.cache = cache
        self.host = host          # [V, P] f32, or bf16 for a bf16 cache
        # K4's grid cap
        self.max_blocks = K4_BLOCKS

    def fetch(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows [N, F] in the cache's dtype, count of cache hits)."""
        return cached_gather(self.cache, self.host, ids, self.max_blocks)
