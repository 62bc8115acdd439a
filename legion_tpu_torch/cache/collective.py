"""Clique-aggregated caches: interleaved shards and their exchange (port of
``legion_tpu/cache/collective.py``).

Legion pools the cache capacity of an NVLink clique: member j of a
Kg-member clique caches the i-th hottest vertex iff i % Kg == j, at local
row i // Kg, and a lookup reads the peers' caches (features:
cache_impl.cuh:104-109, multiGPU_feat_cache_lookup :239-272; topology:
cache_impl.cuh:89-101, graph_storage.cu:76-111, operator_impl.cu:224-243).

The JAX package runs a member a device inside ``shard_map``. Here the
``Kc * Kg`` members of ``Kc`` cliques are a leading axis of one process on
one card (member d = c * Kg + g), and every call takes all of them; or,
with a clique group (``parallel/mesh.py``, layout (b)), a process is one
member and one owner of a clique across processes, and holds only its own
shard:

  slot lookup (direct [V] table, or K11 over a ``HashMap32``) ->
  K12 ``bucket_by_owner``: each member's fixed [Kg, R_req] request matrix
      of local rows, and each lane's row in the answers ->
  ``exchange``: requests to their owners (a transpose of the member axes,
      or one ``all_to_all_single`` in the clique's group) ->
  the owners answer: K1 rows of their [R, F] shard (features), or K14
      ``clique_draw`` windowed draws of their sub-CSR (topology) ->
  ``exchange`` back ->
  K13 ``clique_gather`` (features: each lane's row, or its host row through
      the pinned table for a miss or an overflow), or
      ``clique_draw_unsort`` (topology: each lane's draws in fanout-major
      order, or the host draws of ``fallback`` for a miss).

In one process the Kc cliques use one copy of the shards, which they
would each hold.

The builds are the JAX package's numpy, array for array; host rows are
read with numpy (rounded to bf16 by torch, to nearest even, as the
JAX package's C++ gather rounds). A miss reads the trainer's host table,
bf16 rows for a bf16 cache as JAX ships them (``cache/unified_cache.py``).
Each kernel's wrapper runs its plain version for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from legion_tpu_torch.cache.hashmap import HashMap32, map_lookup
from legion_tpu_torch.cache.unified_cache import K4_BLOCKS, check_host_table
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import HostTable
from legion_tpu_torch.parallel.mesh import all_to_all
from legion_tpu_torch.sampling.access import (M32, bounded, fold_in_words,
                                              hash_words, merge_draws)


def _slot_map(hot: np.ndarray, V: int, map_impl: str, device):
    """id -> global slot i of hot[i]: a [V] int32 table or a HashMap32."""
    C = len(hot)
    if map_impl == "hash":
        return HashMap32.build(hot, np.arange(C, dtype=np.int32),
                               device=device)
    m = np.full(V, -1, np.int32)
    m[hot] = np.arange(C, dtype=np.int32)
    return torch.from_numpy(m).to(device)


def build_clique_cache(feature_order: np.ndarray, group_capacity: int,
                       host_features: np.ndarray, group_size: int,
                       feat_dtype: str = "float32", map_impl: str = "direct",
                       device="cpu", owners=None):
    """Host-side FillUp (cache.cu:553-611). Returns (slot_map: id -> global
    slot, -1 absent, as a [V] int32 tensor or a HashMap32; member_rows
    [len(owners), R, F] in feat_dtype, the shards of ``owners`` (all Kg by
    default); R). Global slot i (the i-th hottest cached vertex) lives on
    member i % Kg at local row i // Kg."""
    V, F = host_features.shape
    Kg = group_size
    C = (group_capacity // Kg) * Kg  # whole rows a member
    R = max(C // Kg, 1)
    hot = np.asarray(feature_order[:C], np.int32)
    slot_map = _slot_map(hot, V, map_impl, device)
    dt = torch.bfloat16 if feat_dtype == "bfloat16" else torch.float32
    owners = range(Kg) if owners is None else owners
    member_rows = torch.zeros((len(owners), R, F), dtype=dt)
    for i, j in enumerate(owners):
        ids_j = hot[j::Kg].astype(np.int64)
        rows = torch.from_numpy(np.asarray(host_features[ids_j], np.float32))
        member_rows[i, :len(ids_j)] = rows.to(dt)
    return slot_map, member_rows.to(device), R


def build_clique_topo(topo_order: np.ndarray, group_capacity: int,
                      host_indptr: np.ndarray, host_indices: np.ndarray,
                      group_size: int, window: int = 64,
                      map_impl: str = "direct", device="cpu", owners=None):
    """Host-side topology FillUp: the hot sub-CSR partitioned over the Kg
    members (cache_impl.cuh:89-101, graph_storage.cu:76-111). Member j
    owns global slot i iff i % Kg == j, at local row i // Kg; the shards
    are padded to a common edge budget (a multiple of ``window``). Returns
    (row_map, member_pairs [n, R, 2] (start, degree) in the member's edge
    space, int32 below 2^31 edges a member else int64, member_indices2d
    [n, Eb // window, window] int32 (-1 pad), R) for the n shards of
    ``owners`` (all Kg by default)."""
    V = host_indptr.shape[0] - 1
    Kg = group_size
    C = (group_capacity // Kg) * Kg
    R = max(C // Kg, 1)
    hot = np.asarray(topo_order[:C], np.int64)
    row_map = _slot_map(hot, V, map_impl, device)

    deg_all = (host_indptr[1:] - host_indptr[:-1]).astype(np.int64)
    # a member's edge budget: the largest, rounded up to the window
    budgets = [int(deg_all[hot[j::Kg]].sum()) if len(hot[j::Kg]) else 0
               for j in range(Kg)]
    Eb = max(max(budgets), 1)
    Eb = -(-Eb // window) * window

    owners = range(Kg) if owners is None else owners
    n = len(owners)
    member_pairs = np.zeros((n, R, 2), np.int64)
    member_indices = np.full((n, Eb), -1, np.int32)
    for i, j in enumerate(owners):
        ids_j = hot[j::Kg]
        deg_j = deg_all[ids_j]
        offs = np.cumsum(deg_j)
        starts = offs - deg_j
        member_pairs[i, :len(ids_j), 0] = starts
        member_pairs[i, :len(ids_j), 1] = deg_j
        total = int(offs[-1]) if len(offs) else 0
        if total:
            e = np.arange(total, dtype=np.int64)
            row = np.searchsorted(offs, e, side="right")
            src = host_indptr[ids_j[row]] + (e - starts[row])
            member_indices[i, :total] = host_indices[src]
    if Eb < 2 ** 31:
        member_pairs = member_pairs.astype(np.int32)
    return (row_map, torch.from_numpy(member_pairs).to(device),
            torch.from_numpy(member_indices.reshape(n, Eb // window,
                                                    window)).to(device), R)


def request_rows(n: int, group_size: int, slack: float) -> int:
    """R_req, the fixed rows a member asks of each owner for n requests:
    ceil(slack * n / Kg), as the JAX package computes it."""
    return int(-(-n * slack // group_size))


def exchange(x: torch.Tensor, group=None) -> torch.Tensor:
    """The all-to-all among each clique's members: x [Kc, Kg(from), Kg(to),
    ...] -> [Kc, Kg(to), Kg(from), ...], block (from, to) to member to. On
    one card a transpose of the two member axes (a copy). With the clique's
    process group, this process is one member: x is its [1, 1, Kg(to),
    ...] block, and one ``all_to_all_single`` returns [1, 1, Kg(from),
    ...]."""
    if group is None:
        return x.transpose(1, 2).contiguous()
    if x.shape[0] != 1 or x.shape[1] != 1:
        raise ValueError(f"exchange: a member's block {tuple(x.shape)}, "
                         "want [1, 1, Kg, ...]")
    return all_to_all(x.reshape(x.shape[2:]), group).view(x.shape)


# ---------------------------------------------------------------------------
# K12 bucket_by_owner
# ---------------------------------------------------------------------------

def _owner_payload(slot: torch.Tensor, Kg: int):
    hit = slot >= 0
    return (torch.where(hit, slot % Kg, Kg).to(torch.int32),
            torch.where(hit, slot // Kg, 0).to(torch.int32))


def bucket_by_owner_plain(slot: torch.Tensor, Kg: int, R_req: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain K12 (``legion_tpu/cache/collective.py:76-104`` with the owner
    and local row of ``:174-175``): for each member row of slot [M, N]
    (global slots, -1 = miss), a stable sort of its lanes by owner (slot %
    Kg; Kg for a miss). Returns req [M, Kg, R_req] (the local rows slot //
    Kg by owner, in lane order, -1 pad, lanes past R_req dropped), row
    [M, N] (a lane's row (m * Kg + owner) * R_req + pos in the answers, -1
    for a miss or an overflow) and pos [M, N] (the lane's position in its
    owner's segment, as JAX's ``pos`` in lane order, its clipped form for
    a miss)."""
    M, N = slot.shape
    dev = slot.device
    owner, payload = _owner_payload(slot, Kg)
    perm = torch.sort(owner, dim=1, stable=True).indices
    s_owner = owner.gather(1, perm)
    s_payload = payload.gather(1, perm)
    bounds = torch.arange(Kg + 1, dtype=torch.int32,
                          device=dev).expand(M, Kg + 1).contiguous()
    seg_start = torch.searchsorted(s_owner.contiguous(), bounds)
    so_c = s_owner.clamp(0, Kg - 1)
    pos_s = (torch.arange(N, device=dev) - seg_start.gather(1, so_c.long())
             ).to(torch.int32)
    inb_s = (s_owner < Kg) & (pos_s < R_req)
    flat = torch.where(inb_s, so_c * R_req + pos_s, Kg * R_req).long()
    req = torch.full((M, Kg * R_req + 1), -1, dtype=torch.int32, device=dev)
    req.scatter_(1, flat, s_payload)
    member = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    row_s = torch.where(inb_s, (member * Kg + so_c) * R_req + pos_s, -1)
    pos = torch.empty_like(pos_s).scatter_(1, perm, pos_s)
    row = torch.empty_like(row_s).scatter_(1, perm, row_s.to(torch.int32))
    return req[:, :Kg * R_req].reshape(M, Kg, R_req), row, pos


@functools.lru_cache(maxsize=None)
def _k12_scratch(M: int, N: int, Kg: int) -> int:
    """The words of K12's scratch for these sizes (``csrc/clique.cu``:
    the tiles' counts)."""
    return kernels.lib().lt_bucket_scratch(M, N, Kg)


def bucket_by_owner(slot: torch.Tensor, Kg: int, R_req: int,
                    with_pos: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """K12, as ``bucket_by_owner_plain``: slot [M, N] int32 -> (req [M, Kg,
    R_req], row [M, N], pos [M, N] when ``with_pos`` else None), for all
    members at once: one launch where a member's lanes fit one block, else
    a count pass and a rank pass over tiles of a member's lanes (the
    tiles' counts in a scratch tensor)."""
    if slot.dtype != torch.int32 or slot.dim() != 2 or not 1 <= Kg < 32 \
            or R_req < 1 or slot.shape[0] * Kg * R_req >= 2 ** 31 - 1 \
            or slot.shape[1] >= 2 ** 30:
        raise ValueError(f"bucket_by_owner: slot {slot.dtype} "
                         f"{tuple(slot.shape)}, Kg {Kg}, R_req {R_req}")
    if slot.device.type == "cpu":
        req, row, pos = bucket_by_owner_plain(slot, Kg, R_req)
        return req, row, pos if with_pos else None
    slot = slot.contiguous()
    M, N = slot.shape
    dev = slot.device
    scratch = torch.empty((_k12_scratch(M, N, Kg),), dtype=torch.int32,
                          device=dev)
    req = torch.empty((M, Kg, R_req), dtype=torch.int32, device=dev)
    row = torch.empty((M, N), dtype=torch.int32, device=dev)
    pos = torch.empty((M, N), dtype=torch.int32, device=dev) \
        if with_pos else None
    rc = kernels.lib().lt_bucket_by_owner(
        slot.data_ptr(), M, N, Kg, R_req, req.data_ptr(), row.data_ptr(),
        None if pos is None else pos.data_ptr(), scratch.data_ptr(),
        kernels.stream_handle())
    kernels.check("bucket_by_owner", rc)
    return req, row, pos


# ---------------------------------------------------------------------------
# K13 clique_gather
# ---------------------------------------------------------------------------

def clique_gather_plain(rows: torch.Tensor, lane_row: torch.Tensor,
                        ids: torch.Tensor, host: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K13 (the requester side of ``collective.py:160-218``): lane
    (m, i) takes rows[lane_row[m, i]] where that is >= 0; else the first F
    values of the host row of ids[m, i] (f32 cast to rows' dtype, round to
    nearest even; bf16 as it is) when ``host`` is given, a zero row for
    pads, ids past the host table and without a host table. Returns (out
    [M, N, F], hits [M] int32)."""
    M, N = ids.shape
    r, i = lane_row.reshape(-1), ids.reshape(-1)
    hit = r >= 0
    out = rows[r.clamp(min=0).long()]
    from_host = torch.zeros_like(hit)
    if host is not None:
        from_host = (i >= 0) & ~hit & (i < host.shape[0])
        miss = host[torch.where(from_host, i, 0).long(),
                    :rows.shape[1]].to(rows.dtype)
        out = torch.where(from_host[:, None], miss, out)
    out = torch.where((hit | from_host)[:, None], out, torch.zeros_like(out))
    return out.view(M, N, -1), hit.view(M, N).sum(1, dtype=torch.int32)


def clique_gather(rows: torch.Tensor, lane_row: torch.Tensor,
                  ids: torch.Tensor, host: Optional[HostTable]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13. rows [*, F] (bf16 or f32) the rows the owners sent back,
    lane_row and ids [M, N] int32, host a registered [V, P] table
    (``check_host_table``) or None -> (out [M, N, F] in rows' dtype, hits
    [M] int32). K4's kernel with the slot read by lane: the ids of all
    members are sorted here, together, so the kernel reads a missed host
    row once for every lane of every member that asks for it, in address
    order, on K4's grid."""
    if ids.dtype != torch.int32 or lane_row.dtype != torch.int32 \
            or ids.dim() != 2 or lane_row.shape != ids.shape \
            or rows.dim() != 2 \
            or rows.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"clique_gather: rows {rows.dtype} "
                         f"{tuple(rows.shape)}, lane_row {lane_row.dtype} "
                         f"{tuple(lane_row.shape)}, ids {ids.dtype} "
                         f"{tuple(ids.shape)}")
    host_t = None if host is None else host.on(ids.device)
    if host_t is not None:
        check_host_table("clique_gather", host_t, rows)
    if ids.device.type == "cpu":
        return clique_gather_plain(rows, lane_row, ids, host_t)
    if not (rows.device == lane_row.device == ids.device):
        raise ValueError("clique_gather: tensors on different devices")
    M, N = ids.shape
    F = rows.shape[1]
    rows, lane_row = rows.contiguous(), lane_row.contiguous()
    sorted_ids, order = torch.sort(ids.reshape(-1))
    out = torch.empty((M * N, F), dtype=rows.dtype, device=ids.device)
    hits = torch.zeros((M,), dtype=torch.int32, device=ids.device)
    rc = kernels.lib().lt_clique_gather(
        rows.data_ptr(), lane_row.data_ptr(),
        None if host_t is None else host_t.data_ptr(),
        0 if host_t is None else host_t.shape[0],
        F if host_t is None else host_t.stride(0),
        int(host_t is not None and host_t.dtype == torch.bfloat16),
        sorted_ids.data_ptr(), order.data_ptr(), M * N, F,
        int(rows.dtype == torch.bfloat16),
        out.data_ptr(), hits.data_ptr(), max(N, 1), M, K4_BLOCKS,
        kernels.stream_handle())
    kernels.check("clique_gather", rc)
    return out.view(M, N, F), hits


# ---------------------------------------------------------------------------
# K14 clique_draw and clique_draw_unsort
# ---------------------------------------------------------------------------

def owner_words(keys: torch.Tensor, Kg: int, first: int = 0):
    """K14's words: member d = c * Kg + o's hop words (keys [Kc * Kg, 4]
    int32), each (lo, hi) pair folded with first + o (the owner's index in
    its clique; ``first`` > 0 where a process holds owners from ``first``
    on). Returns (ka0, kb0, ka1, kb1), int64 tensors [Kc, Kg, 1] in [0,
    2^32)."""
    w = keys.reshape(-1, Kg, 4).long() & M32
    o = torch.arange(first, first + Kg, dtype=torch.int64,
                     device=keys.device)[None, :]
    a0, b0 = fold_in_words(w[..., 0], w[..., 1], o)
    a1, b1 = fold_in_words(w[..., 2], w[..., 3], o)
    return tuple(x[..., None] for x in (a0, b0, a1, b1))


def _owner_rows(pairs: torch.Tensor, recv: torch.Tensor):
    """(start, deg) int64 of each received row of its owner's shard (recv
    [Kc, Kg, Q]); 0 where no row was asked for."""
    Kg, R = pairs.shape[0], pairs.shape[1]
    o = torch.arange(Kg, device=recv.device)[None, :, None]
    ok = recv >= 0
    pd = pairs[o, recv.clamp(0, R - 1).long()].long()
    zero = torch.zeros((), dtype=torch.int64, device=recv.device)
    return torch.where(ok, pd[..., 0], zero), torch.where(ok, pd[..., 1],
                                                          zero)


def clique_select(pairs: torch.Tensor, blocks: torch.Tensor,
                  recv: torch.Tensor, r0: torch.Tensor, off: torch.Tensor
                  ) -> torch.Tensor:
    """The deterministic half of the owners' draws
    (``collective.py:346-370`` for given r0 and off): pairs [Kg, R, 2],
    blocks [Kg, nblk, W], recv [Kc, Kg, Q] local rows (-1 none), r0 [Kc,
    Kg, Q] (block choice, in [0, max(deg, 1))), off [Kc, Kg, Q, fanout]
    (in-block offsets) -> [Kc, Kg, Q, fanout] neighbour ids, -1 for no
    request or degree 0."""
    Kg, nblk, W = blocks.shape
    start, deg = _owner_rows(pairs, recv)
    blk = (start + r0.long()) // W
    o = torch.arange(Kg, device=recv.device)[None, :, None]
    flat = ((o * nblk + blk.clamp(0, nblk - 1)) * W)[..., None] + off.long()
    ok = (deg > 0)[..., None].expand_as(flat)
    cand = blocks.reshape(-1)[torch.where(ok, flat, 0)]
    return torch.where(ok, cand, torch.full_like(cand, -1))


def clique_draw_plain(pairs: torch.Tensor, blocks: torch.Tensor,
                      recv: torch.Tensor, fanout: int, keys: torch.Tensor,
                      first_owner: int = 0) -> torch.Tensor:
    """Plain K14 draws: K3's scheme with ``owner_words`` (from
    ``first_owner``); r0 from lane q (a request's index in its owner's
    [Kg * R_req]), draw f from lane q * fanout + f, then
    ``clique_select``. Bit-identical to the kernel."""
    Kg, nblk, W = blocks.shape
    Q = recv.shape[2]
    ka0, kb0, ka1, kb1 = owner_words(keys, Kg, first_owner)
    start, deg = _owner_rows(pairs, recv)
    q = torch.arange(Q, dtype=torch.int64, device=recv.device)
    r0 = bounded(hash_words(ka0, kb0, q), deg.clamp(1, 2 ** 31 - 1))
    base = (start + r0) // W * W
    lo = torch.maximum(base, start) - base
    hi = torch.minimum(base + W, start + deg) - base
    lanes = (q[:, None] * fanout + torch.arange(fanout, device=recv.device)
             ) & M32
    off = lo[..., None] + bounded(hash_words(ka1[..., None], kb1[..., None],
                                             lanes),
                                  (hi - lo).clamp(min=1)[..., None])
    return clique_select(pairs, blocks, recv, r0, off)


def clique_draw(pairs: torch.Tensor, blocks: torch.Tensor,
                recv: torch.Tensor, fanout: int, keys: torch.Tensor,
                first_owner: int = 0) -> torch.Tensor:
    """K14, the owners' draws, as ``clique_draw_plain``: pairs [Kg, R, 2]
    int32/int64, blocks [Kg, nblk, W] int32, recv [Kc, Kg, Q] int32, keys
    [Kc * Kg, 4] int32 (each member's hop words), owner o's index in its
    clique first_owner + o -> [Kc, Kg, Q, fanout] int32, in one launch for
    every owner of every clique."""
    Kg = blocks.shape[0]
    if pairs.dim() != 3 or pairs.shape[0] != Kg or pairs.shape[2] != 2 \
            or pairs.dtype not in (torch.int32, torch.int64) \
            or blocks.dim() != 3 or blocks.dtype != torch.int32 \
            or recv.dim() != 3 or recv.shape[1] != Kg \
            or recv.dtype != torch.int32 or keys.dtype != torch.int32 \
            or keys.numel() != 4 * recv.shape[0] * Kg or first_owner < 0:
        raise ValueError(f"clique_draw: pairs {pairs.dtype} "
                         f"{tuple(pairs.shape)}, blocks {tuple(blocks.shape)}"
                         f", recv {recv.dtype} {tuple(recv.shape)}, keys "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if recv.device.type == "cpu":
        return clique_draw_plain(pairs, blocks, recv, fanout, keys,
                                 first_owner)
    if not (pairs.device == blocks.device == recv.device == keys.device):
        raise ValueError("clique_draw: tensors on different devices")
    Kc, _, Q = recv.shape
    pairs, blocks = pairs.contiguous(), blocks.contiguous()
    recv, keys = recv.contiguous(), keys.contiguous()
    out = torch.empty((Kc, Kg, Q, fanout), dtype=torch.int32,
                      device=recv.device)
    lib = kernels.lib()
    fn = lib.lt_clique_draw_i32 if pairs.dtype == torch.int32 \
        else lib.lt_clique_draw_i64
    rc = fn(pairs.data_ptr(), blocks.data_ptr(), pairs.shape[1],
            blocks.shape[1], blocks.shape[2], recv.data_ptr(), Kc, Kg, Q,
            fanout, keys.data_ptr(), first_owner, out.data_ptr(),
            kernels.stream_handle())
    kernels.check("clique_draw", rc)
    return out


def clique_draw_unsort_plain(back: torch.Tensor, lane_row: torch.Tensor,
                             fill: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain K14 unsort (``collective.py:398-407`` and ``:412-416``'s
    merge): lane i of member m takes back[lane_row[m, i], f] at lane
    f * F + i, or fill's value (-1 without fill) where lane_row is -1.
    back [*, fanout], lane_row [M, F], fill [M, fanout * F] -> [M, fanout
    * F]."""
    M, F = lane_row.shape
    fanout = back.shape[1]
    got = back[lane_row.clamp(min=0).long()].transpose(1, 2)  # [M, fo, F]
    other = torch.full_like(got, -1) if fill is None \
        else fill.view(M, fanout, F)
    return torch.where((lane_row >= 0)[:, None, :], got,
                       other).reshape(M, fanout * F)


def clique_draw_unsort(back: torch.Tensor, lane_row: torch.Tensor,
                       fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14's requester side, as ``clique_draw_unsort_plain``."""
    if back.dim() != 2 or back.dtype != torch.int32 \
            or lane_row.dim() != 2 or lane_row.dtype != torch.int32 \
            or (fill is not None and (
                fill.dtype != torch.int32 or tuple(fill.shape) != (
                    lane_row.shape[0], back.shape[1] * lane_row.shape[1]))):
        raise ValueError(f"clique_draw_unsort: back {back.dtype} "
                         f"{tuple(back.shape)}, lane_row {lane_row.dtype} "
                         f"{tuple(lane_row.shape)}")
    if lane_row.device.type == "cpu":
        return clique_draw_unsort_plain(back, lane_row, fill)
    if back.device != lane_row.device or (fill is not None
                                          and fill.device != back.device):
        raise ValueError("clique_draw_unsort: tensors on different devices")
    M, F = lane_row.shape
    fanout = back.shape[1]
    back, lane_row = back.contiguous(), lane_row.contiguous()
    fill = None if fill is None else fill.contiguous()
    out = torch.empty((M, fanout * F), dtype=torch.int32, device=back.device)
    rc = kernels.lib().lt_clique_draw_unsort(
        back.data_ptr(), lane_row.data_ptr(),
        None if fill is None else fill.data_ptr(), M, F, fanout,
        out.data_ptr(), kernels.stream_handle())
    kernels.check("clique_draw_unsort", rc)
    return out


# ---------------------------------------------------------------------------
# The caches
# ---------------------------------------------------------------------------

class _Clique:
    """What the two caches share: the map, the member axes, the routing.
    In one process the Kc cliques' Kg members are all here, and each holds
    its owner's shard. With ``group`` (the process group of a clique across
    processes) this process is one member, ``first_owner`` its index in the
    clique, and Kc is 1."""

    def __init__(self, id_map, group_size: int, num_cliques: int,
                 request_slack: float, group=None, first_owner: int = 0):
        self.id_map = id_map
        self.Kg = group_size
        self.Kc = num_cliques
        self.slack = request_slack
        self.group = group
        self.first_owner = first_owner
        # the members (and owners) of a clique that this process holds
        self.local = group_size if group is None else 1
        if group is not None and num_cliques != 1:
            raise ValueError(f"{num_cliques} cliques in a process that holds "
                             "one member of a clique across processes")

    def R_req(self, n: int) -> int:
        return request_rows(n, self.Kg, self.slack)

    def route(self, ids: torch.Tensor, with_pos: bool = False):
        """ids [Kc * local, N] -> (req [Kc * local, Kg, R_req], lane_row
        [Kc * local, N], pos or None) through the map and K12."""
        if ids.dim() != 2 or ids.shape[0] != self.Kc * self.local:
            raise ValueError(f"ids {tuple(ids.shape)}: want [{self.Kc} "
                             f"cliques x {self.local} members, N]")
        slot = map_lookup(self.id_map, ids)
        return bucket_by_owner(slot, self.Kg, self.R_req(ids.shape[1]),
                               with_pos)

    def to_owners(self, req: torch.Tensor) -> torch.Tensor:
        """[Kc * local, Kg, R_req] requests -> [Kc, local(owner), Kg *
        R_req], what each owner here received from the Kg members."""
        Kc, n = self.Kc, self.local
        return exchange(req.view(Kc, n, self.Kg, -1), self.group).view(
            Kc, n, -1)

    def to_members(self, answers: torch.Tensor) -> torch.Tensor:
        """[Kc, local(owner), Kg * R_req, ...] answers -> [Kc * local *
        Kg * R_req, ...], member m's answer from owner o at row (m * Kg +
        o) * R_req + pos."""
        Kc, n = self.Kc, self.local
        tail = answers.shape[3:]
        return exchange(answers.view(Kc, n, self.Kg, -1, *tail),
                        self.group).reshape(-1, *tail)


class CliqueFeatureCache(_Clique):
    """The clique's feature fetch: hits from the owners' [R, F] shards,
    misses and overflow from the pinned host table (K13), the UVA miss
    branch of multiGPU_feat_cache_lookup (cache_impl.cuh:239-272)."""

    def __init__(self, slot_map, member_rows: torch.Tensor,
                 host: Optional[HostTable], group_size: int,
                 num_cliques: int = 1, request_slack: float = 1.5,
                 group=None, first_owner: int = 0):
        super().__init__(slot_map, group_size, num_cliques, request_slack,
                         group, first_owner)
        self.member_rows = member_rows     # [local, R, F]
        self.host = host                   # [V, P] f32, or bf16 (bf16 rows)
        self.R = member_rows.shape[1]
        self.feat_dim = member_rows.shape[2]

    @property
    def slot_map(self):
        return self.id_map

    def collective_bytes(self, n_ids: int) -> dict:
        """A member's exchange bytes for one fetch of n_ids: the requests
        (int32 local rows) and the answers (rows in the shard's dtype),
        and the part that leaves the member, (Kg - 1) / Kg."""
        R_req = self.R_req(n_ids)
        req = self.Kg * R_req * 4
        resp = self.Kg * R_req * self.feat_dim * \
            self.member_rows.element_size()
        off = (self.Kg - 1) / max(self.Kg, 1)
        return dict(request_bytes=req, response_bytes=resp,
                    offchip_bytes=int((req + resp) * off), R_req=R_req)

    def _rows_back(self, req: torch.Tensor) -> torch.Tensor:
        """Requests to owners, each owner's rows by K1 (zero rows for -1),
        and back: [Kc * local * Kg * R_req, F], member m's row from owner o
        at (m * Kg + o) * R_req + pos."""
        recv = self.to_owners(req)
        Kc, n, Q = recv.shape
        served = torch.empty((Kc, n, Q, self.feat_dim),
                             dtype=self.member_rows.dtype,
                             device=recv.device)
        for c in range(Kc):
            for o in range(n):
                kernels.gather_rows(self.member_rows[o], recv[c, o],
                                    out=served[c, o])
        return self.to_members(served)

    def fetch_cached(self, ids: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exchange alone: ids [M, N] (-1 pad; M = Kc * local, the
        members here) -> (rows [M, N, F], zero rows where not served;
        served [M, N] bool)."""
        req, lane_row, _ = self.route(ids)
        rows, _ = clique_gather(self._rows_back(req), lane_row, ids, None)
        return rows, lane_row >= 0

    def fetch(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids [M, N] (M = Kc * local) -> (rows [M, N, F], hits [M] int32,
        the lanes the clique served); misses and overflow read their host
        rows."""
        req, lane_row, _ = self.route(ids)
        return clique_gather(self._rows_back(req), lane_row, ids, self.host)


class CliqueTopoCache(_Clique):
    """Neighbour draws from the clique-partitioned hot sub-CSR, each row
    drawn by its owner (K14) with the windowed scheme of K3; misses and
    overflow drawn by ``fallback`` (K5 on the pinned host CSR:
    ``CachedTopoAccess.all_miss``). ``sample_neighbors`` takes the
    frontier of every member here at once ([Kc * local, F]) and their hop
    words ([Kc * local, 4]); ``members`` tells the sampler so."""

    members = True

    def __init__(self, row_map, member_pairs: torch.Tensor,
                 member_indices2d: torch.Tensor, fallback, group_size: int,
                 num_cliques: int = 1, request_slack: float = 1.5,
                 group=None, first_owner: int = 0):
        super().__init__(row_map, group_size, num_cliques, request_slack,
                         group, first_owner)
        self.member_pairs = member_pairs           # [local, R, 2]
        self.member_indices2d = member_indices2d   # [local, Eb // W, W]
        self.fallback = fallback
        self.num_nodes = fallback.num_nodes

    @property
    def row_map(self):
        return self.id_map

    @property
    def window(self) -> int:
        return int(self.member_indices2d.shape[-1])

    def collective_bytes(self, n_frontier: int, fanout: int) -> dict:
        """A member's exchange bytes for one lookup of n_frontier rows:
        int32 row requests and int32 x fanout draws."""
        R_req = self.R_req(n_frontier)
        req = self.Kg * R_req * 4
        resp = self.Kg * R_req * fanout * 4
        off = (self.Kg - 1) / max(self.Kg, 1)
        return dict(request_bytes=req, response_bytes=resp,
                    offchip_bytes=int((req + resp) * off), R_req=R_req)

    def _draws(self, req: torch.Tensor, fanout: int, keys: torch.Tensor,
               draws) -> torch.Tensor:
        """The owners' draws, and back: [Kc * local * Kg * R_req, fanout].
        An owner draws with its own member's hop words (``keys``, the
        members here). ``draws`` = (r0, off) in ``clique_select``'s shapes
        replaces the hashed draws (the tests inject the JAX package's)."""
        recv = self.to_owners(req)
        if draws is None:
            drawn = clique_draw(self.member_pairs, self.member_indices2d,
                                recv, fanout, keys, self.first_owner)
        else:
            drawn = clique_select(self.member_pairs, self.member_indices2d,
                                  recv, *draws)
        return self.to_members(drawn)

    def lookup(self, frontier: torch.Tensor, fanout: int, keys: torch.Tensor,
               draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exchange alone: frontier [Kc * local, F] -> (nbr [Kc *
        local, fanout * F] fanout-major, -1 on lanes not served; served
        [Kc * local, F] bool)."""
        req, lane_row, _ = self.route(frontier)
        nbr = clique_draw_unsort(self._draws(req, fanout, keys, draws),
                                 lane_row)
        return nbr, lane_row >= 0

    # the split-draw API (``sampling/access.py::GraphAccess``): the host
    # draws member m's misses with m's own hop words, as the fallback's K5
    # draws them in ``sample_neighbors``
    @property
    def needs_host_draws(self) -> bool:
        return getattr(self.fallback, "needs_host_draws", False)

    def host_draw(self, frontier: torch.Tensor, fanout: int, keys,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[Kc * local, F] miss frontier and [Kc * local, 4] key words on
        the host -> [Kc * local, F, fanout]: the fallback's host draws."""
        return self.fallback.host_draw(frontier, fanout, keys, out)

    merge_draws = staticmethod(merge_draws)

    def sample_neighbors(self, frontier: torch.Tensor, fanout: int,
                         keys: torch.Tensor, draws=None) -> torch.Tensor:
        """[Kc * local, F] -> [Kc * local, fanout * F]: the clique's draws,
        and member m's misses drawn by the fallback with m's own hop
        words."""
        req, lane_row, _ = self.route(frontier)
        miss = torch.where(lane_row >= 0, -1, frontier)
        fill = torch.stack([self.fallback.sample_neighbors(f, fanout, k)
                            for f, k in zip(miss, keys)])
        return clique_draw_unsort(self._draws(req, fanout, keys, draws),
                                  lane_row, fill)
