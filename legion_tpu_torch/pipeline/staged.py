"""The staged host pipeline (``CacheConfig.host_transfer="staged"``): port
of ``legion_tpu/pipeline/staged.py``.

The zero-copy path reads a feature miss from the pinned host table inside
K4 (K13 with members), with the SMs' loads over PCIe. The staged path
ships a batch's missed rows as one bulk copy on the copy engine instead,
between two halves of the step, as the JAX package does for runtimes with
no host callbacks:

    program A (side stream): the sample (with host topology, a chain of
        hops: K5's device-only form or the clique's draws, a copy of the
        unserved frontier to the host, the host's draws, a copy back and
        K21 ``merge_draws``), the feature lookup (the direct map inside
        K19, K11 on a hash map, or the clique's ``fetch_cached``) and K19
        ``miss_compact``: the missed lanes' ids in lane order and each
        lane's rank among them;
    host half (a worker thread): one copy of the miss ids and counts to
        pinned memory, waited on by its event alone; the C++ gather of the
        first min(n_miss, cap) missed rows into a pinned staging buffer
        (``ops/host_memory.py::gather_host_rows``); one bulk copy to the
        card on a copy stream;
    program B (the caller's stream, after an event wait on A and on the
        copy): K20 ``staged_assemble`` (cache rows, or the clique's rows,
        with the shipped rows at their lanes, zero rows for misses past the
        cap), then the trainer's forward, backward and Adam
        (``Trainer._update``).

Step N+1's program A is launched before step N's host half is awaited
(JAX's one-step lookahead, ``staged.py:546-582``), so the card runs A of
N+1 beside B of N while the host gathers. Program A owns its sampler state
(``_pm``, the position map of map dedup) and its step counter on the card
(``_ctr_d``, which K10 advances), as JAX's ``_pm`` and ``_ctr``; the probes
advance them. The staging buffers come in pairs (step parity), so step N's
rows stay put while step N+1's gather. A state whose ``train_ctr``
differs from the pipeline's count (a restore, a replayed state) drops the
lookahead (JAX's resync by value). Tensors of program A that program B
reads are ``record_stream``-ed onto the caller's stream, so the allocator
gives them out again only after B is done with them.

The miss buffer's width (``miss_cap``) comes from a probe over min(train
steps, 64) batches: 1.2 x the worst count + 256, rounded up to 512, at
most M (``eval_miss_cap``: the valid and test banks, 64 batches each, 1.5
x + 256). A batch past the cap trains with the tail misses as zero rows;
``miss_overflows`` counts such steps and the first one warns (eval:
``eval_miss_overflows``). Nothing is rebuilt.

On the CPU the same steps run in order on one thread, with the host
half's plain versions. The kernels' plain versions live here (K19, K20)
and in ``sampling/access.py`` (K21, K5's device-only form).
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from legion_tpu_torch.cache.hashmap import HashMap32
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import gather_host_rows
from legion_tpu_torch.pipeline.schedule import Mode
from legion_tpu_torch.sampling.sampler import SampleBatch

# the probes' batches and headroom (legion_tpu/pipeline/staged.py:323-372)
_PROBES = 64
_TRAIN_HEADROOM, _EVAL_HEADROOM = 1.2, 1.5


def _cap_of(worst: int, headroom: float, M: int) -> int:
    cap = int(worst * headroom) + 256
    return min(M, -(-cap // 512) * 512)


# ---------------------------------------------------------------------------
# K19 miss_compact
# ---------------------------------------------------------------------------

@dataclass
class Compacted:
    """K19's outputs for n member rows of M lanes."""

    payload: Optional[torch.Tensor]   # [n, M] slots (map and slot forms)
    m_ids: torch.Tensor               # [n, M] missed ids in lane order, -1
    m_pos: torch.Tensor               # [n, M] their lanes, -1
    rank: torch.Tensor                # [n, M] a lane's miss rank, -1
    n_miss: torch.Tensor              # [n] int32
    hits: torch.Tensor                # [n] int32


def _compact_args(ids, table, slot, hit):
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or sum(x is not None for x in (table, slot, hit)) != 1 \
            or (table is not None and (table.dtype != torch.int32
                                       or table.dim() != 1)) \
            or (slot is not None and (slot.dtype != torch.int32
                                      or slot.shape != ids.shape)) \
            or (hit is not None and (hit.dtype != torch.bool
                                     or hit.shape != ids.shape)):
        raise ValueError("miss_compact: ids [n, M] int32 and one of a [V] "
                         "int32 map, [n, M] int32 slots, [n, M] bool hits")


def miss_compact_plain(ids: torch.Tensor,
                       table: Optional[torch.Tensor] = None,
                       slot: Optional[torch.Tensor] = None,
                       hit: Optional[torch.Tensor] = None) -> Compacted:
    """Plain K19 (``_feature_tail``'s lookup and sort): a lane hits when
    table[min(id, V - 1)] >= 0 for a valid id (that value is its payload),
    when slot >= 0, or where ``hit``; it misses when its id is valid and it
    does not hit. The misses' ids and lanes in ascending lane order, -1
    past n_miss; each lane's rank among the misses, -1 for a hit or a
    pad."""
    _compact_args(ids, table, slot, hit)
    n, M = ids.shape
    payload = None
    if table is not None:
        V = table.shape[0]
        slot = torch.where(ids >= 0, table[ids.clamp(0, V - 1).long()], -1)
        payload = slot
    elif slot is not None:
        payload = slot
    h = slot >= 0 if hit is None else hit
    miss = (ids >= 0) & ~h
    rank = torch.cumsum(miss, 1, dtype=torch.int32) - 1
    rank = torch.where(miss, rank, -1)
    at = torch.where(miss, rank, M).long()
    dev = ids.device
    lane = torch.arange(M, dtype=torch.int32, device=dev).expand(n, M)
    m_ids = torch.full((n, M + 1), -1, dtype=torch.int32, device=dev)
    m_pos = torch.full((n, M + 1), -1, dtype=torch.int32, device=dev)
    m_ids.scatter_(1, at, ids)
    m_pos.scatter_(1, at, lane)
    return Compacted(payload, m_ids[:, :M], m_pos[:, :M], rank,
                     miss.sum(1, dtype=torch.int32),
                     h.sum(1, dtype=torch.int32))


def miss_compact(ids: torch.Tensor, table: Optional[torch.Tensor] = None,
                 slot: Optional[torch.Tensor] = None,
                 hit: Optional[torch.Tensor] = None) -> Compacted:
    """K19, as ``miss_compact_plain``: ids [n, M] int32 (-1 pad) with the
    direct [V] map (looked up in the kernel), slots from K11, or the
    clique's served lanes. Two launches from one C call: a count pass
    (each tile's misses and hits, its misses as ballot words) and a rank
    pass (the ranked misses written as one run a tile)."""
    _compact_args(ids, table, slot, hit)
    if ids.device.type == "cpu":
        return miss_compact_plain(ids, table, slot, hit)
    src = table if table is not None else slot if slot is not None else hit
    if src.device != ids.device:
        raise ValueError("miss_compact: tensors on different devices")
    ids, src = ids.contiguous(), src.contiguous()
    n, M = ids.shape
    dev = ids.device
    # m_ids, m_pos, rank (and the map's payload) in one allocation; n_miss,
    # hits and the kernel's scratch in another
    out = torch.empty((4 if table is not None else 3, n, M),
                      dtype=torch.int32, device=dev)
    cnt = torch.empty((2 * n + kernels.lib().lt_miss_compact_scratch(n, M),),
                      dtype=torch.int32, device=dev)
    payload = out[3] if table is not None else None
    rc = kernels.lib().lt_miss_compact(
        ids.data_ptr(), n, M,
        None if table is None else src.data_ptr(),
        0 if table is None else table.shape[0],
        None if slot is None else src.data_ptr(),
        None if hit is None else src.data_ptr(),
        None if payload is None else payload.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), cnt[:n].data_ptr(),
        cnt[n:2 * n].data_ptr(), cnt[2 * n:].data_ptr(),
        kernels.stream_handle())
    kernels.check("miss_compact", rc)
    return Compacted(slot if payload is None else payload, out[0], out[1],
                     out[2], cnt[:n], cnt[n:2 * n])


# ---------------------------------------------------------------------------
# K20 staged_assemble
# ---------------------------------------------------------------------------

def _assemble_args(rows, slot, staged, rank, cap):
    n, M = rank.shape
    ok = rank.dtype == torch.int32 and staged.dim() == 3 \
        and staged.shape[0] == n and staged.shape[1] >= cap >= 0 \
        and rows.dtype == staged.dtype \
        and rows.dtype in (torch.bfloat16, torch.float32)
    if slot is None:
        ok = ok and tuple(rows.shape) == (n, M, staged.shape[2])
    else:
        ok = ok and slot.shape == rank.shape and slot.dtype == torch.int32 \
            and rows.dim() == 2 and rows.shape[1] == staged.shape[2] \
            and rows.shape[0] > 0
    if not ok:
        raise ValueError(
            f"staged_assemble: rows {rows.dtype} {tuple(rows.shape)}, slot "
            f"{None if slot is None else tuple(slot.shape)}, staged "
            f"{staged.dtype} {tuple(staged.shape)}, rank {tuple(rank.shape)}"
            f", cap {cap}")


def staged_assemble_plain(rows: torch.Tensor, slot: Optional[torch.Tensor],
                          staged: torch.Tensor, rank: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """Plain K20 (``_assemble``): x[m, i] = staged[m, rank] for a shipped
    miss (0 <= rank < cap); else rows[slot] for slot >= 0 (clamped to the
    rows), or rows[m, i] when ``slot`` is None (the clique's rows); else
    zero. Returns [n, M, F]."""
    _assemble_args(rows, slot, staged, rank, cap)
    n, M = rank.shape
    F = staged.shape[2]
    if slot is None:
        x = rows
    else:
        got = rows[slot.clamp(0, rows.shape[0] - 1).long()]
        x = torch.where((slot >= 0)[..., None], got, torch.zeros_like(got))
    ship = (rank >= 0) & (rank < cap)
    if cap == 0:
        return x.clone()
    idx = torch.where(ship, rank, 0).long()[..., None].expand(n, M, F)
    return torch.where(ship[..., None], staged[:, :cap].gather(1, idx), x)


def staged_assemble(rows: torch.Tensor, slot: Optional[torch.Tensor],
                    staged: torch.Tensor, rank: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """K20, as ``staged_assemble_plain``: rows [C, F] with slot [n, M], or
    rows [n, M, F] with slot None; staged [n, >= cap, F], rank [n, M] ->
    x [n, M, F] in rows' dtype (bf16 or f32), each row written once."""
    _assemble_args(rows, slot, staged, rank, cap)
    if rank.device.type == "cpu":
        return staged_assemble_plain(rows, slot, staged, rank, cap)
    if any(t is not None and t.device != rank.device
           for t in (rows, slot, staged)):
        raise ValueError("staged_assemble: tensors on different devices")
    n, M = rank.shape
    F = staged.shape[2]
    rows, rank = rows.contiguous(), rank.contiguous()
    slot = None if slot is None else slot.contiguous()
    # member m's staged rows start at row m * cap
    staged = staged[:, :cap].contiguous()
    x = torch.empty((n, M, F), dtype=rows.dtype, device=rank.device)
    rc = kernels.lib().lt_staged_assemble(
        rows.data_ptr(), rows.shape[0] if slot is not None else n * M,
        None if slot is None else slot.data_ptr(), staged.data_ptr(),
        rank.data_ptr(), cap, M, n, F * rows.element_size(), x.data_ptr(),
        kernels.stream_handle())
    kernels.check("staged_assemble", rc)
    return x


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _on_stream(obj, stream) -> None:
    """``record_stream`` every tensor of a nested batch onto ``stream``."""
    if isinstance(obj, torch.Tensor):
        obj.record_stream(stream)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _on_stream(o, stream)
    elif isinstance(obj, (SampleBatch, Compacted)):
        _on_stream(tuple(vars(obj).values()), stream)


class _SplitDraws:
    """A graph access whose hops draw in three parts: ``lookup`` on the
    card, the host's draws of the unserved slots (the frontier and the
    hop's key words copied to pinned memory, one event waited on), and
    K21 ``merge_draws``: the per-hop chain of ``legion_tpu/pipeline/
    staged.py:194-320`` inside one ``sample`` call."""

    def __init__(self, access, cuda: bool):
        self.access = access
        self.cuda = cuda
        self.members = getattr(access, "members", False)

    def sample_neighbors(self, frontier, fanout, key):
        acc = self.access
        lanes, served = acc.lookup(frontier, fanout, key)
        miss = torch.where(served, -1, frontier)
        if not self.cuda:
            host = acc.host_draw(miss, fanout, key)
            return acc.merge_draws(lanes, served, host, fanout)
        miss_h = torch.empty(miss.shape, dtype=torch.int32, pin_memory=True)
        key_h = torch.empty(key.shape, dtype=torch.int32, pin_memory=True)
        miss_h.copy_(miss, non_blocking=True)
        key_h.copy_(key, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        out = torch.empty(miss.shape + (fanout,), dtype=torch.int32,
                          pin_memory=True)
        acc.host_draw(miss_h, fanout, key_h, out)
        host = out.to(frontier.device, non_blocking=True)
        return acc.merge_draws(lanes, served, host, fanout)


@dataclass
class _Sampled:
    """Program A's outputs for one batch of every member here."""

    batch: object                 # SampleBatch, or the members' tuple
    seeds: torch.Tensor
    y: torch.Tensor
    dkey: Optional[torch.Tensor]
    rows: torch.Tensor            # the cache rows [C, F], or the clique's
    slot: Optional[torch.Tensor]  # [n, M] (None: the rows are per lane)
    comp: Compacted
    counts: Optional[torch.Tensor]
    done: object = None           # on a card: the end of program A


class StagedHostPipeline:
    """Program A, the host half and program B of a staged trainer; the
    trainer delegates ``train_step`` and its eval steps here."""

    def __init__(self, trainer) -> None:
        t = self.t = trainer
        self.staged_clique = t.n_dev > 1
        self.cuda = t.device.type == "cuda"
        fs = t.feature_source
        self.host = fs.host.host           # [V, P] host rows, CPU tensor
        self.n = t.n_local
        self.feat_dim = t.dataset.meta.feature_dim
        self._table = self._hash = None
        self._rows = None
        if self.staged_clique:
            self.dtype = fs.member_rows.dtype
        else:
            self._rows = t.cache.cache_rows
            self.dtype = self._rows.dtype
            map_impl = t.config.cache.resolve_map_impl(
                t.dataset.meta.num_nodes)
            if map_impl == "hash":
                # staged.py:67-75: O(cached) hash in place of the [V] map
                cap = t.cache_plan.feature_capacity
                qf = np.asarray(t.cache_plan.feature_order[:cap], np.int64)
                self._hash = HashMap32.build(
                    qf, np.arange(cap, dtype=np.int32), device=t.device)
            else:
                self._table = t.cache.slot_map
        acc = t.graph_access
        self._access = _SplitDraws(acc, self.cuda) \
            if getattr(acc, "needs_host_draws", False) else acc
        self._pm = t._init_pos_map()
        self._ctr_d = torch.zeros((), dtype=torch.int64, device=t.device)
        self._ctr = 0
        self._prefetch: Optional[Tuple[int, _Sampled, Future, int]] = None
        self.last_gather_s = self.last_half_s = self.last_wait_s = 0.0
        self.last_n_miss = []
        self.miss_cap = self.probe_miss_cap()
        self.eval_miss_cap = self.probe_eval_miss_cap()
        self.miss_overflows = 0
        self.eval_miss_overflows = 0
        shape = (self.n, self.miss_cap, self.feat_dim)
        if self.cuda:
            self._side = t._side()
            self._copy = torch.cuda.Stream(device=t.device)
            self._pool = ThreadPoolExecutor(max_workers=1)
            self._pinned = [torch.empty(shape, dtype=self.dtype,
                                        pin_memory=True) for _ in range(2)]
            self._staged_d = [torch.empty(shape, dtype=self.dtype,
                                          device=t.device) for _ in range(2)]
            self._b_done = [None, None]
            self._copy_done = [None, None]
            self._eval_pinned = torch.empty(
                (self.n, self.eval_miss_cap, self.feat_dim), dtype=self.dtype,
                pin_memory=True)
            self._eval_copied = None
        else:
            self._staged_d = [torch.zeros(shape, dtype=self.dtype)
                              for _ in range(2)]
        self.eval_steps = {
            Mode.VALID: lambda state: self._eval_step(state, Mode.VALID),
            Mode.TEST: lambda state: self._eval_step(state, Mode.TEST)}

    # -- program A -------------------------------------------------------
    def _program_a(self, sampler, pm, base_key, ctr_d, bank, ybank,
                   n_steps: int, tag: int, counts: bool) -> _Sampled:
        """Seeds, keys (K10 advances ``ctr_d``), the sample, the feature
        lookup and K19, on the current stream."""
        t = self.t
        st = {"base_key": base_key, "ctr_d": ctr_d}
        if t.n_dev == 1:
            seeds, y, keys, dkey = t._batch_inputs(st, sampler, bank, ybank,
                                                   n_steps, "ctr", tag)
            batch = sampler.sample(self._access, seeds, keys, pos_map=pm)
            ids = batch.node_ids[:sampler.max_ids][None]
        else:
            seeds, y, keys, dkey = t._member_inputs(st, sampler, bank, ybank,
                                                    n_steps, "ctr", tag)
            batch = sampler.sample_members(self._access, seeds, keys,
                                           pos_map=pm)
            ids = torch.stack([b.node_ids[:sampler.max_ids] for b in batch])
        if self.staged_clique:
            rows, served = t.feature_source.fetch_cached(ids)
            comp, slot = miss_compact(ids, hit=served), None
        elif self._hash is not None:
            rows, slot = self._rows, self._hash.lookup(ids)
            comp = miss_compact(ids, slot=slot)
        else:
            comp = miss_compact(ids, table=self._table)
            rows, slot = self._rows, comp.payload
        c = t._counts(batch, comp.hits.sum(dtype=torch.int32)) \
            if counts else None
        return _Sampled(batch, seeds, y, dkey, rows, slot, comp, c)

    def _train_sample(self, pm, base_key, ctr_d,
                      counts: bool = True) -> _Sampled:
        t = self.t
        return self._program_a(t.sampler_t, pm, base_key, ctr_d,
                               t.train_bank, t.train_ybank,
                               t.schedule.train_step, 0, counts)

    # -- the probes ------------------------------------------------------
    def _worst(self, outs) -> int:
        return int(torch.stack([o.comp.n_miss.max() for o in outs]).max())

    def probe_miss_cap(self) -> int:
        """The train miss buffer's width from min(train steps, 64) batches
        of program A (staged.py:323-344); they advance the pipeline's
        sampler state."""
        t = self.t
        key = torch.full((), t._base_key, dtype=torch.int64,
                         device=t.device)
        ctr = torch.zeros((), dtype=torch.int64, device=t.device)
        outs = [self._train_sample(self._pm, key, ctr, counts=False)
                for _ in range(min(t.schedule.train_step, _PROBES))]
        return _cap_of(self._worst(outs), _TRAIN_HEADROOM,
                       t.sampler_t.max_ids)

    def probe_eval_miss_cap(self) -> int:
        """The eval miss buffer's width from 64 batches each of the valid
        and test banks, each from a fresh sampler state
        (staged.py:346-372)."""
        t = self.t
        key = torch.full((), t._base_key, dtype=torch.int64,
                         device=t.device)
        outs = []
        for mode in (Mode.VALID, Mode.TEST):
            bank, ybank, n_steps, _ = t._eval_banks(mode)
            if n_steps <= 0:
                continue
            pm = t._init_pos_map()
            ctr = torch.zeros((), dtype=torch.int64, device=t.device)
            outs += [self._program_a(t.sampler_e, pm, key, ctr, bank, ybank,
                                     n_steps, 1, counts=False)
                     for _ in range(min(n_steps, _PROBES))]
        worst = self._worst(outs) if outs else 0
        return _cap_of(worst, _EVAL_HEADROOM, t.sampler_e.max_ids)

    # -- the host half ----------------------------------------------------
    def _overflow(self, n_miss, cap: int, train: bool) -> None:
        worst = max(n_miss, default=0)
        if worst <= cap:
            return
        if train:
            self.miss_overflows += 1
            first = self.miss_overflows == 1
        else:
            self.eval_miss_overflows += 1
            first = self.eval_miss_overflows == 1
        if first:
            what = "staged" if train else "eval"
            counter = "miss_overflows" if train else "eval_miss_overflows"
            warnings.warn(
                f"{what} miss buffer overflow: {worst} misses > cap {cap}; "
                f"the misses past it get zero features (counted in "
                f"{counter})", stacklevel=3)

    def _gather(self, m_ids: torch.Tensor, n_miss, cap: int,
                out: torch.Tensor) -> float:
        """The first min(n_miss, cap) missed rows of each member into
        ``out`` [n, >= cap, F] (host tensors); the seconds it took."""
        t0 = time.perf_counter()
        for m, nm in enumerate(n_miss):
            k = min(nm, cap)
            gather_host_rows(self.host, m_ids[m, :k], out[m, :k])
        return time.perf_counter() - t0

    def _ids_to_host(self, comp: Compacted, cap: int):
        """The first ``cap`` miss ids and the counts copied to pinned
        memory on the current stream: (ids, counts, the copies' event)."""
        ids_h = torch.empty((self.n, cap), dtype=torch.int32, pin_memory=True)
        nm_h = torch.empty((self.n,), dtype=torch.int32, pin_memory=True)
        ids_h.copy_(comp.m_ids[:, :cap], non_blocking=True)
        nm_h.copy_(comp.n_miss, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return ids_h, nm_h, ready

    @staticmethod
    def _ship(pin: torch.Tensor, dev: torch.Tensor, n_miss, cap: int):
        """One bulk copy a member of its first min(n_miss, cap) gathered
        rows to the card, on the current stream; the copies' event."""
        for m, nm in enumerate(n_miss):
            k = min(nm, cap)
            if k:
                dev[m, :k].copy_(pin[m, :k], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return done

    def _host_half(self, i: int, ids_h: torch.Tensor, nm_h: torch.Tensor,
                   ready):
        """The worker's part on a card: wait for the copy of the miss ids
        (its event), gather the rows into pinned buffer i once the last copy
        out of it is done, and ship them in one copy a member on the copy
        stream after the update that last read device buffer i. Returns
        (the copy's event, n_miss, gather seconds, seconds from the ids'
        arrival to the copy's issue)."""
        cap = self.miss_cap
        with torch.cuda.device(self.t.device):
            ready.synchronize()
            t0 = time.perf_counter()
            n_miss = nm_h.tolist()
            if self._copy_done[i] is not None:
                self._copy_done[i].synchronize()
            pin = self._pinned[i]
            gather_s = self._gather(ids_h, n_miss, cap, pin)
            with torch.cuda.stream(self._copy):
                if self._b_done[i] is not None:
                    self._copy.wait_event(self._b_done[i])
                done = self._ship(pin, self._staged_d[i], n_miss, cap)
            self._copy_done[i] = done
            return done, n_miss, gather_s, time.perf_counter() - t0

    def _dispatch(self, ctr: int, base_key: torch.Tensor):
        """Program A of the train batch at ``ctr`` on the side stream and its
        host half in the worker; on the CPU both, in order."""
        i = ctr % 2
        if not self.cuda:
            a = self._train_sample(self._pm, base_key, self._ctr_d)
            fut = Future()
            n_miss = a.comp.n_miss.tolist()
            s = self._gather(a.comp.m_ids, n_miss, self.miss_cap,
                             self._staged_d[i])
            fut.set_result((None, n_miss, s, s))
            return ctr, a, fut, i
        side = self._side
        base_key.record_stream(side)
        with torch.cuda.stream(side):
            a = self._train_sample(self._pm, base_key, self._ctr_d)
            ids_h, nm_h, ready = self._ids_to_host(a.comp, self.miss_cap)
        a.done = ready
        return ctr, a, self._pool.submit(self._host_half, i, ids_h, nm_h,
                                         ready), i

    def _resync(self, state: Dict) -> None:
        """JAX's resync by value (staged.py:553-558): a state whose
        train_ctr differs from the pipeline's count drops the lookahead
        and restarts program A's counter there."""
        c = int(state["train_ctr"])
        if c == self._ctr:
            return
        self._ctr = c
        if self._prefetch is not None and self._prefetch[0] != c:
            self._drop()
        if self.cuda:
            self._side.wait_stream(torch.cuda.current_stream(self.t.device))
            with torch.cuda.stream(self._side):
                self._ctr_d.fill_(c)
        else:
            self._ctr_d.fill_(c)

    def _drop(self) -> None:
        """Forget the lookahead, after its host half has finished."""
        if self._prefetch is not None:
            self._prefetch[2].result()
            self._prefetch = None

    # -- program B ---------------------------------------------------------
    def _assemble(self, a: _Sampled, staged: torch.Tensor,
                  cap: int) -> torch.Tensor:
        x = staged_assemble(a.rows, a.slot, staged, a.comp.rank, cap)
        return x[0] if self.t.n_dev == 1 else x

    def train_step(self, state: Dict) -> Tuple[Dict, torch.Tensor]:
        """Program B of the batch at ``train_ctr``, with program A of the
        next batch launched first (the lookahead); the trainer's counters
        from program A."""
        t = self.t
        self._resync(state)
        if self._prefetch is None:
            if self.cuda:
                self._side.wait_stream(
                    torch.cuda.current_stream(t.device))
            self._prefetch = self._dispatch(self._ctr, state["base_key"])
        _, a, fut, i = self._prefetch
        self._prefetch = self._dispatch(self._ctr + 1, state["base_key"])
        t0 = time.perf_counter()
        done, n_miss, self.last_gather_s, self.last_half_s = fut.result()
        self.last_wait_s = time.perf_counter() - t0
        self.last_n_miss = n_miss
        self._overflow(n_miss, self.miss_cap, train=True)
        if self.cuda:
            cur = torch.cuda.current_stream(t.device)
            _on_stream((a.batch, a.seeds, a.y, a.dkey, a.rows, a.slot,
                        a.comp, a.counts), cur)
            cur.wait_event(a.done)
            cur.wait_event(done)
            if t._clique_group is not None:
                # the next batch's clique all-to-alls before this step's
                # all-reduces, on every rank (Trainer._interbatch_step)
                cur.wait_event(self._prefetch[1].done)
        x = self._assemble(a, self._staged_d[i], self.miss_cap)
        loss = t._update(state, a.batch, x, a.seeds, a.y, a.dkey)
        state["train_ctr_d"].add_(1)    # what K10 does in the plain step
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(cur)
            self._b_done[i] = ev
        state["train_ctr"] += 1
        self._ctr += 1
        t._set_counts(a.counts)
        return state, loss

    @torch.no_grad()
    def _eval_step(self, state: Dict, mode: Mode) -> None:
        """One eval batch (staged.py:474-496): program A on the current
        stream from the state's sampler state and counter, the host half
        in place (one event waited on), K20 and the model."""
        t = self.t
        sampler = t.sampler_e
        bank, ybank, n, ctr = t._eval_banks(mode)
        a = self._program_a(sampler, state["pos_map"], state["base_key"],
                            state[ctr + "_d"], bank, ybank, n, 1,
                            counts=False)
        cap = self.eval_miss_cap
        if self.cuda:
            ids_h, nm_h, ready = self._ids_to_host(a.comp, cap)
            ready.synchronize()
            if self._eval_copied is not None:
                self._eval_copied.synchronize()
            n_miss = nm_h.tolist()
            pin = self._eval_pinned
            self._gather(ids_h, n_miss, cap, pin)
            staged = torch.empty(pin.shape, dtype=self.dtype,
                                 device=t.device)
            self._eval_copied = self._ship(pin, staged, n_miss, cap)
        else:
            n_miss = a.comp.n_miss.tolist()
            staged = torch.zeros((self.n, cap, self.feat_dim),
                                 dtype=self.dtype)
            self._gather(a.comp.m_ids, n_miss, cap, staged)
        self._overflow(n_miss, cap, train=False)
        x = self._assemble(a, staged, cap)
        t._eval_on(state, a.batch, x, a.seeds, a.y)
        state[ctr] += 1

    def close(self) -> None:
        """Finish the pending lookahead's host half, stop the worker and
        free the pinned buffers. Safe to call more than once."""
        if self._prefetch is not None:
            self._drop()
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None
        self._pinned = self._eval_pinned = None
