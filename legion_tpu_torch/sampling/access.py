"""Graph access strategies for the sampler (port of
``legion_tpu/sampling/access.py``: ``DeviceCSRAccess``,
``WindowedCSRAccess`` and ``CachedTopoAccess``), plus the port's
counter-based random words.

Randomness: a draw is a pure function of an integer key and a lane,
``hash_words(ka, kb, lane)``, so the CUDA kernels and their plain versions
give the same bits. A hop draws with four 32-bit key words,
``draw_keys(hop_key)``. In a train or eval step K10 ``step_keys`` derives
them on the card from the state's base key and step counter,
``hop_key = fold_in(fold_in(fold_in(base_key, ctr), tag), k)``, the analog
of the JAX package's ``_device_key``, and K3 and K5 read them through a
pointer; ``hop_keys`` makes the same words on the host from an integer key
(presampling, tests). The bits differ from JAX's threefry stream; parity
tests inject JAX's draws into ``windowed_select`` and ``csr_select``.

``hash32`` and friends work on Python ints and on int64 tensors holding
values in [0, 2**32): every product is split so it stays below 2**63.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import HostTable, host_draw

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# folded into a train step's key for its dropout key, as the JAX step does
# (legion_tpu/train.py:612)
DROPOUT_TAG = 7
# the high 32 bits of GAT's attention-dropout fold into that dropout key
# (``ops/dropout.py::attn_fold``): layer i's feature masks fold i, its
# attention masks (ATTN_TAG << 32) | i
ATTN_TAG = 1


def _mul32(x, c: int):
    """(x * c) mod 2**32 without leaving int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash32(x):
    """The "lowbias32" integer hash (csrc/common.cuh::lt_hash32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_in_words(lo, hi, data):
    """``fold_in`` on a key held as its 32-bit halves (lo, hi): ints, or
    int64 tensors in [0, 2**32). ``data`` is an int or an int64 tensor;
    its halves are taken with masks, which is right for negative values
    and the arithmetic shift of int64 too. Returns the new (lo, hi)."""
    lo2 = hash32(lo ^ hash32((data & M32) ^ _GOLDEN))
    hi2 = hash32(hi ^ hash32(lo2 ^ ((data >> 32) & M32)))
    return lo2, hi2


def fold_in(key: int, data: int) -> int:
    """New 64-bit key from (key, data); host-side, no device work."""
    lo2, hi2 = fold_in_words(key & M32, (key >> 32) & M32, data)
    return (hi2 << 32) | lo2


def stream_keys(key: int, stream: int) -> Tuple[int, int]:
    """The two 32-bit keys (ka, kb) of one random stream of ``key``."""
    k = fold_in(key, stream)
    return k & M32, k >> 32


def draw_keys(key: int) -> Tuple[int, int, int, int]:
    """K3's four 32-bit keys: (ka0, kb0) of stream 0 for the block choice,
    (ka1, kb1) of stream 1 for the in-block draws."""
    return stream_keys(key, 0) + stream_keys(key, 1)


def _as_i32(words):
    """uint32 values (int64 tensor or ints) as the int32 of the same bits."""
    if isinstance(words, torch.Tensor):
        return torch.where(words >= 2 ** 31, words - 2 ** 32,
                           words).to(torch.int32)
    return [w - 2 ** 32 if w >= 2 ** 31 else w for w in words]


def key_tensor(keys, device) -> torch.Tensor:
    """int32 tensor (uint32 bits) of ``draw_keys`` of each int key, made on
    the host and copied to ``device`` once: [4] for one key, [n, 4] for a
    list."""
    rows = [_as_i32(draw_keys(k)) for k in
            (keys if isinstance(keys, list) else [keys])]
    t = torch.tensor(rows, dtype=torch.int32).to(device)
    return t if isinstance(keys, list) else t[0]


def hop_keys(key: int, num_hops: int, device) -> torch.Tensor:
    """[num_hops, 4] int32 (uint32 bits): row k is ``draw_keys(fold_in(key,
    k))``, hop k's words."""
    return key_tensor([fold_in(key, k) for k in range(num_hops)], device)


def key_words(key) -> Tuple:
    """A hop's four key words (ka0, kb0, ka1, kb1) for the plain versions:
    ints from an int key, 0-dim int64 tensors in [0, 2**32) from a [4]
    int32 word tensor (no host sync)."""
    if isinstance(key, torch.Tensor):
        w = key.reshape(4).long() & M32
        return tuple(w[i] for i in range(4))
    return draw_keys(key)


def _key_arg(name: str, key, device) -> torch.Tensor:
    """The kernel's key operand: a [4] int32 word tensor on ``device`` (a
    row of ``step_keys``/``hop_keys``), or an int key's words uploaded."""
    if not isinstance(key, torch.Tensor):
        return key_tensor(key, device)
    if key.dtype != torch.int32 or key.numel() != 4 \
            or key.device != device or not key.is_contiguous():
        raise ValueError(f"{name}: key words {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}, want 4 "
                         f"contiguous int32 on {device}")
    return key


# ---------------------------------------------------------------------------
# K10 step_keys
# ---------------------------------------------------------------------------

def step_keys_plain(base_key: torch.Tensor, ctr: torch.Tensor, tag: int,
                    num_hops: int, n_dev: int = 1, first: int = 0,
                    n: Optional[int] = None, dropout: bool = False):
    """Plain K10 in int64 torch ops: with step = fold_in(fold_in(base_key,
    ctr), tag), row k of the [num_hops, 4] int32 result is
    ``draw_keys(fold_in(step, k))`` as uint32 bits; then ctr += 1 in
    place. Equal bit for bit to the host chain ``hop_keys(fold_in(fold_in(
    base, c), tag), num_hops)``. In a world of n_dev > 1 members the
    result is [n, num_hops, 4] for the n members first .. first + n - 1 (all
    n_dev by default), member d's from fold_in(step, d) (JAX's
    ``_device_key`` folds the device index after the tag): a rank that
    holds one member of many folds its own index. With one member in the
    world no device index is folded in. With ``dropout`` it returns
    (words, drop): ``drop`` is each member's dropout key fold_in(step_d,
    7) as int32 (lo, hi), [2] or [n, 2] (``dropout_words``)."""
    n = _check_members(n_dev, first, n)
    b, c = base_key.reshape(()), ctr.reshape(())
    lo, hi = fold_in_words(b & M32, (b >> 32) & M32, c)
    lo, hi = fold_in_words(lo, hi, tag)
    if n_dev > 1:
        dev = torch.arange(first, first + n, dtype=torch.int64,
                           device=ctr.device)
        lo, hi = fold_in_words(lo, hi, dev[:, None])
    hop = torch.arange(num_hops, dtype=torch.int64, device=ctr.device)
    hlo, hhi = fold_in_words(lo, hi, hop)
    words = _as_i32(torch.stack(fold_in_words(hlo, hhi, 0)
                                + fold_in_words(hlo, hhi, 1), dim=-1))
    ctr.add_(1)
    if not dropout:
        return words
    drop = torch.stack(fold_in_words(lo, hi, DROPOUT_TAG), dim=-1)
    return words, _as_i32(drop.reshape(-1, 2) if n_dev > 1
                          else drop.reshape(2))


def _check_members(n_dev: int, first: int, n: Optional[int]) -> int:
    """The members a K10 launch writes for (n, by default n_dev - first),
    or a ValueError unless 0 <= first < first + n <= n_dev."""
    n = n_dev - first if n is None else n
    if not (n_dev >= 1 and first >= 0 and n >= 1 and first + n <= n_dev):
        raise ValueError(f"step_keys: members {first} .. {first + n - 1} of "
                         f"{n_dev}")
    return n


def step_keys(base_key: torch.Tensor, ctr: torch.Tensor, tag: int,
              num_hops: int, n_dev: int = 1, first: int = 0,
              n: Optional[int] = None, dropout: bool = False):
    """K10, as ``step_keys_plain``: base_key and ctr are int64 scalars on
    one device; one launch writes the [num_hops, 4] key words ([n,
    num_hops, 4] for members first .. first + n - 1 of n_dev > 1) and adds
    one to ctr, with no host word in the launch (a captured step replays
    with each step's keys). With ``dropout`` the same launch also writes
    each member's dropout key words, and it returns (words, drop)."""
    if base_key.dtype != torch.int64 or ctr.dtype != torch.int64 \
            or base_key.numel() != 1 or ctr.numel() != 1 \
            or base_key.device != ctr.device or num_hops <= 0 \
            or tag not in (0, 1):
        raise ValueError(f"step_keys: base_key {base_key.dtype} "
                         f"{tuple(base_key.shape)}, ctr {ctr.dtype} "
                         f"{tuple(ctr.shape)}, tag {tag}, hops {num_hops}")
    n = _check_members(n_dev, first, n)
    dev = ctr.device
    if dev.type == "cpu":
        return step_keys_plain(base_key, ctr, tag, num_hops, n_dev, first, n,
                               dropout)
    shape = (num_hops, 4) if n_dev == 1 else (n, num_hops, 4)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    drop = torch.empty((2,) if n_dev == 1 else (n, 2), dtype=torch.int32,
                       device=dev) if dropout else None
    rc = kernels.lib().lt_step_keys(base_key.data_ptr(), ctr.data_ptr(), tag,
                                    num_hops, 0 if n_dev == 1 else n, first,
                                    out.data_ptr(),
                                    None if drop is None else drop.data_ptr(),
                                    kernels.stream_handle())
    kernels.check("step_keys", rc)
    return out if drop is None else (out, drop)


def dropout_words(key: int, device) -> torch.Tensor:
    """The [2] int32 (lo, hi) of fold_in(key, 7), the dropout key of the
    step key ``key``, made on the host (K10 writes the same on the card for
    a train step: ``step_keys(..., dropout=True)``)."""
    k = fold_in(key, DROPOUT_TAG)
    return torch.tensor(_as_i32([k & M32, k >> 32]), dtype=torch.int32,
                        device=device)


def hash_words(ka, kb, lanes: torch.Tensor) -> torch.Tensor:
    """Random 32-bit words (as int64) for int64 ``lanes``
    (csrc/common.cuh::lt_word)."""
    return hash32(hash32(lanes ^ ka) ^ kb)


def bounded(words: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Uniform ints in [0, m) from 32-bit words: (w * m) >> 32, m < 2**31."""
    return (words * m) >> 32


class GraphAccess:
    """Interface: draw ``fanout`` neighbours per frontier vertex.

    The split-draw API (``legion_tpu/sampling/access.py:47-84``) is the
    staged pipeline's (``pipeline/staged.py``): a hop is ``lookup`` on the
    card, ``host_draw`` on the host for the slots it did not serve, and
    ``merge_draws`` (K21), which equals ``sample_neighbors`` bit for bit.
    The host draws with the hop's own key words, as K5 draws a miss (the
    JAX package hands its host sampler a seed, ``host_seed``, which has no
    counterpart here)."""

    num_nodes: int
    needs_host_draws = False

    def sample_neighbors(self, frontier: torch.Tensor, fanout: int,
                         key) -> torch.Tensor:
        """frontier [F] int32 (-1 pad) -> neighbours [fanout*F] int32 in
        FANOUT-MAJOR lane order (draw f of slot i at lane f*F + i), -1
        where the slot is invalid or the vertex has no edges. ``key`` is
        the hop's [4] int32 key words on the frontier's device, or an int
        key."""
        raise NotImplementedError

    def lookup(self, frontier: torch.Tensor, fanout: int, key
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draws on the card alone: (lanes [fanout*F] fanout-major, served
        [F] bool). A slot not served draws on the host (``host_draw``).
        By default every valid slot is served by ``sample_neighbors``."""
        return self.sample_neighbors(frontier, fanout, key), frontier >= 0

    def host_draw(self, frontier: torch.Tensor, fanout: int, key,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The host's draws [F, fanout] for a frontier on the host whose
        served slots are -1."""
        raise NotImplementedError

    @staticmethod
    def merge_draws(lanes: torch.Tensor, served: torch.Tensor,
                    host_nbr: torch.Tensor, fanout: int) -> torch.Tensor:
        return merge_draws(lanes, served, host_nbr, fanout)


def _frontier_rows(row_pairs: torch.Tensor, frontier: torch.Tensor,
                   num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, deg) as int64 per frontier slot; 0 for invalid slots."""
    fvalid = frontier >= 0
    pd = row_pairs[frontier.clamp(0, num_nodes - 1).long()].long()
    zero = torch.zeros((), dtype=torch.int64, device=frontier.device)
    return torch.where(fvalid, pd[:, 0], zero), \
        torch.where(fvalid, pd[:, 1], zero)


# ---------------------------------------------------------------------------
# K5 csr_draw
# ---------------------------------------------------------------------------

def _draw_rows(frontier: torch.Tensor, indptr: torch.Tensor,
               row_map: Optional[torch.Tensor],
               sub_indptr: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start, deg, hit) per frontier slot, int64/int64/bool: the row of
    the cached sub-CSR where ``row_map`` holds the vertex (hit), else the
    row of the full CSR; deg 0 for invalid slots."""
    V = indptr.shape[0] - 1
    fvalid = frontier >= 0
    safe = frontier.clamp(0, V - 1).long()
    start, end = indptr[safe].long(), indptr[safe + 1].long()
    hit = torch.zeros_like(fvalid)
    if row_map is not None:
        hit = fvalid & (row_map[safe] >= 0)
        row = row_map[safe].clamp(min=0).long()
        start = torch.where(hit, sub_indptr[row], start)
        end = torch.where(hit, sub_indptr[row + 1], end)
    zero = torch.zeros((), dtype=torch.int64, device=frontier.device)
    return torch.where(fvalid, start, zero), \
        torch.where(fvalid, end - start, zero), hit


def _select(start, deg, hit, r, indices, sub_indices) -> torch.Tensor:
    pos = start[None, :] + r.long()
    ok = (deg > 0)[None, :].expand_as(pos)
    hit = hit[None, :].expand_as(pos)
    nbr = indices[torch.where(ok & ~hit, pos, 0)]
    if sub_indices is not None:
        nbr = torch.where(hit, sub_indices[torch.where(ok & hit, pos, 0)],
                          nbr)
    return torch.where(ok, nbr, torch.full_like(nbr, -1)).reshape(-1)


def csr_select(frontier: torch.Tensor, r: torch.Tensor,
               indptr: torch.Tensor, indices: torch.Tensor,
               row_map: Optional[torch.Tensor] = None,
               sub_indptr: Optional[torch.Tensor] = None,
               sub_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The deterministic half of a per-slot draw: given in-row offsets r
    [fanout, F] (in [0, max(deg, 1)) of each slot's row), return the
    fanout-major neighbour ids [fanout*F], -1 for an invalid slot or
    degree 0. A slot whose vertex ``row_map`` holds reads the cached
    sub-CSR (``CachedTopoAccess.lookup``'s gather at
    ``legion_tpu/sampling/access.py:285-296`` for the same r), any other
    slot the full CSR."""
    start, deg, hit = _draw_rows(frontier, indptr, row_map, sub_indptr)
    return _select(start, deg, hit, r, indices, sub_indices)


def csr_draw_plain(frontier: torch.Tensor, fanout: int, key,
                   indptr: torch.Tensor, indices: torch.Tensor,
                   row_map: Optional[torch.Tensor] = None,
                   sub_indptr: Optional[torch.Tensor] = None,
                   sub_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Plain PyTorch K5: r = bounded(word of lane f*F + i, deg) with the
    first two key words (stream 0 of an int ``key``), then ``csr_select``.
    Bit-identical to the kernel."""
    F = frontier.shape[0]
    start, deg, hit = _draw_rows(frontier, indptr, row_map, sub_indptr)
    lanes = torch.arange(fanout * F, dtype=torch.int64,
                         device=frontier.device).view(fanout, F)
    ka, kb = key_words(key)[:2]
    r = bounded(hash_words(ka, kb, lanes),
                deg.clamp(1, 2 ** 31 - 1)[None, :])
    return _select(start, deg, hit, r, indices, sub_indices)


def _table(t, device: torch.device) -> torch.Tensor:
    return t.on(device) if isinstance(t, HostTable) else t


def csr_draw(frontier: torch.Tensor, fanout: int, key,
             indptr, indices, row_map: Optional[torch.Tensor] = None,
             sub_indptr: Optional[torch.Tensor] = None,
             sub_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5. frontier [F] int32 -> [fanout*F] int32, fanout-major. The full
    CSR (``indptr`` [V+1] int32/int64, ``indices`` [E] int32) is a device
    tensor or a registered ``HostTable``; ``row_map`` [V] int32,
    ``sub_indptr`` [C+1] int64 and ``sub_indices`` int32 are the device
    topology cache, or None for none. ``key``: the hop's [4] int32 key
    words on the device (the kernel reads the first two), or an int key."""
    dev = frontier.device
    indptr, indices = _table(indptr, dev), _table(indices, dev)
    if dev.type == "cpu":
        return csr_draw_plain(frontier, fanout, key, indptr, indices,
                              row_map, sub_indptr, sub_indices)
    cached = (row_map, sub_indptr, sub_indices)
    if any(t is not None and t.device != dev
           for t in (indptr, indices) + cached):
        raise ValueError("csr_draw: tensors on different devices")
    if (row_map is None) != (sub_indptr is None) \
            or (row_map is None) != (sub_indices is None):
        raise ValueError("csr_draw: row_map, sub_indptr and sub_indices "
                         "come together")
    if frontier.dtype != torch.int32 or indices.dtype != torch.int32 \
            or indptr.dtype not in (torch.int32, torch.int64) \
            or frontier.dim() != 1 or indptr.dim() != 1 \
            or (row_map is not None and (
                row_map.dtype != torch.int32
                or sub_indptr.dtype != torch.int64
                or sub_indices.dtype != torch.int32
                or row_map.shape[0] != indptr.shape[0] - 1)):
        raise ValueError("csr_draw: dtypes/shapes " + ", ".join(
            f"{t.dtype}{tuple(t.shape)}" for t in
            (frontier, indptr, indices) + cached if t is not None))
    return _csr_launch("csr_draw", frontier, fanout, key, cached,
                       (indptr, indices), indptr.dtype, indptr.shape[0] - 1,
                       None)


def _csr_launch(name: str, frontier, fanout: int, key, cached, full,
                off_dtype, num_nodes: int, served: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """K5's launch: ``full`` = (indptr, indices), or (None, None) for the
    device-only form (which then fills ``served``)."""
    dev = frontier.device
    tabs = [None if t is None else t.contiguous()
            for t in (frontier,) + tuple(cached) + tuple(full)]
    ptrs = [0 if t is None else t.data_ptr() for t in tabs]
    F = frontier.shape[0]
    out = torch.empty((fanout * F,), dtype=torch.int32, device=dev)
    words = _key_arg(name, key, dev)
    lib = kernels.lib()
    fn = lib.lt_csr_draw_i32 if off_dtype == torch.int32 \
        else lib.lt_csr_draw_i64
    rc = fn(ptrs[0], F, fanout, *ptrs[1:], num_nodes, words.data_ptr(),
            out.data_ptr(), None if served is None else served.data_ptr(),
            int(served is not None), kernels.stream_handle())
    kernels.check(name, rc)
    return out


def csr_draw_cached_plain(frontier: torch.Tensor, fanout: int, key,
                          row_map: torch.Tensor, sub_indptr: torch.Tensor,
                          sub_indices: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K5 in its device-only form: ``csr_draw_plain``'s draws for
    the slots whose vertex ``row_map`` holds (served), -1 on every lane of
    the others, whose rows are not read."""
    V = row_map.shape[0]
    F = frontier.shape[0]
    dev = frontier.device
    row = row_map[frontier.clamp(0, V - 1).long()]
    served = (frontier >= 0) & (row >= 0)
    r = row.clamp(0, sub_indptr.shape[0] - 2).long()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    start = torch.where(served, sub_indptr[r], zero)
    deg = torch.where(served, sub_indptr[r + 1], zero) - start
    lanes = torch.arange(fanout * F, dtype=torch.int64,
                         device=dev).view(fanout, F)
    ka, kb = key_words(key)[:2]
    pos = start[None, :] + bounded(hash_words(ka, kb, lanes),
                                   deg.clamp(1, 2 ** 31 - 1)[None, :])
    ok = (deg > 0)[None, :].expand_as(pos)
    if sub_indices.numel() == 0:
        return torch.full((fanout * F,), -1, dtype=torch.int32,
                          device=dev), served
    nbr = sub_indices[torch.where(ok, pos, 0)]
    return torch.where(ok, nbr, torch.full_like(nbr, -1)).reshape(-1), served


def csr_draw_cached(frontier: torch.Tensor, fanout: int, key,
                    row_map: torch.Tensor, sub_indptr: torch.Tensor,
                    sub_indices: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's device-only form (``CachedTopoAccess.lookup``, ``legion_tpu/
    sampling/access.py:279-297``), as ``csr_draw_cached_plain``: frontier
    [F] int32 -> (lanes [fanout*F] int32 fanout-major, served [F] bool),
    the draws of the slots the cached sub-CSR holds and -1 elsewhere, no
    host memory read; one launch, which also writes ``served``."""
    dev = frontier.device
    if dev.type == "cpu":
        return csr_draw_cached_plain(frontier, fanout, key, row_map,
                                     sub_indptr, sub_indices)
    cached = (row_map, sub_indptr, sub_indices)
    if any(t.device != dev for t in cached):
        raise ValueError("csr_draw_cached: tensors on different devices")
    if frontier.dtype != torch.int32 or frontier.dim() != 1 \
            or row_map.dtype != torch.int32 \
            or sub_indptr.dtype != torch.int64 \
            or sub_indices.dtype != torch.int32:
        raise ValueError("csr_draw_cached: dtypes/shapes " + ", ".join(
            f"{t.dtype}{tuple(t.shape)}" for t in (frontier,) + cached))
    served = torch.empty((frontier.shape[0],), dtype=torch.bool, device=dev)
    out = _csr_launch("csr_draw_device", frontier, fanout, key, cached,
                      (None, None), torch.int64, row_map.shape[0], served)
    return out, served


# ---------------------------------------------------------------------------
# K21 merge_draws
# ---------------------------------------------------------------------------

def _merge_shapes(lanes, served, host_nbr, fanout: int):
    n = 1 if served.dim() == 1 else served.shape[0]
    F = served.shape[-1]
    if served.dtype != torch.bool or served.dim() not in (1, 2) \
            or lanes.dtype != torch.int32 or host_nbr.dtype != torch.int32 \
            or lanes.numel() != n * fanout * F \
            or tuple(host_nbr.shape[-2:]) != (F, fanout) \
            or host_nbr.numel() != n * F * fanout:
        raise ValueError(f"merge_draws: lanes {lanes.dtype} "
                         f"{tuple(lanes.shape)}, served {served.dtype} "
                         f"{tuple(served.shape)}, host {host_nbr.dtype} "
                         f"{tuple(host_nbr.shape)}, fanout {fanout}")
    return n, F


def merge_draws_plain(lanes: torch.Tensor, served: torch.Tensor,
                      host_nbr: torch.Tensor, fanout: int) -> torch.Tensor:
    """Plain K21: ``jnp.where(jnp.tile(served, fanout), lanes,
    host_nbr.T.reshape(-1))`` for each member row."""
    n, F = _merge_shapes(lanes, served, host_nbr, fanout)
    out = torch.where(served.reshape(n, 1, F), lanes.reshape(n, fanout, F),
                      host_nbr.reshape(n, F, fanout).transpose(1, 2))
    return out.reshape(lanes.shape)


def merge_draws(lanes: torch.Tensor, served: torch.Tensor,
                host_nbr: torch.Tensor, fanout: int) -> torch.Tensor:
    """K21, as ``merge_draws_plain``: lanes [fanout*F] (or [n, fanout*F])
    int32 fanout-major, served [F] ([n, F]) bool, the host's draws [F,
    fanout] ([n, F, fanout]) int32 -> the merged lanes in lanes' shape; the
    transpose of the host's draws is done in the kernel."""
    if lanes.device.type == "cpu":
        return merge_draws_plain(lanes, served, host_nbr, fanout)
    n, F = _merge_shapes(lanes, served, host_nbr, fanout)
    if served.device != lanes.device or host_nbr.device != lanes.device:
        raise ValueError("merge_draws: tensors on different devices")
    lanes, served = lanes.contiguous(), served.contiguous()
    host_nbr = host_nbr.contiguous()
    out = torch.empty_like(lanes)
    rc = kernels.lib().lt_merge_draws(
        lanes.data_ptr(), served.data_ptr(), host_nbr.data_ptr(), n, F,
        fanout, out.data_ptr(), kernels.stream_handle())
    kernels.check("merge_draws", rc)
    return out


class DeviceCSRAccess(GraphAccess):
    """Full CSR on the device, one independent draw per slot
    (``neighbor_window=0``), through K5."""

    def __init__(self, csr: DeviceCSR):
        self.csr = csr
        self.num_nodes = csr.num_nodes

    def sample_neighbors(self, frontier, fanout, key):
        return csr_draw(frontier, fanout, key, self.csr.indptr,
                        self.csr.indices)


class CachedTopoAccess(GraphAccess):
    """Hot sub-CSR on the device + the full CSR in host memory, through K5
    (port of ``legion_tpu/sampling/access.py::CachedTopoAccess``).

    Parity: topo_cache_hit + random_sample's cached branch
    (cache_impl.cuh:89-101, operator_impl.cu:224-243); a miss reads the
    pinned host CSR in the kernel, the reference's UVA branch. A cached
    row is a copy of its host row and both draw with the same words, so
    the draws equal ``DeviceCSRAccess``'s on the whole graph bit for bit,
    whatever the cache holds. (The JAX package draws its misses with
    ``native.sample_neighbors``'s own generator instead.) Like the JAX
    package, it ignores ``neighbor_window``.

    Split draws (the staged pipeline): ``lookup`` is K5's device-only form
    (``all_miss`` serves nothing, as JAX's ``CachedTopoAccess`` over a
    row_map of -1 and its ``HostFallbackAccess.lookup``), ``host_draw``
    the host's C++ draws from the host CSR with the same words
    (``ops/host_memory.py::host_draw``)."""

    needs_host_draws = True

    def __init__(self, row_map: torch.Tensor, sub_indptr: torch.Tensor,
                 sub_indices: torch.Tensor, host_indptr: HostTable,
                 host_indices: HostTable):
        self.row_map = row_map
        self.sub_indptr = sub_indptr
        self.sub_indices = sub_indices
        self.host_indptr = host_indptr
        self.host_indices = host_indices
        self.num_nodes = int(row_map.shape[0])

    @classmethod
    def all_miss(cls, host_indptr: HostTable, host_indices: HostTable,
                 device: torch.device) -> "CachedTopoAccess":
        """No row cached: every draw reads the host CSR (presampling)."""
        V = host_indptr.shape[0] - 1
        return cls(torch.full((V,), -1, dtype=torch.int32, device=device),
                   torch.zeros((2,), dtype=torch.int64, device=device),
                   torch.full((1,), -1, dtype=torch.int32, device=device),
                   host_indptr, host_indices)

    def sample_neighbors(self, frontier, fanout, key):
        return csr_draw(frontier, fanout, key, self.host_indptr,
                        self.host_indices, self.row_map, self.sub_indptr,
                        self.sub_indices)

    def lookup(self, frontier, fanout, key):
        return csr_draw_cached(frontier, fanout, key, self.row_map,
                               self.sub_indptr, self.sub_indices)

    def host_draw(self, frontier, fanout, key, out=None):
        """[F, fanout] (or [n, F, fanout] for [n, F] and keys [n, 4]) draws
        from the host CSR, for a frontier and key words on the host."""
        return host_draw(self.host_indptr.host, self.host_indices.host,
                         frontier, fanout, key, out)


# ---------------------------------------------------------------------------
# K3 windowed_draw
# ---------------------------------------------------------------------------

def windowed_select(row_pairs: torch.Tensor, indices2d: torch.Tensor,
                    frontier: torch.Tensor, r0: torch.Tensor,
                    off: torch.Tensor) -> torch.Tensor:
    """The deterministic half of the windowed draw: given r0 [F] (block
    choice, in [0, max(deg, 1))) and off [fanout, F] (in-block offsets,
    in [lo, hi) of the chosen block), return the fanout-major candidate
    ids, -1 for an invalid slot or degree 0. Equal to the gather at
    ``legion_tpu/sampling/access.py:219-233`` for the same r0 and off."""
    V = row_pairs.shape[0]
    W = indices2d.shape[1]
    start, deg = _frontier_rows(row_pairs, frontier, V)
    blk = (start + r0.long()) // W
    flat = blk[None, :] * W + off.long()
    ok = (deg > 0)[None, :].expand_as(flat)
    cand = indices2d.reshape(-1)[torch.where(ok, flat, 0)]
    return torch.where(ok, cand, torch.full_like(cand, -1)).reshape(-1)


def windowed_draw_plain(row_pairs: torch.Tensor, indices2d: torch.Tensor,
                        frontier: torch.Tensor, fanout: int, key
                        ) -> torch.Tensor:
    """Plain PyTorch K3: the kernel's random words, then
    ``windowed_select``. Bit-identical to the kernel."""
    V = row_pairs.shape[0]
    W = indices2d.shape[1]
    F = frontier.shape[0]
    dev = frontier.device
    start, deg = _frontier_rows(row_pairs, frontier, V)
    ka0, kb0, ka1, kb1 = key_words(key)
    r0 = bounded(hash_words(ka0, kb0, torch.arange(F, device=dev)),
                 deg.clamp(1, 2 ** 31 - 1))
    base = (start + r0) // W * W
    lo = torch.maximum(base, start) - base
    hi = torch.minimum(base + W, start + deg) - base
    lanes = torch.arange(fanout * F, device=dev).view(fanout, F)
    off = lo[None, :] + bounded(hash_words(ka1, kb1, lanes),
                                (hi - lo).clamp(min=1)[None, :])
    return windowed_select(row_pairs, indices2d, frontier, r0, off)


def windowed_draw(row_pairs: torch.Tensor, indices2d: torch.Tensor,
                  frontier: torch.Tensor, fanout: int, key
                  ) -> torch.Tensor:
    """K3. row_pairs [V, 2] int32/int64 (start, degree), indices2d
    [ceil(E/W), W] int32, both contiguous as ``WindowedCSRAccess.from_csr``
    builds them, frontier [F] int32 -> [fanout*F] int32. ``key``: the
    hop's [4] int32 key words on the device, or an int key."""
    dev = frontier.device
    if dev.type == "cpu":
        return windowed_draw_plain(row_pairs, indices2d, frontier, fanout,
                                   key)
    if dev.type != "cuda" or row_pairs.device != dev \
            or indices2d.device != dev:
        raise ValueError("windowed_draw: tensors on different devices")
    if row_pairs.dim() != 2 or row_pairs.shape[1] != 2 \
            or indices2d.dim() != 2 or frontier.dim() != 1:
        raise ValueError("windowed_draw: shapes "
                         f"{tuple(row_pairs.shape)}/{tuple(indices2d.shape)}/"
                         f"{tuple(frontier.shape)}")
    if frontier.dtype != torch.int32 or indices2d.dtype != torch.int32 \
            or row_pairs.dtype not in (torch.int32, torch.int64):
        raise ValueError("windowed_draw: dtypes "
                         f"{row_pairs.dtype}/{indices2d.dtype}/"
                         f"{frontier.dtype}")
    # the kernel reads a (start, degree) pair as one load
    if not (row_pairs.is_contiguous() and indices2d.is_contiguous()) \
            or row_pairs.data_ptr() % (2 * row_pairs.element_size()):
        raise ValueError("windowed_draw: row_pairs and indices2d must be "
                         "contiguous, row_pairs aligned to a pair")
    frontier = frontier.contiguous()
    F = frontier.shape[0]
    out = torch.empty((fanout * F,), dtype=torch.int32, device=dev)
    words = _key_arg("windowed_draw", key, dev)
    lib = kernels.lib()
    fn = lib.lt_windowed_draw_i32 if row_pairs.dtype == torch.int32 \
        else lib.lt_windowed_draw_i64
    rc = fn(row_pairs.data_ptr(), indices2d.data_ptr(), frontier.data_ptr(),
            out.data_ptr(), F, fanout, indices2d.shape[1],
            row_pairs.shape[0], words.data_ptr(), kernels.stream_handle())
    kernels.check("windowed_draw", rc)
    return out


class WindowedCSRAccess(GraphAccess):
    """CSR with block-windowed draws: one aligned W-wide block of the edge
    array per frontier vertex, ``fanout`` uniform draws inside it (proof
    of the exact 1/deg marginal: ``legion_tpu/sampling/access.py:133-157``).

    Layout: ``row_pairs`` [V, 2] = (row_start, degree) in the CSR's offset
    dtype (int64 for graphs of 2**31 edges and more); ``indices2d``
    [ceil(E/W), W] is the edge array padded with -1 to a block multiple.
    """

    def __init__(self, row_pairs: torch.Tensor, indices2d: torch.Tensor,
                 num_nodes: int, num_edges: int):
        self.row_pairs = row_pairs
        self.indices2d = indices2d
        self.num_nodes = num_nodes
        self.num_edges = num_edges

    @property
    def window(self) -> int:
        return int(self.indices2d.shape[1])

    @classmethod
    def from_csr(cls, csr: DeviceCSR, window: int = 64
                 ) -> "WindowedCSRAccess":
        if window <= 0 or window & (window - 1):
            raise ValueError(f"window must be a power of two, not {window}")
        odt = torch.int64 if csr.num_edges >= 2 ** 31 else torch.int32
        starts = csr.indptr[:-1].to(odt)
        deg = (csr.indptr[1:] - csr.indptr[:-1]).to(odt)
        row_pairs = torch.stack([starts, deg], dim=1).contiguous()
        E = csr.num_edges
        pE = -(-E // window) * window
        flat = torch.full((pE,), -1, dtype=torch.int32,
                          device=csr.indices.device)
        flat[:E] = csr.indices
        return cls(row_pairs, flat.view(-1, window), csr.num_nodes, E)

    def sample_neighbors(self, frontier, fanout, key):
        return windowed_draw(self.row_pairs, self.indices2d, frontier,
                             fanout, key)
