"""Graph access strategies for the sampler (port of
``legion_tpu/sampling/access.py``: ``DeviceCSRAccess`` and
``WindowedCSRAccess``), plus the port's counter-based random words.

Randomness: a draw is a pure function of an integer key and a lane,
``hash_words(ka, kb, lane)``, so the CUDA kernel and its plain version
give the same bits. Keys are Python ints derived with ``fold_in`` from
one int64 seed per step (the trainer takes it from its
``torch.Generator``), the analog of the JAX package's key folding. The
bits differ from JAX's threefry stream; parity tests inject JAX's draws
into ``windowed_select``.

``hash32`` and friends work on Python ints and on int64 tensors holding
values in [0, 2**32): every product is split so it stays below 2**63.
"""

from __future__ import annotations

from typing import Tuple

import torch

from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import kernels

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


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


def fold_in(key: int, data: int) -> int:
    """New 64-bit key from (key, data); host-side, no device work."""
    lo, hi = key & M32, (key >> 32) & M32
    lo2 = hash32(lo ^ hash32((data & M32) ^ _GOLDEN))
    hi2 = hash32(hi ^ hash32(lo2 ^ ((data >> 32) & M32)))
    return (hi2 << 32) | lo2


def stream_keys(key: int, stream: int) -> Tuple[int, int]:
    """The two 32-bit keys (ka, kb) of one random stream of ``key``."""
    k = fold_in(key, stream)
    return k & M32, k >> 32


def hash_words(ka: int, kb: int, lanes: torch.Tensor) -> torch.Tensor:
    """Random 32-bit words (as int64) for int64 ``lanes``
    (csrc/common.cuh::lt_word)."""
    return hash32(hash32(lanes ^ ka) ^ kb)


def bounded(words: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Uniform ints in [0, m) from 32-bit words: (w * m) >> 32, m < 2**31."""
    return (words * m) >> 32


class GraphAccess:
    """Interface: draw ``fanout`` neighbours per frontier vertex."""

    num_nodes: int

    def sample_neighbors(self, frontier: torch.Tensor, fanout: int,
                         key: int) -> torch.Tensor:
        """frontier [F] int32 (-1 pad) -> neighbours [fanout*F] int32 in
        FANOUT-MAJOR lane order (draw f of slot i at lane f*F + i), -1
        where the slot is invalid or the vertex has no edges."""
        raise NotImplementedError


def _frontier_rows(row_pairs: torch.Tensor, frontier: torch.Tensor,
                   num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, deg) as int64 per frontier slot; 0 for invalid slots."""
    fvalid = frontier >= 0
    pd = row_pairs[frontier.clamp(0, num_nodes - 1).long()].long()
    zero = torch.zeros((), dtype=torch.int64, device=frontier.device)
    return torch.where(fvalid, pd[:, 0], zero), \
        torch.where(fvalid, pd[:, 1], zero)


class DeviceCSRAccess(GraphAccess):
    """Full CSR on the device, one independent draw per slot
    (``neighbor_window=0``). Plain PyTorch: its kernel is still to port."""

    def __init__(self, csr: DeviceCSR):
        self.csr = csr
        self.num_nodes = csr.num_nodes

    def sample_neighbors(self, frontier, fanout, key):
        csr = self.csr
        F = frontier.shape[0]
        fvalid = frontier >= 0
        safe = frontier.clamp(0, self.num_nodes - 1).long()
        zero = torch.zeros((), dtype=torch.int64, device=frontier.device)
        start = torch.where(fvalid, csr.indptr[safe].long(), zero)
        deg = torch.where(fvalid, csr.indptr[safe + 1].long() - start, zero)
        lanes = torch.arange(fanout * F, dtype=torch.int64,
                             device=frontier.device).view(fanout, F)
        ka, kb = stream_keys(key, 0)
        r = bounded(hash_words(ka, kb, lanes),
                    deg.clamp(1, 2 ** 31 - 1)[None, :])
        pos = (start[None, :] + r).clamp(0, max(csr.num_edges - 1, 0))
        nbr = csr.indices[pos.reshape(-1)]
        return torch.where((deg > 0).repeat(fanout), nbr,
                           torch.full_like(nbr, -1))


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
                        frontier: torch.Tensor, fanout: int, key: int
                        ) -> torch.Tensor:
    """Plain PyTorch K3: the kernel's random words, then
    ``windowed_select``. Bit-identical to the kernel."""
    V = row_pairs.shape[0]
    W = indices2d.shape[1]
    F = frontier.shape[0]
    dev = frontier.device
    start, deg = _frontier_rows(row_pairs, frontier, V)
    ka0, kb0 = stream_keys(key, 0)
    ka1, kb1 = stream_keys(key, 1)
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
                  frontier: torch.Tensor, fanout: int, key: int
                  ) -> torch.Tensor:
    """K3. row_pairs [V, 2] int32/int64 (start, degree), indices2d
    [ceil(E/W), W] int32, frontier [F] int32 -> [fanout*F] int32."""
    if frontier.device.type == "cpu":
        return windowed_draw_plain(row_pairs, indices2d, frontier, fanout,
                                   key)
    if not (frontier.is_cuda and row_pairs.device == frontier.device
            and indices2d.device == frontier.device):
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
    row_pairs, indices2d = row_pairs.contiguous(), indices2d.contiguous()
    frontier = frontier.contiguous()
    F = frontier.shape[0]
    out = torch.empty((fanout * F,), dtype=torch.int32,
                      device=frontier.device)
    ka0, kb0 = stream_keys(key, 0)
    ka1, kb1 = stream_keys(key, 1)
    lib = kernels.lib()
    fn = lib.lt_windowed_draw_i32 if row_pairs.dtype == torch.int32 \
        else lib.lt_windowed_draw_i64
    rc = fn(row_pairs.data_ptr(), indices2d.data_ptr(), frontier.data_ptr(),
            out.data_ptr(), F, fanout, indices2d.shape[1],
            row_pairs.shape[0], ka0, kb0, ka1, kb1, kernels.stream_handle())
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
