"""Bucketed open-addressing hash map for billion-vertex id -> slot lookups
(port of ``legion_tpu/cache/hashmap.py``).

The reference vendors BGHT bucketed-cuckoo tables (src/include/hashmap,
bcht.hpp) because device memory cannot afford a direct [V] table a map at
billion-vertex scale (cache.cu:71-88). The direct int32 table stays the
default (one gather); this map is the billion-scale form:

  memory:  about 32 bytes a cached vertex (load factor 0.5, buckets of 8)
           against 4 bytes x |V| for a direct table;
  lookup:  ``probes`` rounds of one 32-byte bucket row each.

``HashMap32.build`` is the JAX package's numpy build, byte for byte, into
one [B, 16] int32 table: row b holds bucket b's 8 keys, then their 8
values, so that a hit's value lies in the 64-byte row of its keys. JAX's
[B, 8] ``keys`` and ``vals`` are the table's two halves (``HashMap32.keys``
and ``.vals``, views). The table goes to the given device. ``lookup`` is
K11 ``hash_lookup`` (``csrc/hash_lookup.cu``) on a card and
``hash_lookup_plain`` on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from legion_tpu_torch.ops import kernels

BUCKET = 8
ROW = 2 * BUCKET                        # a table row: keys, then values
_MULT = np.uint32(0x9E3779B1)          # Fibonacci hashing multiplier


def _hash(ids: np.ndarray, n_buckets: int) -> np.ndarray:
    h = (ids.astype(np.uint32) * _MULT)
    return (h % np.uint32(n_buckets)).astype(np.int64)


def hash_lookup_plain(keys: torch.Tensor, vals: torch.Tensor, probes: int,
                      ids: torch.Tensor) -> torch.Tensor:
    """Plain K11 (``legion_tpu/cache/hashmap.py:96-115``): the bucket of id
    is (id * 0x9E3779B1 mod 2^32) mod B, then + p for probe round p; the
    first round whose bucket row holds id gives its value. -1 when absent
    and for ids < 0."""
    B = keys.shape[0]
    safe = ids.clamp(min=0).long()
    b0 = ((safe * 0x9E3779B1) & 0xFFFFFFFF) % B
    out = torch.full(ids.shape, -1, dtype=torch.int32, device=ids.device)
    for p in range(probes):
        b = (b0 + p) % B
        m = keys[b] == ids.unsqueeze(-1)
        hit = m.any(dim=-1)
        val = torch.where(m, vals[b], 0).sum(dim=-1, dtype=torch.int32)
        out = torch.where((out < 0) & hit, val, out)
    return torch.where(ids >= 0, out, -1)


def _table_of(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The [B, 16] table whose halves keys and vals are, read in place;
    separate arrays are packed into one first (a copy)."""
    B = keys.shape[0]
    if keys.stride() == (ROW, 1) and vals.stride() == (ROW, 1) \
            and vals.data_ptr() == keys.data_ptr() + 4 * BUCKET \
            and keys.untyped_storage().data_ptr() \
            == vals.untyped_storage().data_ptr():
        return keys.as_strided((B, ROW), (ROW, 1))
    return torch.cat([keys, vals], dim=1)


def _lookup_in(table: torch.Tensor, probes: int,
               ids: torch.Tensor) -> torch.Tensor:
    """K11 over a [B, 16] table on a card."""
    if ids.dtype != torch.int32 or ids.device != table.device:
        raise ValueError(f"hash_lookup: ids {ids.dtype} on {ids.device}, "
                         f"table on {table.device}")
    ids = ids.contiguous()
    out = torch.empty_like(ids)
    rc = kernels.lib().lt_hash_lookup(
        table.data_ptr(), table.shape[0], probes, ids.data_ptr(),
        ids.numel(), out.data_ptr(), kernels.stream_handle())
    kernels.check("hash_lookup", rc)
    return out


def hash_lookup(keys: torch.Tensor, vals: torch.Tensor, probes: int,
                ids: torch.Tensor) -> torch.Tensor:
    """K11. keys/vals [B, 8] int32 (B a power of two), ids int32 of any
    shape -> int32 values of the same shape, -1 when absent. On a card
    the kernel reads the [B, 16] table of a ``HashMap32`` in place when
    keys and vals are its two halves. Other keys and vals are packed into
    a new table on every call: a copy of 64 bytes a bucket (537 MB at
    2^23 buckets) before the lookup. ``HashMap32.lookup`` never copies."""
    if keys.dtype != torch.int32 or vals.dtype != torch.int32 \
            or ids.dtype != torch.int32 or keys.dim() != 2 \
            or keys.shape[1] != BUCKET or vals.shape != keys.shape \
            or keys.shape[0] & (keys.shape[0] - 1) or probes < 1:
        raise ValueError(f"hash_lookup: keys {keys.dtype} "
                         f"{tuple(keys.shape)}, vals {vals.dtype}, ids "
                         f"{ids.dtype}, probes {probes}")
    if ids.device.type == "cpu":
        return hash_lookup_plain(keys, vals, probes, ids)
    if not (keys.device == vals.device == ids.device):
        raise ValueError("hash_lookup: tensors on different devices")
    return _lookup_in(_table_of(keys, vals), probes, ids)


@dataclass
class HashMap32:
    """Static int32 -> int32 map; -1 = absent. Query with ``lookup``."""

    table: torch.Tensor  # [B, 2 * BUCKET] int32: keys (-1 = empty), values
    probes: int          # max probe rounds needed at build time

    @property
    def keys(self) -> torch.Tensor:
        """[B, BUCKET] int32, -1 = empty slot: JAX's ``keys`` (a view)."""
        return self.table[:, :BUCKET]

    @property
    def vals(self) -> torch.Tensor:
        """[B, BUCKET] int32: JAX's ``vals`` (a view)."""
        return self.table[:, BUCKET:]

    @property
    def n_buckets(self) -> int:
        return int(self.table.shape[0])

    @property
    def hbm_bytes(self) -> int:
        return 2 * self.n_buckets * BUCKET * 4

    @classmethod
    def build(cls, ids: np.ndarray, vals: np.ndarray, load: float = 0.5,
              device="cpu") -> "HashMap32":
        """ids: unique non-negative int32 keys; vals: int32 payloads."""
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.int32)
        n = len(ids)
        B = 1 << max(int(np.ceil(np.log2(max(n, 1) / (load * BUCKET)))), 1)
        table = np.zeros((B, ROW), np.int32)
        keys_t, vals_t = table[:, :BUCKET], table[:, BUCKET:]
        keys_t[:] = -1
        fill = np.zeros(B, np.int32)
        h0 = _hash(ids, B)
        pending = np.arange(n)
        rounds = 0
        while len(pending):
            if rounds >= 64:
                raise RuntimeError("hash table build degenerated; lower "
                                   "the load")
            b = (h0[pending] + rounds) % B
            order = np.argsort(b, kind="stable")
            bs = b[order]
            ps = pending[order]
            # rank within each equal-bucket run
            first = np.searchsorted(bs, bs, side="left")
            rank = np.arange(len(bs)) - first
            free = BUCKET - fill[bs]
            place = rank < free
            slot = fill[bs] + rank
            keys_t[bs[place], slot[place]] = ids[ps[place]].astype(np.int32)
            vals_t[bs[place], slot[place]] = vals[ps[place]]
            placed_b, counts = np.unique(bs[place], return_counts=True)
            fill[placed_b] += counts.astype(np.int32)
            pending = ps[~place]
            rounds += 1
        return cls(torch.from_numpy(table).to(device), max(rounds, 1))

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """ids int32 (-1 pad) -> vals int32, -1 when absent (K11)."""
        if ids.device.type == "cpu":
            return hash_lookup(self.keys, self.vals, self.probes, ids)
        return _lookup_in(self.table, self.probes, ids)


def map_lookup(m, ids: torch.Tensor) -> torch.Tensor:
    """id -> value through either map form: a direct [V] int32 table (a
    masked gather, -1 for pads) or a ``HashMap32`` (K11)
    (``legion_tpu/cache/hashmap.py:128-136``)."""
    if isinstance(m, HashMap32):
        return m.lookup(ids)
    return torch.where(ids >= 0, m[ids.clamp(0, m.shape[0] - 1).long()], -1)
