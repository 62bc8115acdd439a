"""Host tables read in place by the kernels (zero-copy, Legion's UVA path).

The reference keeps its full CSR and feature table in pinned host memory
and reads a cache miss over PCIe from inside the kernel
(``cache_impl.cuh:239-272``). The JAX package could not: a TPU kernel does
not read host memory, so it went through ``pure_callback``. Here a host
table is an existing numpy buffer in RAM, pinned where it lies with
``cudaHostRegister`` (``csrc/host_memory.cu``) and mapped into the card's
address space. It is not copied again: ``tensor.pin_memory()`` would copy,
which doubles host RAM at billion scale, and a failed registration
raises rather than falls back to a copy on the device. A table to be
registered must be writable: the trainer copies a read-only array (the
memmaps of a dataset on disk) into RAM once before it registers it
(``train.py::in_ram``).

A registration covers exactly the array's bytes: rounding it out to whole
pages would also register the neighbouring heap bytes, and the driver
then refuses a pageable copy that straddles the edge. Two trainers may
register the same array, which the driver refuses to register twice, so
``_PINNED`` keeps the registered byte ranges with reference counts (one
registry per process, as the driver's registrations are per process): a
table registers only the bytes not registered yet and holds a reference
on every range it covers. The device address of registered memory is its
host address (unified addressing, as on every 64-bit Linux system with a
Hopper card); registration checks it.

The staged pipeline's host half lives here too (``pipeline/staged.py``):
``gather_host_rows`` fills the pinned staging buffer with a batch's
missed rows for one bulk copy, and ``host_draw`` draws the neighbours of
the frontier slots the card did not serve. They are host work by design,
as the JAX package's ``native.gather_rows`` and ``native.sample_neighbors``
are: multi-threaded C++ (``csrc/host_half.cu``) into pinned memory (a
trainer on a card), or their plain PyTorch versions into pageable memory
(a trainer on the CPU, and the comparisons).
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from legion_tpu_torch.ops import kernels

# registered range start -> [end, references]
_PINNED: Dict[int, List[int]] = {}

# a table's dtype -> the CUDA array interface's typestr of its device view.
# A uint16 table holds bf16 bits (numpy has no bf16, and the interface no
# bf16 typestr): it is shared as int16 and both views are torch.bfloat16.
BF16_BITS = np.dtype(np.uint16)
_TYPESTR = {np.dtype(np.float32): "<f4", np.dtype(np.int64): "<i8",
            np.dtype(np.int32): "<i4", BF16_BITS: "<i2"}


def bf16_pitch(F: int) -> int:
    """The pitch, in values, of a bf16 host feature table of width F: the
    row padded to whole 128-byte lines (a multiple of 64 values), unless
    that makes it longer than the f32 row it replaces; else F. A warp's
    load from mapped host memory costs one link request for each 128-byte
    line it touches, so a row of 100 bf16 values reads 2 lines at pitch 128
    where it reads 2.5 on average at pitch 100 (offsets of 200 B a row),
    and 4 as f32 (``chip_smoke.py::pitch_probe``)."""
    P = -(-F // 64) * 64
    return P if P <= 2 * F else F


def bf16_rows(features: np.ndarray, pitch: int,
              chunk: int = 1 << 10) -> np.ndarray:
    """[V, pitch] bf16 bits (uint16) of ``features`` [V, F] f32, columns F
    .. pitch-1 zero: each value rounded to nearest even by the JAX
    package's host gather (``lg_gather_rows_bf16``), (bits + 0x7fff +
    ((bits >> 16) & 1)) >> 16 in uint32 arithmetic. That is the cast to
    bf16 on every value but some NaNs, which a cast keeps NaN: one whose
    payload lies in the low 16 bits and rounds down is carried to inf, one
    of 0xFFFF8000 or more wraps to zero. Built ``chunk`` rows at a time, so
    a memmap is never read into RAM whole as f32."""
    V, F = features.shape
    if pitch < F:
        raise ValueError(f"bf16_rows: pitch {pitch} under the width {F}")
    out = np.zeros((V, pitch), BF16_BITS)
    for lo in range(0, V, chunk):
        b = np.ascontiguousarray(features[lo:lo + chunk],
                                 np.float32).view(np.uint32)
        out[lo:lo + chunk, :F] = (b + np.uint32(0x7FFF)
                                  + ((b >> 16) & np.uint32(1))) >> 16
    return out


def _register(lo: int, hi: int) -> None:
    dev = ctypes.c_void_p()
    rc = kernels.lib().lt_host_register(lo, hi - lo, ctypes.byref(dev))
    if rc != 0:
        msg = kernels.lib().lt_error_string(rc).decode()
        raise RuntimeError(f"cudaHostRegister of {hi - lo} bytes at "
                           f"{lo:#x} failed: {msg} ({rc})")
    if dev.value != lo:
        _unregister(lo)
        raise RuntimeError("registered host memory has a device address "
                           "other than its host address (no unified "
                           "addressing); host tables need it")


def _unregister(lo: int) -> None:
    rc = kernels.lib().lt_host_unregister(lo)
    if rc != 0:
        msg = kernels.lib().lt_error_string(rc).decode()
        raise RuntimeError(f"cudaHostUnregister at {lo:#x} failed: {msg}")


def pin_range(lo: int, nbytes: int) -> List[int]:
    """Register the bytes of [lo, lo + nbytes) that are not registered
    yet, add a reference to every registered range that covers them, and
    return the starts of those ranges (for ``unpin_ranges``)."""
    hi = lo + nbytes
    gaps, held, cur = [], [], lo
    for start in sorted(_PINNED):
        end = _PINNED[start][0]
        if end <= cur or start >= hi:
            continue
        if start > cur:
            gaps.append((cur, start))
        held.append(start)
        cur = end
    if cur < hi:
        gaps.append((cur, hi))
    done = []
    try:
        for a, b in gaps:
            _register(a, b)
            done.append(a)
            _PINNED[a] = [b, 0]
    except Exception:
        for a in done:
            del _PINNED[a]
            _unregister(a)
        raise
    held += done
    for start in held:
        _PINNED[start][1] += 1
    return held


def unpin_ranges(starts: List[int]) -> None:
    """Drop one reference on each range; unregister the unreferenced."""
    for start in starts:
        _PINNED[start][1] -= 1
        if _PINNED[start][1] == 0:
            del _PINNED[start]
            _unregister(start)


class _DeviceArray:
    """A device address as ``__cuda_array_interface__``, for a zero-copy
    torch view of registered host memory."""

    def __init__(self, ptr: int, array: np.ndarray):
        self.__cuda_array_interface__ = {
            "shape": tuple(array.shape), "typestr": _TYPESTR[array.dtype],
            "data": (ptr, False), "version": 3, "strides": None}


class HostTable:
    """A C-contiguous numpy array in host RAM that kernels read in place.

    ``host`` is a CPU tensor over the same memory (no copy), bf16 for a
    uint16 array (``BF16_BITS``). With
    ``pin=True`` the array, which must be writable, is registered with the
    card, and ``device`` is a CUDA tensor over the same memory: reading it
    crosses PCIe. The array stays referenced for as long as it is
    registered. ``close()`` (or the trainer's ``close()``) unregisters
    it."""

    def __init__(self, array: np.ndarray, pin: bool):
        if not array.flags.c_contiguous:
            raise ValueError("a host table must be C-contiguous: make it so "
                             "(np.ascontiguousarray) before registering")
        if array.dtype not in _TYPESTR:
            raise ValueError(f"host table dtype {array.dtype}")
        if pin and not array.flags.writeable:
            raise ValueError("a registered host table must be writable RAM: "
                             "copy a read-only array (a memmap) into RAM "
                             "first")
        self.array = array
        bf16 = array.dtype == BF16_BITS
        with warnings.catch_warnings():
            # a read-only memmap: torch warns that it may not write to it
            warnings.simplefilter("ignore", UserWarning)
            self.host = torch.from_numpy(array.view(np.int16) if bf16
                                         else array)
        self.device: Optional[torch.Tensor] = None
        self._ranges: List[int] = []
        if pin and array.nbytes:
            ptr = array.ctypes.data
            self._ranges = pin_range(ptr, array.nbytes)
            self.device = torch.as_tensor(_DeviceArray(ptr, array),
                                          device="cuda")
        if bf16:
            self.host = self.host.view(torch.bfloat16)
            if self.device is not None:
                self.device = self.device.view(torch.bfloat16)

    @property
    def shape(self):
        return self.host.shape

    def on(self, device: torch.device) -> torch.Tensor:
        """The table as a tensor that ``device`` reads in place."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.host
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.device is None or self.device.device != device:
            raise ValueError(
                f"host table not registered for {device}: kernels read "
                "host tables in place (HostTable(..., pin=True)); it is "
                "never copied to the device")
        return self.device

    def close(self) -> None:
        self.device = None
        if self._ranges:
            unpin_ranges(self._ranges)
            self._ranges = []


def read_probe(host: HostTable, ids: torch.Tensor, align: int) -> None:
    """Read rows ``ids`` (int32, on the card, all inside the table) of a
    registered 2-D host table as K4's miss path does, a warp a row, each
    row asked for as its ``align``-aligned span (16 = the row's own bytes),
    and drop them: a measurement of the link's rate for scattered rows, not
    a step of any path. Time it with CUDA events around the call."""
    t = host.on(ids.device)
    if not t.is_cuda or t.dim() != 2 or ids.dtype != torch.int32 \
            or ids.dim() != 1:
        raise ValueError(f"read_probe: table {tuple(t.shape)} on {t.device}, "
                         f"ids {ids.dtype} {tuple(ids.shape)}")
    ids = ids.contiguous()
    sink = torch.zeros((), dtype=torch.int32, device=ids.device)
    rc = kernels.lib().lt_host_read_probe(
        t.data_ptr(), t.shape[0], t.shape[1] * t.element_size(),
        ids.data_ptr(), ids.shape[0], align, sink.data_ptr(),
        kernels.stream_handle())
    if rc != 0:
        msg = kernels.lib().lt_error_string(rc).decode()
        raise RuntimeError(f"read_probe launch failed: {msg} ({rc})")


def word_probe(host: HostTable, at: torch.Tensor) -> None:
    """Read the 4-byte words ``at`` (int64 word offsets from the table's
    first byte, on the card, all inside the table; negative: no load) of a
    registered host table, a thread a word in the order given, as K5's miss
    path asks for offsets and neighbour ids, and drop them: a measurement
    of the link's rate for scattered words, not a step of any path. Time
    it with CUDA events around the call."""
    t = host.on(at.device)
    if not t.is_cuda or at.dtype != torch.int64 or at.dim() != 1:
        raise ValueError(f"word_probe: table on {t.device}, offsets "
                         f"{at.dtype} {tuple(at.shape)}")
    at = at.contiguous()
    sink = torch.zeros((), dtype=torch.int32, device=at.device)
    rc = kernels.lib().lt_host_word_probe(
        t.data_ptr(), at.data_ptr(), at.shape[0], sink.data_ptr(),
        kernels.stream_handle())
    if rc != 0:
        msg = kernels.lib().lt_error_string(rc).decode()
        raise RuntimeError(f"word_probe launch failed: {msg} ({rc})")


# ---------------------------------------------------------------------------
# The staged pipeline's host half (csrc/host_half.cu)
# ---------------------------------------------------------------------------

def host_threads() -> int:
    """The host threads of a gather or a draw: the process's CPUs (the JAX
    package's ``native._nthreads``)."""
    return max(1, len(os.sched_getaffinity(0)))


def _host_args(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError(f"{name}: host tensors, contiguous; got "
                             f"{tuple(t.shape)} on {t.device}")


def gather_host_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """Plain ``gather_host_rows``: out[j] = the first F values of
    table[ids[j]], a zero row for ids[j] < 0 or past the table."""
    F = out.shape[1]
    ok = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(ok, ids, 0).long(), :F]
    return out.copy_(torch.where(ok[:, None], rows, torch.zeros_like(rows)))


def gather_host_rows(table: torch.Tensor, ids: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Host work, not a fallback: rows ``ids`` [n] int32 of a host table
    [V, P] (f32, or the bf16 rows of ``bf16_rows``: ``HostTable.host``)
    into ``out`` [n, F] of the table's dtype, F <= P, as
    ``gather_host_rows_plain``. Into a pinned ``out`` (the staging buffer
    of a trainer on a card) by the C++ of ``csrc/host_half.cu`` over
    ``host_threads()`` threads; into pageable memory by the plain
    version."""
    _host_args("gather_host_rows", ids, out)
    if table.dim() != 2 or table.stride(1) != 1 or table.device.type != "cpu" \
            or out.dim() != 2 or out.dtype != table.dtype \
            or out.shape[1] > table.shape[1] or ids.dtype != torch.int32 \
            or ids.dim() != 1 or out.shape[0] != ids.shape[0]:
        raise ValueError(f"gather_host_rows: table {table.dtype} "
                         f"{tuple(table.shape)}, ids {ids.dtype} "
                         f"{tuple(ids.shape)}, out {out.dtype} "
                         f"{tuple(out.shape)}")
    if not out.is_pinned():
        return gather_host_rows_plain(table, ids, out)
    es = table.element_size()
    rc = kernels.lib().lt_host_gather_rows(
        table.data_ptr(), table.shape[0], table.stride(0) * es,
        ids.data_ptr(), ids.shape[0], out.shape[1] * es, out.data_ptr(),
        host_threads())
    if rc != 0:
        raise RuntimeError(f"gather_host_rows failed ({rc})")
    return out


def _draw_shapes(frontier: torch.Tensor, fanout: int, keys):
    """(n, F, keys [n, 4] int32 words) of a host draw: frontier [F] with
    keys [4] (or an int key), or [n, F] with [n, 4]."""
    from legion_tpu_torch.sampling.access import _as_i32, draw_keys
    n = 1 if frontier.dim() == 1 else frontier.shape[0]
    if not isinstance(keys, torch.Tensor):
        keys = torch.tensor([_as_i32(draw_keys(keys))], dtype=torch.int32)
    if frontier.dtype != torch.int32 or frontier.dim() not in (1, 2) \
            or keys.dtype != torch.int32 or keys.numel() != 4 * n \
            or fanout < 0:
        raise ValueError(f"host_draw: frontier {frontier.dtype} "
                         f"{tuple(frontier.shape)}, keys {keys.dtype} "
                         f"{tuple(keys.shape)}, fanout {fanout}")
    return n, frontier.shape[-1], keys.reshape(n, 4).contiguous()


def host_draw_plain(indptr: torch.Tensor, indices: torch.Tensor,
                    frontier: torch.Tensor, fanout: int, keys,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ``host_draw``: slot i of member m draws f at lane f*F + i
    with member m's first two key words, from its vertex's row of the
    host CSR (the vertex clamped to V - 1), -1 for a pad or degree 0:
    K5's draws of a miss (``sampling/access.py::csr_draw_plain``)."""
    from legion_tpu_torch.sampling.access import M32, bounded, hash_words
    n, F, keys = _draw_shapes(frontier, fanout, keys)
    V = indptr.shape[0] - 1
    f2 = frontier.reshape(n, F)
    valid = (f2 >= 0) & (V > 0)
    vc = f2.clamp(0, max(V - 1, 0)).long()
    zero = torch.zeros((), dtype=torch.int64)
    start = torch.where(valid, indptr[vc].long(), zero)
    deg = torch.where(valid, indptr[vc + 1].long(), zero) - start
    k = keys.long() & M32
    lane = (torch.arange(fanout, dtype=torch.int64)[None, None, :] * F
            + torch.arange(F, dtype=torch.int64)[None, :, None]) & M32
    r = bounded(hash_words(k[:, 0, None, None], k[:, 1, None, None], lane),
                deg.clamp(1, 2 ** 31 - 1)[..., None])
    ok = (deg > 0)[..., None].expand_as(r)
    pos = torch.where(ok, start[..., None] + r, zero)
    nbr = indices[pos] if indices.numel() else torch.zeros_like(
        pos, dtype=torch.int32)
    res = torch.where(ok, nbr, torch.full_like(nbr, -1)).to(torch.int32)
    res = res.reshape(frontier.shape + (fanout,))
    return res if out is None else out.copy_(res)


def host_draw(indptr: torch.Tensor, indices: torch.Tensor,
              frontier: torch.Tensor, fanout: int, keys,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Host work, not a fallback: the host CSR's draws (indptr [V+1]
    int64, indices [E] int32, both host tensors) for a frontier [F] (or
    [n, F]) int32 on the host (-1 for a slot that needs none) with the
    hop's key words keys [4] ([n, 4]) int32 (or an int key) -> [F, fanout]
    ([n, F, fanout]) int32, as ``host_draw_plain``. Into a pinned ``out``
    (a trainer on a card) by the C++ of ``csrc/host_half.cu`` over
    ``host_threads()`` threads; otherwise by the plain version."""
    n, F, kw = _draw_shapes(frontier, fanout, keys)
    _host_args("host_draw", indptr, indices, frontier, kw)
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
        raise ValueError(f"host_draw: indptr {indptr.dtype}, indices "
                         f"{indices.dtype}")
    if out is None or not out.is_pinned():
        return host_draw_plain(indptr, indices, frontier, fanout, kw, out)
    if out.dtype != torch.int32 or not out.is_contiguous() \
            or tuple(out.shape) != tuple(frontier.shape) + (fanout,):
        raise ValueError(f"host_draw: out {out.dtype} {tuple(out.shape)}")
    rc = kernels.lib().lt_host_draw_i64(
        indptr.data_ptr(), indices.data_ptr(), indptr.shape[0] - 1,
        frontier.data_ptr(), n, F, fanout, kw.data_ptr(), out.data_ptr(),
        host_threads())
    if rc != 0:
        raise RuntimeError(f"host_draw failed ({rc})")
    return out
