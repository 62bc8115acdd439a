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
"""

from __future__ import annotations

import ctypes
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
