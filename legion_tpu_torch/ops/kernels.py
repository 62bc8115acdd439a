"""Hand-written CUDA kernels: build, bind, and the K1/K2 wrappers.

Build (route (b) of the port's kernel rule): at first use, nvcc compiles
each ``legion_tpu_torch/csrc/*.cu`` in parallel (one nvcc per source) and
links them into one shared library with a plain C interface under
``legion_tpu_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds. ctypes loads it. Nothing falls back: a missing
nvcc, a failed build or a refused launch raises.

Each wrapper runs its plain PyTorch version for CPU tensors only (the CPU
tests use it, and ``chip_smoke.py`` compares the kernel with it on the
card); for CUDA tensors it launches the kernel on the current stream and
adds one to ``LAUNCHES[name]``.

K1 ``gather_rows`` replaces ``legion_tpu/ops/pallas_segment.py::
gather_rows_pallas``; K2 ``segment_sum`` replaces ``segment_sum_pallas``.
K3 ``windowed_draw`` and K5 ``csr_draw`` live with their callers in
``sampling/access.py``, K4 ``cached_gather`` in ``cache/unified_cache.py``;
host-memory registration for K4 and K5 is ``ops/host_memory.py``. The
headers of ``csrc/*.cu`` say what bounds each kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")

# launches per kernel since the last reset (chip_smoke.py reads these to
# show that the main path went through every kernel)
LAUNCHES: Dict[str, int] = {"gather_rows": 0, "segment_sum": 0,
                            "windowed_draw": 0, "cached_gather": 0,
                            "csr_draw": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the "
            "legion_tpu_torch kernels are built from csrc/ at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblegion_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands together; raise on the first failure. Returns the
    concatenated output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
    return "".join(outs)


def build() -> Tuple[float, str]:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all started together, then one link. Returns the
    seconds spent and nvcc's report (registers and spills per kernel, from
    ``-Xptxas -v``); (0.0, "") when it was built already."""
    so = library_path()
    if so.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    t0 = time.time()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                           for p, o in zip(cu, objs)])
        lib_tmp = os.path.join(tmp, so.name)
        report += _run_all([[nvcc, *GENCODE, "-shared", "-o", lib_tmp,
                             *objs]])
        os.replace(lib_tmp, so)
    return time.time() - t0, report


@functools.cache
def lib() -> ctypes.CDLL:
    """The built kernel library (built on first call)."""
    build()
    so = ctypes.CDLL(str(library_path()))
    p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                        ctypes.c_uint32)
    so.lt_gather_rows.argtypes = [p, p, p, i64, i64, i64, p]
    so.lt_segment_sum_f32.argtypes = [p, p, p, i64, i64, i64, p]
    so.lt_segment_sum_bf16.argtypes = [p, p, p, i64, i64, i64, p]
    for fn in (so.lt_windowed_draw_i32, so.lt_windowed_draw_i64):
        fn.argtypes = [p, p, p, p, i64, i32, i32, i64, u32, u32, u32, u32,
                       p]
    so.lt_cached_gather.argtypes = [p, p, i64, p, i64, p, i64, i64, i32, p,
                                    p, p]
    for fn in (so.lt_csr_draw_i32, so.lt_csr_draw_i64):
        fn.argtypes = [p, i64, i32, p, p, p, p, p, i64, u32, u32, p, p]
    so.lt_host_register.argtypes = [p, i64, i32,
                                     ctypes.POINTER(ctypes.c_void_p)]
    so.lt_host_unregister.argtypes = [p]
    for fn in (so.lt_gather_rows, so.lt_segment_sum_f32,
               so.lt_segment_sum_bf16, so.lt_windowed_draw_i32,
               so.lt_windowed_draw_i64, so.lt_cached_gather,
               so.lt_csr_draw_i32, so.lt_csr_draw_i64, so.lt_host_register,
               so.lt_host_unregister):
        fn.restype = ctypes.c_int
    so.lt_error_string.argtypes = [ctypes.c_int]
    so.lt_error_string.restype = ctypes.c_char_p
    return so


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error; count the launch."""
    if rc != 0:
        msg = lib().lt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1 gather_rows
# ---------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """out[i] = table[ids[i]]; zero rows where ids[i] < 0; ids past the
    table clamp to its last row."""
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]
    return torch.where((ids >= 0)[:, None], rows, torch.zeros_like(rows))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K1. table [V, F] (bf16 or f32), ids [N] int32 -> [N, F]."""
    _require(table.dim() == 2 and ids.dim() == 1,
             f"gather_rows: table {tuple(table.shape)}, ids "
             f"{tuple(ids.shape)}")
    _require(ids.dtype == torch.int32, f"gather_rows: ids {ids.dtype}")
    _require(table.dtype in (torch.bfloat16, torch.float32),
             f"gather_rows: table {table.dtype}")
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_plain(table, ids)
    _require(table.is_cuda and ids.device == table.device,
             f"gather_rows: table on {table.device}, ids on {ids.device}")
    _require(table.shape[0] > 0, "gather_rows: empty table")
    table, ids = table.contiguous(), ids.contiguous()
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    rc = lib().lt_gather_rows(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
        table.shape[0], table.shape[1] * table.element_size(),
        stream_handle())
    check("gather_rows", rc)
    return out


# ---------------------------------------------------------------------------
# K2 segment_sum
# ---------------------------------------------------------------------------

def segment_sum_plain(data: torch.Tensor, seg: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] (in f32) over e with seg[e] == s; seg < 0
    or >= num_segments is dropped."""
    keep = (seg >= 0) & (seg < num_segments)
    idx = torch.where(keep, seg, num_segments).long()
    out = torch.zeros((num_segments + 1, data.shape[1]),
                      dtype=torch.float32, device=data.device)
    out.index_add_(0, idx, data.float())
    return out[:num_segments]


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """K2. data [E, F] (bf16 or f32), seg [E] int32 -> [S, F] float32."""
    _require(data.dim() == 2 and seg.dim() == 1
             and seg.shape[0] == data.shape[0],
             f"segment_sum: data {tuple(data.shape)}, seg "
             f"{tuple(seg.shape)}")
    _require(seg.dtype == torch.int32, f"segment_sum: seg {seg.dtype}")
    _require(data.dtype in (torch.bfloat16, torch.float32),
             f"segment_sum: data {data.dtype}")
    if data.device.type == "cpu" and seg.device.type == "cpu":
        return segment_sum_plain(data, seg, num_segments)
    _require(data.is_cuda and seg.device == data.device,
             f"segment_sum: data on {data.device}, seg on {seg.device}")
    data, seg = data.contiguous(), seg.contiguous()
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    fn = lib().lt_segment_sum_f32 if data.dtype == torch.float32 \
        else lib().lt_segment_sum_bf16
    rc = fn(data.data_ptr(), seg.data_ptr(), out.data_ptr(), data.shape[0],
            data.shape[1], num_segments, stream_handle())
    check("segment_sum", rc)
    return out


class GatherRows(torch.autograd.Function):
    """K1 with K2 as its backward: d table = segment_sum(d out, ids),
    cast back to the table's dtype (pad lanes get no gradient)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return gather_rows(table, ids)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (ids,) = ctx.saved_tensors
        g = segment_sum(grad_out, ids, ctx.num_rows)
        return g.to(ctx.table_dtype), None
