"""Hand-written CUDA kernels: build, bind, and the K1/K2/K6/K7/K15
wrappers.

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
K6 ``gat_attend`` replaces the XLA attention of ``legion_tpu/models/gat.py::
gat_layer_aligned_streaming`` and K7 ``hop_attention`` the XLA
``legion_tpu/ops/hop_agg.py::hop_softmax_attention``, each with a backward
kernel (its launches counted under ``<name>_bwd``); K7's plain version
lives with its caller in ``ops/hop_agg.py``. K15 ``hop_mean`` replaces
``legion_tpu/ops/hop_agg.py::hop_neighbor_sum`` / ``hop_neighbor_mean``
(and, on the aligned last hop over the device feature table, the fetch of
its rows); its plain versions live in ``ops/hop_agg.py``. Its backward is
``hop_mean_grad`` on a gathered hop (the lanes grouped by row on the card,
each row summed in lane order and written once; counted under
``hop_mean_grad``) and its own kernel on an aligned one (``hop_mean_bwd``).
K3 ``windowed_draw``, K5 ``csr_draw`` and K10 ``step_keys`` (a step's
key words from the device counters, for K3 and K5 to read) live with
their callers in ``sampling/access.py``, K4 ``cached_gather`` in ``cache/unified_cache.py``,
K8 ``dedup_sort`` (sort dedup around its sort: the keys, counted under
``dedup_keys``, and everything after the sort) and K9 ``dedup_map`` (the
position map: seed registration, a hop's claim, rank and read-back, the
clear, or all of them in one cooperative launch; every call counted under
``dedup_map``) in ``sampling/sampler.py``;
K11 ``hash_lookup`` (the hash map's lookup) in ``cache/hashmap.py``; K12
``bucket_by_owner`` (a clique request's routing to its owners), K13
``clique_gather`` (the requester's rows, with the host misses) and K14
``clique_draw`` (the owners' draws, and ``clique_draw_unsort`` on the
requester's side) in ``cache/collective.py``; K16 ``dropout_act``
(dropout fused with the activation and the cast before it, backward
counted under ``dropout_act_bwd``) in ``ops/dropout.py``; K17
``segment_max`` and K18 ``segment_softmax`` (the JAX package's segment
max and softmax, on no path; backwards counted under ``<name>_bwd``) in
``ops/segment.py``;
host-memory registration for K4 and K5 is ``ops/host_memory.py``. The
headers of ``csrc/*.cu`` say what bounds each kernel on the card.
``noop`` launches an empty kernel, the yardstick of a launch's cost, and
``grid_sync_probe`` an empty cooperative one with grid barriers, K9's.
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
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
# K9's grid.sync() (cooperative groups) needs a cooperative launch and no
# further flag: no -rdc since CUDA 11
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")

# launches per kernel since the last reset (chip_smoke.py reads these to
# show that the main path went through every kernel). A CUDA-graph replay
# runs no Python: a captured step counts once, at capture, and the trainer
# keeps that step's counts (``Trainer.graph_launches``)
LAUNCHES: Dict[str, int] = {"gather_rows": 0, "segment_sum": 0,
                            "windowed_draw": 0, "cached_gather": 0,
                            "csr_draw": 0, "gat_attend": 0,
                            "gat_attend_bwd": 0, "hop_attention": 0,
                            "hop_attention_bwd": 0, "dedup_keys": 0,
                            "dedup_sort": 0, "dedup_map": 0, "step_keys": 0,
                            "hash_lookup": 0, "bucket_by_owner": 0,
                            "clique_gather": 0, "clique_draw": 0,
                            "clique_draw_unsort": 0, "hop_mean": 0,
                            "hop_mean_bwd": 0, "hop_mean_grad": 0,
                            "dropout_act": 0, "dropout_act_bwd": 0,
                            "segment_max": 0, "segment_max_bwd": 0,
                            "segment_softmax": 0, "segment_softmax_bwd": 0}


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
    p, i64, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_uint32, ctypes.c_float)
    so.lt_gather_rows.argtypes = [p, p, p, i64, i64, i64, p]
    for name in SUM_FN.values():
        getattr(so, name).argtypes = [p, p, p, i64, i64, i64, i64, p]
    so.lt_hop_mean.argtypes = [p, i64, i64, i32, p, p, i64, p, i64, i32, i64,
                               i32, p, p, p]
    so.lt_hop_mean_bwd.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i32,
                                   p, i32, p]
    so.lt_hop_mean_grad.argtypes = [p, p, p, i64, p, i64, i64, i64, i64, p,
                                    p, i32, p]
    so.lt_hop_mean_grad_scratch.argtypes = [i64, i64, i64, i64]
    so.lt_hop_mean_grad_scratch.restype = ctypes.c_int64
    so.lt_lanes_by_source.argtypes = [p, i64, i64, p, p, p, p, p]
    so.lt_segment_groups_words.argtypes = [i64, i64, i32]
    so.lt_segment_groups_words.restype = ctypes.c_int64
    so.lt_segment_groups.argtypes = [p, i64, i64, p, p, i32, p]
    so.lt_segment_groups_layout.argtypes = [i64, i64, p]
    so.lt_segment_groups_layout.restype = None
    so.lt_segment_part_words.argtypes = [i64, i64]
    so.lt_segment_part_words.restype = ctypes.c_int64
    for fn in (so.lt_windowed_draw_i32, so.lt_windowed_draw_i64):
        fn.argtypes = [p, p, p, p, i64, i32, i32, i64, p, p]
    so.lt_cached_gather.argtypes = [p, p, i64, p, i64, i64, i32, p, p, i64,
                                    i64, i32, p, p, i64, p]
    for fn in (so.lt_csr_draw_i32, so.lt_csr_draw_i64):
        fn.argtypes = [p, i64, i32, p, p, p, p, p, i64, p, p, p]
    # attention dropout's arguments: words, fold, regime, kq, keep, c
    drop = [p, ctypes.c_uint64, i32, u32, f32, f32]
    so.lt_gat_attend_fwd.argtypes = [p, p, p, p, p] + drop + [
        f32, p, p, p, i64, i32, i32, i32, i64, i32, i32, p]
    so.lt_gat_attend_bwd.argtypes = [p, p, p, p, p] + drop + [
        f32, p, p, i64, i32, i32, i32, i64, i32, i32, p]
    so.lt_hop_attention_fwd.argtypes = [p, p, p, p] + drop + [
        p, p, i64, i32, i32, i32, i64, i64, i32, p]
    so.lt_hop_attention_bwd.argtypes = [p, p, p, p, p] + drop + [
        p, p, i64, i32, i32, i32, i64, i64, i32, p]
    so.lt_host_register.argtypes = [p, i64, ctypes.POINTER(ctypes.c_void_p)]
    so.lt_host_unregister.argtypes = [p]
    so.lt_host_read_probe.argtypes = [p, i64, i64, p, i64, i32, p, p]
    so.lt_host_word_probe.argtypes = [p, p, i64, p, p]
    so.lt_dedup_keys.argtypes = [p, i64, p, i64, p, p]
    so.lt_dedup_sort.argtypes = [p, p, i32, i64, i64, p, i32, p, i64, p, p,
                                 p, p]
    so.lt_map_register.argtypes = [p, i64, p, i64, p]
    so.lt_map_clear.argtypes = [p, i64, p, i64, p]
    so.lt_dedup_map.argtypes = [p, i64, p, i64, p, i32, p, p, p, p, p]
    so.lt_dedup_map_fused.argtypes = [p, i64, p, i64, p, i64, p, i32, p, p,
                                      p, i64, p, p]
    so.lt_dedup_map_grid.argtypes = [i64, i64, i64]
    so.lt_step_keys.argtypes = [p, p, u32, i32, i32, i64, p, p, p]
    so.lt_hash_lookup.argtypes = [p, i64, i32, p, i64, p, p]
    so.lt_bucket_scratch.argtypes = [i64, i64, i32]
    so.lt_bucket_scratch.restype = ctypes.c_int64
    so.lt_bucket_by_owner.argtypes = [p, i64, i64, i32, i32, p, p, p, p, p]
    so.lt_clique_gather.argtypes = [p, p, p, i64, i64, i32, p, p, i64, i64,
                                    i32, p, p, i64, i32, i64, p]
    for fn in (so.lt_clique_draw_i32, so.lt_clique_draw_i64):
        fn.argtypes = [p, p, i64, i64, i32, p, i64, i32, i64, i32, p, i32,
                       p, p]
    so.lt_clique_draw_unsort.argtypes = [p, p, p, i64, i64, i32, p, p]
    so.lt_dropout_act_fwd.argtypes = [p, i32, p, i32, p, i64, p, u32, i32,
                                      i32, u32, f32, f32, p]
    so.lt_dropout_act_bwd.argtypes = [p, p, p, i32, p, i32, i64, p, u32, i32,
                                      i32, u32, f32, f32, p]
    # the segment ops: ..., groups, tmp (the forward's build), part, out,
    # stream
    so.lt_segment_max_fwd.argtypes = [p, i32, p, i64, i64, i64, u32, p, p,
                                      p, p, p]
    so.lt_segment_max_bwd.argtypes = [p, i32, p, p, p, f32, i64, i64, i64, p,
                                      p, p, p]
    so.lt_segment_softmax_fwd.argtypes = [p, i32, p, i64, i64, i64, p, p, p,
                                          p, p]
    so.lt_segment_softmax_bwd.argtypes = [p, p, i32, p, i64, i64, i64, p, p,
                                          p, p]
    so.lt_noop.argtypes = [p]
    so.lt_grid_sync_probe.argtypes = [i32, i32, p]
    for fn in (so.lt_noop, so.lt_gather_rows,
               *(getattr(so, n) for n in SUM_FN.values()), so.lt_hop_mean,
               so.lt_hop_mean_bwd,
               so.lt_hop_mean_grad,
               so.lt_lanes_by_source, so.lt_windowed_draw_i32,
               so.lt_windowed_draw_i64, so.lt_cached_gather,
               so.lt_csr_draw_i32, so.lt_csr_draw_i64, so.lt_host_register,
               so.lt_host_unregister, so.lt_host_read_probe,
               so.lt_host_word_probe, so.lt_gat_attend_fwd,
               so.lt_gat_attend_bwd, so.lt_hop_attention_fwd,
               so.lt_hop_attention_bwd, so.lt_dedup_keys, so.lt_dedup_sort,
               so.lt_map_register, so.lt_map_clear, so.lt_dedup_map,
               so.lt_dedup_map_fused, so.lt_dedup_map_grid,
               so.lt_grid_sync_probe, so.lt_step_keys, so.lt_hash_lookup,
               so.lt_bucket_by_owner, so.lt_clique_gather,
               so.lt_clique_draw_i32, so.lt_clique_draw_i64,
               so.lt_clique_draw_unsort, so.lt_dropout_act_fwd,
               so.lt_dropout_act_bwd, so.lt_segment_max_fwd,
               so.lt_segment_max_bwd, so.lt_segment_softmax_fwd,
               so.lt_segment_softmax_bwd, so.lt_segment_groups):
        fn.restype = ctypes.c_int
    so.lt_error_string.argtypes = [ctypes.c_int]
    so.lt_error_string.restype = ctypes.c_char_p
    return so


def stream_handle() -> int:
    """The current CUDA stream's handle, read without building a
    ``torch.cuda.Stream`` object (a few us of the host's time a launch)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def check(name: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error; count the launch."""
    if rc != 0:
        msg = lib().lt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_probe(name: str, rc: int) -> None:
    if rc != 0:
        msg = lib().lt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def noop() -> None:
    """Launch the empty kernel (``csrc/noop.cu``) on the current stream:
    the yardstick for what one launch through this ctypes route costs.
    On no path, and not counted in ``LAUNCHES``."""
    _check_probe("noop", lib().lt_noop(stream_handle()))


def grid_sync_probe(n_syncs: int, blocks: int) -> None:
    """Launch the empty cooperative kernel (``csrc/noop.cu``) of ``blocks``
    blocks that calls ``grid.sync()`` ``n_syncs`` times: the yardstick of
    K9's launch and barriers. On no path, not counted in ``LAUNCHES``."""
    _check_probe("grid_sync_probe", lib().lt_grid_sync_probe(
        n_syncs, blocks, stream_handle()))


# ---------------------------------------------------------------------------
# K1 gather_rows
# ---------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """out[i] = table[ids[i]]; zero rows where ids[i] < 0; ids past the
    table clamp to its last row."""
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]
    return torch.where((ids >= 0)[:, None], rows, torch.zeros_like(rows))


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1. table [V, F] of any dtype (the kernel copies opaque words of 16,
    4, 2 or 1 bytes), ids [N] int32 -> [N, F], written into ``out``
    (contiguous, [N, F] in the table's dtype) when given."""
    _require(table.dim() == 2 and ids.dim() == 1,
             f"gather_rows: table {tuple(table.shape)}, ids "
             f"{tuple(ids.shape)}")
    _require(ids.dtype == torch.int32, f"gather_rows: ids {ids.dtype}")
    _require(out is None or (out.is_contiguous() and out.dtype == table.dtype
                             and tuple(out.shape) == (ids.shape[0],
                                                      table.shape[1])
                             and out.device == table.device),
             "gather_rows: out must be a contiguous [N, F] tensor of the "
             "table's dtype and device")
    if table.device.type == "cpu" and ids.device.type == "cpu":
        rows = gather_rows_plain(table, ids)
        return rows if out is None else out.copy_(rows)
    _require(table.is_cuda and ids.device == table.device,
             f"gather_rows: table on {table.device}, ids on {ids.device}")
    _require(table.shape[0] > 0, "gather_rows: empty table")
    table, ids = table.contiguous(), ids.contiguous()
    if out is None:
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

# K2's accumulator by data dtype: f32 for f32, bf16 and f16, f64 for f64,
# int32 (wrapping modulo 2^32) for int32
SUM_ACC = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
           torch.float16: torch.float32, torch.float64: torch.float64,
           torch.int32: torch.int32}


# K2's C entry point by data dtype
SUM_FN = {torch.float32: "lt_segment_sum_f32",
          torch.bfloat16: "lt_segment_sum_bf16",
          torch.float16: "lt_segment_sum_f16",
          torch.float64: "lt_segment_sum_f64",
          torch.int32: "lt_segment_sum_i32"}


def segment_sum_plain(data: torch.Tensor, seg: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over e with seg[e] == s, in ``SUM_ACC``'s
    type (int32 summed in int64 and wrapped modulo 2^32); seg < 0 or >=
    num_segments is dropped."""
    keep = (seg >= 0) & (seg < num_segments)
    idx = torch.where(keep, seg, num_segments).long()
    acc = SUM_ACC[data.dtype]
    wide = torch.int64 if acc == torch.int32 else acc
    out = torch.zeros((num_segments + 1, data.shape[1]), dtype=wide,
                      device=data.device)
    out.index_add_(0, idx, data.to(wide))
    out = out[:num_segments]
    if acc == torch.int32:
        out = ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    return out


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """K2. data [E, F] (f32, bf16, f16, f64 or int32), seg [E] int32 ->
    [S, F] in ``SUM_ACC``'s type of data's: f32, f64 or int32 (an exact
    sum, wrapping modulo 2^32)."""
    _require(data.dim() == 2 and seg.dim() == 1
             and seg.shape[0] == data.shape[0],
             f"segment_sum: data {tuple(data.shape)}, seg "
             f"{tuple(seg.shape)}")
    _require(seg.dtype == torch.int32, f"segment_sum: seg {seg.dtype}")
    _require(data.dtype in SUM_ACC, f"segment_sum: data {data.dtype}")
    if data.device.type == "cpu" and seg.device.type == "cpu":
        return segment_sum_plain(data, seg, num_segments)
    _require(data.is_cuda and seg.device == data.device,
             f"segment_sum: data on {data.device}, seg on {seg.device}")
    E, F = data.shape
    # rows a fixed stride apart (a column slice of a wider tensor) are read
    # in place; any other layout is copied
    if E > 1 and F > 1 and data.stride(1) == 1 and data.stride(0) >= F:
        ld = data.stride(0)
    else:
        data, ld = data.contiguous(), F
    seg = seg.contiguous()
    out = torch.zeros((num_segments, F), dtype=SUM_ACC[data.dtype],
                      device=data.device)
    rc = getattr(lib(), SUM_FN[data.dtype])(
        data.data_ptr(), seg.data_ptr(), out.data_ptr(), E, F, ld,
        num_segments, stream_handle())
    check("segment_sum", rc)
    return out


class GatherRows(torch.autograd.Function):
    """K1 with K2 as its backward: d table = segment_sum(d out, ids), an id
    past the table summed into its last row (the row K1 read, as the
    transpose of JAX's clipped gather adds), cast back to the table's
    dtype (pad lanes get no gradient)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return gather_rows(table, ids)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (ids,) = ctx.saved_tensors
        g = segment_sum(grad_out, ids.clamp_max(ctx.num_rows - 1),
                        ctx.num_rows)
        return g.to(ctx.table_dtype), None


# ---------------------------------------------------------------------------
# K6 gat_attend and K7 hop_attention (GAT attention, forward and backward)
# ---------------------------------------------------------------------------

MAX_ATTN_FANOUT = 64
MAX_ATTN_HEADS = 16


def _attn_checks(name: str, fanout: int, heads: int, src: torch.Tensor,
                 hop_offset: torch.Tensor, device: torch.device) -> None:
    _require(0 < fanout <= MAX_ATTN_FANOUT and 0 < heads <= MAX_ATTN_HEADS,
             f"{name}: fanout {fanout} (max {MAX_ATTN_FANOUT}), heads "
             f"{heads} (max {MAX_ATTN_HEADS})")
    _require(src.dim() == 1 and src.dtype == torch.int32
             and src.shape[0] % fanout == 0 and src.device == device,
             f"{name}: edge_src {src.dtype} {tuple(src.shape)} on "
             f"{src.device}")
    _require(hop_offset.numel() == 1 and hop_offset.dtype == torch.int32
             and hop_offset.device == device,
             f"{name}: hop_offset {hop_offset.dtype} "
             f"{tuple(hop_offset.shape)} on {hop_offset.device}")


def slice_rows(t: torch.Tensor, offset: torch.Tensor, n: int
                ) -> torch.Tensor:
    """t[offset : offset + n] for a device scalar offset (no host sync)."""
    return t.index_select(0, offset.reshape(()).long()
                          + torch.arange(n, device=t.device))


def gat_scores_plain(x: torch.Tensor, u_l: torch.Tensor, u_r: torch.Tensor,
                     edge_src: torch.Tensor, hop_offset: torch.Tensor,
                     fanout: int, aligned_offset: int, slope: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's scores with the casts of ``gat.py:83-93``: el [fanout, F, H]
    and er [F, H] are x @ u in x's dtype, widened to f32; alpha [fanout,
    F, H] f32 is the masked fanout softmax of their LeakyReLU, before
    dropout."""
    E = edge_src.shape[0]
    F = E // fanout
    H = u_l.shape[1]
    valid = (edge_src >= 0).reshape(fanout, F)[..., None]
    er = (slice_rows(x, hop_offset, F) @ u_r).float()
    el = (x[aligned_offset:aligned_offset + E] @ u_l).float() \
        .reshape(fanout, F, H)
    alpha = masked_fanout_softmax(leaky_relu(el + er[None], slope), valid)
    return el, er, alpha


def gat_contract_plain(x: torch.Tensor, alpha: torch.Tensor, drop,
                       aligned_offset: int) -> torch.Tensor:
    """K6's fanout contraction (``gat.py:94-99``): alpha [fanout, F, H]
    f32 through attention dropout (``drop``, an ``ops/dropout.py::
    AttnDrop`` or None), cast to x's dtype, then xw[i, h, k] = sum_f
    alpha[f, i, h] x[aligned_offset + f*F + i, k] in x's dtype."""
    from legion_tpu_torch.ops.dropout import attn_dropout_plain
    fanout, F, _ = alpha.shape
    alpha = attn_dropout_plain(alpha, drop)
    x_lanes = x[aligned_offset:aligned_offset + fanout * F]
    return torch.einsum("fih,fik->ihk", alpha.to(x.dtype),
                        x_lanes.reshape(fanout, F, x.shape[1]))


def gat_attend_plain(x: torch.Tensor, u_l: torch.Tensor, u_r: torch.Tensor,
                     edge_src: torch.Tensor, hop_offset: torch.Tensor,
                     fanout: int, aligned_offset: int, slope: float,
                     drop=None) -> torch.Tensor:
    """K6's plain version, with the casts of ``gat.py:83-99``. Returns xw
    [F, H, d_in] in x's dtype."""
    alpha = gat_scores_plain(x, u_l, u_r, edge_src, hop_offset, fanout,
                             aligned_offset, slope)[2]
    return gat_contract_plain(x, alpha, drop, aligned_offset)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """JAX's form, whose slope at 0 is 1 (torch's is ``slope``): GAT's
    scores sit at 0 exactly where a zero bias meets a zero row."""
    return torch.where(x >= 0, x, x * slope)


def masked_fanout_softmax(s: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Softmax over the leading (fanout) axis with invalid lanes left out
    (alpha 0; a row with no valid lane gives zeros), as the JAX layers
    take it (``hop_agg.py:111-119``)."""
    fi = torch.finfo(s.dtype)
    s = torch.where(valid, s, fi.min)
    m = s.max(dim=0, keepdim=True).values.detach()
    e = torch.where(valid, torch.exp(s - m), 0.0)
    return e / e.sum(dim=0, keepdim=True).clamp(min=fi.tiny)


def _drop_args(shape, drop) -> Tuple:
    """The dropout arguments of a K6 / K7 launch for alpha of ``shape``:
    the key words' pointer, the fold, the regime, kq, keep and c. (Imported
    here: ``ops/dropout.py`` imports this module.)"""
    from legion_tpu_torch.ops.dropout import attn_spec
    s = attn_spec(tuple(shape), drop)
    return (None if drop is None else drop.words.data_ptr(), s.layer,
            s.regime, s.kq, s.keep, s.c)


def _words(drop):
    """The dropout key words of ``drop`` (None without dropout)."""
    return None if drop is None else drop.words


def gat_attend_fwd(x, u_l, u_r, edge_src, hop_offset, fanout: int,
                   aligned_offset: int, slope: float, drop, general: bool):
    """K6's forward launch (no autograd; ``GatAttend`` calls it): (xw
    [F, H, d_in] in x's dtype, alpha before dropout [fanout, F, H] f32,
    the LeakyReLU sign [fanout, F, H] u8). Contiguous CUDA tensors."""
    E = edge_src.shape[0]
    F = E // fanout
    d_in, H = u_l.shape
    xw = torch.empty((F, H, d_in), dtype=x.dtype, device=x.device)
    alpha = torch.empty((fanout, F, H), dtype=torch.float32,
                        device=x.device)
    neg = torch.empty((fanout, F, H), dtype=torch.uint8, device=x.device)
    dargs = _drop_args(alpha.shape, drop)
    rc = lib().lt_gat_attend_fwd(
        x.data_ptr(), u_l.data_ptr(), u_r.data_ptr(), edge_src.data_ptr(),
        hop_offset.data_ptr(), *dargs, slope, xw.data_ptr(),
        alpha.data_ptr(), neg.data_ptr(), F, fanout, H, d_in,
        aligned_offset, int(x.dtype == torch.bfloat16), int(general),
        stream_handle())
    check("gat_attend", rc)
    return xw, alpha, neg


def gat_attend_bwd(dxw, x, edge_src, alpha, neg, fanout: int,
                   aligned_offset: int, slope: float, drop, general: bool):
    """K6's backward launch (no autograd): (d_el [fanout, F, H], d_er
    [F, H]) f32, the keep bits drawn again from ``drop``."""
    F, H = alpha.shape[1], alpha.shape[2]
    d_el = torch.empty_like(alpha)
    d_er = torch.empty((F, H), dtype=torch.float32, device=x.device)
    dargs = _drop_args(alpha.shape, drop)
    rc = lib().lt_gat_attend_bwd(
        dxw.data_ptr(), x.data_ptr(), edge_src.data_ptr(), alpha.data_ptr(),
        neg.data_ptr(), *dargs, slope, d_el.data_ptr(), d_er.data_ptr(), F,
        fanout, H, x.shape[1], aligned_offset,
        int(x.dtype == torch.bfloat16), int(general), stream_handle())
    check("gat_attend_bwd", rc)
    return d_el, d_er


class GatAttend(torch.autograd.Function):
    """K6, backward K6's second kernel: d_el [fanout, F, H] and d_er
    [F, H], then du_l = x_lanes^T d_el and du_r = x_dst^T d_er by
    ``torch.matmul`` in x's dtype, as JAX's transpose of ``x @ u``. x gets
    no gradient (it is the fetched feature table). Saves the dropout key
    words, never a mask: the backward draws the keep bits again."""

    @staticmethod
    def forward(ctx, x, u_l, u_r, edge_src, hop_offset, fanout,
                aligned_offset, slope, drop, general):
        xw, alpha, neg = gat_attend_fwd(x, u_l, u_r, edge_src, hop_offset,
                                        fanout, aligned_offset, slope, drop,
                                        general)
        ctx.save_for_backward(x, edge_src, hop_offset, alpha, neg,
                              _words(drop))
        ctx.cfg = (fanout, aligned_offset, slope, drop, general)
        return xw

    @staticmethod
    def backward(ctx, dxw):
        x, edge_src, hop_offset, alpha, neg, _ = ctx.saved_tensors
        fanout, aligned_offset, slope, drop, general = ctx.cfg
        E = edge_src.shape[0]
        F, H = alpha.shape[1], alpha.shape[2]
        d_el, d_er = gat_attend_bwd(dxw.to(x.dtype).contiguous(), x,
                                    edge_src, alpha, neg, fanout,
                                    aligned_offset, slope, drop, general)
        x_lanes = x[aligned_offset:aligned_offset + E]
        du_l = x_lanes.t() @ d_el.reshape(E, H).to(x.dtype)
        du_r = slice_rows(x, hop_offset, F).t() @ d_er.to(x.dtype)
        return (None, du_l, du_r) + (None,) * 7


def gat_attend(x: torch.Tensor, u_l: torch.Tensor, u_r: torch.Tensor,
               edge_src: torch.Tensor, hop_offset: torch.Tensor, fanout: int,
               aligned_offset: int, slope: float, drop=None,
               general: bool = False) -> torch.Tensor:
    """K6. x [N, d_in] (bf16 or f32; lanes at aligned_offset + f*F + i,
    destinations at hop_offset + i), u_l/u_r [d_in, H] in x's dtype,
    edge_src [fanout*F] int32 (-1 pads), ``drop`` attention dropout
    (``ops/dropout.py::AttnDrop``: the step's dropout key words on x's
    device, the layer, the rate; its keep bits drawn in the kernels) or
    None -> xw [F, H, d_in] in x's dtype. bf16 with H <= 8 and fanout <= 15
    takes the tensor-core kernels at d_in 128, and at a width of 4 to 112
    in steps of 4 (``csrc/gat_attend.cu``); ``general`` takes the general
    kernels there too (``chip_smoke.py`` times the two)."""
    _require(x.dim() == 2 and u_l.dim() == 2 and u_l.shape == u_r.shape
             and u_l.shape[0] == x.shape[1],
             f"gat_attend: x {tuple(x.shape)}, u_l {tuple(u_l.shape)}, "
             f"u_r {tuple(u_r.shape)}")
    _require(x.dtype in (torch.bfloat16, torch.float32)
             and u_l.dtype == x.dtype and u_r.dtype == x.dtype,
             f"gat_attend: x {x.dtype}, u {u_l.dtype}/{u_r.dtype}")
    _require(aligned_offset + edge_src.shape[0] <= x.shape[0],
             "gat_attend: the aligned lanes run past x")
    tensors = (x, u_l, u_r, edge_src, hop_offset, _words(drop))
    if all(t.device.type == "cpu" for t in tensors if t is not None):
        return gat_attend_plain(x, u_l, u_r, edge_src, hop_offset, fanout,
                                aligned_offset, slope, drop)
    _require(x.is_cuda and u_l.device == x.device and u_r.device == x.device,
             f"gat_attend: x on {x.device}, u_l on {u_l.device}, u_r on "
             f"{u_r.device}")
    _attn_checks("gat_attend", fanout, u_l.shape[1], edge_src, hop_offset,
                 x.device)
    _require(not x.requires_grad,
             "gat_attend: x must not require grad (the aligned hop feeds "
             "layer 0, whose input is the fetched feature table)")
    if drop is not None:
        _require(drop.words.device == x.device,
                 f"gat_attend: dropout key words on {drop.words.device}, x "
                 f"on {x.device}")
    return GatAttend.apply(x.contiguous(), u_l.contiguous(),
                           u_r.contiguous(), edge_src.contiguous(),
                           hop_offset, fanout, int(aligned_offset),
                           float(slope), drop, bool(general))


class HopAttention(torch.autograd.Function):
    """K7 with its backward kernel: dscores [fanout, F, H] and dz. On a
    gathered hop dz is summed in f32 by atomics and cast to z's dtype
    once; on an aligned hop every lane owns its row, and the kernel
    stores dz in z's dtype. The forward kernel writes every row of out
    (zeros outside the hop), so out is not zero-filled here. Saves the
    dropout key words, never a mask: the backward draws the keep bits
    again."""

    @staticmethod
    def forward(ctx, z2, scores, src_l, hop_offset, fanout, num_dst, heads,
                aligned_offset, drop):
        fo, F, H = scores.shape
        d = z2.shape[1] // heads
        out = torch.empty((num_dst, H, d), dtype=torch.float32,
                          device=z2.device)
        alpha = torch.empty_like(scores)
        dargs = _drop_args(scores.shape, drop)
        rc = lib().lt_hop_attention_fwd(
            z2.data_ptr(), scores.data_ptr(), src_l.data_ptr(),
            hop_offset.data_ptr(), *dargs, out.data_ptr(), alpha.data_ptr(),
            F, fanout, H, d, num_dst, aligned_offset,
            int(z2.dtype == torch.bfloat16), stream_handle())
        check("hop_attention", rc)
        ctx.save_for_backward(z2, src_l, hop_offset, alpha, _words(drop))
        ctx.cfg = (fanout, num_dst, aligned_offset, drop)
        return out

    @staticmethod
    def backward(ctx, dout):
        z2, src_l, hop_offset, alpha, _ = ctx.saved_tensors
        fanout, num_dst, aligned_offset, drop = ctx.cfg
        fo, F, H = alpha.shape
        d = z2.shape[1] // H
        dout = dout.float().contiguous()
        dscores = torch.empty_like(alpha)
        dz = torch.zeros(z2.shape, device=z2.device, dtype=torch.float32
                         if aligned_offset < 0 else z2.dtype)
        dargs = _drop_args(alpha.shape, drop)
        rc = lib().lt_hop_attention_bwd(
            dout.data_ptr(), z2.data_ptr(), src_l.data_ptr(),
            hop_offset.data_ptr(), alpha.data_ptr(), *dargs,
            dscores.data_ptr(), dz.data_ptr(), F, fanout, H, d, num_dst,
            aligned_offset, int(z2.dtype == torch.bfloat16), stream_handle())
        check("hop_attention_bwd", rc)
        return (dz.to(z2.dtype), dscores) + (None,) * 7


def hop_attention(z2: torch.Tensor, scores: torch.Tensor,
                  src_l: torch.Tensor, fanout: int, hop_offset: torch.Tensor,
                  num_dst: int, heads: int, aligned_offset=None, drop=None
                  ) -> torch.Tensor:
    """K7 on CUDA tensors (the CPU path is ``ops/hop_agg.py::
    hop_softmax_attention_plain``). z2 [N, H*d] bf16 or f32, scores
    [fanout, F, H] f32, ``drop`` attention dropout (``ops/dropout.py::
    AttnDrop``, its keep bits drawn in the kernels) or None -> [num_dst,
    H, d] f32, zero outside [offset, offset + F)."""
    _require(z2.is_cuda and scores.device == z2.device,
             f"hop_attention: z on {z2.device}, scores on {scores.device}")
    _require(z2.dim() == 2 and z2.dtype in (torch.bfloat16, torch.float32)
             and z2.shape[1] % heads == 0,
             f"hop_attention: z {z2.dtype} {tuple(z2.shape)}, heads {heads}")
    _attn_checks("hop_attention", fanout, heads, src_l, hop_offset,
                 z2.device)
    F = src_l.shape[0] // fanout
    _require(scores.dtype == torch.float32
             and tuple(scores.shape) == (fanout, F, heads),
             f"hop_attention: scores {scores.dtype} {tuple(scores.shape)}")
    _require(aligned_offset is None
             or aligned_offset + src_l.shape[0] <= z2.shape[0],
             "hop_attention: the aligned lanes run past z")
    if drop is not None:
        _require(drop.words.device == z2.device,
                 f"hop_attention: dropout key words on {drop.words.device}, "
                 f"z on {z2.device}")
    return HopAttention.apply(
        z2.contiguous(), scores.contiguous(), src_l.contiguous(), hop_offset,
        fanout, num_dst, heads,
        -1 if aligned_offset is None else int(aligned_offset), drop)


# ---------------------------------------------------------------------------
# K15 hop_mean (the hop aggregation; backward: hop_mean_grad on a gathered
# hop, its own kernel on an aligned one)
# ---------------------------------------------------------------------------

def hop_mean_checks(rows: torch.Tensor, src_l: torch.Tensor, fanout: int,
                    hop_offset: torch.Tensor, num_dst: int,
                    aligned_offset: Optional[int], ids: Optional[torch.Tensor]
                    ) -> None:
    """Raise ValueError for what K15 and its plain versions do not take:
    rows [N, d] bf16 or f32; src_l [fanout * F] int32 with F <= num_dst;
    hop_offset an int32 scalar on src_l's device; with ``ids`` (form (c)),
    ids [>= aligned_offset + E] int32 and an aligned_offset; the aligned
    lanes inside rows (form (b)) or ids (form (c)). Each message is built
    only when its check fails."""
    if not (rows.dim() == 2 and rows.dtype in (torch.bfloat16,
                                               torch.float32)):
        raise ValueError(f"hop_mean: rows {rows.dtype} {tuple(rows.shape)}")
    E = src_l.shape[0] if src_l.dim() == 1 else -1
    if not (fanout > 0 and E >= 0 and src_l.dtype == torch.int32
            and E % fanout == 0 and E // fanout <= num_dst):
        raise ValueError(f"hop_mean: src_l {src_l.dtype} "
                         f"{tuple(src_l.shape)}, fanout {fanout}, num_dst "
                         f"{num_dst}")
    if not (hop_offset.numel() == 1 and hop_offset.dtype == torch.int32
            and hop_offset.device == src_l.device):
        raise ValueError(f"hop_mean: hop_offset {hop_offset.dtype} "
                         f"{tuple(hop_offset.shape)} on {hop_offset.device}")
    if ids is not None:
        if not (aligned_offset is not None and ids.dim() == 1
                and ids.dtype == torch.int32
                and aligned_offset + E <= ids.shape[0]):
            raise ValueError(f"hop_mean: ids {ids.dtype} "
                             f"{tuple(ids.shape)} with the aligned offset "
                             f"{aligned_offset} and {E} lanes")
        if rows.requires_grad:
            raise ValueError("hop_mean: rows read through ids (the feature "
                             "table) take no gradient")
    elif aligned_offset is not None and aligned_offset + E > rows.shape[0]:
        raise ValueError("hop_mean: the aligned lanes run past rows")


def _hop_mean_launch(rows, src_l, ids, hop_offset, fanout, num_dst, aligned,
                     mean):
    """K15's launch: (out [num_dst, d], count [num_dst]) f32. Two
    allocations: one split into two views costs the host more (``chip_smoke.
    py::k15_host_parts`` times both)."""
    F = src_l.shape[0] // fanout
    d = rows.shape[1]
    out = torch.empty((num_dst, d), dtype=torch.float32, device=rows.device)
    count = torch.empty(num_dst, dtype=torch.float32, device=rows.device)
    rc = lib().lt_hop_mean(
        rows.data_ptr(), rows.shape[0], d, rows.dtype == torch.bfloat16,
        src_l.data_ptr(), None if ids is None else ids.data_ptr(), aligned,
        hop_offset.data_ptr(), F, fanout, num_dst, mean, out.data_ptr(),
        count.data_ptr(), stream_handle())
    check("hop_mean", rc)
    return out, count


class HopMean(torch.autograd.Function):
    """K15, out and count; the gradient of rows (never of count): the
    ``hop_mean_grad`` kernels on a gathered hop (summed in f32, written
    once in the rows' dtype), the ``hop_mean_bwd`` kernel on an aligned
    one."""

    @staticmethod
    def forward(ctx, rows, src_l, ids, hop_offset, fanout, num_dst, aligned,
                mean):
        out, count = _hop_mean_launch(rows, src_l, ids, hop_offset, fanout,
                                      num_dst, aligned, mean)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(src_l, hop_offset, count)
        ctx.cfg = (rows.shape, rows.dtype, fanout, num_dst, aligned, mean)
        return out, count

    @staticmethod
    def backward(ctx, dout, _dcount):
        src_l, hop_offset, count = ctx.saved_tensors
        shape, dtype, fanout, num_dst, aligned, mean = ctx.cfg
        E, d = src_l.shape[0], shape[1]
        F = E // fanout
        if dout.dtype != torch.float32:
            dout = dout.float()
        if not dout.is_contiguous():
            dout = dout.contiguous()
        if aligned >= 0:
            drows = torch.zeros(shape, dtype=dtype, device=dout.device)
            rc = lib().lt_hop_mean_bwd(
                dout.data_ptr(), count.data_ptr(), src_l.data_ptr(),
                hop_offset.data_ptr(), F, E, d, aligned, num_dst, int(mean),
                drows.data_ptr(), int(dtype == torch.bfloat16),
                stream_handle())
            check("hop_mean_bwd", rc)
            return (drows,) + (None,) * 7
        drows = hop_mean_grad(dout, src_l, shape[0], dtype, hop_offset, F,
                              count if mean else None)
        return (drows,) + (None,) * 7


def hop_mean(rows: torch.Tensor, src_l: torch.Tensor, fanout: int,
             hop_offset: torch.Tensor, num_dst: int,
             aligned_offset: Optional[int] = None,
             ids: Optional[torch.Tensor] = None, mean: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15 on CUDA tensors (the CPU path is ``ops/hop_agg.py::
    hop_neighbor_sum_plain``): (out [num_dst, d] f32, count [num_dst]
    f32), out the sum (or with ``mean`` the mean) of each frontier slot's
    valid rows at [offset, offset + F), zero elsewhere. A lane's row is
    rows[src_l[lane]] (form (a)), rows[aligned_offset + lane] (b), or
    rows[ids[aligned_offset + lane]] (c: rows is the feature table). Goes
    through the autograd Function only when rows takes a gradient."""
    hop_mean_checks(rows, src_l, fanout, hop_offset, num_dst,
                    aligned_offset, ids)
    dev = rows.get_device()
    if not (dev >= 0 and src_l.get_device() == dev
            and hop_offset.get_device() == dev
            and (ids is None or ids.get_device() == dev)):
        on = [rows, src_l, hop_offset] + ([] if ids is None else [ids])
        raise ValueError("hop_mean: inputs on "
                         + ", ".join(str(t.device) for t in on))
    if rows.shape[0] == 0:
        raise ValueError("hop_mean: no rows")
    if ids is not None:
        # the kernel reads the hop's lanes of ids from their start
        E = src_l.shape[0]
        ids = ids[aligned_offset:aligned_offset + E]
        if not ids.is_contiguous():
            ids = ids.contiguous()
        aligned = -1
    else:
        aligned = -1 if aligned_offset is None else int(aligned_offset)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not src_l.is_contiguous():
        src_l = src_l.contiguous()
    if rows.requires_grad and torch.is_grad_enabled():
        return HopMean.apply(rows, src_l, ids, hop_offset, fanout, num_dst,
                             aligned, bool(mean))
    return _hop_mean_launch(rows, src_l, ids, hop_offset, fanout, num_dst,
                            aligned, bool(mean))


@functools.lru_cache(maxsize=64)
def _grad_scratch_words(S: int, E: int, d: int, F: int) -> int:
    return lib().lt_hop_mean_grad_scratch(S, E, d, F)


def hop_mean_grad(dout: torch.Tensor, src_l: torch.Tensor, num_rows: int,
                  dtype: torch.dtype, hop_offset: torch.Tensor, F: int,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15's backward on a gathered hop (form (a)), on CUDA tensors (the
    plain version is ``ops/hop_agg.py::hop_mean_grad_plain``): d rows
    [num_rows, d] in ``dtype`` (bf16 or f32), row r the f32 sum, in
    ascending lane order, of dout[offset + lane % F] over the valid lanes
    of src_l [fanout * F] int32 that read r (a src past the rows reads the
    last row, as the forward does), each divided by max(count[offset +
    lane % F], 1) when ``count`` (the mean's) is given; offset placed as
    the forward places it. dout [num_dst, d] f32 contiguous. Every row
    written once, the same bits from run to run."""
    dev = dout.get_device()
    if not (dev >= 0 and dout.dtype == torch.float32 and dout.dim() == 2
            and dout.is_contiguous() and src_l.get_device() == dev
            and src_l.dtype == torch.int32 and src_l.dim() == 1
            and src_l.is_contiguous() and hop_offset.get_device() == dev
            and hop_offset.dtype == torch.int32
            and dtype in (torch.bfloat16, torch.float32) and num_rows > 0
            and 0 < F <= dout.shape[0] and src_l.shape[0] % F == 0
            and (count is None or (count.get_device() == dev
                                   and count.dtype == torch.float32
                                   and count.shape == dout.shape[:1]))):
        raise ValueError(
            f"hop_mean_grad: dout {dout.dtype} {tuple(dout.shape)} on "
            f"{dout.device}, src_l {src_l.dtype} {tuple(src_l.shape)} on "
            f"{src_l.device}, {num_rows} rows of {dtype}, F {F}")
    dev = dout.device
    E, d = src_l.shape[0], dout.shape[1]
    scratch = torch.empty(_grad_scratch_words(num_rows, E, d, F),
                          dtype=torch.int32, device=dev)
    drows = torch.empty((num_rows, d), dtype=dtype, device=dev)
    rc = lib().lt_hop_mean_grad(
        dout.data_ptr(), None if count is None else count.data_ptr(),
        src_l.data_ptr(), E, hop_offset.data_ptr(), F, dout.shape[0],
        num_rows, d, scratch.data_ptr(), drows.data_ptr(),
        dtype == torch.bfloat16, stream_handle())
    check("hop_mean_grad", rc)
    return drows


def lanes_by_source(src_l: torch.Tensor, num_rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouping ``hop_mean_grad`` runs first, alone, on CUDA tensors
    (the plain version is ``ops/hop_agg.py::lanes_by_source_plain``):
    (lanes, starts) int32, the valid lanes of src_l grouped by the row
    they read (src clamped to num_rows - 1), each group in ascending lane
    order, group r lanes[starts[r]:starts[r + 1]]. For holding the kernels
    against the plain version; on no path, not counted in ``LAUNCHES``."""
    if not (src_l.is_cuda and src_l.dtype == torch.int32
            and src_l.dim() == 1 and num_rows > 0):
        raise ValueError(f"lanes_by_source: src_l {src_l.dtype} "
                         f"{tuple(src_l.shape)} on {src_l.device}")
    src_l = src_l.contiguous()
    E, dev = src_l.shape[0], src_l.device
    scratch = torch.empty(_grad_scratch_words(num_rows, E, 1, 0),
                          dtype=torch.int32, device=dev)
    lanes = torch.empty(max(E, 1), dtype=torch.int32, device=dev)
    at = torch.empty(num_rows, dtype=torch.int32, device=dev)
    cnt = torch.empty(num_rows, dtype=torch.int32, device=dev)
    _check_probe("lanes_by_source", lib().lt_lanes_by_source(
        src_l.data_ptr(), E, num_rows, scratch.data_ptr(), lanes.data_ptr(),
        at.data_ptr(), cnt.data_ptr(), stream_handle()))
    # the kernels keep the runs of more than 32 lanes after the others
    return runs_in_order(lanes, at, cnt)


def runs_in_order(lanes: torch.Tensor, at: torch.Tensor, cnt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A grouping's runs (row r's lanes[at[r]:at[r] + cnt[r]]) read back
    in row order: (lanes, starts) int32, as the plain versions give it."""
    dev = lanes.device
    starts = torch.zeros(cnt.shape[0] + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(cnt, 0)
    n = cnt.long()
    k = torch.arange(int(starts[-1]), device=dev) - torch.repeat_interleave(
        starts[:-1], n)
    idx = torch.repeat_interleave(at.long(), n) + k
    return lanes[idx], starts.to(torch.int32)
