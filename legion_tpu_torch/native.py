"""NumPy counterparts of the host tools of ``legion_tpu/native`` (the
dataset side of ``native/src/legion_native.cpp``): CSR from an edge list,
the streaming LDG partitioner and the text edge-list converter.

Each function writes the same bytes as the C++ function it stands for, so
a dataset prepared by either package loads in both. There is no C++ and
no ctypes here: the port's host gathers and draws are the kernels K4 and
K5, which read pinned host memory from the card, so only the offline
tools need a host implementation. ``partition_ldg`` is sequential by
nature (each vertex's choice reads the choices before it): a Python loop
over the vertices, slow at large V.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from legion_tpu_torch.graph import CSRGraph


def edges_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr int64 [V+1], indices int32) from edge arrays, as
    ``lg_edges_to_csr``: self-loops and edges with an endpoint outside
    [0, num_nodes) are dropped, and the edges of a source keep their input
    order."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = (src != dst) & (src >= 0) & (src < num_nodes) & (dst >= 0) \
        & (dst < num_nodes)
    g = CSRGraph.from_edges(src[keep], dst[keep], num_nodes,
                            drop_self_loops=False)
    return g.indptr, g.indices


def partition_ldg(indptr: np.ndarray, indices: np.ndarray, n_parts: int,
                  passes: int = 2) -> np.ndarray:
    """Streaming Linear Deterministic Greedy partitioning -> [V] int32 part
    ids, as ``lg_partition_ldg``: every vertex starts unplaced (-1); in
    each pass a vertex leaves its part, then joins the part p with the
    largest cnt[p] * (1 - size[p] / cap) (cnt: its neighbours placed in
    p; cap = V / n_parts * 1.05 + 1, all in double), a tie going to the
    smaller part and then to the lower id."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    V = indptr.shape[0] - 1
    part = np.full(V, -1, np.int32)
    size = np.zeros(n_parts, np.int64)
    cap = float(V) / n_parts * 1.05 + 1.0
    for _ in range(passes):
        for v in range(V):
            nb = part[indices[indptr[v]:indptr[v + 1]]]
            cnt = np.bincount(nb[nb >= 0], minlength=n_parts)
            old = part[v]
            if old >= 0:
                size[old] -= 1
            score = cnt.astype(np.float64) * (1.0 - size / cap)
            best, best_score = 0, -1e300
            for p in range(n_parts):
                s = score[p]
                if s > best_score or (s == best_score
                                      and size[p] < size[best]):
                    best, best_score = p, s
            part[v] = best
            size[best] += 1
    return part


def _parse_edgelist(data: bytes) -> np.ndarray:
    """[n, 2] int64 raw id pairs of a text edge list, read as
    ``lg_convert_edgelist`` reads it: whitespace-separated signed integers,
    two to an edge; the second id of an edge is on the first id's line (a
    line that ends after the first id gives the edge (id, 0))."""
    pairs = []
    for line in data.replace(b"\r", b"\n").split(b"\n"):
        toks = line.split()
        if len(toks) % 2:
            toks.append(b"0")
        pairs.extend(toks)
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.array([int(t) for t in pairs], np.int64).reshape(-1, 2)


def convert_edgelist(in_path: str, out_dir: str) -> Tuple[int, int]:
    """Text edge list -> Legion ``edge_src`` (int64 indptr) and
    ``edge_dst`` (int32 indices) under ``out_dir``, as
    ``lg_convert_edgelist``: an edge whose two raw ids are equal is
    skipped, raw ids are numbered in order of first appearance (an edge's
    first id before its second), and the CSR is ``edges_to_csr``'s.
    Returns (num_nodes, num_edges)."""
    with open(in_path, "rb") as f:
        raw = _parse_edgelist(f.read())
    raw = raw[raw[:, 0] != raw[:, 1]]
    flat = raw.reshape(-1)
    uniq, first, inverse = np.unique(flat, return_index=True,
                                     return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    ids = rank[inverse].reshape(-1, 2)
    n_nodes = len(uniq)
    indptr, indices = edges_to_csr(ids[:, 0], ids[:, 1], n_nodes)
    os.makedirs(out_dir, exist_ok=True)
    indptr.tofile(os.path.join(out_dir, "edge_src"))
    indices.tofile(os.path.join(out_dir, "edge_dst"))
    return n_nodes, int(indices.shape[0])
