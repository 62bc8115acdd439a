"""CSR graph containers (port of ``legion_tpu/graph.py``).

``CSRGraph`` is the host-resident CSR in numpy, the authoritative storage
of a host dataset (int64 offsets, int32 indices, as the reference's
``edge_src``/``edge_dst`` files). It is a copy of the JAX package's class,
not an import of it. ``DeviceCSR`` is a CSR on one device: offsets
(``indptr``) are int32 while the edge count fits int32 and int64 above, as
``CSRGraph.to_device`` decides (``legion_tpu/graph.py:76-77``): the narrow
offsets halve the sampler's offset traffic. Indices are int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1


def offset_dtype(num_edges: int) -> torch.dtype:
    """CSR offset dtype for a graph of ``num_edges`` edges."""
    return torch.int32 if num_edges < INT32_MAX else torch.int64


@dataclass
class CSRGraph:
    """Host-resident CSR. indptr: int64 [V+1]; indices: int32 [E]."""

    indptr: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr.dtype == np.int64
        assert self.indices.dtype == np.int32

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        """v's out-neighbours: a view of ``indices``."""
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   drop_self_loops: bool = True) -> "CSRGraph":
        """CSR from an edge list, self-loops dropped."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if drop_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=num_nodes).astype(np.int64)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, indices=dst.astype(np.int32))

    def to_device(self, device: torch.device) -> "DeviceCSR":
        """A copy of the whole graph on ``device``."""
        return DeviceCSR.from_numpy(self.indptr, self.indices, device)


@dataclass
class DeviceCSR:
    """CSR on one device (full graph)."""

    indptr: torch.Tensor   # [V+1] int32 or int64
    indices: torch.Tensor  # [E] int32
    num_nodes: int
    num_edges: int

    @classmethod
    def from_numpy(cls, indptr: np.ndarray, indices: np.ndarray,
                   device: torch.device) -> "DeviceCSR":
        num_edges = int(indices.shape[0])
        odt = np.int32 if offset_dtype(num_edges) == torch.int32 \
            else np.int64
        return cls(
            indptr=torch.tensor(
                np.asarray(indptr, dtype=odt)).to(device),
            indices=torch.tensor(
                np.asarray(indices, dtype=np.int32)).to(device),
            num_nodes=int(indptr.shape[0]) - 1, num_edges=num_edges)

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]
