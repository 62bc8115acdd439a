"""Device-resident CSR graph (port of ``legion_tpu/graph.py::DeviceCSR``).

Offsets (``indptr``) are int32 while the edge count fits int32 and int64
above, as ``CSRGraph.to_device`` decides (``legion_tpu/graph.py:76-77``):
the narrow offsets halve the sampler's offset traffic. Indices are int32.
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
