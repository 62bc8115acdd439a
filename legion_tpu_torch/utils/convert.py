"""Converters from the JAX package's objects to the port's, with explicit
dtypes. They take numpy arrays, or anything ``np.asarray`` accepts (JAX
arrays included), and never import JAX. Integer arrays may arrive as
int64 (the JAX package turns on x64); bf16 arrays arrive as
``ml_dtypes.bfloat16`` and are widened to f32 on the host, which is exact.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Dict

import numpy as np
import torch

from legion_tpu_torch.cache.unified_cache import UnifiedCache
from legion_tpu_torch.config import DatasetMeta
from legion_tpu_torch.data.device_synthetic import DeviceDataset
from legion_tpu_torch.data.format import LegionDataset
from legion_tpu_torch.graph import CSRGraph
from legion_tpu_torch.sampling.sampler import SampleBatch


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_jax(tree, device: torch.device = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """``{"layers": [{name: array, ...}, ...]}`` of any of the four models
    -> the port's ``state_dict``: every array of layer i under
    ``layers.{i}.{name}``, f32, in its own shape (GAT's ``w`` stays
    [d_in, H, d_out]; padded arrays are copied as they are)."""
    return {f"layers.{i}.{name}": _f32(arr, device)
            for i, layer in enumerate(tree["layers"])
            for name, arr in layer.items()}


def batch_from_jax(batch, device: torch.device = "cpu") -> SampleBatch:
    """A JAX ``SampleBatch`` (fields as arrays) -> the port's, int32."""
    return SampleBatch(
        node_ids=_i32(batch.node_ids, device),
        num_nodes=_i32(batch.num_nodes, device),
        edge_src=tuple(_i32(e, device) for e in batch.edge_src),
        edge_dst=tuple(_i32(e, device) for e in batch.edge_dst),
        num_edges=_i32(batch.num_edges, device),
        hop_offsets=_i32(batch.hop_offsets, device))


def dataset_from_jax(ds, device: torch.device = "cpu") -> DeviceDataset:
    """A JAX ``DeviceDataset`` -> the port's, on ``device``. ``meta`` is
    rebuilt as the port's own ``DatasetMeta`` from the same fields."""
    return DeviceDataset.from_numpy(
        meta=DatasetMeta(**asdict(ds.meta)),
        indptr=np.asarray(ds.csr.indptr), indices=np.asarray(ds.csr.indices),
        features=np.asarray(ds.features).astype(np.float32),
        labels=np.asarray(ds.labels), train_ids=np.asarray(ds.train_ids),
        valid_ids=np.asarray(ds.valid_ids), test_ids=np.asarray(ds.test_ids),
        device=device)


def legion_dataset_from_jax(ds) -> LegionDataset:
    """A JAX host ``LegionDataset`` -> the port's, over the same numpy
    arrays (nothing is copied; the data stays on the host)."""
    return LegionDataset(
        meta=DatasetMeta(**asdict(ds.meta)),
        graph=CSRGraph(indptr=ds.graph.indptr, indices=ds.graph.indices),
        features=ds.features, labels=ds.labels, train_ids=ds.train_ids,
        valid_ids=ds.valid_ids, test_ids=ds.test_ids,
        partition=ds.partition)


def cache_from_jax(cache, device: torch.device = "cpu") -> UnifiedCache:
    """A JAX ``UnifiedCache`` -> the port's, on ``device``: the same rows
    (bf16 stays bf16, exactly), maps and sub-CSR."""
    def opt(a, fn):
        return None if a is None else fn(a)

    def rows(a):
        arr = np.asarray(a)
        t = _f32(arr, device)
        return t.to(torch.bfloat16) if arr.dtype.name == "bfloat16" else t

    return UnifiedCache(
        cache_rows=opt(cache.cache_rows, rows),
        slot_map=opt(cache.slot_map, lambda a: _i32(a, device)),
        sub_indptr=opt(cache.sub_indptr, lambda a: torch.from_numpy(
            np.array(a, dtype=np.int64)).to(device)),
        sub_indices=opt(cache.sub_indices, lambda a: _i32(a, device)),
        row_map=opt(cache.row_map, lambda a: _i32(a, device)),
        feature_capacity=cache.feature_capacity,
        topo_capacity=cache.topo_capacity)
