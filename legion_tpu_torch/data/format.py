"""Legion binary dataset format IO (copy of ``legion_tpu/data/format.py``).

File contract (reference dataset/README.md:3-10 and the mmap readers in
storage_management_impl.cuh:46-159):

  <path>/edge_src        int64  raw, CSR indptr, length V+1
  <path>/edge_dst        int32  raw, CSR indices, length E
  <path>/features        float32 raw, V x feature_dim
  <path>/labels          int32  raw, length V
  <path>/trainingset     int32  raw seed ids
  <path>/validationset   int32  raw seed ids
  <path>/testingset      int32  raw seed ids
  <path>/partition       int32  raw, per-vertex partition id (optional;
                         falls back to id % partition_count like
                         storage_management.cu:205-218)

All arrays are read as numpy memmaps so billion-scale files never have to fit
in RAM at once (the reference used mmap + pinned copies for the same reason).
The memmaps are read-only. In host mode the trainer copies each table that
the kernels read in place (the features, and with the topology on the host
the CSR) into RAM once and registers the copy (``train.py::in_ram``,
``ops/host_memory.py``); pinning would lock the same pages anyway. Arrays
that go to the card are streamed from the memmaps as they are.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from legion_tpu_torch.config import DatasetMeta
from legion_tpu_torch.graph import CSRGraph

FILE_NAMES = dict(
    indptr="edge_src",
    indices="edge_dst",
    features="features",
    labels="labels",
    train="trainingset",
    valid="validationset",
    test="testingset",
    partition="partition",
)


def _mmap(path: str, dtype, shape=None) -> np.ndarray:
    arr = np.memmap(path, dtype=dtype, mode="r")
    if shape is not None:
        arr = arr.reshape(shape)
    return arr


@dataclass
class LegionDataset:
    """A loaded (mmap-backed) Legion-format dataset, held on the host."""

    meta: DatasetMeta
    graph: CSRGraph
    features: np.ndarray       # [V, F] float32
    labels: np.ndarray         # [V] int32
    train_ids: np.ndarray      # int32
    valid_ids: np.ndarray
    test_ids: np.ndarray
    partition: Optional[np.ndarray] = None  # [V] int32 or None

    @classmethod
    def load(cls, meta: DatasetMeta) -> "LegionDataset":
        p = meta.path
        f = lambda k: os.path.join(p, FILE_NAMES[k])  # noqa: E731
        indptr = np.asarray(_mmap(f("indptr"), np.int64))
        assert indptr.shape[0] == meta.num_nodes + 1, (
            f"edge_src has {indptr.shape[0]} entries, expected "
            f"{meta.num_nodes + 1}")
        indices = _mmap(f("indices"), np.int32)
        graph = CSRGraph(indptr=indptr, indices=np.asarray(indices))
        features = _mmap(f("features"), np.float32,
                         (meta.num_nodes, meta.feature_dim))
        labels = _mmap(f("labels"), np.int32)
        train_ids = np.asarray(_mmap(f("train"), np.int32))[:meta.train_size]
        valid_ids = np.asarray(_mmap(f("valid"), np.int32))[:meta.valid_size]
        test_ids = np.asarray(_mmap(f("test"), np.int32))[:meta.test_size]
        partition = None
        if os.path.exists(f("partition")):
            partition = np.asarray(_mmap(f("partition"), np.int32))
        return cls(meta=meta, graph=graph, features=features, labels=labels,
                   train_ids=train_ids, valid_ids=valid_ids,
                   test_ids=test_ids, partition=partition)

    def partition_of(self, ids: np.ndarray, partition_count: int
                     ) -> np.ndarray:
        """Partition assignment; falls back to id % count like
        storage_management.cu:205-218 when no partition file exists."""
        if self.partition is not None:
            return self.partition[ids]
        return ids % partition_count

    def seeds_for_partition(self, which: str, part: int, partition_count: int
                            ) -> np.ndarray:
        ids = {"train": self.train_ids, "valid": self.valid_ids,
               "test": self.test_ids}[which]
        if partition_count <= 1:
            return ids
        return ids[self.partition_of(ids, partition_count) == part]


def infer_meta(path: str, batch_size: int = 8000, cache_bytes: int = 0,
               epochs: int = 1, name: str = "custom",
               num_classes: Optional[int] = None) -> DatasetMeta:
    """Build a DatasetMeta for a Legion-format directory by probing the
    files themselves: V from edge_src bytes, E from edge_dst, feat dim
    from features/V, set sizes from the seed files, classes from a label
    scan over the seed vertices (negative labels are ignored)."""
    f = lambda k: os.path.join(path, FILE_NAMES[k])  # noqa: E731
    sz = lambda k: os.path.getsize(f(k))  # noqa: E731
    V = sz("indptr") // 8 - 1
    E = sz("indices") // 4
    F = sz("features") // (4 * V)
    assert F * 4 * V == sz("features"), (
        f"features size {sz('features')} not divisible by V={V} rows")
    if num_classes is None:
        labels = _mmap(f("labels"), np.int32)
        seed_ids = np.concatenate([
            np.asarray(_mmap(f(k), np.int32)) for k in
            ("train", "valid", "test")])
        seed_labels = labels[seed_ids] if len(seed_ids) else labels
        seed_labels = seed_labels[seed_labels >= 0]
        assert len(seed_labels), f"no non-negative seed labels under {path}"
        num_classes = int(seed_labels.max()) + 1
    return DatasetMeta(
        path=path, batch_size=batch_size, num_nodes=V, num_edges=E,
        feature_dim=F, train_size=sz("train") // 4,
        valid_size=sz("valid") // 4, test_size=sz("test") // 4,
        cache_bytes=cache_bytes, epochs=epochs,
        num_classes=num_classes, name=name)


def write_legion_dataset(path: str, graph: CSRGraph, features: np.ndarray,
                         labels: np.ndarray, train_ids: np.ndarray,
                         valid_ids: np.ndarray, test_ids: np.ndarray,
                         partition: Optional[np.ndarray] = None) -> None:
    """Write arrays in Legion's raw binary layout."""
    os.makedirs(path, exist_ok=True)
    f = lambda k: os.path.join(path, FILE_NAMES[k])  # noqa: E731
    graph.indptr.astype(np.int64).tofile(f("indptr"))
    graph.indices.astype(np.int32).tofile(f("indices"))
    np.ascontiguousarray(features, dtype=np.float32).tofile(f("features"))
    np.asarray(labels, dtype=np.int32).tofile(f("labels"))
    np.asarray(train_ids, dtype=np.int32).tofile(f("train"))
    np.asarray(valid_ids, dtype=np.int32).tofile(f("valid"))
    np.asarray(test_ids, dtype=np.int32).tofile(f("test"))
    if partition is not None:
        np.asarray(partition, dtype=np.int32).tofile(f("partition"))
