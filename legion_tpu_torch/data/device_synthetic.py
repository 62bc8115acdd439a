"""On-device synthetic dataset generation (port of
``legion_tpu/data/device_synthetic.py``).

The same recipe, run on the target device with a ``torch.Generator``:
uniform sources, inverse-CDF power-law destination ranks, a multiplicative
bijection that scatters hot ranks over the id space, a self-loop shift that
keeps E static, then a stable sort by source and ``searchsorted`` into CSR.
Features are one prototype per class plus unit Gaussian noise. The bits
differ from JAX's threefry stream; the structure does not.
``DeviceDataset.from_numpy`` loads arrays made elsewhere (for example by
the JAX generator, see ``utils/convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from legion_tpu_torch.config import DatasetMeta
from legion_tpu_torch.graph import DeviceCSR, offset_dtype


def _coprime(v: int) -> int:
    p = 1_000_003
    while math.gcd(p, v) != 1:
        p += 2
    return p


def _gen_graph(gen: torch.Generator, V: int, E: int, alpha: float,
               scramble: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    src = torch.randint(0, V, (E,), dtype=torch.int32, generator=gen,
                        device=device)
    u = torch.rand((E,), dtype=torch.float32, generator=gen, device=device)
    # inverse-CDF power-law rank popularity q(r) ~ r^-alpha (alpha < 1):
    # r = V * u^(1/(1-alpha)); alpha=0.8 puts ~40% of edges on the top 1%
    dst_rank = (V * u.pow_(1.0 / (1.0 - alpha))).to(torch.int32).clamp_(
        0, V - 1)
    del u
    # the scramble product needs 64 bits (V * prime > 2**31)
    dst = ((dst_rank.to(torch.int64) * scramble) % V).to(torch.int32)
    del dst_rank
    dst = torch.where(dst == src, (dst + 1) % V, dst)
    src_s, order = torch.sort(src, stable=True)
    del src
    dst_s = dst[order]
    del dst, order
    indptr = torch.searchsorted(
        src_s, torch.arange(V + 1, dtype=torch.int32, device=device))
    return indptr.to(offset_dtype(E)), dst_s


def _gen_features(gen: torch.Generator, V: int, feat_dim: int,
                  num_classes: int, scramble: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    labels = ((torch.arange(V, dtype=torch.int64, device=device) * scramble)
              % num_classes).to(torch.int32)
    protos = torch.randn((num_classes, feat_dim), dtype=torch.float32,
                         generator=gen, device=device)
    feats = torch.randn((V, feat_dim), dtype=torch.float32, generator=gen,
                        device=device)
    feats += protos[labels.long()]
    return feats, labels


@dataclass
class DeviceDataset:
    """Device-resident dataset implementing the Trainer protocol."""

    meta: DatasetMeta
    csr: DeviceCSR
    features: torch.Tensor   # [V, feature_dim] float32
    labels: torch.Tensor     # [V] int32
    train_ids: np.ndarray
    valid_ids: np.ndarray
    test_ids: np.ndarray

    def device_arrays(self):
        return self.csr, self.features, self.labels

    def seed_sets(self, n_dev: int
                  ) -> Tuple[List[np.ndarray], List[np.ndarray],
                             List[np.ndarray]]:
        def split(ids):
            if n_dev == 1:
                return [ids]
            return [ids[ids % n_dev == d] for d in range(n_dev)]
        return split(self.train_ids), split(self.valid_ids), \
            split(self.test_ids)

    @classmethod
    def from_numpy(cls, meta: DatasetMeta, indptr: np.ndarray,
                   indices: np.ndarray, features: np.ndarray,
                   labels: np.ndarray, train_ids: np.ndarray,
                   valid_ids: np.ndarray, test_ids: np.ndarray,
                   device: torch.device) -> "DeviceDataset":
        """Place host arrays on ``device`` with the port's dtypes."""
        return cls(
            meta=meta,
            csr=DeviceCSR.from_numpy(indptr, indices, device),
            features=torch.tensor(
                np.asarray(features, np.float32)).to(device),
            labels=torch.tensor(
                np.asarray(labels, np.int32)).to(device),
            train_ids=np.asarray(train_ids, np.int32),
            valid_ids=np.asarray(valid_ids, np.int32),
            test_ids=np.asarray(test_ids, np.int32))


def seed_ids(num_nodes: int, n_train: int, valid_size: int,
             test_size: int) -> np.ndarray:
    """Disjoint distinct seed ids through the multiplicative bijection."""
    p = _coprime(num_nodes)
    all_ids = (np.arange(n_train + valid_size + test_size,
                         dtype=np.int64) * p) % num_nodes
    return all_ids.astype(np.int32)


def synthesize_device_dataset(
    device: torch.device,
    num_nodes: int = 2_400_000,
    num_edges: int = 120_000_000,
    feature_dim: int = 100,
    num_classes: int = 32,
    batch_size: int = 8000,
    train_frac: float = 0.08,
    valid_size: int = 20_000,
    test_size: int = 20_000,
    alpha: float = 0.8,
    seed: int = 0,
) -> DeviceDataset:
    device = torch.device(device)
    scramble = _coprime(num_nodes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    indptr, indices = _gen_graph(gen, num_nodes, num_edges, alpha, scramble,
                                 device)
    feats, labels = _gen_features(gen, num_nodes, feature_dim, num_classes,
                                  scramble, device)
    csr = DeviceCSR(indptr=indptr, indices=indices, num_nodes=num_nodes,
                    num_edges=num_edges)
    n_train = int(num_nodes * train_frac)
    all_ids = seed_ids(num_nodes, n_train, valid_size, test_size)
    meta = DatasetMeta(
        path="device://synthetic", batch_size=batch_size,
        num_nodes=num_nodes, num_edges=num_edges, feature_dim=feature_dim,
        train_size=n_train, valid_size=valid_size, test_size=test_size,
        num_classes=num_classes, name="device_synthetic")
    return DeviceDataset(
        meta=meta, csr=csr, features=feats, labels=labels,
        train_ids=all_ids[:n_train],
        valid_ids=all_ids[n_train:n_train + valid_size],
        test_ids=all_ids[n_train + valid_size:])
