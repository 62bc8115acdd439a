"""Host-side synthetic graph and feature generator (copy of
``legion_tpu/data/synthetic.py``).

A power-law graph with community structure: labels follow communities and
features are noisy class prototypes, so a GNN learns from both features
and topology. The same seed gives the same arrays as the JAX package's
generator (both draw from ``np.random.default_rng``). The dataset lives in
host RAM; the trainer reads it in place (``LegionDataset``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from legion_tpu_torch.config import DatasetMeta
from legion_tpu_torch.data.format import LegionDataset
from legion_tpu_torch.graph import CSRGraph


def powerlaw_community_graph(
    num_nodes: int,
    avg_degree: int,
    num_classes: int,
    rng: np.random.Generator,
    intra_prob: float = 0.8,
    alpha: float = 1.6,
) -> Tuple[CSRGraph, np.ndarray]:
    """Power-law degree graph with community-biased edges.

    Returns (graph, labels). Destinations follow a Zipf-like popularity
    over a permuted id space (hot vertices exist, which is what makes the
    hotness cache meaningful); with probability ``intra_prob`` the
    destination is resampled within the source's community. Sources are
    uniform, so nearly every vertex has out-edges to sample from.
    """
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    num_edges = num_nodes * avg_degree

    perm = rng.permutation(num_nodes)
    src = rng.integers(0, num_nodes, size=num_edges)
    if num_edges > 5_000_000:
        # inverse-CDF power-law rank sampling (rng.choice's cumsum path is
        # too slow at 10^8 edges): rank ~ u^{1/(1-alpha)} truncated
        u = rng.random(num_edges)
        ranks_f = (num_nodes + 1.0) ** (1.0 - alpha) + u * (
            1.0 - (num_nodes + 1.0) ** (1.0 - alpha))
        dst_rank = np.minimum(
            (ranks_f ** (1.0 / (1.0 - alpha))).astype(np.int64) - 1,
            num_nodes - 1)
        dst = perm[dst_rank]
    else:
        ranks = np.arange(num_nodes, dtype=np.float64)
        probs = (ranks + 1.0) ** (-alpha)
        probs /= probs.sum()
        dst = perm[rng.choice(num_nodes, size=num_edges, p=probs)]

    # community bias: rewire a fraction of destinations into the source's
    # community by shifting to a same-label node
    same = rng.random(num_edges) < intra_prob
    order = np.argsort(labels, kind="stable")
    label_starts = np.searchsorted(labels[order], np.arange(num_classes))
    label_counts = np.bincount(labels, minlength=num_classes)
    lab = labels[src[same]]
    offs = (rng.random(same.sum()) * label_counts[lab]).astype(np.int64)
    dst[same] = order[label_starts[lab] + offs]

    graph = CSRGraph.from_edges(src, dst, num_nodes)
    return graph, labels


def class_prototype_features(labels: np.ndarray, feature_dim: int,
                             num_classes: int, rng: np.random.Generator,
                             noise: float = 1.0) -> np.ndarray:
    prototypes = rng.standard_normal((num_classes, feature_dim)).astype(
        np.float32)
    feats = prototypes[labels] + noise * rng.standard_normal(
        (labels.shape[0], feature_dim)).astype(np.float32)
    return feats.astype(np.float32)


def synthesize_dataset(
    num_nodes: int = 20_000,
    avg_degree: int = 16,
    feature_dim: int = 64,
    num_classes: int = 8,
    batch_size: int = 512,
    train_frac: float = 0.1,
    valid_frac: float = 0.02,
    test_frac: float = 0.02,
    seed: int = 0,
    path: str = "synthetic://",
    epochs: int = 1,
) -> LegionDataset:
    """Build an in-memory LegionDataset (no files written)."""
    rng = np.random.default_rng(seed)
    graph, labels = powerlaw_community_graph(num_nodes, avg_degree,
                                             num_classes, rng)
    features = class_prototype_features(labels, feature_dim, num_classes, rng)

    ids = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    n_valid = int(num_nodes * valid_frac)
    n_test = int(num_nodes * test_frac)
    train_ids = ids[:n_train]
    valid_ids = ids[n_train:n_train + n_valid]
    test_ids = ids[n_train + n_valid:n_train + n_valid + n_test]

    meta = DatasetMeta(
        path=path, batch_size=batch_size, num_nodes=num_nodes,
        num_edges=graph.num_edges, feature_dim=feature_dim,
        train_size=n_train, valid_size=n_valid, test_size=n_test,
        num_classes=num_classes, name="synthetic", epochs=epochs)
    return LegionDataset(meta=meta, graph=graph, features=features,
                         labels=labels.astype(np.int32),
                         train_ids=train_ids, valid_ids=valid_ids,
                         test_ids=test_ids)
