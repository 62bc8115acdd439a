"""A learnable synthetic graph for accuracy runs (copy of
``examples/ab_accuracy.py::homophilous_dataset``).

About ``p_intra`` of the edges join two vertices of one class, and the
features are weak class prototypes under unit noise, so the class signal
lives mostly in the neighbourhood: aggregating neighbours raises accuracy
well above a features-only classifier, and sampling faults show up in it.
The same seed gives the same arrays as the example's (both draw from
``np.random.default_rng``); the dataset lives in host RAM.
"""

from __future__ import annotations

import numpy as np

from legion_tpu_torch.config import DatasetMeta
from legion_tpu_torch.data.format import LegionDataset
from legion_tpu_torch.graph import CSRGraph


def homophilous_dataset(num_nodes: int, avg_degree: int, feature_dim: int,
                        num_classes: int, batch_size: int, seed: int = 0,
                        p_intra: float = 0.7) -> LegionDataset:
    """Synthetic graph where ~p_intra of edges connect same-class vertices
    — neighbor aggregation then genuinely improves over feature-only
    classification, so sampling-quality differences show up in accuracy."""
    rng = np.random.default_rng(seed)
    V, E = num_nodes, num_nodes * avg_degree
    labels = rng.integers(0, num_classes, V).astype(np.int32)
    by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    src = rng.integers(0, V, E)
    intra = rng.random(E) < p_intra
    dst = np.empty(E, np.int64)
    for c in range(num_classes):
        m = intra & (labels[src] == c)
        dst[m] = rng.choice(by_class[c], m.sum())
    dst[~intra] = rng.integers(0, V, (~intra).sum())
    # weak node features: class signal mostly lives in the neighborhood
    protos = rng.standard_normal((num_classes, feature_dim)).astype(
        np.float32)
    feats = 0.4 * protos[labels] + rng.standard_normal(
        (V, feature_dim)).astype(np.float32)

    graph = CSRGraph.from_edges(np.concatenate([src, dst]),
                                np.concatenate([dst, src]), V)
    ids = rng.permutation(V).astype(np.int32)
    n_tr, n_va, n_te = int(V * 0.1), int(V * 0.05), int(V * 0.05)
    meta = DatasetMeta(path="mem://ab", batch_size=batch_size,
                       num_nodes=V, num_edges=graph.num_edges,
                       feature_dim=feature_dim, train_size=n_tr,
                       valid_size=n_va, test_size=n_te,
                       num_classes=num_classes, name="ab_homophilous")
    return LegionDataset(
        meta=meta, graph=graph, features=feats, labels=labels,
        train_ids=ids[:n_tr], valid_ids=ids[n_tr:n_tr + n_va],
        test_ids=ids[n_tr + n_va:n_tr + n_va + n_te])
