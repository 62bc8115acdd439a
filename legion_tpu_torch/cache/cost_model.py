"""Cache cost model: split cache bytes between the feature and topology
caches (copy of the NumPy core of ``legion_tpu/cache/cost_model.py``).

Reference parity: UnifiedCache::CandidateSelection + CostModel
(cache.cu:360-551). The sweep steps alpha, the fraction of the budget
given to feature rows, by ``alpha_step`` and keeps the split that
maximises the estimated host bytes saved per presampled step:

  feat_saved(c)  = sum of the c hottest vertices' batch-hit counts
                   x feature row bytes
  topo_saved(c)  = sum of the c hottest vertices' expansion counts
                   x their CSR row bytes (8 + 4*degree, GetEdgeMem
                   cache.cu:494-505)

It runs once at set-up, on the host, over [V] arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CostModelResult:
    feature_capacity: int        # rows of the feature cache
    topo_capacity: int           # rows (vertices) of the topology cache
    alpha: float                 # fraction of bytes given to features
    feature_order: np.ndarray    # QF: vertex ids by feature hotness desc
    topo_order: np.ndarray       # QT: vertex ids by topo hotness desc
    est_feat_saved_bytes: float
    est_topo_saved_bytes: float


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _order_and_prefix(node_access, edge_access, degrees, feat_row_bytes):
    na, ea, deg = _np(node_access), _np(edge_access), _np(degrees)
    qf = np.argsort(-na.astype(np.int64), kind="stable")
    qt = np.argsort(-ea.astype(np.int64), kind="stable")
    feat_saved = np.cumsum(na[qf].astype(np.float64)) * feat_row_bytes
    row_bytes = 8.0 + 4.0 * deg.astype(np.float64)
    topo_saved = np.cumsum(ea[qt].astype(np.float64) * row_bytes[qt])
    topo_bytes = np.cumsum(row_bytes[qt])
    return qf, qt, feat_saved, topo_saved, topo_bytes


def plan_cache(node_access, edge_access, degrees, cache_bytes: int,
               feat_dim: int, alpha_step: float = 0.01,
               group_size: int = 1,
               bytes_per_feat: int = 4) -> CostModelResult:
    """Pick (feature_capacity, topo_capacity) maximizing saved bytes.

    ``node_access``/``edge_access`` are [V] hotness counts and ``degrees``
    the [V] out-degrees, as numpy arrays or torch tensors. group_size (Kg)
    multiplies the budget: a clique pools its members' device memory
    (cache.cu:375-389), and the capacities returned are group totals,
    split across the members by ``cache/collective.py``'s interleaved
    layout. bytes_per_feat=2 for bf16 cache storage doubles the rows a
    byte budget holds.
    """
    V = int(_np(degrees).shape[0])
    feat_row_bytes = bytes_per_feat * feat_dim
    qf, qt, feat_saved, topo_saved, topo_bytes = _order_and_prefix(
        node_access, edge_access, degrees, float(feat_row_bytes))

    total = cache_bytes * group_size
    best = (-1.0, 0, 0, 0.0)  # (saved, feat_cap, topo_cap, alpha)
    alphas = np.arange(0.0, 1.0 + 1e-9, alpha_step)
    for alpha in alphas:
        feat_cap = min(int(alpha * total) // feat_row_bytes, V)
        fs = feat_saved[feat_cap - 1] if feat_cap > 0 else 0.0
        topo_budget = total - feat_cap * feat_row_bytes
        topo_cap = int(np.searchsorted(topo_bytes, topo_budget,
                                       side="right"))
        topo_cap = min(topo_cap, V)
        ts = topo_saved[topo_cap - 1] if topo_cap > 0 else 0.0
        saved = fs + ts
        if saved > best[0]:
            best = (saved, feat_cap, topo_cap, float(alpha))
    _, feat_cap, topo_cap, alpha = best
    fs = float(feat_saved[feat_cap - 1]) if feat_cap > 0 else 0.0
    ts = float(topo_saved[topo_cap - 1]) if topo_cap > 0 else 0.0
    return CostModelResult(
        feature_capacity=feat_cap, topo_capacity=topo_cap, alpha=alpha,
        feature_order=qf, topo_order=qt,
        est_feat_saved_bytes=fs, est_topo_saved_bytes=ts)
