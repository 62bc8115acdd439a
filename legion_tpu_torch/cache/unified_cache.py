"""Feature sources (port of ``legion_tpu/cache/unified_cache.py``).

Only the device-resident source is ported: the whole feature table lives
on the card (the reference's in-memory mode). The host-resident caches
(``CachedFeatureSource``, ``UnifiedCache``) are ROADMAP items.
"""

from __future__ import annotations

from typing import Tuple

import torch

from legion_tpu_torch.ops import kernels


class DeviceFeatureSource:
    """All features in device memory."""

    def __init__(self, features: torch.Tensor):
        self.features = features

    def fetch(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows [N, F] with zero rows for ids < 0, count of valid ids).
        Through K1; features are data, so no gradient is taken."""
        rows = kernels.gather_rows(self.features, ids)
        return rows, (ids >= 0).sum(dtype=torch.int32)
