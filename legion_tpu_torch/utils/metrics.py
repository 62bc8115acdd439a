"""Training metrics & observability.

The reference's observability is stdout prints plus a disabled Intel PCM
PCIe monitor (monitor.cuh — SURVEY.md §5). Here the PCM role (how many bytes
were fetched from host vs served by cache) is played by first-class counters
measured in-band: feature-cache hit counts come back from every train step,
and the throughput numbers are derived from the sampler's own counters.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StepMetrics:
    """Accumulates per-step statistics for one epoch."""

    feat_dim: int = 0
    steps: int = 0
    edges: int = 0
    nodes: int = 0
    feat_hits: int = 0
    feat_total: int = 0
    t_start: float = field(default_factory=time.time)
    frozen_s: Optional[float] = None

    def record(self, num_edges: int, num_nodes: int, feat_hits: int = 0,
               feat_total: int = 0) -> None:
        self.steps += 1
        self.edges += num_edges
        self.nodes += num_nodes
        self.feat_hits += feat_hits
        self.feat_total += feat_total

    def stop(self) -> None:
        """Freeze the clock (call when the measured phase ends, so later
        property reads don't keep counting)."""
        self.frozen_s = time.time() - self.t_start

    @property
    def seconds(self) -> float:
        if self.frozen_s is not None:
            return self.frozen_s
        return time.time() - self.t_start

    @property
    def edges_per_s(self) -> float:
        return self.edges / max(self.seconds, 1e-9)

    @property
    def nodes_per_s(self) -> float:
        return self.nodes / max(self.seconds, 1e-9)

    @property
    def hit_rate(self) -> float:
        return self.feat_hits / max(self.feat_total, 1)

    @property
    def host_bytes(self) -> int:
        """Estimated bytes fetched from host storage (the PCM analog)."""
        return (self.feat_total - self.feat_hits) * self.feat_dim * 4

    def summary(self) -> Dict:
        return {
            "steps": self.steps,
            "seconds": round(self.seconds, 3),
            "edges_per_s": round(self.edges_per_s, 1),
            "sampled_nodes_per_s": round(self.nodes_per_s, 1),
            "feat_hit_rate": round(self.hit_rate, 4),
            "host_bytes": self.host_bytes,
        }

    def line(self) -> str:
        return json.dumps(self.summary())
