"""Unified typed configuration.

Replaces the reference's three config layers — argparse launchers
(legion_server.py:114-125), the positional one-line ``meta_config`` text file
(legion_server.py:94-95 / storage_management.cu:29-98), and compile-time
constants (system_config.cuh:34-57) — with one set of dataclasses.

``DatasetMeta.to_meta_config`` / ``from_meta_config`` keep file-level
compatibility with the reference's in-memory-mode meta_config line:
    path batch |V| |E| feat_dim train valid test cache_bytes epochs

This is a copy of ``legion_tpu/config.py``, not an import of it: importing
any ``legion_tpu`` module imports jax (``legion_tpu/__init__.py``), and the
PyTorch port never does. Keep the two files in step.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


# Known dataset shapes, mirroring the tables hardcoded in the reference's
# legion_server.py:41-91 / graph_partitioning.py:52-102 / gen_sets.py:9-59
# (deduplicated here into one place).
KNOWN_DATASETS = {
    "products": dict(num_nodes=2_449_029, num_edges=123_718_280, feature_dim=100,
                     num_classes=47, train_size=196_615, valid_size=39_323,
                     test_size=2_213_091),
    "paper100m": dict(num_nodes=111_059_956, num_edges=1_615_685_872,
                      feature_dim=128, num_classes=172, train_size=11_105_995,
                      valid_size=100_000, test_size=100_000),
    "com-friendster": dict(num_nodes=65_608_366, num_edges=1_806_067_135,
                           feature_dim=256, num_classes=100,
                           train_size=6_560_836, valid_size=100_000,
                           test_size=100_000),
    "ukunion": dict(num_nodes=133_633_040, num_edges=5_507_679_822,
                    feature_dim=256, num_classes=2, train_size=13_363_304,
                    valid_size=100_000, test_size=100_000),
    "uk2014": dict(num_nodes=787_801_471, num_edges=47_214_874_822,
                   feature_dim=128, num_classes=2, train_size=78_780_147,
                   valid_size=100_000, test_size=100_000),
    "clueweb": dict(num_nodes=955_207_488, num_edges=42_574_107_469,
                    feature_dim=128, num_classes=2, train_size=95_520_748,
                    valid_size=100_000, test_size=100_000),
}


@dataclass(frozen=True)
class DatasetMeta:
    """Dataset description (reference: meta_config + legion_server.py tables)."""

    path: str
    batch_size: int
    num_nodes: int
    num_edges: int
    feature_dim: int
    train_size: int
    valid_size: int
    test_size: int
    cache_bytes: int = 0
    epochs: int = 1
    num_classes: int = 2
    name: str = "custom"
    partition_count: int = 1

    @classmethod
    def known(cls, name: str, path: str, batch_size: int = 8000,
              cache_bytes: int = 0, epochs: int = 1,
              partition_count: int = 1) -> "DatasetMeta":
        if name not in KNOWN_DATASETS:
            raise ValueError(
                f"unknown dataset {name!r}; known: {sorted(KNOWN_DATASETS)}")
        d = KNOWN_DATASETS[name]
        return cls(path=path, batch_size=batch_size, cache_bytes=cache_bytes,
                   epochs=epochs, name=name, partition_count=partition_count,
                   **d)

    def to_meta_config(self, file_path: str = "meta_config") -> None:
        """Write the reference-compatible one-line meta_config file."""
        line = "{} {} {} {} {} {} {} {} {} {}".format(
            self.path, self.batch_size, self.num_nodes, self.num_edges,
            self.feature_dim, self.train_size, self.valid_size,
            self.test_size, self.cache_bytes, self.epochs)
        with open(file_path, "w") as f:
            f.write(line)

    @classmethod
    def from_meta_config(cls, file_path: str = "meta_config") -> "DatasetMeta":
        """Parse the reference's meta_config (storage_management.cu:29-63)."""
        with open(file_path) as f:
            parts = f.readline().split()
        (path, batch, v, e, fd, tr, va, te, cb, ep) = parts[:10]
        return cls(path=path, batch_size=int(batch), num_nodes=int(v),
                   num_edges=int(e), feature_dim=int(fd), train_size=int(tr),
                   valid_size=int(va), test_size=int(te), cache_bytes=int(cb),
                   epochs=int(ep))


@dataclass(frozen=True)
class SamplerConfig:
    """Multi-hop fanout sampling (reference: main.cu:9-11 hardcoded [25,10])."""

    fanouts: Tuple[int, ...] = (25, 10)
    batch_size: int = 8000
    # validation/test batches use 512 seeds per step like the reference
    # (ipc_service.cu:91-115)
    eval_batch_size: int = 512
    # Optional measured caps on cumulative unique nodes per hop (length
    # num_hops+1, caps[0] == batch_size). The reference sizes its
    # steady-state feature buffer at 1.2 x the presampled MaxIdNum instead
    # of the worst case (server.cu:275-283); setting node_caps does the
    # same here and shrinks every downstream buffer (ids, feature gather,
    # per-layer activations, edge lists). Overflowing nodes are dropped
    # (masked), not overflowed.
    node_caps: Optional[Tuple[int, ...]] = None
    # auto-measure node_caps from a presampling pass (Trainer)
    auto_compact: bool = False
    # headroom multiplier on the presampled per-hop max unique-node counts
    # (the reference uses 1.2x, server.cu:277). Every downstream buffer —
    # the feature gather, layer activations, edge lists — scales with it;
    # at 1.1x the bench step's gathered slots drop ~10% vs 1.2x. Overflow
    # (a batch exceeding the cap) drops the excess nodes masked, and is
    # observable via the per-step `last_slots` counter dipping.
    cap_headroom: float = 1.1
    # dedup strategy: "map" = O(E) scatters into a [V] position map
    # (Legion's algorithm, operator_impl.cu bitmap+position_map); "sort" =
    # sort-based dedup with NO O(V) state — scales to billion-vertex
    # graphs (K8 dedup_sort after a torch.sort; map dedup is K9 dedup_map)
    dedup: str = "map"
    # Block-windowed neighbor draws (power of two, 0 = off). When set,
    # device-resident adjacency is read as one aligned W-wide block per
    # frontier vertex instead of `fanout` scattered element reads (K3
    # windowed_draw), with exactly-uniform per-draw marginals; a vertex's
    # draws within one step are confined to one block (see
    # sampling.access.WindowedCSRAccess).
    neighbor_window: int = 0
    # Deduplicate the LAST hop's candidates? The reference always dedups
    # globally (operator_impl.cu:244-251): each unique node saves a PCIe
    # feature fetch. Skipping it makes last-hop local positions
    # LANE-ALIGNED (position = static_offset + lane), which deletes the
    # per-edge row gather (and its scatter-add transpose in backward) from
    # the first aggregation layer and the dedup pass over the largest
    # hop. Training math is unchanged: each duplicate lane carries an
    # identical feature copy, and the aggregation averages the same
    # multiset. Defaults to True (exact reference semantics); the launcher
    # and bench configurations turn it off.
    dedup_last_hop: bool = True

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    def aligned_hop_offset(self, k: int) -> Optional[int]:
        """If hop k's local positions are lane-aligned (position ==
        offset + lane), return the static offset; else None. Models use
        this to replace per-edge row gathers with static slices."""
        if not self.dedup_last_hop and k == self.num_hops - 1:
            return self.cum_sizes()[k]
        return None

    def _worst_frontier(self) -> Tuple[int, ...]:
        sizes = [self.batch_size]
        for f in self.fanouts[:-1]:
            sizes.append(sizes[-1] * f)
        return tuple(sizes)

    def frontier_sizes(self) -> Tuple[int, ...]:
        """Static max frontier size per hop: min(batch * prod(fanouts[:k]),
        measured cap on new nodes at hop k-1).

        Mirrors the worst-case id-buffer sizing in server.cu:188-199, tight-
        ened by node_caps when present.
        """
        worst = self._worst_frontier()
        if self.node_caps is None:
            return worst
        caps = self.node_caps
        out = [self.batch_size]
        for k in range(1, self.num_hops):
            new_max = caps[k] - (caps[k - 1] if k >= 1 else 0)
            out.append(min(worst[k], max(new_max, 1)))
        return tuple(out)

    def edge_counts(self) -> Tuple[int, ...]:
        """Static max edges emitted per hop."""
        fs = self.frontier_sizes()
        return tuple(fs[k] * self.fanouts[k] for k in range(self.num_hops))

    def cum_sizes(self) -> Tuple[int, ...]:
        """S[k] = static bound on local node slots after hop k (unique
        nodes when hop k is deduped; S[k-1] + E_{k-1} lanes when the last
        hop is lane-aligned)."""
        worst = [self.batch_size]
        for e in self.edge_counts():
            worst.append(worst[-1] + e)
        if self.node_caps is None:
            return tuple(worst)
        assert len(self.node_caps) == self.num_hops + 1, self.node_caps
        assert self.node_caps[0] >= self.batch_size
        out = [min(w, c) for w, c in zip(worst, self.node_caps)]
        if not self.dedup_last_hop:
            # last hop emits one slot per lane at a static offset
            out[-1] = out[-2] + self.edge_counts()[-1]
        return tuple(out)

    @property
    def max_ids(self) -> int:
        """Static unique-node bound (worst case, or the measured cap)."""
        return self.cum_sizes()[-1]


@dataclass(frozen=True)
class CacheConfig:
    """Hotness cache (reference: src/cache/cache.cu, system_config.cuh:56)."""

    cache_bytes: int = 0
    # NOTE: the cache-aggregation group size Kg (reference cache_agg_mode,
    # legion_server.py:100-106) is NOT configured here — it is the mesh's
    # "member" axis length (MeshConfig.clique_size), the single source of
    # truth the trainer reads (mesh.shape["member"]).
    # alpha-sweep granularity for the feature/topology split
    # (reference MIN_INTERVAL, cache_impl.cuh:30)
    alpha_step: float = 0.01
    # presampling steps used to measure hotness; 0 => one full train epoch
    presample_steps: int = 0
    # where the authoritative storage lives: "hbm" (fits on chip, reference
    # in-memory mode) or "host" (host RAM = the pinned-UVA analog; HBM holds
    # only the hot cache)
    feature_residency: str = "hbm"
    topo_residency: str = "hbm"
    # how cache-miss feature rows reach the device. In the port "auto" and
    # "callback" both mean the zero-copy kernels: K4 (features) and K5
    # (topology) read a miss from the registered host table inside the
    # step. "staged" is the JAX package's split sample/train programs
    # (pipeline/staged.py): a batch's missed rows are gathered on the host
    # into a pinned buffer and shipped as one bulk copy, and with host
    # topology the host draws the uncached rows' neighbours between hops.
    host_transfer: str = "auto"
    # id->slot map implementation: "direct" = [V] int32 table (one gather,
    # fastest; 4B/vertex/map), "hash" = bucketed open-addressing map
    # (~32B per CACHED vertex regardless of V — the BGHT role,
    # cache.cu:71-88, for billion-vertex graphs whose direct tables no
    # longer fit HBM), "auto" = hash when |V| >= 200M.
    map_impl: str = "auto"

    def resolve_map_impl(self, num_nodes: int) -> str:
        if self.map_impl != "auto":
            return self.map_impl
        return "hash" if num_nodes >= 200_000_000 else "direct"

    @property
    def enabled(self) -> bool:
        return self.cache_bytes > 0 and (
            self.feature_residency == "host"
            or self.topo_residency == "host")


@dataclass(frozen=True)
class TrainConfig:
    """Model/optimizer config (reference: legion_graphsage.py:191-203)."""

    model: str = "graphsage"           # graphsage | gcn | gat | lp_sage
    hidden_dim: int = 256
    num_layers: int = 2
    dropout: float = 0.5
    lr: float = 3e-3
    epochs: int = 2
    # GAT-specific (legion_gat.py:150-157)
    gat_heads: Tuple[int, ...] = (8, 1)
    gat_feat_drop: float = 0.6
    gat_attn_drop: float = 0.6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
    # Pad the device feature table to a multiple of 128 columns: a bf16
    # row is then 256 bytes, which K1 (gather_rows) copies as 16-byte
    # words. Layer-0 weights get zero rows for the pad columns
    # (initialized from the LOGICAL fan-in), so the training math is
    # bit-identical to the unpadded model. Applies with the cache off;
    # the cached path keeps the logical width.
    pad_feature_dim: bool = True
    # Train steps one ``Trainer.train_step`` call takes. On a card the
    # first call captures one step into a CUDA graph and later steps are
    # replays of it (the JAX package's lax.scan of K steps); on the CPU a
    # call takes K eager steps. The key and parameter sequence is exactly
    # the 1-step path's. Must divide the epoch's train_step count when
    # used with fit().
    fused_steps: int = 1
    # Inter-batch pipelining: train on batch N while batch N+1 is sampled
    # and fetched (the reference's 2-deep producer/consumer pipeline,
    # system_config.cuh:47-48). On a card the sampling runs on a second
    # CUDA stream; on the CPU the two halves run in turn. The same losses,
    # ids and keys as the plain step. Not with fused_steps > 1.
    interbatch: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout.

    Legion's NVLink clique structure (Kc cliques x Kg GPUs,
    legion_server.py:100-106) becomes two mesh axes: ``clique`` (independent
    cache replicas, data-parallel across) and ``member`` (cache-interleaved
    ICI neighbors, data-parallel within, cache reads via collectives).
    """

    num_cliques: int = 1     # Kc
    clique_size: int = 1     # Kg

    @property
    def num_devices(self) -> int:
        return self.num_cliques * self.clique_size

    @classmethod
    def for_devices(cls, n: int, clique_size: Optional[int] = None
                    ) -> "MeshConfig":
        if clique_size is None:
            # single host => all chips share ICI => one clique,
            # mirrors DGX-A100 Kc=1 Kg=8 (README.md:14)
            clique_size = n
        assert n % clique_size == 0
        return cls(num_cliques=n // clique_size, clique_size=clique_size)


@dataclass(frozen=True)
class LegionConfig:
    """Top-level config bundle."""

    dataset: DatasetMeta
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "LegionConfig":
        d = json.loads(s)
        for k in ("fanouts", "gat_heads"):
            pass
        ds = DatasetMeta(**d["dataset"])
        sp = SamplerConfig(**{**d["sampler"],
                              "fanouts": tuple(d["sampler"]["fanouts"])})
        ca = CacheConfig(**d["cache"])
        tr = TrainConfig(**{**d["train"],
                            "gat_heads": tuple(d["train"]["gat_heads"])})
        me = MeshConfig(**d["mesh"])
        return cls(dataset=ds, sampler=sp, cache=ca, train=tr, mesh=me)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "LegionConfig":
        with open(path) as f:
            return cls.from_json(f.read())
