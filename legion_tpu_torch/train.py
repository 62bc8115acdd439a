"""Trainer: sample -> feature fetch -> model -> Adam (port of the
fused-step path of ``legion_tpu/train.py``), for GraphSAGE, GCN,
GAT and link-prediction SAGE (``lp_sage``: loss over (anchor, positive,
negative) thirds of each batch; its valid metric is the mean loss over
valid anchors).

A step reads only device state and makes no host sync: seed and label
banks live on the device and are indexed by the device counter (lid =
ctr % steps), per-step counters stay device tensors, and the step's keys
come from the device counters as JAX's do (``legion_tpu/train.py::
_device_key``): K10 ``step_keys`` derives hop k's key words from
fold_in(fold_in(fold_in(base_key, ctr), tag), k), tag 0 for a train step
and 1 for an eval step, and advances the counter, one launch a step. In a
train step the same launch writes the step's dropout key, fold_in(step
key, 7), as the JAX step folds 7 into its key for dropout (``legion_tpu/
train.py:612``); feature dropout (K16) and GAT's attention dropout (K6,
K7) fold each layer into it on the card (``ops/dropout.py``). So a
state's counters alone fix every later batch, and every random stream of
a step but the initial weights comes from K10's keys. The host keeps
Python twins of the counters.

A step is its device part (``_step_body``: K10, the sampling, the fetch,
the forward of every member, the backward, Adam and the counters), the
unit a CUDA graph captures, and the host's count of it.

With one member, features on the card (``DeviceFeatureSource``) and a
model that reads ``TableRows`` (``reads_table_rows``), the fetch takes
only the ids before the lane-aligned last hop (``_table_head``,
``DeviceFeatureSource.fetch_head``): layer 0 reads that hop's rows from
the feature table inside K15, as JAX's XLA sums them where it gathers
them. The feature-hit counter counts every id.

``TrainConfig.fused_steps`` = K: one ``train_step`` call takes K steps.
On a card the first call runs an eager step, captures one step into a
CUDA graph and replays it K-1 times; later calls replay it K times (the
analog of JAX's ``lax.scan`` of K steps in one dispatch,
``legion_tpu/train.py:702-748``). On the CPU a call takes K eager steps.
Either way the call returns the mean loss and sums the counters, and
``fit`` takes ``train_step // K`` calls an epoch.

``TrainConfig.interbatch``: the state carries the next batch of every
member here (sampled and fetched, with its seeds and labels), and a
``train_step`` trains on the carried batch N while it samples and fetches
batch N+1 (JAX's pipelined step, ``legion_tpu/train.py:642-700``). On a
card the update runs on the caller's stream and the sampling on the
trainer's side stream; on the CPU the two halves run one after the
other. The carry has a device counter of its own (``carry_ctr_d``, which
K10 advances), so ``train_ctr_d`` still counts trained batches, and a
checkpoint means the same in both modes. Losses, parameters, ids, masks
and counters equal the plain step's.

Both modes take members and process groups, as JAX's ``shard_map`` step
takes any mesh: each member's model draws its dropout (feature and
attention) from its own row of K10's dropout keys (the carry holds its
batch's, ``carry_dkey``), so a captured graph reads each step's keys from
the buffers K10 rewrites and registers no generator. The collectives of a
step (the gradients' and the loss's all-reduce, layout (b)'s
all-to-alls) are captured with it under NCCL; gloo ranks take eager
steps. Under
``interbatch`` in layout (b), the update's all-reduces wait for the side
stream's all-to-alls (``_interbatch_step``).

Every state owns its parameters: ``init_state`` builds a new module and a
new Adam, so a second ``init_state`` or a restore into the same trainer
leaves a live state as it was.

Ported: storage set-up on one device (``_setup_storage``) for a device
dataset and for a host ``LegionDataset``: measured buffer caps from
presampling; with the cache off, the whole graph and a bf16 feature table
padded to 128 columns on the card; with the cache on, the hotness-planned
unified cache on the card and the graph and features left in host RAM,
their misses read by K4/K5 in place. Both dedup modes: with map dedup
(the config's default) the state holds the sampler's [V] position map
(``state["pos_map"]``), shared by the train and eval samplers and clean
between batches. Also the train step (one step, ``fused_steps`` or
``interbatch``, with members and across processes), the eval step,
``run_eval`` and ``fit``.

``CacheConfig.host_transfer="staged"`` with host features: the staged
host pipeline (``pipeline/staged.py``, JAX's ``StagedHostPipeline``)
takes the train and eval steps. It samples and looks the features up on
a side stream (with host topology, host draws between the hops), ships
the missed rows as one bulk copy from a pinned buffer that a worker
thread fills, and assembles them before the update; one step ahead, as
JAX's lookahead. It takes neither ``fused_steps`` > 1 (refused) nor
``interbatch`` (ignored), as in JAX. "auto" and "callback" mean the
zero-copy kernels (K4, K5, K13).

Members (``MeshConfig(num_cliques=Kc, clique_size=Kg)``, n_dev = Kc * Kg
> 1): the devices of JAX's ("clique", "member") mesh are a leading axis
on this one device, in one process. Member d draws its seeds from its own
bank row (``seeds_for_partition(w, d, n_dev)``), its keys with d folded
in after the tag (K10 writes [n_dev, L, 4] words), keeps its own row of
``pos_map`` ([n_dev, S]) and draws its dropout from fold_in(fold_in(step
key, d), 7), its row of K10's dropout keys. The members sample in
lockstep (``NeighborSampler.sample_members``: the clique topology cache
answers every member's frontier of a hop at once) and fetch through the
clique caches of ``cache/collective.py`` (``_setup_clique``, JAX's
``_setup_multidev_cache``). The loss is the members' mean, so one
backward takes the mean of their gradients (``lax.pmean``), and one Adam
step follows; counters and eval's correct and total are sums
(``lax.psum``).

Across processes (``mesh``, ``parallel/mesh.py``; one process a card, a
rank of ``torch.distributed``): the n_dev members of JAX's mesh are laid
over the W ranks, rank r holding members r * n_local .. r * n_local +
n_local - 1. Every rank builds every member's seed sets, so the schedule
is the same everywhere, and keeps its own members' bank rows; every rank
presamples global member 0's bank and checks with one all-reduce that
the caps and the plan agree. K10 folds each member's global index, and
dropout too. A step's loss is the mean over the rank's members; after the
backward one flat all-reduce of the gradients, divided by W, gives
``lax.pmean``, so every rank runs the same Adam on the same bits. The loss
is all-reduced the same way, the counters summed (one int32 vector a
``train_step`` call), and eval's correct and total summed once at the end
of ``run_eval``. With cliques across ranks (layout (b)) a rank holds its own
shard of each clique cache, and the exchange is an all-to-all in the
clique's group. ``fit`` prints and writes checkpoints on rank 0, with a
barrier after each write. A mesh with a world group makes every
collective call even at W = 1.

Host tables are writable RAM: a table the kernels read in place that is a
read-only array or a file mapping (the memmaps of ``LegionDataset.load``)
is copied into RAM once (``in_ram``) before it is registered. Pinning locks
every page of a table in RAM anyway, so the copy costs the RAM that
pinning the mapped pages would, and the page cache of the files stays
reclaimable. With a bf16 feature cache the host feature table is bf16
rows built once from the f32 features (``_feature_table``), and the f32
array is read only by the cache fill, in place. ``setup_s`` records the
copy's seconds and bytes, the bf16 table's, and the registration's
seconds. A dataset's arrays that go to the card are copied there as they
are.

Checkpoints (``utils/checkpoint.py``): ``fit`` saves every
``checkpoint_every`` epochs; a state restored into a trainer takes the
checkpoint's base key on the device (K10) and as the trainer's
``step_key`` key, and its carry is primed anew.
"""

from __future__ import annotations

import contextlib
import mmap
import time
import zlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from legion_tpu_torch.cache.collective import (CliqueFeatureCache,
                                               CliqueTopoCache,
                                               build_clique_cache,
                                               build_clique_topo)
from legion_tpu_torch.cache.cost_model import plan_cache
from legion_tpu_torch.cache.hashmap import map_lookup
from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.cache.unified_cache import (CachedFeatureSource,
                                                  DeviceFeatureSource,
                                                  UnifiedCache)
from legion_tpu_torch.config import LegionConfig
from legion_tpu_torch.models.common import make_model
from legion_tpu_torch.models.lp_sage import check_thirds
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.ops.host_memory import HostTable, bf16_pitch, bf16_rows
from legion_tpu_torch.parallel.mesh import (Mesh, add_collective_counts,
                                            all_reduce, collective_counts,
                                            dp_size)
from legion_tpu_torch.pipeline.schedule import Mode, Schedule
from legion_tpu_torch.sampling.access import (CachedTopoAccess,
                                              DeviceCSRAccess,
                                              WindowedCSRAccess,
                                              dropout_words, fold_in,
                                              step_keys)
from legion_tpu_torch.sampling.sampler import (INT32_MAX, NeighborSampler,
                                               SampleBatch)
from legion_tpu_torch.utils.checkpoint import save_checkpoint
from legion_tpu_torch.utils.metrics import StepMetrics

# fold_in tags, as in legion_tpu/train.py: a train step's key (:590, :606),
# an eval step's (:765); dropout's (:612) is access.DROPOUT_TAG
_TRAIN_TAG, _EVAL_TAG = 0, 1
_PRESAMPLE_OFFSET = 17


def _file_backed(array: np.ndarray) -> bool:
    a = array
    while a is not None:
        if isinstance(a, (np.memmap, mmap.mmap)):
            return True
        a = getattr(a, "base", None)
    return False


def in_ram(array: np.ndarray, dtype) -> np.ndarray:
    """``array`` as a writable, C-contiguous ``dtype`` array in RAM: the
    array itself when it is one, else a copy (a read-only array, a file
    mapping, another dtype or layout), the one rule for a host table."""
    a = np.asarray(array)
    if a.dtype == dtype and a.flags.c_contiguous and a.flags.writeable \
            and not _file_backed(a):
        return a
    return np.array(a, dtype=dtype, order="C")


def _rows(ts: List[torch.Tensor]) -> torch.Tensor:
    """The members' tensors stacked, [n, ...]; one member's as a view."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(ts)


def topo_count_len(sampler: NeighborSampler, Kg: int, ids_len: int) -> int:
    """Lanes of a batch's ids that ``Trainer._topo_hit_count`` looks up in
    the topology map: the expanded frontier prefix, and with a clique
    (``Kg`` > 1) every hop's window as well."""
    L = sampler.config.num_hops
    P = sampler.cum_caps[L - 1]
    if Kg == 1:
        return P
    return min(ids_len, max(P, *(sampler.cum_caps[k]
                                 + sampler.frontier_sizes[k]
                                 for k in range(L))))


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    ce = F.cross_entropy(logits, labels.clamp(min=0).long(),
                         reduction="none")
    w = valid.to(logits.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1)


@dataclass
class EpochStats:
    epoch: int
    train_loss: float
    valid_acc: float
    seconds: float


def _build_bank(sets: List[np.ndarray], steps: int, static_bs: int,
                batch_sizes: List[int]) -> np.ndarray:
    """[n_dev, steps*static_bs] seed bank; step s of device d occupies
    [s*static_bs, s*static_bs + batch_sizes[d]), -1 padded."""
    bank = np.full((len(sets), steps * static_bs), -1, np.int32)
    for d, ids in enumerate(sets):
        bs = batch_sizes[d]
        for s in range(steps):
            chunk = ids[s * bs:(s + 1) * bs]
            bank[d, s * static_bs: s * static_bs + len(chunk)] = chunk
    return bank


class Trainer:
    def __init__(self, dataset, config: LegionConfig,
                 device: torch.device, mesh: Optional[Mesh] = None):
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        self._host_tables: List[HostTable] = []
        # the members of Kc cliques of Kg; this process holds members
        # first .. first + n_local - 1 as a leading axis on its device
        self.mesh = mesh
        self.n_dev = config.mesh.num_devices
        self.Kc, self.Kg = config.mesh.num_cliques, config.mesh.clique_size
        self.n_local, self.first = self.n_dev, 0
        self._world = self._clique_group = None
        if mesh is not None:
            if dp_size(mesh) != self.n_dev or mesh.clique_size != self.Kg:
                raise ValueError(
                    f"mesh {mesh.shape} for a config of {self.Kc} cliques of "
                    f"{self.Kg}")
            if mesh.world > 1 and mesh.world_group is None:
                raise ValueError(f"a mesh of {mesh.world} processes needs "
                                 "torch.distributed (multihost.initialize)")
            self.n_local, self.first = mesh.n_local, mesh.first_member
            self._world, self._clique_group = (mesh.world_group,
                                               mesh.clique_group)
        if config.cache.host_transfer not in ("auto", "callback", "staged"):
            # "auto" and "callback" both mean the zero-copy kernels here
            raise ValueError(
                f"host_transfer={config.cache.host_transfer!r}: 'auto', "
                "'callback' or 'staged'")
        if config.train.fused_steps < 1:
            raise ValueError(
                f"fused_steps={config.train.fused_steps}: at least 1")
        if config.train.interbatch and config.train.fused_steps > 1:
            raise ValueError(
                "fused_steps applies to the fused single-program path, not "
                "to interbatch (legion_tpu/train.py:191-193)")
        # train steps a ``train_step`` call takes (fit's unit of work), and
        # whether a step trains on the carry while it samples the next
        # batch; a state is made for one of the two modes (``init_state``).
        # The staged pipeline has its own lookahead and takes neither
        # (set after the storage)
        self.fused_steps = config.train.fused_steps
        self.interbatch = config.train.interbatch
        self._graph = self._side_stream = None
        self._staged = None
        # a captured step's kernel launches and collective calls (the
        # launches count once, at capture; a replay adds the collectives
        # to ``COLLECTIVES``, since each replay runs them)
        self.graph_launches: Dict[str, int] = {}
        self.graph_collectives: Dict[str, Dict[str, int]] = {}
        meta = dataset.meta
        V = meta.num_nodes
        scfg = config.sampler
        self.is_lp = config.train.model.lower() == "lp_sage"
        if self.is_lp:
            check_thirds(scfg.batch_size)
            check_thirds(scfg.eval_batch_size)

        device_ds = hasattr(dataset, "device_arrays")
        n_dev = self.n_dev
        if device_ds:
            train_sets, valid_sets, test_sets = dataset.seed_sets(n_dev)
            labels_np = dataset.labels.cpu().numpy()
        else:
            # member d draws its seeds from its own partition
            train_sets, valid_sets, test_sets = (
                [dataset.seeds_for_partition(w, d, n_dev)
                 for d in range(n_dev)]
                for w in ("train", "valid", "test"))
            labels_np = np.asarray(dataset.labels[:V], np.int32)
        self.schedule = Schedule.build(
            [len(s) for s in train_sets], [len(s) for s in valid_sets],
            [len(s) for s in test_sets], scfg.batch_size,
            config.train.epochs, scfg.eval_batch_size)
        sch = self.schedule

        # device seed banks, and label banks gathered once on the host:
        # device label state is O(seeds), not O(V). One member: [steps *
        # batch]; n members: [n_local, steps * batch], row i member
        # first + i's
        local = slice(self.first, self.first + self.n_local)

        def _banks(sets, steps, static_bs, batch_sizes):
            bank = _build_bank([np.asarray(s) for s in sets[local]], steps,
                               static_bs, batch_sizes[local])
            if n_dev == 1:
                bank = bank[0]
            y = np.where(bank >= 0, labels_np[np.clip(bank, 0, V - 1)], 0)
            return torch.from_numpy(bank).to(self.device), \
                torch.from_numpy(y.astype(np.int32)).to(self.device)

        self.train_bank, self.train_ybank = _banks(
            train_sets, sch.train_step, scfg.batch_size,
            [sch.train_batch_size] * n_dev)
        self.valid_bank, self.valid_ybank = _banks(
            valid_sets, sch.valid_step, scfg.eval_batch_size,
            list(sch.valid_batch_sizes))
        self.test_bank, self.test_ybank = _banks(
            test_sets, sch.test_step, scfg.eval_batch_size,
            list(sch.test_batch_sizes))

        self.sampler_t = NeighborSampler(scfg, V)
        eval_scfg = replace(scfg, batch_size=scfg.eval_batch_size,
                            node_caps=None, auto_compact=False)
        self.sampler_e = NeighborSampler(eval_scfg, V)

        self._setup_storage(train_sets[0])
        self._check_ranks_agree()
        if self._staged_host:
            if self.fused_steps > 1:
                raise ValueError(
                    "fused_steps applies to the fused single-program path, "
                    "not to the staged pipeline (legion_tpu/train.py:192-194)")
            # JAX's staged trainer ignores interbatch (train.py:516, :872)
            self.interbatch = False

        if self.compact_caps is not None:
            # the measured train caps bound an eval batch's growth too
            worst_e = self.sampler_e.config.cum_sizes()
            ecaps = (scfg.eval_batch_size,) + tuple(
                min(w, c) for w, c in zip(worst_e[1:],
                                          self.compact_caps[1:]))
            self.sampler_e = NeighborSampler(
                replace(eval_scfg, node_caps=ecaps), V)

        # the host's copy of the base key of the state last made or
        # restored, for ``step_key``
        self._base_key = config.train.seed + 1
        self.test_acc: Optional[float] = None
        if self._staged_host:
            self._build_staged_steps()

    # ------------------------------------------------------------------
    def _check_ranks_agree(self) -> None:
        """With a process group: one all-reduce (min of the digest and of
        its negation) shows whether every rank measured the same caps and
        planned the same caches; a ValueError if not."""
        if self._world is None:
            return
        h = zlib.crc32(repr(self.compact_caps).encode())
        p = self.cache_plan
        if p is not None:
            h = zlib.crc32(repr((p.feature_capacity, p.topo_capacity,
                                 p.alpha)).encode(), h)
            for order, cap in ((p.feature_order, p.feature_capacity),
                               (p.topo_order, p.topo_capacity)):
                h = zlib.crc32(np.ascontiguousarray(
                    np.asarray(order)[:cap], np.int64).tobytes(), h)
        d = all_reduce(torch.tensor([h, -h], dtype=torch.int64,
                                    device=self.device), self._world,
                       torch.distributed.ReduceOp.MIN).tolist()
        if d[0] != -d[1]:
            raise ValueError(
                f"rank {self.mesh.rank}: the ranks measured other caps or "
                f"planned other caches (digests {d[0]} .. {-d[1]})")

    def _in_ram(self, array: np.ndarray, dtype) -> np.ndarray:
        """``in_ram``, with the copy's seconds and bytes added to
        ``setup_s["ram_copy"]`` and ``setup_s["ram_copy_bytes"]``."""
        t0 = time.perf_counter()
        out = in_ram(array, dtype)
        if out is not array:
            self.setup_s["ram_copy"] += time.perf_counter() - t0
            self.setup_s["ram_copy_bytes"] += out.nbytes
        return out

    def _host_table(self, array: np.ndarray, dtype) -> HostTable:
        """A host array the kernels read in place, in RAM (``in_ram``),
        pinned when the trainer runs on a card (its seconds added to
        ``setup_s["register"]``); unpinned by ``close()``."""
        array = self._in_ram(array, dtype)
        t0 = time.perf_counter()
        t = HostTable(array, pin=self.device.type == "cuda")
        self.setup_s["register"] += time.perf_counter() - t0
        self._host_tables.append(t)
        return t

    def _feature_table(self, features: np.ndarray,
                       feat_dtype: str) -> HostTable:
        """The host feature table that K4 and K13 read a miss from, in the
        cache's dtype, as the JAX package ships a miss
        (``legion_tpu/cache/unified_cache.py:254-259``): for a bf16 cache,
        bf16 rows at ``bf16_pitch`` built once from ``features``
        (``bf16_rows``: half the link's bytes of an f32 row, the same bits
        as the kernels' own rounding), its seconds and bytes in
        ``setup_s["bf16_table"]`` and ``["bf16_table_bytes"]``; for an f32
        cache, the f32 array (``_host_table``)."""
        if feat_dtype != "bfloat16":
            return self._host_table(features, np.float32)
        t0 = time.perf_counter()
        table = bf16_rows(features, bf16_pitch(features.shape[1]))
        self.setup_s["bf16_table"] += time.perf_counter() - t0
        self.setup_s["bf16_table_bytes"] += table.nbytes
        return self._host_table(table, table.dtype)

    def _setup_storage(self, train_set0: np.ndarray) -> None:
        """Residency and the PreSc pipeline (``legion_tpu/train.py::
        Trainer._setup_storage``, its single-device, non-staged branch):
        presample hotness and per-hop maxima -> measured caps (max unique
        nodes x headroom, rounded to 128) -> cost model -> cache FillUp ->
        cached access paths.

        With the cache off, the graph and the feature table go to the
        device (bf16, padded to 128 columns). With it on, the graph and
        features of a host dataset stay in host RAM; the device holds the
        planned caches and their [V] maps, and misses are read in place
        by K4 (features) and K5 (topology). ``train_set0`` holds global
        member 0's train seeds, whose bank every rank presamples."""
        dataset, config = self.dataset, self.config
        meta = dataset.meta
        V = meta.num_nodes
        scfg = config.sampler
        cache_cfg = config.cache
        dev = self.device
        self.cache_plan = None
        self.cache: Optional[UnifiedCache] = None
        self.compact_caps = None
        feat_host = cache_cfg.enabled and \
            cache_cfg.feature_residency == "host"
        # the staged pipeline ships the feature misses (host features only,
        # as in legion_tpu/train.py:372-385, :471-482)
        self._staged_host = feat_host and cache_cfg.host_transfer == "staged"
        topo_host = cache_cfg.enabled and cache_cfg.topo_residency == "host"

        def _hbm_access(csr):
            if scfg.neighbor_window:
                return WindowedCSRAccess.from_csr(csr, scfg.neighbor_window)
            return DeviceCSRAccess(csr)

        host_feats = host_indptr = host_indices = None
        # set-up seconds by stage (presampling reads the host CSR in HT),
        # and the bytes copied into RAM for host tables
        self.setup_s: Dict[str, float] = {"ram_copy": 0.0,
                                          "ram_copy_bytes": 0,
                                          "bf16_table": 0.0,
                                          "bf16_table_bytes": 0,
                                          "register": 0.0}
        # a cache stored in bf16 holds twice the rows of a byte budget,
        # and its misses come from a bf16 host table
        feat_dtype = "bfloat16" \
            if config.train.compute_dtype == "bfloat16" else "float32"
        if hasattr(dataset, "device_arrays"):
            if cache_cfg.enabled:
                raise ValueError("host-cached storage needs a host dataset")
            self.csr, feats, _ = dataset.device_arrays()
            base_access = _hbm_access(self.csr)
            degrees = self.csr.degrees()
        else:
            # the f32 table K4 reads is in RAM (a bf16 one is built from
            # the array as it is); to the card, the array as it is
            if not feat_host:
                feats = np.ascontiguousarray(dataset.features, np.float32)
            elif feat_dtype == "bfloat16":
                feats = dataset.features
            else:
                feats = self._in_ram(dataset.features, np.float32)
            host_feats = feats
            if topo_host:
                # presampling reads adjacency from host memory, as the
                # reference's UVA pre_sample (operator_impl.cu:301-397)
                self.csr = None
                host_indptr = self._host_table(dataset.graph.indptr,
                                               np.int64)
                host_indices = self._host_table(dataset.graph.indices,
                                                np.int32)
                base_access = CachedTopoAccess.all_miss(
                    host_indptr, host_indices, dev)
                degrees = dataset.graph.degrees()
            else:
                self.csr = dataset.graph.to_device(dev)
                base_access = _hbm_access(self.csr)
                degrees = self.csr.degrees()

        want_compact = scfg.auto_compact and scfg.node_caps is None
        na = ea = None
        if cache_cfg.enabled or want_compact:
            t0 = time.perf_counter()
            steps = cache_cfg.presample_steps or self.schedule.train_step
            steps = max(1, min(steps, self.schedule.train_step))
            # global member 0's bank on every rank, as JAX presamples
            # (legion_tpu/train.py:281); rank 0 alone holds it already
            if self.first == 0:
                bank0 = self.train_bank if self.n_dev == 1 \
                    else self.train_bank[0]
            else:
                sch = self.schedule
                bank0 = torch.from_numpy(_build_bank(
                    [np.asarray(train_set0)], sch.train_step,
                    scfg.batch_size, [sch.train_batch_size])[0]).to(dev)
            na, ea, mx = presample_hotness(
                self.sampler_t, base_access, bank0, steps,
                config.train.seed + _PRESAMPLE_OFFSET)
            mxv = mx.cpu().numpy()      # waits for the presample batches
            self.setup_s["presample"] = time.perf_counter() - t0
            if want_compact:
                caps = [scfg.batch_size]
                for k in range(1, len(mxv)):
                    c = max(int(mxv[k] * scfg.cap_headroom) + 8,
                            caps[-1] + 1)
                    caps.append(-(-c // 128) * 128)
                scfg = replace(scfg, node_caps=tuple(caps))
                self.sampler_t = NeighborSampler(scfg, V)
                self.compact_caps = tuple(caps)

        # 128-column padding of the device feature table (cache off only;
        # the cache keeps the logical width, as in the JAX package)
        F_log = meta.feature_dim
        self.feat_pad = -(-F_log // 128) * 128 \
            if config.train.pad_feature_dim and not cache_cfg.enabled \
            else F_log

        if not cache_cfg.enabled:
            self.graph_access = base_access
            table = torch.from_numpy(feats).to(dev) \
                if isinstance(feats, np.ndarray) else feats
            if config.train.compute_dtype == "bfloat16":
                table = table.to(torch.bfloat16)
            if self.feat_pad != F_log:
                table = F.pad(table, (0, self.feat_pad - F_log))
            self.feature_source = DeviceFeatureSource(table.contiguous())
            return

        bpf = 2 if feat_dtype == "bfloat16" else 4
        ea_eff = ea if topo_host else torch.zeros_like(ea)
        na_eff = na if feat_host else torch.zeros_like(na)
        t0 = time.perf_counter()
        plan = plan_cache(na_eff, ea_eff, degrees, cache_cfg.cache_bytes,
                          F_log, cache_cfg.alpha_step, group_size=self.Kg,
                          bytes_per_feat=bpf)
        self.cache_plan = plan
        t1 = time.perf_counter()
        if self.n_dev > 1:
            self._setup_clique(plan, feat_host, topo_host, host_feats,
                               host_indptr, host_indices, base_access,
                               feat_dtype)
            self.setup_s.update(plan=t1 - t0, fill=time.perf_counter() - t1)
            return
        cache = UnifiedCache.build_from_host(
            plan, host_feats if feat_host else None,
            host_indptr.array if topo_host else None,
            host_indices.array if topo_host else None, V,
            feat_dtype=feat_dtype, device=dev)
        self.cache = cache
        self.setup_s.update(plan=t1 - t0, fill=time.perf_counter() - t1)

        if topo_host:
            if cache.row_map is None:
                self.graph_access = base_access
            else:
                self.graph_access = CachedTopoAccess(
                    cache.row_map, cache.sub_indptr, cache.sub_indices,
                    host_indptr, host_indices)
        else:
            self.graph_access = base_access
        if feat_host:
            if cache.slot_map is None:
                raise ValueError("feature cache budget resolved to zero "
                                 "rows")
            self.feature_source = CachedFeatureSource(
                cache, self._feature_table(host_feats, feat_dtype))
        else:
            self.feature_source = DeviceFeatureSource(
                torch.from_numpy(host_feats).to(dev))

    def _setup_clique(self, plan, feat_host: bool, topo_host: bool,
                      host_feats, host_indptr, host_indices, base_access,
                      feat_dtype: str) -> None:
        """The members' caches (``legion_tpu/train.py::
        _setup_multidev_cache``): the clique-aggregated caches over each
        clique's Kg members, one copy of the shards for the Kc cliques.
        The topology goes to the clique when Kg > 1 and the plan gives it
        at least Kg rows (``CliqueTopoCache``, misses by K5 on the host
        CSR); otherwise, with the topology on the host, every member reads
        one hot sub-CSR (``CachedTopoAccess``). The features go to the
        clique cache, a per-member cache at Kg = 1. The maps are direct
        [V] tables or hash maps (``CacheConfig.resolve_map_impl``). This
        process's cliques are those of its members; with a clique group
        it holds one member, and one shard of each clique cache."""
        dev, Kg = self.device, self.Kg
        group = self._clique_group
        # (local cliques, the shards held here, their first's index)
        if group is None:
            Kc, owners, o0 = self.n_local // Kg, None, 0
        else:
            Kc, o0 = 1, self.first % Kg
            owners = [o0]
        V = self.dataset.meta.num_nodes
        map_impl = self.config.cache.resolve_map_impl(V)
        if topo_host and Kg > 1 and plan.topo_capacity >= Kg:
            W = self.config.sampler.neighbor_window or 64
            row_map, pairs, blocks, _ = build_clique_topo(
                np.asarray(plan.topo_order), plan.topo_capacity,
                host_indptr.array, host_indices.array, Kg, window=W,
                map_impl=map_impl, device=dev, owners=owners)
            self.graph_access = CliqueTopoCache(
                row_map, pairs, blocks, base_access, Kg, Kc, group=group,
                first_owner=o0)
        elif topo_host and plan.topo_capacity > 0:
            cache_t = UnifiedCache.build_from_host(
                plan, None, host_indptr.array, host_indices.array, V,
                device=dev)
            self.graph_access = CachedTopoAccess(
                cache_t.row_map, cache_t.sub_indptr, cache_t.sub_indices,
                host_indptr, host_indices)
        else:
            self.graph_access = base_access
        if feat_host:
            slot_map, rows, _ = build_clique_cache(
                np.asarray(plan.feature_order), plan.feature_capacity,
                host_feats, Kg, feat_dtype=feat_dtype, map_impl=map_impl,
                device=dev, owners=owners)
            self.feature_source = CliqueFeatureCache(
                slot_map, rows, self._feature_table(host_feats, feat_dtype),
                Kg, Kc, group=group, first_owner=o0)
        else:
            self.feature_source = DeviceFeatureSource(
                torch.from_numpy(host_feats).to(dev))

    # -- the staged host pipeline (CacheConfig.host_transfer="staged") -----
    # owned by pipeline/staged.py::StagedHostPipeline, which probes its own
    # caps and keeps its counters (JAX's seams on the trainer,
    # legion_tpu/train.py:823-852, are the pipeline's members here)

    def _build_staged_steps(self) -> None:
        from legion_tpu_torch.pipeline.staged import StagedHostPipeline
        self._staged = StagedHostPipeline(self)

    def close(self) -> None:
        """Tear down the staged pipeline (its pending host half, its
        worker, its pinned buffers), then unregister the host tables. Safe
        to call more than once."""
        if self._staged is not None:
            self._staged.close()
        for t in self._host_tables:
            t.close()
        self._host_tables = []

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def init_state(self) -> Dict:
        """A new state that shares nothing with another: a new model with
        fresh parameters (from ``train.seed``), a new Adam over them
        (capturable on a card, so that eager and replayed steps run the
        same update), zeroed counters (Python ints, and int64 twins on the
        device that K10 reads and advances), the base key ``train.seed +
        1`` on the device and on the host (JAX's ``PRNGKey(seed + 1)``,
        ``legion_tpu/train.py:507-508``), the sampler state (``pos_map``:
        the [V] position map of map dedup, a 1-element dummy for sort
        dedup, as in ``legion_tpu/train.py:498-505``) and, under
        ``interbatch``, the carry (``prime_carry``). A new state is
        captured anew by the first fused ``train_step`` that takes it."""
        tcfg = self.config.train
        dev = self.device
        meta = self.dataset.meta
        model = make_model(tcfg, self.sampler_t.config, meta.feature_dim,
                           meta.num_classes, device=dev,
                           in_dim_pad=self.feat_pad)
        g = torch.Generator(device=dev)
        g.manual_seed(tcfg.seed)
        model.reset_parameters(g)
        opt = torch.optim.Adam(model.parameters(), lr=tcfg.lr,
                               betas=(0.9, 0.999), eps=1e-8,
                               capturable=dev.type == "cuda")
        self._graph = self._graph_state = None
        self._base_key = tcfg.seed + 1
        # lp_sage sums a loss into "correct": f32 counters
        mdt = torch.float32 if self.is_lp else torch.int32
        zero = lambda: torch.zeros((), dtype=mdt,  # noqa: E731
                                   device=dev)
        ctr = lambda: torch.zeros((), dtype=torch.int64,  # noqa: E731
                                  device=dev)
        state = {"model": model, "opt": opt,
                 "base_key": torch.full((), self._base_key,
                                        dtype=torch.int64, device=dev),
                 "train_ctr": 0, "valid_ctr": 0, "test_ctr": 0,
                 "train_ctr_d": ctr(), "valid_ctr_d": ctr(),
                 "test_ctr_d": ctr(), "correct": zero(), "total": zero(),
                 "pos_map": self._init_pos_map()}
        return self.prime_carry(state)

    def _init_pos_map(self) -> torch.Tensor:
        """The sampler state: one member's, or [n_local, S], a row a member
        here (``legion_tpu/train.py:498-500``)."""
        s = self.sampler_t
        if self.n_dev == 1:
            return s.init_state(self.device)
        return torch.full((self.n_local, s.state_size), INT32_MAX,
                          dtype=torch.int32, device=self.device)

    def prime_carry(self, state: Dict) -> Dict:
        """(Re)fill the ``interbatch`` carry: sample and fetch the batch
        at ``state["train_ctr"]`` into the state (``carry_batch``,
        ``carry_x``, ``carry_hits``, ``carry_seeds``, ``carry_y``), from a
        carry counter of its own (``carry_ctr_d``, a copy of
        ``train_ctr_d`` that K10 advances). A no-op unless
        ``interbatch``. ``init_state`` and ``restore_checkpoint`` call it
        (``legion_tpu/train.py:511-523``); the carry is not saved. On a
        card it samples on the side stream, and the caller's stream waits
        for it, so that whatever the caller then writes (a restore's
        counters and key) comes after the prime's reads."""
        if not self.interbatch:
            return state
        cuda = self.device.type == "cuda"
        on_side = contextlib.nullcontext()
        if cuda:
            side, cur = self._side(), torch.cuda.current_stream(self.device)
            side.wait_stream(cur)
            # made on the caller's stream and written on the side one: not
            # to be reused before the side stream is done with them
            for k in ("pos_map", "base_key"):
                state[k].record_stream(side)
            on_side = torch.cuda.stream(side)
        with on_side:
            state["carry_ctr_d"] = state["train_ctr_d"].clone()
            self._sample_ahead(state)
        if cuda:
            cur.wait_stream(side)
        return state

    def _sample_ahead(self, state: Dict) -> None:
        """Sample and fetch the train batch at ``carry_ctr_d`` (K10
        advances it) of every member here into the state's carry, on the
        current stream; on a card, ``carry_ready`` marks the end of it
        there."""
        batch, x, hits, seeds, y, dkey = self._train_batch(state,
                                                           "carry_ctr")
        state.update(carry_batch=batch, carry_x=x, carry_hits=hits,
                     carry_seeds=seeds, carry_y=y, carry_dkey=dkey)
        if self.device.type == "cuda":
            state["carry_ready"] = torch.cuda.Event()
            state["carry_ready"].record()

    def _side(self) -> "torch.cuda.Stream":
        """The trainer's side stream, made at first use: the first step
        and the capture of ``fused_steps``, and the sampling of
        ``interbatch``. One a trainer: cuBLAS keeps a workspace a
        stream."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=self.device)
        return self._side_stream

    # ------------------------------------------------------------------
    def step_key(self, ctr: int, tag: int) -> int:
        """The host's copy of a step's key, fold_in(fold_in(base_key,
        ctr), tag), for the state last made or restored: K10 derives the
        same on the card."""
        return fold_in(fold_in(self._base_key, ctr), tag)

    def _batch_inputs(self, state: Dict, sampler: NeighborSampler,
                      bank: torch.Tensor, ybank: torch.Tensor, n: int,
                      ctr: str, tag: int):
        """Seeds, labels, key words and dropout key words of the batch at
        the device counter ``state[ctr + "_d"]``, read on the card (no host
        value enters): lid = ctr % n selects the bank row, then K10 derives
        the keys (with a train step's dropout key, fold_in(step key, 7);
        None for an eval step) and advances the counter."""
        bs = sampler.config.batch_size
        ctr_d = state[ctr + "_d"]
        lid = (ctr_d % n).reshape(1)
        seeds = bank.view(n, bs).index_select(0, lid).reshape(bs)
        y = ybank.view(n, bs).index_select(0, lid).reshape(bs)
        train = tag == _TRAIN_TAG
        keys = step_keys(state["base_key"], ctr_d, tag,
                         sampler.config.num_hops, dropout=train)
        return (seeds, y) + (keys if train else (keys, None))

    def _sample_fetch(self, state: Dict, sampler: NeighborSampler,
                      seeds: torch.Tensor, keys: torch.Tensor
                      ) -> Tuple[SampleBatch, torch.Tensor, torch.Tensor]:
        batch = sampler.sample(self.graph_access, seeds, keys,
                               pos_map=state["pos_map"])
        # fetch only the model-visible id prefix, or of it the rows before
        # the aligned last hop, whose rows layer 0 reads from the table
        ids = batch.node_ids[:sampler.max_ids]
        head = self._table_head(sampler, state["model"])
        if head is None:
            x, feat_hits = self.feature_source.fetch(ids)
        else:
            x, feat_hits = self.feature_source.fetch_head(ids, head)
        return batch, x, feat_hits

    def _table_head(self, sampler: NeighborSampler,
                    model: torch.nn.Module) -> Optional[int]:
        """How many ids a batch of ``sampler`` fetches when its aligned
        last hop's rows stay in the device feature table (K15's form (c)
        reads them there at layer 0): the hop's aligned offset, for one
        member here with a ``DeviceFeatureSource`` and a model that reads
        ``TableRows`` (``reads_table_rows``); None (the whole fetch)
        otherwise."""
        if self.n_dev != 1 or not isinstance(self.feature_source,
                                             DeviceFeatureSource) \
                or not getattr(model, "reads_table_rows", False):
            return None
        cfg = sampler.config
        return cfg.aligned_hop_offset(cfg.num_hops - 1)

    def _train_on(self, state: Dict, batch: SampleBatch, x: torch.Tensor,
                  seeds: torch.Tensor, y: torch.Tensor, key: int
                  ) -> torch.Tensor:
        """Forward, backward and one Adam step on one batch, dropout from
        the step key ``key`` (its dropout key words made on the host)."""
        return self._update(state, batch, x, seeds, y,
                            dropout_words(key, self.device))

    def _batch(self, state: Dict, sampler: NeighborSampler,
               bank: torch.Tensor, ybank: torch.Tensor, n: int, ctr: str,
               tag: int):
        """The batch at the device counter ``state[ctr + "_d"]`` of every
        member here, sampled and fetched: (batch, x, feature hits, seeds,
        labels, dropout key words). One member's as ``_batch_inputs`` and
        ``_sample_fetch`` give them; n members' as ``_member_inputs`` and
        ``_member_sample_fetch`` do (a tuple of batches, x [n_local,
        max_ids, F], the hits summed, seeds and labels [n_local, batch],
        the dropout key words [n_local, 2]). The dropout key is None for an
        eval batch."""
        if self.n_dev == 1:
            seeds, y, keys, dkey = self._batch_inputs(
                state, sampler, bank, ybank, n, ctr, tag)
            batch, x, hits = self._sample_fetch(state, sampler, seeds, keys)
        else:
            seeds, y, keys, dkey = self._member_inputs(
                state, sampler, bank, ybank, n, ctr, tag)
            batch, x, hits = self._member_sample_fetch(state, sampler, seeds,
                                                       keys)
        return batch, x, hits, seeds, y, dkey

    def _train_batch(self, state: Dict, ctr: str):
        """``_batch`` of the train banks at ``state[ctr + "_d"]``."""
        return self._batch(state, self.sampler_t, self.train_bank,
                           self.train_ybank, self.schedule.train_step, ctr,
                           _TRAIN_TAG)

    def _update(self, state: Dict, batch, x: torch.Tensor,
                seeds: torch.Tensor, y: torch.Tensor, dkey: torch.Tensor,
                before_reduce=None) -> torch.Tensor:
        """Forward, backward and one Adam step (no host work: the captured
        part of a step). Dropout draws from the dropout key words ``dkey``
        (K10's, on the card; K16, and GAT's K6 and K7, fold each layer
        in). With members (``batch`` a tuple, x, seeds, y and dkey a row a
        member) the loss is the members' mean (``lax.pmean``), so one
        backward gives the mean of their gradients; member d's model draws
        from its own key row. ``before_reduce`` as in
        ``_backward_step``."""
        model = state["model"]
        model.train()
        scfg = self.sampler_t.config

        def loss_of(x, batch, seeds, y, dkey):
            if self.is_lp:
                return model.loss(x, batch, scfg, seeds >= 0, dkey)
            return _masked_ce(model(x, batch, scfg, dkey), y, seeds >= 0)
        if self.n_dev == 1:
            loss = loss_of(x, batch, seeds, y, dkey)
        else:
            loss = torch.stack([
                loss_of(x[d], b, seeds[d], y[d], dkey[d])
                for d, b in enumerate(batch)]).mean()
        return self._backward_step(state, loss, before_reduce)

    def _backward_step(self, state: Dict, loss: torch.Tensor,
                       before_reduce=None) -> torch.Tensor:
        """The backward of ``loss`` and one Adam step; with a process group
        the gradients and the returned loss are their means over the
        ranks (``lax.pmean``): one flat all-reduce of the gradients, and
        one of the loss. ``before_reduce()``, when given, is called after
        the backward and before the all-reduces (``_interbatch_step``
        issues the next batch's sampling there)."""
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if before_reduce is not None:
            before_reduce()
        if self._world is not None:
            W = self.mesh.world
            grads = [p.grad for p in state["model"].parameters()
                     if p.grad is not None]
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce(flat, self._world).div_(W)
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
            loss = all_reduce(loss.clone(), self._world).div_(W)
        opt.step()
        return loss

    def _step_body(self, state: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device part of one train step (the unit a CUDA graph
        captures): every member's batch at ``train_ctr_d`` (K10 with the
        member fold, the sampling, the fetch), the update, and the
        per-step counters [edges, slots, feature hits, topology hits,
        topology total] as one int32 tensor: trained edges, fetched id
        slots, the slots the feature cache served, and the adjacency reads
        the topology cache served (the live PCM analog), summed over the
        members (``lax.psum``)."""
        batch, x, feat_hits, seeds, y, dkey = self._train_batch(state,
                                                                "train_ctr")
        loss = self._update(state, batch, x, seeds, y, dkey)
        return loss, self._counts(batch, feat_hits)

    def _counts(self, batch, feat_hits: torch.Tensor) -> torch.Tensor:
        """A trained batch's counters (one SampleBatch, or the members'
        summed), as one int32 tensor."""
        batches = (batch,) if isinstance(batch, SampleBatch) else batch
        n = self.sampler_t.max_ids
        topo_hits, topo_total = self._topo_hit_count(batch, self.graph_access)
        return torch.stack([
            _rows([b.num_edges for b in batches]).sum(dtype=torch.int32),
            (_rows([b.node_ids[:n] for b in batches]) >= 0).sum(
                dtype=torch.int32),
            feat_hits.to(torch.int32), topo_hits, topo_total])

    def _eager_step(self, state: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """One train step: its device part (``_step_body``), then
        ``train_ctr``."""
        out = self._step_body(state)
        state["train_ctr"] += 1
        return out

    def _interbatch_step(self, state: Dict
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pipelined step (``legion_tpu/train.py:642-669``): the
        forward and backward on the carried batch N of every member here
        on the current stream, then the sampling and fetch of batch N+1
        into the carry, then the all-reduces and Adam of step N and the
        counters of batch N. On a card the sampling runs on the side
        stream and overlaps the update: the update waits for the end of
        batch N's fetch (``carry_ready``), and the sampling waits for what
        the current stream held before this update (the previous update,
        an eval pass that wrote ``pos_map``), not for this update. Batch
        N's buffers were allocated on the side stream; the carry that
        replaces them is allocated there after that wait, so the allocator
        cannot hand them out while the previous update still reads them
        (JAX's note on not donating the carry, ``:674-677``).

        With a clique group (layout (b)) the side stream's sampling makes
        the clique's all-to-alls and the current stream the world's
        all-reduces, on two NCCL communicators; two ranks that ran them in
        other orders could each wait in a kernel for the other. So the
        current stream waits for batch N+1's ``carry_ready`` before step
        N's all-reduces: on every rank the all-to-alls of batch N+1 run
        before the all-reduces of step N, and those before the all-to-alls
        of batch N+2 (which wait for this step's updates)."""
        cuda = self.device.type == "cuda"
        if cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(state["carry_ready"])
            before_update = torch.cuda.Event()
            before_update.record(cur)
        # batch N's dropout key travels in the carry with it: K10 has
        # written batch N+1's by the time this update's forward reads it
        batch, x, hits, seeds, y, dkey = (state[k] for k in (
            "carry_batch", "carry_x", "carry_hits", "carry_seeds",
            "carry_y", "carry_dkey"))
        state["train_ctr_d"].add_(1)    # what K10 does in the plain step

        def sample_next():
            if not cuda:
                self._sample_ahead(state)
                return
            side = self._side()
            side.wait_event(before_update)
            with torch.cuda.stream(side):
                self._sample_ahead(state)
            if self._clique_group is not None:
                cur.wait_event(state["carry_ready"])
        loss = self._update(state, batch, x, seeds, y, dkey, sample_next)
        state["train_ctr"] += 1
        return loss, self._counts(batch, hits)

    def _capture(self, state: Dict, stream) -> None:
        """Capture one step (``_step_body``, and the sums of its loss and
        counters into static tensors) into a CUDA graph on ``stream`` with
        a private memory pool, as PyTorch's whole-network recipe does.
        The step draws its dropout from the key words K10 writes into the
        graph's own buffers, so a replay draws its own step's masks and no
        generator is registered. The collectives of the step (NCCL: the
        gradients' and the loss's all-reduce, and in layout (b) the
        clique's all-to-alls) are captured with it; the capture runs none
        of them, so their counts go to ``graph_collectives`` and not to
        ``COLLECTIVES``, which each replay adds them to."""
        self._loss_sum = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        self._counts_sum = torch.zeros((5,), dtype=torch.int32,
                                       device=self.device)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        coll = collective_counts()
        with torch.cuda.graph(graph, stream=stream):
            loss, counts = self._step_body(state)
            self._loss_sum.add_(loss)
            self._counts_sum.add_(counts)
        self.graph_launches = {k: v - before[k]
                               for k, v in kernels.LAUNCHES.items()}
        self.graph_collectives = {
            k: {f: n - coll[k][f] for f, n in v.items()}
            for k, v in collective_counts().items()}
        add_collective_counts(self.graph_collectives, -1)
        self._graph, self._graph_state = graph, state

    def _replay(self, state: Dict) -> None:
        """One captured step: replay, and count the collectives it ran."""
        self._graph.replay()
        add_collective_counts(self.graph_collectives)
        state["train_ctr"] += 1

    def _fused_call(self, state: Dict, K: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K steps as CUDA-graph replays. The first call for a state runs
        one eager step on a side stream (it builds the library, finds K9's
        grid, allocates Adam's state), sets the grads to None, captures one
        step and replays it K-1 times; a later call replays K times.
        Returns the mean loss and the summed counters."""
        if self._graph is None or self._graph_state is not state:
            side = self._side()
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss0, counts0 = self._eager_step(state)
            torch.cuda.current_stream(self.device).wait_stream(side)
            state["opt"].zero_grad(set_to_none=True)
            self._graph = None
            self._capture(state, side)
            self._loss_sum.copy_(loss0)
            self._counts_sum.copy_(counts0)
            n = K - 1
        else:
            self._loss_sum.zero_()
            self._counts_sum.zero_()
            n = K
        for _ in range(n):
            self._replay(state)
        return self._loss_sum / K, self._counts_sum.clone()

    def train_step(self, state: Dict) -> Tuple[Dict, torch.Tensor]:
        """``fused_steps`` train steps (one by default); the loss, their
        mean, stays a device tensor. ``last_edges``, ``last_slots``,
        ``last_feat_hits``, ``last_topo_hits`` and ``last_topo_total`` hold
        the counters summed over the steps, as JAX's ``scan`` form sums
        them (``legion_tpu/train.py:725-739``). On a card, K > 1 steps are
        CUDA-graph replays of one captured step; on the CPU, K eager steps.
        A capture or replay that fails raises: nothing falls back to eager
        steps. Under ``interbatch`` a call takes one pipelined step
        (``_interbatch_step``) and the counters are the carried batch's.
        Each mode takes every member here; with a process group the
        call's counters are summed over the ranks once, by one
        all-reduce outside any captured step (the sums of JAX's per-step
        ``psum``)."""
        if self._staged_host:
            return self._staged.train_step(state)
        K = self.fused_steps
        if self.interbatch:
            loss, counts = self._interbatch_step(state)
        elif K > 1 and self.device.type == "cuda":
            loss, counts = self._fused_call(state, K)
        else:
            outs = [self._eager_step(state) for _ in range(K)]
            loss = outs[0][0] if K == 1 else \
                torch.stack([o[0] for o in outs]).mean()
            counts = outs[0][1] if K == 1 else \
                torch.stack([o[1] for o in outs]).sum(0, dtype=torch.int32)
        self._set_counts(counts)
        return state, loss

    def _set_counts(self, counts: torch.Tensor) -> None:
        """A ``train_step`` call's counters into ``last_*``; with a process
        group summed over the ranks first, by one all-reduce."""
        if self._world is not None:
            counts = all_reduce(counts, self._world)
        (self.last_edges, self.last_slots, self.last_feat_hits,
         self.last_topo_hits, self.last_topo_total) = counts.unbind()

    # -- the members here (n_dev > 1) --------------------------------------

    def _member_inputs(self, state: Dict, sampler: NeighborSampler,
                       bank: torch.Tensor, ybank: torch.Tensor, n: int,
                       ctr: str, tag: int):
        """``_batch_inputs`` for every member here: seeds and labels
        [n_local, batch] from each member's bank row at lid = ctr % n, and
        K10's [n_local, L, 4] words, member d's with its global index
        folded in after the tag (JAX's ``_device_key``), with a train
        step's [n_local, 2] dropout key words (None for an eval step)."""
        bs = sampler.config.batch_size
        m = self.n_local
        ctr_d = state[ctr + "_d"]
        lid = (ctr_d % n).reshape(1)
        seeds = bank.view(m, n, bs).index_select(1, lid).reshape(m, bs)
        y = ybank.view(m, n, bs).index_select(1, lid).reshape(m, bs)
        train = tag == _TRAIN_TAG
        keys = step_keys(state["base_key"], ctr_d, tag,
                         sampler.config.num_hops, self.n_dev, self.first, m,
                         dropout=train)
        return (seeds, y) + (keys if train else (keys, None))

    def _member_sample_fetch(self, state: Dict, sampler: NeighborSampler,
                             seeds: torch.Tensor, keys: torch.Tensor):
        """Every member's batch, sampled in lockstep (the clique topology
        answers all members' frontiers of a hop at once), then one fetch
        of all members' ids. Returns (batches, x [n_local, max_ids, F], the
        members' feature hits summed)."""
        batches = sampler.sample_members(self.graph_access, seeds, keys,
                                         pos_map=state["pos_map"])
        ids = torch.stack([b.node_ids[:sampler.max_ids] for b in batches])
        fs = self.feature_source
        if isinstance(fs, CliqueFeatureCache):
            x, hits = fs.fetch(ids)
            return batches, x, hits.sum(dtype=torch.int32)
        x, hits = fs.fetch(ids.reshape(-1))
        return batches, x.view(self.n_local, ids.shape[1], -1), hits

    def _eval_banks(self, mode: Mode):
        """(seed bank, label bank, steps, counter name) of an eval mode."""
        if mode == Mode.VALID:
            return (self.valid_bank, self.valid_ybank,
                    self.schedule.valid_step, "valid_ctr")
        return (self.test_bank, self.test_ybank, self.schedule.test_step,
                "test_ctr")

    def _topo_hit_count(self, batch, access,
                        sampler: Optional[NeighborSampler] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hits, total) over the expanded frontier prefix of the ids
        buffer, every vertex whose adjacency was read this batch (seeds
        and hops 0..L-2 occupy ids[:cum_caps[L-1]]): the vertices the
        topology cache served, and all of them
        (``legion_tpu/train.py:535-574``). For a clique cache, a hop's
        lanes past an owner's R_req were not served: the rule of K12's
        routing is replayed on each hop's window of the final ids buffer,
        and its overflow taken off, from one map lookup of every slot the
        prefix and the windows cover. ``batch`` is one SampleBatch or the
        members' (summed: one map lookup for all of them)."""
        batches = (batch,) if isinstance(batch, SampleBatch) else batch
        sampler = sampler or self.sampler_t
        L = sampler.config.num_hops
        P = sampler.cum_caps[L - 1]
        total = (_rows([b.node_ids[:P] for b in batches]) >= 0).sum(
            dtype=torch.int32)
        row_map = getattr(access, "row_map", None)
        if row_map is None:
            return total, total    # all device-resident
        Kg = getattr(access, "Kg", 1)
        n = topo_count_len(sampler, Kg, batches[0].node_ids.shape[0])
        rm = map_lookup(row_map, _rows([b.node_ids[:n] for b in batches]))
        hits = (rm[:, :P] >= 0).sum(dtype=torch.int32)
        if Kg > 1:
            dev = rm.device
            owners = torch.arange(Kg, dtype=torch.int32, device=dev)
            for k in range(L):
                F_k = sampler.frontier_sizes[k]
                lanes = torch.arange(F_k, device=dev)
                win = _rows([b.hop_offsets[k].long() + lanes
                             for b in batches])
                rmk = rm.gather(1, win)
                owner = torch.where(rmk >= 0, rmk % Kg, Kg)
                cnt = (owner[..., None] == owners).sum(1)    # [n, Kg]
                hits -= (cnt - access.R_req(F_k)).clamp(min=0).sum(
                    dtype=torch.int32)
        return hits, total

    @torch.no_grad()
    def _eval_step(self, state: Dict, mode: Mode) -> None:
        """One eval batch of every member here, eager (JAX's eval step is
        unfused), keys from (base_key, the mode's counter, tag 1) by K10;
        with members, correct and total are sums (``lax.psum``). First
        ``_wait_side``: the side stream's sampling writes ``pos_map``
        too."""
        self._wait_side()
        bank, ybank, n, ctr = self._eval_banks(mode)
        batches, x, _, seeds, y, _ = self._batch(state, self.sampler_e, bank,
                                                 ybank, n, ctr, _EVAL_TAG)
        self._eval_on(state, batches, x, seeds, y)
        state[ctr] += 1

    def _eval_on(self, state: Dict, batches, x, seeds: torch.Tensor,
                 y: torch.Tensor) -> None:
        """An eval batch's forward, added to ``correct`` and ``total``
        (one member's batch, or the members' tuple with x, seeds and y a
        row a member)."""
        sampler = self.sampler_e
        bs = sampler.config.batch_size
        if self.n_dev == 1:
            batches, x, seeds, y = (batches,), (x,), seeds[None], y[None]
        model = state["model"]
        model.eval()
        for d, batch in enumerate(batches):
            valid = seeds[d] >= 0
            if self.is_lp:
                # the reference's valid_one_step (lp_sage.py:99-115,
                # 206-215)
                t = valid[:bs // 3].sum(dtype=torch.int32).float()
                loss = model.loss(x[d], batch, sampler.config, valid)
                state["correct"] += loss * t
                state["total"] += t
            else:
                pred = model(x[d], batch, sampler.config).argmax(dim=-1)
                state["correct"] += ((pred == y[d]) & valid).sum(
                    dtype=torch.int32)
                state["total"] += valid.sum(dtype=torch.int32)

    def _wait_side(self) -> None:
        """Under ``interbatch`` on a card, the current stream waits for the
        trainer's side stream (the carry's sampling and fetch)."""
        if self.interbatch and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_stream(self._side())

    def run_eval(self, state: Dict, mode: Mode) -> Tuple[Dict, float]:
        state["correct"] = torch.zeros_like(state["correct"])
        state["total"] = torch.zeros_like(state["total"])
        n = self.schedule.valid_step if mode == Mode.VALID \
            else self.schedule.test_step
        for _ in range(n):
            if self._staged_host:
                self._staged.eval_steps[mode](state)
            else:
                self._eval_step(state, mode)
        if self._world is not None:
            both = all_reduce(torch.stack([state["correct"],
                                           state["total"]]), self._world)
            state["correct"], state["total"] = both.unbind()
        acc = float(state["correct"]) / max(float(state["total"]), 1.0)
        return state, acc

    # ------------------------------------------------------------------
    @property
    def is_rank0(self) -> bool:
        """Whether this process prints and writes for the run."""
        return self.mesh is None or self.mesh.rank == 0

    def save(self, checkpoint_dir: str, state: Dict) -> None:
        """``save_checkpoint`` at ``train_ctr``, by rank 0 alone; with a
        process group every rank then waits at a barrier (an all-reduce),
        so that no rank restores before the file is there."""
        if self.is_rank0:
            save_checkpoint(checkpoint_dir, state, state["train_ctr"])
        if self._world is not None:
            all_reduce(torch.zeros(1, device=self.device), self._world)

    def fit(self, state: Optional[Dict] = None, verbose: bool = True,
            checkpoint_dir: str = "", checkpoint_every: int = 0
            ) -> Tuple[Dict, List[EpochStats]]:
        """The reference schedule: per epoch train then valid; test once
        at the end. ``schedule.epochs`` epochs from the state's counters (a
        restored state runs as many more). ``checkpoint_every`` > 0 saves
        to ``checkpoint_dir`` after every N-th epoch, at ``train_ctr``.
        Under ``interbatch`` a call is one step (``fused_steps`` is 1), and
        the last step leaves a carry that is never trained, as in JAX.
        Across processes only rank 0 prints and writes (``save``)."""
        verbose = verbose and self.is_rank0
        if state is None:
            state = self.init_state()
        sch = self.schedule
        stats: List[EpochStats] = []
        self.epoch_metrics: List[StepMetrics] = []
        cache_on = self.cache_plan is not None
        K = self.fused_steps
        if K > 1 and sch.train_step % K:
            raise ValueError(
                f"fused_steps={K} must divide the epoch's "
                f"train_step={sch.train_step} for the exact schedule")
        for epoch in range(sch.epochs):
            t0 = time.time()
            losses, hits, edges, slots = [], [], [], []
            sm = StepMetrics(feat_dim=self.dataset.meta.feature_dim)
            for _ in range(sch.train_step // K):
                state, loss = self.train_step(state)
                losses.append(loss)
                hits.append(self.last_feat_hits)
                edges.append(self.last_edges)
                slots.append(self.last_slots)
            train_loss = float(torch.stack(losses).mean())
            # the counters come off the device once per epoch
            th, te, ts = (int(v) for v in torch.stack(
                [torch.stack(hits).sum(), torch.stack(edges).sum(),
                 torch.stack(slots).sum()]).cpu())
            sm.steps = len(losses) * K
            sm.edges, sm.feat_hits = te, th
            sm.nodes = sm.feat_total = ts
            if not cache_on:
                sm.feat_hits = ts   # all slots served from device memory
            sm.stop()
            state, acc = self.run_eval(state, Mode.VALID)
            dt = time.time() - t0
            stats.append(EpochStats(epoch, train_loss, acc, dt))
            self.epoch_metrics.append(sm)
            if verbose:
                hit_info = (f" | hit rate {sm.hit_rate:.3f} | host "
                            f"{sm.host_bytes / 1e6:.1f}MB") if cache_on \
                    else ""
                print(f"Epoch {epoch:03d} | time {dt:.2f}s | "
                      f"loss {train_loss:.4f} | val acc {acc:.4f} | "
                      f"{sm.edges_per_s / 1e6:.1f}M edges/s | "
                      f"{sm.nodes_per_s / 1e6:.1f}M nodes/s{hit_info}")
            if checkpoint_dir and checkpoint_every > 0 and \
                    (epoch + 1) % checkpoint_every == 0:
                self.save(checkpoint_dir, state)
        state, self.test_acc = self.run_eval(state, Mode.TEST)
        if verbose:
            print(f"Test acc {self.test_acc:.4f}")
        return state, stats
