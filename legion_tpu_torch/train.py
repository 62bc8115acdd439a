"""Single-device trainer: sample -> feature fetch -> GraphSAGE -> Adam
(port of the fused one-step path of ``legion_tpu/train.py``).

One step on one card, eager PyTorch, no host syncs inside the step: seed
and label banks live on the device, per-step counters stay device
tensors, and the step's random key is an int64 taken from the state's
CPU ``torch.Generator`` (host-side, no device work). Hop k of the sampler
draws with ``fold_in(key, k)``; dropout masks come from a device
generator seeded with ``fold_in(key, 7)``, as the JAX step folds 7 into
its key for dropout.

Ported: the HBM branch of storage setup (device dataset, measured buffer
caps from presampling, bf16 feature table padded to 128 columns), the
one-step train step, the eval step, ``run_eval`` and ``fit``. Not ported
(ROADMAP): host-resident caches, meshes, ``interbatch``, ``fused_steps``,
checkpoints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from legion_tpu_torch.cache.hotness import presample_hotness
from legion_tpu_torch.cache.unified_cache import DeviceFeatureSource
from legion_tpu_torch.config import LegionConfig
from legion_tpu_torch.models.common import make_model
from legion_tpu_torch.pipeline.schedule import Mode, Schedule
from legion_tpu_torch.sampling.access import (DeviceCSRAccess,
                                              WindowedCSRAccess, fold_in)
from legion_tpu_torch.sampling.sampler import NeighborSampler, SampleBatch
from legion_tpu_torch.utils.metrics import StepMetrics

_DROPOUT_TAG = 7
_PRESAMPLE_OFFSET = 17


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


def _step_key(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen).item())


class Trainer:
    def __init__(self, dataset, config: LegionConfig,
                 device: torch.device):
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        if config.mesh.num_devices != 1:
            raise NotImplementedError(
                "the port trains on one device; multi-GPU is a ROADMAP item")
        if not hasattr(dataset, "device_arrays"):
            raise NotImplementedError(
                "the port needs a device-resident dataset; host datasets "
                "and caches are ROADMAP items")
        if config.cache.enabled:
            raise NotImplementedError(
                "host-resident caches are a ROADMAP item")
        if config.train.fused_steps != 1 or config.train.interbatch:
            raise NotImplementedError(
                "fused_steps and interbatch are ROADMAP items")
        meta = dataset.meta
        V = meta.num_nodes
        scfg = config.sampler

        train_sets, valid_sets, test_sets = dataset.seed_sets(1)
        self.schedule = Schedule.build(
            [len(s) for s in train_sets], [len(s) for s in valid_sets],
            [len(s) for s in test_sets], scfg.batch_size,
            config.train.epochs, scfg.eval_batch_size)
        sch = self.schedule

        # device seed banks, and label banks gathered once from the
        # device label table
        labels = dataset.labels

        def _banks(sets, steps, static_bs, batch_sizes):
            bank = torch.from_numpy(_build_bank(
                [np.asarray(s) for s in sets], steps, static_bs,
                batch_sizes)[0]).to(self.device)
            y = labels[bank.clamp(0, V - 1).long()].to(torch.int32)
            return bank, torch.where(bank >= 0, y, torch.zeros_like(y))

        self.train_bank, self.train_ybank = _banks(
            train_sets, sch.train_step, scfg.batch_size,
            [sch.train_batch_size])
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

        self._setup_storage()

        if self.compact_caps is not None:
            # the measured train caps bound an eval batch's growth too
            worst_e = self.sampler_e.config.cum_sizes()
            ecaps = (scfg.eval_batch_size,) + tuple(
                min(w, c) for w, c in zip(worst_e[1:],
                                          self.compact_caps[1:]))
            self.sampler_e = NeighborSampler(
                replace(eval_scfg, node_caps=ecaps), V)

        self.model = make_model(config.train, self.sampler_t.config,
                                meta.feature_dim, meta.num_classes,
                                device=self.device, in_dim_pad=self.feat_pad)
        self._drop_gen = torch.Generator(device=self.device)
        self.test_acc: Optional[float] = None

    # ------------------------------------------------------------------
    def _setup_storage(self) -> None:
        """HBM residency: graph access, measured caps (presample ->
        per-hop max unique nodes x headroom, rounded to 128), and the
        feature table cast to bf16 and padded to 128 columns."""
        config = self.config
        scfg = config.sampler
        V = self.dataset.meta.num_nodes
        self.csr, feats, _ = self.dataset.device_arrays()
        if scfg.neighbor_window:
            self.graph_access = WindowedCSRAccess.from_csr(
                self.csr, scfg.neighbor_window)
        else:
            self.graph_access = DeviceCSRAccess(self.csr)

        self.compact_caps = None
        if scfg.auto_compact and scfg.node_caps is None:
            steps = config.cache.presample_steps or self.schedule.train_step
            steps = max(1, min(steps, self.schedule.train_step))
            _, _, mx = presample_hotness(
                self.sampler_t, self.graph_access, self.train_bank, steps,
                config.train.seed + _PRESAMPLE_OFFSET)
            mxv = mx.cpu().numpy()
            caps = [scfg.batch_size]
            for k in range(1, len(mxv)):
                c = max(int(mxv[k] * scfg.cap_headroom) + 8, caps[-1] + 1)
                caps.append(-(-c // 128) * 128)
            scfg = replace(scfg, node_caps=tuple(caps))
            self.sampler_t = NeighborSampler(scfg, V)
            self.compact_caps = tuple(caps)

        F_log = self.dataset.meta.feature_dim
        self.feat_pad = -(-F_log // 128) * 128 \
            if config.train.pad_feature_dim else F_log
        table = feats
        if config.train.compute_dtype == "bfloat16":
            table = table.to(torch.bfloat16)
        if self.feat_pad != F_log:
            table = F.pad(table, (0, self.feat_pad - F_log))
        self.feature_source = DeviceFeatureSource(table.contiguous())

    # ------------------------------------------------------------------
    def init_state(self) -> Dict:
        """Fresh parameters (from ``train.seed``), a fresh Adam, zeroed
        counters and the step-key generators."""
        tcfg = self.config.train
        g = torch.Generator(device=self.device)
        g.manual_seed(tcfg.seed)
        self.model.reset_parameters(g)
        opt = torch.optim.Adam(self.model.parameters(), lr=tcfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        gen, eval_gen = torch.Generator(), torch.Generator()
        gen.manual_seed(tcfg.seed + 1)
        eval_gen.manual_seed(tcfg.seed + 2)
        zero = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                                   device=self.device)
        return {"model": self.model, "opt": opt, "gen": gen,
                "eval_gen": eval_gen, "train_ctr": 0, "valid_ctr": 0,
                "test_ctr": 0, "correct": zero(), "total": zero()}

    # ------------------------------------------------------------------
    def _sample_fetch(self, sampler: NeighborSampler, bank: torch.Tensor,
                      lid: int, key: int
                      ) -> Tuple[SampleBatch, torch.Tensor, torch.Tensor]:
        bs = sampler.config.batch_size
        seeds = bank[lid * bs:(lid + 1) * bs]
        batch = sampler.sample(self.graph_access, seeds, key)
        # fetch only the model-visible id prefix
        x, feat_hits = self.feature_source.fetch(
            batch.node_ids[:sampler.max_ids])
        return batch, x, feat_hits

    def _train_on(self, state: Dict, batch: SampleBatch, x: torch.Tensor,
                  seeds: torch.Tensor, y: torch.Tensor, key: int
                  ) -> torch.Tensor:
        """Forward, backward and one Adam step on one batch."""
        model, opt = state["model"], state["opt"]
        model.train()
        self._drop_gen.manual_seed(fold_in(key, _DROPOUT_TAG) & (2**63 - 1))
        logits = model(x, batch, self.sampler_t.config, self._drop_gen)
        loss = _masked_ce(logits, y, seeds >= 0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    def train_step(self, state: Dict) -> Tuple[Dict, torch.Tensor]:
        """One train step; the loss stays a device tensor."""
        sampler = self.sampler_t
        bs = sampler.config.batch_size
        lid = state["train_ctr"] % self.schedule.train_step
        key = _step_key(state["gen"])
        batch, x, feat_hits = self._sample_fetch(sampler, self.train_bank,
                                                 lid, key)
        seeds = self.train_bank[lid * bs:(lid + 1) * bs]
        y = self.train_ybank[lid * bs:(lid + 1) * bs]
        loss = self._train_on(state, batch, x, seeds, y, key)
        # per-step counters (device scalars): trained edges and fetched id
        # slots, all served from device memory (no topology cache, so the
        # JAX step's topology-hit counters have nothing to count)
        self.last_edges = batch.num_edges.sum(dtype=torch.int32)
        self.last_slots = feat_hits
        state["train_ctr"] += 1
        return state, loss

    @torch.no_grad()
    def _eval_step(self, state: Dict, mode: Mode) -> None:
        sampler = self.sampler_e
        bs = sampler.config.batch_size
        if mode == Mode.VALID:
            bank, ybank, n, ctr = (self.valid_bank, self.valid_ybank,
                                   self.schedule.valid_step, "valid_ctr")
        else:
            bank, ybank, n, ctr = (self.test_bank, self.test_ybank,
                                   self.schedule.test_step, "test_ctr")
        lid = state[ctr] % n
        key = _step_key(state["eval_gen"])
        batch, x, _ = self._sample_fetch(sampler, bank, lid, key)
        seeds = bank[lid * bs:(lid + 1) * bs]
        y = ybank[lid * bs:(lid + 1) * bs]
        model = state["model"]
        model.eval()
        pred = model(x, batch, sampler.config).argmax(dim=-1)
        valid = seeds >= 0
        state["correct"] += ((pred == y) & valid).sum(dtype=torch.int32)
        state["total"] += valid.sum(dtype=torch.int32)
        state[ctr] += 1

    def run_eval(self, state: Dict, mode: Mode) -> Tuple[Dict, float]:
        state["correct"] = torch.zeros_like(state["correct"])
        state["total"] = torch.zeros_like(state["total"])
        n = self.schedule.valid_step if mode == Mode.VALID \
            else self.schedule.test_step
        for _ in range(n):
            self._eval_step(state, mode)
        acc = float(state["correct"]) / max(float(state["total"]), 1.0)
        return state, acc

    # ------------------------------------------------------------------
    def fit(self, state: Optional[Dict] = None, verbose: bool = True
            ) -> Tuple[Dict, List[EpochStats]]:
        """The reference schedule: per epoch train then valid; test once
        at the end."""
        if state is None:
            state = self.init_state()
        sch = self.schedule
        stats: List[EpochStats] = []
        self.epoch_metrics: List[StepMetrics] = []
        for epoch in range(sch.epochs):
            t0 = time.time()
            losses, edges, slots = [], [], []
            sm = StepMetrics(feat_dim=self.dataset.meta.feature_dim)
            for _ in range(sch.train_step):
                state, loss = self.train_step(state)
                losses.append(loss)
                edges.append(self.last_edges)
                slots.append(self.last_slots)
            train_loss = float(torch.stack(losses).mean())
            te, ts = (int(v) for v in torch.stack(
                [torch.stack(edges).sum(), torch.stack(slots).sum()]).cpu())
            sm.steps = len(losses)
            sm.edges = te
            sm.nodes = sm.feat_total = sm.feat_hits = ts
            sm.stop()
            state, acc = self.run_eval(state, Mode.VALID)
            dt = time.time() - t0
            stats.append(EpochStats(epoch, train_loss, acc, dt))
            self.epoch_metrics.append(sm)
            if verbose:
                print(f"Epoch {epoch:03d} | time {dt:.2f}s | "
                      f"loss {train_loss:.4f} | val acc {acc:.4f} | "
                      f"{sm.edges_per_s / 1e6:.1f}M edges/s | "
                      f"{sm.nodes_per_s / 1e6:.1f}M nodes/s")
        state, self.test_acc = self.run_eval(state, Mode.TEST)
        if verbose:
            print(f"Test acc {self.test_acc:.4f}")
        return state, stats
