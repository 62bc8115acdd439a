"""The port's ``TrainConfig.interbatch`` on the CPU: the pipelined step
(train on the carried batch N, then sample and fetch batch N+1 into the
carry) against the plain step, as ``tests/test_train.py::
test_interbatch_pipeline_exact_equivalence`` holds JAX's. The plain step
is held against JAX's step elsewhere (``test_torch_train.py``,
``test_torch_gat.py``, ``test_torch_gcn_lp.py``, ``test_torch_cache.py``);
the pipelined one must equal it exactly: same losses, parameters, sampled
ids and counters, since only the order of the two halves differs."""

from dataclasses import replace

import pytest
import torch

from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import (synthesize_dataset,
                                   synthesize_device_dataset)
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.train import Trainer

INT32_MAX = 2 ** 31 - 1
COUNTERS = ("last_edges", "last_slots", "last_feat_hits", "last_topo_hits",
            "last_topo_total")


@pytest.fixture(scope="module")
def ds():
    return synthesize_device_dataset("cpu", num_nodes=2000, num_edges=30000,
                                     feature_dim=32, num_classes=5,
                                     batch_size=63, valid_size=126,
                                     test_size=126)


@pytest.fixture(scope="module")
def hds():
    return synthesize_dataset(num_nodes=1500, avg_degree=10, feature_dim=24,
                              num_classes=4, batch_size=64, seed=5)


def _config(ds, case):
    """Small settings of ``case``: sort or map dedup (GraphSAGE), GAT with
    feature and attention dropout 0.5, ``lp_sage`` (batches in thirds),
    or host (the cache on, features and topology on the host)."""
    train = dict(hidden_dim=16, epochs=1, dropout=0.5)
    cache = CacheConfig(presample_steps=4)
    if case == "gat":
        train.update(model="gat", gat_heads=(2, 1), gat_feat_drop=0.5,
                     gat_attn_drop=0.5)
    elif case == "lp_sage":
        train.update(model="lp_sage")
    elif case == "host":
        cache = CacheConfig(cache_bytes=40_000, presample_steps=2,
                            feature_residency="host", topo_residency="host")
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(6, 4), batch_size=63,
                              eval_batch_size=63,
                              dedup="map" if case == "map" else "sort",
                              neighbor_window=16, dedup_last_hop=False,
                              auto_compact=True, cap_headroom=1.03),
        cache=cache, train=TrainConfig(**train),
        mesh=MeshConfig.for_devices(1))


def _interbatch(cfg):
    return replace(cfg, train=replace(cfg.train, interbatch=True))


def _recorder(tr):
    """The ids and per-hop edge counts of every train batch ``tr``
    samples, in order."""
    seen = []
    orig = tr.sampler_t.sample

    def sample(*a, **kw):
        b = orig(*a, **kw)
        seen.append((b.node_ids.clone(), b.num_edges.clone()))
        return b
    tr.sampler_t.sample = sample
    return seen


def _ctr_ok(st):
    return int(st["train_ctr_d"]) == st["train_ctr"]


@pytest.mark.parametrize("case", ["sort", "map", "gat", "lp_sage", "host"])
def test_interbatch_pipeline_exact_equivalence(ds, hds, case):
    """Port of ``tests/test_train.py:72``: 4 steps, a valid pass, 1 more
    step on an ``interbatch`` trainer and on a plain one give the same
    losses, parameters, counters, sampled batches and valid metric
    exactly; only the interbatch state has a carry; ``train_ctr_d`` counts
    trained batches after every call; map dedup's position map is clean
    after every step."""
    data = hds if case == "host" else ds
    cfg = _config(data, case)
    t0, t1 = Trainer(data, cfg, "cpu"), Trainer(data, _interbatch(cfg), "cpu")
    assert t1.interbatch and not t0.interbatch
    seen0, seen1 = _recorder(t0), _recorder(t1)
    s0, s1 = t0.init_state(), t1.init_state()
    assert "carry_batch" in s1 and "carry_batch" not in s0
    assert len(seen1) == 1 and _ctr_ok(s1) and s1["train_ctr"] == 0
    assert int(s1["carry_ctr_d"]) == 1

    def step():
        nonlocal s0, s1
        s0, l0 = t0.train_step(s0)
        s1, l1 = t1.train_step(s1)
        assert torch.equal(l0, l1) and torch.isfinite(l0)
        for k in COUNTERS:
            assert torch.equal(getattr(t0, k), getattr(t1, k)), k
        assert int(t1.last_edges) > 0
        assert s0["train_ctr"] == s1["train_ctr"]
        assert _ctr_ok(s0) and _ctr_ok(s1)
        assert int(s1["carry_ctr_d"]) == s1["train_ctr"] + 1
        if case == "map":
            assert bool((s1["pos_map"] == INT32_MAX).all())

    for _ in range(4):
        step()
    s0, acc0 = t0.run_eval(s0, Mode.VALID)
    s1, acc1 = t1.run_eval(s1, Mode.VALID)
    assert acc0 == acc1 and _ctr_ok(s1)
    assert s1["valid_ctr"] == int(s1["valid_ctr_d"]) == t1.schedule.valid_step
    step()
    for a, b in zip(s0["model"].parameters(), s1["model"].parameters()):
        assert torch.equal(a, b)
    # the interbatch trainer has sampled one batch ahead: the carry
    assert len(seen1) == len(seen0) + 1 == 6
    for (ia, ea), (ib, eb) in zip(seen0, seen1):
        assert torch.equal(ia, ib) and torch.equal(ea, eb)
    if case == "map":
        assert bool((s0["pos_map"] == INT32_MAX).all())
    if case == "host":
        assert t1.cache_plan is not None
        assert 0 < int(t1.last_feat_hits) < int(t1.last_slots)
        t0.close()
        t1.close()


def test_interbatch_fit_and_refusals(ds, hds):
    """``fit`` under interbatch takes one step a call and ends where the
    plain ``fit`` does (losses, valid and test accuracy, parameters, the
    counters); ``interbatch`` with ``fused_steps`` > 1 is refused, as
    JAX's ``fused_steps applies to the fused single-program path``; with
    the staged host pipeline ``interbatch`` is ignored, as in JAX."""
    cfg = replace(_config(ds, "sort"), train=replace(
        _config(ds, "sort").train, epochs=2))
    t0, t1 = Trainer(ds, cfg, "cpu"), Trainer(ds, _interbatch(cfg), "cpu")
    calls = []
    step = t1.train_step

    def counted(state):
        calls.append(1)
        return step(state)
    t1.train_step = counted
    s0, st0 = t0.fit(verbose=False)
    s1, st1 = t1.fit(verbose=False)
    n = t1.schedule.train_step
    assert len(calls) == 2 * n == s1["train_ctr"] == int(s1["train_ctr_d"])
    assert [(a.train_loss, a.valid_acc) for a in st0] == \
        [(b.train_loss, b.valid_acc) for b in st1]
    assert t0.test_acc == t1.test_acc
    assert t1.epoch_metrics[1].edges == t0.epoch_metrics[1].edges
    for a, b in zip(s0["model"].parameters(), s1["model"].parameters()):
        assert torch.equal(a, b)
    # the last step leaves a carry that is never trained: the next batch
    assert int(s1["carry_ctr_d"]) == 2 * n + 1
    with pytest.raises(ValueError, match="fused single-program path"):
        Trainer(ds, _interbatch(replace(cfg, train=replace(
            cfg.train, fused_steps=2))), "cpu")
    # JAX's rule (legion_tpu/train.py:516, :872): staged with interbatch
    # builds, and its step is the staged pipeline's, with no carry
    hcfg = _config(hds, "host")
    hcfg = replace(hcfg, cache=replace(hcfg.cache, host_transfer="staged"))
    tr = Trainer(hds, _interbatch(hcfg), "cpu")
    assert tr._staged_host and not tr.interbatch
    s, loss = tr.train_step(tr.init_state())
    assert "carry_batch" not in s and tr._staged._ctr == 1
    assert torch.isfinite(loss) and s["train_ctr"] == 1
    tr.close()
