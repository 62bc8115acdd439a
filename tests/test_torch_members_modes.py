"""``fused_steps`` and ``interbatch`` with members (``MeshConfig(Kc, Kg)``,
n_dev > 1, one process) on the CPU: JAX's ``shard_map`` step in its
``lax.scan`` form and in its pipelined form (``legion_tpu/train.py:
642-748``, tested by ``tests/test_train.py:72`` and ``:108``) against the
plain member step, which ``tests/test_torch_clique.py`` holds against
JAX's. On the CPU a fused call is K eager steps and a pipelined step runs
its halves one after the other, so both must equal the plain steps bit
for bit: losses, parameters, counters, sampled batches and ``pos_map``.
Also: every member's dropout draws from fold_in(fold_in(step key, d), 7),
member d's row of K10's dropout keys, feature dropout at fold i and GAT's
attention dropout at ``attn_fold(i)``; ``fit`` in each mode
ends where the plain ``fit`` does; a restored member state continues a
pipelined run bit for bit; the eval step waits for the side stream with
members as with one member."""

from dataclasses import replace

import pytest
import torch

from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_dataset
from legion_tpu_torch.ops import dropout as kdrop
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.sampling.access import dropout_words, fold_in
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                               save_checkpoint)

INT32_MAX = 2 ** 31 - 1
COUNTERS = ("last_edges", "last_slots", "last_feat_hits", "last_topo_hits",
            "last_topo_total")

# (mesh, dedup, map kind): a clique of 2 behind the clique caches with map
# dedup; two cliques of one member each (per-member caches); clique-HT-hash
# (a clique of 4, hash maps)
CASES = {
    "1x2-map": (MeshConfig(1, 2), "map", "direct"),
    "2x1-sort": (MeshConfig(2, 1), "sort", "direct"),
    "1x4-hash": (MeshConfig(1, 4), "sort", "hash"),
}


@pytest.fixture(scope="module")
def host_ds():
    return synthesize_dataset(num_nodes=3000, avg_degree=10, feature_dim=32,
                              num_classes=5, batch_size=64, train_frac=0.5,
                              seed=3)


def _cfg(ds, case, fused=1, interbatch=False, epochs=1, model="graphsage"):
    """``tests/test_torch_clique.py``'s member settings: features and
    topology on the host behind the caches, f32, dropout 0.5."""
    mesh, dedup, impl = CASES[case]
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=64,
                              eval_batch_size=64, dedup=dedup,
                              dedup_last_hop=False, neighbor_window=8),
        cache=CacheConfig(cache_bytes=40_000, presample_steps=2,
                          feature_residency="host", topo_residency="host",
                          map_impl=impl),
        train=TrainConfig(model=model, hidden_dim=32, epochs=epochs,
                          compute_dtype="float32", dropout=0.5,
                          pad_feature_dim=False, fused_steps=fused,
                          interbatch=interbatch),
        mesh=mesh)


def _params(state):
    return [p.detach().clone() for p in state["model"].parameters()]


def _counters(tr):
    return torch.stack([getattr(tr, k) for k in COUNTERS])


def _recorder(tr):
    """The ids and per-hop edge counts of every train batch ``tr``
    samples (all members), in order."""
    seen = []
    orig = tr.sampler_t.sample_members

    def sample_members(*a, **kw):
        bs = orig(*a, **kw)
        seen.append((torch.stack([b.node_ids for b in bs]).clone(),
                     torch.stack([b.num_edges for b in bs]).clone()))
        return bs
    tr.sampler_t.sample_members = sample_members
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_fused_member_call_equals_single_steps(host_ds, case):
    """fused_steps=3 with members: a call equals three member steps in
    the mean loss, the summed counters, both counters of the state, the
    parameters and ``pos_map``, twice (the second call from a trained
    state); map dedup leaves every member's map clean."""
    one = Trainer(host_ds, _cfg(host_ds, case), "cpu")
    fused = Trainer(host_ds, _cfg(host_ds, case, fused=3), "cpu")
    assert fused.n_dev == one.n_dev > 1 and fused.fused_steps == 3
    s1, s3 = one.init_state(), fused.init_state()
    for _ in range(2):
        losses, counts = [], []
        for _ in range(3):
            s1, loss = one.train_step(s1)
            losses.append(loss)
            counts.append(_counters(one))
        s3, loss3 = fused.train_step(s3)
        assert torch.equal(loss3, torch.stack(losses).mean())
        got = _counters(fused)
        assert torch.equal(got, torch.stack(counts).sum(0,
                                                        dtype=torch.int32))
        assert int(got[0]) > 0 and int(got[2]) > 0
        assert s3["train_ctr"] == s1["train_ctr"] == int(s3["train_ctr_d"])
        for a, b in zip(_params(s3), _params(s1)):
            assert torch.equal(a, b)
        assert torch.equal(s3["pos_map"], s1["pos_map"])
    if CASES[case][1] == "map":
        assert bool((s3["pos_map"] == INT32_MAX).all())
    one.close()
    fused.close()


@pytest.mark.parametrize("case", list(CASES))
def test_interbatch_members_equal_plain_steps(host_ds, case):
    """The port of ``tests/test_train.py:72`` with members: 4 steps, a
    valid pass, 1 more step on a pipelined trainer and a plain one give
    the same losses, counters, sampled batches (every member's), valid
    metric and parameters exactly; the carry holds every member's batch
    ([n_local, ...]); ``train_ctr_d`` counts trained batches and
    ``carry_ctr_d`` one more; map dedup's maps are clean after every
    step."""
    t0 = Trainer(host_ds, _cfg(host_ds, case), "cpu")
    t1 = Trainer(host_ds, _cfg(host_ds, case, interbatch=True), "cpu")
    n = t1.n_local
    seen0, seen1 = _recorder(t0), _recorder(t1)
    s0, s1 = t0.init_state(), t1.init_state()
    assert len(s1["carry_batch"]) == n and len(seen1) == 1
    assert s1["carry_x"].shape[:2] == (n, t1.sampler_t.max_ids)
    assert s1["carry_seeds"].shape == s1["carry_y"].shape == (n, 64)
    assert int(s1["carry_ctr_d"]) == 1 and s1["train_ctr"] == 0

    def step():
        nonlocal s0, s1
        s0, l0 = t0.train_step(s0)
        s1, l1 = t1.train_step(s1)
        assert torch.equal(l0, l1) and torch.isfinite(l0)
        assert torch.equal(_counters(t0), _counters(t1))
        assert int(t1.last_edges) > 0
        assert s0["train_ctr"] == s1["train_ctr"] == int(s1["train_ctr_d"])
        assert int(s1["carry_ctr_d"]) == s1["train_ctr"] + 1
        if CASES[case][1] == "map":
            assert bool((s1["pos_map"] == INT32_MAX).all())

    for _ in range(4):
        step()
    s0, acc0 = t0.run_eval(s0, Mode.VALID)
    s1, acc1 = t1.run_eval(s1, Mode.VALID)
    assert acc0 == acc1 and int(s1["total"]) > 0
    assert s1["valid_ctr"] == int(s1["valid_ctr_d"]) == t1.schedule.valid_step
    step()
    for a, b in zip(_params(s0), _params(s1)):
        assert torch.equal(a, b)
    assert len(seen1) == len(seen0) + 1 == 6
    for (ia, ea), (ib, eb) in zip(seen0, seen1):
        assert torch.equal(ia, ib) and torch.equal(ea, eb)
    t0.close()
    t1.close()


@pytest.mark.parametrize("mode", ["plain", "fused", "interbatch"])
def test_member_generators_draw_the_seeded_masks(host_ds, mode):
    """Every dropout mask of a member step is member d's, from its key
    fold_in(fold_in(fold_in(fold_in(base, ctr), 0), d), 7), in each mode,
    on GAT (feature and attention dropout at 0.6): feature dropout (K16's
    plain version) draws from member d's row of K10's dropout keys, the
    words of that key, layer i's bits from i; attention dropout (K6's and
    K7's plain versions) from the same words, layer i's mask equal to
    ``keep_mask_plain`` of that key at ``attn_fold(i)``, in layer order.
    No generator is left to seed: the masks follow the key alone."""
    from legion_tpu_torch.models import gat
    tr = Trainer(host_ds, _cfg(host_ds, "1x4-hash", model="gat",
                               fused=2 if mode == "fused" else 1,
                               interbatch=mode == "interbatch"), "cpu")
    feats, drawn = [], []
    orig_mask, orig_act = kdrop.keep_mask_plain, gat.dropout_act

    def mask_of(shape, rate, words, fold):
        out = orig_mask(shape, rate, words, fold)
        if fold >> 32:
            drawn.append((shape, rate, words.clone(), fold, out.clone()))
        return out

    def act(x, kind, out_dtype, rate, words, layer, train=True):
        if train and words is not None:
            feats.append((words.clone(), layer))
        return orig_act(x, kind, out_dtype, rate, words, layer, train)
    kdrop.keep_mask_plain, gat.dropout_act = mask_of, act
    try:
        state = tr.init_state()
        for _ in range(2):
            state, _ = tr.train_step(state)
    finally:
        kdrop.keep_mask_plain, gat.dropout_act = orig_mask, orig_act
    steps = state["train_ctr"]
    assert steps == (4 if mode == "fused" else 2)
    assert not hasattr(tr, "_drop_gens")
    n = tr.n_local
    L = tr.sampler_t.config.num_hops
    assert len(feats) == len(drawn) == steps * n * L
    base = tr.config.train.seed + 1
    for c in range(steps):
        for d in range(n):
            key = fold_in(fold_in(fold_in(base, c), 0), d)
            want = dropout_words(key, "cpu")
            j = (c * n + d) * L
            for i, (words, layer) in enumerate(feats[j:j + L]):
                assert layer == i and torch.equal(words, want)
            for i, (shape, rate, words, fold, mask) in enumerate(
                    drawn[j:j + L]):
                assert fold == kdrop.attn_fold(i) and rate == 0.6
                assert torch.equal(words, want)
                assert torch.equal(mask, orig_mask(shape, rate, want, fold))
    tr.close()


def _divisor(n):
    return next((k for k in range(2, n + 1) if n % k == 0), n)


@pytest.mark.parametrize("mode", ["fused", "interbatch"])
def test_fit_with_members_ends_where_plain_fit_does(host_ds, mode):
    """``fit`` over two epochs with members: in each mode the epoch
    losses, valid and test accuracy, parameters and epoch metrics equal
    the plain ``fit``'s; a fused run takes train_step // K calls an
    epoch, a pipelined one train_step, and its last carry is never
    trained."""
    t0 = Trainer(host_ds, _cfg(host_ds, "1x2-map", epochs=2), "cpu")
    n = t0.schedule.train_step
    K = _divisor(n) if mode == "fused" else 1
    t1 = Trainer(host_ds, _cfg(host_ds, "1x2-map", epochs=2, fused=K,
                               interbatch=mode == "interbatch"), "cpu")
    calls = []
    step = t1.train_step

    def counted(state):
        calls.append(1)
        return step(state)
    t1.train_step = counted
    s0, st0 = t0.fit(verbose=False)
    s1, st1 = t1.fit(verbose=False)
    assert len(calls) == 2 * n // K
    assert s1["train_ctr"] == int(s1["train_ctr_d"]) == 2 * n
    assert [(a.train_loss, a.valid_acc) for a in st0] == \
        [(b.train_loss, b.valid_acc) for b in st1]
    assert t0.test_acc == t1.test_acc
    assert [(m.steps, m.edges, m.feat_hits) for m in t0.epoch_metrics] == \
        [(m.steps, m.edges, m.feat_hits) for m in t1.epoch_metrics]
    for a, b in zip(_params(s0), _params(s1)):
        assert torch.equal(a, b)
    if mode == "interbatch":
        assert int(s1["carry_ctr_d"]) == 2 * n + 1
    t0.close()
    t1.close()


def test_restored_member_state_continues_a_pipelined_run(host_ds,
                                                         tmp_path):
    """A pipelined member run of 5 steps, against 2 steps, a checkpoint,
    a restore into a fresh pipelined trainer (its carry primed at the
    restored counter, for every member) and 3 more steps: the last 3
    losses, counters and the parameters are equal bit for bit."""
    cfg = _cfg(host_ds, "1x4-hash", interbatch=True)
    ta = Trainer(host_ds, cfg, "cpu")
    sa = ta.init_state()
    la = []
    for _ in range(5):
        sa, loss = ta.train_step(sa)
        la.append((loss, _counters(ta)))
    tb = Trainer(host_ds, cfg, "cpu")
    sb = tb.init_state()
    for _ in range(2):
        sb, _ = tb.train_step(sb)
    save_checkpoint(str(tmp_path), sb, sb["train_ctr"])
    tc = Trainer(host_ds, cfg, "cpu")
    sc = restore_checkpoint(str(tmp_path), tc)
    assert sc["train_ctr"] == 2 and int(sc["carry_ctr_d"]) == 3
    assert len(sc["carry_batch"]) == tc.n_local
    for i in range(3):
        sc, loss = tc.train_step(sc)
        assert torch.equal(loss, la[2 + i][0])
        assert torch.equal(_counters(tc), la[2 + i][1])
    for a, b in zip(_params(sa), _params(sc)):
        assert torch.equal(a, b)
    for t in (ta, tb, tc):
        t.close()


def test_eval_waits_for_the_side_stream_with_members(host_ds):
    """Under ``interbatch`` every eval batch first calls ``_wait_side``
    (on a card: the current stream waits for the side stream, whose
    sampling writes ``pos_map`` and the carry), with members as with one
    member."""
    for case, mesh in (("1x2-map", None), ("1x4-hash", None),
                       ("1x2-map", MeshConfig(1, 1))):
        cfg = _cfg(host_ds, case, interbatch=True)
        tr = Trainer(host_ds, replace(cfg, mesh=mesh or cfg.mesh), "cpu")
        waits = []
        tr._wait_side = lambda: waits.append(1)
        state = tr.init_state()
        state, _ = tr.train_step(state)
        state, acc = tr.run_eval(state, Mode.VALID)
        assert len(waits) == tr.schedule.valid_step > 0
        assert 0.0 <= acc <= 1.0
        tr.close()
