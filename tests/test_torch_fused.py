"""The port's fused train step (``TrainConfig.fused_steps``) and its step
keys, on the CPU: K10 ``step_keys``' plain version against the host
``fold_in`` chain, one fused call against K single steps, keys that depend
only on the counters, ``fit``'s divisibility rule, and dropout's scale
against JAX's (feature dropout, and attention dropout's in both of its
regimes)."""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import legion_tpu.models.common as jcommon
from legion_tpu.models.common import dropout as jax_dropout
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_device_dataset
from legion_tpu_torch.graph import DeviceCSR
from legion_tpu_torch.ops import dropout as kdrop
from legion_tpu_torch.ops import kernels
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.sampling import access
from legion_tpu_torch.sampling.access import (draw_keys, fold_in, hop_keys,
                                              step_keys, step_keys_plain)
from legion_tpu_torch.train import Trainer
from test_torch_parity import inject_masks


def _host_words(base: int, ctr: int, tag: int, L: int) -> np.ndarray:
    """The host chain: hop k's words are draw_keys(fold_in(fold_in(
    fold_in(base, ctr), tag), k)), as uint32."""
    step = fold_in(fold_in(base, ctr), tag)
    return np.array([draw_keys(fold_in(step, k)) for k in range(L)],
                    np.uint32)


@settings(max_examples=200, deadline=None)
@given(base=st.integers(0, 2 ** 63 - 1), ctr=st.integers(0, 2 ** 31 - 1),
       tag=st.sampled_from([0, 1]), L=st.integers(1, 4))
def test_step_keys_plain_equals_host_fold_in_chain(base, ctr, tag, L):
    """K10's plain version (int64 torch ops) equals the host fold_in /
    draw_keys chain bit for bit, and adds one to the counter."""
    b = torch.tensor(base, dtype=torch.int64)
    c = torch.tensor(ctr, dtype=torch.int64)
    words = step_keys(b, c, tag, L)        # CPU tensors: the plain version
    assert words.dtype == torch.int32 and tuple(words.shape) == (L, 4)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  _host_words(base, ctr, tag, L))
    assert int(c) == ctr + 1 and int(b) == base
    # hop_keys of the step key is the same chain, made on the host
    np.testing.assert_array_equal(
        hop_keys(fold_in(fold_in(base, ctr), tag), L, "cpu").numpy(),
        words.numpy())


@settings(max_examples=100, deadline=None)
@given(base=st.integers(-2 ** 63, 2 ** 63 - 1),
       ctr=st.integers(0, 2 ** 32 + 5), tag=st.sampled_from([0, 1]),
       L=st.integers(1, 3), n_dev=st.sampled_from([2, 4, 8]))
def test_step_keys_plain_members_equal_host_fold_in_chain(base, ctr, tag, L,
                                                          n_dev):
    """With n_dev members, K10's plain version writes [n_dev, L, 4]: member
    d's rows are the host chain with d folded in after the tag, JAX's
    ``_device_key`` order fold_in(fold_in(fold_in(base, ctr), tag), d), and
    the counter advances once."""
    c = torch.tensor(ctr, dtype=torch.int64)
    words = step_keys(torch.tensor(base, dtype=torch.int64), c, tag, L, n_dev)
    assert words.dtype == torch.int32 and tuple(words.shape) == (n_dev, L, 4)
    step = fold_in(fold_in(base % 2 ** 64, ctr), tag)
    for d in range(n_dev):
        np.testing.assert_array_equal(
            words[d].numpy(), hop_keys(fold_in(step, d), L, "cpu").numpy())
    assert int(c) == ctr + 1
    # member 0 is folded too: its words are not the one-device words
    assert not torch.equal(words[0], step_keys_plain(
        torch.tensor(base, dtype=torch.int64), torch.tensor(ctr), tag, L))


@settings(max_examples=100, deadline=None)
@given(base=st.integers(-2 ** 63, 2 ** 63 - 1),
       ctr=st.integers(0, 2 ** 32 + 5), tag=st.sampled_from([0, 1]),
       L=st.integers(1, 3), n_dev=st.sampled_from([2, 4, 8]),
       data=st.data())
def test_step_keys_plain_at_an_offset_is_a_slice_of_all_members(
        base, ctr, tag, L, n_dev, data):
    """A rank that holds members d0 .. d0 + n - 1 of n_dev: K10's plain
    version writes rows d0:d0+n of the all-members result, each the host
    chain fold_in(fold_in(fold_in(base, ctr), tag), d); one member alone
    on its rank in a world of n_dev > 1 folds its global index (no
    one-device words); offset 0 gives today's words."""
    d0 = data.draw(st.integers(0, n_dev - 1))
    n = data.draw(st.integers(1, n_dev - d0))
    b = torch.tensor(base, dtype=torch.int64)
    c_all, c = torch.tensor(ctr), torch.tensor(ctr)
    full = step_keys(b, c_all, tag, L, n_dev)
    part = step_keys(b, c, tag, L, n_dev, d0, n)
    assert tuple(part.shape) == (n, L, 4) and int(c) == ctr + 1
    assert torch.equal(part, full[d0:d0 + n])
    step = fold_in(fold_in(base % 2 ** 64, ctr), tag)
    for i in range(n):
        np.testing.assert_array_equal(
            part[i].numpy(), hop_keys(fold_in(step, d0 + i), L, "cpu").numpy())
    alone = step_keys(b, torch.tensor(ctr), tag, L, n_dev, d0, 1)
    assert torch.equal(alone[0], full[d0])
    assert not torch.equal(alone[0], step_keys(b, torch.tensor(ctr), tag, L))
    assert torch.equal(step_keys(b, torch.tensor(ctr), tag, L, n_dev, 0),
                       full)


def test_step_keys_refuses_members_outside_the_world():
    b, c = torch.zeros((), dtype=torch.int64), torch.zeros((),
                                                          dtype=torch.int64)
    for n_dev, first, n in ((4, 3, 2), (4, -1, 1), (1, 1, 1), (4, 0, 0)):
        with pytest.raises(ValueError, match="step_keys: members"):
            step_keys(b, c, 0, 2, n_dev, first, n)


def test_step_keys_plain_at_the_edges():
    """Counters and keys whose halves have the top bit set (where an
    arithmetic shift of int64 or an unmasked cast goes wrong), and a
    negative int64 base key (bits of a key at or above 2**63)."""
    for base in (0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1,
                 -1, -2 ** 63):
        for ctr in (0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5):
            for tag in (0, 1):
                c = torch.tensor(ctr, dtype=torch.int64)
                w = step_keys_plain(torch.tensor(base, dtype=torch.int64), c,
                                    tag, 3)
                np.testing.assert_array_equal(
                    w.numpy().view(np.uint32),
                    _host_words(base % 2 ** 64, ctr, tag, 3))
                assert int(c) == ctr + 1
    with pytest.raises(ValueError, match="step_keys"):
        step_keys(torch.zeros((), dtype=torch.int32),
                  torch.zeros((), dtype=torch.int64), 0, 2)


def _csr(rng, V=400, E=6000):
    deg = rng.multinomial(E, np.ones(V) / V)
    deg[:5] = 0
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, V, int(indptr[-1])).astype(np.int32)
    return DeviceCSR.from_numpy(indptr.astype(np.int32), indices, "cpu")


@pytest.mark.parametrize("windowed", [True, False])
def test_draws_from_key_words_equal_draws_from_the_int_key(windowed):
    """K3's and K5's plain versions draw the same neighbours from a hop's
    [4] key words (as K10 writes them) as from the int key they come
    from."""
    rng = np.random.default_rng(3)
    csr = _csr(rng)
    acc = access.WindowedCSRAccess.from_csr(csr, 16) if windowed \
        else access.DeviceCSRAccess(csr)
    front = torch.from_numpy(rng.integers(-1, 400, 300).astype(np.int32))
    for key in (0, 12345, 2 ** 64 - 1):
        words = access.key_tensor(key, "cpu")
        for fo in (1, 7, 25):
            np.testing.assert_array_equal(
                acc.sample_neighbors(front, fo, words).numpy(),
                acc.sample_neighbors(front, fo, key).numpy())


def _dataset():
    return synthesize_device_dataset("cpu", num_nodes=3000, num_edges=60000,
                                     feature_dim=100, num_classes=8,
                                     batch_size=64, valid_size=256,
                                     test_size=256)


def _config(ds, dedup="sort", model="graphsage", fused=1, **train_kw):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=64,
                              eval_batch_size=64, dedup=dedup,
                              neighbor_window=64, dedup_last_hop=False,
                              auto_compact=True, cap_headroom=1.03),
        cache=CacheConfig(presample_steps=8),
        train=TrainConfig(model=model, hidden_dim=64, epochs=1,
                          dropout=0.5, fused_steps=fused, **train_kw),
        mesh=MeshConfig.for_devices(1))


@pytest.fixture(scope="module")
def ds():
    return _dataset()


def _params(state):
    return [p.detach().clone() for p in state["model"].parameters()]


@pytest.mark.parametrize("case", ["sort", "map", "gat"])
def test_fused_call_equals_single_steps(ds, case):
    """fused_steps=3 (port of tests/test_train.py:108-131): one
    ``train_step`` call equals three single steps exactly on the CPU, in
    the mean loss, the summed counters, train_ctr (both twins) and the
    parameters; for both dedup modes and for GAT with feature and
    attention dropout on."""
    kw = dict(model="gat", gat_heads=(2, 1)) if case == "gat" \
        else dict(dedup=case)
    one = Trainer(ds, _config(ds, **kw), "cpu")
    fused = Trainer(ds, _config(ds, fused=3, **kw), "cpu")
    assert fused.fused_steps == 3
    s1, s3 = one.init_state(), fused.init_state()
    for _ in range(2):     # the second call starts from a trained state
        losses, counts = [], []
        for _ in range(3):
            s1, loss = one.train_step(s1)
            losses.append(loss)
            counts.append(torch.stack([
                one.last_edges, one.last_slots, one.last_feat_hits,
                one.last_topo_hits, one.last_topo_total]))
        s3, loss3 = fused.train_step(s3)
        assert torch.equal(loss3, torch.stack(losses).mean())
        got = torch.stack([fused.last_edges, fused.last_slots,
                           fused.last_feat_hits, fused.last_topo_hits,
                           fused.last_topo_total])
        assert torch.equal(got, torch.stack(counts).sum(0,
                                                        dtype=torch.int32))
        assert int(got[0]) > 0
        assert s3["train_ctr"] == s1["train_ctr"]
        assert int(s3["train_ctr_d"]) == int(s1["train_ctr_d"]) \
            == s1["train_ctr"]
        for a, b in zip(_params(s3), _params(s1)):
            assert torch.equal(a, b)
    if case == "map":
        assert bool((s3["pos_map"] == 2 ** 31 - 1).all())


def test_batches_depend_only_on_the_counters(ds):
    """A trainer whose device and Python counters are set to c draws the
    batch an unbroken run draws at step c, whatever eval calls (in
    whichever order) came between; eval batches do not move the train
    keys."""
    c = 5

    def recorder(tr):
        seen = []
        orig = tr.sampler_t.sample

        def sample(*a, **kw):
            b = orig(*a, **kw)
            seen.append((b.node_ids.clone(), b.num_edges.clone()))
            return b
        tr.sampler_t.sample = sample
        return seen

    ref = Trainer(ds, _config(ds, dedup="map"), "cpu")
    seen_ref = recorder(ref)
    st_ref = ref.init_state()
    for _ in range(c + 1):
        st_ref, _ = ref.train_step(st_ref)

    for evals in ([Mode.VALID, Mode.TEST], [Mode.TEST, Mode.VALID], []):
        tr = Trainer(ds, _config(ds, dedup="map"), "cpu")
        seen = recorder(tr)
        st = tr.init_state()
        st["train_ctr"] = c
        st["train_ctr_d"].fill_(c)
        for m in evals:
            st, _ = tr.run_eval(st, m)
        st, _ = tr.train_step(st)
        assert len(seen) == 1
        for a, b in zip(seen[0], seen_ref[c]):
            assert torch.equal(a, b)
        # the batch is the one the sampler draws from the step key
        bs = tr.sampler_t.config.batch_size
        lid = c % tr.schedule.train_step
        again = tr.sampler_t.sample(
            tr.graph_access, tr.train_bank[lid * bs:(lid + 1) * bs],
            tr.step_key(c, 0), pos_map=st["pos_map"])
        assert torch.equal(again.node_ids, seen[0][0])


def test_eval_keys_come_from_the_eval_counter(ds):
    """An eval pass draws with tag 1 from its own counter: the same keys
    whatever the train counter is, and valid batch j equals test batch j's
    keys (JAX derives both from (base_key, ctr, 1))."""
    tr = Trainer(ds, _config(ds), "cpu")
    keys = []
    orig = tr.sampler_e.sample

    def sample(access_, seeds, key, **kw):
        keys.append(key.clone())
        return orig(access_, seeds, key, **kw)
    tr.sampler_e.sample = sample
    st = tr.init_state()
    st, _ = tr.run_eval(st, Mode.VALID)
    st, _ = tr.train_step(st)
    st, _ = tr.run_eval(st, Mode.TEST)
    n = tr.schedule.valid_step
    assert st["valid_ctr"] == int(st["valid_ctr_d"]) == n
    for j in range(n):
        np.testing.assert_array_equal(
            keys[j].numpy().view(np.uint32),
            _host_words(tr.config.train.seed + 1, j, 1, 2))
        assert torch.equal(keys[j], keys[n + j])


def test_fit_refuses_a_fused_steps_that_does_not_divide(ds):
    """fit asserts train_step % K == 0 as JAX does
    (legion_tpu/train.py:937-942) and takes train_step // K calls an epoch
    for a K that divides; interbatch is refused with fused_steps 2, as
    JAX refuses it (``legion_tpu/train.py:191-193``), and with fused_steps
    1 it builds and fits."""
    tr = Trainer(ds, _config(ds), "cpu")
    n = tr.schedule.train_step
    bad = next(k for k in range(2, n + 2) if n % k)
    tr = Trainer(ds, _config(ds, fused=bad), "cpu")
    with pytest.raises(ValueError, match="must divide the epoch"):
        tr.fit(verbose=False)
    tr = Trainer(ds, _config(ds, fused=n), "cpu")
    calls = []
    step = tr.train_step

    def counted(state):
        calls.append(1)
        return step(state)
    tr.train_step = counted
    state, stats = tr.fit(verbose=False)
    assert len(calls) == 1 and state["train_ctr"] == n
    assert tr.epoch_metrics[0].steps == n and np.isfinite(stats[0].train_loss)
    for fused in (1, 2):
        cfg = _config(ds, fused=fused)
        cfg = replace(cfg, train=replace(cfg.train, interbatch=True))
        if fused > 1:
            with pytest.raises(ValueError, match="interbatch"):
                Trainer(ds, cfg, "cpu")
            continue
        tr = Trainer(ds, cfg, "cpu")
        state, stats = tr.fit(verbose=False)
        assert state["train_ctr"] == int(state["train_ctr_d"]) == n
        assert "carry_batch" in state and np.isfinite(stats[0].train_loss)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}


def _jax_mask(key, x, rate):
    """The keep mask JAX's dropout draws for x (legion_tpu/models/
    common.py:71-99), as numpy bool."""
    keep = 1.0 - rate
    if rate == 0.5 and x.ndim == 2 and x.shape[-1] % 32 == 0:
        words = jax.random.bits(key, (x.shape[0], x.shape[1] // 32),
                                jnp.uint32)
        bits = (words[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
        return np.asarray(bits.reshape(x.shape) != 0)
    if x.ndim >= 2 and x.size >= (1 << 20):
        kq = min(max(round(keep * 256), 1), 255)
        return np.asarray(jax.random.bits(key, x.shape, jnp.uint8) < kq)
    return np.asarray(jax.random.bernoulli(key, keep, x.shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rate", [((300, 70), 0.6), ((64, 256), 0.5),
                                        ((1024, 1024), 0.6)])
def test_dropout_equals_jax_bit_for_bit(shape, rate, dtype, monkeypatch):
    """With JAX's mask injected (in place of the keyed mask of
    ``ops/dropout.py::keep_mask_plain``), the port's dropout
    (``dropout_act``, no activation, no cast) gives JAX's bits: it divides
    by keep in the per-element and bit-unpacked regimes and multiplies by
    256 / kq in the u8 regime, each constant in x's dtype, as JAX's weakly
    typed scalar is."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_dropout(xj, rate, key, True).astype(jnp.float32))
    mask = torch.from_numpy(np.array(_jax_mask(key, xj, rate)))
    monkeypatch.setattr(kdrop, "keep_mask_plain", lambda *a, **k: mask)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = kdrop.dropout_act(xt, "none", None, rate,
                            torch.zeros(2, dtype=torch.int32), 0)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(25, 800, 1), (10, 13108, 8)])
def test_attention_dropout_equals_jax_bit_for_bit(shape, monkeypatch):
    """Attention dropout's plain arithmetic (``ops/dropout.py::
    attn_dropout_plain``, what K6 and K7 compute) equals JAX's
    ``dropout`` bit for bit, given the mask (the port's, drawn from the
    key at the attention fold and injected into JAX's draw): in regime 3
    (alpha divided by keep in f32) and in regime 2 (2^20 entries or more:
    alpha times 256 / kq), the sign of a zero too."""
    rate, layer = 0.6, 1
    words = torch.tensor([0x7F3A, 0x1BADB0], dtype=torch.int32)
    alpha = np.random.default_rng(8).random(shape).astype(np.float32)
    reg = kdrop.regime(shape, rate)
    assert reg == (2 if math.prod(shape) >= 1 << 20 else 3)
    applied = inject_masks(monkeypatch, (jcommon,), [kdrop.attn_fold(layer)],
                           words)
    want = np.asarray(jcommon.dropout(jnp.asarray(alpha), rate,
                                      jax.random.PRNGKey(0), True))
    assert applied == [(shape, kdrop.attn_fold(layer))]
    got = kdrop.attn_dropout_plain(torch.from_numpy(alpha),
                                   kdrop.AttnDrop(words, layer, rate))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert 0 < int((got != 0).sum()) < got.numel()
