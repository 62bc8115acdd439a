"""K15 ``hop_mean`` and the prefix fetch, on the CPU, against the JAX
package: the plain form (c) (rows read from the feature table by the
lane's id) against JAX's ``DeviceFeatureSource.fetch`` followed by
``hop_neighbor_mean`` on the aligned hop; GraphSAGE and ``lp_sage`` fed
``TableRows`` (the rows before the aligned last hop, and the table)
against JAX's ``apply`` / ``loss`` on the whole fetch; a trainer's step and
eval pass on the prefix fetch against the same on the whole fetch; and the
wrapper's refusals. The kernel itself runs on the card only
(``chip_smoke.py`` phase 2 holds it against these plain versions).

Tolerances: counts exactly; f32 sums taken in another order within
F32_ATOL (absolute) or F32_RTOL (relative to the largest reference value);
bf16 models within BF16_RTOL (``tests/test_torch_parity.py``). The prefix
fetch and the whole fetch read the same bits in the same order on the
CPU, so the port's two runs agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legion_tpu.cache.unified_cache import DeviceFeatureSource as JSource
from legion_tpu.config import SamplerConfig as JSamplerConfig
from legion_tpu.config import TrainConfig as JTrainConfig
from legion_tpu.models import make_model as jax_make_model
from legion_tpu.ops import hop_agg as jhop
from legion_tpu_torch.cache.unified_cache import DeviceFeatureSource
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_device_dataset
from legion_tpu_torch.models.common import make_model
from legion_tpu_torch.ops import hop_agg
from legion_tpu_torch.ops.hop_agg import TableRows
from legion_tpu_torch.pipeline import Mode
from legion_tpu_torch.train import Trainer
from legion_tpu_torch.utils.convert import params_from_jax
from test_torch_parity import (BF16_RTOL, F32_RTOL, batch_and_feats, close,
                               jdt, np32, tdt)

F32_ATOL = 1e-5


def _table_hop(rng, V, d, fanout, F, P, pad_frac):
    """A feature table [V, d] and an aligned last hop as the sampler lays
    it out: ids [P + fanout * F] (the prefix, then one id a lane, -1 for a
    pad) and src_l = P + lane for a valid lane, -1 for a pad."""
    table = rng.standard_normal((V, d)).astype(np.float32)
    E = fanout * F
    ids = rng.integers(0, V, P + E).astype(np.int32)
    ids[rng.random(P + E) < pad_frac] = -1
    lanes = np.arange(E, dtype=np.int32)
    src_l = np.where(ids[P:] >= 0, P + lanes, -1).astype(np.int32)
    return table, ids, src_l


# (fanout, F, P, offset, pad fraction): pads; the last possible offset
# (offset + F == num_dst); every lane a pad; fanout 1
TABLE_CASES = {"pads": (5, 40, 70, 12, 0.2),
               "last offset": (5, 40, 70, 30, 0.2),
               "all pads": (4, 16, 20, 3, 1.0),
               "fanout 1": (1, 24, 30, 6, 0.1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_table_form_matches_jax_fetch_then_mean(case, dtype):
    """Form (c)'s plain version (``hop_neighbor_sum`` / ``_mean`` with
    ids): the count exactly and the sum and mean to f32 order, against
    JAX's fetch of every id and its mean over the aligned hop."""
    fanout, F, P, offset, pad = TABLE_CASES[case]
    rng = np.random.default_rng(len(case))
    table, ids, src_l = _table_hop(rng, 300, 128, fanout, F, P, pad)
    num_dst = P
    tj = jnp.asarray(table, jdt(dtype))
    xj, _ = JSource(tj).fetch(jnp.asarray(ids))
    sj, cj = jhop.hop_neighbor_sum(xj, jnp.asarray(src_l), fanout,
                                   jnp.int32(offset), num_dst, P)
    mj = jhop.hop_neighbor_mean(xj, jnp.asarray(src_l), fanout,
                                jnp.int32(offset), num_dst, P)
    tt = torch.from_numpy(table).to(tdt(dtype))
    args = (tt, torch.from_numpy(src_l), fanout,
            torch.tensor(offset, dtype=torch.int32), num_dst, P,
            torch.from_numpy(ids))
    sp, cp = hop_agg.hop_neighbor_sum(*args)
    mp = hop_agg.hop_neighbor_mean(*args)
    assert sp.dtype == mp.dtype == cp.dtype == torch.float32
    np.testing.assert_array_equal(np32(cp), np32(cj))
    np.testing.assert_allclose(np32(sp), np32(sj), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(np32(mp), np32(mj), rtol=0, atol=F32_ATOL)
    # the same rows read through the whole fetch (form (b)): the same bits
    xp, _ = DeviceFeatureSource(tt).fetch(torch.from_numpy(ids))
    mb = hop_agg.hop_neighbor_mean(xp, *args[1:6])
    assert torch.equal(mb, mp)


def _table_batch(rng, scfg, V=500, in_pad=128, in_dim=100):
    """A batch of the port's sampler (and the same batch for JAX), a
    feature table [V, in_pad] (zero pad columns) and the ids the whole
    fetch reads."""
    pb, jb, _ = batch_and_feats(rng, scfg, V=V, in_pad=in_pad,
                                in_dim=in_dim)
    table = np.zeros((V, in_pad), np.float32)
    table[:, :in_dim] = rng.standard_normal((V, in_dim))
    ids = pb.node_ids[:scfg.max_ids].contiguous()
    return pb, jb, table, ids


MODEL_CASES = [("graphsage", "float32"), ("graphsage", "bfloat16"),
               ("lp_sage", "float32")]


@pytest.mark.parametrize("model,dtype", MODEL_CASES)
def test_models_on_the_prefix_fetch_match_jax(model, dtype):
    """GraphSAGE and ``lp_sage`` fed ``TableRows`` (``fetch_head``: the
    rows before the aligned last hop, which layer 0 reads from the table)
    against JAX's model on the whole fetch, with JAX's parameters through
    ``params_from_jax``: logits (the loss for ``lp_sage``) and every
    parameter gradient; and exactly equal to the port's model on the
    whole fetch."""
    kw = dict(fanouts=(6, 4), batch_size=30, dedup="sort",
              neighbor_window=16, dedup_last_hop=False,
              node_caps=(30, 160, 0))
    scfg, jcfg = SamplerConfig(**kw), JSamplerConfig(**kw)
    rng = np.random.default_rng(5)
    pb, jb, table, ids = _table_batch(rng, scfg)
    P = scfg.aligned_hop_offset(1)
    tkw = dict(model=model, hidden_dim=64, dropout=0.5,
               compute_dtype=dtype)
    jm = jax_make_model(JTrainConfig(**tkw), jcfg, 100, 10, in_dim_pad=128)
    params = jm.init(jax.random.PRNGKey(0))
    tt = torch.from_numpy(table).to(tdt(dtype))
    xj, _ = JSource(jnp.asarray(table, jdt(dtype))).fetch(
        jnp.asarray(ids.numpy()))
    valid = np.ones(30, bool)
    valid[[1, 7]] = False
    w = rng.standard_normal((30, 64 if model == "lp_sage" else 10)) \
        .astype(np.float32)

    def jfn(p):
        if model == "lp_sage":
            out = jm.loss(p, xj, jb, jnp.asarray(valid), train=False)
            return out, out
        logits = jm.apply(p, xj, jb, train=False)
        return jnp.sum(logits.astype(jnp.float32) * w), logits

    (_, oj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    src = DeviceFeatureSource(tt)
    x_head, hits = src.fetch_head(ids, P)
    x_full, hits_full = src.fetch(ids)
    assert isinstance(x_head, TableRows) and x_head.head.shape[0] == P
    assert int(hits) == int(hits_full) == int((ids >= 0).sum())
    outs = []
    for x in (x_head, x_full):
        pm = make_model(TrainConfig(**tkw), scfg, 100, 10, device="cpu",
                        in_dim_pad=128)
        pm.load_state_dict(params_from_jax(params))
        pm.eval()
        if model == "lp_sage":
            out = pm.loss(x, pb, scfg, torch.from_numpy(valid))
            out.backward()
        else:
            out = pm(x, pb, scfg)
            (out.float() * torch.from_numpy(w)).sum().backward()
        outs.append((out, [pm.layers[i][k].grad for i in range(2)
                           for k in ("w_self", "w_neigh", "b")]))
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    close(outs[0][0], oj, tol, "output")
    names = [(i, k) for i in range(2) for k in ("w_self", "w_neigh", "b")]
    for (i, k), g in zip(names, outs[0][1]):
        close(g, gj["layers"][i][k], tol, f"layer {i} {k}")
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def _trainer(model):
    bs = 63 if model == "lp_sage" else 64
    ds = synthesize_device_dataset("cpu", num_nodes=3000, num_edges=60000,
                                   feature_dim=100, num_classes=8,
                                   batch_size=bs, valid_size=256,
                                   test_size=256)
    cfg = LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=bs,
                              eval_batch_size=bs, dedup="sort",
                              neighbor_window=64, dedup_last_hop=False,
                              auto_compact=True, cap_headroom=1.03),
        cache=CacheConfig(presample_steps=8),
        train=TrainConfig(model=model, hidden_dim=64, epochs=1,
                          dropout=0.5, seed=3),
        mesh=MeshConfig.for_devices(1))
    return Trainer(ds, cfg, device="cpu")


@pytest.mark.parametrize("model", ["graphsage", "lp_sage"])
def test_trainer_prefix_fetch_equals_whole_fetch(model):
    """A CPU trainer on the device dataset fetches the ids before the
    aligned last hop only (``fetch_head``), yet counts every id's feature
    hit; two train steps and an eval pass from a fresh state give the same
    losses, counters, parameters and metric, bit for bit, as the same
    trainer with the whole fetch."""
    tr = _trainer(model)
    s = tr.sampler_t
    P = s.config.aligned_hop_offset(s.config.num_hops - 1)
    assert P is not None
    assert tr._table_head(s, tr.init_state()["model"]) == P
    fetched = []
    fetch_head = tr.feature_source.fetch_head

    def record(ids, n_head):
        fetched.append((ids.shape[0], n_head))
        return fetch_head(ids, n_head)
    tr.feature_source.fetch_head = record

    def run():
        state = tr.init_state()
        out = []
        for _ in range(2):
            state, loss = tr.train_step(state)
            out.append((float(loss), int(tr.last_feat_hits),
                        int(tr.last_slots), int(tr.last_edges)))
        state, metric = tr.run_eval(state, Mode.VALID)
        return out, metric, [p.detach().clone()
                             for p in state["model"].parameters()]

    steps, metric, params = run()
    assert fetched and all(f == (s.max_ids, P) for f in fetched)
    for _, hits, slots, _ in steps:
        assert 0 < hits == slots
    n = len(fetched)
    tr._table_head = lambda sampler, model: None     # the whole fetch
    steps_w, metric_w, params_w = run()
    assert len(fetched) == n
    assert steps == steps_w and metric == metric_w
    for a, b in zip(params, params_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["gat", "gcn"])
def test_trainer_fetches_every_id_for_models_without_table_rows(model):
    """A model that does not declare ``reads_table_rows`` (GAT, GCN) gets
    the whole fetch on the same one-member device path: ``_table_head``
    is None, and a train step fetches through ``fetch`` alone."""
    tr = _trainer(model)
    state = tr.init_state()
    assert not getattr(state["model"], "reads_table_rows", False)
    assert tr._table_head(tr.sampler_t, state["model"]) is None

    def refuse(ids, n_head):
        raise AssertionError("fetch_head called")
    tr.feature_source.fetch_head = refuse
    state, loss = tr.train_step(state)
    assert torch.isfinite(loss)


def _refusal_case(what):
    """Arguments of ``hop_neighbor_mean`` that it must refuse."""
    rows = torch.zeros((40, 8))
    src = torch.arange(30, dtype=torch.int32)
    off = torch.tensor(0, dtype=torch.int32)
    args = dict(h_src=rows, src_l=src, fanout=3, offset=off, num_dst=10,
                aligned_offset=None, ids=None)
    if what == "rows on another device":
        args["h_src"] = torch.zeros((40, 8), device="meta")
    elif what == "ids on another device":
        args.update(aligned_offset=0,
                    ids=torch.zeros(40, dtype=torch.int32, device="meta"))
    elif what == "f16 rows":
        args["h_src"] = rows.half()
    elif what == "int64 src_l":
        args["src_l"] = src.long()
    elif what == "lanes not a multiple of the fanout":
        args["src_l"] = src[:29]
    elif what == "frontier past num_dst":
        args["num_dst"] = 9
    elif what == "int64 offset":
        args["offset"] = off.long()
    elif what == "ids without an aligned offset":
        args["ids"] = torch.zeros(40, dtype=torch.int32)
    elif what == "ids shorter than the lanes":
        args.update(aligned_offset=20, ids=torch.zeros(40, dtype=torch.int32))
    elif what == "a table that takes a gradient":
        args.update(h_src=rows.requires_grad_(), aligned_offset=0,
                    ids=torch.zeros(40, dtype=torch.int32))
    elif what == "aligned lanes past the rows":
        args["aligned_offset"] = 11
    return args


@pytest.mark.parametrize("what", [
    "rows on another device", "ids on another device", "f16 rows",
    "int64 src_l", "lanes not a multiple of the fanout",
    "frontier past num_dst", "int64 offset",
    "ids without an aligned offset", "ids shorter than the lanes",
    "a table that takes a gradient", "aligned lanes past the rows"])
def test_wrapper_refuses_mixed_or_unsupported_inputs(what):
    """``hop_neighbor_sum`` and ``hop_neighbor_mean`` raise ValueError for
    inputs on two devices (no CPU fallback for a tensor off the CPU) and
    for what neither K15 nor its plain versions take."""
    args = _refusal_case(what)
    with pytest.raises(ValueError, match="hop_mean"):
        hop_agg.hop_neighbor_mean(**args)
    with pytest.raises(ValueError, match="hop_mean"):
        hop_agg.hop_neighbor_sum(**args)
