"""The port across processes on the CPU: ranks of ``torch.distributed``
over gloo, one spawned process a rank, each started through the launcher
as JAX starts its processes (``run.main --coordinator --num-processes
--process-id``; ``tests/test_multiprocess.py`` and ``tests/mp_worker.py``
do the same for the JAX package).

Both layouts of ``parallel/mesh.py`` are held three ways: every rank
returns the same losses and accuracies bit for bit; every sampled id, and
every fetched row, equals the one-process run of the same members (itself
held against JAX's ``shard_map`` in ``tests/test_torch_clique.py``); the
losses equal that run's within rtol 1e-5 (the mean over the ranks sums in
another order); the same in both layouts with ``fused_steps``, with
``interbatch`` and with the staged host pipeline. Also: ``exchange`` over 2 and 4 ranks against the
one-process transpose, a resumed 2-rank run against the unbroken one, and
``make_mesh``'s shapes and members against JAX's mesh, and its rule,
without processes.

Run as a script, this file is one rank (``_worker``)."""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher's synthetic dataset, at mp_worker.py's widths
SYNTH = ["--dataset-name", "synthetic", "--nodes", "6000", "--avg-degree",
         "8", "--feature-dim", "16", "--classes", "5", "--train-batch-size",
         "32", "--fanout", "4", "3", "--hidden", "16", "--no-compact",
         "--device", "cpu"]
HOST = ["--features", "host", "--cache-memory", "40000"]
RANK_TIMEOUT = 90


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _overrides(cache, train=None):
    """The launcher with ``cache`` and ``train`` fields set in its config:
    the topology on the host, the map kind, ``fused_steps`` and
    ``interbatch`` have no flag (in either package)."""
    from dataclasses import replace

    from legion_tpu_torch import run
    orig = run.build_config

    def build(args):
        cfg = orig(args)
        return replace(cfg, cache=replace(cfg.cache, **cache),
                       train=replace(cfg.train, **(train or {})))
    run.build_config = build
    try:
        yield
    finally:
        run.build_config = orig


def _launch(argv, cache, train=None):
    """``run.main(argv)`` under ``_overrides(cache, train)``, recording every
    train step's counter and loss and every train batch's ids and fetched
    rows. Returns (trainer, records, epoch stats)."""
    from legion_tpu_torch import run
    from legion_tpu_torch.train import Trainer
    rec = {"ctr": [], "loss": [], "ids": [], "x": []}
    step, fetch = Trainer.train_step, Trainer._member_sample_fetch

    def train_step(tr, state):
        rec["ctr"].append(state["train_ctr"])
        out = step(tr, state)
        rec["loss"].append(float(out[1]))
        return out

    def member_sample_fetch(tr, state, sampler, seeds, keys):
        out = fetch(tr, state, sampler, seeds, keys)
        if sampler is tr.sampler_t:
            rec["ids"].append(torch.stack([b.node_ids for b in out[0]])
                              .numpy().copy())
            rec["x"].append(out[1].float().numpy().copy())
        return out
    Trainer.train_step = train_step
    Trainer._member_sample_fetch = member_sample_fetch
    try:
        with _overrides(cache, train):
            tr, _, stats = run.main(argv)
    finally:
        Trainer.train_step, Trainer._member_sample_fetch = step, fetch
    tr.close()
    return tr, rec, stats


def _result(tr, rec, stats):
    return dict(ctr=rec["ctr"], loss=rec["loss"],
                acc=[s.valid_acc for s in stats] + [tr.test_acc],
                first=tr.first, n_local=tr.n_local,
                feature_source=type(tr.feature_source).__name__,
                graph_access=type(tr.graph_access).__name__,
                staged=tr._staged_host)


def _worker(spec):
    """One rank: ``spec["runs"]`` launcher runs (argv after the shared
    ones) with the coordinator flags and each run's ``spec["train"]``
    fields, or the exchange check; writes
    ``rank<r>.json`` (and ``.npz`` of the runs' ids and rows) to
    ``spec["out"]``."""
    torch.set_num_threads(1)
    r, W = spec["rank"], spec["world"]
    out = os.path.join(spec["out"], f"rank{r}")
    if spec["kind"] == "exchange":
        return _exchange_worker(spec, out)
    mp = ["--coordinator", f"127.0.0.1:{spec['port']}", "--num-processes",
          str(W), "--process-id", str(r)]
    results, arrays = [], {}
    for i, argv in enumerate(spec["runs"]):
        tr, rec, stats = _launch(SYNTH + argv + mp, spec["cache"],
                                 spec["train"][i])
        results.append(_result(tr, rec, stats))
        if rec["ids"]:      # the staged pipeline fetches on its own
            arrays[f"ids{i}"] = np.stack(rec["ids"])
            arrays[f"x{i}"] = np.stack(rec["x"])
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(results, f)


def _exchange_worker(spec, out):
    """Blocks [1, W(from), W(to), 3, 5] made from one seed on every rank:
    rank r exchanges its row in the clique group of ``make_mesh`` (layout
    (b), one clique of W) and must get row r of the one-process transpose,
    f32 and bf16, with two all-to-all calls counted."""
    import torch.distributed as dist

    from legion_tpu_torch.cache.collective import exchange
    from legion_tpu_torch.config import MeshConfig
    from legion_tpu_torch.parallel import mesh as pmesh
    from legion_tpu_torch.parallel import multihost
    r, W = spec["rank"], spec["world"]
    multihost.initialize(f"127.0.0.1:{spec['port']}", W, r, "cpu")
    mesh = pmesh.make_mesh(MeshConfig(1, W), W, r)
    assert mesh.clique_group is not None and mesh.n_local == 1
    pmesh.reset_collective_counts()
    g = torch.Generator().manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((1, W, W, 3, 5), generator=g).to(dt)
        got = exchange(x[:, r:r + 1], mesh.clique_group)
        want = exchange(x)[:, r:r + 1]
        assert got.dtype == dt and torch.equal(got, want), (dt, got, want)
    assert pmesh.COLLECTIVES["all_to_all"]["calls"] == 2
    dist.destroy_process_group()
    with open(out + ".json", "w") as f:
        json.dump("ok", f)


def _run_ranks(kind, world, tmp_path, runs=(), cache=None, train=None):
    """Start ``world`` ranks of this file as processes; fail with a
    rank's output as soon as one fails (the others are killed), or at
    RANK_TIMEOUT. Returns each rank's json and npz."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, logs = [], [tmp_path / f"rank{r}.log" for r in range(world)]
    for r in range(world):
        spec = dict(kind=kind, rank=r, world=world, port=port,
                    out=str(tmp_path), runs=list(runs), cache=cache or {},
                    train=list(train or [{}] * len(runs)))
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 json.dumps(spec)], stdout=log, stderr=subprocess.STDOUT,
                cwd=ROOT, env=env))
    t0 = time.time()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() - t0 > RANK_TIMEOUT:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed ({p.returncode}):\n" \
            f"{logs[r].read_text()[-4000:]}"
    res = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.json") as f:
            j = json.load(f)
        npz = tmp_path / f"rank{r}.npz"
        res.append((j, dict(np.load(npz)) if npz.exists() else None))
    return res


# (processes W, members a process, clique size, host caches, map)
CASES = {
    # JAX's mp_worker.py: layout (a), 2 cliques of 2 in each of 2 processes
    "a-2x4-kg2": (2, 4, 2, False, None),
    # layout (a): plain data parallel, one member a process
    "a-2x1-kg1": (2, 1, 1, False, None),
    # layout (b): one clique of 4 across 4 processes, features and
    # topology on the host behind the clique caches
    "b-4x1-kg4-direct": (4, 1, 4, True, "direct"),
    "b-4x1-kg4-hash": (4, 1, 4, True, "hash"),
}


def _argv(n_local, Kg, host):
    return ["--devices", str(n_local), "--clique-size", str(Kg),
            "--epoch", "2"] + (HOST if host else [])


def _cache(host, map_impl):
    return dict(topo_residency="host", map_impl=map_impl) if host else {}


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_equal_each_other_and_one_process(case, tmp_path):
    """W ranks through the launcher against one process of the same W *
    n_local members (``--devices W*n_local``)."""
    W, n, Kg, host, map_impl = CASES[case]
    ranks = _run_ranks("train", W, tmp_path, [_argv(n, Kg, host)],
                       _cache(host, map_impl))
    tr, ref, _ = _launch(SYNTH + _argv(W * n, Kg, host),
                         _cache(host, map_impl))
    assert tr.n_dev == W * n and tr.mesh is None
    j0 = ranks[0][0][0]
    assert len(j0["loss"]) == 2 * tr.schedule.train_step >= 2
    for r, (j, arr) in enumerate(ranks):
        j = j[0]
        assert (j["first"], j["n_local"]) == (r * n, n)
        assert j["loss"] == j0["loss"] and j["acc"] == j0["acc"]
        assert j["ctr"] == list(range(len(j["loss"])))
        if host:
            assert j["feature_source"] == "CliqueFeatureCache"
            assert j["graph_access"] == "CliqueTopoCache"
        mine = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(arr["ids0"],
                                      np.stack(ref["ids"])[:, mine])
        np.testing.assert_array_equal(arr["x0"], np.stack(ref["x"])[:, mine])
    np.testing.assert_allclose(j0["loss"], ref["loss"], rtol=1e-5)
    assert all(np.isfinite(j0["loss"]))


# (processes W, members a process, clique size, map) of the runs in each
# mode: layout (a), a clique of 2 inside each of 2 processes, and layout
# (b), one clique of 2 across 2 processes; host caches in both
MODE_CASES = {
    "a-2x2-kg2-hash": (2, 2, 2, "hash"),
    "b-2x1-kg2-direct": (2, 1, 2, "direct"),
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_ranks_in_each_mode_equal_each_other_and_one_process(case,
                                                             tmp_path):
    """``fused_steps`` = K (a divisor of the epoch) and ``interbatch`` over
    2 gloo ranks through the launcher, two epochs each, against the plain
    steps of one process of the same members: every rank returns the same
    losses and accuracies bit for bit; every train batch's ids and rows
    equal the one-process run's for the rank's members (the pipelined run
    samples one batch more, its last carry); a fused call's loss is the
    mean of the K plain losses and a pipelined step's the plain one,
    within rtol 1e-5 (the mean over the ranks sums in another order)."""
    W, n, Kg, impl = MODE_CASES[case]
    cache = _cache(True, impl)
    tr, ref, _ = _launch(SYNTH + _argv(W * n, Kg, True), cache)
    per_epoch = tr.schedule.train_step
    steps = 2 * per_epoch
    K = next(k for k in range(2, per_epoch + 1) if per_epoch % k == 0)
    ranks = _run_ranks("train", W, tmp_path, [_argv(n, Kg, True)] * 2,
                       cache, [{"fused_steps": K}, {"interbatch": True}])
    ids, x = np.stack(ref["ids"]), np.stack(ref["x"])
    loss_k = np.mean(np.reshape(ref["loss"], (-1, K)), axis=1)
    j0 = ranks[0][0]
    for r, (j, arr) in enumerate(ranks):
        fused, ib = j
        assert [(m["loss"], m["acc"]) for m in j] == \
            [(m["loss"], m["acc"]) for m in j0]
        assert fused["ctr"] == list(range(0, steps, K))
        assert ib["ctr"] == list(range(steps))
        mine = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(arr["ids0"], ids[:, mine])
        np.testing.assert_array_equal(arr["x0"], x[:, mine])
        assert arr["ids1"].shape[0] == steps + 1
        np.testing.assert_array_equal(arr["ids1"][:steps], ids[:, mine])
        np.testing.assert_array_equal(arr["x1"][:steps], x[:, mine])
    np.testing.assert_allclose(j0[0]["loss"], loss_k, rtol=1e-5)
    np.testing.assert_allclose(j0[1]["loss"], ref["loss"], rtol=1e-5)
    assert all(np.isfinite(j0[1]["loss"]))


# (processes W, members a process, clique size) of the staged runs: layout
# (a), one member a process, and layout (b), a clique of 2 across 2
# processes; features and topology on the host in both
STAGED_CASES = {"a-2x1-kg1": (2, 1, 1), "b-2x1-kg2": (2, 1, 2)}


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_ranks_equal_each_other_and_one_process(case, tmp_path):
    """``host_transfer="staged"`` over 2 gloo ranks through the launcher,
    two epochs: every rank returns the same losses and accuracies bit for
    bit; the losses equal one process's staged run of the same members
    within rtol 1e-5 (the mean over the ranks sums in another order), and
    that run's losses and accuracies equal its zero-copy run's."""
    W, n, Kg = STAGED_CASES[case]
    zero_copy = _cache(True, "direct")
    staged = dict(zero_copy, host_transfer="staged")
    ranks = _run_ranks("train", W, tmp_path, [_argv(n, Kg, True)], staged)
    tr, ref, ref_stats = _launch(SYNTH + _argv(W * n, Kg, True), staged)
    tz, zc, zc_stats = _launch(SYNTH + _argv(W * n, Kg, True), zero_copy)
    assert tr._staged_host and not tz._staged_host
    np.testing.assert_allclose(ref["loss"], zc["loss"], rtol=1e-5,
                               atol=1e-6)
    assert [s.valid_acc for s in ref_stats] == \
        [s.valid_acc for s in zc_stats] and tr.test_acc == tz.test_acc
    j0 = ranks[0][0][0]
    assert len(j0["loss"]) == 2 * tr.schedule.train_step >= 2
    for j, _ in ranks:
        assert j[0]["loss"] == j0["loss"] and j[0]["acc"] == j0["acc"]
        assert j[0]["ctr"] == list(range(len(j0["loss"])))
        assert j[0]["staged"]
    np.testing.assert_allclose(j0["loss"], ref["loss"], rtol=1e-5)
    assert all(np.isfinite(j0["loss"]))


def test_a_resumed_two_rank_run_continues_the_unbroken_one(tmp_path):
    """Layout (b) over 2 ranks with host caches: B1 one epoch with a
    checkpoint (written by rank 0), A two epochs, B2 one epoch resumed by
    every rank from B1's checkpoint: B2's first batch has A's ids and rows
    at the same counter exactly, and its loss within rtol 1e-6."""
    ck = str(tmp_path / "ck")
    base = ["--devices", "1", "--clique-size", "2"] + HOST
    ranks = _run_ranks("train", 2, tmp_path, [
        base + ["--epoch", "1", "--checkpoint-dir", ck],
        base + ["--epoch", "2"],
        base + ["--epoch", "1", "--resume", "--checkpoint-dir", ck]],
        _cache(True, "direct"))
    n = len(ranks[0][0][0]["loss"])
    assert sorted(os.listdir(ck)) == [f"ckpt_{n:010d}.pt",
                                      f"ckpt_{2 * n:010d}.pt"]
    for j, arr in ranks:
        b1, a, b2 = j
        assert b2["ctr"][0] == n == a["ctr"][n]
        np.testing.assert_array_equal(arr["ids2"][0], arr["ids1"][n])
        np.testing.assert_array_equal(arr["x2"][0], arr["x1"][n])
        np.testing.assert_allclose(b2["loss"][0], a["loss"][n], rtol=1e-6)
        assert [(x["loss"], x["acc"]) for x in j] == \
            [(x["loss"], x["acc"]) for x in ranks[0][0]]


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_over_ranks_is_the_transpose(world, tmp_path):
    assert [j for j, _ in _run_ranks("exchange", world, tmp_path)] == \
        ["ok"] * world


@pytest.mark.parametrize("cfg,W,rank,shape,n_local", [
    # JAX's test_multihost_mesh_axes: 2 processes of 2 cliques of 2
    ((4, 2), 2, 1, {"host": 2, "clique": 2, "member": 2}, 4),
    ((2, 1), 2, 1, {"host": 2, "clique": 1, "member": 1}, 1),
    ((1, 4), 1, 0, {"clique": 1, "member": 4}, 4),
    ((1, 4), 4, 3, {"clique": 1, "member": 4}, 1),
    ((2, 2), 4, 2, {"clique": 2, "member": 2}, 1),
])
def test_make_mesh_shapes(cfg, W, rank, shape, n_local):
    """``make_mesh`` without processes: the axes, their sizes, the rank's
    members; no process group (``torch.distributed`` is not up). Held
    against JAX's mesh of the same members over the 8 CPU devices: layout
    (a) is ``make_mesh(per-process config, num_hosts=W)``, layout (b) the
    single-host mesh laid over the cards. Process r's devices (JAX lists
    process 0's first) get, from the axis_index arithmetic of JAX's
    ``Trainer._device_key``, the members ``first_member ..
    first_member + n_local - 1``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from legion_tpu.config import MeshConfig as JMeshConfig
    from legion_tpu.parallel.mesh import make_mesh as jmake_mesh
    from legion_tpu.train import _shard_map
    from legion_tpu_torch.config import MeshConfig
    from legion_tpu_torch.parallel import dp_axes, dp_size, make_mesh
    m = make_mesh(MeshConfig(*cfg), W, rank)
    assert m.axis_names == tuple(shape) == dp_axes(m)
    assert m.shape == shape and dp_size(m) == cfg[0] * cfg[1]
    assert (m.rank, m.world, m.n_local, m.first_member) == (
        rank, W, n_local, rank * n_local)
    assert m.world_group is None and m.clique_group is None

    Kc, Kg = cfg
    if n_local % Kg == 0:       # layout (a)
        jm = jmake_mesh(JMeshConfig(Kc // W, Kg), num_hosts=W)
    else:                       # layout (b)
        jm = jmake_mesh(JMeshConfig(Kc, Kg))
    assert jm.axis_names == m.axis_names and dict(jm.shape) == m.shape

    def dev_index():
        dev = jnp.int32(0)
        for a in jm.axis_names:
            dev = dev * jm.shape[a] + jax.lax.axis_index(a)
        return dev.reshape((1,) * len(jm.axis_names))
    devs = np.asarray(jax.jit(_shard_map(
        dev_index, jm, (), P(*jm.axis_names)))())
    member_of = {jm.devices[i].id: int(devs[i])
                 for i in np.ndindex(jm.devices.shape)}
    mine = jax.devices()[m.first_member:m.first_member + n_local]
    assert [member_of[d.id] for d in mine] == list(
        range(m.first_member, m.first_member + n_local))


@pytest.mark.parametrize("cfg,W", [((3, 2), 2), ((1, 4), 2), ((3, 1), 2),
                                   ((1, 3), 2)])
def test_make_mesh_refuses_other_layouts(cfg, W):
    from legion_tpu_torch.config import MeshConfig
    from legion_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="members"):
        make_mesh(MeshConfig(*cfg), W, 0)


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]))
