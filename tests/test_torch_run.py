"""The port's launcher, checkpoints and host-table rule, on the CPU:
``run.build_config`` against the JAX launcher's, a restored trainer
against the unbroken run (bit for bit), ``fit``'s checkpoints, the
launcher end to end on a synthetic and a prepared dataset, and the RAM
copy of read-only host tables."""

import dataclasses
import os
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from legion_tpu import run as jrun
from legion_tpu.data.format import infer_meta as jinfer_meta
from legion_tpu_torch import run
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import (LegionDataset, synthesize_dataset,
                                   synthesize_device_dataset,
                                   write_legion_dataset)
from legion_tpu_torch.data.format import infer_meta
from legion_tpu_torch.ops.host_memory import HostTable, bf16_pitch, bf16_rows
from legion_tpu_torch.tools import prepare
from legion_tpu_torch.train import Trainer, in_ram
from legion_tpu_torch.utils import (latest_step, restore_checkpoint,
                                    save_checkpoint)

PKG = Path(__file__).resolve().parent.parent / "legion_tpu_torch"
INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------- config
class _Parsed(Exception):
    pass


def _jax_args(argv, monkeypatch):
    """The namespace the JAX launcher parses from ``argv``."""
    seen = {}

    def grab(args):
        seen["args"] = args
        raise _Parsed
    monkeypatch.setattr(jrun, "build_config", grab)
    with pytest.raises(_Parsed):
        jrun.main(argv)
    monkeypatch.undo()
    return seen["args"]


def _prepared_dir(tmp_path, V=600, F=16, classes=5):
    """A Legion directory written by the port's prepare: an edge list
    converted, seed sets and features."""
    rng = np.random.default_rng(8)
    el = tmp_path / "edges.txt"
    src = rng.integers(0, V, 6 * V)
    dst = rng.integers(0, V, 6 * V)
    el.write_text("".join(f"{s} {d}\n" for s, d in zip(src, dst)))
    out = str(tmp_path / "prep")
    prepare.main(["convert", "--edgelist", str(el), "--out", out])
    n = os.path.getsize(os.path.join(out, "edge_src")) // 8 - 1
    prepare.main(["gensets", "--out", out, "--nodes", str(n),
                  "--train-frac", "0.3", "--valid-frac", "0.1",
                  "--test-frac", "0.1"])
    prepare.main(["synthfeat", "--out", out, "--nodes", str(n),
                  "--feature-dim", str(F), "--classes", str(classes)])
    return out


def _no_mesh(cfg):
    d = dataclasses.asdict(cfg)
    del d["mesh"]
    return d


@pytest.mark.parametrize("extra", [
    [],
    ["--model", "gcn"],
    ["--features", "host", "--cache-memory", "5000000"],
    ["--model", "gat", "--dedup", "map", "--window", "0", "--no-compact",
     "--exact-dedup", "--presample-steps", "4", "--fanout", "5", "3",
     "--hidden", "32", "--dropout", "0.1", "--lr", "0.01", "--epoch", "3",
     "--train-batch-size", "128"],
    "custom",
])
def test_build_config_matches_jax(extra, tmp_path, monkeypatch):
    """The same command line parses to the same flags (all but the
    port's ``--device``) and builds the same config, field by field (all
    but the mesh)."""
    if extra == "custom":
        extra = ["--dataset-name", "custom", "--dataset-path",
                 _prepared_dir(tmp_path), "--features", "host",
                 "--cache-memory", "100000", "--train-batch-size", "64"]
    ja = _jax_args(extra, monkeypatch)
    pa = run.parse_args(extra)
    pv = vars(pa)
    assert pv.pop("device") == "cuda"
    assert pv == vars(ja)
    got, want = run.build_config(pa), jrun.build_config(ja)
    assert got.mesh.num_devices == 1
    assert _no_mesh(got) == _no_mesh(want)
    if "custom" in extra:
        assert got.dataset.num_classes == 5 and got.dataset.train_size > 0


def test_infer_meta_of_prepared_dir_matches_jax(tmp_path):
    d = _prepared_dir(tmp_path)
    got = infer_meta(d, batch_size=64, cache_bytes=7, epochs=3)
    want = jinfer_meta(d, batch_size=64, cache_bytes=7, epochs=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_SMALL = ["--dataset-name", "synthetic", "--nodes", "3000",
          "--train-batch-size", "32", "--fanout", "4", "3", "--epoch", "1",
          "--hidden", "16", "--no-compact", "--device", "cpu"]


def test_launcher_trains_members_in_one_process():
    """``--devices 2 --clique-size 2``: one clique of two members on one
    device, behind the clique feature cache (JAX's flags, JAX's
    meanings)."""
    from legion_tpu_torch.cache.collective import CliqueFeatureCache
    tr, st, stats = run.main(_SMALL + ["--devices", "2", "--clique-size",
                                       "2", "--features", "host",
                                       "--cache-memory", "20000"])
    assert (tr.n_dev, tr.Kg, tr.n_local, tr.mesh) == (2, 2, 2, None)
    assert isinstance(tr.feature_source, CliqueFeatureCache)
    assert tuple(st["pos_map"].shape)[0] == 2
    assert np.isfinite(stats[0].train_loss) and int(tr.last_feat_hits) > 0
    tr.close()


def test_launcher_one_rank_world_equals_no_world():
    """``--coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0``
    (gloo on the CPU): every collective of a world runs, at one rank, and
    the run equals the run without a process group bit for bit."""
    import socket

    import torch.distributed as dist

    from legion_tpu_torch.parallel import mesh as pmesh
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    a, sa, stats_a = run.main(_SMALL)
    pmesh.reset_collective_counts()
    try:
        b, sb, stats_b = run.main(_SMALL + [
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
            "--process-id", "0"])
    finally:
        dist.destroy_process_group()
    assert b.mesh.world == 1 and b.mesh.world_group is not None
    n = b.schedule.train_step
    # a step's gradients, loss and counters, the digest, eval's sums twice
    assert pmesh.COLLECTIVES["all_reduce"]["calls"] == 3 * n + 1 + 2
    assert [(x.train_loss, x.valid_acc) for x in stats_a] == \
        [(x.train_loss, x.valid_acc) for x in stats_b]
    assert a.test_acc == b.test_acc
    for p, q in zip(_params(sa), _params(sb)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("argv", [["--devices", "3", "--clique-size", "2"],
                                  ["--devices", "2", "--clique-size", "4"]])
def test_launcher_refuses_other_layouts(argv):
    """A clique lies inside a process or across processes of one member
    each; any other layout is refused before the run starts."""
    with pytest.raises(ValueError, match="a clique lies either inside"):
        run.main(_SMALL + argv)


def test_launcher_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.main(["--nodes", "500"])


# ----------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def ds():
    return synthesize_device_dataset("cpu", num_nodes=2000, num_edges=30000,
                                     feature_dim=32, num_classes=5,
                                     batch_size=64, valid_size=128,
                                     test_size=128)


def _config(ds, dedup="sort", model="graphsage", fused=1, seed=0,
            compact=True, epochs=2, interbatch=False):
    kw = dict(gat_heads=(2, 1)) if model == "gat" else {}
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(6, 4), batch_size=64,
                              eval_batch_size=64, dedup=dedup,
                              neighbor_window=16, dedup_last_hop=False,
                              auto_compact=compact,
                              node_caps=None if compact
                              else (64, 448, 2304)),
        cache=CacheConfig(presample_steps=4),
        train=TrainConfig(model=model, hidden_dim=16, epochs=epochs,
                          dropout=0.5, fused_steps=fused, seed=seed,
                          interbatch=interbatch, **kw),
        mesh=MeshConfig.for_devices(1))


def _steps(tr, st, calls):
    losses = []
    for _ in range(calls):
        st, loss = tr.train_step(st)
        losses.append(loss)
    return st, losses


def _params(state):
    return [p.detach().clone() for p in state["model"].parameters()]


def _ptrs(state):
    return [p.data_ptr() for p in state["model"].parameters()]


@pytest.mark.parametrize("case", ["sort", "map", "sort-fused2",
                                  "map-fused2", "gat", "interbatch-sort",
                                  "interbatch-map", "interbatch-to-plain",
                                  "plain-to-interbatch"])
def test_restore_continues_bit_for_bit(ds, case, tmp_path):
    """Train 3 calls, save, take 2 more; a fresh trainer restored from
    the checkpoint takes the same 2 calls to the same losses and
    parameters exactly (port of tests/test_checkpoint.py), for both dedup
    modes, fused_steps 1 and 2, GAT with feature and attention dropout,
    interbatch (the restored carry primed at the checkpoint's counter),
    and a checkpoint of an interbatch trainer restored into a plain one
    and the reverse (``train_ctr`` counts trained batches in both). The
    restored state's parameters are its own: another live state of the
    restoring trainer keeps its addresses and values."""
    dedup = "map" if case.endswith("map") else "sort"
    model = "gat" if case == "gat" else "graphsage"
    fused = 2 if case.endswith("fused2") else 1
    save_ib = case.startswith("interbatch")
    load_ib = save_ib and case != "interbatch-to-plain" \
        or case == "plain-to-interbatch"
    cfg = _config(ds, dedup=dedup, model=model, fused=fused,
                  interbatch=save_ib)
    tr = Trainer(ds, cfg, "cpu")
    st, _ = _steps(tr, tr.init_state(), 3)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, st, st["train_ctr"])
    assert latest_step(ck) == 3 * fused == st["train_ctr"]
    st, la = _steps(tr, st, 2)
    pa = _params(st)

    tr2 = Trainer(ds, replace(cfg, train=replace(cfg.train,
                                                 interbatch=load_ib)), "cpu")
    live = tr2.init_state()
    live_ptrs, live_params = _ptrs(live), _params(live)
    st2 = restore_checkpoint(ck, tr2)
    assert not set(_ptrs(st2)) & set(live_ptrs)
    assert _ptrs(live) == live_ptrs
    for a, b in zip(_params(live), live_params):
        assert torch.equal(a, b)
    for k in ("train_ctr", "valid_ctr", "test_ctr"):
        assert st2[k] == int(st2[k + "_d"])
    assert st2["train_ctr"] == 3 * fused
    assert ("carry_batch" in st2) == load_ib
    if load_ib:
        assert int(st2["carry_ctr_d"]) == 3 * fused + 1
    assert bool((st2["pos_map"] == INT32_MAX).all())
    st2, lb = _steps(tr2, st2, 2)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    for a, b in zip(pa, _params(st2)):
        assert torch.equal(a, b)
    assert st2["train_ctr"] == st["train_ctr"] \
        == int(st2["train_ctr_d"]) == 5 * fused
    if dedup == "map":
        assert bool((st2["pos_map"] == INT32_MAX).all())


@pytest.mark.parametrize("mode", ["plain", "fused2", "interbatch"])
def test_gat_restore_mid_run_continues_with_attention_dropout(
        ds, mode, tmp_path, monkeypatch):
    """GAT with feature and attention dropout at 0.6 (the config's
    defaults): 3 calls, a checkpoint, 2 more; a fresh trainer restored from
    the checkpoint takes the same 2 calls to the same losses and
    parameters bit for bit, drawing at every attention layer of every step
    the unbroken run's masks (the same dropout key words and attention
    fold where the plain versions draw them), in plain steps, fused
    calls and pipelined steps."""
    from legion_tpu_torch.ops import dropout as kdrop
    fused = 2 if mode == "fused2" else 1
    cfg = _config(ds, model="gat", fused=fused,
                  interbatch=mode == "interbatch")
    assert cfg.train.gat_attn_drop == cfg.train.gat_feat_drop == 0.6
    drawn = []
    orig = kdrop.keep_mask_plain

    def mask_of(shape, rate, words, fold):
        if fold >> 32:
            drawn.append((shape, words.clone(), fold))
        return orig(shape, rate, words, fold)
    monkeypatch.setattr(kdrop, "keep_mask_plain", mask_of)
    tr = Trainer(ds, cfg, "cpu")
    st, _ = _steps(tr, tr.init_state(), 3)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, st, st["train_ctr"])
    drawn.clear()
    st, la = _steps(tr, st, 2)
    run_a = list(drawn)
    assert len(run_a) == 2 * fused * 2
    assert [f for _, _, f in run_a] == [kdrop.attn_fold(i) for i in (0, 1)] \
        * (2 * fused)
    drawn.clear()
    tr2 = Trainer(ds, cfg, "cpu")
    st2, lb = _steps(tr2, restore_checkpoint(ck, tr2), 2)
    assert len(drawn) == len(run_a)
    for (sa, wa, fa), (sb, wb, fb) in zip(run_a, drawn):
        assert sa == sb and fa == fb and torch.equal(wa, wb)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    for a, b in zip(_params(st), _params(st2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dedup", ["sort", "map"])
def test_clique_members_restore_continues_bit_for_bit(dedup, tmp_path):
    """A trainer of 4 members behind clique caches (features and topology
    on the host) saves after 3 steps; a new trainer restored from the
    checkpoint takes the next 2 steps to the unbroken run's losses and
    parameters exactly, with a clean [4, S] position map."""
    hds = synthesize_dataset(num_nodes=3000, avg_degree=10, feature_dim=32,
                             num_classes=5, batch_size=64, train_frac=0.5,
                             seed=3)
    cfg = LegionConfig(
        dataset=hds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=64,
                              eval_batch_size=64, dedup=dedup,
                              dedup_last_hop=False, neighbor_window=8),
        cache=CacheConfig(cache_bytes=40_000, presample_steps=2,
                          feature_residency="host", topo_residency="host"),
        train=TrainConfig(hidden_dim=16, epochs=1, dropout=0.5),
        mesh=MeshConfig(num_cliques=1, clique_size=4))
    tr = Trainer(hds, cfg, "cpu")
    st, _ = _steps(tr, tr.init_state(), 3)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, st, st["train_ctr"])
    st, la = _steps(tr, st, 2)
    pa = _params(st)
    tr2 = Trainer(hds, cfg, "cpu")
    st2 = restore_checkpoint(ck, tr2)
    assert tuple(st2["pos_map"].shape) == (4, tr2.sampler_t.state_size)
    assert st2["train_ctr"] == 3 == int(st2["train_ctr_d"])
    st2, lb = _steps(tr2, st2, 2)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    for a, b in zip(pa, _params(st2)):
        assert torch.equal(a, b)
    assert bool((st2["pos_map"] == INT32_MAX).all())
    tr.close()
    tr2.close()


@pytest.mark.parametrize("interbatch", [False, True])
def test_a_second_init_state_leaves_a_live_state_alone(ds, interbatch):
    """States are values (as JAX's ``init_state`` returns fresh arrays,
    ``legion_tpu/train.py:491-509``): a state trained 3 steps keeps its
    parameters through a second ``init_state`` on the same trainer, and
    its next 2 steps equal those of an unbroken run."""
    cfg = _config(ds, dedup="map", interbatch=interbatch)
    ref = Trainer(ds, cfg, "cpu")
    sr, lr = _steps(ref, ref.init_state(), 5)
    tr = Trainer(ds, cfg, "cpu")
    st, la = _steps(tr, tr.init_state(), 3)
    before = _params(st)
    other = tr.init_state()
    assert other["model"] is not st["model"]
    assert not set(_ptrs(other)) & set(_ptrs(st))
    for a, b in zip(before, _params(st)):
        assert torch.equal(a, b)
    st, lb = _steps(tr, st, 2)
    for a, b in zip(lr, la + lb):
        assert torch.equal(a, b)
    for a, b in zip(_params(sr), _params(st)):
        assert torch.equal(a, b)
    # the new state starts where a fresh trainer does
    for a, b in zip(_params(other), _params(ref.init_state())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("interbatch", [False, True])
def test_a_restore_leaves_a_live_state_alone(ds, interbatch, tmp_path):
    """A ``restore_checkpoint`` into the trainer of a live state, from a
    checkpoint of another seed (other weights, another base key), leaves
    that state's parameters and its later steps (keys, dropout) as an
    unbroken run's; the restored state continues the checkpoint's run."""
    cfg = _config(ds, interbatch=interbatch)
    other = replace(cfg, train=replace(cfg.train, seed=7))
    src = Trainer(ds, other, "cpu")
    ss, _ = _steps(src, src.init_state(), 2)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, ss, ss["train_ctr"])
    ss, l_src = _steps(src, ss, 2)

    ref = Trainer(ds, cfg, "cpu")
    sr, lr = _steps(ref, ref.init_state(), 5)
    tr = Trainer(ds, cfg, "cpu")
    st, la = _steps(tr, tr.init_state(), 3)
    before = _params(st)
    rs = restore_checkpoint(ck, tr)
    assert tr._base_key == int(rs["base_key"]) != int(st["base_key"])
    for a, b in zip(before, _params(st)):
        assert torch.equal(a, b)
    st, lb = _steps(tr, st, 2)
    for a, b in zip(lr, la + lb):
        assert torch.equal(a, b)
    for a, b in zip(_params(sr), _params(st)):
        assert torch.equal(a, b)
    rs, l_rs = _steps(tr, rs, 2)
    for a, b in zip(l_src, l_rs):
        assert torch.equal(a, b)
    for a, b in zip(_params(ss), _params(rs)):
        assert torch.equal(a, b)


def test_restore_into_another_seed_continues_the_checkpoints_run(
        ds, tmp_path):
    """A trainer built with another ``train.seed`` (other initial weights,
    another base key) continues as the checkpoint's run did: the sampler
    and dropout both take the checkpoint's base key, and counters that
    the evals moved come back too."""
    from legion_tpu_torch.pipeline import Mode
    cfg = _config(ds, model="gat", compact=False)
    tr = Trainer(ds, cfg, "cpu")
    st, _ = _steps(tr, tr.init_state(), 2)
    st, _ = tr.run_eval(st, Mode.VALID)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, st, st["train_ctr"])
    st, la = _steps(tr, st, 2)
    st, acc_a = tr.run_eval(st, Mode.VALID)

    other = replace(cfg, train=replace(cfg.train, seed=11))
    tr2 = Trainer(ds, other, "cpu")
    assert tr2.init_state()["base_key"] != st["base_key"]
    st2 = restore_checkpoint(ck, tr2)
    assert int(st2["base_key"]) == int(st["base_key"]) == tr2._base_key
    assert st2["valid_ctr"] == tr.schedule.valid_step
    st2, lb = _steps(tr2, st2, 2)
    st2, acc_b = tr2.run_eval(st2, Mode.VALID)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    for a, b in zip(_params(st), _params(st2)):
        assert torch.equal(a, b)
    assert acc_a == acc_b


def test_fit_saves_every_epoch(ds, tmp_path):
    tr = Trainer(ds, _config(ds, epochs=2), "cpu")
    ck = str(tmp_path / "ck")
    st, stats = tr.fit(verbose=False, checkpoint_dir=ck, checkpoint_every=1)
    n = tr.schedule.train_step
    assert len(stats) == 2
    assert sorted(os.listdir(ck)) == [f"ckpt_{n:010d}.pt",
                                      f"ckpt_{2 * n:010d}.pt"]
    assert latest_step(ck) == st["train_ctr"] == 2 * n
    # a restored state runs schedule.epochs more epochs
    tr2 = Trainer(ds, _config(ds, epochs=1), "cpu")
    st2, _ = tr2.fit(restore_checkpoint(ck, tr2, step=n), verbose=False)
    assert st2["train_ctr"] == 2 * n
    for a, b in zip(_params(st), _params(st2)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tr2)


# -------------------------------------------------------------- launcher
def test_launcher_synthetic(tmp_path):
    tr, st, stats = run.main([
        "--dataset-name", "synthetic", "--nodes", "3000",
        "--train-batch-size", "64", "--fanout", "4", "3", "--epoch", "1",
        "--hidden", "16", "--no-compact", "--device", "cpu"])
    assert len(stats) == 1 and np.isfinite(stats[0].train_loss)
    assert 0.0 <= stats[0].valid_acc <= 1.0
    assert st["train_ctr"] == tr.schedule.train_step


def test_launcher_prepared_dataset_in_host_mode_and_resume(tmp_path):
    """prepare -> the launcher in host mode (the cache on, bf16: the host
    features the bf16 rows of the memmap, built in RAM, the f32 memmap
    never copied) with a checkpoint -> ``--resume``: finite losses, and
    the resumed counters as saved."""
    d = _prepared_dir(tmp_path)
    ck = str(tmp_path / "ck")
    argv = ["--dataset-name", "custom", "--dataset-path", d, "--features",
            "host", "--cache-memory", "20000", "--train-batch-size", "64",
            "--fanout", "5", "3", "--hidden", "16", "--epoch", "1",
            "--no-compact", "--device", "cpu", "--checkpoint-dir", ck]
    tr, st, stats = run.main(argv)
    n = tr.schedule.train_step
    assert tr.cache_plan is not None
    V, F = tr.dataset.features.shape
    assert tr.setup_s["ram_copy_bytes"] == 0
    assert tr.setup_s["bf16_table_bytes"] == V * bf16_pitch(F) * 2 == \
        tr.feature_source.host.array.nbytes
    assert tr.feature_source.host.array.flags.writeable
    assert np.isfinite(stats[0].train_loss) and latest_step(ck) == n
    saved = {k: st[k] for k in ("train_ctr", "valid_ctr", "test_ctr")}
    tr.close()
    calls = []
    orig = Trainer.train_step

    def spy(self, state):
        calls.append({k: state[k] for k in saved})
        return orig(self, state)
    Trainer.train_step = spy
    try:
        tr, st, stats = run.main(argv + ["--resume"])
    finally:
        Trainer.train_step = orig
    assert calls[0] == saved
    assert np.isfinite(stats[0].train_loss) and latest_step(ck) == 2 * n
    tr.close()


# ----------------------------------------------------------- host tables
def test_in_ram_copies_read_only_and_file_backed_arrays(tmp_path):
    a = np.arange(60, dtype=np.float32).reshape(12, 5)
    p = str(tmp_path / "a")
    a.tofile(p)
    for mode in ("r", "r+", "c"):
        mm = np.memmap(p, dtype=np.float32, mode=mode, shape=(12, 5))
        for arr in (mm, np.asarray(mm)):
            got = in_ram(arr, np.float32)
            assert type(got) is np.ndarray and got is not arr
            assert got.flags.writeable and got.flags.c_contiguous
            np.testing.assert_array_equal(got, a)
    assert in_ram(a, np.float32) is a          # RAM already: no copy
    np.testing.assert_array_equal(in_ram(a, np.int64), a.astype(np.int64))
    np.testing.assert_array_equal(in_ram(a.T, np.float32), a.T)
    ro = a.copy()
    ro.flags.writeable = False
    assert in_ram(ro, np.float32).flags.writeable
    with pytest.raises(ValueError, match="writable RAM"):
        HostTable(ro, pin=True)


def test_trainer_copies_a_dataset_on_disk_into_ram(tmp_path):
    """A LegionDataset on disk in host mode (features and topology on the
    host, a bf16 cache): every host table is writable RAM, the topology's
    a copy equal to its memmap, the features' the bf16 rows of theirs;
    ``setup_s`` counts the copied bytes and the bf16 table's, and the
    trainer steps."""
    hds = synthesize_dataset(num_nodes=1500, avg_degree=8, feature_dim=24,
                             num_classes=4, batch_size=64, seed=2)
    d = str(tmp_path / "ds")
    write_legion_dataset(d, hds.graph, hds.features, hds.labels,
                         hds.train_ids, hds.valid_ids, hds.test_ids)
    loaded = LegionDataset.load(infer_meta(d, batch_size=64))
    cfg = LegionConfig(
        dataset=loaded.meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=64,
                              eval_batch_size=64, dedup="sort",
                              dedup_last_hop=False),
        cache=CacheConfig(cache_bytes=40_000, presample_steps=2,
                          feature_residency="host", topo_residency="host"),
        train=TrainConfig(hidden_dim=16, epochs=1),
        mesh=MeshConfig.for_devices(1))
    tr = Trainer(loaded, cfg, device="cpu")
    # registered in set-up order: the topology, then the features
    srcs = (loaded.graph.indptr, loaded.graph.indices, loaded.features)
    assert not any(s.flags.writeable for s in srcs)
    assert len(tr._host_tables) == 3
    refs = (srcs[0], srcs[1], bf16_rows(np.asarray(srcs[2]),
                                        bf16_pitch(24)))
    for t, ref in zip(tr._host_tables, refs):
        assert t.array.flags.writeable
        np.testing.assert_array_equal(t.array, np.asarray(ref))
    assert {t.array.ctypes.data for t in tr._host_tables}.isdisjoint(
        {np.asarray(s).ctypes.data for s in srcs})
    assert tr.setup_s["ram_copy_bytes"] == sum(s.nbytes for s in srcs[:2])
    assert tr.setup_s["bf16_table_bytes"] == refs[2].nbytes == 1500 * 24 * 2
    _, loss = tr.train_step(tr.init_state())
    assert np.isfinite(float(loss))
    tr.close()


def test_new_modules_are_covered_by_the_no_jax_check():
    """``test_torch_train.py::test_port_never_imports_jax`` imports every
    ``*.py`` under the package: the launcher, checkpoints, tools, the
    clique caches and the homophilous dataset are among them."""
    found = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"native.py", "run.py", "tools/prepare.py", "tools/__init__.py",
            "utils/checkpoint.py", "cache/hashmap.py",
            "cache/collective.py", "data/homophilous.py"} <= found
