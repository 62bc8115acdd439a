"""Drive the legion_tpu_torch GraphSAGE training slice once on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``) and no network.

  1. builds the hand-written kernels from ``legion_tpu_torch/csrc``;
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, and times both;
  3. drives the main path through the public API at the bench
     configuration (``bench.py`` defaults: 2.4M vertices, 120M edges,
     GraphSAGE [25,10], batch 8000, hidden 256, bf16 features, 64-wide
     windowed draws, sort dedup with a lane-aligned last hop, measured
     caps): train steps, then an eval pass, counting kernel launches;
  4. checks the whole slice on the card against the same slice on the
     CPU (plain versions) at a small size.

Prints the card's ``name, power.limit`` line, the per-kernel JSON line and,
last, ``{"ok": true, "device": ...}`` only when every phase passed. Any
failure exits non-zero without that line.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_STEPS = 5
WARMUP_STEPS = 3
TIMING_ITERS = 20

KERNELS = {
    "gather_rows": dict(source="legion_tpu_torch/csrc/gather_rows.cu",
                        replaces="legion_tpu/ops/pallas_segment.py:85"),
    "segment_sum": dict(source="legion_tpu_torch/csrc/segment_sum.cu",
                        replaces="legion_tpu/ops/pallas_segment.py:132"),
    "windowed_draw": dict(source="legion_tpu_torch/csrc/windowed_draw.cu",
                          replaces="legion_tpu/sampling/access.py:201"),
}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, torch):
    """Mean milliseconds per call of fn over TIMING_ITERS launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMING_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMING_ITERS


def compare(name, kernel, plain, tol, results, torch, shape_note):
    """Run kernel and plain once, check, then time plain, kernel, kernel,
    plain. tol(k, p) -> (max_abs_err, ok)."""
    k, p = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = tol(k, p)
    if not ok:
        fail(f"{name} {shape_note}: kernel disagrees with its plain "
             f"version (max abs err {err})")
    tp1 = cuda_ms(plain, torch)
    tk1 = cuda_ms(kernel, torch)
    tk2 = cuda_ms(kernel, torch)
    tp2 = cuda_ms(plain, torch)
    ms, plain_ms = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    print(f"  {name:14s} {shape_note:44s} max_abs_err {err:.3g} | kernel "
          f"{ms:.4f} ms | plain {plain_ms:.4f} ms")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return ms, plain_ms


def exact(k, p):
    err = (k.float() - p.float()).abs().max().item() if k.numel() else 0.0
    return err, bool((k == p).all().item()) and k.shape == p.shape


def f32_atomic_order(k, p):
    """Segment sums in another order: rtol 1e-5, atol 1e-5 * max|out|."""
    diff = (k - p).abs()
    atol = 1e-5 * p.abs().max().item()
    ok = bool((diff <= atol + 1e-5 * p.abs()).all().item())
    return diff.max().item(), ok


def bench_config(ds):
    from legion_tpu_torch.config import (CacheConfig, LegionConfig,
                                         MeshConfig, SamplerConfig,
                                         TrainConfig)
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=8000,
                              auto_compact=True, eval_batch_size=512,
                              dedup="sort", cap_headroom=1.03,
                              neighbor_window=64, dedup_last_hop=False),
        cache=CacheConfig(presample_steps=8, cache_bytes=0,
                          feature_residency="hbm"),
        train=TrainConfig(model="graphsage", hidden_dim=256, epochs=1,
                          lr=3e-3, dropout=0.5, fused_steps=1),
        mesh=MeshConfig.for_devices(1))


def phase_kernels(tr, torch):
    """Each kernel against its plain version at the main path's shapes
    (from one real batch) and at the JAX package's benchmark shapes."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.sampling import access
    s, acc = tr.sampler_t, tr.graph_access
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    dev = "cuda"
    results, main = {}, {}

    seeds = tr.train_bank[:s.config.batch_size]
    carry = s.begin(seeds)
    f0 = s.hop_frontier(carry, 0)
    carry = s.hop_absorb(carry, 0, acc.sample_neighbors(f0, 25, 77))
    f1 = s.hop_frontier(carry, 1)
    carry = s.hop_absorb(carry, 1, acc.sample_neighbors(f1, 10, 78))
    batch = s.finish(carry)

    # K3: bit for bit, both hops
    for f, fo, key in ((f0, 25, 5), (f1, 10, 6)):
        main.setdefault("windowed_draw", []).append(compare(
            "windowed_draw",
            lambda: access.windowed_draw(acc.row_pairs, acc.indices2d, f,
                                         fo, key),
            lambda: access.windowed_draw_plain(acc.row_pairs, acc.indices2d,
                                               f, fo, key),
            exact, results, torch, f"frontier {f.shape[0]} fanout {fo}"))

    # K1: exact
    table = tr.feature_source.features
    nid = batch.node_ids[:s.max_ids]
    main["gather_rows"] = [compare(
        "gather_rows", lambda: kernels.gather_rows(table, nid),
        lambda: kernels.gather_rows_plain(table, nid), exact, results,
        torch, f"fetch [{table.shape[0]},{table.shape[1]}] bf16 x "
               f"{nid.shape[0]}")]
    ids = torch.randint(0, table.shape[0], (1_247_232,), generator=g,
                        device=dev, dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=g, device=dev) < 0.05] = -1
    compare("gather_rows", lambda: kernels.gather_rows(table, ids),
            lambda: kernels.gather_rows_plain(table, ids), exact, results,
            torch, f"bench ids {ids.shape[0]}, 5% pads")
    S1 = s.cum_caps[1]
    src0 = batch.edge_src[0]
    hp = torch.randn((S1, 128), generator=g, device=dev).to(torch.bfloat16)
    main["gather_rows"].append(compare(
        "gather_rows", lambda: kernels.gather_rows(hp, src0),
        lambda: kernels.gather_rows_plain(hp, src0), exact, results, torch,
        f"layer-1 msgs [{S1},128] bf16 x {src0.shape[0]}"))

    # K2: f32 atomic order
    dmsg = torch.randn((src0.shape[0], 128), generator=g,
                       device=dev).to(torch.bfloat16)
    main["segment_sum"] = [compare(
        "segment_sum", lambda: kernels.segment_sum(dmsg, src0, S1),
        lambda: kernels.segment_sum_plain(dmsg, src0, S1), f32_atomic_order,
        results, torch, f"layer-1 bwd E {src0.shape[0]} -> S {S1} bf16")]
    seg = torch.randint(-1, 8192, (200_704,), generator=g, device=dev,
                        dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        data = torch.randn((200_704, 128), generator=g, device=dev).to(dt)
        compare("segment_sum", lambda: kernels.segment_sum(data, seg, 8192),
                lambda: kernels.segment_sum_plain(data, seg, 8192),
                f32_atomic_order, results, torch,
                f"bench E 200704 -> S 8192 {str(dt)[6:]}")
    # per train step: the sum over the main path's launches of a kernel
    # (K3: both hops; K1: feature fetch + layer-1 message gather; K2: the
    # layer-1 backward)
    for name, times in main.items():
        results[name].update(ms=sum(t[0] for t in times),
                             plain_ms=sum(t[1] for t in times))
    return results


def phase_slice(tr, torch):
    """The main path through the public API; returns the launch counts."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline import Mode
    state = tr.init_state()
    kernels.reset_launch_counts()
    for _ in range(WARMUP_STEPS):
        state, loss = tr.train_step(state)
    torch.cuda.synchronize()
    losses, edges = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss = tr.train_step(state)
        losses.append(loss)
        edges.append(tr.last_edges)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    state, acc = tr.run_eval(state, Mode.VALID)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    losses = [float(x) for x in losses]
    edges = [int(x) for x in edges]
    print(f"  losses {losses}")
    print(f"  mean step {step_ms:.3f} ms over {TRAIN_STEPS} steps (after "
          f"{WARMUP_STEPS} warm-up) | valid edges/step {edges}")
    print(f"  trained edges/s {sum(edges) / (step_ms / 1e3 * TRAIN_STEPS):.1f}"
          f" | valid acc after {WARMUP_STEPS + TRAIN_STEPS} steps {acc:.4f}"
          f" | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches on the main path: {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss {losses}")
    if not 0.0 <= acc <= 1.0 or int(state["total"]) == 0:
        fail(f"eval pass counted nothing (acc {acc})")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return counts


def phase_reference(torch):
    """The slice on the card (kernels) against the slice on the CPU (plain
    versions) at a small size: identical batches (K3 is bit-exact and sort
    dedup deterministic) and matching losses and parameters."""
    from dataclasses import replace
    from legion_tpu_torch.data import DeviceDataset, synthesize_device_dataset
    from legion_tpu_torch.train import Trainer
    small = synthesize_device_dataset("cpu", num_nodes=20_000,
                                      num_edges=400_000, batch_size=256,
                                      valid_size=512, test_size=512, seed=3)
    gpu_ds = DeviceDataset.from_numpy(
        small.meta, small.csr.indptr.numpy(), small.csr.indices.numpy(),
        small.features.numpy(), small.labels.numpy(), small.train_ids,
        small.valid_ids, small.test_ids, device="cuda")
    cfg = bench_config(small)
    cfg = replace(cfg, sampler=replace(cfg.sampler, batch_size=256),
                  train=replace(cfg.train, dropout=0.0))
    trs = [Trainer(small, cfg, device="cpu"), Trainer(gpu_ds, cfg, "cuda")]
    if trs[0].compact_caps != trs[1].compact_caps:
        fail(f"caps differ: {trs[0].compact_caps} {trs[1].compact_caps}")
    states = [t.init_state() for t in trs]
    states[1]["model"].load_state_dict(states[0]["model"].state_dict())
    b = [t.sampler_t.sample(t.graph_access, t.train_bank[:256], 99)
         for t in trs]
    for f in ("node_ids", "num_nodes", "num_edges", "hop_offsets"):
        if not torch.equal(getattr(b[0], f), getattr(b[1], f).cpu()):
            fail(f"small batch differs in {f}")
    losses = [[], []]
    for _ in range(3):
        for i, t in enumerate(trs):
            states[i], loss = t.train_step(states[i])
            losses[i].append(float(loss))
    rel = max(abs(a - c) / abs(a) for a, c in zip(*losses))
    pdiff = max(
        ((p.detach().cpu() - q.detach()).norm() / q.detach().norm()).item()
        for p, q in zip(states[1]["model"].parameters(),
                        states[0]["model"].parameters()))
    print(f"  cpu losses {losses[0]}\n  gpu losses {losses[1]}\n  max loss "
          f"rel diff {rel:.3g} | max param rel diff {pdiff:.3g} (3 steps)")
    # bf16 activations may round differently where f32 sums differ in
    # order (cuBLAS vs CPU GEMM, f32 atomics): bf16-level tolerance
    if rel > 2e-2 or pdiff > 2e-2:
        fail("small-input slice on the card disagrees with the CPU slice")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "legion_tpu_torch")):
        fail("run from a checkout of the repository (legion_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from legion_tpu_torch.data import synthesize_device_dataset
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.train import Trainer

    print("phase 1: build")
    build_s, report = kernels.build()
    kernels.lib()
    print(f"  built {kernels.library_path().name} in {build_s:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    print("set-up: bench dataset and trainer")
    t0 = time.perf_counter()
    ds = synthesize_device_dataset("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr = Trainer(ds, bench_config(ds), device="cuda")
    torch.cuda.synchronize()
    s = tr.sampler_t
    print(f"  datagen {t1 - t0:.2f} s | trainer set-up (8 presample "
          f"batches) {time.perf_counter() - t1:.2f} s")
    print(f"  caps {tr.compact_caps} | frontier sizes {s.frontier_sizes} "
          f"| edge sizes {s.edge_sizes} | max_ids {s.max_ids} | ids_len "
          f"{s.ids_len}")

    print("phase 2: kernels against their plain versions")
    results = phase_kernels(tr, torch)

    print("phase 3: the main path (train steps, then an eval pass)")
    counts = phase_slice(tr, torch)

    print("phase 4: small-input slice, card vs CPU")
    del tr, ds
    torch.cuda.empty_cache()
    phase_reference(torch)

    kern = [dict(name=n, route="cuda", source=KERNELS[n]["source"],
                 replaces=KERNELS[n]["replaces"], launches=counts[n],
                 max_abs_err=results[n]["max_abs_err"],
                 ms=results[n]["ms"], plain_ms=results[n]["plain_ms"])
            for n in KERNELS]
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
