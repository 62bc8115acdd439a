"""Training launcher CLI (counterpart of ``legion_tpu/run.py``): dataset
load, storage set-up (presampling, the cache plan and fill), the train
schedule and checkpoints, on one card a process.

It takes the JAX launcher's flags, with the same names, defaults and
meanings, so a command line carries over, and adds ``--device`` (default
``cuda``; the counterpart of ``JAX_PLATFORMS``). A card that is asked for
and absent raises: nothing carries on on the CPU.

- ``--devices N``: the members (JAX's devices) this process drives, a
  leading axis on its card; 0 means 1.
- ``--clique-size K``: the members of a clique that pool their caches; 0
  means ``--devices``, as in JAX.
- ``--coordinator HOST:PORT --num-processes W --process-id R``: one
  command a process, as JAX starts them; each joins ``torch.distributed``
  (NCCL for a card, ``cuda:{R % cards}`` for ``--device cuda``; gloo for
  ``--device cpu``), and the W * N members train as one data-parallel run.
  A clique lies inside a process, or across processes of one member each
  (``parallel/mesh.py::layout``); any other layout raises.

  python -m legion_tpu_torch.run --dataset-name custom --dataset-path DIR \
      --features host --cache-memory 200000000 --train-batch-size 8000 \
      --epoch 2 --checkpoint-dir CKPT [--resume]

  # two cards, one member each, one clique across them: on each card r
  python -m legion_tpu_torch.run ... --devices 1 --clique-size 2 \
      --coordinator 127.0.0.1:29500 --num-processes 2 --process-id r
"""

from __future__ import annotations

import argparse

import torch

from legion_tpu_torch.parallel import mesh as pmesh
from legion_tpu_torch.parallel import multihost


def build_config(args):
    from legion_tpu_torch.config import (CacheConfig, DatasetMeta,
                                         LegionConfig, MeshConfig,
                                         SamplerConfig, TrainConfig)
    if args.dataset_name in ("synthetic",):
        meta = None
    else:
        if args.dataset_name == "custom":
            # any Legion-format directory (e.g. tools/prepare output):
            # shapes probed from the files themselves
            from legion_tpu_torch.data.format import infer_meta
            meta = infer_meta(args.dataset_path,
                              batch_size=args.train_batch_size,
                              cache_bytes=args.cache_memory,
                              epochs=args.epoch)
        else:
            meta = DatasetMeta.known(
                args.dataset_name, path=args.dataset_path,
                batch_size=args.train_batch_size,
                cache_bytes=args.cache_memory, epochs=args.epoch)
        if args.write_meta_config:
            meta.to_meta_config()  # reference-compatible artifact

    n_local = args.devices or 1
    clique = args.clique_size or n_local
    W = args.num_processes if args.coordinator else 1
    pmesh.layout(W, n_local, clique)
    cache_enabled = args.cache_memory > 0 and args.features == "host"
    return LegionConfig(
        dataset=meta,
        sampler=SamplerConfig(fanouts=tuple(args.fanout),
                              batch_size=args.train_batch_size,
                              auto_compact=not args.no_compact,
                              dedup=args.dedup,
                              neighbor_window=args.window,
                              # gcn needs exact dedup (block-degree
                              # normalization); gat runs lane-aligned
                              dedup_last_hop=(args.exact_dedup
                                              or args.model == "gcn")),
        cache=CacheConfig(
            cache_bytes=args.cache_memory,
            feature_residency="host" if cache_enabled else "hbm",
            presample_steps=args.presample_steps),
        train=TrainConfig(model=args.model, hidden_dim=args.hidden,
                          dropout=args.dropout, lr=args.lr,
                          epochs=args.epoch),
        mesh=MeshConfig.for_devices(W * n_local, clique_size=clique),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser("Legion trainer (PyTorch/CUDA port)")
    # reference flags (legion_server.py:114-125)
    ap.add_argument("--dataset_path", "--dataset-path",
                    dest="dataset_path", type=str, default="./dataset")
    ap.add_argument("--dataset_name", "--dataset-name",
                    dest="dataset_name", type=str, default="synthetic")
    ap.add_argument("--train_batch_size", "--train-batch-size",
                    dest="train_batch_size", type=int, default=8000)
    ap.add_argument("--fanout", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--epoch", type=int, default=2)
    ap.add_argument("--cache_memory", "--cache-memory",
                    dest="cache_memory", type=int, default=0)
    # trainer flags (legion_graphsage.py:191-203)
    ap.add_argument("--model", default="graphsage",
                    choices=["graphsage", "gcn", "gat", "lp_sage"])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=3e-3)
    # the JAX launcher's multi-device flags
    ap.add_argument("--devices", type=int, default=0,
                    help="members this process drives on its card; 0 = 1")
    ap.add_argument("--clique-size", type=int, default=0,
                    help="cache group size Kg; 0 = --devices")
    # one command a process (torch.distributed; NCCL on cards)
    ap.add_argument("--coordinator", default="",
                    help="ip:port of process 0 for torch.distributed")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--features", choices=["hbm", "host"], default="hbm")
    ap.add_argument("--dedup", choices=["map", "sort"], default="sort")
    ap.add_argument("--exact-dedup", action="store_true",
                    help="dedup the last hop too (exact reference "
                         "semantics; slower — see "
                         "SamplerConfig.dedup_last_hop)")
    ap.add_argument("--window", type=int, default=64,
                    help="block-windowed neighbor draws; 0 = exact "
                         "per-slot independent draws")
    ap.add_argument("--no-compact", action="store_true")
    ap.add_argument("--presample-steps", type=int, default=0)
    ap.add_argument("--write-meta-config", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N epochs (0 = only at "
                         "the end)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from "
                         "--checkpoint-dir before training")
    # synthetic fallback sizing
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--avg-degree", type=int, default=15)
    ap.add_argument("--feature-dim", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    # the port's own
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card is "
                           "visible to torch")

    cfg = build_config(args)
    mesh = None
    if args.coordinator:
        W, r = args.num_processes, args.process_id
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", r % torch.cuda.device_count())
        multihost.initialize(args.coordinator, W, r, device)
        mesh = multihost.make_multihost_mesh(args.clique_size or None,
                                             args.devices or 1)
        print(f"process {r}/{W}: members {mesh.first_member} .. "
              f"{mesh.first_member + mesh.n_local - 1} on {device} | mesh "
              f"{mesh.shape}")
    if args.dataset_name == "synthetic":
        import dataclasses

        from legion_tpu_torch.data import synthesize_dataset
        ds = synthesize_dataset(
            num_nodes=args.nodes, avg_degree=args.avg_degree,
            feature_dim=args.feature_dim, num_classes=args.classes,
            batch_size=args.train_batch_size, epochs=args.epoch)
        cfg = dataclasses.replace(cfg, dataset=ds.meta)
    else:
        from legion_tpu_torch.data import LegionDataset
        ds = LegionDataset.load(cfg.dataset)

    from legion_tpu_torch.train import Trainer
    trainer = Trainer(ds, cfg, device, mesh=mesh)
    say = print if trainer.is_rank0 else (lambda *a, **k: None)
    say(f"device: {device} | schedule: train "
          f"{trainer.schedule.train_step}/epoch, valid "
          f"{trainer.schedule.valid_step}, test {trainer.schedule.test_step}")
    say("set-up: " + ", ".join(
        f"{k} {v}" if k.endswith("_bytes") else f"{k} {v:.3f} s"
        for k, v in trainer.setup_s.items()))
    if trainer.compact_caps:
        say(f"measured buffer caps: {trainer.compact_caps}")
    if trainer.cache_plan:
        p = trainer.cache_plan
        say(f"cache plan: alpha={p.alpha:.2f} feat_rows="
            f"{p.feature_capacity} topo_rows={p.topo_capacity}")
    from legion_tpu_torch.utils import restore_checkpoint
    state = None
    if args.resume:
        state = restore_checkpoint(args.checkpoint_dir, trainer)
        say(f"resumed from {args.checkpoint_dir} at train_ctr "
            f"{state['train_ctr']}")
    state, stats = trainer.fit(state, checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every)
    if args.checkpoint_dir:
        trainer.save(args.checkpoint_dir, state)
        say(f"checkpoint saved to {args.checkpoint_dir}")
    return trainer, state, stats


if __name__ == "__main__":
    main()
