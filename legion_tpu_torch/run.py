"""Training launcher CLI (counterpart of ``legion_tpu/run.py``): dataset
load, storage set-up (presampling, the cache plan and fill), the train
schedule and checkpoints, in one process on one card.

It takes the JAX launcher's flags, with the same names and defaults, so a
command line carries over, and adds ``--device`` (default ``cuda``; the
counterpart of ``JAX_PLATFORMS``). A card that is asked for and absent
raises: nothing carries on on the CPU. More than one device and clique
caches raise: the launcher's ``--devices`` will count processes, a member
each (``ROADMAP.md`` A.4); the clique caches with their members in one
process are ``Trainer``'s ``MeshConfig`` (A.3). Multi-host runs raise
too (A.6).

  python -m legion_tpu_torch.run --dataset-name custom --dataset-path DIR \
      --features host --cache-memory 200000000 --train-batch-size 8000 \
      --epoch 2 --checkpoint-dir CKPT [--resume]
"""

from __future__ import annotations

import argparse

import torch


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

    if args.devices > 1 or args.clique_size > 1:
        raise NotImplementedError(
            f"--devices {args.devices} --clique-size {args.clique_size}: the "
            "launcher trains one member on one card; a process a member is "
            "ROADMAP.md A.4 (the clique caches with their members in one "
            "process are Trainer's MeshConfig, A.3)")
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
        mesh=MeshConfig.for_devices(1),
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
    # the JAX launcher's multi-device flags: only one device here
    ap.add_argument("--devices", type=int, default=0,
                    help="0 = one card (more raise: a process a member is "
                         "ROADMAP.md A.4)")
    ap.add_argument("--clique-size", type=int, default=0,
                    help="cache group size Kg (more than 1 raises: ROADMAP.md "
                         "A.4; in one process, Trainer's MeshConfig, A.3)")
    ap.add_argument("--coordinator", default="",
                    help="multi-host runs raise (ROADMAP.md A.6)")
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
    if args.coordinator:
        raise NotImplementedError(
            "--coordinator: multi-host runs are not ported (ROADMAP.md "
            "A.6)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card is "
                           "visible to torch")

    cfg = build_config(args)
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
    trainer = Trainer(ds, cfg, device)
    print(f"device: {device} | schedule: train "
          f"{trainer.schedule.train_step}/epoch, valid "
          f"{trainer.schedule.valid_step}, test {trainer.schedule.test_step}")
    print("set-up: " + ", ".join(
        f"{k} {v}" if k.endswith("_bytes") else f"{k} {v:.3f} s"
        for k, v in trainer.setup_s.items()))
    if trainer.compact_caps:
        print(f"measured buffer caps: {trainer.compact_caps}")
    if trainer.cache_plan:
        p = trainer.cache_plan
        print(f"cache plan: alpha={p.alpha:.2f} feat_rows="
              f"{p.feature_capacity} topo_rows={p.topo_capacity}")
    from legion_tpu_torch.utils import restore_checkpoint, save_checkpoint
    state = None
    if args.resume:
        state = restore_checkpoint(args.checkpoint_dir, trainer)
        print(f"resumed from {args.checkpoint_dir} at train_ctr "
              f"{state['train_ctr']}")
    state, stats = trainer.fit(state, checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, state, state["train_ctr"])
        print(f"checkpoint saved to {args.checkpoint_dir}")
    return trainer, state, stats


if __name__ == "__main__":
    main()
