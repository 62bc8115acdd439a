"""Offline dataset preparation CLI (copy of ``legion_tpu/tools/prepare.py``,
with the same subcommands, flags and output files; its host tools are the
NumPy ones of ``legion_tpu_torch/native.py``).

Reference parity for the dataset pipeline (SURVEY.md §2.7):

  gen_legion_xtrapulp_fomat.cpp  -> `convert` (text edge list -> edge_src/
                                    edge_dst binaries)
  gen_sets.py                    -> `gensets` (shuffled train/valid/test
                                    seed files)
  graph_partitioning.py+XtraPuLP -> `partition` (streaming LDG min-cut-ish
                                    partitioner -> int32 `partition` file)
  missing features/labels        -> `synthfeat` (the reference snapshot
                                    cannot load real features,
                                    storage_management.cu:160-164)

Usage (``legion-tpu-torch-prepare`` once installed):
  python -m legion_tpu_torch.tools.prepare ogb --name ogbn-products \
      --out DIR [--npy-dir EXPORTED]
  python -m legion_tpu_torch.tools.prepare convert --edgelist E.txt \
      --out DIR
  python -m legion_tpu_torch.tools.prepare gensets --out DIR --nodes V \
      --train-frac 0.1 [--valid-frac 0.02] [--test-frac 0.02] [--seed 0]
  python -m legion_tpu_torch.tools.prepare partition --out DIR --parts K
  python -m legion_tpu_torch.tools.prepare synthfeat --out DIR --nodes V \
      --feature-dim F --classes C
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def cmd_convert(args):
    from legion_tpu_torch import native
    nodes, edges = native.convert_edgelist(args.edgelist, args.out)
    print(f"wrote {args.out}/edge_src edge_dst: {nodes} nodes, "
          f"{edges} edges")


def cmd_gensets(args):
    rng = np.random.default_rng(args.seed)
    ids = rng.permutation(args.nodes).astype(np.int32)
    n_tr = int(args.nodes * args.train_frac)
    n_va = int(args.nodes * args.valid_frac)
    n_te = int(args.nodes * args.test_frac)
    os.makedirs(args.out, exist_ok=True)
    ids[:n_tr].tofile(os.path.join(args.out, "trainingset"))
    ids[n_tr:n_tr + n_va].tofile(os.path.join(args.out, "validationset"))
    ids[n_tr + n_va:n_tr + n_va + n_te].tofile(
        os.path.join(args.out, "testingset"))
    print(f"wrote seed sets: {n_tr}/{n_va}/{n_te}")


def cmd_partition(args):
    from legion_tpu_torch import native
    indptr = np.fromfile(os.path.join(args.out, "edge_src"), np.int64)
    indices = np.fromfile(os.path.join(args.out, "edge_dst"), np.int32)
    part = native.partition_ldg(indptr, indices, args.parts, args.passes)
    part.tofile(os.path.join(args.out, "partition"))
    # report edge cut
    V = indptr.shape[0] - 1
    src = np.repeat(np.arange(V), np.diff(indptr))
    cut = (part[src] != part[indices]).mean()
    print(f"wrote partition ({args.parts} parts, edge cut "
          f"{cut:.3f}, sizes {np.bincount(part).tolist()})")


def cmd_ogb(args):
    """Convert an OGB node-property dataset (e.g. ogbn-products) to the
    Legion binary layout (reference consumes the same graph as PR,
    legion_server.py:41-48). Two sources:

      - the `ogb` package, when installed and the dataset is downloaded
        (--ogb-root), or
      - a directory of .npy files (--npy-dir) with:
            edge_index.npy  int64 [2, E]
            node_feat.npy   float32 [V, F]
            labels.npy      int   [V]  (or [V, 1])
            train_idx.npy / valid_idx.npy / test_idx.npy  int
        (the arrays `ogb.nodeproppred.NodePropPredDataset` exposes —
        export them once on a machine with the package/network).
    """
    import numpy as np
    if args.npy_dir:
        d = args.npy_dir
        ld = lambda n: np.load(os.path.join(d, n + ".npy"))
        edge_index = ld("edge_index")
        feats = ld("node_feat").astype(np.float32)
        labels = ld("labels").reshape(-1).astype(np.int32)
        tr, va, te = ld("train_idx"), ld("valid_idx"), ld("test_idx")
    else:
        from ogb.nodeproppred import NodePropPredDataset
        ds = NodePropPredDataset(name=args.name, root=args.ogb_root)
        graph, y = ds[0]
        edge_index = graph["edge_index"]
        feats = graph["node_feat"].astype(np.float32)
        labels = np.asarray(y).reshape(-1).astype(np.int32)
        split = ds.get_idx_split()
        tr, va, te = split["train"], split["valid"], split["test"]
    V = feats.shape[0]
    from legion_tpu_torch.data.format import write_legion_dataset
    from legion_tpu_torch.graph import CSRGraph
    from legion_tpu_torch import native
    # symmetrize like the reference's undirected webgraph edge lists
    src = np.concatenate([edge_index[0], edge_index[1]])
    dst = np.concatenate([edge_index[1], edge_index[0]])
    indptr, indices = native.edges_to_csr(src, dst, V)
    graph = CSRGraph(indptr=np.asarray(indptr, np.int64),
                     indices=np.asarray(indices, np.int32))
    write_legion_dataset(args.out, graph, feats, labels,
                         np.asarray(tr, np.int32), np.asarray(va, np.int32),
                         np.asarray(te, np.int32))
    n_cls = int(labels[labels >= 0].max()) + 1
    print(f"wrote {args.out}: V={V} E={graph.num_edges} F={feats.shape[1]} "
          f"classes={n_cls} splits={len(tr)}/{len(va)}/{len(te)}")
    print(f"meta: --dataset-name custom nodes={V} edges={graph.num_edges} "
          f"feat={feats.shape[1]} train={len(tr)} valid={len(va)} "
          f"test={len(te)}")


def cmd_synthfeat(args):
    rng = np.random.default_rng(args.seed)
    labels = rng.integers(0, args.classes, args.nodes).astype(np.int32)
    protos = rng.standard_normal(
        (args.classes, args.feature_dim)).astype(np.float32)
    os.makedirs(args.out, exist_ok=True)
    feats = protos[labels] + rng.standard_normal(
        (args.nodes, args.feature_dim)).astype(np.float32)
    feats.astype(np.float32).tofile(os.path.join(args.out, "features"))
    labels.tofile(os.path.join(args.out, "labels"))
    print(f"wrote features [{args.nodes}, {args.feature_dim}] + labels")


def main(argv=None):
    ap = argparse.ArgumentParser("legion_tpu_torch dataset preparation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("--edgelist", required=True)
    c.add_argument("--out", required=True)

    g = sub.add_parser("gensets")
    g.add_argument("--out", required=True)
    g.add_argument("--nodes", type=int, required=True)
    g.add_argument("--train-frac", type=float, default=0.1)
    g.add_argument("--valid-frac", type=float, default=0.02)
    g.add_argument("--test-frac", type=float, default=0.02)
    g.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("partition")
    p.add_argument("--out", required=True)
    p.add_argument("--parts", type=int, required=True)
    p.add_argument("--passes", type=int, default=2)

    o = sub.add_parser("ogb")
    o.add_argument("--name", default="ogbn-products")
    o.add_argument("--out", required=True)
    o.add_argument("--ogb-root", default="dataset/")
    o.add_argument("--npy-dir", default="",
                   help="read exported .npy arrays instead of the ogb pkg")

    s = sub.add_parser("synthfeat")
    s.add_argument("--out", required=True)
    s.add_argument("--nodes", type=int, required=True)
    s.add_argument("--feature-dim", type=int, default=128)
    s.add_argument("--classes", type=int, default=47)
    s.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)
    {"convert": cmd_convert, "gensets": cmd_gensets,
     "partition": cmd_partition, "synthfeat": cmd_synthfeat,
     "ogb": cmd_ogb}[args.cmd](args)


if __name__ == "__main__":
    main()
