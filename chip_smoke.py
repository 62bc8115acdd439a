"""Drive the legion_tpu_torch training slices once on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``) and no network.

  1. builds the hand-written kernels from ``legion_tpu_torch/csrc``;
  2. times an empty kernel through the port's ctypes route
     (``launch_floor``); holds K1-K3 against their plain PyTorch versions
     on the card, at the shapes the main path gives them, and times both,
     beside each kernel's bound (the least time the card could take for
     the same bytes and operations) and, where one PyTorch call computes
     the same function, that call; K2 and K3 also with the host's launch
     time hidden (``queued_ms``) and in the host's own time per call
     (``host_us``); K2 at the main path's size under other skews of its
     segments; K2 and K3 at the edges of their shapes (``k2_edges``,
     ``k3_edges``); an empty cooperative kernel with 0, 1 and 5 grid
     barriers at K9's grid (``grid_sync``); K8 (sort dedup: its keys, and
     everything after the sort) and K9 (map dedup: register, hop, clear, in
     three calls and in the one cooperative call that the sampler makes)
     at hop 0 of the bench batch, bit for bit, timed the same three ways,
     and at the edges of their shapes (``k8_edges``, ``k9_edges``);
     K10 (the step keys from the device counters, with the step's
     dropout key) at the main path's hops and at 1,000 random (base key,
     counter) pairs, exactly, also with 4 members and at member offsets
     (a rank's members of a world of 8); K16 (dropout fused with the
     activation and the cast before it, its keep bits drawn in the pass
     and again in the backward) at the Device path's layer-0 output,
     forward, forward + backward under autograd and the backward alone,
     bit for bit, beside ``F.dropout``, and at the edges of its shapes
     (``k16_edges``: every regime, rate 0, odd lane counts, a misaligned
     base, three dtype pairs, three activations); K1 at the Device path's prefix fetch (the ids before the
     aligned last hop) and at the whole fetch; K15 (the hop aggregation)
     in its three forms: (c) at layer 0 reading the aligned last hop's
     rows from the feature table, (a) at layer 1 gathering its rows,
     forward and forward + backward, each also in the host's time per
     call (``host_us``), with where a call's host time goes
     (``k15_host_parts``), and at the edges of its shapes (``k15_edges``:
     forms, widths, dtypes, pads, fanouts 1 and 33, the last offset,
     misaligned rows); its backward on a gathered hop (``hop_mean_grad``)
     alone, with its grouping of the lanes by row exactly and two runs
     the same bits, at layer 1 and at the edges of its shapes
     (``k15_grad_edges``: a hub over many chunks, long and short runs,
     pads, offsets wrapped and clamped, odd widths, runs wider than its
     bitmap window);
  3. drives the main path through the public API at the bench
     configuration (``bench.py`` defaults: 2.4M vertices, 120M edges,
     GraphSAGE [25,10], batch 8000, hidden 256, bf16 features, 64-wide
     windowed draws, sort dedup with a lane-aligned last hop, measured
     caps): train steps, then an eval pass, counting kernel launches; then
     the same with map dedup, the config's default (``device-map``),
     checking that the position map is clean after it; on both (and on
     lp_sage) one step on the prefix fetch against one on the whole
     fetch and one with the plain aggregation, from the same
     state (``prefix_check``: K1's ids, the loss, the hits). After each of
     Device, Device-map, GAT and HT, the same path with ``fused_steps = 4``
     (CUDA-graph replays of one captured step) against as many eager steps
     from the same state (``phase_fused``): every step's sampled ids and
     the keys of its dropout masks (feature, and on GAT attention) equal
     exactly, losses and parameters within the
     atomics' order, the captured step's launches against ``PATH_KERNELS``.
     After each of Device-map, GAT, H and HT, the same path with
     ``interbatch`` (the update on the carried batch on the current stream,
     the next batch sampled and fetched on a side stream) against as many
     plain steps (``phase_interbatch``), held as ``phase_fused`` holds its
     replays, then an A/B (plain, interbatch, interbatch, plain) with the
     time a step that the two streams run at once, from the profiler; in
     host mode also K4 alone under grid caps from 1056 blocks to its own
     66, and a plain and an interbatch run with K4 at 1056;
  3b. on the same device dataset, at ``bench.py --model X`` settings:
     GAT (heads (8,1), feature and attention dropout 0.6, aligned last
     hop), after holding K6 and K7 against their plain versions at its
     shapes, forward and backward, with and without attention dropout
     (its keep bits drawn in the kernels from the key), each form's keep
     set lane for lane against ``keep_mask_plain``, forward and backward,
     in regimes 2 and 3 (``k6_keep_sets``, ``k7_keep_sets``), and each at
     the edges of its shapes (heads, widths and fanouts inside and outside
     K6's tensor-core path and K7's small-row kernels, both dtypes);
     GCN (exact last-hop dedup), after holding K7 at the exact-dedup GAT
     layer-0 shape of one of its batches, K2 at its out-degree shape
     (one column, both hops), K15 at both of its gathered hops (the sum;
     hop 0 with its backward, also alone), and K8 and K9 at its hop 1
     (965,760 lanes);
     link-prediction SAGE (batch
     7998, eval batch 510), after holding K15 at its layer 1 (256-wide
     f32 rows, forward, forward + backward, the backward alone); each
     after holding K16 at its shapes (GAT: layer 0's features, forward,
     and layer 1's ELU, cast and dropout both ways), for train steps and
     an eval pass. On GCN's trainer first the segment ops that no model
     calls (``phase_segment``): the ids of its layer-0 block (965,760
     lanes into 104,576 rows, pads and all), the max and the mean over
     [E, 128] bf16 rows and the softmax over [E, 8] scores in f32 and
     bf16, once through ``legion_tpu_torch.ops`` under autograd with the
     counts of the "segment" path, then K17 ``segment_max`` (bit for bit,
     beside ``scatter_reduce_`` "amax"), K18 ``segment_softmax`` and the
     mean (K2, K1) against their plain versions, both ways, timed; the
     grouping of the lanes by segment that K17 and K18 run first, exactly
     against its plain version, and its time alone; K18 the same bits in
     two runs; each backward on the grouping its forward wrote, as
     autograd runs it; the same at the block's ids under a seeded
     permutation (``seg_shuffled``); and at the edges of
     their shapes (``segment_edges``: f32, bf16, int32; [E], [E, F], [E,
     H, F]; E 1, 7, 2^20 + 3; NaN, +-0, +-inf, ties, pads, ids past S,
     empty segments, initial tied, all pads, a misaligned base; hubs: one
     segment with half of 2^20 + 3 lanes, and every lane in one);
  3c. the Device path at three hops (fanouts [15, 10, 5], GraphSAGE with
     3 layers): train steps and an eval pass, ms a step and peak
     memory (``phase_three_hop``);
  4. checks the whole slice on the card against the same slice on the
     CPU (plain versions) at a small size, for GraphSAGE (sort and map
     dedup), GAT and GCN;
  5. builds the host-resident dataset of ``bench.py --features host``
     (2.4M vertices, about 120M edges, f32 features in host RAM) and its
     trainers: H (features on the host, a 200 MB bf16 cache planned by
     hotness), HT (features and topology on the host, the same budget
     split by the cost model), whose misses read host tables of bf16
     rows; measures what the link gives (a bulk copy, bare reads of one
     HT batch's miss rows from the registered table and from f32 tables
     of 400-, 200- and 256-byte rows, and bare reads of the offsets and
     neighbour words that K5 asks for on both hops, beside the frontier's
     degree figures), with the card's NUMA node, the process's CPUs and
     the nodes of the table's pages; holds K4 (over the bf16 table and an
     f32 table of the same rows, then the two in turns) and K5 against
     their plain versions at HT's shapes and times both, K15's form (b)
     at H's layer 0 (K4's 100-wide bf16 rows), and K4 and K5 at the
     edges of their shapes (K4: widths, dtypes, f32 and bf16 tables at
     misaligned bases and padded pitches, pads and ids past the tables,
     all hits, all misses, no ids; K5:
     fanouts, frontier sizes, degrees from 0 to 70,000, offset types, a
     misaligned host table, with and without a cache);
  6. drives H, HT and the same dataset with the cache off (everything
     copied to the card), each for train steps and an eval pass, with
     per-step times and hit counters, and the launches of each path;
     then GAT on the same dataset (gat-H, ``bench.py --model gat
     --features host``), after holding K6 at its layer 0 (K4's 100-wide
     cached rows: K6's padded tensor-core form, and its general kernels
     timed beside it) and K16 at its dropout of those rows; then ``UnifiedCache.build`` from device tensors
     against ``build_from_host`` at H's and HT's plans, in f32 and bf16,
     bit for bit, with both set-up times;
     then the staged host pipeline (phase 6d, ``phase_staged``) on H, HT
     and clique-HT: K19 ``miss_compact`` and K20 ``staged_assemble`` at
     each path's fetch, K5's device-only form and K21 ``merge_draws`` at
     its hops, and the host half's C++ (the gather of the missed rows,
     the host's draws), each bit for bit against its plain version, timed
     beside its bound, with the bulk copy's rate; the assembled rows
     against the zero-copy fetch and the split draws against
     ``sample_neighbors``, bit for bit; each staged trainer's 5 losses,
     counters and valid accuracy against the zero-copy trainer of the
     same seed; both trainers in turns (ms a step, the host half's hidden
     share); and the four kernels and the host half at the edges of their
     shapes (``staged_edges``);
  7. checks a small HT slice on the card against the same slice on the
     CPU;
  8. writes phase 5's host dataset to disk in Legion's layout and trains
     it through the launcher (``legion_tpu_torch.run.main``, GraphSAGE at
     full width, features on the host: the memmaps copied into RAM and
     registered): one epoch with a checkpoint, two epochs unbroken, and
     one epoch resumed in a fresh trainer, whose first batch must equal
     the unbroken run's at the same counter exactly and whose loss and
     parameters must agree with its second epoch within the atomics'
     order; then the checkpoint restored for fused steps (CUDA-graph
     replays) against eager steps, as ``phase_fused`` holds them. Prints
     what ``cudaHostRegister`` returns for a copy-on-write file mapping
     (``memmap_probe``; the port never registers one);
  9. on the same host dataset, the clique caches with 4 members of one
     clique on the card (``phase_clique``): clique-HT (features and
     topology on the host, at 50 MB a member, or the least budget at
     which the plan gives both caches 4 rows), whose batch holds K11
     (hash map lookup), K12 (bucket by owner), K13 (the clique fetch,
     over the bf16 host table and an f32 one, then the two in turns) and
     K14 (the owners' draws and their unsort) against their plain
     versions, timed (also queued), and at the edges of their shapes,
     and K11, K12 and K14 replayed from a CUDA graph on new inputs; K11
     also at the counters' one topology-map lookup and at a uk2014-sized
     map past L2 (``hash_scale``: 30M keys of V 787,801,471, 537 MB,
     queried at the fetch's shape); 10 steps
     and an eval pass with hit counters, overflow lanes and exchange
     bytes, the
     launches equal to ``PATH_KERNELS``; every member's fetched rows
     against their host rows and every drawn neighbour against the CSR;
     the same path with hash maps, and clique-H (the topology on the
     card) against the same members with every feature on the card: the
     same ids and rows in every step, the same first loss; K14 also for
     each owner alone at its clique index (as a process of a clique
     across processes draws);
 10. on phase 8's dataset on disk, the launcher's members
     (``--devices 4 --clique-size 4``, features and topology on the host
     behind the clique caches, one epoch at full width), first in one
     process, then as a world of one rank under NCCL (``--coordinator
     --num-processes 1 --process-id 0``), which makes every collective
     call of a larger world: the same ids in every step, the same first
     loss; the collective calls and bytes a step (``phase_dist``);
 11. ``Trainer.fit`` through the launcher as ``docs/RESULTS.md`` section 5
     ran the reference (the homophilous dataset, V 200,000, written to
     disk and loaded; batch 2000, 3 epochs, hidden 128), plain, with
     ``fused_steps`` 3 and with ``interbatch``: the runs agree, and each
     test accuracy is within 0.01 of the reference's record
     (``phase_fit``);
 12. K3 and K5 past offset 2^31: a CSR built on the card (V 2^24, E
     about 2.18e9, int64 offsets), one hop of each exactly against its
     plain version, every drawn neighbour in its row (``phase_int64``).

Prints the card's ``name, power.limit`` line, the per-kernel JSON line and,
last, ``{"ok": true, "device": ...}`` only when every phase passed. Any
failure exits non-zero without that line.

``python3 chip_smoke.py --profile gat,H,HT`` runs none of the phases: it
takes the named paths (of device, device-map, gat, gcn, lp_sage, H, HT,
cache-off, gat-H, clique-HT, clique-H) through ``torch.profiler`` and prints
where a train step's device time goes (``phase_profile``); it fails if a
step calls ``torch.cummax`` (the plain sort dedup). ``--profile PATHS --fused
1,4,E,E,4,1`` does so for each ``fused_steps`` in turn (E: the epoch's
``train_step``), an A/B of single steps against CUDA-graph replays in one
call, and fails if a fused run's profile lacks a kernel of its path. ``python3 chip_smoke.py
--kernels`` stops after phase 2 and the GCN shapes of K2, K8, K9 and K15,
for work on K1-K3, K8, K9 and K15. ``python3 chip_smoke.py --k15`` builds
and holds K15 and its backward at the Device path's, GCN's and lp_sage's
shapes with the host's breakdown (``phase_k15``); it also runs against a
package from before ``hop_mean_grad`` (whose gathered backward is K2's
lane form), for times in turns with it. ``python3 chip_smoke.py
--clique`` builds, makes the host dataset and runs phase 9 alone, for
work on K11-K14;
``--clique-kernels`` stops phase 9 after K11-K14 at clique-HT's shapes,
their edges and the replay check (``clique_replay``), and times K11 in
turns with the parent's kernel where ``_archive/parent`` holds a ``git
archive`` of the parent commit. ``python3 chip_smoke.py --k16`` builds and
holds K16 at every path's shapes and its edges, with K10's dropout key
row (``phase_k16``). ``python3 chip_smoke.py --attn`` builds and holds K6
and K7 at the GAT path's shapes with their keep sets (``phase_attn``); it
also runs against a package whose kernels read a keep mask, for times in
turns with it. ``python3
chip_smoke.py --segment`` builds, runs ``phase_segment`` and
``segment_edges`` on GCN's trainer and phase 3c, for work on K17 and K18
(about 80 s of command time); where ``_archive/parent`` holds a ``git
archive`` of the parent commit, it also builds the parent's K17 and K18
and times them in turns with the tree's (``seg_turns``). ``python3
chip_smoke.py --link`` builds, holds K4 and K11-K14 at their edges, makes
the host dataset and runs phases 5 and 9, for work on the host reads of
K4 and K13. ``python3 chip_smoke.py --dist`` builds, holds K10 and K14 at
their offsets (and K11-K14 at their edges), makes the host dataset and
runs phase 10 alone, for work on ``legion_tpu_torch/parallel``. ``python3
chip_smoke.py --int64`` builds and runs phase 12 alone. ``python3
chip_smoke.py --staged`` builds, makes the host dataset and runs phase 6d
alone, for work on the staged host pipeline.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_STEPS = 5
WARMUP_STEPS = 3
TIMING_ITERS = 20
# bench.py --features host defaults
HOST_NODES, HOST_AVG_DEGREE, CACHE_BYTES = 2_400_000, 50, 200_000_000

KERNELS = {
    "gather_rows": dict(source="legion_tpu_torch/csrc/gather_rows.cu",
                        replaces="legion_tpu/ops/pallas_segment.py:85"),
    "segment_sum": dict(source="legion_tpu_torch/csrc/segment_sum.cu",
                        replaces="legion_tpu/ops/pallas_segment.py:132"),
    "windowed_draw": dict(source="legion_tpu_torch/csrc/windowed_draw.cu",
                          replaces="legion_tpu/sampling/access.py:201"),
    "cached_gather": dict(source="legion_tpu_torch/csrc/cached_gather.cu",
                          replaces="legion_tpu/cache/unified_cache.py:261"),
    "csr_draw": dict(source="legion_tpu_torch/csrc/csr_draw.cu",
                     replaces="legion_tpu/sampling/access.py:299"),
    "gat_attend": dict(source="legion_tpu_torch/csrc/gat_attend.cu",
                       replaces="legion_tpu/models/gat.py:83"),
    "hop_attention": dict(source="legion_tpu_torch/csrc/hop_attention.cu",
                          replaces="legion_tpu/ops/hop_agg.py:95"),
    "dedup_keys": dict(source="legion_tpu_torch/csrc/dedup_sort.cu",
                       replaces="legion_tpu/sampling/sampler.py:250"),
    "dedup_sort": dict(source="legion_tpu_torch/csrc/dedup_sort.cu",
                       replaces="legion_tpu/sampling/sampler.py:222"),
    "dedup_map": dict(source="legion_tpu_torch/csrc/dedup_map.cu",
                      replaces="legion_tpu/sampling/sampler.py:190"),
    "step_keys": dict(source="legion_tpu_torch/csrc/step_keys.cu",
                      replaces="legion_tpu/train.py:526"),
    "hash_lookup": dict(source="legion_tpu_torch/csrc/hash_lookup.cu",
                        replaces="legion_tpu/cache/hashmap.py:96"),
    "bucket_by_owner": dict(source="legion_tpu_torch/csrc/clique.cu",
                            replaces="legion_tpu/cache/collective.py:76"),
    "clique_gather": dict(source="legion_tpu_torch/csrc/cached_gather.cu",
                          replaces="legion_tpu/cache/collective.py:160"),
    "clique_draw": dict(source="legion_tpu_torch/csrc/clique.cu",
                        replaces="legion_tpu/cache/collective.py:337"),
    "hop_mean": dict(source="legion_tpu_torch/csrc/hop_agg.cu",
                     replaces="legion_tpu/ops/hop_agg.py:59"),
    # the gather's transpose in hop_gather_msgs, under jax.grad; its device
    # functions are named hop_grad_*
    "hop_mean_grad": dict(source="legion_tpu_torch/csrc/hop_agg.cu",
                          replaces="legion_tpu/ops/hop_agg.py:43",
                          symbol="hop_grad_"),
    # XLA fuses the JAX package's dropout into its neighbours
    "dropout_act": dict(source="legion_tpu_torch/csrc/dropout.cu",
                        replaces="legion_tpu/models/common.py:71"),
    # the JAX package's segment ops that no model calls (XLA): on the
    # "segment" path of phase_segment
    "segment_max": dict(source="legion_tpu_torch/csrc/segment_max.cu",
                        replaces="legion_tpu/ops/segment.py:54"),
    "segment_softmax": dict(source="legion_tpu_torch/csrc/segment_softmax.cu",
                            replaces="legion_tpu/ops/segment.py:67"),
    # the staged host pipeline (host_transfer="staged"): program A's
    # lookup and compaction, program B's assembly (XLA in the JAX
    # package), the per-hop merge and the device-only draws
    "miss_compact": dict(source="legion_tpu_torch/csrc/staged.cu",
                         replaces="legion_tpu/pipeline/staged.py:112"),
    "staged_assemble": dict(source="legion_tpu_torch/csrc/staged.cu",
                            replaces="legion_tpu/pipeline/staged.py:375"),
    "merge_draws": dict(source="legion_tpu_torch/csrc/staged.cu",
                        replaces="legion_tpu/sampling/access.py:78"),
    "csr_draw_device": dict(source="legion_tpu_torch/csrc/csr_draw.cu",
                            replaces="legion_tpu/sampling/access.py:279"),
}
# the kernels each path must launch, and the path whose launches the
# kernel line reports
SORT_DEDUP = ("dedup_keys", "dedup_sort")
# every train step drops out by K16, forward and backward (GAT: layer 0's
# features forward only, layer 1's ELU, cast and dropout both ways)
DROPOUT = ("dropout_act", "dropout_act_bwd")
CLIQUE_HT = ("gather_rows", "csr_draw", "step_keys", "bucket_by_owner",
             "clique_gather", "clique_draw", "clique_draw_unsort",
             "hop_mean", "hop_mean_grad") + SORT_DEDUP + DROPOUT
# every path's step derives its keys by K10; every path but GAT's
# aggregates by K15 (its gathered hop's backward is hop_mean_grad), and
# K1 fetches on the paths with features on the card; K2 runs GAT's
# GatherRows backward and GCN's out-degree
PATH_KERNELS = {
    "device": ("gather_rows", "windowed_draw", "step_keys", "hop_mean",
               "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "device-map": ("gather_rows", "windowed_draw", "dedup_map", "step_keys",
                   "hop_mean", "hop_mean_grad") + DROPOUT,
    "H": ("windowed_draw", "cached_gather", "step_keys", "hop_mean",
          "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "HT": ("cached_gather", "csr_draw", "step_keys", "hop_mean",
           "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "cache-off": ("gather_rows", "windowed_draw", "step_keys", "hop_mean",
                  "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "gat": ("gather_rows", "segment_sum", "windowed_draw", "gat_attend",
            "gat_attend_bwd", "hop_attention", "hop_attention_bwd",
            "step_keys") + SORT_DEDUP + DROPOUT,
    # GAT on H's dataset (bench.py --model gat --features host): layer 0's
    # K6 on K4's 100-wide cached rows
    "gat-H": ("gather_rows", "segment_sum", "windowed_draw", "cached_gather",
              "gat_attend", "gat_attend_bwd", "hop_attention",
              "hop_attention_bwd", "step_keys") + SORT_DEDUP + DROPOUT,
    "gcn": ("gather_rows", "segment_sum", "windowed_draw", "step_keys",
            "hop_mean", "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "lp_sage": ("gather_rows", "windowed_draw", "step_keys", "hop_mean",
                "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    # the launcher on a dataset on disk, features on the host (phase 8)
    "cli": ("windowed_draw", "cached_gather", "step_keys", "hop_mean",
            "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    # 4 members of a clique on the card (phase 9): features and topology
    # on the host; the same with hash maps; the topology on the card
    "clique-HT": CLIQUE_HT,
    "clique-HT-hash": CLIQUE_HT + ("hash_lookup",),
    "clique-H": ("gather_rows", "windowed_draw", "step_keys",
                 "bucket_by_owner", "clique_gather", "hop_mean",
                 "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    # the Device path at three hops (phase 3c): the same kernels
    "device-3hop": ("gather_rows", "windowed_draw", "step_keys", "hop_mean",
                    "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    # the segment ops through legion_tpu_torch.ops (phase_segment): the
    # max and the softmax both ways, the mean's sums (K2) and its
    # backward's gather (K1)
    "segment": ("segment_max", "segment_max_bwd", "segment_softmax",
                "segment_softmax_bwd", "segment_sum", "gather_rows"),
    # the staged host pipeline (phase 6d): K19 and K20 in place of K4 or
    # K13; with host topology K5's device-only form (one member) or the
    # clique's draws, and K21, in place of K5's host reads
    "H-staged": ("windowed_draw", "miss_compact", "staged_assemble",
                 "step_keys", "hop_mean", "hop_mean_grad") + SORT_DEDUP
    + DROPOUT,
    "HT-staged": ("csr_draw_device", "merge_draws", "miss_compact",
                  "staged_assemble", "step_keys", "hop_mean",
                  "hop_mean_grad") + SORT_DEDUP + DROPOUT,
    "clique-HT-staged": ("gather_rows", "bucket_by_owner", "clique_gather",
                         "clique_draw", "clique_draw_unsort", "merge_draws",
                         "miss_compact", "staged_assemble", "step_keys",
                         "hop_mean", "hop_mean_grad") + SORT_DEDUP + DROPOUT,
}
# the paths whose CUDA-graph replays phase_fused holds against eager steps
FUSED_PATHS = ("device", "device-map", "gat", "HT")
FUSED_K = 4
# the paths that phase_interbatch takes with ``interbatch`` on: K9's
# cooperative launch, K4 (and K5) and GAT's model beside the update
INTERBATCH_PATHS = ("device-map", "gat", "H", "HT")
IB_STEPS = 6         # interbatch steps held against plain ones
AB_STEPS = 10        # timed steps of an A/B run, after WARMUP_STEPS
AB_PROFILED = 3      # then steps under torch.profiler
# K4 grid caps tried alone in host mode, in this order: 8, 4, 2 and 1
# blocks an SM, and one block on half of the SMs
K4_CAPS = (1056, 528, 264, 132, 66)
K4_PAIRS = 5      # then the two ends in turn, this many times more
REPORTED_PATH = {"gather_rows": "device", "segment_sum": "gcn",
                 "windowed_draw": "device", "cached_gather": "H",
                 "csr_draw": "HT", "gat_attend": "gat",
                 "hop_attention": "gat", "dedup_keys": "device",
                 "dedup_sort": "device", "dedup_map": "device-map",
                 "step_keys": "device", "hash_lookup": "clique-HT-hash",
                 "bucket_by_owner": "clique-HT", "clique_gather": "clique-HT",
                 "clique_draw": "clique-HT", "hop_mean": "device",
                 "hop_mean_grad": "device", "dropout_act": "device",
                 "segment_max": "segment", "segment_softmax": "segment",
                 "miss_compact": "H-staged", "staged_assemble": "H-staged",
                 "merge_draws": "HT-staged",
                 "csr_draw_device": "HT-staged"}
# bench.py --model gat --features host (GAT-H)
GAT_H = dict(cache_bytes=CACHE_BYTES, feature_residency="host", model="gat")
# bench.py --model X: lp_sage batches divide into thirds, GCN dedups the
# last hop exactly
MODEL_SAMPLER = {"gat": {}, "gcn": dict(dedup_last_hop=True),
                 "lp_sage": dict(batch_size=7998, eval_batch_size=510)}


# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, and operations/s by input type (f64 outside the tensor
# cores; int32 adds, which the data sheet does not list, at f32's rate)
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "f64": 34e12}
# this run's measurements that later phases read: the link's bulk-copy
# rate (phase 5)
MEASURED = {}


def nb(*tensors):
    """Bytes of the tensors."""
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct(ids):
    """How many distinct valid ids."""
    return int(ids[ids >= 0].unique().numel())


def bound(dev_bytes, ops=0.0, peak="f32", link_bytes=0.0, link_bps=None):
    """The least milliseconds the card could take, and what sets it: the
    larger of the bytes the function must move (each input read once, each
    output written once; device memory at its peak rate, and bytes that
    cross PCIe at the rate a bulk copy from the same registered memory
    reached in this run) and its operations at the peak rate of their
    type. Returns (ms, "bytes" | "operations")."""
    t_bytes = dev_bytes / HBM_BPS
    if link_bytes:
        t_bytes = max(t_bytes, link_bytes / link_bps)
    t_ops = ops / PEAK_OPS[peak]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def add_main(results, main):
    """Per train step of a kernel's path: the sums over its launches there
    of kernel, plain, bound and library-call times (None where a launch
    has no library call; the queued time where every launch has one)."""
    for name, times in main.items():
        lib, queued = [t[3] for t in times], [t[4] for t in times]
        results[name].update(
            ms=sum(t[0] for t in times), plain_ms=sum(t[1] for t in times),
            bound_ms=sum(t[2][0] for t in times),
            bound_by=max(times, key=lambda t: t[2][0])[2][1],
            library_ms=None if None in lib else sum(lib),
            queued_ms=None if None in queued else sum(queued))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, torch, iters=TIMING_ITERS):
    """Mean milliseconds per call of fn over ``iters`` launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, torch, iters=50):
    """Mean milliseconds per call of fn with the calls queued behind a
    kernel that holds the card for some 100 ms, so that the host's time to
    launch them is hidden: the card's own time for the work of one call.
    The least of three takes: a host that stalls past the hold lets the
    queue drain, and that take reads the host again."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    takes = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(180_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        takes.append(start.elapsed_time(end) / iters)
    return min(takes)


def host_us(fn, torch, calls=1000):
    """Microseconds of the host's time per call of fn: ``calls`` calls with
    no sync between them (``time.perf_counter``), a sync at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def launch_floor(torch):
    """The least a launch through the port's ctypes route costs: an empty
    kernel (``csrc/noop.cu``), as the host launches it, queued behind a
    kernel that holds the card, and in the host's own time. No kernel's
    queued time can go under the second figure. Returns it."""
    from legion_tpu_torch.ops import kernels
    ms = cuda_ms(kernels.noop, torch, 200)
    queued = queued_ms(kernels.noop, torch, 200)
    print(f"  launch_floor: an empty kernel {ms:.4f} ms as the host launches "
          f"it | queued {queued:.4f} ms | host_us_per_call "
          f"{host_us(kernels.noop, torch):.2f}")
    if not 0 < queued <= ms * 1.5:
        fail(f"launch_floor: queued {queued} ms against {ms} ms as launched")
    return queued


def grid_sync(torch, blocks, what, floor):
    """K9's yardstick: an empty cooperative kernel of ``blocks`` blocks of
    256 threads (K9's grid for ``what``) with 0, 1 and 5 ``grid.sync()``
    calls, queued (the card's own time), beside ``launch_floor``."""
    from legion_tpu_torch.ops import kernels
    if blocks <= 0:
        fail(f"grid_sync: K9 cannot launch a cooperative grid for {what}")
    q = {n: queued_ms(lambda: kernels.grid_sync_probe(n, blocks), torch, 200)
         for n in (0, 1, 5)}
    print(f"  grid_sync      {what}, {blocks} blocks: queued {q[0]:.4f} ms "
          f"with no barrier, {q[1]:.4f} with 1, {q[5]:.4f} with 5 "
          f"({(q[5] - q[0]) / 5 * 1e3:.2f} us a barrier) | launch_floor "
          f"{floor:.4f} ms")


def compare(name, kernel, plain, tol, results, torch, shape_note,
            iters=TIMING_ITERS, least=None, library=None, queued=False,
            library_bytes=None):
    """Run kernel and plain once, check, then time plain, kernel, kernel,
    plain. tol(k, p) -> (max_abs_err, ok). ``least`` is the kernel's
    ``bound`` for these inputs, ``library`` one PyTorch call that computes
    the same function (timed, used nowhere else), ``library_bytes`` the
    device-memory bytes that call moves where they differ from the
    kernel's (printed with that call's own bound and share). ``queued``
    also times the kernel with the host's launch time hidden
    (``queued_ms``), for a kernel that the host cannot launch as fast as
    the card runs it. Returns
    (kernel ms, plain ms, least, library ms or None, queued ms or None)."""
    k, p = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = tol(k, p)
    del k, p
    if not ok:
        fail(f"{name} {shape_note}: kernel disagrees with its plain "
             f"version (max abs err {err})")
    tp1 = cuda_ms(plain, torch, iters)
    tk1 = cuda_ms(kernel, torch, iters)
    tk2 = cuda_ms(kernel, torch, iters)
    tp2 = cuda_ms(plain, torch, iters)
    ms, plain_ms = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    lib_ms = None if library is None else cuda_ms(library, torch, iters)
    msg = (f"  {name:14s} {shape_note:52s} max_abs_err {err:.3g} | kernel "
           f"{ms:.4f} ms | plain {plain_ms:.4f} ms")
    if least is not None:
        msg += (f" | bound {least[0]:.4f} ms by {least[1]} (share "
                f"{least[0] / ms:.3f})")
    if lib_ms is not None:
        msg += f" | library call {lib_ms:.4f} ms"
        if library_bytes is not None:
            lb = bound(library_bytes)[0]
            msg += (f" ({library_bytes} B, its bound {lb:.4f} ms, share "
                    f"{lb / lib_ms:.3f})")
    q_ms = queued_ms(kernel, torch) if queued else None
    if queued:
        msg += f" | queued {q_ms:.4f} ms"
        if least is not None:
            msg += f" (share {least[0] / q_ms:.3f})"
    print(msg)
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return ms, plain_ms, least, lib_ms, q_ms


def exact(k, p):
    err = (k.float() - p.float()).abs().max().item() if k.numel() else 0.0
    return err, bool((k == p).all().item()) and k.shape == p.shape


def f32_atomic_order(k, p):
    """Segment sums in another order: rtol 1e-5, atol 1e-5 * max|out|."""
    diff = (k - p).abs()
    atol = 1e-5 * p.abs().max().item()
    ok = bool((diff <= atol + 1e-5 * p.abs()).all().item())
    return diff.max().item(), ok


def close_f32(k, p):
    """f32 outputs: rtol 1e-4, atol 1e-5 * max|ref| (sums and expf taken
    in another order)."""
    diff = (k.float() - p.float()).abs()
    ok = bool((diff <= 1e-4 * p.float().abs()
               + 1e-5 * p.float().abs().max()).all().item())
    return diff.max().item(), ok


def ulp_bf16(v):
    """One bf16 ulp (8 significant bits) of each element of v."""
    return (v.float().abs().clamp(min=1e-30).log2().floor() - 7).exp2()


def bf16_ulp(k, p, atol=1e-5):
    """bf16 outputs of f32 sums taken in another order (or by atomics),
    rounded once: one bf16 ulp of the larger value, elementwise, plus an
    atol of ``atol`` * max|ref| (K2's 1e-5 by default)."""
    kf, pf = k.float(), p.float()
    diff = (kf - pf).abs()
    ulp = ulp_bf16(kf.abs().maximum(pf.abs()))
    ok = bool((diff <= ulp + atol * pf.abs().max()).all().item())
    return diff.max().item(), ok


def ulp_f16(v):
    """One f16 ulp (11 significant bits; 2^-24 below the normal range) of
    each element of v."""
    return (v.float().abs().clamp(min=2.0 ** -14).log2().floor() - 10).exp2()


def f16_ulp(k, p, atol=1e-5):
    """f16 outputs of f32 arithmetic taken in another order, rounded once:
    one f16 ulp of the larger value, elementwise, plus ``atol`` *
    max|ref|."""
    kf, pf = k.float(), p.float()
    if not kf.numel():
        return 0.0, k.shape == p.shape
    diff = (kf - pf).abs()
    ulp = ulp_f16(kf.abs().maximum(pf.abs()))
    ok = bool((diff <= ulp + atol * pf.abs().max()).all().item())
    return diff.max().item(), ok


def f64_order(k, p):
    """f64 sums by atomics in any order: within 1e-12 of max|ref|
    elementwise."""
    if not k.numel():
        return 0.0, k.shape == p.shape
    diff = (k - p).abs()
    ok = bool((diff <= 1e-12 * p.abs().max()).all().item())
    return diff.max().item(), ok and k.dtype == p.dtype


def k2_tol(dtype):
    """K2's tolerance for data of ``dtype``: its sums in another order (in
    f32 for f32, bf16 and f16 data, in f64 for f64), exact for int32."""
    import torch
    return {torch.float64: f64_order, torch.int32: exact}.get(
        dtype, f32_atomic_order)


def k6_bf16_tol(args, torch, allow=None, du_atol=2.0 ** -11, quiet=False,
                general=False):
    """K6 in bf16 against its plain version, outputs (xw,) or (xw, du_l,
    du_r) (of the general kernels where ``general``). Both round each
    score x @ u, alpha and d alpha to bf16 from f32 sums taken in
    different orders; where such a sum lies within f32
    rounding of a bf16 rounding midpoint the two round it one bf16 ulp
    apart, which moves the outputs by more than one of their own ulps. So
    the check is taken in stages:
      - alpha before dropout (K6 saves it for its backward) equals the
        plain version's within f32 rounding (rtol 1e-4, atol 1e-6) in
        every (row, head) but those where a score rounded apart, at most
        one in 1000 (``allow`` pairs where given: a small shape has too
        few pairs for a share); there it is within the first-order effect
        of one bf16 ulp in each score, 4 alpha (ulp(el) + ulp(er));
      - xw is within one bf16 ulp, elementwise, of the plain contraction
        of K6's own alpha;
      - du_l and du_r, x^T d_el over about 1M products in both versions,
        are within one bf16 ulp plus 2^-11 max|ref|, elementwise: each
        score or d alpha rounded apart moves every element of the sum by
        a like absolute amount (``du_atol`` where given: a small shape
        sums a few thousand products, and one d alpha rounded apart is a
        larger share of so short a sum)."""
    from legion_tpu_torch.ops import kernels
    x, u_l, u_r, src, off, fo, ao, slope, keep = args
    xw = kernels.gat_attend(*args, general=general)
    alpha = xw.grad_fn.saved_tensors[3]  # (x, src, offset, alpha, neg, mask)
    with torch.no_grad():
        el, er, alpha_p = kernels.gat_scores_plain(x, u_l, u_r, src, off, fo,
                                                   ao, slope)
        ref = kernels.gat_contract_plain(x, alpha, keep, ao)
    diff = (alpha - alpha_p).abs()
    noise = 1e-4 * alpha_p + 1e-6
    apart = (diff > noise).any(dim=0)                     # [F, H]
    step = ulp_bf16(el).amax(dim=0) + ulp_bf16(er)        # [F, H]
    lim = torch.where(apart[None], noise + 4 * alpha_p * step[None], noise)
    n_apart = int(apart.sum())
    if allow is None:
        allow = apart.numel() // 1000
    ok_alpha = n_apart <= allow and bool((diff <= lim).all().item())
    if not quiet:
        print(f"    K6 alpha: scores rounded apart in {n_apart} of "
              f"{apart.numel()} (row, head) pairs; within bound: {ok_alpha}")
    del xw

    def tol(ks, ps):
        errs = [(k.float() - p.float()).abs().max().item()
                for k, p in zip(ks, ps)]
        oks = [ok_alpha, bf16_ulp(ks[0], ref)[1]]
        oks += [bf16_ulp(k, p, atol=du_atol)[1]
                for k, p in zip(ks[1:], ps[1:])]
        if not all(oks):
            print(f"    K6 within bound (alpha, xw, du_l, du_r): {oks}")
        return max(errs), all(oks)
    return tol


def tuple_tol(*tols):
    """Apply tols[i] to output i of tuples; the max err over outputs."""
    def tol(ks, ps):
        errs, oks = zip(*(t(k, p) for t, k, p in zip(tols, ks, ps)))
        return max(errs), all(oks)
    return tol


def bench_config(ds, cache_bytes=0, feature_residency="hbm",
                 topo_residency="hbm", model="graphsage", dedup="sort",
                 fanouts=(25, 10), host_transfer="auto", map_impl="auto"):
    from legion_tpu_torch.config import (CacheConfig, LegionConfig,
                                         MeshConfig, SamplerConfig,
                                         TrainConfig)
    skw = dict(fanouts=fanouts, batch_size=8000, auto_compact=True,
               eval_batch_size=512, dedup=dedup, cap_headroom=1.03,
               neighbor_window=64, dedup_last_hop=False)
    skw.update(MODEL_SAMPLER.get(model, {}))
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(**skw),
        cache=CacheConfig(presample_steps=8, cache_bytes=cache_bytes,
                          feature_residency=feature_residency,
                          topo_residency=topo_residency,
                          host_transfer=host_transfer, map_impl=map_impl),
        train=TrainConfig(model=model, hidden_dim=256, epochs=1,
                          lr=3e-3, dropout=0.5, fused_steps=1,
                          num_layers=len(fanouts)),
        mesh=MeshConfig.for_devices(1))


THREE_HOP = (15, 10, 5)


def phase_three_hop(ds, torch, smi):
    """Phase 3's Device trainer at three hops (fanouts [15, 10, 5],
    GraphSAGE num_layers 3, hidden 256, batch 8000): warm-up and timed
    train steps and an eval pass (``phase_slice``: every kernel of the
    Device path launched, the losses finite), with its ms a step and
    peak memory beside the card's name and power limit. Returns the
    launch counts."""
    from legion_tpu_torch.train import Trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(ds, bench_config(ds, fanouts=THREE_HOP), device="cuda")
    torch.cuda.synchronize()
    s = tr.sampler_t
    print(f" device-3hop: fanouts {list(THREE_HOP)}, {len(THREE_HOP)} "
          f"layers | set-up {time.perf_counter() - t0:.2f} s | caps "
          f"{tr.compact_caps} | frontier sizes {s.frontier_sizes} | edge "
          f"sizes {s.edge_sizes} | max_ids {s.max_ids}")
    counts, step_ms = phase_slice(tr, torch, "device-3hop")
    print(f"  device-3hop: {step_ms:.3f} ms a step, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MB allocated "
          f"| {smi}")
    del tr
    torch.cuda.empty_cache()
    return counts


def phase_kernels(tr, torch):
    """Each kernel against its plain version at the main path's shapes
    (from one real batch) and at the JAX package's benchmark shapes."""
    from dataclasses import replace
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.sampling import access
    from legion_tpu_torch.sampling.sampler import CLAIM_BASE, NeighborSampler
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

    floor = launch_floor(torch)
    sm = NeighborSampler(replace(s.config, dedup="map"), s.num_nodes)
    for what, shape in (
            ("the Device-map batch", (sm.edge_sizes[0],
                                      s.config.batch_size, sm.touched_len)),
            ("the card's resident limit", (CLAIM_BASE - 1, 0, 0))):
        grid_sync(torch, kernels.lib().lt_dedup_map_grid(*shape), what,
                  floor)

    # K3: bit for bit, both hops, its key words read from the card as the
    # main path gives them (a row of K10's output)
    for f, fo, key in ((f0, 25, access.key_tensor(5, dev)),
                       (f1, 10, access.key_tensor(6, dev))):
        # the frontier, a (start, degree) pair per valid slot, one int32
        # per draw read and one written
        valid = int((f >= 0).sum())
        least = bound(nb(f) + valid * 2 * acc.row_pairs.element_size()
                      + 4 * valid * fo + 4 * f.shape[0] * fo)

        def k3():
            return access.windowed_draw(acc.row_pairs, acc.indices2d, f, fo,
                                        key)
        t = compare(
            "windowed_draw", k3,
            lambda: access.windowed_draw_plain(acc.row_pairs, acc.indices2d,
                                               f, fo, key),
            exact, results, torch, f"frontier {f.shape[0]} fanout {fo}",
            least=least, queued=True)
        main.setdefault("windowed_draw", []).append(t)
        print(f"  windowed_draw  frontier {f.shape[0]} fanout {fo}: queued "
              f"{t[4] / floor:.2f} x launch_floor | host_us_per_call "
              f"{host_us(k3, torch):.2f}")
    k10_compares(tr, torch, results, main, floor)

    # K1: exact
    table = tr.feature_source.features
    nid = batch.node_ids[:s.max_ids]
    def k1_least(tbl, ids):
        # the ids, each distinct row read once, every output row written
        row = tbl.shape[1] * tbl.element_size()
        return bound(nb(ids) + (distinct(ids) + ids.shape[0]) * row)

    def k1_library(tbl, ids):
        idx = ids.clamp(min=0).long()
        return lambda: tbl.index_select(0, idx)

    # the Device path fetches the ids before the aligned last hop (K15
    # reads that hop's rows from the table); GAT and GCN fetch them all
    head = nid[:tr._table_head(s, tr.init_state()["model"])]
    main["gather_rows"] = [compare(
        "gather_rows", lambda: kernels.gather_rows(table, head),
        lambda: kernels.gather_rows_plain(table, head), exact, results,
        torch, f"prefix fetch [{table.shape[0]},{table.shape[1]}] bf16 x "
               f"{head.shape[0]}", least=k1_least(table, head),
        library=k1_library(table, head))]
    compare("gather_rows", lambda: kernels.gather_rows(table, nid),
            lambda: kernels.gather_rows_plain(table, nid), exact, results,
            torch, f"whole fetch [{table.shape[0]},{table.shape[1]}] bf16 "
                   f"x {nid.shape[0]}", least=k1_least(table, nid),
            library=k1_library(table, nid))
    ids = torch.randint(0, table.shape[0], (1_247_232,), generator=g,
                        device=dev, dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=g, device=dev) < 0.05] = -1
    compare("gather_rows", lambda: kernels.gather_rows(table, ids),
            lambda: kernels.gather_rows_plain(table, ids), exact, results,
            torch, f"bench ids {ids.shape[0]}, 5% pads")
    S1 = s.cum_caps[1]
    src0 = batch.edge_src[0]
    k15_compares(tr, batch, torch, results, main)
    # K16 at layer 0's output, forward and backward, and at its edges
    k16_compares(tr, torch, results, main, "device")
    k16_edges(torch, results)

    # K2: f32 atomic order
    dmsg = torch.randn((src0.shape[0], 128), generator=g,
                       device=dev).to(torch.bfloat16)
    dmsg32 = dmsg.float()
    def k2_compare(seg, note):
        # the rows and their segments read, the f32 sums written; one add
        # per valid element
        idx = torch.where(seg >= 0, seg, S1).long()
        return compare(
            "segment_sum", lambda: kernels.segment_sum(dmsg, seg, S1),
            lambda: kernels.segment_sum_plain(dmsg, seg, S1),
            f32_atomic_order, results, torch,
            f"E {seg.shape[0]} -> S {S1} bf16, {note}",
            least=bound(nb(dmsg, seg) + 4 * S1 * 128,
                        ops=int((seg >= 0).sum()) * 128),
            library=lambda: torch.zeros(
                (S1 + 1, 128), device=dev).index_add_(0, idx, dmsg32),
            queued=True)

    # how the batch's own segments are skewed, and what the zero-fill of
    # the accumulator costs inside every time below
    full = torch.bincount(src0[src0 >= 0].long(), minlength=S1)
    zero_ms = cuda_ms(lambda: torch.zeros((S1, 128), device=dev), torch)
    print(f"  segment_sum    the batch's segments: {int(full.sum())} valid "
          f"lanes on {int((full > 0).sum())} distinct rows; the fullest "
          f"rows hold {full.sort(descending=True).values[:4].tolist()} | "
          f"zero-fill of [{S1},128] f32 alone {zero_ms:.4f} ms")
    k2_compare(src0, "a layer-1 bwd's per-lane rows (the batch's own)")
    # 200 calls: each is two launches, and the launch queue must not fill
    print(f"  segment_sum    per-lane rows: host_us_per_call "
          f"{host_us(lambda: kernels.segment_sum(dmsg, src0, S1), torch, 200):.2f}")
    # the same E, F, S under other skews: uniform segments; every lane in
    # one; 1% of the segments taking half of the lanes
    E = src0.shape[0]
    uniform = torch.randint(0, S1, (E,), generator=g, device=dev,
                            dtype=torch.int32)
    hot = torch.randperm(S1, generator=g, device=dev)[:S1 // 100]
    hubs = hot[torch.randint(0, hot.numel(), (E,), generator=g,
                             device=dev)].to(torch.int32)
    half = torch.rand((E,), generator=g, device=dev) < 0.5
    for seg, note in ((uniform, "uniform segments"),
                      (torch.full_like(src0, S1 // 2), "one segment"),
                      (torch.where(half, hubs, uniform),
                       "1% of segments take half")):
        k2_compare(seg, note)
    seg = torch.randint(-1, 8192, (200_704,), generator=g, device=dev,
                        dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        data = torch.randn((200_704, 128), generator=g, device=dev).to(dt)
        compare("segment_sum", lambda: kernels.segment_sum(data, seg, 8192),
                lambda: kernels.segment_sum_plain(data, seg, 8192),
                f32_atomic_order, results, torch,
                f"bench E 200704 -> S 8192 {str(dt)[6:]}")
    k2_edges(torch, results)
    k15_edges(torch, results)
    k15_grad_edges(torch, results)
    k3_edges(torch)
    # K8 and K9 at hop 0 of the bench batch, and at their edges
    dedup_compares(tr, torch, results, main)
    dedup_edges(torch, results)
    # per train step: the sum over the main path's launches of a kernel
    # (K3: both hops; K1: the prefix fetch; K15: layer 0 over the table and
    # layer 1 gathered; hop_mean_grad: layer 1's backward; K8: hop 0's
    # keys and its dedup; K9: the one call of the device-map path,
    # register, hop 0 and the clear; K2 from GCN's path, phase 3b)
    add_main(results, main)
    return results


def k2_edges(torch, results):
    """K2 at the edges of its shapes against the plain version
    (``k2_tol``: f32 atomic order, f64 1e-12, int32 exact): widths 1, 3,
    4, 8, 100, 128, 130, 256 (chunks of eight, of four and of one
    column), bf16, f32, f16, f64 and int32 (values across the whole int32
    range: the sums wrap), 1003 lanes into 37 segments: uniform ids with
    a tenth dropped, all -1, all >= S, one hub, one segment (S = 1), no
    lane, one lane; and data that is misaligned: a view that slices one
    column off a wider tensor (rows a stride apart, read in place) and a
    contiguous one whose first byte is one element past a 16-byte
    boundary."""
    from legion_tpu_torch.ops import kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    E, S, n, worst = 1003, 37, 0, 0.0

    def rand(shape, dt):
        if dt == torch.int32:
            return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                                 device="cuda", dtype=dt)
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    uniform = torch.randint(0, S, (E,), generator=g, device="cuda",
                            dtype=torch.int32)
    uniform[torch.rand((E,), generator=g, device="cuda") < 0.1] = -1
    segs = {"uniform": (uniform, S),
            "all -1": (torch.full_like(uniform, -1), S),
            "all >= S": (uniform.clamp(min=0) + S, S),
            "one hub": (torch.full_like(uniform, 5), S),
            "S = 1": (uniform.clamp(max=0), 1),
            "E = 0": (uniform[:0], S), "E = 1": (uniform[:1] * 0 + 3, S)}
    for F in (1, 3, 4, 8, 100, 128, 130, 256):
        for dt in (torch.bfloat16, torch.float32, torch.float16,
                   torch.float64, torch.int32):
            cases = [(what, rand((seg.shape[0], F), dt), seg, num)
                     for what, (seg, num) in segs.items()]
            sliced = rand((E, F + 1), dt)[:, 1:]
            shifted = rand((E * F + 1,), dt)[1:].view(E, F)
            if sliced.data_ptr() % 16 == 0 or shifted.data_ptr() % 16 == 0:
                fail("segment_sum edges: the views are not misaligned as "
                     "the cases want them")
            cases += [("a column sliced off", sliced, uniform, S),
                      ("a misaligned base", shifted, uniform, S)]
            for what, data, seg, num in cases:
                k = kernels.segment_sum(data, seg, num)
                p_ = kernels.segment_sum_plain(data, seg, num)
                err, ok = k2_tol(dt)(k, p_)
                if not ok or k.shape != p_.shape or k.dtype != p_.dtype:
                    fail(f"segment_sum edge F {F} {dt} {what}: kernel "
                         f"disagrees with its plain version (max abs err "
                         f"{err})")
                n, worst = n + 1, max(worst, err)
    torch.cuda.synchronize()
    print(f"  segment_sum    {n} edge cases (widths 1/3/4/8/100/128/130/256,"
          f" bf16, f32, f16, f64 and int32, uniform / all -1 / all >= S / "
          f"one hub / S = 1 / E = 0 / E = 1, a column sliced off, a "
          f"misaligned base): all within tolerance (int32 exactly), "
          f"max_abs_err {worst:.3g}")
    r = results["segment_sum"]
    r["max_abs_err"] = max(r["max_abs_err"], worst)


def k3_edges(torch):
    """K3 at the edges of its shapes, bit for bit against the plain
    version: fanouts 1, 10, 16, 25, 32, 33 (one to four draws of a slot in
    a step, and more draws than a step has lanes); windows 4 and 64;
    frontiers of 0, 1, 31, 32, 33 and 1000 slots; int32 and int64
    ``row_pairs``; a graph of 300 vertices whose rows have degree 0, degree
    1, lie inside one block, straddle two blocks or many, and whose last
    row ends in the padded last block; pads, ids at and past the number of
    vertices. A frontier of one slot is run once for each of those kinds."""
    import numpy as np
    from legion_tpu_torch.graph import DeviceCSR
    from legion_tpu_torch.sampling import access
    rng = np.random.default_rng(9)
    V, n = 300, 0
    deg = np.resize([0, 1, 3, 2, 5, 7, 61, 64, 70, 130, 1, 4], V)
    deg[V - 1] = 3
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    E = int(indptr[-1])
    indices = rng.integers(0, V, E).astype(np.int32)
    csr = DeviceCSR.from_numpy(indptr.astype(np.int32), indices, "cuda")
    for W in (4, 64):
        if E % W == 0:
            fail("windowed_draw edges: the last block has no padding")
        lo_b, hi_b = indptr[:-1] // W, (indptr[1:] - 1) // W
        kinds = {"degree 0": np.flatnonzero(deg == 0)[0],
                 "degree 1": np.flatnonzero(deg == 1)[0],
                 "inside one block": np.flatnonzero(
                     (deg > 1) & (lo_b == hi_b))[0],
                 "straddling two blocks": np.flatnonzero(
                     (deg > 1) & (hi_b == lo_b + 1))[0],
                 "ending in the padded block": V - 1,
                 "a pad": -1, "the number of vertices": V,
                 "past the vertices": 2 ** 31 - 1}
        acc = access.WindowedCSRAccess.from_csr(csr, W)
        for pairs in (acc.row_pairs, acc.row_pairs.long()):
            for F in (0, 1, 31, 32, 33, 1000):
                special = list(kinds.values())
                fronts = [[v] for v in special] if F == 1 else [None]
                for front in fronts:
                    if front is None:
                        ids = rng.integers(0, V, F)
                        ids[rng.random(F) < 0.1] = -1
                        ids[:len(special)] = special[:F]
                    else:
                        ids = np.array(front)
                    ft = torch.from_numpy(ids.astype(np.int32)).cuda()
                    for fo in (1, 10, 16, 25, 32, 33):
                        k = access.windowed_draw(pairs, acc.indices2d, ft,
                                                 fo, 60 + fo)
                        p_ = access.windowed_draw_plain(pairs, acc.indices2d,
                                                        ft, fo, 60 + fo)
                        if not exact(k, p_)[1]:
                            fail(f"windowed_draw edge W {W} {pairs.dtype} F "
                                 f"{F} fanout {fo} frontier {front}: kernel "
                                 f"differs from its plain version")
                        n += 1
    torch.cuda.synchronize()
    print(f"  windowed_draw  {n} edge cases (fanouts 1/10/16/25/32/33, "
          f"windows 4/64, frontiers of 0/1/31/32/33/1000, int32 and int64 "
          f"pairs, rows of degree 0 / 1 / inside a block / straddling / "
          f"ending in the padded block, pads and ids past the graph): all "
          f"exact")


def k10_compares(tr, torch, results, main, floor):
    """K10 against its plain version, exactly: at the main path's L (the
    Device trainer's hops) from its base key, timed like the others (one
    launch a train step, with the dropout key row), and at 1,000 random
    (base_key in [0, 2^63), ctr in [0, 2^31)) pairs, both tags, with the
    dropout key row (K16's words, fold_in(step, 7)), each also checked for
    its counter's increment; eight of them against the host's fold_in
    chain. The same pairs again with the clique paths' CLIQUE_KG members
    ([Kg, L, 4] and [Kg, 2], the member index folded in after the tag),
    eight of them against the host chain fold_in(fold_in(fold_in(base,
    ctr), tag), d)."""
    import numpy as np
    from legion_tpu_torch.sampling import access
    L = tr.sampler_t.config.num_hops
    dev = "cuda"
    base = torch.full((), tr.config.train.seed + 1, dtype=torch.int64,
                      device=dev)
    ck = torch.full((), 12345, dtype=torch.int64, device=dev)
    cp = ck.clone()

    def k10():
        return torch.cat([w.reshape(-1) for w in access.step_keys(
            base, ck, 0, L, dropout=True)])

    def k10_plain():
        return torch.cat([w.reshape(-1) for w in access.step_keys_plain(
            base, cp, 0, L, dropout=True)])
    # the base key and the counter read, the counter, the words and the
    # dropout key written
    t = compare("step_keys", k10, k10_plain, exact, results, torch,
                f"L {L}, tag 0, dropout row", least=bound(32 + 16 * L),
                queued=True)
    main["step_keys"] = [t]
    print(f"  step_keys      L {L}: queued {t[4] / floor:.2f} x launch_floor "
          f"| host_us_per_call {host_us(k10, torch):.2f}")
    rng = np.random.default_rng(10)
    n = 1000
    bases = rng.integers(0, 2 ** 63, n, dtype=np.int64)
    ctrs = rng.integers(0, 2 ** 31, n, dtype=np.int64)
    b_d = torch.from_numpy(bases).to(dev)
    c0 = torch.from_numpy(ctrs).to(dev)
    c_k, c_p = c0.clone(), c0.clone()

    def pairs(fn, c, *members):
        out = [fn(b_d[i], c[i], i % 2, L, *members, dropout=True)
               for i in range(n)]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))
    (out_k, drop_k), (out_p, drop_p) = (
        pairs(access.step_keys, c_k), pairs(access.step_keys_plain, c_p))
    steps = [access.fold_in(access.fold_in(int(bases[i]), int(ctrs[i])),
                            i % 2) for i in range(8)]
    host = torch.stack([access.hop_keys(k, L, dev) for k in steps])
    host_d = torch.stack([access.dropout_words(k, dev) for k in steps])
    if not (torch.equal(out_k, out_p) and torch.equal(out_k[:8], host)
            and torch.equal(drop_k, drop_p)
            and torch.equal(drop_k[:8], host_d)):
        fail("step_keys: the kernel's words or dropout key differ from its "
             "plain version's or the host chain's")
    if not (torch.equal(c_k, c0 + 1) and torch.equal(c_p, c0 + 1)):
        fail("step_keys: a counter was not advanced by one")
    print(f"  step_keys      {n} random (base_key, ctr) pairs, tags 0 and 1: "
          f"words and dropout key all exact, every counter advanced by "
          f"one")
    # the member fold of the clique paths: [Kg, L, 4], member d's words
    # from fold_in(step, d), the device index folded in after the tag
    Kg = CLIQUE_KG
    c_k, c_p = c0.clone(), c0.clone()
    (out_k, drop_k), (out_p, drop_p) = (
        pairs(access.step_keys, c_k, Kg),
        pairs(access.step_keys_plain, c_p, Kg))
    host = torch.stack([torch.stack([access.hop_keys(access.fold_in(
        k, d), L, dev) for d in range(Kg)]) for k in steps])
    host_d = torch.stack([torch.stack([access.dropout_words(
        access.fold_in(k, d), dev) for d in range(Kg)]) for k in steps])
    if tuple(out_k.shape) != (n, Kg, L, 4) or not (
            torch.equal(out_k, out_p) and torch.equal(out_k[:8], host)
            and torch.equal(drop_k, drop_p)
            and torch.equal(drop_k[:8], host_d)):
        fail(f"step_keys: with {Kg} members the kernel's words or dropout "
             f"keys differ from its plain version's or the host chain's")
    if not (torch.equal(c_k, c0 + 1) and torch.equal(c_p, c0 + 1)):
        fail(f"step_keys: with {Kg} members a counter was not advanced by "
             f"one")
    print(f"  step_keys      {Kg} members [{Kg}, {L}, 4] and [{Kg}, 2], the "
          f"same {n} pairs, tags 0 and 1: all exact, eight equal to the "
          f"host chain fold_in(fold_in(fold_in(base, ctr), tag), d) and "
          f"its fold_in(., 7)")
    k10_offsets(torch, L)


def k10_offsets(torch, L, n=1000):
    """K10 at non-zero member offsets, as the ranks of a run across
    processes launch it: members first .. first + m - 1 of a world of 8
    ((5, 1): one member alone on its rank; (2, 4)), at ``n`` random (base,
    ctr) pairs, both tags, exact against the plain version and equal to
    rows first:first+m of the all-members words."""
    import numpy as np
    from legion_tpu_torch.sampling import access
    rng = np.random.default_rng(11)
    b_d = torch.from_numpy(rng.integers(0, 2 ** 63, n, dtype=np.int64)
                           ).to("cuda")
    c0 = torch.from_numpy(rng.integers(0, 2 ** 31, n, dtype=np.int64)
                          ).to("cuda")
    n_dev = 8
    for first, m in ((5, 1), (2, 4)):
        c_k, c_p, c_f = c0.clone(), c0.clone(), c0.clone()
        out_k = torch.stack([access.step_keys(b_d[i], c_k[i], i % 2, L,
                                              n_dev, first, m)
                             for i in range(n)])
        out_p = torch.stack([access.step_keys_plain(b_d[i], c_p[i], i % 2, L,
                                                    n_dev, first, m)
                             for i in range(n)])
        full = torch.stack([access.step_keys(b_d[i], c_f[i], i % 2, L, n_dev)
                            for i in range(n)])
        if tuple(out_k.shape) != (n, m, L, 4) or not (
                torch.equal(out_k, out_p)
                and torch.equal(out_k, full[:, first:first + m])):
            fail(f"step_keys: members {first} .. {first + m - 1} of {n_dev}:"
                 " the kernel's words differ from its plain version's or "
                 "from those rows of all members' words")
        if not torch.equal(c_k, c0 + 1):
            fail("step_keys: at an offset a counter was not advanced by one")
    print(f"  step_keys      at member offsets (5, 1 member) and (2, 4 "
          f"members) of {n_dev}, {n} pairs each: exact, and the slices of "
          "all members' words")


def k8_compare(note, skey, stag, P, cum, ids, cap, results, torch,
               main=None):
    """K8 against its plain version (exact: src_l, n_new and the ids
    buffer) on one hop's sorted keys, with its bound, queued time and the
    host's time a call. No single PyTorch call computes these positions;
    the library call timed beside it, ``torch.unique_consecutive`` of the
    sorted keys with their runs, computes less (the distinct ids and each
    entry's run: no authority, no positions, no lane order, no ids block)
    and waits for the host to size its output. Each call rewrites the
    same ids block, so repeated calls do the same work."""
    from legion_tpu_torch.sampling import sampler as smp
    ids_k, ids_p = ids.clone(), ids.clone()

    def kern():
        return smp.dedup_sort(skey, stag, P, cum, ids_k, cap) + (ids_k,)

    def plain():
        return smp.dedup_sort_plain(skey, stag, P, cum, ids_p, cap) + (ids_p,)
    E = skey.shape[0] - P
    # the sorted keys and tags read; src_l and the ids block written
    least = bound(nb(skey, stag) + 4 * E + 4 * min(E, cap))
    t = compare("dedup_sort", kern, plain, tuple_tol(exact, exact, exact),
                results, torch, note, least=least, queued=True,
                library=lambda: torch.unique_consecutive(
                    skey, return_inverse=True))
    print(f"  dedup_sort     {note}: host_us_per_call "
          f"{host_us(kern, torch, 200):.2f}")
    if main is not None:
        main.setdefault("dedup_sort", []).append(t)


def k9_compare(note, seeds, cand, pos_map, cum, ids, cap, touched, results,
               torch, main=None):
    """K9 against its plain version, exact, on one unit of a batch's work
    that leaves the map as it found it: (with ``seeds``) the seed
    registration, the hop (claim, rank, resolve, read-back), then the clear
    of ``touched`` (a slice of ids). The map between hop and clear is held
    against the plain version's once; then the unit's outputs (src_l,
    n_new, ids, map) and its times, bound, queued time and the host's time
    a call. No single PyTorch call computes the positions: no library
    call."""
    from legion_tpu_torch.sampling import sampler as smp
    bufs = {n: (pos_map.clone(), ids.clone()) for n in ("kernel", "plain")}
    fns = {"kernel": (smp.map_register, smp.dedup_map, smp.map_clear),
           "plain": (smp.map_register_plain, smp.dedup_map_plain,
                     smp.map_clear_plain)}

    def unit(name, clear=True):
        pm, ib = bufs[name]
        reg, hop, clr = fns[name]
        if seeds is not None:
            reg(pm, seeds)
        src, n = hop(cand, pm, cum, ib, cap)
        if clear:
            clr(pm, ib[touched])
        return src, n, ib, pm
    mid = [unit(n, clear=False) for n in ("kernel", "plain")]
    torch.cuda.synchronize()
    if not all(exact(a, b)[1] for a, b in zip(*mid)):
        fail(f"dedup_map {note}: the hop differs from its plain version")
    n_new = int(mid[1][1])
    for name, (_, _, clr) in fns.items():
        clr(bufs[name][0], bufs[name][1][touched])
    if not torch.equal(bufs["kernel"][0], pos_map):
        fail(f"dedup_map {note}: the clear left the map changed")
    # cand, the map entries of its distinct ids read once; src_l, the new
    # ids' entries and ids written; the touched ids read and their entries
    # reset; with seeds, the seeds read and their entries written
    n_t = touched.stop - touched.start
    reg_b = 8 * seeds.shape[0] if seeds is not None else 0
    least = bound(nb(cand) + 4 * distinct(cand) + 4 * cand.shape[0]
                  + 8 * n_new + 8 * n_t + reg_b)
    t = compare("dedup_map", lambda: unit("kernel"), lambda: unit("plain"),
                tuple_tol(exact, exact, exact, exact), results, torch, note,
                least=least, queued=True)
    print(f"  dedup_map      {note}: {n_new} new ids | host_us_per_call "
          f"{host_us(lambda: unit('kernel'), torch, 200):.2f}")
    if main is not None:
        main.setdefault("dedup_map", []).append(t)


def k9_fused_compare(note, seeds, cand, pos_map, cum, ids, cap, clear_len,
                     results, torch, main=None):
    """K9 in one call, as ``NeighborSampler.sample`` makes it: the seeds'
    registration, the hop and the clear of ids[:clear_len], on a map that
    the unit leaves as it found it. Bit for bit against its plain
    composition and against the three separate kernel calls (register,
    hop, clear); then its times, bound, queued time and the host's time a
    call, and those of the three calls beside them."""
    from legion_tpu_torch.sampling import sampler as smp
    bufs = {n: (pos_map.clone(), ids.clone())
            for n in ("fused", "plain", "three calls")}

    def unit(name):
        pm, ib = bufs[name]
        if name == "three calls":
            smp.map_register(pm, seeds)
            src, n = smp.dedup_map(cand, pm, cum, ib, cap)
            smp.map_clear(pm, ib[:clear_len])
        else:
            fn = smp.dedup_map_fused if name == "fused" \
                else smp.dedup_map_fused_plain
            src, n = fn(cand, pm, cum, ib, cap, seeds, clear_len)
        return src, n, ib, pm
    outs = [unit(n) for n in bufs]
    torch.cuda.synchronize()
    for name, out in zip(list(bufs)[1:], outs[1:]):
        if not all(exact(a, b)[1] for a, b in zip(outs[0], out)):
            fail(f"dedup_map {note}: the fused call differs from {name}")
    if not torch.equal(bufs["fused"][0], pos_map):
        fail(f"dedup_map {note}: the call left the map changed")
    n_new = int(outs[1][1])
    touched = int((outs[1][2][:clear_len] >= 0).sum())
    # cand, the map entries of its distinct ids read once; src_l, the new
    # ids' entries and ids written; the seeds read and their entries
    # written; ids[:clear_len] read and the valid ones' entries reset
    least = bound(nb(cand) + 4 * distinct(cand) + 4 * cand.shape[0]
                  + 8 * n_new + 8 * seeds.shape[0] + 4 * clear_len
                  + 4 * touched)
    t = compare("dedup_map", lambda: unit("fused"), lambda: unit("plain"),
                tuple_tol(exact, exact, exact, exact), results, torch, note,
                least=least, queued=True)
    three = (cuda_ms(lambda: unit("three calls"), torch),
             queued_ms(lambda: unit("three calls"), torch))
    print(f"  dedup_map      {note}: {n_new} new ids | host_us_per_call "
          f"{host_us(lambda: unit('fused'), torch, 200):.2f} | the three "
          f"calls: {three[0]:.4f} ms, queued {three[1]:.4f} ms, "
          f"host_us_per_call "
          f"{host_us(lambda: unit('three calls'), torch, 200):.2f}")
    if main is not None:
        main.setdefault("dedup_map", []).append(t)


def dedup_compares(tr, torch, results, main, gcn=False):
    """K8 and K9 at a path's shapes, from one real batch of ``tr`` (the
    Device trainer: hop 0, 8000 + 200,000 sorted entries and 200,000
    lanes; the GCN trainer: hop 1, 104,576 + 965,760 entries and 965,760
    lanes). K8: its keys, then everything after the sort. K9 samples the
    same batch with a map-dedup sampler of the same configuration; at hop 0
    its unit is the registration, the hop and the clear of the batch, in
    three calls and in the sampler's one call; at hop 1 the hop and the
    clear of its new ids (three calls' unit without the first), and in one
    call the registration of hop 0's ids (the map hop 0 leaves), the hop
    and the clear of every id."""
    from dataclasses import replace
    from legion_tpu_torch.sampling import sampler as smp
    s, acc = tr.sampler_t, tr.graph_access
    seeds = tr.train_bank[:s.config.batch_size]
    fo = s.config.fanouts
    sm = smp.NeighborSampler(replace(s.config, dedup="map"), s.num_nodes)
    for smp_, form in ((s, "sort"), (sm, "map")):
        pm = smp_.init_state("cuda")
        carry = smp_.begin(seeds, pm)
        cand = acc.sample_neighbors(smp_.hop_frontier(carry, 0), fo[0], 77)
        k = 0
        if gcn:
            carry = smp_.hop_absorb(carry, 0, cand)
            cand = acc.sample_neighbors(smp_.hop_frontier(carry, 1), fo[1],
                                        78)
            k = 1
        P, cap = s.cum_caps[k], s.cum_caps[k + 1]
        prefix = f"P {P} + " if form == "sort" else ""
        note = (f"{'GCN ' if gcn else ''}hop {k}: {prefix}E {cand.shape[0]} "
                f"-> cap {cap}")
        ids, E = carry["ids"], cand.shape[0]
        if form == "sort":
            # the keys: ids[:P] and cand read, the keys written
            t = compare("dedup_keys", lambda: smp.dedup_keys(ids, cand, P),
                        lambda: smp.dedup_keys_plain(ids, cand, P), exact,
                        results, torch, note,
                        least=bound(4 * P + nb(cand) + 4 * (P + E)),
                        queued=True)
            print(f"  dedup_keys     {note}: host_us_per_call "
                  f"{host_us(lambda: smp.dedup_keys(ids, cand, P), torch):.2f}")
            if not gcn:
                main.setdefault("dedup_keys", []).append(t)
            keys = smp.dedup_keys(ids, cand, P)
            skey, stag = smp.dedup_sort_keys(ids, cand, P)
            # what stays torch before K8: the stable sort
            t_keys = cuda_ms(lambda: smp.dedup_sort_keys(ids, cand, P),
                             torch)
            t_sort = cuda_ms(lambda: torch.sort(keys, stable=True), torch)
            print(f"  dedup_sort     {note}: before it, the keys and their "
                  f"sort {t_keys:.4f} ms; torch.sort(stable=True) of the "
                  f"{keys.shape[0]} keys alone {t_sort:.4f} ms")
            k8_compare(note, skey, stag, P, carry["cum"], ids, cap,
                       results, torch, None if gcn else main)
        elif gcn:
            cum = carry["cum"]
            n0 = int(cum)
            k9_compare(note + ", hop + clear of its new ids", None, cand, pm,
                       cum, ids, cap, slice(n0, cap), results, torch)
            k9_fused_compare(
                note + f", one call: register hop 0's {n0} ids + hop + "
                f"clear of all {sm.touched_len}", ids[:n0].clone(), cand,
                sm.init_state("cuda"), cum, ids, cap, sm.touched_len,
                results, torch)
        else:
            k9_compare(note + ", register + hop + clear", seeds, cand,
                       smp_.init_state("cuda"), carry["cum"], ids, cap,
                       slice(0, cap), results, torch)
            k9_fused_compare(note + ", the same in one call", seeds, cand,
                             smp_.init_state("cuda"), carry["cum"], ids,
                             cap, sm.touched_len, results, torch, main)
        del carry
    torch.cuda.synchronize()


def dedup_edge_case(case, rng, torch):
    """(seeds, candidates, node_caps, V, cap) of one edge case of K8/K9 at
    hop 0, on the card; cap overrides the hop's cap where it is not None.
    Tiles hold 2048 sorted entries (K8) or 1024 lanes (K9)."""
    import numpy as np
    V, B, fo, cap = 5000, 64, 40, None
    if case == "a hub of 10,477 in 200,000 lanes":
        V, B, fo = 300_000, 8000, 25
    elif case == "exactly one K8 tile":
        B, fo = 32, 63                       # 32 + 2016 = 2048 entries
    elif case == "one past a K8 tile":
        B, fo = 683, 2                       # 683 + 1366 = 2049 entries
    elif case == "exactly one K9 tile":
        B, fo = 32, 32                       # 1024 lanes
    elif case == "below one tile":
        B, fo = 8, 5
    elif case in ("a new id over 66 tiles", "a seed over 66 tiles"):
        fo = 2100                            # 64 + 134,400 entries
    elif case == "3,000,000 lanes, more tiles than the grid":
        V, B, fo = 4_000_000, 1000, 3000
    elif case == "M = 1: one seed, no lanes":
        B, fo = 1, 0
    elif case == "E = 0":
        fo = 0
    seeds = rng.choice(V, B, replace=False).astype(np.int32)
    if B > 1:
        seeds[-max(1, B // 12):] = -1
    E = B * fo
    cand = rng.integers(0, V, E).astype(np.int32)
    cand[rng.random(E) < 0.1] = -1
    fresh = np.setdiff1d(np.arange(min(V, 100_000)), seeds)
    caps = None
    if case in ("one new id in every lane", "a new id over 66 tiles"):
        cand[:] = fresh[7]
    elif case in ("one seed in every lane", "a seed over 66 tiles"):
        cand[:] = seeds[3]
    elif case == "a run across a tile":
        cand[rng.permutation(E)[:1500]] = fresh[11]
    elif case == "a run starting in a tile's last entry":
        # 2047 valid keys below 2000, then 300 lanes of 2000: the run
        # starts at sorted entry 2047, the last of K8's tile 0
        seeds[:-5] = rng.choice(1000, B - 5, replace=False)
        low = rng.integers(0, 1000, 2047 - (B - 5))
        high = rng.integers(2001, V, E - low.shape[0] - 300)
        high[rng.random(high.shape[0]) < 0.1] = -1
        cand = rng.permutation(np.concatenate(
            [low, np.full(300, 2000), high])).astype(np.int32)
    elif case == "only seeds and pads: no new id":
        cand = rng.choice(seeds[seeds >= 0], E).astype(np.int32)
        cand[rng.random(E) < 0.2] = -1
    elif case == "all pads":
        cand[:] = -1
    elif case == "a cap that binds mid-run":
        cand = rng.choice(np.arange(0, V, 50), E).astype(np.int32)
        caps = (B, B + 50)
    elif case == "a cap equal to cum":
        seeds[:] = rng.choice(V, B, replace=False)
        caps = (B, B)
    elif case == "cap 0":
        cap = 0
    elif case == "repeated seeds, pads among them":
        seeds[5:9] = seeds[1]
        seeds[12:15] = -1
    elif case == "ids at and past V":
        cand[:6] = (V, V + 5, 2 ** 31 - 1, V - 1, 0, V)
    elif case == "a hub of 10,477 in 200,000 lanes":
        cand[rng.permutation(E)[:10_477]] = fresh[3]
    return (torch.from_numpy(seeds).cuda(), torch.from_numpy(cand).cuda(),
            caps, V, cap)


DEDUP_EDGE_CASES = (
    "random", "one new id in every lane", "one seed in every lane",
    "a run across a tile", "all pads", "a cap that binds mid-run",
    "a cap equal to cum", "below one tile", "exactly one K8 tile",
    "one past a K8 tile", "exactly one K9 tile",
    "repeated seeds, pads among them", "ids at and past V",
    "a hub of 10,477 in 200,000 lanes", "a new id over 66 tiles",
    "a seed over 66 tiles",
    "a run starting in a tile's last entry",
    "only seeds and pads: no new id", "cap 0", "M = 1: one seed, no lanes",
    "E = 0", "3,000,000 lanes, more tiles than the grid")


def dedup_edges(torch, results):
    """K8 (``k8_edges``) and K9 (``k9_edges``) at the edges of their shapes,
    bit for bit against their plain versions, one deduped hop each from
    ``begin``: every case of ``DEDUP_EDGE_CASES`` (runs across tiles and
    over 66 tiles, a run that starts in a tile's last entry, no new id,
    caps that bind, leave no room or are 0, M below, at and one past a
    tile, M = 1, E = 0, pads, repeated seeds, ids past V, a 200,000-lane
    hub, 3,000,000 lanes: more tiles than K9's grid has blocks); K8's keys,
    and K8 with int64 tags (``torch.sort``'s) and int32 tags; K9's three
    calls (register, hop, the map between, clear), and its one fused call
    with the registration on and off and the clear on and off, against
    its plain composition and the three calls. The map must be clean after
    every clear (but where seeds repeat with pads among them, which JAX
    leaves unclean too)."""
    import numpy as np
    from legion_tpu_torch.config import SamplerConfig
    from legion_tpu_torch.sampling import sampler as smp
    rng = np.random.default_rng(17)
    n8 = n9 = nf = 0
    for case in DEDUP_EDGE_CASES:
        seeds, cand, caps, V, cap_o = dedup_edge_case(case, rng, torch)
        B = seeds.shape[0]
        cfg = SamplerConfig(fanouts=(cand.shape[0] // B,), batch_size=B,
                            dedup="sort", node_caps=caps)
        s = smp.NeighborSampler(cfg, V)
        P = s.cum_caps[0]
        cap = s.cum_caps[1] if cap_o is None else cap_o
        carry = s.begin(seeds)
        keys = smp.dedup_keys(carry["ids"], cand, P)
        if not exact(keys, smp.dedup_keys_plain(carry["ids"], cand, P))[1]:
            fail(f"dedup_keys edge {case}: kernel differs from its plain "
                 "version")
        skey, stag = torch.sort(keys, stable=True)
        for tags in (stag, stag.int()):
            ids_k, ids_p = carry["ids"].clone(), carry["ids"].clone()
            k = smp.dedup_sort(skey, tags, P, carry["cum"], ids_k, cap)
            p_ = smp.dedup_sort_plain(skey, tags, P, carry["cum"], ids_p, cap)
            if not all(exact(a, b)[1] for a, b in zip(k + (ids_k,),
                                                      p_ + (ids_p,))):
                fail(f"dedup_sort edge {case} tags {tags.dtype}: kernel "
                     f"differs from its plain version")
            n8 += 1
        ids0 = carry["ids"]
        sm = smp.NeighborSampler(SamplerConfig(
            fanouts=cfg.fanouts, batch_size=B, dedup="map", node_caps=caps),
            V)
        clean = case != "repeated seeds, pads among them"
        out = []
        for reg, hop, clr in ((smp.map_register, smp.dedup_map,
                               smp.map_clear),
                              (smp.map_register_plain, smp.dedup_map_plain,
                               smp.map_clear_plain)):
            pm, ids = sm.init_state("cuda"), ids0[:sm.ids_len].clone()
            reg(pm, seeds)
            after_reg = pm.clone()
            src, n = hop(cand, pm, carry["cum"], ids, cap)
            mid = pm.clone()
            clr(pm, ids[:sm.touched_len])
            out.append((after_reg, src, n, ids, mid, pm))
        if not all(exact(a, b)[1] for a, b in zip(*out)):
            fail(f"dedup_map edge {case}: kernel differs from its plain "
                 f"version")
        if clean and not bool((out[0][-1] == 2 ** 31 - 1).all()):
            fail(f"dedup_map edge {case}: the map is not clean after the "
                 "clear")
        n9 += 1
        for with_reg in (True, False):
            for with_clear in (True, False):
                clear_len = sm.touched_len if with_clear else 0
                forms = []
                for form in ("fused", "plain", "three calls"):
                    pm, ids = sm.init_state("cuda"), ids0[:sm.ids_len].clone()
                    if not with_reg:
                        smp.map_register_plain(pm, seeds)
                    sd = seeds if with_reg else None
                    if form == "three calls":
                        if with_reg:
                            smp.map_register(pm, seeds)
                        src, n = smp.dedup_map(cand, pm, carry["cum"], ids,
                                               cap)
                        smp.map_clear(pm, ids[:clear_len])
                    else:
                        fn = smp.dedup_map_fused if form == "fused" \
                            else smp.dedup_map_fused_plain
                        src, n = fn(cand, pm, carry["cum"], ids, cap, sd,
                                    clear_len)
                    forms.append((src, n, ids, pm))
                for name, f in zip(("plain", "three calls"), forms[1:]):
                    if not all(exact(a, b)[1] for a, b in zip(forms[0], f)):
                        fail(f"dedup_map edge {case}, register {with_reg}, "
                             f"clear {with_clear}: the fused call differs "
                             f"from {name}")
                if with_clear and clean and not bool(
                        (forms[0][3] == 2 ** 31 - 1).all()):
                    fail(f"dedup_map edge {case}, register {with_reg}: the "
                         "map is not clean after the fused call")
                nf += 1
    torch.cuda.synchronize()
    what = ", ".join(DEDUP_EDGE_CASES)
    print(f"  dedup_sort     k8_edges: {n8} edge cases ({what}; the keys; "
          f"int64 and int32 tags): all exact")
    print(f"  dedup_map      k9_edges: {n9} edge cases of the three calls "
          f"(register, hop, the map between, clear) and {nf} of the fused "
          f"call (register on and off, clear on and off; against its plain "
          f"composition and the three calls): all exact")


def k2_gcn_compare(tr, torch, results):
    """K2 at GCN's out-degree shapes: a column of ones over each hop's
    edge list of one real batch of the GCN trainer (F = 1, a float an
    atomic), as ``models/gcn.py::block_out_degree`` calls it, once a layer
    a step. Counts are whole numbers, so the sums are exact in any order.
    Returns the ``compare`` tuples (K2's launches on GCN's path)."""
    from legion_tpu_torch.ops import kernels
    batch, _ = one_batch(tr, torch)
    sizes = tr.sampler_t.config.cum_sizes()
    times = []
    for hop in (1, 0):
        src, n_src = batch.edge_src[hop], sizes[hop + 1]
        ones = torch.ones((src.shape[0], 1), device="cuda")
        idx = torch.where(src >= 0, src, n_src).long()
        times.append(compare(
            "segment_sum", lambda: kernels.segment_sum(ones, src, n_src),
            lambda: kernels.segment_sum_plain(ones, src, n_src), exact,
            results, torch, f"GCN out-degree hop {hop} E {src.shape[0]} -> "
            f"S {n_src} f32, F 1", least=bound(nb(ones, src) + 4 * n_src,
                                               ops=int((src >= 0).sum())),
            library=lambda: torch.zeros((n_src + 1, 1), device="cuda")
            .index_add_(0, idx, ones), queued=True))
    return times


def nan_tol(tol):
    """``tol`` on the finite elements of the plain version, once the
    kernel holds the same NaN and infinity wherever the plain version
    holds one (K18 spreads a NaN lane's NaN over its segment; the mean
    sums infinities)."""
    def check(k, p):
        k, p = k.float(), p.float()
        odd = ~p.isfinite()
        same = (k == p) | (k.isnan() & p.isnan())
        if not bool(same[odd].all().item()):
            return float("nan"), False
        return tol(k.masked_fill(odd, 0), p.masked_fill(odd, 0))
    return check


def seg_mean_plain(data, ids, S):
    """The segment mean by its kernels' plain versions: K2's f32 sums of
    the rows and of a column of ones, divided, cast."""
    from legion_tpu_torch.ops import kernels
    ones = data.new_ones((data.shape[0], 1)).float()
    cnt = kernels.segment_sum_plain(ones, ids, S).clamp_min(1.0)
    return (kernels.segment_sum_plain(data, ids, S) / cnt).to(data.dtype)


def seg_grad(fn, x, g, torch):
    """fn(x) and its gradient at g, through autograd."""
    xg = x.detach().requires_grad_()
    y = fn(xg)
    return y.detach(), torch.autograd.grad(y, xg, g)[0]


SEG_F32 = nan_tol(f32_atomic_order)    # K18 f32: rtol 1e-5 (sum order)
SEG_BF16 = nan_tol(bf16_ulp)           # K18 bf16: one bf16 ulp
SEG_F16 = nan_tol(f16_ulp)             # K18 f16: one f16 ulp


def phase_segment(tr, torch, results, main, turns=False):
    """The JAX package's segment ops that no model calls (K17
    ``segment_max``, K18 ``segment_softmax``, and the mean by K2 and K1)
    at full-size shapes from one real batch of ``tr`` (the GCN trainer,
    exact last-hop dedup): the ids are its layer-0 block's ``edge_dst``,
    pads and all. First the path: each op once through ``legion_tpu_torch.
    ops`` under autograd, forward and backward, the counts set to 0 just
    before and read just after (``PATH_KERNELS["segment"]``: the max, the
    mean and the sum over [E, 128] bf16 rows, the softmax over [E, 8]
    scores in f32 and in bf16, a DGL GATConv edge softmax). Then each
    kernel against
    its plain version at those shapes, timed: K17 bit for bit, K18 f32
    within rtol 1e-5 and bf16 within one ulp, the mean within one bf16
    ulp; the grouping of the lanes by segment that K17 and K18 run first
    exactly against its plain version and timed alone
    (``seg_grouping_time``), K18 the same bits in two runs; each backward
    reads the grouping its forward wrote, as autograd runs it. Then the
    same at the block's ids under a fixed seeded permutation
    (``seg_shuffled``), and, with ``turns`` where
    ``_archive/parent`` holds a ``git archive`` of the parent commit, the
    parent's K17 and K18 timed in turns with these (``seg_turns``). Last,
    the forms for JAX's other dtypes and ids (``seg_forms``).
    Returns the launch counts."""
    from legion_tpu_torch import ops
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.ops import segment as sg
    batch, _ = one_batch(tr, torch)
    ids = batch.edge_dst[1]
    S = tr.sampler_t.config.cum_sizes()[1]
    E = ids.shape[0]
    valid = int((ids >= 0).sum())
    g = torch.Generator(device="cuda")
    g.manual_seed(24)
    rows = torch.randn((E, 128), generator=g, device="cuda") \
        .to(torch.bfloat16)
    scores = {dt: (2 * torch.randn((E, 8), generator=g, device="cuda"))
              .to(dt) for dt in (torch.float32, torch.bfloat16)}
    g_rows = torch.randn((S, 128), generator=g, device="cuda") \
        .to(torch.bfloat16)
    g_sc = {dt: torch.randn((E, 8), generator=g, device="cuda").to(dt)
            for dt in scores}
    print(f"  segment ops at GCN's layer-0 block: E {E} lanes ({valid} "
          f"valid), S {S} segments")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out_max, d_max = seg_grad(
        lambda x: ops.masked_segment_max(x, ids, S), rows, g_rows, torch)
    out_mean, d_mean = seg_grad(
        lambda x: ops.masked_segment_mean(x, ids, S), rows, g_rows, torch)
    out_sum, d_sum = seg_grad(
        lambda x: ops.masked_segment_sum(x, ids, S), rows, g_rows, torch)
    soft = {dt: seg_grad(lambda x: ops.segment_softmax(x, ids, S), s,
                         g_sc[dt], torch) for dt, s in scores.items()}
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"  launches on the segment path: "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name in PATH_KERNELS["segment"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the segment path")
    for what, t, shape in (("max", out_max, (S, 128)),
                           ("mean", out_mean, (S, 128)),
                           ("sum", out_sum, (S, 128)),
                           ("d max", d_max, (E, 128)),
                           ("d mean", d_mean, (E, 128)),
                           ("d sum", d_sum, (E, 128))) + tuple(
            (f"softmax {str(dt)[6:]} {i}", soft[dt][i], (E, 8))
            for dt in soft for i in (0, 1)):
        if tuple(t.shape) != shape or not bool(t.float().isfinite().all()):
            fail(f"segment path: {what} {tuple(t.shape)} not finite of "
                 f"shape {shape}")
    p32 = soft[torch.float32][0].float()
    if not bool((p32[ids < 0] == 0).all()):
        fail("segment path: a pad lane's softmax is not 0")
    sums = torch.zeros((S + 1, 8), device="cuda").index_add_(
        0, torch.where(ids >= 0, ids, S).long(), p32)[:S]
    has = torch.zeros(S + 1, dtype=torch.bool, device="cuda")
    has[torch.where(ids >= 0, ids, S).long()] = True
    if not bool(((sums[has[:S]] - 1).abs() <= 1e-5).all()):
        fail("segment path: a segment's softmax does not sum to 1")
    counts["per_step"] = dict(counts)     # the path is one pass

    # K17 against its plain version, the library's scatter_reduce_ beside
    init = torch.tensor(torch.finfo(torch.bfloat16).min,
                        dtype=torch.bfloat16)
    key = int(sg.order_keys_plain(init))
    idx = torch.where(ids >= 0, ids, S).long()[:, None].expand(E, 128)
    row_b = valid * 128 * 2
    note = f"[{E},128] bf16 -> [{S},128]"
    fwd = compare("segment_max", lambda: sg.segment_max_fwd(rows, ids, S,
                                                            key),
                  lambda: sg.segment_max_plain(rows, ids, S, key), bit_exact,
                  results, torch, note + " fwd",
                  least=bound(row_b + nb(ids) + S * 256, ops=valid * 128),
                  library=lambda: torch.full(
                      (S + 1, 128), float(init), dtype=torch.bfloat16,
                      device="cuda").scatter_reduce_(0, idx, rows, "amax"),
                  queued=True)
    # the backward reads the grouping its forward wrote, as autograd runs it
    groups = sg.segment_groups_buffer(ids, S)
    if not same_bits(sg.segment_max_fwd(rows, ids, S, key, groups), out_max,
                     torch):
        fail("segment_max: the path's forward differs from the kernel's")
    bwd = compare("segment_max", lambda: sg.segment_max_bwd(
        rows, ids, out_max, g_rows, float(init), groups),
        lambda: sg.segment_max_bwd_plain(rows, ids, out_max, g_rows,
                                         float(init)), bit_exact, results,
        torch, note + " bwd",
        least=bound(row_b + nb(ids) + 2 * S * 256 + E * 256,
                    ops=valid * 128), queued=True)
    main["segment_max"] = [fwd, bwd]

    def max_plain_both():
        o = sg.segment_max_plain(rows, ids, S, key)
        return o, sg.segment_max_bwd_plain(rows, ids, o, g_rows, float(init))
    compare("segment_max", lambda: seg_grad(
        lambda x: ops.masked_segment_max(x, ids, S), rows, g_rows, torch),
        max_plain_both, tuple_tol(bit_exact, bit_exact), results, torch,
        note + " fwd+bwd (autograd; plain: both plain versions; library: "
        "scatter_reduce amax under autograd)",
        least=bound(row_b + nb(ids) + 2 * S * 256 + E * 256,
                    ops=2 * valid * 128),
        library=lambda: seg_grad(lambda x: torch.full(
            (S + 1, 128), float(init), dtype=torch.bfloat16,
            device="cuda").scatter_reduce(0, idx, x, "amax",
                                          include_self=False)[:S],
            rows, g_rows, torch), queued=True)

    # K18, f32 and bf16, each way
    main["segment_softmax"] = []
    for dt, s in scores.items():
        es = s.element_size()
        tol = SEG_F32 if dt == torch.float32 else SEG_BF16
        note = f"[{E},8] {str(dt)[6:]}, S {S}"
        p = soft[dt][0]
        sgr = sg.segment_groups_buffer(ids, S)
        if not same_bits(sg.segment_softmax_fwd(s, ids, S, sgr), p, torch):
            fail("segment_softmax: the path's forward differs from the "
                 "kernel's")
        main["segment_softmax"].append(compare(
            "segment_softmax", lambda s=s: sg.segment_softmax_fwd(s, ids, S),
            lambda s=s: sg.segment_softmax_plain(s, ids, S), tol, results,
            torch, note + " fwd",
            least=bound(valid * 8 * es + nb(ids) + E * 8 * es,
                        ops=3 * valid * 8), queued=True))
        main["segment_softmax"].append(compare(
            "segment_softmax",
            lambda p=p, dt=dt, sgr=sgr: sg.segment_softmax_bwd(
                p, g_sc[dt], ids, S, sgr),
            lambda p=p, dt=dt: sg.segment_softmax_bwd_plain(p, g_sc[dt],
                                                            ids, S),
            tol, results, torch, note + " bwd",
            least=bound(2 * valid * 8 * es + nb(ids) + E * 8 * es,
                        ops=4 * valid * 8), queued=True))
        # forward + backward under autograd against the plain chain: in
        # bf16 the two backwards read p's one ulp apart, which moves dx by
        # up to ulp(p) |g - sum p g|: 2^-7 max|g| more
        gmax = g_sc[dt].float().abs().max().item()
        both_tol = tol if dt == torch.float32 else nan_tol(
            lambda k, p, gmax=gmax: bf16_ulp(k, p, 2.0 ** -7 * gmax
                                            / max(p.abs().max().item(),
                                                  1e-30)))

        def plain_both(s=s, dt=dt):
            pp = sg.segment_softmax_plain(s, ids, S)
            return pp, sg.segment_softmax_bwd_plain(pp, g_sc[dt], ids, S)
        compare("segment_softmax", lambda s=s, dt=dt: seg_grad(
            lambda x: ops.segment_softmax(x, ids, S), s, g_sc[dt], torch),
            plain_both, tuple_tol(tol, both_tol), results, torch,
            note + " fwd+bwd (autograd; plain chain)",
            least=bound(2 * valid * 8 * es + nb(ids) + 2 * E * 8 * es,
                        ops=7 * valid * 8), queued=True)

    seg_groups_check(ids, S, sg, torch, "the block's ids")
    for dt, x in scores.items():
        seg_same_bits(x, g_sc[dt], ids, S, sg, torch,
                      f"[{E},8] {str(dt)[6:]}")
    seg_grouping_time(ids, S, sg, torch)
    seg_shuffled(rows, ids, S, g_rows, scores, g_sc, sg, torch)
    if turns:
        seg_turns(rows, ids, S, g_rows, scores, g_sc, sg, torch)

    # the mean: K2 twice forward, K1 backward; the library's "mean" beside
    compare("mean (K2, K1)", lambda: ops.masked_segment_mean(rows, ids, S),
            lambda: seg_mean_plain(rows, ids, S), nan_tol(bf16_ulp),
            {}, torch, f"[{E},128] bf16 -> [{S},128] fwd",
            least=bound(row_b + nb(ids) + S * 256, ops=valid * 129),
            library=lambda: torch.zeros(
                (S + 1, 128), dtype=torch.bfloat16, device="cuda")
            .scatter_reduce_(0, idx, rows, "mean", include_self=False),
            queued=True)
    compare("mean (K2, K1)",
            lambda: seg_grad(lambda x: ops.masked_segment_mean(x, ids, S),
                             rows, g_rows, torch),
            lambda: seg_grad(lambda x: seg_mean_plain(x, ids, S), rows,
                             g_rows, torch),
            tuple_tol(nan_tol(bf16_ulp), nan_tol(bf16_ulp)), {}, torch,
            f"[{E},128] bf16 fwd+bwd (library: scatter_reduce mean under "
            "autograd)",
            least=bound(row_b + nb(ids) + 2 * S * 256 + E * 256,
                        ops=valid * 257),
            library=lambda: seg_grad(lambda x: torch.zeros(
                (S + 1, 128), dtype=torch.bfloat16,
                device="cuda").scatter_reduce(0, idx, x, "mean",
                                              include_self=False)[:S],
                rows, g_rows, torch), queued=True)
    seg_forms(rows, ids, S, g_rows, scores, g_sc, sg, torch, results)
    return counts


def seg_forms(rows, ids, S, g_rows, scores, g_sc, sg, torch, results):
    """The forms the public segment ops take for JAX's other dtypes and
    ids, at the block's shapes, each against its plain version and timed
    as ``compare`` times (queued too), with its bound and a library call:
    K2 int32 as [E] and [E, 8] exactly (values across the whole int32
    range: the sums wrap), f16 [E, 128] in f32 atomic order, f64 [E, 8]
    within 1e-12; K17 f16 [E, 128] both ways bit for bit; K18 f16 [E, 8]
    both ways within one f16 ulp; K1 over 1-byte rows (uint8 [S, 13]:
    1-byte words) exactly. Then, through ``legion_tpu_torch.ops`` on the
    card: ``masked_segment_sum``'s result has a grad_fn and its gradient
    (K1) equals the plain version's bit for bit; ``gather_rows``'
    gradient with ids >= V equals the plain version's (K2 into the last
    row); int64 ids, an id past 2^32 among them, give the int32 ids'
    results bit for bit. Fails on any difference."""
    from legion_tpu_torch import ops
    from legion_tpu_torch.ops import kernels
    E = ids.shape[0]
    valid = int(((ids >= 0) & (ids < S)).sum())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    idx = torch.where((ids >= 0) & (ids < S), ids, S).long()

    def lib_sum(data):
        return lambda: torch.zeros((S + 1, data.shape[1]), dtype=data.dtype,
                                   device="cuda").index_add_(0, idx, data)

    # K2's new forms
    forms = [("int32", torch.randint(-2 ** 31, 2 ** 31 - 1, (E, F),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32), "f32")
             for F in (1, 8)]
    forms += [("f16", rows.to(torch.float16), "f32"),
              ("f64", torch.randn((E, 8), generator=gen, device="cuda",
                                  dtype=torch.float64), "f64")]
    for what, data, peak in forms:
        F, es = data.shape[1], data.element_size()
        acc = kernels.SUM_ACC[data.dtype].itemsize
        shape = f"[{E}]" if F == 1 else f"[{E},{F}]"
        compare("segment_sum", lambda d=data: kernels.segment_sum(d, ids, S),
                lambda d=data: kernels.segment_sum_plain(d, ids, S),
                k2_tol(data.dtype), results, torch,
                f"{what} {shape} -> [{S}] rows" + (
                    " (library: index_add_ in f16)" if what == "f16"
                    else ""),
                least=bound(valid * F * es + nb(ids) + S * F * acc,
                            ops=valid * F, peak=peak),
                library=lib_sum(data), queued=True)

    # K17 f16 both ways, bit for bit
    x16 = rows.to(torch.float16)
    g16 = g_rows.to(torch.float16)
    init = torch.tensor(torch.finfo(torch.float16).min, dtype=torch.float16)
    key = int(sg.order_keys_plain(init))
    note = f"[{E},128] f16 -> [{S},128]"
    compare("segment_max", lambda: sg.segment_max_fwd(x16, ids, S, key),
            lambda: sg.segment_max_plain(x16, ids, S, key), bit_exact,
            results, torch, note + " fwd",
            least=bound(valid * 256 + nb(ids) + S * 256, ops=valid * 128),
            library=lambda: torch.full(
                (S + 1, 128), float(init), dtype=torch.float16,
                device="cuda").scatter_reduce_(
                    0, idx[:, None].expand(E, 128), x16, "amax"),
            queued=True)
    groups = sg.segment_groups_buffer(ids, S)
    out16 = sg.segment_max_fwd(x16, ids, S, key, groups)
    compare("segment_max", lambda: sg.segment_max_bwd(
        x16, ids, out16, g16, float(init), groups),
        lambda: sg.segment_max_bwd_plain(x16, ids, out16, g16, float(init)),
        bit_exact, results, torch, note + " bwd",
        least=bound(valid * 256 + nb(ids) + 2 * S * 256 + E * 256,
                    ops=valid * 128), queued=True)

    # K18 f16 both ways, one f16 ulp
    s16 = scores[torch.float32].to(torch.float16)
    gs16 = g_sc[torch.float32].to(torch.float16)
    note = f"[{E},8] f16, S {S}"
    compare("segment_softmax", lambda: sg.segment_softmax_fwd(s16, ids, S),
            lambda: sg.segment_softmax_plain(s16, ids, S), SEG_F16, results,
            torch, note + " fwd",
            least=bound(valid * 16 + nb(ids) + E * 16, ops=3 * valid * 8),
            queued=True)
    sgr = sg.segment_groups_buffer(ids, S)
    p16 = sg.segment_softmax_fwd(s16, ids, S, sgr)
    compare("segment_softmax", lambda: sg.segment_softmax_bwd(
        p16, gs16, ids, S, sgr),
        lambda: sg.segment_softmax_bwd_plain(p16, gs16, ids, S), SEG_F16,
        results, torch, note + " bwd",
        least=bound(2 * valid * 16 + nb(ids) + E * 16, ops=4 * valid * 8),
        queued=True)

    # K1 over 1-byte rows: uint8 [S, 13], the block's ids
    tbl = torch.randint(0, 256, (S, 13), generator=gen, device="cuda",
                        dtype=torch.uint8)
    compare("gather_rows", lambda: kernels.gather_rows(tbl, ids),
            lambda: kernels.gather_rows_plain(tbl, ids), exact, results,
            torch, f"uint8 [{S},13] x {E} (1-byte words)",
            least=bound(nb(ids) + (distinct(ids) + E) * 13),
            library=lambda: tbl.index_select(0, ids.clamp(min=0).long()),
            queued=True)

    # masked_segment_sum differentiates on the card (SegmentSum, K1 back)
    x = rows.float()
    gf = g_rows.float()
    back = torch.where(ids < S, ids, -1)
    out, dx = seg_grad(lambda t: ops.masked_segment_sum(t, ids, S), x, gf,
                       torch)
    probe = ops.masked_segment_sum(x.detach().requires_grad_(), ids, S)
    if probe.grad_fn is None:
        fail("masked_segment_sum on the card: no grad_fn")
    if not (f32_atomic_order(out, kernels.segment_sum_plain(x, ids, S))[1]
            and same_bits(dx, kernels.gather_rows_plain(gf, back), torch)):
        fail("masked_segment_sum on the card: forward or gradient differs "
             "from the plain version's")
    compare("segment_sum", lambda: seg_grad(
        lambda t: ops.masked_segment_sum(t, ids, S), x, gf, torch),
        lambda: (kernels.segment_sum_plain(x, ids, S),
                 kernels.gather_rows_plain(gf, back)),
        tuple_tol(f32_atomic_order, bit_exact), results, torch,
        f"masked_segment_sum f32 [{E},128] fwd+bwd (K2, K1; library: "
        f"index_add under autograd)",
        least=bound(valid * 512 + nb(ids) + S * 512 + S * 512 + E * 512,
                    ops=valid * 128),
        library=lambda: seg_grad(lambda t: torch.zeros(
            (S + 1, 128), device="cuda").index_add(0, idx, t)[:S], x, gf,
            torch), queued=True)

    # gather_rows' gradient with ids past the table: into its last row
    V = S
    over = torch.where(torch.rand(E, generator=gen, device="cuda") < 0.1,
                       V + ids.abs() % 7, ids).to(torch.int32)
    tab = torch.randn((V, 8), generator=gen, device="cuda")
    gg = torch.randn((E, 8), generator=gen, device="cuda")
    _, dt = seg_grad(lambda t: ops.gather_rows(t, over), tab, gg, torch)
    ref = kernels.segment_sum_plain(gg, over.clamp_max(V - 1), V)
    err, ok = f32_atomic_order(dt, ref)
    dropped = kernels.segment_sum_plain(gg, over, V)
    if not ok or f32_atomic_order(dropped, ref)[1]:
        fail(f"gather_rows' gradient with ids >= V: differs from the plain "
             f"version's (max abs err {err}), or the test ids miss row V-1")
    print(f"  gather_rows    gradient, {int((over >= V).sum())} of {E} ids "
          f">= V into row V-1: within f32 atomic order of the plain "
          f"version (max abs err {err:.3g})")

    # int64 ids, an id past 2^32 among them, against the int32 ids that
    # mean the same: a dropped lane in the segment ops, the last row in
    # the gather
    at = torch.arange(0, E, 101, device="cuda")
    big, i32, i32g = ids.long(), ids.clone(), ids.clone()
    big[at], i32[at], i32g[at] = 2 ** 32 + 1, -1, V - 1
    d32 = forms[1][1]
    for what, fn, same in (
            ("masked_segment_max bf16", lambda i: ops.masked_segment_max(
                rows, i, S), i32),
            ("segment_softmax f32", lambda i: ops.segment_softmax(
                scores[torch.float32], i, S), i32),
            ("masked_segment_sum int32", lambda i: ops.masked_segment_sum(
                d32, i, S), i32),
            ("gather_rows f32", lambda i: ops.gather_rows(tab, i), i32g)):
        if not same_bits(fn(big), fn(same), torch):
            fail(f"{what}: int64 ids differ from the int32 ids' result")
    print(f"  int64 ids ({at.numel()} of them 2^32 + 1): the max, the "
          "softmax, the int32 sum and the gather equal the int32 ids' "
          "results bit for bit")


def seg_groups_check(ids, S, sg, torch, what):
    """The groupings of K18 (each run in ascending lane order) and K17 (in
    any order; sorted here) by ``segment_groups`` (the same launches, read
    back in segment order) exactly against ``segment_groups_plain``; fails
    on a difference. Returns the valid lanes."""
    ref = sg.segment_groups_plain(ids, S)
    for sort in (True, False):
        lanes, starts = sg.segment_groups(ids, S, sort)
        if not sort:     # each run's lanes in order: sort by (run, lane)
            run = torch.repeat_interleave(
                torch.arange(S, device=ids.device),
                (starts[1:] - starts[:-1]).long())
            lanes = lanes[torch.sort(run * ids.shape[0] + lanes).indices]
        if not (exact(lanes, ref[0])[1] and exact(starts, ref[1])[1]):
            fail(f"segment grouping at {what} (sorted {sort}): the "
                 "kernels' grouping differs from segment_groups_plain")
    return int(ref[1][-1])


def seg_same_bits(x, g, ids, S, sg, torch, what):
    """K18 forward and backward twice on the same inputs (the backward on
    the forward's grouping): the same bits (no atomic adds a sum); fails
    otherwise."""
    gr = sg.segment_groups_buffer(ids, S)
    for name, fn in (
            ("forward", lambda: sg.segment_softmax_fwd(x, ids, S, gr)),
            ("backward", lambda: sg.segment_softmax_bwd(x, g, ids, S, gr))):
        if not same_bits(fn(), fn(), torch):
            fail(f"segment_softmax {what}: two runs of the {name} differ")


def seg_grouping_time(ids, S, sg, torch):
    """The grouping of the lanes by segment that K17's forward (each run
    in any order) and K18's (sorted into lane order) run first, launched
    alone, queued: its share of their times. Their backwards read the
    forward's and do not group."""
    from legion_tpu_torch.ops import kernels
    E = ids.shape[0]
    groups = sg.segment_groups_buffer(ids, S)
    tmp = torch.empty(kernels.lib().lt_segment_groups_words(S, E, 1),
                      dtype=torch.int32, device=ids.device)
    for sort, who in ((False, "K17, unsorted"), (True, "K18, sorted")):
        def run(sort=sort):
            kernels._check_probe("segment_groups",
                                 kernels.lib().lt_segment_groups(
                                     ids.data_ptr(), E, S, groups.data_ptr(),
                                     tmp.data_ptr(), int(sort),
                                     kernels.stream_handle()))
        print(f"  the grouping ({who}): queued {queued_ms(run, torch):.4f} "
              "ms")


def seg_shuffled(rows, ids, S, g_rows, scores, g_sc, sg, torch):
    """K17 and K18 at the block's ids under a fixed seeded permutation of
    the lanes (the same multiset of ids, so a segment's rows lie at
    random): the grouping exactly, K17 bit for bit both ways, K18 within
    its tolerances and the same bits in two runs; each timed queued
    beside the block's own order (and its plain version as launched),
    each backward on its forward's grouping."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    perm = torch.randperm(ids.shape[0], generator=gen, device="cuda")
    sh = ids[perm].contiguous()
    seg_groups_check(sh, S, sg, torch, "the shuffled ids")
    init = torch.tensor(torch.finfo(torch.bfloat16).min,
                        dtype=torch.bfloat16)
    key = int(sg.order_keys_plain(init))
    note = f"[{ids.shape[0]},128] bf16, shuffled ids"
    out = sg.segment_max_plain(rows, sh, S, key)

    def grouped(fwd):
        """{id of the ids: the grouping that fwd(ids, groups) wrote}, for
        the shuffled ids and the block's: what each backward reads."""
        got = {}
        for i in (sh, ids):
            got[id(i)] = sg.segment_groups_buffer(i, S)
            fwd(i, got[id(i)])
        return got
    mg = grouped(lambda i, gr: sg.segment_max_fwd(rows, i, S, key, gr))
    cases = [("segment_max", note + " fwd", bit_exact,
              lambda i: sg.segment_max_fwd(rows, i, S, key),
              lambda: sg.segment_max_plain(rows, sh, S, key)),
             ("segment_max", note + " bwd", bit_exact,
              lambda i: sg.segment_max_bwd(rows, i, out, g_rows, float(init),
                                           mg[id(i)]),
              lambda: sg.segment_max_bwd_plain(rows, sh, out, g_rows,
                                               float(init)))]
    for dt, x in scores.items():
        tol = SEG_F32 if dt == torch.float32 else SEG_BF16
        p = sg.segment_softmax_plain(x, sh, S).to(dt)
        n = f"[{ids.shape[0]},8] {str(dt)[6:]}, shuffled ids"
        sgr = grouped(lambda i, gr, x=x: sg.segment_softmax_fwd(x, i, S, gr))
        cases += [("segment_softmax", n + " fwd", tol,
                   lambda i, x=x: sg.segment_softmax_fwd(x, i, S),
                   lambda x=x: sg.segment_softmax_plain(x, sh, S)),
                  ("segment_softmax", n + " bwd", tol,
                   lambda i, p=p, dt=dt, sgr=sgr: sg.segment_softmax_bwd(
                       p, g_sc[dt], i, S, sgr[id(i)]),
                   lambda p=p, dt=dt: sg.segment_softmax_bwd_plain(
                       p, g_sc[dt], sh, S))]
        seg_same_bits(x, g_sc[dt], sh, S, sg, torch, n)
    for name, what, tol, kern, plain in cases:
        err, ok = tol(kern(sh), plain())
        if not ok:
            fail(f"{name} {what}: kernel disagrees with its plain version "
                 f"(max abs err {err})")
        t_sh = queued_ms(lambda: kern(sh), torch)
        t_id = queued_ms(lambda: kern(ids), torch)
        print(f"  {name:14s} {what:44s} max_abs_err {err:.3g} | queued "
              f"{t_sh:.4f} ms (the block's order {t_id:.4f}) | plain "
              f"{cuda_ms(plain, torch, 3):.4f} ms")


def parent_lib(label, files, name):
    """The parent commit's ``files`` (from ``legion_tpu_torch/csrc`` of
    ``_archive/parent``, a ``git archive`` of it) built from source with
    kernels.NVCC_FLAGS into a library of their own,
    ``legion_tpu_torch/_build/<name>/<name>.so``. Returns (the library,
    None), or (None, why not) where no archive is unpacked or the library
    does not load."""
    import ctypes
    from legion_tpu_torch.ops import kernels
    src = [os.path.join(PARENT, "legion_tpu_torch", "csrc", f)
           for f in files]
    if not all(os.path.exists(f) for f in src):
        return None, "no parent archive"
    out = os.path.join(str(kernels.BUILD_DIR), name)
    os.makedirs(out, exist_ok=True)
    so_path = os.path.join(out, f"{name}.so")
    t0 = time.perf_counter()
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                       "-o", so_path, *src]])
    print(f"  {label}: built the parent's kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    try:
        return ctypes.CDLL(so_path), None
    except OSError as e:
        return None, f"the parent's library does not load ({e})"


def seg_parent_lib():
    """The parent commit's K17 and K18 (``parent_lib``): (the library,
    None), or (None, why not) where ``parent_lib`` has none or the
    parent's K17 and K18 group the lanes by segment (they need
    ``hop_agg.cu`` too, and their entry points differ from the bindings
    below)."""
    import ctypes
    so, why = parent_lib("K17, K18", ("segment_max.cu", "segment_softmax.cu"),
                         "seg_parent")
    if so is None:
        return None, why
    if hasattr(so, "lt_segment_groups_words"):
        return None, "the parent's K17 and K18 group by segment"
    p, i64, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_uint32, ctypes.c_float)
    so.lt_segment_max_fwd.argtypes = [p, i32, p, i64, i64, i64, u32, p, p, p]
    so.lt_segment_max_bwd.argtypes = [p, i32, p, p, p, f32, i64, i64, i64, p,
                                      p, p]
    so.lt_segment_softmax_fwd.argtypes = [p, i32, p, i64, i64, i64, p, p, p,
                                          p]
    so.lt_segment_softmax_bwd.argtypes = [p, p, i32, p, i64, i64, i64, p, p,
                                          p]
    for fn in (so.lt_segment_max_fwd, so.lt_segment_max_bwd,
               so.lt_segment_softmax_fwd, so.lt_segment_softmax_bwd):
        fn.restype = ctypes.c_int
    return so, None


def seg_parent_calls(so, sg, torch):
    """The parent's four wrappers over ``so`` (its [S, F] key, count and
    sum buffers from ``torch.empty``), as its ops/segment.py called them."""
    from legion_tpu_torch.ops import kernels

    def run(name, rc):
        if rc != 0:
            fail(f"the parent's {name}: launch failed ({rc})")

    def max_fwd(data, ids, S, key):
        (E, F), dev = data.shape, data.device
        keys = torch.empty(S * F, dtype=torch.int32, device=dev)
        out = torch.empty((S, F), dtype=data.dtype, device=dev)
        run("segment_max", so.lt_segment_max_fwd(
            data.data_ptr(), sg.SEG_TYPES[data.dtype], ids.data_ptr(), E, F,
            S, key, keys.data_ptr(), out.data_ptr(), kernels.stream_handle()))
        return out

    def max_bwd(data, ids, out, g, init):
        (E, F), S = data.shape, out.shape[0]
        cnt = torch.empty(S * F, dtype=torch.int32, device=data.device)
        dx = torch.empty_like(data)
        run("segment_max_bwd", so.lt_segment_max_bwd(
            data.data_ptr(), sg.SEG_TYPES[data.dtype], ids.data_ptr(),
            out.data_ptr(), g.data_ptr(), init, E, F, S, cnt.data_ptr(),
            dx.data_ptr(), kernels.stream_handle()))
        return dx

    def soft_fwd(x, ids, S):
        (E, H), dev = x.shape, x.device
        mk = torch.empty(S * H, dtype=torch.int32, device=dev)
        den = torch.empty(S * H, dtype=torch.float32, device=dev)
        p = torch.empty_like(x)
        run("segment_softmax", so.lt_segment_softmax_fwd(
            x.data_ptr(), sg.SEG_TYPES[x.dtype], ids.data_ptr(), E, H, S,
            mk.data_ptr(), den.data_ptr(), p.data_ptr(),
            kernels.stream_handle()))
        return p

    def soft_bwd(p, g, ids, S):
        E, H = p.shape
        sums = torch.empty(S * H, dtype=torch.float32, device=p.device)
        dx = torch.empty_like(p)
        run("segment_softmax_bwd", so.lt_segment_softmax_bwd(
            p.data_ptr(), g.data_ptr(), sg.SEG_TYPES[p.dtype],
            ids.data_ptr(), E, H, S, sums.data_ptr(), dx.data_ptr(),
            kernels.stream_handle()))
        return dx
    return max_fwd, max_bwd, soft_fwd, soft_bwd


def seg_turns(rows, ids, S, g_rows, scores, g_sc, sg, torch):
    """The parent's K17 and K18 (``seg_parent_lib``) and this tree's, in
    turns (parent, tree, tree, parent), queued, at the GCN block and at
    its shuffled ids: each way, and forward + backward (the parent's two
    wrappers; the tree's through autograd). The tree's backward reads the
    grouping its forward wrote, as under autograd; the parent's takes no
    grouping. The parent's outputs are held against the tree's first,
    each way: K17 bit for bit, K18 within its tolerances."""
    so, why = seg_parent_lib()
    if so is None:
        print(f"  K17, K18: {why}; the tree's kernels alone")
        return
    from legion_tpu_torch import ops
    max_fwd, max_bwd, soft_fwd, soft_bwd = seg_parent_calls(so, sg, torch)
    init = torch.tensor(torch.finfo(torch.bfloat16).min,
                        dtype=torch.bfloat16)
    key, fi = int(sg.order_keys_plain(init)), float(init)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    sh = ids[torch.randperm(ids.shape[0], generator=gen,
                            device="cuda")].contiguous()
    for order, i in (("block", ids), ("shuffled", sh)):
        mg = sg.segment_groups_buffer(i, S)
        out = sg.segment_max_fwd(rows, i, S, key, mg)
        pairs = [(f"K17 fwd {order}", bit_exact,
                  lambda i=i: max_fwd(rows, i, S, key),
                  lambda i=i: sg.segment_max_fwd(rows, i, S, key)),
                 (f"K17 bwd {order}", bit_exact,
                  lambda i=i, out=out: max_bwd(rows, i, out, g_rows, fi),
                  lambda i=i, out=out, mg=mg: sg.segment_max_bwd(
                      rows, i, out, g_rows, fi, mg))]
        if order == "block":
            pairs.append((
                "K17 fwd+bwd block", tuple_tol(bit_exact, bit_exact),
                lambda: (lambda o: (o, max_bwd(rows, ids, o, g_rows, fi)))(
                    max_fwd(rows, ids, S, key)),
                lambda: seg_grad(lambda x: ops.masked_segment_max(x, ids, S),
                                 rows, g_rows, torch)))
        for dt, x in scores.items():
            tol = SEG_F32 if dt == torch.float32 else SEG_BF16
            n = f"K18 {str(dt)[6:]}"
            sgr = sg.segment_groups_buffer(i, S)
            p = sg.segment_softmax_fwd(x, i, S, sgr)
            pairs += [(f"{n} fwd {order}", tol,
                       lambda x=x, i=i: soft_fwd(x, i, S),
                       lambda x=x, i=i: sg.segment_softmax_fwd(x, i, S)),
                      (f"{n} bwd {order}", tol,
                       lambda p=p, dt=dt, i=i: soft_bwd(p, g_sc[dt], i, S),
                       lambda p=p, dt=dt, i=i, sgr=sgr:
                       sg.segment_softmax_bwd(p, g_sc[dt], i, S, sgr))]
            if order == "block":    # each way held above: timed alone
                pairs.append((
                    f"{n} fwd+bwd block", None,
                    lambda x=x, dt=dt: (lambda q: (q, soft_bwd(
                        q, g_sc[dt], ids, S)))(soft_fwd(x, ids, S)),
                    lambda x=x, dt=dt: seg_grad(
                        lambda z: ops.segment_softmax(z, ids, S), x,
                        g_sc[dt], torch)))
        for what, tol, parent, tree in pairs:
            err, ok = tol(parent(), tree()) if tol else (0.0, True)
            if not ok:
                fail(f"{what}: the parent's kernel and the tree's disagree "
                     f"(max abs err {err})")
            t = [queued_ms(f, torch) for f in (parent, tree, tree, parent)]
            print(f"  in turns {what:26s} queued ms: parent {t[0]:.4f}, "
                  f"{t[3]:.4f} | tree {t[1]:.4f}, {t[2]:.4f} | tree / parent "
                  f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}")


SEG_SIZES = (1, 7, 2 ** 20 + 3)
SEG_SHAPES = ((), (5,), (3, 4))       # trailing dims: [E], [E, F], [E, H, F]
SEG_HUBS = ("half", "all")            # one segment takes half, or every lane


def seg_edge_inputs(E, tail, dtype, rng, torch, hub=None):
    """(data, ids, S) for an edge case: random values with ties, the
    special values of the type at random lanes, pads, ids past S and empty
    segments (only even ids below S are drawn). With ``hub`` "half", one
    segment takes a random half of the lanes; with "all", every lane is in
    one segment; a hub's data are small integers alone (a tie in every
    eighth lane, no special value to make the whole hub NaN)."""
    S = max(3, E // 5)
    shape = (E,) + tail
    if hub is not None:
        data = torch.randint(-4, 4, shape, generator=rng, device="cuda",
                             dtype=torch.int32)
        if dtype != torch.int32:
            data = data.to(dtype)
        ids = 2 * torch.randint(0, (S + 1) // 2, (E,), generator=rng,
                                device="cuda", dtype=torch.int32)
        if hub == "all":
            ids.fill_(2)
        else:
            ids[torch.rand(E, generator=rng, device="cuda") < 0.5] = 2
        return data, ids, S
    if dtype == torch.int32:
        data = torch.randint(-5, 5, shape, generator=rng, device="cuda",
                             dtype=torch.int32)
        specials = (-2 ** 31, 2 ** 31 - 1, 0)
    else:
        data = torch.randint(-4, 4, shape, generator=rng,
                             device="cuda").float()
        data += torch.randn(shape, generator=rng, device="cuda") \
            * (torch.rand(shape, generator=rng, device="cuda") < 0.5)
        specials = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"),
                    torch.finfo(dtype).min)
        data = data.to(dtype)
    flat = data.view(-1)
    for v in specials:
        n = max(1, flat.numel() // 97)
        at = torch.randint(0, flat.numel(), (n,), generator=rng,
                           device="cuda")
        flat[at] = torch.tensor(v, dtype=dtype, device="cuda")
    ids = 2 * torch.randint(0, (S + 1) // 2, (E,), generator=rng,
                            device="cuda", dtype=torch.int32)
    r = torch.rand(E, generator=rng, device="cuda")
    ids = torch.where(r < 0.1, -1, torch.where(r < 0.15, S + 2, ids)) \
        .to(torch.int32)
    return data, ids, S


def segment_edges(torch, results):
    """K17 and K18 (and the mean) at the edges of their shapes against the
    plain versions: f32, bf16, f16 and int32 (the max's forward alone)
    over [E], [E, F] and [E, H, F], E 1, 7 and 2^20 + 3, NaN, +-0, +-inf,
    finfo.min (iinfo's ends), ties, pads, ids past S, empty segments;
    initial by default and tied with a lane (and the max of an all-pad
    input); data on a base one element past an aligned one; and hubs at
    2^20 + 3 lanes over [E] and [E, 8] (``SEG_HUBS``: one segment with
    half of the lanes, and every lane in one segment). Through the
    public ops under autograd on the card against the plain versions of
    the folded [E, F]: K17 both ways bit for bit, K18 f32 rtol 1e-5 and
    bf16 and f16 one ulp, the mean one ulp of its dtype. Then
    ``public_edges``."""
    from legion_tpu_torch import ops
    from legion_tpu_torch.ops import segment as sg
    rng = torch.Generator(device="cuda")
    rng.manual_seed(17)
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        for E in SEG_SIZES:
            for tail in SEG_SHAPES:
                for misaligned in (False, True):
                    data, ids, S = seg_edge_inputs(E, tail, dtype, rng,
                                                   torch)
                    if misaligned:
                        buf = torch.empty(data.numel() + 1, dtype=dtype,
                                          device="cuda")
                        buf[1:] = data.view(-1)
                        data = buf[1:].view(data.shape)
                    if E == 1 and misaligned:
                        ids = torch.full_like(ids, -1)     # all padding
                    case = (f"{str(dtype)[6:]} E {E} tail {tail}"
                            f"{' misaligned' if misaligned else ''}")
                    n += seg_edge_case(case, data, ids, S, ops, sg, torch,
                                       results)
        # hubs: K17 and K18 split a segment of more than 32 lanes into
        # chunks and combine them
        for hub in SEG_HUBS:
            for tail in ((), (8,)):
                data, ids, S = seg_edge_inputs(SEG_SIZES[-1], tail, dtype,
                                               rng, torch, hub)
                case = f"{str(dtype)[6:]} E {SEG_SIZES[-1]} tail {tail} hub " \
                       f"{hub} ({int((ids == 2).sum())} lanes)"
                n += seg_edge_case(case, data, ids, S, ops, sg, torch,
                                   results, hub=2)
                seg_groups_check(ids, S, sg, torch, case)
                if dtype != torch.int32:
                    d2 = data.reshape(data.shape[0], -1)
                    seg_same_bits(d2, torch.randn_like(d2.float()).to(dtype),
                                  ids, S, sg, torch, case)
    print(f"  segment_edges: {n} cases, K17 bit for bit, K18 and the mean "
          "within their tolerances; at the hubs the grouping exactly and "
          "K18 the same bits in two runs")
    public_edges(torch)


def public_edges(torch):
    """The five public ops on the card against the same calls on the CPU
    (their plain versions), at the edges of the shapes and dtypes they
    take: ``masked_segment_sum`` and ``masked_segment_mean`` in f32, bf16,
    f16, f64 and int32 over [E], [E, 5] and [E, 3, 4], E 1, 7 (on a base
    one element past an aligned one) and 1003, forward, and in f32 and
    f64 the sum's gradient (K1) bit for bit; ``gather_rows`` of bool,
    uint8, int8, f16, int32, f32 and f64 tables of widths 1, 3, 13 and
    16 on aligned and misaligned bases, V 1 and 37, by [N] and [2, 4] ids
    with pads and ids past V (int32 and int64), exactly, and its gradient
    in f32 and f64; and the empty cases: E = 0, S = 0, ids with a zero
    dimension, [E, 0] rows, for every op. Sums and means within their
    order's tolerance (one ulp in bf16 and f16; int32 exactly), the rest
    bit for bit; fails on a difference, a wrong shape or dtype, or a
    launch error."""
    from legion_tpu_torch import ops
    rng = torch.Generator(device="cuda")
    rng.manual_seed(26)
    n = 0

    def on_cpu(*ts):
        return [t.cpu() if isinstance(t, torch.Tensor) else t for t in ts]

    def check(what, k, p, tol):
        nonlocal n
        k = k.cpu()
        if k.shape != p.shape or k.dtype != p.dtype:
            fail(f"public edge {what}: {k.dtype} {tuple(k.shape)} against "
                 f"the CPU's {p.dtype} {tuple(p.shape)}")
        err, ok = tol(k, p) if k.numel() else (0.0, True)
        if not ok:
            fail(f"public edge {what}: differs from the CPU's plain "
                 f"versions (max abs err {err})")
        n += 1

    def rand(shape, dt, misaligned=False):
        size = math.prod(shape)
        if dt == torch.bool:
            flat = torch.rand(size + 1, generator=rng, device="cuda") < 0.5
        elif not dt.is_floating_point:
            lo, hi = (-2 ** 31, 2 ** 31 - 1) if dt == torch.int32 else (
                (0, 256) if dt == torch.uint8 else (-128, 128))
            flat = torch.randint(lo, hi, (size + 1,), generator=rng,
                                 device="cuda", dtype=dt)
        else:
            flat = torch.randn(size + 1, generator=rng, device="cuda").to(dt)
        return flat[int(misaligned):size + int(misaligned)].view(shape)

    # by the result's dtype: sums in another order (bf16 and f16 rounded
    # once from them: one ulp apart at most), int32 exactly
    out_tol = {torch.float32: f32_atomic_order, torch.float64: f64_order,
               torch.bfloat16: bf16_ulp, torch.float16: f16_ulp,
               torch.int32: exact}
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64,
               torch.int32):
        for E in (1, 7, 1003):
            S = max(3, E // 5)
            ids = torch.randint(-1, S + 2, (E,), generator=rng,
                                device="cuda", dtype=torch.int32)
            for tail in SEG_SHAPES:
                data = rand((E,) + tail, dt, misaligned=E == 7)
                what = f"{str(dt)[6:]} E {E} tail {tail}"
                check("sum " + what, ops.masked_segment_sum(data, ids, S),
                      ops.masked_segment_sum(*on_cpu(data, ids, S)),
                      out_tol[dt])
                mean = ops.masked_segment_mean(data, ids, S)
                check("mean " + what, mean,
                      ops.masked_segment_mean(*on_cpu(data, ids, S)),
                      out_tol[mean.dtype])
                if dt in (torch.float32, torch.float64):
                    g = rand((S,) + tail, dt)
                    kd = seg_grad(lambda x: ops.masked_segment_sum(
                        x, ids, S), data, g, torch)[1]
                    pd = seg_grad(lambda x: ops.masked_segment_sum(
                        x, ids.cpu(), S), data.cpu(), g.cpu(), torch)[1]
                    check("sum's gradient " + what, kd, pd, bit_exact_cpu)
    for dt in (torch.bool, torch.uint8, torch.int8, torch.float16,
               torch.int32, torch.float32, torch.float64):
        for V in (1, 37):
            for F in (1, 3, 13, 16):
                for misaligned in (False, True):
                    table = rand((V, F), dt, misaligned)
                    for ishape in ((50,), (2, 4)):
                        for idt in (torch.int32, torch.int64):
                            idx = torch.randint(-1, V + 3, ishape,
                                                generator=rng, device="cuda",
                                                dtype=idt)
                            check(f"gather {str(dt)[6:]} [{V},{F}] "
                                  f"{'misaligned ' * misaligned}ids "
                                  f"{ishape} {str(idt)[6:]}",
                                  ops.gather_rows(table, idx),
                                  ops.gather_rows(*on_cpu(table, idx)),
                                  bit_exact_cpu)
            if dt in (torch.float32, torch.float64):
                table = rand((V, 3, 2), dt)
                idx = torch.randint(-1, V + 3, (5, 8), generator=rng,
                                    device="cuda", dtype=torch.int32)
                g = rand((5, 8, 3, 2), dt)
                kd = seg_grad(lambda t: ops.gather_rows(t, idx), table, g,
                              torch)[1]
                pd = seg_grad(lambda t: ops.gather_rows(t, idx.cpu()),
                              table.cpu(), g.cpu(), torch)[1]
                check(f"gather's gradient {str(dt)[6:]} V {V}", kd, pd,
                      out_tol[dt])
    empties = [
        ("sum E 0", lambda i: ops.masked_segment_sum(
            i(torch.zeros((0, 3))), i(torch.zeros(0, dtype=torch.int32)),
            4)),
        ("sum S 0", lambda i: ops.masked_segment_sum(
            i(torch.ones((3, 2))), i(torch.zeros(3, dtype=torch.int32)), 0)),
        ("sum int32 [E, 0]", lambda i: ops.masked_segment_sum(
            i(torch.ones((3, 0), dtype=torch.int32)),
            i(torch.zeros(3, dtype=torch.int32)), 2)),
        ("mean [E, 0]", lambda i: ops.masked_segment_mean(
            i(torch.ones((3, 0))), i(torch.zeros(3, dtype=torch.int32)), 2)),
        ("mean int32 E 0", lambda i: ops.masked_segment_mean(
            i(torch.zeros(0, dtype=torch.int32)),
            i(torch.zeros(0, dtype=torch.int32)), 2)),
        ("max f16 E 0", lambda i: ops.masked_segment_max(
            i(torch.zeros((0, 2), dtype=torch.float16)),
            i(torch.zeros(0, dtype=torch.int64)), 3)),
        ("max S 0", lambda i: ops.masked_segment_max(
            i(torch.ones((3, 2))), i(torch.zeros(3, dtype=torch.int32)), 0)),
        ("max [E, 0]", lambda i: ops.masked_segment_max(
            i(torch.ones((3, 0))), i(torch.zeros(3, dtype=torch.int32)), 2)),
        ("softmax f16 E 0", lambda i: ops.segment_softmax(
            i(torch.zeros(0, dtype=torch.float16)),
            i(torch.zeros(0, dtype=torch.int32)), 2)),
        ("softmax S 0", lambda i: ops.segment_softmax(
            i(torch.ones((3, 2))), i(torch.zeros(3, dtype=torch.int32)), 0)),
        ("softmax [E, 0]", lambda i: ops.segment_softmax(
            i(torch.ones((3, 0))), i(torch.zeros(3, dtype=torch.int32)), 2)),
        ("gather V 1", lambda i: ops.gather_rows(
            i(torch.tensor([[1.5, -2.0]])),
            i(torch.tensor([0, 3, -1], dtype=torch.int32)))),
        ("gather [2, 0] ids", lambda i: ops.gather_rows(
            i(torch.ones((5, 2))), i(torch.zeros((2, 0), dtype=torch.int32)))),
        ("gather [V, 0] rows", lambda i: ops.gather_rows(
            i(torch.ones((5, 0))),
            i(torch.tensor([1, 7], dtype=torch.int32)))),
        ("gather V 0, no id", lambda i: ops.gather_rows(
            i(torch.ones((0, 3))), i(torch.zeros(0, dtype=torch.int32))))]
    for what, fn in empties:
        check(what, fn(lambda t: t.cuda()), fn(lambda t: t), bit_exact_cpu)
    torch.cuda.synchronize()
    print(f"  public_edges: {n} cases (the sum and the mean in five dtypes, "
          "the gather in seven, int64 ids, the empty cases), each against "
          "the CPU's plain versions: within tolerance")


def bit_exact_cpu(k, p):
    """``bit_exact`` for two tensors on the CPU (any dtype)."""
    import torch
    err = (k.double() - p.double()).abs().max().item() if k.numel() \
        else 0.0
    return err, same_bits(k, p, torch)


def seg_softmax_f64(x, ids, S, sg, torch):
    """K18's plain arithmetic carried in f64 (m from the plain version's
    keys, exact), rounded once to x's dtype. The reference at a hub: an f32
    sum of 2^19 to 2^20 exps is good to about 1e-3 in any order, the plain
    version's ``index_add_`` included (its small terms vanish against the
    running sum); K18 sums a hub's chunks with compensation."""
    valid = (ids >= 0) & (ids < S)
    row = torch.where(valid, ids, S).long()
    v = valid[:, None]
    m = sg.segment_max_plain(x, ids, S, sg.KEY_POS_ZERO).double()
    m = torch.cat([m, m.new_zeros((1, x.shape[1]))])
    e = torch.where(v, torch.exp(torch.where(v, x.double() - m[row], 0.0)),
                    0.0)
    d = torch.zeros(m.shape, dtype=torch.float64, device=x.device) \
        .index_add_(0, row, e).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.where(v, e / d[row], 0.0).to(x.dtype)


def seg_softmax_bwd_f64(p, g, ids, S, torch):
    """K18's backward arithmetic in f64 on p and g, rounded once: the
    reference at a hub, as ``seg_softmax_f64`` for the forward."""
    valid = (ids >= 0) & (ids < S)
    row = torch.where(valid, ids, S).long()
    v = valid[:, None]
    pg = torch.where(v, p.double() * g.double(), 0.0)
    sums = torch.zeros((S + 1, p.shape[1]), dtype=torch.float64,
                       device=p.device).index_add_(0, row, pg)
    return torch.where(v, p.double() * (g.double() - sums[row]),
                       0.0).to(p.dtype)


def split_tol(tol, mask):
    """``tol`` on the rows of ``mask`` (a hub's lanes) and on the others
    apart, so that a hub's small values are held to their own scale."""
    def check(k, p):
        errs, oks = [], []
        for m in (mask, ~mask):
            if bool(m.any()):
                e, o = tol(k[m], p[m])
                errs.append(e)
                oks.append(o)
        return max(errs), all(oks)
    return check


def seg_edge_case(case, data, ids, S, ops, sg, torch, results, hub=None):
    """One edge case of ``segment_edges``; fails on a difference. With
    ``hub`` (the hub's segment), K18 is held against its arithmetic in f64
    (``seg_softmax_f64``), the hub's lanes apart from the others. Returns
    the number of comparisons made."""
    E, dtype = data.shape[0], data.dtype
    F = data[0].numel() if E else 1
    d2 = data.reshape(E, F)
    tie = d2[0, 0].item() if E else 0.0
    n = 0
    for initial in (None, tie):
        if dtype == torch.int32:
            init = torch.tensor(torch.iinfo(dtype).min if initial is None
                                else int(initial), dtype=dtype)
        else:
            init = torch.tensor(torch.finfo(dtype).min if initial is None
                                else initial, dtype=dtype)
        key = int(sg.order_keys_plain(init))
        g = torch.randn((S, F), device="cuda").to(dtype) \
            if dtype != torch.int32 else None
        if g is None:
            k = ops.masked_segment_max(data, ids, S, init.item())
            kd = None
        else:
            k, kd = seg_grad(
                lambda x: ops.masked_segment_max(x, ids, S, init.item()),
                data, g.reshape((S,) + tuple(data.shape[1:])), torch)
        p = sg.segment_max_plain(d2, ids, S, key)
        if not same_bits(k.reshape(S, F), p, torch):
            fail(f"segment_max edge {case} initial {initial}: the forward "
                 "differs from its plain version")
        n += 1
        if kd is not None:
            pd = sg.segment_max_bwd_plain(d2, ids, p, g, float(init))
            if not same_bits(kd.reshape(E, F), pd, torch):
                fail(f"segment_max edge {case} initial {initial}: the "
                     "backward differs from its plain version")
            n += 1
    if dtype == torch.int32:
        return n
    tol = {torch.float32: SEG_F32, torch.bfloat16: SEG_BF16,
           torch.float16: SEG_F16}[dtype]
    gs = torch.randn(data.shape, device="cuda").to(dtype)
    k, kd = seg_grad(lambda x: ops.segment_softmax(x, ids, S), data, gs,
                     torch)
    # the backward on the p that the kernel's backward read (its forward's)
    if hub is None:
        p = sg.segment_softmax_plain(d2, ids, S)
        pd = sg.segment_softmax_bwd_plain(k.reshape(E, F), gs.reshape(E, F),
                                          ids, S)
    else:
        p = seg_softmax_f64(d2, ids, S, sg, torch)
        pd = seg_softmax_bwd_f64(k.reshape(E, F), gs.reshape(E, F), ids, S,
                                 torch)
    k18_tol = tol if hub is None else split_tol(tol, ids == hub)
    for what, a, b in (("forward", k.reshape(E, F), p),
                       ("backward", kd.reshape(E, F), pd)):
        err, ok = k18_tol(a, b)
        if not ok:
            fail(f"segment_softmax edge {case}: the {what} differs from its "
                 f"plain version (max abs err {err})")
        r = results.setdefault("segment_softmax", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
    # the mean without the finfo.min lanes: two of them overflow to -inf,
    # and whether a +inf lane meets that -inf (NaN) or a finite sum first
    # (+inf) depends on the order of K2's atomics
    dm = data.masked_fill(data == torch.finfo(dtype).min, 0)
    km = ops.masked_segment_mean(dm, ids, S).reshape(S, F)
    err, ok = tol(km, seg_mean_plain(dm.reshape(E, F), ids, S))
    if not ok:
        fail(f"masked_segment_mean edge {case}: differs from the plain "
             f"sums (max abs err {err})")
    return n + 3


def k15_rows(src, ids=None, aligned=None):
    """The row each lane of K15 reads (-1 for none), by form: src (a),
    aligned + lane (b), the hop's ids (c)."""
    import torch
    E = src.shape[0]
    if ids is not None:
        r = ids[aligned:aligned + E]
    elif aligned is not None:
        r = aligned + torch.arange(E, device=src.device, dtype=torch.int32)
    else:
        r = src
    return torch.where((src >= 0) & (r >= 0), r, -1)


def k15_least(rows, src, fanout, num_dst, ids=None, aligned=None,
              bwd=False):
    """K15's bound for these inputs. Forward: src (and the hop's ids)
    read, each distinct row the valid lanes name read once, out [num_dst,
    d] and count written in f32, one f32 add a valid lane and column.
    With ``bwd``, the backward's too: src, the hop's F rows of the output's
    gradient and their counts read, the gradient of rows written once in
    the rows' dtype (K2's f32 accumulator on a gathered hop is the
    kernel's choice, not the function's), one add or division a valid
    lane and column."""
    r = k15_rows(src, ids, aligned)
    d = rows.shape[1]
    valid = int((r >= 0).sum())
    dev = (nb(src) + (4 * src.shape[0] if ids is not None else 0)
           + distinct(r) * d * rows.element_size() + num_dst * (4 * d + 4))
    ops = valid * d
    if bwd:
        F = src.shape[0] // fanout
        dev += nb(src) + F * (4 * d + 4) + nb(rows)
        ops += valid * d
    return bound(dev, ops=ops)


def k15_library(rows, src, fanout, ids=None, aligned=None):
    """One PyTorch call for K15's forward: ``embedding_bag`` (mean) over
    the [F, fanout] lanes, pads mapped to ``padding_idx`` (the last row:
    it differs from K15 only where a valid lane names that row, and it does
    not place the rows at the hop's offset). Timed; used nowhere else."""
    import torch
    r = k15_rows(src, ids, aligned)
    rows, V = rows.detach(), rows.shape[0]
    idx = torch.where(r >= 0, r, V - 1).long().view(fanout, -1).t() \
        .contiguous()
    return lambda: torch.nn.functional.embedding_bag(
        idx, rows, mode="mean", padding_idx=V - 1)


def k15_pair(rows, src, fanout, off, num_dst, aligned=None, ids=None,
             mean=True):
    """The kernel and its plain version as ``compare`` takes them, no
    gradient taken: each returns (out, count)."""
    import torch
    from legion_tpu_torch.ops import hop_agg, kernels

    @torch.no_grad()
    def kern():
        return kernels.hop_mean(rows, src, fanout, off, num_dst, aligned,
                                ids, mean)

    @torch.no_grad()
    def plain():
        s, c = hop_agg.hop_neighbor_sum_plain(rows, src, fanout, off,
                                              num_dst, aligned, ids)
        return (s / c.clamp(min=1)[:, None] if mean else s), c
    return kern, plain


def k15_grad_pair(rows, src, fanout, off, num_dst, g_out, aligned=None,
                  mean=True):
    """Forward + backward of K15 and of its plain version for upstream
    ``g_out``: each returns (out, d rows)."""
    import torch
    from legion_tpu_torch.ops import hop_agg, kernels

    def run(fn):
        def both():
            out = fn(rows, src, fanout, off, num_dst, aligned)
            return (out,) + torch.autograd.grad(out, rows, g_out)
        return both
    k = (lambda *a: kernels.hop_mean(*a, mean=mean)[0])
    p = hop_agg.hop_neighbor_mean_plain if mean else \
        (lambda *a: hop_agg.hop_neighbor_sum_plain(*a)[0])
    return run(k), run(p)


def k15_compares(tr, batch, torch, results, main):
    """K15 against its plain versions at the Device path's shapes, from
    one real batch: form (c) at layer 0 (the aligned last hop's rows read
    from the feature table by id, the mean at the hop's offset of the
    prefix), and form (a) at layer 1 (the hop-0 lanes gathered from [S1,
    128] bf16 rows, W_neigh applied first), forward, and forward +
    backward (``hop_mean_grad``); the backward alone (``k15_grad_compare``)
    and where the host's time of a call goes (``k15_host_parts``). The
    count exactly; sums to f32 order (``close_f32``); the bf16 gradient
    within a bf16 ulp (``bf16_ulp``: f32 sums, cast once)."""
    from legion_tpu_torch.ops import kernels
    s = tr.sampler_t
    S = s.config.cum_sizes()
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    table = tr.feature_source.features
    ids = batch.node_ids[:s.max_ids]
    P, fo1, fo0 = S[1], s.config.fanouts[1], s.config.fanouts[0]
    src1, off1 = batch.edge_src[1], batch.hop_offsets[1]
    kern, plain = k15_pair(table, src1, fo1, off1, P, P, ids)
    main["hop_mean"] = [compare(
        "hop_mean", kern, plain, tuple_tol(close_f32, exact), results, torch,
        f"(c) L0 table [{table.shape[0]},{table.shape[1]}] bf16 x "
        f"{src1.shape[0]} lanes -> [{P}]", least=k15_least(
            table, src1, fo1, P, ids, P),
        library=k15_library(table, src1, fo1, ids, P), queued=True)]
    print(f"  hop_mean       (c) L0: host_us_per_call "
          f"{host_us(kern, torch, 200):.2f}")
    src0, off0 = batch.edge_src[0], batch.hop_offsets[0]
    hp = torch.randn((S[1], 128), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    kern, plain = k15_pair(hp, src0, fo0, off0, S[0])
    note = f"(a) L1 [{S[1]},128] bf16 x {src0.shape[0]} lanes -> [{S[0]}]"
    main["hop_mean"].append(compare(
        "hop_mean", kern, plain, tuple_tol(close_f32, exact), results, torch,
        note + " fwd", least=k15_least(hp, src0, fo0, S[0]),
        library=k15_library(hp, src0, fo0), queued=True))
    g_out = torch.randn((S[0], 128), generator=g, device="cuda")
    kb, pb = k15_grad_pair(hp, src0, fo0, off0, S[0], g_out)
    compare("hop_mean", kb, pb, tuple_tol(close_f32, bf16_ulp), results,
            torch, note + " fwd+bwd", least=k15_least(
                hp, src0, fo0, S[0], bwd=True), queued=True)
    # the backward alone, on the forward's own count
    with torch.no_grad():
        count = kernels.hop_mean(hp, src0, fo0, off0, S[0])[1]
    t = k15_grad_compare(f"(a) L1 bwd [{S[0]},128] f32 by {src0.shape[0]} "
                         f"lanes -> [{S[1]},128] bf16, mean", g_out, src0,
                         S[1], torch.bfloat16, off0, fo0, count, bf16_ulp,
                         results, torch)
    if t is not None:
        main["hop_mean_grad"] = [t]
    k15_host_parts(hp, src0, fo0, off0, S[0], g_out, count, torch)


def k15_lp_compares(tr, torch, results):
    """K15 at lp_sage's layer 1, from one of its batches: form (a) over
    [S1, hidden] f32 rows (the mean first: the layer does not shrink
    rows), forward, forward + backward, and the backward alone
    (``hop_mean_grad`` over the f32 gradient of the mean). The count
    exactly; sums to f32 order (``close_f32``); the f32 gradient to f32
    order (``f32_atomic_order``: the plain version's ``index_add_`` adds by
    atomics)."""
    from legion_tpu_torch.ops import kernels
    batch, _ = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    S = scfg.cum_sizes()
    H = tr.config.train.hidden_dim
    g = torch.Generator(device="cuda")
    g.manual_seed(18)
    src0, off0, fo0 = batch.edge_src[0], batch.hop_offsets[0], \
        scfg.fanouts[0]
    h = torch.randn((S[1], H), generator=g, device="cuda").requires_grad_()
    note = f"(a) lp_sage L1 [{S[1]},{H}] f32 x {src0.shape[0]} -> [{S[0]}]"
    kern, plain = k15_pair(h, src0, fo0, off0, S[0])
    compare("hop_mean", kern, plain, tuple_tol(close_f32, exact), results,
            torch, note + " fwd", least=k15_least(h, src0, fo0, S[0]),
            library=k15_library(h, src0, fo0), queued=True)
    g_out = torch.randn((S[0], H), generator=g, device="cuda")
    kb, pb = k15_grad_pair(h, src0, fo0, off0, S[0], g_out)
    compare("hop_mean", kb, pb, tuple_tol(close_f32, f32_atomic_order),
            results, torch, note + " fwd+bwd",
            least=k15_least(h, src0, fo0, S[0], bwd=True), queued=True)
    with torch.no_grad():
        count = kernels.hop_mean(h, src0, fo0, off0, S[0])[1]
    k15_grad_compare(f"(a) lp_sage L1 bwd [{S[0]},{H}] f32 -> [{S[1]},{H}] "
                     "f32, mean", g_out, src0, S[1], torch.float32, off0,
                     fo0, count, f32_atomic_order, results, torch)


def k15_grad_least(dout, src, num_rows, dtype, F, mean):
    """``hop_mean_grad``'s bound for these inputs: src read, the hop's F
    rows of d out (and for the mean their counts) read once, d rows
    written once in the rows' dtype; one add a valid lane and column (and
    a division for the mean)."""
    import torch
    d = dout.shape[1]
    valid = int((src >= 0).sum())
    dev = (nb(src) + F * 4 * d + (4 * F if mean else 0)
           + num_rows * d * torch.empty((), dtype=dtype).element_size())
    return bound(dev, ops=valid * d * (2 if mean else 1))


def k15_grad_fns(dout, src, num_rows, dtype, off, F, count):
    """The gathered hop's backward alone and its plain version, as the
    package runs them: ``hop_mean_grad``; in a package from before it (the
    parent's, timed in turns with this one), K2's lane form, then the cast
    to the rows' dtype."""
    from legion_tpu_torch.ops import hop_agg, kernels
    if hasattr(kernels, "hop_mean_grad"):
        return (lambda: kernels.hop_mean_grad(dout, src, num_rows, dtype, off,
                                              F, count),
                lambda: hop_agg.hop_mean_grad_plain(dout, src, num_rows,
                                                    dtype, off, F, count))
    return (lambda: kernels.segment_sum_lanes(dout, src, num_rows, off, F,
                                              count).to(dtype),
            lambda: kernels.segment_sum_lanes_plain(dout, src, num_rows, off,
                                                    F, count).to(dtype))


def embedding_bag_bwd(dout, src, num_rows, dtype, off, fanout, mean,
                      torch):
    """The library yardstick of ``hop_mean_grad``: the backward alone of one
    ``F.embedding_bag`` call (mode "mean", or "sum") over the hop's lanes,
    a bag a destination row (its fanout draws), into a weight of the rows'
    dtype with one extra zero row that the pads index as ``padding_idx``;
    the forward runs once, outside the timing."""
    import torch.nn.functional as tnf
    F = src.shape[0] // fanout
    idx = torch.where(src >= 0, src, num_rows).view(fanout, F).t().long()
    w = torch.zeros((num_rows + 1, dout.shape[1]), dtype=dtype,
                    device="cuda", requires_grad=True)
    out = tnf.embedding_bag(idx, w, mode="mean" if mean else "sum",
                            padding_idx=num_rows)
    o = int(off)
    g = dout[o:o + F].to(dtype)
    return lambda: torch.autograd.grad(out, w, g, retain_graph=True)


def k15_grad_compare(note, dout, src, num_rows, dtype, off, fanout, count,
                     tol, results, torch):
    """``hop_mean_grad`` (d rows of a gathered hop from d out) against its
    plain version, ``tol`` (f32 sums in another order), timed, queued and
    in host us a call; its grouping of the lanes by row against
    ``lanes_by_source_plain`` exactly; two runs the same bits; beside the
    library call ``embedding_bag_bwd``. Returns the ``compare`` tuple (None
    for a package from before the kernel, whose backward is timed under
    ``segment_sum``)."""
    from legion_tpu_torch.ops import hop_agg, kernels
    F = src.shape[0] // fanout
    kern, plain = k15_grad_fns(dout, src, num_rows, dtype, off, F, count)
    new = hasattr(kernels, "hop_mean_grad")
    if new:
        got = kernels.lanes_by_source(src, num_rows)
        ref = hop_agg.lanes_by_source_plain(src, num_rows)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"hop_mean_grad {note}: its grouping of the lanes differs "
                 "from lanes_by_source_plain")
        if not same_bits(kern(), kern(), torch):
            fail(f"hop_mean_grad {note}: two runs differ in their bits")
    t = compare("hop_mean_grad" if new else "segment_sum", kern, plain, tol,
                results, torch, note, least=k15_grad_least(
                    dout, src, num_rows, dtype, F, count is not None),
                library=embedding_bag_bwd(dout, src, num_rows, dtype, off,
                                          fanout, count is not None, torch),
                queued=True)
    held = ("grouping exact, two runs the same bits" if new else
            "K2's lane form: grouping and bits not checked")
    print(f"  {'hop_mean_grad' if new else 'lane form':14s} {note}: {held} "
          f"| host_us_per_call {host_us(kern, torch, 200):.2f}")
    return t if new else None


def k15_host_parts(rows, src, fanout, off, num_dst, g_out, count, torch):
    """Where K15's host time goes at Device's layer 1 (form (a), bf16
    rows that take a gradient), in host us a call (``host_us``: 1000
    calls, 50 for forward + backward, whose nine launches a call would
    otherwise fill the launch queue and time the card): ``hop_mean_checks``,
    the outputs' allocations (two, as the wrapper makes them, and one split
    into two views), the C entry point alone on buffers made once, the
    wrapper under ``no_grad`` (a direct launch), the wrapper through the
    autograd Function, forward + backward, the backward's wrapper alone,
    beside an empty kernel's launch (``noop``)."""
    from legion_tpu_torch.ops import kernels
    lib, F, d = kernels.lib(), src.shape[0] // fanout, rows.shape[1]
    buf = torch.empty(num_dst * (d + 1), device="cuda")
    bf = int(rows.dtype == torch.bfloat16)

    def call():
        lib.lt_hop_mean(rows.data_ptr(), rows.shape[0], d, bf,
                        src.data_ptr(), None, -1, off.data_ptr(), F, fanout,
                        num_dst, 1, buf.data_ptr(),
                        buf.data_ptr() + 4 * num_dst * d,
                        kernels.stream_handle())

    def one_buffer():
        b = torch.empty(num_dst * (d + 1), device="cuda")
        return b[:num_dst * d].view(num_dst, d), b[num_dst * d:]

    def no_grad():
        with torch.no_grad():
            kernels.hop_mean(rows, src, fanout, off, num_dst)

    def both():
        out = kernels.hop_mean(rows, src, fanout, off, num_dst)[0]
        torch.autograd.grad(out, rows, g_out)
    bwd = k15_grad_fns(g_out, src, rows.shape[0], rows.dtype, off, F,
                       count)[0]
    parts = [("hop_mean_checks", lambda: kernels.hop_mean_checks(
        rows, src, fanout, off, num_dst, None, None), 1000),
        ("two allocations", lambda: (torch.empty(
            (num_dst, d), device="cuda"), torch.empty(num_dst,
                                                      device="cuda")), 1000),
        ("one allocation, two views", one_buffer, 1000),
        ("the C call", call, 1000), ("fwd under no_grad", no_grad, 1000),
        ("fwd through the Function",
         lambda: kernels.hop_mean(rows, src, fanout, off, num_dst), 1000),
        ("fwd + bwd", both, 50), ("the bwd's wrapper", bwd, 50),
        ("noop", kernels.noop, 1000)]
    print("  hop_mean       (a) L1, host us a call: " + " | ".join(
        f"{what} {host_us(fn, torch, n):.2f}" for what, fn, n in parts))


# the backward's edge cases (``k15_grad_edges``): (rows, fanout, F,
# num_dst, offset, pad fraction, hub fraction); every case also has two
# lanes past the rows. A hub over many chunks; runs of 33-128 lanes
# (sorted through a bitmap, summed in chunks); runs of 9-32 (a warp's
# ranks); every lane a pad; F = num_dst; the offset negative (wrapped),
# below -num_dst and past num_dst - F (clamped); one row; and runs spread
# wider than a bitmap window (262,144 lanes)
K15_GRAD_CASES = {"hub over chunks": (300, 25, 120, 150, 7, 0.1, 0.4),
                  "runs of 33-128": (40, 10, 200, 230, 3, 0.1, 0.0),
                  "runs of 9-32": (200, 5, 400, 400, 0, 0.1, 0.0),
                  "every lane a pad": (50, 5, 37, 60, 11, 1.0, 0.0),
                  "F = num_dst": (90, 10, 64, 64, 0, 0.2, 0.1),
                  "offset negative, wrapped": (90, 10, 30, 70, -45, 0.2, 0.1),
                  "offset below 0": (90, 10, 30, 70, -1000, 0.2, 0.1),
                  "offset past the end": (90, 10, 30, 70, 1000, 0.2, 0.1),
                  "one row": (1, 5, 37, 40, 2, 0.2, 0.0),
                  "runs wider than a window": (10, 1, 300_000, 300_000, 0,
                                               0.1, 0.0)}
K15_GRAD_WIDTHS = (1, 3, 47, 128)


def k15_grad_edges(torch, results):
    """``hop_mean_grad`` at the edges of its shapes (``K15_GRAD_CASES``),
    widths ``K15_GRAD_WIDTHS`` (2-byte stores of bf16 rows at odd widths,
    a float a thread where d is not a multiple of 4; the widest case at
    width 3 only), bf16 and f32, the mean (random counts, 0 among them)
    and the sum: against its plain version (``bf16_ulp``,
    ``f32_atomic_order``), its grouping against ``lanes_by_source_plain``
    exactly, two runs the same bits."""
    from legion_tpu_torch.ops import hop_agg, kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    n, worst = 0, 0.0
    for case, (R, fo, F, num_dst, offset, pad, hub) in \
            K15_GRAD_CASES.items():
        E = fo * F
        src = torch.randint(0, R, (E,), generator=g, device="cuda",
                            dtype=torch.int32)
        src[torch.rand((E,), generator=g, device="cuda") < hub] = R // 2
        src[torch.rand((E,), generator=g, device="cuda") < pad] = -1
        if pad < 1.0:
            src[torch.randperm(E, generator=g, device="cuda")[:2]] = \
                torch.tensor([R, R + 9], dtype=torch.int32, device="cuda")
        off = torch.tensor(offset, dtype=torch.int32, device="cuda")
        got = kernels.lanes_by_source(src, R)
        ref = hop_agg.lanes_by_source_plain(src, R)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"hop_mean_grad edge {case}: its grouping of the lanes "
                 "differs from lanes_by_source_plain")
        widths = (3,) if E > 100_000 else K15_GRAD_WIDTHS
        for d in widths:
            dout = torch.randn((num_dst, d), generator=g, device="cuda")
            count = torch.randint(0, fo + 1, (num_dst,), generator=g,
                                  device="cuda").float()
            for dt in (torch.bfloat16, torch.float32):
                tol = bf16_ulp if dt == torch.bfloat16 else f32_atomic_order
                for cnt in (count, None):
                    what = (f"hop_mean_grad edge {case} d {d} {str(dt)[6:]}"
                            f" {'mean' if cnt is not None else 'sum'}")
                    kern, plain = k15_grad_fns(dout, src, R, dt, off, F, cnt)
                    k = kern()
                    err, ok = tol(k, plain())
                    if not ok:
                        fail(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
                    if not same_bits(k, kern(), torch):
                        fail(f"{what}: two runs differ in their bits")
                    n, worst = n + 1, max(worst, err)
    torch.cuda.synchronize()
    print(f"  hop_mean_grad  {n} edge cases ({' / '.join(K15_GRAD_CASES)}; "
          f"widths {'/'.join(map(str, K15_GRAD_WIDTHS))}, bf16 and f32, "
          f"mean and sum): grouping exact, two runs the same bits, all "
          f"within tolerance, max_abs_err {worst:.3g}")
    r = results.setdefault("hop_mean_grad", {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], worst)


def k15_gcn_compares(tr, torch, results):
    """K15 at GCN's shapes (exact dedup: both hops gathered, the sum):
    hop 1 at layer 0 over the fetched bf16 rows scaled as the model scales
    them (965,760 lanes into W rows), forward (features take no
    gradient); hop 0 at layer 1 over [S1, classes] f32 rows (188-byte
    rows: 4-byte pieces), forward + backward, and the backward alone."""
    batch, x = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    S = scfg.cum_sizes()
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    src1, off1 = batch.edge_src[1], batch.hop_offsets[1]
    kern, plain = k15_pair(x, src1, scfg.fanouts[1], off1, S[1], mean=False)
    compare("hop_mean", kern, plain, tuple_tol(close_f32, exact), results,
            torch, f"(a) GCN hop 1 [{S[2]},{x.shape[1]}] bf16 x "
                   f"{src1.shape[0]} -> [{S[1]}] sum",
            least=k15_least(x, src1, scfg.fanouts[1], S[1]),
            library=k15_library(x, src1, scfg.fanouts[1]), queued=True)
    C = tr.dataset.meta.num_classes
    h = torch.randn((S[1], C), generator=g, device="cuda").requires_grad_()
    src0, off0 = batch.edge_src[0], batch.hop_offsets[0]
    g_out = torch.randn((S[0], C), generator=g, device="cuda")
    kb, pb = k15_grad_pair(h, src0, scfg.fanouts[0], off0, S[0], g_out,
                           mean=False)
    compare("hop_mean", kb, pb, tuple_tol(close_f32, f32_atomic_order),
            results, torch, f"(a) GCN hop 0 [{S[1]},{C}] f32 x "
                            f"{src0.shape[0]} -> [{S[0]}] sum fwd+bwd",
            least=k15_least(h, src0, scfg.fanouts[0], S[0], bwd=True),
            queued=True)
    k15_grad_compare(f"(a) GCN hop 0 bwd [{S[0]},{C}] f32 -> [{S[1]},{C}] "
                     "f32, sum", g_out, src0, S[1], torch.float32, off0,
                     scfg.fanouts[0], None, f32_atomic_order, results, torch)


def phase_k15(torch):
    """``--k15``: K15 and its backward alone at the Device path's shapes
    (``k15_compares``, with the host's breakdown), then at GCN's
    (``k15_gcn_compares``) and lp_sage's (``k15_lp_compares``), each from
    one batch of its trainer at ``bench.py --model X`` settings."""
    from legion_tpu_torch.data import synthesize_device_dataset
    from legion_tpu_torch.train import Trainer
    ds = synthesize_device_dataset("cuda")
    results = {}
    launch_floor(torch)
    for model in ("graphsage", "gcn", "lp_sage"):
        tr = Trainer(ds, bench_config(ds, model=model), device="cuda")
        print(f" {model}: frontier sizes {tr.sampler_t.frontier_sizes} | "
              f"edge sizes {tr.sampler_t.edge_sizes}")
        if model == "graphsage":
            k15_compares(tr, one_batch(tr, torch)[0], torch, results, {})
        elif model == "gcn":
            k15_gcn_compares(tr, torch, results)
        else:
            k15_lp_compares(tr, torch, results)
        del tr
        torch.cuda.empty_cache()


def k15_aligned_compare(tr, torch, results):
    """K15's form (b) at H's layer 0: the aligned last hop over K4's
    fetched rows, 100 wide in bf16 (200-byte rows, 8-byte aligned: 8-byte
    pieces), the mean at the hop's offset."""
    batch, x = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    S = scfg.cum_sizes()
    src, off, fo = batch.edge_src[1], batch.hop_offsets[1], scfg.fanouts[1]
    kern, plain = k15_pair(x, src, fo, off, S[1], S[1])
    compare("hop_mean", kern, plain, tuple_tol(close_f32, exact), results,
            torch, f"(b) H L0 [{x.shape[0]},{x.shape[1]}] bf16 (K4's rows) "
                   f"x {src.shape[0]} -> [{S[1]}]",
            least=k15_least(x, src, fo, S[1], aligned=S[1]),
            library=k15_library(x, src, fo, aligned=S[1]), queued=True)


# K15's edge cases: (fanout, F, num_dst, offset, pad fraction) for pads;
# every lane a pad; fanout 1; fanout 33 (two rounds of 32 draws) at the
# last offset; the last offset with rows one element past their
# allocation (the narrowest pieces)
K15_CASES = {"pads": (5, 37, 60, 11, 0.2),
             "every lane a pad": (5, 37, 60, 11, 1.0),
             "fanout 1": (1, 64, 64, 0, 0.1),
             "fanout 33, last offset": (33, 19, 40, 21, 0.1),
             "misaligned base, last offset": (5, 37, 60, 23, 0.2)}
K15_WIDTHS = (1, 3, 47, 100, 128, 256)


def k15_edges(torch, results):
    """K15 at the edges of its shapes against its plain versions, each of
    the three forms, sum and mean, bf16 and f32, widths ``K15_WIDTHS``,
    the cases of ``K15_CASES``; forms (a) and (b) also forward + backward
    of the mean. The count exactly, sums ``close_f32``; the gradient
    ``bf16_ulp`` / ``f32_atomic_order`` on a gathered hop
    (``hop_mean_grad``), exactly on an aligned one. Form (c)'s ids include
    one past the table (clamped, as K1 clamps)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(18)
    n, worst, V, P = 0, 0.0, 300, 9

    def rand(shape, dt, shift):
        return torch.randn((math.prod(shape) + shift,), generator=g,
                           device="cuda").to(dt)[shift:].view(shape)

    for case, (fo, F, num_dst, offset, pad) in K15_CASES.items():
        E = fo * F
        shift = 1 if case.startswith("misaligned") else 0
        off = torch.tensor(offset, dtype=torch.int32, device="cuda")
        drop = torch.rand((E,), generator=g, device="cuda") < pad
        gathered = torch.randint(0, V, (E,), generator=g, device="cuda",
                                 dtype=torch.int32)
        lanes = torch.arange(E, dtype=torch.int32, device="cuda")
        ids = torch.randint(0, V, (P + E,), generator=g, device="cuda",
                            dtype=torch.int32)
        ids[P:][drop] = -1
        # lane 0 names an id past the table, lane 1 a -1 id (a zero row
        # that counts where the lane is valid)
        ids[P], ids[P + 1] = V + 5, -1
        forms = {"a": (torch.where(drop, -1, gathered), None, None, V),
                 "b": (torch.where(drop, -1, P + lanes), P, None, P + E),
                 "c": (torch.where(drop, -1, P + lanes), P, ids, V)}
        for d in K15_WIDTHS:
            for dt in (torch.bfloat16, torch.float32):
                g_out = torch.randn((num_dst, d), generator=g, device="cuda")
                for form, (src, ao, fid, n_rows) in forms.items():
                    rows = rand((n_rows, d), dt, shift)
                    what = (f"hop_mean edge {case} form ({form}) d {d} "
                            f"{str(dt)[6:]}")
                    if shift and rows.data_ptr() % 16 == 0:
                        fail(f"{what}: the rows are not misaligned")
                    for mean in (False, True):
                        kern, plain = k15_pair(rows, src, fo, off, num_dst,
                                               ao, fid, mean)
                        err, ok = tuple_tol(close_f32, exact)(kern(),
                                                              plain())
                        if not ok:
                            fail(f"{what} {'mean' if mean else 'sum'}: "
                                 f"kernel disagrees with its plain version "
                                 f"(max abs err {err})")
                        n, worst = n + 1, max(worst, err)
                    if form == "c":
                        continue
                    r = rows.detach().clone().requires_grad_()
                    kb, pb = k15_grad_pair(r, src, fo, off, num_dst, g_out,
                                           ao)
                    dtol = exact if form == "b" else (
                        bf16_ulp if dt == torch.bfloat16
                        else f32_atomic_order)
                    err, ok = tuple_tol(close_f32, dtol)(kb(), pb())
                    if not ok:
                        fail(f"{what} fwd+bwd: kernel disagrees with its "
                             f"plain version (max abs err {err})")
                    n, worst = n + 1, max(worst, err)
    torch.cuda.synchronize()
    print(f"  hop_mean       {n} edge cases (forms a/b/c, sum and mean, "
          f"widths {'/'.join(map(str, K15_WIDTHS))}, bf16 and f32, "
          f"{' / '.join(K15_CASES)}; a and b also fwd+bwd): all within "
          f"tolerance, max_abs_err {worst:.3g}")
    r = results["hop_mean"]
    r["max_abs_err"] = max(r["max_abs_err"], worst)


# ---------------------------------------------------------------------------
# K16 dropout_act
# ---------------------------------------------------------------------------

# a step's dropout key words (lo, hi) for the compares
K16_WORDS = (0x2545F491, -0x4F6CDD1D)


def k16_act(act, torch):
    import torch.nn.functional as F
    return {"relu": torch.relu, "elu": F.elu, "none": lambda t: t}[act]


def bit_exact(k, p):
    """Bit for bit, the sign of a zero too (``exact`` compares values)."""
    import torch
    err = (k.float() - p.float()).abs().max().item() if k.numel() else 0.0
    return err, same_bits(k, p, torch)


def k16_grad_check(note, x, act, out_dtype, rate, words, layer, dy, torch):
    """K16 forward + backward through autograd (``dropout_act``: the
    Function that launches the kernel both ways; with ReLU its backward
    reads the forward's passes mask) against the plain chain under
    autograd (``dropout_act_plain``) on the same x and dy: y and dx bit for
    bit, or fail. Returns the max abs error of dx."""
    from legion_tpu_torch.ops import dropout as kd
    out = []
    for fn in (kd.dropout_act, kd.dropout_act_plain):
        xg = x.detach().requires_grad_()     # x's storage and offset
        y = fn(xg, act, out_dtype, rate, words, layer)
        out.append((y.detach(),) + torch.autograd.grad(y, xg, dy))
    (yk, gk), (yp, gp) = out
    err, ok = bit_exact(gk, gp)
    if not (ok and bit_exact(yk, yp)[1]):
        fail(f"dropout_act {note}: forward + backward differs from the "
             f"plain chain's under autograd (dx max abs err {err})")
    return err


def k16_mask_check(note, x, out_dtype, rate, words, layer, dy, torch):
    """K16's ReLU forward with its passes mask and the backward from that
    mask alone (no x, no key words), bit for bit against
    ``passes_mask_plain`` and ``dropout_act_bwd_plain`` given the plain
    mask, or fail; y too unless x holds a NaN (its bits past the
    activation are the card's NaN). Returns the max abs error of dx."""
    from legion_tpu_torch.ops import dropout as kd
    ydt = out_dtype or x.dtype
    s = kd.make_spec(x.shape, rate, "relu", ydt, layer)
    yk, mk = kd.dropout_act_fwd(x, words, rate, s, with_mask=True)
    mp = kd.passes_mask_plain(x, rate, words, layer)
    if not same_bits(mk, mp, torch):
        fail(f"dropout_act {note}: the passes mask differs from "
             f"passes_mask_plain's ({int((mk != mp).sum())} bytes)")
    if not bool(x.float().isnan().any()):
        yp = kd.dropout_act_plain(x, "relu", out_dtype, rate, words, layer)
        if not bit_exact(yk, yp)[1]:
            fail(f"dropout_act {note}: the forward that writes the mask "
                 "differs from the plain chain")
    gk = kd.dropout_act_bwd(dy, mk, x.dtype, None, rate, s)
    gp = kd.dropout_act_bwd_plain(dy, mp, x.dtype, None, rate, s)
    err, ok = bit_exact(gk, gp)
    if not ok:
        fail(f"dropout_act {note}: the backward from the mask differs from "
             f"its plain version (max abs err {err})")
    return err


def k16_compare(note, x, act, out_dtype, rate, results, torch, grad=True,
                layer=0):
    """K16 against its plain version on x at one of the path's shapes:
    the forward bit for bit (with ``grad`` and ReLU, the forward that also
    writes the passes mask, and the mask), then (with ``grad``: where x
    takes a gradient on the path) forward + backward under autograd bit for
    bit (``k16_grad_check``) and the backward alone (ReLU's from the
    kernel's mask), at a dy made on the card. Each is timed beside its
    plain version, its bound (forward: x read, y and a ReLU mask of
    ceil(n / 8) bytes written; ReLU backward: dy and the mask read, dx
    written; ELU backward: dy and x read, dx written) and its library
    call with that call's own bytes and share: ``F.dropout`` on the
    activated, cast tensor (``native_dropout``: h read, y and a 1-byte
    mask written; no activation, no cast), and for the backward
    ``native_dropout_backward`` with that call's mask (dy and the 1-byte
    mask read, dx written in dy's dtype; no activation's derivative, no
    widening). Returns the forward's timing tuple and, with ``grad``, the
    backward's."""
    import torch.nn.functional as F
    from legion_tpu_torch.ops import dropout as kd
    words = torch.tensor(K16_WORDS, dtype=torch.int32, device="cuda")
    ydt = out_dtype or x.dtype
    s = kd.make_spec(x.shape, rate, act, ydt, layer)
    xs, ys, n = x.element_size(), torch.empty((), dtype=ydt).element_size(), \
        x.numel()
    relu = act == "relu" and grad
    mb = -(-n // 8) if relu else 0
    h = k16_act(act, torch)(x).to(ydt)
    what = (f"{note} {tuple(x.shape)} {str(x.dtype)[6:]} -> {str(ydt)[6:]}, "
            f"{act}, rate {rate}, regime {s.regime}")

    def plain_fwd():
        with torch.no_grad():
            y = kd.dropout_act_plain(x, act, out_dtype, rate, words, layer)
            return (y, kd.passes_mask_plain(x, rate, words, layer)) \
                if relu else y
    lib_fwd = n * (2 * ys + 1)
    least_fwd = bound(n * (xs + ys) + mb)
    out = [compare("dropout_act",
                   (lambda: kd.dropout_act_fwd(x, words, rate, s, True))
                   if relu else
                   (lambda: kd.dropout_act_fwd(x, words, rate, s)[0]),
                   plain_fwd,
                   tuple_tol(bit_exact, bit_exact) if relu else bit_exact,
                   results, torch, what + " fwd", least=least_fwd,
                   library=lambda: F.dropout(h, rate, training=True),
                   library_bytes=lib_fwd, queued=True)]
    if not grad:
        return out
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(ydt)
    k16_grad_check(what, x, act, out_dtype, rate, words, layer, dy, torch)
    mask = torch.native_dropout(h, rate, True)[1]
    scale = 1.0 / (1.0 - rate)
    if relu:
        k16_mask_check(what, x, out_dtype, rate, words, layer, dy, torch)
        mk = kd.dropout_act_fwd(x, words, rate, s, True)[1]
        mp = kd.passes_mask_plain(x, rate, words, layer)
        kern = lambda: kd.dropout_act_bwd(dy, mk, x.dtype, None, rate, s)
        plain = lambda: kd.dropout_act_bwd_plain(dy, mp, x.dtype, None, rate,
                                                 s)
        least_bwd = bound(n * (ys + xs) + mb)
    else:
        held = x if act == "elu" else None
        kern = lambda: kd.dropout_act_bwd(dy, held, x.dtype, words, rate, s)
        plain = lambda: kd.dropout_act_bwd_plain(dy, held, x.dtype, words,
                                                 rate, s)
        least_bwd = bound(n * (ys + (xs if act == "elu" else 0) + xs))
    out.append(compare(
        "dropout_act", kern, plain, bit_exact, results, torch, what + " bwd",
        least=least_bwd,
        library=lambda: torch.ops.aten.native_dropout_backward(dy, mask,
                                                               scale),
        library_bytes=n * (2 * ys + 1), queued=True))
    return out


def k16_compares(tr, torch, results, main, path):
    """K16 at the shapes ``path``'s train step gives it (``tr`` at
    ``bench.py --model X`` settings): GraphSAGE (device), GCN, lp_sage:
    layer 0's output [S[1], hidden] f32, ReLU, cast to the compute dtype
    (bf16 on GraphSAGE), the path's dropout rate, forward (with the passes
    mask) and backward (from the mask); GAT (gat, gat-H): layer 0's
    fetched features (one real batch: 128 wide bf16 from the device
    table, 100 wide from K4's cached rows), dropout alone, forward only
    (the features take no gradient), then on gat layer 1's input [S[1],
    heads * hidden] f32, ELU, cast to bf16, both ways. The Device path's
    forward and backward are the kernel line's numbers."""
    model = tr.init_state()["model"]
    S = tr.sampler_t.config.cum_sizes()
    tc = tr.config.train
    g = torch.Generator(device="cuda")
    g.manual_seed(61)
    if path in ("gat", "gat-H"):
        _, x = one_batch(tr, torch)
        k16_compare(f"{path} L0 features", x, "none", None,
                    tc.gat_feat_drop, results, torch, grad=False)
        if path == "gat":
            x1 = torch.randn((S[1], model.layer_in[1]), generator=g,
                             device="cuda")
            k16_compare(f"{path} L1 input", x1, "elu", model.cdt,
                        tc.gat_feat_drop, results, torch, layer=1)
        return
    x = torch.randn((S[1], tc.hidden_dim), generator=g, device="cuda")
    # GraphSAGE casts to its compute dtype before dropout; GCN and lp_sage
    # (no compute dtype) stay in f32
    t = k16_compare(f"{path} L0 output", x, "relu",
                    getattr(model, "cdt", None), tc.dropout, results, torch)
    if path == "device":
        main["dropout_act"] = t


def k16_edges(torch, results):
    """K16 at the edges of its shapes, forward and forward + backward under
    autograd, bit for bit against the plain chain: rate 0 (the activation
    and the cast alone), every regime (rate 0.5 at a 32-multiple width;
    the u8 regime at 2^20 lanes or more, rate 0.6 and 0.9; the per-lane
    regime, rates 0.5 at width 100 and 0.6 at odd widths), lane counts
    that are not a multiple of 4, 8 or 32, x and dy on a base off 16-byte
    alignment (the one-lane paths of the forward and of each backward),
    each in f32 -> f32, f32 -> bf16 and bf16 -> bf16
    and with no activation, ReLU and ELU, at layers 0-3; x holds +-0 and
    +-1e-30 at its first lanes. With ReLU also the forward's passes mask
    and the backward from it alone (``k16_mask_check``), on x with a NaN
    among them (it passes) as well."""
    import numpy as np
    words = torch.tensor(K16_WORDS, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(62)
    shapes = (((37, 33), 0.6), ((64, 256), 0.5), ((33, 100), 0.5),
              ((1049, 1001), 0.6), ((1049, 1001), 0.0), ((4097, 256), 0.9),
              ((7, 1), 0.3), ((37, 33), 0.0))
    dtypes = ((torch.float32, None), (torch.float32, torch.bfloat16),
              (torch.bfloat16, None))
    specials = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0],
                            device="cuda")
    rng = np.random.default_rng(63)
    cases = masks = 0
    for (shape, rate), misaligned in [(c, False) for c in shapes] + [
            (shapes[0], True), (shapes[3], True), (shapes[7], True)]:
        n = math.prod(shape)
        for xdt, ydt in dtypes:
            buf = torch.randn((n + 3,), generator=g, device="cuda") * 3
            xb = buf[3:] if misaligned else buf[:n]
            k = min(n, specials.numel())
            xb[:k] = specials[:k]
            buf = buf.to(xdt)
            x = (buf[3:] if misaligned else buf[:n]).view(shape)
            dbuf = torch.randn((n + 3,), generator=g, device="cuda").to(
                ydt or xdt)
            dy = (dbuf[3:] if misaligned else dbuf[:n]).view(shape)
            for act in ("none", "relu", "elu"):
                layer = int(rng.integers(0, 4))
                note = (f"edge {shape} {str(xdt)[6:]} -> "
                        f"{str(ydt or xdt)[6:]} {act} rate {rate} layer "
                        f"{layer}{' misaligned' if misaligned else ''}")
                if act == "none" and ydt is None and rate == 0.0:
                    continue        # nothing to do: x itself
                k16_grad_check(note, x, act, ydt, rate, words, layer, dy,
                               torch)
                cases += 1
                if act == "relu":
                    k16_mask_check(note, x, ydt, rate, words, layer, dy,
                                   torch)
                    # a NaN in x's place (keeping its base), then back
                    lane = x.view(-1)[min(n, 5) - 1:min(n, 5)]
                    held = lane.clone()
                    lane.fill_(float("nan"))
                    k16_mask_check(note + " NaN", x, ydt, rate, words,
                                   layer, dy, torch)
                    lane.copy_(held)
                    masks += 2
    results.setdefault("dropout_act", {"max_abs_err": 0.0})
    print(f"  dropout_act    k16_edges: {cases} cases (regimes 0-3, lane "
          f"counts 1221, 1,050,049, 7; widths 1, 33, 100, 256, 1001; a "
          f"misaligned base), forward + backward: all bit for bit; ReLU's "
          f"passes mask and its backward from the mask alone in {masks} "
          f"(x with +-0, +-1e-30, and a NaN): all bit for bit")


def phase_k16(torch):
    """``--k16``: K16 alone at every path shape (``k16_compares``: Device,
    GCN, lp_sage, GAT, then gat-H on the host dataset), and its edges,
    with K10's
    dropout key row on 1,000 pairs (``k10_compares``)."""
    from legion_tpu_torch.data import synthesize_device_dataset
    from legion_tpu_torch.train import Trainer
    ds = synthesize_device_dataset("cuda")
    results, main = {}, {}
    floor = launch_floor(torch)
    for path in ("device", "gcn", "lp_sage", "gat"):
        model = "graphsage" if path == "device" else path
        tr = Trainer(ds, bench_config(ds, model=model), device="cuda")
        if path == "device":
            k10_compares(tr, torch, results, main, floor)
        k16_compares(tr, torch, results, main, path)
        del tr
        torch.cuda.empty_cache()
    k16_edges(torch, results)
    del ds
    torch.cuda.empty_cache()
    tr = host_trainer(host_dataset(), torch, "gat-H", **GAT_H)
    k16_compares(tr, torch, results, main, "gat-H")
    tr.close()


def prefix_check(tr, torch, path):
    """The path's train step on the prefix fetch (K1 fetches the ids
    before the aligned last hop, K15 reads that hop's rows from the table)
    against the same step with the whole fetch (K1's rows of every id, K15
    over them), and against the step the port took before K15 (the whole
    fetch, and the aggregation as the plain chain of torch ops, its
    backward ``index_add_``), each one step from ``init_state`` on the
    same batch: K1's ids a step, the feature-hit counter equal in all
    three; the loss bit for bit in all three (each sums a slot's draws in
    draw order in f32); the updated parameters bit for bit against the
    whole fetch (``hop_mean_grad`` gives the same bits from run to run)
    and within norm-wise rel 2e-3 of the plain chain's, as ``phase_fused``
    holds parameters (the plain gradient sums a row's lanes by f32 atomics,
    in another order; Adam's first step moves a parameter by about lr
    whatever its gradient's size, so a gradient within rounding of 0 that
    lands on its other side moves it by 2 lr)."""
    from legion_tpu_torch.models import graphsage
    from legion_tpu_torch.ops import hop_agg, kernels
    s = tr.sampler_t
    head = tr._table_head(s, tr.init_state()["model"])
    if head is None:
        fail(f"{path}: the trainer fetches every id")
    k1 = kernels.gather_rows
    seen = []

    def gather_rows(table, ids, out=None):
        seen.append(ids.shape[0])
        return k1(table, ids, out)

    def step():
        seen.clear()
        state = tr.init_state()
        kernels.gather_rows = gather_rows
        try:
            state, loss = tr.train_step(state)
            torch.cuda.synchronize()
        finally:
            kernels.gather_rows = k1
        params.append([p.detach().clone()
                       for p in state["model"].parameters()])
        return float(loss), int(tr.last_feat_hits), int(tr.last_slots), \
            list(seen)

    mean = graphsage.hop_neighbor_mean
    params = []
    runs = {"prefix": step()}
    tr._table_head = lambda sampler, model: None
    try:
        runs["whole"] = step()
        graphsage.hop_neighbor_mean = hop_agg.hop_neighbor_mean_plain
        runs["plain"] = step()
    finally:
        del tr._table_head
        graphsage.hop_neighbor_mean = mean
    p_whole = all(same_bits(a, b, torch)
                  for a, b in zip(params[0], params[1]))
    p_rel = rel_norm(params[0], params[2])
    for k, (loss, hits, slots, k1_ids) in runs.items():
        print(f"  {path} one step, {k} fetch: loss {loss!r} | feature hits "
              f"{hits}/{slots} | K1 ids a step {k1_ids}")
    print(f"  {path} updated parameters: the prefix fetch's against the "
          f"whole fetch's bit for bit: {p_whole} | against the plain "
          f"chain's norm-wise rel {p_rel:.3g} (tol 2e-3)")
    (lp, hp, _, ip), (lw, hw, _, iw), (lc, hc, _, _) = runs.values()
    if ip != [head] or iw != [s.max_ids]:
        fail(f"{path}: K1 fetched {ip} ids on the prefix fetch and {iw} on "
             f"the whole, not [{head}] and [{s.max_ids}]")
    if not (hp == hw == hc and lp == lw == lc and p_whole and p_rel <= 2e-3):
        fail(f"{path}: the prefix fetch's step disagrees with the whole "
             f"fetch's or the plain chain's: {runs}, parameters bit for bit "
             f"{p_whole}, rel {p_rel}")


def phase_slice(tr, torch, path):
    """One path through the public API: warm-up steps, timed train steps
    (per-step times from CUDA events at the step boundaries, no sync
    inside the loop), then an eval pass. Fails unless every kernel of the
    path launched, if the other dedup mode's kernel did, or if a position
    map is not clean after the pass. Returns the launch counts and the mean
    step ms."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline import Mode
    state = tr.init_state()
    kernels.reset_launch_counts()
    for _ in range(WARMUP_STEPS):
        state, loss = tr.train_step(state)
    torch.cuda.synchronize()
    losses, counters = [], []
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(TRAIN_STEPS + 1)]
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(TRAIN_STEPS):
        state, loss = tr.train_step(state)
        ev[i + 1].record()
        losses.append(loss)
        counters.append(torch.stack([
            tr.last_edges, tr.last_feat_hits, tr.last_slots,
            tr.last_topo_hits, tr.last_topo_total]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    per_step = {k: (v - before[k]) / TRAIN_STEPS
                for k, v in kernels.LAUNCHES.items()}
    state, acc = tr.run_eval(state, Mode.VALID)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    losses = [float(x) for x in losses]
    F = tr.dataset.meta.feature_dim
    tot = [0] * 5
    for i, c in enumerate(counters):
        e, fh, sl, th, tt = (int(v) for v in c.cpu())
        tot = [a + b for a, b in zip(tot, (e, fh, sl, th, tt))]
        print(f"  step {i}: {ev[i].elapsed_time(ev[i + 1]):.3f} ms | valid "
              f"edges {e} | feature hits {fh}/{sl} slots | topology hits "
              f"{th}/{tt} | host feature reads {(sl - fh) * F * 4 / 1e6:.3f}"
              f" MB")
    edges, hits, slots = tot[0], tot[1], tot[2]
    print(f"  losses {losses}")
    print(f"  mean step {step_ms:.3f} ms over {TRAIN_STEPS} steps (after "
          f"{WARMUP_STEPS} warm-up) | trained edges/s "
          f"{edges / (step_ms / 1e3 * TRAIN_STEPS):.1f}")
    metric = "valid mean loss" if tr.is_lp else "valid acc"
    print(f"  feature hit rate {hits / max(slots, 1):.4f} | topology hit rate"
          f" {tot[3] / max(tot[4], 1):.4f} | host feature MB/step "
          f"{(slots - hits) * F * 4 / 1e6 / TRAIN_STEPS:.3f} | {metric} "
          f"after {WARMUP_STEPS + TRAIN_STEPS} steps {acc:.4f} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches on the {path} path: {counts}\n  launches per train "
          f"step: { {k: v for k, v in per_step.items() if v} }")
    counts["per_step"] = per_step
    if not all(math.isfinite(x) for x in losses):
        fail(f"{path}: non-finite loss {losses}")
    # lp_sage's valid metric is its mean loss over valid anchors
    ok = math.isfinite(acc) and acc > 0 if tr.is_lp else 0.0 <= acc <= 1.0
    if not ok or float(state["total"]) == 0:
        fail(f"{path}: eval pass counted nothing (metric {acc})")
    for name in PATH_KERNELS[path]:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    # the other dedup mode's kernels never run, map dedup with an aligned
    # last hop is one call (one launch) a batch, and the map is clean
    others = SORT_DEDUP if path == "device-map" else ("dedup_map",)
    for other in others:
        if counts[other]:
            fail(f"{path}: {other} launched {counts[other]} times")
    if path == "device-map" and per_step["dedup_map"] != 1:
        fail(f"device-map: {per_step['dedup_map']} dedup_map calls a train "
             "step, not 1")
    if not tr.sampler_t.sort_dedup and not bool(
            (state["pos_map"] == 2 ** 31 - 1).all()):
        fail(f"{path}: the position map is not clean after the steps and "
             "the eval pass")
    if path in ("H", "gat-H") and not 0 < hits < slots:
        fail(f"{path}: feature hit rate {hits}/{slots} is not strictly "
             "between 0 and 1")
    return counts, step_ms


# StepRecorder's mark of an attention mask's key: 256 + layer in its high
# word (a feature mask's holds the layer)
ATTN_MARK = 256


class StepRecorder:
    """Records what each train step of ``tr`` sampled and which dropout
    masks it drew, on the card, into rows indexed by the step's counter:
    a wrapper around the trainer's ``_batch`` copies every member's ids
    and per-hop edge counts of each train batch to row ``state[ctr +
    "_d"] - 1`` (K10 has advanced the counter: ``train_ctr_d`` in a plain
    step, ``carry_ctr_d`` for an ``interbatch`` state's carry, on the
    stream that samples it), and wrappers around the models'
    ``dropout_act`` (feature dropout, K16) and around K6's and K7's
    wrappers (attention dropout, drawn in the kernels) the key that fixes
    each mask (the step's dropout key words read on the card, and the
    layer; attention's marked apart), to row ``train_ctr_d - 1``. Inside a
    captured step the copies are captured too, so a replay records its
    own step."""

    MASKS = 8      # dropout calls of a member's step at most

    def __init__(self, tr, torch, steps):
        from legion_tpu_torch.models import gat, gcn, graphsage
        from legion_tpu_torch.ops import kernels
        s, n = tr.sampler_t, tr.n_local
        self.tr, self.torch, self.steps = tr, torch, steps
        self.ids = torch.zeros((steps, n, s.ids_len), dtype=torch.int32,
                               device="cuda")
        self.edges = torch.zeros((steps, n, s.config.num_hops),
                                 dtype=torch.int32, device="cuda")
        self.masks = torch.zeros((steps, self.MASKS * n, 2),
                                 dtype=torch.int64, device="cuda")
        self.state, self.j = None, 0
        orig_batch, orig_act = tr._batch, graphsage.dropout_act
        orig_k6, orig_k7 = kernels.gat_attend, kernels.hop_attention

        def slot(state, ctr):
            return (state[ctr + "_d"] - 1).remainder(steps).view(1)

        def batch(state, sampler, bank, ybank, n_steps, ctr, tag):
            out = orig_batch(state, sampler, bank, ybank, n_steps, ctr, tag)
            if sampler is s:
                bs = (out[0],) if tr.n_dev == 1 else out[0]
                row = slot(state, ctr)
                self.j = 0
                self.ids.index_copy_(0, row, torch.stack(
                    [b.node_ids for b in bs])[None])
                self.edges.index_copy_(0, row, torch.stack(
                    [b.num_edges for b in bs])[None])
            return out

        def record(row):
            self.masks[:, self.j].index_copy_(
                0, slot(self.state, "train_ctr"), row.view(1, 2))
            self.j += 1

        def attn(drop):
            # the attention mask's key: the words, and the layer marked
            # apart from a feature layer's
            if drop is not None and self.state is not None:
                w = drop.words.long()
                record(torch.stack([(w[0] & 0xFFFFFFFF)
                                    + ((ATTN_MARK + drop.layer) << 32),
                                    w[1]]))

        def k6(*a, **kw):
            attn(kw["drop"] if "drop" in kw else
                 (a[8] if len(a) > 8 else None))
            return orig_k6(*a, **kw)

        def k7(*a, **kw):
            attn(kw["drop"] if "drop" in kw else
                 (a[8] if len(a) > 8 else None))
            return orig_k7(*a, **kw)

        def act(x, kind, out_dtype, rate, words, layer, train=True):
            if train and words is not None and self.state is not None:
                w = words.long()
                record(torch.stack([w[0] + (layer << 32), w[1]]))
            return orig_act(x, kind, out_dtype, rate, words, layer, train)
        tr._batch = batch
        self._undo = [(kernels, "gat_attend", orig_k6),
                      (kernels, "hop_attention", orig_k7)] + [
            (m, "dropout_act", orig_act) for m in (gat, gcn, graphsage)]
        kernels.gat_attend, kernels.hop_attention = k6, k7
        gat.dropout_act = gcn.dropout_act = graphsage.dropout_act = act

    def bind(self, state):
        self.torch.cuda.synchronize()     # the side stream's copies too
        self.state = state
        for t in (self.ids, self.edges, self.masks):
            t.zero_()

    def take(self):
        self.torch.cuda.synchronize()
        return self.ids.clone(), self.edges.clone(), self.masks.clone()

    def close(self):
        del self.tr._batch              # back to the class's method
        for obj, name, orig in self._undo:
            setattr(obj, name, orig)


def mask_keys(masks, path, what):
    """(mask keys, of them attention's) that ``StepRecorder`` wrote for the
    first step; fails on a GAT path whose step drew no attention mask."""
    n = int((masks[0] != 0).any(-1).sum())
    n_attn = int(((masks[0][:, 0] >> 32) >= ATTN_MARK).sum())
    if path.startswith("gat") and n_attn == 0:
        fail(f"{what} {path}: no attention dropout mask recorded")
    return n, n_attn


def coll_per_step(coll, steps):
    """``COLLECTIVES`` counts over ``steps`` steps, a step."""
    return {k: {f: n / steps for f, n in v.items()} for k, v in coll.items()}


def rel_norm(params, ref):
    """Norm-wise relative difference of two lists of parameters, over all
    of them: ||params - ref|| / ||ref||."""
    num = sum(float((a.detach().float() - b.float()).norm()) ** 2
              for a, b in zip(params, ref)) ** 0.5
    return num / sum(float(b.float().norm()) ** 2 for b in ref) ** 0.5


def phase_fused(tr, torch, path, calls=2):
    """``fused_steps = FUSED_K`` on ``path``: ``calls`` train_step calls
    (the first runs an eager step, captures one step and replays it
    K-1 times; the next replays K times) against K * calls eager steps
    from the same state (``init_state`` again: the same seeded weights,
    counters, base key and a fresh Adam). Fails unless every step's
    sampled ids and per-hop edge counts and the key of every dropout mask
    (feature and attention) are equal exactly, the call losses and the parameters agree within
    the tolerance below, the position map is clean (map dedup), and the
    captured step launched every kernel of ``PATH_KERNELS[path]`` (the
    launches a fused path's step counts are the captured ones: a replay
    runs no Python). With members, every member's ids and masks. With a
    process group, prints the collectives a step both ways, and fails
    unless ``COLLECTIVES`` counted each replay's captured collectives
    (``Trainer.graph_collectives``) and one all-reduce of the counters a
    call.

    Tolerance: K2's and K7's backward sum in f32 by atomics, in an order
    that changes from run to run, so neither two eager runs nor a replay
    and an eager run agree to the bit after the first backward; Adam
    then divides each gradient by its own magnitude. Losses: relative
    1e-3 of the eager mean; parameters: 2e-3 of the eager parameters'
    norm, over all of them (norm-wise, as the CPU parity tests state
    it). A replay that repeated a step's keys or masks, or skipped Adam's
    update, moves them by far more, and the ids and masks are held
    exactly besides."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.parallel import mesh as pmesh
    K = FUSED_K
    steps = K * calls
    rec = StepRecorder(tr, torch, steps)
    try:
        tr.fused_steps = 1
        state = tr.init_state()
        rec.bind(state)
        pmesh.reset_collective_counts()
        eager = [tr.train_step(state)[1] for _ in range(steps)]
        coll_e = pmesh.collective_counts()
        eager_loss = [float(torch.stack(eager[c * K:(c + 1) * K]).mean())
                      for c in range(calls)]
        params_e = [p.detach().clone() for p in state["model"].parameters()]
        ids_e, edges_e, masks_e = rec.take()

        tr.fused_steps = K
        state = tr.init_state()
        rec.bind(state)
        kernels.reset_launch_counts()
        pmesh.reset_collective_counts()
        t0 = time.perf_counter()
        fused = [float(tr.train_step(state)[1]) for _ in range(calls)]
        first_s = time.perf_counter() - t0
        coll_f = pmesh.collective_counts()
        ids_f, edges_f, masks_f = rec.take()
        graph = dict(tr.graph_launches)
        graph_coll = tr.graph_collectives
        launched = dict(kernels.LAUNCHES)
    finally:
        rec.close()
        tr.fused_steps = 1
    if state["train_ctr"] != steps or int(state["train_ctr_d"]) != steps:
        fail(f"fused {path}: counters {state['train_ctr']} / "
             f"{int(state['train_ctr_d'])} after {steps} steps")
    bad = [i for i in range(steps) if not (
        torch.equal(ids_e[i], ids_f[i]) and torch.equal(edges_e[i],
                                                        edges_f[i]))]
    if bad or not bool((edges_e.sum((1, 2)) > 0).all()):
        fail(f"fused {path}: the sampled batches of steps {bad} differ from "
             "the eager steps'")
    n_masks, n_attn = mask_keys(masks_e, path, "fused")
    if not torch.equal(masks_e, masks_f):
        fail(f"fused {path}: a replayed step's dropout masks differ from "
             f"the eager step's")
    p_rel = rel_norm(state["model"].parameters(), params_e)
    l_rel = max(abs(f - e) / abs(e) for f, e in zip(fused, eager_loss))
    print(f"  fused {path}: K {K}, {calls} calls = {steps} steps against "
          f"{steps} eager steps: ids and edge counts of every step exact, "
          f"{n_masks} dropout mask keys a step exact ({n_attn} attention) "
          f"| call losses {fused} vs "
          f"eager {eager_loss} (max rel {l_rel:.3g}, tol 1e-3) | parameters "
          f"norm-wise rel {p_rel:.3g} (tol 2e-3) | first call (eager step, "
          f"capture, {K - 1} replays) + second {first_s:.3f} s")
    if not (l_rel <= 1e-3 and p_rel <= 2e-3):
        fail(f"fused {path}: losses (rel {l_rel}) or parameters (rel "
             f"{p_rel}) differ from the eager steps' beyond tolerance")
    if not tr.sampler_t.sort_dedup and not bool(
            (state["pos_map"] == 2 ** 31 - 1).all()):
        fail(f"fused {path}: the position map is not clean after replays")
    per_step = {k: v for k, v in graph.items() if v}
    print(f"  fused {path}: launches of the captured step {per_step}")
    if tr._world is not None:
        # a call: K steps' captured collectives (the eager first step
        # counts as many), and what an eager step makes besides them once
        # (the all-reduce of the counters)
        want = {k: {f: steps * n + calls * (coll_e[k][f] // steps - n)
                    for f, n in v.items()} for k, v in graph_coll.items()}
        print(f"  fused {path}: collectives a step, eager "
              f"{coll_per_step(coll_e, steps)} | replayed (COLLECTIVES) "
              f"{coll_per_step(coll_f, steps)} | the captured step's "
              f"{graph_coll}")
        if coll_f != want or graph_coll["all_reduce"]["calls"] < 2:
            fail(f"fused {path}: COLLECTIVES {coll_f} under replay, want "
                 f"{want} ({calls} calls of {K} steps)")
    for name in PATH_KERNELS[path]:
        if graph.get(name, 0) <= 0:
            fail(f"fused {path}: the captured step launched no {name}")
        # one eager step and the capture count; a replay adds nothing
        if launched[name] != 2 * graph[name]:
            fail(f"fused {path}: {launched[name]} {name} launches counted, "
                 f"not the eager step's and the capture's {graph[name]} "
                 "each")
    if path == "device-map" and graph.get("dedup_map") != 1:
        fail("fused device-map: the captured step is not one dedup_map "
             "launch")
    return graph


def union_us(iv):
    """The length of the union of (start, end) intervals."""
    iv = sorted(iv)
    total, lo, hi = 0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + hi - lo


def device_windows(prof, steps):
    """From a profile's device events (kernels, copies, memsets), in ms a
    step: busy (their summed durations), union (the time at least one
    runs), span (first start to last end) and overlap (the time kernels
    of two streams run at once: the sum over streams of each stream's
    union, less the union of all); and the number of streams."""
    from torch.autograd import DeviceType
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        fail("the profiler recorded no device event")
    by_stream = {}
    for e in on_card:
        by_stream.setdefault(e.device_resource_id, []).append(
            (e.time_range.start, e.time_range.end))
    iv = [t for v in by_stream.values() for t in v]
    busy = sum(b - a for a, b in iv)
    union = union_us(iv)
    span = max(b for _, b in iv) - min(a for a, _ in iv)
    overlap = sum(union_us(v) for v in by_stream.values()) - union
    return [v / steps / 1e3 for v in (busy, union, span, overlap)], \
        len(by_stream)


def ab_run(tr, torch, interbatch, K=1):
    """One run of an A/B from a fresh state, with ``interbatch`` or
    ``fused_steps`` K: WARMUP_STEPS steps (a fused run's capture among
    them), AB_STEPS steps timed by the host clock ending in a sync (ms a
    step, and the host's ms a step before the sync: what launching a step
    costs it while the launch queue has room), then AB_PROFILED steps
    under ``torch.profiler`` (``device_windows``); a fused run takes
    whole calls, each count rounded up to a multiple of K."""
    from torch.profiler import ProfilerActivity, profile
    tr.interbatch, tr.fused_steps = interbatch, K
    state = tr.init_state()
    try:
        for _ in range(-(-WARMUP_STEPS // K)):
            state, _ = tr.train_step(state)
        torch.cuda.synchronize()
        calls = -(-AB_STEPS // K)
        t0 = time.perf_counter()
        for _ in range(calls):
            state, _ = tr.train_step(state)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (calls * K) * 1e3
        host = (t1 - t0) / (calls * K) * 1e3
        pcalls = -(-AB_PROFILED // K)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pcalls):
                state, _ = tr.train_step(state)
            torch.cuda.synchronize()
    finally:
        tr.interbatch, tr.fused_steps = False, 1
    return ms, host, *device_windows(prof, pcalls * K)


def table_step_ab(tr, torch, path):
    """The path's train step over each of ``feature_tables`` (the
    trainer's bf16 host table, an f32 table of the same rows: the table
    before bf16 rows, and their bf16 rows unpadded), put in the feature
    source in turns (these, then back), each from a fresh state: ms a
    step by the host clock over AB_STEPS steps after WARMUP_STEPS, ending
    in a sync."""
    fs = tr.feature_source
    own, tables = fs.host, feature_tables(tr)
    labels = list(tables)
    ms = {lb: [] for lb in labels}
    try:
        for lb in labels + labels[::-1]:
            fs.host = tables[lb]
            state = tr.init_state()
            for _ in range(WARMUP_STEPS):
                state, _ = tr.train_step(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AB_STEPS):
                state, loss = tr.train_step(state)
            torch.cuda.synchronize()
            ms[lb].append((time.perf_counter() - t0) / AB_STEPS * 1e3)
            if not math.isfinite(float(loss)):
                fail(f"{path} over the {lb} table: loss {float(loss)}")
    finally:
        fs.host = own
        for t in list(tables.values())[:-1]:
            t.close()
    mean = {lb: statistics.mean(v) for lb, v in ms.items()}
    print(f"  {path} train step by host table, in turns (these, then "
          "back): " + " | ".join(
              f"{lb} {', '.join(f'{x:.3f}' for x in ms[lb])} ms, mean "
              f"{mean[lb]:.3f} ({mean[lb] - mean[labels[0]]:+.3f})"
              for lb in labels) + " (one call; no claim)")


def ab_line(label, ms, host, win, streams):
    busy, union, span, overlap = win
    return (f"    {label}: {ms:.3f} ms/step (host {host:.3f} before the "
            f"sync) | profiled busy {busy:.3f} / span {span:.3f} ms/step "
            f"(idle share {1 - union / span:.3f}), two streams at once "
            f"{overlap:.3f} ms/step | {streams} stream(s)")


def interbatch_check(tr, torch, path):
    """``interbatch`` on ``path``: IB_STEPS pipelined steps against as many
    plain eager steps from a fresh ``init_state`` each (the same seeded
    weights, counters and key), then a valid pass. Fails unless every
    step's sampled ids and per-hop edge counts and the key of every
    dropout mask are equal exactly, every member's with members
    (``StepRecorder``; the carry's batches land in the rows of their own
    counter), losses and parameters agree within ``phase_fused``'s
    tolerance (K2's and K7's atomics), the launches of the two runs are
    equal and cover ``PATH_KERNELS[path]``, the counters count trained
    batches, and the position map is clean (map dedup)."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline import Mode
    n = IB_STEPS
    rec = StepRecorder(tr, torch, n + 1)
    got = {}
    try:
        for ib in (False, True):
            tr.interbatch = ib
            state = tr.init_state()
            rec.bind(state)
            tr.prime_carry(state)    # again, so that its batch is recorded
            kernels.reset_launch_counts()
            losses = [tr.train_step(state)[1] for _ in range(n)]
            launched = dict(kernels.LAUNCHES)
            ids, edges, masks = rec.take()
            params = [p.detach().clone() for p in state["model"].parameters()]
            ctrs = (state["train_ctr"], int(state["train_ctr_d"]),
                    int(state.get("carry_ctr_d", n + 1)))
            state, acc = tr.run_eval(state, Mode.VALID)
            torch.cuda.synchronize()
            clean = tr.sampler_t.sort_dedup or bool(
                (state["pos_map"] == 2 ** 31 - 1).all())
            got[ib] = ([float(x) for x in losses], params, ids[:n],
                       edges[:n], masks[:n], launched, ctrs, acc, clean,
                       int(state["train_ctr_d"]) == state["train_ctr"])
            del state
    finally:
        rec.close()
        tr.interbatch = False
    (l_p, p_p, ids_p, e_p, m_p, la_p, _, acc_p, _, _) = got[False]
    (l_i, p_i, ids_i, e_i, m_i, la_i, ctrs, acc_i, clean, ctr_ok) = got[True]
    if ctrs != (n, n, n + 1) or not ctr_ok:
        fail(f"interbatch {path}: counters (train_ctr, train_ctr_d, "
             f"carry_ctr_d) {ctrs} after {n} steps, or train_ctr_d moved "
             "in the eval pass")
    bad = [i for i in range(n) if not (torch.equal(ids_p[i], ids_i[i])
                                       and torch.equal(e_p[i], e_i[i]))]
    if bad or not bool((e_p.sum((1, 2)) > 0).all()):
        fail(f"interbatch {path}: the sampled batches of steps {bad} differ "
             "from the plain steps'")
    if not torch.equal(m_p, m_i):
        fail(f"interbatch {path}: a step's dropout masks differ from the "
             "plain step's")
    n_masks, n_attn = mask_keys(m_p, path, "interbatch")
    l_rel = max(abs(a - b) / abs(b) for a, b in zip(l_i, l_p))
    p_rel = rel_norm(p_i, p_p)
    print(f"  interbatch {path}: {n} pipelined steps against {n} plain "
          f"steps: ids and edge counts of every step exact, {n_masks} "
          f"dropout mask keys a step exact ({n_attn} attention) | losses "
          f"max rel {l_rel:.3g} (tol "
          f"1e-3) | parameters norm-wise rel {p_rel:.3g} (tol 2e-3) | valid "
          f"metric {acc_i:.4f} vs plain {acc_p:.4f}")
    if not (l_rel <= 1e-3 and p_rel <= 2e-3):
        fail(f"interbatch {path}: losses (rel {l_rel}) or parameters (rel "
             f"{p_rel}) differ from the plain steps' beyond tolerance")
    if not clean:
        fail(f"interbatch {path}: the position map is not clean after the "
             "steps and the eval pass")
    if la_i != la_p:
        fail(f"interbatch {path}: launches {la_i} differ from the plain "
             f"steps' {la_p}")
    missing = [k for k in PATH_KERNELS[path] if la_i[k] <= 0]
    if missing:
        fail(f"interbatch {path}: no launch of {missing}")
    print(f"  interbatch {path}: launches in {n} steps (equal to the plain "
          f"steps'): { {k: v for k, v in la_i.items() if v} }")


def phase_interbatch(tr, torch, path):
    """``interbatch_check`` on ``path``, then an A/B in this call: plain,
    interbatch, interbatch, plain (``ab_run``): ms a step, busy / span,
    the idle share and the time a step in which the two streams run at
    once. In host mode (H, HT), K4 alone at the path's fetch under each
    grid cap of ``K4_CAPS``, then under the two ends of the range in turn
    ``K4_PAIRS`` times more (its ms, the two ends' medians, and exact
    against the trainer's grid), then a plain and an interbatch run with
    K4's grid at the other end of the range (1056 if the trainer's is
    smaller, else 66). Returns the A/B's ms a step."""
    t_phase = time.perf_counter()
    interbatch_check(tr, torch, path)

    fs = tr.feature_source
    grid = f", K4 grid {fs.max_blocks}" if hasattr(fs, "max_blocks") else ""
    print(f"  interbatch {path}: A/B in turn, {AB_STEPS} steps each after "
          f"{WARMUP_STEPS} warm-up, then {AB_PROFILED} profiled")
    ab = {}
    for ib in (False, True, True, False):
        r = ab_run(tr, torch, ib)
        label = ("interbatch" if ib else "plain") + grid
        ab.setdefault(label, []).append(r)
        print(ab_line(label, *r))
    if grid:
        from legion_tpu_torch.cache.unified_cache import cached_gather
        grid = fs.max_blocks
        batch, _ = one_batch(tr, torch)
        ids = batch.node_ids[:tr.sampler_t.max_ids]
        ref = cached_gather(fs.cache, fs.host, ids, grid)
        ends = (K4_CAPS[0], K4_CAPS[-1])
        k4_ms = {}
        for cap in K4_CAPS + ends * K4_PAIRS:
            out = cached_gather(fs.cache, fs.host, ids, cap)
            if not (torch.equal(out[0], ref[0])
                    and torch.equal(out[1], ref[1])):
                fail(f"K4 with grid cap {cap} differs from grid {grid}")
            k4_ms.setdefault(cap, []).append(cuda_ms(
                lambda: cached_gather(fs.cache, fs.host, ids, cap), torch))
        print(f"    K4 alone at {path}'s fetch ({ids.shape[0]} ids), ms by "
              "grid cap, in turn (all exact): " + " | ".join(
                  f"{c}: " + ", ".join(f"{t:.4f}" for t in v)
                  for c, v in k4_ms.items()))
        med = {c: statistics.median(k4_ms[c]) for c in ends}
        print(f"    K4 alone at {path}'s fetch: median of {K4_PAIRS + 1} "
              f"readings, grid {ends[0]} {med[ends[0]]:.4f} ms, grid "
              f"{ends[1]} {med[ends[1]]:.4f} ms "
              f"({med[ends[1]] / med[ends[0]] - 1:+.2%})")
        other = ends[0] if grid < ends[0] else ends[1]
        try:
            fs.max_blocks = other
            for ib in (False, True):
                r = ab_run(tr, torch, ib)
                ab.setdefault(f"{'interbatch' if ib else 'plain'}, K4 grid "
                              f"{other}", []).append(r)
                print(ab_line(f"{'interbatch' if ib else 'plain'}, K4 grid "
                              f"{other}", *r))
        finally:
            fs.max_blocks = grid
    print(f"  interbatch {path}: {time.perf_counter() - t_phase:.1f} s")
    return {k: [r[0] for r in v] for k, v in ab.items()}


def phase_modes(tr, torch, path):
    """The two modes of a path whose steps take members or a process
    group: ``phase_fused`` and ``interbatch_check``, then an A/B in this
    call: plain, ``fused_steps`` FUSED_K, interbatch, plain (``ab_run``):
    ms a step, busy / span, the idle share and the time a step in which
    two streams run at once. Returns {mode: [(ms a step, idle share)]}."""
    t0 = time.perf_counter()
    phase_fused(tr, torch, path)
    interbatch_check(tr, torch, path)
    print(f"  modes {path}: A/B in turn, {AB_STEPS} steps each after "
          f"{WARMUP_STEPS} warm-up, then {AB_PROFILED} profiled (whole "
          f"calls of {FUSED_K} when fused)")
    ab = {}
    for label, ib, K in (("plain", False, 1),
                         (f"fused {FUSED_K}", False, FUSED_K),
                         ("interbatch", True, 1), ("plain", False, 1)):
        r = ab_run(tr, torch, ib, K)
        _, union, span, _ = r[2]
        ab.setdefault(label, []).append((r[0], 1 - union / span))
        print(ab_line(label, *r))
    print(f"  modes {path}: {time.perf_counter() - t0:.1f} s")
    return ab


def print_modes(modes):
    """The A/B lines of ``phase_modes`` by path."""
    print("modes A/B with members and in worlds of one rank, ms/step by "
          "the host clock (idle share under the profiler; one call; no "
          "claim):")
    for path, runs in modes.items():
        print(f"  {path}: " + " | ".join(
            f"{k} " + ", ".join(f"{ms:.3f} ({idle:.3f})" for ms, idle in v)
            for k, v in runs.items()))


def one_batch(tr, torch, key=77):
    """One train batch of ``tr`` through its public sampler, and its
    fetched features."""
    s = tr.sampler_t
    seeds = tr.train_bank[:s.config.batch_size]
    batch = s.sample(tr.graph_access, seeds, key,
                     pos_map=s.init_state("cuda"))
    x, _ = tr.feature_source.fetch(batch.node_ids[:s.max_ids])
    torch.cuda.synchronize()
    return batch, x


def attn_pair(fn, args, grads_of, g_out, torch):
    """fn(*args) forward only, and forward + backward with the gradients
    of ``grads_of`` (leaf tensors in args) for upstream ``g_out``."""
    def fwd():
        with torch.no_grad():
            return (fn(*args),)

    def fwd_bwd():
        out = fn(*args)
        return (out,) + torch.autograd.grad(out, grads_of, g_out)
    return fwd, fwd_bwd


def attn_drop(torch, shape, seed, layer=0, rate=0.6):
    """Attention dropout for K6 and K7 at alpha ``shape``: the package's
    ``AttnDrop`` (the keep bits drawn in the kernels from the dropout key
    words of ``seed``); in a package from before it (the parent's, timed in
    turns with this one) the (mask, scale) its kernels read, drawn from a
    generator seeded with ``seed``."""
    from legion_tpu_torch.ops import dropout as kdrop
    if hasattr(kdrop, "AttnDrop"):
        from legion_tpu_torch.sampling.access import dropout_words
        return kdrop.AttnDrop(dropout_words(seed, "cuda"), layer, rate)
    from legion_tpu_torch.models.common import dropout_keep
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return dropout_keep(tuple(shape), rate, g, "cuda")


def k6_compares(tr, torch, results, main, path="gat"):
    """K6 against its plain version at GAT layer 0 of ``path`` (one real
    batch: the aligned last hop's lanes of the fetched bf16 rows, 128 wide
    on the device table, 100 on GAT-H's cached rows), forward and forward +
    backward, bf16 (the path's dtype, held as ``k6_bf16_tol`` sets out)
    and f32 (``close_f32``), with attention dropout in its u8 regime and
    without. In bf16 the general kernels are held and timed too, in the
    same call: the tensor-core form against them at the path's width.
    Each is also timed queued (``queued_ms``): forward + backward is some
    ten launches through autograd, and the host may take longer to launch
    them than the card takes to run them. The Device GAT path's forward +
    backward with dropout is the kernel line's number."""
    from legion_tpu_torch.ops import kernels
    p = tr.init_state()["model"].layers[0]   # the initial parameters
    batch, x = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    src, off = batch.edge_src[1], batch.hop_offsets[1]
    fo, ao = scfg.fanouts[1], scfg.aligned_hop_offset(1)
    F, d_in = src.shape[0] // fo, x.shape[1]
    H = p["attn_l"].shape[0]
    keep = attn_drop(torch, (fo, F, H), 11)
    print(f"  gat_attend     {path} layer 0: F {F} x fanout {fo} x heads {H} "
          f"x d_in {d_in} (x {tuple(x.shape)} {x.dtype}, aligned offset "
          f"{ao})")

    def least(es, bwd):
        """K6's bound. Forward: the lanes and the destinations, u and the
        lane ids read; xw, alpha and the sign written. Backward (with its
        two du GEMMs): dxw, the lanes, the destinations, alpha, the sign
        and the ids read; du written. Dropout's keep bits are drawn from
        the key (8 bytes), no mask."""
        rows, flags = (fo + 1) * F * d_in * es, fo * F * H
        peak = "bf16" if es == 2 else "f32"
        fwd = bound(rows + 2 * d_in * H * es + nb(src)
                    + F * H * d_in * es + 5 * flags,
                    ops=2 * F * d_in * H * (2 * fo + 1), peak=peak)
        if not bwd:
            return fwd
        b = bound(F * H * d_in * es + rows + 5 * flags + nb(src)
                  + 2 * d_in * H * es,
                  ops=2 * F * d_in * H * (2 * fo + 1), peak=peak)
        return fwd[0] + b[0], fwd[1]

    for dt in (torch.bfloat16, torch.float32):
        w = p["w"].detach().to(dt)
        u = [torch.einsum("khd,hd->kh", w, p[a].detach().to(dt))
             .contiguous().requires_grad_() for a in ("attn_l", "attn_r")]
        xd = x.to(dt)
        g_out = torch.randn((F, H, d_in), generator=g, device="cuda").to(dt)
        forms = (False, True) if dt == torch.bfloat16 else (False,)
        for kp in (keep, None):
            args = (xd, u[0], u[1], src, off, fo, ao, 0.2, kp)
            pf, pb = attn_pair(kernels.gat_attend_plain, args, u, g_out,
                               torch)
            es = xd.element_size()
            for general in forms:
                # the general kernels sum d alpha in another order than
                # the plain version's bf16 GEMM, so many more d alphas
                # round apart than on the tensor cores; du as k6_edges
                # holds them
                tol = k6_bf16_tol(args, torch, general=general,
                                  du_atol=2.0 ** (-7 if general else -11)) \
                    if dt == torch.bfloat16 \
                    else tuple_tol(close_f32, close_f32, close_f32)
                kf, kb = attn_pair(
                    lambda *a: kernels.gat_attend(*a, general=general), args,
                    u, g_out, torch)
                note = (f"{path} L0 {F}x{fo}x{H}x{d_in} {str(dt)[6:]}"
                        f"{' drop u8' if kp else ''}"
                        f"{' general' if general else ''}")
                compare("gat_attend", kf, pf, tol, results, torch,
                        note + " fwd", least=least(es, False), queued=True)
                t_b = compare("gat_attend", kb, pb, tol, results, torch,
                              note + " fwd+bwd", least=least(es, True),
                              queued=True)
                if path == "gat" and dt == torch.bfloat16 \
                        and kp is not None and not general:
                    main["gat_attend"] = [t_b]


K6_EDGE_WIDTHS = (36, 100, 112, 128, 602)


def k6_edges(torch, results):
    """K6 at the edges of its shapes, forward and backward against the
    plain version on random inputs, 517 rows: heads 1, 3, 8; widths 36,
    100, 112, 128, 602; fanouts 1, 10, 33 (the tensor-core forms take bf16
    at fanouts 1 and 10: the exact one at width 128, the padded one at 36,
    100 and 112, whose 36- and 100-wide rows start 16- and 8-byte aligned
    by turns; the general kernels the rest); bf16 (as ``k6_bf16_tol``,
    with up to 8 + 1/200 of the pairs apart and du within one ulp plus
    2^-7 max|ref|) and f32 (``close_f32``, against the plain version on
    the inputs cast to float64: in f32 the plain version's du drifts from
    that reference, where its d er cancels, further than the kernel's
    does); with the dropout mask and without; a tenth of the lanes
    invalid, and one row with no valid lane."""
    from legion_tpu_torch.ops import kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    F, n, worst = 517, 0, 0.0
    for H in (1, 3, 8):
        for d_in in K6_EDGE_WIDTHS:
            for fo in (1, 10, 33):
                ao = F + 11
                N = ao + fo * F
                x32 = torch.randn((N, d_in), generator=g, device="cuda")
                u32 = [torch.randn((d_in, H), generator=g, device="cuda")
                       * 0.1 for _ in range(2)]
                src = torch.randint(0, N, (fo * F,), generator=g,
                                    device="cuda", dtype=torch.int32)
                src[torch.rand(src.shape, generator=g, device="cuda")
                    < 0.1] = -1
                src.view(fo, F)[:, 3] = -1
                off = torch.tensor(7, dtype=torch.int32, device="cuda")
                keep = attn_drop(torch, (fo, F, H), 1000 * H + 10 * fo + d_in)
                g32 = torch.randn((F, H, d_in), generator=g, device="cuda")
                u64 = [t.double().requires_grad_() for t in u32]
                for dt in (torch.bfloat16, torch.float32):
                    u = [t.to(dt).requires_grad_() for t in u32]
                    for kp in (keep, None):
                        args = (x32.to(dt), u[0], u[1], src, off, fo, ao,
                                0.2, kp)
                        tol = k6_bf16_tol(args, torch, F * H // 200 + 8,
                                          2.0 ** -7, quiet=True) \
                            if dt == torch.bfloat16 \
                            else tuple_tol(close_f32, close_f32, close_f32)
                        kb = attn_pair(kernels.gat_attend, args, u,
                                       g32.to(dt), torch)[1]
                        pb = attn_pair(kernels.gat_attend_plain, args, u,
                                       g32.to(dt), torch)[1] \
                            if dt == torch.bfloat16 else attn_pair(
                                kernels.gat_attend_plain,
                                (x32.double(), u64[0], u64[1]) + args[3:],
                                u64, g32.double(), torch)[1]
                        err, ok = tol(kb(), pb())
                        if not ok:
                            fail(f"gat_attend edge H {H} d_in {d_in} fanout "
                                 f"{fo} {dt} mask {kp is not None}: kernel "
                                 f"disagrees with its plain version (max "
                                 f"abs err {err})")
                        n, worst = n + 1, max(worst, err)
    print(f"  gat_attend     {n} edge cases (heads 1/3/8, widths "
          f"{'/'.join(map(str, K6_EDGE_WIDTHS))}, fanouts 1/10/33, bf16 and "
          f"f32, mask or none), fwd+bwd: all within tolerance, max_abs_err "
          f"{worst:.3g}")
    r = results["gat_attend"]
    r["max_abs_err"] = max(r["max_abs_err"], worst)


def k7_least(sl, z, fo, H, d, num_dst, aligned):
    """K7's bounds, (forward, forward + backward). Forward: each distinct
    source row of z, the scores and the lane ids read; the destinations
    and alpha written. Backward: the same rows, d out, alpha and the ids
    read; d scores and dz written. Dropout's keep bits are drawn from the
    key, no mask."""
    F = sl.shape[0] // fo
    zrow, flags = H * d * z.element_size(), fo * F * H
    zrows = (sl.shape[0] if aligned else distinct(sl)) * zrow
    fwd = bound(zrows + 8 * flags + nb(sl) + num_dst * H * d * 4,
                ops=2 * flags * d)
    bwd = bound(zrows + F * H * d * 4 + 8 * flags + nb(sl)
                + z.shape[0] * zrow, ops=4 * flags * d)
    return fwd, (fwd[0] + bwd[0], fwd[1])


def k7_compares(tr, torch, results, main):
    """K7 against its plain version at GAT layer 1 (one real batch of the
    GAT path: 8000 x 25 lanes, 1 head, z [S1, classes]), forward and
    forward + backward, bf16 and f32, with attention dropout in its
    per-lane regime and without; and once on an aligned hop."""
    from legion_tpu_torch.ops import hop_agg, kernels
    batch, _ = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    S = scfg.cum_sizes()
    src, off = batch.edge_src[0], batch.hop_offsets[0]
    fo = scfg.fanouts[0]
    F = src.shape[0] // fo
    H, d = tr.config.train.gat_heads[1], tr.dataset.meta.num_classes
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    keep = attn_drop(torch, (fo, F, H), 12, layer=1)
    z0 = torch.randn((S[1], H, d), generator=g, device="cuda")
    sc = torch.randn((fo, F, H), generator=g, device="cuda") \
        .requires_grad_()
    g_out = torch.randn((S[0], H, d), generator=g, device="cuda")
    cases = [(torch.bfloat16, kp, None, src) for kp in (keep, None)] + \
        [(torch.float32, kp, None, src) for kp in (keep, None)]
    # the aligned form: lanes at S0 + lane, the same pads
    a_src = torch.where(src >= 0, S[0] + torch.arange(
        src.shape[0], device="cuda", dtype=torch.int32), -1)
    cases.append((torch.bfloat16, keep, S[0], a_src))
    for dt, kp, ao, sl in cases:
        n = S[0] + sl.shape[0] if ao is not None else S[1]
        z = (z0 if ao is None else torch.randn(
            (n, H, d), generator=g, device="cuda")).to(dt).requires_grad_()
        kern = (lambda z, sc, sl=sl, ao=ao, kp=kp: kernels.hop_attention(
            z.reshape(z.shape[0], -1), sc, sl, fo, off, S[0], H, ao, kp))
        plain = (lambda z, sc, sl=sl, ao=ao, kp=kp:
                 hop_agg.hop_softmax_attention_plain(z, sc, sl, fo, off,
                                                     S[0], kp, ao))
        kf, kb = attn_pair(kern, (z, sc), (z, sc), g_out, torch)
        pf, pb = attn_pair(plain, (z, sc), (z, sc), g_out, torch)
        dz_tol = bf16_ulp if dt == torch.bfloat16 \
            else f32_atomic_order
        note = (f"L1 {F}x{fo}x{H}x{d} z[{n}] {str(dt)[6:]}"
                f"{' drop' if kp else ''}{' aligned' if ao else ''}")
        fwd, both = k7_least(sl, z, fo, H, d, S[0], ao is not None)
        compare("hop_attention", kf, pf, tuple_tol(close_f32), results,
                torch, note + " fwd", least=fwd, queued=True)
        t_b = compare("hop_attention", kb, pb,
                      tuple_tol(close_f32, dz_tol, close_f32), results,
                      torch, note + " fwd+bwd", least=both, queued=True)
        if dt == torch.bfloat16 and kp is not None and ao is None:
            main["hop_attention"] = [t_b]


def k7_exact_compares(tr, torch, results):
    """K7 at the exact-dedup GAT layer 0: a batch sampled with
    ``dedup_last_hop=True`` (the GCN trainer's), its hop-1 lanes x 8
    heads x 256 over z [S2, 2048] bf16, where JAX needs its chunked scan;
    forward and forward + backward, with u8-regime dropout and without."""
    from legion_tpu_torch.ops import hop_agg, kernels
    batch, _ = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    S = scfg.cum_sizes()
    src, off = batch.edge_src[1], batch.hop_offsets[1]
    fo, H, d = scfg.fanouts[1], 8, 256
    F = src.shape[0] // fo
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    keep = attn_drop(torch, (fo, F, H), 13)
    z = torch.randn((S[2], H, d), generator=g, device="cuda") \
        .to(torch.bfloat16).requires_grad_()
    sc = torch.randn((fo, F, H), generator=g, device="cuda") \
        .requires_grad_()
    g_out = torch.randn((S[1], H, d), generator=g, device="cuda")
    for kp in (keep, None):
        kern = (lambda z, sc, kp=kp: kernels.hop_attention(
            z.reshape(z.shape[0], -1), sc, src, fo, off, S[1], H, None, kp))
        plain = (lambda z, sc, kp=kp: hop_agg.hop_softmax_attention_plain(
            z, sc, src, fo, off, S[1], kp))
        kf, kb = attn_pair(kern, (z, sc), (z, sc), g_out, torch)
        pf, pb = attn_pair(plain, (z, sc), (z, sc), g_out, torch)
        note = (f"exact L0 {F}x{fo}x{H}x{d} z[{S[2]}] bf16"
                f"{' drop u8' if kp else ''}")
        fwd, both = k7_least(src, z, fo, H, d, S[1], False)
        compare("hop_attention", kf, pf, tuple_tol(close_f32), results,
                torch, note + " fwd", iters=5, least=fwd)
        compare("hop_attention", kb, pb,
                tuple_tol(close_f32, bf16_ulp, close_f32), results,
                torch, note + " fwd+bwd", iters=5, least=both)


def k7_edges(torch, results):
    """K7 at the edges of its shapes, forward and backward against the
    plain version on random inputs, 203 frontier rows placed at offset 7 of
    214 destinations: heads 1, 2, 8, 16; head widths 8, 32, 33, 64, 256;
    fanouts 1, 25, 32, 33, 64 (the small-row kernels take fanouts up to 32
    at a head's slice of 16 to 128 bytes, the general kernels the rest);
    gathered and aligned; bf16 and f32; with the keep mask and without; a
    tenth of the lanes invalid, and one row with no valid lane. And z at a
    base that is not 16-byte aligned, which the general kernels take.
    Tolerances as at the path's shapes: out and d scores ``close_f32``, dz
    ``bf16_ulp`` or ``f32_atomic_order``; at fanout 1, where d scores is
    zero but for rounding, it is held within 1e-5 d max|d out| max|z|."""
    from legion_tpu_torch.ops import hop_agg, kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    F, num_dst, n, worst = 203, 214, 0, 0.0
    off = torch.tensor(7, dtype=torch.int32, device="cuda")
    lanes = torch.arange(64 * F, device="cuda", dtype=torch.int32)

    def one(z, sc, src, fo, H, ao, kp, g_out, what):
        nonlocal n, worst
        kern = (lambda z, sc: kernels.hop_attention(
            z.reshape(z.shape[0], -1), sc, src, fo, off, num_dst, H, ao, kp))
        plain = (lambda z, sc: hop_agg.hop_softmax_attention_plain(
            z, sc, src, fo, off, num_dst, kp, ao))
        kb = attn_pair(kern, (z, sc), (z, sc), g_out, torch)[1]
        pb = attn_pair(plain, (z, sc), (z, sc), g_out, torch)[1]
        dz_tol = bf16_ulp if z.dtype == torch.bfloat16 else f32_atomic_order
        ds_tol = close_f32
        if fo == 1:
            # a softmax over one lane: d scores is zero but for rounding,
            # so hold it against the size of d alpha, not of itself
            lim = 1e-5 * z.shape[2] * float(g_out.abs().max()
                                            * z.detach().abs().max())
            ds_tol = (lambda k, p: ((k - p).abs().max().item(), bool(
                (k - p).abs().max() <= lim)))
        err, ok = tuple_tol(close_f32, dz_tol, ds_tol)(kb(), pb())
        if not ok:
            fail(f"hop_attention edge {what}: kernel disagrees with its "
                 f"plain version (max abs err {err})")
        n, worst = n + 1, max(worst, err)

    for H in (1, 2, 8, 16):
        for d in (8, 32, 33, 64, 256):
            for fo in (1, 25, 32, 33, 64):
                E = fo * F
                src = torch.randint(0, 300, (E,), generator=g, device="cuda",
                                    dtype=torch.int32)
                src[torch.rand((E,), generator=g, device="cuda") < 0.1] = -1
                src.view(fo, F)[:, 3] = -1
                sc = torch.randn((fo, F, H), generator=g, device="cuda") \
                    .requires_grad_()
                keep = attn_drop(torch, (fo, F, H), 100 * H + d + 7 * fo)
                g_out = torch.randn((num_dst, H, d), generator=g,
                                    device="cuda")
                for ao in (None, num_dst + 5):
                    N = 300 if ao is None else ao + E
                    sl = src if ao is None else torch.where(
                        src >= 0, ao + lanes[:E], -1)
                    z32 = torch.randn((N, H, d), generator=g, device="cuda")
                    for dt in (torch.bfloat16, torch.float32):
                        z = z32.to(dt).requires_grad_()
                        for kp in (keep, None):
                            one(z, sc, sl, fo, H, ao, kp, g_out,
                                f"H {H} d {d} fanout {fo} {dt} aligned "
                                f"{ao} mask {kp is not None}")
    # a z whose first byte is not 16-byte aligned: the general kernels
    H, d, fo = 1, 32, 25
    src = torch.randint(0, 300, (fo * F,), generator=g, device="cuda",
                        dtype=torch.int32)
    sc = torch.randn((fo, F, H), generator=g, device="cuda").requires_grad_()
    g_out = torch.randn((num_dst, H, d), generator=g, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        flat = torch.randn((300 * H * d + 1,), generator=g,
                           device="cuda").to(dt)
        z = flat[1:].view(300, H, d).requires_grad_()
        if z.data_ptr() % 16 == 0:
            fail("hop_attention edges: z is 16-byte aligned where the case "
                 "wants it not")
        one(z, sc, src, fo, H, None, None, g_out, f"misaligned z {dt}")
    print(f"  hop_attention  {n} edge cases (heads 1/2/8/16, head widths "
          f"8/32/33/64/256, fanouts 1/25/32/33/64, gathered and aligned, "
          f"bf16 and f32, mask or none, misaligned z), fwd+bwd: all within "
          f"tolerance, max_abs_err {worst:.3g}")
    r = results["hop_attention"]
    r["max_abs_err"] = max(r["max_abs_err"], worst)


def keep_set_report(name, what, want, got_fwd, d_k, d_p, torch):
    """Fail unless the kernel kept the lanes ``want`` (bool, valid lanes
    only) in its forward (``got_fwd``) and its backward: per lane, the
    kernel's gradient ``d_k`` within 1e-3 of the plain version's ``d_p``,
    where a flipped lane moves it by 0.1 or more (inputs set so)."""
    fwd_bad = int((got_fwd != want).sum())
    bwd_bad = int(((d_k - d_p).abs() > 1e-3).sum())
    kept = int(want.sum())
    if fwd_bad or bwd_bad or not 0 < kept < want.numel():
        fail(f"{name} keep set {what}: {fwd_bad} lanes apart forward, "
             f"{bwd_bad} backward, {kept} of {want.numel()} kept")
    return f"{what}: {kept} of {want.numel()} kept"


def k6_keep_sets(tr, torch):
    """K6's keep set, lane for lane, against ``keep_mask_plain`` of the key
    at the attention fold, forward and backward, in every form: the exact
    tensor-core form (bf16, width 128), the padded one (width 100) and the
    general kernels (bf16 through ``general``, and f32), at GAT layer 0's
    shape (one real batch's pads: 96,576 x 10 x 8, regime 2) and at its
    first 12,000 rows (960,000 entries, regime 3); and the tensor-core
    forms at 3 heads (their guard on heads past H). The inputs make every
    lane visible: lane (f, i)'s row is one-hot at column f and u is 0, so
    alpha is uniform over the valid lanes and xw[i, h, f] is lane (f, i,
    h)'s alpha after dropout (0 where dropped); the backward's d xw[i, h,
    f] = f + 1 gives d alpha = f + 1, and each lane's d el is held against
    the plain version's (a flip moves it by at least 0.1)."""
    from legion_tpu_torch.ops import dropout as kdrop
    from legion_tpu_torch.ops import kernels
    batch, _ = one_batch(tr, torch)
    scfg = tr.sampler_t.config
    fo = scfg.fanouts[1]
    src_all = batch.edge_src[1].view(fo, -1)
    F2 = src_all.shape[1]
    off = torch.zeros((), dtype=torch.int32, device="cuda")
    cases = [(F2, 8, 128, torch.bfloat16, False, "exact"),
             (F2, 8, 100, torch.bfloat16, False, "padded"),
             (F2, 8, 128, torch.bfloat16, True, "general bf16"),
             (F2, 8, 128, torch.float32, False, "general f32"),
             (12000, 8, 128, torch.bfloat16, False, "exact"),
             (12000, 8, 100, torch.bfloat16, False, "padded"),
             (12000, 8, 128, torch.bfloat16, True, "general bf16"),
             (12000, 8, 128, torch.float32, False, "general f32"),
             (F2, 3, 128, torch.bfloat16, False, "exact"),
             (12000, 3, 100, torch.bfloat16, False, "padded")]
    done = []
    for F, H, d_in, dt, general, form in cases:
        src = src_all[:, :F].contiguous().view(-1)
        shape = (fo, F, H)
        drop = attn_drop(torch, shape, 31 + F + H, layer=0)
        reg = kdrop.regime(shape, drop.rate)
        ao = F
        x = torch.zeros((ao + fo * F, d_in), dtype=dt, device="cuda")
        x[ao:].view(fo, F, d_in)[:, :, :fo] = torch.eye(
            fo, dtype=dt, device="cuda")[:, None, :]
        u = torch.zeros((d_in, H), dtype=dt, device="cuda")
        valid = (src >= 0).view(fo, F, 1)
        want = kdrop.keep_mask_plain(shape, drop.rate, drop.words,
                                     kdrop.attn_fold(0)) & valid
        xw, alpha, neg = kernels.gat_attend_fwd(x, u, u, src, off, fo, ao,
                                                0.2, drop, general)
        got = (xw[:, :, :fo].permute(2, 0, 1) != 0) & valid
        dxw = torch.zeros((F, H, d_in), dtype=dt, device="cuda")
        dxw[:, :, :fo] = torch.arange(1, fo + 1, dtype=dt, device="cuda")
        d_el = kernels.gat_attend_bwd(dxw, x, src, alpha, neg, fo, ao, 0.2,
                                      drop, general)[0]
        el = torch.zeros(shape, device="cuda", requires_grad=True)
        er = torch.zeros((F, H), device="cuda", requires_grad=True)
        a_p = kernels.masked_fanout_softmax(
            kernels.leaky_relu(el + er[None], 0.2), valid)
        xw_p = kernels.gat_contract_plain(x, a_p, drop, ao)
        d_el_p, = torch.autograd.grad(xw_p, el, dxw)
        done.append(keep_set_report(
            "gat_attend", f"{form} {F}x{fo}x{H}x{d_in} regime {reg}", want,
            got, d_el, d_el_p, torch))
        del x, xw, alpha, neg, dxw, d_el, el, er, a_p, xw_p, d_el_p
    print(f"  gat_attend     keep sets lane for lane, fwd and bwd, equal to "
          f"keep_mask_plain's: " + "; ".join(done))


def k7_keep_sets(torch):
    """K7's keep set, lane for lane, against ``keep_mask_plain`` of the key
    at the attention fold, forward and backward, in both designs: the
    small-row kernels (a head's slice of 64 bytes in bf16, 128 in f32) and
    the general ones (33 columns), gathered, at GAT layer 1's shape (8000
    rows x 25 draws x 1 head, regime 3) and at 42,000 rows (1,050,000
    entries, regime 2). Lane (f, i) reads its own row, one-hot at column f,
    and the scores are 0, so out[i, h, f] is the lane's alpha after
    dropout; d out[i, h, f] = f + 1 gives d alpha = f + 1, and each lane's
    d score is held against the plain version's. A tenth of the lanes are
    pads, and row 3 has none valid."""
    from legion_tpu_torch.ops import dropout as kdrop
    from legion_tpu_torch.ops import hop_agg, kernels
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    fo, H = 25, 1
    off = torch.zeros((), dtype=torch.int32, device="cuda")
    done = []
    for F in (8000, 42000):
        E = fo * F
        src = torch.arange(E, dtype=torch.int32, device="cuda")
        src[torch.rand((E,), generator=g, device="cuda") < 0.1] = -1
        src.view(fo, F)[:, 3] = -1
        shape = (fo, F, H)
        drop = attn_drop(torch, shape, 47 + F, layer=1)
        reg = kdrop.regime(shape, drop.rate)
        valid = (src >= 0).view(fo, F, 1)
        want = kdrop.keep_mask_plain(shape, drop.rate, drop.words,
                                     kdrop.attn_fold(1)) & valid
        for dt, d, form in ((torch.bfloat16, 32, "small-row bf16"),
                            (torch.float32, 32, "small-row f32"),
                            (torch.bfloat16, 33, "general bf16")):
            z = torch.zeros((E, H, d), dtype=dt, device="cuda")
            z.view(fo, F, H, d)[..., :fo] = torch.eye(
                fo, dtype=dt, device="cuda")[:, None, None, :]
            sc = torch.zeros(shape, device="cuda", requires_grad=True)
            g_out = torch.zeros((F, H, d), device="cuda")
            g_out[..., :fo] = torch.arange(1, fo + 1, device="cuda",
                                           dtype=torch.float32)
            out = kernels.hop_attention(z.view(E, H * d), sc, src, fo, off,
                                        F, H, None, drop)
            got = (out[:, :, :fo].permute(2, 0, 1) != 0) & valid
            ds, = torch.autograd.grad(out, sc, g_out)
            out_p = hop_agg.hop_softmax_attention_plain(z, sc, src, fo, off,
                                                        F, drop)
            ds_p, = torch.autograd.grad(out_p, sc, g_out)
            done.append(keep_set_report(
                "hop_attention", f"{form} {F}x{fo}x{H}x{d} regime {reg}",
                want, got, ds, ds_p, torch))
            del z, sc, out, ds, out_p, ds_p
    print(f"  hop_attention  keep sets lane for lane, fwd and bwd, equal to "
          f"keep_mask_plain's: " + "; ".join(done))


def phase_attn(torch):
    """``--attn``: K6 and K7 alone at the GAT path's shapes on the device
    dataset (``k6_compares``, ``k7_compares``: bf16 and f32, with attention
    dropout and without, each also queued) and, in a package that draws
    the keep bits in the kernels, their keep sets (``k6_keep_sets``,
    ``k7_keep_sets``). It also runs against a package from before that
    (whose kernels read a mask, ``attn_drop``), for times in turns with
    it; the last lines give the path's two times, K6's layer 0 forward +
    backward and K7's layer 1 forward + backward, both bf16 with dropout,
    as launched and queued."""
    from legion_tpu_torch.data import synthesize_device_dataset
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.train import Trainer
    ds = synthesize_device_dataset("cuda")
    tr = Trainer(ds, bench_config(ds, model="gat"), device="cuda")
    results, main = {}, {}
    k6_compares(tr, torch, results, main)
    k7_compares(tr, torch, results, main)
    if hasattr(kernels, "gat_attend_fwd"):
        k6_keep_sets(tr, torch)
        k7_keep_sets(torch)
    for n in ("gat_attend", "hop_attention"):
        ms, plain_ms, least, _, q_ms = main[n][0]
        print(f"  {n} on the GAT path, fwd + bwd with dropout: kernel "
              f"{ms:.4f} ms, queued {q_ms:.4f} ms, bound {least[0]:.4f} ms "
              f"| plain {plain_ms:.4f} ms")
    tr.close()


def compare_slices(trs, torch, label):
    """The slice on the card (kernels) against the slice on the CPU (plain
    versions): the same caps, identical batches (the draws are bit-exact
    and sort dedup deterministic), and matching losses and parameters
    over 3 steps."""
    if trs[0].compact_caps != trs[1].compact_caps:
        fail(f"{label}: caps differ: {trs[0].compact_caps} "
             f"{trs[1].compact_caps}")
    states = [t.init_state() for t in trs]
    states[1]["model"].load_state_dict(states[0]["model"].state_dict())
    bs = trs[0].sampler_t.config.batch_size
    b = [t.sampler_t.sample(t.graph_access, t.train_bank[:bs], 99,
                            pos_map=st["pos_map"])
         for t, st in zip(trs, states)]
    for f in ("node_ids", "num_nodes", "num_edges", "hop_offsets"):
        if not torch.equal(getattr(b[0], f), getattr(b[1], f).cpu()):
            fail(f"{label}: small batch differs in {f}")
    losses, counters = [[], []], [[], []]
    for _ in range(3):
        for i, t in enumerate(trs):
            states[i], loss = t.train_step(states[i])
            losses[i].append(float(loss))
            counters[i].append([int(t.last_feat_hits), int(t.last_slots),
                                int(t.last_topo_hits),
                                int(t.last_topo_total)])
    if counters[0] != counters[1]:
        fail(f"{label}: hit counters differ: {counters}")
    rel = max(abs(a - c) / abs(a) for a, c in zip(*losses))
    per = {n: ((p.detach().cpu() - q.detach()).norm()
               / q.detach().norm()).item()
           for (n, p), q in zip(states[1]["model"].named_parameters(),
                                states[0]["model"].parameters())}
    pdiff = max(per.values())
    worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    print("  largest param rel diffs: " + ", ".join(
        f"{n} {v:.3g}" for n, v in worst))
    print(f"  cpu losses {losses[0]}\n  gpu losses {losses[1]}\n  max loss "
          f"rel diff {rel:.3g} | max param rel diff {pdiff:.3g} (3 steps) | "
          f"hit counters (feature hits, slots, topology hits, total) "
          f"{counters[1]}")
    # bf16 activations may round differently where f32 sums differ in
    # order (cuBLAS vs CPU GEMM, f32 atomics): bf16-level tolerance
    if rel > 2e-2 or pdiff > 2e-2:
        fail(f"{label}: small-input slice on the card disagrees with the "
             "CPU slice")


def phase_reference(torch):
    """Phase 4: the device-dataset slices of GraphSAGE, GAT and GCN, card
    against CPU, small size, dropout 0."""
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
    for model, dedup in (("graphsage", "sort"), ("graphsage", "map"),
                         ("gat", "sort"), ("gcn", "sort")):
        cfg = bench_config(small, model=model, dedup=dedup)
        cfg = replace(cfg, sampler=replace(cfg.sampler, batch_size=256),
                      train=replace(cfg.train, dropout=0.0, gat_feat_drop=0.0,
                                    gat_attn_drop=0.0))
        print(f" {model}, {dedup} dedup:")
        compare_slices([Trainer(small, cfg, device="cpu"),
                        Trainer(gpu_ds, cfg, "cuda")], torch,
                       f"device {model} {dedup}")


def fmt_setup(setup_s):
    """``Trainer.setup_s``: seconds by stage, and the bytes copied into
    RAM for host tables."""
    return ", ".join(f"{k} {v}" if k.endswith("_bytes") else f"{k} {v:.3f} s"
                     for k, v in setup_s.items())


def host_dataset():
    """The host-resident dataset of ``bench.py --features host`` (numpy,
    in host RAM)."""
    from legion_tpu_torch.data import synthesize_dataset
    return synthesize_dataset(num_nodes=HOST_NODES,
                              avg_degree=HOST_AVG_DEGREE, feature_dim=100,
                              num_classes=32, batch_size=8000,
                              train_frac=0.08, seed=0)


def host_trainer(ds, torch, name, **cache_kw):
    """A trainer on the host dataset, with its set-up time, plan and
    device memory."""
    from legion_tpu_torch.train import Trainer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(ds, bench_config(ds, **cache_kw), device="cuda")
    torch.cuda.synchronize()
    msg = (f"  {name}: set-up {time.perf_counter() - t0:.2f} s ("
           + fmt_setup(tr.setup_s) + f") | caps {tr.compact_caps} | device "
           f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f})")
    p = tr.cache_plan
    if p is not None:
        c = tr.cache
        edges = 0 if c.sub_indices is None else c.sub_indices.shape[0]
        msg += (f"\n    plan: alpha {p.alpha:.2f} | feature rows "
                f"{p.feature_capacity} | topology rows {p.topo_capacity} "
                f"({edges} edges) | est. saved bytes per presample run: "
                f"features {p.est_feat_saved_bytes:.4g}, topology "
                f"{p.est_topo_saved_bytes:.4g}")
    print(msg)
    return tr


def table_turns(name, what, fns, torch):
    """A kernel over host tables of the same rows, timed in turns (a, b,
    c, c, b, a; ``fns`` {table: call}); prints each table's two takes,
    their mean and its ratio to the first table's."""
    labels = list(fns)
    ms = {lb: [] for lb in labels}
    for lb in labels + labels[::-1]:
        ms[lb].append(cuda_ms(fns[lb], torch))
    mean = {lb: statistics.mean(v) for lb, v in ms.items()}
    print(f"  {name:14s} {what}, in turns (these, then back): "
          + " | ".join(f"{lb} table {', '.join(f'{x:.4f}' for x in ms[lb])}"
                       f" ms, mean {mean[lb]:.4f} "
                       f"({mean[lb] / mean[labels[0]]:.3f})"
                       for lb in labels))


def feature_tables(tr):
    """The host tables that K4 and K13 are timed over, of the same rows:
    the dataset's f32 features, their bf16 rows at the width, and the
    trainer's own table (bf16 rows at ``bf16_pitch``), last. Close all
    but the last."""
    from legion_tpu_torch.ops.host_memory import HostTable, bf16_rows
    f = tr.dataset.features
    own = tr.feature_source.host
    return {f"f32 pitch {f.shape[1]}": HostTable(f, pin=True),
            f"bf16 pitch {f.shape[1]}": HostTable(
                bf16_rows(f, f.shape[1]), pin=True),
            f"bf16 pitch {own.shape[1]}": own}


def ht_batch(tr_ht):
    """One HT train batch, sampled hop by hop: (hop 0's frontier, hop 1's,
    the fetch's ids, the fetch's missed slots in batch order)."""
    s, acc = tr_ht.sampler_t, tr_ht.graph_access
    seeds = tr_ht.train_bank[:s.config.batch_size]
    carry = s.begin(seeds)
    f0 = s.hop_frontier(carry, 0)
    carry = s.hop_absorb(carry, 0, acc.sample_neighbors(f0, 25, 77))
    f1 = s.hop_frontier(carry, 1)
    carry = s.hop_absorb(carry, 1, acc.sample_neighbors(f1, 10, 78))
    nid = s.finish(carry).node_ids[:s.max_ids]
    _, hit = tr_ht.cache.find_feat(nid)
    rows = tr_ht.feature_source.host.shape[0]
    miss = nid[(nid >= 0) & ~hit & (nid < rows)].contiguous()
    return f0, f1, nid, miss


def phase_host_kernels(tr_h, tr_ht, torch):
    """K4 and K5 against their plain versions at HT's shapes (from one
    real HT batch): K4 exactly (rows and hit count) over the trainer's
    bf16 host table and the other ``feature_tables``, also timed in
    turns; K5 bit for bit on both hops, on a hit-heavy frontier,
    an all-miss frontier and in its DeviceCSRAccess form (H's device CSR),
    which must all equal HT's own draws."""
    from legion_tpu_torch.cache.unified_cache import (cached_gather,
                                                      cached_gather_plain)
    from legion_tpu_torch.ops.host_memory import HostTable
    from legion_tpu_torch.sampling import access
    acc = tr_ht.graph_access
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    results, main = {}, {}
    f0, f1, nid, miss = ht_batch(tr_ht)

    host = (acc.host_indptr, acc.host_indices)
    cached = (acc.row_map, acc.sub_indptr, acc.sub_indices)
    dev_host = tuple(t.device for t in host)

    def k5(front, fo, key, tables):
        # the key words on the card, read by the kernel through a pointer
        words = access.key_tensor(key, "cuda")
        return lambda: access.csr_draw(front, fo, words, *tables)

    def p5(front, fo, key, tables):
        words = access.key_tensor(key, "cuda")
        return lambda: access.csr_draw_plain(front, fo, words, *tables)

    def hit_share(front):
        hit = (acc.row_map[front.clamp(min=0).long()] >= 0) & (front >= 0)
        return float(hit.sum()) / max(float((front >= 0).sum()), 1.0)

    link_bps = link_probe(tr_ht.feature_source.host, miss, torch)
    MEASURED["link_bps"] = link_bps
    pitch_probe(miss.unique().to(torch.int32), tr_ht.dataset.meta.num_nodes,
                "HT fetch", torch)
    link_unit(acc.host_indices, torch)

    for f, fo, key in ((f0, 25, 5), (f1, 10, 6)):
        k5_link(acc, f, fo, key, f"K5 {f.shape[0]} x {fo}", torch)
        # a cached slot reads its row's two offsets and one int32 per draw
        # from device memory, any other the same over PCIe
        valid = int((f >= 0).sum())
        n_hit = round(hit_share(f) * valid)
        per = 16 + 4 * fo
        least = bound(nb(f) + 4 * valid + n_hit * per + 4 * f.shape[0] * fo,
                      link_bytes=(valid - n_hit) * per, link_bps=link_bps)
        main.setdefault("csr_draw", []).append(compare(
            "csr_draw", k5(f, fo, key, host + cached),
            p5(f, fo, key, dev_host + cached), exact, results, torch,
            f"HT frontier {f.shape[0]} x {fo}, {hit_share(f):.3f} cached",
            least=least))
    ref = access.csr_draw(f1, 10, 6, *host, *cached)
    if not bool((acc.row_map >= 0).any()):
        # HT's plan gave the topology cache no rows: hold K5's hit path
        # on a topology-only cache of the same budget
        tc = topo_only_cache(tr_ht, "csr_draw")
        cached = (tc.row_map, tc.sub_indptr, tc.sub_indices)
    rows = torch.nonzero(cached[0] >= 0).flatten().to(torch.int32)
    fh = rows[torch.randint(0, rows.numel(), f1.shape, generator=g,
                            device="cuda")]
    compare("csr_draw", k5(fh, 10, 6, host + cached),
            p5(fh, 10, 6, dev_host + cached), exact, results, torch,
            f"hit-heavy frontier {fh.shape[0]} x 10, all cached")
    compare("csr_draw", k5(f1, 10, 6, host), p5(f1, 10, 6, dev_host),
            exact, results, torch, f"all-miss frontier {f1.shape[0]} x 10")
    csr = tr_h.csr
    compare("csr_draw", k5(f1, 10, 6, (csr.indptr, csr.indices)),
            p5(f1, 10, 6, (csr.indptr, csr.indices)), exact, results,
            torch, f"DeviceCSRAccess form {f1.shape[0]} x 10")
    # a cached row and its host row give the same neighbour
    for tables, what in ((host + cached, "cached"), (host, "all-miss"),
                         ((csr.indptr, csr.indices), "DeviceCSRAccess")):
        if not torch.equal(access.csr_draw(f1, 10, 6, *tables), ref):
            fail(f"csr_draw: the {what} draws differ from HT's draws")

    # K4 over the trainer's table (bf16 rows for the bf16 cache), over an
    # f32 table of the same rows (the dataset's features) and over their
    # bf16 rows unpadded, each exact, then the three in turns
    t0 = time.perf_counter()
    f32_table = HostTable(tr_ht.dataset.features, pin=True)
    print(f"  the f32 features as a host table (what the trainers "
          f"registered before bf16 rows): {f32_table.array.nbytes} B, "
          f"registered in {time.perf_counter() - t0:.3f} s | HT's bf16 "
          f"table {tr_ht.setup_s['bf16_table_bytes']} B, built in "
          f"{tr_ht.setup_s['bf16_table']:.3f} s")
    f32_table.close()
    for tr, name in ((tr_ht, "HT"), (tr_h, "H")):
        cache, own = tr.cache, tr.feature_source.host
        tables = feature_tables(tr)
        kh = cached_gather(cache, own, nid)[1]
        ph = cached_gather_plain(cache, own.device, nid)[1]
        if int(kh) != int(ph):
            fail(f"cached_gather {name}: hit count {int(kh)} != plain "
                 f"{int(ph)}")
        # device memory: the ids, a slot per valid id, each distinct cached
        # row read, every output row written; PCIe: the F values of each
        # distinct missed row once, in the table's type
        _, hit = cache.find_feat(nid)
        from_host = (nid >= 0) & ~hit & (nid < own.shape[0])
        F = cache.cache_rows.shape[1]
        row_c = F * cache.cache_rows.element_size()
        idx = nid[from_host].long()
        for label, ht in tables.items():
            least = bound(nb(nid) + 4 * int((nid >= 0).sum())
                          + (distinct(nid[hit]) + nid.shape[0]) * row_c,
                          link_bytes=distinct(nid[from_host]) * F
                          * ht.device.element_size(), link_bps=link_bps)
            t = compare(
                "cached_gather",
                lambda: cached_gather(cache, ht, nid)[0],
                lambda: cached_gather_plain(cache, ht.device, nid)[0],
                exact, results, torch,
                f"{name} fetch {nid.shape[0]} ids, "
                f"{int(kh) / max(int((nid >= 0).sum()), 1):.3f} hits, "
                f"{label} table {tuple(ht.shape)}", least=least,
                library=lambda: ht.device[idx, :F])
            if name == "HT" and ht is own:
                main["cached_gather"] = [t]
        table_turns("cached_gather", f"{name} fetch", {
            label: lambda ht=ht: cached_gather(cache, ht, nid)
            for label, ht in tables.items()}, torch)
        for ht in list(tables.values())[:-1]:
            ht.close()
    k4_edges(torch)
    k5_edges(torch)
    # per train step of HT: K4 once (the fetch), K5 once per hop
    add_main(results, main)
    return results


def topo_only_cache(tr, label):
    """A topology-only cache of CACHE_BYTES for the host trainer ``tr``,
    filled in its plan's topology order (the alpha = 0 end of the cost
    model's sweep): HT's own plan at that budget caches no topology
    rows, so K5's cached branch needs this one to draw anything."""
    import numpy as np
    from legion_tpu_torch.cache.cost_model import CostModelResult
    from legion_tpu_torch.cache.unified_cache import UnifiedCache
    p, hg = tr.cache_plan, tr.dataset.graph
    row_bytes = 8 + 4 * np.diff(hg.indptr)[p.topo_order]
    cap = int(np.searchsorted(np.cumsum(row_bytes), CACHE_BYTES,
                              side="right"))
    tc = UnifiedCache.build_from_host(
        CostModelResult(0, cap, 0.0, p.feature_order, p.topo_order, 0.0,
                        0.0), None, hg.indptr, hg.indices, hg.num_nodes,
        device="cuda")
    print(f"  {label}: HT's plan cached no topology rows; hit paths below "
          f"use a topology-only cache of {cap} rows "
          f"({tc.sub_indices.shape[0]} edges)")
    return tc


def k5_link(acc, f, fo, key, what, torch):
    """What K5's host path asks of the link on frontier ``f``: the degree
    figures of its slots; per slot, the distinct 32-byte sectors and
    128-byte lines its draws fall on against the lines its whole row spans;
    and bare reads of exactly those addresses by the SMs (nothing stored),
    a thread a word in K5's slot-major order: the offsets alone, the
    neighbour words alone, one after the other, and one word per distinct
    (slot, sector) and (slot, line)."""
    from legion_tpu_torch.ops import host_memory
    from legion_tpu_torch.sampling import access
    hp, hi = acc.host_indptr, acc.host_indices
    F = f.shape[0]
    start, deg, _ = access._draw_rows(f, hp.device, None, None)
    some = deg > 0
    lanes = torch.arange(fo * F, dtype=torch.int64,
                         device="cuda").view(fo, F)
    ka, kb = access.stream_keys(key, 0)
    pos = start[None, :] + access.bounded(
        access.hash_words(ka, kb, lanes), deg.clamp(1, 2 ** 31 - 1)[None, :])
    addr = hi.device.data_ptr() + 4 * pos            # [fanout, F] bytes

    def first_of(unit):
        """Per slot, its draws sorted by address, and which of them is the
        first on its ``unit``-byte block."""
        a = addr.sort(dim=0).values
        new = torch.ones_like(a, dtype=torch.bool)
        new[1:] = a[1:] // unit != a[:-1] // unit
        return a, new & some[None, :]

    dv = deg[some].float().sort().values
    n = dv.numel()
    sec, lin = (int(first_of(u)[1].sum()) for u in (32, 128))
    lo = hi.device.data_ptr() + 4 * start[some]
    span = int(((lo + 4 * deg[some] - 1) // 128 - lo // 128 + 1).sum())
    hdr = hp.device.data_ptr() + 8 * f[some].long()
    hdr_lines = int(((hdr + 15) // 128 - hdr // 128 + 1).sum())
    print(f"  link: {what}: {n} slots with neighbours | degree median "
          f"{dv[n // 2]:.0f}, p90 {dv[n * 9 // 10]:.0f}, share <= 32 "
          f"{float((dv <= 32).sum()) / n:.4f}, <= 64 "
          f"{float((dv <= 64).sum()) / n:.4f}, <= 128 "
          f"{float((dv <= 128).sum()) / n:.4f} | per slot, its {fo} draws "
          f"fall on {sec / n:.3f} sectors of 32 B and {lin / n:.3f} lines "
          f"of 128 B; its whole row spans {span / n:.3f} lines; its offsets "
          f"{hdr_lines / n:.3f}")

    def slot_major(a, keep):
        return torch.where(keep, (a - hi.device.data_ptr()) // 4,
                           -1).t().reshape(-1)

    vid = torch.where(some, f.long(), -1)
    offs = torch.stack([torch.where(some, 2 * vid, -1),
                        torch.where(some, 2 * vid + 2, -1)], 1).reshape(-1)
    words = slot_major(addr, some[None, :].expand_as(addr))
    reads = [("the offsets alone", lambda: host_memory.word_probe(hp, offs),
              hdr_lines),
             ("the neighbour words alone",
              lambda: host_memory.word_probe(hi, words), lin),
             ("the offsets, then the neighbour words",
              lambda: (host_memory.word_probe(hp, offs),
                       host_memory.word_probe(hi, words)), hdr_lines + lin)]
    for unit, name in ((32, "sector"), (128, "line")):
        one = slot_major(*first_of(unit))
        reads.append((f"one word per distinct (slot, {name})",
                      lambda one=one: host_memory.word_probe(hi, one),
                      lin))
    for name, fn, lines in reads:
        ms = cuda_ms(fn, torch, 10)
        print(f"  link: {what}: SM reads of {name}: {ms:.4f} ms, "
              f"{lines / ms / 1e3:.1f} M lines/s")


def link_unit(hi, torch):
    """What unit the link moves for the SMs: a million random 128-byte
    lines of the host ``indices``, with one, four (one a sector) or eight
    words of each asked for by neighbouring threads."""
    from legion_tpu_torch.ops import host_memory
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    n, base = 1_000_000, hi.device.data_ptr()
    line = torch.randint(1, hi.shape[0] // 32 - 1, (n,), generator=g,
                         device="cuda")
    word = (line * 128 - base % 128) // 4
    for places in ((0,), (0, 8, 16, 24), (0, 4, 8, 12, 16, 20, 24, 28)):
        at = (word[:, None] + torch.tensor(places, device="cuda")[None, :]) \
            .reshape(-1)
        ms = cuda_ms(lambda: host_memory.word_probe(hi, at), torch, 10)
        print(f"  link: SM reads of {len(places)} word(s) of each of {n} "
              f"random 128-byte lines: {ms:.4f} ms, {n / ms / 1e3:.1f} M "
              f"lines/s")


def k5_edges(torch):
    """K5 at the edges of its shapes, bit for bit against the plain
    version: fanouts 1, 10, 16, 17, 25, 32, 33, 64 (lane groups of 1 to 32,
    and more draws than a group has lanes); frontiers of 0, 1, 31, 33 and
    1000 slots; a graph of 600 vertices with degrees 0, 1, 2, 31, 32, 33
    (either side of a 128-byte line), 63 to 65, 127 to 129 and one row of
    70,000, whose first and last rows have neighbours; pads, ids at and
    past the number of vertices; the host CSR (int64 offsets, ``indices``
    at a base that is 4-byte but not 16-byte aligned, registered to its
    last byte) with no map, with a map and all hits, all misses or both;
    the device CSR with int32 and int64 offsets."""
    import numpy as np
    from legion_tpu_torch.ops.host_memory import HostTable
    from legion_tpu_torch.sampling import access
    rng = np.random.default_rng(8)
    V = 600
    deg = np.resize([0, 1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129], V)
    deg[[0, V - 1]] = 5, 7
    deg[300] = 70_000
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    E = int(indptr[-1])
    buf = np.empty(E + 8, np.int32)
    at = (-buf.ctypes.data) % 16 // 4 + 1
    indices = buf[at:at + E]
    indices[:] = rng.integers(0, V, E)
    if indices.ctypes.data % 16 != 4:
        fail("csr_draw edges: indices' base is not where the case wants it")
    hot = np.sort(rng.permutation(V)[:200])
    cold = np.setdiff1d(np.arange(V), hot)
    row_map = np.full(V, -1, np.int32)
    row_map[hot] = np.arange(hot.size)
    sub_indptr = np.zeros(hot.size + 1, np.int64)
    sub_indptr[1:] = np.cumsum(deg[hot])
    sub_indices = np.concatenate([indices[indptr[v]:indptr[v + 1]]
                                  for v in hot]).astype(np.int32)
    cached = tuple(torch.from_numpy(a).cuda()
                   for a in (row_map, sub_indptr, sub_indices))
    host = (HostTable(indptr, pin=True), HostTable(indices, pin=True))
    dev = (torch.from_numpy(indptr).cuda(), torch.from_numpy(indices).cuda())
    forms = {"host CSR, no map": (host, (), None),
             "host CSR, mixed": (host, cached, None),
             "host CSR, all hits": (host, cached, hot),
             "host CSR, all misses": (host, cached, cold),
             "device CSR int64": (dev, (), None),
             "device CSR int32": ((dev[0].int(), dev[1]), (), None)}
    n = 0
    for F in (0, 1, 31, 33, 1000):
        for what, (tabs, cache, pool) in forms.items():
            ids = rng.integers(0, V, F) if pool is None \
                else rng.choice(pool, F)
            if pool is None and F:
                ids[rng.random(F) < 0.1] = -1
                special = (V - 1, 0, 300, V, V + 5, 2 ** 31 - 1, -1)
                ids[:len(special)] = special[:F]
            front = torch.from_numpy(ids.astype(np.int32)).cuda()
            plain_tabs = tuple(t.device if isinstance(t, HostTable) else t
                               for t in tabs)
            for fo in (1, 10, 16, 17, 25, 32, 33, 64):
                k = access.csr_draw(front, fo, 40 + fo, *tabs, *cache)
                p_ = access.csr_draw_plain(front, fo, 40 + fo, *plain_tabs,
                                           *cache)
                if not exact(k, p_)[1]:
                    fail(f"csr_draw edge F {F} fanout {fo} {what}: kernel "
                         f"differs from its plain version")
                n += 1
    torch.cuda.synchronize()
    for t in host:
        t.close()
    print(f"  csr_draw       {n} edge cases (fanouts 1/10/16/17/25/32/33/64,"
          f" frontiers of 0/1/31/33/1000, degrees 0 to 70,000, pads and ids "
          f"past the graph, host CSR with no map / mixed / all hits / all "
          f"misses at a 4-byte-aligned base, device CSR int32 / int64): "
          f"all exact")


def link_probe(ht, miss, torch):
    """What the link gives from a registered host table: a bulk copy of as
    many bytes as the miss rows hold (the copy engine), and bare reads of
    the rows by the SMs as K4's miss path reads them (a warp a row, nothing
    converted or stored), in batch order, sorted, and each distinct row
    once, each with the row's own bytes asked for and with whole 128-byte
    lines; and, as the two ends of what address order is worth, as many
    contiguous rows and uniform random rows. Returns the bulk copy's bytes
    per second."""
    from legion_tpu_torch.ops import host_memory
    host_t = ht.device
    row = host_t.shape[1] * host_t.element_size()
    words = miss.numel() * host_t.shape[1]
    dst = torch.empty(words, dtype=host_t.dtype, device="cuda")
    flat = host_t.view(-1)
    ms = cuda_ms(lambda: dst.copy_(flat[:words], non_blocking=True), torch)
    bps = words * host_t.element_size() / ms * 1e3
    print(f"  link: bulk copy of {words * host_t.element_size()} B from the "
          f"registered table {ms:.4f} ms, {bps / 1e9:.2f} GB/s")
    numa_report(ht, torch)
    uniq = miss.unique().to(torch.int32)
    print(f"  link: {miss.numel()} miss slots, {uniq.numel()} distinct rows "
          f"(share {uniq.numel() / max(miss.numel(), 1):.4f})")
    n, rows = uniq.numel(), host_t.shape[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    for what, ids, aligns in (
            ("miss slots in batch order", miss, (16, 128)),
            ("miss slots sorted", miss.sort().values, (16, 128)),
            ("distinct missed rows, sorted", uniq, (16, 128)),
            ("contiguous rows", torch.arange(
                n, dtype=torch.int32, device="cuda") % rows, (16,)),
            ("uniform random rows", torch.randint(
                0, rows, (n,), generator=g, device="cuda",
                dtype=torch.int32), (16,))):
        for align in aligns:
            ms = cuda_ms(lambda: host_memory.read_probe(ht, ids, align),
                         torch, 10)
            print(f"  link: SM reads of {ids.numel()} rows of {row} B, "
                  f"{what}, {align}-byte spans: {ms:.4f} ms, "
                  f"{ids.numel() * row / ms / 1e6:.2f} GB/s of row bytes")
    return bps


def cpu_ranges(cpus):
    """A sorted CPU list as ranges: [0, 1, 2, 5] -> "0-2,5"."""
    out, run = [], []
    for c in cpus:
        if run and c != run[-1] + 1:
            out.append(run)
            run = []
        run.append(c)
    if run:
        out.append(run)
    return ",".join(f"{r[0]}-{r[-1]}" if len(r) > 1 else f"{r[0]}"
                    for r in out)


def numa_report(ht, torch):
    """Where the link's rate may come from, changing nothing: the card's
    NUMA node (``/sys/bus/pci/devices/<bus id>/numa_node``, else the
    "NUMA Affinity" of ``nvidia-smi topo -m``), this process's CPU
    affinity, and the NUMA nodes that hold the pages of the registered
    host table ``ht`` (the mappings of ``/proc/self/maps`` that overlap
    it, their ``N<node>=<pages>`` in ``/proc/self/numa_maps``; a mapping
    may hold more than the table)."""
    p = torch.cuda.get_device_properties(0)
    bus = (f"{getattr(p, 'pci_domain_id', 0):04x}:"
           f"{getattr(p, 'pci_bus_id', 0):02x}:"
           f"{getattr(p, 'pci_device_id', 0):02x}.0")
    try:
        with open(f"/sys/bus/pci/devices/{bus}/numa_node") as f:
            node = f.read().strip()
    except OSError as e:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                              capture_output=True, text=True, timeout=60)
        head = [" ".join(ln.split()) for ln in topo.stdout.splitlines()[:2]]
        node = (f"not readable in sysfs ({e.strerror}); nvidia-smi topo "
                f"-m: {' / '.join(head)!r}")
    lo = ht.array.ctypes.data
    hi = lo + ht.array.nbytes
    pages = {}
    try:
        starts = []
        with open("/proc/self/maps") as f:
            for line in f:
                a, b = (int(x, 16) for x in line.split()[0].split("-"))
                if a < hi and b > lo:
                    starts.append(a)
        found = 0
        with open("/proc/self/numa_maps") as f:
            for line in f:
                fields = line.split()
                if int(fields[0], 16) not in starts:
                    continue
                found += 1
                for fld in fields[2:]:
                    if fld[:1] == "N" and "=" in fld:
                        k, v = fld.split("=")
                        pages[k] = pages.get(k, 0) + int(v)
        held = (", ".join(f"{k} {v} pages" for k, v in sorted(pages.items()))
                or "no N<node> fields") + f" ({found} mapping(s))"
    except (OSError, ValueError) as e:
        held = f"not readable ({e})"
    print(f"  link: card {bus} on NUMA node {node} | this process's CPUs "
          f"{cpu_ranges(sorted(os.sched_getaffinity(0)))} | the host "
          f"table's {ht.array.nbytes} B at {lo:#x}: {held}")


# the widths of the f32 tables that ``pitch_probe`` reads: rows of 400,
# 200 and 256 bytes
PITCH_COLS = (100, 50, 64)


def pitch_probe(ids, V, what, torch):
    """The row pitch's effect on the link: bare SM reads (``read_probe``,
    a warp a row, the row's own 16-byte chunks) of the rows ``ids``
    (distinct, sorted, int32 on the card) of registered f32 host tables
    of V rows and PITCH_COLS columns, 128-byte aligned, timed in turns
    (100, 50, 64, 64, 50, 100 columns)."""
    import numpy as np
    from legion_tpu_torch.ops import host_memory
    from legion_tpu_torch.ops.host_memory import HostTable
    tables = {}
    try:
        for c in PITCH_COLS:
            buf = np.full(V * c + 32, 1.0, np.float32)
            at = (-buf.ctypes.data) % 128 // 4
            tables[c] = HostTable(buf[at:at + V * c].reshape(V, c), pin=True)
        ms = {c: [] for c in PITCH_COLS}
        for c in PITCH_COLS + PITCH_COLS[::-1]:
            ms[c].append(cuda_ms(
                lambda: host_memory.read_probe(tables[c], ids, 16), torch,
                10))
        n, out = ids.numel(), {}
        for c in PITCH_COLS:
            rb, base = 4 * c, tables[c].array.ctypes.data
            a = base + ids.long() * rb
            lines = float(((a + rb - 1) // 128 - a // 128 + 1).double()
                          .mean())
            t = statistics.mean(ms[c])
            out[rb] = t
            print(f"  link: {what}: SM reads of {n} distinct rows of {rb} B "
                  f"(base % 128 = {base % 128}, {lines:.3f} lines a row): "
                  f"{', '.join(f'{x:.4f}' for x in ms[c])} ms, mean "
                  f"{t:.4f} | {n * rb / t / 1e6:.2f} GB/s of row bytes, "
                  f"{n * lines / t / 1e3:.1f} M lines/s | "
                  f"{t / out[4 * PITCH_COLS[0]]:.3f} of the 400-B time")
    finally:
        for t in tables.values():
            t.close()


def aligned_table(values, shift, pitch=None):
    """A registered host table of ``values`` ([V, F] f32) whose base lies
    ``shift`` bytes past a 128-byte boundary: the f32 values (``pitch``
    None), or their bf16 rows (``bf16_rows``) at ``pitch``, the pad
    columns filled with bits that a kernel reading them would show."""
    import numpy as np
    from legion_tpu_torch.ops.host_memory import HostTable, bf16_rows
    V, F = values.shape
    src = values if pitch is None else bf16_rows(values, pitch)
    if pitch is not None:
        src[:, F:] = 0x7F81                          # a NaN
    n, es = src.size, src.itemsize
    buf = np.empty(n + 128 // es, src.dtype)
    at = (-buf.ctypes.data) % 128 // es + shift // es
    arr = buf[at:at + n].reshape(src.shape)
    arr[:] = src
    if arr.ctypes.data % 128 != shift:
        fail("edges: a table's base is not where the case wants it")
    return HostTable(arr, pin=True)


# the bf16 tables of K4's and K13's edge cases: widths, bases (bytes past
# a 128-byte boundary), and each width's pitches (the width, and padded:
# to whole lines where bf16_pitch pads, else past them)
EDGE_WIDTHS = (1, 100, 128, 602)
EDGE_BF16_SHIFTS = (0, 16, 8, 2)


def edge_pitches(F):
    return (F, -(-(F + 1) // 64) * 64)


def k4_edges(torch):
    """K4 at the edges of its shapes, rows and hit count exact against the
    plain version: widths 1, 100, 128, 602; f32 host tables whose base is
    128-byte aligned, 16-byte aligned only, and 4-byte aligned only, with
    bf16 and f32 caches; bf16 host tables (a bf16 cache) whose base is
    128-, 16-, 8- and 2-byte aligned, at a pitch of the width and padded
    (``edge_pitches``); every table registered to its last byte; a slot
    map longer than the host table; ids with duplicates, pads, ids past
    the host table and past the slot map, the table's first and last rows
    as misses; all hits; all misses; no ids."""
    import numpy as np
    from legion_tpu_torch.cache.unified_cache import (UnifiedCache,
                                                      cached_gather,
                                                      cached_gather_plain)
    rng = np.random.default_rng(5)
    rows_h, V, C, n = 1000, 1200, 300, 0
    hot = 1 + rng.permutation(rows_h - 2)[:C]       # rows 0 and 999 miss
    cold = np.setdiff1d(np.arange(rows_h), hot)
    slot_map = torch.full((V,), -1, dtype=torch.int32)
    slot_map[torch.from_numpy(hot)] = torch.arange(C, dtype=torch.int32)
    slot_map[V - 1] = 0                     # ids past the map clamp to a hit
    mixed = rng.integers(0, rows_h, 1003)
    mixed[rng.random(1003) < 0.1] = -1
    mixed[:8] = (0, rows_h - 1, rows_h, V - 2, V - 1, V + 5, 2**31 - 1, 0)
    id_sets = {"mixed": mixed, "all hits": rng.choice(hot, 257),
               "all misses": np.concatenate([[0, rows_h - 1],
                                             rng.choice(cold, 94)]),
               "no ids": np.zeros(0)}
    tables = []          # (F, shift, pitch or None: f32, cache dtypes)
    for F in EDGE_WIDTHS:
        tables += [(F, shift, None, (torch.bfloat16, torch.float32))
                   for shift in (0, 16, 4)]
        tables += [(F, shift, P, (torch.bfloat16,))
                   for shift in EDGE_BF16_SHIFTS for P in edge_pitches(F)]
    for F, shift, P, dts in tables:
        vals = rng.standard_normal((rows_h, F), dtype=np.float32)
        ht = aligned_table(vals, shift, P)
        kind = "f32" if P is None else f"bf16 pitch {P}"
        for dt in dts:
            cache = UnifiedCache(
                torch.from_numpy(vals[hot]).to(dt).cuda(),
                slot_map.cuda(), None, None, None, C, 0)
            for what, ids in id_sets.items():
                ids = torch.from_numpy(ids.astype(np.int32)).cuda()
                k, kh = cached_gather(cache, ht, ids)
                p, ph = cached_gather_plain(cache, ht.device, ids)
                if not exact(k, p)[1] or int(kh) != int(ph):
                    fail(f"cached_gather edge F {F} {kind} table base % 128"
                         f" = {shift} {dt} cache {what}: kernel differs "
                         f"from its plain version (hits {int(kh)} / "
                         f"{int(ph)})")
                n += 1
        torch.cuda.synchronize()
        ht.close()
    print(f"  cached_gather  {n} edge cases (widths 1/100/128/602; f32 "
          f"tables at bases 128-/16-/4-byte aligned, bf16 and f32 caches; "
          f"bf16 tables at bases 128-/16-/8-/2-byte aligned, pitch the "
          f"width and padded; mixed ids / all hits / all misses / no ids): "
          f"all exact")


def phase_host_reference(torch):
    """Phase 7: a small HT slice, card against CPU: the same presampled
    hotness gives the same plan and caches, then as ``compare_slices``."""
    from dataclasses import replace
    from legion_tpu_torch.data import synthesize_dataset
    from legion_tpu_torch.train import Trainer
    small = synthesize_dataset(num_nodes=20_000, avg_degree=20,
                               feature_dim=100, num_classes=32,
                               batch_size=256, train_frac=0.08, seed=3)
    cfg = bench_config(small, cache_bytes=1_600_000,
                       feature_residency="host", topo_residency="host")
    cfg = replace(cfg, sampler=replace(cfg.sampler, batch_size=256),
                  train=replace(cfg.train, dropout=0.0))
    trs = [Trainer(small, cfg, device="cpu"), Trainer(small, cfg, "cuda")]
    plans = [(t.cache_plan.feature_capacity, t.cache_plan.topo_capacity,
              t.cache_plan.alpha) for t in trs]
    print(f"  plan (feature rows, topology rows, alpha): cpu {plans[0]}, "
          f"gpu {plans[1]}")
    if plans[0] != plans[1]:
        fail("small HT: the card's plan differs from the CPU's")
    for name in ("slot_map", "row_map"):
        a, b = (getattr(t.cache, name) for t in trs)
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a, b.cpu())):
            fail(f"small HT: cache {name} differs")
    compare_slices(trs, torch, "small HT")
    trs[1].close()


# the launcher's flags in phase 8 (bench.py --features host widths)
CLI_ARGS = ("--features", "host", "--cache-memory", str(CACHE_BYTES),
            "--train-batch-size", "8000", "--fanout", "25", "10",
            "--hidden", "256")


class BatchAt:
    """Records, through the launcher, the train batch sampled at counter
    ``ctr`` in each run (``label``, set before the run: ids and per-hop
    edge counts, copied on the card) and the counter of each run's first
    train batch: a wrapper around ``Trainer._sample_fetch``, which a train
    step calls with the train sampler before it advances the host
    counter."""

    def __init__(self, ctr):
        from legion_tpu_torch.train import Trainer
        self.ctr, self.label, self.at, self.first = ctr, None, {}, {}
        self._orig = orig = Trainer._sample_fetch

        def sample_fetch(tr, state, sampler, seeds, keys):
            out = orig(tr, state, sampler, seeds, keys)
            if sampler is tr.sampler_t:
                self.first.setdefault(self.label, state["train_ctr"])
                if state["train_ctr"] == self.ctr:
                    self.at.setdefault(self.label, []).append(
                        (out[0].node_ids.clone(), out[0].num_edges.clone()))
            return out
        Trainer._sample_fetch = sample_fetch

    def close(self):
        from legion_tpu_torch.train import Trainer
        Trainer._sample_fetch = self._orig


def memmap_probe(path):
    """What a plain ``cudaHostRegister`` returns for a
    copy-on-write mapping of a file (``np.memmap`` mode "c") of the whole
    features file, and how long it takes: a record, not a path of the port
    (which copies read-only tables into RAM). Never fails."""
    import ctypes

    import numpy as np
    from legion_tpu_torch.ops import kernels
    mm = np.memmap(path, np.float32, mode="c")
    dev = ctypes.c_void_p()
    t0 = time.perf_counter()
    rc = kernels.lib().lt_host_register(mm.ctypes.data, mm.nbytes,
                                        ctypes.byref(dev))
    dt = time.perf_counter() - t0
    if rc == 0:
        kernels.lib().lt_host_unregister(mm.ctypes.data)
    print(f"  memmap_probe: cudaHostRegister of a mode 'c' memmap of "
          f"{mm.nbytes} bytes: {kernels.lib().lt_error_string(rc).decode()}"
          f" ({rc}) in {dt:.3f} s")
    del mm


def cli_run(argv, torch, label):
    """One ``legion_tpu_torch.run.main`` call on the card, in process:
    fails on a non-finite loss or a valid accuracy outside [0, 1]. Returns
    the trainer (closed: its host tables unpinned), the state, the epoch
    stats and the kernels' launch counts of the run."""
    from legion_tpu_torch import run
    from legion_tpu_torch.ops import kernels
    print(f" {label}: python -m legion_tpu_torch.run " + " ".join(argv))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr, state, stats = run.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    host = tr.feature_source.host
    if host.device is None or not host.array.flags.writeable:
        fail(f"{label}: the host feature table is not registered RAM")
    # a bf16 cache: the host table is the features' bf16 rows, built in
    # RAM from the memmap, which is never copied whole
    if tr.setup_s["ram_copy_bytes"] != 0 or host.host.dtype != \
            torch.bfloat16 or tr.setup_s["bf16_table_bytes"] != \
            host.array.nbytes:
        fail(f"{label}: set-up {tr.setup_s}, a host table of "
             f"{host.host.dtype}: not the bf16 table alone")
    tr.close()
    for st, sm in zip(stats, tr.epoch_metrics):
        if not (math.isfinite(st.train_loss) and 0.0 <= st.valid_acc <= 1.0):
            fail(f"{label}: epoch {st.epoch} loss {st.train_loss}, valid acc "
                 f"{st.valid_acc}")
        print(f"  {label} epoch {st.epoch}: {st.seconds:.3f} s (train "
              f"{sm.seconds / sm.steps * 1e3:.3f} ms/step over {sm.steps} "
              f"steps) | loss {st.train_loss!r} | valid acc "
              f"{st.valid_acc:.4f} | trained edges/s {sm.edges_per_s:.1f} | "
              f"feature hit rate {sm.hit_rate:.4f}")
    print(f"  {label}: {secs:.3f} s in all | set-up {fmt_setup(tr.setup_s)}"
          f" | caps {tr.compact_caps} | train_ctr {state['train_ctr']}")
    return tr, state, stats, counts


def cli_dataset(hds, tmp):
    """Phase 5's host dataset written in Legion's layout under ``tmp``,
    loaded once as the launcher loads it; returns its directory."""
    from legion_tpu_torch.data import (LegionDataset, infer_meta,
                                       write_legion_dataset)
    d = os.path.join(tmp, "dataset")
    t0 = time.perf_counter()
    write_legion_dataset(d, hds.graph, hds.features, hds.labels,
                         hds.train_ids, hds.valid_ids, hds.test_ids)
    t1 = time.perf_counter()
    meta = infer_meta(d, batch_size=8000)
    LegionDataset.load(meta)
    t2 = time.perf_counter()
    wrote = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"  dataset on disk: {wrote} bytes written in {t1 - t0:.3f} s "
          f"| infer_meta + load (memmaps) {t2 - t1:.3f} s | V "
          f"{meta.num_nodes} E {meta.num_edges} F {meta.feature_dim} "
          f"classes {meta.num_classes} train {meta.train_size}")
    return d


def phase_cli(d, tmp, torch, h_step_ms):
    """Phase 8: the launcher from a dataset on disk. Takes phase 5's host
    dataset in Legion's layout in ``d`` (``cli_dataset``) and
    trains GraphSAGE at full width in host mode through
    ``legion_tpu_torch.run.main`` (the memmaps copied into RAM and
    registered, a 200 MB cache, misses read by K4): B1 one epoch with a
    checkpoint, A two epochs unbroken, B2 one epoch resumed from B1's
    checkpoint in a fresh trainer. Fails unless every run's losses are
    finite and its valid accuracy in [0, 1], A launched every kernel of
    ``PATH_KERNELS["cli"]``, B2's first batch has exactly the ids and edge
    counts of A's batch at the same counter, and B2's epoch loss and
    parameters agree with A's second epoch within ``phase_fused``'s
    tolerance (K2's f32 atomics). Then restores B1's checkpoint into a
    fresh trainer three times: ``FUSED_K`` steps as one fused call (a
    first capture), as eager steps, and fused again (a capture after
    one); the fused calls must equal the eager steps in every sampled id
    and dropout mask, and in loss and parameters within the same
    tolerance. Prints each run's set-up by stage (the RAM copy's seconds
    and bytes among them) and epochs, and the checkpoint's size and its
    save and restore seconds."""
    from legion_tpu_torch import run
    from legion_tpu_torch.data import LegionDataset
    from legion_tpu_torch.train import Trainer
    from legion_tpu_torch.utils import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    ck = os.path.join(tmp, "ckpt")
    memmap_probe(os.path.join(d, "features"))
    base = ["--dataset-name", "custom", "--dataset-path", d, *CLI_ARGS]
    rec = None
    try:
        tr, st, _, _ = cli_run(
            base + ["--epoch", "1", "--checkpoint-dir", ck], torch, "B1")
        n = st["train_ctr"]
        if latest_step(ck) != n:
            fail(f"B1: latest checkpoint {latest_step(ck)}, not {n}")
        del tr, st
        torch.cuda.empty_cache()
        rec = BatchAt(n)
        rec.label = "A"
        tr, st, stats_a, counts = cli_run(base + ["--epoch", "2"],
                                          torch, "A")
        params_a = [p.detach().clone()
                    for p in st["model"].parameters()]
        ms_a = tr.epoch_metrics[1].seconds / tr.epoch_metrics[1].steps \
            * 1e3
        del tr, st
        torch.cuda.empty_cache()
        rec.label = "B2"
        tr, st, stats_b, _ = cli_run(
            base + ["--epoch", "1", "--resume", "--checkpoint-dir", ck],
            torch, "B2")
        params_b = [p.detach() for p in st["model"].parameters()]
    finally:
        if rec is not None:
            rec.close()
    print("  launches of run A: "
          f"{ {k: v for k, v in counts.items() if v} }")
    for name in PATH_KERNELS["cli"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the launcher run")
    if counts["dedup_map"]:
        fail("the launcher's sort-dedup run launched dedup_map")
    seen = {k: len(v) for k, v in rec.at.items()}
    if rec.first != {"A": 0, "B2": n} or seen != {"A": 1, "B2": 1}:
        fail(f"first train batches at {rec.first}, batches at train_ctr "
             f"{n} {seen}: want A at 0, B2 at {n}, one each")
    (ids_a, e_a), (ids_b, e_b) = rec.at["A"][0], rec.at["B2"][0]
    if not (torch.equal(ids_a, ids_b) and torch.equal(e_a, e_b)):
        fail(f"B2's first batch differs from A's batch at train_ctr {n}")
    l_a, l_b = stats_a[1].train_loss, stats_b[0].train_loss
    l_rel = abs(l_b - l_a) / abs(l_a)
    p_rel = rel_norm(params_b, params_a)
    print(f"  resume: B2's first batch equals A's at train_ctr {n} "
          f"({int(e_a.sum())} edges) | epoch loss B2 {l_b!r} vs A's "
          f"second {l_a!r} (rel {l_rel:.3g}, tol 1e-3) | parameters "
          f"norm-wise rel {p_rel:.3g} (tol 2e-3) | A's second epoch "
          f"{ms_a:.3f} ms/step from disk, phase 6's H from memory "
          f"{h_step_ms:.3f} ms/step (one call; no claim)")
    if not (l_rel <= 1e-3 and p_rel <= 2e-3):
        fail(f"resume: B2 differs from A's second epoch beyond "
             f"tolerance (loss rel {l_rel}, parameters rel {p_rel})")
    del tr, st, params_b
    torch.cuda.empty_cache()

    cfg = run.build_config(run.parse_args(base + ["--epoch", "1"]))
    tr = Trainer(LegionDataset.load(cfg.dataset), cfg, "cuda")
    rec = StepRecorder(tr, torch, FUSED_K)
    out, restore_s = {}, []
    try:
        for label, K in (("fused", FUSED_K), ("eager", 1),
                         ("fused again", FUSED_K)):
            t0 = time.perf_counter()
            state = restore_checkpoint(ck, tr, step=n)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            rec.bind(state)
            tr.fused_steps = K
            loss = float(torch.stack([tr.train_step(state)[1]
                                      for _ in range(FUSED_K // K)])
                         .mean())
            if state["train_ctr"] != n + FUSED_K or \
                    int(state["train_ctr_d"]) != n + FUSED_K:
                fail(f"restore + {label}: counters {state['train_ctr']}"
                     f" / {int(state['train_ctr_d'])}, not "
                     f"{n + FUSED_K}")
            out[label] = (loss, [p.detach().clone()
                                 for p in state["model"].parameters()],
                          rec.take(), tr._graph,
                          dict(tr.graph_launches))
            if label == "eager":
                ck2 = os.path.join(tmp, "ckpt2")
                t0 = time.perf_counter()
                save_checkpoint(ck2, state, state["train_ctr"])
                save_s = time.perf_counter() - t0
                size = sum(os.path.getsize(os.path.join(ck2, f))
                           for f in os.listdir(ck2))
    finally:
        rec.close()
        tr.fused_steps = 1
    tr.close()
    le, pe, (ids_e, edges_e, masks_e), _, _ = out["eager"]
    for label in ("fused", "fused again"):
        lf, pf, (ids_f, edges_f, masks_f), _, launches = out[label]
        if not (torch.equal(ids_e, ids_f) and torch.equal(edges_e,
                                                          edges_f)):
            fail(f"restore + {label}: a replayed step sampled other ids "
                 "than the eager steps from the same checkpoint")
        if not torch.equal(masks_e, masks_f):
            fail(f"restore + {label}: a replayed step's dropout masks "
                 "differ from the eager steps'")
        l_rel = abs(lf - le) / abs(le)
        p_rel = rel_norm(pf, pe)
        print(f"  restore + {label} (K {FUSED_K}) against {FUSED_K} "
              f"eager steps: ids, edge counts and dropout masks exact | "
              f"loss {lf!r} vs {le!r} (rel {l_rel:.3g}) | parameters "
              f"rel {p_rel:.3g}")
        if not (l_rel <= 1e-3 and p_rel <= 2e-3):
            fail(f"restore + {label}: loss (rel {l_rel}) or parameters "
                 f"(rel {p_rel}) beyond tolerance")
        for name in PATH_KERNELS["cli"]:
            if launches.get(name, 0) <= 0:
                fail(f"restore + {label}: the captured step launched "
                     f"no {name}")
    if out["fused again"][3] is out["fused"][3]:
        fail("a restored state replayed the graph captured for "
             "another state")
    print(f"  checkpoint: {size} bytes | save {save_s:.3f} s | restore "
          f"{', '.join(f'{x:.3f}' for x in restore_s)} s")
    del tr, out
    torch.cuda.empty_cache()


def kernel_symbol(name, key):
    """Whether the profiler's kernel name ``key`` is a device function of
    the launch count ``name`` (``<kernel>_bwd`` names the backward; a
    ``symbol`` in ``KERNELS`` names the device functions of its own)."""
    base, bwd = (name[:-4], True) if name.endswith("_bwd") else (name, False)
    sym = KERNELS.get(name, {}).get("symbol")
    if sym is not None:
        return sym in key
    return base in key and ("bwd" in key) == bwd


def profile_run(tr, torch, name, K):
    """One run of ``phase_profile`` with ``fused_steps = K`` from a fresh
    state: warm-up calls (the capture among them), three unprofiled runs
    of at least 10 steps (ms a step by the host clock ending in a sync,
    and the host's microseconds a step before that sync), then at least 5
    steps under ``torch.profiler``, peak memory since the state was made
    (the graph's private pool included), and for K > 1 the host's
    microseconds a bare graph replay. Fails if a fused run's profile lacks
    a kernel of ``PATH_KERNELS[name]`` by its device symbol, or if a step
    calls ``torch.cummax`` (the plain sort dedup)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr.fused_steps = K
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = -(-10 // K)
    for _ in range(-(-5 // K)):
        state, _ = tr.train_step(state)
    torch.cuda.synchronize()
    runs, host = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            state, _ = tr.train_step(state)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / (calls * K) * 1e3)
        host.append((t1 - t0) / (calls * K) * 1e6)
    pcalls = -(-5 // K)
    steps = pcalls * K
    # K1's ids a call in the profiled steps (a replay runs no Python)
    from legion_tpu_torch.ops import kernels
    k1, k1_ids = kernels.gather_rows, []

    def gather_rows(table, ids, out=None):
        k1_ids.append(ids.shape[0])
        return k1(table, ids, out)
    kernels.gather_rows = gather_rows
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pcalls):
                state, _ = tr.train_step(state)
            torch.cuda.synchronize()
    finally:
        kernels.gather_rows = k1
    peak_b = torch.cuda.max_memory_allocated()
    peak = peak_b / 2 ** 30
    # the host's time of one replay on an idle queue (many queued replays
    # would wait for room in the launch queue); the last, since replays
    # outside train_step advance the device counter alone
    replay = None
    if K > 1:
        takes = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._graph.replay()
            takes.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        replay = sorted(takes)[len(takes) // 2]
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_card)
    span = (max(e.time_range.end for e in on_card)
            - min(e.time_range.start for e in on_card))
    print(f" {name} fused_steps {K}: unprofiled ms/step "
          + ", ".join(f"{r:.3f}" for r in runs)
          + " | host us/step before the sync "
          + ", ".join(f"{h:.1f}" for h in host)
          + f" | profiled: kernels {busy / steps / 1e3:.3f} ms/step over a "
          f"span of {span / steps / 1e3:.3f} ms/step (idle share "
          f"{1 - busy / span:.3f}), {len(on_card) / steps:.0f} kernels and "
          f"copies a step | peak mem {peak:.2f} GiB "
          f"({peak_b / 1e6:.1f} MB)"
          + ("" if replay is None else
             f" | host us a replay (median of 20) {replay:.1f}"))

    if K == 1:
        print(f"    K1's ids a call in the profiled steps: "
              f"{sorted(set(k1_ids))} ({len(k1_ids) / steps:g} calls a "
              "step)")
        state = peak_owners(tr, state, torch, name)
        if name in ("device", "gcn", "lp_sage"):
            k16_host_us(tr, state, torch, name)

    def per_step(r):
        return r.self_device_time_total / steps / 1e3

    rows = prof.key_averages()
    if K == 1:
        ops = sorted((r for r in rows if r.device_type == DeviceType.CPU
                      and r.self_device_time_total > 0),
                     key=lambda r: -r.self_device_time_total)[:12]
        for r in ops:
            print(f"    {r.key[:48]:48s} {per_step(r):8.3f} ms/step "
                  f"({r.count / steps:g} calls)")
    mine = {}     # the port's kernels by launch-count name
    for r in rows:
        if r.device_type != DeviceType.CUDA:
            continue
        for n in KERNELS:
            for cand in (n, n + "_bwd"):
                if kernel_symbol(cand, r.key):
                    t, c = mine.get(cand, (0.0, 0))
                    mine[cand] = (t + per_step(r), c + r.count / steps)
    print(f"    {name} fused_steps {K} kernels ms/step (launches): "
          + ", ".join(f"{n} {t:.4f} ({c:g})" for n, (t, c) in mine.items()))
    for r in rows:
        if r.key == "aten::sort" and r.device_type == DeviceType.CPU:
            print(f"    the sort dedup's torch.sort: {per_step(r):.3f} "
                  f"ms/step ({r.count / steps:g} calls)")
    if any("cummax" in r.key for r in rows):
        fail(f"{name}: a train step called torch.cummax (the plain sort "
             "dedup)")
    if K > 1:
        keys = [r.key for r in rows if r.device_type == DeviceType.CUDA]
        missing = [n for n in PATH_KERNELS[name]
                   if not any(kernel_symbol(n, k) for k in keys)]
        if missing:
            fail(f"{name} fused_steps {K}: the replays' profile lists no "
                 f"kernel of {missing}")
        print(f"    every kernel of {name} runs inside the replays: "
              f"{', '.join(PATH_KERNELS[name])}")
    tr.fused_steps = 1


def repo_frame(frames):
    """The innermost frame of an allocation's Python stack in the port
    (``file:line function``), else its innermost frame."""
    for f in frames:
        if "legion_tpu_torch" in f["filename"]:
            return (f"{f['filename'].split('legion_tpu_torch/')[-1]}:"
                    f"{f['line']} {f['name']}")
    return (f"{frames[0]['filename'].rsplit('/', 1)[-1]}:{frames[0]['line']} "
            f"{frames[0]['name']}") if frames else "no Python frame (autograd)"


def peak_at(events, base):
    """Replay an allocator trace (``torch.cuda.memory._snapshot()``'s
    device trace: ``alloc`` adds a block, ``free_completed`` takes it back,
    as ``memory_allocated`` counts them) from ``base`` bytes: the peak, the
    event index where it falls, and the blocks allocated in the trace that
    are live there, {addr: event}."""
    live, cur, peak, at, held = {}, base, base, -1, {}
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
        else:
            continue
        if cur > peak:
            peak, at, held = cur, i, dict(live)
    return peak, at, held


def peak_owners(tr, state, torch, name, top=8):
    """One more train step with the allocator's history recorded: where
    its peak of allocated memory falls (the allocation that reached it, by
    its innermost frame in the port) and the blocks of the step that are
    live there, summed by that frame, largest first; what was allocated
    before the step (the dataset, the state) is one line. Returns the
    step's state."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        state, _ = tr.train_step(state)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][torch.cuda.current_device()]
    peak, at, held = peak_at(events, base)
    by = {}
    for e in held.values():
        k = repo_frame(e.get("frames") or [])
        n, b = by.get(k, (0, 0))
        by[k] = (n + 1, b + e["size"])
    reached = repo_frame(events[at].get("frames") or []) if at >= 0 else \
        "no allocation of the step"
    print(f"    {name} peak of one step {peak / 1e6:.1f} MB ({base / 1e6:.1f}"
          f" MB held before the step), reached at {reached}; the step's "
          f"blocks live there ({len(held)}, "
          f"{sum(b for _, b in by.values()) / 1e6:.1f} MB), by frame: "
          + "; ".join(f"{k} {b / 1e6:.1f} MB ({n})" for k, (n, b) in
                      sorted(by.items(), key=lambda kv: -kv[1][1])[:top]))
    return state


def k16_host_us(tr, state, torch, name, calls=200):
    """The host's microseconds of one K16 call at the path's layer 0 as
    its step makes it (``dropout_act``: ReLU, the cast, the path's rate,
    forward and backward under autograd), ``calls`` calls and a sync (few
    enough that the launch queue never fills); the same call in the
    parent's package in turns reads what the step's host pays for K16."""
    from legion_tpu_torch.ops import dropout as kd
    S = tr.sampler_t.config.cum_sizes()
    tc = tr.config.train
    cdt = getattr(state["model"], "cdt", None)
    words = torch.tensor(K16_WORDS, dtype=torch.int32, device="cuda")
    x = torch.randn((S[1], tc.hidden_dim), device="cuda").requires_grad_()
    dy = torch.randn((S[1], tc.hidden_dim), device="cuda").to(cdt or x.dtype)

    def call():
        y = kd.dropout_act(x, "relu", cdt, tc.dropout, words, 0)
        torch.autograd.grad(y, x, dy)
    takes = [host_us(call, torch, calls) for _ in range(3)]
    print(f"    {name} K16 fwd + bwd at layer 0, host us a call "
          f"({calls} calls, 3 takes): "
          + ", ".join(f"{t:.1f}" for t in takes))


def phase_profile(names, torch, fused=("1",)):
    """Where a train step's device time goes on the named paths, for each
    ``fused_steps`` of ``fused`` in turn on one trainer a path (an A/B
    inside one call: 1,4,E,E,4,1 takes K = 4 and K = E, the epoch's
    ``train_step``, between runs of single steps); see ``profile_run``.
    The profiler's busy time is the kernels' summed device time and its
    span runs from the first kernel's start to the last one's end; what is
    left of the span is the device's idle time, an upper bound, since the
    profiler slows the host. For single steps it also lists the largest
    device costs by the torch op that launched them."""
    from legion_tpu_torch.data import (synthesize_dataset,
                                       synthesize_device_dataset)
    from legion_tpu_torch.train import Trainer
    host_kw = {"H": dict(cache_bytes=CACHE_BYTES, feature_residency="host"),
               "HT": dict(cache_bytes=CACHE_BYTES, feature_residency="host",
                          topo_residency="host"), "cache-off": {},
               "gat-H": GAT_H}
    clique_kw = {"clique-HT": {}, "clique-H": dict(topo_residency="hbm")}
    ds = hds = None
    for name in names:
        if name in clique_kw:
            hds = hds or synthesize_dataset(
                num_nodes=HOST_NODES, avg_degree=HOST_AVG_DEGREE,
                feature_dim=100, num_classes=32, batch_size=8000,
                train_frac=0.08, seed=0)
            tr = Trainer(hds, clique_config(hds, CLIQUE_BYTES,
                                            **clique_kw[name]), "cuda")
        elif name in host_kw:
            hds = hds or synthesize_dataset(
                num_nodes=HOST_NODES, avg_degree=HOST_AVG_DEGREE,
                feature_dim=100, num_classes=32, batch_size=8000,
                train_frac=0.08, seed=0)
            tr = Trainer(hds, bench_config(hds, **host_kw[name]), "cuda")
        else:
            ds = ds or synthesize_device_dataset("cuda")
            model = "graphsage" if name.startswith("device") else name
            tr = Trainer(ds, bench_config(
                ds, model=model,
                dedup="map" if name == "device-map" else "sort"), "cuda")
        for k in fused:
            profile_run(tr, torch, name,
                        tr.schedule.train_step if k == "E" else int(k))
        tr.close()
        del tr
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The clique caches: Kg members on one card (phase 9)
# ---------------------------------------------------------------------------

CLIQUE_KG = 4
CLIQUE_BYTES = 50_000_000     # a member's: a group of 200 MB, H's budget
CLIQUE_STEPS = 10
CLIQUE_AB_STEPS = 3           # the hash and clique-H runs, each side


def clique_config(ds, cache_bytes, topo_residency="host",
                  map_impl="direct", feature_residency="host",
                  host_transfer="auto"):
    """The bench configuration (batch 8000 a member, [25,10], hidden 256,
    bf16, sort dedup with the aligned last hop) for a clique of
    CLIQUE_KG members on the card."""
    from dataclasses import replace
    from legion_tpu_torch.config import MeshConfig
    cfg = bench_config(ds, cache_bytes=cache_bytes,
                       feature_residency=feature_residency,
                       topo_residency=topo_residency,
                       host_transfer=host_transfer)
    return replace(cfg, cache=replace(cfg.cache, map_impl=map_impl),
                   mesh=MeshConfig(num_cliques=1, clique_size=CLIQUE_KG))


def clique_trainer(hds, torch):
    """clique-HT's trainer at CLIQUE_BYTES a member; if its plan gives the
    feature or the topology cache fewer than Kg rows, trainers at twice
    the budget, and twice again, until one's plan gives both Kg rows.
    Returns (trainer, a member's budget)."""
    from legion_tpu_torch.train import Trainer
    budget = CLIQUE_BYTES
    while True:
        t0 = time.perf_counter()
        tr = Trainer(hds, clique_config(hds, budget), device="cuda")
        p = tr.cache_plan
        group = budget * CLIQUE_KG
        print(f"  clique-HT at {budget} B a member (group {group} B): "
              f"set-up {time.perf_counter() - t0:.2f} s "
              f"({fmt_setup(tr.setup_s)}) | plan: alpha {p.alpha:.2f}, "
              f"feature rows {p.feature_capacity}, topology rows "
              f"{p.topo_capacity} (group totals)")
        if min(p.feature_capacity, p.topo_capacity) >= CLIQUE_KG:
            return tr, budget
        tr.close()
        del tr
        torch.cuda.empty_cache()
        budget *= 2
        if budget > 2 ** 40:
            fail("clique-HT: no budget gives both caches Kg rows")


def clique_batch(tr, torch, ctr=0):
    """The pieces of one clique-HT train batch, as ``Trainer._step_body``
    makes them: every member's seeds and key words at counter ``ctr``,
    each hop's frontiers [Kg, F_k] with their routing, owners' requests and
    misses' host draws, the fetch's ids [Kg, max_ids], and the ids of the
    counters' one topology-map lookup (``train.py::topo_count_len``)."""
    from legion_tpu_torch.cache.hashmap import map_lookup
    from legion_tpu_torch.train import topo_count_len
    s, acc, fs = tr.sampler_t, tr.graph_access, tr.feature_source
    state = {"base_key": torch.full((), tr.config.train.seed + 1,
                                    dtype=torch.int64, device="cuda"),
             "train_ctr_d": torch.full((), ctr, dtype=torch.int64,
                                       device="cuda"),
             "pos_map": tr._init_pos_map()}
    seeds, _, keys, _ = tr._member_inputs(state, s, tr.train_bank,
                                          tr.train_ybank,
                                          tr.schedule.train_step,
                                          "train_ctr", 0)
    hops = []
    carries = [s._begin(seeds[d], None, register=True)
               for d in range(CLIQUE_KG)]
    for k in range(s.config.num_hops):
        fo = s.config.fanouts[k]
        fr = torch.stack([s.hop_frontier(c, k) for c in carries])
        req, row, _ = acc.route(fr)
        miss = torch.where(row >= 0, -1, fr)
        fill = torch.stack([acc.fallback.sample_neighbors(f, fo, kw)
                            for f, kw in zip(miss, keys[:, k])])
        hops.append(dict(frontier=fr, fanout=fo, keys=keys[:, k].contiguous(),
                         slot=map_lookup(acc.row_map, fr), req=req, row=row,
                         recv=acc.to_owners(req), fill=fill))
        cand = acc.sample_neighbors(fr, fo, keys[:, k])
        carries = [s._absorb(c, k, cand[d], False)
                   for d, c in enumerate(carries)]
    done = [s._finish(c, clear=False).node_ids for c in carries]
    ids = torch.stack([d[:s.max_ids] for d in done])
    n = topo_count_len(s, CLIQUE_KG, done[0].shape[0])
    slot = map_lookup(fs.slot_map, ids)
    req, row, _ = fs.route(ids)
    return hops, dict(ids=ids, slot=slot, req=req, row=row,
                      back=fs._rows_back(req),
                      count_ids=torch.stack([d[:n] for d in done]))


def all_exact(name, got, ref, what, torch):
    """Every output of a kernel's call equal to its plain version's."""
    for a, b in zip(got, ref):
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"{name} {what}: kernel differs from its plain version")


def hash_bound(m, ids, torch):
    """K11's bytes for these ids: each id read and each value written once,
    each bucket row that the early-ending probe reads (32 bytes) once, and
    a value read for each hit."""
    mask = m.n_buckets - 1
    safe = ids.clamp(min=0).long()
    b0 = (safe * 0x9E3779B1) & 0xFFFFFFFF & mask
    active = ids >= 0
    seen, hits = [], 0
    for p in range(m.probes):
        b = (b0 + p) & mask
        seen.append(b[active])
        krow = m.keys[b]
        found = (krow == ids[..., None]).any(-1) & active
        hits += int(found.sum())
        active = active & ~found & ~(krow < 0).any(-1)
    rows = int(torch.cat(seen).unique().numel())
    return bound(8 * ids.numel() + 32 * rows + 4 * hits)


PARENT = os.path.join(ROOT, "_archive", "parent")


def k11_builds(parent=False):
    """K11's kernels to time in turns, by name: with ``parent`` (``--clique-
    kernels`` only) the parent's (its ``hash_lookup.cu`` from a ``git
    archive`` of the parent commit in ``_archive/parent``, where one is
    unpacked: the old [B, 8] keys and values, built from source with
    kernels.NVCC_FLAGS into a library of its own and called on contiguous
    copies of the map's halves), then "tree", the package's own. Returns
    {name: make(map) -> fn(ids) -> values}. A full run times the tree's
    kernel alone, whatever ``_archive`` holds."""
    import ctypes
    from legion_tpu_torch.ops import kernels
    makers = {}
    src = os.path.join(PARENT, "legion_tpu_torch", "csrc", "hash_lookup.cu")
    if parent and os.path.exists(src):
        out = os.path.join(str(kernels.BUILD_DIR), "k11")
        os.makedirs(out, exist_ok=True)
        so_path = os.path.join(out, "k11_parent.so")
        t0 = time.perf_counter()
        kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           "-o", so_path, src]])
        print(f"  K11: built the parent's kernel in "
              f"{time.perf_counter() - t0:.2f} s")
        fn = ctypes.CDLL(so_path).lt_hash_lookup
        fn.restype = ctypes.c_int
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        fn.argtypes = [p, p, i64, i32, p, i64, p, p]

        def parent(m):
            import torch
            keys, vals = m.keys.contiguous(), m.vals.contiguous()

            def call(ids):
                o = torch.empty_like(ids)
                rc = fn(keys.data_ptr(), vals.data_ptr(), m.n_buckets,
                        m.probes, ids.data_ptr(), ids.numel(), o.data_ptr(),
                        kernels.stream_handle())
                if rc != 0:
                    fail(f"hash_lookup parent: launch failed ({rc})")
                return o
            call.keep = (keys, vals)
            return call
        makers["parent"] = parent
    else:
        print("  K11: the tree's kernel alone (the parent's in turns only "
              "under --clique-kernels with _archive/parent)")
    makers["tree"] = lambda m: m.lookup
    return makers


def kernel_turns(name, what, fns, ref, tol, least, torch):
    """One kernel's forms at one shape (``fns`` {label: call}): each held
    against ``ref`` (its plain version's output) with ``tol``, then timed
    in turns (the labels, then back: parent, tree, tree, parent), as the
    host launches them and queued, with the share of ``least`` queued."""
    for lb, fn in fns.items():
        err, ok = tol(fn(), ref)
        if not ok:
            fail(f"{name} {lb} {what}: differs from its plain version "
                 f"(max abs err {err})")
    got = {lb: [] for lb in fns}
    for lb in list(fns) + list(fns)[::-1]:
        got[lb].append((cuda_ms(fns[lb], torch), queued_ms(fns[lb], torch)))
    print(f"  {name} turns, {what}: bound {least[0]:.4f} ms")
    for lb, v in got.items():
        q = [b for _, b in v]
        print(f"    {lb:12s} launched {', '.join(f'{a:.4f}' for a, _ in v)}"
              f" | queued {', '.join(f'{b:.4f}' for b in q)} ms (share "
              f"{least[0] / min(q):.3f})")


def k11_turns(what, m, ids, ref, least, builds, torch):
    """K11 at one shape: every kernel of ``builds`` exact against ``ref``
    (the plain version's values), then each timed in turns
    (``kernel_turns``)."""
    fns = {k: make(m) for k, make in builds.items()}
    kernel_turns("hash_lookup", what, {
        k: (lambda fn=fn: fn(ids)) for k, fn in fns.items()}, ref, exact,
        least, torch)


# the uk2014-sized feature map (tests/test_torch_hashmap.py's sizing:
# 30M cached feature rows of V 787,801,471) and the fetch's shares at
# clique-HT-hash: hits, absent ids, -1 pads at each member's tail
UK_V, UK_KEYS = 787_801_471, 30_000_000
UK_HIT, UK_PAD = 0.52, 0.035


def uk2014_map(torch, n_ids):
    """The map: UK_KEYS keys without repeats in [0, UK_V) (the unique of 3%
    more draws, trimmed at random), values ``arange``, built by
    ``HashMap32.build`` at load 0.5, moved to the card. The queries [Kg,
    n_ids]: each member's ids ascending (as sort dedup leaves them),
    UK_HIT of them keys, the rest absent ids but UK_PAD -1 pads at the
    tail. Both come from a fixed seed; the first run saves the table, its
    probes and the queries under ``legion_tpu_torch/_build/`` and a later
    run in the same checkout loads them (the numpy build takes 80-105 s)."""
    import numpy as np
    from legion_tpu_torch.cache.hashmap import HashMap32
    from legion_tpu_torch.ops import kernels
    seed = 2014
    path = os.path.join(str(kernels.BUILD_DIR),
                        f"uk2014_map_{seed}_{UK_KEYS}_{CLIQUE_KG}x{n_ids}.npz")
    t0 = time.perf_counter()
    if os.path.exists(path):
        with np.load(path) as z:
            table, probes, q = z["table"], int(z["probes"]), z["ids"]
        how = f"loaded from {os.path.relpath(path, ROOT)}"
    else:
        rng = np.random.default_rng(seed)
        keys = np.unique(rng.integers(0, UK_V, UK_KEYS * 103 // 100))
        if len(keys) < UK_KEYS:
            fail(f"uk2014 map: {len(keys)} distinct keys drawn")
        keys = rng.permutation(keys)[:UK_KEYS]
        built = HashMap32.build(keys, np.arange(UK_KEYS, dtype=np.int32),
                                load=0.5)
        table, probes = built.table.numpy(), built.probes
        sk = np.sort(keys)
        n_pad = round(UK_PAD * n_ids)
        n_hit = round(UK_HIT * n_ids)
        n_abs = n_ids - n_pad - n_hit
        rows = []
        for _ in range(CLIQUE_KG):
            hit = keys[rng.choice(UK_KEYS, n_hit, replace=False)]
            cand = np.unique(rng.integers(0, UK_V, n_abs * 11 // 10))
            at = np.minimum(np.searchsorted(sk, cand), UK_KEYS - 1)
            cand = cand[sk[at] != cand]
            cand = cand[rng.permutation(len(cand))[:n_abs]]
            if len(cand) < n_abs:
                fail("uk2014 queries: too few absent ids drawn")
            rows.append(np.concatenate([
                np.sort(np.concatenate([hit, cand])), np.full(n_pad, -1)]))
        q = np.stack(rows).astype(np.int32)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            np.savez(f, table=table, probes=probes, ids=q)
        os.replace(path + ".tmp", path)
        how = "built (numpy) and saved"
    m = HashMap32(torch.from_numpy(table).to("cuda"), probes)
    ids = torch.from_numpy(q).to("cuda")
    pads = int((q[0] < 0).sum())
    print(f"  uk2014-sized map: {UK_KEYS} keys of V {UK_V}, {m.n_buckets} "
          f"buckets ({m.table.numel() * 4} B), probes {m.probes}; "
          f"{how} in {time.perf_counter() - t0:.2f} s; queries "
          f"{tuple(ids.shape)}, {pads} pads a member")
    return m, ids


def hash_scale(torch, results, builds, n_ids):
    """K11 at the uk2014-sized map past L2 (``uk2014_map``), at the
    fetch's shape: exact against its plain version, timed with its bound,
    then in turns with the parent's kernel."""
    from legion_tpu_torch.cache.hashmap import hash_lookup_plain
    m, ids = uk2014_map(torch, n_ids)
    ref = hash_lookup_plain(m.keys, m.vals, m.probes, ids)
    least = hash_bound(m, ids, torch)
    compare("hash_lookup", lambda: m.lookup(ids),
            lambda: hash_lookup_plain(m.keys, m.vals, m.probes, ids), exact,
            results, torch, f"uk2014-sized {tuple(ids.shape)}, {m.n_buckets}"
            f" buckets, probes {m.probes}", least=least, queued=True)
    k11_turns("uk2014-sized map", m, ids, ref, least, builds, torch)
    del m, ids, ref
    torch.cuda.empty_cache()


def clique_kernels(tr, tr_hash, torch, results, main, parent=False):
    """K11-K14 against their plain versions at clique-HT's shapes (one real
    batch of the Kg members), exact, timed, with their bounds; K12 beside
    ``torch.sort(owner, stable=True)``; K13 over the trainer's bf16 host
    table and the other ``feature_tables``, also in turns. K11 on
    clique-HT-hash's maps, in turns with the parent's kernel when
    ``parent`` (``k11_builds``)."""
    from legion_tpu_torch.cache import collective as co
    from legion_tpu_torch.cache.hashmap import hash_lookup_plain
    link_bps = MEASURED["link_bps"]
    hops, fetch = clique_batch(tr, torch)
    acc, fs = tr.graph_access, tr.feature_source
    Kg = CLIQUE_KG

    def owner_of(slot):
        return torch.where(slot >= 0, slot % Kg, Kg)

    # K11, at the fetch, both hops and the counters' lookup, on the hash
    # path's maps; then in turns with the parent's kernel; then at the
    # uk2014-sized map
    builds = k11_builds(parent)
    for m, ids, what in (
            (tr_hash.feature_source.slot_map, fetch["ids"], "fetch ids"),
            (tr_hash.graph_access.row_map, hops[0]["frontier"], "hop 0"),
            (tr_hash.graph_access.row_map, hops[1]["frontier"], "hop 1"),
            (tr_hash.graph_access.row_map, fetch["count_ids"],
             "counters")):
        least = hash_bound(m, ids, torch)
        t = compare(
            "hash_lookup", lambda: m.lookup(ids),
            lambda: hash_lookup_plain(m.keys, m.vals, m.probes, ids), exact,
            results, torch, f"{what} {tuple(ids.shape)}, {m.n_buckets} "
            f"buckets, probes {m.probes}", least=least, queued=True)
        main.setdefault("hash_lookup", []).append(t)
        k11_turns(what, m, ids,
                  hash_lookup_plain(m.keys, m.vals, m.probes, ids), least,
                  builds, torch)
    hash_scale(torch, results, builds, fetch["ids"].shape[1])
    # K12, at the fetch and both hops, for the Kg members and for member 0
    # alone (a rank of layout (b)): req, row and pos exact, then the
    # trainer's call (no pos) timed, as launched and queued, the host's us
    # a call, and a hop's target: twice the launch floor and the bound
    floor = launch_floor(torch)
    for h, what in ((fetch, "fetch"), (hops[0], "hop 0"), (hops[1], "hop 1")):
        for slot in (h["slot"].contiguous(), h["slot"][:1].contiguous()):
            M, N = slot.shape
            R_req = co.request_rows(N, Kg, 1.5)
            all_exact("bucket_by_owner", co.bucket_by_owner(slot, Kg, R_req,
                                                            True),
                      co.bucket_by_owner_plain(slot, Kg, R_req), what, torch)
            own = owner_of(slot)
            least = bound(4 * M * N * 2 + 4 * M * Kg * R_req)
            t = compare(
                "bucket_by_owner",
                lambda: co.bucket_by_owner(slot, Kg, R_req)[1],
                lambda: co.bucket_by_owner_plain(slot, Kg, R_req)[1],
                exact, results, torch, f"{what} [{M}, {N}], R_req {R_req}",
                least=least,
                library=lambda: torch.sort(own, dim=1, stable=True),
                queued=True)
            if M == Kg:
                main.setdefault("bucket_by_owner", []).append(t)
            us = host_us(lambda: co.bucket_by_owner(slot, Kg, R_req), torch,
                         200)
            print(f"  bucket_by_owner {what} [{M}, {N}]: host_us_per_call "
                  f"{us:.2f} | 2 x (launch floor + bound) "
                  f"{2 * (floor + least[0]):.4f} ms")
    k12_host_parts(hops[0]["slot"].contiguous(), Kg, torch)
    k12_tile_count(fetch["slot"][0], Kg, torch)
    # K13, the fetch: rows and hits exact, over the trainer's table (bf16
    # rows for the bf16 cache), an f32 table of the same rows and their
    # bf16 rows unpadded, then the three timed in turns
    ids, row, back = fetch["ids"], fetch["row"], fetch["back"]
    tables = feature_tables(tr)
    n, F = ids.numel(), back.shape[1]
    hit = row >= 0
    from_host = (ids >= 0) & ~hit & (ids < fs.host.shape[0])
    es = back.element_size()
    print(f"  clique fetch: {n} lanes, {int(hit.sum())} served by the "
          f"clique, {int(((fetch['slot'] >= 0) & ~hit).sum())} overflow, "
          f"{int(from_host.sum())} from the host "
          f"({distinct(ids[from_host])} distinct rows)")
    pitch_probe(ids[from_host].unique().to(torch.int32), fs.host.shape[0],
                "clique-HT fetch", torch)
    # the library call, K4's: the missed lanes' rows read from the mapped
    # host table by one index (computing less: no served rows, no order)
    idx = ids[from_host].long()
    for label, host in tables.items():
        # device memory: the sorted ids, their order (int64) and each
        # lane's row read once, each served row read, every output row
        # written; the link: the F values of each distinct missed row
        # once, in the table's type
        least = bound(4 * n * 2 + 8 * n + int(hit.sum()) * F * es
                      + n * F * es, link_bytes=distinct(ids[from_host]) * F
                      * host.device.element_size(), link_bps=link_bps)
        all_exact("clique_gather", co.clique_gather(back, row, ids, host),
                  co.clique_gather_plain(back, row, ids, host.on("cuda")),
                  f"fetch, {label} table", torch)
        t = compare("clique_gather",
                    lambda: co.clique_gather(back, row, ids, host)[0],
                    lambda: co.clique_gather_plain(back, row, ids,
                                                   host.on("cuda"))[0],
                    exact, results, torch, f"fetch [{Kg}, {ids.shape[1]}] x"
                    f" {F}, {label} table {tuple(host.shape)}", least=least,
                    queued=True,
                    library=lambda: host.device[idx, :F])
        if host is fs.host:
            main["clique_gather"] = [t]
    table_turns("clique_gather", "clique-HT fetch", {
        label: lambda host=host: co.clique_gather(back, row, ids, host)
        for label, host in tables.items()}, torch)
    for host in list(tables.values())[:-1]:
        host.close()
    # the rest of the fetch: the owners' serve (K1 a member) and the two
    # exchanges, and the whole fetch as the trainer calls it
    req = fetch["req"]
    ms_ex = cuda_ms(lambda: co.exchange(back.view(1, Kg, Kg, -1, F)), torch)
    ms_serve = cuda_ms(lambda: fs._rows_back(req), torch)
    ms_fetch = cuda_ms(lambda: fs.fetch(ids), torch)
    print(f"  the exchange of the answers ({nb(back)} B) {ms_ex:.4f} ms | "
          f"the owners' serve and both exchanges {ms_serve:.4f} ms | the "
          f"whole fetch (map, K12, serve, exchanges, K13) {ms_fetch:.4f} ms")
    # K14, both hops: the owners' draws, and the requesters' unsort with
    # the host draws of the lanes not served
    for k, h in enumerate(hops):
        recv, fo, keys = h["recv"], h["fanout"], h["keys"]
        valid = int((recv >= 0).sum())
        pe = tr.graph_access.member_pairs.element_size()

        def draw():
            return co.clique_draw(acc.member_pairs, acc.member_indices2d,
                                  recv, fo, keys)
        least = bound(4 * recv.numel() + 2 * pe * valid + 4 * valid * fo
                      + 4 * recv.numel() * fo)
        t = compare("clique_draw", draw,
                    lambda: co.clique_draw_plain(acc.member_pairs,
                                                 acc.member_indices2d, recv,
                                                 fo, keys),
                    exact, results, torch,
                    f"owners {tuple(recv.shape)} x {fo}, {valid} rows",
                    least=least, queued=True)
        main.setdefault("clique_draw", []).append(t)
        print(f"  clique_draw hop {k}: host_us_per_call "
              f"{host_us(draw, torch, 200):.2f} | 2 x (launch floor + "
              f"bound) {2 * (floor + least[0]):.4f} ms")
        bk = co.exchange(draw().view(1, Kg, Kg, -1, fo)).view(-1, fo)
        r, fill = h["row"], h["fill"]
        served = int((r >= 0).sum())

        def unsort():
            return co.clique_draw_unsort(bk, r, fill)
        least = bound(4 * r.numel() * (1 + 2 * fo) + 4 * served * fo)
        t = compare("clique_draw", unsort,
                    lambda: co.clique_draw_unsort_plain(bk, r, fill), exact,
                    results, torch, f"unsort {tuple(r.shape)} x {fo}, "
                    f"{served} served", least=least, queued=True)
        main["clique_draw"].append(t)
        print(f"  clique_draw_unsort hop {k}: host_us_per_call "
              f"{host_us(unsort, torch, 200):.2f} | 2 x (launch floor + "
              f"bound) {2 * (floor + least[0]):.4f} ms")
        print(f"  hop {fo}: {int((h['frontier'] >= 0).sum())} frontier "
              f"lanes, {int((h['slot'] >= 0).sum())} cached, {served} "
              f"served, {int(((h['slot'] >= 0) & (r < 0)).sum())} overflow")
    clique_owners(tr, torch, hops, fetch)


def k12_host_parts(slot, Kg, torch):
    """Where K12's host time goes, at hop 0's shape: the host's us a call
    of the wrapper, of its three allocations, of the stream handle and of
    the C entry point alone (one launch there) on buffers made once."""
    from legion_tpu_torch.cache import collective as co
    from legion_tpu_torch.ops import kernels
    M, N = slot.shape
    R_req = co.request_rows(N, Kg, 1.5)
    words = co._k12_scratch(M, N, Kg)

    def alloc():
        return (torch.empty((words,), dtype=torch.int32, device="cuda"),
                torch.empty((M, Kg, R_req), dtype=torch.int32, device="cuda"),
                torch.empty((M, N), dtype=torch.int32, device="cuda"))
    sc, req, row = alloc()
    lib = kernels.lib()

    def call():
        lib.lt_bucket_by_owner(slot.data_ptr(), M, N, Kg, R_req,
                               req.data_ptr(), row.data_ptr(), None,
                               sc.data_ptr(), kernels.stream_handle())
    parts = [host_us(f, torch, 1000) for f in (
        lambda: co.bucket_by_owner(slot, Kg, R_req), alloc,
        kernels.stream_handle, call)]
    print(f"  bucket_by_owner hop 0 [{M}, {N}], host us a call: the wrapper "
          f"{parts[0]:.2f} | its three allocations {parts[1]:.2f} | the "
          f"stream handle {parts[2]:.2f} | the C call "
          f"{parts[3]:.2f}")


def k12_tile_count(lanes, Kg, torch):
    """K12 for one member (M = 1, a rank of layout (b)) over 1, 3 and 12
    times the fetch's lanes (member 0's, repeated), exact and queued, with
    the share of the bound: a tile's prefix over the tiles before it reads
    ceil(t / 512) rounds of 16-byte loads a lane, so a cost that grows
    faster than the lanes shows as a falling share."""
    from legion_tpu_torch.cache import collective as co
    for times in (1, 3, 12):
        slot = lanes.repeat(times)[None].contiguous()
        N = slot.shape[1]
        R_req = co.request_rows(N, Kg, 1.5)
        all_exact("bucket_by_owner", co.bucket_by_owner(slot, Kg, R_req,
                                                        True),
                  co.bucket_by_owner_plain(slot, Kg, R_req),
                  f"{times} x the fetch's lanes", torch)
        q = queued_ms(lambda: co.bucket_by_owner(slot, Kg, R_req), torch)
        least = bound(4 * N * 2 + 4 * Kg * R_req)
        print(f"  bucket_by_owner [1, {N}] ({-(-N // 2048)} tiles), R_req "
              f"{R_req}: queued {q:.4f} ms | bound {least[0]:.4f} ms "
              f"(share {least[0] / q:.3f}) | {q / N * 1e6:.4f} ns a lane")


def clique_owners(tr, torch, hops, fetch):
    """What each rank of a clique across processes (one member a card,
    layout (b)) computes on its own, at clique-HT's shapes on one real
    batch, with no process group: for each owner o, its shards built
    alone (``owners=[o]``), its K1 serve of the requests it received, its
    K14 draws at ``first_owner=o`` and its K10 words at member offset o.
    Stacked over the owners and sent back as the clique's all-to-all
    would, they must equal the all-owners caches' rows and draws, and
    the members' words, exactly."""
    import numpy as np
    from legion_tpu_torch.cache import collective as co
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.sampling import access
    fs, acc, plan, Kg = tr.feature_source, tr.graph_access, tr.cache_plan, \
        CLIQUE_KG
    map_impl = tr.config.cache.resolve_map_impl(tr.dataset.meta.num_nodes)
    dt = "bfloat16" if fs.member_rows.dtype == torch.bfloat16 else "float32"
    recv_f = fs.to_owners(fetch["req"])             # [1, Kg, Q]
    served, drawn = [], [[] for _ in hops]
    L = tr.sampler_t.config.num_hops
    keys = torch.stack([h["keys"] for h in hops], 1)        # [Kg, L, 4]
    for o in range(Kg):
        smap, rows, _ = co.build_clique_cache(
            np.asarray(plan.feature_order), plan.feature_capacity,
            tr.dataset.features, Kg,
            feat_dtype=dt, map_impl=map_impl, device="cuda", owners=[o])
        if not torch.equal(rows[0], fs.member_rows[o]):
            fail(f"clique owners: owner {o}'s feature shard built alone "
                 "differs from its shard of the whole build")
        served.append(kernels.gather_rows(rows[0], recv_f[0, o]))
        _, pairs, blocks, _ = co.build_clique_topo(
            np.asarray(plan.topo_order), plan.topo_capacity,
            acc.fallback.host_indptr.array, acc.fallback.host_indices.array,
            Kg, window=acc.window, map_impl=map_impl, device="cuda",
            owners=[o])
        for k, h in enumerate(hops):
            drawn[k].append(co.clique_draw(
                pairs, blocks, h["recv"][:, o:o + 1].contiguous(),
                h["fanout"], h["keys"][o:o + 1], first_owner=o))
        base = torch.full((), tr.config.train.seed + 1, dtype=torch.int64,
                          device="cuda")
        ctr = torch.zeros((), dtype=torch.int64, device="cuda")
        if not torch.equal(access.step_keys(base, ctr, 0, L, Kg, o, 1)[0],
                           keys[o]):
            fail(f"clique owners: K10 at member offset {o} differs from "
                 f"member {o}'s words of the whole clique")
        del smap
    back = fs.to_members(torch.stack(served)[None])
    if not torch.equal(back, fs._rows_back(fetch["req"])):
        fail("clique owners: the owners' serves built alone, exchanged, "
             "differ from the all-owners cache's served rows")
    for k, h in enumerate(hops):
        one = torch.cat(drawn[k], 1)                # [1, Kg, Q, fanout]
        if not torch.equal(one, co.clique_draw(
                acc.member_pairs, acc.member_indices2d, h["recv"],
                h["fanout"], h["keys"])):
            fail(f"clique owners: hop {k}: the owners' draws at their own "
                 "offsets differ from the all-owners draw")
    print(f"  each of {Kg} owners alone (one member a card, layout (b)): "
          f"shards, K1 serves of {recv_f.shape[2]} requests, K14 draws of "
          f"both hops and K10 words at its offset: exact against the "
          "all-owners caches")


def k11_edge_maps(rng, dev):
    """K11's maps at its edges, each with its query sets: the tails of 4
    ids a thread (1, 3, 4, 5 and 4·1000 + 1 ids), 2-D ids; a map of 2
    buckets; a chain of buckets from bucket B - 1 that wraps past it (3 or
    more probe rounds), with every query in that chain; the largest int32
    id, present and absent. Yields (what, map, [query ids])."""
    import numpy as np
    from legion_tpu_torch.cache.hashmap import HashMap32, _hash
    keys = rng.choice(10 ** 7, 5000, replace=False)
    m = HashMap32.build(keys, np.arange(5000, dtype=np.int32), device=dev)
    mixed = rng.permutation(np.concatenate([keys, rng.integers(
        -1, 10 ** 7, 5000)]))
    yield "tails", m, [mixed[:n] for n in (1, 3, 4, 5, 4001)] + [
        mixed[:4 * 1001].reshape(4, 1001)]
    two = rng.choice(1000, 12, replace=False)
    m = HashMap32.build(two, np.arange(12, dtype=np.int32), load=0.9,
                        device=dev)
    if m.n_buckets != 2:
        fail(f"k11 edges: {m.n_buckets} buckets, want 2")
    yield "2 buckets", m, [np.concatenate([two, np.arange(-1, 1000)])]
    cand = np.arange(1, 400_000)
    last = cand[_hash(cand, 64) == 63]
    others = np.setdiff1d(cand, last)
    chain = np.concatenate([last[:30], rng.choice(others, 170,
                                                  replace=False)])
    m = HashMap32.build(chain, rng.integers(0, 2 ** 31 - 1, 200)
                        .astype(np.int32), device=dev)
    if m.n_buckets != 64 or m.probes < 3:
        fail(f"k11 edges: {m.n_buckets} buckets, probes {m.probes}; want "
             "64 and 3 or more")
    yield "wrapping chain", m, [chain, last[:400], last[10:11]]
    top = np.append(rng.choice(2 ** 31 - 1, 999, replace=False),
                    2 ** 31 - 1)
    for keep in (True, False):
        k = top if keep else top[:-1]
        m = HashMap32.build(k, np.arange(len(k), dtype=np.int32),
                            device=dev)
        yield f"id 2^31-1 {'present' if keep else 'absent'}", m, [
            np.concatenate([top, [2 ** 31 - 1, 2 ** 31 - 2, -1]])]


def clique_edges(torch, results):
    """K11-K14 at the edges of their shapes, exact against the plain
    versions: K11 at loads needing 2+ probe rounds, all misses, pads, one
    id, and at ``k11_edge_maps``' edges, each 1-D query set also from a
    base that is not 16-byte aligned; K12 at Kg 1, 4, 8 and 31, M 1 to 8,
    N from 1 to 4,200,000 (one block a member, its last lane, one lane
    past it, tiles of 2048 and their last lane, past 2,000 tiles), all
    misses, no misses, half misses, one owner past R_req (half the lanes
    to owner 1, or to owner Kg // 2), every lane to one owner, at the
    fetch's size too; K13 with all misses, no misses, overflow, an id
    that one member's lane finds and another's overflows, no host table,
    f32 and bf16, widths 1, 100, 128 and 602, f32 host tables, and bf16
    ones at the bases and pitches of
    ``k4_edges``;
    K14 with degree-0 rows, no requests, int64 pairs, fanouts 1 and 25, a
    window of 8 and one of 48 (not a power of two), two cliques, and each
    owner alone at its clique index (its shard only, the index folded in:
    the slice of the all-owners draw); at hop 1's shape with degree-0
    rows and with no requests, the unsort there with and without fill, at
    a width of 4 lanes a thread and of one."""
    import numpy as np
    from legion_tpu_torch.cache import collective as co
    from legion_tpu_torch.cache.hashmap import HashMap32, hash_lookup_plain
    rng = np.random.default_rng(12)
    dev = "cuda"
    n_cases = 0

    def check(name, got, ref, what):
        nonlocal n_cases
        n_cases += 1
        all_exact(name, got, ref, f"edge {what}", torch)

    for n, load, q in ((5000, 0.97, "mixed"), (100, 0.5, "all miss"),
                       (1, 0.5, "pads"), (3000, 0.9, "one")):
        ids = rng.choice(10 ** 7, n, replace=False)
        m = HashMap32.build(ids, rng.integers(0, 2 ** 31 - 1, n,
                                              dtype=np.int64)
                            .astype(np.int32), load=load, device=dev)
        qs = {"mixed": np.concatenate([ids, rng.integers(0, 10 ** 7, n),
                                       [-1, -5]]),
              "all miss": np.setdiff1d(rng.integers(0, 10 ** 7, 999), ids),
              "pads": np.full(77, -1), "one": ids[-1:]}[q]
        qt = torch.from_numpy(qs.astype(np.int32)).to(dev)
        check("hash_lookup", [m.lookup(qt)],
              [hash_lookup_plain(m.keys, m.vals, m.probes, qt)],
              f"{q}, probes {m.probes}")
    for what, m, qs in k11_edge_maps(rng, dev):
        for q in qs:
            qt = torch.from_numpy(q.astype(np.int32)).to(dev)
            # also one id in: a base that is not 16-byte aligned
            for x in (qt, qt.view(-1)[1:]) if qt.dim() == 1 else (qt,):
                check("hash_lookup", [m.lookup(x)],
                      [hash_lookup_plain(m.keys, m.vals, m.probes, x)],
                      f"{what}, ids {tuple(x.shape)}, probes {m.probes}")
    # K12: one block a member up to 8192 lanes, tiles of 2048 past it; at
    # the fetch's size (1,418,112 lanes a member) and past 1,000 tiles
    fetch_n = 1_418_112
    for M, N, Kg, q in ((4, 1, 4, "mixed"), (4, 1000, 4, "all miss"),
                        (4, 1000, 4, "no miss"), (4, 3000, 4, "skew"),
                        (2, 700, 1, "mixed"), (3, 257, 8, "mixed"),
                        (1, 5000, 31, "mixed"), (8, 20000, 4, "skew"),
                        (4, 2048, 4, "half"), (4, 2049, 4, "half"),
                        (4, 8192, 4, "half"), (4, 8193, 4, "half"),
                        (2, 6 * 2048, 2, "half"),
                        (2, 10 * 2048 + 1, 1, "half"),
                        (4, 100_000, 31, "half"), (1, 100_000, 31, "skew"),
                        (4, 20_000, 4, "one owner"),
                        (1, 4_200_000, 4, "skew"),
                        (1, 4_200_000, 4, "skew mid"),
                        (4, fetch_n, 4, "all miss"),
                        (4, fetch_n, 4, "skew"), (1, fetch_n, 4, "half"),
                        (4, fetch_n, 4, "one owner")):
        slot = rng.integers(-1, 50 * Kg, (M, N)).astype(np.int32)
        if q == "all miss":
            slot[:] = -1
        if q == "no miss":
            slot = np.abs(slot)
        if q == "half":
            slot[rng.random((M, N)) < 0.5] = -1
        if q == "skew":
            slot[:, :N // 2] = Kg * rng.integers(0, 50, N // 2) + 1
        if q == "skew mid":
            slot[:, :N // 2] = Kg * rng.integers(0, 50, N // 2) + Kg // 2
        if q == "one owner":
            slot = Kg * rng.integers(0, 10 ** 6, (M, N)).astype(np.int32) \
                + Kg - 1
        st = torch.from_numpy(slot).to(dev)
        R_req = co.request_rows(N, Kg, 1.5)
        check("bucket_by_owner", co.bucket_by_owner(st, Kg, R_req, True),
              co.bucket_by_owner_plain(st, Kg, R_req), f"{M}x{N} Kg {Kg} {q}")
    V = 3000
    # f32 tables (the tables with None: no host table), then bf16 tables
    # at each base and pitch of ``k4_edges``
    tables = [(100, torch.bfloat16, 0, None), (128, torch.float32, 0, None),
              (1, torch.float32, 0, None), (602, torch.bfloat16, 0, None)]
    tables += [(F, torch.bfloat16, shift, P) for F in EDGE_WIDTHS
               for shift in EDGE_BF16_SHIFTS for P in edge_pitches(F)]
    for F, dt, shift, P in tables:
        host = aligned_table(rng.standard_normal((V, F)).astype(np.float32),
                             shift, P)
        kind = "f32" if P is None else f"bf16 pitch {P} base % 128 {shift}"
        for q in ("mixed", "all miss", "no miss", "overflow", "shared"):
            M, N, Kg = 4, 500, 4
            ids = np.stack([rng.choice(V, N, replace=False)
                            for _ in range(M)]).astype(np.int32)
            ids[:, -7:] = -1
            slot = np.where(rng.random((M, N)) < 0.6, ids % 400, -1)
            if q == "all miss":
                slot[:] = -1
            if q == "no miss":
                slot = ids % 400
            if q in ("overflow", "shared"):
                slot = (ids % 100) * Kg + 2
            if q == "shared":
                # the same ids in every member: early lanes served, late
                # lanes past R_req, so runs of one id mix the two
                ids[:] = ids[0]
                ids[1] = ids[1][::-1]
            slot = np.where(ids >= 0, slot, -1).astype(np.int32)
            R_req = co.request_rows(N, Kg, 1.5)
            _, row, _ = co.bucket_by_owner(torch.from_numpy(slot).to(dev),
                                           Kg, R_req)
            back = torch.randn((M * Kg * R_req, F), device=dev).to(dt)
            it = torch.from_numpy(ids).to(dev)
            for h in (host, None) if P is None else (host,):
                ref = co.clique_gather_plain(
                    back, row, it, None if h is None else h.on("cuda"))
                check("clique_gather", co.clique_gather(back, row, it, h),
                      ref, f"{q} F {F} {dt} host {h is not None and kind}")
        host.close()
    Vg = 5000
    deg = rng.integers(0, 200, Vg)
    deg[rng.random(Vg) < 0.2] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, Vg, indptr[-1]).astype(np.int32)
    order = rng.permutation(Vg)
    for Kc, Kg, fo, W, q in ((1, 4, 25, 64, "mixed"), (1, 4, 1, 8, "mixed"),
                             (2, 2, 10, 48, "mixed"), (1, 4, 10, 64, "none"),
                             (1, 4, 10, 64, "int64")):
        row_map, pairs, blocks, R = co.build_clique_topo(
            order, 3000, indptr, indices, Kg, window=W, device=dev)
        if q == "int64":
            pairs = pairs.long()
        n = Kc * Kg
        fr = rng.integers(-1, Vg, (n, 900)).astype(np.int32)
        if q == "none":
            fr[:] = -1
        cache = co._Clique(row_map, Kg, Kc, 1.5)
        req, row, _ = cache.route(torch.from_numpy(fr).to(dev))
        recv = cache.to_owners(req)
        keys = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 4))
                                .astype(np.int32)).to(dev)
        drawn = co.clique_draw(pairs, blocks, recv, fo, keys)
        check("clique_draw", [drawn],
              [co.clique_draw_plain(pairs, blocks, recv, fo, keys)],
              f"Kc {Kc} Kg {Kg} fanout {fo} W {W} {q}")
        # one owner alone at its clique index o0 (a process of a clique
        # across processes): its slice of the all-owners draw
        for o0 in range(Kg):
            args = (pairs[o0:o0 + 1], blocks[o0:o0 + 1],
                    recv[:, o0:o0 + 1].contiguous(), fo,
                    keys.view(Kc, Kg, 4)[:, o0].contiguous())
            one = co.clique_draw(*args, first_owner=o0)
            check("clique_draw", [one, one],
                  [co.clique_draw_plain(*args, first_owner=o0),
                   drawn[:, o0:o0 + 1]],
                  f"Kc {Kc} Kg {Kg} fanout {fo} W {W} {q} owner {o0} alone")
        back = co.exchange(drawn.view(Kc, Kg, Kg, -1, fo)).view(-1, fo)
        fill = torch.from_numpy(rng.integers(-1, Vg, (n, fo * 900))
                                .astype(np.int32)).to(dev)
        for fl in (None, fill):
            check("clique_draw_unsort", [co.clique_draw_unsort(back, row, fl)],
                  [co.clique_draw_unsort_plain(back, row, fl)],
                  f"Kc {Kc} Kg {Kg} fanout {fo} fill {fl is not None}")
    # K14 at hop 1's shape of clique-HT: owners [1, 4, 192,288] x 10 over
    # rows of which a fifth have degree 0, then no requests at all; the
    # unsort [4, 128,192] x 10 (and one lane fewer: the one-lane form)
    row_map, pairs, blocks, R = co.build_clique_topo(
        order, 3000, indptr, indices, 4, window=64, device=dev)
    Q, F, fo = 192_288, 128_192, 10
    keys = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (4, 4))
                            .astype(np.int32)).to(dev)
    for q in ("mixed", "none"):
        recv = rng.integers(-1, R, (1, 4, Q)).astype(np.int32)
        recv[rng.random(recv.shape) < 0.5] = -1
        if q == "none":
            recv[:] = -1
        rt = torch.from_numpy(recv).to(dev)
        drawn = co.clique_draw(pairs, blocks, rt, fo, keys)
        check("clique_draw", [drawn],
              [co.clique_draw_plain(pairs, blocks, rt, fo, keys)],
              f"hop 1's shape, {q} requests")
        back = drawn.view(-1, fo)
        for Fu in (F, F - 1):
            row = rng.integers(-back.shape[0], back.shape[0], (4, Fu))
            rw = torch.from_numpy(row.astype(np.int32)).to(dev).clamp(min=-1)
            fill = torch.from_numpy(rng.integers(-1, Vg, (4, fo * Fu))
                                    .astype(np.int32)).to(dev)
            for fl in (None, fill):
                check("clique_draw_unsort",
                      [co.clique_draw_unsort(back, rw, fl)],
                      [co.clique_draw_unsort_plain(back, rw, fl)],
                      f"hop 1's shape [4, {Fu}], {q} requests, fill "
                      f"{fl is not None}")
    print(f"  clique_edges: {n_cases} cases of K11-K14, exact")


def clique_replay(torch):
    """K11 (at hop 1's and the fetch's shapes, over maps of clique-HT-hash's
    sizes), K12 (one block a member at hop 0's size, two passes at hop
    1's) and K14 captured in one CUDA graph and replayed twice on new
    inputs copied into the captured ones: each replay exact against the
    plain versions."""
    import numpy as np
    from legion_tpu_torch.cache import collective as co
    from legion_tpu_torch.cache.hashmap import HashMap32, hash_lookup_plain
    rng = np.random.default_rng(16)
    dev, Kg, fo = "cuda", 4, 10

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape)
                                .astype(np.int32)).to(dev)
    Vg = 5000
    deg = rng.integers(0, 200, Vg)
    deg[rng.random(Vg) < 0.2] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, Vg, indptr[-1]).astype(np.int32)
    _, pairs, blocks, R = co.build_clique_topo(
        rng.permutation(Vg), 3000, indptr, indices, Kg, window=64,
        device=dev)
    sizes = (8000, 128_192)
    slots = [ints(-1, 200 * Kg, (Kg, n)) for n in sizes]
    R_reqs = [co.request_rows(n, Kg, 1.5) for n in sizes]
    Q, F = Kg * R_reqs[1], sizes[1]
    recv, keys = ints(-1, R, (1, Kg, Q)), ints(-2 ** 31, 2 ** 31, (Kg, 4))
    back = ints(-1, Vg, (Kg * Q, fo))
    row, fill = ints(-1, Kg * Q, (Kg, F)), ints(-1, Vg, (Kg, fo * F))
    inputs = slots + [recv, keys, back, row, fill]
    # K11: a topology map of 4,096 buckets at hop 1's [Kg, 128,192] ids,
    # a feature map of 262,144 at the fetch's [Kg, 1,418,112], ids of H's
    # 2.4M vertices
    V = 2_400_000
    maps = [HashMap32.build(k, np.arange(len(k), dtype=np.int32),
                            device=dev)
            for k in (rng.choice(V, 16_000, replace=False),
                      rng.choice(V, 1_000_000, replace=False))]
    hids = [ints(-1, V, (Kg, n)) for n in (sizes[1], 1_418_112)]

    def calls():
        out = [x for s, r in zip(slots, R_reqs)
               for x in co.bucket_by_owner(s, Kg, r, True)]
        out += [m.lookup(i) for m, i in zip(maps, hids)]
        return out + [co.clique_draw(pairs, blocks, recv, fo, keys),
                      co.clique_draw_unsort(back, row, fill)]

    def plain():
        out = [x for s, r in zip(slots, R_reqs)
               for x in co.bucket_by_owner_plain(s, Kg, r)]
        out += [hash_lookup_plain(m.keys, m.vals, m.probes, i)
                for m, i in zip(maps, hids)]
        return out + [co.clique_draw_plain(pairs, blocks, recv, fo, keys),
                      co.clique_draw_unsort_plain(back, row, fill)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = calls()
    for rep in range(2):
        for x in inputs:
            new = torch.from_numpy(rng.integers(-1, 200 * Kg, x.shape)
                                   .astype(np.int32)).to(dev)
            x.copy_(new if x is not recv else new.remainder(R + 1) - 1)
        for x in hids:
            x.copy_(ints(-1, V, x.shape))
        g.replay()
        torch.cuda.synchronize()
        all_exact("clique replay", outs, plain(), f"replay {rep}", torch)
    print(f"  clique_replay: K11 at {[tuple(i.shape) for i in hids]} "
          f"({[m.n_buckets for m in maps]} buckets), K12 at [{Kg}, "
          f"{sizes[0]}] and [{Kg}, {sizes[1]}] (req, row, pos) and K14 "
          "(draws, unsort) captured once, replayed twice on new inputs: "
          "exact")


class MemberRecorder:
    """Wraps ``Trainer._member_sample_fetch``: for each train batch, the
    members' ids [Kg, ids_len], feature hits and (``keep``) the batches
    and the fetched rows."""

    def __init__(self, tr, torch, keep=False):
        self.tr, self.rec = tr, []
        orig = tr._member_sample_fetch

        def wrapped(state, sampler, seeds, keys):
            out = orig(state, sampler, seeds, keys)
            if sampler is tr.sampler_t:
                ids = torch.stack([b.node_ids for b in out[0]]).clone()
                self.rec.append((ids, out[2].clone()) + (
                    (out[0], out[1].clone()) if keep else ()))
            return out
        tr._member_sample_fetch = wrapped

    def close(self):
        del self.tr._member_sample_fetch


def clique_path(tr, torch, path, steps, warmup=WARMUP_STEPS, evaluate=True,
                keep=False):
    """``path``'s steps (after ``warmup``) and an eval pass from
    ``init_state``, with the launches counted over exactly that run and
    held against ``PATH_KERNELS[path]``: every kernel of the path
    launched, none other. Returns (counts, ms a step, losses, the
    recorder's records of the timed steps, the state)."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline import Mode
    rec = MemberRecorder(tr, torch, keep)
    state = tr.init_state()
    kernels.reset_launch_counts()
    for _ in range(warmup):
        state, _ = tr.train_step(state)
    torch.cuda.synchronize()
    rec.rec.clear()
    before = dict(kernels.LAUNCHES)
    losses, ctr = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = tr.train_step(state)
        losses.append(loss)
        ctr.append(torch.stack([tr.last_edges, tr.last_feat_hits,
                                tr.last_slots, tr.last_topo_hits,
                                tr.last_topo_total]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    per_step = {k: (v - before[k]) / steps
                for k, v in kernels.LAUNCHES.items()}
    acc = None
    if evaluate:
        state, acc = tr.run_eval(state, Mode.VALID)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    rec.close()
    launched = {k for k, v in counts.items() if v}
    if launched != set(PATH_KERNELS[path]):
        fail(f"{path}: launched {sorted(launched)}, want "
             f"{sorted(PATH_KERNELS[path])}")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{path}: non-finite loss {losses}")
    if evaluate and not (0.0 <= acc <= 1.0 and float(state["total"]) > 0):
        fail(f"{path}: eval pass counted nothing (acc {acc})")
    tot = torch.stack(ctr).sum(0).tolist()
    print(f"  {path}: {step_ms:.3f} ms a step over {steps} steps (after "
          f"{warmup}) | trained edges/s {tot[0] / (step_ms / 1e3 * steps):.1f}"
          f" | feature hits {tot[1]}/{tot[2]} slots | topology hits "
          f"{tot[3]}/{tot[4]} | losses {losses}"
          + ("" if acc is None else f" | valid acc {acc:.4f}"))
    nonzero = {k: v for k, v in counts.items() if v}
    print(f"  launches on the {path} path: {nonzero}\n  launches per train "
          f"step: { {k: v for k, v in per_step.items() if v} }")
    counts["per_step"] = per_step
    return counts, step_ms, losses, rec.rec, state, ctr


def clique_checks(tr, hds, torch):
    """One clique-HT step's results against the data: every member's
    fetched rows equal its ids' host rows rounded to bf16 (to nearest
    even, as K4 rounds) and zero rows for pads, exactly; every sampled
    edge's neighbour lies in its vertex's CSR row."""
    rec = clique_path(tr, torch, "clique-HT", 1, warmup=0, evaluate=False,
                      keep=True)[3]
    ids, _, batches, x = rec[0]
    feats = torch.from_numpy(hds.features).to("cuda")
    fid = ids[:, :tr.sampler_t.max_ids]
    ref = feats[fid.clamp(min=0).long()].to(x.dtype)
    ref[fid < 0] = 0
    del feats
    if not torch.equal(x, ref):
        bad = int((x != ref).any(-1).sum())
        fail(f"clique-HT: {bad} fetched rows differ from their host rows")
    g = hds.graph
    V = hds.meta.num_nodes
    indptr = torch.from_numpy(g.indptr).to("cuda")
    rows = torch.repeat_interleave(torch.arange(V, device="cuda"),
                                   indptr[1:] - indptr[:-1])
    keys = torch.sort(rows * V + torch.from_numpy(g.indices).to("cuda")
                      .long()).values
    del rows
    n_edges = 0
    for b in batches:
        for k in range(b.num_hops):
            src, dst = b.edge_src[k], b.edge_dst[k]
            ok = src >= 0
            u = b.node_ids[src[ok].long()].long()
            v = b.node_ids[dst[ok].long()].long()
            kq = v * V + u
            at = torch.searchsorted(keys, kq).clamp(max=keys.numel() - 1)
            if not bool((keys[at] == kq).all()):
                fail(f"clique-HT: a drawn neighbour of hop {k} is not in "
                     "its vertex's CSR row")
            n_edges += int(ok.sum())
    print(f"  clique-HT checks: {x.shape[0] * x.shape[1]} fetched rows equal"
          f" their host rows (bf16, nearest even); {n_edges} sampled edges, "
          "every neighbour in its vertex's CSR row")


def clique_pair(tr_a, tr_b, torch, path_a, label):
    """``path_a`` on tr_a (its launches held as ``clique_path`` holds them)
    and as many steps of tr_b from init_state: every step's sampled ids
    and fetched rows equal exactly; the first loss equal exactly (the same
    parameters, rows and dropout), later losses and the parameters within
    ``phase_fused``'s tolerance (K2's f32 atomics make two runs' updates
    differ in their last bits)."""
    counts, _, la, ra, sa, _ = clique_path(tr_a, torch, path_a,
                                           CLIQUE_AB_STEPS, warmup=0,
                                           evaluate=False, keep=True)
    rec = MemberRecorder(tr_b, torch, keep=True)
    sb = tr_b.init_state()
    lb = []
    for i in range(CLIQUE_AB_STEPS):
        sb, loss = tr_b.train_step(sb)
        lb.append(float(loss))
        ids_a, _, _, xa = ra[i]
        ids_b, _, _, xb = rec.rec[i]
        if not torch.equal(ids_a, ids_b):
            fail(f"{label}: step {i}'s sampled ids differ")
        if not torch.equal(xa, xb):
            fail(f"{label}: step {i}'s fetched rows differ")
        rec.rec[i] = None
        ra[i] = None
    rec.close()
    pa = [p.detach() for p in sa["model"].parameters()]
    pdiff = rel_norm([p.detach() for p in sb["model"].parameters()], pa)
    rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    print(f"  {label}: ids and fetched rows equal in all "
          f"{CLIQUE_AB_STEPS} steps | losses {la} against {lb} | first loss "
          f"{'equal' if la[0] == lb[0] else 'DIFFERS'} | max loss rel "
          f"{rel:.3g} | params rel {pdiff:.3g}")
    if la[0] != lb[0] or rel > 1e-3 or pdiff > 2e-3:
        fail(f"{label}: the two runs disagree")
    return counts


def phase_clique(hds, torch, kernels_only=False):
    """Phase 9: the clique caches with Kg = 4 members on the card, on the
    host dataset: K11-K14 against their plain versions at the clique-HT
    path's shapes and at the edges of theirs; each owner alone, as a rank
    of a clique across processes holds it (``clique_owners``); clique-HT
    (features and topology on the host, direct maps) for CLIQUE_STEPS
    steps and an eval pass, with its hit counters, overflow lanes and exchange bytes, and
    the data checks of ``clique_checks``; clique-HT-hash (hash maps)
    against clique-HT, and clique-H (the topology on the card) against
    the same members with every feature on the card (``clique_pair``).
    clique-HT and clique-HT-hash also run ``phase_modes``: replayed and
    pipelined member steps against eager ones, and the A/B of the modes.
    ``kernels_only`` stops after the kernels, their edges and the replay
    check. Returns (kernel results, launch counts by path, main-path times,
    the modes' A/B)."""
    from legion_tpu_torch.cache.hashmap import map_lookup
    from legion_tpu_torch.train import Trainer
    results, main, counts = {}, {}, {}
    tr, budget = clique_trainer(hds, torch)
    tr_hash = Trainer(hds, clique_config(hds, budget, map_impl="hash"),
                      device="cuda")
    clique_kernels(tr, tr_hash, torch, results, main, parent=kernels_only)
    clique_edges(torch, results)
    clique_replay(torch)
    add_main(results, main)
    if kernels_only:
        tr_hash.close()
        tr.close()
        return results, {}, None, {}

    print(" clique-HT:")
    fs, acc = tr.feature_source, tr.graph_access
    N = tr.sampler_t.max_ids
    fb = fs.collective_bytes(N)
    print(f"  exchange a member a step: fetch {fb} | " + " | ".join(
        f"hop {k}: {acc.collective_bytes(f, fo)}" for k, (f, fo) in
        enumerate(zip(tr.sampler_t.frontier_sizes,
                      tr.sampler_t.config.fanouts))))
    counts["clique-HT"], step_ms, _, rec, _, ctr = clique_path(
        tr, torch, "clique-HT", CLIQUE_STEPS)
    table_step_ab(tr, torch, "clique-HT")
    P = tr.sampler_t.cum_caps[tr.sampler_t.config.num_hops - 1]
    for i, ((ids, hits), c) in enumerate(zip(rec, ctr)):
        fid = ids[:, :N]
        slot = map_lookup(fs.slot_map, fid)
        cached = int((slot >= 0).sum())
        resident = int((map_lookup(acc.row_map, ids[:, :P]) >= 0).sum())
        print(f"  step {i}: feature lanes cached {cached}, served "
              f"{int(hits)}, overflow {cached - int(hits)}, host rows read "
              f"{distinct(fid[slot < 0])} distinct (all members) | topology"
              f" lanes cached {resident}, served {int(c[3])}, overflow "
              f"{resident - int(c[3])}")
    clique_checks(tr, hds, torch)
    print(" clique-HT with fused steps and interbatch:")
    modes = {"clique-HT": phase_modes(tr, torch, "clique-HT")}

    print(" clique-HT-hash (hash maps) against clique-HT (direct):")
    counts["clique-HT-hash"] = clique_pair(tr_hash, tr, torch,
                                           "clique-HT-hash", "hash maps")
    print(" clique-HT-hash with fused steps and interbatch:")
    modes["clique-HT-hash"] = phase_modes(tr_hash, torch, "clique-HT-hash")
    tr_hash.close()
    tr.close()
    del tr, tr_hash
    torch.cuda.empty_cache()

    print(" clique-H (the topology on the card) against the features on "
          "the card:")
    from dataclasses import replace
    tr_c = Trainer(hds, clique_config(hds, CLIQUE_BYTES, topo_residency="hbm"),
                   device="cuda")
    p = tr_c.cache_plan
    print(f"  clique-H plan: feature rows {p.feature_capacity}, topology rows "
          f"{p.topo_capacity}")
    cfg = clique_config(hds, 0, topo_residency="hbm", feature_residency="hbm")
    tr_d = Trainer(hds, replace(cfg, train=replace(cfg.train,
                                                   pad_feature_dim=False)),
                   device="cuda")
    counts["clique-H"] = clique_pair(tr_c, tr_d, torch, "clique-H",
                                     "clique-H against device features")
    tr_c.close()
    del tr_c, tr_d
    torch.cuda.empty_cache()
    counts["clique-HT"]["clique_draw"] += \
        counts["clique-HT"]["clique_draw_unsort"]
    counts["clique-HT"]["per_step"]["clique_draw"] += \
        counts["clique-HT"]["per_step"]["clique_draw_unsort"]
    return results, counts, step_ms, modes


# the launcher's flags of phase 10 (after CLI_ARGS): 4 members of one
# clique on the card
DIST_ARGS = ("--epoch", "1", "--devices", str(CLIQUE_KG), "--clique-size",
             str(CLIQUE_KG))


class DistRecorder:
    """Through the launcher: with ``topo_host``, the topology on the host
    as well (the launcher has no flag for it, in either package:
    ``run.build_config`` is wrapped), and for each train step its counter,
    loss, counters (edges, slots, feature hits, topology hits and total),
    the collectives' calls and bytes it made, and the members' ids (on
    the card)."""

    def __init__(self, torch, topo_host=True):
        from dataclasses import replace

        from legion_tpu_torch import run
        from legion_tpu_torch.parallel import mesh as pmesh
        from legion_tpu_torch.train import Trainer
        self.steps, self.ids = [], []
        self._orig = (run.build_config, Trainer.train_step,
                      Trainer._member_sample_fetch)
        build, step, fetch = self._orig

        def build_config(args):
            cfg = build(args)
            if not topo_host:
                return cfg
            return replace(cfg, cache=replace(cfg.cache,
                                              topo_residency="host"))

        def train_step(tr, state):
            ctr = state["train_ctr"]
            before = {k: dict(v) for k, v in pmesh.COLLECTIVES.items()}
            out = step(tr, state)
            coll = {k: {f: v[f] - before[k][f] for f in v}
                    for k, v in pmesh.COLLECTIVES.items()}
            self.steps.append((ctr, out[1].clone(), torch.stack(
                [tr.last_edges, tr.last_slots, tr.last_feat_hits,
                 tr.last_topo_hits, tr.last_topo_total]), coll))
            return out

        def member_sample_fetch(tr, state, sampler, seeds, keys):
            out = fetch(tr, state, sampler, seeds, keys)
            if sampler is tr.sampler_t:
                self.ids.append(torch.stack([b.node_ids for b in out[0]])
                                .clone())
            return out
        run.build_config = build_config
        Trainer.train_step = train_step
        Trainer._member_sample_fetch = member_sample_fetch

    def close(self):
        from legion_tpu_torch import run
        from legion_tpu_torch.train import Trainer
        (run.build_config, Trainer.train_step,
         Trainer._member_sample_fetch) = self._orig


def dist_run(argv, torch, label, path="clique-HT"):
    """One launcher run on the card (``DistRecorder``; the topology on the
    host on the clique-HT path): fails on a non-finite loss, a valid
    accuracy outside [0, 1], caches other than the clique's on the
    clique-HT path, or a kernel of ``PATH_KERNELS[path]`` not launched (or
    another launched). Returns (the recorder, its steps' ms, the
    collectives of the whole run, the trainer: the caller closes it)."""
    from legion_tpu_torch import run
    from legion_tpu_torch.cache.collective import (CliqueFeatureCache,
                                                   CliqueTopoCache)
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.parallel import mesh as pmesh
    print(f" {label}: python -m legion_tpu_torch.run " + " ".join(argv)
          + (" (topology on the host)" if path == "clique-HT" else ""))
    kernels.reset_launch_counts()
    pmesh.reset_collective_counts()
    rec = DistRecorder(torch, topo_host=path == "clique-HT")
    try:
        t0 = time.perf_counter()
        tr, state, stats = run.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        rec.close()
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    coll = pmesh.collective_counts()
    if path == "clique-HT" and not (
            isinstance(tr.feature_source, CliqueFeatureCache)
            and isinstance(tr.graph_access, CliqueTopoCache)):
        fail(f"{label}: caches {type(tr.feature_source).__name__}, "
             f"{type(tr.graph_access).__name__}, not the clique's")
    if set(counts) != set(PATH_KERNELS[path]):
        fail(f"{label}: launched {sorted(counts)}, want "
             f"{sorted(PATH_KERNELS[path])}")
    st, sm = stats[0], tr.epoch_metrics[0]
    if not (math.isfinite(st.train_loss) and 0.0 <= st.valid_acc <= 1.0):
        fail(f"{label}: loss {st.train_loss}, valid acc {st.valid_acc}")
    tot = torch.stack([c for _, _, c, _ in rec.steps]).sum(0).tolist()
    ms = sm.seconds / sm.steps * 1e3
    p = tr.cache_plan
    print(f"  {label}: {secs:.3f} s in all | set-up {fmt_setup(tr.setup_s)}"
          f" | plan: alpha {p.alpha:.2f}, feature rows {p.feature_capacity},"
          f" topology rows {p.topo_capacity} | mesh "
          f"{None if tr.mesh is None else tr.mesh.shape}")
    print(f"  {label} epoch: {st.seconds:.3f} s (train {ms:.3f} ms/step over "
          f"{sm.steps} steps) | loss {st.train_loss!r} | valid acc "
          f"{st.valid_acc:.4f} | test acc {tr.test_acc:.4f} | trained "
          f"edges/s {sm.edges_per_s:.1f} | feature hits {tot[2]}/{tot[1]} "
          f"slots | topology hits {tot[3]}/{tot[4]}")
    print(f"  {label} launches: {counts}")
    return rec, ms, coll, tr


def phase_dist(d, torch):
    """Phase 10: the launcher's members and its process group. GraphSAGE
    at full width from the dataset on disk (``cli_dataset``), one epoch,
    ``--devices 4 --clique-size 4``, features and topology on the host
    behind the clique caches (clique-HT through the launcher): first in
    one process with no process group, then as a world of one rank under
    NCCL (``--coordinator 127.0.0.1:<port> --num-processes 1
    --process-id 0``), which makes every collective call of a larger world
    (layout (a): the gradients, the loss and the counters each step, the
    rank digest, eval's sums). The two runs must sample the same ids in
    every step exactly and give the same first loss bit for bit; later
    losses within ``phase_fused``'s tolerance (K2's f32 atomics). Prints
    the collective calls and bytes a step, and the ms a step both ways.
    Then that world's trainer in each mode (``phase_modes``: replayed and
    pipelined steps against eager ones, the collectives a step under
    replay, the A/B). Then a second world of one rank: one member on H's
    dataset (``--devices 1 --clique-size 1``, the topology on the card:
    layout (a) at Kg 1, a rank of plain data parallelism), through the
    launcher and in each mode. Each process group is destroyed after its
    runs. Returns the modes' A/B by world."""
    import socket

    import torch.distributed as dist

    def world():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                "1", "--process-id", "0"]
    t0 = time.perf_counter()
    data = ["--dataset-name", "custom", "--dataset-path", d, *CLI_ARGS]
    base = data + list(DIST_ARGS)
    a, ms_a, _, tr = dist_run(base, torch, "members, no process group")
    tr.close()
    del tr
    modes = {}
    try:
        b, ms_b, coll, tr = dist_run(base + world(), torch,
                                     "members, a world of one rank (NCCL)")
        if dist.get_backend() != "nccl":
            fail(f"the world of one rank on the card ran on "
                 f"{dist.get_backend()}")
        if [x[0] for x in a.steps] != [x[0] for x in b.steps] or \
                len(a.ids) != len(b.ids):
            fail("the two runs took other train steps")
        for i, (x, y) in enumerate(zip(a.ids, b.ids)):
            if not torch.equal(x, y):
                fail(f"step {i}: the world of one rank sampled other ids")
        la = [float(x[1]) for x in a.steps]
        lb = [float(x[1]) for x in b.steps]
        rel = max(abs(x - y) / abs(x) for x, y in zip(la, lb))
        if la[0] != lb[0] or rel > 1e-3:
            fail(f"losses {la} against {lb}: first equal {la[0] == lb[0]}"
                 f", max rel {rel}")
        per = [x[3] for x in b.steps]
        calls = {k: sorted({c[k]["calls"] for c in per}) for k in per[0]}
        nbytes = {k: sorted({c[k]["bytes"] for c in per}) for k in per[0]}
        print(f"  world of one rank against no process group: ids equal in "
              f"all {len(la)} steps | losses {la} against {lb} (first "
              f"equal, max rel {rel:.3g}) | collectives a train step: calls"
              f" {calls}, bytes {nbytes} | whole run: {coll} | ms a step "
              f"{ms_a:.3f} without, {ms_b:.3f} with (one call; no claim)")
        print(" CLI-members-world1 with fused steps and interbatch:")
        modes["CLI-members-world1"] = phase_modes(tr, torch, "clique-HT")
        tr.close()
        del tr
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        _, _, _, tr = dist_run(
            data + ["--epoch", "1", "--devices", "1", "--clique-size", "1"]
            + world(), torch, "one member on H's dataset, a world of one "
            "rank (NCCL)", path="cli")
        print(" H-world1 with fused steps and interbatch:")
        modes["H-world1"] = phase_modes(tr, torch, "cli")
        tr.close()
        del tr
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"  phase 10 seconds: {time.perf_counter() - t0:.3f}")
    return modes


# ``--dist4``: the launcher's flags of each of four ranks, one card each:
# one clique of four members across the four processes (layout (b)), on
# the launcher's synthetic graph at H's widths, features and topology on
# the host behind the clique caches (the topology by ``DistRecorder``)
DIST4_RANKS = 4
DIST4_ARGS = ("--dataset-name", "synthetic", "--nodes", "2400000",
              "--avg-degree", "15", "--feature-dim", "100", "--classes",
              "32", "--epoch", "1", "--devices", "1", "--clique-size",
              str(DIST4_RANKS), "--num-processes", str(DIST4_RANKS),
              "--features", "host", "--cache-memory", str(CLIQUE_BYTES),
              "--train-batch-size", "8000", "--fanout", "25", "10",
              "--hidden", "256")
DIST4_TIMEOUT = 600


def dist4_rank(rank, port, torch):
    """One rank of ``phase_dist4`` on card ``rank``: the launcher
    (``dist_run``, NCCL) with ``DIST4_ARGS``, then ``phase_modes`` on its
    trainer, every rank in the same order; prints its A/B as JSON last."""
    import torch.distributed as dist

    from legion_tpu_torch.ops import kernels
    torch.cuda.set_device(rank)
    kernels.lib()
    try:
        _, _, coll, tr = dist_run(
            list(DIST4_ARGS) + ["--coordinator", f"127.0.0.1:{port}",
                                "--process-id", str(rank)], torch,
            f"rank {rank} of a clique across {DIST4_RANKS} cards (NCCL)")
        if tr.mesh.clique_group is None or tr.n_local != 1:
            fail(f"rank {rank}: not layout (b) (mesh {tr.mesh.shape})")
        print(f"  rank {rank}: collectives of the launcher's run {coll}")
        modes = phase_modes(tr, torch, "clique-HT")
        tr.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(modes))


def phase_dist4(torch):
    """Four cards: ``DIST4_RANKS`` processes of this script, one a card
    (``dist4_rank``), a clique across them in layout (b), where a step's
    exchanges are ``all_to_all_single`` calls in the clique's NCCL group
    and its gradients an all-reduce in the world's: the launcher's eager
    epoch, then replayed steps (the all-to-alls and all-reduces captured)
    and pipelined steps (the side stream's all-to-alls before the
    caller's all-reduces) against eager ones on every rank, and the A/B.
    Fails if a rank fails or the ranks take longer than DIST4_TIMEOUT
    (then every rank is killed). Prints rank 0's output and every rank's
    A/B."""
    import socket
    if torch.cuda.device_count() < DIST4_RANKS:
        fail(f"--dist4 needs {DIST4_RANKS} cards, found "
             f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print("  cards: " + " | ".join(smi))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory(prefix="legion_dist4_") as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(DIST4_RANKS)]
        procs = []
        for r, path in enumerate(logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank4",
                     str(r), str(port)], stdout=out,
                    stderr=subprocess.STDOUT, cwd=ROOT))
        t0 = time.perf_counter()
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.perf_counter() - t0 > DIST4_TIMEOUT:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = [open(path).read() for path in logs]
    print(texts[0])
    for r, (p, text) in enumerate(zip(procs, texts)):
        last = text.strip().splitlines()[-1:] or [""]
        print(f"  rank {r}: exit {p.returncode} | A/B {last[0]}")
        if p.returncode != 0:
            print(text[-4000:])
            fail(f"--dist4: rank {r} exited with {p.returncode} after "
                 f"{time.perf_counter() - t0:.1f} s")
    print(f"  --dist4: {DIST4_RANKS} ranks in "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# UnifiedCache.build from device tensors, fit's accuracy, int64 offsets
# ---------------------------------------------------------------------------

CACHE_FIELDS = ("cache_rows", "slot_map", "sub_indptr", "sub_indices",
                "row_map")


def same_bits(a, b, torch):
    """Whether two tensors (or two Nones) are equal bit for bit."""
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def phase_build(hds, plans, torch):
    """``UnifiedCache.build`` on device tensors (the f32 feature table, its
    bf16 cast and the CSR, copied to the card first) against
    ``build_from_host`` on the host arrays, at each plan of ``plans`` (H's
    and HT's: H's budget buys feature rows only) and at a plan of 200,000
    topology rows by degree, in f32 and bf16: every field equal bit for
    bit. Prints both set-up times (a sync ends each)."""
    import numpy as np
    from legion_tpu_torch.cache.cost_model import CostModelResult
    from legion_tpu_torch.cache.unified_cache import UnifiedCache
    g, V = hds.graph, hds.meta.num_nodes
    by_degree = np.argsort(-g.degrees(), kind="stable")
    plans = dict(plans, topology=CostModelResult(
        feature_capacity=0, topo_capacity=200_000, alpha=0.0,
        feature_order=by_degree, topo_order=by_degree,
        est_feat_saved_bytes=0.0, est_topo_saved_bytes=0.0))
    t0 = time.perf_counter()
    csr = g.to_device("cuda")
    f32 = torch.from_numpy(hds.features).to("cuda")
    tables = {"float32": f32, "bfloat16": f32.to(torch.bfloat16)}
    torch.cuda.synchronize()
    print(f"  the CSR and the features to the card in "
          f"{time.perf_counter() - t0:.3f} s (before either build)")
    for label, plan in plans.items():
        for dtype, feats in tables.items():
            t0 = time.perf_counter()
            dev = UnifiedCache.build(plan, feats, csr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = UnifiedCache.build_from_host(
                plan, hds.features, g.indptr, g.indices, V,
                feat_dtype=dtype, device="cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bad = [n for n in CACHE_FIELDS
                   if not same_bits(getattr(dev, n), getattr(host, n),
                                     torch)]
            if bad:
                fail(f"UnifiedCache.build at the {label} plan, {dtype}: "
                     f"{bad} differ from build_from_host's")
            edges = 0 if dev.sub_indices is None else dev.sub_indices.numel()
            print(f"  build at the {label} plan, {dtype}: feature rows "
                  f"{plan.feature_capacity}, topology rows "
                  f"{plan.topo_capacity} ({edges} edges) | build (device "
                  f"tensors) {t1 - t0:.3f} s | build_from_host (host arrays)"
                  f" {t2 - t1:.3f} s | equal bit for bit")
            del dev, host
    del csr, f32, tables
    torch.cuda.empty_cache()


# docs/RESULTS.md section 5: the reference's run of this configuration
FIT_ARGS = ("--dataset-name", "custom", "--train-batch-size", "2000",
            "--epoch", "3", "--hidden", "128")
FIT_MODES = {"plain": dict(fused_steps=1, interbatch=False),
             "fused 3": dict(fused_steps=3, interbatch=False),
             "interbatch": dict(fused_steps=1, interbatch=True)}
# the JAX package's record of that run on a TPU: an accuracy target,
# never a time
FIT_REF_VAL, FIT_REF_TEST = (0.6099, 0.9518, 0.9928), 0.9915
FIT_TEST_FLOOR = FIT_REF_TEST - 0.01
# the runs against the plain one: epoch losses rel 1e-3 (phase_fused's:
# K2's and K7's f32 atomics sum in another order in every run), valid and
# test accuracies within 2e-3 (20 of the 10,000 valid or test vertices)
FIT_LOSS_RTOL, FIT_ACC_ATOL = 1e-3, 2e-3


def phase_fit(torch):
    """``Trainer.fit`` through the launcher, as ``docs/RESULTS.md`` section
    5 ran the reference: the homophilous dataset (V 200,000, average
    degree 25, F 64, 16 classes, seed 0) written in Legion's layout by the
    port's ``write_legion_dataset`` and loaded from disk; batch 2000, 3
    epochs, hidden 128, fanouts [25, 10], the launcher's other defaults.
    Three runs: plain, ``fused_steps`` 3 (CUDA-graph replays; the epoch has
    9 train steps) and ``interbatch``, set on ``TrainConfig`` by wrapping
    ``run.build_config`` (the launcher has neither flag, in either
    package). Fails unless every run launched the Device path's kernels,
    its epoch losses and accuracies agree with the plain run's
    (``FIT_LOSS_RTOL``, ``FIT_ACC_ATOL``), and its test accuracy is at least
    ``FIT_TEST_FLOOR``, 0.01 under the reference's record."""
    from dataclasses import replace

    from legion_tpu_torch import run
    from legion_tpu_torch.data import (homophilous_dataset,
                                       write_legion_dataset)
    from legion_tpu_torch.ops import kernels
    runs = {}
    with tempfile.TemporaryDirectory(prefix="legion_fit_") as tmp:
        t0 = time.perf_counter()
        ds = homophilous_dataset(200_000, 25, 64, 16, batch_size=2000,
                                 seed=0)
        write_legion_dataset(tmp, ds.graph, ds.features, ds.labels,
                             ds.train_ids, ds.valid_ids, ds.test_ids)
        print(f"  wrote {tmp}: V={ds.meta.num_nodes} E={ds.meta.num_edges} "
              f"F={ds.meta.feature_dim} classes={ds.meta.num_classes} in "
              f"{time.perf_counter() - t0:.2f} s")
        del ds
        build = run.build_config
        for label, mode in FIT_MODES.items():
            argv = list(FIT_ARGS) + ["--dataset-path", tmp, "--device",
                                     "cuda"]
            print(f" {label} ({mode}): python -m legion_tpu_torch.run "
                  + " ".join(argv))

            def build_config(args, mode=mode):
                cfg = build(args)
                return replace(cfg, train=replace(cfg.train, **mode))
            kernels.reset_launch_counts()
            run.build_config = build_config
            try:
                t0 = time.perf_counter()
                tr, state, stats = run.main(argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                run.build_config = build
            missing = [n for n in PATH_KERNELS["device"]
                       if not kernels.LAUNCHES[n]]
            if missing:
                fail(f"fit {label}: {missing} never launched")
            runs[label] = ([st.train_loss for st in stats],
                           [st.valid_acc for st in stats], tr.test_acc)
            print(f"  fit {label}: {secs:.2f} s in all | epochs "
                  + ", ".join(f"{st.seconds:.3f} s" for st in stats)
                  + f" | caps {tr.compact_caps}")
            tr.close()
            del tr, state
            torch.cuda.empty_cache()
    loss0, val0, test0 = runs["plain"]
    print(f"  the reference's record (JAX on a TPU, docs/RESULTS.md 5): val "
          f"acc {' / '.join(map(str, FIT_REF_VAL))}, test acc "
          f"{FIT_REF_TEST}")
    for label, (loss, val, test) in runs.items():
        drift = max(abs(a - b) / abs(b) for a, b in zip(loss, loss0))
        acc_drift = max([abs(a - b) for a, b in zip(val, val0)]
                        + [abs(test - test0)])
        print(f"  fit {label}: losses {', '.join(f'{x:.6f}' for x in loss)} "
              f"| val acc {' / '.join(f'{x:.4f}' for x in val)} | test acc "
              f"{test:.4f} (reference {FIT_REF_TEST}, gap "
              f"{test - FIT_REF_TEST:+.4f}) | against plain: loss rel "
              f"{drift:.3g}, acc {acc_drift:.4f}")
        if not all(math.isfinite(x) for x in loss):
            fail(f"fit {label}: non-finite loss {loss}")
        if drift > FIT_LOSS_RTOL or acc_drift > FIT_ACC_ATOL:
            fail(f"fit {label}: against the plain run, losses rel {drift:.3g}"
                 f" (bound {FIT_LOSS_RTOL}), accuracies {acc_drift:.4f} "
                 f"(bound {FIT_ACC_ATOL})")
        if test < FIT_TEST_FLOOR:
            fail(f"fit {label}: test accuracy {test:.4f} under "
                 f"{FIT_TEST_FLOOR:.4f}, 0.01 below the reference's "
                 f"{FIT_REF_TEST}")
    return runs


INT64_NODES = 2 ** 24
INT64_DEGREES = (100, 160)      # drawn uniformly: E about 2.18e9
INT64_FRONTIER = 8000
INT64_FANOUT = 25


def phase_int64(torch, results):
    """K3 and K5 past offset 2^31. Builds on the card, with nothing on the
    host: V 2^24 vertices of degrees drawn in [100, 160] (E about 2.18e9,
    past 2^31), int64 offsets, ``indices[j] = j mod V``; then
    ``WindowedCSRAccess.from_csr`` (window 64: int64 pairs) and
    ``DeviceCSRAccess``. A frontier of 8000: the row that straddles 2^31,
    the last row, and rows from past 2^31 and from below it. One hop of
    fanout 25 through each kernel, exactly against its plain version on
    the same key words, and every drawn neighbour n of v in v's row:
    indptr[v] + ((n - indptr[v]) mod V) < indptr[v + 1] (the one position
    of n at or past the row's start, within 160 < V of it). Prints the
    set-up time, each kernel's ms and bound."""
    from legion_tpu_torch.graph import DeviceCSR
    from legion_tpu_torch.sampling import access
    V, fo, dev = INT64_NODES, INT64_FANOUT, "cuda"
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(64)
    deg = torch.randint(INT64_DEGREES[0], INT64_DEGREES[1] + 1, (V,),
                        generator=g, device=dev, dtype=torch.int64)
    indptr = torch.zeros(V + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=indptr[1:])
    del deg
    E = int(indptr[-1])
    if E < 2 ** 31:
        fail(f"int64: E {E} is not past 2^31")
    indices = torch.empty(E, dtype=torch.int32, device=dev)
    period = torch.arange(V, dtype=torch.int32, device=dev)
    for c in range(0, E, V):
        indices[c:c + V] = period[:min(V, E - c)]
    csr = DeviceCSR(indptr=indptr, indices=indices, num_nodes=V,
                    num_edges=E)
    windowed = access.WindowedCSRAccess.from_csr(csr, 64)
    direct = access.DeviceCSRAccess(csr)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if windowed.row_pairs.dtype != torch.int64:
        fail(f"int64: K3's pairs are {windowed.row_pairs.dtype}")
    # the row that straddles 2^31: the last that starts below it
    b = int(torch.searchsorted(indptr, torch.tensor(2 ** 31, device=dev))) - 1
    s_b, e_b = int(indptr[b]), int(indptr[b + 1])
    if not s_b < 2 ** 31 < e_b:
        fail(f"int64: row {b} spans [{s_b}, {e_b}), not across 2^31")
    half = (INT64_FRONTIER - 2) // 2
    past = torch.randint(b + 1, V - 1, (half,), generator=g, device=dev)
    below = torch.randint(0, b, (INT64_FRONTIER - 2 - half,), generator=g,
                          device=dev)
    front = torch.cat([torch.tensor([b, V - 1], device=dev), past, below])
    front = front[torch.randperm(front.numel(), generator=g, device=dev)]
    front = front.to(torch.int32).contiguous()
    key = access.hop_keys(0x64, 1, dev)[0]
    print(f"  int64 CSR on the card: V {V} E {E} ({E / 2 ** 31:.4f} x 2^31) "
          f"| indices {nb(indices) / 1e9:.2f} GB, windowed copy "
          f"{nb(windowed.indices2d) / 1e9:.2f} GB, offsets and pairs "
          f"{(nb(indptr) + nb(windowed.row_pairs)) / 1e9:.2f} GB | set-up "
          f"{setup:.2f} s | frontier {front.numel()}: row {b} [{s_b}, {e_b})"
          f" straddles 2^31, last row {V - 1}, {half} rows past 2^31, "
          f"{front.numel() - 2 - half} below")

    def in_rows(out, what):
        v = front.long().repeat(fo)
        s, e = indptr[v], indptr[v + 1]
        n = out.long()
        ok = (n >= 0) & (s + (n - s) % V < e)
        if not bool(ok.all()):
            fail(f"int64 {what}: {int((~ok).sum())} drawn neighbours lie "
                 "outside their rows")
        pos = s + (n - s) % V
        return int((pos >= 2 ** 31).sum()), int((v == b).sum())

    valid = front.numel()
    for name, kernel, plain, pair in (
            ("windowed_draw",
             lambda: windowed.sample_neighbors(front, fo, key),
             lambda: access.windowed_draw_plain(
                 windowed.row_pairs, windowed.indices2d, front, fo, key),
             2 * windowed.row_pairs.element_size()),
            ("csr_draw", lambda: direct.sample_neighbors(front, fo, key),
             lambda: access.csr_draw_plain(front, fo, key, indptr, indices),
             2 * indptr.element_size())):
        # the frontier, a slot's (start, degree) or its two offsets, one
        # int32 per draw read and one written
        least = bound(nb(front) + valid * pair + 8 * valid * fo + nb(key))
        compare(name, kernel, plain, exact, results, torch,
                f"int64 frontier {valid} fanout {fo}", least=least,
                queued=True)
        n_past, n_b = in_rows(kernel(), name)
        print(f"  {name:14s} int64: all {valid * fo} draws in their rows; "
              f"{n_past} at positions past 2^31, {n_b} from the straddling "
              f"row")
    del windowed, direct, csr, indices, indptr
    torch.cuda.empty_cache()


# the staged host pipeline (host_transfer="staged"), phase 6d and --staged:
# steps held against the zero-copy trainer, and the steps of the A/B of
# the two in turns
STAGED_STEPS = 5
STAGED_TURN_STEPS = 8
# K19's lanes a tile (csrc/staged.cu kCompactTile), for its edge cases
K19_TILE = 1024
STAGED_PARENT = {}
# K19's rank pass sums the words of its member's earlier tiles in this loop
# (csrc/staged.cu): tiles^2 / 2 words a call. K19_PROBE holds the tree's
# K19 built with the loop's read replaced by one read of the tile's
# exclusive prefix, which the harness sets (``k19_prefix_probe``)
K19_PREFIX_LOOP = ("for (int k = threadIdx.x; k < tile; k += "
                   "kCompactThreads) {\n      const int2 c = "
                   "cnt[m * tiles + k];")
K19_PREFIX_READ = ("if (threadIdx.x == 0) {\n      const int2 c = "
                   "k19_probe_pre[t];")
K19_PROBE = {}


def staged_parent_lib():
    """The parent commit's K19 and K21 (``parent_lib``: its
    ``staged.cu``), built once a run: (the library, None), or (None, why
    not)."""
    if not STAGED_PARENT:
        import ctypes
        so, why = parent_lib("K19, K21", ("staged.cu",), "staged_parent")
        if so is not None:
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            so.lt_miss_compact_scratch.argtypes = [i64, i64]
            so.lt_miss_compact_scratch.restype = ctypes.c_int64
            so.lt_miss_compact.argtypes = [p, i64, i64, p, i64, p, p, p, p,
                                           p, p, p, p, p, p]
            so.lt_merge_draws.argtypes = [p, p, p, i64, i64, i32, p, p]
            so.lt_miss_compact.restype = ctypes.c_int
            so.lt_merge_draws.restype = ctypes.c_int
        STAGED_PARENT.update(so=so, why=why)
    return STAGED_PARENT["so"], STAGED_PARENT["why"]


def k19_prefix_probe():
    """The tree's ``csrc/staged.cu`` built once a run into
    ``legion_tpu_torch/_build/k19_probe/`` with K19_PREFIX_LOOP replaced
    by K19_PREFIX_READ: the rank pass reads each tile's exclusive prefix
    (misses, hits) from ``k19_probe_pre``, set by
    ``lt_k19_probe_prefix``, instead of summing the words of the tiles
    before it. Given the right prefix its outputs are the tree's, bit for
    bit; its time against the tree's is that sum's. (the library, None),
    or (None, why not)."""
    if not K19_PROBE:
        import ctypes
        from legion_tpu_torch.ops import kernels
        csrc = os.path.join(ROOT, "legion_tpu_torch", "csrc")
        with open(os.path.join(csrc, "staged.cu")) as f:
            src = f.read()
        so, why = None, None
        if src.count(K19_PREFIX_LOOP) != 1:
            why = "K19_PREFIX_LOOP is not once in staged.cu"
        else:
            out = os.path.join(str(kernels.BUILD_DIR), "k19_probe")
            os.makedirs(out, exist_ok=True)
            cu = os.path.join(out, "staged_probe.cu")
            with open(cu, "w") as f:
                f.write('#include "common.cuh"\n'
                        "__device__ const int2* k19_probe_pre;\n"
                        + src.replace(K19_PREFIX_LOOP, K19_PREFIX_READ)
                        + "\nLT_EXPORT int lt_k19_probe_prefix(const void* p)"
                        " {\n  return (int)cudaMemcpyToSymbol(k19_probe_pre,"
                        " &p, sizeof(p));\n}\n")
            so_path = os.path.join(out, "k19_probe.so")
            kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                               csrc, "-shared", "-o", so_path, cu]])
            so = ctypes.CDLL(so_path)
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            so.lt_miss_compact_scratch.argtypes = [i64, i64]
            so.lt_miss_compact_scratch.restype = ctypes.c_int64
            so.lt_miss_compact.argtypes = [p, i64, i64, p, i64, p, p, p, p,
                                           p, p, p, p, p, p]
            so.lt_k19_probe_prefix.argtypes = [p]
            for fn in (so.lt_miss_compact, so.lt_k19_probe_prefix):
                fn.restype = ctypes.c_int
        K19_PROBE.update(so=so, why=why)
    return K19_PROBE["so"], K19_PROBE["why"]


def compact_call(fn, scratch_words, ids, form, cnt=None):
    """K19 through the C entry ``fn`` (the parent's kernel, or the tree's
    and its prefix probe's, with its ``scratch_words``), on the buffers
    the wrapper ``pipeline/staged.py::miss_compact`` makes (``cnt``, the
    n_miss, hits and scratch words, where given). A Compacted."""
    import torch
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline.staged import Compacted
    table, slot, hit = (form.get(k) for k in ("table", "slot", "hit"))
    src = next(iter(form.values())).contiguous()
    n, M = ids.shape
    out = torch.empty((4 if table is not None else 3, n, M),
                      dtype=torch.int32, device=ids.device)
    if cnt is None:
        cnt = torch.empty((2 * n + scratch_words(n, M),), dtype=torch.int32,
                          device=ids.device)
    payload = out[3] if table is not None else None
    rc = fn(ids.data_ptr(), n, M,
            None if table is None else src.data_ptr(),
            0 if table is None else table.shape[0],
            None if slot is None else src.data_ptr(),
            None if hit is None else src.data_ptr(),
            None if payload is None else payload.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            cnt[:n].data_ptr(), cnt[n:2 * n].data_ptr(),
            cnt[2 * n:].data_ptr(), kernels.stream_handle())
    if rc != 0:
        fail(f"miss_compact through {fn.__name__}: launch failed ({rc})")
    return Compacted(slot if payload is None else payload, out[0], out[1],
                     out[2], cnt[:n], cnt[n:2 * n])


def merge_call(fn, lanes, served, host, fo):
    """K21 through the C entry ``fn`` (the parent's kernel), as the
    wrapper ``sampling/access.py::merge_draws`` calls it."""
    import torch
    from legion_tpu_torch.ops import kernels
    n = 1 if served.dim() == 1 else served.shape[0]
    out = torch.empty_like(lanes)
    rc = fn(lanes.data_ptr(), served.data_ptr(), host.data_ptr(), n,
            served.shape[-1], fo, out.data_ptr(), kernels.stream_handle())
    if rc != 0:
        fail(f"merge_draws through {fn.__name__}: launch failed ({rc})")
    return out


def compact_turns(ids, form, least, what, torch):
    """K19 at a path's fetch in turns: the parent's kernel (where
    ``staged_parent_lib`` has one) and the tree's, each bit for bit; then
    the tree's against its prefix probe (``k19_prefix_probe``), queued in
    turns (tree, probe, probe, tree): the share of the tree's time that
    the rank pass's sum over the member's earlier tiles takes."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.pipeline.staged import (miss_compact,
                                                  miss_compact_plain)
    so, why = staged_parent_lib()
    fns = {}
    if so is None:
        print(f"  miss_compact turns: {why}; the tree's kernel alone")
    else:
        fns["parent"] = lambda: compact_call(
            so.lt_miss_compact, so.lt_miss_compact_scratch, ids, form)
    fns["tree"] = lambda: miss_compact(ids, **form)
    kernel_turns("miss_compact", what, fns, miss_compact_plain(ids, **form),
                 compacted_exact, least, torch)
    probe, why = k19_prefix_probe()
    if probe is None:
        print(f"  miss_compact prefix probe: {why}; not timed")
        return
    # each tile's exclusive prefix of (misses, hits) from the tree's tile
    # words (the scratch's head: a count pass writes them whole)
    lib = kernels.lib()
    n, M = ids.shape
    tiles = -(-M // K19_TILE)
    cnt = torch.empty((2 * n + lib.lt_miss_compact_scratch(n, M),),
                      dtype=torch.int32, device=ids.device)
    compact_call(lib.lt_miss_compact, lib.lt_miss_compact_scratch, ids,
                 form, cnt)
    words = cnt[2 * n:2 * n + 2 * n * tiles].view(n, tiles, 2)
    pre = (torch.cumsum(words, 1, dtype=torch.int32) - words).contiguous()
    if probe.lt_k19_probe_prefix(pre.data_ptr()) != 0:
        fail("miss_compact prefix probe: setting the prefix failed")
    calls = {"tree": lambda: compact_call(
        lib.lt_miss_compact, lib.lt_miss_compact_scratch, ids, form),
        "prefix read": lambda: compact_call(
            probe.lt_miss_compact, probe.lt_miss_compact_scratch, ids, form)}
    ref = miss_compact_plain(ids, **form)
    for lb, fn in calls.items():
        if not compacted_exact(fn(), ref)[1]:
            fail(f"miss_compact prefix probe: {lb} differs from the plain "
                 f"version, {what}")
    got = {lb: [] for lb in calls}
    for lb in ("tree", "prefix read", "prefix read", "tree"):
        got[lb].append(queued_ms(calls[lb], torch))
    tree, cut = min(got["tree"]), min(got["prefix read"])
    print(f"  miss_compact prefix probe, {what}: {n * tiles} tiles; queued "
          f"tree {', '.join(f'{t:.4f}' for t in got['tree'])}, prefix read "
          f"{', '.join(f'{t:.4f}' for t in got['prefix read'])} ms; the sum "
          f"over earlier tiles {tree - cut:.4f} ms, share "
          f"{(tree - cut) / tree:.3f} of the tree's")


def staged_ids(tr, a):
    """The fetch's ids [n, M] of program A's batch ``a``."""
    import torch
    M = tr.sampler_t.max_ids
    if tr.n_dev == 1:
        return a.batch.node_ids[:M][None]
    return torch.stack([b.node_ids[:M] for b in a.batch])


def staged_batch(tr, torch, ctr=0):
    """Program A of the staged trainer's train batch at ``ctr``, from a
    fresh sampler state and counter (the pipeline's own are left alone)."""
    key = torch.full((), tr._base_key, dtype=torch.int64, device="cuda")
    c = torch.full((), ctr, dtype=torch.int64, device="cuda")
    a = tr._staged._train_sample(tr._init_pos_map(), key, c, counts=False)
    torch.cuda.synchronize()
    return a


def compacted_exact(k, p):
    """K19's outputs, every field equal."""
    import torch
    fields = ("m_ids", "m_pos", "rank", "n_miss", "hits") + (
        ("payload",) if p.payload is not None else ())
    ok = all(getattr(k, f).shape == getattr(p, f).shape
             and torch.equal(getattr(k, f), getattr(p, f)) for f in fields)
    err = (k.rank.float() - p.rank.float()).abs().max().item() \
        if k.rank.numel() else 0.0
    return err, ok


def pair_exact(k, p):
    """(lanes, served) of K5's device-only form, both equal."""
    import torch
    ok = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    err = (k[0].float() - p[0].float()).abs().max().item() \
        if k[0].numel() else 0.0
    return err, ok


def compact_form(tr, ids):
    """K19's lookup operand on ``tr``'s path: the direct map, K11's slots
    or the clique's served lanes."""
    pipe = tr._staged
    if pipe.staged_clique:
        return dict(hit=tr.feature_source.fetch_cached(ids)[1])
    if pipe._hash is not None:
        return dict(slot=pipe._hash.lookup(ids))
    return dict(table=pipe._table)


def compact_bytes(ids, form):
    """K19's least bytes: the ids, the lookup (a map entry a valid id, or
    the slots or flags), the three [n, M] outputs (and the map's payload),
    n_miss and hits."""
    n, M = ids.shape
    valid = int((ids >= 0).sum())
    if "table" in form:
        return nb(ids) + 4 * valid + 16 * n * M + 8 * n
    return nb(ids) + nb(next(iter(form.values()))) + 12 * n * M + 8 * n


def host_copy(t, torch):
    """A pinned host copy of a device tensor."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def host_half_check(tr, a, torch, path):
    """The staged trainer's host half on its batch: the C++ gather against
    its plain version bit for bit, its time and rate by the host clock,
    and the bulk copy's time and rate by CUDA events. Returns (the device
    staging buffer the copy filled, the shipped rows a member)."""
    from legion_tpu_torch.ops.host_memory import (gather_host_rows,
                                                  gather_host_rows_plain,
                                                  host_threads)
    pipe = tr._staged
    cap = pipe.miss_cap
    ids_h = host_copy(a.comp.m_ids[:, :cap].contiguous(), torch)
    n_miss = a.comp.n_miss.tolist()
    ks = [min(v, cap) for v in n_miss]
    F, dt = pipe.feat_dim, pipe.dtype
    pin = torch.empty((pipe.n, cap, F), dtype=dt, pin_memory=True)
    ref = torch.zeros((pipe.n, cap, F), dtype=dt)
    takes, ptakes = [], []
    for rep in range(4):
        t0 = time.perf_counter()
        for m, k in enumerate(ks):
            gather_host_rows(pipe.host, ids_h[m, :k], pin[m, :k])
        takes.append(time.perf_counter() - t0)
    for rep in range(2):
        t0 = time.perf_counter()
        for m, k in enumerate(ks):
            gather_host_rows_plain(pipe.host, ids_h[m, :k], ref[m, :k])
        ptakes.append(time.perf_counter() - t0)
    for m, k in enumerate(ks):
        if not same_bits(pin[m, :k], ref[m, :k], torch):
            fail(f"gather_host_rows {path}: the C++ gather differs from its "
                 "plain version")
    rows = sum(ks)
    nbytes = rows * F * pin.element_size()
    ms = statistics.mean(takes[1:]) * 1e3
    print(f"  host gather {path}: {rows} rows of {F} {str(dt)[6:]} "
          f"({nbytes} B), {host_threads()} threads: C++ {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.2f} GB/s; takes "
          f"{', '.join(f'{x * 1e3:.3f}' for x in takes)} ms) | plain "
          f"{statistics.mean(ptakes) * 1e3:.3f} ms | bit for bit")
    dev = torch.empty((pipe.n, cap, F), dtype=dt, device="cuda")

    def copy():
        for m, k in enumerate(ks):
            if k:
                dev[m, :k].copy_(pin[m, :k], non_blocking=True)
    cms = cuda_ms(copy, torch, 10)
    print(f"  bulk copy {path}: {nbytes} B in {len(ks)} copies, {cms:.4f} ms"
          f" ({nbytes / cms / 1e6:.2f} GB/s) | miss_cap {cap} | n_miss "
          f"{n_miss} | eval_miss_cap {pipe.eval_miss_cap}")
    copy()
    torch.cuda.synchronize()
    return dev, ks


def staged_kernels(tr, torch, results, main, path):
    """K19 and K20 at the staged path's shapes (program A's batch at
    counter 0), each bit for bit against its plain version and timed,
    the host half (``host_half_check``), and K20's rows against the
    zero-copy fetch of the same ids (K4, or K13 with members): the same
    rows bit for bit."""
    from legion_tpu_torch.pipeline.staged import (miss_compact,
                                                  miss_compact_plain,
                                                  staged_assemble,
                                                  staged_assemble_plain)
    a = staged_batch(tr, torch)
    ids = staged_ids(tr, a)
    form = compact_form(tr, ids)
    n, M = ids.shape
    comp = miss_compact(ids, **form)
    miss = comp.rank >= 0
    what = f"{path} fetch [{n}, {M}], {int(comp.n_miss.sum())} missed"
    least = bound(compact_bytes(ids, form))
    main.setdefault("miss_compact", []).append(compare(
        "miss_compact", lambda: miss_compact(ids, **form),
        lambda: miss_compact_plain(ids, **form), compacted_exact, results,
        torch, what, least=least, library=lambda: torch.nonzero(miss),
        queued=True))
    compact_turns(ids, form, least, what, torch)
    dev, ks = host_half_check(tr, a, torch, path)
    cap = tr._staged.miss_cap
    rows, slot = a.rows, a.slot
    row = dev.shape[2] * dev.element_size()
    F = dev.shape[2]
    # rows read: each distinct cached row and each shipped row once (the
    # slot form), or one row a lane (the clique's rows of the lanes); x
    # written once
    read = distinct(slot) + sum(ks) if slot is not None else n * M
    least = bound(nb(comp.rank) + (0 if slot is None else nb(slot))
                  + (read + n * M) * row)
    main.setdefault("staged_assemble", []).append(compare(
        "staged_assemble",
        lambda: staged_assemble(rows, slot, dev, comp.rank, cap),
        lambda: staged_assemble_plain(rows, slot, dev, comp.rank, cap),
        bit_exact, results, torch,
        f"{path} x [{n}, {M}, {F}] {str(dev.dtype)[6:]}, {sum(ks)} shipped",
        least=least, queued=True))
    x = staged_assemble(rows, slot, dev, comp.rank, cap)
    fs = tr.feature_source
    zc = fs.fetch(ids)[0] if tr.n_dev > 1 else fs.fetch(ids[0])[0][None]
    if not same_bits(x, zc, torch):
        fail(f"{path}: the staged rows differ from the zero-copy fetch")
    print(f"  {path}: the assembled rows equal the zero-copy fetch's "
          f"{tuple(zc.shape)} bit for bit")
    return a


def device_draw(acc, front, fo, keys, tables, results, main, torch, what):
    """K5's device-only form on ``tables`` (row_map, sub_indptr,
    sub_indices), bit for bit against its plain version and timed into
    ``main``. Returns (lanes, served)."""
    from legion_tpu_torch.sampling import access as A
    row_map, sub_ip, _ = tables
    lanes, served = A.csr_draw_cached(front, fo, keys, *tables)
    F = front.shape[0]
    valid = int((front >= 0).sum())
    nsv = int(served.sum())
    r = row_map[front.clamp(min=0).long()].clamp(min=0).long()
    nzdeg = int(((sub_ip[r + 1] - sub_ip[r] > 0) & served).sum())
    # the frontier, a map entry a valid slot, a served slot's two offsets
    # and its draws' neighbours; the lanes and served out
    least = bound(nb(front) + 4 * valid + 16 * nsv + 4 * nzdeg * fo
                  + 4 * F * fo + F)
    main.setdefault("csr_draw_device", []).append(compare(
        "csr_draw_device",
        lambda: A.csr_draw_cached(front, fo, keys, *tables),
        lambda: A.csr_draw_cached_plain(front, fo, keys, *tables),
        pair_exact, results, torch, f"{what} {F} x {fo}, {nsv}/{valid} "
        "served", least=least, queued=True))
    return lanes, served


def host_half_draws(acc, front, served, fo, keys, n, torch, what):
    """The host's C++ draws of the unserved slots, bit for bit against
    their plain version and timed by the host clock; on the card."""
    from legion_tpu_torch.ops.host_memory import host_draw_plain
    miss = torch.where(served, -1, front)
    miss_h, keys_h = host_copy(miss, torch), host_copy(keys, torch)
    out = torch.empty(tuple(miss.shape) + (fo,), dtype=torch.int32,
                      pin_memory=True)
    takes = []
    for rep in range(3):
        t0 = time.perf_counter()
        acc.host_draw(miss_h, fo, keys_h, out)
        takes.append(time.perf_counter() - t0)
    hb = acc.fallback if n > 1 else acc
    ref = host_draw_plain(hb.host_indptr.host, hb.host_indices.host,
                          miss_h, fo, keys_h)
    if not torch.equal(out, ref):
        fail(f"host_draw {what}: the C++ draws differ from their plain "
             "version")
    print(f"  host draw {what}: {int((miss >= 0).sum())} slots x {fo} on "
          f"the host, C++ {', '.join(f'{x * 1e3:.3f}' for x in takes)} ms "
          "| bit for bit")
    return out.to("cuda")


def merge_checked(lanes, served, host, fo, n, results, main, torch, what):
    """K21 bit for bit against its plain version and timed into ``main``.
    Returns the merged lanes."""
    from legion_tpu_torch.sampling import access as A
    F = served.shape[-1]
    nsv = int(served.sum())
    # served, then a served slot's lanes or an unserved slot's host draws
    # (fanout int32 either way), the merged lanes out
    least = bound(nb(served) + 4 * fo * n * F + nb(lanes))
    what = f"{what} [{n}, {F}] x {fo}, {nsv} served"
    main.setdefault("merge_draws", []).append(compare(
        "merge_draws",
        lambda: A.merge_draws(lanes, served, host, fo),
        lambda: A.merge_draws_plain(lanes, served, host, fo),
        exact, results, torch, what, least=least, queued=True,
        library=lambda: torch.where(
            served.view(n, 1, F), lanes.view(n, fo, F),
            host.view(n, F, fo).transpose(1, 2))))
    so, why = staged_parent_lib()
    if so is None:
        print(f"  merge_draws turns: {why}; not timed in turns")
    else:
        kernel_turns("merge_draws", what, {
            "parent": lambda: merge_call(so.lt_merge_draws, lanes, served,
                                         host, fo),
            "tree": lambda: A.merge_draws(lanes, served, host, fo)},
            A.merge_draws_plain(lanes, served, host, fo), exact, least,
            torch)
    return A.merge_draws(lanes, served, host, fo)


def split_hops(tr, torch, results, main, path):
    """The staged path's hops, one batch: K5's device-only form (one
    member) or the clique's draws, the host's draws (C++ against plain,
    bit for bit, and timed) and K21, each kernel bit for bit against its
    plain version and timed, and the merge against ``sample_neighbors``
    (the zero-copy draws) exactly. With one member, the path's plan
    caches no topology rows, so K5's device-only form and K21 are also
    driven on the same frontiers against a topology-only cache of the
    same budget (``topo_only_cache``), whose rows they do draw: those are
    the times ``main`` keeps for K5's form, and the merge of those draws
    must equal ``sample_neighbors`` too."""
    from legion_tpu_torch.sampling import access as A
    acc = tr.graph_access
    s = tr.sampler_t
    n = tr.n_dev
    bs = s.config.batch_size
    bank = tr.train_bank.view(n, -1) if n > 1 else tr.train_bank[None]
    carries = [s.begin(bank[m, :bs].contiguous()) for m in range(n)]
    tc = topo_only_cache(tr, f"{path} hops") if n == 1 else None
    for k, fo in enumerate(s.config.fanouts):
        front = torch.stack([s.hop_frontier(c, k) for c in carries])
        keys = A.key_tensor([91 + 7 * m + k for m in range(n)], "cuda")
        if n == 1:
            front, keys = front[0], keys[0]
            lanes, served = device_draw(
                acc, front, fo, keys, (acc.row_map, acc.sub_indptr,
                                       acc.sub_indices),
                results, {}, torch, f"{path} hop {k}")
        else:
            lanes, served = acc.lookup(front, fo, keys)
        host = host_half_draws(acc, front, served, fo, keys, n, torch,
                               f"{path} hop {k}")
        merged = merge_checked(lanes, served, host, fo, n, results, main,
                               torch, f"{path} hop {k}")
        want = acc.sample_neighbors(front, fo, keys)
        if not torch.equal(merged, want):
            fail(f"{path} hop {k}: the split draws differ from "
                 "sample_neighbors")
        if tc is not None:
            what = f"{path} hop {k}, topology-only cache"
            t_lanes, t_served = device_draw(
                acc, front, fo, keys, (tc.row_map, tc.sub_indptr,
                                       tc.sub_indices),
                results, main, torch, what)
            t_host = host_half_draws(acc, front, t_served, fo, keys, n,
                                     torch, what)
            if not torch.equal(merge_checked(t_lanes, t_served, t_host, fo,
                                             n, results, {}, torch, what),
                               want):
                fail(f"{what}: the split draws differ from "
                     "sample_neighbors")
        merged = merged.view(n, -1)
        carries = [s.hop_absorb(c, k, merged[m])
                   for m, c in enumerate(carries)]
    print(f"  {path}: the split draws of both hops equal sample_neighbors "
          "bit for bit" + (", with the path's cache and the topology-only"
                           " one" if tc is not None else ""))


def staged_pair(tr_zc, tr_st, torch, path):
    """The staged trainer against the zero-copy one of the same seed:
    STAGED_STEPS losses and counters, then a valid pass (JAX's tolerance,
    rtol 1e-5 / atol 1e-6; on GraphSAGE equality is what happens)."""
    from legion_tpu_torch.pipeline import Mode
    s_zc, s_st = tr_zc.init_state(), tr_st.init_state()
    got = {"zero-copy": [], "staged": []}
    for _ in range(STAGED_STEPS):
        for tr, s, lb in ((tr_zc, s_zc, "zero-copy"), (tr_st, s_st,
                                                        "staged")):
            _, loss = tr.train_step(s)
            got[lb].append(torch.stack([loss.float()] + [
                getattr(tr, c).float() for c in (
                    "last_edges", "last_slots", "last_feat_hits",
                    "last_topo_hits", "last_topo_total")]))
    a, b = (torch.stack(got[k]).cpu() for k in ("zero-copy", "staged"))
    if not torch.equal(a[:, 1:], b[:, 1:]):
        fail(f"{path}-staged: counters {b[:, 1:].tolist()} against the "
             f"zero-copy trainer's {a[:, 1:].tolist()}")
    if not torch.allclose(b[:, 0], a[:, 0], rtol=1e-5, atol=1e-6):
        fail(f"{path}-staged: losses {b[:, 0].tolist()} against the "
             f"zero-copy trainer's {a[:, 0].tolist()}")
    _, acc_zc = tr_zc.run_eval(s_zc, Mode.VALID)
    _, acc_st = tr_st.run_eval(s_st, Mode.VALID)
    if abs(acc_zc - acc_st) > 1e-6:
        fail(f"{path}-staged: valid acc {acc_st} against {acc_zc}")
    print(f"  {path}-staged against zero-copy: {STAGED_STEPS} losses "
          f"{b[:, 0].tolist()} (zero-copy {a[:, 0].tolist()}, "
          f"{'equal' if torch.equal(a, b) else 'within rtol 1e-5'}) | "
          f"counters equal | valid acc {acc_st:.6f} (zero-copy "
          f"{acc_zc:.6f}) | overflows {tr_st._staged.miss_overflows} train, "
          f"{tr_st._staged.eval_miss_overflows} eval")


def staged_turn(tr, torch):
    """ms a step by the host clock over STAGED_TURN_STEPS steps after
    WARMUP_STEPS, a sync at the end; for a staged trainer also the host
    half's means (gather ms, ms from the ids' arrival to the copy's issue,
    the caller's ms waiting for it) and n_miss a step."""
    s = tr.init_state()
    for _ in range(WARMUP_STEPS):
        s, _ = tr.train_step(s)
    torch.cuda.synchronize()
    half = []
    t0 = time.perf_counter()
    for _ in range(STAGED_TURN_STEPS):
        s, _ = tr.train_step(s)
        p = tr._staged
        if p is not None:
            half.append((p.last_gather_s, p.last_half_s, p.last_wait_s,
                         sum(p.last_n_miss)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STAGED_TURN_STEPS * 1e3
    if not half:
        return ms, None
    g, h, w, nm = (statistics.mean(v) for v in zip(*half))
    return ms, (g * 1e3, h * 1e3, w * 1e3, nm, max(v[3] for v in half))


def staged_turns(tr_zc, tr_st, torch, path):
    """The zero-copy and staged trainers in turns (zero-copy, staged,
    staged, zero-copy) in one process: ms a step, and how much of the host
    half the step hides. Returns {label: [ms, ms]}."""
    runs = {"zero-copy": [], "staged": []}
    halves = []
    for lb, tr in (("zero-copy", tr_zc), ("staged", tr_st),
                   ("staged", tr_st), ("zero-copy", tr_zc)):
        ms, half = staged_turn(tr, torch)
        runs[lb].append(ms)
        if half:
            halves.append(half)
    g, h, w, nm, worst = (statistics.mean(v) for v in zip(*halves))
    grown = statistics.mean(runs["staged"]) - statistics.mean(
        runs["zero-copy"])
    print(f"  {path} in turns, ms a step (host clock): zero-copy "
          f"{', '.join(f'{x:.3f}' for x in runs['zero-copy'])} | staged "
          f"{', '.join(f'{x:.3f}' for x in runs['staged'])} (one call; no "
          f"claim): the staged step {grown:+.3f} ms")
    print(f"  {path}-staged host half a step: gather {g:.3f} ms, ids to "
          f"copy issued {h:.3f} ms, the caller waited {w:.3f} ms (hidden "
          f"{max(0.0, 1 - w / h) if h else 1.0:.3f} of it from the caller; "
          f"{1 - grown / h if h else 1.0:.3f} of it from the step's growth "
          f"over zero-copy) | n_miss "
          f"{nm:.0f} a step (worst {worst:.0f}) | miss_cap "
          f"{tr_st._staged.miss_cap} | overflows "
          f"{tr_st._staged.miss_overflows}")
    return runs


def staged_edges(torch, results):
    """K19, K20, K21 and K5's device-only form at the edges of their shapes,
    bit for bit against their plain versions: all hits, all misses, pads,
    an empty batch (all pads, and no lanes), n_miss past the cap and a cap
    of 0, tile edges, 4 members, f32 and bf16 rows of 1 to 128 columns at
    a misaligned base; K19 at its tiles' edges, past 32 tiles, at more
    tiles than resident blocks, 4 members of different n_miss; K5:
    nothing cached, everything cached, fanouts 1, 25 and 33; K21: nothing,
    half or everything served, fanouts 1 to 13000, 4 members. Also the
    host half's C++ against its plain version: ids past the table, pads,
    no ids, rows of degree 0 and vertices past V."""
    from legion_tpu_torch.ops import kernels
    from legion_tpu_torch.ops.host_memory import (
        HostTable, gather_host_rows, gather_host_rows_plain, host_draw,
        host_draw_plain)
    from legion_tpu_torch.pipeline.staged import (miss_compact,
                                                  miss_compact_plain,
                                                  staged_assemble,
                                                  staged_assemble_plain)
    from legion_tpu_torch.sampling import access as A
    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    V = 5000
    n_cases = 0

    def rand_ids(n, M, pad, V=V):
        ids = torch.randint(0, V, (n, M), generator=g, device="cuda",
                            dtype=torch.int32)
        return torch.where(torch.rand((n, M), generator=g, device="cuda")
                           < pad, -1, ids)

    def check(name, k, p, tol, what):
        err, ok = tol(k, p)
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if not ok:
            fail(f"{name} edge {what}: kernel disagrees with its plain "
                 "version")

    for n in (1, 4):
        for M in (0, 1, 2047, 2049, 70001):
            for pad, hot in ((0.0, 0.5), (0.2, 0.0), (0.2, 1.0), (1.0, 0.5),
                             (0.3, 0.5)):
                ids = rand_ids(n, M, pad)
                table = torch.where(
                    torch.rand(V, generator=g, device="cuda") < hot,
                    torch.arange(V, dtype=torch.int32, device="cuda"), -1)
                slot = torch.where(ids >= 0, table[
                    ids.clamp(min=0).long()], -1).to(torch.int32)
                hit = (slot >= 0) & (torch.rand(
                    (n, M), generator=g, device="cuda") < 0.8)
                for form in (dict(table=table), dict(slot=slot),
                             dict(hit=hit)):
                    k = miss_compact(ids, **form)
                    check("miss_compact", k, miss_compact_plain(ids, **form),
                          compacted_exact, f"n {n} M {M} pad {pad} hot "
                          f"{hot} {list(form)[0]}")
                    n_cases += 1
                for dt in (torch.float32, torch.bfloat16):
                    for F in (1, 3, 100, 128):
                        nm = int(k.n_miss.max()) if M else 0
                        for cap in {0, max(nm // 2, 1), nm + 5}:
                            C = 300
                            rows = torch.randn((C + 1, F), generator=g,
                                               device="cuda").to(dt)[1:]
                            st = torch.randn((n, cap, F), generator=g,
                                             device="cuda").to(dt)
                            sl = torch.where(slot >= 0, slot % C, -1)
                            check("staged_assemble",
                                  staged_assemble(rows, sl, st, k.rank, cap),
                                  staged_assemble_plain(rows, sl, st, k.rank,
                                                        cap), bit_exact,
                                  f"n {n} M {M} F {F} {dt} cap {cap}")
                            lane_rows = torch.randn(
                                (n, M, F), generator=g, device="cuda").to(dt)
                            check("staged_assemble",
                                  staged_assemble(lane_rows, None, st,
                                                  k.rank, cap),
                                  staged_assemble_plain(lane_rows, None, st,
                                                        k.rank, cap),
                                  bit_exact,
                                  f"lane rows n {n} M {M} F {F} {dt} cap "
                                  f"{cap}")
                            n_cases += 2
    # K20 at a misaligned base: rows and staged at an 8-byte offset
    rows = torch.randn((301, 100), generator=g, device="cuda").to(
        torch.bfloat16).view(-1)[4:].view(-1)[:300 * 100].view(300, 100)
    ids = rand_ids(1, 3000, 0.1, V=300)
    k = miss_compact(ids, table=torch.where(
        torch.rand(300, generator=g, device="cuda") < 0.5,
        torch.arange(300, dtype=torch.int32, device="cuda"), -1))
    st = torch.randn((1, 3001, 100), generator=g, device="cuda").to(
        torch.bfloat16).view(-1)[4:4 + 3000 * 100].view(1, 3000, 100)
    check("staged_assemble",
          staged_assemble(rows, k.payload, st, k.rank, 3000),
          staged_assemble_plain(rows, k.payload, st, k.rank, 3000),
          bit_exact, "misaligned bf16 rows")
    n_cases += 1
    # K19 at its tiles' edges (a tile less a lane, one tile, one more), past
    # 32 tiles, at more tiles than the card holds blocks at once (rank-pass
    # blocks that start before the count pass ends), and 4 members of
    # different n_miss (pads 5%, 40%, 90% and all), each in the map, slot
    # and served forms
    lib = kernels.lib()
    if not lib.lt_miss_compact_scratch(1, 1) == lib.lt_miss_compact_scratch(
            1, K19_TILE) < lib.lt_miss_compact_scratch(1, K19_TILE + 1):
        fail(f"staged_edges: K19_TILE {K19_TILE} is not staged.cu's tile")
    resident = torch.cuda.get_device_properties(0).multi_processor_count * 8
    member_pad = torch.tensor([0.05, 0.4, 0.9, 1.0], device="cuda")
    for n, M in ((1, K19_TILE - 1), (1, K19_TILE), (1, K19_TILE + 1),
                 (1, 40 * K19_TILE + 7), (1, resident * 3 // 2 * K19_TILE
                                          + 5),
                 (4, K19_TILE - 1), (4, K19_TILE + 1), (4, 33 * K19_TILE)):
        ids = rand_ids(n, M, 0.0)
        ids = torch.where(torch.rand((n, M), generator=g, device="cuda")
                          < member_pad[:n, None], -1, ids)
        table = torch.where(torch.rand(V, generator=g, device="cuda") < 0.5,
                            torch.arange(V, dtype=torch.int32,
                                         device="cuda"), -1)
        slot = torch.where(ids >= 0, table[ids.clamp(min=0).long()],
                           -1).to(torch.int32)
        hit = (slot >= 0) & (torch.rand((n, M), generator=g, device="cuda")
                             < 0.8)
        for form in (dict(table=table), dict(slot=slot), dict(hit=hit)):
            k = miss_compact(ids, **form)
            check("miss_compact", k, miss_compact_plain(ids, **form),
                  compacted_exact, f"tile edge n {n} M {M} "
                  f"{list(form)[0]}, n_miss {k.n_miss.tolist()}")
            n_cases += 1
    # K21 and K5's device-only form
    ip = torch.sort(torch.randint(0, 70_000, (V + 1,), generator=g,
                                  device="cuda")).values
    ip[0] = 0
    ip[V // 2:V // 2 + 50] = ip[V // 2]          # rows of degree 0
    E = int(ip[-1])
    ix = torch.randint(0, V, (E,), generator=g, device="cuda",
                       dtype=torch.int32)
    for share in (0.0, 0.5, 1.0):
        hot = torch.nonzero(torch.rand(V, generator=g, device="cuda")
                            < share).flatten()
        row_map = torch.full((V,), -1, dtype=torch.int32, device="cuda")
        row_map[hot] = torch.arange(hot.numel(), dtype=torch.int32,
                                    device="cuda")
        deg = ip[hot + 1] - ip[hot]
        sub_ip = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                            torch.cumsum(deg, 0)])
        pos = torch.repeat_interleave(ip[hot], deg) + (
            torch.arange(int(deg.sum()), device="cuda")
            - torch.repeat_interleave(sub_ip[:-1], deg))
        sub_ix = ix[pos] if pos.numel() else torch.full(
            (1,), -1, dtype=torch.int32, device="cuda")
        if hot.numel() == 0:     # a sub-CSR of no rows, as all_miss's
            sub_ip = torch.zeros(2, dtype=torch.int64, device="cuda")
        for F in (1, 777, 8000):
            for fo in (1, 25, 33):
                front = rand_ids(1, F, 0.1)[0]
                front[:3] = V + 5                  # past V: clamped
                key = A.key_tensor(F * 100 + fo, "cuda")
                check("csr_draw_device",
                      A.csr_draw_cached(front, fo, key, row_map, sub_ip,
                                        sub_ix),
                      A.csr_draw_cached_plain(front, fo, key, row_map,
                                              sub_ip, sub_ix),
                      pair_exact, f"F {F} fanout {fo} share {share}")
                lanes, served = A.csr_draw_cached(front, fo, key, row_map,
                                                  sub_ip, sub_ix)
                host = torch.randint(-1, V, (F, fo), generator=g,
                                     device="cuda", dtype=torch.int32)
                check("merge_draws", A.merge_draws(lanes, served, host, fo),
                      A.merge_draws_plain(lanes, served, host, fo), exact,
                      f"F {F} fanout {fo} share {share}")
                n_cases += 2
    # K21 with members: fanouts 1 to 64 at F not a multiple of a block's
    # slots (member rows off 16-byte alignment where F * fanout is odd),
    # and fanouts of 1000 (a few slots a block) and 13000 (cut in chunks
    # of columns); nothing, half or everything served
    shapes = [(4, 1000, 10), (2, 1, 1), (3, 0, 5)] + [
        (4, F, fo) for fo in (1, 10, 25, 33, 64)
        for F in (777, 8001, 40_003)] + [
        (4, F, fo) for fo in (1000, 13000) for F in (3, 41)]
    for n, F, fo in shapes:
        for share in (0.0, 0.5, 1.0):
            lanes = torch.randint(-1, V, (n, fo * F), generator=g,
                                  device="cuda", dtype=torch.int32)
            served = torch.rand((n, F), generator=g, device="cuda") < share
            host = torch.randint(-1, V, (n, F, fo), generator=g,
                                 device="cuda", dtype=torch.int32)
            check("merge_draws", A.merge_draws(lanes, served, host, fo),
                  A.merge_draws_plain(lanes, served, host, fo), exact,
                  f"members {n} F {F} fanout {fo} served {share}")
            n_cases += 1
    # the host half's C++ at its edges
    ip_h, ix_h = ip.cpu(), ix.cpu()
    feats = torch.randn((V, 128))
    for dt in (torch.float32, torch.bfloat16):
        tab = feats.to(dt)
        for F in (1, 100, 128):
            for n_ids in (0, 1, 5000, 100_000):
                ids = torch.randint(-5, V + 5, (n_ids,), dtype=torch.int32)
                out = torch.empty((n_ids, F), dtype=dt, pin_memory=True)
                ref = torch.empty((n_ids, F), dtype=dt)
                gather_host_rows(tab, ids, out)
                gather_host_rows_plain(tab, ids, ref)
                if not same_bits(out, ref, torch):
                    fail(f"gather_host_rows edge {dt} F {F} n {n_ids}")
                n_cases += 1
    for n, F, fo in ((1, 0, 5), (1, 9000, 25), (4, 3000, 10), (2, 7, 33)):
        front = torch.randint(-1, V + 3, (n, F), dtype=torch.int32)
        keys = A.key_tensor([F + m for m in range(n)], "cpu")
        out = torch.empty((n, F, fo), dtype=torch.int32, pin_memory=True)
        host_draw(ip_h, ix_h, front, fo, keys, out)
        if not torch.equal(out, host_draw_plain(ip_h, ix_h, front, fo,
                                                keys)):
            fail(f"host_draw edge members {n} F {F} fanout {fo}")
        n_cases += 1
    print(f"  staged_edges: {n_cases} cases of K19, K20, K21, K5's "
          "device-only form and the host half, bit for bit")


def staged_trainers(hds, torch, path, budget=None):
    """The zero-copy and the staged trainer of ``path`` (H, HT or
    clique-HT; clique-HT at the budget ``clique_trainer`` settled on)."""
    from legion_tpu_torch.train import Trainer
    if path == "clique-HT":
        mk = lambda tf: Trainer(hds, clique_config(  # noqa: E731
            hds, budget, host_transfer=tf), device="cuda")
    else:
        kw = dict(cache_bytes=CACHE_BYTES, feature_residency="host")
        if path == "HT":
            kw["topo_residency"] = "host"
        mk = lambda tf: host_trainer(  # noqa: E731
            hds, torch, f"{path}-{tf}", host_transfer=tf, **kw)
    t0 = time.perf_counter()
    tr_zc = mk("auto")
    t1 = time.perf_counter()
    tr_st = mk("staged")
    torch.cuda.synchronize()
    p = tr_st._staged
    print(f"  {path}: zero-copy set-up {t1 - t0:.2f} s | staged set-up "
          f"{time.perf_counter() - t1:.2f} s (with the probes) | miss_cap "
          f"{p.miss_cap} of M {tr_st.sampler_t.max_ids} | eval_miss_cap "
          f"{p.eval_miss_cap} of {tr_st.sampler_e.max_ids} | members "
          f"{p.n} | rows {str(p.dtype)[6:]}")
    return tr_zc, tr_st


def staged_hash(hds, tr_zc, torch, results):
    """H-staged with ``map_impl="hash"``: the single-card hash map over
    the cached rows, looked up by K11, then K19's slot form. K19 and K20
    at the path's shapes bit for bit, the assembled rows against the
    zero-copy fetch, and the staged trainer's losses, counters and valid
    accuracy against the zero-copy trainer's, with K11, K19 and K20
    launched in those steps."""
    from legion_tpu_torch.ops import kernels
    tr = host_trainer(hds, torch, "H-staged-hash", cache_bytes=CACHE_BYTES,
                      feature_residency="host", host_transfer="staged",
                      map_impl="hash")
    if tr._staged._hash is None:
        fail("H-staged-hash: the pipeline built no hash map")
    staged_kernels(tr, torch, results, {}, "H-hash")
    before = dict(kernels.LAUNCHES)
    staged_pair(tr_zc, tr, torch, "H-hash")
    torch.cuda.synchronize()
    ran = {k: kernels.LAUNCHES[k] - before[k]
           for k in ("hash_lookup", "miss_compact", "staged_assemble")}
    if not all(ran.values()):
        fail(f"H-staged-hash: launches in its steps {ran}")
    print(f"  H-staged-hash: launches in {STAGED_STEPS} steps and a valid "
          f"pass {ran}")
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_staged(hds, torch):
    """Phase 6d (and ``--staged``): the staged host pipeline on H, HT and
    clique-HT (4 members on the card, at the budget ``clique_trainer``
    settles on). For each: K19 and K20 at the path's shapes, bit for bit
    and timed, the host half (C++ gather and bulk copy), the assembled
    rows against the zero-copy fetch; on HT and clique-HT the hops' split
    draws (K5's device-only form, the host's draws, K21) against
    ``sample_neighbors``; the staged trainer's losses, counters and valid
    accuracy against the zero-copy trainer's (``staged_pair``); the
    staged path through ``phase_slice`` (its launches); both trainers'
    ms a step in turns with the host half's hidden share. Then
    ``staged_edges``. Returns (kernel results, launch counts by path, the
    turns by path)."""
    results, main, counts, turns = {}, {}, {}, {}
    budget = None
    for path in ("H", "HT", "clique-HT"):
        print(f" {path}-staged:")
        if path == "clique-HT":
            tr0, budget = clique_trainer(hds, torch)
            tr0.close()
            del tr0
            torch.cuda.empty_cache()
        tr_zc, tr_st = staged_trainers(hds, torch, path, budget)
        staged_kernels(tr_st, torch, results,
                       main if path == "H" else {}, path)
        if path != "H":
            split_hops(tr_st, torch, results,
                       main if path == "HT" else {}, path)
        staged_pair(tr_zc, tr_st, torch, path)
        counts[f"{path}-staged"], _ = phase_slice(tr_st, torch,
                                                  f"{path}-staged")
        turns[path] = staged_turns(tr_zc, tr_st, torch, path)
        if path == "H":
            staged_hash(hds, tr_zc, torch, results)
        tr_st.close()
        tr_zc.close()
        del tr_zc, tr_st
        torch.cuda.empty_cache()
    staged_edges(torch, results)
    add_main(results, main)
    return results, counts, turns


def staged_summary(res, counts):
    """The staged kernels' numbers a train step of their paths."""
    for n in ("miss_compact", "staged_assemble", "merge_draws",
              "csr_draw_device"):
        r, c = res[n], counts[REPORTED_PATH[n]]
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"  {n:16s} launches a step {c['per_step'][n]:g} | kernel "
              f"{r['ms']:.4f} ms | queued {r['queued_ms']:.4f} ms | bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (share "
              f"{r['bound_ms'] / r['queued_ms']:.3f} queued) | plain "
              f"{r['plain_ms']:.4f} ms | library {lib}")


def bulk_link_bps(hds, torch):
    """The bulk-copy rate from the registered feature table (as
    ``link_probe`` measures it), for the bounds of ``--clique`` runs."""
    from legion_tpu_torch.ops.host_memory import HostTable
    ht = HostTable(hds.features, pin=True)
    words = 466_475 * hds.meta.feature_dim
    dst = torch.empty(words, dtype=torch.float32, device="cuda")
    flat = ht.device.view(-1)
    ms = cuda_ms(lambda: dst.copy_(flat[:words], non_blocking=True), torch)
    ht.close()
    bps = words * 4 / ms * 1e3
    print(f"  link: bulk copy {bps / 1e9:.2f} GB/s")
    return bps


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
    if sys.argv[1:2] == ["--rank4"]:
        dist4_rank(int(sys.argv[2]), int(sys.argv[3]), torch)
        return
    if sys.argv[1:2] == ["--profile"]:
        from legion_tpu_torch.ops import kernels
        kernels.lib()
        fused = sys.argv[4].split(",") if sys.argv[3:4] == ["--fused"] \
            else ("1",)
        phase_profile(sys.argv[2].split(","), torch, fused)
        return

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

    if sys.argv[1:2] == ["--k15"]:
        phase_k15(torch)
        return
    if sys.argv[1:2] == ["--k16"]:
        phase_k16(torch)
        return
    if sys.argv[1:2] == ["--attn"]:
        phase_attn(torch)
        return
    if sys.argv[1:2] == ["--clique-kernels"]:
        hds = host_dataset()
        MEASURED["link_bps"] = bulk_link_bps(hds, torch)
        phase_clique(hds, torch, kernels_only=True)
        return
    if sys.argv[1:2] == ["--clique"]:
        hds = host_dataset()
        MEASURED["link_bps"] = bulk_link_bps(hds, torch)
        res, counts, _, modes = phase_clique(hds, torch)
        print_modes(modes)
        for n in ("hash_lookup", "bucket_by_owner", "clique_gather",
                  "clique_draw"):
            r, c = res[n], counts[REPORTED_PATH[n]]
            print(f"  {n:16s} launches a step {c['per_step'][n]:g} | kernel "
                  f"{r['ms']:.4f} ms | bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']} | plain {r['plain_ms']:.4f} ms | library "
                  f"{r['library_ms']}")
        return
    if sys.argv[1:2] == ["--link"]:
        k4_edges(torch)
        clique_edges(torch, {})
        hds = host_dataset()
        tr_h = host_trainer(hds, torch, "H", cache_bytes=CACHE_BYTES,
                            feature_residency="host")
        tr_ht = host_trainer(hds, torch, "HT", cache_bytes=CACHE_BYTES,
                             feature_residency="host", topo_residency="host")
        res = phase_host_kernels(tr_h, tr_ht, torch)
        tr_h.close()
        tr_ht.close()
        del tr_h, tr_ht
        torch.cuda.empty_cache()
        res.update(phase_clique(hds, torch)[0])
        for n in ("cached_gather", "clique_gather"):
            r = res[n]
            print(f"  {n:16s} kernel {r['ms']:.4f} ms | bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} | plain "
                  f"{r['plain_ms']:.4f} ms | library {r['library_ms']}")
        return
    if sys.argv[1:2] == ["--dist4"]:
        phase_dist4(torch)
        return
    if sys.argv[1:2] == ["--staged"]:
        hds = host_dataset()
        MEASURED["link_bps"] = bulk_link_bps(hds, torch)
        print("phase 6d: the staged host pipeline on H, HT and clique-HT")
        res, counts, _ = phase_staged(hds, torch)
        staged_summary(res, counts)
        return
    if sys.argv[1:2] == ["--int64"]:
        print("phase 12: K3 and K5 past offset 2^31")
        phase_int64(torch, {})
        return
    if sys.argv[1:2] == ["--dist"]:
        k10_offsets(torch, 2)
        clique_edges(torch, {})
        hds = host_dataset()
        with tempfile.TemporaryDirectory(prefix="legion_cli_") as tmp:
            print_modes(phase_dist(cli_dataset(hds, tmp), torch))
        return

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

    if sys.argv[1:2] == ["--segment"]:
        del tr
        tr = Trainer(ds, bench_config(ds, model="gcn"), device="cuda")
        res = {}
        phase_segment(tr, torch, res, {}, turns=True)
        segment_edges(torch, res)
        k2_edges(torch, res)
        del tr
        phase_three_hop(ds, torch, smi)
        return

    print("phase 2: kernels against their plain versions")
    results = phase_kernels(tr, torch)
    if sys.argv[1:2] == ["--kernels"]:
        del tr
        tr = Trainer(ds, bench_config(ds, model="gcn"), device="cuda")
        k2_gcn_compare(tr, torch, results)
        k15_gcn_compares(tr, torch, results)
        dedup_compares(tr, torch, results, {}, gcn=True)
        return

    print("phase 3: the main path (train steps, then an eval pass), and "
          f"its steps as CUDA-graph replays (fused_steps {FUSED_K})")
    counts = {"device": phase_slice(tr, torch, "device")[0]}
    phase_fused(tr, torch, "device")
    prefix_check(tr, torch, "device")
    del tr
    torch.cuda.empty_cache()
    print(" device-map (the same with map dedup, the config's default):")
    tr = Trainer(ds, bench_config(ds, dedup="map"), device="cuda")
    print(f"  caps {tr.compact_caps} | ids_len {tr.sampler_t.ids_len}")
    counts["device-map"] = phase_slice(tr, torch, "device-map")[0]
    phase_fused(tr, torch, "device-map")
    prefix_check(tr, torch, "device-map")
    ib_ab = {"device-map": phase_interbatch(tr, torch, "device-map")}
    del tr
    torch.cuda.empty_cache()

    print("phase 3b: GAT, GCN and lp_sage on the device dataset "
          "(bench.py --model X)")
    main_ms = {}
    for model in ("gat", "gcn", "lp_sage"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(ds, bench_config(ds, model=model), device="cuda")
        torch.cuda.synchronize()
        s = tr.sampler_t
        print(f" {model}: set-up {time.perf_counter() - t0:.2f} s | caps "
              f"{tr.compact_caps} | frontier sizes {s.frontier_sizes} | "
              f"edge sizes {s.edge_sizes} | max_ids {s.max_ids}")
        if model == "gat":
            k6_compares(tr, torch, results, main_ms)
            k6_keep_sets(tr, torch)
            k6_edges(torch, results)
            k7_compares(tr, torch, results, main_ms)
            k7_keep_sets(torch)
            k7_edges(torch, results)
        elif model == "gcn":
            counts["segment"] = phase_segment(tr, torch, results, main_ms)
            segment_edges(torch, results)
            k7_exact_compares(tr, torch, results)
            main_ms["segment_sum"] = k2_gcn_compare(tr, torch, results)
            k15_gcn_compares(tr, torch, results)
            dedup_compares(tr, torch, results, main_ms, gcn=True)
        elif model == "lp_sage":
            k15_lp_compares(tr, torch, results)
        k16_compares(tr, torch, results, main_ms, model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts[model] = phase_slice(tr, torch, model)[0]
        if model == "lp_sage":
            prefix_check(tr, torch, model)
        if model in FUSED_PATHS:
            phase_fused(tr, torch, model)
        if model in INTERBATCH_PATHS:
            ib_ab[model] = phase_interbatch(tr, torch, model)
        del tr
        torch.cuda.empty_cache()
    print("phase 3c: the Device path at three hops")
    counts["device-3hop"] = phase_three_hop(ds, torch, smi)
    add_main(results, main_ms)
    for path, name in (("gat", "gat_attend"), ("gat", "hop_attention"),
                       ("device", "dropout_act"), ("segment", "segment_max"),
                       ("segment", "segment_softmax")):
        counts[path][name] += counts[path][name + "_bwd"]
        counts[path]["per_step"][name] += \
            counts[path]["per_step"][name + "_bwd"]

    print("phase 4: small-input slices, card vs CPU")
    del ds
    torch.cuda.empty_cache()
    phase_reference(torch)

    print("set-up: host-resident dataset (bench.py --features host) and "
          "trainers")
    t0 = time.perf_counter()
    hds = host_dataset()
    g = hds.graph
    print(f"  datagen {time.perf_counter() - t0:.2f} s (numpy, host) | V "
          f"{hds.meta.num_nodes} E {hds.meta.num_edges} | host features "
          f"{hds.features.nbytes / 1e9:.3f} GB f32 | host CSR "
          f"{(g.indptr.nbytes + g.indices.nbytes) / 1e9:.3f} GB")
    tr_h = host_trainer(hds, torch, "H", cache_bytes=CACHE_BYTES,
                        feature_residency="host")
    tr_ht = host_trainer(hds, torch, "HT", cache_bytes=CACHE_BYTES,
                         feature_residency="host", topo_residency="host")

    print("phase 5: K4 and K5 against their plain versions at HT's shapes")
    results.update(phase_host_kernels(tr_h, tr_ht, torch))
    k15_aligned_compare(tr_h, torch, results)

    print("phase 6: host-resident slice: H, HT, then the cache off")
    step_ms = {}
    plans = {"H": tr_h.cache_plan, "HT": tr_ht.cache_plan}
    for name, tr in (("H", tr_h), ("HT", tr_ht)):
        print(f" {name}:")
        counts[name], step_ms[name] = phase_slice(tr, torch, name)
        table_step_ab(tr, torch, name)
        if name in FUSED_PATHS:
            phase_fused(tr, torch, name)
        ib_ab[name] = phase_interbatch(tr, torch, name)
        tr.close()
    del tr, tr_h, tr_ht
    torch.cuda.empty_cache()
    tr = host_trainer(hds, torch, "cache-off")
    print(" cache-off:")
    counts["cache-off"], step_ms["cache-off"] = phase_slice(
        tr, torch, "cache-off")
    del tr
    torch.cuda.empty_cache()
    print("  step ms H / cache-off "
          f"{step_ms['H'] / step_ms['cache-off']:.3f} | HT / cache-off "
          f"{step_ms['HT'] / step_ms['cache-off']:.3f} (one call; no claim)")

    print("phase 6b: GAT on the host dataset (bench.py --model gat "
          "--features host): K6 at its layer 0, then the gat-H path")
    tr = host_trainer(hds, torch, "gat-H", **GAT_H)
    k6_compares(tr, torch, results, {}, "gat-H")
    k16_compares(tr, torch, results, {}, "gat-H")
    counts["gat-H"], step_ms["gat-H"] = phase_slice(tr, torch, "gat-H")
    tr.close()
    del tr
    torch.cuda.empty_cache()

    print("phase 6c: UnifiedCache.build from device tensors against "
          "build_from_host, at H's and HT's plans")
    phase_build(hds, plans, torch)

    print("phase 6d: the staged host pipeline on H, HT and clique-HT")
    res_s, counts_s, staged_ab = phase_staged(hds, torch)
    results.update(res_s)
    counts.update(counts_s)

    print("phase 7: small-input HT slice, card vs CPU")
    phase_host_reference(torch)

    print("phase 8: the launcher from a dataset on disk (host mode, "
          "checkpoint, resume)")
    with tempfile.TemporaryDirectory(prefix="legion_cli_") as tmp:
        d = cli_dataset(hds, tmp)
        phase_cli(d, tmp, torch, step_ms["H"])

        print(f"phase 9: the clique caches, {CLIQUE_KG} members on the card")
        res_c, counts_c, step_ms["clique-HT"], modes = phase_clique(
            hds, torch)
        results.update(res_c)
        counts.update(counts_c)
        del hds

        print(f"phase 10: the launcher's members ({CLIQUE_KG} on the card), "
              "without and with a process group, and one member in a world")
        modes.update(phase_dist(d, torch))
    torch.cuda.empty_cache()

    print("phase 11: fit through the launcher as docs/RESULTS.md 5 ran the "
          "reference: plain, fused_steps 3, interbatch")
    phase_fit(torch)

    print("phase 12: K3 and K5 past offset 2^31")
    phase_int64(torch, results)

    kern = [dict(name=n, route="cuda", source=KERNELS[n]["source"],
                 replaces=KERNELS[n]["replaces"],
                 launches=counts[REPORTED_PATH[n]][n],
                 launches_per_step=counts[REPORTED_PATH[n]]["per_step"][n],
                 max_abs_err=results[n]["max_abs_err"],
                 ms=results[n]["ms"], plain_ms=results[n]["plain_ms"],
                 bound_ms=results[n]["bound_ms"],
                 bound_by=results[n]["bound_by"],
                 library_ms=results[n]["library_ms"],
                 queued_ms=results[n]["queued_ms"])
            for n in KERNELS]
    print("per train step of each kernel's path (the sums over its launches "
          "there):")
    for k in kern:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"  {k['name']:14s} launches {k['launches_per_step']:g} | "
              f"kernel {k['ms']:.4f} ms | bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']} (share {k['bound_ms'] / k['ms']:.3f}) | plain "
              f"{k['plain_ms']:.4f} ms | library call {lib} ms")
    print_modes(modes)
    print("interbatch A/B, ms/step by the host clock (one call; no claim):")
    for path, runs in ib_ab.items():
        print(f"  {path}: " + " | ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in ms)}"
            for k, ms in runs.items()))
    print("staged against zero-copy, in turns, ms/step by the host clock "
          "(one call; no claim):")
    for path, runs in staged_ab.items():
        print(f"  {path}: " + " | ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in ms)}"
            for k, ms in runs.items()))
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
