#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
sm_90a), holds each kernel against its plain PyTorch version on the card,
then drives two paths, with the launch counters zeroed just before each
run and read just after:

- the exact Lloyd fit (``KMeans.fit`` / ``fit_batched`` and the online
  ``iterate``) at the widths of the paper's four regimes
  (``benchmarks/bench_e2e.py``), smallN_smallK in f32 and bf16, and at
  smallN_smallK f32 also the path auto does not take;
- FlashIVF search (``repro_torch.index.IVFIndex``) at the FAISS
  ``IVF1024,Flat`` configuration on SIFT1M (N = 1,048,576, d = 128,
  K = 1,024; a synthetic corpus of 1,024 Gaussian blobs made on the card
  from the seed): ``build``, then batches of 256 queries at ``topk=10``,
  ``nprobe=16``, with the ``fp32`` and the ``q8`` codec, recall@10 held
  against ``search_brute`` and against the corpus's own exact neighbours;
  the fp32 and q8 searches (the store scans, which read the probed cells
  in place) held to the block path (the gathered candidate block and the
  grouped scan) on the same batch, and to the same search with the probe's
  and the rescore's list modes (batch times, recall, device profiles); and
  full-probe exactness on a smaller index. The q8 search reads its rescore
  rows from the device rescore cache (``rescore="device"``, the default),
  held bit for bit to the host reservoir's path on every batch; both cells'
  warm searches run under ``torch.cuda.set_sync_debug_mode("error")``;
- serving: ``SearchEngine(query_batch=256, pipeline_depth=2)`` over both
  IVF cells, 64 ragged search requests of 1-512 rows with 4 interleaved
  adds of 4,096 rows (``refresh_every=2``), each request held bit for bit
  to the same op stream through a synchronous engine (``pipeline_depth=1``)
  over a copy of the index;
- the two-level router (``TwoLevelRouter``, ``search(nprobe_c=)``) at the
  reference's routed regime (``benchmarks/bench_index.py:152-210``) at
  d = 128: K = 65,536 fine centroids around 512 meta-centres, 64 rows a
  cell (N = 4,194,304) added in chunks, a flat and a routed index over one
  store, fp32 and q8, B = 16, 64 (the reference's) and 256 at nprobe 10
  to 64 (batch times, device time by kernel, recall@10 against
  ``search_brute``, the planner's ``route`` verdict), a warm routed
  search without a host sync, and probe lists that end in the sentinel
  cell (``nprobe_c = 1``); and at the IVF1024 cell, the routed index at
  nprobe = K returns the flat index's ids;
- the paged store (``IVFIndex(..., store="paged", page_size=64)``): at both
  IVF cells the same centroids and corpus in a paged store, its batches
  (flat, and two-level over one router) bit for bit the padded index's,
  its resident bytes and batch times beside the padded ones, and the q8
  cell served through ``SearchEngine`` as above; at the exactness index,
  nprobe = K bit for bit the padded index's; ``paged_skew``, the IVF
  cell's blob centres with each row's cell drawn from Zipf(1.0) (seed 15),
  added in chunks of 262,144, a corpus the padded layout could not grow to
  on the card (recall@10 against ``search_brute``, each add's allocator
  time); ``paged_evict``, the uniform corpus by blob into a store of half
  its page bytes (rows evicted, the count identity, ids in the posting
  lists, the last add's cells kept);
- reliability (``repro_torch.reliability``, ``reliability_phase``) at the
  IVF cell's width over a padded fp32 flat index and a paged q8 two-level
  index: the add path bit for bit from run to run (65,536 rows over K = 8,
  and the phase's adds); a ``SearchEngine`` under a ``HealthPolicy`` with
  a write-ahead log, killed as its second snapshot begins, and
  ``SearchEngine.recover`` bit for bit the uninterrupted engine (index
  state, a held-out batch); a snapshot round trip (the q8 cache re-warms);
  seeded chaos (``FaultPlan.seeded(7, 8, 9)``): nothing raises, every
  distance finite, units at the configured nprobe return a fault-free
  engine's ids; snapshot save/load, recover and replay, a WAL append,
  ``clone_index``, ``guard_batch`` and queries/s with and without the
  policy timed;
- the parallel layer (``repro_torch.core.parallel``, ``parallel_phase``):
  in this process, a world of one rank over NCCL, the distributed Lloyd fit
  at largeN_smallK (N = 8,388,608, K = 1,024, d = 128, 5 iterations) bit
  for bit ``KMeans.fit`` through ``ParallelContext.for_mesh``, and through
  an explicit cells axis (the two-stage path) its first ids bit for bit
  and its centroids within tolerance, with the ms an iteration of each
  against ``KMeans.iterate``; ``StreamingKMeans(pctx=)`` over phase 8's
  stream bit for bit; ``launch/serve.py --mode search --mesh 1x1``. Then
  ranks spawned on the one card over gloo: two at mesh 2x1 (the same fit:
  one iteration's ids bit for bit, the centroids within tolerance) and at
  mesh 1x2 at largeN_largeK (the two-stage argmin bit for bit FlashAssign,
  one K-sharded iteration, ``owned_stats`` and its extra bucket against the
  plain version); four at mesh 2x2 at the IVF cell (a sharded and a
  single-rank index from the same centroids, ids bit for bit before and
  after an add of 4,096 rows and a refresh; full probe on the exactness
  corpus against ``search_brute``; ``build(pctx=)`` recall), and the
  sharded index's search axes. Part (e), the sharded index's reliability
  (``rel_mesh_part``) over phase 11's two indexes at the IVF cell, on a 1x1
  NCCL mesh against one device and on 2x2 gloo ranks: ``dead_shard`` equal
  to the brute force over the surviving shards' rows, ``nan_stats`` and the
  guarded refresh, the dead cells' repair, chaos seeds 7-9 with equal
  counters on every rank, a durability run killed and recovered onto the
  mesh bit for bit the uninterrupted run, its snapshot the one-device
  twin's key for key and restored onto 1x4, 4x1 and one device bit for
  bit, and the launcher's ``--mesh 1x1`` with every reliability flag.
  Every rank reports its kernel launches; times at two or four ranks are
  ranks time-slicing one card;
- LM serving (``repro_torch.models``, ``repro_torch.serve.Engine``,
  ``lm_phase``) at the full width of Llama-3-8B (32 layers, d_model 4,096,
  GQA 32/8 heads, d_ff 14,336, vocab 128,256; f32, random weights from the
  seed): ``kmeans_routed_attention`` at S 2,048 over 32 heads (one cluster
  equal to dense attention, 16 through FlashAssign); dense prefill of 128
  tokens and 128 decode steps, each equal to the full forward; the clustered
  engine at B 4, prompt 2,048, 32 steps (kc 64, cap 128, two incremental
  re-clusters: every logit finite, the buckets' invariants) beside the dense
  engine; FlashAssign, the sort-inverse update and FlashLloyd at the
  clustered cache's shape (1,024 problems of N 2,048, K 64, d 128) against
  their plain versions; with the depth cut to 4 layers and every cluster
  read (cap 2,176), the clustered engine's greedy ids equal to the dense
  engine's; and ``launch/serve.py --mode clustered`` at B 4. It starts
  once the earlier phases' tensors are freed (checked: under 1 GiB
  allocated). The serving path's runs count as main-path launches; the cut
  4-layer engines, the routed calls and the kernel checks are named checks;
- the rest of the LM zoo (``zoo_phase``): zamba2-7b at full width and depth
  (54 Mamba2 layers and 27 applications of one shared attention block of 32
  heads of 112; f32, random weights): dense prefill of 128 tokens and 128
  decode steps, each equal to the full forward; the clustered engine at B
  4, prompt 2,048, 32 steps (the shared block's 27 caches: 3,456 problems
  of N 2,048, K 64, d 112, two flushes) beside the dense engine; kernels 1-3
  at that shape against their plain versions; with the depth cut to 2
  groups and every cluster read, greedy ids equal to the dense engine's;
  the launcher with ``--arch zamba2-7b``. Then granite-moe, minicpm3 (MLA),
  xLSTM, phi-3-vision (576 patches), whisper-base (1,500 frames) at full
  width and dbrx-132b cut to 2 layers, B 1, prompt 128, 16 steps: prefill
  and decode against the forward (MoE with one token a group; xLSTM block
  by block), and ``Engine`` in both modes. Its serving runs and the
  full-depth engines count as main-path launches;
- training (``train_phase``, f32 masters, random weights): granite-moe-1b-
  a400m at full width and depth through ``launch/train.py`` (B 2, S 4,096,
  bfloat16 with remat, 20 steps, a checkpoint every 10; the loss must
  fall), the fault contract at depth 2 (a fault at step 9 replayed, a
  SIGTERM at step 6 resumed, both bit for bit an uninterrupted run),
  llama3-8b with ``kmeans_attn`` at depth 2 and S 4,096 (kernels 1-3 on a
  layer's keys and queries against their plain versions, the flash step
  against the plain one, remat against none, 4 counted steps), and one
  step of each other family at full width. Its training runs count as
  main-path launches.

Before the paths, the sort-inverse update, FlashLloyd and the store scan are
held to their plain versions on edge shapes (one segment over every CTA, K >
N, ragged chunks, R < 32, d = 1, 3, 19, 129, batched ids, an unaligned x; each
FlashLloyd cluster size at the largest K it takes, no points, fewer points
than a tile, K = 1, K = 16 with every row near 3 centroids, batches across
clusters of 2 and 8, FlashLloyd's ids equal to FlashAssign's bit for bit;
empty, full and over-width cells, fewer live rows than L, duplicate rows, the
scalar path, bf16, one and several CTAs per pair; for the q8 store scan also
live slots of scale 0 and lists of one and two entries a lane and longer; both
store scans also through a page table, on pages of 8, 64 and 128 rows of a
fragmented free list with the sentinel cell, bit for bit the padded scan over
the same rows; FlashProbe's tile mode at B, K and L off its tiles, narrow and
wide rows, duplicated centroids and clusters of 2 and 8, and its list mode on
the same inputs; the block scan's warp mode at short blocks off a warp step,
padding and duplicated rows and every lane count, bit for bit against its list
mode). The probe's tile mode is also timed at each cluster size against L at
the IVF shape. The rescore cache's insert is held to its plain version on
edges (ways 1 to 32, d off the vector width, ids of -1, duplicates, heavy
eviction) and at the q8 build (unbounded, budgeted at a quarter of the rows'
bytes, a re-insert). FlashAssign's scores and its distances (the launch that
sums ||x||^2 itself) are held to the plain version everywhere it runs.
Wherever the fused step fits, the two-pass and fused iterations are timed in
alternation (auto must take the winner of most pairs) and split by kernel with
``torch.profiler``; FlashLloyd's device time is read beside FlashAssign's on
the same inputs, and at smallN_smallK its smallest cluster size against the
next one up.

It prints the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository, and when any check fails. ``--kernels-only`` stops
after the build and the ragged kernel checks (a first call after a kernel
change); ``--reliability-only`` runs the build and the reliability phase,
``--parallel-only`` the build and the parallel phase, ``--parallel-e-only``
the build and that phase's part (e), ``--lm-only`` the build and the LM
serving phase (details in ``chip_smoke_lm.json``), ``--zoo-only`` the build
and the LM zoo phase (details in ``chip_smoke_zoo.json``), ``--train-only``
the build and the training phase (details in ``chip_smoke_train.json``).
Details go to
``chip_smoke.json`` in the repository's git-ignored output directory.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BW = 3.35e12                    # H100 SXM data sheet, bytes/s
CUDA_CORE_F32 = 67e12               # fp32 FMA on the CUDA cores, FLOP/s
# the least time per counted operation, by kernel and input type (H100 SXM
# data sheet): FlashAssign and FlashLloyd run their argmin on the tensor
# cores, 3xTF32 for f32 (three products per term at 495 TFLOP/s) and dense
# bf16 (989 TFLOP/s); the other kernels run fp32 arithmetic on the CUDA cores
# whatever the input type
PEAK = {kname: {"float32": 495e12 / 3, "bfloat16": 989e12}
        for kname in ("flash_assign", "flash_lloyd")}
U32 = 2.0 ** -24                    # fp32 unit roundoff


def peak(kname: str, dtype: str) -> float:
    return PEAK.get(kname, {}).get(dtype, CUDA_CORE_F32)


# name, N, K, d, B, dtype, Lloyd iterations (paper regimes, widths as
# benchmarks/bench_e2e.py; largeN_largeK's N is cut from 1,048,576)
REGIMES = [
    ("smallN_smallK", 65536, 256, 128, 1, "float32", 10),
    ("smallN_smallK", 65536, 256, 128, 1, "bfloat16", 10),
    ("largeN_smallK", 8388608, 1024, 128, 1, "float32", 4),
    ("largeN_smallK", 8388608, 1024, 128, 1, "bfloat16", 4),
    ("batched_B32", 65536, 1024, 128, 32, "float32", 4),
    ("largeN_largeK", 262144, 65536, 512, 1, "float32", 1),
]
LARGE_K_FULL_N = 1048576
PLAIN_ELEMS = 2 ** 28   # entries of one plain score matrix (1 GiB in f32)
# (B, N, K, d): tails of every tile dim, K = 1, d = 1, a single point
RAGGED = [(1, 1000, 37, 19), (3, 777, 100, 64), (1, 1, 1, 1),
          (2, 130, 1, 3), (1, 4097, 65, 129)]
# FlashAssign's own edges (B, N, K, d, kind): N off the 128-row CTA tile, K
# tails inside one 128-column tile (1, 37, 129, 257), d that TMA reads
# directly (8, 512) or through the wrapper's zero padding (1, 3, 19, 129),
# duplicated centroids (ids must go to the lower copy), and a batch whose
# points and centroids sit far from the origin
ASSIGN_EDGE = [(1, 1000, 257, 8, "random"), (2, 333, 129, 512, "random"),
               (1, 4100, 37, 3, "random"), (1, 190, 1, 129, "random"),
               (3, 517, 64, 1, "random"), (2, 700, 129, 19, "random"),
               (3, 517, 64, 19, "duplicated"), (2, 300, 257, 128, "far")]
# The controls: FlashAssign's f32 arithmetic with fewer products than the
# kernel takes ("tf32": x_hi c_hi alone; "drop_x_lo": x_hi c_lo + x_hi c_hi),
# emulated in plain PyTorch and sent through the kernel's own comparison,
# which must reject them on CONTROL_EDGE and on the main path's inputs
# (CONTROL_REGIME, f32). Elsewhere their readings are recorded: on random or
# far data the TF32 error grows as sqrt(d), the worst-case bound as d.
# CONTROL_EDGE: far from the origin at small d, and "aligned" data (positive
# values near 1 whose low mantissa bits sit just under TF32's rounding point,
# so that every TF32 product errs by the most, one way); the kernel is held
# to score_tol there too. Drawn from a generator of their own, so that the
# data of the later phases does not depend on them.
CONTROL_KINDS = ("tf32", "drop_x_lo")
CONTROL_EDGE = [(2, 300, 257, 3, "far"), (2, 300, 257, 19, "far"),
                (1, 3000, 257, 128, "aligned"), (1, 1000, 257, 512, "aligned")]
CONTROL_REGIME = "largeN_smallK"
# FlashProbe ragged checks. L in {1, 7, 40, K}, K/C/W tails, d in {1, 19,
# 129}, one query, lists longer than the kernel keeps in shared memory
# (L > 2048), duplicated rows (the lower-index tie rule), store padding
# rows (the 1e15 coordinate), q8 rows with fewer live slots than L.
# probe: (N, K, d, L, duplicated centroids)
PROBE_RAGGED = [(1, 1, 1, 1, False), (37, 100, 19, 7, False),
                (5, 300, 129, 300, False), (64, 3000, 16, 3000, False),
                (40, 150, 32, 60, True), (256, 1024, 128, 40, False)]
# the probe's tile mode (lists of at most 64): (B, K, row) for each L of
# TILE_L not above K, f32 and bf16, the planned cluster and clusters of 2
# and 8: B off the 16-query tile, K = 1 and 33 (slices of a cluster empty),
# K off the 64-row ring tile; rows of d = 128, of 16 bytes (the narrowest)
# and of 1,024 (the widest); at B = 17 every centroid of the first half
# again in the second (the lower-index rule across slices)
PROBE_TILE_EDGE = [(b, k, 128) for b in (1, 17, 255)
                   for k in (1, 33, 1025)] + [(17, 1025, "16 bytes"),
                                              (17, 1025, "1024 bytes")]
TILE_L = (1, 16, 32, 33, 64)
# the block scan's warp mode (lists of at most 64, blocks of at most 1,024
# rows): C x L (L <= C) at d = 128, B = 33 (the last CTA holds one query,
# the last query's block ends the tensor at a C off 32), padding rows and
# duplicated rows; and (C, L) = (41, 10) at d = 4 .. 512 (1 .. 32 lanes a
# row). Each is held to the plain version and to the list mode bit for bit
WARP_C, WARP_L = (1, 10, 40, 41, 300), (1, 10, 32, 33, 64)
WARP_D = (4, 32, 64, 256, 512)
# grouped scan: (B, C, d, L, padding rows per query, duplicated rows)
SCAN_RAGGED = [(1, 5, 1, 1, 0, False), (7, 1000, 19, 7, 3, False),
               (16, 4100, 129, 40, 50, False), (3, 2500, 16, 2500, 10, False),
               (8, 300, 32, 40, 0, True)]
# q8 scan: (B, nprobe, W, d, L, duplicated slots)
Q8_RAGGED = [(1, 1, 1, 1, 1, False), (5, 3, 37, 19, 7, False),
             (16, 16, 100, 129, 40, False), (4, 4, 700, 16, 2800, False),
             (8, 4, 64, 32, 40, True)]
PAD = 1e15   # the store's padding coordinate (index/store.py _PAD_COORD)
# sort-inverse edges: (R, S, d, ids, chunk): one segment over every CTA, K > N
# with most clusters empty, R off the chunk, R < 32, d off the vector width
SIU_EDGE = [(5000, 3, 128, "equal", 512), (300, 5000, 64, "random", 64),
            (1000, 37, 128, "random", 256), (20, 4, 128, "random", 64)] + [
    (3000, 50, d, "random", 256) for d in (1, 3, 19, 129)]
# FlashLloyd edges (B, N, K, d, kind, cluster size or None for the
# planner's): each cluster size at the largest K that fits it ("window"), d
# off the 16-byte row (1, 3, 19, 129), no points, fewer points than one
# tile, K = 1, K > N (most clusters empty), K = 16 with every row near one of
# 3 centroids, B > 1 across clusters of 2 and of 8
LLOYD_EDGE = [(1, 3000, 0, 128, "window", cl) for cl in (1, 2, 4, 8)] + [
    (1, 2000, 50, d, "random", None) for d in (1, 3, 19, 129)] + [
    (1, 0, 10, 128, "random", None), (1, 50, 10, 128, "random", None),
    (1, 1000, 1, 128, "random", None), (1, 100, 1000, 128, "random", None),
    (1, 20000, 16, 128, "few", None), (3, 2000, 300, 128, "random", 2),
    (2, 700, 100, 64, "random", 8)]
# store scan edges: (B, K, cap, width, d, nprobe, L); every case has an
# empty cell, one at count == width and one at count == cap (> width where
# cap > width), query 0 probing the emptiest cells (fewer live rows than L
# where they hold fewer), and cells 5 and 6 holding the same rows. d covers
# every lane-group size of the vector path (1 .. 32 lanes) and the scalar
# path (d = 1, 3, 19). L <= 32 takes the cell mode: cells probed by more
# than 8 pairs (several units), more than 1,024 pairs with runs of one cell
# across the prologue's chunks, more tiles than the ring holds. L = 40, 100
# and 2,500 take the list mode; 2,500 keeps its list in global scratch
STORE_EDGE = [(64, 40, 256, 200, 128, 8, 10), (33, 24, 64, 64, 19, 5, 40),
              (16, 12, 300, 300, 8, 4, 100), (8, 10, 3000, 3000, 16, 4, 2500),
              (20, 16, 100, 96, 64, 6, 7), (12, 9, 48, 48, 3, 3, 20),
              (7, 7, 40, 40, 1, 2, 5), (10, 12, 128, 128, 512, 4, 10),
              (5, 30, 2200, 2128, 32, 16, 10), (40, 8, 64, 60, 19, 3, 12),
              (1100, 7, 40, 40, 16, 3, 3)]
# q8 store scan edges: (B, K, cap, width, d, nprobe, L), built as STORE_EDGE
# (empty, full and over-width cells, query 0 on the emptiest, cells 5 and 6
# alike) with a twentieth of the live slots at scale 0. L <= 32 keeps one
# list entry a lane, 33-64 two; longer lists, rows off the 16-code vector
# (d = 8, 19: the block kernel's scalar path) and d > 512 take the list
# mode (L = 2,500 in global scratch); d covers every lane count (16: 1 lane
# .. 512: 32), a cap off 4 slots (the list mode), a width off 4
# and more tiles than the ring
QSTORE_EDGE = [(64, 40, 256, 200, 128, 8, 10), (33, 24, 64, 64, 16, 5, 40),
               (16, 12, 300, 300, 32, 4, 64), (16, 12, 300, 296, 64, 4, 65),
               (8, 10, 3000, 3000, 256, 4, 2500), (20, 16, 100, 96, 19, 6, 7),
               (12, 9, 48, 48, 512, 3, 20), (10, 12, 128, 128, 1024, 4, 33),
               (5, 30, 2200, 2128, 128, 16, 40), (1100, 7, 40, 40, 16, 3, 3),
               (7, 7, 40, 40, 8, 2, 5), (9, 8, 100, 97, 128, 3, 30),
               (6, 8, 42, 40, 128, 2, 12)]
# the paged store (PagedBucketStore): the page sizes of the store-scan edges
# (each edge's cells on pages of a shuffled, gapped free list, cells of no
# pages, partial last pages, the sentinel cell K, widths and splits off the
# page boundaries), and the IVF cells' page size; the two scans' paged rows
# in the kernel table
PAGE_SIZES = (8, 64, 128)
PAGE = 64
PAGED_ROWS = {"flash_probe_store (paged)": "flash_probe_store",
              "flash_probe_store_q8 (paged)": "flash_probe_store_q8"}
# the skewed deployment: the IVF cell's blob centres (seed 4), each row's
# cell drawn from Zipf(1.0) over a permutation of them (seed 15), added in
# chunks of SKEW_CHUNK to IVFIndex(centres, 8, store="paged") (a trained
# build would split the hot blob)
SKEW_SEED, SKEW_CHUNK = 15, 262144
NO_SPILLS = r"\b0 bytes spill stores, 0 bytes spill loads"  # ptxas -v
STEP_PAIRS = 11  # two-pass / fused iteration pairs, ABAB, where fused fits
# FlashIVF: the FAISS IVF1024,Flat configuration on SIFT1M (N, K, d),
# searched in batches of IVF_B queries at topk 10, nprobe 16
IVF = (1048576, 1024, 128)
IVF_B, IVF_BATCHES, TOPK, NPROBE = 256, 4, 10, 16
SWEEP_L = (1, 16, 32, 48, 64)   # the probe's tile mode: clusters against L
EXACT = (65536, 64, 128)   # the full-probe exactness index
EXACT_B = 32
# the two-level router: the reference's routed regime (K fine centroids
# around META meta-centres, benchmarks/bench_index.py:152-210) at d = 128,
# ROWS_A_CELL rows a cell added in chunks of ROUTED_CHUNK; searched at
# (B, nprobe) ROUTED_POINTS: the reference's B 64 at nprobe 10 and 32, B 16
# (where the planner's route op answers two_level) and the serving batch
# B 256; its kernels are held to their plain versions at B 256, nprobe
# ROUTED_NPROBE
ROUTED, ROUTED_CHUNK, ROUTED_NPROBE = (65536, 512, 64), 262144, (16, 64)
ROUTED_POINTS = ((16, 10), (16, 32), (64, 10), (64, 32), (256, 16),
                 (256, 64))
# the device rescore cache's insert (sets, ways, d, batch, ids below, kind):
# ways 1, 4, 8 and 32, d off the 4-float vector (1, 3, 129) and an x off 16
# bytes (the scalar copy), ids of -1 and duplicates within a batch, sets
# that fill, that evict heavily, that take hits on a second batch
INSERT_EDGE = [(64, 4, 128, 200, 100, "fill"),
               (16, 4, 128, 1000, 1000, "evict"),
               (8, 1, 3, 300, 300, "evict"),
               (32, 32, 129, 3000, 5000, "evict"),
               (7, 8, 16, 500, 900, "evict"), (4, 4, 1, 100, 40, "fill"),
               (64, 4, 128, 700, 600, "unaligned")]
# the serving phase: SearchEngine over each IVF cell, ragged traffic
ENGINE_REQUESTS, ENGINE_MAX_ROWS = 64, 512
ENGINE_ADDS, ENGINE_ADD_ROWS = 4, 4096
ENGINE_RECALL_ROWS = 512
# the k-means loops that reuse the Lloyd step: the out-of-core Lloyd over a corpus
# logically larger than the card (N rows streamed from a pinned pool of
# OOC_POOL chunks of OOC_CHUNK rows, d = 128, K = OOC_K), its peak at a
# quarter of N, a pageable numpy source of OOC_NUMPY rows; the streaming
# StreamingKMeans's ragged stream; the out-of-core IVF build; the tune
OOC_N, OOC_N_SMALL, OOC_K = 2 ** 28, 2 ** 26, 4096
OOC_CHUNK, OOC_POOL, OOC_NUMPY, OOC_ITERS = 2 ** 22, 4, 2 ** 24, 2
STREAM_K, STREAM_BATCHES, STREAM_ROWS = 1024, 256, (4096, 65536)
STREAM_INIT, STREAM_DECAY, STREAM_EPOCH = 65536, 0.95, 2 ** 20
OOC_IVF, OOC_IVF_CHUNK = (4194304, 1024, 128), 262144
TUNE = (8388608, 1024, 128)

# phase 11, the reliability layer, at phase 5's width over two indexes
REL_ADDS, REL_ADD_ROWS = 24, 4096     # the durability run's adds
REL_REFRESH, REL_SNAP = 8, 12         # refresh_every, snapshot_every
REL_QPS_REQUESTS = 64                 # requests of IVF_B rows, +/- health
CHAOS_SEEDS, CHAOS_UNITS, CHAOS_ADDS = (7, 8, 9), 64, 16
UPDATE_BIT_REPS = 5   # runs of the regimes' update and FlashLloyd compared
DET_SHAPE, DET_REPS = (65536, 8), 5   # a cluster spans 32 update chunks

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def plain_chunks(b: int, n: int, k: int):
    """(batch, row) slices that cover every row of every problem, each
    with a plain score matrix of at most ``PLAIN_ELEMS`` entries."""
    rows = max(1, PLAIN_ELEMS // k)
    if n <= rows:
        step = max(1, rows // n)
        return [(slice(i, i + step), slice(0, n)) for i in range(0, b, step)]
    return [(slice(i, i + 1), slice(r, r + rows))
            for i in range(b) for r in range(0, n, rows)]


def reliability_phase(dev, smi, zero_counts, read_counts, details):
    """Phase 11: the reliability layer at phase 5's width (``IVF``, B
    ``IVF_B``, ``nprobe`` ``NPROBE``) over two indexes, each from a seed of
    its own: (a) the padded fp32 store with the flat router, (b) the paged
    q8 store with the device rescore cache and the two-level router.

    First the add path's determinism: ``IVFIndex.add`` of one batch on
    clones of one state must give ``_pending`` bit for bit, at the phase's
    batch and at ``DET_SHAPE`` (a cluster over many update chunks). Then,
    for each index: a ``SearchEngine`` under a ``HealthPolicy`` with a
    snapshot directory runs ``REL_ADDS`` adds, each followed by a search
    unit; it is killed as its second automatic snapshot begins, and
    ``recover`` (snapshot at add ``REL_SNAP``, the WAL's tail replayed)
    must hold the uninterrupted engine's index and answer a held-out batch
    bit for bit; ``save``/``load`` round-trips bit for bit (the q8 cache
    re-warms); the engine serves ``CHAOS_UNITS`` units and ``CHAOS_ADDS``
    adds under ``FaultPlan.seeded(s)`` without raising or a non-finite
    distance, and each unit served at the configured nprobe returns a
    fault-free engine's ids over the same index. Every fault-free engine
    under the policy (the served one, its twin, the recovered one, those
    timed for queries/s) must serve each unit at the configured nprobe and
    take no rung of the ladder. Times: snapshot save and
    load, recover and its replay, a WAL append, ``clone_index``,
    ``guard_batch`` on a device batch, queries/s with and without the
    policy. Snapshots go to a ``tempfile.mkdtemp()`` directory, removed at
    the end. Returns each index's launch counts (store kind, counts) from
    the driven runs (the determinism check and the timings apart)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.index import IVFIndex
    from repro_torch.reliability import (AddLog, FaultInjector, FaultPlan,
                                         HealthPolicy, clone_index,
                                         guard_batch)
    from repro_torch.serve import SearchConfig, SearchEngine

    import numpy as np
    n, k, d = IVF
    sync = torch.cuda.synchronize
    rec = details.setdefault("reliability", {"indexes": []})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rel_")
    free = shutil.disk_usage(tmp).free
    print(f"\n[reliability] N={n} d={d} K={k}, B {IVF_B}, nprobe {NPROBE}; "
          f"{REL_ADDS} adds of {REL_ADD_ROWS}, refresh_every {REL_REFRESH}, "
          f"snapshot_every {REL_SNAP}; chaos seeds {CHAOS_SEEDS}; snapshots "
          f"under {tmp} ({free / 2**30:.1f} GiB free); {smi}", flush=True)
    rec.update(tmp_free_bytes=free, card=smi)
    runs = []

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def same_state(a, b):
        """Store arrays, centroids, both statistics and n_total, bit for
        bit; a list of what differs."""
        bad = []
        sa, sb = a.store.state_arrays(), b.store.state_arrays()
        bad += [key for key in sorted(set(sa) | set(sb))
                if key not in sa or key not in sb
                or not np.array_equal(sa[key], sb[key])]
        if not torch.equal(a.centroids, b.centroids):
            bad.append("centroids")
        for part in ("stats", "_pending"):
            if not all(torch.equal(u, v) for u, v in
                       zip(getattr(a, part), getattr(b, part))):
                bad.append(part)
        if a.n_total != b.n_total:
            bad.append("n_total")
        return bad

    rungs = ("retries", "nprobe_degraded", "brute_fallbacks",
             "lkg_fallbacks", "blackholed", "adds_requeued", "adds_rejected",
             "refresh_failures")

    def served_clean(tag, what, e, units):
        """A fault-free engine under the policy served each of its
        ``units`` units at the configured nprobe, through the kernels, and
        took no rung of the ladder; its counters, printed."""
        c = e.counters.as_dict()
        print(f"  {what}: counters { {kk: v for kk, v in c.items() if v} }",
              flush=True)
        check(c["searches_ok"] == units and not any(c[x] for x in rungs),
              f"{tag}: {what} served its {units} units at nprobe {NPROBE}, "
              f"no rung of the ladder taken")
        return c

    def add_bits(base, batch, reps):
        """``_pending`` after ``add(batch)`` on ``reps`` clones of ``base``:
        how many equal the first bit for bit."""
        outs = []
        for _ in range(reps):
            c = clone_index(base)
            c.add(batch)
            outs.append([t.clone() for t in c._pending])
            del c
        return sum(all(torch.equal(u, v) for u, v in zip(o, outs[0]))
                   for o in outs)

    try:
        # the add path's determinism at DET_SHAPE: a cluster of 8,192 rows
        # over the planner's update chunks
        gen = torch.Generator(device=dev).manual_seed(SEED + 19)
        dn, dk = DET_SHAPE
        c8 = torch.randn(dk, d, device=dev, generator=gen) * 5.0
        xb = c8[torch.randint(0, dk, (dn,), device=dev, generator=gen)] + \
            torch.randn(dn, d, device=dev, generator=gen)
        small = IVFIndex(c8, 2 * dn // dk)
        chunk = small._batch_blocks(dn).update_block_n
        biggest = int(torch.bincount(torch.cdist(xb, c8).argmin(1),
                                     minlength=dk).max())
        eq = add_bits(small, xb, DET_REPS)
        print(f"  add path at ({dn} rows, K {dk}, update chunk {chunk}: the "
              f"largest cluster {biggest} rows over "
              f"{-(-biggest // chunk) + 1} chunks at most): _pending bit "
              f"for bit in {eq} of {DET_REPS} runs", flush=True)
        rec["determinism"] = [{"rows": dn, "k": dk, "chunk": chunk,
                               "largest_cluster": biggest, "equal": eq,
                               "reps": DET_REPS}]
        check(eq == DET_REPS, f"reliability: IVFIndex.add of {dn} rows at "
                              f"K {dk} gives _pending bit for bit in every "
                              f"run ({eq} of {DET_REPS})")
        del small, xb, c8

        for label, kw, seed in (
                ("fp32/padded/flat", {}, SEED + 20),
                ("q8/paged/two_level", {"codec": "q8", "store": "paged",
                                        "page_size": PAGE,
                                        "router": "two_level"}, SEED + 21)):
            tag = f"reliability/{label}"
            print(f"\n[{tag}]", flush=True)
            gen = torch.Generator(device=dev).manual_seed(seed)
            centers = torch.randn(k, d, device=dev, generator=gen) * 5.0

            def blobs(rows):
                lab = torch.randint(0, k, (rows,), device=dev, generator=gen)
                return centers[lab] + 0.4 * torch.randn(
                    rows, d, device=dev, generator=gen)
            x = blobs(n)
            base, build_s = wall(lambda: IVFIndex.build(
                x, k=k, max_iters=8, seed=seed, **kw))
            del x
            adds = [blobs(REL_ADD_ROWS) for _ in range(REL_ADDS)]
            units = [blobs(IVF_B) for _ in range(REL_ADDS)]
            held = blobs(IVF_B)
            r = {"index": label, "build_s": build_s,
                 "resident_bytes": base.resident_bytes()}
            eq = add_bits(base, adds[0], 3)
            chunk = base._batch_blocks(REL_ADD_ROWS).update_block_n
            print(f"  {base!r}, built in {build_s:.2f} s; add path at "
                  f"({REL_ADD_ROWS} rows, K {k}, update chunk {chunk}): "
                  f"_pending bit for bit in {eq} of 3 runs", flush=True)
            rec["determinism"].append({"rows": REL_ADD_ROWS, "k": k,
                                       "chunk": chunk, "equal": eq,
                                       "reps": 3, "index": label})
            check(eq == 3, f"{tag}: IVFIndex.add of {REL_ADD_ROWS} rows "
                           f"gives _pending bit for bit ({eq} of 3)")

            # the durability run: served engine and its uninterrupted twin
            pol = HealthPolicy()
            sdir = os.path.join(tmp, label.replace("/", "_"))
            cfg = dict(topk=TOPK, nprobe=NPROBE, query_batch=IVF_B,
                       refresh_every=REL_REFRESH)
            scfg = SearchConfig(**cfg, snapshot_dir=sdir,
                                snapshot_every=REL_SNAP, wal_log_every=1)
            twin_index, clone_s = wall(lambda: clone_index(base))
            twin = SearchEngine(twin_index, SearchConfig(**cfg), health=pol)
            zero_counts()
            eng = SearchEngine(base, scfg, health=pol)
            saves, save_s = [], []
            real_save = base.save

            class Killed(Exception):
                pass

            def save_or_die(*a, **kw_):
                saves.append(1)
                if len(saves) == 2:   # the crash: as this snapshot begins
                    raise Killed
                out, t = wall(lambda: real_save(*a, **kw_))
                save_s.append(t)
                return out
            base.save = save_or_die
            killed_at = None
            for i in range(REL_ADDS):
                try:
                    eng.add(adds[i])
                except Killed:
                    killed_at = i
                    break
                eng.search(units[i])
            for i in range(REL_ADDS):
                twin.add(adds[i])
                twin.search(units[i])
            check(killed_at == REL_ADDS - 1
                  and eng.counters.snapshots_written == 1,
                  f"{tag}: killed at add {killed_at} as its second snapshot "
                  f"began, one snapshot written")
            clean = {"engine": served_clean(tag, "the served engine", eng,
                                            REL_ADDS - 1)}
            del eng, base, real_save
            sync()
            torch.cuda.empty_cache()
            replay_s, real_add = [], SearchEngine.add

            def timed_add(self, x_new):
                out, t = wall(lambda: real_add(self, x_new))
                replay_s.append(t)
                return out
            SearchEngine.add = timed_add
            try:
                back, recover_s = wall(lambda: SearchEngine.recover(
                    sdir, SearchConfig(**cfg, snapshot_every=REL_SNAP),
                    health=pol))
            finally:
                SearchEngine.add = real_add
            diff = same_state(back.index, twin.index)
            got, want = back.search(held), twin.search(held)
            clean["twin"] = served_clean(tag, "the uninterrupted engine", twin,
                                         REL_ADDS + 1)
            clean["recovered"] = served_clean(tag, "the recovered engine",
                                              back, 1)
            check(back.counters.wal_records_replayed == REL_ADDS - REL_SNAP
                  and back.refresh_count == twin.refresh_count
                  and back.adds_since_refresh == twin.adds_since_refresh,
                  f"{tag}: recover replayed "
                  f"{back.counters.wal_records_replayed} records "
                  f"(expected {REL_ADDS - REL_SNAP}); refreshes "
                  f"{back.refresh_count} / {twin.refresh_count}")
            check(not diff, f"{tag}: the recovered index equals the "
                            f"uninterrupted one bit for bit (store arrays, "
                            f"centroids, statistics): {diff or 'all equal'}")
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"{tag}: the recovered engine's held-out batch equals the "
                  f"uninterrupted one's bit for bit "
                  f"({int((got[0] != want[0]).sum())} ids differ)")
            snap_bytes = sum(os.path.getsize(os.path.join(sdir, f))
                             for f in os.listdir(sdir))
            r.update(counters_fault_free=clean, auto_save_s=save_s,
                     recover_s=recover_s,
                     replay_s=sum(replay_s), replayed=len(replay_s),
                     snapshot_dir_bytes=snap_bytes, clone_s=clone_s)
            print(f"  recover {recover_s:.3f} s, of which the replay of "
                  f"{len(replay_s)} records {sum(replay_s):.3f} s; the "
                  f"snapshot at add {REL_SNAP} {save_s[0]:.3f} s; "
                  f"{snap_bytes / 2**30:.3f} GiB on disk", flush=True)
            del twin
            live = back.index

            # round trip
            rdir = os.path.join(tmp, label.replace("/", "_") + "_rt")
            path, t_save = wall(lambda: live.save(rdir, seqno=1))
            size = os.path.getsize(path)
            loaded, t_load = wall(lambda: IVFIndex.load(rdir))
            got, want = loaded.search(held, topk=TOPK, nprobe=NPROBE), \
                live.search(held, topk=TOPK, nprobe=NPROBE)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                  and not same_state(loaded, live),
                  f"{tag}: save then load returns the index bit for bit "
                  f"(state, held-out ids and distances)")
            if kw.get("codec") == "q8":
                cache = loaded.store.cache
                check(cache is not None and cache.inserted == loaded.n_total,
                      f"{tag}: the loaded index's device rescore cache "
                      f"re-warmed from the reservoir ({cache.inserted} rows "
                      f"of {loaded.n_total})")
            r.update(save_s=t_save, load_s=t_load, snapshot_bytes=size,
                     save_gbs=size / t_save / 1e9, load_gbs=size / t_load / 1e9)
            print(f"  snapshot {size / 2**30:.3f} GiB: save {t_save * 1e3:.1f}"
                  f" ms ({size / t_save / 1e9:.2f} GB/s), load "
                  f"{t_load * 1e3:.1f} ms ({size / t_load / 1e9:.2f} GB/s)",
                  flush=True)
            del loaded
            shutil.rmtree(rdir, ignore_errors=True)

            # chaos: each seed over a fresh copy of the live index
            chaos = []
            for s in CHAOS_SEEDS:
                idx = clone_index(live)
                ce = SearchEngine(idx, SearchConfig(**cfg), health=pol,
                                  faults=FaultInjector(FaultPlan.seeded(s)))
                fe = SearchEngine(idx, SearchConfig(**cfg))
                bad_ids, finite, err, at_full = [], True, None, 0
                try:
                    for u in range(CHAOS_UNITS):
                        if u % (CHAOS_UNITS // CHAOS_ADDS) == 0:
                            ce.add(adds[u // (CHAOS_UNITS // CHAOS_ADDS)])
                        q_u = units[u % len(units)]
                        ok0 = ce.counters.searches_ok
                        ids, dd = ce.search(q_u)
                        finite &= bool(torch.isfinite(dd).all())
                        if ce.counters.searches_ok == ok0 + 1:
                            at_full += 1
                            inj, idx.faults = idx.faults, None
                            ids_f, _ = fe.search(q_u)
                            idx.faults = inj
                            if not torch.equal(ids, ids_f):
                                bad_ids.append(u)
                except Exception as e:   # the contract: nothing raises
                    err = f"{type(e).__name__}: {e}"[:200]
                c = ce.counters.as_dict()
                chaos.append({"seed": s, "counters": c,
                              "fired": [e.kind for e in idx.faults.fired],
                              "units_at_nprobe": at_full,
                              "ids_differ_units": bad_ids, "error": err})
                print(f"  chaos seed {s}: fired "
                      f"{[e.kind for e in idx.faults.fired]}; counters "
                      f"{ {kk: v for kk, v in c.items() if v} }; "
                      f"{at_full} units at nprobe {NPROBE}", flush=True)
                check(err is None and finite,
                      f"{tag} chaos seed {s}: nothing raised ({err}), every "
                      f"distance finite ({finite})")
                check(not bad_ids and at_full > 0,
                      f"{tag} chaos seed {s}: the {at_full} units served at "
                      f"nprobe {NPROBE} return the fault-free engine's ids "
                      f"(units {bad_ids} differ)")
                del idx, ce, fe
            r["chaos"] = chaos
            counts = read_counts()
            runs.append((live.store_kind, counts))
            r["launches"] = counts
            need = ["flash_assign", "sort_inverse_update",
                    "flash_probe_tile", "flash_probe_store"] + (
                ["flash_probe_store_q8", "flash_probe_grouped_warp",
                 "rescore_cache_insert"] if kw.get("codec") == "q8" else [])
            check(all(counts[kn] > 0 for kn in need),
                  f"{tag} kernels launched: {counts}")

            # times (outside the counted run)
            wal = AddLog(os.path.join(tmp, "wal_timing"))
            wal_s = [wall(lambda i=i: wal.append(i + 1, adds[i]))[1]
                     for i in range(10)]
            clones = [wall(lambda: clone_index(live))[1] for _ in range(3)]
            m0 = torch.cuda.memory_allocated()
            keep = clone_index(live)
            clone_bytes = torch.cuda.memory_allocated() - m0
            del keep
            qd = held.clone()
            guard_ms = []
            for _ in range(21):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                guard_batch(qd, d, policy="sanitize")
                e1.record()
                sync()
                guard_ms.append(e0.elapsed_time(e1))
            guard_host = [wall(lambda: guard_batch(qd, d))[1]
                          for _ in range(21)]

            def qps(health):
                e = SearchEngine(live, SearchConfig(**cfg), health=health)
                e.search(units[0])
                reqs = [units[i % len(units)] for i in range(REL_QPS_REQUESTS)]

                def go():
                    rids = [e.submit(qq) for qq in reqs]
                    e.pump()
                    return [e.take(rr) for rr in rids]
                _, t = wall(go)
                if health is not None:
                    clean.setdefault("qps_with_health", []).append(
                        served_clean(tag, "the queries/s engine", e,
                                     REL_QPS_REQUESTS + 1))
                return REL_QPS_REQUESTS * IVF_B / t
            qps_plain, qps_health = qps(None), qps(pol)
            qps_plain2, qps_health2 = qps(None), qps(pol)
            r.update(wal_append_s=wal_s, clone_index_s=clones,
                     guard_ms=guard_ms[1:], guard_host_s=guard_host[1:],
                     qps_without_health=[qps_plain, qps_plain2],
                     qps_with_health=[qps_health, qps_health2],
                     index_bytes=live.resident_bytes(),
                     clone_device_bytes=clone_bytes)
            med = statistics.median
            print(f"  a WAL append ({REL_ADD_ROWS} x {d} f32 on the card) "
                  f"{med(wal_s) * 1e3:.2f} ms (median of 10, host clock); "
                  f"clone_index {med(clones) * 1e3:.2f} ms (median of 3), "
                  f"the index {live.resident_bytes() / 2**30:.3f} GiB "
                  f"resident, a clone {clone_bytes / 2**30:.3f} GiB more "
                  f"device memory; guard_batch of {IVF_B} queries on "
                  f"the card {med(guard_ms[1:]):.4f} ms (events), "
                  f"{med(guard_host[1:]) * 1e3:.4f} ms (host); queries/s "
                  f"without health {qps_plain:.0f}, {qps_plain2:.0f}, with "
                  f"{qps_health:.0f}, {qps_health2:.0f} ({smi})",
                  flush=True)
            rec["indexes"].append(r)
            del live, back, adds, units, held, wal
            sync()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---- phase 12: the parallel layer (core.parallel) ---------------------------
# phase 12's shapes: the distributed fit at largeN_smallK over 1,024
# well-separated blobs (the IVF corpus's spread; seed SEED + 12), a fixed
# number of iterations (tol 0); the K-sharded assignment at largeN_largeK
# (seed SEED + 13); the sharded index at phase 5's IVF cell and phase 6's
# exactness corpus. Ranks beyond the first share the one card (gloo).
PAR_FIT, PAR_FIT_ITERS = (8388608, 1024, 128), 5
PAR_LARGE_K = (262144, 65536, 512)
PAR_ADD_ROWS = 4096
# the share of rows whose final cell in the 2x1 fit may differ from the
# one-rank fit's (near-ties that the other order of the sums moved)
MOVED_MAX = 0.005
PAR_TIMEOUT_S = 300    # a rank's collective that waits longer fails
PAR_JOIN_S = 420       # a group of ranks that runs longer is killed
# (a') and (d'): the sharded index's search axes (queue A item 6b, parts
# 1-3), name -> IVFIndex keywords: the paged pool over K-shards, q8 with the
# rescore cache sharded over cells (padded and paged), and the routed
# sharded probe, which runs at phase 5b's routed cell, its first
# PAR_ROUTED_B queries at each of PAR_ROUTED_NPROBE
PAR_AXES = {"paged": dict(store="paged", page_size=PAGE),
            "q8": dict(codec="q8", rescore="device"),
            "q8_paged": dict(codec="q8", store="paged", page_size=PAGE,
                             rescore="device"),
            "routed": dict(router="two_level")}
PAR_ROUTED_B, PAR_ROUTED_NPROBE = 64, (10, 32)


def ivf_corpus(dev):
    """Phase 5's corpus (seed SEED + 4): ``(gen, centers, x, queries)``,
    ``IVF`` rows around ``IVF[1]`` blob centres (x5, noise 0.4) and
    ``IVF_BATCHES`` batches of ``IVF_B`` queries; ``gen`` goes on."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, k, d = IVF
    centers = torch.randn(k, d, device=dev, generator=gen) * 5.0
    x = centers[torch.randint(0, k, (n,), device=dev, generator=gen)]
    x += 0.4 * torch.randn(n, d, device=dev, generator=gen)
    qlab = torch.randint(0, k, (IVF_BATCHES, IVF_B), device=dev,
                         generator=gen)
    queries = centers[qlab] + 0.4 * torch.randn(IVF_BATCHES, IVF_B, d,
                                                device=dev, generator=gen)
    return gen, centers, x, queries


def drifting_stream(dev, d):
    """Phase 8's stream (seed 12): ``(sizes, gen, centers, drifting)``,
    ``drifting(rows)`` the next batch around centres that drift."""
    import torch
    sizes = torch.randint(STREAM_ROWS[0], STREAM_ROWS[1] + 1,
                          (STREAM_BATCHES,),
                          generator=torch.Generator().manual_seed(12)).tolist()
    gen = torch.Generator(device=dev).manual_seed(12)
    centers = torch.randn(STREAM_K, d, device=dev, generator=gen) * 2.0

    def drifting(rows):
        centers.add_(0.01 * torch.randn(STREAM_K, d, device=dev,
                                        generator=gen))
        lab = torch.randint(0, STREAM_K, (rows,), device=dev, generator=gen)
        return centers[lab] + torch.randn(rows, d, device=dev, generator=gen)

    return sizes, gen, centers, drifting


def stats_bound(x2, ids, segments, cnt):
    """|sum error| bound per (segment, column) of a sort-inverse update
    against its plain version: 2 n u sum |x|."""
    import torch
    abssum = torch.zeros((segments, x2.shape[1]), device=x2.device)
    abssum.index_add_(0, ids.long(), x2.abs().float())
    return 2 * U32 * cnt.unsqueeze(1) * abssum + 1e-30


def launch_counters():
    """``(zero, read)`` of this process's kernel launch counters."""
    from repro_torch.kernels import flash_assign as fa
    from repro_torch.kernels import flash_lloyd as fl
    from repro_torch.kernels import flash_probe as fp
    from repro_torch.kernels import rescore_cache as rck
    from repro_torch.kernels import sort_inverse_update as siu
    mods = {"flash_assign": fa, "sort_inverse_update": siu,
            "flash_lloyd": fl, "rescore_cache_insert": rck}

    def zero():
        for mod in mods.values():
            mod.launches = 0
        for kname in fp.launches:
            fp.launches[kname] = 0

    def read():
        return {**{kname: mod.launches for kname, mod in mods.items()},
                **fp.launches}

    return zero, read


def events_ms(fn, reps=3):
    """CUDA-event ms a call of ``fn`` over ``reps`` calls, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def wall_s(fn):
    """``(fn(), seconds)`` on the host clock, the card synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fit_corpus(dev, shape, seed, spread, noise):
    """``(x, c0)``: ``shape[0]`` rows around ``shape[1]`` Gaussian centres
    (``spread``, ``noise``) from ``seed``, and the c0 ``KMeans.fit`` draws
    (``cfg.init`` random, its seed 0)."""
    import torch
    from repro_torch.core.init import init_centroids
    n, k, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(k, d, device=dev, generator=gen) * spread
    x = centers[torch.randint(0, k, (n,), device=dev, generator=gen)]
    x += noise * torch.randn(n, d, device=dev, generator=gen)
    c0 = init_centroids(x, k, "random",
                        generator=torch.Generator(device=dev).manual_seed(0))
    return x, c0


def _rank_fits(rank, dev):
    """Cases (b) and (c) on one of two ranks sharing the card."""
    import torch
    from repro_torch.core import KMeans, KMeansConfig
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.kernels import ops
    from repro_torch.kernels import sort_inverse_update as siu
    zero, read = launch_counters()
    out = {}
    # (b) mesh 2x1: the N-sharded fit from (a)'s c0
    n, k, d = PAR_FIT
    x, c0 = fit_corpus(dev, PAR_FIT, SEED + 12, 5.0, 0.4)
    cfg = KMeansConfig(k=k, max_iters=PAR_FIT_ITERS)
    pctx = ParallelContext.for_mesh(build_mesh((2, 1), ("data", "model"),
                                               backend="gloo"))
    fit, assign = pctx.make_kmeans_fit(cfg), pctx.make_assign(cfg)
    zero()
    r, fit_s = wall_s(lambda: fit(x, c0))
    ids1 = assign(x, c0)[0]
    torch.cuda.synchronize()
    out["b"] = {"centroids": r.centroids.cpu(), "ids": r.assignments.cpu(),
                "ids1": ids1.cpu(), "iterations": r.iterations,
                "inertia": float(r.inertia), "fit_s": fit_s,
                "counts": read(),
                "fused": cfg.resolved_step_impl(n // 2, d, 4, device=dev)
                == "fused"}
    # the fit is a Lloyd trajectory of its own: its first iteration from
    # c0, and its final ids the argmin of the centroids one iteration back
    # (the same gloo sums in the same order, so the same bits)
    first = pctx.make_kmeans_fit(KMeansConfig(k=k, max_iters=1))(x, c0)
    back = pctx.make_kmeans_fit(KMeansConfig(
        k=k, max_iters=PAR_FIT_ITERS - 1))(x, c0)
    out["b"]["centroids1"] = first.centroids.cpu()
    out["b"]["last_ids_consistent"] = bool(torch.equal(
        assign(x, back.centroids)[0], r.assignments))
    del x, c0, r, ids1, first, back
    torch.cuda.empty_cache()
    # (c) mesh 1x2 at largeN_largeK: the two-stage argmin, one K-sharded
    # iteration, the owned statistics and their extra bucket
    n, k, d = PAR_LARGE_K
    x, c0 = fit_corpus(dev, PAR_LARGE_K, SEED + 13, 2.0, 1.0)
    a_ref = ops.flash_assign(x, c0, want_dists=False)[0]
    c1 = KMeans(KMeansConfig(k=k), device=dev).iterate(x, c0)[0]
    pk = ParallelContext.for_mesh(build_mesh((1, 2), ("data", "model"),
                                             backend="gloo"))
    cfg = KMeansConfig(k=k, max_iters=1)
    zero()
    (a, _), assign_s = wall_s(lambda: pk.make_assign(cfg)(x, c0))
    r, iter_s = wall_s(lambda: pk.make_kmeans_fit(cfg)(x, c0))
    counts = read()
    kl = pk.k_local(k)
    rel = a - pk.k_rank * kl
    a_eff = torch.where((rel >= 0) & (rel < kl), rel, kl).to(torch.int32)
    blk = cfg.blocks_for(n, d, 4, dev)
    s_own, n_own = pk.owned_stats(x, a, k, cfg)
    s_full, n_full = ops.centroid_stats(x, a_eff, k=kl + 1,
                                        block_n=blk.update_block_n,
                                        block_k=blk.update_block_k)
    ids_s, order = torch.sort(a_eff, stable=True)
    sp, cp = siu.sort_inverse_update_plain(x, order.to(torch.int32), ids_s,
                                           kl + 1)
    err = (s_full - sp).abs()
    bound = stats_bound(x, a_eff, kl + 1, cp)
    own_ms = events_ms(lambda: pk.owned_stats(x, a, k, cfg), reps=5)
    out["c"] = {
        "ids_equal": bool(torch.equal(a, a_ref)),
        "ids_differ": int((a != a_ref).sum()),
        "centroid_err": float((r.centroids - c1).abs().max()),
        "centroids_ok": bool(torch.allclose(r.centroids, c1, rtol=1e-5,
                                            atol=1e-5)),
        "stats_ok": bool((err <= bound).all()) and torch.equal(n_full, cp),
        "owned_is_sliced": torch.equal(s_own, s_full[:kl])
        and torch.equal(n_own, n_full[:kl]),
        "stats_err": float(err.max()),
        "extra_bucket_rows": int(cp[kl]),
        "extra_bucket_err": float(err[kl].max()),
        "extra_bucket_bound": float(bound[kl].min()),
        "owned_stats_ms": own_ms, "assign_s": assign_s, "iter_s": iter_s,
        "counts": counts}
    return out


def _rank_ivf(rank, dev):
    """Case (d) on one of four ranks sharing the card, mesh 2x2."""
    import torch
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.index import IVFIndex, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    zero, read = launch_counters()

    def brute(index):
        """``search_brute``'s ids of each batch, its score matrix taken 32
        queries at a time: four ranks share the card's memory."""
        flat_x, flat_ids = index.store.flat()   # a gather over the cells
        return [torch.cat([flat_ids[kref.probe_ref(
            qb[i:i + 32].to(flat_x.dtype), flat_x, TOPK)[0].long()]
            for i in range(0, qb.shape[0], 32)]) for qb in queries]

    gen, centers, x, queries = ivf_corpus(dev)
    n, k, d = IVF
    x2 = centers[torch.randint(0, k, (PAR_ADD_ROWS,), device=dev,
                               generator=gen)]
    x2 += 0.4 * torch.randn(PAR_ADD_ROWS, d, device=dev, generator=gen)
    pctx = ParallelContext.for_mesh(build_mesh((2, 2), ("data", "model"),
                                               backend="gloo"))
    cap = int(torch.bincount(ops.flash_assign(x, centers)[0].long(),
                             minlength=k).max())
    zero()
    sh = IVFIndex(centers, cap, pctx=pctx)
    _, add_s = wall_s(lambda: sh.add(x))
    sh.search(queries[0], topk=TOPK, nprobe=NPROBE)   # warm-up
    got, batch_s = [], []
    for qb in queries:
        res, s = wall_s(lambda: sh.search(qb, topk=TOPK, nprobe=NPROBE))
        got.append(res)
        batch_s.append(s)
    _, add2_s = wall_s(lambda: sh.add(x2))
    sh.refresh()
    after = [sh.search(qb, topk=TOPK, nprobe=NPROBE) for qb in queries]
    counts = read()
    c_sh = sh.global_centroids()
    brute_ids = brute(sh)
    out = {"results": [(i.cpu(), dd.cpu()) for i, dd in got + after],
           "counts": counts, "add_s": add_s, "add2_s": add2_s,
           "batch_s": batch_s, "cap": cap, "k_owned": sh.k_owned,
           "resident_bytes": sh.resident_bytes(),
           "collective_bytes": sh.search_collective_bytes(IVF_B, TOPK,
                                                          NPROBE),
           "recall_brute": [recall_at_k(ids, b)
                            for (ids, _), b in zip(after, brute_ids)]}
    if rank == 0:   # the single-rank index from the same centroids
        one = IVFIndex(centers, cap)
        one.add(x)
        ref = [one.search(qb, topk=TOPK, nprobe=NPROBE) for qb in queries]
        one.add(x2)
        one.refresh()
        ref_after = [one.search(qb, topk=TOPK, nprobe=NPROBE)
                     for qb in queries]
        cmp = []
        for (i_s, d_s), (i_1, d_1) in zip(got + after, ref + ref_after):
            cmp.append((torch.equal(i_s, i_1), int((i_s != i_1).sum()),
                        float((d_s - d_1).abs().max()),
                        bool(torch.allclose(d_s, d_1, rtol=1e-5,
                                            atol=1e-4))))
        out["vs_single"] = cmp
        out["centroid_err"] = float((c_sh - one.centroids).abs().max())
        del one
    del sh
    torch.cuda.empty_cache()
    # the exactness corpus (phase 6's): nprobe = K against search_brute
    _, xe, qe = exact_corpus(dev)
    ke = EXACT[1]
    ex = IVFIndex.build(xe, k=ke, max_iters=8, seed=SEED, pctx=pctx)
    ids, dd = ex.search(qe, topk=TOPK, nprobe=ke)
    ids_b, dd_b = ex.search_brute(qe, topk=TOPK)
    out["exact_results"] = (ids.cpu(), dd.cpu())
    out["exact"] = near_ties(ids, ids_b, xe, qe)
    out["exact"]["dist_err"] = float((dd - dd_b).abs().max())
    del ex, xe
    # build(pctx=) at the IVF cell: recall@10 against search_brute
    zero()
    built, build_s = wall_s(lambda: IVFIndex.build(x, k=k, max_iters=8,
                                                   seed=SEED, pctx=pctx))
    out["build_counts"] = read()
    out["build_s"] = build_s
    built_ids = [built.search(qb, topk=TOPK, nprobe=NPROBE)[0]
                 for qb in queries]
    out["build_results"] = [i.cpu() for i in built_ids]
    out["build_recall"] = [recall_at_k(i, b)
                           for i, b in zip(built_ids, brute(built))]
    return out


def near_ties(ids, ref_ids, x, q):
    """Where ``ids`` and ``ref_ids`` differ, the gap between the float64
    distances of the two ids' rows, against the fp32 worst case ``2 d u
    (|q| + max |x|)^2``: ids may differ only on such near-ties."""
    q64 = q.double().unsqueeze(1)

    def true_d(i):
        return ((x[i.long().clamp(0, x.shape[0] - 1)].double() - q64) ** 2
                ).sum(-1)
    mag = (q.norm(dim=-1).max() + x.norm(dim=-1).max()) ** 2
    tol = float(2 * x.shape[1] * U32 * mag)
    diff = ids != ref_ids
    gap = float((true_d(ids) - true_d(ref_ids)).abs()[diff].max()) \
        if bool(diff.any()) else 0.0
    return {"mismatches": int(diff.sum()), "tie_gap": gap, "tol": tol,
            "ok": gap <= tol}


def routed_corpus(dev):
    """Phase 5b's routed cell (seed SEED + 14): ``(gen, cent, xr, qr)``,
    ``ROUTED[0]`` fine centroids around meta-centres (scale 8, unit noise),
    each cell's ``ROUTED[2]`` rows its centroid plus 0.05 noise (row i at
    centroid i % K), ``IVF_B`` queries; ``gen`` goes on."""
    import torch
    kr, n_meta, per_cell = ROUTED
    dr, nr = 128, kr * per_cell
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    meta = torch.randn(n_meta, dr, device=dev, generator=gen) * 8.0
    cent = meta[torch.randint(0, n_meta, (kr,), device=dev, generator=gen)]
    cent += torch.randn(kr, dr, device=dev, generator=gen)
    xr = cent.repeat(per_cell, 1)
    xr += 0.05 * torch.randn(nr, dr, device=dev, generator=gen)
    qr = xr[torch.randint(0, nr, (IVF_B,), device=dev, generator=gen)]
    qr = qr + 0.05 * torch.randn(IVF_B, dr, device=dev, generator=gen)
    return gen, cent, xr, qr


def exact_corpus(dev):
    """Phase 6's exactness corpus (seed SEED + 5): ``(centres, x, q)``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ne, ke, de = EXACT
    ce = torch.randn(ke, de, device=dev, generator=gen) * 5.0
    xe = ce[torch.randint(0, ke, (ne,), device=dev, generator=gen)]
    xe += 0.4 * torch.randn(ne, de, device=dev, generator=gen)
    qe = ce[torch.randint(0, ke, (EXACT_B,), device=dev, generator=gen)]
    qe += 0.4 * torch.randn(EXACT_B, de, device=dev, generator=gen)
    return ce, xe, qe


def router_copy(router, dev):
    """A fresh router with ``router``'s state (an index's router moves on
    its refresh, so two indexes never share one)."""
    from repro_torch.index.router import TwoLevelRouter
    return TwoLevelRouter(router.coarse, router.owner,
                          nprobe_c=router.nprobe_c, device=dev)


def axes_case(dev, pctx, name, router=None):
    """One index of ``PAR_AXES`` over ``pctx`` (None: one device), built from
    its cell's centroids: the corpus added (the routed cell's in chunks of
    ``ROUTED_CHUNK``), its searches, an add of ``PAR_ADD_ROWS`` rows and a
    refresh, its searches again. The IVF cell searches its ``IVF_BATCHES``
    batches at ``NPROBE``; the routed cell its first ``PAR_ROUTED_B``
    queries at each of ``PAR_ROUTED_NPROBE``, with a copy of ``router``
    (trained over the fine centroids when None). On q8 every search runs
    again with the cache set aside (the ``rescore="host"`` oracle). Returns
    the results on the host, the seconds of each search, the wire bytes of
    the last search, the launch counts and the router it used."""
    import torch
    from repro_torch.index import IVFIndex
    from repro_torch.index.router import TwoLevelRouter
    from repro_torch.kernels import ops
    zero, read = launch_counters()
    kw = dict(PAR_AXES[name])
    if name == "routed":
        gen, cent, x, qr = routed_corpus(dev)
        points = [(qr[:PAR_ROUTED_B], npb) for npb in PAR_ROUTED_NPROBE]
        if router is None:
            router = TwoLevelRouter.train(cent, max_iters=4)
        kw["router"] = router_copy(router, dev)
        cap, chunk = 8, ROUTED_CHUNK
    else:
        gen, cent, x, queries = ivf_corpus(dev)
        points = [(qb, NPROBE) for qb in queries]
        cap = int(torch.bincount(ops.flash_assign(x, cent)[0].long(),
                                 minlength=cent.shape[0]).max())
        chunk = x.shape[0]
    k, d = cent.shape
    x2 = cent[torch.randint(0, k, (PAR_ADD_ROWS,), device=dev, generator=gen)]
    x2 += 0.4 * torch.randn(PAR_ADD_ROWS, d, device=dev, generator=gen)
    torch.cuda.reset_peak_memory_stats()
    zero()
    idx = IVFIndex(cent, cap, pctx=pctx, **kw)
    for lo in range(0, x.shape[0], chunk):
        idx.add(x[lo:lo + chunk])
    del x
    out = {"results": [], "host": [], "batch_s": [], "router": router}

    def searches():
        for qb, npb in points:
            if pctx is not None:
                pctx.wire_bytes = dict.fromkeys(pctx.wire_bytes, 0)
            res, sec = wall_s(lambda: idx.search(qb, topk=TOPK, nprobe=npb))
            out["results"].append(tuple(t.cpu() for t in res))
            out["batch_s"].append(sec)
            if pctx is not None:
                out["wire"] = dict(pctx.wire_bytes)
            if idx.store.codec_kind != "fp32":
                cache, idx.store.cache = idx.store.cache, None
                try:
                    out["host"].append(tuple(t.cpu() for t in idx.search(
                        qb, topk=TOPK, nprobe=npb)))
                finally:
                    idx.store.cache = cache
    idx.search(points[0][0], topk=TOPK, nprobe=points[0][1])   # warm-up
    searches()
    idx.add(x2)
    idx.refresh()
    searches()
    torch.cuda.synchronize()
    out["counts"] = read()
    b, npb = points[0][0].shape[0], points[0][1]
    out["modeled"] = idx.search_collective_bytes(b, TOPK, npb)
    out["exchange"] = idx.row_exchange_bytes(b, TOPK, npb)
    out["resident_bytes"] = idx.resident_bytes()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del idx
    torch.cuda.empty_cache()
    return out


def axes_exact(dev, pctx, name):
    """The index of ``PAR_AXES[name]`` over the exactness corpus, searched
    at nprobe = K: ``(ids, dists)`` and ``search_brute``'s ids on the
    host."""
    import torch
    from repro_torch.index import IVFIndex
    from repro_torch.kernels import ops
    ce, xe, qe = exact_corpus(dev)
    cap = int(torch.bincount(ops.flash_assign(xe, ce)[0].long(),
                             minlength=ce.shape[0]).max())
    ex = IVFIndex(ce, cap, pctx=pctx, **PAR_AXES[name])
    ex.add(xe)
    ids, dd = ex.search(qe, topk=TOPK, nprobe=ce.shape[0])
    ids_b, _ = ex.search_brute(qe, topk=TOPK)
    ties = near_ties(ids, ids_b, xe, qe)
    del ex, xe
    torch.cuda.empty_cache()
    return ids.cpu(), dd.cpu(), ids_b.cpu(), ties


def same_bits(u, v):
    """Tensors, or nested sequences of them, equal bit for bit."""
    import torch
    if torch.is_tensor(u):
        return torch.equal(u, v)
    return len(u) == len(v) and all(map(same_bits, u, v))


def axes_kernels(name):
    """The kernels an index of ``PAR_AXES`` must launch beside the probe:
    the fp32 store scan, or the q8 store scan, the rescore and the cache
    insert."""
    if PAR_AXES[name].get("codec") == "q8":
        return ("flash_probe_store_q8", "rescore_cache_insert")
    return ("flash_probe_store",)


def ran_axes(tag, name, counts):
    """Checks that an index of ``PAR_AXES`` launched the probe (tile or list
    mode), the scan of its codec, and on q8 the rescore (warp or list mode)
    and the cache insert."""
    probe = counts["flash_probe_tile"] + counts["flash_probe"]
    rescore = counts["flash_probe_grouped_warp"] + counts["flash_probe_grouped"]
    q8 = PAR_AXES[name].get("codec") == "q8"
    check(probe > 0 and (rescore > 0 or not q8)
          and all(counts[kn] > 0 for kn in axes_kernels(name)),
          f"parallel {tag} {name}: the probe, {', '.join(axes_kernels(name))}"
          f"{' and the rescore' if q8 else ''} launched ({counts})")


def axes_compare(got, want, rtol=0.0):
    """Per search of two ``axes_case`` results: ``(ids equal, ids that
    differ, max distance error, distances equal (rtol 0: bit for bit, else
    within rtol))``."""
    import torch
    out = []
    for (i_s, d_s), (i_1, d_1) in zip(got, want):
        out.append((torch.equal(i_s, i_1), int((i_s != i_1).sum()),
                    float((d_s - d_1).abs().max()),
                    torch.equal(d_s, d_1) if rtol == 0.0 else
                    bool(torch.allclose(d_s, d_1, rtol=rtol, atol=1e-4))))
    return out


def _rank_axes(rank, dev):
    """Case (d') on one of four ranks sharing the card, mesh 2x2: each index
    of ``PAR_AXES``, and on rank 0 its single-rank twin; then the indexes
    over the exactness corpus at full probe."""
    import torch
    from repro_torch.core.parallel import ParallelContext, build_mesh
    pctx = ParallelContext.for_mesh(build_mesh((2, 2), ("data", "model"),
                                               backend="gloo"))
    out, router = {}, None
    for name in PAR_AXES:
        res = axes_case(dev, pctx, name, router)
        router = res.pop("router")
        if rank == 0:
            one = axes_case(dev, None, name, router)
            res["vs_single"] = axes_compare(res["results"], one["results"],
                                            rtol=1e-5)
            del one
        out[name] = res
    for name in PAR_AXES:
        ids, dd, ids_b, ties = axes_exact(dev, pctx, name)
        out[f"exact/{name}"] = {"results": [(ids, dd)], "ties": ties}
        if rank == 0 and PAR_AXES[name].get("codec") == "q8":
            one = axes_exact(dev, None, name)
            out[f"exact/{name}"]["vs_single"] = axes_compare(
                [(ids, dd)], [one[:2]], rtol=1e-5)
    torch.cuda.synchronize()
    return out


# (e): the sharded index's reliability (queue A item 6b, parts 4-6) at the
# IVF cell over phase 11's two indexes (the same seeds), on a 1x1 NCCL mesh
# against one device and on 2x2 gloo ranks sharing the card. A durability
# run of E_ADDS adds of REL_ADD_ROWS rows, a unit after each, refresh and
# snapshot every E_SNAP adds, killed as its second snapshot begins; chaos
# seeds CHAOS_SEEDS over E_CHAOS_UNITS units with an add every
# E_CHAOS_EVERY; the dead-shard check at full probe on E_DEAD_B queries; the
# dead cells' repair over E_LOW_ROWS rows in cells 0..K/2-1
REL_E = {"fp32/padded/flat": ({}, SEED + 20),
         "q8/paged/two_level": (dict(codec="q8", store="paged",
                                     page_size=PAGE, router="two_level"),
                                SEED + 21)}
E_ADDS, E_SNAP = 8, 4
E_CHAOS_UNITS, E_CHAOS_EVERY = 16, 4
E_DEAD_B, E_LOW_ROWS, E_QPS_REQUESTS = 64, 262144, 16
NAN_SEED, DEAD_SHARD = 9, 1
# float arrays of a snapshot that a mesh of several data shards sums in
# another order than one device (held within E_RTOL / E_ATOL there)
E_FLOAT_KEYS = ("centroids", "stats_sums", "stats_counts", "stats_inertia",
                "pending_sums", "pending_counts", "pending_inertia")
E_RTOL, E_ATOL = 1e-5, 1e-4


def rel_corpus(dev, seed):
    """Phase 11's corpus of one index (``seed``): ``(centres, x, x2, adds,
    units, held, x_low)``: ``IVF[0]`` rows, an add of ``REL_ADD_ROWS``,
    the durability run's adds and units, a held-out batch, and
    ``E_LOW_ROWS`` rows around the lower half of the centres."""
    import torch
    n, k, d = IVF
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(k, d, device=dev, generator=gen) * 5.0

    def blobs(rows, top=k):
        lab = torch.randint(0, top, (rows,), device=dev, generator=gen)
        return centers[lab] + 0.4 * torch.randn(rows, d, device=dev,
                                                generator=gen)
    x = blobs(n)
    x2 = blobs(REL_ADD_ROWS)
    adds = [blobs(REL_ADD_ROWS) for _ in range(E_ADDS)]
    units = [blobs(IVF_B) for _ in range(E_ADDS)]
    return centers, x, x2, adds, units, blobs(IVF_B), blobs(E_LOW_ROWS,
                                                           k // 2)


def snapshot_diff(dir_a, dir_b, seqno, exact):
    """Key by key, the npz arrays of two snapshots at ``seqno``, and their
    manifests' store meta but ``n_shards`` and ``pps``: ``(keys that differ,
    max error of the float keys)``; the float keys within ``E_RTOL`` /
    ``E_ATOL`` unless ``exact``."""
    import numpy as np
    from repro_torch.reliability import read_manifest
    name = f"index_{seqno:08d}.npz"
    with np.load(os.path.join(dir_a, name)) as fa, \
            np.load(os.path.join(dir_b, name)) as fb:
        a, b = dict(fa), dict(fb)
    bad, err = sorted(set(a) ^ set(b)), 0.0
    for key in sorted(set(a) & set(b)):
        u, v = a[key], b[key]
        if u.shape != v.shape:
            bad.append(key)
        elif key in E_FLOAT_KEYS and not exact:
            err = max(err, float(np.abs(u - v).max(initial=0.0)))
            if not np.allclose(u, v, rtol=E_RTOL, atol=E_ATOL):
                bad.append(key)
        elif not np.array_equal(u, v):
            bad.append(key)
    ma, mb = (dict(read_manifest(dd)["store"]) for dd in (dir_a, dir_b))
    for m in (ma, mb):
        m.pop("n_shards", None)
        m.pop("pps", None)
    if ma != mb:
        bad.append("manifest store meta")
    return bad, err


def rel_mesh_case(dev, pctx, label, rank, root, others=()):
    """Part (e) on one index of ``REL_E`` over ``pctx`` (every rank calls
    it; rank 0 also drives the one-device twin): the dead shard (more than
    one K-shard), ``nan_stats`` and the guarded refresh, the dead cells'
    repair, chaos seeds under the policy, the durability run killed and
    recovered onto ``pctx``, its snapshot restored onto each context of
    ``others``; times and launch counts. Snapshots go under ``root``.
    ``counts`` are the mesh path's launches alone: the one-device twin's
    work runs between windows that are not counted, and the dead-shard
    check's launches (at nprobe K, the probe's list mode) are
    ``dead_counts``, a run of its own. Returns the results on the host."""
    import torch
    from repro_torch.index import IVFIndex
    from repro_torch.index.router import TwoLevelRouter
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.reliability import (AddLog, FaultEvent, FaultInjector,
                                         FaultPlan, HealthPolicy,
                                         clone_index)
    from repro_torch.serve import SearchConfig, SearchEngine
    zero, read = launch_counters()
    kw, seed = REL_E[label]
    n, k, d = IVF
    one = rank == 0
    centers, x, x2, adds, units, held, x_low = rel_corpus(dev, seed)
    router = TwoLevelRouter.train(centers, max_iters=4) \
        if kw.get("router") else None

    def fullest(rows):   # the capacity that holds ``rows`` (not counted)
        return int(torch.bincount(ops.flash_assign(rows, centers)[0].long(),
                                  minlength=k).max())
    cap_x, cap_low = fullest(x), fullest(x_low)

    def make(ctx, rows, cap):
        kk = dict(kw)
        if router is not None:
            kk["router"] = router_copy(router, dev)
        idx = IVFIndex(centers, cap, pctx=ctx, **kk)
        idx.add(rows)
        return idx

    def host(res):
        return tuple(t.cpu() for t in res)

    def nan_injector():
        return FaultInjector(FaultPlan([FaultEvent("add", "nan_stats", 0,
                                                   arg=NAN_SEED)]))
    out = {"label": label}
    counted = collections.Counter()

    def bank():   # the mesh path's launches since the last zero()
        torch.cuda.synchronize()
        counted.update(read())
        zero()
    t_case = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    twin = make(None, x, cap_x) if one else None   # not counted
    zero()
    idx = make(pctx, x, cap_x)
    # 1. dead shard: the filtered brute force, then the healthy search again;
    # an exactness check at full probe (L = K / P_k = 512 takes the probe's
    # list mode), counted as a run of its own
    if pctx.n_k_shards > 1:
        bank()
        qd = held[:E_DEAD_B]
        healthy = host(idx.search(qd, topk=TOPK, nprobe=k))
        idx.faults = FaultInjector(FaultPlan(
            [FaultEvent("search", "dead_shard", 0, arg=DEAD_SHARD)]))
        dead = host(idx.search(qd, topk=TOPK, nprobe=k))
        healed = host(idx.search(qd, topk=TOPK, nprobe=k))
        idx.faults = None
        torch.cuda.synchronize()
        out["dead_counts"] = read()
        # the surviving shards' rows: the ids the store's posting lists put
        # in other cells than the dead shard's (a gather: every rank), read
        # from the corpus (the rows an id was added with; on q8 the rows
        # the rescore reads from the cache)
        ids, off = idx.posting_lists()
        rec = {"finite": bool(torch.isfinite(dead[1]).all()),
               "healed": same_bits(healed, healthy),
               "ids_changed": int((dead[0] != healthy[0]).sum())}
        if one:
            kl = k // pctx.n_k_shards
            alive = torch.cat([ids[:off[DEAD_SHARD * kl]],
                               ids[off[(DEAD_SHARD + 1) * kl]:]]).long()
            pos, _ = kref.probe_ref(qd, x[alive], TOPK)
            rec.update(near_ties(dead[0].to(dev), alive[pos.long()], x, qd))
        out["dead"] = rec
        del ids, off
        zero()
    del x
    torch.cuda.empty_cache()

    def nan_then_guard(ix):
        ix.faults = nan_injector()
        ix.add(x2)
        ix.faults = None
        ix.refresh(guard=True)
        return {"repaired": ix.repaired_cells,
                "centroids": ix.global_centroids().cpu(),
                "search": host(ix.search(held, topk=TOPK, nprobe=NPROBE))}

    def repair(ctx):
        low = make(ctx, x_low, cap_low)
        low.refresh(repair_dead=True)
        return {"reseeded": low.reseeded_cells,
                "centroids": low.global_centroids().cpu()}
    # 2. nan_stats on an add, then the guarded refresh; 3. the dead cells'
    # repair: the upper half of the cells holds no row (the twin alike,
    # outside the counted windows)
    out["nan"] = nan_then_guard(idx)
    out["repair"] = repair(pctx)
    if one:
        bank()
        tw = nan_then_guard(twin)
        out["nan"].update(twin_repaired=tw["repaired"],
                          twin_centroids=tw["centroids"],
                          twin_search=tw["search"])
        out["twin_repair"] = repair(None)
        zero()
    torch.cuda.empty_cache()
    pol = HealthPolicy()
    cfg = dict(topk=TOPK, nprobe=NPROBE, query_batch=IVF_B,
               refresh_every=E_SNAP)
    # 4. chaos: each seed over a clone of the index
    out["chaos"] = []
    for s in CHAOS_SEEDS:
        c = clone_index(idx)
        ce = SearchEngine(c, SearchConfig(**cfg), health=pol,
                          faults=FaultInjector(FaultPlan.seeded(s)))
        finite, err = True, None
        try:
            for u in range(E_CHAOS_UNITS):
                if u % E_CHAOS_EVERY == 0:
                    ce.add(adds[u // E_CHAOS_EVERY])
                finite &= bool(torch.isfinite(
                    ce.search(units[u % len(units)])[1]).all())
        except Exception as e:   # the contract: nothing raises
            err = f"{type(e).__name__}: {e}"[:200]
        out["chaos"].append({"seed": s, "finite": finite, "error": err,
                             "counters": ce.counters.as_dict(),
                             "fired": [e.kind for e in c.faults.fired]})
        del c, ce
    torch.cuda.empty_cache()
    # 5. durability: killed as its second snapshot begins, recovered onto
    # the mesh; an uninterrupted twin on the mesh, and on rank 0 one on one
    # device that snapshots the same adds
    sdir = os.path.join(root, f"{label.replace('/', '_')}_mesh")
    base = clone_index(idx)
    mesh_twin = SearchEngine(base, SearchConfig(**cfg), health=pol)
    eng = SearchEngine(idx, SearchConfig(**cfg, snapshot_dir=sdir,
                                         snapshot_every=E_SNAP), health=pol)
    saves, save_s, real_save = [], [], idx.save

    class Killed(Exception):
        pass

    def save_or_die(*a, **kw_):
        saves.append(1)
        if len(saves) == 2:   # the crash: as this snapshot begins
            raise Killed
        res, t = wall_s(lambda: real_save(*a, **kw_))
        save_s.append(t)
        return res
    idx.save = save_or_die
    killed_at = None
    for i in range(E_ADDS):
        try:
            eng.add(adds[i])
        except Killed:
            killed_at = i
            break
        eng.search(units[i])
    for i in range(E_ADDS):
        mesh_twin.add(adds[i])
        mesh_twin.search(units[i])
    del eng, idx
    torch.cuda.empty_cache()
    replay_s, real_add = [], SearchEngine.add

    def timed_add(self, x_new):
        res, t = wall_s(lambda: real_add(self, x_new))
        replay_s.append(t)
        return res
    SearchEngine.add = timed_add
    try:
        back, recover_s = wall_s(lambda: SearchEngine.recover(
            sdir, SearchConfig(**cfg, snapshot_every=E_SNAP), health=pol,
            pctx=pctx))
    finally:
        SearchEngine.add = real_add
    got, want = host(back.search(held)), host(mesh_twin.search(held))
    refreshes = (back.refresh_count, mesh_twin.refresh_count)
    del mesh_twin, base
    torch.cuda.empty_cache()
    snap_bytes = os.path.getsize(os.path.join(sdir, f"index_{E_SNAP:08d}"
                                              ".npz"))
    out["durability"] = {
        "killed_at": killed_at, "replayed": back.counters.
        wal_records_replayed, "recovered_equal": same_bits(got, want),
        "ids_differ": int((got[0] != want[0]).sum()),
        "refreshes": refreshes,
        "recover_s": recover_s, "replay_s": sum(replay_s),
        "save_s": save_s, "snapshot_bytes": snap_bytes,
        "held": got}
    if one:   # the one-device twin's snapshot of the same adds (not counted)
        bank()
        tdir = os.path.join(root, f"{label.replace('/', '_')}_one")
        te = SearchEngine(twin, SearchConfig(**cfg, snapshot_dir=tdir,
                                             snapshot_every=E_SNAP),
                          health=pol)
        for i in range(E_SNAP):
            te.add(adds[i])
            te.search(units[i])
        bad, err = snapshot_diff(sdir, tdir, E_SNAP,
                                 exact=pctx.n_data_shards == 1)
        out["durability"]["vs_one_device"] = {"differ": bad,
                                              "float_err": err}
        del te, twin
        zero()
    torch.cuda.empty_cache()
    # times: a WAL append, clone_index, queries/s with and without the
    # policy (on the recovered index)
    live = back.index
    wal = AddLog(os.path.join(root, f"wal_{label.replace('/', '_')}"),
                 pctx=pctx)
    out["wal_append_s"] = [wall_s(lambda i=i: wal.append(i + 1, adds[i]))[1]
                           for i in range(3)]
    out["clone_s"] = [wall_s(lambda: clone_index(live))[1] for _ in range(3)]

    def qps(health):
        e = SearchEngine(live, SearchConfig(**cfg), health=health)
        e.search(units[0])
        reqs = [units[i % len(units)] for i in range(E_QPS_REQUESTS)]

        def go():
            rids = [e.submit(qq) for qq in reqs]
            e.pump()
            return [e.take(rr) for rr in rids]
        _, t = wall_s(go)
        return E_QPS_REQUESTS * IVF_B / t
    out["qps"] = {"without": [qps(None), qps(None)],
                  "with": [qps(pol), qps(pol)]}
    del back, live
    torch.cuda.empty_cache()
    # the snapshot restored onto each of the other meshes
    restores = {}
    for tag, ctx in (("same", pctx), *others):
        r, t = wall_s(lambda: IVFIndex.load(sdir, seqno=E_SNAP, pctx=ctx))
        restores[tag] = {"search": host(r.search(held, topk=TOPK,
                                                 nprobe=NPROBE)),
                         "load_s": t}
        del r
        torch.cuda.empty_cache()
    out["restores"] = restores
    bank()
    out["counts"] = {kk: counted[kk] for kk in read()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_case
    return out


def jsonable(obj):
    """``obj`` (nested dicts and lists) without its tensors and tuples of
    tensors, which the checks read and the details file does not keep."""
    import torch

    def keep(v):
        return not (torch.is_tensor(v) or (isinstance(v, tuple) and v
                                           and torch.is_tensor(v[0])))
    if isinstance(obj, dict):
        return {kk: jsonable(v) for kk, v in obj.items() if keep(v)}
    if isinstance(obj, list):
        return [jsonable(v) for v in obj if keep(v)]
    return obj


def _rank_rel(rank, dev):
    """Part (e) on one of four ranks sharing the card, mesh 2x2, each index
    of ``REL_E``; its snapshots restored onto 1x4 and 4x1 meshes of the same
    ranks. Snapshots go under ``CHIP_SMOKE_REL_DIR`` (the parent's)."""
    import torch
    from repro_torch.core.parallel import ParallelContext, build_mesh
    ctx = {shape: ParallelContext.for_mesh(build_mesh(
        shape, ("data", "model"), backend="gloo"))
        for shape in ((2, 2), (1, 4), (4, 1))}
    root = os.environ["CHIP_SMOKE_REL_DIR"]
    out = {label: rel_mesh_case(dev, ctx[(2, 2)], label, rank, root,
                                others=(("1x4", ctx[(1, 4)]),
                                        ("4x1", ctx[(4, 1)])))
           for label in REL_E}
    torch.cuda.synchronize()
    return out


def parallel_rank(rank, world, init_file, case, out_dir):
    """One rank of phase 12, in a spawned process on the card: a gloo world
    of ``world`` ranks (the ranks share one card), then ``case``, its
    results saved to ``out_dir``. Any error ends the process non-zero."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_PLAN_CACHE"] = "off"   # the parent's plan file is its
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        res = {"fits": _rank_fits, "ivf": _rank_ivf,
               "axes": _rank_axes, "rel": _rank_rel}[case](rank, dev)
    finally:
        dist.destroy_process_group()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save(res, Path(out_dir) / f"{case}{rank}.pt")


def spawn_ranks(case, world):
    """Run ``parallel_rank`` on ``world`` spawned processes; join them
    within ``PAR_JOIN_S`` (the group is killed past it). Returns ``(results
    or None by rank, exit codes, seconds)``."""
    import multiprocessing as mp
    import shutil
    import tempfile
    import torch
    ctx = mp.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, world, str(tmp / "init"), case, str(tmp)))
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, PAR_JOIN_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    secs = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    res = [torch.load(tmp / f"{case}{r}.pt") if code == 0 else None
           for r, code in enumerate(codes)]
    shutil.rmtree(tmp, ignore_errors=True)
    return res, codes, secs


def parallel_phase(dev, smi, zero_counts, read_counts, details):
    """Phase 12: the parallel layer on the card. (a) a world of one rank
    (NCCL): the distributed fit through ``for_mesh`` bit for bit
    ``KMeans.fit``, and with an explicit cells axis (the two-stage path);
    ``StreamingKMeans(pctx=)`` over phase 8's stream bit for bit the
    single-device one; the launcher's ``--mesh 1x1``. (b) two ranks sharing
    the card (gloo), mesh 2x1: the same fit. (c) two ranks, mesh 1x2, at
    largeN_largeK: the two-stage argmin bit for bit FlashAssign's, one
    K-sharded iteration, the owned statistics against the plain version.
    (d) four ranks, mesh 2x2, at the IVF cell: a sharded and a single-rank
    index from the same centroids, bit for bit, before and after an add and
    a refresh; full probe against ``search_brute``; ``build(pctx=)``. (d')
    the sharded index's search axes. (e) the sharded index's reliability
    (``rel_mesh_part``). Each rank's launch counts. Returns the counted
    runs (``(counts, paged store)``) and the named runs outside the main
    path (``(name, counts, paged store)``)."""
    import torch
    from repro_torch.core import KMeans, KMeansConfig, StreamingKMeans
    from repro_torch.core import parallel as par
    from repro_torch.core.parallel import ParallelContext
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    rec = details.setdefault("parallel", {"card": smi})
    runs = []
    n, k, d = PAR_FIT
    print(f"\n[parallel] (a) one rank (NCCL): the distributed fit at N={n} "
          f"K={k} d={d}, {PAR_FIT_ITERS} iterations, tol 0", flush=True)
    x, c0 = fit_corpus(dev, PAR_FIT, SEED + 12, 5.0, 0.4)
    cfg = KMeansConfig(k=k, max_iters=PAR_FIT_ITERS)
    km = KMeans(cfg, device=dev)
    st = km.fit(x, c0=c0)
    c1, ids1 = km.iterate(x, c0)[:2]
    par.init_world("cuda", "nccl")
    try:
        mesh = par.build_mesh((1, 1), ("data", "model"), backend="nccl")
        p1 = ParallelContext.for_mesh(mesh)
        pk = ParallelContext(mesh, k_axis="model")
        fit1, fitk = p1.make_kmeans_fit(cfg), pk.make_kmeans_fit(cfg)
        zero_counts()
        r = fit1(x, c0)
        torch.cuda.synchronize()
        counts = read_counts()
        runs.append((counts, False))
        same = (torch.equal(r.centroids, st.centroids)
                and torch.equal(r.assignments, st.assignments)
                and r.iterations == int(st.iteration))
        check(same, f"parallel (a) for_mesh 1x1: centroids, assignments and "
                    f"iterations ({r.iterations}) equal KMeans.fit's bit for "
                    f"bit")
        zero_counts()
        ids1_k = pk.make_assign(cfg)(x, c0)[0]
        rk = fitk(x, c0)
        torch.cuda.synchronize()
        counts_k = read_counts()
        runs.append((counts_k, False))
        share = float((rk.assignments == st.assignments).float().mean())
        c_err = float((rk.centroids - st.centroids).abs().max())
        check(torch.equal(ids1_k, ids1),
              "parallel (a) k_axis=model 1x1: the first iteration's ids "
              "equal KMeans.iterate's bit for bit")
        check(bool(torch.allclose(rk.centroids, st.centroids, rtol=1e-5,
                                  atol=1e-5)) and rk.iterations
              == int(st.iteration),
              f"parallel (a) k_axis=model 1x1: centroids within rtol=atol="
              f"1e-5 of KMeans.fit's (max err {c_err:.3g}), {rk.iterations} "
              f"iterations; {share:.6f} of the ids equal")
        ms_fit = events_ms(lambda: fit1(x, c0), reps=2) / PAR_FIT_ITERS
        ms_fitk = events_ms(lambda: fitk(x, c0), reps=2) / PAR_FIT_ITERS
        ms_iter = events_ms(lambda: km.iterate(x, c0), reps=3)
        print(f"  an iteration: {ms_fit:.3f} ms through for_mesh, {ms_fitk:.3f}"
              f" ms through the two-stage path, KMeans.iterate {ms_iter:.3f} "
              f"ms (CUDA events; {smi})", flush=True)
        rec["a"] = {"bit_equal": same, "iterations": r.iterations,
                    "k_axis_ids_share": share, "k_axis_centroid_err": c_err,
                    "ms_iter_for_mesh": ms_fit, "ms_iter_k_axis": ms_fitk,
                    "ms_iterate": ms_iter, "counts": counts,
                    "counts_k_axis": counts_k}
        a_ref = {"centroids": st.centroids.cpu(), "ids1": ids1.cpu(),
                 "ids": st.assignments.cpu(), "centroids1": c1.cpu(),
                 "inertia": float(st.inertia)}
        del x, c0, st, c1, ids1, ids1_k, r, rk
        torch.cuda.empty_cache()
        # FlashLloyd's statistics are the same bits from run to run
        xf, cf = fit_corpus(dev, (65536, 256, 128), SEED + 14, 2.0, 1.0)
        first = ops.flash_lloyd_step(xf, cf)
        same_runs = sum(all(torch.equal(u, v) for u, v in zip(
            first, ops.flash_lloyd_step(xf, cf))) for _ in range(4))
        check(same_runs == 4, f"parallel (a) FlashLloyd at N 65,536, K 256: "
                              f"{same_runs} of 4 reruns equal the first bit "
                              f"for bit")
        rec["a"]["flash_lloyd_bit_reruns"] = same_runs
        del xf, cf, first
        # the streaming phase's stream through one device and the mesh, bit
        # for bit on the two-pass steps and on auto's (FlashLloyd) steps
        for impl in ("two_pass", "auto"):
            sizes, _, _, drifting = drifting_stream(dev, 128)
            cfg_s = KMeansConfig(k=STREAM_K, step_impl=impl)
            one = StreamingKMeans(cfg_s, decay=STREAM_DECAY,
                                  init_size=STREAM_INIT, device=dev)
            sp = StreamingKMeans(cfg_s, decay=STREAM_DECAY,
                                 init_size=STREAM_INIT, pctx=p1)
            zero_counts()
            for rows in sizes:
                xb = drifting(rows)
                one.partial_fit(xb)
                sp.partial_fit(xb)
            torch.cuda.synchronize()
            counts_s = read_counts()
            runs.append((counts_s, False))
            same = torch.equal(one.centroids, sp.centroids) and all(
                torch.equal(u, v) for u, v in zip(one.stats, sp.stats))
            err = float((one.centroids - sp.centroids).abs().max())
            rec["a"][f"stream_{impl}"] = {"bit_equal": same, "err": err,
                                          "counts": counts_s}
            check(same and (impl == "two_pass"
                            or counts_s["flash_lloyd"] > 0),
                  f"parallel (a) StreamingKMeans(pctx=) over phase 8's "
                  f"{len(sizes)} batches ({impl} steps, "
                  f"{counts_s['flash_lloyd']} FlashLloyd launches): "
                  f"centroids and statistics equal the single-device "
                  f"stream's bit for bit (max err {err:.3g})")
            del one, sp
        # (a') the sharded index's search axes on one rank with an explicit
        # cells axis: bit for bit the single-device index
        rec["a_axes"], router = {}, None
        for name in PAR_AXES:
            sh = axes_case(dev, pk, name, router)
            router = sh.pop("router")
            one = axes_case(dev, None, name, router)
            cmp = axes_compare(sh["results"], one["results"])
            runs.append((sh["counts"], "paged" in name))
            check(all(eq and dok for eq, _, _, dok in cmp),
                  f"parallel (a') {name} k_axis=model 1x1: ids and distances "
                  f"of {len(cmp)} searches (before and after an add of "
                  f"{PAR_ADD_ROWS} rows and a refresh) equal the "
                  f"single-device index's bit for bit "
                  f"({sum(nd for _, nd, _, _ in cmp)} ids differ, max "
                  f"distance error {max(e for _, _, e, _ in cmp):.3g})")
            if sh["host"]:
                check(same_bits(sh["results"], sh["host"]),
                      f"parallel (a') {name}: the device cache's searches "
                      f"equal the rescore='host' oracle's bit for bit")
            ran_axes("(a')", name, sh["counts"])
            ms = [1e3 * t for t in sh["batch_s"]]
            ms1 = [1e3 * t for t in one["batch_s"]]
            print(f"  (a') {name}: {min(ms):.2f}-{max(ms):.2f} ms a search "
                  f"(one device {min(ms1):.2f}-{max(ms1):.2f}); peak "
                  f"{sh['peak_gib']:.2f} GiB", flush=True)
            rec["a_axes"][name] = {"vs_single": cmp, "batch_ms": ms,
                                   "single_batch_ms": ms1,
                                   "peak_gib": sh["peak_gib"],
                                   "counts": sh["counts"]}
            del sh, one
        del router
        torch.cuda.empty_cache()
    finally:
        par.release_world()
    out = serve.main(["--mode", "search", "--mesh", "1x1"])
    check(out["recall"] >= 0.9 and out["collective_bytes"] == 0,
          f"parallel (a) launch/serve.py --mode search --mesh 1x1: recall "
          f"{out['recall']:.3f} >= 0.9, {out['qps']:.0f} queries/s")
    rec["a"]["launcher"] = {kk: out[kk] for kk in ("qps", "recall",
                                                   "collective_bytes")}
    torch.cuda.empty_cache()
    rec["parent_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
    rec["parent_reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    print(f"  the parent holds {rec['parent_allocated_gib']:.2f} GiB "
          f"({rec['parent_reserved_gib']:.2f} GiB reserved) as the ranks "
          f"start", flush=True)

    def ranks_ok(tag, codes, secs):
        ok = all(c == 0 for c in codes)
        check(ok, f"parallel {tag}: every rank exited 0 within "
                  f"{PAR_JOIN_S} s (exit codes {codes}, {secs:.1f} s)")
        return ok

    def ran(tag, counts, names):
        check(all(counts[kname] > 0 for kname in names),
              f"parallel {tag}: {', '.join(names)} launched ({counts})")

    # (b), (c): two ranks sharing the card
    print("\n[parallel] (b) two ranks sharing the card (gloo), mesh 2x1; "
          "(c) mesh 1x2 at largeN_largeK", flush=True)
    res, codes, secs = spawn_ranks("fits", 2)
    rec["fits_s"] = secs
    if ranks_ok("(b)(c)", codes, secs):
        b0, b1 = res[0]["b"], res[1]["b"]
        check(torch.equal(b0["ids1"], a_ref["ids1"])
              and torch.equal(b1["ids1"], b0["ids1"]),
              "parallel (b) 2x1: one iteration's ids from (a)'s c0 equal "
              "(a)'s bit for bit on both ranks")
        check(all(bool(torch.allclose(rr["b"]["centroids1"],
                                      a_ref["centroids1"], rtol=1e-5,
                                      atol=1e-5)) for rr in res),
              "parallel (b) 2x1: one iteration's centroids from (a)'s c0 "
              "within rtol=atol=1e-5 of (a)'s on both ranks")
        check(all(rr["b"]["last_ids_consistent"] for rr in res),
              "parallel (b) 2x1: the fit's final ids are, bit for bit, the "
              "argmin of its centroids one iteration back, on both ranks")
        # over the iterations a row near two centroids may change cells when
        # the sums add in another order, and the cells it leaves and joins
        # move: at most MOVED_MAX of the rows may, the other cells hold
        # (a)'s centroids within 1e-5, the inertia stays within 1e-4 of
        # (a)'s, and every centroid is the mean of the rows the fit gave
        # it, within the update's bound
        x, _ = fit_corpus(dev, PAR_FIT, SEED + 12, 5.0, 0.4)
        ids_b, ids_a = b0["ids"].to(dev), a_ref["ids"].to(dev)
        moved = torch.zeros(k, dtype=torch.bool, device=dev)
        diff = ids_b != ids_a
        moved[ids_b[diff].long()] = True
        moved[ids_a[diff].long()] = True
        cb, ca = b0["centroids"].to(dev), a_ref["centroids"].to(dev)
        kept_ok = bool(torch.allclose(cb[~moved], ca[~moved], rtol=1e-5,
                                      atol=1e-5))
        cnt = torch.bincount(ids_b.long(), minlength=k).float()
        sums = torch.zeros(k, d, device=dev, dtype=torch.float64)
        sums.index_add_(0, ids_b.long(), x.double())
        live = cnt > 0
        mean_err = (cb.double() - sums / cnt.clamp(min=1).unsqueeze(1)
                    ).abs()[live]
        bound = stats_bound(x, ids_b, k, cnt)[live] / cnt[live].unsqueeze(1)
        mean_ok = bool((mean_err <= bound).all())
        n_moved = int(diff.sum())
        share = 1.0 - n_moved / n
        c_err = float((cb - ca).abs().max())
        j_rel = abs(b0["inertia"] - a_ref["inertia"]) / a_ref["inertia"]
        del x, ids_a, sums
        check(n_moved <= MOVED_MAX * n and kept_ok and mean_ok
              and j_rel <= 1e-4 and b0["iterations"] == PAR_FIT_ITERS
              and torch.equal(b0["centroids"], b1["centroids"]),
              f"parallel (b) 2x1: {b0['iterations']} iterations; {n_moved} "
              f"rows moved <= {MOVED_MAX:.3%} of {n} ({int(moved.sum())} "
              f"cells touched); the other cells' centroids within "
              f"rtol=atol=1e-5 of (a)'s; inertia within {j_rel:.3g} <= 1e-4 "
              f"of (a)'s; every centroid the mean of its rows within 2 n u "
              f"sum|x| (max err {float(mean_err.max()):.3g}; against (a) "
              f"{c_err:.3g}); the same on both ranks")
        rec["b_vs_a"] = {"ids_share": share, "rows_moved": n_moved,
                         "cells_touched": int(moved.sum()),
                         "centroid_err": c_err, "inertia_rel": j_rel}
        for rank, rr in enumerate(res):
            want = (("flash_lloyd",) if rr["b"]["fused"]
                    else ("flash_assign", "sort_inverse_update"))
            ran(f"(b) rank {rank}", rr["b"]["counts"], want)
            ran(f"(c) rank {rank}", rr["c"]["counts"],
                ("flash_assign", "sort_inverse_update"))
            runs += [(rr["b"]["counts"], False), (rr["c"]["counts"], False)]
            cc = rr["c"]
            check(cc["ids_equal"],
                  f"parallel (c) 1x2 rank {rank}: make_assign's ids equal the "
                  f"single-rank FlashAssign's bit for bit ({cc['ids_differ']} "
                  f"differ)")
            check(cc["centroids_ok"],
                  f"parallel (c) rank {rank}: one K-sharded iteration's "
                  f"centroids within rtol=atol=1e-5 of KMeans.iterate's (max "
                  f"err {cc['centroid_err']:.3g})")
            check(cc["stats_ok"] and cc["owned_is_sliced"],
                  f"parallel (c) rank {rank}: owned_stats' sums within 2 n u "
                  f"sum|x| of the plain version (max err {cc['stats_err']:.3g};"
                  f" the extra bucket: {cc['extra_bucket_rows']} rows, err "
                  f"{cc['extra_bucket_err']:.3g}), counts equal; "
                  f"{cc['owned_stats_ms']:.3f} ms a call (ranks time-slicing "
                  f"one card)")
        print(f"  (b) a fit of {PAR_FIT_ITERS} iterations {b0['fit_s']:.3f} s "
              f"on rank 0 (2 ranks time-slicing one card, {smi}); "
              f"(c) assign {res[0]['c']['assign_s']:.3f} s, one iteration "
              f"{res[0]['c']['iter_s']:.3f} s", flush=True)
        rec["b"] = [{kk: v for kk, v in rr["b"].items()
                     if kk not in ("centroids", "ids", "ids1", "centroids1")}
                    | {"peak_gib": rr["peak_gib"]} for rr in res]
        rec["c"] = [rr["c"] for rr in res]
    # (d): four ranks sharing the card
    n, k, d = IVF
    print(f"\n[parallel] (d) four ranks sharing the card (gloo), mesh 2x2: "
          f"IVF{k},Flat N={n} d={d}, {IVF_BATCHES} batches of {IVF_B}, "
          f"topk={TOPK} nprobe={NPROBE}", flush=True)
    res, codes, secs = spawn_ranks("ivf", 4)
    rec["ivf_s"] = secs
    if ranks_ok("(d)", codes, secs):
        r0 = res[0]
        for rank, rr in enumerate(res[1:], 1):
            check(all(same_bits(rr[kk], r0[kk]) for kk in (
                "results", "exact_results", "build_results")),
                f"parallel (d) rank {rank}: its search results (before and "
                f"after the add and refresh, at full probe, from "
                f"build(pctx=)) equal rank 0's bit for bit")
        for i, (eq, ndiff, derr, dok) in enumerate(r0["vs_single"]):
            when = "after the add and refresh" if i >= IVF_BATCHES else ""
            check(eq and dok, f"parallel (d) batch {i % IVF_BATCHES} {when}: "
                              f"ids equal the single-rank index's bit for bit"
                              f" ({ndiff} differ), distances within rtol 1e-5"
                              f" (max err {derr:.3g})")
        for rank, rr in enumerate(res):
            ran(f"(d) rank {rank}", rr["counts"],
                ("flash_assign", "sort_inverse_update", "flash_probe_store"))
            check(rr["counts"]["flash_probe_tile"]
                  + rr["counts"]["flash_probe"] > 0,
                  f"parallel (d) rank {rank}: the probe launched "
                  f"({rr['counts']})")
            ran(f"(d) rank {rank} build(pctx=)", rr["build_counts"],
                ("flash_assign", "sort_inverse_update"))
            runs += [(rr["counts"], False), (rr["build_counts"], False)]
        ex = r0["exact"]
        check(ex["ok"], f"parallel (d) exactness corpus {EXACT}: nprobe=K "
                        f"equals search_brute ({ex['mismatches']} ids differ, "
                        f"gap {ex['tie_gap']:.3g} <= {ex['tol']:.3g})")
        rb = sum(r0["build_recall"]) / len(r0["build_recall"])
        check(rb >= 0.9, f"parallel (d) build(pctx=): recall@{TOPK} {rb:.4f} "
                         f">= 0.9 against search_brute ({r0['build_s']:.2f} s "
                         f"to build on 4 ranks sharing one card)")
        ms = [s * 1e3 for s in r0["batch_s"]]
        print(f"  sharded search {min(ms):.2f}-{max(ms):.2f} ms a batch of "
              f"{IVF_B} (4 ranks time-slicing one card, {smi}); "
              f"{r0['collective_bytes']} cross-rank bytes a batch (modeled); "
              f"add of {n} rows {r0['add_s']:.2f} s, of {PAR_ADD_ROWS} rows "
              f"{r0['add2_s'] * 1e3:.1f} ms; centroids after the refresh "
              f"within {r0['centroid_err']:.3g} of the single-rank index's; "
              f"each rank's peak <= "
              f"{max(rr['peak_gib'] for rr in res):.2f} GiB", flush=True)
        rec["d"] = [{kk: v for kk, v in rr.items() if not kk.endswith(
            "results")} for rr in res]
    # (d'): the sharded index's search axes, four ranks sharing the card
    print(f"\n[parallel] (d') four ranks sharing the card (gloo), mesh 2x2: "
          f"{', '.join(PAR_AXES)} (the IVF cell's {IVF_BATCHES} batches of "
          f"{IVF_B} at nprobe {NPROBE}; the routed cell K={ROUTED[0]}, "
          f"N={ROUTED[0] * ROUTED[2]} at B {PAR_ROUTED_B}, nprobe "
          f"{PAR_ROUTED_NPROBE})", flush=True)
    res, codes, secs = spawn_ranks("axes", 4)
    rec["axes_s"] = secs
    if ranks_ok("(d')", codes, secs):
        r0 = res[0]
        for rank, rr in enumerate(res[1:], 1):
            check(all(same_bits(rr[kk]["results"], r0[kk]["results"])
                      and same_bits(rr[kk].get("host", []),
                                    r0[kk].get("host", []))
                      for kk in r0 if isinstance(r0[kk], dict)),
                  f"parallel (d') rank {rank}: every index's searches (and "
                  f"the q8 host oracle's, and at full probe) equal rank 0's "
                  f"bit for bit")
        rec["d_axes"] = {}
        for name in PAR_AXES:
            a, ex = r0[name], r0[f"exact/{name}"]
            cmp = a["vs_single"]
            check(all(eq and dok for eq, _, _, dok in cmp),
                  f"parallel (d') {name}: ids of {len(cmp)} searches (before "
                  f"and after an add and a refresh) equal the single-rank "
                  f"index's bit for bit ({sum(nd for _, nd, _, _ in cmp)} "
                  f"differ), distances within rtol 1e-5 (max err "
                  f"{max(e for _, _, e, _ in cmp):.3g})")
            if a["host"]:
                check(same_bits(a["results"], a["host"]),
                      f"parallel (d') {name}: the device cache's searches "
                      f"equal the rescore='host' oracle's bit for bit")
            if "vs_single" in ex:   # q8's proposals are approximate
                eq, nd, err, dok = ex["vs_single"][0]
                check(eq and dok, f"parallel (d') {name} exactness corpus "
                                  f"{EXACT}: nprobe=K ids equal the "
                                  f"single-rank index's ({nd} differ, max "
                                  f"distance error {err:.3g})")
            else:
                t = ex["ties"]
                check(t["ok"], f"parallel (d') {name} exactness corpus "
                               f"{EXACT}: nprobe=K equals search_brute "
                               f"({t['mismatches']} ids differ, gap "
                               f"{t['tie_gap']:.3g} <= {t['tol']:.3g})")
            for rank, rr in enumerate(res):
                ran_axes(f"(d') rank {rank}", name, rr[name]["counts"])
                runs.append((rr[name]["counts"], "paged" in name))
            ms = [1e3 * t for t in a["batch_s"]]
            wire = a.get("wire", {})
            print(f"  (d') {name}: {min(ms):.2f}-{max(ms):.2f} ms a search "
                  f"(4 ranks time-slicing one card, {smi}); cross-rank bytes "
                  f"a search on rank 0: {a['modeled']} modeled (the two "
                  f"merges), measured {wire.get('all_gather', 0)} gathered "
                  f"+ {wire.get('all_reduce', 0)} all-reduced (the q8 row "
                  f"exchange alone: {a['exchange']} modeled); peaks "
                  f"{[round(rr[name]['peak_gib'], 2) for rr in res]} GiB",
                  flush=True)
            rec["d_axes"][name] = {
                "vs_single": cmp, "batch_ms": ms, "modeled_bytes":
                a["modeled"], "exchange_bytes": a["exchange"], "wire": wire,
                "peak_gib": [rr[name]["peak_gib"] for rr in res],
                "resident_bytes": [rr[name]["resident_bytes"] for rr in res],
                "counts": [rr[name]["counts"] for rr in res],
                "exact": {kk: v for kk, v in ex.items() if kk != "results"}}
        rec["axes_peak_gib"] = [rr["peak_gib"] for rr in res]
    # (e): the sharded index's reliability
    checks = []
    rel_mesh_part(dev, smi, rec, runs, checks)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  [parallel] {rec['seconds']:.1f} s", flush=True)
    return runs, checks


def rel_mesh_part(dev, smi, rec, runs, checks):
    """Part (e) of phase 12, the sharded index's reliability, on each index
    of ``REL_E``: (1) a 1x1 NCCL mesh with a cells axis against one device
    (``rel_mesh_case``): the guarded refresh's centroids, the repair, the
    durability run's snapshot bit for bit the one-device twin's; (2) the
    launcher's ``--mesh 1x1`` with every reliability flag; (3) four ranks
    sharing the card, mesh 2x2: the dead shard equal to the filtered brute
    force, ranks 1-3 bit for bit rank 0 and its ids one device's, chaos
    seeds with equal counters on every rank, recovery bit for bit the
    uninterrupted run, the snapshot restored bit for bit onto 1x4 and 4x1;
    (4) each mesh snapshot restored onto one device in this process. Adds
    each run's launch counts to ``runs`` (``(counts, paged store)``) and
    the dead-shard check's, a run outside the main path, to ``checks``
    (``(name, counts, paged store)``)."""
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch.core import parallel as par
    from repro_torch.core.parallel import ParallelContext
    from repro_torch.index import IVFIndex
    from repro_torch.launch import serve
    t_e = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_rel_mesh_")
    er = rec.setdefault("e", {"card": smi, "1x1": {}, "2x2": {}})
    got1, got2 = {}, {}   # the full results (tensors too), by index
    n, k, d = IVF
    med = statistics.median

    def nonzero(d_):
        return {kk: v for kk, v in d_.items() if v}

    def show(tag, label, r):
        du = r["durability"]
        size = du["snapshot_bytes"]
        loads = {t: v["load_s"] for t, v in r["restores"].items()}
        print(f"  (e) {tag} {label}: recover {du['recover_s']:.3f} s (the "
              f"replay of {du['replayed']} records {du['replay_s']:.3f} s); "
              f"save {du['save_s'][0]:.3f} s ({size / 2**30:.3f} GiB, "
              f"{size / du['save_s'][0] / 1e9:.2f} GB/s); loads (s) "
              f"{ {t: round(v, 3) for t, v in loads.items()} } "
              f"({size / min(loads.values()) / 1e9:.2f} GB/s at best); "
              f"clone_index {med(r['clone_s']) * 1e3:.1f} ms; WAL append "
              f"{med(r['wal_append_s']) * 1e3:.2f} ms; queries/s without "
              f"the policy {r['qps']['without'][0]:.0f}, "
              f"{r['qps']['without'][1]:.0f}, with "
              f"{r['qps']['with'][0]:.0f}, {r['qps']['with'][1]:.0f}; "
              f"peak {r['peak_gib']:.2f} GiB; {r['seconds']:.1f} s ({smi})",
              flush=True)

    def ran_e(tag, label, counts):
        need = ["flash_assign", "sort_inverse_update", "flash_probe_store"]
        if "q8" in label:
            need += ["flash_probe_store_q8", "rescore_cache_insert"]
        probe = counts["flash_probe_tile"] + counts["flash_probe"]
        rescore = counts["flash_probe_grouped_warp"] \
            + counts["flash_probe_grouped"]
        check(probe > 0 and all(counts[kn] > 0 for kn in need)
              and (rescore > 0 or "q8" not in label),
              f"(e) {tag} {label}: the probe, {', '.join(need)}"
              f"{' and the rescore' if 'q8' in label else ''} launched "
              f"({nonzero(counts)})")

    def common(tag, label, r):
        du = r["durability"]
        check(not any(c["error"] for c in r["chaos"])
              and all(c["finite"] for c in r["chaos"]),
              f"(e) {tag} {label} chaos seeds {CHAOS_SEEDS}: nothing raised "
              f"({[c['error'] for c in r['chaos']]}), every distance finite; "
              f"counters {[nonzero(c['counters']) for c in r['chaos']]}")
        check(du["killed_at"] == E_ADDS - 1
              and du["replayed"] == E_ADDS - E_SNAP and du["recovered_equal"]
              and du["refreshes"][0] == du["refreshes"][1],
              f"(e) {tag} {label}: killed at add {du['killed_at']} as its "
              f"second snapshot began, recover(pctx=) replayed "
              f"{du['replayed']} records; the held-out batch equals the "
              f"uninterrupted run's bit for bit ({du['ids_differ']} ids "
              f"differ); refreshes {du['refreshes']}")
        check(r["nan"]["repaired"] > 0,
              f"(e) {tag} {label}: nan_stats then refresh(guard=True) "
              f"repaired {r['nan']['repaired']} cells")

    try:
        # (1) one rank over NCCL, a cells axis of one shard
        par.init_world("cuda", "nccl")
        try:
            pk = ParallelContext(par.build_mesh((1, 1), ("data", "model"),
                                                backend="nccl"),
                                 k_axis="model")
            for label in REL_E:
                print(f"\n[parallel] (e) 1x1 (NCCL, k_axis=model) {label}: "
                      f"N={n} K={k} d={d}", flush=True)
                r = rel_mesh_case(dev, pk, label, 0, root)
                runs.append((r["counts"], "paged" in label))
                ran_e("1x1", label, r["counts"])
                print(f"  launches: {nonzero(r['counts'])}", flush=True)
                nn, rp = r["nan"], r["repair"]
                check(torch.equal(nn["centroids"], nn["twin_centroids"])
                      and nn["repaired"] == nn["twin_repaired"]
                      and same_bits(nn["search"], nn["twin_search"]),
                      f"(e) 1x1 {label}: after nan_stats and the guarded "
                      f"refresh, repaired_cells ({nn['repaired']}), the "
                      f"centroids and a search equal the one-device twin's "
                      f"bit for bit")
                check(rp["reseeded"] == r["twin_repair"]["reseeded"] > 0
                      and torch.equal(rp["centroids"],
                                      r["twin_repair"]["centroids"]),
                      f"(e) 1x1 {label}: refresh(repair_dead=True) re-seeded "
                      f"{rp['reseeded']} cells, the centroids bit for bit "
                      f"the one-device twin's")
                common("1x1", label, r)
                vs = r["durability"]["vs_one_device"]
                check(not vs["differ"], f"(e) 1x1 {label}: the snapshot "
                                        f"equals the one-device twin's key "
                                        f"for key, bit for bit "
                                        f"({vs['differ'] or 'all equal'})")
                show("1x1", label, r)
                got1[label] = r
                er["1x1"][label] = jsonable(r)
        finally:
            par.release_world()
        torch.cuda.empty_cache()
        # (2) the launcher with every reliability flag over --mesh 1x1
        ldir = os.path.join(root, "launcher")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lo = serve.main(["--mode", "search", "--mesh", "1x1", "--health",
                             "--chaos-seed", "7", "--snapshot-dir", ldir])
        text = buf.getvalue()
        print("  " + "\n  ".join(text.strip().splitlines()[-3:]), flush=True)
        check("restored search identical: True" in text,
              "(e) launch/serve.py --mode search --mesh 1x1 --health "
              "--chaos-seed 7 --snapshot-dir: 'restored search identical: "
              "True'")
        er["launcher"] = {kk: lo.get(kk) for kk in (
            "qps", "recall", "recover_s", "snapshot_s", "counters")}
        torch.cuda.empty_cache()
        # (3) four ranks sharing the card
        print(f"\n[parallel] (e) four ranks sharing the card (gloo), mesh "
              f"2x2: {', '.join(REL_E)}", flush=True)
        os.environ["CHIP_SMOKE_REL_DIR"] = root
        res, codes, secs = spawn_ranks("rel", 4)
        er["ranks_s"] = secs
        ok = all(c == 0 for c in codes)
        check(ok, f"(e) 2x2: every rank exited 0 within {PAR_JOIN_S} s (exit "
                  f"codes {codes}, {secs:.1f} s)")
        if ok:
            for label in REL_E:
                r0 = res[0][label]
                for rank, rr in enumerate(res[1:], 1):
                    r = rr[label]
                    same = (same_bits(r["nan"]["centroids"],
                                      r0["nan"]["centroids"])
                            and r["nan"]["repaired"] == r0["nan"]["repaired"]
                            and same_bits(r["nan"]["search"],
                                          r0["nan"]["search"])
                            and r["repair"]["reseeded"]
                            == r0["repair"]["reseeded"]
                            and same_bits(r["repair"]["centroids"],
                                          r0["repair"]["centroids"])
                            and [c["counters"] for c in r["chaos"]]
                            == [c["counters"] for c in r0["chaos"]]
                            and same_bits(r["durability"]["held"],
                                          r0["durability"]["held"])
                            and all(same_bits(r["restores"][t]["search"],
                                              r0["restores"][t]["search"])
                                    for t in r0["restores"]))
                    check(same, f"(e) 2x2 {label} rank {rank}: repaired_cells"
                                f", the guarded refresh's centroids and "
                                f"search, the repair, the chaos counters, "
                                f"the recovered and restored searches equal "
                                f"rank 0's bit for bit")
                dd = r0["dead"]
                check(dd["ok"] and dd["finite"]
                      and all(rr[label]["dead"]["healed"] for rr in res),
                      f"(e) 2x2 {label}: dead_shard {DEAD_SHARD} at nprobe K "
                      f"equals the brute force over the surviving shards' "
                      f"rows ({dd['mismatches']} ids differ, gap "
                      f"{dd['tie_gap']:.3g} <= {dd['tol']:.3g}; "
                      f"{dd['ids_changed']} ids changed from the healthy "
                      f"search), distances finite; the next call is the "
                      f"healthy search bit for bit on every rank")
                nn = r0["nan"]
                c_err = float((nn["centroids"] - nn["twin_centroids"]).abs()
                              .max())
                check(nn["repaired"] == nn["twin_repaired"]
                      and torch.equal(nn["search"][0], nn["twin_search"][0])
                      and bool(torch.allclose(nn["centroids"],
                                              nn["twin_centroids"],
                                              rtol=E_RTOL, atol=E_ATOL)),
                      f"(e) 2x2 {label}: after nan_stats and the guarded "
                      f"refresh, repaired_cells {nn['repaired']} and the "
                      f"search's ids equal one device's; centroids within "
                      f"rtol {E_RTOL}, atol {E_ATOL} (max err {c_err:.3g}: "
                      f"two data shards sum in another order)")
                rp, tr = r0["repair"], r0["twin_repair"]
                r_err = float((rp["centroids"] - tr["centroids"]).abs().max())
                check(rp["reseeded"] == tr["reseeded"] > 0
                      and bool(torch.allclose(rp["centroids"],
                                              tr["centroids"], rtol=E_RTOL,
                                              atol=E_ATOL)),
                      f"(e) 2x2 {label}: refresh(repair_dead=True) re-seeded "
                      f"{rp['reseeded']} cells as one device did; centroids "
                      f"within rtol {E_RTOL}, atol {E_ATOL} (max err "
                      f"{r_err:.3g})")
                common("2x2", label, r0)
                vs = r0["durability"]["vs_one_device"]
                check(not vs["differ"],
                      f"(e) 2x2 {label}: the snapshot equals the one-device "
                      f"twin's key for key (float statistics within rtol "
                      f"{E_RTOL}, atol {E_ATOL}, max err "
                      f"{vs['float_err']:.3g}; the rest bit for bit): "
                      f"{vs['differ'] or 'all equal'}")
                same_r = r0["restores"]["same"]["search"]
                check(all(same_bits(v["search"], same_r)
                          for v in r0["restores"].values()),
                      f"(e) 2x2 {label}: the snapshot restored onto 1x4 and "
                      f"4x1 searches bit for bit as restored onto 2x2")
                for rank, rr in enumerate(res):
                    runs.append((rr[label]["counts"], "paged" in label))
                    ran_e(f"2x2 rank {rank}", label, rr[label]["counts"])
                dead_n = collections.Counter()
                for rr in res:
                    dead_n.update(rr[label]["dead_counts"])
                name = (f"phase 12 (e) 2x2 {label}: dead_shard check at "
                        f"nprobe K, 4 ranks")
                checks.append((name, dict(dead_n), "paged" in label))
                check(dead_n["flash_probe_tile"] + dead_n["flash_probe"] > 0,
                      f"(e) 2x2 {label}: the dead-shard check went through "
                      f"the probe ({nonzero(dead_n)})")
                print(f"  {name}: {nonzero(dead_n)}", flush=True)
                print(f"  launches a rank: "
                      f"{[nonzero(rr[label]['counts']) for rr in res]}; "
                      f"peaks "
                      f"{[round(rr[label]['peak_gib'], 2) for rr in res]} GiB",
                      flush=True)
                show("2x2 rank 0", label, r0)
                rec_s = [round(rr[label]["durability"]["recover_s"], 3)
                         for rr in res]
                load_s = [[round(v["load_s"], 3)
                           for v in rr[label]["restores"].values()]
                          for rr in res]
                print(f"  each rank: recover {rec_s} s; loads (2x2, 1x4, "
                      f"4x1) {load_s} s", flush=True)
                got2[label] = r0
                er["2x2"][label] = [jsonable(rr[label]) for rr in res]
        # (4) each mesh snapshot onto one device, in this process
        for tag, got in (("1x1", got1), ("2x2", got2)):
            for label, r in got.items():
                _, _, _, _, _, held, _ = rel_corpus(dev, REL_E[label][1])
                sdir = os.path.join(root, f"{label.replace('/', '_')}_mesh")
                one, t = wall_s(lambda: IVFIndex.load(sdir, seqno=E_SNAP))
                res1 = tuple(tt.cpu() for tt in one.search(
                    held, topk=TOPK, nprobe=NPROBE))
                check(same_bits(res1, r["restores"]["same"]["search"]),
                      f"(e) {tag} {label}: the mesh's snapshot restored onto "
                      f"one device searches bit for bit as restored onto "
                      f"the mesh ({t:.3f} s to load)")
                del one
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    er["seconds"] = time.perf_counter() - t_e
    print(f"  (e) {er['seconds']:.1f} s", flush=True)


# ---- phase 13: LM serving (models, kmeans_attention, Engine) ---------------
# Llama-3-8B at full width (configs/llama3_8b.py), f32 as the reference's
# Engine computes, random weights from SEED
LM_ARCH = "llama3-8b"
LM_DENSE = (128, 128)    # check 2: prompt, tokens decoded one by one (B 1)
# check 3: depth cut to 4 layers; top = kc = 64 and a capacity factor of 66
# (cap 2,176 >= 2,048 + 16 rows), so no row drops and every cluster is read
LM_EXACT = {"layers": 4, "batch": 1, "prompt": 2048, "steps": 16,
            "recent": 8, "capacity_factor": 66.0}
LM_GEOM = {"batch": 4, "prompt": 2048, "steps": 32, "recent": 16}  # check 4
LM_ROUTED = (1, 2048, 32, 128)   # check 5: B, S, H, hd
LM_ROUTED_CLUSTERS = 16


def device_rows(step, reps):
    """``torch.profiler`` (CUPTI) over ``reps`` calls of ``step``: the
    device's kernels (and memsets, copies) by name, time and calls per
    call, largest first. The caller makes the warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:   # launch_ms: per recorded launch (the profiler may
            # record fewer launches of a short kernel than were made)
            rows.append({"name": ev.key, "ms": t / reps / 1e3,
                         "calls": ev.count / reps,
                         "launch_ms": t / ev.count / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    return rows


class LMProbe:
    """Instruments an ``Engine``'s ``_prefill``, ``_decode``,
    ``_cluster_caches`` and ``_recluster``: CUDA events around each call
    (read after the run), the finiteness of every logit row it sampled
    from (a device flag, no host read a step), the first decode's logits,
    the launches of the cluster build, the built caches' ``bcount`` and
    ``cweight``, and, with ``keep``, a copy of the prefill's keys and
    values (the build's inputs)."""

    def __init__(self, eng, read_counts, keep=False):
        import torch
        self.ev = {"prefill": [], "decode": [], "build": [], "flush": []}
        self.finite = torch.ones((), dtype=torch.bool, device=eng.device)
        self.first = None
        self.logits = []
        self.built = None
        self.kv = None
        self.build_counts = None

        def timed(name, fn, after=None):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.ev[name].append((e0, e1))
                if after is not None:
                    after(a, out)
                return out
            return run

        def logits_of(at):
            def after(_, out):
                lg = out[0][:, at]
                self.finite &= torch.isfinite(lg).all()
                self.logits.append(lg)
                if at == 0 and self.first is None:
                    self.first = lg.clone()
            return after

        build = eng._cluster_caches

        def counted_build(caches, seq_len, *a, **k):
            if keep:
                self.kv = {key: (c["k"][:, :, :seq_len].clone(),
                                 c["v"][:, :, :seq_len].clone())
                           for key, c in caches.items() if "k" in c}
            before = read_counts()
            out = build(caches, seq_len, *a, **k)
            after = read_counts()
            self.build_counts = {kn: after[kn] - before[kn] for kn in after}
            self.built = {key: (c["bcount"].clone(), c["cweight"].clone(),
                                c["bk"].shape, 2 * c["bk"].numel()
                                * c["bk"].element_size())
                          for key, c in out.items() if "bcount" in c}
            return out

        eng._prefill = timed("prefill", eng._prefill, logits_of(-1))
        eng._decode = timed("decode", eng._decode, logits_of(0))
        eng._cluster_caches = timed("build", counted_build)
        eng._recluster = timed("flush", eng._recluster)

    def ms(self, name):
        import torch
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.ev[name]]

    def min_margin(self):
        """The smallest top-two margin of the logit rows sampled from."""
        import torch
        m = [torch.topk(lg, 2, dim=-1).values for lg in self.logits]
        return float(min(float((t[:, 0] - t[:, 1]).min()) for t in m))


def _allclose_excess(got, want, rtol, atol):
    """``max(|got - want| - atol - rtol |want|)``: <= 0 is allclose."""
    return float(((got - want).abs() - atol - rtol * want.abs()).max())


def decode_against(params, cfg, ctx, toks, caches, full, p_len, tol,
                   cross_kv=None):
    """Decode ``toks[:, p_len:]`` one by one from ``caches`` and hold each
    step's logits to ``full`` (the forward's) at rtol = atol = ``tol``.
    Returns (the worst excess over the tolerance, each step's CUDA-event
    ms, the caches after the last step)."""
    import torch
    from repro_torch.models import model as M
    diffs, evs = [], []
    for t_ in range(p_len, toks.shape[1]):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ld, caches = M.decode_step(params, toks[:, t_:t_ + 1], caches, ctx,
                                   cfg, cross_kv=cross_kv)
        e1.record()
        evs.append((e0, e1))
        diffs.append(((ld[:, 0] - full[:, t_]).abs() - tol
                      - tol * full[:, t_].abs()).max())
    worst = float(torch.stack(diffs).max())
    return worst, [e0.elapsed_time(e1) for e0, e1 in evs], caches


def engine_runs(cfg, params, toks, steps, recent, fe, read_counts,
                zero_counts, keep=False, modes=("clustered", "dense")):
    """``Engine.generate`` in each mode through an ``LMProbe``: ``{mode:
    {"ids", "wall_s", "probe", "count", "counts"}}``."""
    from repro_torch.serve import Engine, ServeConfig
    patches = cfg.frontend_seq if cfg.frontend and cfg.family != "audio" \
        else 0
    res = {}
    for mode in modes:
        eng = Engine(cfg, params, ServeConfig(
            max_seq=patches + toks.shape[1] + steps + 8, mode=mode,
            recent=recent))
        probe = LMProbe(eng, read_counts, keep=keep and mode == "clustered")
        zero_counts()
        ids, wall = wall_s(lambda: eng.generate(toks, steps, frontend=fe))
        res[mode] = {"ids": ids, "wall_s": wall, "probe": probe,
                     "count": eng.recluster_count, "counts": read_counts()}
        del eng
    return res


def bucket_invariants(probe, seq_len, kc, cap):
    """Every built cache: ``bcount`` = min(its weight, cap) in every
    bucket, the weights summing to ``seq_len`` a head, (kc, cap) buckets;
    and the share of rows dropped by capacity."""
    import torch
    ok, dropped, total = True, 0.0, 0.0
    for bc, cw, shape, _ in probe.built.values():
        ok &= torch.equal(bc, torch.clamp(cw, max=cap).to(torch.int32))
        ok &= bool((cw.sum(-1) == seq_len).all())
        ok &= tuple(shape[-3:-1]) == (kc, cap)
        dropped += float((cw - bc).sum())
        total += float(cw.sum())
    return ok and bool(probe.built), dropped / max(total, 1.0)


def lm_kernel_checks(dev, x, kc, iters, rec, tag="lm"):
    """Phase 13's kernels at the clustered cache's shape: x (P, N, d) the
    prefill's keys of every (layer, sequence, kv head), the engine's initial
    centroids. FlashAssign (ids equal except on near-ties within each
    problem's ``flash_assign.score_tol``, scores within it, distances within
    ``dist_tol``), the sort-inverse update of its ids (sums within rtol 1e-5
    of sum|x| or the derived ``2 n u sum|x|``, counts equal) and FlashLloyd
    (ids equal FlashAssign's bit for bit, sums and counts of its own ids,
    inertia within rtol 1e-4), each against its plain version; their times
    (CUDA events) beside the plain versions'. Returns ``{kernel: max abs
    err}``."""
    import torch
    from repro_torch.core.kmeans import KMeansConfig
    from repro_torch.kernels import flash_assign as fa
    from repro_torch.kernels import flash_lloyd as fl
    from repro_torch.kernels import ops
    from repro_torch.models import kmeans_attention as kma
    p, n, d = x.shape
    c = kma.initial_centroids(x, kc)
    cfgk = KMeansConfig(k=kc, max_iters=iters, init="random")
    step = cfgk.resolved_step_impl(n, d, x.element_size(), device=dev)
    errs = {}
    out = rec.setdefault("kernels", {})
    # per problem, fa.score_tol and fa.dist_tol, vectorized
    cn = torch.linalg.vector_norm(c, dim=-1).amax(-1)
    xn = torch.linalg.vector_norm(x, dim=-1).amax(-1)
    mag = cn * cn + 2 * xn * cn
    stol = (fa._kernel_terms(x) + d + 1) * U32 * mag
    h = fa.sq_chain(d, x.element_size()) + 2 * d + 2
    dtol = stol + (h * xn * xn * (1 + 1 / 64) + 2 * mag) * U32

    a, m = ops.flash_assign_batched(x, c)
    ap, mp = fa.flash_assign_plain(x, c, want_dists=True)
    score_k = fa.flash_assign_raw(x, c)[1]
    score_p = fa.flash_assign_plain(x, c)[1]
    s_err = (score_k - score_p).abs().amax(-1)
    d_err = (m - mp).abs().amax(-1)
    diff = a != ap
    gap = torch.zeros_like(s_err)
    if bool(diff.any()):
        bi, ni = diff.nonzero().unbind(1)
        xr = x[bi, ni]

        def score(kk):
            ck = c[bi, kk.long()]
            return (ck * ck).sum(-1) - 2 * (xr * ck).sum(-1)
        g = (score(a[bi, ni]) - score(ap[bi, ni])).abs()
        gap.scatter_reduce_(0, bi, g, reduce="amax")
    mism = int(diff.sum())
    ok = bool((s_err <= stol).all() and (d_err <= dtol).all()
              and (gap <= stol).all())
    errs["flash_assign"] = float(s_err.max())
    out["flash_assign"] = {"mismatches": mism, "max_score_err": float(
        s_err.max()), "score_err_over_tol": float((s_err / stol).max()),
        "max_dist_err": float(d_err.max()), "tie_gap_over_tol": float(
            (gap / stol).max())}
    check(ok, f"[{tag}] flash_assign at the clustered shape (P {p}, N {n}, K "
              f"{kc}, d {d}): scores within score_tol (max "
              f"{float((s_err / stol).max()):.3g} of it), distances within "
              f"dist_tol, {mism} ids differ, each a near-tie within the "
              f"tolerance")

    s, cnt = ops.sort_inverse_update_batched(x, a, k=kc)
    ids = (a.long() + kc * torch.arange(p, device=dev).unsqueeze(1)
           ).reshape(-1)
    x2 = x.reshape(-1, d)
    sp = torch.zeros((p * kc, d), device=dev).index_add_(0, ids, x2)
    cp = torch.bincount(ids, minlength=p * kc).float()
    absum = torch.zeros((p * kc, d), device=dev).index_add_(0, ids,
                                                            x2.abs())
    err_t = (s.reshape(p * kc, d) - sp).abs()
    bound = torch.maximum(1e-5 * absum, stats_bound(x2, ids, p * kc, cp))
    ok = bool((err_t <= bound).all()) and torch.equal(cnt.reshape(-1), cp)
    errs["sort_inverse_update"] = float(err_t.max())
    out["sort_inverse_update"] = {
        "max_abs_err": float(err_t.max()),
        "max_rel_to_abs_sum": float((err_t / absum.clamp_min(1e-30)).max())}
    check(ok, f"[{tag}] sort_inverse_update at the clustered shape ({p * n} "
              f"rows, {p * kc} segments): sums within rtol 1e-5 of sum|x| "
              f"(max {out['sort_inverse_update']['max_rel_to_abs_sum']:.3g}),"
              f" counts equal {torch.equal(cnt.reshape(-1), cp)}")
    del sp, absum, err_t, bound

    a_f, s_f, cnt_f, j_f = ops.flash_lloyd_step_batched(x, c)
    ids_f = (a_f.long() + kc * torch.arange(p, device=dev).unsqueeze(1)
             ).reshape(-1)
    sp = torch.zeros((p * kc, d), device=dev).index_add_(0, ids_f, x2)
    cp = torch.bincount(ids_f, minlength=p * kc).float()
    err_t = (s_f.reshape(p * kc, d) - sp).abs()
    bound = stats_bound(x2, ids_f, p * kc, cp)
    jerr = float(((j_f - mp.sum(-1)).abs() / mp.sum(-1).abs()).max())
    same = torch.equal(a_f, a)
    ok = (same and bool((err_t <= bound).all())
          and torch.equal(cnt_f.reshape(-1), cp) and jerr <= 1e-4)
    errs["flash_lloyd"] = float(err_t.max())
    out["flash_lloyd"] = {"ids_equal_assign": same,
                          "max_abs_err": float(err_t.max()),
                          "inertia_rel_err": jerr}
    check(ok, f"[{tag}] flash_lloyd at the clustered shape: ids == "
              f"FlashAssign's bit for bit {same}, sums within 2nu*sum|x|, "
              f"counts equal, inertia rel err {jerr:.2g} <= 1e-4")
    del sp, err_t, bound

    times = {
        "flash_assign": (lambda: ops.flash_assign_batched(x, c),
                         lambda: fa.flash_assign_plain(x, c, True)),
        "sort_inverse_update": (
            lambda: ops.sort_inverse_update_batched(x, a, k=kc),
            lambda: torch.zeros((p * kc, d), device=dev).index_add_(
                0, ids, x2)),
        "flash_lloyd": (lambda: ops.flash_lloyd_step_batched(x, c),
                        lambda: fl.flash_lloyd_plain(x, c))}
    for kname, (kern, plain) in times.items():
        out[kname].update(ms=events_ms(kern), plain_ms=events_ms(plain))
        print(f"  {kname} at P {p}, N {n}, K {kc}, d {d}: "
              f"{out[kname]['ms']:.4f} ms a call (plain "
              f"{out[kname]['plain_ms']:.3f} ms)", flush=True)
    rec["step_impl"] = step
    print(f"  the planner's step at N {n}, K {kc}, d {d}: {step}", flush=True)
    return errs


def lm_phase(dev, smi, zero_counts, read_counts, details):
    """Phase 13: LM serving through the port's entry points at the full width
    of Llama-3-8B (d_model 4,096, 32 heads, 8 kv heads, head_dim 128, d_ff
    14,336, vocab 128,256 padded to 128,512, 32 layers; f32, random weights
    from the seed):

    (5) ``kmeans_routed_attention`` at B 1, S 2,048, 32 heads, hd 128:
        ``clusters=1`` equals ``dot_attention`` (rtol 1e-4, atol 1e-5);
        ``clusters=16`` routes its queries through FlashAssign;
    (2) dense at full depth, B 1: prefill 128 tokens, decode 128 more one by
        one; each step's logits equal the full forward's (rtol = atol =
        1e-3);
    (4) ``Engine(mode="clustered")`` at the config's geometry: B 4, prompt
        2,048, 32 steps, ``recent`` 16 (kc 64, cap 128, two flushes): every
        logit finite, each bucket's ``bcount`` = min(its weight, cap), the
        weights summing to 2,048 a head, two flushes; the rows dropped by
        capacity and the greedy agreement with the dense engine printed;
    (1) the kernels at the clustered cache's shape (the prefill's keys of
        those 1,024 problems, N 2,048, K 64, d 128) against their plain
        versions (``lm_kernel_checks``), and the build re-run under the
        profiler;
    (3) exactness with the depth cut to 4 layers: B 1, prompt 2,048, 16
        steps, ``recent`` 8, top = kc = 64, cap 2,176: greedy ids equal the
        dense engine's, the first decode's logits within 1e-3 of the dense
        step's, two flushes;
    (6) ``launch/serve.py --arch llama3-8b --mode clustered --batch 4
        --prompt-len 2048 --gen 32 --recent 16`` prints its tok/s.

    Returns the main path's counted runs' launch counts ((2), (4) and
    (6): the serving path at the config's own geometry), the named check
    runs' ``(name, counts)`` ((1), the cut config of (3), and (5)'s routed
    calls, a branch the model's forward does not take), and ``{kernel:
    max abs err}``."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.models import model as M
    from repro_torch.models.common import Ctx
    from repro_torch.models.layers import attention as attn
    from repro_torch.models.transformer import tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = details.setdefault("lm", {})
    rec["card"] = smi
    runs, checks = [], []
    cfg = get_config(LM_ARCH)
    ctx = Ctx(compute_dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    print(f"\n[lm] {cfg.name} at full width: d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"(padded {cfg.vocab_padded()}), {cfg.num_layers} layers; f32, "
          f"TF32 {torch.backends.cuda.matmul.allow_tf32}; {smi}; "
          f"{base / 2**30:.2f} GiB allocated before", flush=True)
    check(base < 2 ** 30, f"[lm] phase 13 starts with the earlier phases' "
                          f"tensors freed ({base / 2**30:.3f} GiB allocated, "
                          f"< 1 GiB)")

    # ---- (5) routed attention (before the weights: its scores are large)
    b, s, h, hd = LM_ROUTED
    q, k, v = (torch.randn((b, s, h, hd), device=dev, generator=gen)
               for _ in range(3))
    zero_counts()
    out1 = kma.kmeans_routed_attention(q, k, v, clusters=1)
    checks.append(("lm/(5) routed attention, clusters=1", read_counts()))
    full = attn.dot_attention(q, k, v, causal=True)
    exc = _allclose_excess(out1, full, 1e-4, 1e-5)
    check(exc <= 0, f"[lm] (5) kmeans_routed_attention clusters=1 at B {b}, "
                    f"S {s}, H {h}, hd {hd} == dot_attention (rtol 1e-4, "
                    f"atol 1e-5; max abs diff "
                    f"{float((out1 - full).abs().max()):.3g})")
    del out1, full
    torch.cuda.empty_cache()
    zero_counts()
    (out16, t_r) = wall_s(lambda: kma.kmeans_routed_attention(
        q, k, v, clusters=LM_ROUTED_CLUSTERS))
    counts = read_counts()
    checks.append((f"lm/(5) routed attention, clusters="
                   f"{LM_ROUTED_CLUSTERS}", counts))
    check(bool(torch.isfinite(out16).all()) and counts["flash_assign"] > 0,
          f"[lm] (5) kmeans_routed_attention clusters={LM_ROUTED_CLUSTERS}: "
          f"finite, {counts['flash_assign']} FlashAssign launches (the "
          f"queries' assignment among them), {t_r * 1e3:.1f} ms")
    rec["routed"] = {"clusters16_ms": t_r * 1e3, "launches": counts}
    del q, k, v, out16
    torch.cuda.empty_cache()

    # ---- the weights ------------------------------------------------------
    params, t = wall_s(lambda: M.init_model(cfg, seed=SEED, device=dev))
    n_el = M.n_elements(params)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    check(n_el == cfg.n_params() + norms,
          f"[lm] init_model {t:.2f} s: {n_el} parameters "
          f"({n_el * 4 / 2**30:.2f} GiB f32) == ArchConfig.n_params() "
          f"{cfg.n_params()} + the norms' {norms}")
    rec.update(n_params=n_el, arch_n_params=cfg.n_params(), init_s=t)

    # ---- (2) dense at full depth: prefill + decode == the full forward ---
    p_len, steps = LM_DENSE
    toks = torch.randint(0, cfg.vocab_size, (1, p_len + steps),
                         generator=gen, device=dev)
    full, t_full = wall_s(lambda: M.forward(params, toks, ctx, cfg))
    zero_counts()
    lp, caches, _ = M.prefill(params, toks[:, :p_len], ctx, cfg,
                              max_seq=p_len + steps + 8)
    first = _allclose_excess(lp[:, -1], full[:, p_len - 1], 1e-3, 1e-3)
    worst, ms, caches = decode_against(params, cfg, ctx, toks, caches, full,
                                       p_len, 1e-3)
    runs.append(read_counts())
    worst = max(worst, first)
    check(worst <= 0, f"[lm] (2) dense, {cfg.num_layers} layers, B 1: prefill "
                      f"{p_len} + {steps} decode steps, every step's logits "
                      f"== the full forward's (rtol = atol = 1e-3; worst "
                      f"excess {worst:.3g}); decode "
                      f"{statistics.median(ms):.3f} ms a token (median), "
                      f"the forward of {p_len + steps} tokens {t_full:.2f} s")
    # where a step's time goes: one more step under the profiler (its slot
    # is free), beside its CUDA-event time
    nxt = toks[:, -1:]
    one = lambda: M.decode_step(params, nxt, caches, ctx, cfg)
    ev_ms = events_ms(one, reps=3)
    rows = device_rows(one, 3)
    busy, calls = sum(r["ms"] for r in rows), sum(r["calls"] for r in rows)
    print(f"  a dense B 1 step: {ev_ms:.3f} ms (CUDA events, back to back); "
          f"device busy {busy:.3f} ms in {calls:g} launches; largest: "
          + "; ".join(f"{r['name'][:60]} {r['ms']:.3f} ms x{r['calls']:g}"
                      for r in rows[:5]), flush=True)
    rec["dense_b1"] = {"decode_ms": ms, "forward_s": t_full,
                       "profiled_step": {"ms": ev_ms, "busy_ms": busy,
                                         "launches": calls,
                                         "rows": rows[:12]}}
    del full, caches, lp
    torch.cuda.empty_cache()

    # ---- (4) clustered at the config's geometry, full depth -------------
    g = LM_GEOM
    kc, cap = M.clustered_geometry(cfg, g["prompt"])
    kc = min(kc, max(4, g["prompt"] // 8))
    toks4 = torch.randint(0, cfg.vocab_size, (g["batch"], g["prompt"]),
                          generator=gen, device=dev)
    res = engine_runs(cfg, params, toks4, g["steps"], g["recent"], None,
                      read_counts, zero_counts, keep=True)
    for m in res:
        runs.append(res[m]["counts"])
        res[m]["tok_s"] = g["batch"] * g["steps"] / res[m]["wall_s"]
    pc = res["clustered"]["probe"]
    bucket_bytes = pc.built["0_block"][3]
    inv, dropped = bucket_invariants(pc, g["prompt"], kc, cap)
    agree = float((res["clustered"]["ids"] == res["dense"]["ids"]
                   ).float().mean())
    check(bool(pc.finite) and inv and res["clustered"]["count"] == 2,
          f"[lm] (4) clustered, {cfg.num_layers} layers, B {g['batch']}, "
          f"prompt {g['prompt']}, {g['steps']} steps, recent {g['recent']}: "
          f"kc {kc}, cap {cap}; every logit finite {bool(pc.finite)}; bcount "
          f"== min(weight, cap) in every bucket, the weights summing to "
          f"{g['prompt']} a head, (kc, cap) buckets {inv}; "
          f"{res['clustered']['count']} flushes (2)")
    pre = {m: res[m]["probe"].ms("prefill")[0] for m in res}
    dec = {m: statistics.median(res[m]["probe"].ms("decode")) for m in res}
    build_ms = pc.ms("build")[0]
    flush_ms = pc.ms("flush")
    print(f"  rows dropped by capacity {dropped:.4f}; greedy agreement with "
          f"the dense engine {agree:.4f}; buckets "
          f"{bucket_bytes / 2**30:.2f} GiB; prefill "
          f"{pre['clustered']:.1f} ms (dense engine's {pre['dense']:.1f} ms);"
          f" a decoded token {dec['clustered']:.3f} ms clustered, "
          f"{dec['dense']:.3f} ms dense (median of the steps); the cluster "
          f"build {build_ms:.1f} ms ({pc.build_counts}); a flush "
          f"{', '.join(f'{v:.2f}' for v in flush_ms)} ms; "
          f"{res['clustered']['tok_s']:.1f} tok/s clustered, "
          f"{res['dense']['tok_s']:.1f} tok/s dense (wall, prefill "
          f"included)", flush=True)
    rec["geometry"] = {
        "kc": kc, "cap": cap, "dropped_share": dropped, "agreement": agree,
        "bucket_bytes": bucket_bytes, "prefill_ms": pre, "decode_ms": dec,
        "build_ms": build_ms, "build_launches": pc.build_counts,
        "flush_ms": flush_ms, "wall_s": {m: res[m]["wall_s"] for m in res},
        "tok_s": {m: res[m]["tok_s"] for m in res},
        "launches": {m: res[m]["counts"] for m in res}}
    kv = pc.kv["0_block"]
    del res, pc
    torch.cuda.empty_cache()

    # ---- (1) the kernels at the clustered cache's shape ----------------
    kk, vv = kv
    x = kk.movedim(-2, -3).reshape(-1, g["prompt"], cfg.resolved_head_dim)
    x = x.contiguous()
    zero_counts()
    errs = lm_kernel_checks(dev, x, kc, 4, rec)
    from repro_torch.core import kmeans as km
    from repro_torch.core.kmeans import KMeansConfig
    st = km._lloyd_loop(x, kma.initial_centroids(x, kc),
                        KMeansConfig(k=kc, max_iters=4, init="random"))
    iters = int(st.iteration.max())
    del st, x
    build = lambda: kma.build_clustered_cache(kk, vv, kc=kc, capacity=cap,
                                              iters=4)
    build()
    b_ms = events_ms(build, reps=2)
    rows = device_rows(build, 1)
    dev_ms, calls = sum(r["ms"] for r in rows), sum(r["calls"] for r in rows)
    checks.append(("lm/kernel checks at the clustered shape", read_counts()))
    print(f"  the cluster build re-run: {iters} Lloyd iterations, "
          f"{b_ms:.2f} ms (CUDA events), device {dev_ms:.2f} ms in "
          f"{calls:g} launches (all kernels, the bucket scatter included); "
          f"largest: " + "; ".join(f"{r['name'][:60]} {r['ms']:.3f} ms "
                                   f"x{r['calls']:g}" for r in rows[:5]),
          flush=True)
    rec["build"] = {"iterations": iters, "ms": b_ms, "device_ms": dev_ms,
                    "device_launches": calls, "rows": rows[:12]}
    del kk, vv, kv
    torch.cuda.empty_cache()

    # ---- (3) exactness, depth cut to 4 layers -----------------------------
    e = LM_EXACT
    cfg4 = dataclasses.replace(cfg, num_layers=e["layers"],
                               kv_cluster_capacity_factor=e[
                                   "capacity_factor"])
    kc4, cap4 = M.clustered_geometry(cfg4, e["prompt"])
    kc4 = min(kc4, max(4, e["prompt"] // 8))
    cfg4 = dataclasses.replace(cfg4, kv_cluster_top=kc4)
    p4 = dict(params, stack={"groups": tree_map(
        lambda t_: t_[:e["layers"]], params["stack"]["groups"])})
    toks3 = torch.randint(0, cfg.vocab_size, (e["batch"], e["prompt"]),
                          generator=gen, device=dev)
    res = engine_runs(cfg4, p4, toks3, e["steps"], e["recent"], None,
                      read_counts, zero_counts)
    for m in res:
        checks.append((f"lm/(3) exactness, {e['layers']} layers, {m} "
                       f"engine", res[m]["counts"]))
    same = torch.equal(res["dense"]["ids"], res["clustered"]["ids"])
    exc = _allclose_excess(res["clustered"]["probe"].first,
                           res["dense"]["probe"].first, 1e-3, 1e-3)
    margin = res["dense"]["probe"].min_margin()
    check(same and exc <= 0 and res["clustered"]["count"] == 2
          and cap4 >= e["prompt"] + e["steps"],
          f"[lm] (3) {e['layers']} layers, B {e['batch']}, prompt "
          f"{e['prompt']}, {e['steps']} steps, recent {e['recent']}, top = kc "
          f"= {kc4}, cap {cap4}: greedy ids == the dense engine's {same} (its "
          f"smallest top-two margin {margin:.3g}); the first decode's logits "
          f"within 1e-3 of the dense step's (excess {exc:.3g}); "
          f"{res['clustered']['count']} flushes (2)")
    rec["exact"] = {"kc": kc4, "cap": cap4, "ids_equal": same,
                    "first_logits_excess": exc, "dense_margin": margin}
    del res, p4, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (6) the launcher ---------------------------------------------------
    argv = ["--arch", LM_ARCH, "--mode", "clustered", "--batch", "4",
            "--prompt-len", "2048", "--gen", "32", "--recent", "16"]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    zero_counts()
    out = serve.main(argv)
    counts = read_counts()
    runs.append(counts)
    check(out["tok_s"] > 0 and tuple(out["ids"].shape) == (4, 32)
          and out["recluster_count"] == 2,
          f"[lm] (6) the launcher served {out['tok_s']:.1f} tok/s "
          f"({out['recluster_count']} flushes)")
    rec["launcher"] = {"tok_s": out["tok_s"], "wall_s": out["wall_s"],
                       "launches": counts}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t_phase
    rec["main_launches"] = {kn: sum(r[kn] for r in runs) for kn in runs[0]}
    rec["check_launches"] = dict(checks)
    rec["max_abs_err"] = errs
    print(f"  peak memory {rec['peak_bytes'] / 2**30:.2f} GiB; phase "
          f"{rec['seconds']:.1f} s; the main path's runs launched "
          f"{ {kn: v for kn, v in rec['main_launches'].items() if v} }",
          flush=True)
    return runs, checks, errs


# ---- phase 14: the rest of the LM zoo (MoE, MLA, Mamba2, xLSTM, encoder) ---
# (a) zamba2-7b at full width and depth (configs/zamba2_7b.py: 54 Mamba2
# layers and 27 applications of one shared attention block, 32 heads of
# 112), f32 as the reference's Engine computes, random weights from SEED
ZOO_ARCH = "zamba2-7b"
ZOO_DENSE = (128, 128)   # (1): prompt, steps (B 1); 256 tokens, one chunk
ZOO_GEOM = {"batch": 4, "prompt": 2048, "steps": 32, "recent": 16}   # (2)
# (4): depth cut to 2 groups (6 layers); top = kc and a capacity over every
# row (cap 2,176 >= 2,048 + 16), so the shared block reads every key
ZOO_EXACT = {"groups": 2, "batch": 1, "prompt": 2048, "steps": 16,
             "recent": 8, "capacity_factor": 66.0}
# (b) every other family at full width: (arch, layers kept or None = all);
# dbrx-132b's 40 layers take 488 GiB in f32, 2 of them 26.6 GiB
ZOO_FAMILIES = (("granite-moe-1b-a400m", None), ("minicpm3-4b", None),
                ("xlstm-1.3b", None), ("phi-3-vision-4.2b", None),
                ("whisper-base", None), ("dbrx-132b", 2))
ZOO_B = {"prompt": 128, "steps": 16, "recent": 8}
ZOO_TOL = 1e-3
# xLSTM's chunk scan takes bfloat16 operands, its one-step recurrence is all
# f32: the reference's own tolerance between them is one block's rtol = atol
# = 2e-2, set at head_dim 16 (tests/models/test_layers.py:89-105)
ZOO_TOL_BF16 = 2e-2
# one mLSTM block at full width (head_dim 1,024): the JAX package's own
# least rtol = atol over 42 draws is 0.0070-0.0258, past 2e-2 in 2 of them
# (tools/xlstm_reference_gap.py); the port's 42 blocks are other draws, so
# twice the reference's largest
ZOO_XL_BLOCK_TAU = 0.05
# xLSTM's decode against its forward with the depth cut to one group (7
# mLSTM and 1 sLSTM block) at full width: the JAX package's own least
# rtol = atol there is 0.24-0.34 over 4 seeds, and from zero caches (a
# state not carried) 3.5-4.0 (tools/xlstm_reference_gap.py); the port's
# weights are other draws, so twice the reference's largest
ZOO_XL_TAU = 0.7
# the model's decode step at full depth against its blocks' steps composed
# by hand: the same operations in the same order
ZOO_XL_STACK_TOL = 1e-4


def zoo_phase(dev, smi, zero_counts, read_counts, details):
    """Phase 14: the rest of the LM zoo through the port's entry points.

    (a) zamba2-7b at full width and depth (d_model 3,584, 54 Mamba2 layers
        of d_inner 7,168 and state 64, one shared attention block of 32
        heads of 112 applied 27 times, d_ff 14,336; f32, random weights):
        (1) dense, B 1: prefill 128 tokens, decode 128 more one by one,
            each step's logits equal to the full forward's over 256 tokens
            (rtol = atol = 1e-3);
        (2) ``Engine(mode="clustered")`` at B 4, prompt 2,048, 32 steps,
            ``recent`` 16 (the shared block's 27 caches: 3,456 problems of
            N 2,048, K 64, d 112; two flushes) beside the dense engine:
            every logit finite, the buckets' invariants, the greedy
            agreement printed;
        (3) kernels 1-3 at that shape against their plain versions
            (``lm_kernel_checks``), the build re-run under the profiler;
        (4) the depth cut to 2 groups (6 layers), B 1, prompt 2,048, 16
            steps, top = kc, every row within the capacity: greedy ids
            equal to the dense engine's;
        (5) ``launch/serve.py --arch zamba2-7b --mode clustered``.
    (b) every other family at full width (dbrx-132b cut to 2 layers), B 1,
        prompt 128, 16 steps: prefill's logits equal to the forward's and
        the decode steps equal to it where the reference's semantics make
        them equal (MoE: ``moe_decode_check``; xLSTM: its decode against
        its blocks composed by hand at full depth, ``xlstm_stack_check``,
        block by block, ``xlstm_block_checks``, and against the forward
        with the depth cut to one group, ``xlstm_cut_check``), then
        ``Engine`` in both modes (``recent`` 8): ms a token, prefill ms,
        the build's and flushes' ms, peak memory and each kernel's
        launches; and kernels 1-3 on the keys of every clustered build
        (d 64, 96, 128) against their plain versions (``lm_kernel_checks``).

    Returns the main path's counted runs' launch counts ((a)(1), (2), (5)
    and (b)'s full-depth engines), the named check runs' ``(name,
    counts)`` ((3), (4), the cut dbrx engines, (b)'s kernel checks), and
    ``{kernel: max abs err}``."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.common import Ctx
    from repro_torch.models.transformer import tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = details.setdefault("zoo", {})
    rec["card"] = smi
    runs, checks = [], []
    ctx = Ctx(compute_dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    cfg = get_config(ZOO_ARCH)
    print(f"\n[zoo] {cfg.name} at full width and depth: d_model "
          f"{cfg.d_model}, {cfg.num_layers} layers ({cfg.num_layers // 3 * 2}"
          f" Mamba2, d_inner {cfg.ssm_expand * cfg.d_model}, state "
          f"{cfg.ssm_state}; {cfg.num_layers // 3} applications of one shared"
          f" block of {cfg.num_heads} heads of {cfg.resolved_head_dim}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; f32; {smi}; "
          f"{base / 2**30:.2f} GiB allocated before", flush=True)
    check(base < 2 ** 30, f"[zoo] phase 14 starts with the earlier phases' "
                          f"tensors freed ({base / 2**30:.3f} GiB allocated, "
                          f"< 1 GiB)")
    params, t = wall_s(lambda: M.init_model(cfg, seed=SEED, device=dev))
    n_el = M.n_elements(params)
    rec["zamba2"] = z = {"n_params": n_el, "init_s": t, "peak_gib": {}}

    def peak_of(step):
        """The peak since the last step's, in GiB, and a fresh count."""
        z["peak_gib"][step] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
    print(f"  init_model {t:.2f} s: {n_el} parameters ({n_el * 4 / 2**30:.2f}"
          f" GiB f32)", flush=True)

    # ---- (a)(1) dense at full depth: prefill + decode == the forward -----
    p_len, steps = ZOO_DENSE
    toks = torch.randint(0, cfg.vocab_size, (1, p_len + steps),
                         generator=gen, device=dev)
    full, t_full = wall_s(lambda: M.forward(params, toks, ctx, cfg))
    zero_counts()
    (lp, caches, _), t_pre = wall_s(lambda: M.prefill(
        params, toks[:, :p_len], ctx, cfg, max_seq=p_len + steps + 8))
    first = _allclose_excess(lp[:, -1], full[:, p_len - 1], ZOO_TOL, ZOO_TOL)
    worst, ms, caches = decode_against(params, cfg, ctx, toks, caches, full,
                                       p_len, ZOO_TOL)
    runs.append(read_counts())
    worst = max(worst, first)
    check(worst <= 0, f"[zoo] (a)(1) dense, {cfg.num_layers} layers, B 1: "
                      f"prefill {p_len} + {steps} decode steps, every step's "
                      f"logits == the full forward's over {p_len + steps} "
                      f"(rtol = atol = {ZOO_TOL}; worst excess {worst:.3g}); "
                      f"decode {statistics.median(ms):.3f} ms a token "
                      f"(median), prefill {t_pre * 1e3:.1f} ms, the forward "
                      f"{t_full:.2f} s")
    nxt = toks[:, -1:]
    one = lambda: M.decode_step(params, nxt, caches, ctx, cfg)  # noqa: E731
    ev_ms = events_ms(one, reps=3)
    rows = device_rows(one, 3)
    busy, calls = sum(r["ms"] for r in rows), sum(r["calls"] for r in rows)
    print(f"  a dense B 1 step: {ev_ms:.3f} ms (CUDA events, back to back); "
          f"device busy {busy:.3f} ms in {calls:g} launches; largest: "
          + "; ".join(f"{r['name'][:50]} {r['ms']:.3f} ms x{r['calls']:g}"
                      for r in rows[:4]), flush=True)
    z["dense_b1"] = {"decode_ms": ms, "prefill_s": t_pre, "forward_s": t_full,
                     "profiled_step": {"ms": ev_ms, "busy_ms": busy,
                                       "launches": calls, "rows": rows[:12]}}
    del full, caches, lp
    torch.cuda.empty_cache()
    peak_of("(1) dense")

    # ---- (a)(2) the clustered engine at the config's geometry ------------
    g = ZOO_GEOM
    kc, cap = M.clustered_geometry(cfg, g["prompt"])
    kc = min(kc, max(4, g["prompt"] // 8))
    toks4 = torch.randint(0, cfg.vocab_size, (g["batch"], g["prompt"]),
                          generator=gen, device=dev)
    res = engine_runs(cfg, params, toks4, g["steps"], g["recent"], None,
                      read_counts, zero_counts, keep=True)
    for m in res:
        runs.append(res[m]["counts"])
    pc = res["clustered"]["probe"]
    inv, dropped = bucket_invariants(pc, g["prompt"], kc, cap)
    agree = float((res["clustered"]["ids"] == res["dense"]["ids"]
                   ).float().mean())
    n_prob = sum(c[0].numel() // kc for c in pc.built.values())
    check(bool(pc.finite) and inv and res["clustered"]["count"] == 2,
          f"[zoo] (a)(2) clustered, B {g['batch']}, prompt {g['prompt']}, "
          f"{g['steps']} steps, recent {g['recent']}: {n_prob} problems (kc "
          f"{kc}, cap {cap}, d {cfg.resolved_head_dim}); every logit finite "
          f"{bool(pc.finite)}; bucket invariants {inv}; "
          f"{res['clustered']['count']} flushes (2)")
    cc, built = res["clustered"]["counts"], nonzero(pc.build_counts)
    check(cc["flash_assign"] > 0 and cc["sort_inverse_update"] > 0
          and sum(built.values()) > 0,
          f"[zoo] (a)(2) the clustered engine ran the kernels: the build "
          f"{built}, the whole run {nonzero(cc)} (FlashAssign and the "
          f"update at each flush)")
    pre = {m: res[m]["probe"].ms("prefill")[0] for m in res}
    dec = {m: statistics.median(res[m]["probe"].ms("decode")) for m in res}
    build_ms, flush_ms = pc.ms("build")[0], pc.ms("flush")
    print(f"  rows dropped by capacity {dropped:.4f}; greedy agreement with "
          f"the dense engine {agree:.4f}; prefill {pre['clustered']:.1f} ms "
          f"(dense engine's {pre['dense']:.1f} ms); a decoded token "
          f"{dec['clustered']:.3f} ms clustered, {dec['dense']:.3f} ms dense "
          f"(median); the cluster build {build_ms:.1f} ms; a flush "
          f"{', '.join(f'{v:.2f}' for v in flush_ms)} ms; tok/s (wall) "
          + ", ".join(f"{m} {g['batch'] * g['steps'] / res[m]['wall_s']:.1f}"
                      for m in res), flush=True)
    z["geometry"] = {
        "kc": kc, "cap": cap, "problems": n_prob, "dropped_share": dropped,
        "agreement": agree, "prefill_ms": pre, "decode_ms": dec,
        "build_ms": build_ms, "build_launches": pc.build_counts,
        "flush_ms": flush_ms, "wall_s": {m: res[m]["wall_s"] for m in res},
        "launches": {m: res[m]["counts"] for m in res}}
    kk, vv = pc.kv["2_shared_attn"]
    del res, pc
    torch.cuda.empty_cache()
    peak_of("(2) engines")

    # ---- (a)(3) kernels 1-3 at the shared block's clustered shape --------
    x = kk.movedim(-2, -3).reshape(-1, g["prompt"], cfg.resolved_head_dim)
    x = x.contiguous()
    zero_counts()
    zrec = z.setdefault("kernel_checks", {})
    errs = lm_kernel_checks(dev, x, kc, 4, zrec, tag="zoo")
    del x
    build = lambda: kma_build(kk, vv, kc, cap)   # noqa: E731
    build()
    b_ms = events_ms(build, reps=2)
    rows = device_rows(build, 1)
    dev_ms, calls = sum(r["ms"] for r in rows), sum(r["calls"] for r in rows)
    checks.append(("zoo/(a)(3) kernel checks at the shared block's shape",
                   read_counts()))
    print(f"  the cluster build re-run: {b_ms:.2f} ms (CUDA events), device "
          f"{dev_ms:.2f} ms in {calls:g} launches; largest: "
          + "; ".join(f"{r['name'][:50]} {r['ms']:.3f} ms x{r['calls']:g}"
                      for r in rows[:4]), flush=True)
    z["build"] = {"ms": b_ms, "device_ms": dev_ms, "device_launches": calls,
                  "rows": rows[:12]}
    del kk, vv
    torch.cuda.empty_cache()
    peak_of("(3) kernels")

    # ---- (a)(4) exactness, depth cut to 2 groups ---------------------------
    e = ZOO_EXACT
    cfg2 = dataclasses.replace(cfg, num_layers=3 * e["groups"],
                               kv_cluster_capacity_factor=e[
                                   "capacity_factor"])
    kc2, cap2 = M.clustered_geometry(cfg2, e["prompt"])
    kc2 = min(kc2, max(4, e["prompt"] // 8))
    cfg2 = dataclasses.replace(cfg2, kv_cluster_top=kc2)
    p2 = dict(params, stack={"groups": tree_map(
        lambda t_: t_[:e["groups"]], params["stack"]["groups"]),
        "shared": params["stack"]["shared"]})
    toks2 = torch.randint(0, cfg.vocab_size, (e["batch"], e["prompt"]),
                          generator=gen, device=dev)
    res = engine_runs(cfg2, p2, toks2, e["steps"], e["recent"], None,
                      read_counts, zero_counts)
    for m in res:
        checks.append((f"zoo/(a)(4) exactness, {3 * e['groups']} layers, {m} "
                       f"engine", res[m]["counts"]))
    same = torch.equal(res["dense"]["ids"], res["clustered"]["ids"])
    margin = res["dense"]["probe"].min_margin()
    check(same and res["clustered"]["count"] == 2
          and cap2 >= e["prompt"] + e["steps"],
          f"[zoo] (a)(4) {3 * e['groups']} layers, B {e['batch']}, prompt "
          f"{e['prompt']}, {e['steps']} steps, recent {e['recent']}, top = kc "
          f"= {kc2}, cap {cap2}: greedy ids == the dense engine's {same} (its "
          f"smallest top-two margin {margin:.3g}); "
          f"{res['clustered']['count']} flushes (2)")
    z["exact"] = {"kc": kc2, "cap": cap2, "ids_equal": same,
                  "dense_margin": margin}
    del res, p2, params
    gc.collect()
    torch.cuda.empty_cache()
    peak_of("(4) exactness")

    # ---- (a)(5) the launcher ------------------------------------------------
    argv = ["--arch", ZOO_ARCH, "--mode", "clustered", "--batch",
            str(g["batch"]), "--prompt-len", str(g["prompt"]), "--gen",
            str(g["steps"]), "--recent", str(g["recent"])]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    zero_counts()
    out = serve.main(argv)
    runs.append(read_counts())
    check(out["tok_s"] > 0
          and tuple(out["ids"].shape) == (g["batch"], g["steps"])
          and out["recluster_count"] == 2,
          f"[zoo] (a)(5) the launcher served {out['tok_s']:.1f} tok/s "
          f"({out['recluster_count']} flushes)")
    z["launcher"] = {"tok_s": out["tok_s"], "wall_s": out["wall_s"]}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    peak_of("(5) launcher")
    z["peak_bytes"] = max(z["peak_gib"].values()) * 2 ** 30
    z["seconds"] = time.perf_counter() - t_phase
    print(f"  zamba2-7b's peaks (GiB): "
          + ", ".join(f"{k} {v:.2f}" for k, v in z["peak_gib"].items())
          + f"; (a) {z['seconds']:.1f} s", flush=True)

    # ---- (b) every other family at full width -----------------------------
    fam = rec.setdefault("families", {})
    for arch, layers in ZOO_FAMILIES:
        for kn, v in zoo_family(dev, arch, layers, ctx, gen, fam, runs,
                                checks, zero_counts, read_counts).items():
            errs[kn] = max(errs[kn], v)
        gc.collect()
        torch.cuda.empty_cache()

    rec["peak_bytes"] = max([z["peak_bytes"]] + [f["peak_bytes"]
                                                for f in fam.values()])
    rec["seconds"] = time.perf_counter() - t_phase
    rec["main_launches"] = {kn: sum(r[kn] for r in runs) for kn in runs[0]}
    rec["check_launches"] = dict(checks)
    rec["max_abs_err"] = errs
    print(f"  peak memory {rec['peak_bytes'] / 2**30:.2f} GiB; phase "
          f"{rec['seconds']:.1f} s; the main path's runs launched "
          f"{ {kn: v for kn, v in rec['main_launches'].items() if v} }",
          flush=True)
    return runs, checks, errs


def nonzero(counts):
    return {kn: v for kn, v in counts.items() if v}


def kma_build(kk, vv, kc, cap):
    from repro_torch.models import kmeans_attention as kma
    return kma.build_clustered_cache(kk, vv, kc=kc, capacity=cap, iters=4)


def moe_decode_check(params, cfg, ctx, toks, p_len):
    """MoE: decode against the forward where the reference's semantics make
    them equal. A (token, slot) pair's place in its expert is a cumsum over
    its group's tokens slot by slot (``moe.py:61-67``): pairs past the
    capacity ``int(gs * 1.25 * k / e) + 1`` drop, and pairs of two tokens
    in different slots can share a place, where the dispatch sums them. A
    decode step is a group of one token, which never drops and never
    shares; the forward's group of 144 tokens does both, and a shared
    place mixes a later token into an earlier one's output, so no position
    of it equals a decode (the reference's own decode differs from its
    forward by more than 0.1 in the logits: ``tests/test_torch_zoo_models.py
    ::test_reference_moe_decode_equals_its_forward_only_per_token``). So:
    prefill (the config's group) equals the forward over the
    prompt, one group either way; and the decode steps are compared at
    every position with the group size set to 1 (one token a group, as a
    decode step is), where prefill + decode equal the forward. Returns
    (the worst excess of the prompt check, of the group-1 decode, the ms
    of those steps, (pairs dropped, pairs sharing a place) in layer 0 at
    the config's group over the prompt)."""
    import dataclasses

    from repro_torch.models import common
    from repro_torch.models import model as M
    full_p = M.forward(params, toks[:, :p_len], ctx, cfg)
    lp, _, _ = M.prefill(params, toks[:, :p_len], ctx, cfg,
                         max_seq=toks.shape[1] + 8)
    prompt_ex = _allclose_excess(lp[:, -1], full_p[:, -1], ZOO_TOL, ZOO_TOL)
    cfg1 = dataclasses.replace(cfg, moe_group_size=1)
    full1 = M.forward(params, toks, ctx, cfg1)
    lp1, c1, _ = M.prefill(params, toks[:, :p_len], ctx, cfg1,
                           max_seq=toks.shape[1] + 8)
    ex1 = _allclose_excess(lp1[:, -1], full1[:, p_len - 1], ZOO_TOL, ZOO_TOL)
    worst, ms, _ = decode_against(params, cfg1, ctx, toks, c1, full1, p_len,
                                  ZOO_TOL)
    h = M._embed_tokens(cfg, params, toks[:, :p_len], ctx)
    blk = tree_first(params["stack"]["groups"]["0_block"])
    h = common.norm_apply(cfg.norm)(blk["norm_attn"], h, ctx)
    return prompt_ex, max(worst, ex1), ms, moe_dispatch_counts(
        blk["mlp"], h, ctx, cfg)


def moe_dispatch_counts(params, x, ctx, cfg):
    """The (token, expert) pairs that ``moe`` drops for capacity at this
    input, and the pairs that share their (expert, place) with a pair of
    another token (a token's slots pick distinct experts), in groups of
    ``cfg.moe_group_size``."""
    import torch
    from repro_torch.models.layers import moe
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    gs = min(cfg.moe_group_size, tokens.shape[0])
    xg = tokens.reshape(-1, gs, d)
    k, e = cfg.experts_per_token, cfg.num_experts
    _, _, top_i = moe.route((xg @ ctx.cast(params["router"])).float(), k)
    cap = moe.capacity(gs, k, e)
    _, pos = moe.places(top_i, e)
    slot = (top_i.long() * (cap + 1) + pos.clamp(max=cap).long()).flatten(1)
    occ = torch.zeros((xg.shape[0], e * (cap + 1)), device=x.device
                      ).scatter_add_(1, slot, torch.ones(slot.shape,
                                                         device=x.device))
    shared = (occ.gather(1, slot) > 1) & (pos < cap).flatten(1)
    return int((pos >= cap).sum()), int(shared.sum())


def xlstm_block_checks(params, cfg, ctx, toks, p_len):
    """xLSTM, block by block, as the reference's own test holds a block
    (``tests/models/test_layers.py:89-105``): for every mLSTM and sLSTM
    block at full width, on the normalized token embeddings, the prefill
    (the chunk scan over the prompt, or sLSTM's loop) and then one-token
    steps from its cache against one pass over the whole sequence. sLSTM
    (an f32 loop either way) within rtol = atol = 1e-3; mLSTM, whose chunk
    scan takes bfloat16 operands and whose step does not, within rtol =
    atol = ``ZOO_XL_BLOCK_TAU``: the reference's test sets 2e-2 at
    head_dim 16, and at full width (head_dim 1,024) the JAX package's own
    blocks pass 2e-2 in 40 of 42 draws (``tools/xlstm_reference_gap.py``).
    A control, the first block's input one f32 ulp off, shows the bfloat16
    floor. Returns
    {"mlstm_excess", "mlstm_max_abs", "slstm_excess", "control_max_abs",
    "blocks"}."""
    import torch
    from repro_torch.models import common
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import xlstm as xl

    x0 = M._embed_tokens(cfg, params, toks, ctx)
    subs, n_groups = T.group_layout(cfg)
    norm = common.norm_apply(cfg.norm)
    out = {"mlstm_excess": -1.0, "mlstm_max_abs": 0.0, "slstm_excess": -1.0,
           "control_max_abs": 0.0, "blocks": 0}
    for g in range(n_groups):
        for i, sub in enumerate(subs):
            p = T.tree_map(lambda t: t[g], params["stack"]["groups"][
                f"{i}_{sub}"])
            h = norm(p["norm"], x0, ctx)
            zero = T.subblock_cache(cfg, sub, h.shape[0], 1, ctx.compute_dtype,
                                    device=h.device)
            if sub == "mlstm":
                run = lambda x_, c_: xl.mlstm(  # noqa: E731
                    p["core"], x_, ctx, num_heads=cfg.num_heads,
                    chunk=cfg.ssm_chunk, cache=c_)
            else:
                run = lambda x_, c_: xl.slstm(  # noqa: E731
                    p["core"], x_, ctx, num_heads=cfg.num_heads, cache=c_)
            full, _ = run(h, dict(zero))
            y, c = run(h[:, :p_len], dict(zero))
            ys = [y]
            for t_ in range(p_len, h.shape[1]):
                y, c = run(h[:, t_:t_ + 1], c)
                ys.append(y)
            got = torch.cat(ys, 1)
            if sub == "mlstm":
                out["mlstm_excess"] = max(
                    out["mlstm_excess"], _allclose_excess(
                        got, full, ZOO_XL_BLOCK_TAU, ZOO_XL_BLOCK_TAU))
                out["mlstm_max_abs"] = max(out["mlstm_max_abs"], float(
                    (got - full).abs().max()))
                if out["blocks"] == 0:   # the control, on the first block
                    ctl, _ = run(h * (1 + 2.0 ** -23), dict(zero))
                    out["control_max_abs"] = float((ctl - full).abs().max())
            else:
                out["slstm_excess"] = max(out["slstm_excess"],
                                          _allclose_excess(got, full, ZOO_TOL,
                                                           ZOO_TOL))
            out["blocks"] += 1
    return out


def xlstm_cut_check(params, cfg, ctx, toks, p_len):
    """xLSTM's model path with the depth cut to one group (7 mLSTM blocks
    and 1 sLSTM) at full width: ``prefill`` over the prompt and then
    ``decode_step`` token by token against ``forward`` over the whole
    sequence, and the same steps from zero caches (a state that is not
    carried) as the control. Returns each one's least rtol = atol,
    ``max |got - want| / (1 + |want|)``: {"decode", "control"}."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg1 = dataclasses.replace(cfg, num_layers=cfg.slstm_every)
    p1 = dict(params, stack=dict(params["stack"], groups=T.tree_map(
        lambda t: t[:1], params["stack"]["groups"])))
    full = M.forward(p1, toks, ctx, cfg1)[:, p_len:]
    _, caches, _ = M.prefill(p1, toks[:, :p_len], ctx, cfg1,
                             max_seq=toks.shape[1] + 8)
    zero = M.init_decode_caches(cfg1, toks.shape[0], toks.shape[1] + 8,
                                dtype=torch.float32, device=toks.device)
    out = {}
    for name, c in (("decode", caches), ("control", zero)):
        steps = []
        for t_ in range(p_len, toks.shape[1]):
            lg, c = M.decode_step(p1, toks[:, t_:t_ + 1], c, ctx, cfg1)
            steps.append(lg[:, 0])
        d = (torch.stack(steps, 1) - full).abs() / (1 + full.abs())
        out[name] = float(d.max())
    return out


def xlstm_stack_check(params, cfg, ctx, toks, caches, p_len):
    """xLSTM's ``decode_step`` at full depth against its blocks' one-token
    steps composed by hand from the same prefill caches (group by group,
    each block ``x + block(norm(x))``, its cache a tuple carried alone):
    the model's stacking of the tuple caches over the groups is held
    exactly where the forward cannot hold it. Returns the worst excess over
    rtol = atol = ``ZOO_XL_STACK_TOL`` of the logits of every step and of
    every cache leaf after the last."""
    from repro_torch.models import common
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import xlstm as xl
    from repro_torch.utils.tree import tree_leaves
    subs, n_groups = T.group_layout(cfg)
    norm = common.norm_apply(cfg.norm)
    tol = ZOO_XL_STACK_TOL
    mc = T.tree_map(lambda t: t.clone(), caches)
    hand = [{key: T.tree_map(lambda t: t[g].clone(), c)
             for key, c in caches.items()} for g in range(n_groups)]
    worst = -1.0
    for t_ in range(p_len, toks.shape[1]):
        tok = toks[:, t_:t_ + 1]
        got, mc = M.decode_step(params, tok, mc, ctx, cfg)
        x = M._embed_tokens(cfg, params, tok, ctx)
        for g in range(n_groups):
            for i, sub in enumerate(subs):
                key = f"{i}_{sub}"
                p = T.tree_map(lambda w: w[g], params["stack"]["groups"][key])
                h = norm(p["norm"], x, ctx)
                if sub == "mlstm":
                    y, hand[g][key] = xl.mlstm(
                        p["core"], h, ctx, num_heads=cfg.num_heads,
                        chunk=cfg.ssm_chunk, cache=hand[g][key])
                else:
                    y, hand[g][key] = xl.slstm(
                        p["core"], h, ctx, num_heads=cfg.num_heads,
                        cache=hand[g][key])
                x = x + y
        want = M._logits(cfg, params, M._final_norm(cfg, params, x, ctx),
                         ctx)
        worst = max(worst, _allclose_excess(got, want, tol, tol))
    for key, c in mc.items():
        for g in range(n_groups):
            for a, b in zip(tree_leaves(T.tree_map(lambda t: t[g], c)),
                            tree_leaves(hand[g][key])):
                worst = max(worst, _allclose_excess(a, b, tol, tol))
    return worst


def tree_first(tree):
    """Group 0 of a stacked parameter tree."""
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t[0], tree)


def zoo_family(dev, arch, layers, ctx, gen, fam, runs, checks, zero_counts,
               read_counts):
    """Phase 14 (b) for one config: see ``zoo_phase``. Returns ``{kernel:
    max abs err}`` of its kernel checks ({} without a clustered cache)."""
    import dataclasses
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(arch)
    cut = layers is not None
    if cut:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params, t_init = wall_s(lambda: M.init_model(cfg, seed=SEED, device=dev))
    n_el = M.n_elements(params)
    b = ZOO_B
    p_len, steps = b["prompt"], b["steps"]
    toks = torch.randint(0, cfg.vocab_size, (1, p_len + steps),
                         generator=gen, device=dev)
    fe = (torch.randn((1, cfg.frontend_seq, cfg.d_model), generator=gen,
                      device=dev) if cfg.frontend else None)
    tol = ZOO_TOL
    r = fam[arch] = {"layers": cfg.num_layers, "cut": cut, "n_params": n_el,
                     "init_s": t_init, "tol": tol}
    desc = (f"{arch}, {cfg.num_layers} layers{' (cut)' if cut else ''}, "
            f"d_model {cfg.d_model}, {n_el * 4 / 2**30:.2f} GiB f32")
    if cfg.num_experts:
        prompt_ex, worst, ms, (drop, shared) = moe_decode_check(
            params, cfg, ctx, toks, p_len)
        check(prompt_ex <= 0 and worst <= 0,
              f"[zoo] (b) {desc}: prefill's logits == the forward's over the "
              f"prompt (one group of {p_len}; excess {prompt_ex:.3g}); with "
              f"one token a group, prefill + {steps} decode steps == the "
              f"forward at every position (rtol = atol = {tol}; worst excess "
              f"{worst:.3g}); in the prompt's group, layer 0 drops {drop} "
              f"(token, expert) pairs and {shared} share a place")
        r.update(prompt_excess=prompt_ex, decode_excess=worst,
                 layer0_dropped=drop, layer0_shared=shared)
    elif cfg.family == "ssm":
        full_p = M.forward(params, toks[:, :p_len], ctx, cfg)
        lp, caches, _ = M.prefill(params, toks[:, :p_len], ctx, cfg,
                                  max_seq=p_len + steps + 8)
        prompt_ex = _allclose_excess(lp[:, -1], full_p[:, -1], ZOO_TOL,
                                     ZOO_TOL)
        full = M.forward(params, toks, ctx, cfg)
        drift = float((full_p[:, -1] - full[:, p_len - 1]).abs().max())
        stack_ex = xlstm_stack_check(params, cfg, ctx, toks, caches, p_len)
        dec_ex, ms, _ = decode_against(params, cfg, ctx, toks, caches,
                                       full, p_len, ZOO_TOL)
        bl = xlstm_block_checks(params, cfg, ctx, toks, p_len)
        cut1 = xlstm_cut_check(params, cfg, ctx, toks, p_len)
        check(prompt_ex <= 0 and stack_ex <= 0 and bl["slstm_excess"] <= 0
              and bl["mlstm_excess"] <= 0,
              f"[zoo] (b) {desc}: prefill's logits == the forward's over the "
              f"prompt (rtol = atol = {ZOO_TOL}; excess {prompt_ex:.3g}); "
              f"{steps} decode steps == the {bl['blocks']} blocks' steps "
              f"composed by hand, logits and caches (rtol = atol = "
              f"{ZOO_XL_STACK_TOL}; excess {stack_ex:.3g}); each block's "
              f"prefill + {steps} one-token steps == its pass over the whole "
              f"sequence: sLSTM within rtol = atol = {ZOO_TOL} (excess "
              f"{bl['slstm_excess']:.3g}), mLSTM within rtol = atol = "
              f"{ZOO_XL_BLOCK_TAU} (excess {bl['mlstm_excess']:.3g}; largest "
              f"element {bl['mlstm_max_abs']:.3g}, the 1-ulp control's "
              f"{bl['control_max_abs']:.3g})")
        check(cut1["decode"] <= ZOO_XL_TAU < cut1["control"],
              f"[zoo] (b) {arch} cut to one group ({cfg.slstm_every} "
              f"layers), full width: prefill + {steps} decode_steps == the "
              f"forward within rtol = atol = {ZOO_XL_TAU} (least "
              f"{cut1['decode']:.3g}; the reference's {ZOO_TOL_BF16} cannot "
              f"hold: the JAX package's own least is 0.24-0.34 here), and "
              f"the same steps from zero caches outside it (least "
              f"{cut1['control']:.3g})")
        print(f"  {arch}, the whole model against its forward (not gated): "
              f"the forward over {p_len} and over {p_len + steps} tokens "
              f"differ by {drift:.3g} at position {p_len - 1} (the chunk's "
              f"bf16 rounding through {cfg.num_layers} layers of random "
              f"weights), the decode steps by up to {dec_ex + ZOO_TOL:.3g} "
              f"over rtol {ZOO_TOL}; logits of scale "
              f"{float(full.abs().max()):.3g}", flush=True)
        r.update(prompt_excess=prompt_ex, stack_excess=stack_ex, blocks=bl,
                 one_group=cut1, forward_drift=drift,
                 decode_excess_vs_forward=dec_ex)
        del full, full_p, lp, caches
    else:
        full = M.forward(params, toks, ctx, cfg, frontend=fe)
        lp, caches, cross = M.prefill(
            params, toks[:, :p_len], ctx, cfg, frontend=fe,
            max_seq=(fe.shape[1] if cfg.family == "vlm" else 0)
            + p_len + steps + 8)
        first = _allclose_excess(lp[:, -1], full[:, p_len - 1], ZOO_TOL,
                                 ZOO_TOL)
        worst, ms, _ = decode_against(params, cfg, ctx, toks, caches, full,
                                      p_len, tol, cross_kv=cross)
        check(first <= 0 and worst <= 0,
              f"[zoo] (b) {desc}: prefill's logits == the forward's (rtol = "
              f"atol = {ZOO_TOL}; excess {first:.3g}); {steps} decode steps "
              f"== the forward (rtol = atol = {tol}; worst excess "
              f"{worst:.3g})")
        r.update(prefill_excess=first, decode_excess=worst)
        del full, lp, caches, cross
    r["decode_ms"] = ms
    res = engine_runs(cfg, params, toks[:, :p_len], steps, b["recent"], fe,
                      read_counts, zero_counts, keep=True)
    flushes = 0 if (cfg.attention == "mla" or cfg.family == "ssm") else 2
    kc, cap = M.clustered_geometry(cfg, p_len)
    kc = min(kc, max(4, p_len // 8))
    pc = res["clustered"]["probe"]
    inv, dropped = (bucket_invariants(pc, p_len, kc, cap) if flushes
                    else (not pc.built, 0.0))
    for m in res:
        if cut:
            checks.append((f"zoo/(b) {arch} cut to {layers} layers, {m} "
                           f"engine", res[m]["counts"]))
        else:
            runs.append(res[m]["counts"])
    errs = {}
    if pc.kv:
        # kernels 1-3 on the keys the clustered build took (every layer,
        # sequence and kv head: at d 64 for granite and whisper, 96 for
        # phi-3-vision, 128 for dbrx) against their plain versions
        x = torch.cat([kk.movedim(-2, -3).reshape(-1, p_len, kk.shape[-1])
                       for kk, _ in pc.kv.values()]).contiguous()
        zero_counts()
        errs = lm_kernel_checks(dev, x, kc, 4, r, tag=f"zoo/{arch}")
        checks.append((f"zoo/(b) {arch} kernel checks at the clustered "
                       f"shape", read_counts()))
        del x
    pc.kv = None
    fin = all(bool(res[m]["probe"].finite) for m in res)
    agree = float((res["clustered"]["ids"] == res["dense"]["ids"]
                   ).float().mean())
    kern = nonzero(res["clustered"]["counts"])
    dense_kern = nonzero(res["dense"]["counts"])
    check(fin and inv and res["clustered"]["count"] == flushes
          and res["dense"]["count"] == 0 and bool(kern) == bool(flushes)
          and not dense_kern,
          f"[zoo] (b) {arch} Engine, B 1, prompt {p_len}, {steps} steps, "
          f"recent {b['recent']}: every logit finite {fin}; clustered "
          f"{res['clustered']['count']} flushes ({flushes}), launches {kern}"
          f" (none without a clustered cache); dense launches {dense_kern} "
          f"(none); bucket invariants {inv}")
    pre = {m: res[m]["probe"].ms("prefill")[0] for m in res}
    dec = {m: statistics.median(res[m]["probe"].ms("decode")) for m in res}
    build = pc.ms("build")[0]
    flush = pc.ms("flush")
    r.update(prefill_ms=pre, engine_decode_ms=dec, build_ms=build,
             build_launches=pc.build_counts, flush_ms=flush,
             dropped_share=dropped, agreement=agree,
             launches={m: res[m]["counts"] for m in res},
             peak_bytes=torch.cuda.max_memory_allocated(),
             seconds=time.perf_counter() - t0)
    print(f"  {arch}: decode {statistics.median(ms):.3f} ms a token (B 1, "
          f"median); engine prefill {pre['clustered']:.1f} / "
          f"{pre['dense']:.1f} ms, a token {dec['clustered']:.3f} / "
          f"{dec['dense']:.3f} ms (clustered / dense); build {build:.2f} ms "
          f"({nonzero(pc.build_counts)}), flushes "
          f"{', '.join(f'{v:.2f}' for v in flush) or 'none'} ms; clustered "
          f"launches {kern}; greedy agreement {agree:.3f}; peak "
          f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['seconds']:.1f} s",
          flush=True)
    return errs


# ---- phase 15: training (pipeline, AdamW, loss_fn, Trainer, launch/train) --
TRAIN_ARCH = "granite-moe-1b-a400m"
# (a) full width and depth through launch/train.py: train_4k's sequence,
# its batch of 256 cut to 2 for the smoke's time, not for memory: on one
# H100, B 4 took 2,954.8 ms a step at a peak of 33.53 GiB and 129.8 s for
# (a), B 2 1,566.4 ms, 26.94 GiB and 65.7 s
TRAIN_A = {"batch": 2, "seq": 4096, "steps": 20, "ckpt_every": 10}
# (b) the fault contract: the same config at depth 2, f32, the reference
# test's schedule (tests/distributed/test_fault_tolerance.py:22-33)
TRAIN_B = {"layers": 2, "batch": 1, "seq": 4096, "steps": 12,
           "ckpt_every": 4, "fault": 9, "sigterm": 6}
# (c) the routed train-time workload: llama3-8b with kmeans_attn, depth 2
TRAIN_C = {"arch": "llama3-8b", "layers": 2, "batch": 1, "seq": 4096,
           "steps": 4}
# flash against ref where some ids differ: loss and |g_flash - g_ref| /
# |g_ref|. Not set from a reading: no run on the card has had an id differ
TRAIN_C_LOSS_RTOL = 1e-3
TRAIN_C_GRAD_RTOL = 0.05
# (d) one step of each other family at full width, B 1, bf16 with remat:
# {arch: (config cuts, S)}. Depth cut so the f32 params, grads and moments
# fit about 60 GiB (about 20 bytes a parameter with the bf16 copy and the
# update's temporaries); dbrx's one layer of 16 experts alone is 3.26 G
# parameters, so its experts are cut to 8 (top-4 kept). S 1,024 (576 of
# phi-3-vision's are its patches), xLSTM's 256: its sLSTM loops over time
# steps on the host (1,024 took 17.9 s, measured on one H100)
TRAIN_D = {"dbrx-132b": ({"num_layers": 1, "num_experts": 8}, 1024),
           "gemma2-27b": ({"num_layers": 2}, 1024),
           "minicpm3-4b": ({"num_layers": 32}, 1024),
           "phi-3-vision-4.2b": ({"num_layers": 20}, 1024),
           "starcoder2-3b": ({"num_layers": 24}, 1024),
           "whisper-base": ({}, 1024),
           "xlstm-1.3b": ({"num_layers": 32}, 256),
           "zamba2-7b": ({"num_layers": 39}, 1024)}


def same_tree(a, b) -> bool:
    """Every leaf of two trees equal bit for bit."""
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and same_bits(x, y)
        for x, y in zip(la, lb))


def tree_rel_diff(a, b) -> float:
    """|a - b| / |b| over two lists of tensors (global norms)."""
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


class _Capture:
    """Records the routed attention's inputs and its clustering's outputs
    while a forward runs (``kmeans_routed_attention``, ``cluster_keys``);
    ``impl`` ("flash" or "ref") replaces the one each call was given."""

    def __init__(self, kma, impl=None):
        self.kma, self.impl, self.calls, self.fits = kma, impl, [], []

    def __enter__(self):
        kma = self.kma
        self._routed, self._fit = kma.kmeans_routed_attention, kma.cluster_keys

        def routed(q, k, v, **kw):
            self.calls.append((q.detach(), k.detach(), v.detach(), kw))
            if self.impl is not None:
                kw = dict(kw, impl=self.impl)
            return self._routed(q, k, v, **kw)

        def fit(*a, **kw):
            out = self._fit(*a, **kw)
            self.fits.append(tuple(t.detach() for t in out))
            return out
        kma.kmeans_routed_attention, kma.cluster_keys = routed, fit
        return self

    def __exit__(self, *exc):
        self.kma.kmeans_routed_attention = self._routed
        self.kma.cluster_keys = self._fit


def train_phase(dev, smi, zero_counts, read_counts, details):
    """Phase 15: training through the port's entry points (f32 masters,
    random weights from the seed):

    (a) granite-moe-1b-a400m at full width and depth (24 layers, d_model
        1,024, 32 experts top-8) through ``launch/train.py``'s ``main``: B
        2, S 4,096, bf16 mixed precision with remat, 20 steps, a checkpoint
        every 10; every loss finite and the mean of the last 3 below the
        first 3; ms a step (CUDA events, median), tokens/s, the peak memory
        and 6 N_active tokens / step time against the bf16 dense peak;
    (b) the fault contract at depth 2, f32, B 1, S 4,096: 12 steps, a
        checkpoint every 4; a fault at step 9 replays to the uninterrupted
        run's params and AdamW state bit for bit; a SIGTERM at step 6 (the
        handler's flag) leaves a checkpoint that a new trainer resumes to
        the same state bit for bit;
    (c) llama3-8b with ``kmeans_attn`` at full width, depth 2, B 1, S 4,096
        (32 problems a layer of N 4,096, K 64, d 128; window 512, cap 128),
        f32 with remat, 4 counted steps. Named checks: kernels 1-3 on layer
        0's keys and queries against their plain versions
        (``lm_kernel_checks``); each routed layer at ``impl="flash"`` and
        ``impl="ref"`` on the flash step's own inputs, the differing ids
        counted and the attention rows bit for bit where the query's
        cluster agrees; the step's loss and grads at ``impl="flash"``
        against ``impl="ref"``, bit for bit where every id agrees, else
        within ``TRAIN_C_*``; remat against no remat, loss and grads bit
        for bit;
    (d) one ``make_train_step`` step (bf16, remat) of each other family at
        full width, B 1 (``TRAIN_D``'s depth cuts and lengths): the loss
        finite, the grad norm finite and > 0.

    Returns the counted runs' launch counts ((a), (b), (c)'s steps, (d)),
    the named checks' ``(name, counts)`` and ``{kernel: max abs err}``."""
    import dataclasses
    import gc
    import math
    import shutil
    import signal
    import statistics
    import tempfile

    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticPipeline,
                                           pipeline_for, put_batch)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_launch
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.models import model as M
    from repro_torch.models.common import Ctx
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    rec = details.setdefault("train", {})
    rec["card"] = smi
    runs, checks, errs = [], [], {}
    bf16_peak = PEAK["flash_assign"]["bfloat16"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    print(f"\n[train] {smi}; {base / 2**30:.2f} GiB allocated before; "
          f"checkpoints under {root} "
          f"({shutil.disk_usage(root).free / 2**30:.0f} GiB free)",
          flush=True)
    check(base < 2 ** 30, f"[train] phase 15 starts with the earlier phases' "
                          f"tensors freed ({base / 2**30:.3f} GiB, < 1 GiB)")
    try:
        # ---- (a) granite-moe at full width and depth, launch/train.py ----
        cfg = get_config(TRAIN_ARCH)
        a = TRAIN_A
        argv = ["--arch", TRAIN_ARCH, "--batch", str(a["batch"]),
                "--seq", str(a["seq"]), "--steps", str(a["steps"]),
                "--ckpt-every", str(a["ckpt_every"]), "--ckpt-keep", "1",
                "--log-every", "1", "--seed", str(SEED),
                "--ckpt-dir", str(root / "a")]
        print(f"[train/a] {cfg.name}: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_experts} experts top-"
              f"{cfg.experts_per_token}, {cfg.n_params() / 1e9:.3f} G params "
              f"({cfg.n_active_params() / 1e9:.3f} G active); B {a['batch']}"
              f" (train_4k's 256 cut for time), S {a['seq']}, bf16 over f32 masters, "
              f"remat", flush=True)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = train_launch.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        runs.append(counts)
        peak = torch.cuda.max_memory_allocated()
        losses = [loss for _, loss in out["losses"]]
        ms = statistics.median(out["device_ms"])
        tokens = a["batch"] * a["seq"]
        flops = 6 * cfg.n_active_params() * tokens
        ra = {"steps": out["final_step"], "losses": losses,
              "device_ms": out["device_ms"], "step_s": out["step_s"],
              "ms_median": ms, "tokens_per_s": tokens / (ms / 1e3),
              "peak_bytes": peak, "wall_s": wall,
              "n_params": out["n_params"],
              "n_active": cfg.n_active_params(),
              "model_flops_share": flops / (ms / 1e3) / bf16_peak,
              "stragglers": out["stragglers"], "retries": out["retries"],
              "launches": counts}
        rec["a"] = ra
        print(f"  {ms:.1f} ms a step (CUDA events, median of "
              f"{len(out['device_ms'])}), {ra['tokens_per_s']:.0f} tokens/s,"
              f" peak {peak / 2**30:.2f} GiB, 6 N_active tokens / step time "
              f"= {ra['model_flops_share']:.3f} of the bf16 dense peak; "
              f"{wall:.1f} s in all", flush=True)
        first = statistics.mean(losses[:3])
        last = statistics.mean(losses[-3:])
        check(out["final_step"] == a["steps"] and len(losses) == a["steps"]
              and all(math.isfinite(x) for x in losses)
              and out["retries"] == 0,
              f"[train/a] {a['steps']} steps, every loss finite "
              f"({len(losses)} logged), no step replayed "
              f"({out['retries']} retries)")
        check(last < first, f"[train/a] the loss falls: the mean of the "
                            f"last 3 {last:.4f} < the first 3 {first:.4f}")
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) the fault contract at depth 2 ------------------------------
        b_ = TRAIN_B
        cfg_b = dataclasses.replace(cfg, num_layers=b_["layers"])

        def trainer_b(d, total, hook=None):
            params = M.init_model(cfg_b, seed=SEED, device=dev, max_pos=1024)
            step_fn = make_train_step(cfg_b, compute_dtype=torch.float32,
                                      remat=False)
            pipe = SyntheticPipeline(DataConfig(
                seed=1, vocab_size=cfg_b.vocab_size, batch=b_["batch"],
                seq_len=b_["seq"]))
            tr = Trainer(TrainerConfig(
                total_steps=total, checkpoint_every=b_["ckpt_every"],
                checkpoint_dir=str(root / d), keep=2), step_fn, pipe,
                lambda batch: put_batch(batch, dev))
            tr.fault_hook = hook
            return tr, params, adamw.init(params)

        t0 = time.perf_counter()
        zero_counts()
        tr, p, o = trainer_b("clean", b_["steps"])
        clean, _ = tr.run(p, o)
        runs.append(read_counts())
        clean_ms = statistics.median(tr.device_ms)
        shutil.rmtree(root / "clean")
        armed = {"on": True}

        def fault(step):
            if step == b_["fault"] and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected node failure")

        tr, p, o = trainer_b("fault", b_["steps"], fault)
        faulty, _ = tr.run(p, o)
        replay_ok = same_tree(clean, faulty)
        check(tr.retries == 1 and replay_ok,
              f"[train/b] a fault at step {b_['fault']} ({tr.retries} retry) "
              f"replays from step 8 to the uninterrupted run's params and "
              f"AdamW state bit for bit: {replay_ok}")
        del faulty, tr, p, o
        shutil.rmtree(root / "fault")

        def term(step):
            if step == b_["sigterm"]:
                os.kill(os.getpid(), signal.SIGTERM)

        tr, p, o = trainer_b("term", b_["steps"], term)
        _, stopped = tr.run(p, o)
        saved = tr.ckpt.latest_step()
        del tr, p, o
        tr, p, o = trainer_b("term", b_["steps"])
        resumed, final = tr.run(p, o)
        resume_ok = same_tree(clean, resumed)
        check(stopped == b_["sigterm"] + 1 and saved == stopped
              and final == b_["steps"] and resume_ok,
              f"[train/b] SIGTERM at step {b_['sigterm']}: stopped at "
              f"{stopped} with a checkpoint at {saved}; a new trainer "
              f"resumed to step {final}, bit for bit the uninterrupted run: "
              f"{resume_ok}")
        rec["b"] = {"replay_bitwise": replay_ok, "sigterm_stop": stopped,
                    "sigterm_ckpt": saved, "resume_bitwise": resume_ok,
                    "ms_median": clean_ms,
                    "seconds": time.perf_counter() - t0}
        print(f"  (b) {clean_ms:.1f} ms a step at depth 2 f32; "
              f"{rec['b']['seconds']:.1f} s", flush=True)
        del clean, resumed, tr, p, o
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (c) routed attention: llama3-8b with kmeans_attn -----------
        c_ = TRAIN_C
        cfg_c = dataclasses.replace(get_config(c_["arch"]),
                                    num_layers=c_["layers"], kmeans_attn=True)
        rc = rec.setdefault("c", {})
        t0 = time.perf_counter()
        params = M.init_model(cfg_c, seed=SEED + 40, device=dev,
                              max_pos=1024)
        pipe = SyntheticPipeline(DataConfig(
            seed=SEED + 41, vocab_size=cfg_c.vocab_size, batch=c_["batch"],
            seq_len=c_["seq"]))
        batch0 = put_batch(pipe.batch_at(0), dev)
        s = c_["seq"]
        print(f"[train/c] {cfg_c.name} with kmeans_attn: {c_['layers']} "
              f"layers at full width, B {c_['batch']}, S {s}: "
              f"{c_['batch'] * cfg_c.num_heads} problems a layer of N {s}, "
              f"K {cfg_c.kv_cluster_k}, d {cfg_c.resolved_head_dim}, window "
              f"{min(cfg_c.window_size, max(32, s // 8))}, cap "
              f"{max(8, int(s / cfg_c.kv_cluster_k * 2.0))}", flush=True)

        ctx_c = Ctx(compute_dtype=torch.float32)

        def loss_grads(impl, remat):
            """The step's loss and grads; ``impl`` None is the model's own
            choice (``"flash"`` on the card), else forced on every routed
            layer."""
            ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
            with _Capture(kma, impl=impl) as cap:
                loss, _ = M.loss_fn(ps, batch0, ctx_c, cfg_c, remat=remat)
                grads = torch.autograd.grad(loss, tree_leaves(ps))
            return loss.detach(), grads, cap

        zero_counts()
        lf, gf, capf = loss_grads(None, True)
        nl = c_["layers"]
        impls = [kw["impl"] for *_, kw in capf.calls[:nl]]
        check(impls == ["flash"] * nl,
              f"[train/c] the model's routed layers take the kernels on the "
              f"card: impl {impls}")
        # the kernels on layer 0's keys and queries (the first fit's)
        q0, k0 = capf.calls[0][0], capf.calls[0][1]
        z = q0.shape[0] * q0.shape[2]
        for name, x in (("keys", k0), ("queries", q0)):
            xe = x.movedim(2, 1).reshape(z, s, -1).contiguous()
            e = lm_kernel_checks(dev, xe, cfg_c.kv_cluster_k, 4,
                                 rc.setdefault(name, {}),
                                 tag=f"train/c {name}")
            for kn, v in e.items():
                errs[kn] = max(errs.get(kn, 0.0), v)
        checks.append(("train/c flash step + kernel checks", read_counts()))

        zero_counts()
        lr_, gr_, _ = loss_grads("ref", True)
        checks.append(("train/c ref step", read_counts()))

        # every routed layer on the flash step's own q, k and v, at
        # impl="flash" and at impl="ref" (each its own fit of the same
        # keys): the rows whose query's cluster holds the same keys and
        # queries under both are equal bit for bit
        kc = cfg_c.kv_cluster_k
        zero_counts()
        layers = []
        for qa, ka, va, kw in capf.calls[:nl]:
            outs, fits = {}, {}
            for impl in ("flash", "ref"):
                with _Capture(kma, impl=impl) as cap, torch.no_grad():
                    o = kma.kmeans_routed_attention(qa, ka, va, **kw)
                outs[impl] = o.movedim(2, 1).reshape(z, s, -1)
                fits[impl] = cap.fits[0]
            qz = qa.movedim(2, 1).reshape(z, s, -1).float()
            aq_f = ops.flash_assign_batched(qz, fits["flash"][0].float(),
                                            want_dists=False)[0]
            aq_r = ref.assign_ref(qz, fits["ref"][0].float())[0]
            ak_f, ak_r = fits["flash"][1], fits["ref"][1]
            # a cluster agrees when no key or query moved into or out of it
            moved = torch.zeros((z, kc + 1), dtype=torch.bool, device=dev)
            for fa_, fr_ in ((ak_f, ak_r), (aq_f, aq_r)):
                diff = fa_ != fr_
                for col in (fa_, fr_):
                    moved.scatter_(1, torch.where(diff, col, kc).long(),
                                   True)
            rows_ok = (aq_f == aq_r) & (~moved[:, :kc]).gather(
                1, aq_f.long())
            eq = (outs["flash"] == outs["ref"]).all(-1)
            layers.append({"key_ids_differ": int((ak_f != ak_r).sum()),
                           "query_ids_differ": int((aq_f != aq_r).sum()),
                           "rows_agree": int(rows_ok.sum()),
                           "rows_bitwise": bool(eq[rows_ok].all())})
            del outs, fits, eq
        checks.append(("train/c flash vs ref, each layer's inputs",
                       read_counts()))
        n_ids = z * s
        check(all(r["rows_bitwise"] for r in layers),
              f"[train/c] flash vs ref on each routed layer's inputs: the "
              f"attention rows equal bit for bit where the query's cluster "
              f"agrees ({[r['rows_agree'] for r in layers]} of {n_ids} "
              f"rows); (key, query) ids differing "
              f"{[(r['key_ids_differ'], r['query_ids_differ']) for r in layers]}")
        loss_rel = abs(float(lf) - float(lr_)) / abs(float(lr_))
        grad_rel = tree_rel_diff(gf, gr_)
        rc["flash_vs_ref"] = {"layers": layers, "ids_a_layer": n_ids,
                              "loss_flash": float(lf), "loss_ref": float(lr_),
                              "loss_rel": loss_rel, "grad_rel": grad_rel}
        print(f"  flash vs ref: loss {float(lf):.6f} vs {float(lr_):.6f} "
              f"(rel {loss_rel:.3g}), grads rel {grad_rel:.3g}", flush=True)
        if not any(r["key_ids_differ"] or r["query_ids_differ"]
                   for r in layers):
            # layer 0's inputs are the same in both steps; with every id
            # equal each layer hands the next the same bits
            check(same_bits(lf, lr_) and all(
                same_bits(x, y) for x, y in zip(gf, gr_)),
                "[train/c] every id agrees on every layer, so the flash "
                "step's loss and grads equal the ref step's bit for bit")
        else:
            # never reached on the card so far (every id agreed in every
            # run): TRAIN_C_*'s bounds come from no reading
            check(loss_rel <= TRAIN_C_LOSS_RTOL
                  and grad_rel <= TRAIN_C_GRAD_RTOL,
                  f"[train/c] flash vs ref with some ids differing: loss "
                  f"rel {loss_rel:.3g} <= {TRAIN_C_LOSS_RTOL}, grads rel "
                  f"{grad_rel:.3g} <= {TRAIN_C_GRAD_RTOL}")
        del gr_

        zero_counts()
        ln, gn_, _ = loss_grads(None, False)
        checks.append(("train/c no-remat step", read_counts()))
        remat_ok = same_bits(lf, ln) and all(
            same_bits(x, y) for x, y in zip(gf, gn_))
        # remat's backward re-ran each layer's fit (in reverse layer order)
        refit = capf.fits[nl:]
        refit_ok = len(refit) == nl and all(
            same_bits(f, g) for f, g in zip(capf.fits[:nl], refit[::-1]))
        check(remat_ok and refit_ok,
              f"[train/c] remat and no remat: the loss and every grad bit "
              f"for bit ({float(lf):.6f}): {remat_ok}; the backward's "
              f"recomputed clusters the forward's bit for bit: {refit_ok}")
        rc["remat_bitwise"] = remat_ok
        rc["refit_bitwise"] = refit_ok
        del gf, gn_, capf, q0, k0
        gc.collect()
        torch.cuda.empty_cache()

        # the counted run: make_train_step, 4 steps
        step_fn = make_train_step(cfg_c, compute_dtype=torch.float32,
                                  remat=True)
        opt = adamw.init(params)
        ms_c, losses_c = [], []
        zero_counts()
        for step in range(c_["steps"]):
            batch = put_batch(pipe.batch_at(step), dev)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            params, opt, met = step_fn(params, opt, batch, step)
            e1.record()
            losses_c.append(met["loss"].item())
            ms_c.append(e0.elapsed_time(e1))
        counts = read_counts()
        runs.append(counts)
        rc.update(losses=losses_c, device_ms=ms_c, launches=counts,
                  seconds=time.perf_counter() - t0)
        print(f"  {c_['steps']} steps: losses {losses_c}, "
              f"{statistics.median(ms_c):.1f} ms a step (median), launches "
              f"{ {kn: v for kn, v in counts.items() if v} }", flush=True)
        check(all(math.isfinite(x) for x in losses_c)
              and counts["flash_assign"] > 0
              and counts["sort_inverse_update"] + counts["flash_lloyd"] > 0,
              f"[train/c] {c_['steps']} routed steps: losses finite, "
              f"FlashAssign launched {counts['flash_assign']} times, the "
              f"update or FlashLloyd {counts['sort_inverse_update']} + "
              f"{counts['flash_lloyd']}")
        del params, opt, step_fn, batch, batch0, met
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (d) every other family, one step -----------------------------
        rd = rec.setdefault("d", {})
        for arch, (cut, seq) in TRAIN_D.items():
            t0 = time.perf_counter()
            cfg_d = dataclasses.replace(get_config(arch), **cut)
            torch.cuda.reset_peak_memory_stats()
            params = M.init_model(cfg_d, seed=SEED, device=dev,
                                  max_pos=max(seq, 1024))
            opt = adamw.init(params)
            step_fn = make_train_step(cfg_d, compute_dtype=torch.bfloat16,
                                      remat=True)
            pipe = pipeline_for(cfg_d, ShapeSpec("train", seq, 1, "train"),
                                seed=SEED)
            batch = put_batch(pipe.batch_at(0), dev)
            zero_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            params, opt, met = step_fn(params, opt, batch, 0)
            e1.record()
            loss, gnorm = met["loss"].item(), met["grad_norm"].item()
            counts = read_counts()
            runs.append(counts)
            n = M.n_elements(params)
            rd[arch] = {"cut": cut, "seq": seq, "n_params": n, "loss": loss,
                        "grad_norm": gnorm, "ms": e0.elapsed_time(e1),
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "seconds": time.perf_counter() - t0}
            print(f"  (d) {arch} {cut or 'uncut'}, S {seq}: {n / 1e9:.3f} G "
                  f"params, "
                  f"loss {loss:.4f}, grad norm {gnorm:.4f}, "
                  f"{rd[arch]['ms']:.1f} ms, peak "
                  f"{rd[arch]['peak_bytes'] / 2**30:.1f} GiB", flush=True)
            check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
                  f"[train/d] {arch} ({cut or 'full depth'}): one step, loss "
                  f"{loss:.4f} finite, grad norm {gnorm:.4g} finite and > 0")
            del params, opt, step_fn, batch, met
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["main_launches"] = {kn: sum(r[kn] for r in runs) for kn in runs[0]}
    rec["check_launches"] = dict(checks)
    rec["max_abs_err"] = errs
    print(f"  phase {rec['seconds']:.1f} s; the training path's runs "
          f"launched { {kn: v for kn, v in rec['main_launches'].items() if v} }",
          flush=True)
    return runs, checks, errs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and run the ragged kernel checks only")
    ap.add_argument("--reliability-only", action="store_true",
                    help="build and run the reliability phase only")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build and run the parallel phase only")
    ap.add_argument("--parallel-e-only", action="store_true",
                    help="build and run the parallel phase's part (e), the "
                         "sharded index's reliability, only")
    ap.add_argument("--lm-only", action="store_true",
                    help="build and run the LM serving phase (13) only")
    ap.add_argument("--zoo-only", action="store_true",
                    help="build and run the LM zoo phase (14) only")
    ap.add_argument("--train-only", action="store_true",
                    help="build and run the training phase (15) only")
    args = ap.parse_args()
    t_main = time.perf_counter()
    # the plain versions' score matrices take up to 32 GiB at a time, in
    # blocks of changing size: segments that grow keep the cache from
    # fragmenting between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    # a fresh plan file for the whole run: no earlier run's plans can change
    # the paths the phases take
    plan_file = ROOT / "build" / "chip_smoke_plans.json"
    plan_file.parent.mkdir(parents=True, exist_ok=True)
    plan_file.unlink(missing_ok=True)
    os.environ["REPRO_PLAN_CACHE"] = str(plan_file)
    from repro_torch.core import (ChunkedKMeans, ChunkedStats, KMeans,
                                  KMeansConfig, StreamingKMeans,
                                  stream_from_numpy)
    from repro_torch.core import autotune
    from repro_torch.core import heuristics as H
    from repro_torch.core import plan as P
    from repro_torch.index import (DeviceRescoreCache, IVFIndex,
                                   TwoLevelRouter, recall_at_k)
    from repro_torch.index import bridge
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.index import store as store_mod
    from repro_torch.index.rescore_cache import cache_lookup
    from repro_torch.kernels import flash_assign as fa
    from repro_torch.kernels import flash_lloyd as fl
    from repro_torch.kernels import flash_probe as fp
    from repro_torch.kernels import ops
    from repro_torch.kernels import rescore_cache as rck
    from repro_torch.kernels import sort_inverse_update as siu
    from repro_torch.serve import SearchConfig, SearchEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds}) -> {_build.build()}", flush=True)
    for line in _build.ptxas_log.splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())
    # FlashAssign's tensor-core kernels: registers and spills from ptxas,
    # the dynamic shared memory its launch sets against the planner's model
    fname, spills = "", {}
    for line in _build.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            fname = line.split("'")[1]
        elif "spill stores" in line:
            spills[fname] = line.strip()
        elif "Used" in line and "flash_assign_tc" in fname:
            f32, res, dists = re.findall(r"Lb([01])E", fname)[:3]
            spill = spills.get(fname, "")
            check(bool(re.search(NO_SPILLS, spill)),
                  f"flash_assign_tc<{'f32' if f32 == '1' else 'bf16'}, "
                  f"{'resident' if res == '1' else 'streamed'} x, "
                  f"{'distances' if dists == '1' else 'scores'}>: "
                  f"{line.split(':', 1)[1].strip()}; {spill} (no spills)")
    for bf16, d, dists in itertools.product((False, True), (128, 512),
                                            (False, True)):
        got = _build.assign_dynamic_smem(bf16, d, dists)
        model = H.assign_footprint(fa.TILE_N, fa.TILE_K, d, 2 if bf16 else 4,
                                   dists=dists)
        check(got == model and model <= H.H100.smem_block_bytes,
              f"flash_assign dynamic smem {got} == the planner's model "
              f"{model} <= {H.H100.smem_block_bytes} (bf16={bf16}, d={d}, "
              f"distances={dists})")
    # FlashLloyd: registers and spills, then for every cluster size its
    # shared memory at the largest K that fits (the planner's window), as
    # the launch sets it, against the planner's model; and the clusters the
    # card keeps resident there (cudaOccupancyMaxActiveClusters)
    for line in _build.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            fname = line.split("'")[1]
        elif "Used" in line and "flash_lloyd_tc" in fname:
            f32 = re.findall(r"Lb([01])E", fname)[0]
            print(f"  flash_lloyd_tc<{'f32' if f32 == '1' else 'bf16'}>: "
                  f"{line.split(':', 1)[1].strip()}; {spills.get(fname, '')}")
    for bf16, d, cl in itertools.product((False, True), (1, 19, 128, 129),
                                         fl.CLUSTERS):
        isz = 2 if bf16 else 4
        kmax = H.max_fused_k(d, isz, cl, H.H100)
        dp = fl.padded_d(d, isz)
        got = _build.lloyd_smem(bf16, dp, kmax, cl)
        model = H.fused_footprint(kmax, d, isz, cl)
        active = fl.active_clusters(dev, bf16, dp, kmax, cl)
        check(got == (model, 0) and model <= H.H100.smem_block_bytes
              and H.fused_footprint(kmax + 1, d, isz, cl)
              > H.H100.smem_block_bytes,
              f"flash_lloyd (dynamic, static) smem {got} == the planner's "
              f"({model}, 0) at the window's edge K={kmax} (bf16={bf16}, "
              f"d={d}, C={cl}); {active} clusters of {cl} resident "
              f"({active * cl} CTAs)")

    # the q8 store scan's cell-mode instances (lanes a row, list entries a
    # lane): its local memory is a stack frame, never spills; nor may any
    # instance of the probe's tile mode or the block scan's warp mode
    for fname, spill in spills.items():
        if "flash_probe_store_q8_kernel" in fname:
            g, kn = re.findall(r"ILi(\d+)ELi(\d+)E", fname)[0]
            check(bool(re.search(NO_SPILLS, spill)),
                  f"flash_probe_store_q8<{g} lanes, {32 * int(kn)} entries>: "
                  f"{spill} (no spills)")
        for kern in ("flash_probe_tile_kernel",
                     "flash_probe_grouped_warp_kernel"):
            if kern in fname:
                check(bool(re.search(NO_SPILLS, spill)),
                      f"{kern} {fname}: {spill} (no spills)")
    for kname, (regs, local) in fp.kernel_attrs().items():
        cap = (H.PROBE_REGS if kname.endswith("_list")
               else H.STORE_Q8_REGS if kname.startswith("flash_probe_store_q8")
               else H.STORE_REGS if kname.startswith("flash_probe_store")
               else H.PROBE_TILE_REGS if kname.startswith("flash_probe_tile")
               else H.GROUPED_WARP_REGS
               if kname.startswith("flash_probe_grouped_warp")
               else H.PROBE_REGS)
        check(regs <= cap, f"{kname}: {regs} registers <= {cap} (the "
              f"planner's model); {local} bytes of local memory")
    # the probe's tile mode: its launch's shared memory, as the CUDA source
    # computes it, against the planner's model, at the widest rows
    bad = [(d, isz, l, cl, _build.probe_tile_smem(d * isz, l, cl),
            fp.probe_tile_smem(d, isz, l, cl))
           for isz, l, cl in itertools.product((2, 4), (1, 16, 33, 64),
                                               fp.PROBE_CLUSTERS)
           for d in (16 // isz, 128, fp.PROBE_TILE_ROW_BYTES // isz)]
    bad = [b for b in bad if b[4] != b[5] or b[5] > H.H100.smem_block_bytes]
    check(not bad, f"flash_probe_tile dynamic smem == the planner's model <= "
                   f"{H.H100.smem_block_bytes} at every (d, itemsize, L, "
                   f"cluster) of the grid; (d, itemsize, L, cluster, got, "
                   f"model) off: {bad}")
    # the sort-inverse launch's layout and shared memory, as compiled,
    # against the planner's model
    for d, bf16 in itertools.product((1, 19, 128, 129, 512), (False, True)):
        isz = 2 if bf16 else 4
        got = siu.kernel_layout(d, 256, siu.THREADS, bf16)
        model = (H.update_footprint(256, siu.THREADS, d, isz),
                 *siu.layout(d, isz))
        check(got == model, f"sort_inverse_update (smem, V, G, VPL) {got} "
                            f"== the planner's {model} (d={d}, bf16={bf16})")

    mods = {"flash_assign": fa, "sort_inverse_update": siu,
            "flash_lloyd": fl, "rescore_cache_insert": rck}
    probe_names = tuple(fp.launches)
    launches = {k: 0 for k in (*mods, *probe_names)}
    max_err = {k: 0.0 for k in (*launches, *PAGED_ROWS)}
    paged_launches = {k: 0 for k in PAGED_ROWS}
    # runs outside the main path, by kernel table row: {run name: launches}
    check_launches = {k: {} for k in (*launches, *PAGED_ROWS)}
    timing: dict[str, dict] = {}
    details = {"card": smi, "regimes": [], "kernel_checks": [], "ivf": [],
               "ivf_truth": [], "controls": [], "step_pairs": [],
               "profiles": [], "cache_insert": [], "engine": [],
               "routed": {}, "paged": [], "paged_skew": [],
               "paged_evict": {},
               "out_of_core": {}, "streaming": {}, "ooc_ivf": [],
               "planner": {}}

    zero_counts, read_counts = launch_counters()
    ms_of = events_ms

    def mixture(b, n, k, d, gen):
        centers = torch.randn(b, k, d, device=dev, generator=gen) * 2.0
        lab = torch.randint(0, k, (b, n), device=dev, generator=gen)
        x = torch.randn(b, n, d, device=dev, generator=gen)
        for i in range(b):
            x[i].add_(centers[i].index_select(0, lab[i]))
        return x

    if args.reliability_only:   # phase 11 alone (reliability_phase)
        reliability_phase(dev, smi, zero_counts, read_counts, details)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_reliability.json").write_text(
            json.dumps(details["reliability"], indent=1))
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print("\nchip_smoke --reliability-only: all checks passed")
        return 0
    if args.lm_only:   # phase 13 alone (lm_phase)
        lm_phase(dev, smi, zero_counts, read_counts, details)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_lm.json").write_text(
            json.dumps(details["lm"], indent=1))
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print("\nchip_smoke --lm-only: all checks passed")
        return 0
    if args.zoo_only:   # phase 14 alone (zoo_phase)
        zoo_phase(dev, smi, zero_counts, read_counts, details)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_zoo.json").write_text(
            json.dumps(details["zoo"], indent=1))
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print("\nchip_smoke --zoo-only: all checks passed")
        return 0
    if args.train_only:   # phase 15 alone (train_phase)
        train_phase(dev, smi, zero_counts, read_counts, details)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_train.json").write_text(
            json.dumps(details["train"], indent=1))
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print("\nchip_smoke --train-only: all checks passed")
        return 0
    if args.parallel_only or args.parallel_e_only:   # phase 12 or its (e)
        if args.parallel_e_only:
            rel_mesh_part(dev, smi, details.setdefault("parallel", {
                "card": smi}), [], [])
        else:
            parallel_phase(dev, smi, zero_counts, read_counts, details)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_parallel.json").write_text(
            json.dumps(details["parallel"], indent=1, default=str))
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print("\nchip_smoke --parallel-only: all checks passed"
              if args.parallel_only else
              "\nchip_smoke --parallel-e-only: all checks passed")
        return 0

    # ---- phase 2 helpers: kernel vs plain on the card -------------------
    def batch_tol(x, c):
        """Per problem: ``flash_assign.score_tol``, the kernel's worst-case
        score error plus the plain version's (FlashLloyd runs the same
        argmin)."""
        return torch.tensor([fa.score_tol(x[i], c[i])
                             for i in range(x.shape[0])], device=dev)

    def row_gap(x, c, a1, a2):
        """(B, N) ``|score(a1) - score(a2)|`` (fp32, the plain form), 0 where
        the ids agree: two ids may differ only on such near-ties."""
        gap = torch.zeros(a1.shape, device=dev)
        diff = a1 != a2
        if bool(diff.any()):
            bi, ni = diff.nonzero().unbind(1)
            xr, cc = x[bi, ni].float(), c.float()

            def score(kk):
                ck = cc[bi, kk.long()]
                return (ck * ck).sum(-1) - 2 * (xr * ck).sum(-1)
            gap[bi, ni] = (score(a1[bi, ni]) - score(a2[bi, ni])).abs()
        return gap

    def assign_compare(x, c, a, m, tag, kname="flash_assign"):
        """``(a, m)`` for x (B, N, d), c (B, K, d) of one dtype, every row
        held against the plain version, which runs in chunks that fit the
        card: scores within each problem's ``score_tol``, ids equal except
        on near-ties inside it. Returns the record, with ``ok``."""
        b, n, d = x.shape
        k = c.shape[1]
        tol = batch_tol(x, c)
        err = torch.zeros(b, device=dev)
        gap = torch.zeros(b, device=dev)
        mism = 0
        for bs, rs in plain_chunks(b, n, k):
            ap, mp = fa.flash_assign_plain(x[bs, rs], c[bs])
            err[bs] = torch.maximum(err[bs], (m[bs, rs] - mp).abs().amax(1))
            gap[bs] = torch.maximum(
                gap[bs], row_gap(x[bs, rs], c[bs], a[bs, rs], ap).amax(1))
            mism += int((a[bs, rs] != ap).sum())
        return {"kernel": kname, "at": tag, "dtype": str(x.dtype),
                "shape": [b, n, k, d], "rows_compared": b * n,
                "max_abs_err": float(err.max()), "tol": float(tol.max()),
                "err_over_tol": float((err / tol).max()), "mismatches": mism,
                "tie_gap": float(gap.max()),
                "gap_over_tol": float((gap / tol).max()),
                "ok": bool((err <= tol).all()) and bool((gap <= tol).all())}

    def assign_check(x, c, tag):
        """The kernel over the whole batch, held to ``assign_compare``; then
        its launch that returns distances (the two-pass path's), whose ids
        must equal the first launch's bit for bit (the same argmin) and
        whose distances must lie within each problem's
        ``flash_assign.dist_tol`` of the plain version's. Returns the
        kernel's ids."""
        a, m = fa.flash_assign_raw(x, c)
        rec = assign_compare(x, c, a, m, tag)
        details["kernel_checks"].append(rec)
        check(rec["ok"], f"flash_assign {tag} {x.dtype}: all "
              f"{rec['rows_compared']} rows, score err "
              f"{rec['max_abs_err']:.3g}, {rec['mismatches']} id mismatches "
              f"(max gap {rec['tie_gap']:.3g}) <= score_tol {rec['tol']:.3g} "
              f"(err/tol {rec['err_over_tol']:.3g})")
        a_d, m_d = fa.flash_assign_raw(x, c, want_dists=True)
        b, n, _ = x.shape
        tol = torch.tensor([fa.dist_tol(x[i], c[i]) for i in range(b)],
                           device=dev)
        err = torch.zeros(b, device=dev)
        for bs, rs in plain_chunks(b, n, c.shape[1]):
            _, mp = fa.flash_assign_plain(x[bs, rs], c[bs], want_dists=True)
            err[bs] = torch.maximum(err[bs], (m_d[bs, rs] - mp).abs().amax(1))
        same = torch.equal(a_d, a)
        ok = same and bool((err <= tol).all()) and bool((m_d >= 0).all())
        details["kernel_checks"].append(
            {"kernel": "flash_assign", "at": tag + "/distances",
             "dtype": str(x.dtype), "rows_compared": b * n,
             "max_abs_err": float(err.max()), "tol": float(tol.max()),
             "err_over_tol": float((err / tol).max()),
             "ids_equal_scores_launch": same, "ok": ok})
        check(ok, f"flash_assign {tag} {x.dtype} distances: ids == the score "
              f"launch's bit for bit {same}, dist err {float(err.max()):.3g} "
              f"<= dist_tol {float(tol.max()):.3g} (err/tol "
              f"{float((err / tol).max()):.3g}), none negative")
        max_err["flash_assign"] = max(max_err["flash_assign"],
                                      rec["max_abs_err"], float(err.max()))
        del a_d, m_d, m
        torch.cuda.empty_cache()   # the plain versions' large blocks
        return a

    def tf32_rna(v):
        """``cvt.rna.tf32.f32``: 13 low mantissa bits cleared, rounding half
        away from zero (half the dropped ulp added to the sign-magnitude
        bits)."""
        return ((v.contiguous().view(torch.int32) + 0x1000)
                & -0x2000).view(torch.float32)

    def assign_emulated(x, c, kind):
        """``(a, m)`` of FlashAssign's f32 arithmetic with fewer TF32
        products than the kernel takes, in plain PyTorch: ``tf32`` takes
        x_hi c_hi alone, ``drop_x_lo`` x_hi c_lo + x_hi c_hi (the kernel
        with its x_lo c_hi term lost). The products are summed in float64,
        so only the dropped terms err; chunked like the plain version."""
        b, n, _ = x.shape
        a = torch.empty((b, n), dtype=torch.int32, device=dev)
        m = torch.empty((b, n), dtype=torch.float32, device=dev)
        for bs, rs in plain_chunks(b, n, c.shape[1]):
            xs, cs = x[bs, rs], c[bs]
            c_hi = tf32_rna(cs)
            c_b = c_hi.double()
            if kind == "drop_x_lo":   # c_hi + c_lo is exact in float64
                c_b = c_b + tf32_rna(cs - c_hi).double()
            dot = torch.matmul(tf32_rna(xs).double(), c_b.transpose(-1, -2))
            c64 = cs.double()
            score = ((c64 * c64).sum(-1).unsqueeze(-2) - 2.0 * dot).float()
            del dot
            ai = torch.argmin(score, dim=-1)
            a[bs, rs] = ai.to(torch.int32)
            m[bs, rs] = torch.gather(score, -1, ai.unsqueeze(-1)).squeeze(-1)
            del score
        return a, m

    def assign_control(x, c, tag, must_fail):
        """The controls of CONTROL_KINDS on f32 inputs, through
        ``assign_compare``: with ``must_fail`` the comparison must reject
        each, else its reading is recorded."""
        for kind in CONTROL_KINDS:
            a, m = assign_emulated(x, c, kind)
            rec = assign_compare(x, c, a, m, tag, kname=f"control/{kind}")
            rec["must_fail"] = must_fail
            details["controls"].append(rec)
            what = (f"control {kind} at {tag}: score err/tol "
                    f"{rec['err_over_tol']:.3g}, tie gap/tol "
                    f"{rec['gap_over_tol']:.3g}, {rec['mismatches']} ids "
                    f"differ")
            if must_fail:
                check(not rec["ok"], what + ": rejected by assign_check's "
                      "comparison")
            else:
                print("  read " + what, flush=True)

    sums_tol = stats_bound

    def siu_check(x2, ids, segments, tag, chunk=512, threads=128, got=None):
        """The kernel (or ``got``, its result through a wrapper) against the
        plain version: sums within ``2 n u sum|x|``, counts equal, clusters
        without points exactly 0."""
        ids_s, order = torch.sort(ids, stable=True)
        order = order.to(torch.int32)
        s, cnt = got if got is not None else siu.sort_inverse_update_raw(
            x2, order, ids_s, segments, chunk=chunk, threads=threads)
        sp, cp = siu.sort_inverse_update_plain(x2, order, ids_s, segments)
        torch.cuda.synchronize()
        err_t = (s - sp).abs()
        bound = sums_tol(x2, ids, segments, cp)
        err = float(err_t.max())
        empty = cp == 0
        zeros = bool((s[empty] == 0).all()) and bool((cnt[empty] == 0).all())
        ok = bool((err_t <= bound).all()) and torch.equal(cnt, cp) and zeros
        details["kernel_checks"].append(
            {"kernel": "sort_inverse_update", "at": tag,
             "dtype": str(x2.dtype), "rows": x2.shape[0],
             "segments": segments, "chunk": chunk, "threads": threads,
             "max_abs_err": err, "counts_equal": torch.equal(cnt, cp),
             "empty_clusters": int(empty.sum()), "empty_exact_zero": zeros})
        check(ok, f"sort_inverse_update {tag} {x2.dtype} (chunk {chunk}, "
                  f"threads {threads}): sums err {err:.3g} within "
                  f"2nu*sum|x|, counts equal {torch.equal(cnt, cp)}, "
                  f"{int(empty.sum())} empty clusters exactly 0 {zeros}")
        max_err["sort_inverse_update"] = max(max_err["sort_inverse_update"],
                                             err)
        return order, ids_s

    def inertia_bound(x, c, jp):
        """Per problem, the derived bound on ``|kernel inertia - plain|``:
        each row's score within ``flash_assign.score_tol`` (both sides),
        its ``||x||^2`` within ``d u ||x||^2`` on each side, and the sum of
        the N clamped terms within ``N u`` of its value on each side. Used
        where rows sit near their centroids, so that ``m + ||x||^2``
        cancels and no relative bound holds."""
        n, d = x.shape[1], x.shape[2]
        xn = torch.linalg.vector_norm(x.float(), dim=-1).amax(-1)
        return n * (batch_tol(x, c) + 2 * d * U32 * xn * xn) \
            + 2 * n * U32 * jp.abs()

    def lloyd_check(x, c, tag, cluster=None, near=False):
        """FlashLloyd (at ``cluster`` CTAs a cluster, the planner's smallest
        when None) against FlashAssign's ids, which it must equal bit for
        bit (the same tensor-core argmin), and against the plain version's
        statistics of its own ids: sums within ``2 n u sum|x|``, counts
        equal, clusters without points exactly 0; the inertia within rtol
        1e-4 of the plain version's, or with ``near`` (rows near their
        centroids) within ``inertia_bound``. Returns the ids."""
        a, s, cnt, j = fl.flash_lloyd_raw(x, c, cluster=cluster)
        torch.cuda.synchronize()
        b, n, d = x.shape
        k = c.shape[1]
        cl = cluster or H.choose_lloyd_cluster(k, d, x.element_size(),
                                               P.detect_hardware(dev))
        a_assign = assign_check(x, c, tag + "/fused-argmin") if n else a
        ids = (a.long() + k * torch.arange(b, device=dev).unsqueeze(1))
        ids = ids.reshape(-1)
        x2 = x.reshape(-1, d)
        sp = torch.zeros((b * k, d), device=dev).index_add_(
            0, ids, x2.float())
        cp = torch.bincount(ids, minlength=b * k).float()
        torch.cuda.empty_cache()
        _, _, _, jp = fl.flash_lloyd_plain(x, c)
        bound = sums_tol(x2, ids, b * k, cp)
        err_t = (s.reshape(b * k, d) - sp).abs()
        err = float(err_t.max())
        jerr = float(((j - jp).abs() / jp.abs().clamp_min(1e-30)).max())
        if near:
            j_ok = bool(((j - jp).abs() <= inertia_bound(x, c, jp)).all())
            j_what = "within the derived bound"
        else:
            j_ok, j_what = jerr <= 1e-4, "<= 1e-4"
        same = torch.equal(a, a_assign)
        empty = cp == 0
        zeros = bool((s.reshape(b * k, d)[empty] == 0).all()) and bool(
            (cnt.reshape(-1)[empty] == 0).all())
        ok = (bool((err_t <= bound).all()) and torch.equal(
            cnt.reshape(-1), cp) and j_ok and same and zeros)
        details["kernel_checks"].append(
            {"kernel": "flash_lloyd", "at": tag, "dtype": str(x.dtype),
             "shape": [b, n, k, d], "cluster": cl, "max_abs_err": err,
             "inertia_rel_err": jerr, "ids_equal_assign": same,
             "empty_clusters": int(empty.sum()), "empty_exact_zero": zeros})
        check(ok, f"flash_lloyd {tag} {x.dtype} (C={cl}): ids == "
                  f"FlashAssign's bit for bit {same}, sums err {err:.3g} "
                  f"within 2nu*sum|x|, counts equal, {int(empty.sum())} empty "
                  f"clusters exactly 0 {zeros}, inertia rel err {jerr:.2g} "
                  f"{j_what}")
        max_err["flash_lloyd"] = max(max_err["flash_lloyd"], err)
        return a_assign

    # ---- FlashProbe helpers: dense scores and the top-L check ------------
    def probe_scores(q, c):
        """(N, K) ``||c||^2 - 2 q.c`` and the worst-case magnitude."""
        q32, c32 = q.float(), c.float()
        mag = ((c32 * c32).sum(-1).max() + 2 * q32.norm(dim=-1).max()
               * c32.norm(dim=-1).max())
        return (c32 * c32).sum(-1) - 2.0 * (q32 @ c32.t()), mag

    def scan_scores(q, c):
        """(B, C) per-query ``||c||^2 - 2 q.c``; the magnitude is taken over
        real rows (store padding rows are checked relative to their own
        huge score)."""
        q32, c32 = q.float(), c.float()
        real = c32.abs().amax(-1) < PAD / 10
        cn = torch.where(real, c32.norm(dim=-1), torch.zeros((), device=dev))
        mag = cn.max() ** 2 + 2 * q32.norm(dim=-1).max() * cn.max()
        cross = torch.bmm(c32, q32.unsqueeze(-1)).squeeze(-1)
        return (c32 * c32).sum(-1) - 2.0 * cross, mag

    def q8_scores(qp, codes, scales):
        """(B, nprobe * W) true quantized distances, +inf on dead slots."""
        b, p, w, _ = codes.shape
        r = codes.float() * scales.unsqueeze(-1)
        cross = torch.matmul(r, qp.unsqueeze(-1)).squeeze(-1)
        qsq = (qp * qp).sum(-1, keepdim=True)
        score = torch.where(scales > 0, qsq - 2.0 * cross + (r * r).sum(-1),
                            torch.full_like(cross, float("inf")))
        rn = torch.where(scales > 0, r.norm(dim=-1),
                         torch.zeros((), device=dev)).max()
        qn = qp.norm(dim=-1).max()
        return score.reshape(b, p * w), (qn + rn) ** 2

    def topl_check(kname, tag, got, exp, score, mag, d):
        """Kernel ``got`` against the plain version's ``exp`` (ids, values):
        +inf in the same places, and the ids of those entries equal; finite
        values within the fp32 worst case ``2 d u (mag + |v|)``; every id
        in range and distinct in its row, its dense score equal to the
        kernel's value; ids that differ sit on near-ties inside the bound;
        equal values keep ascending ids (the lower-index rule)."""
        idx, v = got
        idx_p, v_p = exp
        torch.cuda.synchronize()
        c_n = score.shape[1]
        zero = torch.zeros((), device=dev)
        fin = torch.isfinite(v_p)
        tol = 2 * d * U32 * (mag + torch.where(fin, v_p.abs(), zero))
        err_t = torch.where(fin, (v - v_p).abs(), zero)
        real = fin & (v_p.abs() < PAD)
        err = float(err_t[real].max()) if bool(real.any()) else 0.0
        sk = score.gather(1, idx.long().clamp(0, c_n - 1))
        sp = score.gather(1, idx_p.long())
        diff = idx != idx_p
        gap_t = torch.where(diff & fin, (sk - sp).abs(), zero)
        srt = torch.sort(idx, dim=1).values
        eq = v[:, 1:] == v[:, :-1]
        parts = {
            "inf_same": torch.equal(torch.isinf(v), torch.isinf(v_p))
            and torch.equal(idx[~fin], idx_p[~fin]),
            "values": bool((err_t <= tol).all()),
            "ids_in_range": bool(((idx >= 0) & (idx < c_n)).all()),
            "ids_distinct": bool((srt[:, 1:] > srt[:, :-1]).all()),
            "value_is_score": bool((torch.where(fin, (sk - v).abs(), zero)
                                    <= tol).all()),
            "near_ties": bool((gap_t <= tol).all()),
            "lower_index": bool((idx[:, 1:] > idx[:, :-1])[eq].all()),
        }
        mism, gap = int((diff & fin).sum()), float(gap_t.max())
        details["kernel_checks"].append(
            {"kernel": kname, "at": tag, "shape": list(score.shape),
             "l": v.shape[1], "max_abs_err": err, "mismatches": mism,
             "tie_gap": gap, **parts})
        check(all(parts.values()),
              f"{kname} {tag}: {v.numel()} entries, err {err:.3g}, {mism} "
              f"id mismatches (gap {gap:.3g}), failed: "
              f"{[k for k, ok in parts.items() if not ok]}")
        max_err[kname] = max(max_err[kname], err)

    @contextlib.contextmanager
    def list_rule():
        """Both mode rules answer "list": the probe and the block scan take
        their list modes (the kernels before the tile and warp modes), the
        planner's plans with them; restored on exit."""
        saved = fp.probe_mode, fp.grouped_mode
        fp.probe_mode = fp.grouped_mode = lambda *a: "list"
        try:
            yield
        finally:
            fp.probe_mode, fp.grouped_mode = saved

    def in_list_mode(fn, *a, **kw):
        with list_rule():
            return fn(*a, **kw)

    def probe_check(q, c, l, tag, splits=None, cluster=None, plan=None,
                    list_too=False):
        """FlashProbe in the mode the wrapper takes (its row: the tile or
        the list mode; ``cluster`` forces the tile mode's cluster size)
        against the plain version; with ``list_too``, where the tile mode
        ran, the list mode on the same inputs as well, at its planned
        splits and at 3."""
        c32 = c.float()
        csq = (c32 * c32).sum(-1)
        score, mag = probe_scores(q, c)
        exp = fp.flash_probe_plain(q, c, csq, l)
        n0 = fp.launches["flash_probe_tile"]
        if cluster is None:
            got = ops.flash_probe(q, c, l=l, splits=splits, plan=plan,
                                  want_dists=False, c_sq=csq)
        else:
            got = fp.flash_probe_raw(q, c, csq, l, cluster=cluster)
        tile = fp.launches["flash_probe_tile"] > n0
        kname = "flash_probe_tile" if tile else "flash_probe"
        topl_check(kname, tag, got, exp, score, mag, q.shape[1])
        if tile and list_too:
            planned = H.choose_probe_splits(q.shape[0], c.shape[0], l)
            for s_ in sorted({planned, 3}):
                lst = in_list_mode(fp.flash_probe_raw, q, c, csq, l,
                                   splits=s_)
                topl_check("flash_probe", f"{tag}/list mode, splits={s_}",
                           lst, exp, score, mag, q.shape[1])
        return got

    def scan_check(q, c, l, tag, splits=None):
        """The block scan in the mode the wrapper takes (the warp or the
        list mode) against the plain version; the warp mode also against
        the list mode, bit for bit (same per-lane sums and lane pairing),
        on 16-byte aligned copies of q and c where they are not aligned
        (the warp mode scans such copies; the list mode would take its
        scalar path, which sums in another order)."""
        score, mag = scan_scores(q, c)
        exp = fp.flash_probe_grouped_plain(q, c, l)
        n0 = fp.launches["flash_probe_grouped_warp"]
        got = ops.flash_probe_grouped(q, c, l=l, splits=splits,
                                      want_dists=False)
        warp = fp.launches["flash_probe_grouped_warp"] > n0
        kname = "flash_probe_grouped_warp" if warp else "flash_probe_grouped"
        topl_check(kname, tag, got, exp, score, mag, q.shape[1])
        if warp:
            qa, ca = fp._aligned_copy(q), fp._aligned_copy(c)
            for s_ in (1, 3):
                lst = in_list_mode(fp.flash_probe_grouped_raw, qa, ca, l,
                                   splits=s_)
                check(torch.equal(got[0], lst[0])
                      and torch.equal(got[1], lst[1]),
                      f"{kname} {tag}: indices and scores equal the list "
                      f"mode's (splits={s_}) bit for bit "
                      f"({int((got[0] != lst[0]).sum())} indices differ)")
        return got

    def sentinel_block(t, probe, width, fill):
        """``candidate_slots`` of a per-slot store array ``t (K, cap, ...)``
        where ``probe`` may hold the sentinel cell K (counts of K + 1):
        its slots gathered at cell K - 1 and set to ``fill``."""
        k_ = t.shape[0]
        blk = store_mod.candidate_slots(t, probe.clamp(max=k_ - 1), width)
        dead = (probe >= k_).repeat_interleave(width, dim=1)
        return torch.where(dead.reshape(*dead.shape, *([1] * (blk.ndim - 2))),
                           torch.full_like(blk, fill), blk)

    def store_check(q, buckets, counts, probe, width, l, tag, splits=None):
        """The store scan against its plain version (the gathered block and
        the grouped scan's plain version), scored on that block; and against
        the grouped kernel on the gathered block, which it must equal bit
        for bit (same per-lane sums, same shuffle pairing). ``probe`` may
        hold the sentinel cell K where ``counts`` has K + 1 entries: its
        slots are padding rows in the block."""
        cand = sentinel_block(buckets, probe, width, PAD)
        score, mag = scan_scores(q, cand)
        exp = fp.flash_probe_store_plain(q, buckets, counts, probe, width, l,
                                         PAD)
        got = ops.flash_probe_store(q, buckets, counts, probe, width=width,
                                    l=l, pad=PAD, splits=splits,
                                    want_dists=False)
        topl_check("flash_probe_store", tag, got, exp, score, mag,
                   q.shape[1])
        for how, blk in (
                ("", ops.flash_probe_grouped(q, cand, l=l, want_dists=False)),
                (", list mode", in_list_mode(fp.flash_probe_grouped_raw,
                                             q, cand, l))):
            check(torch.equal(got[0], blk[0]) and torch.equal(got[1], blk[1]),
                  f"flash_probe_store {tag}: indices and scores equal the "
                  f"grouped kernel's{how} on the gathered block, bit for bit "
                  f"({int((got[0] != blk[0]).sum())} indices differ)")
        return got

    def q8_check(qp, codes, scales, l, tag, splits=None):
        score, mag = q8_scores(qp, codes, scales)
        exp = fp.flash_probe_grouped_q8_plain(qp, codes, scales, l)
        got = ops.flash_probe_grouped_q8(qp, codes, scales, l=l,
                                         splits=splits)
        topl_check("flash_probe_grouped_q8", tag, got, exp, score, mag,
                   qp.shape[-1])
        return got

    def q8_store_check(q, codes, scales, counts, probe, anchors, width, l,
                       tag, splits=None):
        """The q8 store scan against its plain version, scored on the
        gathered block; and against the block kernel on that block
        (``gather_global_q8``), which it must equal bit for bit, ``+inf``
        entries and their indices included. ``probe`` may hold the sentinel
        cell K where ``counts`` and ``anchors`` have K + 1 entries: its
        slots have scale 0 in the block."""
        b, nprobe = probe.shape
        d = codes.shape[-1]
        cb = sentinel_block(codes, probe, width, 0).reshape(b, nprobe, width,
                                                             d)
        sb = sentinel_block(scales, probe, width, 0.0).reshape(b, nprobe,
                                                                width)
        qp = q.float().unsqueeze(1) - anchors[probe.long()]
        score, mag = q8_scores(qp, cb, sb)
        exp = fp.flash_probe_store_q8_plain(qp, codes, scales, counts, probe,
                                            width, l)
        got = ops.flash_probe_store_q8(q, codes, scales, counts, probe,
                                       anchors, width=width, l=l,
                                       splits=splits)
        topl_check("flash_probe_store_q8", tag, got, exp, score, mag, d)
        blk = ops.flash_probe_grouped_q8(qp, cb, sb, l=l)
        check(torch.equal(got[0], blk[0]) and torch.equal(got[1], blk[1]),
              f"flash_probe_store_q8 {tag}: indices and distances equal the "
              f"block kernel's on the gathered block, bit for bit, +inf "
              f"entries included ({int((got[0] != blk[0]).sum())} indices "
              f"differ, {int(torch.isinf(got[1]).sum())} +inf)")
        return got

    def paged_layout(arrays, fills, cnt, ps):
        """The cells of the per-slot ``arrays`` (K, cap, ...) as pools of
        ``ps``-row pages under one page table (K + 1, ceil(cap / ps)) int32:
        cell c's first ceil(cnt[c] / ps) pages, on page ids of a shuffled
        free list with gaps (a fragmented allocator); page 0 and a last
        page's slots past cap hold ``fills``, unmapped entries and the
        sentinel cell K's row (the last) name page 0, and free pages hold
        noise that no scan may read."""
        k_, cap = arrays[0].shape[:2]
        maxp = -(-cap // ps)
        npg = (cnt.long() + ps - 1) // ps
        n_ = int(npg.sum())
        total = 2 * n_ + 3
        pids = 1 + torch.randperm(total - 1, device=dev, generator=gen_p)[:n_]
        cells = torch.repeat_interleave(torch.arange(k_, device=dev), npg)
        pg = torch.arange(n_, device=dev) - torch.repeat_interleave(
            torch.cumsum(npg, 0) - npg, npg)
        table = torch.zeros((k_ + 1, maxp), dtype=torch.int32, device=dev)
        table[cells, pg] = pids.to(torch.int32)
        pools = []
        for a, fill in zip(arrays, fills):
            slots = torch.full((k_, maxp * ps, *a.shape[2:]), fill,
                               dtype=a.dtype, device=dev)
            slots[:, :cap] = a
            pool = torch.randint(-100, 100, (total, ps, *a.shape[2:]),
                                 device=dev, generator=gen_p).to(a.dtype)
            pool[0] = fill
            pool[pids] = slots.reshape(k_, maxp, ps, *a.shape[2:])[cells, pg]
            pools.append(pool)
        return pools, table

    def logical_block(rows, table, counts, probe, width, fill):
        """The ``(B, nprobe * width, ...)`` block of the probed cells' slots
        gathered through the page table, ``fill`` on every slot at or past
        its cell's count (the sentinel's all): what a store scan computes
        on."""
        page, row = fp._slot_pages(rows, table, probe, width)
        blk = rows[page, row]
        dead = (torch.arange(width, device=dev)
                >= counts[probe.long()].unsqueeze(-1))
        blk = torch.where(dead.reshape(*dead.shape, *([1] * (blk.ndim - 3))),
                          torch.full_like(blk, fill), blk)
        return blk.reshape(probe.shape[0], -1, *rows.shape[2:])

    def paged_store_check(q, rows, table, counts, probe, width, l, tag,
                          splits=None, padded=None):
        """The store scan through a page table against its plain version,
        scored on the table-gathered block; against the grouped kernel on
        that block and, where ``padded`` (the same cells' (K, cap, d) store)
        is given, against the padded scan, both bit for bit."""
        cand = logical_block(rows, table, counts, probe, width, PAD)
        score, mag = scan_scores(q, cand)
        exp = fp.flash_probe_store_plain(q, rows, counts, probe, width, l,
                                         PAD, table)
        got = ops.flash_probe_store(q, rows, counts, probe, table=table,
                                    width=width, l=l, pad=PAD, splits=splits,
                                    want_dists=False)
        kname = "flash_probe_store (paged)"
        topl_check(kname, tag, got, exp, score, mag, q.shape[1])
        refs = [("the grouped kernel's on the table-gathered block",
                 ops.flash_probe_grouped(q, cand, l=l, want_dists=False))]
        if padded is not None:
            refs.append(("the padded scan's over the same rows",
                         ops.flash_probe_store(q, padded, counts, probe,
                                               width=width, l=l, pad=PAD,
                                               splits=splits,
                                               want_dists=False)))
        for how, ref_ in refs:
            check(torch.equal(got[0], ref_[0])
                  and torch.equal(got[1], ref_[1]),
                  f"{kname} {tag}: indices and scores equal {how}, bit for "
                  f"bit ({int((got[0] != ref_[0]).sum())} indices differ)")
        return got

    def paged_q8_store_check(q, codes, scales, table, counts, probe, anchors,
                             width, l, tag, splits=None, padded=None):
        """The q8 store scan through a page table, as ``paged_store_check``:
        against its plain version, the block kernel on the table-gathered
        codes and scales and, with ``padded`` ((K, cap, d) codes, (K, cap)
        scales), the padded scan, bit for bit, +inf entries included."""
        b, nprobe = probe.shape
        d = codes.shape[-1]
        cb = logical_block(codes, table, counts, probe, width, 0).reshape(
            b, nprobe, width, d)
        sb = logical_block(scales, table, counts, probe, width, 0.0).reshape(
            b, nprobe, width)
        qp = q.float().unsqueeze(1) - anchors[probe.long()]
        score, mag = q8_scores(qp, cb, sb)
        exp = fp.flash_probe_store_q8_plain(qp, codes, scales, counts, probe,
                                            width, l, table)
        got = ops.flash_probe_store_q8(q, codes, scales, counts, probe,
                                       anchors, table=table, width=width,
                                       l=l, splits=splits)
        kname = "flash_probe_store_q8 (paged)"
        topl_check(kname, tag, got, exp, score, mag, d)
        refs = [("the block kernel's on the table-gathered block",
                 ops.flash_probe_grouped_q8(qp, cb, sb, l=l))]
        if padded is not None:
            refs.append(("the padded scan's over the same rows",
                         ops.flash_probe_store_q8(q, *padded, counts, probe,
                                                  anchors, width=width, l=l,
                                                  splits=splits)))
        for how, ref_ in refs:
            check(torch.equal(got[0], ref_[0])
                  and torch.equal(got[1], ref_[1]),
                  f"{kname} {tag}: indices and distances equal {how}, bit "
                  f"for bit, +inf entries included "
                  f"({int((got[0] != ref_[0]).sum())} indices differ)")
        return got

    def insert_state(cache):
        return [cache.keys, cache.rows, cache.ref, cache.hand]

    def insert_check(state, ids, x, tag):
        """The rescore cache's insert on a copy of ``state`` (keys, rows,
        ref, hand) against its plain version on another copy: keys, ref
        bits and hands equal, rows equal on live lanes. Returns the
        kernel's state."""
        got = [t.clone() for t in state]
        exp = [t.clone() for t in state]
        rck.cache_insert_raw(*got, ids, x)
        order, seg = rck.group_by_set(ids, state[0].shape[0])
        rck.cache_insert_plain(*exp, ids, x, order, seg)
        live = exp[0] >= 0
        err = float((got[1] - exp[1])[live].abs().max()) if bool(
            live.any()) else 0.0
        same = [torch.equal(got[i], exp[i]) for i in (0, 2, 3)]
        ok = all(same) and torch.equal(got[1][live], exp[1][live])
        max_err["rescore_cache_insert"] = max(
            max_err["rescore_cache_insert"], err)
        rec = {"kernel": "rescore_cache_insert", "at": tag,
               "shape": [*state[1].shape, int(ids.shape[0])],
               "live_lanes": int(live.sum()), "max_abs_err": err,
               "keys_ref_hand_equal": same, "ok": ok}
        details["kernel_checks"].append(rec)
        check(ok, f"rescore_cache_insert {tag}: keys, ref, hand equal the "
                  f"plain version's {same}, rows on {int(live.sum())} live "
                  f"lanes equal (max err {err:.3g})")
        return got

    # ---- FlashIVF helpers: the corpus's own exact neighbours --------------
    def corpus_topk(x, q, topk):
        """Exact top-``topk`` of ``||x - q||^2`` over the corpus rows, with
        ids = row positions (the ids ``build`` gives them): the fp32
        expanded form and a stable ascending sort, queries in chunks whose
        score matrix has at most ``PLAIN_ELEMS`` entries."""
        xsq = (x * x).sum(-1)
        step = max(1, PLAIN_ELEMS // x.shape[0])
        ids, dd = [], []
        for s in range(0, q.shape[0], step):
            qc = q[s:s + step].float()
            sc = xsq - 2.0 * (qc @ x.t()) + (qc * qc).sum(-1, keepdim=True)
            v, i = torch.sort(sc, dim=1, stable=True)
            ids.append(i[:, :topk].to(torch.int32))
            dd.append(v[:, :topk])
            del sc, v, i
        return torch.cat(ids), torch.cat(dd)

    def truth_check(tag, ids, dd, x, q, ref_ids, exact=True):
        """Search results ``(ids, dd)`` held against the corpus: each
        distance equals the float64 distance from the query to the corpus
        row of its id (so ids are bound to the right rows), within the fp32
        worst case ``2 d u (|q| + max |x|)^2``; with ``exact``, ids equal
        ``ref_ids`` except on near-ties inside that bound."""
        q64 = q.double().unsqueeze(1)
        d = x.shape[1]

        def true_d(i):
            return ((x[i.long().clamp(0, x.shape[0] - 1)].double() - q64)
                    ** 2).sum(-1)
        mag = (q.norm(dim=-1).max() + x.norm(dim=-1).max()) ** 2
        tol = float(2 * d * U32 * mag)
        d_got = true_d(ids)
        err = float((dd.double() - d_got).abs().max())
        diff = ids != ref_ids
        gap = float((d_got - true_d(ref_ids)).abs()[diff].max()) \
            if bool(diff.any()) else 0.0
        in_range = bool(((ids >= 0) & (ids < x.shape[0])).all())
        ok = in_range and err <= tol and (not exact or gap <= tol)
        rec = {"at": tag, "dist_err": err, "tol": tol,
               "mismatches": int(diff.sum()), "tie_gap": gap}
        details["ivf_truth"].append(rec)
        check(ok, f"{tag}: dists == true distances of their ids' corpus "
                  f"rows (err {err:.3g})" + (
                      f", {int(diff.sum())} id mismatches (gap {gap:.3g})"
                      if exact else "") + f" <= tol {tol:.3g}")
        return rec

    # ---- phase 2a: ragged and degenerate shapes, every kernel ------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print("\n[ragged shapes]", flush=True)
    for b, n, k, d in RAGGED:
        for cdt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n, d, device=dev, generator=gen).to(cdt)
            c = torch.randn(b, k, d, device=dev, generator=gen).to(cdt)
            a = lloyd_check(x, c, f"ragged{(b, n, k, d)}")
            ids = a + k * torch.arange(b, device=dev,
                                       dtype=torch.int32).unsqueeze(1)
            siu_check(x.reshape(-1, d), ids.reshape(-1), b * k,
                      f"ragged{(b, n, k, d)}")

    print("\n[FlashProbe ragged shapes]", flush=True)
    for n, k, d, l, dup in PROBE_RAGGED:
        for cdt in (torch.float32, torch.bfloat16):
            q = torch.randn(n, d, device=dev, generator=gen).to(cdt)
            c = torch.randn(k, d, device=dev, generator=gen)
            if dup:   # every centroid three times
                c = torch.cat([c[:k // 3]] * 3)
            for splits in (None, 3):
                probe_check(q, c.to(cdt), l, f"ragged{(n, k, d, l)}/"
                            f"{cdt}/splits={splits or 'planned'}", splits,
                            list_too=splits is None)
    for b, cn, d, l, npad, dup in SCAN_RAGGED:
        for cdt in (torch.float32, torch.bfloat16):
            q = torch.randn(b, d, device=dev, generator=gen)
            c = torch.randn(b, cn, d, device=dev, generator=gen)
            if dup:
                c[:, cn // 2:] = c[:, :cn // 2]
            if npad:
                rows = torch.randperm(cn, device=dev, generator=gen)[:npad]
                c[:, rows] = PAD
            for splits in (None, 3):
                scan_check(q.to(cdt), c.to(cdt), l, f"ragged{(b, cn, d, l)}/"
                           f"pad={npad}/{cdt}/splits={splits or 'planned'}",
                           splits)
    for b, p, w, d, l, dup in Q8_RAGGED:
        qp = torch.randn(b, p, d, device=dev, generator=gen)
        codes = torch.randint(-127, 128, (b, p, w, d), device=dev,
                              generator=gen).to(torch.int8)
        scales = torch.rand(b, p, w, device=dev, generator=gen) * 0.02 + 1e-3
        scales[torch.rand(b, p, w, device=dev, generator=gen) < 0.3] = 0.0
        scales[0] = 0.0          # query 0: fewer live slots than L
        scales[0, 0, :min(2, w)] = 1e-2
        if dup:
            codes[:, :, w // 2:] = codes[:, :, :w // 2]
            scales[:, :, w // 2:] = scales[:, :, :w // 2]
        for splits in (None, 3):
            q8_check(qp, codes, scales, l, f"ragged{(b, p, w, d, l)}/"
                     f"splits={splits or 'planned'}", splits)
    # the new edges draw from a generator of their own, so that the data of
    # the later phases does not depend on them
    gen_e = torch.Generator(device=dev).manual_seed(SEED + 2)
    gen_p = torch.Generator(device=dev).manual_seed(SEED + 16)  # page ids
    print("\n[FlashProbe tile edges]", flush=True)
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_tile, n0 = 0, fp.launches["flash_probe_tile"]
    for b, k, row in PROBE_TILE_EDGE:
        for cdt in (torch.float32, torch.bfloat16):
            isz = 2 if cdt == torch.bfloat16 else 4
            d = row if isinstance(row, int) else int(row.split()[0]) // isz
            q = torch.randn(b, d, device=dev, generator=gen_t).to(cdt)
            c = torch.randn(k, d, device=dev, generator=gen_t)
            if b == 17:
                c[k // 2:2 * (k // 2)] = c[:k // 2]
            for l in (l_ for l_ in TILE_L if l_ <= k):
                for cl in (None, 2, 8):
                    probe_check(q, c.to(cdt), l, f"tile edge{(b, k, d, l)}/"
                                f"{cdt}/cluster={cl or 'planned'}"
                                + ("/duplicated" if b == 17 else ""),
                                cluster=cl, list_too=cl is None)
                    n_tile += 1
    # q and c off 16 bytes: copied, then the tile mode
    qu = torch.randn(17 * 128 + 1, device=dev, generator=gen_t)[1:]
    cu = torch.randn(1025 * 128 + 1, device=dev, generator=gen_t)[1:]
    probe_check(qu.view(17, 128), cu.view(1025, 128), 16,
                "tile edge(17, 1025, 128, 16)/unaligned q and c",
                list_too=True)
    n_tile += 1
    check(fp.launches["flash_probe_tile"] - n0 == n_tile,
          f"flash_probe_tile: every tile edge took the tile mode "
          f"({fp.launches['flash_probe_tile'] - n0} of {n_tile} launches)")

    print("\n[grouped scan warp edges]", flush=True)
    n_warp, n0 = 0, fp.launches["flash_probe_grouped_warp"]
    warp_cases = [(cn, l, 128) for cn in WARP_C for l in WARP_L if l <= cn]
    warp_cases += [(41, 10, d) for d in WARP_D]
    for cn, l, d in warp_cases:
        q = torch.randn(33, d, device=dev, generator=gen_t)
        c = torch.randn(33, cn, d, device=dev, generator=gen_t)
        if cn >= 40:       # duplicated rows: the lower-index rule
            c[:, cn // 2:2 * (cn // 2)] = c[:, :cn // 2]
        if cn >= 10:       # store padding rows
            rows = torch.randperm(cn, device=dev, generator=gen_t)[:cn // 8]
            c[:, rows] = PAD
        for cdt in (torch.float32, torch.bfloat16):
            if (d * (2 if cdt == torch.bfloat16 else 4)) % 16:
                continue
            scan_check(q.to(cdt), c.to(cdt), l, f"warp edge{(33, cn, d, l)}/"
                       f"{cdt}", 3)
            n_warp += 1
    # q and the blocks off 16 bytes: copied, then the warp mode
    qu = torch.randn(33 * 128 + 1, device=dev, generator=gen_t)[1:]
    cu = torch.randn(33 * 40 * 128 + 1, device=dev, generator=gen_t)[1:]
    scan_check(qu.view(33, 128), cu.view(33, 40, 128), 10,
               "warp edge(33, 40, 128, 10)/unaligned q and c", 3)
    n_warp += 1
    check(fp.launches["flash_probe_grouped_warp"] - n0 == n_warp,
          f"flash_probe_grouped_warp: every warp edge took the warp mode "
          f"({fp.launches['flash_probe_grouped_warp'] - n0} of {n_warp} "
          f"launches)")
    print("\n[sort-inverse edges]", flush=True)
    for r, segs, d, kind, chunk in SIU_EDGE:
        for cdt in (torch.float32, torch.bfloat16):
            x2 = torch.randn(r, d, device=dev, generator=gen_e).to(cdt)
            ids = (torch.ones(r, dtype=torch.int32, device=dev)
                   if kind == "equal" else torch.randint(
                       0, segs, (r,), device=dev, generator=gen_e,
                       dtype=torch.int32))
            siu_check(x2, ids, segs, f"edge(R={r}, S={segs}, d={d}, {kind})",
                      chunk=chunk, threads=siu.THREADS)
    for cdt in (torch.float32, torch.bfloat16):
        # batched ids through the wrapper (offset by b * K, one launch)
        b, n, k, d = 3, 2000, 40, 128
        x = torch.randn(b, n, d, device=dev, generator=gen_e).to(cdt)
        a = torch.randint(0, k, (b, n), device=dev, generator=gen_e,
                          dtype=torch.int32)
        s_b, c_b = ops.sort_inverse_update_batched(x, a, k=k)
        ids = a + k * torch.arange(b, device=dev,
                                   dtype=torch.int32).unsqueeze(1)
        siu_check(x.reshape(-1, d), ids.reshape(-1), b * k,
                  f"edge batched(B={b}, N={n}, K={k})",
                  got=(s_b.reshape(b * k, d), c_b.reshape(-1)))
        # an x that is not 16-byte aligned: the scalar path at d = 128
        buf = torch.randn(4000 * 128 + 1, device=dev, generator=gen_e).to(cdt)
        x2 = buf[1:].view(4000, 128)
        ids = torch.randint(0, 100, (4000,), device=dev, generator=gen_e,
                            dtype=torch.int32)
        siu_check(x2, ids, 100, "edge unaligned x (R=4000, S=100, d=128)",
                  chunk=256, threads=siu.THREADS)

    print("\n[FlashLloyd edges]", flush=True)
    gen_l = torch.Generator(device=dev).manual_seed(SEED + 3)
    for b, n, k, d, kind, cl in LLOYD_EDGE:
        for cdt in (torch.float32, torch.bfloat16):
            isz = 2 if cdt == torch.bfloat16 else 4
            if kind == "window":   # the largest K of cluster size cl
                k = H.max_fused_k(d, isz, cl, H.H100)
            if kind == "few":      # every row near one of 3 centroids
                c = torch.randn(b, k, d, device=dev, generator=gen_l) * 2.0
                lab = torch.randint(0, 3, (b, n), device=dev, generator=gen_l)
                x = torch.stack([c[i, lab[i]] for i in range(b)]) + 0.1 * \
                    torch.randn(b, n, d, device=dev, generator=gen_l)
            else:
                x = torch.randn(b, n, d, device=dev, generator=gen_l)
                c = torch.randn(b, k, d, device=dev, generator=gen_l)
            lloyd_check(x.to(cdt), c.to(cdt), f"edge{(b, n, k, d)}/{kind}",
                        cluster=cl, near=kind == "few")

    print("\n[store scan edges]", flush=True)
    for bq, kc, cap, width, d, nprobe, l in STORE_EDGE:
        cnt = torch.randint(0, width + 1, (kc,), device=dev, generator=gen_e)
        cnt[0], cnt[1], cnt[2], cnt[3], cnt[4] = 0, width, cap, 1, 2
        xs = torch.randn(kc, cap, d, device=dev, generator=gen_e)
        n56 = int(torch.minimum(cnt[5], cnt[6]))
        xs[6, :n56] = xs[5, :n56]                    # duplicated rows
        xs[torch.arange(cap, device=dev)[None, :] >= cnt[:, None]] = PAD
        probe = torch.argsort(torch.rand(bq, kc, device=dev, generator=gen_e),
                              dim=1)[:, :nprobe]
        probe[0] = torch.argsort(cnt, stable=True)[:nprobe]   # emptiest
        probe = probe.to(torch.int32).contiguous()
        counts = cnt.to(torch.int32)
        q = torch.randn(bq, d, device=dev, generator=gen_e)
        live0 = int(torch.clamp(cnt[probe[0].long()], max=width).sum())
        for cdt in (torch.float32, torch.bfloat16):
            for splits in (None, 1, 3):
                store_check(q.to(cdt), xs.to(cdt), counts, probe, width, l,
                            f"edge{(bq, kc, cap, width, d, nprobe, l)}/"
                            f"query0 live {live0}/{cdt}/"
                            f"splits={splits or 'planned'}", splits)
        # the same cells on pages, the sentinel cell K in query 1's list
        cs = torch.cat([counts, counts.new_zeros(1)])
        pr = probe.clone()
        pr[min(1, bq - 1), -1] = kc
        for ps in PAGE_SIZES:
            (pool,), table = paged_layout((xs,), (PAD,), cnt, ps)
            for cdt in (torch.float32, torch.bfloat16):
                for splits in (None, 3):
                    paged_store_check(
                        q.to(cdt), pool.to(cdt), table, cs, pr, width, l,
                        f"edge{(bq, kc, cap, width, d, nprobe, l)}/page {ps}"
                        f"/{cdt}/splits={splits or 'planned'}", splits,
                        padded=xs.to(cdt))

    print("\n[q8 store scan edges]", flush=True)
    for bq, kc, cap, width, d, nprobe, l in QSTORE_EDGE:
        cnt = torch.randint(0, width + 1, (kc,), device=dev, generator=gen_e)
        cnt[0], cnt[1], cnt[2], cnt[3], cnt[4] = 0, width, cap, 1, 2
        dead = torch.arange(cap, device=dev)[None, :] >= cnt[:, None]
        codes = torch.randint(-127, 128, (kc, cap, d), device=dev,
                              generator=gen_e).to(torch.int8)
        scales = torch.rand(kc, cap, device=dev, generator=gen_e) * 0.02 + 1e-3
        scales[torch.rand(kc, cap, device=dev, generator=gen_e) < 0.05] = 0.0
        n56 = int(torch.minimum(cnt[5], cnt[6]))
        codes[6, :n56] = codes[5, :n56]              # duplicated rows
        scales[6, :n56] = scales[5, :n56]
        codes[dead] = 0
        scales[dead] = 0.0
        anchors = torch.randn(kc, d, device=dev, generator=gen_e)
        anchors[6] = anchors[5]                      # so they tie exactly
        probe = torch.argsort(torch.rand(bq, kc, device=dev, generator=gen_e),
                              dim=1)[:, :nprobe]
        probe[0] = torch.argsort(cnt, stable=True)[:nprobe]   # emptiest
        probe = probe.to(torch.int32).contiguous()
        counts = cnt.to(torch.int32)
        q = torch.randn(bq, d, device=dev, generator=gen_e) * 0.02
        live0 = int(torch.clamp(cnt[probe[0].long()], max=width).sum())
        for splits in (None, 1, 3):
            q8_store_check(q, codes, scales, counts, probe, anchors, width, l,
                           f"edge{(bq, kc, cap, width, d, nprobe, l)}/query0 "
                           f"live {live0}/splits={splits or 'planned'}",
                           splits)
        # the same cells on pages, the sentinel cell K in query 1's list
        cs = torch.cat([counts, counts.new_zeros(1)])
        anc = torch.cat([anchors, anchors.new_zeros((1, d))])
        pr = probe.clone()
        pr[min(1, bq - 1), -1] = kc
        for ps in PAGE_SIZES:
            (pc, pa), table = paged_layout((codes, scales), (0, 0.0), cnt, ps)
            for splits in (None, 3):
                paged_q8_store_check(
                    q, pc, pa, table, cs, pr, anc, width, l,
                    f"edge{(bq, kc, cap, width, d, nprobe, l)}/page {ps}/"
                    f"splits={splits or 'planned'}", splits,
                    padded=(codes, scales))

    def aligned(shape, g):
        """Values in [1, 1 + 1/16) with the low 13 mantissa bits 0x0fff:
        ``cvt.rna.tf32`` rounds each down by almost half its ulp."""
        v = 1.0 + torch.rand(shape, device=dev, generator=g) / 16
        return ((v.view(torch.int32) & -0x2000) | 0x0fff).view(torch.float32)

    print("\n[FlashAssign edges]", flush=True)
    gen_c = torch.Generator(device=dev).manual_seed(SEED + 1)
    for (b, n, k, d, kind), g in ([(e, gen) for e in ASSIGN_EDGE]
                                  + [(e, gen_c) for e in CONTROL_EDGE]):
        for cdt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n, d, device=dev, generator=g)
            c = torch.randn(b, k, d, device=dev, generator=g)
            if kind == "duplicated":
                c[:, k // 2:2 * (k // 2)] = c[:, :k // 2]
            elif kind == "far":   # the last problem far from the origin
                x[-1] += 100.0
                c[-1] += 100.0
            elif kind == "aligned":
                x, c = aligned(x.shape, g), aligned(c.shape, g)
            tag = f"edge{(b, n, k, d)}/{kind}"
            a = assign_check(x.to(cdt), c.to(cdt), tag)
            if cdt == torch.float32 and kind in ("far", "aligned"):
                assign_control(x, c, tag, g is gen_c)
            if kind == "duplicated":
                h = k // 2
                check(not bool(((a >= h) & (a < 2 * h)).any()),
                      f"flash_assign edge{(b, n, k, d)} {cdt}: no id on the "
                      "upper copy of a duplicated centroid")
    print("\n[rescore cache insert edges]", flush=True)
    gen_i = torch.Generator(device=dev).manual_seed(SEED + 8)
    for sets, ways, d, m, top, kind in INSERT_EDGE:
        state = [torch.full((sets, ways), -1, dtype=torch.int32, device=dev),
                 torch.zeros((sets, ways, d), device=dev),
                 torch.zeros((sets, ways), dtype=torch.int32, device=dev),
                 torch.zeros((sets,), dtype=torch.int32, device=dev)]
        for step in range(2):   # the second batch meets the first's lanes
            ids = torch.randint(-1, top, (m,), device=dev, generator=gen_i,
                                dtype=torch.int32)
            x = torch.randn(m * d + 1, device=dev, generator=gen_i)
            x = (x[1:] if kind == "unaligned" else x[:-1]).view(m, d)
            state = insert_check(state, ids, x, f"edge{(sets, ways, d, m)}/"
                                 f"{kind}/batch {step}")

    if args.kernels_only:
        if failures:
            print(f"\nchip_smoke: {len(failures)} check(s) failed",
                  file=sys.stderr)
            return 1
        print(f"\nchip_smoke --kernels-only: all "
              f"{len(details['kernel_checks'])} kernel checks passed")
        return 0

    def graph_ms(fn, n=50):
        """Device time of one call of ``fn`` inside a CUDA graph of ``n``
        back-to-back calls (CUDA events around a replay, the least of 3):
        no host time between the launches, and no profiler."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        best = float("inf")
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / n)
        del graph
        return best

    def device_ms_of(fn, reps=10):
        """Device time of one call of ``fn`` (all its kernels), from the
        profiler, after a warm-up: the event time of back-to-back calls
        is the host's launch rate where a call's kernels are short."""
        fn()
        torch.cuda.synchronize()
        return sum(r["ms"] for r in device_rows(fn, reps))

    def profile_steps(label, step, reps=3):
        """Device time by kernel per call of ``step``, beside the CUDA-event
        time of a call, so that what the kernel table does not time shows
        by name. Returns the record."""
        step()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step()
        e1.record()
        torch.cuda.synchronize()
        rows = device_rows(step, reps)
        busy = sum(r["ms"] for r in rows)
        launches_ = sum(r["calls"] for r in rows)
        call_ms = e0.elapsed_time(e1)
        print(f"  profile {label}: {call_ms:.3f} ms a call (CUDA events), "
              f"device busy {busy:.3f} ms in {launches_:g} launches of "
              f"{len(rows)} kernels; idle {max(0.0, call_ms - busy):.3f} ms",
              flush=True)
        for r in rows[:14]:
            print(f"    {r['ms']:.4f} ms  x{r['calls']:g}  {r['name'][:100]}")
        rec = {"at": label, "call_ms": call_ms, "device_busy_ms": busy,
               "launches": launches_, "kernels": rows}
        details["profiles"].append(rec)
        return rec

    def no_x_pass(rec, x, k):
        """A two-pass iteration's profile: none of PyTorch's elementwise or
        reduction kernels takes a quarter of the time of one read of x at
        the card's memory rate: FlashAssign returns the distances, so no
        pass adds ||x||^2 after it. The kernels are only listed where one
        read of x takes under 0.1 ms (a kernel's device time is then mostly
        its latency: the inertia's sum of N scores takes 0.012 ms at N =
        65,536) or where the (K, d) centroids are more than a sixteenth of
        x (finalize_centroids' passes over them then take as long)."""
        read = x.numel() * x.element_size() / HBM_BW * 1e3
        big = [(r["name"][:70], round(r["ms"], 4)) for r in rec["kernels"]
               if ("elementwise" in r["name"] or "reduce_kernel" in r["name"])
               and r["ms"] > 0.25 * read]
        if read < 0.1 or 16 * k > x.shape[-2]:
            print(f"  read {rec['at']}: one read of x {read:.4f} ms; PyTorch "
                  f"kernels over a quarter of it: {big}", flush=True)
            return
        check(not big, f"{rec['at']}: no elementwise or reduction kernel over "
                       f"{0.25 * read:.4f} ms, a quarter of one read of x (no "
                       f"||x||^2 pass): {big}")

    # ---- phases 2-3: per regime, compare, then drive the main path ------
    for name, n, k, d, b, dt, iters in REGIMES:
        dtype = getattr(torch, dt)
        print(f"\n[{name}] N={n} K={k} d={d} B={b} {dt}, {iters} Lloyd "
              f"iteration(s)", flush=True)
        if name == "largeN_largeK":
            print(f"  N cut from {LARGE_K_FULL_N} to {n} so that the "
                  "fp32 FlashAssign fits the run's time", flush=True)
        x = mixture(b, n, k, d, gen).to(dtype)
        c0 = torch.stack([x[i, torch.randperm(n, device=dev, generator=gen)
                            [:k]] for i in range(b)])
        # phase 2: each kernel against its plain version, f32 and bf16,
        # over every row of the run; the sort-inverse update from the
        # checked ids with the planner's blocks, as the two-pass path runs it
        blk = KMeansConfig(k=k).blocks_for(n, d, x.element_size(), dev)
        for cdt in (torch.float32, torch.bfloat16):
            xc, cc = x.to(cdt), c0.to(cdt)
            if H.choose_lloyd_cluster(k, d, xc.element_size(),
                                      P.detect_hardware(dev)) is not None:
                a_k = lloyd_check(xc, cc, name)   # with FlashAssign's check
            else:
                a_k = assign_check(xc, cc, name)
            if cdt == dtype:
                ids = (a_k + k * torch.arange(
                    b, device=dev, dtype=torch.int32).unsqueeze(1))
                siu_check(x.reshape(-1, d), ids.reshape(-1), b * k, name,
                          chunk=blk.update_block_n,
                          threads=blk.update_block_k)
                del ids
            if cdt == dtype == torch.float32:
                assign_control(xc, cc, name, name == CONTROL_REGIME)
            del xc, cc, a_k
        torch.cuda.synchronize()

        # phase 3: the main path, counted: the planner's choice (auto), and
        # at smallN_smallK also the fused path, which a user asks for with
        # step_impl="fused", so that FlashLloyd stays driven
        def drive(step_impl):
            """fit (or fit_batched) from c0, then iters + 1 online steps from
            c0: per-iteration inertia and device time (the first step is the
            warm-up)."""
            km = KMeans(KMeansConfig(k=k, max_iters=iters, tol=0.0,
                                     step_impl=step_impl))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = km.fit(x[0], c0=c0[0]) if b == 1 else km.fit_batched(x, c0=c0)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            c, traj, step_ms = c0 if b > 1 else c0[0], [], []
            for it in range(iters + 1):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                if b == 1:
                    c, _, j = km.iterate(x[0], c)
                else:
                    c, _, j = km.iterate_batched(x, c)
                e1.record()
                torch.cuda.synchronize()
                traj.append(j.float().reshape(-1).cpu())
                if it > 0:
                    step_ms.append(e0.elapsed_time(e1))
            return km, st, fit_s, traj, statistics.median(step_ms), step_ms

        def check_path(label, impl, km, st, fit_s, traj, ms_iter, step_ms,
                       counts):
            need = (["flash_lloyd"] if impl == "fused" else
                    ["flash_assign", "sort_inverse_update"])
            idle = (["flash_assign", "sort_inverse_update"] if impl == "fused"
                    else ["flash_lloyd"])
            check(all(counts[kn] > 0 for kn in need)
                  and all(counts[kn] == 0 for kn in idle),
                  f"{label}: kernels launched: {counts}")
            fin = bool(torch.isfinite(st.centroids.float()).all()) and bool(
                torch.isfinite(st.inertia).all())
            shapes = (tuple(st.centroids.shape) == ((k, d) if b == 1 else
                                                     (b, k, d))
                      and tuple(st.assignments.shape) == ((n,) if b == 1 else
                                                          (b, n)))
            check(fin and shapes, f"{label}: fit state finite with the "
                  f"expected shapes (iterations {st.iteration.tolist()})")
            ok_a = bool(((st.assignments >= 0) & (st.assignments < k)).all())
            check(ok_a, f"{label}: assignments in [0, K)")
            rtol = 1e-5 if dt == "float32" else 1e-3
            rising = [(t, (traj[t + 1] - traj[t]).max().item())
                      for t in range(len(traj) - 1)
                      if bool((traj[t + 1] > traj[t] * (1 + rtol)).any())]
            check(not rising, f"{label}: inertia does not rise over "
                  f"{len(traj)} steps (rtol {rtol}): "
                  f"{[float(t[0]) for t in traj]}")
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            print(f"  {label}: fit {fit_s:.3f} s host wall for {iters} "
                  f"iteration(s); {ms_iter:.3f} ms per Lloyd iteration (CUDA "
                  f"events, median of {len(step_ms)} after a warm-up); peak "
                  f"{peak_gib:.2f} GiB", flush=True)
            details["regimes"].append(
                {"name": name, "N": n, "K": k, "d": d, "B": b, "dtype": dt,
                 "impl": impl, "step_impl": label,
                 "fit_iterations": st.iteration.tolist(),
                 "fit_host_s": fit_s, "ms_per_iteration": ms_iter,
                 "step_ms": step_ms, "inertia": [t.tolist() for t in traj],
                 "launches": counts, "peak_gib": peak_gib})

        isz = x.element_size()
        hw_ = P.detect_hardware(dev)
        impl = KMeansConfig(k=k).resolved_step_impl(n, d, isz, device=dev)
        want = H.choose_step_impl(n, k, d, dtype_bytes=isz, hw=hw_)
        check(impl == want, f"step_impl auto -> {impl} (the planner's "
                            f"choice {want})")
        zero_counts()
        km, st, fit_s, traj, ms_iter, step_ms = drive("auto")
        counts = read_counts()
        for kname in mods:
            launches[kname] += counts[kname]
        check_path("auto", impl, km, st, fit_s, traj, ms_iter, step_ms,
                   counts)
        if (name, dt) == ("largeN_smallK", "bfloat16"):   # by kernel
            profile_steps(f"{name}/{dt} iterate ({impl})",
                          lambda: km.iterate(x[0], c0[0]))
        if (name, dt) == ("smallN_smallK", "float32"):
            # the other entry points, counted on their own: fits that draw
            # their own start on the card, and predict (FlashAssign)
            zero_counts()
            for init in ("random", "kmeans++"):
                g1 = torch.Generator(device=dev).manual_seed(SEED + 1)
                s2 = KMeans(KMeansConfig(k=k, max_iters=3, init=init)).fit(
                    x[0], generator=g1)
                check(bool(torch.isfinite(s2.inertia))
                      and int(s2.iteration) >= 1,
                      f"fit(init={init!r}) finite, {int(s2.iteration)} "
                      "iterations")
            pred = km.predict(x[0], st.centroids)
            counts_e = read_counts()
            for kname in mods:
                launches[kname] += counts_e[kname]
            details["regimes"][-1]["launches_other_entry_points"] = counts_e
            check(counts_e["flash_assign"] > 0,
                  f"fit(init=...) and predict: kernels launched: {counts_e}")
            # the path auto did not take, which a user asks for with
            # step_impl, counted too, so that both paths stay driven
            other = "two_pass" if impl == "fused" else "fused"
            zero_counts()
            km_o, st_o, *rest = drive(other)
            counts_o = read_counts()
            for kname in mods:
                launches[kname] += counts_o[kname]
            check_path(other, other, km_o, st_o, *rest, counts_o)
            # predict (FlashAssign) against the fused step's ids (FlashLloyd)
            # on the same centroids: the same argmin, so equal bit for bit
            km_f = km if impl == "fused" else km_o
            _, a_fused, _ = km_f.iterate(x[0], st.centroids)
            n_diff = int((pred != a_fused).sum())
            details["regimes"][-1]["predict_ids_differ_from_fused"] = n_diff
            check(n_diff == 0, f"predict ids == the fused step's ids bit for "
                               f"bit ({n_diff} differ)")
            del km_o, st_o, rest, a_fused, pred, km_f
        cl_ = H.choose_lloyd_cluster(k, d, isz, hw_)
        if cl_ is not None:
            # the planner's rule where fused is feasible: two-pass against
            # fused, alternating (A B A B ...), each sample the median of 10
            # event-timed iterate calls from c0 after a warm-up; auto must
            # take the path that wins most of the pairs
            kms = {impl_: KMeans(KMeansConfig(k=k, step_impl=impl_))
                   for impl_ in ("two_pass", "fused")}

            def one_iterate(km_):
                if b == 1:
                    km_.iterate(x[0], c0[0])
                else:
                    km_.iterate_batched(x, c0)

            def iter_ms(km_):
                t = []
                for _ in range(10):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    one_iterate(km_)
                    e1.record()
                    torch.cuda.synchronize()
                    t.append(e0.elapsed_time(e1))
                return statistics.median(t)
            for km_ in kms.values():
                iter_ms(km_)
            pairs = [(iter_ms(kms["two_pass"]), iter_ms(kms["fused"]))
                     for _ in range(STEP_PAIRS)]
            med = [statistics.median(p[i] for p in pairs) for i in (0, 1)]
            fused_wins = sum(f < t for t, f in pairs)
            winner = "fused" if 2 * fused_wins > STEP_PAIRS else "two_pass"
            print(f"  two-pass vs fused (C={cl_}), {STEP_PAIRS} alternating "
                  f"pairs (ms per iterate): "
                  f"{[(round(t, 4), round(f, 4)) for t, f in pairs]}; "
                  f"medians {med[0]:.4f} / {med[1]:.4f}; fused won "
                  f"{fused_wins} of {STEP_PAIRS}", flush=True)
            # each path by kernel: launches per iteration and device time
            prof = {impl_: profile_steps(f"{name}/{dt} iterate ({impl_})",
                                         lambda km_=km_: one_iterate(km_))
                    for impl_, km_ in kms.items()}
            no_x_pass(prof["two_pass"], x, k)
            check(impl == winner, f"{name}/{dt}: auto picks {impl}, the "
                  f"winner of most of the {STEP_PAIRS} pairs ({winner}: "
                  f"fused won {fused_wins})")
            details["step_pairs"].append(
                {"regime": name, "dtype": dt, "cluster": cl_, "auto": impl,
                 "pairs_ms": pairs, "median_ms": med,
                 "fused_wins": fused_wins, "winner": winner,
                 "launches": {k_: v["launches"] for k_, v in prof.items()},
                 "device_busy_ms": {k_: v["device_busy_ms"]
                                    for k_, v in prof.items()}})
            del kms, prof

        else:   # two-pass only: its profile, for the same check
            no_x_pass(profile_steps(
                f"{name}/{dt} iterate (two_pass)",
                lambda: km.iterate(x[0], c0[0]) if b == 1
                else km.iterate_batched(x, c0), reps=1), x, k)

        # kernel times at this regime's shapes (after the counted runs)
        xb, cb = x, c0
        tag = f"{name}/{dt}"

        def assign_plain_chunked(xb=xb, cb=cb):
            for bs, rs in plain_chunks(xb.shape[0], xb.shape[1],
                                       cb.shape[1]):
                fa.flash_assign_plain(xb[bs, rs], cb[bs], want_dists=True)

        def lloyd_times(xb, cb, tag, cl=None):
            """FlashLloyd at (xb, cb): event time of back-to-back calls,
            the profiler's device time, and FlashAssign's device time on the
            same inputs (the argmin both run)."""
            b_, n_, d_ = xb.shape
            k_ = cb.shape[1]
            nb_ = b_ * n_

            def lloyd_plain_chunked():
                for bs, rs in plain_chunks(b_, n_, k_):
                    fl.flash_lloyd_plain(xb[bs, rs], cb[bs])
            rec = {
                "ms": ms_of(lambda: fl.flash_lloyd_raw(xb, cb, cluster=cl)),
                "device_ms": device_ms_of(
                    lambda: fl.flash_lloyd_raw(xb, cb, cluster=cl), reps=5),
                "assign_device_ms": device_ms_of(
                    lambda: fa.flash_assign_raw(xb, cb), reps=5),
                "plain_ms": ms_of(lloyd_plain_chunked, reps=1),
                "library_ms": None, "library_device_ms": None,
                "cluster": cl or H.choose_lloyd_cluster(
                    k_, d_, xb.element_size(), hw_),
                # inputs read once; a, sums, counts, inertia written once
                "bytes": (nb_ * d_ + b_ * k_ * d_) * xb.element_size()
                + nb_ * 4 + b_ * (k_ * d_ + k_ + 1) * 4,
                "ops": 2.0 * nb_ * k_ * d_ + nb_ * d_,
                "dtype": str(xb.dtype).split(".")[1],
                "shape": [b_, n_, k_, d_]}
            if xb.dtype == torch.float32:   # the flops as fp32 FMAs on the
                # CUDA cores, beside the 3xTF32 bound
                rec["bound_cuda_core_ms"] = 2.0 * nb_ * k_ * d_ \
                    / CUDA_CORE_F32 * 1e3
            # its time beyond FlashAssign's, a second per value of N d and
            # per value and centroid tile after the first
            extra_s = (rec["device_ms"] - rec["assign_device_ms"]) * 1e-3
            nk = -(-k_ // fl.TILE_K)
            rec["values_per_s"] = nb_ * d_ / extra_s if extra_s > 0 else None
            rec["tile_values_per_s"] = ((nk - 1) * nb_ * d_ / extra_s
                                        if extra_s > 0 and nk > 1 else None)
            print(f"  {tag}: FlashLloyd (C={rec['cluster']}) device "
                  f"{rec['device_ms']:.4f} ms, a call {rec['ms']:.4f} ms; "
                  f"FlashAssign device {rec['assign_device_ms']:.4f} ms; "
                  f"beyond it: {rec['values_per_s'] or 0:.4g} values/s, "
                  f"{rec['tile_values_per_s'] or 0:.4g} values x tiles/s",
                  flush=True)
            # the fused step's statistics are the same bits from run to run
            # (the adders' lists and the clusters' fold in a fixed order)
            first = [t.clone() for t in fl.flash_lloyd_raw(xb, cb,
                                                            cluster=cl)]
            rec["bitwise_runs"] = 1 + sum(
                all(torch.equal(u, v) for u, v in zip(
                    fl.flash_lloyd_raw(xb, cb, cluster=cl), first))
                for _ in range(UPDATE_BIT_REPS - 1))
            rec["bitwise_reps"] = UPDATE_BIT_REPS
            check(rec["bitwise_runs"] == UPDATE_BIT_REPS,
                  f"{tag}: FlashLloyd (C={rec['cluster']}) gives the same "
                  f"ids, sums, counts and inertia bit for bit in "
                  f"{rec['bitwise_runs']} of {UPDATE_BIT_REPS} runs")
            del first
            timing[tag] = rec
            return rec

        if cl_ is not None:
            lloyd_times(xb, cb, tag + "/flash_lloyd")
            if name == "smallN_smallK":
                # K = 16 (a centroid tile of its own, the additions alone
                # beyond the argmin)
                x16 = mixture(1, n, 16, d, gen).to(x.dtype)
                c16 = x16[:, torch.randperm(n, device=dev,
                                            generator=gen)[:16]].clone()
                lloyd_times(x16, c16, f"smallN_K16/{dt}/flash_lloyd")
                del x16, c16
            nxt = [c_ for c_ in fl.CLUSTERS if c_ > cl_]
            if (name, dt) == ("smallN_smallK", "float32") and nxt:
                # the smallest C against the next one up, (C, C', C', C)
                turns = [(c_, device_ms_of(lambda c_=c_: fl.flash_lloyd_raw(
                    xb, cb, cluster=c_), reps=10))
                    for c_ in (cl_, nxt[0], nxt[0], cl_)]
                timing[tag + "/flash_lloyd"]["cluster_turns"] = turns
                print(f"  FlashLloyd device ms by C, in turns: {turns}",
                      flush=True)
        nb = b * n
        a_full, _ = fa.flash_assign_raw(xb, cb)
        # the two-pass path's launch (distances) and the score-only one, in
        # turns (scores, distances, distances, scores)
        reps_a = 1 if name == "largeN_largeK" else 3
        turns = [(w, ms_of(lambda w=w: fa.flash_assign_raw(
            xb, cb, want_dists=w), reps=reps_a))
            for w in (False, True, True, False)]
        timing[tag + "/flash_assign"] = {
            "ms": statistics.mean(t for w, t in turns if w),
            "scores_ms": statistics.mean(t for w, t in turns if not w),
            "device_ms": device_ms_of(lambda: fa.flash_assign_raw(
                xb, cb, want_dists=True), reps=reps_a + 2),
            "scores_device_ms": device_ms_of(lambda: fa.flash_assign_raw(
                xb, cb), reps=reps_a + 2),
            "plain_ms": ms_of(assign_plain_chunked, reps=1),
            "library_ms": None, "library_device_ms": None,
            "bytes": (nb * d + b * k * d) * x.element_size() + nb * 8,
            "ops": 2.0 * nb * k * d, "dtype": dt, "shape": [b, n, k, d]}
        ta = timing[tag + "/flash_assign"]
        print(f"  {tag}: FlashAssign with distances {ta['ms']:.4f} ms "
              f"(device {ta['device_ms']:.4f}), scores only "
              f"{ta['scores_ms']:.4f} ms (device "
              f"{ta['scores_device_ms']:.4f}); in turns {turns}", flush=True)
        if dt == "float32":   # the same flops as fp32 FMAs on the CUDA
            # cores, beside the 3xTF32 bound
            timing[tag + "/flash_assign"]["bound_cuda_core_ms"] = (
                2.0 * nb * k * d / CUDA_CORE_F32 * 1e3)
        ids = (a_full + k * torch.arange(
            b, device=dev, dtype=torch.int32).unsqueeze(1)).reshape(-1)
        ids_s, order = torch.sort(ids, stable=True)
        order = order.to(torch.int32)
        x2 = xb.reshape(-1, d)
        ids_l = ids.long()
        timing[tag + "/sort_inverse_update"] = {
            "ms": ms_of(lambda: siu.sort_inverse_update_raw(
                x2, order, ids_s, b * k, chunk=blk.update_block_n,
                threads=blk.update_block_k), reps=20),
            "plain_ms": ms_of(lambda: siu.sort_inverse_update_plain(
                x2, order, ids_s, b * k)),
            # index_add_ computes the f32 sums only from f32 rows
            "library_ms": ms_of(lambda: torch.zeros(
                (b * k, d), device=dev).index_add_(0, ids_l, x2),
                reps=20) if x2.dtype == torch.float32 else None,
            # device time alone (the memset with the kernel; zeros and
            # index_add_), where a call is short next to its launch
            "device_ms": device_ms_of(lambda: siu.sort_inverse_update_raw(
                x2, order, ids_s, b * k, chunk=blk.update_block_n,
                threads=blk.update_block_k)),
            "library_device_ms": device_ms_of(lambda: torch.zeros(
                (b * k, d), device=dev).index_add_(0, ids_l, x2))
            if x2.dtype == torch.float32 else None,
            "sort_ms": ms_of(lambda: torch.sort(ids, stable=True)),
            # the two-pass path's sort prologue, device time (its launches)
            "sort_device_ms": device_ms_of(lambda: torch.sort(ids,
                                                              stable=True)),
            "bytes": nb * d * x.element_size() + nb * 8
            + b * k * (d + 1) * 4,
            "ops": float(nb * d), "dtype": dt, "shape": [b, n, k, d]}
        tu = timing[tag + "/sort_inverse_update"]

        def update():
            return siu.sort_inverse_update_raw(
                x2, order, ids_s, b * k, chunk=blk.update_block_n,
                threads=blk.update_block_k)
        first = [t.clone() for t in update()]
        tu["bitwise_runs"] = 1 + sum(
            all(torch.equal(u, v) for u, v in zip(update(), first))
            for _ in range(UPDATE_BIT_REPS - 1))
        tu["bitwise_reps"] = UPDATE_BIT_REPS
        print(f"  {tag}: sort_inverse_update {tu['ms']:.4f} ms (device "
              f"{tu['device_ms']:.4f}), sums and counts bit for bit in "
              f"{tu['bitwise_runs']} of {UPDATE_BIT_REPS} runs; the sort "
              f"prologue of {nb} ids {tu['sort_ms']:.4f} ms (device "
              f"{tu['sort_device_ms']:.4f} ms)", flush=True)
        check(tu["bitwise_runs"] == UPDATE_BIT_REPS,
              f"{tag}: sort_inverse_update gives the same sums and counts "
              f"bit for bit from run to run")
        del first
        del a_full, ids, ids_s, order, ids_l
        del x, c0, xb, cb, st, km
        torch.cuda.empty_cache()

    @contextlib.contextmanager
    def list_modes(index):
        """The index searches with the probe's and block scan's list modes
        (the kernels before the tile and warp modes): both mode rules answer
        "list" and the index plans afresh; restored on exit."""
        saved = index.planner, index._search_plans
        index.planner = P.KernelPlanner(index.planner.hw)
        index._search_plans = {}
        try:
            with list_rule():
                yield
        finally:
            index.planner, index._search_plans = saved

    @contextlib.contextmanager
    def host_rescore(index):
        """The q8 index searches through the host reservoir, the reference's
        ``rescore="host"`` path: its cache is set aside (the plans of that
        geometry plan the rescore as "scan"); restored on exit."""
        cache = index.store.cache
        index.store.cache = None
        try:
            yield
        finally:
            index.store.cache = cache

    def no_sync_check(index, qb, tag):
        """A warm search under ``set_sync_debug_mode("error")``: any host
        sync on the path raises."""
        torch.cuda.synchronize()
        err = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            index.search(qb, topk=TOPK, nprobe=NPROBE)
        except RuntimeError as e:
            err = str(e).splitlines()[0][:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(err is None, f"{tag}: a warm search makes no host sync "
                           f"(set_sync_debug_mode('error')): "
                           f"{err or 'nothing raised'}")

    def time_batches(index):
        """Each query batch once after a warm-up: results and CUDA-event
        ms per batch."""
        index.search(queries[0], topk=TOPK, nprobe=NPROBE)   # warm-up
        res, ms = [], []
        for qb in queries:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res.append(index.search(qb, topk=TOPK, nprobe=NPROBE))
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return res, ms

    def insert_timing(st0, ids, x, tag, reps=5):
        """The insert from ``st0`` (never changed): CUDA events around the
        wrapper (its grouping sort included) and the plain version, each
        call on a fresh copy of the state; the device time of one call by
        kernel (the profiler); the byte bound's operands."""
        work = [t.clone() for t in st0]
        sets, ways = st0[0].shape
        d_ = st0[1].shape[2]

        def reset():
            for w, t in zip(work, st0):
                w.copy_(t)
            torch.cuda.synchronize()

        def plain():
            rck.cache_insert_plain(*work, ids, x,
                                   *rck.group_by_set(ids, sets))
        out = {}
        for label, fn, n_ in (("ms", lambda: rck.cache_insert_raw(
                *work, ids, x), reps), ("plain_ms", plain, 2)):
            ts = []
            for _ in range(n_ + 1):   # the first is a warm-up
                reset()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                ts.append(e0.elapsed_time(e1))
            out[label] = statistics.median(ts[1:])
            out[label + "_runs"] = ts[1:]
        rows = []
        for _ in range(3):   # the profiler now and then records no kernel
            reset()
            rows = device_rows(lambda: rck.cache_insert_raw(*work, ids, x),
                               1)
            if rows:
                break
        _, seg = rck.group_by_set(ids, sets)
        cnt = (seg[1:] - seg[:-1]).long()
        touched = int((cnt > 0).sum())
        slots = int(torch.clamp(cnt, max=ways).sum())
        m = int(ids.shape[0])
        # ids and rows read once; each touched set's written rows (at most
        # its ways) and its lanes (keys, ref) and hand written once
        byt = (m * 4 + m * d_ * 4 + slots * d_ * 4
               + touched * (2 * ways + 1) * 4)
        kern = [r for r in rows if "cache_insert" in r["name"]]
        out.update({"library_ms": None, "bytes": byt, "ops": 0.0,
                    "dtype": "float32", "shape": [sets, ways, d_, m],
                    "device_ms": sum(r["ms"] for r in rows),
                    "device_launch_ms": kern[0]["launch_ms"] if kern
                    else None,
                    "library_device_ms": None, "device_rows": rows,
                    "touched_sets": touched, "written_slots": slots})
        print(f"  {tag}: {out['ms']:.4f} ms a call (CUDA events, median of "
              f"{reps}; plain {out['plain_ms']:.3f} ms); device "
              f"{out['device_ms']:.4f} ms, the kernel "
              f"{out['device_launch_ms']} ms; bound "
              f"{byt / HBM_BW * 1e3:.4f} ms (bytes: {m} ids, {slots} rows "
              f"written in {touched} sets)", flush=True)
        del work
        return out

    def count_run(counts, paged=False):
        """Add a counted run's launches to the kernel table's; on a paged
        store the store scans' go to their paged rows."""
        base = {v: k for k, v in PAGED_ROWS.items()}
        for kname in launches:
            if paged and kname in base:
                paged_launches[base[kname]] += counts[kname]
            else:
                launches[kname] += counts[kname]

    def count_check(name, counts, paged=False):
        """A named run outside the main path (a check at another setting):
        its launches go to the kernel table's ``check_launches`` under
        ``name``, beside the main path's ``launches``."""
        base = {v: k for k, v in PAGED_ROWS.items()}
        for kname in launches:
            row = base[kname] if paged and kname in base else kname
            if counts.get(kname):
                check_launches[row][name] = \
                    check_launches[row].get(name, 0) + counts[kname]

    def paged_phase(index, codec, x, queries, results):
        """The paged store at an IVF cell: the same centroids and corpus in
        ``IVFIndex(..., store="paged", page_size=PAGE)`` filled by one add;
        its batches (counted), flat and two-level over one router trained
        on those centroids, bit for bit the padded index's (``results``:
        the padded flat search's batches); its store scan at the main
        path's shape held to its plain version and queued for timing
        beside the padded one's. Returns the paged index."""
        tag = f"ivf/{codec}/paged"
        n_, d_ = x.shape
        print(f"\n[{tag}] the same centroids and corpus, {PAGE} rows a page",
              flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paged = IVFIndex(index.centroids, 8, store="paged", page_size=PAGE,
                         codec=codec)
        paged.add(x)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        zero_counts()
        res_p, ms_p = time_batches(paged)
        counts = read_counts()
        count_run(counts, paged=True)
        base = "flash_probe_store" if codec == "fp32" \
            else "flash_probe_store_q8"
        check(counts[base] > 0 and counts["flash_probe_tile"] > 0,
              f"{tag} kernels launched: {counts}")
        diff = [i for i, (a, b) in enumerate(zip(results, res_p))
                if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
        check(not diff, f"{tag}: every batch's ids and distances equal the "
                        f"padded index's bit for bit (flat router): batches "
                        f"{diff} differ")
        router = TwoLevelRouter.train(index.centroids, max_iters=4)
        r_pad = IVFIndex(index.centroids, 8, store=index.store, router=router)
        r_pag = IVFIndex(index.centroids, 8, store=paged.store, router=router)
        bad = []
        for i, qb in enumerate(queries):
            a = r_pad.search(qb, topk=TOPK, nprobe=NPROBE)
            b = r_pag.search(qb, topk=TOPK, nprobe=NPROBE)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                bad.append(i)
        check(not bad, f"{tag}: two-level ({router!r}) batches equal the "
                       f"padded index's bit for bit: batches {bad} differ")
        no_sync_check(paged, queries[1], tag)
        st_p, st_d = paged.store, index.store
        width_p = paged.search_geometry(TOPK, NPROBE)[2]
        # batch times of both layouts in turns on the same batches (padded,
        # paged, paged, padded), and each search's device profile
        turns = {"padded": [], "paged": []}
        for name in ("padded", "paged", "paged", "padded"):
            turns[name] += time_batches(index if name == "padded"
                                        else paged)[1]
        prof = {name: profile_steps(f"{tag} search, {name}",
                                    lambda idx=idx: idx.search(
                                        queries[0], topk=TOPK, nprobe=NPROBE))
                for name, idx in (("paged", paged), ("padded", index))}
        ms, ms_d = (statistics.median(turns["paged"]),
                    statistics.median(turns["padded"]))
        rec = {"codec": codec, "page_size": PAGE, "add_s": add_s,
               "gather_width": width_p, "gather_width_padded":
                   index.search_geometry(TOPK, NPROBE)[2],
               "occupied_pages": st_p.occupied_pages(),
               "resident_bytes": st_p.resident_bytes(),
               "resident_bytes_padded": st_d.resident_bytes(),
               "ms_per_batch": ms, "batch_ms": ms_p, "turns_ms": turns,
               "ms_per_batch_padded": ms_d,
               "device_busy_ms": prof["paged"]["device_busy_ms"],
               "device_busy_ms_padded": prof["padded"]["device_busy_ms"],
               "launches": counts,
               "batches_differ": diff, "two_level_batches_differ": bad}
        details["paged"].append(rec)
        print(f"  add {add_s:.3f} s; {st_p.occupied_pages()} pages occupied, "
              f"resident {st_p.resident_bytes() / 2**30:.3f} GiB (padded "
              f"{st_d.resident_bytes() / 2**30:.3f} GiB); gather_width "
              f"{width_p} (padded {rec['gather_width_padded']}); {ms:.3f} ms "
              f"per batch against the padded index's {ms_d:.3f} ms (CUDA "
              f"events, medians of {len(turns['paged'])} in turns); device "
              f"busy {rec['device_busy_ms']:.4f} ms against "
              f"{rec['device_busy_ms_padded']:.4f} ms", flush=True)
        # the paged scan at the main path's shape, against its plain version
        # (outside the counted run), and queued for timing
        qb = queries[0]
        plans = paged.plan_search(IVF_B, TOPK, NPROBE)
        probe = paged._probe(qb, NPROBE, None, plans[:1])
        view = st_p.scan_view()
        k_ = index.k
        rows_, table_, cn = view.rows, view.table[:k_], view.counts[:k_]
        live_rows = int(torch.clamp(cn[probe.long()], max=width_p).sum())
        cells = torch.unique(probe.long())
        cell_rows = int(torch.clamp(cn[cells], max=width_p).sum())
        pages_read = int(((torch.clamp(cn[cells], max=width_p) + PAGE - 1)
                          // PAGE).sum())
        s_ = plans[1].blocks[0]
        if codec == "fp32":
            paged_store_check(qb, rows_, table_, cn, probe, width_p, TOPK,
                              f"{tag} batch 0", s_)
            main_inputs["flash_probe_store (paged)"] = (
                lambda: fp.flash_probe_store_raw(qb, rows_, cn, probe,
                                                 width_p, TOPK, PAD,
                                                 table=table_, splits=s_),
                lambda: fp.flash_probe_store_plain(qb, rows_, cn, probe,
                                                   width_p, TOPK, PAD,
                                                   table_),
                H.scan_store_bytes(IVF_B, NPROBE, width_p, d_, TOPK,
                                   rows_read=cell_rows) + 4 * pages_read,
                4.0 * live_rows * d_, [IVF_B, NPROBE, width_p, d_, TOPK],
                {"pages_read": pages_read, "page_size": PAGE})
        else:
            r = paged._rescore_r(TOPK, NPROBE, width_p)
            anc = st_p.anchors_sentinel[:k_]
            paged_q8_store_check(qb, rows_, view.scales, table_, cn, probe,
                                 anc, width_p, r, f"{tag} batch 0", s_)
            qp = qb.float().unsqueeze(1) - anc[probe.long()]
            main_inputs["flash_probe_store_q8 (paged)"] = (
                lambda: fp.flash_probe_store_q8_raw(
                    qp, rows_, view.scales, cn, probe, width_p, r,
                    table=table_, splits=s_),
                lambda: fp.flash_probe_store_q8_plain(
                    qp, rows_, view.scales, cn, probe, width_p, r, table_),
                H.scan_q8_store_bytes(IVF_B, NPROBE, width_p, d_, r,
                                      rows_read=cell_rows) + 4 * pages_read,
                2.0 * live_rows * d_ + 3.0 * cell_rows * d_,
                [IVF_B, NPROBE, width_p, d_, r],
                {"pages_read": pages_read, "page_size": PAGE})
        del r_pad, r_pag, router
        return paged

    def engine_phase(index, codec, centers):
        """Ragged traffic through ``SearchEngine(query_batch=IVF_B,
        pipeline_depth=2)`` over ``index`` and the same op stream through a
        synchronous engine over a copy of it (the bridge's state, so both
        start from the same bits without a second build); every request
        must equal bit for bit. The served engine's run is counted. A paged store's
        copy is its canonical packed form, which an index filled by one add
        already holds."""
        tag = f"engine/{codec}" + ("/paged" if index.store_kind == "paged"
                                   else "")
        print(f"\n[{tag}] SearchEngine(query_batch={IVF_B}, "
              f"pipeline_depth=2), {ENGINE_REQUESTS} requests of 1-"
              f"{ENGINE_MAX_ROWS} rows, {ENGINE_ADDS} adds of "
              f"{ENGINE_ADD_ROWS}, refresh_every=2", flush=True)
        snap = bridge.index_to_numpy(index)
        twin = bridge.index_from_numpy(
            snap["centroids"], snap["store_arrays"], snap["store_meta"],
            n_total=snap["n_total"], stats=snap["stats"],
            pending=snap["pending"], cache=snap["cache"], device=dev,
            planner=index.planner)
        del snap
        same = [torch.equal(index.centroids, twin.centroids),
                torch.equal(index.counts, twin.counts),
                all(torch.equal(a, b) for a, b in zip(
                    index.store.device_arrays(), twin.store.device_arrays()))]
        if codec == "q8":
            same.append(all(torch.equal(a, b) for a, b in zip(
                index.store.cache_arrays(), twin.store.cache_arrays())))
        check(all(same), f"{tag}: the synchronous engine's index equals the "
                         f"served one (centroids, counts, store"
                         f"{', cache' if codec == 'q8' else ''}): {same}")
        g = torch.Generator().manual_seed(SEED + 9)     # the request sizes
        sizes = torch.randint(1, ENGINE_MAX_ROWS + 1, (ENGINE_REQUESTS,),
                              generator=g).tolist()
        gd = torch.Generator(device=dev).manual_seed(SEED + 10)
        dd_ = centers.shape[1]

        def blobs(rows):
            lab = torch.randint(0, centers.shape[0], (rows,), device=dev,
                                generator=gd)
            return centers[lab] + 0.4 * torch.randn(rows, dd_, device=dev,
                                                    generator=gd)
        every = ENGINE_REQUESTS // (ENGINE_ADDS + 1)
        stream = []
        for i, sz in enumerate(sizes):
            stream.append(("search", blobs(sz)))
            if (i + 1) % every == 0 and (i + 1) // every <= ENGINE_ADDS:
                stream.append(("add", blobs(ENGINE_ADD_ROWS)))
        rows_total = sum(sizes)

        def run(idx, depth):
            """The op stream through an engine; the host time of each of
            its adds (``IVFIndex.add``, whose id readback syncs) apart."""
            eng = SearchEngine(idx, SearchConfig(
                topk=TOPK, nprobe=NPROBE, query_batch=IVF_B,
                pipeline_depth=depth, refresh_every=2))
            add_s, real_add = [], idx.add

            def timed_add(x_new):
                t = time.perf_counter()
                a = real_add(x_new)
                add_s.append(time.perf_counter() - t)
                return a
            idx.add = timed_add
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rids = [eng.submit(p) if kind == "search"
                        else eng.submit_add(p) for kind, p in stream]
                eng.pump()   # a server's loop: drain what was admitted
                out = [eng.take(r) for r in rids]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                del idx.add
            return eng, out, wall, add_s

        zero_counts()
        eng, out, wall, add_s = run(index, 2)
        counts = read_counts()
        count_run(counts, index.store_kind == "paged")
        ref_eng, ref_out, ref_wall, ref_add_s = run(twin, 1)
        bad = [i for i, ((kind, _), a, b) in enumerate(zip(stream, out,
                                                             ref_out))
               if not (torch.equal(a, b) if kind == "add" else
                       torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
        check(not bad, f"{tag}: all {len(stream)} requests equal the "
                       f"synchronous engine's bit for bit (ids, distances; "
                       f"the adds' cells): {len(bad)} differ {bad[:8]}")
        ok_out = all(a[0].shape == (p.shape[0], TOPK)
                     and bool(((a[0] >= 0) & (a[0] < len(index))).all())
                     and bool(torch.isfinite(a[1]).all())
                     for (kind, p), a in zip(stream, out) if kind == "search")
        check(ok_out, f"{tag}: every request's ids in [0, N), finite "
                      f"distances, (rows, {TOPK})")
        need = ["flash_assign", "sort_inverse_update", "flash_probe_tile"] + (
            ["flash_probe_store"] if codec == "fp32" else
            ["flash_probe_store_q8", "flash_probe_grouped_warp",
             "rescore_cache_insert"])
        check(all(counts[kn] > 0 for kn in need),
              f"{tag} kernels launched: {counts}")
        # recall@10 of the requests served after the last add, against
        # search_brute on the index they searched
        last_add = max(i for i, (kind, _) in enumerate(stream)
                       if kind == "add")
        tail = [(p, a[0]) for i, ((kind, p), a) in enumerate(zip(stream, out))
                if i > last_add]
        q_tail = torch.cat([p for p, _ in tail])[:ENGINE_RECALL_ROWS]
        ids_tail = torch.cat([a for _, a in tail])[:ENGINE_RECALL_ROWS]
        brute = torch.cat([index.search_brute(q_tail[i:i + IVF_B],
                                              topk=TOPK)[0]
                           for i in range(0, q_tail.shape[0], IVF_B)])
        recall = recall_at_k(ids_tail, brute)
        check(recall >= 0.9, f"{tag}: recall@{TOPK} {recall:.4f} of the "
                             f"{q_tail.shape[0]} rows served after the last "
                             f"add (vs search_brute) >= 0.9")
        lat, lat_ref = eng.latency_stats(), ref_eng.latency_stats()
        # where an add's host time goes: one more add of the same size on
        # the served index, under cProfile (after every check above)
        import cProfile
        import io
        import pstats
        prof_add = cProfile.Profile()
        x_add = blobs(ENGINE_ADD_ROWS)
        torch.cuda.synchronize()
        prof_add.enable()
        index.add(x_add)
        torch.cuda.synchronize()
        prof_add.disable()
        buf = io.StringIO()
        pstats.Stats(prof_add, stream=buf).sort_stats("cumulative") \
            .print_stats(14)
        add_profile = [ln for ln in buf.getvalue().splitlines()
                       if ln.strip()][-16:]
        print("  one more add under cProfile (cumulative):\n    "
              + "\n    ".join(add_profile), flush=True)
        rec = {"codec": codec, "store": index.store_kind,
               "requests": ENGINE_REQUESTS,
               "rows": rows_total, "adds": ENGINE_ADDS,
               "add_rows": ENGINE_ADD_ROWS, "sizes": sizes,
               "wall_s": wall, "qps": rows_total / wall,
               "latency": lat, "batches_formed": eng.batches_formed,
               "coalesced_requests": eng.coalesced_requests,
               "interleaved_adds": eng.interleaved_adds,
               "refresh_count": eng.refresh_count,
               "recall_at_10": recall, "launches": counts,
               "add_s": add_s, "qps_searches": rows_total
               / (wall - sum(add_s)), "add_profile": add_profile,
               "sync_engine": {"wall_s": ref_wall, "add_s": ref_add_s,
                               "qps": rows_total / ref_wall,
                               "qps_searches": rows_total
                               / (ref_wall - sum(ref_add_s)),
                               "latency": lat_ref}}
        details["engine"].append(rec)
        print(f"  {rows_total} query rows in {eng.batches_formed} units "
              f"({eng.coalesced_requests} coalesced requests, "
              f"{eng.interleaved_adds} adds, {eng.refresh_count} refreshes) "
              f"in {wall:.3f} s = {rows_total / wall:.1f} queries/s "
              f"(synchronous engine {rows_total / ref_wall:.1f}); "
              f"overlap_hits {eng.overlap_hits}; recall@{TOPK} "
              f"{recall:.4f}", flush=True)
        fmt_ms = lambda ts: ", ".join(f"{t * 1e3:.1f}" for t in ts)
        print(f"  adds {fmt_ms(add_s)} ms (synchronous engine "
              f"{fmt_ms(ref_add_s)}); "
              f"without the adds {rec['qps_searches']:.1f} queries/s "
              f"(synchronous {rec['sync_engine']['qps_searches']:.1f})",
              flush=True)
        print(f"  latency_stats {json.dumps(lat)}; synchronous "
              f"{json.dumps(lat_ref)}", flush=True)
        del twin, eng, ref_eng, out, ref_out, stream
        torch.cuda.empty_cache()

    # ---- phase 5: FlashIVF search at full width, fp32 and q8 -------------
    # a generator of its own: the corpus does not depend on what the earlier
    # phases draw
    gen_ivf, centers, x, queries = ivf_corpus(dev)
    n, k, d = IVF
    main_inputs, off_path = {}, {}
    for codec in ("fp32", "q8"):
        print(f"\n[ivf/{codec}] IVF{k},Flat shape: N={n} d={d} K={k}, "
              f"{IVF_BATCHES} batches of {IVF_B} queries, topk={TOPK} "
              f"nprobe={NPROBE}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = IVFIndex.build(x, k=k, max_iters=8, codec=codec, seed=SEED)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()   # the searches' own peak
        width = index.search_geometry(TOPK, NPROBE)[2]
        if codec == "q8":
            check(index.store.cache is not None, "ivf/q8: the index's "
                  "default rescore is the device cache")
        index.search(queries[0], topk=TOPK, nprobe=NPROBE)   # warm-up
        no_sync_check(index, queries[1], f"ivf/{codec}")
        results, batch_ms = time_batches(index)
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for kname in launches:
            launches[kname] += counts[kname]
        # recall against search_brute (the index's own rows) and against
        # the corpus's exact neighbours; search_brute must equal the
        # latter, and every returned distance must be its id's true one
        recall, recall_c, brute = [], [], []
        for i, ((ids, dd), qb) in enumerate(zip(results, queries)):
            ids_b, dd_b = index.search_brute(qb, topk=TOPK)
            brute.append(ids_b)
            ids_t, _ = corpus_topk(x, qb, TOPK)
            recall.append(recall_at_k(ids, ids_b))
            recall_c.append(recall_at_k(ids, ids_t))
            truth_check(f"ivf/{codec} batch {i} search_brute vs corpus",
                        ids_b, dd_b, x, qb, ids_t)
            truth_check(f"ivf/{codec} batch {i} search", ids, dd, x, qb,
                        ids_t, exact=False)
        recall, recall_c = statistics.mean(recall), statistics.mean(recall_c)
        ms = statistics.median(batch_ms)
        # both scans read the store in place: no candidate block is gathered
        block = 0
        print(f"  build {build_s:.3f} s (peak {build_peak_gib:.2f} GiB); cap "
              f"{index.cap}, gather_width {width}; candidate block "
              f"{block} bytes; {ms:.3f} ms per batch (CUDA events, median "
              f"of {len(batch_ms)} after a warm-up) = "
              f"{IVF_B / ms * 1e3:.1f} queries/s; search peak "
              f"{peak_gib:.2f} GiB; recall@{TOPK} {recall:.4f} (vs "
              f"search_brute), {recall_c:.4f} (vs the corpus)", flush=True)
        check(recall >= 0.9 and recall_c >= 0.9,
              f"ivf/{codec} recall@{TOPK} {recall:.4f} (search_brute), "
              f"{recall_c:.4f} (corpus) >= 0.9")
        need = ["flash_assign", "sort_inverse_update", "flash_probe_tile"] + (
            ["flash_probe_store"] if codec == "fp32"
            else ["flash_probe_store_q8", "flash_probe_grouped_warp",
                  "rescore_cache_insert"])
        idle = ["flash_probe_grouped_q8", "flash_probe",
                "flash_probe_grouped"] + (
            ["flash_probe_grouped_warp", "flash_probe_store_q8",
             "rescore_cache_insert"]
            if codec == "fp32" else ["flash_probe_store"])
        check(all(counts[kn] > 0 for kn in need)
              and all(counts[kn] == 0 for kn in idle),
              f"ivf/{codec} kernels launched: {counts}")
        ok_out = all(
            ids.shape == (IVF_B, TOPK) and bool(((ids >= 0) & (ids < n)).all())
            and bool(torch.isfinite(dd).all())
            and bool((dd[:, 1:] >= dd[:, :-1]).all())
            for ids, dd in results)
        check(ok_out, f"ivf/{codec} results: ids in [0, N), finite "
                      f"ascending distances of shape ({IVF_B}, {TOPK})")
        # the same batches with the list modes (the probe and block scan
        # kernels before their tile and warp modes) in the same process:
        # batch times, recall, and both searches' device profiles
        with list_modes(index):
            index.search(queries[0], topk=TOPK, nprobe=NPROBE)   # warm-up
            res_l, ms_l = [], []
            for qb in queries:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res_l.append(index.search(qb, topk=TOPK, nprobe=NPROBE))
                e1.record()
                torch.cuda.synchronize()
                ms_l.append(e0.elapsed_time(e1))
            prof_l = profile_steps(f"ivf/{codec} search, list modes",
                                   lambda: index.search(
                                       queries[0], topk=TOPK, nprobe=NPROBE))
        prof = profile_steps(f"ivf/{codec} search", lambda: index.search(
            queries[0], topk=TOPK, nprobe=NPROBE))
        host = {}
        if codec == "q8":
            # the host reservoir's path on the same index, in the same
            # process: every batch bit for bit the device path's
            torch.cuda.reset_peak_memory_stats()
            with host_rescore(index):
                res_h, ms_h = time_batches(index)
                prof_h = profile_steps("ivf/q8 search, host rescore",
                                       lambda: index.search(
                                           queries[0], topk=TOPK,
                                           nprobe=NPROBE))
            diff = [i for i, (a, b) in enumerate(zip(results, res_h))
                    if not (torch.equal(a[0], b[0])
                            and torch.equal(a[1], b[1]))]
            check(not diff, f"ivf/q8: every batch of the device path equals "
                            f"the host path's bit for bit (ids, distances): "
                            f"batches {diff} differ")
            host = {"ms_per_batch": statistics.median(ms_h), "batch_ms": ms_h,
                    "device_busy_ms": prof_h["device_busy_ms"],
                    "launches": prof_h["launches"],
                    "search_peak_gib":
                        torch.cuda.max_memory_allocated() / 2**30}
            cache = index.store.cache
            print(f"  device rescore: {ms:.3f} ms per batch, busy "
                  f"{prof['device_busy_ms']:.4f} ms in {prof['launches']:g} "
                  f"launches; host rescore: {host['ms_per_batch']:.3f} ms, "
                  f"busy {host['device_busy_ms']:.4f} ms in "
                  f"{host['launches']:g}; the cache {cache.sets} sets x "
                  f"{cache.ways} ways, {cache.resident_bytes() / 2**30:.3f} "
                  f"GiB resident", flush=True)
        recall_l = statistics.mean(recall_at_k(ids, ids_b) for (ids, _), ids_b
                                   in zip(res_l, brute))
        ms_list = statistics.median(ms_l)
        print(f"  list modes: {ms_list:.3f} ms per batch (median of "
              f"{len(ms_l)}), recall@{TOPK} {recall_l:.4f}; device busy "
              f"{prof['device_busy_ms']:.4f} ms in {prof['launches']:g} "
              f"launches, list modes {prof_l['device_busy_ms']:.4f} ms in "
              f"{prof_l['launches']:g}", flush=True)
        check(abs(recall - recall_l) <= 0.0005,
              f"ivf/{codec} recall@{TOPK} {recall:.4f} within 0.0005 of the "
              f"list modes' {recall_l:.4f} on the same batches")
        details["ivf"].append(
            {"codec": codec, "N": n, "K": k, "d": d, "B": IVF_B,
             "topk": TOPK, "nprobe": NPROBE, "build_s": build_s,
             "cap": index.cap, "gather_width": width,
             "candidate_block_bytes": block, "ms_per_batch": ms,
             "batch_ms": batch_ms, "qps": IVF_B / ms * 1e3,
             "build_peak_gib": build_peak_gib, "search_peak_gib": peak_gib,
             "recall_at_10": recall,
             "recall_at_10_corpus": recall_c, "launches": counts,
             "list_modes": {"ms_per_batch": ms_list, "batch_ms": ms_l,
                            "recall_at_10": recall_l,
                            "device_busy_ms": prof_l["device_busy_ms"],
                            "launches": prof_l["launches"]},
             "search_device_busy_ms": prof["device_busy_ms"],
             "search_launches": prof["launches"], "host_rescore": host,
             "cache_bytes": index.store.cache.resident_bytes()
             if codec == "q8" else 0})

        # build's and add's kernels at the shapes this path gave them:
        # FlashAssign of the corpus on the built centroids, then the
        # sort-inverse statistics of its ids with the planner's blocks
        a_ivf = assign_check(x.unsqueeze(0), index.centroids.to(
            x.dtype).unsqueeze(0), f"ivf/{codec}")
        blk = index._batch_blocks(n)
        siu_check(x, a_ivf.reshape(-1), k, f"ivf/{codec}",
                  chunk=blk.update_block_n, threads=blk.update_block_k)
        del a_ivf

        # the search kernels at the shapes this path gave them, held
        # against their plain versions (outside the counted run)
        qb = queries[0]
        plans = index.plan_search(IVF_B, TOPK, NPROBE)
        cnorm = index._centroid_norms()
        probe, _ = probe_check(qb, index.centroids, NPROBE,
                               f"ivf/{codec}", plan=plans[0], list_too=True)
        if codec == "fp32":
            buckets, bucket_ids = index.store.device_arrays()
            cnts = index.counts
            store_check(qb, buckets, cnts, probe, width, TOPK, "ivf/fp32",
                        plans[1].blocks[0])
            # the block path on the same batch: the gathered candidate block
            # and the grouped scan, as before the store scan
            cand_x, cand_ids = store_mod.gather_global(
                "padded", index.store.device_arrays(), probe, width)
            c_n = NPROBE * width
            blk_splits = index.planner.plan(
                "scan", (IVF_B, c_n, d, TOPK), torch.float32).blocks[0]
            scan_check(qb, cand_x, TOPK, "ivf/fp32 block path", blk_splits)
            li_b, dd_b = ops.flash_probe_grouped(qb, cand_x, l=TOPK,
                                                 splits=blk_splits)
            ids_b = ivf_mod._take_rows(cand_ids, li_b)
            check(torch.equal(results[0][0], ids_b)
                  and torch.equal(results[0][1], dd_b),
                  f"ivf/fp32 batch 0: the search returns the block path's "
                  f"ids and distances bit for bit "
                  f"({int((results[0][0] != ids_b).sum())} ids differ)")
            # the bytes the store scan must read: each query's live rows,
            # and each probed cell's live rows once
            live_rows = int(torch.clamp(cnts[probe.long()], max=width).sum())
            cells = torch.unique(probe.long())
            cell_rows = int(torch.clamp(cnts[cells], max=width).sum())
            lookup = lambda li=li_b: bucket_ids[torch.gather(
                probe.long(), 1, torch.div(li.long(), width,
                                           rounding_mode="floor")),
                li.long() % width]
            parts = {"block_gather_ms": ms_of(
                lambda: store_mod.gather_global(
                    "padded", index.store.device_arrays(), probe, width)),
                "id_lookup_ms": ms_of(lookup),
                "live_rows": live_rows, "probed_cells": int(cells.numel()),
                "probed_cell_rows": cell_rows}
            # the tile mode (f32, and bf16 off the path) and beside it the
            # list mode with the splits its planner gives (the kernel before
            # the tile mode); the two-call yardstick, timed only (its tie
            # order is not held)
            ctr = index.centroids
            list_s = H.choose_probe_splits(IVF_B, k, NPROBE)
            two = lambda qb=qb, c=ctr, cn=cnorm: torch.topk(
                torch.addmm(cn, qb, c.t(), alpha=-2), NPROBE, largest=False)
            main_inputs["flash_probe_tile"] = (
                lambda qb=qb, c=ctr, cn=cnorm, cl=plans[0].cluster:
                fp.flash_probe_raw(qb, c, cn, NPROBE, cluster=cl),
                lambda qb=qb, c=ctr, cn=cnorm:
                fp.flash_probe_plain(qb, c, cn, NPROBE),
                H.probe_bytes(IVF_B, k, d, NPROBE), 2.0 * IVF_B * k * d,
                [IVF_B, k, d, NPROBE],
                {"two_call_ms": ms_of(two, reps=20),
                 "two_call_device_ms": device_ms_of(two)})
            off_path["ivf/flash_probe"] = (
                lambda qb=qb, c=ctr, cn=cnorm:
                in_list_mode(fp.flash_probe_raw, qb, c, cn, NPROBE,
                             splits=list_s),
                lambda qb=qb, c=ctr, cn=cnorm:
                fp.flash_probe_plain(qb, c, cn, NPROBE),
                H.probe_bytes(IVF_B, k, d, NPROBE), 2.0 * IVF_B * k * d,
                [IVF_B, k, d, NPROBE], {})
            qh, ch = qb.to(torch.bfloat16), ctr.to(torch.bfloat16)
            chq = (ch.float() * ch.float()).sum(-1)
            probe_check(qh, ch, NPROBE, "ivf/bf16", list_too=True)
            plan_h = index.planner.plan("probe", (IVF_B, k, d, NPROBE),
                                        torch.bfloat16)
            for kn, run in (
                    ("flash_probe_tile", lambda qh, ch, cn: fp.flash_probe_raw(
                        qh, ch, cn, NPROBE, cluster=plan_h.cluster)),
                    ("flash_probe", lambda qh, ch, cn: in_list_mode(
                        fp.flash_probe_raw, qh, ch, cn, NPROBE,
                        splits=list_s))):
                off_path[f"ivf-bf16/{kn}"] = (
                    lambda qh=qh, ch=ch, cn=chq, run=run: run(qh, ch, cn),
                    lambda qh=qh, ch=ch, cn=chq:
                    fp.flash_probe_plain(qh, ch, cn, NPROBE),
                    H.probe_bytes(IVF_B, k, d, NPROBE, 2),
                    2.0 * IVF_B * k * d, [IVF_B, k, d, NPROBE], {})
            # the tile mode at each cluster size, in a CUDA graph, against L
            # (the IVF centroids; f32 and bf16 at B 256, f32 at 1,024),
            # beside the planner's choice
            sweep, q_all = [], queries.reshape(-1, d)
            for b_, dt_ in ((IVF_B, torch.float32), (IVF_B, torch.bfloat16),
                            (4 * IVF_B, torch.float32)):
                qx, cx = q_all[:b_].to(dt_), ctr.to(dt_)
                cnx = (cx.float() * cx.float()).sum(-1)
                for l_ in SWEEP_L:
                    row = {"B": b_, "K": k, "d": d, "L": l_,
                           "dtype": str(dt_).rsplit(".", 1)[1],
                           "planned": H.choose_probe_cluster(b_, k, l_),
                           "graph_ms": {cl: graph_ms(
                               lambda cl=cl: fp.flash_probe_raw(
                                   qx, cx, cnx, l_, cluster=cl))
                               for cl in fp.PROBE_CLUSTERS}}
                    sweep.append(row)
                    best = min(row["graph_ms"], key=row["graph_ms"].get)
                    print(f"  tile mode B={b_} {row['dtype']} L={l_}: "
                          + ", ".join(f"cluster {cl} {t:.4f}" for cl, t
                                      in row["graph_ms"].items())
                          + f" ms (graph); planned {row['planned']}, "
                          f"fastest {best}", flush=True)
            details["probe_cluster_sweep"] = sweep
            # bound: each probed cell's live rows read once; beside it the
            # bound of each query reading its own live rows
            main_inputs["flash_probe_store"] = (
                lambda qb=qb, bk=buckets, cn=cnts, pr=probe,
                s=plans[1].blocks[0]:
                fp.flash_probe_store_raw(qb, bk, cn, pr, width, TOPK, PAD,
                                         splits=s),
                lambda qb=qb, bk=buckets, cn=cnts, pr=probe:
                fp.flash_probe_store_plain(qb, bk, cn, pr, width, TOPK, PAD),
                H.scan_store_bytes(IVF_B, NPROBE, width, d, TOPK,
                                   rows_read=cell_rows),
                4.0 * live_rows * d, [IVF_B, NPROBE, width, d, TOPK],
                {"bound_query_rows_ms": H.scan_store_bytes(
                    IVF_B, NPROBE, width, d, TOPK, rows_read=live_rows)
                 / HBM_BW * 1e3})
            # the block path's scan, for comparison (not on the main path)
            off_path["ivf-block/flash_probe_grouped"] = (
                lambda qb=qb, cx=cand_x, s=blk_splits:
                fp.flash_probe_grouped_raw(qb, cx, TOPK, splits=s),
                lambda qb=qb, cx=cand_x:
                fp.flash_probe_grouped_plain(qb, cx, TOPK),
                H.scan_bytes(IVF_B, c_n, d, TOPK), 4.0 * IVF_B * c_n * d,
                [IVF_B, c_n, d, TOPK], {})
            del li_b, dd_b
        else:
            codes_s, bucket_ids, scales_s, anchors = \
                index.store.device_arrays()
            cnts = index.counts
            r = index._rescore_r(TOPK, NPROBE, width)
            q8_store_check(qb, codes_s, scales_s, cnts, probe, anchors, width,
                           r, "ivf/q8", plans[1].blocks[0])
            # the block path on the same batch: the gathered codes and scales
            # and the block kernel, as before the store scan
            codes, scales, cand_ids = store_mod.gather_global_q8(
                "padded", (codes_s, bucket_ids, scales_s), probe, width)
            qp = qb.float().unsqueeze(1) - anchors[probe.long()]
            codes = codes.reshape(IVF_B, NPROBE, width, d)
            scales = scales.reshape(IVF_B, NPROBE, width)
            c_n = NPROBE * width
            blk_splits = index.planner.plan(
                "scan_q8", (IVF_B, c_n, d, r), torch.int8).blocks[0]
            q8_check(qp, codes, scales, r, "ivf/q8 block path", blk_splits)
            ids, deq = ivf_mod._q8_propose(
                qb, index.centroids, cnorm, index.store.scan_view(), r=r,
                nprobe=NPROBE, width=width, probe_plan=plans[0],
                scan_plan=plans[1])
            li_b, v_b = ops.flash_probe_grouped_q8(qp, codes, scales, l=r,
                                                   splits=blk_splits)
            ids_b = torch.where(torch.isfinite(v_b),
                                ivf_mod._take_rows(cand_ids, li_b), -1)
            deq_b = (ivf_mod._take_rows(anchors[probe.long()],
                                        torch.div(li_b, width,
                                                  rounding_mode="floor"))
                     + ivf_mod._take_rows(codes.reshape(IVF_B, c_n, d),
                                          li_b).float()
                     * ivf_mod._take_rows(scales.reshape(IVF_B, c_n),
                                          li_b).unsqueeze(-1))
            check(torch.equal(ids, ids_b),
                  f"ivf/q8 batch 0: the proposal's ids equal the block "
                  f"path's bit for bit ({int((ids != ids_b).sum())} differ)")
            check(torch.equal(deq, deq_b), "ivf/q8 batch 0: the proposal's "
                  "dequantized rows equal the block path's bit for bit")
            del li_b, v_b, ids_b, deq_b
            # phase 1 on the card; the host round trip (ids to the host,
            # the reservoir's lookup, rows back: median of 5 on the host
            # clock); the exact rescore on the card
            host_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                rows, found = index.store.reservoir.lookup(ids.cpu().numpy())
                rows = torch.as_tensor(rows, device=dev)
                found = torch.as_tensor(found, device=dev)
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
            # the device path's rows: the cache's lookup, on the card, bit
            # for bit the reservoir's (the unbounded cache holds every id)
            rows_c, found_c = cache_lookup(*index.store.cache_arrays(), ids)
            check(torch.equal(found_c, found) and torch.equal(rows_c, rows),
                  f"ivf/q8 batch 0: the device cache's rows and hits equal "
                  f"the host reservoir's bit for bit ({int(found.sum())} of "
                  f"{found.numel()} proposals found)")
            # the rescore scan on the rows the path feeds it: cached rows,
            # dequantized codes where missing, padding for id -1
            cand = ivf_mod._rescore_rows(deq, ids, rows_c, found_c)
            scan_check(qb, cand, TOPK, "ivf/q8-rescore", plans[2].blocks[0])
            # the warp mode, and beside it the list mode with the splits
            # its planner gives (the kernel before the warp mode)
            main_inputs["flash_probe_grouped_warp"] = (
                lambda qb=qb, cx=cand, s=plans[2].blocks[0]:
                fp.flash_probe_grouped_raw(qb, cx, TOPK, splits=s),
                lambda qb=qb, cx=cand:
                fp.flash_probe_grouped_plain(qb, cx, TOPK),
                H.scan_bytes(IVF_B, r, d, TOPK), 4.0 * IVF_B * r * d,
                [IVF_B, r, d, TOPK], {})
            off_path["ivf/flash_probe_grouped"] = (
                lambda qb=qb, cx=cand, s=H.choose_probe_splits(IVF_B, r,
                                                               TOPK):
                in_list_mode(fp.flash_probe_grouped_raw, qb, cx, TOPK,
                             splits=s),
                lambda qb=qb, cx=cand:
                fp.flash_probe_grouped_plain(qb, cx, TOPK),
                H.scan_bytes(IVF_B, r, d, TOPK), 4.0 * IVF_B * r * d,
                [IVF_B, r, d, TOPK], {})
            live_rows = int(torch.clamp(cnts[probe.long()], max=width).sum())
            cells = torch.unique(probe.long())
            cell_rows = int(torch.clamp(cnts[cells], max=width).sum())
            parts = {
                "block_gather_ms": ms_of(lambda: store_mod.gather_global_q8(
                    "padded", (codes_s, bucket_ids, scales_s), probe,
                    width)),
                "propose_ms": ms_of(lambda: ivf_mod._q8_propose(
                    qb, index.centroids, cnorm, index.store.scan_view(),
                    r=r, nprobe=NPROBE, width=width,
                    probe_plan=plans[0], scan_plan=plans[1])),
                "host_round_trip_ms": statistics.median(host_ms),
                "cache_lookup_ms": ms_of(lambda: cache_lookup(
                    *index.store.cache_arrays(), ids)),
                "rescore_ms": ms_of(lambda: ivf_mod._rescore_body(
                    qb, deq, ids, rows, found, topk=TOPK, plan=plans[2])),
                "live_rows": live_rows, "probed_cells": int(cells.numel()),
                "probed_cell_rows": cell_rows}
            del rows, found
            # bound: each probed cell's live codes and scales read once, and
            # the work the function needs: r = code * s and ||r||^2 once a
            # probed cell's live row (3 flops a code), q'.r for each pair's
            # live rows (2 flops a code); beside it the bound of each query
            # reading its own live rows
            main_inputs["flash_probe_store_q8"] = (
                lambda qp=qp, cd=codes_s, sc=scales_s, cn=cnts, pr=probe,
                s=plans[1].blocks[0], r=r:
                fp.flash_probe_store_q8_raw(qp, cd, sc, cn, pr, width, r,
                                            splits=s),
                lambda qp=qp, cd=codes_s, sc=scales_s, cn=cnts, pr=probe,
                r=r: fp.flash_probe_store_q8_plain(qp, cd, sc, cn, pr, width,
                                                   r),
                H.scan_q8_store_bytes(IVF_B, NPROBE, width, d, r,
                                      rows_read=cell_rows),
                2.0 * live_rows * d + 3.0 * cell_rows * d,
                [IVF_B, NPROBE, width, d, r],
                {"bound_query_rows_ms": H.scan_q8_store_bytes(
                    IVF_B, NPROBE, width, d, r, rows_read=live_rows)
                 / HBM_BW * 1e3})
            # the block kernel on the gathered block (off the main path)
            live = int((scales > 0).sum())
            off_path["ivf/flash_probe_grouped_q8"] = (
                lambda qp=qp, cd=codes, sc=scales, s=blk_splits, r=r:
                fp.flash_probe_grouped_q8_raw(qp, cd, sc, r, splits=s),
                lambda qp=qp, cd=codes, sc=scales, r=r:
                fp.flash_probe_grouped_q8_plain(qp, cd, sc, r),
                # q' rows, every scale, the codes of live slots, the pair out
                IVF_B * NPROBE * d * 4 + IVF_B * c_n * 4 + live * d
                + 2 * IVF_B * r * 4,
                5.0 * live * d, [IVF_B, NPROBE, width, d, r], {})
            del codes, scales, deq, cand_ids
        details["ivf"][-1].update(parts)
        print("  " + ", ".join(f"{key} {v:.3f}" for key, v in parts.items()),
              flush=True)
        del probe
        if codec == "q8":
            # the rescore cache's insert at the build's shapes: the build's
            # ids and rows in the store's append order (its posting lists),
            # into an unbounded cache (the index's own, which it must
            # equal) and one budgeted at a quarter of the rows' bytes (16
            # items a set: heavy eviction); then a re-insert of every 16th
            # id with new rows
            ids_app = index.posting_lists()[0].to(torch.int32).contiguous()
            rows_app = x[ids_app.long()]
            for label, mb in (("unbounded", None), ("budgeted", n * d)):
                c0 = DeviceRescoreCache(d, max_bytes=mb, device=dev)
                if mb is None:
                    c0._ensure(n - 1)
                st0 = insert_state(c0)
                tag = f"ivf/q8 {label} ({c0.sets} sets x {c0.ways})"
                st1 = insert_check(st0, ids_app, rows_app, tag)
                if mb is None:
                    live = st1[0] >= 0
                    same = torch.equal(index.store.cache.keys, st1[0]) and \
                        torch.equal(index.store.cache.rows[live], st1[1][live])
                    check(same, f"{tag}: the index's cache after its build "
                                f"equals this insert's")
                insert_check(st1, ids_app[::16].contiguous(),
                             rows_app[::16] + 1.0, f"{tag} re-insert")
                rec = insert_timing(st0, ids_app, rows_app, tag)
                details["cache_insert"].append({"at": tag, **{
                    kk: v for kk, v in rec.items() if kk != "device_rows"}})
                if mb is None:
                    timing["ivf/rescore_cache_insert"] = rec
                del c0, st0, st1
            del ids_app, rows_app
            torch.cuda.empty_cache()
        # the two-level router over this index's store: at nprobe = K every
        # group is probed, so the routed ids equal the flat index's exactly
        routed = IVFIndex(index.centroids, index.cap, store=index.store,
                          router="two_level")
        ids_f, dd_f = index.search(queries[0], topk=TOPK, nprobe=k)
        ids_r, dd_r = routed.search(queries[0], topk=TOPK, nprobe=k)
        check(routed.router.effective_nprobe_c(k) == routed.router.coarse_k
              and torch.equal(ids_f, ids_r),
              f"ivf/{codec} full coverage: the routed index ({routed.router!r})"
              f" at nprobe = K = {k} returns the flat index's ids exactly "
              f"({int((ids_f != ids_r).sum())} differ; distances within "
              f"{float((dd_f - dd_r).abs().max()):.3g})")
        details["ivf"][-1]["routed_full_coverage"] = {
            "router": repr(routed.router),
            "ids_differ": int((ids_f != ids_r).sum()),
            "max_dist_diff": float((dd_f - dd_r).abs().max())}
        del routed, ids_f, dd_f, ids_r, dd_r
        paged = paged_phase(index, codec, x, queries, results)
        if codec == "fp32":   # the evicting store's budget: half of these
            paged_page_bytes = paged.store.occupied_pages() * \
                paged.store._page_bytes()
        engine_phase(index, codec, centers)
        if codec == "q8":
            engine_phase(paged, codec, centers)
        del index, paged, results
        torch.cuda.empty_cache()

    def time_kernel(tag, kern, plain, byt, ops_, shape, extra):
        """A kernel's wrapper at one shape: CUDA events of back-to-back
        calls, its plain version's, the device time by kernel (the
        profiler), and the byte and operation counts of its bound."""
        kern()
        torch.cuda.synchronize()
        for _ in range(3):   # the profiler now and then records no kernel
            rows = device_rows(kern, 10)
            if rows:
                break
        # the event time is that of back-to-back wrapper calls, which the
        # host can pace; beside it the device's own time, by kernel
        timing[tag] = {
            "ms": ms_of(kern, reps=20), "plain_ms": ms_of(plain, reps=3),
            "library_ms": None, "bytes": byt, "ops": ops_,
            "dtype": "float32", "shape": shape,
            "device_ms": sum(r["ms"] for r in rows),
            "device_launch_ms": rows[0]["launch_ms"] if len(rows) == 1
            else None,
            "library_device_ms": None, "device_rows": rows, **extra}
        if tag.rsplit("/", 1)[1] in ("flash_probe_tile", "flash_probe",
                                     "flash_probe_grouped_warp",
                                     "flash_probe_grouped"):
            timing[tag]["graph_ms"] = graph_ms(kern)
        print(f"  {tag} device time by kernel: " + "; ".join(
            f"{r['name'][:48]} {r['ms']:.4f} ms x{r['calls']:g} "
            f"({r['launch_ms']:.4f} ms a launch)" for r in rows), flush=True)
        if tag.endswith(("/flash_probe_tile", "/flash_probe_grouped_warp")):
            kern_name = tag.rsplit("/", 1)[1] + "_kernel"
            check(len(rows) == 1 and kern_name in rows[0]["name"],
                  f"{tag}: one launch a call, of {kern_name} alone (the "
                  f"device ran {[r['name'][:60] for r in rows]})")

    # kernel times at the main path's shapes, and the block path's scans
    for tag, args_ in [*((f"ivf/{kn}", v) for kn, v in main_inputs.items()),
                       *off_path.items()]:
        time_kernel(tag, *args_)
    del main_inputs, off_path, x, centers, queries
    torch.cuda.empty_cache()

    # ---- phase 5b: the two-level router at K = 65,536 ---------------------
    # the reference's routed regime at the serving width d = 128: fine
    # centroids around meta-centres (scale 8, unit noise), each cell's rows
    # its centroid plus 0.05 noise, added in chunks to IVFIndex(cent,
    # capacity=8); a flat and a routed index share one store, so a recall
    # gap is routing's alone; a seed of its own
    kr, n_meta, per_cell = ROUTED
    dr, nr = 128, ROUTED[0] * ROUTED[2]
    _, cent, xr, qr = routed_corpus(dev)
    rec_r = details["routed"]
    rec_r.update(K=kr, meta_centres=n_meta, N=nr, d=dr, B=IVF_B, topk=TOPK,
                 chunk=ROUTED_CHUNK, cells=[])
    print(f"\n[routed] K={kr} fine centroids around {n_meta} meta-centres, "
          f"N={nr} ({per_cell} rows a cell), d={dr}; topk={TOPK}, (B, "
          f"nprobe) {ROUTED_POINTS}", flush=True)
    router, ids_truth = None, None
    for codec in ("fp32", "q8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = IVFIndex(cent, capacity=8, codec=codec)
        for lo in range(0, nr, ROUTED_CHUNK):
            flat.add(xr[lo:lo + ROUTED_CHUNK])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() / 2**30
        if router is None:
            t0 = time.perf_counter()
            router = TwoLevelRouter.train(cent, max_iters=4)
            torch.cuda.synchronize()
            rec_r["router"] = {
                "train_s": time.perf_counter() - t0,
                "coarse_k": router.coarse_k, "nprobe_c": router.nprobe_c,
                "gcap": router.gcap,
                "largest_group": int(router.group_sizes.max())}
        routed = IVFIndex(cent, capacity=8, store=flat.store, router=router)
        table = routed._route_view()   # the fine stage's (K_c, gcap, d)
        if "table_bytes" not in rec_r["router"]:
            rec_r["router"]["table_bytes"] = (table.numel()
                                              * table.element_size())
            print(f"  TwoLevelRouter.train(max_iters=4) "
                  f"{rec_r['router']['train_s']:.3f} s: coarse_k "
                  f"{router.coarse_k}, nprobe_c {router.nprobe_c}, gcap "
                  f"{router.gcap} (largest group "
                  f"{rec_r['router']['largest_group']}); the fine table "
                  f"{rec_r['router']['table_bytes'] / 2**20:.1f} MiB",
                  flush=True)
        if ids_truth is None:   # the q8 store holds the same rows and ids
            ids_truth = torch.cat([flat.search_brute(qr[i:i + 64], topk=TOPK)
                                   [0] for i in range(0, IVF_B, 64)])
        print(f"  [{codec}] added in chunks of {ROUTED_CHUNK}: {build_s:.3f} "
              f"s (peak {build_peak:.2f} GiB); cap {flat.cap}, resident "
              f"{flat.resident_bytes() / 2**30:.3f} GiB", flush=True)
        cell = {"codec": codec, "build_s": build_s, "build_peak_gib":
                build_peak, "cap": flat.cap,
                "resident_bytes": flat.resident_bytes(), "searches": []}
        recalls = {}
        for bq, nprobe in ROUTED_POINTS:
            verdict = routed.planner.plan("route", (bq, kr, dr, nprobe),
                                          torch.float32).impl
            for name, index in (("flat", flat), ("routed", routed)):
                def run(index=index, nprobe=nprobe, bq=bq):
                    return index.search(qr[:bq], topk=TOPK, nprobe=nprobe)
                run()   # warm-up
                ms = []
                for _ in range(5):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    ids, dd = run()
                    e1.record()
                    torch.cuda.synchronize()
                    ms.append(e0.elapsed_time(e1))
                rows = device_rows(run, 3)
                rc = recall_at_k(ids, ids_truth[:bq])
                recalls[name, bq, nprobe] = rc
                npc = router.effective_nprobe_c(nprobe) \
                    if name == "routed" else None
                check(ids.shape == (bq, TOPK)
                      and bool(((ids >= 0) & (ids < nr)).all())
                      and bool(torch.isfinite(dd).all()),
                      f"routed/{codec} {name} B {bq} nprobe {nprobe}: ids "
                      f"in [0, N), finite distances")
                print(f"  [{codec}] {name} B {bq} nprobe {nprobe}"
                      f"{f' (nprobe_c {npc})' if npc else ''}, route plan "
                      f"{verdict}: "
                      f"{statistics.median(ms):.3f} ms per batch (CUDA "
                      f"events, median of 5 after a warm-up), recall@{TOPK} "
                      f"{rc:.4f}; device busy "
                      f"{sum(r['ms'] for r in rows):.4f} ms: " + "; ".join(
                          f"{r['name'][:40]} {r['ms']:.4f} ms x{r['calls']:g}"
                          for r in rows[:6]), flush=True)
                cell["searches"].append(
                    {"router": name, "B": bq, "nprobe": nprobe,
                     "route_plan": verdict, "nprobe_c_eff": npc,
                     "ms_per_batch": statistics.median(ms), "batch_ms": ms,
                     "recall_at_10": rc,
                     "device_busy_ms": sum(r["ms"] for r in rows),
                     "device_rows": rows})
        top = (IVF_B, max(ROUTED_NPROBE))
        check(recalls["routed", *top] >= recalls["flat", *top] - 0.02,
              f"routed/{codec} recall@{TOPK} at B {top[0]}, nprobe {top[1]}: "
              f"routed {recalls['routed', *top]:.4f} >= flat "
              f"{recalls['flat', *top]:.4f} - 0.02")
        no_sync_check(routed, qr, f"routed/{codec}")
        # nprobe_c = 1 below nprobe: nprobe_c * gcap < nprobe, so the probe
        # lists end in the sentinel cell K
        nps = min(kr, router.gcap + 16)
        ids_s, dd_s = routed.search(qr, topk=TOPK, nprobe=nps, nprobe_c=1)
        probe_s = routed._probe(
            qr, nps, 1, routed.plan_search(IVF_B, TOPK, nps, 1)[:2])
        counts_s = flat.store.counts_sentinel
        sentinels = int((probe_s == kr).sum())
        check(sentinels >= IVF_B * (nps - router.gcap)
              and bool(((ids_s >= -1) & (ids_s < nr)).all())
              and bool((torch.isfinite(dd_s) | (dd_s == float("inf"))).all()),
              f"routed/{codec} nprobe {nps}, nprobe_c 1: {sentinels} "
              f"sentinel cells in the probe lists; ids valid or -1 "
              f"({int((ids_s < 0).sum())} of -1), distances finite or +inf")
        counts = read_counts()
        for kname in launches:
            launches[kname] += counts[kname]
        need = ["flash_assign", "sort_inverse_update", "flash_probe_tile",
                "flash_probe_store"] + (
            ["flash_probe_store_q8", "flash_probe_grouped_warp",
             "rescore_cache_insert"] if codec == "q8" else [])
        idle = ["flash_probe", "flash_probe_grouped", "flash_probe_grouped_q8"]
        check(all(counts[kn] > 0 for kn in need)
              and all(counts[kn] == 0 for kn in idle),
              f"routed/{codec} kernels launched: {counts}")
        cell.update(launches=counts, sentinel_nprobe=nps,
                    sentinel_cells=sentinels)

        # the routed path's kernels at the shapes it gave them, against
        # their plain versions (outside the counted run): the coarse probe
        # and the fine stage (the store scan over the router's table), and
        # the bucket scans over probe lists that end in sentinels (the
        # first 32 queries: the block they are held to grows with nprobe)
        if codec == "fp32":
            for nprobe in ROUTED_NPROBE:
                plans = routed.plan_search(IVF_B, TOPK, nprobe)
                _, npc, gcap = router.fingerprint(nprobe)
                leff = min(nprobe, npc * gcap)
                cidx, _ = probe_check(qr, router.coarse, npc,
                                      f"routed coarse probe, nprobe {nprobe}",
                                      plan=plans[0])
                store_check(qr, table, router.group_sizes, cidx,
                            gcap, leff, f"routed fine stage, nprobe {nprobe}",
                            plans[1].blocks[0])
                sizes = router.group_sizes
                pair_rows = int(sizes[cidx.long()].sum())
                group_rows = int(sizes[torch.unique(cidx.long())].sum())
                time_kernel(
                    f"routed/nprobe{nprobe}/flash_probe_store",
                    lambda c=cidx, l=leff, s=plans[1].blocks[0]:
                    fp.flash_probe_store_raw(qr, table, sizes, c,
                                             gcap, l, PAD, splits=s),
                    lambda c=cidx, l=leff:
                    fp.flash_probe_store_plain(qr, table, sizes, c,
                                               gcap, l, PAD),
                    H.scan_store_bytes(IVF_B, npc, gcap, dr, leff,
                                       rows_read=group_rows),
                    2.0 * pair_rows * dr + 2.0 * group_rows * dr,
                    [IVF_B, npc, gcap, dr, leff],
                    {"bound_query_rows_ms": H.scan_store_bytes(
                        IVF_B, npc, gcap, dr, leff, rows_read=pair_rows)
                     / HBM_BW * 1e3, "pair_rows": pair_rows,
                     "group_rows": group_rows})
        qs, ps = qr[:32], probe_s[:32].contiguous()
        width_s = routed._gather_width(TOPK, nps)
        arrays = flat.store.device_arrays()
        if codec == "fp32":
            store_check(qs, arrays[0], counts_s, ps, width_s, TOPK,
                        f"routed bucket scan, {int((ps == kr).sum())} "
                        f"sentinel cells")
        else:
            codes_r, _, scales_r, _ = arrays
            q8_store_check(qs, codes_r, scales_r, counts_s, ps,
                           flat.store.anchors_sentinel,
                           width_s, routed._rescore_r(TOPK, nps, width_s),
                           f"routed q8 proposal, {int((ps == kr).sum())} "
                           f"sentinel cells")
        rec_r["cells"].append(cell)
        del flat, routed, table, probe_s, counts_s, ids_s, dd_s, arrays, qs
        del ps
    del cent, xr, qr, router, ids_truth
    torch.cuda.empty_cache()

    # ---- phase 6: full-probe exactness on a smaller index -----------------
    gen_x = torch.Generator(device=dev).manual_seed(SEED + 5)
    n, k, d = EXACT
    centers = torch.randn(k, d, device=dev, generator=gen_x) * 5.0
    x = centers[torch.randint(0, k, (n,), device=dev, generator=gen_x)]
    x += 0.4 * torch.randn(n, d, device=dev, generator=gen_x)
    q = centers[torch.randint(0, k, (EXACT_B,), device=dev, generator=gen_x)]
    q += 0.4 * torch.randn(EXACT_B, d, device=dev, generator=gen_x)
    ids_t, _ = corpus_topk(x, q, TOPK)
    for codec in ("fp32", "q8"):
        index = IVFIndex.build(x, k=k, max_iters=8, codec=codec, seed=SEED,
                               rescore_mult=n)   # R = the whole pool
        ids, dd = index.search(q, topk=TOPK, nprobe=k)
        ids_b, dd_b = index.search_brute(q, topk=TOPK)
        tag = f"ivf/{codec} full probe (N={n}, K={k})"
        rec = truth_check(f"{tag} search vs search_brute", ids, dd, x, q,
                          ids_b)
        truth_check(f"{tag} search vs corpus", ids, dd, x, q, ids_t)
        truth_check(f"{tag} search_brute vs corpus", ids_b, dd_b, x, q,
                    ids_t)
        # the paged store over the same centroids and rows: at nprobe = K
        # its ids and distances are the padded index's, bit for bit
        paged = IVFIndex(index.centroids, 8, store="paged", page_size=PAGE,
                         codec=codec, rescore_mult=n)
        paged.add(x)
        ids_p, dd_p = paged.search(q, topk=TOPK, nprobe=k)
        same = torch.equal(ids_p, ids) and torch.equal(dd_p, dd)
        check(same, f"{tag} paged ({PAGE} rows a page): ids and distances "
                    f"equal the padded index's bit for bit "
                    f"({int((ids_p != ids).sum())} ids differ)")
        details["ivf"].append(
            {"codec": codec, "exactness": True, "N": n, "K": k, "d": d,
             "B": EXACT_B, "nprobe": k, "paged_equal": same, **rec})
        del index, paged
    del x, centers, q
    torch.cuda.empty_cache()

    # ---- phase 6b: the paged store under a skewed corpus ------------------
    # the IVF cell's blob centres (seed 4), each row's (and query's) cell
    # drawn from Zipf(1.0) over a permutation of them (seed 15): the hottest
    # cell holds about N / H(1,024) rows, which sets the padded layout's cap
    # for every cell; the paged pool holds the occupied pages
    n, k, d = IVF
    centers = torch.randn(k, d, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED + 4)) * 5.0
    gen_z = torch.Generator(device=dev).manual_seed(SKEW_SEED)
    perm = torch.randperm(k, device=dev, generator=gen_z)
    zipf = 1.0 / torch.arange(1, k + 1, device=dev, dtype=torch.float64)
    zipf /= zipf.sum()
    lab = perm[torch.multinomial(zipf, n, replacement=True, generator=gen_z)]
    x = centers[lab] + 0.4 * torch.randn(n, d, device=dev, generator=gen_z)
    qlab = perm[torch.multinomial(zipf, IVF_BATCHES * IVF_B, replacement=True,
                                  generator=gen_z)]
    queries = (centers[qlab] + 0.4 * torch.randn(
        IVF_BATCHES * IVF_B, d, device=dev, generator=gen_z)).reshape(
        IVF_BATCHES, IVF_B, d)
    del lab, qlab
    brute = None
    for codec in ("fp32", "q8"):
        tag = f"paged_skew/{codec}"
        print(f"\n[{tag}] N={n} d={d} K={k}, cells Zipf(1.0), {PAGE} rows a "
              f"page, added in chunks of {SKEW_CHUNK}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        index = IVFIndex(centers, 8, store="paged", page_size=PAGE,
                         codec=codec)
        # the allocator's host time in each add (page tables, free list)
        inner = getattr(index.store, "_inner", index.store)
        alloc_s, map_pages = [], inner._map_pages

        def timed_map(*a, map_pages=map_pages, alloc_s=alloc_s):
            t = time.perf_counter()
            out_ = map_pages(*a)
            alloc_s.append(time.perf_counter() - t)
            return out_
        inner._map_pages = timed_map
        add_s, hot_after = [], []
        for lo in range(0, n, SKEW_CHUNK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.add(x[lo:lo + SKEW_CHUNK])
            torch.cuda.synchronize()
            add_s.append(time.perf_counter() - t0)
            hot_after.append(index.store.max_count)
        del inner._map_pages
        hottest = hot_after[-1]
        width = index.search_geometry(TOPK, NPROBE)[2]
        row_b = d * (4 if codec == "fp32" else 1) + 4 + (
            0 if codec == "fp32" else 4)
        # the padded layout over the same adds, from the counts alone: its
        # (K, cap) payload at the end, and its peak while growing (the
        # store's doubling holds the old and the new tensors at once)
        cap_, grow_peak = 8, 0
        for h in hot_after:
            if h > cap_:
                new_cap = max(-(-h // 8) * 8, 2 * cap_)
                grow_peak = max(grow_peak, k * (cap_ + new_cap) * row_b)
                cap_ = new_cap
        padded_b = k * cap_ * row_b
        zero_counts()
        res, ms = time_batches(index)
        counts = read_counts()
        count_run(counts, paged=True)
        base = "flash_probe_store" if codec == "fp32" \
            else "flash_probe_store_q8"
        check(counts[base] > 0, f"{tag} kernels launched: {counts}")
        if brute is None:   # the q8 store holds the same rows and ids
            brute = [index.search_brute(qb, topk=TOPK)[0] for qb in queries]
        recall = statistics.mean(recall_at_k(ids, ids_b) for (ids, _), ids_b
                                 in zip(res, brute))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rec = {"codec": codec, "N": n, "K": k, "d": d, "page_size": PAGE,
               "hottest_cell_rows": hottest, "gather_width": width,
               "occupied_pages": index.store.occupied_pages(),
               "resident_bytes": index.resident_bytes(),
               "padded_required_bytes": padded_b,
               "padded_growth_peak_bytes": grow_peak, "add_s": add_s,
               "alloc_s": alloc_s, "ms_per_batch": statistics.median(ms),
               "batch_ms": ms, "recall_at_10": recall, "launches": counts,
               "peak_gib": peak_gib}
        details["paged_skew"].append(rec)
        print(f"  hottest cell {hottest} rows; gather_width {width}; "
              f"{rec['occupied_pages']} pages occupied, resident "
              f"{rec['resident_bytes'] / 2**30:.3f} GiB; the padded layout "
              f"would need {padded_b / 2**30:.2f} GiB ({grow_peak / 2**30:.2f}"
              f" GiB while growing); adds "
              + ", ".join(f"{t:.3f}" for t in add_s) + " s (allocator "
              + ", ".join(f"{t:.3f}" for t in alloc_s) + f" s); "
              f"{rec['ms_per_batch']:.3f} ms per batch (CUDA events, median "
              f"of {len(ms)}); recall@{TOPK} {recall:.4f} (vs search_brute);"
              f" peak {peak_gib:.2f} GiB", flush=True)
        check(recall >= 0.9, f"{tag} recall@{TOPK} {recall:.4f} >= 0.9")
        check(alloc_s[0] < 1.0, f"{tag}: the first add's allocator time "
                                f"{alloc_s[0]:.3f} s < 1 s")
        if codec == "fp32":
            total = torch.cuda.get_device_properties(0).total_memory
            check(grow_peak > total > 20 * index.resident_bytes(),
                  f"{tag}: the padded layout would need {grow_peak / 2**30:.1f}"
                  f" GiB to grow to this corpus, beyond the card's "
                  f"{total / 2**30:.1f} GiB; the paged store holds it in "
                  f"{index.resident_bytes() / 2**30:.2f} GiB")
        check(all(ids.shape == (IVF_B, TOPK)
                  and bool(((ids >= 0) & (ids < n)).all())
                  and bool(torch.isfinite(dd).all()) for ids, dd in res),
              f"{tag} results: ids in [0, N), finite distances")
        del index, inner, res
    del x, queries, brute
    torch.cuda.empty_cache()

    # ---- phase 6c: the paged store under a byte budget --------------------
    # the uniform IVF corpus (seed 4, as phase 5 draws it), its rows sorted
    # by their blob so that each chunk covers other cells than the last,
    # into a paged fp32 store of half the full store's page bytes
    gen_ivf = torch.Generator(device=dev).manual_seed(SEED + 4)
    centers = torch.randn(k, d, device=dev, generator=gen_ivf) * 5.0
    lab = torch.randint(0, k, (n,), device=dev, generator=gen_ivf)
    x = centers[lab] + 0.4 * torch.randn(n, d, device=dev, generator=gen_ivf)
    x = x[torch.argsort(lab, stable=True)]
    q = x[torch.randperm(n, device=dev, generator=gen_ivf)[:IVF_B]]
    budget = paged_page_bytes // 2
    tag = "paged_evict/fp32"
    print(f"\n[{tag}] N={n} d={d} K={k}, store_bytes {budget} (half the "
          f"full paged store's page bytes), rows added by blob in chunks of "
          f"{SKEW_CHUNK}", flush=True)
    index = IVFIndex(centers, 8, store="paged", page_size=PAGE,
                     store_bytes=budget, codec="fp32")
    add_s, evicted = [], []
    for lo in range(0, n, SKEW_CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells_last = index.add(x[lo:lo + SKEW_CHUNK])
        torch.cuda.synchronize()
        add_s.append(time.perf_counter() - t0)
        evicted.append(index.evicted)
    ids, dd = index.search(q, topk=TOPK, nprobe=NPROBE)
    listed = index.posting_lists()[0]
    stored = int(index.counts.sum())
    last = torch.unique(cells_last.long()).cpu().numpy()
    rec = {"N": n, "store_bytes": budget, "evicted": index.evicted,
           "spilled": index.spilled, "stored": stored,
           "evicted_after_add": evicted, "add_s": add_s,
           "resident_bytes": index.resident_bytes(),
           "occupied_pages": index.store.occupied_pages()}
    details["paged_evict"] = rec
    print(f"  evicted {index.evicted} rows, spilled {index.spilled}, stored "
          f"{stored}; evicted after each add {evicted}; adds "
          + ", ".join(f"{t:.3f}" for t in add_s) + " s; resident "
          f"{index.resident_bytes() / 2**30:.3f} GiB", flush=True)
    check(index.evicted > 0, f"{tag}: the budget evicted rows "
                             f"({index.evicted})")
    check(index.n_total - index.evicted - index.spilled == stored,
          f"{tag}: n_total {index.n_total} - evicted {index.evicted} - "
          f"spilled {index.spilled} == rows stored {stored}")
    check(bool(torch.isin(ids[ids >= 0], listed).all()),
          f"{tag}: every id a search returns is in posting_lists()")
    check(bool((index.evict_counts[last] == 0).all()),
          f"{tag}: the {last.size} cells of the last add keep their rows "
          f"(evict_counts 0)")
    check(bool(((ids >= -1) & (ids < n)).all())
          and bool(torch.isfinite(dd[ids >= 0]).all()),
          f"{tag}: ids valid or -1, finite distances where found")
    del index, x, q, centers, lab, ids, dd, listed
    torch.cuda.empty_cache()

    # ---- phase 7: out-of-core Lloyd (ChunkedKMeans, paper §4.3) ----------
    # a corpus logically larger than the card, streamed from a pool of
    # distinct pinned chunks (their repeats leave the statistics exact over
    # the logical multiset); the pool drawn on the card (seed 11), then
    # copied to pinned host memory
    n, d, k = OOC_N, 128, OOC_K
    chunk, pool_n = OOC_CHUNK, OOC_POOL
    host_ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    cuts = []
    while host_ram < 4 * pool_n * chunk * d * 4 and chunk > 2 ** 16:
        chunk //= 2
        cuts.append(f"pool chunks halved to {chunk} rows: host RAM "
                    f"{host_ram / 2**30:.1f} GiB < 4x the pool")
    rec = details["out_of_core"]
    rec.update(N=n, N_small=OOC_N_SMALL, K=k, d=d, chunk=chunk,
               pool_chunks=pool_n, host_ram_gib=host_ram / 2**30, cuts=cuts)
    print(f"\n[out_of_core] ChunkedKMeans: logical N={n} "
          f"({n * d * 4 / 2**30:.0f} GiB f32), d={d}, K={k}, chunks of "
          f"{chunk} rows cycling a pinned pool of {pool_n}; host RAM "
          f"{host_ram / 2**30:.1f} GiB{'; ' + '; '.join(cuts) if cuts else ''}",
          flush=True)
    gen_o = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    xo = mixture(1, pool_n * chunk, k, d, gen_o)[0]
    c_o = xo[torch.randperm(xo.shape[0], device=dev, generator=gen_o)[:k]]
    pool = [torch.empty((chunk, d), dtype=torch.float32, pin_memory=True)
            .copy_(xo[i * chunk:(i + 1) * chunk]) for i in range(pool_n)]
    rec["pool_seconds"] = time.perf_counter() - t0
    cfg_o = KMeansConfig(k=k)

    def pool_source(rows):
        def chunks():
            for i in range(rows // chunk):
                yield pool[i % pool_n]
        return chunks

    # exactness: one chunked iteration over the pool against the in-core
    # step on the same centroids
    ck = ChunkedKMeans(cfg_o, chunk_size=chunk, device=dev)
    ids_ch = torch.empty(xo.shape[0], dtype=torch.int32, device=dev)
    c_ch, j_ch = ck.iterate(pool_source(pool_n * chunk), c_o,
                            assignments=ids_ch)
    c_in, a_in, j_in = KMeans(cfg_o, device=dev).iterate(xo, c_o)
    torch.cuda.synchronize()
    c_err = float((c_ch - c_in).abs().max())
    c_ok = bool(torch.allclose(c_ch, c_in, rtol=1e-5, atol=1e-5))
    j_rel = abs(float(j_ch) - float(j_in)) / float(j_in)
    ids_eq = bool(torch.equal(ids_ch, a_in))
    rec["exactness"] = {"rows": xo.shape[0], "ids_equal": ids_eq,
                        "centroid_max_abs_err": c_err,
                        "inertia_rel_err": j_rel}
    check(ids_eq and c_ok and j_rel <= 1e-5,
          f"out_of_core: one chunked iteration over the pool "
          f"({xo.shape[0]} rows) == the in-core step: ids equal "
          f"{ids_eq}, centroids within rtol=atol=1e-5 (max err "
          f"{c_err:.3g}), inertia rel err {j_rel:.3g} <= 1e-5")
    del xo, c_in, a_in, ids_ch, c_ch
    torch.cuda.empty_cache()

    def ooc_run(source, rows, iters, tag):
        """``iters`` chunked iterations; per iteration the wall and the
        ChunkedStats; the device peak over the run, less what was
        allocated before it (the earlier phases' tensors)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c, its = c_o, []
        for _ in range(iters):
            ck.stats = ChunkedStats()
            c, _ = ck.iterate(source, c)
            st = ck.stats
            byts = st.sampled_chunks * chunk * d * 4
            its.append({
                "ms": st.wall_seconds * 1e3, "chunks": st.chunks,
                "sampled_chunks": st.sampled_chunks,
                "h2d_gb_s": byts / st.h2d_seconds / 1e9,
                "h2d_ms_per_chunk": st.h2d_seconds / st.sampled_chunks * 1e3,
                "compute_ms_per_chunk":
                    st.compute_seconds / st.sampled_chunks * 1e3,
                "overlap": (st.h2d_seconds + st.compute_seconds)
                / st.wall_seconds,
                "staging_s": st.staging_seconds,
                "dispatch_h2d_s": st.dispatch_h2d_seconds,
                "dispatch_compute_s": st.dispatch_compute_seconds})
            it = its[-1]
            print(f"  {tag}: {it['ms']:.1f} ms an iteration ({it['chunks']} "
                  f"chunks), H2D {it['h2d_gb_s']:.2f} GB/s "
                  f"({it['h2d_ms_per_chunk']:.2f} ms a chunk), compute "
                  f"{it['compute_ms_per_chunk']:.2f} ms a chunk (events, "
                  f"{it['sampled_chunks']} warm chunks), overlap (h2d + "
                  f"compute) / wall {it['overlap']:.3f}, host staging "
                  f"{it['staging_s']:.3f} s", flush=True)
        return its, torch.cuda.max_memory_allocated() - base, base

    its_small, peak_small, _ = ooc_run(pool_source(OOC_N_SMALL), OOC_N_SMALL,
                                    1, f"N={OOC_N_SMALL}")
    zero_counts()
    its, peak_b, base = ooc_run(pool_source(n), n, OOC_ITERS, f"N={n}")
    counts = read_counts()
    for kname in launches:
        launches[kname] += counts[kname]
    rec.update(iterations=its, iterations_small=its_small,
               peak_bytes=peak_b, peak_bytes_small=peak_small,
               allocated_before=base, launches=counts)
    slots = 2 * chunk * d * 4   # ChunkedKMeans's two device slots
    rec["slot_bytes"] = slots
    print(f"  device peak {peak_b / 2**20:.1f} MiB at N={n}, "
          f"{peak_small / 2**20:.1f} MiB at N={OOC_N_SMALL}, above the "
          f"{base / 2**20:.1f} MiB allocated before (which holds "
          f"ChunkedKMeans's two slots, {slots / 2**20:.0f} MiB)",
          flush=True)
    check(abs(peak_b - peak_small) <= 8 * 2**20,
          f"out_of_core: the device peak does not grow with N "
          f"({peak_b / 2**20:.1f} MiB at {n}, {peak_small / 2**20:.1f} at "
          f"{OOC_N_SMALL}, within 8 MiB)")
    check(all(r["staging_s"] == 0.0 for r in its),
          "out_of_core: pinned chunks are copied from their own memory "
          "(no host staging)")
    check(counts["flash_assign"] == OOC_ITERS * n // chunk
          and counts["sort_inverse_update"] == OOC_ITERS * n // chunk,
          f"out_of_core: one FlashAssign and one sort-inverse launch a "
          f"chunk (two-pass at K={k}): {counts}")
    # the same iteration from a pageable numpy source: each chunk staged
    # into pinned memory on the host first
    x_np = torch.cat(pool[:OOC_NUMPY // chunk]).numpy()
    ck.iterate(x_np[:chunk], c_o)   # allocates the pinned staging buffers
    its_np = ooc_run(x_np, OOC_NUMPY, 1, f"numpy N={OOC_NUMPY}")[0]
    its_pin = ooc_run(pool_source(OOC_NUMPY), OOC_NUMPY, 1,
                      f"pinned N={OOC_NUMPY}")[0]
    rec.update(numpy_source=its_np[0], pinned_source=its_pin[0])
    check(its_np[0]["staging_s"] > 0,
          "out_of_core: a numpy source is staged into pinned memory "
          f"({its_np[0]['staging_s']:.3f} s on the host)")
    del x_np, pool, ck
    torch.cuda.empty_cache()

    # ---- phase 8: streaming (StreamingKMeans) ----------------------------
    k = STREAM_K
    sizes, gen_s, centers, drifting = drifting_stream(dev, d)
    print(f"\n[streaming] StreamingKMeans(k={k}, decay={STREAM_DECAY}, "
          f"init_size={STREAM_INIT}): {STREAM_BATCHES} ragged batches of "
          f"{min(sizes)}-{max(sizes)} rows, d={d}, drifting centres",
          flush=True)
    planner = P.default_planner(dev)
    sk = StreamingKMeans(KMeansConfig(k=k), decay=STREAM_DECAY,
                         init_size=STREAM_INIT, device=dev)
    # warm-up: the batches buffered for the init draw, the bootstrap, and
    # every later batch up to the first of the last new shape bucket; after
    # it the planner must only hit
    boot = next(i for i in range(len(sizes))
                if sum(sizes[:i + 1]) >= STREAM_INIT)
    seen, warm_from = set(), boot + 1
    for i in range(boot + 1, len(sizes)):
        if P.bucket_dim(sizes[i]) not in seen:
            seen.add(P.bucket_dim(sizes[i]))
            warm_from = i + 1
    evs, calls_warm = [], None
    zero_counts()
    for i, rows in enumerate(sizes):
        xb = drifting(rows)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sk.partial_fit(xb)
        e1.record()
        evs.append((e0, e1))
        if i == boot:
            check(sk.centroids is not None and sk.n_batches == boot + 1,
                  f"streaming: the init draw at batch {boot}, after "
                  f"{sum(sizes[:boot + 1])} buffered rows")
        if i + 1 == warm_from:
            calls_warm = planner.counters()["chooser_calls"]
    torch.cuda.synchronize()
    counts = read_counts()
    for kname in launches:
        launches[kname] += counts[kname]
    calls_end = planner.counters()["chooser_calls"]
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in evs[warm_from:])
    p50, p99 = ms[len(ms) // 2], ms[min(len(ms) - 1, int(0.99 * len(ms)))]
    rec = details["streaming"]
    rec.update(k=k, batches=STREAM_BATCHES, rows=sum(sizes),
               bootstrap_batch=boot, warm_from=warm_from,
               ms_p50=p50, ms_p99=p99, ms_warm=ms,
               chooser_calls_warm=calls_warm, chooser_calls_end=calls_end,
               launches=counts)
    print(f"  partial_fit p50 {p50:.3f} ms, p99 {p99:.3f} ms (CUDA events, "
          f"{len(ms)} warm batches from batch {warm_from}; bootstrap at "
          f"batch {boot}); chooser calls {calls_warm} after the warm-up, "
          f"{calls_end} at the end; {sum(sizes)} rows", flush=True)
    check(calls_end == calls_warm,
          f"streaming: no plan after the warm-up (chooser calls "
          f"{calls_warm} -> {calls_end})")
    check(counts["flash_assign"] > 0 or counts["flash_lloyd"] > 0,
          f"streaming: the stream ran the Lloyd kernels: {counts}")
    warm = [drifting(rows) for rows in sizes[-3:]]
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk.partial_fit(warm[0])
        sk.partial_fit(warm[1])
        sk.update(warm[2])
    except RuntimeError as e:
        err = str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(err is None, f"streaming: a warm partial_fit and update make no "
                       f"host sync (set_sync_debug_mode('error')): "
                       f"{err or 'nothing raised'}")
    # decay=1: one epoch of disjoint batches against one full-batch Lloyd
    # pass from the same centroids
    xe = mixture(1, STREAM_EPOCH, k, d, gen_s)[0]
    c_e = xe[torch.randperm(STREAM_EPOCH, device=dev, generator=gen_s)[:k]]
    c1 = KMeans(KMeansConfig(k=k), device=dev).iterate(xe, c_e)[0]
    j_full = float(ops.flash_assign(xe, c1)[1].sum())
    sk1 = StreamingKMeans(KMeansConfig(k=k), decay=1.0, device=dev)
    stream_from_numpy(sk1, {"centroids": c_e.cpu().numpy(),
                            "sums": torch.zeros(k, d).numpy(),
                            "counts": torch.zeros(k).numpy(),
                            "inertia": torch.zeros(()).numpy(),
                            "n_batches": 0})
    for lo in range(0, STREAM_EPOCH, STREAM_ROWS[1]):
        sk1.partial_fit(xe[lo:lo + STREAM_ROWS[1]])
    j_stream = sk1.inertia(xe)
    rec.update(epoch_rows=STREAM_EPOCH, epoch_inertia=j_stream,
               lloyd_pass_inertia=j_full)
    check(j_stream <= 1.02 * j_full,
          f"streaming: decay=1, one epoch of {STREAM_EPOCH // STREAM_ROWS[1]}"
          f" disjoint batches: inertia {j_stream:.6g} within 2% of one "
          f"full-batch Lloyd pass's {j_full:.6g} (ratio "
          f"{j_stream / j_full:.4f})")
    del xe, c1, sk1, sk, warm, centers
    torch.cuda.empty_cache()

    # ---- phase 9: the out-of-core IVF build (IVFIndex.build(chunk_size=))
    n, k, d = OOC_IVF
    gen_b = torch.Generator(device=dev).manual_seed(13)
    centers = torch.randn(k, d, device=dev, generator=gen_b) * 5.0
    xb = centers[torch.randint(0, k, (n,), device=dev, generator=gen_b)]
    xb += 0.4 * torch.randn(n, d, device=dev, generator=gen_b)
    qb = centers[torch.randint(0, k, (IVF_B,), device=dev, generator=gen_b)]
    qb += 0.4 * torch.randn(IVF_B, d, device=dev, generator=gen_b)
    x_host = xb.cpu().numpy()
    x_add = (centers[torch.randint(0, k, (3, ENGINE_ADD_ROWS), device=dev,
                                   generator=gen_b)]
             + 0.4 * torch.randn(3, ENGINE_ADD_ROWS, d, device=dev,
                                 generator=gen_b))
    del xb
    for codec in ("fp32", "q8"):
        print(f"\n[ooc_ivf/{codec}] IVFIndex.build(x_host, k={k}, "
              f"chunk_size={OOC_IVF_CHUNK}, max_iters=8): N={n} host rows, "
              f"d={d}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = IVFIndex.build(x_host, k=k, chunk_size=OOC_IVF_CHUNK,
                               max_iters=8, codec=codec, seed=SEED,
                               device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counts = read_counts()
        for kname in launches:
            launches[kname] += counts[kname]
        peak_b = torch.cuda.max_memory_allocated() - base
        ids, dd = index.search(qb, topk=TOPK, nprobe=NPROBE)
        ids_b, _ = index.search_brute(qb, topk=TOPK)
        recall = recall_at_k(ids, ids_b)
        add_ms = []
        for xa in x_add:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            index.add(xa)
            torch.cuda.synchronize()
            add_ms.append((time.perf_counter() - t1) * 1e3)
        details["ooc_ivf"].append(
            {"codec": codec, "N": n, "K": k, "d": d, "chunk": OOC_IVF_CHUNK,
             "build_s": build_s, "peak_bytes": peak_b,
             "allocated_before": base, "recall": recall,
             "cap": index.cap, "add_ms": add_ms, "launches": counts})
        print(f"  build {build_s:.3f} s, device peak {peak_b / 2**30:.3f} GiB"
              f" above the {base / 2**30:.3f} GiB allocated before (the "
              f"corpus {n * d * 4 / 2**30:.1f} GiB on the host), cap "
              f"{index.cap}; recall@{TOPK} {recall:.4f} vs search_brute at "
              f"nprobe {NPROBE}; adds of {ENGINE_ADD_ROWS} rows "
              f"{', '.join(f'{v:.2f}' for v in add_ms)} ms", flush=True)
        check(recall >= 0.9 and len(index) == n + 3 * ENGINE_ADD_ROWS,
              f"ooc_ivf/{codec}: recall@{TOPK} {recall:.4f} >= 0.9, "
              f"{len(index)} rows indexed")
        del index
    del x_host, centers, qb, x_add
    torch.cuda.empty_cache()

    # ---- phase 10: the planner: exhaustive tune, disk cache --------------
    print(f"\n[planner] exhaustive_tune at largeN_smallK f32 {TUNE}; the "
          f"disk cache", flush=True)
    rep = autotune.exhaustive_tune(*TUNE, device=dev)
    hw = P.detect_hardware(dev)
    heur = autotune.heuristic_tune(*TUNE, hw=hw)
    h_key = ("update", heur.best.update_block_n, heur.best.update_block_k)
    ratio = rep.table[h_key] / rep.best_update_us
    for (kind, bn, bk), us in sorted(rep.table.items()):
        print(f"  {kind} ({bn}, {bk}): {us / 1e3:.4f} ms"
              + ("  <- oracle" if (bn, bk) == (rep.best.update_block_n,
                                               rep.best.update_block_k)
                 and kind == "update" else "")
              + ("  <- heuristic" if (kind, bn, bk) == h_key else ""))
    print(f"  {rep.num_compiles} candidates timed in {rep.tune_seconds:.3f} "
          f"s; heuristic_tune {heur.tune_seconds * 1e3:.3f} ms; the "
          f"heuristic's update {rep.table[h_key] / 1e3:.4f} ms over the "
          f"oracle's {rep.best_update_us / 1e3:.4f} ms = {ratio:.4f}",
          flush=True)
    rec = details["planner"]
    rec.update(shape=TUNE, table={f"{kd}/{bn}/{bk}": us for (kd, bn, bk), us
                                  in rep.table.items()},
               oracle=dataclasses.asdict(rep.best),
               heuristic=dataclasses.asdict(heur.best),
               tune_seconds=rep.tune_seconds,
               heuristic_seconds=heur.tune_seconds,
               heuristic_over_oracle=ratio, candidates=rep.num_compiles)
    check(h_key in rep.table and ratio >= 1.0,
          f"planner: the heuristic's tiles {h_key[1:]} are a timed candidate "
          f"({ratio:.4f}x the oracle)")
    path = ROOT / "build" / "chip_smoke_roundtrip.json"
    path.unlink(missing_ok=True)
    shapes = [("step", (rn, rk, rd), getattr(torch, rdt).itemsize)
              for _, rn, rk, rd, _, rdt, _ in REGIMES] + [
        ("probe", (IVF_B, IVF[1], IVF[2], NPROBE), 4),
        ("scan_store", (IVF_B, NPROBE, 3056, IVF[2], TOPK), 4)]
    first = P.KernelPlanner(device=dev, cache_path=path)
    for op, sh, isz in shapes:
        first.plan(op, sh, isz)
    first.fold_measured(*TUNE, report=rep)
    again = P.KernelPlanner(device=dev, cache_path=path)
    same = all(again.plan(op, sh, isz) == first.plan(op, sh, isz)
               for op, sh, isz in shapes)
    measured = again.plan("step", TUNE)
    rec["disk"] = {**again.counters(), "entries_on_disk": len(json.loads(
        path.read_text())["plans"]), "measured_source": measured.source}
    print(f"  disk cache {path.name}: a second planner {again.counters()}",
          flush=True)
    check(same and again.counters()["chooser_calls"] == 0
          and measured.source == "measured"
          and measured.block.update_block_n == rep.best.update_block_n,
          f"planner: the disk cache round-trips ({len(shapes)} plans and the "
          f"measured one) with 0 chooser calls: {again.counters()}")

    # ---- phase 11: the reliability layer (reliability_phase) -------------
    for store_kind, counts in reliability_phase(dev, smi, zero_counts,
                                                read_counts, details):
        count_run(counts, store_kind == "paged")

    # ---- phase 12: the parallel layer (parallel_phase) -------------------
    par_runs, par_checks = parallel_phase(dev, smi, zero_counts, read_counts,
                                          details)
    for counts, paged in par_runs:
        count_run(counts, paged)
    for name, counts, paged in par_checks:
        count_check(name, counts, paged)

    # ---- phase 13: LM serving (lm_phase) ------------------------------------
    # what the earlier phases left on the card (14.3 GiB): the IVF phase's
    # gathered block and store arrays, indexes held by timing closures'
    # defaults, the regimes' inputs; phase 13 needs 45 GiB of its own
    del (cand_x, run, args_, buckets, cache, assign_plain_chunked, codes_r,
         update, x2, codes_s, map_pages, timed_map, scales_r, lookup,
         bucket_ids, scales_s, xa, rows_c, cand, qp, ooc_run, c_o, two, live,
         cells_last)
    lm_runs, lm_checks, lm_errs = lm_phase(dev, smi, zero_counts,
                                           read_counts, details)
    for counts in lm_runs:
        count_run(counts)
    for name, counts in lm_checks:
        count_check(name, counts)
    for kname, err in lm_errs.items():
        max_err[kname] = max(max_err[kname], err)

    # ---- phase 14: the rest of the LM zoo (zoo_phase) --------------------
    zoo_runs, zoo_checks, zoo_errs = zoo_phase(dev, smi, zero_counts,
                                               read_counts, details)
    for counts in zoo_runs:
        count_run(counts)
    for name, counts in zoo_checks:
        count_check(name, counts)
    for kname, err in zoo_errs.items():
        max_err[kname] = max(max_err[kname], err)

    # ---- phase 15: training (train_phase) --------------------------------
    train_runs, train_checks, train_errs = train_phase(
        dev, smi, zero_counts, read_counts, details)
    for counts in train_runs:
        count_run(counts)
    for name, counts in train_checks:
        count_check(name, counts)
    for kname, err in train_errs.items():
        max_err[kname] = max(max_err[kname], err)

    # ---- phase 4: the kernel table ---------------------------------------
    main_shape = {"flash_assign": "largeN_smallK/float32",
                  "sort_inverse_update": "largeN_smallK/float32",
                  "flash_lloyd": "smallN_smallK/float32",
                  "rescore_cache_insert": "ivf",
                  **{kname: "ivf" for kname in probe_names}}
    sources = {"flash_assign": "src/repro_torch/csrc/flash_assign.cu",
               "sort_inverse_update":
                   "src/repro_torch/csrc/sort_inverse_update.cu",
               "flash_lloyd": "src/repro_torch/csrc/flash_lloyd.cu",
               "rescore_cache_insert": "src/repro_torch/csrc/rescore_cache.cu",
               **{kname: "src/repro_torch/csrc/flash_probe.cu"
                  for kname in probe_names}}
    # the cache insert replaces no pl.pallas_call: the reference's insert
    # is the jitted fori_loop _cache_insert
    replaces = {"flash_assign": "src/repro/kernels/flash_assign.py:77",
                "rescore_cache_insert": "src/repro/index/rescore_cache.py:99",
                "sort_inverse_update":
                    "src/repro/kernels/sort_inverse_update.py:104",
                "flash_lloyd": "src/repro/kernels/flash_lloyd.py:118",
                "flash_probe_tile": "src/repro/kernels/flash_probe.py:301",
                "flash_probe": "src/repro/kernels/flash_probe.py:301",
                "flash_probe_grouped_warp":
                    "src/repro/kernels/flash_probe.py:261",
                "flash_probe_grouped": "src/repro/kernels/flash_probe.py:261",
                "flash_probe_store": "src/repro/kernels/flash_probe.py:261",
                "flash_probe_grouped_q8":
                    "src/repro/kernels/flash_probe.py:215",
                "flash_probe_store_q8":
                    "src/repro/kernels/flash_probe.py:215"}
    # the block q8 scan left the main path (the store scan took its place),
    # and the probe's and block scan's list modes (their tile and warp modes
    # took their place there): each is held to its plain version and timed
    # at the main path's shapes, and launched by no main path
    off_main = {"flash_probe_grouped_q8", "flash_probe", "flash_probe_grouped"}
    # one empty launch: the least device time of any launch (the floor the
    # kernel table's latency-bound kernels are ranked against)
    empty = {"device_ms": device_ms_of(lambda: _build.empty_launch(dev),
                                       reps=20),
             "ms": ms_of(lambda: _build.empty_launch(dev), reps=100)}
    details["empty_launch"] = empty
    print(f"  an empty launch: device {empty['device_ms']:.4f} ms, "
          f"{empty['ms']:.4f} ms a call back to back (CUDA events)",
          flush=True)
    table = []
    for kname in launches:
        t = timing[f"{main_shape[kname]}/{kname}"]
        t_bytes = t["bytes"] / HBM_BW * 1e3
        t_ops = t["ops"] / peak(kname, t["dtype"]) * 1e3
        table.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname], "launches": launches[kname],
            "check_launches": check_launches[kname],
            "max_abs_err": max_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": t["dtype"]})
        if kname in off_main:
            check(launches[kname] == 0, f"{kname} is off the main path (0 "
                                        f"launches: {launches[kname]})")
        else:
            check(launches[kname] > 0, f"{kname} launched on the main path "
                                       f"({launches[kname]} launches)")
    # the store scans' paged mode: the same kernels reading rows through
    # the paged store's page table, launched by the paged stores' runs
    for kname, base_ in PAGED_ROWS.items():
        t = timing[f"ivf/{kname}"]
        t_bytes = t["bytes"] / HBM_BW * 1e3
        t_ops = t["ops"] / peak(base_, t["dtype"]) * 1e3
        table.append({
            "name": kname, "route": "cuda", "source": sources[base_],
            "replaces": replaces[base_], "launches": paged_launches[kname],
            "check_launches": check_launches[kname],
            "max_abs_err": max_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": t["dtype"]})
        check(paged_launches[kname] > 0,
              f"{kname} launched on the paged stores' paths "
              f"({paged_launches[kname]} launches)")
    for tag, t in timing.items():
        t_bytes = t["bytes"] / HBM_BW * 1e3
        kn = tag.rsplit("/", 1)[1]
        t_ops = t["ops"] / peak(PAGED_ROWS.get(kn, kn), t["dtype"]) * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        cuda_core = (f", CUDA-core bound {t['bound_cuda_core_ms']:.3f} ms"
                     if "bound_cuda_core_ms" in t else "")
        per_query = (f", bound with each query's own rows "
                     f"{t['bound_query_rows_ms']:.3f} ms"
                     if "bound_query_rows_ms" in t else "")
        lib = (f"; library {t['library_ms']:.4f} ms, the kernel "
               f"{'faster' if t['ms'] < t['library_ms'] else 'slower'}"
               if t["library_ms"] is not None else "")
        if t.get("device_launch_ms") is not None:
            lib += f"; device time a launch {t['device_launch_ms']:.4f} ms"
        if "graph_ms" in t:
            lib += f"; in a CUDA graph {t['graph_ms']:.4f} ms a call"
        if "device_ms" in t:
            lib += f"; device time {t['device_ms']:.4f} ms" + (
                f" against the library's {t['library_device_ms']:.4f} ms"
                if t["library_device_ms"] is not None else "")
        if "two_call_ms" in t:
            lib += (f"; two calls (addmm, topk) {t['two_call_ms']:.4f} ms, "
                    f"device {t['two_call_device_ms']:.4f} ms")
        print(f"  {tag}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}{cuda_core}{per_query}; plain "
              f"{t['plain_ms']:.3f} ms{lib})")
    details["timing"] = timing
    details["failures"] = failures
    details["seconds"] = time.perf_counter() - t_main
    print(f"[smoke] {details['seconds']:.1f} s from its start to the end of "
          f"its checks", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    if failures:
        print(f"\nchip_smoke: {len(failures)} check(s) failed:",
              file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
