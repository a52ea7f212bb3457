#!/usr/bin/env python3
"""Drive the PyTorch port (nann_tpu_torch) through its main path on one GPU.

    python3 chip_smoke.py

Phases, each printed with its wall seconds; any failure raises and the
script exits non-zero:

  1 device   the card's name, and its name and power limit from nvidia-smi
  2 build    the CUDA kernel libraries (nvcc, one per source) and the native
             HNSW builder (g++), all side by side with the making of phase
             7c's and phase 7f's synthetic data (numpy)
  3 kernel   the frontier-scorer kernel against its plain PyTorch version on
             the card: ids [16, 4096] (L = 50 and 7) and the main path's
             shapes [64, 4096], [64, 2880], [64, 90] (L = 50), ~10% invalid,
             then [64, 2880] and [64, 4096] with a search-shaped mask (the
             first 1,516 rows of each query valid, as the level-1 hop fills
             them, padding after), into a 100k-row table, float32 and
             bfloat16; then packed int8 tables (int8 [N, 68]) at float32 and
             bfloat16 compute: ids [64, 4096], [64, 2880], [64, 90] and the
             prefix-masked [64, 2880] into the 100k items, and [64, 8192]
             into a 4,200,000-row table (the reference scale and its
             frontier cap), timed with fresh ids on every call so that its
             rows come from HBM; each case with its launch plan (rows a
             block, shared bytes, blocks an SM: the wrapper's and the
             device's), timed with CUDA events and by device time
             (torch.profiler), the kernel's and the plain version's. Then the
             byte-map backend's kernels (gather_elems, gather_rows,
             scatter_set) against their plain versions, bit-exact: the row
             gather at the TPU probe's shape and at neighbours [100,000, 64]
             x ids [64, 400]; the element gather and the scatter at every
             case of scripts/bench_visited.py: the TPU probes' shapes (an
             int32 table of 200,064, 12,800 ids, also as [1563, 128]; the
             lane gather [100, 128] x [100, 128]), the search's shapes (uint8
             [64, 125,600] x ids [64, 25,600], the lane gathers behind its
             top-ks) in random order and in the search's own orders
             (vis_unvisited on sorted ids with n pads, vis_mark on
             _pad_trash of sorted ids with 4,096 marks a row, the wide hop's
             neighbour-row and score orders, top-k order for the lane
             gathers), and each side of every bound of the launch plan
             (_visited_plan; rows that start off 16 bytes); each case with
             its plan (path, grid, threads, shared bytes, blocks an SM), its
             bound and the time of one PyTorch call that computes the same
             function. Then the row sort
             and row top-k (row_sort, row_topk) against their plain versions,
             bit-exact in values and indices, at the TPU probes' shapes
             ([100, 128] sort, 12,800 -> 128 top-k) and at every shape the
             search gives them, on rows salted with ties, runs of -inf, -0.0
             beside +0.0 and negative int32; each with its bound and the time
             of torch.sort(stable=True) or torch.topk on the same inputs. The
             sort also at its paths' boundaries (short rows up to 8,192 keys,
             tiles of 4,096) and at [1, 100,000], each case with its path
             and tile count, and twice on the same rows (equal bits); the
             top-k likewise at its paths' boundaries (k = W, k above 8,192)
             and on tie groups that span tiles (every key equal, a run of
             -inf longer than a tile holding the k-th key, float32 keys that
             all share their first digit), twice on the same rows; and at
             the sampler's shape: the Gumbel-perturbed [1, 4,200,000] row
             phase 7c's first train step draws from, k = 160,000, and the
             sort of its 160,000 winners with their permutation (row_sort
             beside torch.sort(stable=True)).
             Every byte-map and select case, and its library call, is
             timed twice: CUDA events around 10 calls (host work included)
             and its device time per call from torch.profiler (every device
             kernel of a call: a tiled sort launches nine, a tiled top-k
             ten)
  4 bundle   random serving-width weights (seeded) and 100,000 items of width
             64; HNSW graph (M=32, ef_construction=64); the bundle is written
             with the port's writer to a temporary directory and read back
  5 search   64 queries through the batched search on the kernel path and on
             the plain path; top-200 overlap, per-hop num_scoring, the
             launches of every kernel of the path (each must launch), scores
             of common ids within the bfloat16 tolerance; the same search with
             the kernel scorer and the plain selects, whose ids, scores and
             num_scoring must equal the kernel path's; recall@200 against the
             brute-force oracle, whose top-k runs through row_topk and must
             give the ids of the plain top-k
  6 engine   the serving engine on the bundle (every bucket of the ladder
             1-128 warmed), 64 requests from 4 threads, each answer equal to
             the direct search
  6b front ends  on the same bundle: the engine calibrates its ladder into a
             file (each bucket's qps and the serving bucket printed) and a
             second engine reads it back ("cached"); 128 queries through the
             batched search on the kernel and plain paths (overlap, scores
             of common ids), then through an engine at serve_bucket=128, each
             answer equal to the direct search; NannServer on a free port:
             64 requests over http.client from 4 threads, then :reload of a
             second bundle (weight seed 1), answers equal to its direct
             search; a predict request and response through tfs_proto
             around engine.submit, and NannGrpcServer where grpc imports;
             ModelSelector over the list engine and a byte-map engine, each
             answer equal to its own direct search; run_load_test for 5 s
             at qps=-1 (its numbers with the card's name and power limit).
             The direct searches run first; launches are counted in the
             front ends' steps only (counts set to 0 before each step, read
             after it): every kernel of the path launched there, the scorer
             in every step, scatter_set in the selector's byte-map step and
             not in its list step
  7 int8     the same bundle loaded with dtype="int8": the 64 queries on the
             kernel and plain paths (overlap, scores of common ids), the
             launch counters (the int8 kernel and not the float one), wall
             times and device breakdown, overlap with phase 5's bfloat16
             search and recall@200 against its oracle; the search on an int8
             index built by SearchIndex.from_artifacts(dtype="int8",
             reorder="bfs") from the bundle's graph (overlap printed:
             overflowing hops truncate other nodes after the relabel), and
             at a frontier cap
             no hop reaches, where the relabel must not change the answer;
             the engine on the int8 index, each answer equal to the direct
             int8 search
  7b byte-map  phase 5's queries through vis_impl="bytemap": kernel path
             against plain path (overlap, scores), ids equal to phase 5's
             list search, every byte-map kernel launched, the filter half's
             device time; mark_policy="all", hop_mode="wide",
             topk_impl="approx" and semantics="serving", each kernel vs plain
             with num_scoring per hop and recall@200; per-hop caps from
             autotune_hop_caps, ids equal to the scalar-cap search, and the
             scorer's launch widths at those caps
  7c train  training at the reference's scale (4,200,000 synthetic items,
             TrainConfig's defaults: batch 800, 200 unique negatives each,
             lr 3e-3, wd 1e-4, adv_eps 3e-5) at the serving width in
             float32: train_loop for 5 steps with checkpoints, then a second
             train_loop resumed from step_5 for one step; each step's wall
             ms (CUDA events) and metrics (finite, loss_adv not below float32's
             noise), peak memory, the resumed step's device time by kernel
             family (torch.profiler), row_topk launched once a step (the
             sampler) and no other kernel; extract_item_embeddings over all
             4.2M items (a sample held against the CPU); then the trained
             tail: HNSW over the first 100,000 items' embeddings, the bundle
             written at the bfloat16 serving type and read back, 64 test
             users through user_embed, kernel path against plain path
             (plain scorer and selects: overlap, scores), every kernel of the
             search launched, recall@200 against the brute-force oracle
  7d cli    the CLI, nann_tpu_torch.main.main, on the card job by job at
             100,000 synthetic items, its default widths in float32 and 20
             steps (CLI_ARGV): the `all` order (train, select_checkpoint,
             extract_feature, build_index, test_all, test, export,
             verify_export), parity, build_tree and test_tree (beam 200,
             branch 16), test with --bf16 and with --vis-impl bytemap,
             serve_bench after a bench conf of 3 s at qps=-1, each with its
             seconds and the kernels it launched (test_tree must launch the
             scorer, row_topk and gather_elems; the byte-map test
             scatter_set); recall@200 of test_all, test and test_tree and
             the parity; the tree search of 64 test users on the kernel path
             against the plain path (overlap, scores; its scorer widths,
             launches, wall and device time); then serve in a subprocess:
             one REST predict equal to the direct search, SIGINT, exit 0
  7e staged and sharded  phase 5's 64 queries through the staged searcher
             (search/staged.py) on the list, byte-map and int8 indexes: ids,
             scores and num_scoring equal to phases 5, 7b and 7's fused
             searches bit for bit, the plain path's to phase 5's plain path,
             and each search's launches equal to the fused search's; the
             device ms and kernels of every stage of the list search (a
             utils/trace census a stage: prep, enter, a filter and a score
             stage per hop, final); Engine(staged=True) answering 16
             requests equal to the direct search. Then a spawned world of 2
             ranks on the one card (gloo over CUDA tensors, each rank 50,000
             rows of the bundle, make_mesh(dp=1, mp=2) and shard_index): the
             list, byte-map and int8 sharded searches of the 64 queries, on
             each rank ids, scores and num_scoring equal to the single-card
             search's, every kernel of the path launched, the wall of three
             searches, and the collectives of one search (count, bytes, and
             their ms with the card synchronized around each, against that
             search's wall); Engine(mesh=...) on rank 0 with EngineFollower
             on rank 1 answering 8 requests equal to the single-card search.
             A rank's failure fails the phase
  7f data-parallel training  a spawned world of 2 ranks on the one card
             (gloo over CUDA tensors) at phase 7c's configuration: rank 0
             first runs the single-card steps the world is held against;
             then make_mesh(dp=2, mp=1) and 3 steps of
             make_train_step(mesh=...) on each rank's 400 rows of the
             global batch of 800 (BatchIterator(mesh=...)): the first
             step's metrics, batch-norm state, gradients and parameters
             against the single-card step, both ranks' parameters, AdamW
             moments and
             batch-norm state bit-equal before and after every step (64-bit
             fingerprints compared), the same 160,000 negatives drawn on
             both ranks, row_topk launched once a rank a step and no other
             kernel; each step's wall and each rank's peak memory; one
             step's all_reduce calls and bytes, and the gradients'
             all-reduce bytes and ms (card synchronized around it). Then
             make_mesh(dp=1, mp=2) with train_state_shardings on a
             catalogue cut to 4,199,999 items and 49 categories (table
             rows 4,200,000 and 50 split over 2; 200 users x 4 samples):
             one step, the tables gathered whole against the single-card
             step, the replicated leaves bit-equal on both ranks, gather_rows
             launched inside the lookups. A rank's failure fails the phase
  8 kernels  one JSON line {"kernels": [...]}: frontier_scorer,
             frontier_scorer_int8, gather_elems (also the lane gather),
             gather_rows, scatter_set, row_sort, row_topk; gather_elems and
             scatter_set with the plan of their entry's case (the byte-map
             search's filtered hop in its sorted id order); each with its
             launches in phase 6b's front-end steps (launches_front_ends),
             per train step of phase 7c (launches_train: row_topk's 1, the
             sampler), in its trained tail's search (launches_trained_tail)
             and over phase 7d's in-process jobs (launches_cli); the
             scorer, row_topk and gather_elems also in one tree search
             (launches_tree); each with its launches over phase 7e's three
             staged searches (launches_staged) and over rank 0's three
             sharded searches (launches_sharded); and in phase 7f
             (launches_dp_train): row_topk's a rank a dp step, gather_rows'
             on rank 0 in the mp step
  9 result   the last line: {"ok": true, "device": {...}}

It needs one CUDA card and exits non-zero without one. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import http.client
import json
import multiprocessing
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from nann_tpu_torch import main as cli
from nann_tpu_torch.config import (ModelConfig, SearchConfig, TrainConfig,
                                   default_frontier_cap)
from nann_tpu_torch.data import synthetic_dataset
from nann_tpu_torch.delivery import (export_model, extract_item_embeddings,
                                     extract_user_embeddings,
                                     load_serving_bundle)
from nann_tpu_torch.index import build_and_save_index, load_index, load_tree
from nann_tpu_torch.index import hnsw_build
from nann_tpu_torch.index.quantize import pack_quantized
from nann_tpu_torch.kernels import build as kernel_build
from nann_tpu_torch.kernels import select_ops, visited_ops
from nann_tpu_torch.kernels.frontier_scorer import (frontier_scorer_plain,
                                                    kernel_weights,
                                                    library_plan,
                                                    score_frontier,
                                                    scorer_plan)
from nann_tpu_torch.models import init_scorer, item_tower, user_embed
from nann_tpu_torch.data import BatchIterator
from nann_tpu_torch.models.scorer import flatten
from nann_tpu_torch.parallel import (collectives, make_mesh,
                                     train_state_shardings, whole_leaf)
from nann_tpu_torch.ops import fold_scorer, precompute_user
from nann_tpu_torch.search import beam as search_beam
from nann_tpu_torch.search.autotune import autotune_hop_caps
from nann_tpu_torch.search import (DeviceTree, SearchIndex, brute_force_topk,
                                   level_topn_default, make_searcher,
                                   make_tree_searcher)
from nann_tpu_torch.search import tree as search_tree
from nann_tpu_torch.search.distributed import (make_distributed_searcher,
                                               shard_index)
from nann_tpu_torch.search.staged import make_staged_searcher
from nann_tpu_torch.serving import (Engine, EngineConfig, EngineFollower,
                                    Histogram,
                                    LoadGenConfig, ModelSelector, NannServer,
                                    run_load_test, tfs_proto)
from nann_tpu_torch.serving.grpc_server import NannGrpcServer, make_client_call
from nann_tpu_torch.train import loop as train_loop_mod
from nann_tpu_torch.train import sampler as train_sampler
from nann_tpu_torch.train.loop import checkpoint_steps, train_loop
from nann_tpu_torch.train import objective as train_objective
from nann_tpu_torch.train import step as train_step
from nann_tpu_torch.train.step import step_generator
from nann_tpu_torch.utils import calc_pr, torch_dtype, trace
from scripts import bench_visited

# the serving width of bench.py: item/user embeddings 64, attention
# 64 -> 128 -> 256, head (128, 64, 32, 1)
MCFG = ModelConfig(emb_dim=32, max_seq_length=50, compute_dtype="bfloat16")
SCFG = SearchConfig()
NUM_ITEMS = 100_000
HNSW_M, HNSW_EF = 32, 64
NUM_QUERIES = 64
# (B, F, L, mask): [16, 4096] at both L, then the main path's shapes (the
# ground hops, the level-1 hop, the enter points) with ~10% of the rows
# invalid at random ("random"); then the level-1 hop's and a ground hop's
# widths with the search's mask ("prefix"): each query's first LEVEL1_FILL
# rows valid, padding after, as _select_fresh orders them
KERNEL_CASES = [(16, 4096, 50, "random"), (16, 4096, 7, "random"),
                (64, 4096, 50, "random"), (64, 2880, 50, "random"),
                (64, 90, 50, "random"), (64, 2880, 50, "prefix"),
                (64, 4096, 50, "prefix")]
MAIN_SHAPE = (64, 4096, 50)
# the rows the level-1 hop fills of its 2,880 slots on this workload
# (num_scoring of a list search, PERF.md section 5)
LEVEL1_FILL = 1516
# the reference scale of bench.py, where int8 is the item table's default
REF_ITEMS = 4_200_000
# a frontier cap above any hop's expansion (400 candidates x degree 64 on
# the ground level), so that no hop truncates
NO_TRUNCATION_CAP = max(SCFG.top_k_per_level) * 2 * HNSW_M
# (B, F, L, table, mask) on packed int8 tables: the main path's ground hops,
# level-1 hop (also with the search's mask) and enter points, and a
# frontier at the reference scale's cap
INT8_CASES = [(64, 4096, 50, "100k", "random"), (64, 2880, 50, "100k", "random"),
              (64, 90, 50, "100k", "random"), (64, 2880, 50, "100k", "prefix"),
              (64, default_frontier_cap(REF_ITEMS), 50, "4.2M", "random")]
# phase 7c: the reference's training scale at the serving width: 4.2M
# synthetic items (50 categories, the JAX CLI's default), TrainConfig's
# defaults (batch 800, num_neg 200: 160,000 unique negatives a step drawn
# from one [1, 4.2M] row; lr 3e-3, wd 1e-4, adv_eps 3e-5), float32 compute
# (the CLI's default without --bf16), 1,000 users x 4 samples (5 batches);
# every step logged, one checkpoint kept. The trained tail indexes and
# serves the first TAIL_ITEMS items: a 100k-item HNSW build takes 39-69 s on
# the card machine's 8 cores, a 4.2M one does not fit the time limit.
TRAIN_MCFG = dataclasses.replace(MCFG, num_item=REF_ITEMS, num_cate=50,
                                 compute_dtype="float32")
TRAIN_TCFG = TrainConfig(print_freq=1, max_to_keep=1)
TRAIN_DATA = dict(num_item=REF_ITEMS, num_cate=50, num_users=1000,
                  max_seq_length=MCFG.max_seq_length, samples_per_user=4,
                  seed=0)
TRAIN_STEPS = 5            # then one step more, resumed from step_5
PROFILED_STEP = TRAIN_STEPS
SAMPLER_K = TRAIN_TCFG.batch_size * TRAIN_TCFG.num_neg
TAIL_ITEMS, TAIL_QUERIES = NUM_ITEMS, 64
# loss_adv (a KL, >= 0) is the difference of two float32 means near
# -log(1 + num_neg), 5.3: at adv_eps 3e-5 its true value (about 1e-9 at the
# serving width) lies below float32's spacing there, so a step reads 0 or
# one spacing either side. It is held at >= minus two spacings.
KL_FLOOR = 2 * float(np.spacing(np.float32(np.log(1 + TRAIN_TCFG.num_neg))))
TOL = {torch.float32: 2e-4, torch.bfloat16: 0.05}   # x (1 + |ref|)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}   # H100 SXM
PEAK_BYTES = 3.35e12
MIN_OVERLAP = 0.98
# phase 7e: the world of ranks on the one card, the engines' requests, and
# the expansion hops of a search
SHARDS = 2
SHARDED_REQUESTS = 8
STAGED_REQUESTS = 16
HOPS = sum(SCFG.num_scoring_per_level[:SCFG.hnsw_start_level])
# phase 7f: data-parallel training on a world of DP_RANKS ranks on the one
# card (gloo over CUDA tensors: NCCL takes one card a rank), phase 7c's
# configuration: dp=2 for DP_STEPS steps from the first DP_STEPS global
# batches of its data, then dp=1 x mp=2 for one step with the tables
# row-sharded, on a catalogue whose table rows split over 2 (4,199,999
# items and 49 categories: 4,200,000 and 50 rows; its data cut to 200 users
# x 4 samples, one global batch). Tolerances of tests/test_torch_train.py:
# metrics and batch-norm state rtol 1e-5 (loss_adv atol 1e-6), gradients
# atol 1e-6 + rtol 1e-4, ZERO_GRAD_LEAVES (gradient 0 in exact arithmetic)
# only held below 1e-6; parameters rtol 1e-6 + ADAM_ATOL x lr beyond the
# difference AdamW's first update makes of the two gradients,
# lr x |g / (|g| + eps) - g_ref / (|g_ref| + eps)|. That file leaves
# elements whose gradient is below 1e-6 at 2 x lr; near |g| = 1e-6 the
# update's eps / |g| turns a gradient difference of 1e-7 into steps 1e-6
# apart. At 160,800 rows float32 sums in another order move a few
# gradient elements of a leaf by up to 5e-6 (the single-card step on its
# batch with the two halves swapped, the same sums, does so by as much):
# the gradients get twice the largest difference that swap makes in each
# leaf on top of that file's tolerance.
DP_RANKS, DP_STEPS = 2, 3
MP_MCFG = dataclasses.replace(TRAIN_MCFG, num_item=REF_ITEMS - 1, num_cate=49)
MP_DATA = dict(TRAIN_DATA, num_item=REF_ITEMS - 1, num_cate=49,
               num_users=200)
ADAM_ATOL = 1e-5
ZERO_GRAD_LEAVES = ("item_tower/0/dense/bias", "item_tower/1/dense/bias",
                    "head/0/dense/bias", "head/1/dense/bias",
                    "head/2/dense/bias", "att/k2/bias")
# phase 6b: the batch the largest bucket of the ladder gives the kernels,
# the seed of its queries, the load test's seconds
FRONT_BATCH, FRONT_SEED, LOAD_S = 128, 6, 5.0
# phase 7d: the CLI (nann_tpu_torch.main) on the card, job by job, at its
# default widths (--emb-dim 32: item and user width 64, the serving width)
# in float32, its default; cut to 100k items (the HNSW build's time), its
# ef_construction to 64 as in phases 4 and 7c, and to 20 steps. The CLI's
# own clamp makes num_neg 125 (100,000 // 800). The bench conf gives
# serve_bench CLI_BENCH_S seconds at qps=-1.
CLI_ARGV = ["--synthetic", "--num-item", "100000", "--num-cate", "50",
            "--num-users", "2000", "--max-seq-length", "50",
            "--batch-size", "800", "--max-steps", "20", "--save-freq", "10",
            "--ef-construction", "64", "--num-test-batch", "256",
            "--search-batch", "64"]
CLI_BENCH_S = 3.0
CLI_TREE_QUERIES = 64
# the TPU probes' shapes (scripts/probe_kernel_ops.py:26-27, 169-172)
PROBE_ITEMS, PROBE_IDS = 200_064, 12_800
VISITED_OPS = (visited_ops.gather_elems, visited_ops.gather_rows,
               visited_ops.scatter_set)
SELECT_OPS = (select_ops.row_sort, select_ops.row_topk)
# the shapes the search gives the row sort (B = 64; chip_smoke's workload):
# widths of the list merge and the "exact" selection (the visited list grows
# by 4096 a hop), of the byte-map's expansion sort, and of the wide hop's
# stable id sort with its permutation; then the boundaries of its paths
# (short rows up to SHORT_ROW, tiles of SORT_TILE keys) and the ops layer's
# [1, 100,000]: (label, B, W, with_perm)
_T, _S = select_ops.SORT_TILE, select_ops.SHORT_ROW
SORT_CASES = [("merge, level 1", 64, 2970, False),
              ("merge, ground 1", 64, 13000, False),
              ("merge, ground 2", 64, 29896, False),
              ("merge, ground 3", 64, 33992, False),
              ("byte-map expansion", 64, 2880, False),
              ("byte-map expansion", 64, 12800, False),
              ("byte-map expansion", 64, 25600, False),
              ("wide id sort", 64, 8192, True),
              ("short rows, S + 1", 64, _S + 1, False),
              ("tiles, 3T - 1", 64, 3 * _T - 1, False),
              ("tiles, 3T + 1", 64, 3 * _T + 1, False),
              ("ops bitmap", 1, NUM_ITEMS, False)]
# (label, W, k, largest, dtype): every _masked_topk of a search, the "topk"
# and "approx" selections, the wide hop's selection, the oracle; then the
# boundaries of its paths (short rows up to SHORT_ROW keys, k = W, k above
# SHORT_ROW through the tiled sort)
TOPK_CASES = [("enter points", 90, 90, True, torch.float32),
              ("merge, level 1", 2970, 200, True, torch.float32),
              ("merge, level 1 (byte-map)", 2880, 200, True, torch.float32),
              ("merge, ground 1", 4296, 400, True, torch.float32),
              ("candidates, ground", 4096, 400, True, torch.float32),
              ("merge, ground 2-3", 4496, 400, True, torch.float32),
              ("final", 400, 200, True, torch.float32),
              ("select 'topk'", 33992, 4096, False, torch.int32),
              ("select 'approx'", 33992, 4096, False, torch.float32),
              ("wide selection", 25600, 8192, True, torch.float32),
              ("oracle", NUM_ITEMS, 200, True, torch.float32),
              ("short rows, S", _S, 200, True, torch.float32),
              ("tiles, S + 1", _S + 1, 200, True, torch.float32),
              ("tiles, k = W", _S + 1, _S + 1, True, torch.float32),
              ("tiles, k = S + 1", 33992, _S + 1, False, torch.int32)]
# (label, kind, W, k): tie groups across the tiled top-k's tiles (tie_rows)
TOPK_TIE_CASES = [("every key equal", "equal", 33992, 4096),
                  ("-inf run over 7 tiles, k-th in it", "neginf_run", 33992,
                   6000),
                  ("first digit shared", "one_digit", 33992, 4096)]
# row_sort calls of a list search on this workload: the merge and the
# "exact" selection of each of its 4 hops (level 1, three ground hops); its
# row_topk calls: the enter points, the merge and the candidates of each
# hop, and the final merge
SORTS_PER_LIST_SEARCH = 8
TOPKS_PER_LIST_SEARCH = 10
MAIN_SELECT = {"row_sort": "merge, ground 3",
               "row_topk": "merge, ground 2-3"}
# the case of each element kernel's entry in the kernels line: the byte-map
# search's filtered hop, in the search's id order
MAIN_VISITED = {"gather_elems": "search: vis_unvisited, sorted expansion",
                "scatter_set": "search: vis_mark, sorted with"}


@contextlib.contextmanager
def phase(name):
    """Print a phase's name, and its wall seconds when it succeeds."""
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f}s", flush=True)


TIMED_CALLS = 12   # cuda_ms's warm-up and timed calls together


def cuda_ms(fn) -> float:
    """Mean milliseconds of fn() on the card over 10 calls after 2 warm-up
    calls (CUDA events: utils/trace.py's `timed`)."""
    return trace.timed(fn, reps=TIMED_CALLS - 2, warmup=2, device="cuda")


def wall_ms(fn) -> float:
    """Host-clock milliseconds of fn() through to the card's last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_per_call(fn, symbols, calls=10, own_launches=None):
    """(device ms, device kernels, {kernel name: (device ms, launches)}) per
    call of fn(), from one torch.profiler session over `calls` calls: every
    device kernel (and memset) the session records counts, so a wrapper that
    launches several kernels a call is timed whole. None where it is not
    measured. The tracer now and then records no kernel of a short session,
    not the kernel's own (no name holds one of `symbols`), or, given
    `own_launches` (the kernel's launches a call), fewer of them, so such a
    session is taken once more."""
    for _ in range(2):
        events = trace.device_events(lambda: [fn() for _ in range(calls)])
        if events is None:
            return None
        own = [count for key, _, count in events
               if any(k in key for k in symbols)]
        if own and (own_launches is None
                    or sum(own) == own_launches * calls):
            return (sum(ms for _, ms, _ in events) / calls,
                    sum(count for _, _, count in events) / calls,
                    {trace.kernel_name(key): (ms / calls, count / calls)
                     for key, ms, count in events})
    return None


def device_ms_pair(kernel, library, symbols, calls=10):
    """The device milliseconds per call of kernel() and of library(), each
    from its own torch.profiler session (`device_per_call`); also kernel()'s
    device kernels per call, and {kernel name: (device ms, launches) per
    call}. (None, None, None, None) where it is not measured."""
    own = device_per_call(kernel, symbols, calls)
    lib = device_per_call(library, ("",), calls) if own else None
    if own is None or lib is None:
        return None, None, None, None
    return own[0], lib[0], own[1], own[2]


def row_flops(mcfg: ModelConfig, L: int) -> int:
    """Operations of the scorer chain for one frontier row."""
    d, du = mcfg.item_emb_dim, mcfg.user_emb_dim
    h1, dk = mcfg.att_proj_mult1 * du, mcfg.att_proj_mult2 * du
    g = list(mcfg.head_dims)
    macs = d * h1 + h1 * dk + dk * L + L * du + (du + d) * g[0]
    macs += sum(a * b for a, b in zip(g, g[1:]))
    return 2 * macs


def kernel_bound_ms(mcfg, dt, valid, L, weights, table):
    """Least time for the call: FLOPs of the valid rows over the peak rate of
    the compute type, or the bytes it must move over the memory rate. A
    packed int8 row moves D + 4 bytes and costs D more operations (the
    dequantizing product)."""
    B, F = valid.shape
    n_valid = int(valid.sum())
    esize = torch.finfo(dt).bits // 8
    du, dk = mcfg.user_emb_dim, mcfg.att_proj_mult2 * mcfg.user_emb_dim
    row_bytes = table.shape[1] * table.element_size()
    nbytes = (B * F * (4 + 1 + 4) + n_valid * row_bytes
              + B * L * (dk + du) * esize
              + sum(w.numel() * w.element_size() for w in weights.values()))
    flops = n_valid * row_flops(mcfg, L)
    if table.dtype == torch.int8:
        flops += n_valid * mcfg.item_emb_dim
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def hold_case(weights, k_proj, v, table, ids, valid, dt, label, mask,
              timing_ids=None):
    """One kernel case against the plain version on the same inputs: the
    -inf of invalid rows, the error, both times (CUDA events, and device
    time from torch.profiler), the bound and the launch plan. With
    `timing_ids` (one id tensor per timed call, warm-up included) each timed
    call gathers other rows, so a table larger than L2 is read from HBM."""
    got = score_frontier(weights, k_proj, v, table, ids, valid)
    want = frontier_scorer_plain(weights, k_proj, v, table, ids, valid)
    torch.cuda.synchronize()
    inval = ~valid
    if not (torch.isneginf(got[inval]).all()
            and torch.isneginf(want[inval]).all()):
        raise AssertionError("invalid rows must score -inf")
    if not (torch.isfinite(got[valid]).all()
            and torch.isfinite(want[valid]).all()):
        raise AssertionError("valid rows must score finite values")
    err = (got[valid] - want[valid]).abs()
    rel = (err / (1 + want[valid].abs())).max().item()
    def ids_for_call():
        return ids if timing_ids is None else next(calls)

    calls = iter(timing_ids or [])
    ms = cuda_ms(lambda: score_frontier(weights, k_proj, v, table,
                                        ids_for_call(), valid))
    calls = iter(timing_ids or [])
    plain_ms = cuda_ms(lambda: frontier_scorer_plain(weights, k_proj, v, table,
                                                     ids_for_call(), valid))
    calls = iter((timing_ids or [])[2:] * 2)
    own = device_per_call(lambda: score_frontier(weights, k_proj, v, table,
                                                 ids_for_call(), valid),
                          ("frontier_scorer",), own_launches=1)
    calls = iter((timing_ids or [])[2:] * 2)
    plain = device_per_call(lambda: frontier_scorer_plain(
        weights, k_proj, v, table, ids_for_call(), valid), ("",))
    device_ms = own[0] if own else None
    plain_device_ms = plain[0] if plain else None
    (B, F), L = ids.shape, k_proj.shape[1]
    bound, bound_by, flops, nbytes = kernel_bound_ms(MCFG, dt, valid, L,
                                                     weights, table)
    plan = scorer_plan(weights, k_proj, v, table)
    device_plan = library_plan(weights, k_proj, v, table, ids, valid)
    if device_plan[:3] != plan[:3] or \
            device_plan.blocks_per_sm < plan.blocks_per_sm:
        raise AssertionError(f"launch plan {plan} differs from the "
                             f"library's {device_plan}")
    blocks = -(-F // plan.rows)
    padded = torch.zeros((B, blocks * plan.rows), dtype=torch.bool,
                         device=valid.device)
    padded[:, :F] = valid
    working = int(padded.view(B, blocks, plan.rows).any(-1).sum())
    blocks *= B
    case = {"dtype": str(dt).replace("torch.", ""), "B": B, "F": F, "L": L,
            "table": label, "mask": mask, "valid_rows": int(valid.sum()),
            "max_abs_err": err.max().item(), "max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            "plain_device_ms": plain_device_ms, "bound_ms": bound,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "rows_per_block": plan.rows, "smem_bytes": plan.smem_bytes,
            "blocks_per_sm": device_plan.blocks_per_sm, "blocks": blocks,
            "blocks_with_valid_rows": working}

    def dev(t):
        return "not measured" if t is None else f"{t:.4f} ms"
    print(f"   kernel {case['dtype']:8s} {label:20s} ids [{B}, {F}] L={L:2d} "
          f"{mask:6s}: max|d|={case['max_abs_err']:.3e} "
          f"max|d|/(1+|ref|)={rel:.3e} (tol {TOL[dt]}) "
          f"kernel {ms:.4f} ms (device {dev(device_ms)}), plain "
          f"{plain_ms:.4f} ms (device {dev(plain_device_ms)}), "
          f"bound {bound:.4f} ms ({bound_by}); plan: {plan.rows} rows a "
          f"block, {plan.smem_bytes} B shared, {plan.blocks_per_sm} blocks "
          f"an SM (device: {device_plan.blocks_per_sm}); {working} of "
          f"{blocks} blocks hold a valid row", flush=True)
    if rel > TOL[dt]:
        raise AssertionError(f"kernel disagrees with plain version: "
                             f"{rel} > {TOL[dt]} ({case})")
    return case


def random_packed_table(n, d, dev, seed):
    """A packed int8 table [n, d+4] made on the card from a seed: int8
    values and positive float32 scales, in the layout of pack_quantized."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                      dtype=torch.int8)
    scales = torch.rand((n,), generator=g, device=dev) * (3 / 127) + 1e-3
    return torch.cat([q, scales.view(torch.int8).view(n, 4)], dim=1)


def check_kernel(params, state, table32, packed, gen):
    """Phase 3: kernel vs plain version on the card, at the serving width;
    float tables, then packed int8 tables. Returns (float cases, int8
    cases)."""
    dev = table32.device
    folded = fold_scorer(params, state, MCFG)

    def inputs(dt, B, F, L, n, mask):
        ids = torch.randint(0, n, (B, F), generator=gen,
                            dtype=torch.int32).to(dev)
        if mask == "prefix":
            valid = (torch.arange(F) < LEVEL1_FILL).expand(B, F).contiguous()
        else:
            valid = torch.rand((B, F), generator=gen) > 0.1
        valid = valid.to(dev)
        user = torch.randn((B, L, MCFG.user_emb_dim), generator=gen).to(dev)
        return (*precompute_user(folded, user, dt), ids, valid)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        table = table32.to(dt).contiguous()
        weights = kernel_weights(folded, dt)
        for B, F, L, mask in KERNEL_CASES:
            k_proj, v, ids, valid = inputs(dt, B, F, L, table.shape[0], mask)
            cases.append(hold_case(weights, k_proj, v, table, ids, valid, dt,
                                   f"{table.shape[0]:,} rows", mask))
    ref_table = random_packed_table(REF_ITEMS, MCFG.item_emb_dim, dev, seed=1)
    print(f"   packed int8 tables: {packed.shape[0]} x {packed.shape[1]} B "
          f"({packed.numel() / 1e6:.1f} MB), {ref_table.shape[0]} x "
          f"{ref_table.shape[1]} B ({ref_table.numel() / 1e6:.1f} MB)")
    int8_cases = []
    for dt in (torch.float32, torch.bfloat16):
        weights = kernel_weights(folded, dt)
        for B, F, L, which, mask in INT8_CASES:
            table = packed if which == "100k" else ref_table
            k_proj, v, ids, valid = inputs(dt, B, F, L, table.shape[0], mask)
            # the 4.2M table (285.6 MB) outgrows the 50 MB L2: fresh ids
            # for every timed call keep its rows from being read back warm
            timing_ids = None if which == "100k" else [
                torch.randint(0, table.shape[0], (B, F), generator=gen,
                              dtype=torch.int32).to(dev)
                for _ in range(TIMED_CALLS)]
            int8_cases.append(hold_case(weights, k_proj, v, table, ids, valid,
                                        dt, f"int8 {table.shape[0]:,} rows",
                                        mask, timing_ids))
    del ref_table
    return cases, int8_cases


def same_bits(got, want) -> bool:
    """Tensors, or tuples of them, of one shape and type and equal bits (a
    float's bits: -0.0 is not +0.0)."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(bits(g),
                                                                  bits(w))
        for g, w in zip(got, want))


def hold_exact(name, label, kernel, plain, library, nbytes, compare=None,
               symbols=None):
    """One kernel case of the byte-map's or the selects' kernels: the
    kernel's output against its plain version's, bit for bit (`compare()`
    gives both: for a scatter on fresh copies of the table, for a sort with
    its permutation; by default kernel() and plain()), kernel(), plain() and
    the one PyTorch call library() timed, and the bound: nbytes over the
    memory rate (each input read once, each output written once). The
    kernel and the library call are timed twice: `ms` and `library_ms`,
    CUDA events around back-to-back calls (host work included, where the
    host is slower than the card), and `device_ms` and `library_device_ms`,
    their own device time per call (torch.profiler; every device kernel of
    a call, whose names hold one of `symbols`, by default `{name}_kernel`)."""
    got, want = compare() if compare else (kernel(), plain())
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"{name} {label}: the kernel differs from its "
                             f"plain version")
    ms, plain_ms, library_ms = cuda_ms(kernel), cuda_ms(plain), \
        cuda_ms(library)
    device_ms, library_device_ms, per_call, by_kernel = device_ms_pair(
        kernel, library, symbols or (f"{name}_kernel",))
    bound = nbytes / PEAK_BYTES * 1e3

    def dev(t):
        return "not measured" if t is None else f"{t:.4f} ms"
    print(f"   {name:12s} {label:58s} bit-exact; kernel {ms:.4f} ms "
          f"(device {dev(device_ms)}), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (device {dev(library_device_ms)}), bound "
          f"{bound:.5f} ms (bytes); device kernels a call "
          f"{'not measured' if per_call is None else f'{per_call:g}'}",
          flush=True)
    if by_kernel and len(by_kernel) > 1:
        print("      device ms a call by kernel: " + ", ".join(
            f"{k} {ms:.4f} ({n:g} launches)"
            for k, (ms, n) in by_kernel.items()), flush=True)
    return {"name": name, "shape": label, "max_abs_err": 0.0, "ms": ms,
            "device_ms": device_ms, "device_kernels_per_call": per_call,
            "device_ms_by_kernel": by_kernel,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes}


def check_visited_kernels(dev):
    """Phase 3, second half: the byte-map's and the lane gathers' kernels
    against their plain versions. gather_rows at the TPU probe's shape (the
    probe's inputs, from its numpy seed) and at the main path's;
    gather_elems and scatter_set at every case of scripts/bench_visited.py:
    the probes' shapes, the search's shapes in random order and in the
    search's own id orders, and each side of every bound of the plan, each
    case with the plan the library picked. Returns {kernel name: [cases]};
    MAIN_VISITED names the case of each kernel's entry in the kernels line,
    gather_rows' is its last. The library calls take int64 indices, made
    before the timing."""
    vo = visited_ops
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.integers(0, 250, PROBE_ITEMS).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, PROBE_ITEMS, PROBE_IDS).astype(
        np.int32)).to(dev)
    tab2d = tab.view(-1, 128)
    rows = (idx.view(-1, 128)[:, 0] // 128).contiguous()
    n, B = NUM_ITEMS, NUM_QUERIES
    gen = torch.Generator(device=dev).manual_seed(0)
    neigh = torch.randint(0, n, (n, 2 * HNSW_M), generator=gen, device=dev,
                          dtype=torch.int32)
    cand = torch.randint(0, n, (B, 400), generator=gen, device=dev,
                         dtype=torch.int32)
    rows64, cand64 = rows.long(), cand.long().view(-1)
    gr = [
        hold_exact(
            "gather_rows", "probe build_gather_rows: int32 [1563, 128] x [100]",
            lambda: vo.gather_rows(tab2d, rows),
            lambda: vo.gather_rows_plain(tab2d, rows),
            lambda: torch.index_select(tab2d, 0, rows64),
            rows.numel() * (4 + 2 * 128 * 4)),
        hold_exact(
            "gather_rows", f"path take_rows: int32 [{n}, {2 * HNSW_M}] x "
            f"[{B}, 400]",
            lambda: vo.gather_rows(neigh, cand),
            lambda: vo.gather_rows_plain(neigh, cand),
            lambda: torch.index_select(neigh, 0, cand64),
            cand.numel() * (4 + 2 * 2 * HNSW_M * 4))]
    out = {"gather_elems": [], "gather_rows": gr, "scatter_set": []}
    for case in bench_visited.visited_cases(dev):
        t, ids, arg = case.table, case.ids, case.arg
        if case.op == "gather":
            name = "gather_elems"
            kernel = (lambda t=t, ids=ids, arg=arg:
                      vo.gather_elems(t, ids, arg))
            plain = (lambda t=t, ids=ids, arg=arg:
                     vo.gather_elems_plain(t, ids, arg))
            compare = None
        else:
            name = "scatter_set"
            kernel = (lambda t=t, ids=ids, arg=arg:
                      vo.scatter_set(t, ids, arg))
            plain = (lambda t=t, ids=ids, arg=arg:
                     vo.scatter_set_plain(t, ids, arg))
            compare = (lambda t=t, ids=ids, arg=arg: (
                vo.scatter_set(t.clone(), ids, arg),
                vo.scatter_set_plain(t.clone(), ids, arg)))
        plan, blocks = vo.library_plan(case.op, t, ids, arg)
        print(f"   {name:12s} {case.order}: {case.label}: {plan.path}, grid "
              f"{list(plan.grid)}, {plan.threads} "
              f"threads, {plan.smem_bytes} shared bytes, {blocks} blocks an "
              f"SM", flush=True)
        r = hold_exact(name, f"{case.order}: {case.label}", kernel, plain,
                       bench_visited.library_call(case), case.nbytes,
                       compare=compare, symbols=(name,))
        r["plan"] = {"path": plan.path, "grid": list(plan.grid),
                     "cluster": 1, "threads": plan.threads,
                     "smem_bytes": plan.smem_bytes, "blocks_per_sm": blocks}
        out[name].append(r)
    return out


def edge_rows(B, W, dtype, gen):
    """Rows on the card salted with what a select can get wrong: many ties,
    runs of -inf, -0.0 beside +0.0 (float32); negative keys, the extremes of
    int32 and runs of equal pads (int32). Row 0 is plain random."""
    dev = gen.device
    if dtype == torch.float32:
        x = torch.randint(-64, 64, (B, W), generator=gen, device=dev) / 8.0
        x[torch.rand((B, W), generator=gen, device=dev) < 0.2] = float("-inf")
        x[:, W // 3:W // 3 + W // 10] = float("-inf")
        x[torch.rand((B, W), generator=gen, device=dev) < 0.05] = -0.0
        x[0] = torch.randn(W, generator=gen, device=dev)
        return x
    x = torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen, device=dev,
                      dtype=torch.int32)
    x[:, ::3] = 2**31 - 1
    x[:, 1::7] = -(2**31)
    x[1:, 2::5] = torch.randint(-3, 3, (B - 1, len(range(2, W, 5))),
                                generator=gen, device=dev, dtype=torch.int32)
    return x


def check_select_kernels(dev, sampler_row):
    """Phase 3, third part: row_sort and row_topk against their plain
    versions, values and indices bit for bit, at the TPU probes' shapes (the
    probe's inputs, from its numpy seed), at the search's and at their
    paths' boundaries (SORT_CASES, TOPK_CASES) on salted rows, and the
    top-k on tie groups across tiles (TOPK_TIE_CASES); each twice on the
    same rows at three widths (equal bits); and the sampler's top-k of
    phase 7c's first train step: SAMPLER_K of `sampler_row`, its
    Gumbel-perturbed [1, 4.2M] row. Bounds: each input read once, each
    output written once. Library: torch.sort(stable=True), torch.topk.
    Returns {kernel name: [cases]}."""
    so = select_ops
    rng = np.random.default_rng(0)
    rng.integers(0, 250, PROBE_ITEMS)        # the probe's table, then its ids
    idx2d = torch.from_numpy(rng.integers(0, PROBE_ITEMS, PROBE_IDS).astype(
        np.int32)).to(dev).view(-1, 128)
    gen = torch.Generator(device=dev).manual_seed(3)
    B = NUM_QUERIES

    def sort_case(label, x, with_perm):
        kind = str(x.dtype).replace("torch.", "")
        path, tiles, _ = so._sort_plan(*x.shape)
        return hold_exact(
            "row_sort", f"{label}: {kind} {list(x.shape)}"
            + (" with perm" if with_perm else "") + f" ({path}, {tiles} "
            f"tile{'s' if tiles > 1 else ''})",
            lambda: so.row_sort(x, with_perm), lambda: so.row_sort_plain(
                x, with_perm), lambda: torch.sort(x, stable=True),
            x.numel() * (12 if with_perm else 8),
            compare=lambda: (so.row_sort(x, True), so.row_sort_plain(x, True)),
            symbols=("row_sort_",))

    def topk_case(label, x, k, largest):
        kind = str(x.dtype).replace("torch.", "")
        path, tiles, _ = so._topk_plan(*x.shape, k)
        return hold_exact(
            "row_topk", f"{label}: {kind} {list(x.shape)} k {k}"
            + ("" if largest else " smallest") + f" ({path}, {tiles} "
            f"tile{'s' if tiles > 1 else ''})",
            lambda: so.row_topk(x, k, largest),
            lambda: so.row_topk_plain(x, k, largest),
            lambda: torch.topk(x, k, largest=largest),
            x.numel() * 4 + x.shape[0] * k * 8, symbols=("row_topk_",))

    print(f"   row_sort blocks an SM: "
          f"{ {p: so.blocks_per_sm(p, dev) for p in so.SORT_PATHS} }")
    sorts = [sort_case("probe build_sort", idx2d, False)]
    sorts += [sort_case(label, edge_rows(b, W, torch.int32, gen), perm)
              for label, b, W, perm in SORT_CASES]
    sorts += [sort_case("float32 rows", edge_rows(B, W, torch.float32, gen),
                        True) for W in (2970, 33992)]
    # two calls give equal bits (a key's place never depends on which
    # block ran first)
    for W in (_S, 33992):
        x = edge_rows(B, W, torch.float32, gen)
        if not same_bits(so.row_sort(x, True), so.row_sort(x, True)):
            raise AssertionError(f"row_sort [{B}, {W}]: two calls differ")
    topks = [topk_case("probe build_topk", idx2d.reshape(1, -1), 128, True)]
    topks += [topk_case(label, edge_rows(B, W, dt, gen), k, largest)
              for label, W, k, largest, dt in TOPK_CASES]
    topks += [topk_case(label, tie_rows(B, W, kind, gen), k, True)
              for label, kind, W, k in TOPK_TIE_CASES]
    topks.append(topk_case("sampler, train step 0", sampler_row, SAMPLER_K,
                           True))
    # the sampler's SAMPLER_K winners in index order, which row_topk sorts
    # with their permutation inside its call: row_sort and
    # torch.sort(stable=True) at that shape
    winners = torch.sort(torch.topk(sampler_row, SAMPLER_K).indices).values
    sorts.append(sort_case("sampler's winners", sampler_row[:, winners[0]]
                           .contiguous(), True))
    for W, k in ((4496, 400), (33992, 4096), (NUM_ITEMS, 200)):
        x = edge_rows(B, W, torch.float32, gen)
        if not same_bits(so.row_topk(x, k), so.row_topk(x, k)):
            raise AssertionError(f"row_topk [{B}, {W}] k {k}: two calls "
                                 f"differ")
    return {"row_sort": sorts, "row_topk": topks}


def tie_rows(B, W, kind, gen):
    """float32 rows whose tie groups span the tiled top-k's tiles: every
    key equal; random keys but a run of -inf from key 2,000 to W - 2,000
    (seven tiles of 4,096 at W = 33,992), so that the k-th largest of a k
    above the 4,000 finite keys is -inf inside the run and its ties are
    taken from the run's start; keys in [1, 2), which share their first
    digit, with every seventh 1.5."""
    dev = gen.device
    if kind == "equal":
        return torch.full((B, W), 0.25, device=dev)
    if kind == "neginf_run":
        x = torch.randn((B, W), generator=gen, device=dev)
        x[:, 2000:W - 2000] = float("-inf")
        return x
    x = 1 + torch.rand((B, W), generator=gen, device=dev)
    x[:, ::7] = 1.5
    return x


def mean_overlap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([
        len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
        / max(len(y[y >= 0]), 1) for x, y in zip(a, b)]))


def check_results(items: np.ndarray, scores: np.ndarray,
                  queries: int = NUM_QUERIES) -> None:
    """[queries, k_final] results: no row empty or duplicated, scores
    finite and sorted."""
    k_final = max(SCFG.topk_eval)
    if items.shape != (queries, k_final):
        raise AssertionError(f"result shape {items.shape}")
    for row, sc in zip(items, scores):
        got = row[row >= 0]
        if len(got) == 0 or len(set(got.tolist())) != len(got):
            raise AssertionError("empty or duplicated result")
        if not np.isfinite(sc[row >= 0]).all() or \
                np.any(np.diff(sc[row >= 0]) > 0):
            raise AssertionError("scores not finite and sorted")


def common_score_rel(items_a, scores_a, items_b, scores_b) -> float:
    """max |a - b| / (1 + |b|) over the scores of ids both results hold."""
    rel = 0.0
    for ia, sa, ib, sb in zip(items_a, scores_a, items_b, scores_b):
        _, at_a, at_b = np.intersect1d(ia[ia >= 0], ib[ib >= 0],
                                       return_indices=True)
        ref = sb[ib >= 0][at_b]
        rel = max(rel, float(np.max(
            np.abs(sa[ia >= 0][at_a] - ref) / (1 + np.abs(ref)),
            initial=0.0)))
    return rel


def alternate_walls(search_k, search_p, args):
    """Wall ms of warm searches in turns (kernel, plain, plain, kernel)."""
    walls = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = search_k if name == "kernel" else search_p
        walls[name].append(wall_ms(lambda: fn(*args)))
    return walls


def print_breakdown(breakdown, search_ms) -> None:
    if breakdown is None:
        print("   device time by kernel family: not measured (the "
              "profiler saw no device time)")
        return
    busy = sum(breakdown.values())
    print(f"   device time of one kernel-path search by kernel family "
          f"(torch.profiler, ms): "
          f"{ {k: round(v, 3) for k, v in breakdown.items()} }; "
          f"device busy {busy:.2f} of {search_ms:.2f} ms wall "
          f"({busy / search_ms:.1%})")


def serve(mcfg, params, state, index, users_np, want_items, want_scores,
          label):
    """The engine on `index` (every bucket warmed): NUM_QUERIES requests from
    4 client threads, each answer equal to the direct search's.
    Returns (seconds to answer all, the engine, shut down)."""
    engine = Engine(mcfg, SCFG, params, state, index, EngineConfig())
    futures = [None] * NUM_QUERIES

    def client(lo):
        for i in range(lo, NUM_QUERIES, 4):
            futures[i] = engine.submit(users_np[i])

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    answers = [f.result(timeout=300) for f in futures]
    serve_s = time.perf_counter() - t0
    engine.shutdown()
    answers_equal(answers, want_items, want_scores, label)
    return serve_s, engine


def front_end_ops():
    """The kernel wrappers whose launches phase 6b counts."""
    return (score_frontier,) + VISITED_OPS + SELECT_OPS


def entry_name(op) -> str:
    return "frontier_scorer" if op is score_frontier else op.__name__


class FrontEndLaunches:
    """The kernels' launches in phase 6b's front-end steps only: each step
    sets every count to 0 just before it and reads the counts just after,
    so the direct searches the answers are held against count nowhere."""

    def __init__(self):
        self.total = {entry_name(op): 0 for op in front_end_ops()}
        self.steps = {}

    @contextlib.contextmanager
    def step(self, label):
        zero_launches()
        yield
        got = {entry_name(op): op.launches for op in front_end_ops()}
        self.steps[label] = got
        for name, n in got.items():
            self.total[name] += n
        if not got["frontier_scorer"]:
            raise AssertionError(f"{label}: the scorer kernel was not "
                                 f"launched: {got}")


def answers_equal(answers, items, scores, label) -> float:
    """Each engine answer (ids, scores) against row i of a direct search:
    ids equal, scores within the bfloat16 tolerance. Returns the largest
    |d| / (1 + |ref|) of the scores."""
    worst = 0.0
    for i, (got_items, got_scores) in enumerate(answers):
        keep = items[i] >= 0
        if not np.array_equal(got_items, items[i][keep]):
            raise AssertionError(f"{label}: answer {i} differs from the "
                                 f"direct search")
        ref = scores[i][keep]
        worst = max(worst, float(np.max(
            np.abs(got_scores - ref) / (1 + np.abs(ref)), initial=0.0)))
    if worst > TOL[torch.bfloat16]:
        raise AssertionError(f"{label}: scores differ by {worst}")
    return worst


def post_json(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def front_ends(mcfg, params, state, index, tmp, item_embs, card, dev):
    """Phase 6b: the engine's calibrated ladder and its cache, the search at
    B = FRONT_BATCH (kernel path against plain path, and through the engine),
    the REST server and its reload, the wire codec and gRPC, the selector
    over the list and byte-map engines, and the load generator. The direct
    searches come first; the front ends' steps after them. Returns the
    kernels' launches in those steps, by their entries' names in the kernels
    line."""
    ltn = level_topn_default(SCFG)
    L, d = MCFG.max_seq_length, MCFG.user_emb_dim
    users = np.random.default_rng(FRONT_SEED).standard_normal(
        (FRONT_BATCH, L, d)).astype(np.float32)
    users_t = torch.from_numpy(users)
    bm = dataclasses.replace(SCFG, vis_impl="bytemap")
    search_k = make_searcher(mcfg, SCFG)

    # the direct searches every answer below is held against
    # the search at B = FRONT_BATCH: kernel path against plain path
    items_k, scores_k, _ = (x.cpu().numpy() for x in search_k(
        params, state, index, users_t, ltn))
    items_p, scores_p, _ = (x.cpu().numpy() for x in make_searcher(
        mcfg, SCFG, scorer_impl="plain")(params, state, index, users_t, ltn))
    overlap = mean_overlap(items_k, items_p)
    score_rel = common_score_rel(items_k, scores_k, items_p, scores_p)
    print(f"   batched search at B={FRONT_BATCH}: top-{items_k.shape[1]} "
          f"overlap kernel vs plain {overlap:.4f} (need >= {MIN_OVERLAP}); "
          f"scores of common ids max|d|/(1+|ref|)={score_rel:.3e} "
          f"(tol {TOL[torch.bfloat16]})")
    if overlap < MIN_OVERLAP or score_rel > TOL[torch.bfloat16]:
        raise AssertionError(f"B={FRONT_BATCH}: overlap {overlap}, score "
                             f"error {score_rel}")
    # a second bundle (weight seed 1) for :reload, and its direct search
    bundle2 = os.path.join(tmp, "bundle_seed1")
    params2, state2 = init_scorer(MCFG, torch.Generator().manual_seed(1),
                                  device=dev)
    export_model(bundle2, params2, state2, MCFG, SCFG,
                 item_ids=np.arange(1, NUM_ITEMS + 1, dtype=np.int64),
                 item_embs=item_embs, index_dir=os.path.join(tmp, "index"))
    p2, s2, _m2, index2 = load_serving_bundle(bundle2, device=dev)
    items_2, scores_2, _ = (x.cpu().numpy() for x in search_k(
        p2, s2, index2, users_t[:16], ltn))
    del p2, s2, index2
    # the wire codec's request: its fp16 comm_seq as the engine receives it
    comm = users[:1].reshape(1, L * d).astype(np.float16)
    req = tfs_proto.encode_predict_request({"comm_seq": comm,
                                            "level_topn": ltn}, "nann")
    _spec, inputs = tfs_proto.decode_predict_request(req)
    user16 = inputs["comm_seq"].astype(np.float32).reshape(L, d)
    items_16, scores_16, _ = (x.cpu().numpy() for x in search_k(
        params, state, index, torch.from_numpy(user16[None]), ltn))
    # the byte-map engine's direct search
    items_b, scores_b, _ = (x.cpu().numpy() for x in make_searcher(mcfg, bm)(
        params, state, index, users_t[:32], ltn))
    torch.cuda.synchronize()

    counts = FrontEndLaunches()
    cal_path = os.path.join(tmp, "calibration.json")
    t0 = time.perf_counter()
    with counts.step("calibration"):
        engine = Engine(mcfg, SCFG, params, state, index,
                        EngineConfig(calibrate=True,
                                     calibration_file=cal_path))
    cal_s = time.perf_counter() - t0
    print(f"   calibration ({cal_s:.2f}s, warm-up included): ladder "
          f"{list(engine.config.batch_buckets)}, median engine qps by "
          f"bucket { {b: round(q, 1) for b, q in engine.bucket_qps.items()} }"
          f", serving bucket {engine._serve_cap} "
          f"({engine.calibration_source}); {card}")
    if engine.calibration_source != "measured" or \
            engine._serve_cap not in engine.config.batch_buckets:
        raise AssertionError("the engine did not calibrate its ladder")
    cached = Engine(mcfg, SCFG, params, state, index,
                    EngineConfig(calibrate=True, calibration_file=cal_path,
                                 warmup=False))
    cached.shutdown()
    print(f"   a second engine on the same file: {cached.calibration_source}"
          f", serving bucket {cached._serve_cap}")
    if cached.calibration_source != "cached" or \
            cached._serve_cap != engine._serve_cap:
        raise AssertionError("the calibration file was not read back")

    big = Engine(mcfg, SCFG, params, state, index,
                 EngineConfig(serve_bucket=FRONT_BATCH, warmup=False))
    with counts.step(f"engine, serve_bucket={FRONT_BATCH}"):
        futures = [big.submit(u) for u in users]
        answers = [f.result(timeout=300) for f in futures]
    rel = answers_equal(answers, items_k, scores_k, "engine at "
                        f"serve_bucket={FRONT_BATCH}")
    print(f"   engine at serve_bucket={FRONT_BATCH}: {FRONT_BATCH} requests "
          f"in batches of up to "
          f"{big.metrics.batch_size.snapshot()['max']:.0f}, each equal to the "
          f"direct search (scores max|d|/(1+|ref|)={rel:.1e})")

    # REST: NannServer on a free port, 64 requests from 4 threads, reload
    server = NannServer(big, port=0)
    server.start()
    try:
        n_rest = min(64, FRONT_BATCH)
        replies = [None] * n_rest

        def client(c):
            for i in range(c, n_rest, 4):
                replies[i] = post_json(server.port, "/v1/models/nann:predict",
                                       {"inputs": {"comm_seq": users[i].reshape(
                                           1, -1).tolist()}})
        t0 = time.perf_counter()
        with counts.step("REST"):
            clients = [threading.Thread(target=client, args=(c,))
                       for c in range(4)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
        rest_s = time.perf_counter() - t0
        if any(status != 200 for status, _ in replies):
            raise AssertionError(f"REST replies {[s for s, _ in replies]}")
        rel = answers_equal(
            [(np.asarray(r["outputs"]["top_k"][0]),
              np.asarray(r["outputs"]["scores"][0], np.float32))
             for _, r in replies], items_k, scores_k, "REST")
        print(f"   REST: {n_rest} requests over http.client from 4 threads in "
              f"{rest_s * 1e3:.1f} ms, each equal to the direct search "
              f"(scores max|d|/(1+|ref|)={rel:.1e})")

        t0 = time.perf_counter()
        with counts.step("REST after :reload"):
            status, reply = post_json(server.port, "/v1/models/nann:reload",
                                      {"export_dir": bundle2})
            reload_s = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"reload: {status} {reply}")
            replies = [post_json(server.port, "/v1/models/nann:predict",
                                 {"inputs": {"comm_seq": users[i].tolist()}})
                       for i in range(16)]
        rel = answers_equal(
            [(np.asarray(r["outputs"]["top_k"][0]),
              np.asarray(r["outputs"]["scores"][0], np.float32))
             for _, r in replies], items_2, scores_2, "after :reload")
        print(f"   :reload of a bundle of weight seed 1: {reload_s:.2f}s; 16 "
              f"answers equal to the new model's direct search (overlap with "
              f"the old model's {mean_overlap(items_2, items_k[:16]):.4f})")
    finally:
        server.stop()
        big.shutdown()

    # the wire codec around engine.submit, then gRPC where it imports
    with counts.step("tfs_proto"):
        items, scores = engine.submit(user16, inputs["level_topn"]).result(
            timeout=300)
    _spec, outputs = tfs_proto.decode_predict_response(
        tfs_proto.encode_predict_response(
            {"top_k": items[None].astype(np.int32), "scores": scores[None]}))
    answers_equal([(outputs["top_k"][0], outputs["scores"][0])], items_16,
                  scores_16, "tfs_proto round trip")
    print(f"   tfs_proto: a predict request ({len(req)} bytes, fp16 comm_seq "
          f"[1, {L * d}]) and its response round-trip around engine.submit, "
          f"equal to the direct search")
    try:
        import grpc
    except ImportError:
        print("   gRPC: the grpc package does not import here; the gRPC "
              "transport was not driven")
    else:
        grpc_server = NannGrpcServer(engine, port=0)
        grpc_server.start()
        try:
            with grpc.insecure_channel(f"127.0.0.1:{grpc_server.port}") as ch, \
                    counts.step("gRPC"):
                out = make_client_call(ch)({"comm_seq": users[:8].reshape(
                    8, L * d)}, timeout=300)
        finally:
            grpc_server.stop()
        answers_equal([(row[row > 0], sc[row > 0]) for row, sc in
                       zip(out["top_k"], out["scores"])], items_k, scores_k,
                      "gRPC")
        print("   gRPC: 8 rows in one Predict, each equal to the direct "
              "search")

    # the selector over the list engine and a byte-map engine
    bytemap = Engine(mcfg, bm, params, state, index,
                     EngineConfig(warmup=False))
    selector = ModelSelector({"list": engine, "bytemap": bytemap})
    try:
        for name, (want_i, want_s) in (("list", (items_k, scores_k)),
                                       ("bytemap", (items_b, scores_b))):
            selector.select(name)
            with counts.step(f"selector, {name}"):
                futures = [selector.submit(u) for u in users[:32]]
                answers = [f.result(timeout=300) for f in futures]
            answers_equal(answers, want_i, want_s, f"selector, {name}")
    finally:
        bytemap.shutdown()
    scatter = {name: counts.steps[f"selector, {name}"]["scatter_set"]
               for name in ("list", "bytemap")}
    print(f"   ModelSelector: 32 requests to each of the list and byte-map "
          f"engines, each equal to its own direct search; scatter_set "
          f"launches {scatter}")
    if not scatter["bytemap"] or scatter["list"]:
        raise AssertionError(f"scatter_set behind the selector: {scatter}")

    # the load generator on the calibrated engine, its histograms emptied of
    # calibration's and the earlier steps' samples (as bench.py drops them)
    for name in ("latency_us", "batch_size", "device_us"):
        setattr(engine.metrics, name, Histogram())
    with counts.step("load test"):
        res = run_load_test(engine, LoadGenConfig(duration_s=LOAD_S, qps=-1),
                            verbose=False)
    engine.shutdown()
    print(f"   load test ({LOAD_S:.0f}s, qps=-1, 4 producers, serving bucket "
          f"{engine._serve_cap}; {card}): {json.dumps(res)}")
    if res["failures"] or res["total"] == 0:
        raise AssertionError(f"load test: {res}")
    for label, got in counts.steps.items():
        print(f"   launches in step {label}: {got}")
    print(f"   launches in the front ends' steps: {counts.total}")
    if not all(counts.total.values()):
        raise AssertionError(f"a kernel of the front ends' path was not "
                             f"launched: {counts.total}")
    return counts.total


# families of a train step's device kernels, by substrings of their names
# (lower case); the first family that matches takes a kernel
def family_breakdown(events):
    """{family: device ms} of torch.profiler's events (the train step's
    families of utils/trace.py, then "other") and the ten kernels that took
    the most device time."""
    top = sorted(events, key=lambda e: -e[1])[:10]
    return (trace.families(events, trace.TRAIN_FAMILIES),
            [(trace.kernel_name(k), round(ms, 4), n) for k, ms, n in top])


def tree_to(tree, dev):
    """A copy of nested params or state on `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.detach().to(dev)


def train_phase(dev, tmp, data):
    """Phase 7c: train_loop for TRAIN_STEPS steps at the reference's
    training scale, then a second train_loop that resumes from its last
    checkpoint and takes one step; each step's wall time (CUDA events) and
    metrics, peak memory, one step's device time by kernel family, and the
    sampler's row_topk launches (one a step, and no other kernel of the
    port); extraction of every item embedding (a sample held against the
    CPU); then the trained tail: HNSW over the first TAIL_ITEMS items'
    embeddings, the bundle written and read back at the bfloat16 serving
    type, TAIL_QUERIES test users through user_embed, the kernel path
    against the plain path (plain scorer and plain selects), and recall@200
    against the oracle. Returns {"launches_train": {entry: launches a
    step}, "launches_tail": {entry: launches}}."""
    train, test, feats = data
    n_items = TRAIN_MCFG.num_item
    ckpt = os.path.join(tmp, "ckpt")
    metrics_path = os.path.join(tmp, "train_metrics.jsonl")
    events = []          # (step, start, end): the CUDA events of each step
    profiled = {}
    make = train_loop_mod.make_train_step

    def make_timed(*args, **kw):
        step = make(*args, **kw)

        def timed(state, batch, seed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if state.step == PROFILED_STEP:
                out = []
                profiled["events"] = trace.device_events(
                    lambda: out.append(step(state, batch, seed)))
                if not out:     # the profiler cannot trace the card
                    out.append(step(state, batch, seed))
                return out[0]
            start.record()
            out = step(state, batch, seed)
            end.record()
            events.append((state.step, start, end))
            return out
        return timed

    ops = front_end_ops()
    for op in ops:
        op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_loop_mod.make_train_step = make_timed
    try:
        t0 = time.perf_counter()
        train_loop(TRAIN_MCFG, TRAIN_TCFG, train, feats, ckpt_dir=ckpt,
                   num_steps=TRAIN_STEPS, metrics_path=metrics_path,
                   device=dev)
        first_s = time.perf_counter() - t0
        saved = checkpoint_steps(ckpt)
        t0 = time.perf_counter()
        state, _ = train_loop(TRAIN_MCFG, TRAIN_TCFG, train, feats,
                              ckpt_dir=ckpt, num_steps=TRAIN_STEPS + 1,
                              metrics_path=metrics_path, device=dev)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    finally:
        train_loop_mod.make_train_step = make
    peak = torch.cuda.max_memory_allocated()
    launches = {entry_name(op): op.launches for op in ops}
    steps = TRAIN_STEPS + 1
    print(f"   train_loop: {TRAIN_STEPS} steps in {first_s:.2f}s "
          f"(checkpoints {saved}), resumed from step_{saved[-1]} for one "
          f"step in {resumed_s:.2f}s (checkpoints "
          f"{checkpoint_steps(ckpt)}); state.step {state.step}; "
          f"{n_items:,} items, batch {TRAIN_TCFG.batch_size}, num_neg "
          f"{TRAIN_TCFG.num_neg}: {TRAIN_TCFG.batch_size * TRAIN_TCFG.num_neg:,}"
          f" unique negatives a step")
    if state.step != steps or saved[-1] != TRAIN_STEPS:
        raise AssertionError(f"training stopped at step {state.step}, "
                             f"checkpoints {saved}")
    walls = {s: a.elapsed_time(b) for s, a, b in events}
    print(f"   step wall ms (CUDA events, by step; step {PROFILED_STEP} "
          f"ran under torch.profiler): "
          f"{ {s: round(ms, 3) for s, ms in walls.items()} }; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after")
    with open(metrics_path) as f:
        logged = [json.loads(line) for line in f]
    for m in logged:
        print(f"   step {m['step']}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in ("loss", "loss_xe", "loss_adv", "acc",
                                        "acc_origin")))
    if [m["step"] for m in logged] != list(range(steps)) or not all(
            np.isfinite([m[k] for k in ("loss", "loss_xe", "loss_adv", "acc",
                                        "acc_origin")]).all()
            and m["loss_adv"] >= -KL_FLOOR for m in logged):
        raise AssertionError(f"train metrics not finite, loss_adv below "
                             f"-{KL_FLOOR:.3g}, or steps missing: {logged}")
    if profiled.get("events") is None:
        print("   device time of one step by kernel family: not measured "
              "(the profiler saw no device time)")
    else:
        groups, top = family_breakdown(profiled["events"])
        busy = sum(groups.values())
        print(f"   device time of step {PROFILED_STEP} by kernel family "
              f"(torch.profiler, ms): "
              f"{ {k: round(v, 4) for k, v in groups.items()} }; busy "
              f"{busy:.2f} ms; top kernels (name, ms, launches) {top}")
    print(f"   launches over the {steps} steps: {launches}")
    if launches["row_topk"] != steps or any(
            n for name, n in launches.items() if name != "row_topk"):
        raise AssertionError(f"the sampler must launch row_topk once a step "
                             f"and nothing else: {launches}")

    t0 = time.perf_counter()
    item_ids, item_embs = extract_item_embeddings(
        state.params, state.bn_state, TRAIN_MCFG, feats)
    extract_s = time.perf_counter() - t0
    if item_embs.shape != (n_items, TRAIN_MCFG.item_emb_dim) or \
            not np.isfinite(item_embs).all() or \
            not np.array_equal(item_ids, feats["item_id"]):
        raise AssertionError("extracted item embeddings are malformed")
    sample = np.random.default_rng(7).choice(n_items, min(4096, n_items),
                                             replace=False)
    cpu_params = tree_to(state.params, "cpu")
    with torch.no_grad():
        ref, _ = item_tower(cpu_params, tree_to(state.bn_state, "cpu"),
                            TRAIN_MCFG, torch.from_numpy(item_ids[sample]),
                            torch.from_numpy(feats["cate_id"][sample]), False)
    ref = ref.numpy()
    rel = float(np.max(np.abs(item_embs[sample] - ref) / (1 + np.abs(ref))))
    print(f"   extract_item_embeddings: {n_items:,} items in "
          f"{extract_s:.2f}s ({n_items / extract_s:,.0f} items/s, host "
          f"copy included); {len(sample):,} sampled rows against the CPU "
          f"max|d|/(1+|ref|)={rel:.3e} (tol {TOL[torch.float32]})")
    if rel > TOL[torch.float32]:
        raise AssertionError(f"extraction differs from the CPU: {rel}")

    index_dir = os.path.join(tmp, "index_trained")
    t0 = time.perf_counter()
    build_and_save_index(item_embs[:TAIL_ITEMS], SCFG.hnsw_start_level,
                         HNSW_M, index_dir, ef_construction=HNSW_EF, seed=42)
    print(f"   hnsw build over the first {TAIL_ITEMS:,} trained item "
          f"embeddings: {time.perf_counter() - t0:.2f}s")
    bundle = os.path.join(tmp, "bundle_trained")
    export_model(bundle, state.params, state.bn_state,
                 dataclasses.replace(TRAIN_MCFG, compute_dtype="bfloat16"),
                 SCFG, item_ids=item_ids[:TAIL_ITEMS],
                 item_embs=item_embs[:TAIL_ITEMS], index_dir=index_dir,
                 checkpoint_step=state.step)
    del state, cpu_params
    params, bn, mcfg, index = load_serving_bundle(bundle, device=dev)
    with torch.no_grad():
        users = user_embed(params, torch.from_numpy(
            test["item_ids"][:TAIL_QUERIES]).to(dev), torch.from_numpy(
                test["cate_ids"][:TAIL_QUERIES]).to(dev)).float().cpu()
    args = (params, bn, index, users, level_topn_default(SCFG))
    search_k = make_searcher(mcfg, SCFG)
    selects = select_ops.selects
    select_ops.selects = lambda plain=False: selects(True)
    try:
        search_p = make_searcher(mcfg, SCFG, scorer_impl="plain")
    finally:
        select_ops.selects = selects
    for fn in (search_k, search_p):
        fn(*args)
    torch.cuda.synchronize()
    for op in ops:
        op.launches = 0
    items_k, scores_k, ns_k = search_k(*args)
    torch.cuda.synchronize()
    tail_launches = {entry_name(op): op.launches for op in ops}
    path = ("frontier_scorer", "gather_elems", "gather_rows", "row_sort",
            "row_topk")
    if not all(tail_launches[name] for name in path):
        raise AssertionError(f"a kernel of the trained tail's search was not "
                             f"launched: {tail_launches}")
    items_p, scores_p, _ = search_p(*args)
    walls = alternate_walls(search_k, search_p, args)
    items_k, scores_k = items_k.cpu().numpy(), scores_k.cpu().numpy()
    items_p, scores_p = items_p.cpu().numpy(), scores_p.cpu().numpy()
    check_results(items_k, scores_k, TAIL_QUERIES)
    overlap = mean_overlap(items_k, items_p)
    score_rel = common_score_rel(items_k, scores_k, items_p, scores_p)
    k_final = max(SCFG.topk_eval)
    top_idx, _ = brute_force_topk(params, bn, mcfg, users, index.item_embs,
                                  k=k_final)
    oracle_ids = index.item_ids[top_idx.long()].cpu().numpy()
    recall = float(np.mean([calc_pr(o, g[g >= 0])[1]
                            for o, g in zip(oracle_ids, items_k)]))
    print(f"   trained bundle: {index.num_items:,} items ({mcfg.compute_dtype}"
          f"), {TAIL_QUERIES} test users; launches of one kernel-path search "
          f"{tail_launches}; wall kernel path "
          f"{np.mean(walls['kernel']):.2f} ms, plain path (plain scorer and "
          f"selects) {np.mean(walls['plain']):.2f} ms; mean num_scoring per "
          f"hop {np.round(ns_k.float().mean(0).cpu().numpy(), 1).tolist()}")
    print(f"   top-{k_final} overlap kernel vs plain: {overlap:.4f} (need >= "
          f"{MIN_OVERLAP}); scores of common ids max|d|/(1+|ref|)="
          f"{score_rel:.3e} (tol {TOL[torch.bfloat16]}); graph recall@"
          f"{k_final} vs brute-force oracle: {recall:.4f}")
    if overlap < MIN_OVERLAP or score_rel > TOL[torch.bfloat16]:
        raise AssertionError(f"trained tail: overlap {overlap}, score error "
                             f"{score_rel}")
    return {"launches_train": {name: n / steps
                               for name, n in launches.items()},
            "launches_tail": tail_launches}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def tree_phase(dev, root, argv):
    """Phase 7d's direct tree search: CLI_TREE_QUERIES test users through
    the CLI's tree (beam 200, branch 16) on the kernel path and the plain
    path (plain scorer, top-k and gathers) of the selected checkpoint; the
    scorer's launch widths, the kernels' launches of one kernel-path
    search, wall times and device time by family; the tree's and the HNSW
    graph's recall against the brute-force oracle. Returns the launches."""
    args = cli.parse_opt(argv)
    mcfg, tcfg, scfg = cli.build_configs(args)
    paths = cli.Paths(root)
    state = cli._restore(mcfg, tcfg, paths, device=dev)
    _train, test, _feats = cli.load_dataset(args)
    users = torch.from_numpy(extract_user_embeddings(
        state.params, {k: v[:CLI_TREE_QUERIES] for k, v in test.items()}))
    tree = load_tree(os.path.join(root, "tree_index"))
    dtree = DeviceTree.from_tree(tree, np.load(paths.item_ids_file),
                                 dtype=mcfg.compute_dtype, device=dev)
    k = max(args.topk_eval)
    targs = (state.params, state.bn_state, dtree, users)
    widths = []

    def recording(weights, k_proj, v, table, ids, valid):
        widths.append(list(ids.shape))
        return score_frontier(weights, k_proj, v, table, ids, valid)

    search_tree.score_frontier = recording
    try:
        make_tree_searcher(mcfg, beam_width=args.tree_beam, topk=k)(*targs)
    finally:
        search_tree.score_frontier = score_frontier
    search_k = make_tree_searcher(mcfg, beam_width=args.tree_beam, topk=k)
    search_p = make_tree_searcher(mcfg, beam_width=args.tree_beam, topk=k,
                                  scorer_impl="plain")
    search_k(*targs)
    search_p(*targs)
    torch.cuda.synchronize()
    ops = front_end_ops()
    for op in ops:
        op.launches = 0
    items_k, scores_k = search_k(*targs)
    torch.cuda.synchronize()
    launches = {entry_name(op): op.launches for op in ops}
    items_p, scores_p = search_p(*targs)
    walls = alternate_walls(search_k, search_p, targs)
    tree_ms = float(np.mean(walls["kernel"]))
    breakdown = trace.device_breakdown(lambda: search_k(*targs))
    items_k, scores_k = items_k.cpu().numpy(), scores_k.cpu().numpy()
    items_p, scores_p = items_p.cpu().numpy(), scores_p.cpu().numpy()
    check_results(items_k, scores_k, CLI_TREE_QUERIES)
    overlap = mean_overlap(items_k, items_p)
    score_rel = common_score_rel(items_k, scores_k, items_p, scores_p)
    tol = TOL[torch_dtype(mcfg.compute_dtype)]
    print(f"   tree search of {CLI_TREE_QUERIES} queries ({tree.num_levels} "
          f"levels {[e.shape[0] for e in tree.node_embs]}, beam "
          f"{args.tree_beam}, {mcfg.compute_dtype}): scorer launch widths "
          f"{widths}; launches of one kernel-path search {launches}; wall "
          f"kernel path {tree_ms:.2f} ms {[round(t, 2) for t in walls['kernel']]}"
          f", plain path {np.mean(walls['plain']):.2f} ms "
          f"{[round(t, 2) for t in walls['plain']]}")
    print_breakdown(breakdown, tree_ms)
    print(f"   tree top-{k} overlap kernel vs plain: {overlap:.4f} (need >= "
          f"{MIN_OVERLAP}); scores of common ids max|d|/(1+|ref|)="
          f"{score_rel:.3e} (tol {tol})")
    if overlap < MIN_OVERLAP or score_rel > tol:
        raise AssertionError(f"tree search kernel vs plain: overlap "
                             f"{overlap}, score error {score_rel}")
    # both retrieval families against the brute-force oracle on these users
    item_ids = np.load(paths.item_ids_file)
    top_idx, _ = brute_force_topk(state.params, state.bn_state, mcfg, users,
                                  cli._oracle_table(args, mcfg, np.load(
                                      paths.item_embs_file)), k=k)
    oracle_ids = item_ids[top_idx.cpu().numpy()]
    graph = make_searcher(mcfg, scfg)(
        state.params, state.bn_state,
        cli._load_search_index(args, mcfg, scfg, paths), users,
        level_topn_default(scfg))[0].cpu().numpy()
    recall = {name: float(np.mean([calc_pr(o, g[g >= 0])[1]
                                   for o, g in zip(oracle_ids, got)]))
              for name, got in (("tree", items_k), ("graph", graph))}
    print(f"   recall@{k} against the brute-force oracle on these users: "
          f"tree {recall['tree']:.4f}, HNSW graph {recall['graph']:.4f}")
    expansion = [CLI_TREE_QUERIES, args.tree_beam * args.tree_branch]
    if expansion not in widths:
        raise AssertionError(f"no {expansion} frontier was scored: {widths}")
    return launches


def serve_job(dev, root, argv):
    """`--job-type serve` in a subprocess: wait for its REST port, one
    predict answered equal to the direct search of the bundle, then SIGINT,
    on which it must exit 0."""
    try:
        import grpc  # noqa: F401
        grpc_port = free_port()
    except ImportError:
        grpc_port = -1
    port = free_port()
    scfg = cli.build_configs(cli.parse_opt(argv))[2]
    params, state, mcfg, index = load_serving_bundle(
        os.path.join(root, "export"), scfg, device=dev)
    user = np.random.default_rng(11).standard_normal(
        (mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32)
    want_items, want_scores, _ = make_searcher(mcfg, scfg)(
        params, state, index, torch.from_numpy(user[None]),
        level_topn_default(scfg))
    log_path = os.path.join(root, "serve.log")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "nann_tpu_torch.main", "--job-type",
             "serve", *argv, "--port", str(port), "--grpc-port",
             str(grpc_port)], cwd=here, stdout=log, stderr=subprocess.STDOUT)
    try:
        reply = None
        while reply is None:
            if proc.poll() is not None:
                raise RuntimeError(f"serve exited with {proc.returncode}")
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("serve did not answer within 300 s")
            try:
                reply = post_json(port, "/v1/models/nann:predict",
                                  {"inputs": {"comm_seq":
                                              user.reshape(1, -1).tolist()}})
            except OSError:
                time.sleep(0.5)
        first_s = time.perf_counter() - t0
        status, body = reply
        if status != 200:
            raise AssertionError(f"serve answered {status}: {body}")
        rel = answers_equal(
            [(np.asarray(body["outputs"]["top_k"][0]),
              np.asarray(body["outputs"]["scores"][0], np.float32))],
            want_items.cpu().numpy(), want_scores.cpu().numpy(), "serve")
        # the REST port answers before the gRPC server has started: SIGINT
        # only once serve logs that every server is up
        def serving() -> bool:
            with open(log_path) as f:
                return "ctrl-c to stop" in f.read()

        while not serving():
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise RuntimeError("serve did not log that it is serving")
            time.sleep(0.2)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        exit_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"serve exited with {rc} on SIGINT")
    except BaseException:
        with open(log_path) as log:
            print("   serve's log (tail):\n" + "".join(log.readlines()[-30:]))
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"   serve (subprocess, REST :{port}, gRPC "
          f"{'off' if grpc_port < 0 else f':{grpc_port}'}): first answer "
          f"{first_s:.2f}s after start (calibration included), equal to the "
          f"direct search (scores max|d|/(1+|ref|)={rel:.1e}); exit 0 "
          f"{exit_s:.2f}s after SIGINT")


def cli_phase(dev, tmp):
    """Phase 7d: nann_tpu_torch.main.main on the card, job by job: the
    `all` order (train, select_checkpoint, extract_feature, build_index,
    test_all, test, export, verify_export), parity, build_tree and
    test_tree, test with --bf16 and with --vis-impl bytemap, serve_bench
    after a bench conf of CLI_BENCH_S seconds, and serve in a subprocess.
    Each job's seconds and the kernels it launched (counts set to 0 just
    before it, read just after); test_tree must launch the scorer, row_topk
    and gather_elems, the byte-map test scatter_set. Then the direct tree
    search, kernel path against plain path. Returns {"launches_cli":
    {entry: launches over the in-process jobs}, "launches_tree": {entry:
    launches of one tree search}}."""
    root = os.path.join(tmp, "cli")
    argv = CLI_ARGV + ["--output-root", root]
    ops = front_end_ops()
    total = {entry_name(op): 0 for op in ops}
    total["frontier_scorer_int8"] = 0
    seconds, launched = {}, {}

    def job(label, name, extra=()):
        for op in ops:
            op.launches = 0
        score_frontier.launches_int8 = 0
        t0 = time.perf_counter()
        result = cli.main(["--job-type", name, *argv, *extra])
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        got = {entry_name(op): op.launches for op in ops}
        got["frontier_scorer_int8"] = score_frontier.launches_int8
        for key, n in got.items():
            total[key] += n
        launched[label] = got
        print(f"   {label}: {seconds[label]:.2f}s; launches "
              f"{ {k: n for k, n in got.items() if n} }", flush=True)
        return result

    results = {name: job(name, name) for name in cli.ALL_ORDER}
    parity = job("parity", "parity")
    job("build_tree", "build_tree")
    tree = job("test_tree", "test_tree")
    bf16 = job("test --bf16", "test", ["--bf16"])
    bytemap = job("test --vis-impl bytemap", "test", ["--vis-impl", "bytemap"])
    with open(os.path.join(root, "benchmark_conf.json"), "w") as f:
        json.dump(dataclasses.asdict(LoadGenConfig(duration_s=CLI_BENCH_S,
                                                   qps=-1)), f)
    bench = job("serve_bench", "serve_bench")
    for label, want in (("test_tree", ("frontier_scorer", "row_topk",
                                       "gather_elems")),
                        ("test --vis-impl bytemap", ("scatter_set",))):
        missing = [k for k in want if not launched[label][k]]
        if missing:
            raise AssertionError(f"{label} did not launch {missing}")
    sel = results["select_checkpoint"]
    report = results["verify_export"]
    print(f"   selected step_{sel['step']} of {sel['evaluated']}; "
          f"verify_export {report}")
    print(f"   recall@200: test_all {results['test_all']['recall@200']:.4f}, "
          f"test {results['test']['recall@200']:.4f}, test_tree "
          f"{tree['recall@200']:.4f}, test --bf16 {bf16['recall@200']:.4f}, "
          f"test --vis-impl bytemap {bytemap['recall@200']:.4f}; parity "
          f"{parity['parity@200']:.4f}")
    print(f"   serve_bench ({CLI_BENCH_S:.0f} s at qps=-1): "
          f"{ {k: round(v, 2) for k, v in bench.items()} }")
    if report.get("in_memory_cross_check_overlap") is None:
        raise AssertionError("verify_export ran without the live state")
    tree_launches = tree_phase(dev, root, argv)
    torch.cuda.empty_cache()      # the card's memory for serve's process
    t0 = time.perf_counter()
    serve_job(dev, root, argv)
    seconds["serve (subprocess)"] = time.perf_counter() - t0
    print(f"   job seconds: { {k: round(v, 2) for k, v in seconds.items()} }")
    print(f"   launches over the phase's in-process jobs: {total}")
    return {"launches_cli": total, "launches_tree": tree_launches}


def path_launches_now():
    """Every kernel wrapper's count, by the kernels line's names."""
    got = {entry_name(op): op.launches for op in front_end_ops()}
    got["frontier_scorer_int8"] = score_frontier.launches_int8
    return got


def zero_launches():
    for op in front_end_ops():
        op.launches = 0
    score_frontier.launches_int8 = 0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def same_outputs(got, want) -> bool:
    """Ids, scores and num_scoring equal bit for bit (tensors or arrays)."""
    def host(x):
        return x.cpu() if torch.is_tensor(x) else torch.from_numpy(
            np.asarray(x))
    return same_bits(tuple(host(g) for g in got),
                     tuple(host(w) for w in want))


def stage_times(searchB, args, dev, calls=10):
    """The stages of one staged search, each timed alone: the search runs
    once with its stages recording their inputs, then every stage call is
    replayed `calls` times under one census (utils/trace.py; a census a call
    lets a short session's kernels fall into the next one). Returns
    [(stage, key, busy ms, kernels)] a call, in call order: device time on
    the card. For a search whose stages are pure (the list backend's)."""
    st = searchB.stages
    recorded = []

    def recording(kind, key, fn):
        def stage(*a):
            recorded.append((kind, key, fn, a))
            return fn(*a)
        return stage

    saved = {k: (dict(v) if isinstance(v, dict) else v) for k, v in st.items()}
    try:
        for kind in ("filter", "score"):
            st[kind] = {key: recording(kind, key, fn)
                        for key, fn in st[kind].items()}
        for kind in ("prep", "enter", "final"):
            st[kind] = recording(kind, None, st[kind])
        searchB(*args)
        sync(dev)
    finally:
        st.update(saved)
    rows = []
    for kind, key, fn, a in recorded:
        rep = trace.census(lambda: [fn(*a) for _ in range(calls)],
                           device=dev.type)
        rows.append((kind, key,
                     None if "busy_ms" not in rep else rep["busy_ms"] / calls,
                     None if "launches" not in rep else
                     rep["launches"] / calls))
    return rows


def staged_phase(dev, mcfg, params, state, index, users, ltn, fused,
                 fused_plain, bytemap, int8, users_np):
    """Phase 7e's staged half: the staged searcher against phase 5's fused
    search (kernel path and plain path), phase 7b's byte-map search and
    phase 7's int8 search, each with its launches equal to the fused
    search's; the device ms of each stage; Engine(staged=True)."""
    args = (params, state, index, users, ltn)
    search_s = make_staged_searcher(mcfg, SCFG)
    search_sp = make_staged_searcher(mcfg, SCFG, scorer_impl="plain")
    for fn in (search_s, search_sp):
        fn(*args)
    sync(dev)
    launches = {}
    cases = [("list", search_s, args, fused),
             ("byte-map", make_staged_searcher(
                 mcfg, dataclasses.replace(SCFG, vis_impl="bytemap")), args,
              bytemap),
             ("int8", make_staged_searcher(int8["mcfg"], SCFG),
              int8["args"], int8["want"])]
    for label, fn, a, (want, want_launches) in cases:
        fn(*a)
        sync(dev)
        zero_launches()
        got = fn(*a)
        sync(dev)
        launches[label] = path_launches_now()
        same = same_outputs(got, want)
        equal_launches = all(launches[label][k] == n
                             for k, n in want_launches.items())
        print(f"   staged {label} search: ids, scores and num_scoring equal "
              f"to the fused search's: {same}; launches {launches[label]}, "
              f"equal to the fused search's {want_launches}: "
              f"{equal_launches}")
        if not same or not equal_launches:
            raise AssertionError(f"the staged {label} search differs from "
                                 f"the fused search")
    got_p = search_sp(*args)
    same_p = same_outputs(got_p[:2], fused_plain)
    print(f"   staged plain path: ids and scores equal to phase 5's fused "
          f"plain path: {same_p}")
    if not same_p:
        raise AssertionError("the staged plain path differs from the fused "
                             "plain path")
    fused_search = make_searcher(mcfg, SCFG)
    walls = alternate_walls(search_s, fused_search, args) \
        if dev.type == "cuda" else {}
    rows = stage_times(search_s, args, dev)
    unit = "device" if dev.type == "cuda" else "host (not device)"
    hop, lines = 0, []
    for kind, key, ms, n in rows:
        if kind == "filter":
            hop += 1
        where = f" level {key[0]} hop {hop}" if kind == "filter" else \
            f" level {key}" if kind == "score" else ""
        ms_txt = "not measured" if ms is None else f"{ms:.3f} ms"
        n_txt = "" if n is None else f", {n:g} kernels"
        lines.append(f"{kind}{where}: {ms_txt}{n_txt}")
    print(f"   staged list search, {unit} time a stage call (utils/trace "
          f"census over 10 replays of each call): " + "; ".join(lines))
    if walls:
        print(f"   staged list search wall (staged, fused, fused, staged): "
              f"{np.mean(walls['kernel']):.2f} ms "
              f"{[round(t, 2) for t in walls['kernel']]} against the fused "
              f"search's {np.mean(walls['plain']):.2f} ms "
              f"{[round(t, 2) for t in walls['plain']]}")

    engine = Engine(mcfg, SCFG, params, state, index,
                    EngineConfig(staged=True, batch_buckets=(1, 4, 16)))
    try:
        futures = [engine.submit(u) for u in users_np[:STAGED_REQUESTS]]
        answers = [f.result(timeout=300) for f in futures]
    finally:
        engine.shutdown()
    answers_equal(answers, fused[0][0], fused[0][1], "staged engine")
    print(f"   Engine(staged=True): {STAGED_REQUESTS} requests, each equal "
          f"to the fused direct search")
    return launches


def sharded_rank(rank, port, bundle, users_np, want, dev_type, out):
    """One rank of phase 7e's world: the list, byte-map and int8 sharded
    searches of the 64 queries on this rank's half of the bundle, each
    with its ids, launches, walls and collectives, then the mesh engine
    (rank 0) or its follower (rank 1). Puts its result, or its traceback,
    on `out`."""
    result = {"rank": rank}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
            torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=SHARDS, rank=rank,
                                timeout=datetime.timedelta(seconds=180))
        result["backend"] = dist.get_backend()
        mesh = make_mesh(dp=1, mp=SHARDS)
        users = torch.from_numpy(users_np)
        ltn = level_topn_default(SCFG)
        bytemap = dataclasses.replace(SCFG, vis_impl="bytemap")
        for label, dtype, cfg in (("list", None, SCFG),
                                  ("byte-map", None, bytemap),
                                  ("int8", "int8", SCFG)):
            params, state, mcfg, index = load_serving_bundle(
                bundle, dtype=dtype, device=dev)
            shard = shard_index(mesh, index)
            result["rows"] = int(shard.item_embs.shape[0])
            del index
            search = make_distributed_searcher(mcfg, cfg, mesh)
            args = (params, state, shard, users, ltn)
            search(*args)
            sync(dev)
            zero_launches()
            got = search(*args)
            sync(dev)
            case = {"launches": path_launches_now(),
                    "same": same_outputs(got, want[label])}
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                search(*args)
                sync(dev)
                walls.append((time.perf_counter() - t0) * 1e3)
            case["walls"] = walls
            # the collectives of one search, each timed alone: the card
            # synchronized before and after every all_reduce
            calls, coll_ms = [], []
            plain_all_reduce = dist.all_reduce

            def all_reduce(t, *a, **kw):
                sync(dev)
                t0 = time.perf_counter()
                r = plain_all_reduce(t, *a, **kw)
                sync(dev)
                coll_ms.append((time.perf_counter() - t0) * 1e3)
                calls.append(t.numel() * t.element_size())
                return r

            dist.all_reduce = all_reduce
            try:
                t0 = time.perf_counter()
                search(*args)
                sync(dev)
                case["instrumented_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                dist.all_reduce = plain_all_reduce
            case["collectives"] = len(calls)
            case["collective_bytes"] = sum(calls)
            case["collective_ms"] = sum(coll_ms)
            result[label] = case
            if label == "list":
                model = (mcfg, params, state, shard)
        mcfg, params, state, shard = model
        if mesh.index("mp") == 0:
            engine = Engine(mcfg, SCFG, params, state, shard,
                            EngineConfig(mesh=mesh, batch_buckets=(1, 4, 16)))
            try:
                futures = [engine.submit(u)
                           for u in users_np[:SHARDED_REQUESTS]]
                result["engine"] = [f.result(timeout=300) for f in futures]
            finally:
                engine.shutdown()
        else:
            follower = EngineFollower(mcfg, SCFG, params, state, shard, mesh)
            follower.join(timeout=300)
            result["follower_batches"] = follower.batches
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        result["error"] = traceback.format_exc()
    out.put(result)


def sharded_phase(dev, bundle, users_np, want, single=None, timeout_s=300):
    """Phase 7e's sharded half: a spawned world of SHARDS ranks on the one
    card (gloo over CUDA tensors; NCCL takes one rank a device), each with
    its half of the bundle's rows; `single` {search: [wall ms]} the
    single-card searches' walls, for the ratio. Returns the launches of rank
    0's searches, summed."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, port, bundle, users_np, want, dev.type,
                               out)) for r in range(SHARDS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.perf_counter() + timeout_s
    try:
        while len(results) < SHARDS:
            left = deadline - time.perf_counter()
            try:
                got = out.get(timeout=max(left, 1))
            except queue.Empty:
                raise AssertionError(f"the sharded world gave "
                                     f"{len(results)} of {SHARDS} results in "
                                     f"{timeout_s} s") from None
            results[got["rank"]] = got
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: res["error"] for r, res in results.items() if "error" in res}
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank failed (exit codes "
                             f"{[p.exitcode for p in procs]}): {errors}")
    print(f"   world of {SHARDS} ranks on {dev}: backend "
          f"{results[0]['backend']}, {results[0]['rows']} rows a rank")
    for label in ("list", "byte-map", "int8"):
        for r in range(SHARDS):
            case = results[r][label]
            need = ("frontier_scorer_int8",) if label == "int8" else \
                ("frontier_scorer", "gather_rows", "gather_elems",
                 "row_sort", "row_topk") + (
                    ("scatter_set",) if label == "byte-map" else ())
            launched = all(case["launches"][k] for k in need)
            share = case["collective_ms"] / case["instrumented_ms"]
            ratio = "" if not single else \
                f" ({np.mean(case['walls']) / np.mean(single[label]):.1f}x " \
                f"the single-card search's {np.mean(single[label]):.2f} ms)"
            print(f"   rank {r} {label} sharded search of {len(users_np)} "
                  f"queries: ids, scores and num_scoring equal to the "
                  f"single-card search's: {case['same']}; launches "
                  f"{case['launches']}; wall {np.mean(case['walls']):.2f} ms "
                  f"{[round(t, 2) for t in case['walls']]}{ratio}; "
                  f"{case['collectives']} collectives a search "
                  f"({case['collectives'] / HOPS:.1f} a hop over {HOPS} hops "
                  f"and the enter and final steps), "
                  f"{case['collective_bytes'] / 1e6:.2f} MB, "
                  f"{case['collective_ms']:.2f} ms alone of an instrumented "
                  f"search of {case['instrumented_ms']:.2f} ms "
                  f"({share:.1%})")
            if not case["same"] or not launched:
                raise AssertionError(f"rank {r}, {label}: ids equal "
                                     f"{case['same']}, kernels {need} "
                                     f"launched {launched}")
    answers_equal(results[0]["engine"], want["list"][0], want["list"][1],
                  "mesh engine")
    print(f"   Engine(mesh=...) on rank 0: {SHARDED_REQUESTS} requests, each "
          f"equal to the single-card search; its follower ran "
          f"{results[1]['follower_batches']} batches (warm-up included)")
    total = {}
    for label in ("list", "byte-map", "int8"):
        for k, n in results[0][label]["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def fingerprint(tensors) -> list:
    """Two 64-bit position-weighted sums of each tensor's 32-bit words
    (wrapping), a pair a tensor: equal bits give equal pairs, and a word
    that differs changes both (its weights are odd)."""
    out = []
    for t in tensors:
        words = t.detach().contiguous().view(-1).view(torch.int32)
        pair = torch.zeros(2, dtype=torch.int64, device=t.device)
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].to(torch.int64)
            at = torch.arange(lo, lo + w.numel(), device=t.device,
                              dtype=torch.int64)
            pair[0] += (w * (at * 2654435761 * 2 + 1)).sum()
            pair[1] += (w * ((at ^ 0x5BD1E995) * 40503 * 2 + 3)).sum()
        out.append(pair.tolist())
    return out


def state_tensors(state):
    """A TrainState's leaves, AdamW moments and batch-norm state, in one
    order on every rank."""
    moments = state.opt_state.state_dict()["state"]
    return ([leaf for _, leaf in train_step.named_leaves(state.params)] +
            [moments[i][m] for i in sorted(moments)
             for m in ("exp_avg", "exp_avg_sq")] +
            [t for _, t in train_step.named_leaves(state.bn_state)])


def same_on_every_rank(tensors, group=None) -> bool:
    """Whether the tensors' fingerprints agree on every rank of `group`."""
    mine = fingerprint(tensors)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    return all(f == every[0] for f in every)


def step_against(ref, metrics, bn_state, params, grads, noise=None
                 ) -> dict:
    """A first step's metrics, batch-norm state, gradients and parameters
    against the single-card step `ref` (its metrics, bn state, parameters
    and gradients) at the tolerances above; returns the worst error /
    tolerance of each (update_gap: the largest difference of the two
    AdamW updates the gradients imply, over lr), the leaves whose
    parameters are out (with the worst element's gradients and values),
    and whether all are in. `noise` {leaf: the largest gradient difference
    of the same step on reordered rows} widens the gradients' tolerance by
    twice it."""
    lr = TRAIN_TCFG.learning_rate
    worst = {"metrics": 0.0, "loss_adv": 0.0, "bn": 0.0, "grads": 0.0,
             "params": 0.0, "update_gap": 0.0}
    out_leaves = []
    ok = True
    for k, v in metrics.items():
        d = abs(float(v) - ref["metrics"][k])
        if k == "loss_adv":
            worst["loss_adv"] = max(worst["loss_adv"], d)
            ok &= d <= 1e-6
        else:
            worst["metrics"] = max(worst["metrics"], d / max(
                abs(ref["metrics"][k]), 1e-30))
            ok &= d <= 1e-5 * abs(ref["metrics"][k])
    got_bn = flatten(bn_state)
    for k, want in flatten(ref["bn"]).items():
        d = np.abs(got_bn[k] - want)
        worst["bn"] = max(worst["bn"], float((d / (1e-8 + 1e-5 * np.abs(
            want))).max()))
        ok &= bool((d <= 1e-8 + 1e-5 * np.abs(want)).all())
    grads_out = []
    for k, want in ref["params"].items():
        g_ref, g = ref["grads"][k], grads[k]
        ratio = (g - g_ref).abs() / (1e-6 + 1e-4 * g_ref.abs() + 2 * (
            noise[k] if noise else 0.0))
        g_err = float(ratio.max())
        worst["grads"] = max(worst["grads"], g_err)
        zero = k in ZERO_GRAD_LEAVES
        if g_err > 1 or (zero and float(g_ref.abs().max()) >= 1e-6):
            at = int(torch.argmax(ratio))
            grads_out.append({
                "leaf": k, "ratio": g_err, "out": int((ratio > 1).sum()),
                "of": int(g.numel()), "g_ref": float(g_ref.view(-1)[at]),
                "g": float(g.view(-1)[at]),
                "max_g_ref": float(g_ref.abs().max()),
                "max_g": float(g.abs().max())})
            ok = False
        if zero:
            continue
        d = (params[k].detach() - want).abs()
        implied = lr * (g / (g.abs() + 1e-8) -
                        g_ref / (g_ref.abs() + 1e-8)).abs()
        bound = ADAM_ATOL * lr + 1e-6 * want.abs() + implied
        worst["params"] = max(worst["params"], float((d / bound).max()))
        worst["update_gap"] = max(worst["update_gap"],
                                  float(implied.max() / lr))
        if bool((d > bound).any()):
            at = int(torch.argmax(d / bound))
            out_leaves.append({
                "leaf": k, "out": int((d > bound).sum()),
                "of": int(d.numel()), "ratio": float((d / bound).view(-1)[at]),
                "g_ref": float(g_ref.view(-1)[at]), "g": float(g.view(-1)[at]),
                "p_ref": float(want.view(-1)[at]),
                "p": float(params[k].detach().view(-1)[at])})
            ok = False
    return {"worst": worst, "out": out_leaves, "grads_out": grads_out,
            "ok": bool(ok)}


def single_card_step(mcfg, train, feats, dev, swap=False):
    """The single-card step from create_train_state's state on the first
    global batch: its metrics, bn state, parameters and gradients. With
    `swap`, the batch's two halves swapped, each row with its own
    negatives: the same sums, in another order."""
    state, schedule = train_step.create_train_state(mcfg, TRAIN_TCFG,
                                                    device=dev)
    step = train_step.make_train_step(mcfg, TRAIN_TCFG, schedule, feats,
                                      device=dev)
    batch = next(iter(BatchIterator(train, TRAIN_TCFG.batch_size,
                                    seed=TRAIN_TCFG.seed)))
    sample = train_objective.sample_negatives
    if swap:
        half = TRAIN_TCFG.batch_size // 2
        batch = {k: np.concatenate([v[half:], v[:half]])
                 for k, v in batch.items()}

        def swapped(*a, **kw):
            rows = sample(*a, **kw).reshape(2, half, -1)
            return torch.cat([rows[1], rows[0]]).reshape(-1)

        train_objective.sample_negatives = swapped
    try:
        new, metrics = step(state, batch, TRAIN_TCFG.seed + 1)
    finally:
        train_objective.sample_negatives = sample
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "bn": new.bn_state,
            "params": {k: v.detach().clone()
                       for k, v in train_step.named_leaves(new.params)},
            "grads": {k: v.grad.clone()
                      for k, v in train_step.named_leaves(new.params)}}


class Collectives:
    """Counts dist.all_reduce's calls and bytes while on, and times the
    gradients' all-reduce with the card synchronized before and after it."""

    def __init__(self, dev):
        self.dev, self.calls, self.nbytes, self.grad_ms = dev, 0, 0, []
        self.grad_bytes = 0

    def __enter__(self):
        self.plain, self.plain_grads = dist.all_reduce, \
            collectives.all_reduce_grads

        def all_reduce(t, *a, **kw):
            self.calls += 1
            self.nbytes += t.numel() * t.element_size()
            return self.plain(t, *a, **kw)

        def all_reduce_grads(leaves, group):
            sync(self.dev)
            t0 = time.perf_counter()
            self.grad_bytes = self.plain_grads(leaves, group)
            sync(self.dev)
            self.grad_ms.append((time.perf_counter() - t0) * 1e3)
            return self.grad_bytes

        dist.all_reduce = all_reduce
        collectives.all_reduce_grads = all_reduce_grads
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.plain
        collectives.all_reduce_grads = self.plain_grads


def dp_rank(rank, port, inputs, dev_type, out):
    """One rank of phase 7f's world. Rank 0 first runs the single-card
    steps (phase 7c's and the mp catalogue's) the world's steps are held
    against. Then dp=2: DP_STEPS steps of make_train_step(mesh=...) on this
    rank's blocks of BatchIterator(mesh=...), the ranks' state bit-equal
    before and after each, the draws equal, the first step against the
    single-card step, one step's collectives counted and its gradient
    all-reduce timed; then dp=1 x mp=2 with train_state_shardings: one step,
    the tables gathered whole against the single-card step's. Puts its
    result, or its traceback, on `out`."""
    result = {"rank": rank}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
            torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        z = np.load(inputs)
        part = {p: {k.split("/", 1)[1]: z[k] for k in z.files
                    if k.startswith(p + "/")}
                for p in ("train", "feat", "mp_train", "mp_feat")}
        if rank == 0:
            t0 = time.perf_counter()
            refs = {"dp": single_card_step(TRAIN_MCFG, part["train"],
                                           part["feat"], dev),
                    "mp": single_card_step(MP_MCFG, part["mp_train"],
                                           part["mp_feat"], dev)}
            swapped = single_card_step(TRAIN_MCFG, part["train"],
                                       part["feat"], dev, swap=True)
            noise = {k: float((g - refs["dp"]["grads"][k]).abs().max())
                     for k, g in swapped["grads"].items()}
            result["reorder_noise"] = max(noise.values())
            del swapped
            result["reference_s"] = time.perf_counter() - t0
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=DP_RANKS, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        result["backend"] = dist.get_backend()
        mesh = make_mesh(dp=DP_RANKS, mp=1)

        # the draws of each step, to hold them equal across the ranks
        draws = []
        sample = train_objective.sample_negatives

        def recording(*a, **kw):
            got = sample(*a, **kw)
            draws.append(got.clone())
            return got

        train_objective.sample_negatives = recording
        state, schedule = train_step.create_train_state(
            TRAIN_MCFG, TRAIN_TCFG, device=dev)
        step = train_step.make_train_step(TRAIN_MCFG, TRAIN_TCFG, schedule,
                                          part["feat"], device=dev, mesh=mesh)
        equal = [same_on_every_rank(state_tensors(state))]
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        walls, coll = [], None
        batches = BatchIterator(part["train"], TRAIN_TCFG.batch_size,
                                seed=TRAIN_TCFG.seed, mesh=mesh)
        for i, batch in zip(range(DP_STEPS), batches):
            result["rows"] = len(batch["gt_item_id"])
            instrument = Collectives(dev) if i == DP_STEPS - 1 else \
                contextlib.nullcontext()
            with instrument:
                sync(dev)
                t0 = time.perf_counter()
                state, metrics = step(state, batch, TRAIN_TCFG.seed + 1)
                sync(dev)
                walls.append((time.perf_counter() - t0) * 1e3)
            if i == DP_STEPS - 1:
                coll = instrument
            if i == 0 and rank == 0:
                leaves = dict(train_step.named_leaves(state.params))
                result["against_single"] = step_against(
                    refs["dp"], metrics, state.bn_state, leaves,
                    {k: v.grad for k, v in leaves.items()}, noise)
            result.setdefault("metrics", []).append(
                {m: float(v) for m, v in metrics.items()})
            equal.append(same_on_every_rank(state_tensors(state)))
        result["launches"] = path_launches_now()
        result["walls"] = walls
        result["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if dev.type == "cuda" else 0.0
        result["bit_equal"] = equal
        same_draws = []
        for d in draws:
            mine = d.clone()
            dist.broadcast(d, src=0)
            same_draws.append(bool(torch.equal(mine, d)))
        result["same_draws"] = same_draws
        result["draw_sizes"] = [int(d.numel()) for d in draws]
        result["collectives"] = {"calls": coll.calls, "bytes": coll.nbytes,
                                 "grad_bytes": coll.grad_bytes,
                                 "grad_ms": coll.grad_ms}
        train_objective.sample_negatives = sample
        del state, step

        # dp=1 x mp=2: the tables row-sharded over the two ranks
        m12 = make_mesh(dp=1, mp=DP_RANKS)
        whole, schedule = train_step.create_train_state(
            MP_MCFG, TRAIN_TCFG, device=dev)
        sh = train_state_shardings(m12, whole)
        local = train_step.shard_train_state(whole, sh, m12)
        del whole
        step = train_step.make_train_step(MP_MCFG, TRAIN_TCFG, schedule,
                                          part["mp_feat"], device=dev,
                                          mesh=m12, state_shardings=sh)
        batch = next(iter(BatchIterator(part["mp_train"],
                                        TRAIN_TCFG.batch_size,
                                        seed=TRAIN_TCFG.seed, mesh=m12)))
        sync(dev)
        zero_launches()
        with Collectives(dev) as mp_coll:
            t0 = time.perf_counter()
            local, metrics = step(local, batch, TRAIN_TCFG.seed + 1)
            sync(dev)
            mp_wall = (time.perf_counter() - t0) * 1e3
        mp = {"launches": path_launches_now(), "wall": mp_wall,
              "calls": mp_coll.calls, "bytes": mp_coll.nbytes,
              "rows": int(local.params["ht_item"].shape[0]),
              "cate_rows": int(local.params["ht_cate"].shape[0])}
        params = dict(train_step.named_leaves(local.params))
        tables = {k: whole_leaf(params[k], sh["params"][k], m12)
                  for k in ("ht_item", "ht_cate")}
        replicated = [t for k, t in train_step.named_leaves(local.params)
                      if k not in tables]
        mp["replicated_equal"] = same_on_every_rank(
            replicated + [t for _, t in train_step.named_leaves(
                local.bn_state)], m12.group("mp"))
        grads = {k: whole_leaf(params[k].grad, sh["params"][k], m12)
                 for k in tables}
        if rank == 0:
            mp["against_single"] = step_against(
                refs["mp"], metrics, local.bn_state, {**params, **tables},
                {**{k: v.grad for k, v in params.items()}, **grads})
        result["mp"] = mp
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        result["error"] = traceback.format_exc()
    out.put(result)


def dp_train_phase(dev, tmp, data, mp_data, timeout_s=400):
    """Phase 7f: a spawned world of DP_RANKS ranks on the one card (gloo
    over CUDA tensors). Returns {"row_topk": launches a rank a dp step,
    "gather_rows": rank 0's launches in the mp step}, the kernels line's
    launches_dp_train."""
    train, _test, feats = data
    mp_train, _, mp_feats = mp_data
    rows = DP_STEPS * TRAIN_TCFG.batch_size
    inputs = os.path.join(tmp, "dp_inputs.npz")
    np.savez(inputs, **{f"train/{k}": v[:rows] for k, v in train.items()},
             **{f"feat/{k}": v for k, v in feats.items()},
             **{f"mp_train/{k}": v for k, v in mp_train.items()},
             **{f"mp_feat/{k}": v for k, v in mp_feats.items()})
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=dp_rank, args=(r, port, inputs, dev.type,
                                               out))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.perf_counter() + timeout_s
    try:
        while len(results) < DP_RANKS:
            left = deadline - time.perf_counter()
            try:
                got = out.get(timeout=max(left, 1))
            except queue.Empty:
                raise AssertionError(f"the dp world gave {len(results)} of "
                                     f"{DP_RANKS} results in {timeout_s} s"
                                     ) from None
            results[got["rank"]] = got
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: res["error"] for r, res in results.items() if "error" in res}
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank failed (exit codes "
                             f"{[p.exitcode for p in procs]}): {errors}")
    r0 = results[0]
    print(f"   world of {DP_RANKS} ranks on {dev}: backend {r0['backend']}; "
          f"rank 0's single-card reference steps {r0['reference_s']:.2f}s; "
          f"{TRAIN_MCFG.num_item:,} items, global batch "
          f"{TRAIN_TCFG.batch_size} ({r0['rows']} a rank), num_neg "
          f"{TRAIN_TCFG.num_neg}; the single-card step's gradients on its "
          f"batch with the halves swapped differ from its own by up to "
          f"{r0['reorder_noise']:.3g}")
    problems = []
    for r in range(DP_RANKS):
        res = results[r]
        coll = res["collectives"]
        print(f"   rank {r} dp=2: step walls ms "
              f"{[round(t, 2) for t in res['walls']]} (card synchronized "
              f"around each; step {DP_STEPS - 1} with its collectives "
              f"counted); peak memory {res['peak_gib']:.2f} GiB "
              f"(max_memory_allocated over the steps); state bit-equal on "
              f"both ranks before and after each step {res['bit_equal']}; "
              f"draws equal {res['same_draws']} of {res['draw_sizes']}; "
              f"launches over {DP_STEPS} steps {res['launches']}")
        print(f"   rank {r} dp=2 collectives of one step: "
              f"{coll['calls']} all_reduce calls, {coll['bytes'] / 1e6:.2f} "
              f"MB, of them the gradients {coll['grad_bytes'] / 1e6:.2f} MB "
              f"in {coll['grad_ms'][0]:.2f} ms (card synchronized before "
              f"and after)")
        mp = res["mp"]
        print(f"   rank {r} dp=1 x mp=2: {mp['rows']:,} ht_item rows and "
              f"{mp['cate_rows']} ht_cate rows a rank; step wall "
              f"{mp['wall']:.2f} ms; {mp['calls']} all_reduce calls, "
              f"{mp['bytes'] / 1e6:.2f} MB; replicated leaves and bn state "
              f"bit-equal {mp['replicated_equal']}; launches {mp['launches']}")
        launched = res["launches"]
        if not (all(res["bit_equal"]) and all(res["same_draws"])
                and launched["row_topk"] == DP_STEPS
                and not any(n for k, n in launched.items()
                            if k != "row_topk")
                and all(n == SAMPLER_K for n in res["draw_sizes"])
                and mp["replicated_equal"]
                and mp["launches"]["row_topk"] == 1
                and mp["launches"]["gather_rows"] >= 4):
            problems.append(f"rank {r}")
    for m in r0["metrics"]:
        print("   dp=2 step: " + ", ".join(f"{k} {m[k]:.6g}" for k in
                                           ("loss", "loss_xe", "loss_adv",
                                            "acc", "acc_origin")))
    for case, got in (("dp=2 step 1", r0["against_single"]),
                      ("dp=1 x mp=2 step", r0["mp"]["against_single"])):
        print(f"   {case} against the single-card step: worst error / "
              f"tolerance {got['worst']} (metrics relative; loss_adv "
              f"absolute, tol 1e-6); parameters out {got['out']}; "
              f"gradients out {got['grads_out']}: in {got['ok']}")
        if not got["ok"]:
            problems.append(case)
    if problems or not all(np.isfinite(list(m.values())).all()
                           for m in r0["metrics"]):
        raise AssertionError(f"phase 7f failed: {problems}")
    return {"row_topk": r0["launches"]["row_topk"] / DP_STEPS,
            "gather_rows": r0["mp"]["launches"]["gather_rows"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp(prefix="nann_chip_smoke_")
    try:
        return run(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(dev: torch.device, tmp: str) -> int:
    t_start = time.perf_counter()
    with phase("1 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        print(f"   torch.cuda.get_device_name: {kind} (count {count}); "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
            "nvidia-smi gave no output"
        print(card, flush=True)

    with phase("2 build"):
        times = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            fn()
            times[name] = time.perf_counter() - t0

        # one nvcc per source and g++ run side by side
        builds = {f"{src}.cu (nvcc)": lambda src=src: kernel_build.load(src)
                  for src in ("frontier_scorer", "visited_ops", "select_ops")}
        builds["hnsw.cc (g++)"] = hnsw_build._load_lib
        data = []
        builds["phase 7c's synthetic data (numpy)"] = lambda: data.append(
            synthetic_dataset(**TRAIN_DATA))
        mp_data = []
        builds["phase 7f's mp catalogue (numpy)"] = lambda: mp_data.append(
            synthetic_dataset(**MP_DATA))
        threads = [threading.Thread(target=timed, args=item)
                   for item in builds.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(times) != len(builds):
            raise RuntimeError("a build failed (see the traceback above)")
        for name, s in times.items():
            print(f"   built {name} in {s:.2f}s")

    gen = torch.Generator().manual_seed(0)
    params, state = init_scorer(MCFG, gen, device=dev)
    rng = np.random.default_rng(0)
    item_embs = rng.standard_normal((NUM_ITEMS, MCFG.item_emb_dim)).astype(
        np.float32)
    with phase("3 kernel"):
        cases, int8_cases = check_kernel(
            params, state, torch.from_numpy(item_embs).to(dev),
            pack_quantized(item_embs).to(dev), gen)
        visited_cases = check_visited_kernels(dev)
        # the row phase 7c's first train step draws its negatives from
        probs = torch.as_tensor(data[0][2]["weight_tag"], device=dev)
        sampler_row = train_sampler.gumbel_keys(
            step_generator(TRAIN_TCFG.seed + 1, 0, dev),
            torch.log(1e-20 + probs))
        select_cases = check_select_kernels(dev, sampler_row)
        del probs, sampler_row

    with phase("4 bundle"):
        index_dir = os.path.join(tmp, "index")
        t0 = time.perf_counter()
        build_and_save_index(item_embs, SCFG.hnsw_start_level, HNSW_M,
                             index_dir, ef_construction=HNSW_EF, seed=42)
        hnsw_s = time.perf_counter() - t0
        print(f"   hnsw build: {NUM_ITEMS} items, M={HNSW_M}, "
              f"ef_construction={HNSW_EF}: {hnsw_s:.2f}s")
        bundle = os.path.join(tmp, "bundle")
        export_model(bundle, params, state, MCFG, SCFG,
                     item_ids=np.arange(1, NUM_ITEMS + 1, dtype=np.int64),
                     item_embs=item_embs, index_dir=index_dir)
        params, state, mcfg, index = load_serving_bundle(bundle, device=dev)
        if dataclasses.asdict(mcfg) != json.loads(json.dumps(
                dataclasses.asdict(MCFG))) or \
                index.item_embs.dtype != torch.bfloat16:
            raise AssertionError("bundle did not round-trip its config")
        print(f"   bundle read back: {index.num_items} items, "
              f"{index.enter_points.numel()} enter points, degrees "
              f"{ {l: t.shape[1] for l, t in index.neighbors.items()} }")

    ltn = level_topn_default(SCFG)
    users = torch.from_numpy(rng.standard_normal(
        (NUM_QUERIES, MCFG.max_seq_length, MCFG.user_emb_dim)).astype(
            np.float32))
    users_np = users.numpy()
    k_final = max(SCFG.topk_eval)
    with phase("5 search"):
        search_k = make_searcher(mcfg, SCFG)
        search_p = make_searcher(mcfg, SCFG, scorer_impl="plain")
        args = (params, state, index, users, ltn)
        for fn in (search_k, search_p):       # first-call costs at this batch
            fn(*args)
        torch.cuda.synchronize()
        # the list backend's row and id gathers, and the selects
        path_ops = (score_frontier,) + VISITED_OPS[:2] + SELECT_OPS
        for op in path_ops:
            op.launches = 0
        items_k, scores_k, ns_k = search_k(*args)
        torch.cuda.synchronize()
        path_launches = {op.__name__: op.launches for op in path_ops}
        search_launches = score_frontier.launches
        print(f"   launches of one kernel-path search: {path_launches}")
        if not all(path_launches.values()):
            raise AssertionError(f"a kernel of the main path was not "
                                 f"launched: {path_launches}")
        # row_sort and row_topk count calls: one device kernel a call on
        # short rows; a tiled sort launches nine, a tiled top-k ten
        for op, want in (("row_sort", SORTS_PER_LIST_SEARCH),
                         ("row_topk", TOPKS_PER_LIST_SEARCH)):
            if path_launches[op] != want:
                raise AssertionError(f"{op} was called {path_launches[op]} "
                                     f"times in a list search, not {want}")
        # one scorer (the kernel), the sorts, top-ks and element gathers on
        # their plain versions
        selects = select_ops.selects
        select_ops.selects = lambda plain=False: selects(True)
        try:
            search_ks = make_searcher(mcfg, SCFG)
        finally:
            select_ops.selects = selects
        got_ks = search_ks(*args)
        same_ks = all(same_bits(a, b) for a, b in zip(
            (items_k, scores_k, ns_k), got_ks))
        walls_s = alternate_walls(search_k, search_ks, args)
        print(f"   kernel selects against plain selects under the kernel "
              f"scorer: ids, scores and num_scoring identical: {same_ks}; "
              f"wall {np.mean(walls_s['kernel']):.2f} ms "
              f"{[round(t, 2) for t in walls_s['kernel']]} against "
              f"{np.mean(walls_s['plain']):.2f} ms "
              f"{[round(t, 2) for t in walls_s['plain']]}")
        if not same_ks:
            raise AssertionError("the search with kernel selects differs from "
                                 "the search with plain selects")
        items_p, scores_p, _ns_p = search_p(*args)
        walls = alternate_walls(search_k, search_p, args)
        search_ms = float(np.mean(walls["kernel"]))
        plain_search_ms = float(np.mean(walls["plain"]))
        breakdown = trace.device_breakdown(lambda: search_k(*args))
        items_k, scores_k = items_k.cpu().numpy(), scores_k.cpu().numpy()
        items_p, scores_p = items_p.cpu().numpy(), scores_p.cpu().numpy()
        check_results(items_k, scores_k)
        overlap = mean_overlap(items_k, items_p)
        # a common id's score comes from the kernel on one path and from the
        # plain version on the other: hold it at the bfloat16 tolerance
        score_rel = common_score_rel(items_k, scores_k, items_p, scores_p)
        ns_mean = ns_k.float().mean(0).cpu().numpy()
        print(f"   batched search of {NUM_QUERIES} queries, wall (kernel, plain, "
              f"plain, kernel): kernel path {search_ms:.2f} ms "
              f"{[round(t, 2) for t in walls['kernel']]}, plain path "
              f"{plain_search_ms:.2f} ms "
              f"{[round(t, 2) for t in walls['plain']]}; "
              f"{search_launches} kernel launches per search")
        print_breakdown(breakdown, search_ms)
        print(f"   mean num_scoring per hop: {np.round(ns_mean, 1).tolist()}")
        print(f"   top-{k_final} overlap kernel vs plain (bf16): {overlap:.4f} "
              f"(need >= {MIN_OVERLAP})")
        if overlap < MIN_OVERLAP:
            raise AssertionError(f"overlap {overlap} < {MIN_OVERLAP}")
        print(f"   scores of common ids, kernel vs plain path: "
              f"max|d|/(1+|ref|)={score_rel:.3e} (tol {TOL[torch.bfloat16]})")
        if score_rel > TOL[torch.bfloat16]:
            raise AssertionError(f"search scores disagree: {score_rel} > "
                                 f"{TOL[torch.bfloat16]}")
        row_topk = SELECT_OPS[1]
        row_topk.launches = 0
        t0 = time.perf_counter()
        top_idx, _ = brute_force_topk(params, state, mcfg, users,
                                      index.item_embs, k=k_final)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        if row_topk.launches != 1:
            raise AssertionError("the oracle's top-k did not run through "
                                 "row_topk")
        # the same oracle with the plain top-k: equal ids, so that the
        # recall below is the one plain selects give on this graph
        select_ops.row_topk = select_ops.row_topk_plain
        try:
            plain_idx, _ = brute_force_topk(params, state, mcfg, users,
                                            index.item_embs, k=k_final)
        finally:
            select_ops.row_topk = row_topk
        same_oracle = torch.equal(top_idx, plain_idx)
        oracle_ids = index.item_ids[top_idx.long()].cpu().numpy()
        recall = float(np.mean([calc_pr(o, g[g >= 0])[1]
                                for o, g in zip(oracle_ids, items_k)]))
        print(f"   graph recall@{k_final} vs brute-force oracle: {recall:.4f} "
              f"(oracle {oracle_s * 1e3:.1f} ms through the scorer kernel "
              f"and row_topk; its ids equal the plain top-k's: "
              f"{same_oracle})")
        if not same_oracle:
            raise AssertionError("the oracle's row_topk differs from the "
                                 "plain top-k")

    with phase("6 engine"):
        score_frontier.launches = 0
        serve_s, engine = serve(mcfg, params, state, index, users_np, items_k,
                                scores_k, "engine")
        engine_launches = score_frontier.launches
        print(f"   engine: {NUM_QUERIES} requests answered in "
              f"{serve_s * 1e3:.1f} ms, all equal to the direct search; "
              f"{engine_launches} kernel launches (warmup included)")
        for line in engine.metrics.report_lines():
            print("  ", line)
        if engine_launches == 0:
            raise AssertionError("the engine launched no kernel")

    with phase("6b front ends"):
        front_launches = front_ends(mcfg, params, state, index, tmp,
                                          item_embs, card, dev)

    with phase("7 int8"):
        params8, state8, mcfg8, index8 = load_serving_bundle(
            bundle, dtype="int8", device=dev)
        if index8.item_embs.dtype != torch.int8 or tuple(
                index8.item_embs.shape) != (NUM_ITEMS, MCFG.item_emb_dim + 4):
            raise AssertionError(f"int8 index is {index8.item_embs.dtype} "
                                 f"{tuple(index8.item_embs.shape)}")
        print(f"   int8 bundle read back: item table int8 "
              f"{list(index8.item_embs.shape)} "
              f"({index8.item_embs.numel() / 1e6:.1f} MB; bfloat16 "
              f"{index.item_embs.numel() * 2 / 1e6:.1f} MB)")
        search_k8 = make_searcher(mcfg8, SCFG)
        search_p8 = make_searcher(mcfg8, SCFG, scorer_impl="plain")
        args8 = (params8, state8, index8, users, ltn)
        for fn in (search_k8, search_p8):
            fn(*args8)
        torch.cuda.synchronize()
        score_frontier.launches = score_frontier.launches_int8 = 0
        items_8, scores_8, ns_8 = search_k8(*args8)
        torch.cuda.synchronize()
        search_launches_8 = score_frontier.launches_int8
        if search_launches_8 == 0 or score_frontier.launches != 0:
            raise AssertionError(
                f"the int8 search launched the int8 kernel "
                f"{search_launches_8} times and the float kernel "
                f"{score_frontier.launches} times")
        items_8p, scores_8p, _ = search_p8(*args8)
        walls8 = alternate_walls(search_k8, search_p8, args8)
        search_ms_8 = float(np.mean(walls8["kernel"]))
        breakdown8 = trace.device_breakdown(lambda: search_k8(*args8))
        items_8, scores_8 = items_8.cpu().numpy(), scores_8.cpu().numpy()
        items_8p, scores_8p = items_8p.cpu().numpy(), scores_8p.cpu().numpy()
        check_results(items_8, scores_8)
        overlap8 = mean_overlap(items_8, items_8p)
        score_rel8 = common_score_rel(items_8, scores_8, items_8p, scores_8p)
        print(f"   int8 batched search of {NUM_QUERIES} queries, wall (kernel, "
              f"plain, plain, kernel): kernel path {search_ms_8:.2f} ms "
              f"{[round(t, 2) for t in walls8['kernel']]}, plain path "
              f"{np.mean(walls8['plain']):.2f} ms "
              f"{[round(t, 2) for t in walls8['plain']]}; "
              f"{search_launches_8} int8 kernel launches per search, "
              f"0 float")
        print_breakdown(breakdown8, search_ms_8)
        print(f"   mean num_scoring per hop: "
              f"{np.round(ns_8.float().mean(0).cpu().numpy(), 1).tolist()}")
        print(f"   top-{k_final} overlap int8 kernel vs plain: {overlap8:.4f} "
              f"(need >= {MIN_OVERLAP})")
        if overlap8 < MIN_OVERLAP:
            raise AssertionError(f"int8 overlap {overlap8} < {MIN_OVERLAP}")
        print(f"   scores of common ids, int8 kernel vs plain path: "
              f"max|d|/(1+|ref|)={score_rel8:.3e} "
              f"(tol {TOL[torch.bfloat16]})")
        if score_rel8 > TOL[torch.bfloat16]:
            raise AssertionError(f"int8 search scores disagree: {score_rel8} "
                                 f"> {TOL[torch.bfloat16]}")
        recall8 = float(np.mean([calc_pr(o, g[g >= 0])[1]
                                 for o, g in zip(oracle_ids, items_8)]))
        print(f"   top-{k_final} overlap int8 vs bfloat16 search (phase 5): "
              f"{mean_overlap(items_8, items_k):.4f}; graph recall@{k_final} "
              f"vs the bfloat16 oracle: {recall8:.4f}")

        # the bundle's own artifacts, as load_serving_bundle reads them (its
        # item table is stored in float16)
        index8b = SearchIndex.from_artifacts(
            load_index(os.path.join(bundle, "index"), SCFG.hnsw_start_level),
            np.load(os.path.join(bundle, "item_embs.npy")).astype(np.float32),
            np.load(os.path.join(bundle, "item_ids.npy")), dtype="int8",
            reorder="bfs", device=dev)
        args8b = (params8, state8, index8b, users, ltn)
        search_k8(*args8b)
        bfs_walls = [wall_ms(lambda: search_k8(*args8b)) for _ in range(2)]
        items_8b, scores_8b, _ = search_k8(*args8b)
        items_8b, scores_8b = items_8b.cpu().numpy(), scores_8b.cpu().numpy()
        check_results(items_8b, scores_8b)
        recall8b = float(np.mean([calc_pr(o, g[g >= 0])[1]
                                  for o, g in zip(oracle_ids, items_8b)]))
        print(f"   int8 search on the reorder='bfs' index: "
              f"{np.mean(bfs_walls):.2f} ms {[round(t, 2) for t in bfs_walls]}"
              f"; top-{k_final} overlap with the plain-order int8 search "
              f"{mean_overlap(items_8b, items_8):.4f} (printed, not held: "
              f"hops that overflow the cap truncate other nodes); "
              f"recall@{k_final} vs the bfloat16 oracle {recall8b:.4f}")
        # with a cap no hop reaches, nothing is truncated and the relabel
        # must not change the answer
        wide = dataclasses.replace(SCFG, frontier_cap=NO_TRUNCATION_CAP)
        search_w = make_searcher(mcfg8, wide)
        items_w, _, ns_w = search_w(params8, state8, index8, users, ltn)
        items_wb, _, _ = search_w(*args8b)
        overlap_w = mean_overlap(items_wb.cpu().numpy(),
                                 items_w.cpu().numpy())
        print(f"   at frontier_cap {NO_TRUNCATION_CAP} (mean num_scoring "
              f"{np.round(ns_w.float().mean(0).cpu().numpy(), 1).tolist()}): "
              f"top-{k_final} overlap bfs vs plain order {overlap_w:.4f} "
              f"(need >= {MIN_OVERLAP})")
        if overlap_w < MIN_OVERLAP:
            raise AssertionError(f"bfs relabel changed an untruncated search: "
                                 f"overlap {overlap_w} < {MIN_OVERLAP}")
        del index8b

        score_frontier.launches = score_frontier.launches_int8 = 0
        serve_s8, engine8 = serve(mcfg8, params8, state8, index8, users_np,
                                  items_8, scores_8, "int8 engine")
        engine_launches_8 = score_frontier.launches_int8
        if engine_launches_8 == 0 or score_frontier.launches != 0:
            raise AssertionError(
                f"the int8 engine launched the int8 kernel "
                f"{engine_launches_8} times and the float kernel "
                f"{score_frontier.launches} times")
        print(f"   int8 engine: {NUM_QUERIES} requests answered in "
              f"{serve_s8 * 1e3:.1f} ms, all equal to the direct int8 "
              f"search; {engine_launches_8} int8 kernel launches (warmup "
              f"included)")
        for line in engine8.metrics.report_lines():
            print("  ", line)

    with phase("7b byte-map"):
        bm = dataclasses.replace(SCFG, vis_impl="bytemap")
        search_kb = make_searcher(mcfg, bm)
        search_pb = make_searcher(mcfg, bm, scorer_impl="plain")
        for fn in (search_kb, search_pb):
            fn(*args)
        torch.cuda.synchronize()
        score_frontier.launches = 0
        for op in VISITED_OPS + SELECT_OPS:
            op.launches = 0
        items_b, scores_b, ns_b = search_kb(*args)
        torch.cuda.synchronize()
        bytemap_launches = {op.__name__: op.launches
                            for op in VISITED_OPS + SELECT_OPS}
        bytemap_launches["frontier_scorer"] = score_frontier.launches
        if not all(bytemap_launches.values()):
            raise AssertionError(f"a kernel of the byte-map path was not "
                                 f"launched: {bytemap_launches}")
        items_bp, scores_bp, _ = search_pb(*args)
        walls_b = alternate_walls(search_kb, search_pb, args)
        search_ms_b = float(np.mean(walls_b["kernel"]))
        breakdown_b = trace.device_breakdown(lambda: search_kb(*args))
        items_b, scores_b = items_b.cpu().numpy(), scores_b.cpu().numpy()
        items_bp, scores_bp = items_bp.cpu().numpy(), scores_bp.cpu().numpy()
        check_results(items_b, scores_b)
        overlap_b = mean_overlap(items_b, items_bp)
        score_rel_b = common_score_rel(items_b, scores_b, items_bp, scores_bp)
        print(f"   byte-map batched search of {NUM_QUERIES} queries, wall "
              f"(kernel, plain, plain, kernel): kernel path "
              f"{search_ms_b:.2f} ms {[round(t, 2) for t in walls_b['kernel']]}"
              f", plain path {np.mean(walls_b['plain']):.2f} ms "
              f"{[round(t, 2) for t in walls_b['plain']]}; launches per "
              f"search {bytemap_launches}")
        print_breakdown(breakdown_b, search_ms_b)
        for label, bd in (("byte-map", breakdown_b), ("list (phase 5)",
                                                      breakdown)):
            if bd is not None:
                print(f"   filter half, {label}: "
                      f"{sum(bd.values()) - bd['frontier_scorer']:.3f} ms of "
                      f"device time (select kernels "
                      f"{bd['row_sort'] + bd['row_topk']:.3f}: row_sort "
                      f"{bd['row_sort']:.3f}, row_topk {bd['row_topk']:.3f}; "
                      f"visited_ops kernels {bd['visited_ops']:.3f}, other "
                      f"sorts {bd['sort']:.3f}, other {bd['other']:.3f})")
        print(f"   top-{k_final} overlap byte-map kernel vs plain: "
              f"{overlap_b:.4f} (need >= {MIN_OVERLAP}); scores of common "
              f"ids max|d|/(1+|ref|)={score_rel_b:.3e} "
              f"(tol {TOL[torch.bfloat16]})")
        if overlap_b < MIN_OVERLAP or score_rel_b > TOL[torch.bfloat16]:
            raise AssertionError(f"byte-map kernel vs plain: overlap "
                                 f"{overlap_b}, score error {score_rel_b}")
        same_b = np.array_equal(items_b, items_k) and torch.equal(
            ns_b.cpu(), ns_k.cpu())
        print(f"   ids and num_scoring equal to phase 5's list search: "
              f"{same_b}")
        if not same_b:
            raise AssertionError("the byte-map search differs from the list "
                                 "search")

        for name, kw in (("mark_policy='all'", {"mark_policy": "all"}),
                         ("hop_mode='wide'", {"hop_mode": "wide"}),
                         ("topk_impl='approx'", {"topk_impl": "approx"}),
                         ("semantics='serving'", {"semantics": "serving"})):
            cfg = dataclasses.replace(bm, **kw)
            args_m = (params, state, index, users, level_topn_default(cfg))
            search_m = make_searcher(mcfg, cfg)
            got_m = search_m(*args_m)
            want_m = make_searcher(mcfg, cfg, scorer_impl="plain")(*args_m)
            walls_m = [wall_ms(lambda: search_m(*args_m)) for _ in range(2)]
            items_m = got_m[0].cpu().numpy()
            check_results(items_m, got_m[1].cpu().numpy())
            overlap_m = mean_overlap(items_m, want_m[0].cpu().numpy())
            recall_m = float(np.mean([calc_pr(o, g[g >= 0])[1]
                                      for o, g in zip(oracle_ids, items_m)]))
            ns_m = got_m[2].float().mean(0).cpu().numpy()
            print(f"   {name:20s} kernel vs plain overlap {overlap_m:.4f} "
                  f"(need >= {MIN_OVERLAP}); mean num_scoring per hop "
                  f"{np.round(ns_m, 1).tolist()}; recall@{k_final} "
                  f"{recall_m:.4f}; kernel path wall {np.mean(walls_m):.2f} "
                  f"ms {[round(t, 2) for t in walls_m]}", flush=True)
            if overlap_m < MIN_OVERLAP:
                raise AssertionError(f"{name}: overlap {overlap_m} < "
                                     f"{MIN_OVERLAP}")

        report = {}
        tuned = autotune_hop_caps(mcfg, bm, params, state, index, users_np,
                                  report=report)
        print(f"   autotuned per-hop caps {tuned.frontier_cap_per_hop} from "
              f"probe maxima {report['probe_hop_maxima']} (means "
              f"{report['probe_hop_means']}, scalar cap "
              f"{report['scalar_cap']})")
        widths = []

        def recording_scorer(weights, k_proj, v, table, ids, valid):
            widths.append(tuple(ids.shape))
            return score_frontier(weights, k_proj, v, table, ids, valid)

        search_beam.score_frontier = recording_scorer
        try:
            search_t = make_searcher(mcfg, tuned)
        finally:
            search_beam.score_frontier = score_frontier
        items_t, _, ns_t = search_t(*args)
        items_t, ns_t = items_t.cpu().numpy(), ns_t.cpu().numpy()
        caps = np.asarray(tuned.frontier_cap_per_hop)
        # a query whose hops all stay below their tuned caps is not truncated
        # by them; a hop tuned to the scalar cap truncates as before
        free = np.all((ns_b.cpu().numpy()[:, 1:] < caps)
                      | (caps == bm.frontier_cap), axis=1)
        equal_t = [np.array_equal(items_t[q], items_b[q])
                   for q in np.flatnonzero(free)]
        walls_t = [wall_ms(lambda: search_t(*args)) for _ in range(2)]
        print(f"   at the tuned caps: scorer launch widths {widths}; ids "
              f"equal to the scalar-cap search on {sum(equal_t)} of the "
              f"{int(free.sum())} queries no tuned cap truncated (of "
              f"{NUM_QUERIES}); wall {np.mean(walls_t):.2f} ms "
              f"{[round(t, 2) for t in walls_t]}")
        if not all(equal_t):
            raise AssertionError("the tuned caps changed an untruncated "
                                 "search")
        del search_kb, search_pb, search_t

    with phase("7c train"):
        trained = train_phase(dev, tmp, data[0])

    with phase("7d cli"):
        cli_launches = cli_phase(dev, tmp)

    with phase("7e staged and sharded"):
        fused_launches = {
            "frontier_scorer": search_launches, "frontier_scorer_int8": 0,
            "scatter_set": 0, **{k: n for k, n in path_launches.items()
                                 if k != "score_frontier"}}
        int8_launches = dict(fused_launches, frontier_scorer=0,
                             frontier_scorer_int8=search_launches_8)
        staged = staged_phase(
            dev, mcfg, params, state, index, users, ltn,
            fused=((items_k, scores_k, ns_k), fused_launches),
            fused_plain=(items_p, scores_p),
            bytemap=((items_b, scores_b, ns_b),
                     dict(bytemap_launches, frontier_scorer_int8=0)),
            int8={"mcfg": mcfg8, "args": (params8, state8, index8, users, ltn),
                  "want": ((items_8, scores_8, ns_8), int8_launches)},
            users_np=users_np)
        staged_launches = {}
        for got in staged.values():
            for k, n in got.items():
                staged_launches[k] = staged_launches.get(k, 0) + n
        single = {}
        for label, fn, a in (
                ("list", search_k, args),
                ("byte-map", make_searcher(mcfg, dataclasses.replace(
                    SCFG, vis_impl="bytemap")), args),
                ("int8", search_k8, (params8, state8, index8, users, ltn))):
            fn(*a)
            single[label] = [wall_ms(lambda: fn(*a)) for _ in range(3)]
        print(f"   single-card walls just before the world: "
              f"{ {k: [round(t, 2) for t in v] for k, v in single.items()} }")
        torch.cuda.empty_cache()
        sharded_launches = sharded_phase(dev, bundle, users_np, {
            "list": (items_k, scores_k, ns_k.cpu().numpy()),
            "byte-map": (items_b, scores_b, ns_b.cpu().numpy()),
            "int8": (items_8, scores_8, ns_8.cpu().numpy())}, single)

    with phase("7f data-parallel training"):
        torch.cuda.empty_cache()
        dp_launches = dp_train_phase(dev, tmp, data[0], mp_data[0])

    def entry(name, replaces, launches, per_search, main, all_cases):
        return {
            "name": name, "route": "cuda",
            "source": "nann_tpu_torch/csrc/frontier_scorer.cu",
            "replaces": replaces, "launches": launches,
            "launches_per_search": per_search,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
            "plain_device_ms": main["plain_device_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "rows_per_block": main["rows_per_block"],
            "smem_bytes": main["smem_bytes"],
            "blocks_per_sm": main["blocks_per_sm"],
            "shape": f"ids [{main['B']}, {main['F']}] {main['dtype']} "
                     f"L={main['L']}, {main['table']}",
            "card": card, "cases": all_cases}

    def main_case(of):
        return next(c for c in of if c["dtype"] == "bfloat16"
                    and (c["B"], c["F"], c["L"]) == MAIN_SHAPE
                    and c["mask"] == "random")

    def visited_entry(name, replaces):
        path_case = visited_cases[name][-1] if name not in MAIN_VISITED \
            else next(c for c in visited_cases[name]
                      if c["shape"].startswith(MAIN_VISITED[name]))
        plan = {"plan": path_case["plan"]} if "plan" in path_case else {}
        return {
            "name": name, "route": "cuda",
            "source": "nann_tpu_torch/csrc/visited_ops.cu",
            "replaces": replaces, "launches": bytemap_launches[name],
            "launches_per_search": bytemap_launches[name],
            "launches_per_list_search": path_launches.get(name, 0),
            **{k: path_case[k] for k in ("max_abs_err", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_device_ms",
                                         "shape")},
            **plan, "card": card, "cases": visited_cases[name]}

    def select_entry(name, replaces):
        main = next(c for c in select_cases[name]
                    if c["shape"].startswith(MAIN_SELECT[name] + ":"))
        return {
            "name": name, "route": "cuda",
            "source": "nann_tpu_torch/csrc/select_ops.cu",
            "replaces": replaces, "launches": path_launches[name],
            "launches_per_search": path_launches[name],
            "launches_per_bytemap_search": bytemap_launches[name],
            **{k: main[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "device_kernels_per_call", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms", "shape")},
            "card": card, "cases": select_cases[name]}

    probe = "scripts/probe_kernel_ops.py"
    kernels = {"kernels": [
        entry("frontier_scorer", "nann_tpu/experimental/pallas_scorer.py:47",
              engine_launches, search_launches, main_case(cases), cases),
        entry("frontier_scorer_int8",
              "nann_tpu/experimental/pallas_scorer.py:84", engine_launches_8,
              search_launches_8, main_case(int8_cases), int8_cases),
        visited_entry("gather_elems",
                      f"{probe}:173, {probe}:247, {probe}:186"),
        visited_entry("gather_rows", f"{probe}:233"),
        visited_entry("scatter_set", f"{probe}:198"),
        select_entry("row_sort", f"{probe}:212"),
        select_entry("row_topk", f"{probe}:222")]}
    for k in kernels["kernels"]:
        k["launches_front_ends"] = front_launches.get(k["name"], 0)
        k["launches_train"] = trained["launches_train"].get(k["name"], 0)
        k["launches_trained_tail"] = trained["launches_tail"].get(k["name"],
                                                                  0)
        k["launches_cli"] = cli_launches["launches_cli"].get(k["name"], 0)
        if k["name"] in ("frontier_scorer", "row_topk", "gather_elems"):
            k["launches_tree"] = cli_launches["launches_tree"][k["name"]]
        k["launches_staged"] = staged_launches.get(k["name"], 0)
        k["launches_sharded"] = sharded_launches.get(k["name"], 0)
        k["launches_dp_train"] = dp_launches.get(k["name"], 0)
    with phase("8 kernels"):
        print(json.dumps(kernels), flush=True)
    print(f"   total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
