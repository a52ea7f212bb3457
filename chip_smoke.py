#!/usr/bin/env python3
"""Drive the PyTorch port (nann_tpu_torch) through its main path on one GPU.

    python3 chip_smoke.py

Phases, each printed with its wall seconds; any failure raises and the
script exits non-zero:

  1 device   the card's name, and its name and power limit from nvidia-smi
  2 build    the CUDA kernel library (nvcc) and the native HNSW builder (g++)
  3 kernel   the frontier-scorer kernel against its plain PyTorch version on
             the card: ids [16, 4096] (L = 50 and 7) and the main path's
             shapes [64, 4096], [64, 2880], [64, 90] (L = 50), ~10% invalid,
             into a 100k-row table, float32 and bfloat16; then packed int8
             tables (int8 [N, 68]) at float32 and bfloat16 compute: ids
             [64, 4096], [64, 2880] and [64, 90] into the 100k items, and
             [64, 8192] into a 4,200,000-row table (the reference scale and
             its frontier cap), timed with fresh ids on every call so that
             its rows come from HBM; all timed with CUDA events
  4 bundle   random serving-width weights (seeded) and 100,000 items of width
             64; HNSW graph (M=32, ef_construction=64); the bundle is written
             with the port's writer to a temporary directory and read back
  5 search   64 queries through the batched search on the kernel path and on
             the plain path; top-200 overlap, per-hop num_scoring, kernel
             launches, scores of common ids within the bfloat16 tolerance,
             recall@200 against the brute-force oracle
  6 engine   the serving engine on the bundle (every bucket warmed), 64
             requests from 4 threads, each answer equal to the direct search
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
  8 kernels  one JSON line {"kernels": [...]}
  9 result   the last line: {"ok": true, "device": {...}}

It needs one CUDA card and exits non-zero without one. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from nann_tpu_torch.config import (ModelConfig, SearchConfig,
                                   default_frontier_cap)
from nann_tpu_torch.delivery import export_model, load_serving_bundle
from nann_tpu_torch.index import build_and_save_index, load_index
from nann_tpu_torch.index import hnsw_build
from nann_tpu_torch.index.quantize import pack_quantized
from nann_tpu_torch.kernels import build as kernel_build
from nann_tpu_torch.kernels.frontier_scorer import (frontier_scorer_plain,
                                                    kernel_weights,
                                                    score_frontier)
from nann_tpu_torch.models import init_scorer
from nann_tpu_torch.ops import fold_scorer, precompute_user
from nann_tpu_torch.search import (SearchIndex, brute_force_topk,
                                   level_topn_default, make_searcher)
from nann_tpu_torch.serving import Engine, EngineConfig
from nann_tpu_torch.utils import calc_pr

# the serving width of bench.py: item/user embeddings 64, attention
# 64 -> 128 -> 256, head (128, 64, 32, 1)
MCFG = ModelConfig(emb_dim=32, max_seq_length=50, compute_dtype="bfloat16")
SCFG = SearchConfig()
NUM_ITEMS = 100_000
HNSW_M, HNSW_EF = 32, 64
NUM_QUERIES = 64
# (B, F, L): the issue's [16, 4096] at both L, then the main path's shapes
# (the ground hops, the level-1 hop, the enter points)
KERNEL_CASES = [(16, 4096, 50), (16, 4096, 7), (64, 4096, 50),
                (64, 2880, 50), (64, 90, 50)]
MAIN_SHAPE = (64, 4096, 50)
# the reference scale of bench.py, where int8 is the item table's default
REF_ITEMS = 4_200_000
# a frontier cap above any hop's expansion (400 candidates x degree 64 on
# the ground level), so that no hop truncates
NO_TRUNCATION_CAP = max(SCFG.top_k_per_level) * 2 * HNSW_M
# (B, F, L, table) on packed int8 tables: the main path's ground hops,
# level-1 hop and enter points, and a frontier at the reference scale's cap
INT8_CASES = [(64, 4096, 50, "100k"), (64, 2880, 50, "100k"),
              (64, 90, 50, "100k"),
              (64, default_frontier_cap(REF_ITEMS), 50, "4.2M")]
TOL = {torch.float32: 2e-4, torch.bfloat16: 0.05}   # x (1 + |ref|)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}   # H100 SXM
PEAK_BYTES = 3.35e12
MIN_OVERLAP = 0.98


@contextlib.contextmanager
def phase(name):
    """Print a phase's name, and its wall seconds when it succeeds."""
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f}s", flush=True)


TIMED_CALLS = 12   # cuda_ms's warm-up and timed calls together


def cuda_ms(fn, repeats=10, warmup=2):
    """Mean milliseconds of fn() on the card, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def wall_ms(fn) -> float:
    """Host-clock milliseconds of fn() through to the card's last kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_breakdown(fn):
    """Device milliseconds of one fn() by kernel family from torch.profiler:
    the frontier scorer, sorts, everything else. None where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if ProfilerActivity.CUDA not in supported_activities():
        return None
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no CUPTI: the breakdown is not measured
        print(f"   torch.profiler failed: {e}")
        return None
    groups = {"frontier_scorer": 0.0, "sort": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        group = "frontier_scorer" if "frontier_scorer" in name else \
            "sort" if "sort" in name else "other"
        groups[group] += ms
    return groups if sum(groups.values()) > 0 else None


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


def hold_case(weights, k_proj, v, table, ids, valid, dt, label,
              timing_ids=None):
    """One kernel case against the plain version on the same inputs: the
    -inf of invalid rows, the error, both times and the bound. With
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
    (B, F), L = ids.shape, k_proj.shape[1]
    bound, bound_by, flops, nbytes = kernel_bound_ms(MCFG, dt, valid, L,
                                                     weights, table)
    case = {"dtype": str(dt).replace("torch.", ""), "B": B, "F": F, "L": L,
            "table": label,
            "max_abs_err": err.max().item(), "max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes}
    print(f"   kernel {case['dtype']:8s} {label:20s} ids [{B}, {F}] L={L:2d}: "
          f"max|d|={case['max_abs_err']:.3e} "
          f"max|d|/(1+|ref|)={rel:.3e} (tol {TOL[dt]}) "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({bound_by})", flush=True)
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

    def inputs(dt, B, F, L, n):
        ids = torch.randint(0, n, (B, F), generator=gen,
                            dtype=torch.int32).to(dev)
        valid = (torch.rand((B, F), generator=gen) > 0.1).to(dev)
        user = torch.randn((B, L, MCFG.user_emb_dim), generator=gen).to(dev)
        return (*precompute_user(folded, user, dt), ids, valid)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        table = table32.to(dt).contiguous()
        weights = kernel_weights(folded, dt)
        for B, F, L in KERNEL_CASES:
            k_proj, v, ids, valid = inputs(dt, B, F, L, table.shape[0])
            cases.append(hold_case(weights, k_proj, v, table, ids, valid, dt,
                                   f"{table.shape[0]:,} rows"))
    ref_table = random_packed_table(REF_ITEMS, MCFG.item_emb_dim, dev, seed=1)
    print(f"   packed int8 tables: {packed.shape[0]} x {packed.shape[1]} B "
          f"({packed.numel() / 1e6:.1f} MB), {ref_table.shape[0]} x "
          f"{ref_table.shape[1]} B ({ref_table.numel() / 1e6:.1f} MB)")
    int8_cases = []
    for dt in (torch.float32, torch.bfloat16):
        weights = kernel_weights(folded, dt)
        for B, F, L, which in INT8_CASES:
            table = packed if which == "100k" else ref_table
            k_proj, v, ids, valid = inputs(dt, B, F, L, table.shape[0])
            # the 4.2M table (285.6 MB) outgrows the 50 MB L2: fresh ids
            # for every timed call keep its rows from being read back warm
            timing_ids = None if which == "100k" else [
                torch.randint(0, table.shape[0], (B, F), generator=gen,
                              dtype=torch.int32).to(dev)
                for _ in range(TIMED_CALLS)]
            int8_cases.append(hold_case(weights, k_proj, v, table, ids, valid,
                                        dt, f"int8 {table.shape[0]:,} rows",
                                        timing_ids))
    del ref_table
    return cases, int8_cases


def mean_overlap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([
        len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
        / max(len(y[y >= 0]), 1) for x, y in zip(a, b)]))


def check_results(items: np.ndarray, scores: np.ndarray) -> None:
    """[NUM_QUERIES, k_final] results: no row empty or duplicated, scores
    finite and sorted."""
    k_final = max(SCFG.topk_eval)
    if items.shape != (NUM_QUERIES, k_final):
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


def serve(mcfg, params, state, index, users_np, want_items):
    """The engine on `index` (every bucket warmed): NUM_QUERIES requests from
    4 client threads, each answer equal to the direct search's items.
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
    for i, (got_items, _got_scores) in enumerate(answers):
        want = want_items[i][want_items[i] >= 0]
        if not np.array_equal(got_items, want):
            raise AssertionError(f"engine answer {i} differs from the "
                                 f"direct search")
    return serve_s, engine


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

        # nvcc and g++ run side by side
        threads = [threading.Thread(target=timed, args=(
            "frontier_scorer.cu (nvcc)",
            lambda: kernel_build.load("frontier_scorer"))),
            threading.Thread(target=timed, args=(
                "hnsw.cc (g++)", hnsw_build._load_lib))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(times) != 2:
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
        score_frontier.launches = 0
        items_k, scores_k, ns_k = search_k(*args)
        torch.cuda.synchronize()
        search_launches = score_frontier.launches
        if search_launches == 0:
            raise AssertionError("the kernel path launched no kernel")
        items_p, scores_p, _ns_p = search_p(*args)
        walls = alternate_walls(search_k, search_p, args)
        search_ms = float(np.mean(walls["kernel"]))
        plain_search_ms = float(np.mean(walls["plain"]))
        breakdown = device_breakdown(lambda: search_k(*args))
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
        t0 = time.perf_counter()
        top_idx, _ = brute_force_topk(params, state, mcfg, users,
                                      index.item_embs, k=k_final)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        oracle_ids = index.item_ids[top_idx.long()].cpu().numpy()
        recall = float(np.mean([calc_pr(o, g[g >= 0])[1]
                                for o, g in zip(oracle_ids, items_k)]))
        print(f"   graph recall@{k_final} vs brute-force oracle: {recall:.4f} "
              f"(oracle {oracle_s * 1e3:.1f} ms through the kernel)")

    with phase("6 engine"):
        score_frontier.launches = 0
        serve_s, engine = serve(mcfg, params, state, index, users_np, items_k)
        engine_launches = score_frontier.launches
        print(f"   engine: {NUM_QUERIES} requests answered in "
              f"{serve_s * 1e3:.1f} ms, all equal to the direct search; "
              f"{engine_launches} kernel launches (warmup included)")
        for line in engine.metrics.report_lines():
            print("  ", line)
        if engine_launches == 0:
            raise AssertionError("the engine launched no kernel")

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
        breakdown8 = device_breakdown(lambda: search_k8(*args8))
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
                                  items_8)
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

    def entry(name, replaces, launches, per_search, main, all_cases):
        return {
            "name": name, "route": "cuda",
            "source": "nann_tpu_torch/csrc/frontier_scorer.cu",
            "replaces": replaces, "launches": launches,
            "launches_per_search": per_search,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": f"ids [{main['B']}, {main['F']}] {main['dtype']} "
                     f"L={main['L']}, {main['table']}",
            "card": card, "cases": all_cases}

    def main_case(of):
        return next(c for c in of if c["dtype"] == "bfloat16"
                    and (c["B"], c["F"], c["L"]) == MAIN_SHAPE)

    kernels = {"kernels": [
        entry("frontier_scorer", "nann_tpu/experimental/pallas_scorer.py:47",
              engine_launches, search_launches, main_case(cases), cases),
        entry("frontier_scorer_int8",
              "nann_tpu/experimental/pallas_scorer.py:84", engine_launches_8,
              search_launches_8, main_case(int8_cases), int8_cases)]}
    with phase("8 kernels"):
        print(json.dumps(kernels), flush=True)
    print(f"   total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
