#!/usr/bin/env python3
"""Time the element gather and scatter kernels on one CUDA card, at the
search's shapes and in the search's id orders as well as in random order.

    python3 scripts/bench_visited.py [--root DIR] [--calls N] [--only TEXT]

Imports `nann_tpu_torch` from DIR (by default the checkout this script lives
in), so that two checkouts can be timed on one card in turns (parent, change,
change, parent), each in its own process. For every case `gather_elems` or
`scatter_set` runs on the same inputs as its plain version and must give the
same bits (a scatter on two copies of the table); then the kernel and one
PyTorch call that computes the same function (`torch.gather`, `torch.take`,
`scatter_`, `index_fill_`; int64 indices made before the timing) are timed
by device time per call (torch.profiler, every device kernel of N calls,
by default 20) and by CUDA events around N back-to-back calls (host work
included). The bound is the bytes the case must move over 3.35 TB/s: the ids
read once, each distinct element the case reads or writes once, the output
written once. `--only` keeps the cases whose label holds TEXT.

The cases (`visited_cases`, also chip_smoke.py's phase 3): the TPU probes'
shapes (scripts/probe_kernel_ops.py:169-172); the byte-map's [64, 125,600]
uint8 map (100,000 items and 400 x 64 trash slots) with the 25,600 ids of a
ground hop's expansion (400 candidates x 64 neighbours, uniform over the
items, 5% of the candidates invalid), in random order and in the search's:
sorted by the row sort with the invalid ones at n (`vis_unvisited`), the
`_pad_trash` of the sorted ids where 4,096 of them are marked (`vis_mark`),
the expansion's neighbour-row order (the wide hop's `vis_unvisited`), the
`_pad_trash` of the wide hop's 8,192 selected ids in score order (its
`vis_mark`); the lane gathers behind the top-ks (int32 rows, and float32
rows as their bits, hi = W - 1), whose search order is a top-k's: distinct
positions in random order; and
each side of every boundary of `_visited_plan`, rows whose bases are not 16
bytes apart included.

Prints one line per case with the plan the library picked (where the
checkout has `library_plan`) and, last, one JSON object with every case and
the card's name and power limit from nvidia-smi. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable, List, NamedTuple, Optional

import torch

N_ITEMS = 100_000
BATCH = 64
DEGREE = 64                  # 2 x HNSW M = 32
CANDIDATES = 400             # the ground level's top-k
TRASH = CANDIDATES * DEGREE  # SearchConfig: max(top_k_per_level) x 2 x M
INVALID = 0.05               # share of candidates that are invalid (-> n)
MARKS = 4096                 # marks of a filtered hop (its frontier cap)
WIDE_SELECT = 8192           # the wide hop's selection, 2 x frontier cap
PROBE_ITEMS, PROBE_IDS = 200_064, 12_800
PEAK_BYTES = 3.35e12


class Case(NamedTuple):
    """One call: gather_elems(table, ids, hi=arg) (op "gather") or
    scatter_set(table, ids, value=arg) (op "scatter"); `order` is "random",
    "search" or "boundary"; `nbytes` the bound's bytes."""
    op: str
    label: str
    order: str
    table: torch.Tensor
    ids: torch.Tensor
    arg: int
    nbytes: int


def _bytes(op: str, table: torch.Tensor, ids: torch.Tensor, arg: int) -> int:
    """The ids read once, each distinct element read (gather, clipped) or
    written (scatter, in the row) once, the output (gather) written once."""
    row = table.shape[-1]
    idx = ids.long().reshape(ids.shape[0] if table.dim() == 2 else 1, -1)
    if op == "gather":
        idx = idx.clamp(0, arg)
    else:
        idx = torch.where((idx >= 0) & (idx < row), idx, -1)
    flat = idx + row * torch.arange(idx.shape[0], device=idx.device)[:, None]
    flat = flat[idx >= 0]
    elems = torch.unique(flat).numel()
    out = ids.numel() * table.element_size() if op == "gather" else 0
    return ids.numel() * 4 + elems * table.element_size() + out


def _case(op, label, order, table, ids, arg) -> Case:
    ids = ids.int().contiguous()
    return Case(op, label, order, table, ids, arg, _bytes(op, table, ids, arg))


def _uniform(shape, hi, gen):
    return torch.randint(0, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _distinct(rows, width, k, gen):
    """k distinct positions of [0, width) a row, in random order: a top-k's
    indices."""
    keys = torch.rand((rows, width), generator=gen, device=gen.device)
    return keys.argsort(dim=1)[:, :k].int()


def pad_trash(ids, keep, n):
    """beam._pad_trash: kept ids as they are, the others to n + position."""
    pos = torch.arange(ids.shape[-1], dtype=ids.dtype, device=ids.device)
    return torch.where(keep, ids, n + pos)


def expansion(gen, n=N_ITEMS, rows=BATCH):
    """A ground hop's expansion [rows, 400 x 64] in neighbour-row order:
    uniform neighbour ids, the rows of invalid candidates set to n."""
    nb = _uniform((rows, CANDIDATES, DEGREE), n, gen)
    invalid = torch.rand((rows, CANDIDATES, 1), generator=gen,
                         device=gen.device) < INVALID
    return torch.where(invalid, n, nb).reshape(rows, -1)


def _first(sorted_ids):
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    return first


def visited_cases(dev: torch.device, seed: int = 0,
                  boundaries: bool = True) -> List[Case]:
    """Every case, its inputs made on `dev` from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, B = N_ITEMS, BATCH
    cases = []
    # the TPU probes' shapes, from the probe's numpy seed
    import numpy as np
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.integers(0, 250, PROBE_ITEMS).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, PROBE_ITEMS, PROBE_IDS).astype(
        np.int32)).to(dev)
    idx2d = idx.view(-1, 128)
    cases += [
        _case("gather", "probe build_gather_flat: int32 [200064] x [12800]",
              "random", tab, idx, PROBE_ITEMS - 1),
        _case("gather", "probe build_gather_2d: int32 [1563, 128] x [100, 128]",
              "random", tab, idx2d, PROBE_ITEMS - 1),
        _case("gather", "probe build_take_along: int32 [100, 128] x [100, 128]",
              "random", tab.view(-1, 128)[:100].contiguous(), idx2d % 128,
              127),
        _case("scatter", "probe build_scatter: int32 [200064] x [12800] := 7",
              "random", tab.clone(), idx, 7)]

    # the byte-map [B, n + trash] and a ground hop's expansion
    row = n + TRASH
    vis = torch.randint(0, 3, (B, row), generator=gen, device=dev,
                        dtype=torch.uint8)
    nb = expansion(gen)
    nb_sorted = nb.sort(dim=1).values
    shape = f"uint8 [{B}, {row}] x [{B}, {TRASH}]"
    cases += [
        _case("gather", f"vis_unvisited: {shape}", "random", vis,
              _uniform((B, TRASH), n + 1, gen), n),
        _case("gather", f"vis_unvisited, sorted expansion: {shape}", "search",
              vis, nb_sorted, n),
        _case("gather", f"vis_unvisited, wide hop (neighbour rows): {shape}",
              "search", vis, nb, n)]
    # marks: 4,096 of the first occurrences of real ids, the rest to trash
    first = _first(nb_sorted) & (nb_sorted < n)
    rank = torch.where(first, torch.rand(nb_sorted.shape, generator=gen,
                                         device=dev), 2.0)
    picked = torch.zeros_like(first).scatter_(
        1, rank.argsort(dim=1)[:, :MARKS], True) & first
    sel = _uniform((B, WIDE_SELECT), n, gen)
    sel_first = torch.zeros_like(sel, dtype=torch.bool).scatter_(
        1, sel.sort(dim=1, stable=True).indices,
        _first(sel.sort(dim=1, stable=True).values))
    cand = _uniform((B, CANDIDATES), n, gen)
    cases += [
        _case("scatter", f"vis_mark: {shape} := 0", "random", vis.clone(),
              _distinct(B, row, TRASH, gen), 0),
        _case("scatter", f"vis_mark, sorted with {MARKS} marks: {shape} := 0",
              "search", vis.clone(), pad_trash(nb_sorted, picked, n), 0),
        _case("scatter", f"vis_mark, wide hop (score order): uint8 [{B}, "
              f"{row}] x [{B}, {WIDE_SELECT}] := 0", "search", vis.clone(),
              pad_trash(sel, sel_first, n), 0),
        _case("scatter", f"vis_reset_mark, level entry: uint8 [{B}, {row}] x "
              f"[{B}, {CANDIDATES}] := 0", "search", vis.clone(),
              pad_trash(cand, torch.ones_like(cand, dtype=torch.bool), n), 0)]

    # the lane gathers: int32 rows, hi = W - 1
    for label, W, K in (("_masked_topk ids", 4496, 400),
                        ("approx keys", 33992, 4096),
                        ("wide neighbours", 25600, 8192)):
        table = torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen,
                              device=dev, dtype=torch.int32)
        shape = f"int32 [{B}, {W}] x [{B}, {K}]"
        floats = torch.randn((B, W), generator=gen, device=dev)
        cases += [
            _case("gather", f"lane gather, {label}: {shape}", "random", table,
                  _uniform((B, K), W, gen), W - 1),
            _case("gather", f"lane gather, {label}, float32 bits: {shape}",
                  "random", floats.view(torch.int32), _uniform((B, K), W, gen),
                  W - 1),
            _case("gather", f"lane gather, {label} (top-k order): {shape}",
                  "search", table, _distinct(B, W, K, gen), W - 1)]
    if boundaries:
        cases += boundary_cases(dev, gen)
    return cases


def plan_bounds(vo, sms: int = 132) -> list:
    """(label, rows, M, span, staged): int32 gathers on each side of every
    bound of the staged path (`_visited_plan` on `sms` SMs, its constants
    read from `vo`, the checkout's kernels/visited_ops.py): the cost ratio,
    rows, the least ids of a launch, one row an SM, shared memory; odd
    widths and odd ids a row, so that rows of the table and of the ids start
    off 16 bytes. `staged` says which side."""
    cost = getattr(vo, "STAGE_COST", 12)
    least = getattr(vo, "STAGE_MIN_IDS", 1 << 18)
    fill = (getattr(vo, "BLOCK_SMEM", 232_448) -
            getattr(vo, "BARRIER_BYTES", 16) - 32 - 4 * 12_000) // 4

    def at(B, M):       # the widest span of the cost bound
        return B * M // cost - M

    rows = least // 4096                      # rows x 4096 ids = least
    few = least // 128                        # ids a row of 128 rows
    return [("at the cost bound", rows, 4096, at(rows, 4096), True),
            ("span one over the cost bound", rows, 4096,
             at(rows, 4096) + 1, False),
            ("one row fewer", rows - 1, 4096, at(rows, 4096), False),
            ("the least ids", 128, few, at(128, few) // 2, True),
            ("one id fewer than the least", 128, few - 1, at(128, few) // 2,
             False),
            ("a row an SM", sms, 4096, at(sms, 4096) // 2, True),
            ("one row more than SMs", sms + 1, 4096, at(sms, 4096) // 2,
             False),
            ("span and ids filling shared memory", sms, 12_000, fill, True),
            ("span one 16-byte unit over", sms, 12_000, fill + 4, False),
            ("odd ids a row", rows, 4097, at(rows, 4097) // 2 + 1, True)]


def boundary_cases(dev: torch.device, gen: torch.Generator) -> List[Case]:
    """Each side of every bound of the plan (`plan_bounds`), for both ops
    and both types (only an int32 gather may be staged); a table shared by
    the batch; ids below 0 and past the row; repeats."""
    from nann_tpu_torch.kernels import visited_ops as vo
    cases = []

    def ids_for(rows, M, hi):
        return torch.randint(-9, hi + 9, (rows, M), generator=gen, device=dev,
                             dtype=torch.int32)

    for dtype in (torch.int32, torch.uint8):
        kind = str(dtype).replace("torch.", "")
        for label, rows, M, span, _staged in plan_bounds(vo):
            W = span + 7            # odd: rows start off 16 bytes
            table = torch.randint(0, 100, (rows, W), generator=gen,
                                  device=dev, dtype=torch.int32).to(dtype)
            cases += [
                _case("gather", f"{label}: {kind} [{rows}, {W}] x [{rows}, "
                      f"{M}], hi {span - 1}", "boundary", table,
                      ids_for(rows, M, W), span - 1),
                _case("scatter", f"{label}: {kind} [{rows}, {span}] x "
                      f"[{rows}, {M}]", "boundary",
                      table[:, :span].contiguous(), ids_for(rows, M, span),
                      5)]
        # one row shared by the batch (never staged), odd sizes
        table = torch.randint(0, 100, (5003,), generator=gen, device=dev,
                              dtype=torch.int32).to(dtype)
        cases += [
            _case("gather", f"shared row: {kind} [5003] x [37, 999]",
                  "boundary", table, ids_for(37, 999, 5003), 4990),
            _case("scatter", f"shared row, repeats: {kind} [5003] x "
                  f"[37, 999]", "boundary", table.clone(),
                  ids_for(37, 999, 5003), 3)]
    return cases


# ------------------------------------------------------------------ timing


def cuda_ms(fn: Callable, calls: int) -> float:
    """Milliseconds per call of fn(), CUDA events around `calls` calls after
    two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn: Callable, calls: int) -> Optional[float]:
    """Device milliseconds per call of fn(): every device kernel torch.profiler
    records over `calls` calls (a session that records none is taken once
    more); None where the profiler cannot trace the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / calls
    return None


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def library_call(case: Case) -> Callable:
    """One PyTorch call that computes the case's function, its int64
    indices made here, before any timing."""
    t, ids, arg = case.table, case.ids, case.arg
    row = t.shape[-1]
    if case.op == "gather":
        idx = ids.long().clamp(0, arg)
        if t.dim() == 1:
            return lambda: torch.take(t, idx)
        return lambda: torch.gather(t, 1, idx)
    idx = ids.long()
    if t.dim() == 2 and bool(((idx >= 0) & (idx < row)).all()):
        return lambda: t.scatter_(1, idx, arg)
    ok = (idx >= 0) & (idx < row)
    if t.dim() == 2:
        idx = idx + row * torch.arange(t.shape[0], device=t.device)[:, None]
    flat = idx[ok]
    view = t.view(-1)
    return lambda: view.index_fill_(0, flat, arg)


def run_case(vo, case: Case, calls: int) -> dict:
    """Hold the kernel against its plain version bit for bit, then time the
    kernel and the library call."""
    if case.op == "gather":
        def kernel():
            return vo.gather_elems(case.table, case.ids, case.arg)
        got = kernel()
        want = vo.gather_elems_plain(case.table, case.ids, case.arg)
    else:
        def kernel():
            return vo.scatter_set(case.table, case.ids, case.arg)
        got = vo.scatter_set(case.table.clone(), case.ids, case.arg)
        want = vo.scatter_set_plain(case.table.clone(), case.ids, case.arg)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError(f"{case.op} {case.label}: the kernel differs "
                             f"from its plain version")
    library = library_call(case)
    plan = None
    if hasattr(vo, "library_plan"):
        p, blocks = vo.library_plan(case.op, case.table, case.ids, case.arg)
        plan = {"path": p.path, "grid": list(p.grid), "threads": p.threads,
                "smem_bytes": p.smem_bytes, "blocks_per_sm": blocks}
    return {"op": case.op, "label": case.label, "order": case.order,
            "plan": plan, "device_ms": device_ms(kernel, calls),
            "ms": cuda_ms(kernel, calls),
            "library_device_ms": device_ms(library, calls),
            "library_ms": cuda_ms(library, calls),
            "bound_ms": case.nbytes / PEAK_BYTES * 1e3, "bytes": case.nbytes}


def _fmt(t: Optional[float]) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--calls", type=int, default=20,
                    help="calls a timing (default 20)")
    ap.add_argument("--only", help="keep the cases whose label holds this")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from nann_tpu_torch.kernels import visited_ops as vo

    if not torch.cuda.is_available():
        print("bench_visited: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi gave no output"
    print(f"{card}; port from {os.path.abspath(args.root)}", flush=True)
    results = []
    for case in visited_cases(dev):
        if args.only and args.only not in case.label:
            continue
        r = run_case(vo, case, args.calls)
        results.append(r)
        p = r["plan"]
        where = "plan not exported" if p is None else (
            f"{p['path']} grid {p['grid']} smem "
            f"{p['smem_bytes']} ({p['blocks_per_sm']} an SM)")
        print(f"{case.op:7s} {case.order:8s} {case.label:70s} bit-exact; "
              f"device {_fmt(r['device_ms'])} ms (events {r['ms']:.4f}), "
              f"library device {_fmt(r['library_device_ms'])} ms, bound "
              f"{r['bound_ms']:.5f} ms; {where}", flush=True)
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
