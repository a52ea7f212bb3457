#!/usr/bin/env python3
"""Time the frontier-scorer kernel on one CUDA card against its plain version.

    python3 scripts/bench_scorer.py [--root DIR] [--cases NAME ...] [--ref]

Imports `nann_tpu_torch` from DIR (by default the checkout this script lives
in), so that two checkouts can be timed on one card in turns (parent, change,
change, parent), each in its own process. The inputs are those of
chip_smoke.py's phase 3 at the serving width (bench.py's model, random weights
and 100,000 random items from seed 0): for each case the kernel and the plain
version run on the same inputs, the error is held to the tolerance
(bfloat16 0.05 x (1 + |ref|), float32 2e-4 x (1 + |ref|)), and both are timed
with CUDA events over 10 calls after 2 warm-up calls. The masks are "random"
(about 10% of the rows invalid, scattered) and "prefix" (the first 1,516 rows
of each query valid, the rest padding, as the search's level-1 hop fills its
2,880 slots). `--ref` adds a [64, 8192] frontier into a 4,200,000-row packed
int8 table with fresh ids on every call.

Prints one line per case and, last, one JSON object with every case and the
card's name and power limit from nvidia-smi. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# (name, compute type, table, B, F, L, mask)
CASES = [
    ("bf16 rows random", "bfloat16", "rows", 64, 4096, 50, "random"),
    ("bf16 rows level-1 prefix", "bfloat16", "rows", 64, 2880, 50, "prefix"),
    ("bf16 rows level-1 random", "bfloat16", "rows", 64, 2880, 50, "random"),
    ("bf16 rows ground prefix", "bfloat16", "rows", 64, 4096, 50, "prefix"),
    ("bf16 int8 random", "bfloat16", "int8", 64, 4096, 50, "random"),
    ("bf16 int8 level-1 prefix", "bfloat16", "int8", 64, 2880, 50, "prefix"),
    ("fp32 rows random", "float32", "rows", 64, 4096, 50, "random"),
    ("fp32 rows level-1 prefix", "float32", "rows", 64, 2880, 50, "prefix"),
    ("fp32 int8 random", "float32", "int8", 64, 4096, 50, "random"),
    ("bf16 rows enter points", "bfloat16", "rows", 64, 90, 50, "random"),
    ("bf16 rows L=7", "bfloat16", "rows", 16, 4096, 7, "random"),
]
REF_CASE = ("bf16 int8 4.2M", "bfloat16", "int8 4.2M", 64, 8192, 50, "random")
LEVEL1_FILL = 1516
NUM_ITEMS, REF_ITEMS = 100_000, 4_200_000
TOL = {"float32": 2e-4, "bfloat16": 0.05}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--cases", nargs="*", help="case names to run (all)")
    ap.add_argument("--ref", action="store_true",
                    help="also the 4.2M-row packed int8 case")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from nann_tpu_torch.config import ModelConfig
    from nann_tpu_torch.index.quantize import pack_quantized
    from nann_tpu_torch.kernels.frontier_scorer import (
        frontier_scorer_plain, kernel_weights, score_frontier)
    from nann_tpu_torch.models import init_scorer
    from nann_tpu_torch.ops import fold_scorer, precompute_user

    if not torch.cuda.is_available():
        print("bench_scorer: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi gave no output"
    print(card, flush=True)
    mcfg = ModelConfig(emb_dim=32, max_seq_length=50,
                       compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params, state = init_scorer(mcfg, gen, device=dev)
    folded = fold_scorer(params, state, mcfg)
    items = np.random.default_rng(0).standard_normal(
        (NUM_ITEMS, mcfg.item_emb_dim)).astype(np.float32)
    tables = {"rows": torch.from_numpy(items).to(dev),
              "int8": pack_quantized(items).to(dev)}

    def timed(fn, calls):
        for _ in range(2):
            fn(next(calls))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fn(next(calls))
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    cases = CASES + ([REF_CASE] if args.ref else [])
    results = []
    for name, dts, kind, B, F, L, mask in cases:
        if args.cases and name not in args.cases:
            continue
        dt = getattr(torch, dts)
        if kind == "int8 4.2M":
            g = torch.Generator(device=dev).manual_seed(1)
            q = torch.randint(-127, 128, (REF_ITEMS, mcfg.item_emb_dim),
                              generator=g, device=dev, dtype=torch.int8)
            s = torch.rand((REF_ITEMS,), generator=g, device=dev) * 0.02 + 1e-3
            table = torch.cat([q, s.view(torch.int8).view(-1, 4)], dim=1)
        else:
            table = tables[kind]
            table = table if kind == "int8" else table.to(dt).contiguous()
        n = table.shape[0]
        weights = kernel_weights(folded, dt)
        user = torch.randn((B, L, mcfg.user_emb_dim), generator=gen).to(dev)
        k_proj, v = precompute_user(folded, user, dt)
        if mask == "prefix":
            valid = (torch.arange(F) < LEVEL1_FILL).expand(B, F)
        else:
            valid = torch.rand((B, F), generator=gen) > 0.1
        valid = valid.contiguous().to(dev)
        id_sets = [torch.randint(0, n, (B, F), generator=gen,
                                 dtype=torch.int32).to(dev)
                   for _ in range(12 if kind == "int8 4.2M" else 1)]
        ids = id_sets[0]
        got = score_frontier(weights, k_proj, v, table, ids, valid)
        want = frontier_scorer_plain(weights, k_proj, v, table, ids, valid)
        torch.cuda.synchronize()
        if not (torch.isneginf(got[~valid]).all()
                and torch.isfinite(got[valid]).all()):
            raise AssertionError(f"{name}: -inf / finite rows wrong")
        rel = ((got - want)[valid].abs()
               / (1 + want[valid].abs())).max().item()

        def calls():
            while True:
                yield from id_sets

        ms = timed(lambda i: score_frontier(weights, k_proj, v, table, i,
                                            valid), calls())
        plain_ms = timed(lambda i: frontier_scorer_plain(
            weights, k_proj, v, table, i, valid), calls())
        case = {"case": name, "dtype": dts, "table": kind, "B": B, "F": F,
                "L": L, "mask": mask, "valid_rows": int(valid.sum()),
                "max_rel_err": rel, "tol": TOL[dts], "ms": ms,
                "plain_ms": plain_ms}
        results.append(case)
        print(f"   {name:26s} ids [{B}, {F}] L={L}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, max|d|/(1+|ref|) {rel:.3e} "
              f"(tol {TOL[dts]})", flush=True)
        if rel > TOL[dts]:
            raise AssertionError(f"{name}: {rel} > {TOL[dts]}")
        del table
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
