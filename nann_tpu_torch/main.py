"""The jobs of nann_tpu_torch: the CLI of nann_tpu/main.py on PyTorch.

Jobs:
  train              adversarial training with checkpointing and auto-resume
  extract_feature    item tower over the catalogue -> item_ids.npy, item_embs.npy
  build_index        HNSW over item_embs -> the npy artifact contract
  test               HNSW + model retrieval eval: P/R/F1@topk against the
                     ground truth, rows scored per hop
  test_all           brute-force oracle eval (the recall ceiling)
  select_checkpoint  evaluate the retained checkpoints, write the winner to
                     model/selected_step.json (oracle or graph recall)
  export             the serving bundle
  serve              REST (and gRPC) serving of the bundle, with hot reload
  serve_bench        load-test the serving engine
  verify_export      contract checks of the bundle, and its cross-check
                     against the live checkpoint
  parity             graph recall against the oracle's -> parity_result.json
  build_tree         the TDM-style tree index over the item embeddings
  test_tree          tree retrieval eval
  all                train, select_checkpoint, extract_feature, build_index,
                     test_all, test, export, verify_export

Every job runs on the card unless --device cpu is given. `--dp N` trains on
N ranks (make_mesh(dp=N, mp=1)): under torchrun with WORLD_SIZE == N the job
joins that world, otherwise it starts ranks 1..N-1 itself and is rank 0;
NCCL when every rank has a card of its own, gloo otherwise (on one shared
card, and for --device cpu). Rank 0 alone returns the result and runs the
later jobs of `all`. Checkpoints are the
port's own (model/step_N/train_state.pt); the other files (embeddings, index,
export bundle, tree, selected_step.json, parity_result.json) are the JAX
package's, so either package reads what the other wrote.

Examples:
  python -m nann_tpu_torch.main --job-type all --synthetic --num-item 5000
  python -m nann_tpu_torch.main --job-type train --dataset-dir data/ --output-root out/
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import os
import signal
import socket
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import ModelConfig, SearchConfig, TrainConfig, default_frontier_cap
from .data import synthetic_dataset
from .data.user_behavior import PackedUB
from .delivery import (export_model, extract_item_embeddings,
                       extract_user_embeddings, load_serving_bundle,
                       verify_export)
from .delivery.graph_select import gt_covering_subset, subset_graph_recall
from .index import (build_and_save_index, build_tree, load_index, load_tree,
                    save_tree)
from .search import (DeviceTree, SearchIndex, brute_force_topk,
                     level_topn_default, make_searcher, make_tree_searcher)
from .search.autotune import autotune_hop_caps
from .serving import (Engine, EngineConfig, LoadGenConfig, ModelReloader,
                      NannServer, run_load_test)
from .train.dataclasses_io import restore_train_state
from .train.loop import checkpoint_steps, latest_checkpoint_step, train_loop
from .train.step import create_train_state
from .utils import (AverageMeter, calc_pr, get_logger, resolve_device,
                    torch_dtype)

logger = get_logger("nann_tpu_torch.main")


def build_parser() -> argparse.ArgumentParser:
    """nann_tpu/main.py's options, name for name, with their defaults, types,
    nargs and choices, and `--device`."""
    p = argparse.ArgumentParser(
        "nann_tpu_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--job-type", default="train",
                   choices=["train", "extract_feature", "build_index", "test",
                            "test_all", "select_checkpoint", "export",
                            "serve", "serve_bench", "verify_export",
                            "parity", "build_tree", "test_tree", "all"])
    p.add_argument("--tree-branch", type=int, default=16,
                   help="k-ary branch factor of the tree index")
    p.add_argument("--tree-beam", type=int, default=200,
                   help="beam width of the tree search")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--grpc-port", type=int, default=8500,
                   help="TF-Serving-compatible gRPC Predict port of "
                        "--job-type serve (-1 disables it)")
    p.add_argument("--output-root", default="./output")
    p.add_argument("--index-dir", default=None,
                   help="override <output-root>/index (index variants built "
                        "with other graph knobs over one checkpoint)")
    p.add_argument("--dataset-dir", default="./data")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset generator instead of a "
                        "converted UserBehavior corpus")
    # model / train
    p.add_argument("--batch-size", type=int, default=800)
    p.add_argument("--train-epochs", type=int, default=5)
    p.add_argument("--emb-dim", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="cosine decays to lr * lr-final-ratio over "
                        "--max-steps (or --lr-total-steps)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-total-steps", type=int, default=0,
                   help="pin the cosine decay horizon independently of "
                        "--max-steps (0 = track max-steps); set it when a "
                        "resumed run passes another step budget, so that "
                        "the schedule stays the one the run started with")
    p.add_argument("--lr-final-ratio", type=float, default=0.01)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--adv-eps", type=float, default=3e-5)
    p.add_argument("--adv-weight", type=float, default=1.0)
    p.add_argument("--num-neg", type=int, default=200)
    p.add_argument("--save-freq", type=int, default=5000)
    p.add_argument("--print-freq", type=int, default=50)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel shards: train on a world of this many "
                        "ranks (torchrun's, or started here)")
    # synthetic scale
    p.add_argument("--num-item", type=int, default=5000)
    p.add_argument("--num-cate", type=int, default=50)
    p.add_argument("--num-users", type=int, default=500)
    p.add_argument("--max-seq-length", type=int, default=20)
    # search
    p.add_argument("--hnsw-start-level", type=int, default=2)
    p.add_argument("--num-scoring-per-level", type=int, nargs="+",
                   default=[3, 1, 1])
    p.add_argument("--top-k-per-level", type=int, nargs="+",
                   default=[400, 200, 100])
    p.add_argument("--topk-eval", type=int, nargs="+", default=[200])
    p.add_argument("--num-test-batch", type=int, default=10000)
    p.add_argument("--select-steps", type=int, nargs="+", default=None,
                   help="checkpoint steps select_checkpoint evaluates "
                        "(default: every retained checkpoint)")
    p.add_argument("--select-metric", choices=["oracle", "graph"],
                   default="oracle",
                   help="select_checkpoint's criterion: oracle = the "
                        "brute-force ceiling; graph = end-to-end graph "
                        "recall on a small gt-covering subset index built "
                        "per checkpoint, the shipping metric")
    p.add_argument("--select-subset", type=int, default=200_000,
                   help="subset catalogue size for --select-metric graph")
    p.add_argument("--frontier-cap", type=int, default=None,
                   help="static per-hop frontier capacity; default is "
                        "catalogue-aware (config.default_frontier_cap: 4096 "
                        "up to 2M items, 8192 beyond)")
    p.add_argument("--frontier-cap-per-hop", type=int, nargs="+",
                   default=None,
                   help="per-expansion-hop frontier capacities (one per hop "
                        "in search order; see SearchConfig)")
    p.add_argument("--hnsw-num-neighbors", type=int, default=32)
    p.add_argument("--ef-construction", type=int, default=200)
    p.add_argument("--search-batch", type=int, default=16)
    p.add_argument("--autotune-caps", action="store_true",
                   help="export: probe per-hop scored maxima on held-out "
                        "users and write tuned frontier_cap_per_hop into the "
                        "bundle signature (search/autotune.py)")
    p.add_argument("--batch-buckets", type=int, nargs="+", default=None,
                   help="engine batch-bucket ladder for serve/serve_bench "
                        "(default: EngineConfig's 1 4 16 64 128)")
    p.add_argument("--calibration-file", default=None,
                   help="keep and reuse the engine's per-bucket calibration "
                        "(default: <output-root>/calibration.json); with a "
                        "matching file, serve starts without measuring")
    p.add_argument("--search-semantics", default="eval",
                   choices=["serving", "eval"],
                   help="eval (default) = the reference test-job algorithm "
                        "(threshold candidates); serving = the reference's "
                        "exported-graph loop")
    p.add_argument("--vis-impl", default="list",
                   choices=["list", "bytemap"],
                   help="visited-set representation (list = sort-merged id "
                        "list; bytemap = epoch-stamped byte-map)")
    p.add_argument("--mark-policy", default="scored",
                   choices=["all", "scored"],
                   help="scored (default) = mark only scored nodes, so that "
                        "truncated ones stay reachable; all = the reference "
                        "op's semantics, truncated unscored nodes included")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 scorer compute")
    p.add_argument("--device", default="cuda",
                   help="torch device of every job; 'cpu' runs the kernels' "
                        "plain versions where there is no card")
    return p


def parse_opt(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build_configs(args) -> Tuple[ModelConfig, TrainConfig, SearchConfig]:
    meta_path = os.path.join(args.dataset_dir, "ub_meta.json")
    if not args.synthetic and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        num_item, num_cate = meta["num_item"], meta["num_cate"]
        max_len = meta["max_length"]
    else:
        num_item, num_cate, max_len = (args.num_item, args.num_cate,
                                       args.max_seq_length)
    mcfg = ModelConfig(
        num_item=num_item, num_cate=num_cate, emb_dim=args.emb_dim,
        max_seq_length=max_len,
        item_tower_dims=(2 * args.emb_dim,) * 3,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    tcfg = TrainConfig(
        batch_size=args.batch_size, train_epochs=args.train_epochs,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        lr_final_ratio=args.lr_final_ratio,
        lr_total_steps=args.lr_total_steps,
        adv_eps=args.adv_eps, adv_weight=args.adv_weight,
        num_neg=min(args.num_neg, max(num_item // args.batch_size, 1)),
        save_freq=args.save_freq, print_freq=args.print_freq, dp=args.dp)
    k = args.hnsw_start_level
    scfg = SearchConfig(
        hnsw_start_level=k,
        num_scoring_per_level=tuple(args.num_scoring_per_level),
        top_k_per_level=tuple(min(t, num_item) for t in args.top_k_per_level),
        topk_eval=tuple(min(t, num_item) for t in args.topk_eval),
        frontier_cap=args.frontier_cap or default_frontier_cap(num_item),
        frontier_cap_per_hop=tuple(args.frontier_cap_per_hop)
        if args.frontier_cap_per_hop else None,
        semantics=args.search_semantics,
        vis_impl=args.vis_impl, mark_policy=args.mark_policy)
    return mcfg, tcfg, scfg


def load_dataset(args) -> Tuple[Dict, Dict, Dict]:
    """Returns (train, test, item_features) dict-of-arrays."""
    if args.synthetic:
        # the generated corpus is cached per config, so that a workflow of
        # several jobs does not generate it for every job
        key = (f"synth_{args.num_item}_{args.num_cate}_{args.num_users}_"
               f"{args.max_seq_length}")
        cache = os.path.join(args.output_root, f"{key}.npz")
        if os.path.exists(cache):
            z = np.load(cache)
            unpack = lambda pre: {k[len(pre):]: z[k] for k in z.files  # noqa: E731
                                  if k.startswith(pre)}
            return unpack("train_"), unpack("test_"), unpack("feat_")
        train, test, feats = synthetic_dataset(
            num_item=args.num_item, num_cate=args.num_cate,
            num_users=args.num_users, max_seq_length=args.max_seq_length,
            seed=0)
        os.makedirs(args.output_root, exist_ok=True)
        np.savez(cache,
                 **{f"train_{k}": v for k, v in train.items()},
                 **{f"test_{k}": v for k, v in test.items()},
                 **{f"feat_{k}": v for k, v in feats.items()})
        return train, test, feats

    def load_npz(name):
        return dict(np.load(os.path.join(args.dataset_dir, name)))
    if os.path.exists(os.path.join(args.dataset_dir, "ub_train_packed.npz")):
        # the packed train split: prefixes materialised lazily per batch
        train = PackedUB(args.dataset_dir)
    else:
        train = load_npz("ub_train.npz")
    return train, load_npz("ub_test.npz"), load_npz("ub_items.npz")


class Paths:
    def __init__(self, root):
        def mk(p):
            os.makedirs(p, exist_ok=True)
            return p
        self.model_save_dir = mk(os.path.join(root, "model"))
        emb = mk(os.path.join(root, "embeddings"))
        self.item_ids_file = os.path.join(emb, "item_ids.npy")
        self.item_embs_file = os.path.join(emb, "item_embs.npy")
        self.index_dir = mk(os.path.join(root, "index"))
        self.export_dir = mk(os.path.join(root, "export"))


def _selected_step(paths) -> Optional[int]:
    """The checkpoint select_checkpoint picked (model/selected_step.json),
    or None if selection never ran."""
    sel = os.path.join(paths.model_save_dir, "selected_step.json")
    if os.path.exists(sel):
        with open(sel) as f:
            return int(json.load(f)["step"])
    return None


def _restore(mcfg, tcfg, paths, step: Optional[int] = None,
             prefer_selected: bool = True, device="cuda"):
    """Restore a checkpoint onto `device`: explicit `step` > the
    select_checkpoint winner > the latest; a fresh init without one."""
    # a restore-only skeleton: no optimizer step runs, and the optimizer's
    # state does not depend on the schedule, so a constant-lr skeleton
    # restores checkpoints trained under any schedule
    skel_tcfg = dataclasses.replace(tcfg, lr_schedule="constant")
    state, _schedule = create_train_state(mcfg, skel_tcfg, device=device)
    how = "requested"
    if step is None and prefer_selected:
        step = _selected_step(paths)
        how = "selected"
    if step is None:
        step = latest_checkpoint_step(paths.model_save_dir)
        how = "latest"
    if step is not None:
        logger.info(f"restoring {how} checkpoint step_{step}")
        state = restore_train_state(
            os.path.join(paths.model_save_dir, f"step_{step}"), state)
    else:
        logger.info("no checkpoint found; using fresh init")
    return state


def job_train(args, mcfg, tcfg, scfg, paths):
    if tcfg.dp > 1:
        return _train_dp(args, tcfg.dp)
    return _train(args, mcfg, tcfg, paths, args.device)


def _train(args, mcfg, tcfg, paths, device, mesh=None):
    train, _test, feats = load_dataset(args)
    state, metrics = train_loop(
        mcfg, tcfg, train, feats,
        ckpt_dir=paths.model_save_dir,
        num_steps=args.max_steps,
        metrics_path=os.path.join(args.output_root, "train_metrics.jsonl"),
        device=device, mesh=mesh)
    if mesh is None or dist.get_rank() == 0:
        logger.info(f"train done: {metrics}")
    return state


# a rank that waits longer than this for the others in a collective fails
DP_TIMEOUT_S = 600


def _torchrun_rank(dp: int) -> Optional[int]:
    """This process's rank when torchrun started a world of `dp` ranks."""
    if dp > 1 and int(os.environ.get("WORLD_SIZE", "1")) == dp:
        return int(os.environ["RANK"])
    return None


def dp_backend(device: str, world: int) -> str:
    """NCCL when every rank of the world has a card of its own, gloo
    otherwise: ranks sharing one card (NCCL refuses two ranks on a card;
    gloo moves CUDA tensors through host memory) and the CPU."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _train_rank(args, rank: int, world: int, init_method: str,
                local_rank: int):
    """One rank of --dp training: join the world, train on
    make_mesh(dp=world, mp=1), leave it. Returns the state on rank 0."""
    from .parallel import make_mesh
    backend = dp_backend(args.device, world)
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        if rank == 0:
            msg = (f"--dp {world}: {world} ranks, backend "
                   f"{dist.get_backend()}, device {device}")
            print(msg, flush=True)
            logger.info(msg)
        mcfg, tcfg, _scfg = build_configs(args)
        state = _train(args, mcfg, tcfg, Paths(args.output_root), device,
                       mesh=make_mesh(dp=world, mp=1))
    finally:
        dist.destroy_process_group()
    return state if rank == 0 else None


def _train_dp(args, world: int):
    """--dp N training (nann_tpu/main.py:296-304 on a mesh of N devices):
    join torchrun's world of N ranks, or start ranks 1..N-1 and be rank 0.
    A rank that fails fails the job."""
    rank = _torchrun_rank(world)
    if rank is not None:
        return _train_rank(args, rank, world, "env://",
                           int(os.environ.get("LOCAL_RANK", rank)))
    load_dataset(args)   # a synthetic corpus is cached before ranks read it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init_method = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_train_rank,
                         args=(args, r, world, init_method, r))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        state = _train_rank(args, 0, world, init_method, 0)
        for p in procs:
            p.join(timeout=DP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs, 1) if p.exitcode}
    if failed:
        raise RuntimeError(f"--dp {world}: rank(s) failed, exit codes "
                           f"{failed}")
    return state


def job_extract(args, mcfg, tcfg, scfg, paths):
    _train, _test, feats = load_dataset(args)
    state = _restore(mcfg, tcfg, paths, device=args.device)
    item_ids, item_embs = extract_item_embeddings(
        state.params, state.bn_state, mcfg, feats)
    np.save(paths.item_ids_file, item_ids)
    np.save(paths.item_embs_file, item_embs)
    logger.info(f"saved {item_embs.shape} embeddings to {paths.item_embs_file}")


def job_build_index(args, mcfg, tcfg, scfg, paths):
    item_embs = np.load(paths.item_embs_file)
    build_and_save_index(item_embs, scfg.hnsw_start_level,
                         args.hnsw_num_neighbors, paths.index_dir,
                         ef_construction=args.ef_construction)


def _load_search_index(args, mcfg, scfg, paths) -> SearchIndex:
    item_embs = np.load(paths.item_embs_file)
    item_ids = np.load(paths.item_ids_file)
    art = load_index(paths.index_dir, scfg.hnsw_start_level,
                     max_degree=2 * args.hnsw_num_neighbors)
    return SearchIndex.from_artifacts(art, item_embs, item_ids,
                                      dtype=torch_dtype(mcfg.compute_dtype),
                                      device=args.device)


def _padded_users(state, batch, B: int) -> torch.Tensor:
    """The batch's user sequence embeddings, padded with zero rows to B."""
    user = extract_user_embeddings(state.params, batch)
    pad = B - user.shape[0]
    if pad:
        user = np.concatenate([user, np.zeros((pad,) + user.shape[1:],
                                              np.float32)])
    return torch.from_numpy(user)


def job_test(args, mcfg, tcfg, scfg, paths):
    """HNSW + model retrieval eval."""
    _train, test, _feats = load_dataset(args)
    state = _restore(mcfg, tcfg, paths, device=args.device)
    sidx = _load_search_index(args, mcfg, scfg, paths)

    n_users = min(args.num_test_batch, len(test["gt_item_id"]))
    search = make_searcher(mcfg, scfg)
    ltn = level_topn_default(scfg)

    meters = {k: {t: AverageMeter(n, ":.2%") for t in args.topk_eval}
              for k, n in (("prec", "prec"), ("recall", "recall"), ("f1", "f1"))}
    bt = AverageMeter("batch_time", ":.2f", moving_average=True)
    all_scoring = []
    B = args.search_batch
    tic = time.time()
    for start in range(0, n_users, B):
        end = min(start + B, n_users)
        batch = {k: test[k][start:end] for k in test}
        top_items, _scores, num_scoring = search(
            state.params, state.bn_state, sidx,
            _padded_users(state, batch, B), ltn)
        top_items = top_items.cpu().numpy()[:end - start]
        all_scoring.append(num_scoring.cpu().numpy()[:end - start])
        bt.update(time.time() - tic)
        tic = time.time()
        for u in range(end - start):
            got = top_items[u][top_items[u] >= 0]
            for topk in args.topk_eval:
                prec, recall, f1 = calc_pr(batch["gt_item_id"][u], got[:topk])
                meters["prec"][topk].update(prec)
                meters["recall"][topk].update(recall)
                meters["f1"][topk].update(f1)
        if (start // B) % max(args.print_freq // B, 1) == 0:
            t0 = args.topk_eval[0]
            logger.info(f"[{end}/{n_users}] {meters['recall'][t0]} "
                        f"{meters['prec'][t0]} {bt}")
    ns = np.concatenate(all_scoring)
    for topk in args.topk_eval:
        logger.info(f"Test Recall@{topk} {meters['recall'][topk].avg:.2%}, "
                    f"num_scoring {ns.sum(-1).mean():.0f}")
    logger.info(f"num scoring per hop: mean {ns.mean(0)}, max {ns.max(0)}")
    # a hop whose MEAN scored count sits at the cap is truncating real
    # expansion, not padding
    hop_means = ns.mean(0)
    if hop_means.max() >= 0.98 * scfg.frontier_cap:
        logger.warning(
            f"frontier_cap={scfg.frontier_cap} SATURATED: per-hop scored "
            f"means {np.round(hop_means).astype(int).tolist()} — the cap is "
            f"truncating the neighbor expansion and costing recall. "
            f"Raise --frontier-cap (catalogue-aware default: "
            f"{default_frontier_cap(mcfg.num_item)} for "
            f"{mcfg.num_item} items).")
    return {f"recall@{t}": meters["recall"][t].avg for t in args.topk_eval}


def _oracle_recall(args, mcfg, state, item_embs: torch.Tensor,
                   item_ids: np.ndarray, test,
                   quiet: bool = False) -> Dict[str, float]:
    """Brute-force oracle recall over a held-out user slice; item_embs is the
    catalogue's table in the compute type on the device.

    For max(topk_eval) above the n items the oracle's tail holds pad
    indices >= n scored -inf; they are dropped, so the recall is that of
    the catalogue's ids."""
    n_users = min(args.num_test_batch, len(test["gt_item_id"]))
    k = max(args.topk_eval)
    n = item_embs.shape[0]
    meters = {t: AverageMeter("recall", ":.2%") for t in args.topk_eval}
    B = args.search_batch
    for start in range(0, n_users, B):
        end = min(start + B, n_users)
        batch = {key: test[key][start:end] for key in test}
        user = extract_user_embeddings(state.params, batch)
        idx, _ = brute_force_topk(state.params, state.bn_state, mcfg,
                                  torch.from_numpy(user), item_embs, k=k,
                                  chunk_size=8192)
        idx = idx.cpu().numpy()
        for u in range(end - start):
            retrieved = item_ids[idx[u][idx[u] < n]]
            for topk in args.topk_eval:
                _p, recall, _f = calc_pr(batch["gt_item_id"][u],
                                         retrieved[:topk])
                meters[topk].update(recall)
        if not quiet and (start // B) % max(args.print_freq // B, 1) == 0:
            t0 = args.topk_eval[0]
            logger.info(f"[{end}/{n_users}] {meters[t0]}")
    return {f"recall@{t}": meters[t].avg for t in args.topk_eval}


def _oracle_table(args, mcfg, item_embs: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(item_embs, np.float32)).to(
        resolve_device(args.device), torch_dtype(mcfg.compute_dtype))


def job_test_all(args, mcfg, tcfg, scfg, paths):
    """Brute-force oracle eval."""
    _train, test, _feats = load_dataset(args)
    state = _restore(mcfg, tcfg, paths, device=args.device)
    item_embs = _oracle_table(args, mcfg, np.load(paths.item_embs_file))
    item_ids = np.load(paths.item_ids_file)
    res = _oracle_recall(args, mcfg, state, item_embs, item_ids, test)
    for topk in args.topk_eval:
        logger.info(f"Test-all Recall@{topk} {res[f'recall@{topk}']:.2%}")
    return res


def job_select_checkpoint(args, mcfg, tcfg, scfg, paths):
    """Deploy-by-evaluation checkpoint selection.

    Evaluates every retained checkpoint (or --select-steps) on a held-out
    slice, writes the winner to model/selected_step.json, and every
    downstream job (extract_feature, test, test_all, export, parity)
    restores the selected checkpoint. --select-metric oracle takes the
    brute-force ceiling (the reference's test_all-then-deploy flow); graph
    takes end-to-end recall through a per-checkpoint subset HNSW
    (delivery/graph_select.py), the metric that ships.
    """
    _train, test, feats = load_dataset(args)
    steps = args.select_steps or checkpoint_steps(paths.model_save_dir)
    if not steps:
        raise SystemExit(f"no checkpoints in {paths.model_save_dir}")
    graph_mode = args.select_metric == "graph"
    k = max(args.topk_eval)
    key = f"graph_recall@{k}" if graph_mode else f"recall@{k}"
    n_users = min(args.num_test_batch, len(test["gt_item_id"]))
    if graph_mode:
        sub_ids, sub_rows = gt_covering_subset(
            feats, test, n_users, min(args.select_subset, mcfg.num_item))
        logger.info(f"graph selection: {len(sub_ids)}-item gt-covering "
                    f"subset index per checkpoint")
    # each finished evaluation is cached, so that a restarted selection skips
    # to the unfinished ones; keyed by (users, dtype): another slice or
    # other numerics is a new screen
    cache_path = os.path.join(
        paths.model_save_dir,
        f"select_cache{'_graph' if graph_mode else ''}"
        f"_u{n_users}_{mcfg.compute_dtype}.json")
    results = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            results = {int(k): v for k, v in json.load(f).items()}
        logger.info(f"resuming selection: {sorted(results)} cached")
    for step in steps:
        if step in results:
            logger.info(f"checkpoint step_{step}: cached {key} "
                        f"{results[step][key]:.2%}")
            continue
        t0 = time.time()
        state = _restore(mcfg, tcfg, paths, step=step, device=args.device)
        item_ids, item_embs = extract_item_embeddings(
            state.params, state.bn_state, mcfg, feats)
        if graph_mode:
            res = {key: subset_graph_recall(
                mcfg, scfg, state, item_embs, sub_ids, sub_rows, test,
                n_users,
                workdir=os.path.join(paths.model_save_dir,
                                     f"select_idx_{step}"),
                search_batch=args.search_batch, topk=k)}
        else:
            res = _oracle_recall(args, mcfg, state,
                                 _oracle_table(args, mcfg, item_embs),
                                 item_ids, test)
        results[step] = res
        logger.info(f"checkpoint step_{step}: oracle {key} "
                    f"{res[key]:.2%} ({time.time() - t0:.0f}s)")
        with open(cache_path, "w") as f:
            json.dump({str(s): r for s, r in results.items()}, f)
        del state, item_embs
    best = max(results, key=lambda s: results[s][key])
    sel = {"step": best, "metric": key, "scores": results[best],
           "num_users": min(args.num_test_batch, len(test["gt_item_id"])),
           "evaluated": {str(s): results[s][key] for s in results}}
    if not graph_mode:
        sel["oracle"] = results[best]  # the JAX package's field name
    sel_path = os.path.join(paths.model_save_dir, "selected_step.json")
    with open(sel_path, "w") as f:
        json.dump(sel, f, indent=1)
    logger.info(f"SELECTED step_{best} ({key} {results[best][key]:.2%}) "
                f"-> {sel_path}")
    return sel


def job_export(args, mcfg, tcfg, scfg, paths):
    state = _restore(mcfg, tcfg, paths, device=args.device)
    item_ids = np.load(paths.item_ids_file) if \
        os.path.exists(paths.item_ids_file) else None
    item_embs = np.load(paths.item_embs_file) if \
        os.path.exists(paths.item_embs_file) else None
    # the index is copied inside export_model, so that VERSION lands only
    # after the whole bundle (scorer and index) is on disk
    has_index = os.path.exists(os.path.join(paths.index_dir,
                                            "enter_points.npy"))
    autotune_report = None
    if args.autotune_caps and has_index:
        # per-hop caps from the search's measured expansion on held-out
        # users (search/autotune.py); signature.json carries the whole
        # SearchConfig, so the serving side runs the tuned widths
        _train, test, _feats = load_dataset(args)
        n_probe = min(args.num_test_batch, len(test["gt_item_id"]), 256)
        users = extract_user_embeddings(
            state.params, {k: test[k][:n_probe] for k in test})
        sidx = _load_search_index(args, mcfg, scfg, paths)
        autotune_report = {}
        scfg = autotune_hop_caps(mcfg, scfg, state.params, state.bn_state,
                                 sidx, np.asarray(users, np.float32),
                                 report=autotune_report)
        logger.info(f"autotuned per-hop frontier caps ({n_probe} probes): "
                    f"{scfg.frontier_cap_per_hop} ({autotune_report})")
    export_model(paths.export_dir, state.params, state.bn_state, mcfg, scfg,
                 item_ids, item_embs,
                 index_dir=paths.index_dir if has_index else None,
                 checkpoint_step=int(state.step),
                 autotune_report=autotune_report)


def _engine_config(args) -> EngineConfig:
    buckets = tuple(args.batch_buckets) if args.batch_buckets else \
        EngineConfig.batch_buckets
    # a cached calibration (fingerprint-keyed) lets a warm restart serve at
    # once instead of measuring every bucket again
    cal = args.calibration_file or os.path.join(args.output_root,
                                                "calibration.json")
    return EngineConfig(batch_buckets=buckets, calibrate=True,
                        calibration_file=cal)


def job_serve_bench(args, mcfg, tcfg, scfg, paths):
    state = _restore(mcfg, tcfg, paths, device=args.device)
    sidx = _load_search_index(args, mcfg, scfg, paths)
    engine = Engine(mcfg, scfg, state.params, state.bn_state, sidx,
                    _engine_config(args))
    # the bench conf file holds LoadGenConfig's fields
    lg = LoadGenConfig(duration_s=10.0, qps=-1)
    conf_path = os.path.join(args.output_root, "benchmark_conf.json")
    if os.path.exists(conf_path):
        with open(conf_path) as f:
            lg = LoadGenConfig(**json.load(f))
        logger.info(f"loaded bench conf from {conf_path}: {lg}")
    else:
        with open(conf_path, "w") as f:
            json.dump(dataclasses.asdict(lg), f, indent=1)
    res = run_load_test(engine, lg)
    engine.shutdown()
    logger.info(f"serve_bench: {res}")
    return res


def job_serve(args, mcfg, tcfg, scfg, paths):
    """Serve the export bundle over REST (and gRPC) with hot reload, until
    SIGINT."""
    params, state, mcfg, sidx = load_serving_bundle(paths.export_dir, scfg,
                                                    device=args.device)
    engine = Engine(mcfg, scfg, params, state, sidx, _engine_config(args))
    reloader = ModelReloader(engine, paths.export_dir, scfg)
    reloader.start()
    server = NannServer(engine, port=args.port)
    server.start()
    grpc_server = None
    if args.grpc_port >= 0:
        from .serving.grpc_server import NannGrpcServer
        grpc_server = NannGrpcServer(engine, port=args.grpc_port)
        grpc_server.start()
    logger.info(f"serving export bundle on :{server.port} (REST)"
                + (f" / :{grpc_server.port} (gRPC Predict)" if grpc_server
                   else "") + "; ctrl-c to stop")
    try:
        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        server.stop()
        if grpc_server:
            grpc_server.stop()
        reloader.stop()
        engine.shutdown()


def job_verify_export(args, mcfg, tcfg, scfg, paths):
    # cross-check the bundle against the live checkpoint when one exists
    ref = None
    if latest_checkpoint_step(paths.model_save_dir) is not None:
        state = _restore(mcfg, tcfg, paths, device=args.device)
        ref = (state.params, state.bn_state)
    return verify_export(paths.export_dir, scfg, reference_state=ref,
                         device=args.device)


def job_build_tree(args, mcfg, tcfg, scfg, paths):
    """Build the tree index over the extracted item embeddings
    (index/tree_build.py)."""
    item_embs = np.load(paths.item_embs_file)
    tree = build_tree(item_embs, branch=args.tree_branch)
    tree_dir = os.path.join(args.output_root, "tree_index")
    save_tree(tree, tree_dir)
    logger.info(f"tree index: {tree.num_levels} levels, branch "
                f"{args.tree_branch} -> {tree_dir}")


def job_test_tree(args, mcfg, tcfg, scfg, paths):
    """Tree-retrieval eval: top-down beam search against the ground truth."""
    _train, test, _feats = load_dataset(args)
    state = _restore(mcfg, tcfg, paths, device=args.device)
    tree = load_tree(os.path.join(args.output_root, "tree_index"))
    item_ids = np.load(paths.item_ids_file)
    dtree = DeviceTree.from_tree(tree, item_ids, dtype=mcfg.compute_dtype,
                                 device=args.device)

    topk = max(args.topk_eval)
    search = make_tree_searcher(mcfg, beam_width=args.tree_beam, topk=topk)
    n_users = min(args.num_test_batch, len(test["gt_item_id"]))
    meters = {t: AverageMeter("recall", ":.2%") for t in args.topk_eval}
    B = args.search_batch
    for start in range(0, n_users, B):
        end = min(start + B, n_users)
        batch = {k: test[k][start:end] for k in test}
        items, _scores = search(state.params, state.bn_state, dtree,
                                _padded_users(state, batch, B))
        items = items.cpu().numpy()[:end - start]
        for u in range(end - start):
            got = items[u][items[u] >= 0]
            for t in args.topk_eval:
                _p, recall, _f = calc_pr(batch["gt_item_id"][u], got[:t])
                meters[t].update(recall)
    for t in args.topk_eval:
        logger.info(f"Tree Recall@{t} {meters[t].avg:.2%} "
                    f"(beam {args.tree_beam})")
    return {f"recall@{t}": meters[t].avg for t in args.topk_eval}


def job_parity(args, mcfg, tcfg, scfg, paths):
    """Graph-search recall against the brute-force ceiling on the same
    checkpoint, written to parity_result.json."""
    oracle = job_test_all(args, mcfg, tcfg, scfg, paths)
    graph = job_test(args, mcfg, tcfg, scfg, paths)
    report = {}
    for topk in args.topk_eval:
        ceiling = oracle[f"recall@{topk}"]
        got = graph[f"recall@{topk}"]
        ratio = got / ceiling if ceiling > 0 else float("nan")
        report[f"parity@{topk}"] = ratio
        report[f"graph_recall@{topk}"] = got
        report[f"oracle_recall@{topk}"] = ceiling
        logger.info(f"PARITY@{topk}: graph {got:.2%} / oracle {ceiling:.2%} "
                    f"= {ratio:.1%}")
    report["num_users"] = int(args.num_test_batch)
    report["checkpoint_step"] = _selected_step(paths)
    out = os.path.join(args.output_root, "parity_result.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    logger.info(f"parity report -> {out}")
    return report


JOBS = {
    "train": job_train,
    "extract_feature": job_extract,
    "build_index": job_build_index,
    "test": job_test,
    "test_all": job_test_all,
    "select_checkpoint": job_select_checkpoint,
    "export": job_export,
    "serve": job_serve,
    "serve_bench": job_serve_bench,
    "verify_export": job_verify_export,
    "parity": job_parity,
    "build_tree": job_build_tree,
    "test_tree": job_test_tree,
}
# select_checkpoint between train and the index, eval and export stages:
# everything downstream runs on the selected checkpoint
ALL_ORDER = ("train", "select_checkpoint", "extract_feature", "build_index",
             "test_all", "test", "export", "verify_export")


def main(argv=None):
    """Run the job; returns what it returns (for "all", a dict of the jobs'
    results by name). Raises without a card unless --device cpu is given."""
    args = parse_opt(argv)
    resolve_device(args.device)
    mcfg, tcfg, scfg = build_configs(args)
    paths = Paths(args.output_root)
    if args.index_dir:
        os.makedirs(args.index_dir, exist_ok=True)
        paths.index_dir = args.index_dir
    lead = (_torchrun_rank(tcfg.dp) or 0) == 0
    if lead:
        logger.info(f"job={args.job_type} model={mcfg} train={tcfg} "
                    f"search={scfg}")
    if args.job_type != "all":
        return JOBS[args.job_type](args, mcfg, tcfg, scfg, paths)
    results = {}
    for name in ALL_ORDER:
        if lead:
            logger.info(f"=== {name} ===")
        results[name] = JOBS[name](args, mcfg, tcfg, scfg, paths)
        if not lead:
            return None     # torchrun's other ranks: training only
    return results


if __name__ == "__main__":
    main()
