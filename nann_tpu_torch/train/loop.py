"""Training loop: meters, checkpointing, auto-resume (nann_tpu/train/loop.py).

Periodic checkpoint save (every `save_freq` steps and at the end), auto-resume
from the latest checkpoint, moving-average loss/acc meters, periodic logging
and an optional metrics JSONL. Checkpoints are the port's own
(`dataclasses_io.py`): params, batch-norm state, optimizer state and step.

With a mesh (parallel.make_mesh over an initialised torch.distributed
world) every rank of the mesh runs the loop on its block of each global
batch; the rank at place (0, 0) logs, writes the metrics and saves and
prunes the checkpoints, and the others wait at a barrier after each save.
Every rank reads the checkpoint it resumes from.

Runnable on synthetic data, on the card unless told otherwise:
    python -m nann_tpu_torch.train.loop --steps 200 --out /tmp/nann_run
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..data import BatchIterator, synthetic_dataset
from ..utils import AverageMeter, get_logger, resolve_device
from .dataclasses_io import is_lead, restore_train_state, save_train_state
from .step import TrainState, create_train_state, make_train_step

logger = get_logger("nann_tpu_torch.train")


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep only the newest `keep` checkpoints (tf.train.Saver max_to_keep)."""
    steps = checkpoint_steps(ckpt_dir)
    for s in steps[:-keep] if len(steps) > keep else []:
        path = os.path.join(ckpt_dir, f"step_{s}")
        shutil.rmtree(path, ignore_errors=True)
        if os.path.exists(path):
            logger.info(f"could not prune checkpoint {path}")


def checkpoint_steps(ckpt_dir: str) -> list:
    """All retained checkpoint steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[-1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d.split("_")[-1].isdigit())


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return max(steps) if steps else None


def _mesh_max(mesh, value: int, device) -> int:
    """The MAX of `value` over every rank of the mesh (over its "dp" group,
    then its "mp" group); a barrier of the mesh's ranks as well."""
    t = torch.tensor([value], device=device)
    for axis in ("dp", "mp"):
        if mesh.size(axis) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return int(t.item())


def train_loop(mcfg: ModelConfig, tcfg: TrainConfig,
               train_data: Dict[str, np.ndarray],
               item_features: Dict[str, np.ndarray],
               ckpt_dir: Optional[str] = None,
               num_steps: Optional[int] = None,
               metrics_path: Optional[str] = None,
               device="cuda", mesh=None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """Run training; returns (final_state, final_metrics).

    num_steps is the total global-step budget (also the cosine horizon
    unless tcfg.lr_total_steps pins one); metrics_path an optional JSONL
    sink for the logged steps' metrics. With `mesh` every rank of the mesh
    calls it (the batch split over "dp", the state replicated, as
    nann_tpu/train/loop.py runs on a mesh); the metrics are the global
    batch's on every rank.
    """
    dev = resolve_device(device)
    lead = is_lead(mesh)
    it = BatchIterator(train_data, tcfg.batch_size, epochs=tcfg.train_epochs,
                       drop_remainder=True, seed=tcfg.seed, mesh=mesh)
    total = len(it) if num_steps is None else num_steps
    state, schedule = create_train_state(mcfg, tcfg, total_steps=total,
                                         device=dev)
    step_fn = make_train_step(mcfg, tcfg, schedule, item_features, device=dev,
                              mesh=mesh)

    def save(path):
        save_train_state(path, state, mesh)
        if lead:
            _prune_checkpoints(ckpt_dir, keep=tcfg.max_to_keep)
        if mesh is not None:
            _mesh_max(mesh, 0, dev)     # the barrier: (0, 0) has written

    start_step = 0
    if ckpt_dir:
        resume = latest_checkpoint_step(ckpt_dir)
        if resume is not None:
            if lead:
                logger.info(f"auto-resuming from {ckpt_dir}/step_{resume}")
            state = restore_train_state(os.path.join(ckpt_dir, f"step_{resume}"),
                                        state)
            start_step = resume

    # a resumed run completes the remaining schedule from where it stopped
    # (data position fast-forwarded, not replayed; the optimizer's step
    # count, and with it the lr schedule, restores from the checkpoint)
    if start_step >= total:
        if lead:
            logger.info(f"resume step {start_step} >= budget {total}; "
                        f"nothing to do")
        return state, {}

    meters = {k: AverageMeter(k, ":.4f", moving_average=True)
              for k in ("loss", "loss_xe", "loss_adv", "acc", "acc_origin")}
    bt = AverageMeter("batch_time", ":.3f", moving_average=True)
    data_seed = tcfg.seed + 1

    tic = time.time()
    metrics_host: Dict[str, float] = {}
    stepped = False   # did at least one optimizer step run?
    for step_idx, batch in enumerate(it.iter_from(start_step % len(it)),
                                     start=start_step):
        if step_idx >= total:
            break
        stepped = True
        state, metrics = step_fn(state, batch, data_seed)

        if step_idx % tcfg.print_freq == 0 or step_idx + 1 == total:
            metrics_host = {k: float(v) for k, v in metrics.items()}
            for k, m in meters.items():
                m.update(metrics_host[k])
            bt.update(time.time() - tic)
            if lead:
                logger.info(f"[{step_idx}/{total}] " +
                            ", ".join(str(m) for m in meters.values()) +
                            f", {bt}")
            if metrics_path and lead:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"step": step_idx,
                                        "batch_time": bt.val,
                                        **metrics_host}) + "\n")
        tic = time.time()

        if ckpt_dir and (step_idx % tcfg.save_freq == 0
                         or step_idx + 1 == total):
            save(os.path.join(ckpt_dir, f"step_{step_idx + 1}"))

    # end-of-training save: the in-loop condition `step_idx + 1 == total`
    # never fires when the data runs out before the step budget
    if ckpt_dir and stepped:
        final = os.path.join(ckpt_dir, f"step_{state.step}")
        missing = not os.path.exists(final)
        if mesh is not None:
            # one answer on every rank, so that all of them save or none
            missing = bool(_mesh_max(mesh, int(missing), dev))
        if missing:
            save(final)

    if not metrics_host:
        metrics_host = {k: float("nan") for k in meters}
    return state, metrics_host


def _main():
    import argparse

    p = argparse.ArgumentParser("nann_tpu_torch synthetic training demo")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-item", type=int, default=2000)
    p.add_argument("--num-neg", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args()

    train, _test, feats = synthetic_dataset(num_item=args.num_item,
                                            num_users=800, max_seq_length=20)
    mcfg = ModelConfig(num_item=args.num_item, num_cate=50,
                       max_seq_length=20)
    tcfg = TrainConfig(batch_size=args.batch_size, num_neg=args.num_neg,
                       train_epochs=50, print_freq=10,
                       save_freq=max(args.steps // 2, 1))
    _state, metrics = train_loop(mcfg, tcfg, train, feats, ckpt_dir=args.out,
                                 num_steps=args.steps, device=args.device)
    logger.info(f"final metrics: {metrics}")


if __name__ == "__main__":
    _main()
