"""Train state and the train step (nann_tpu/train/step.py), on one device
or on a ("dp", "mp") mesh of torch.distributed ranks.

The optimizer is `torch.optim.AdamW` with optax.adamw's constants (b1 0.9,
b2 0.999, eps 1e-8, decay decoupled and scaled by the learning rate, on every
parameter), its learning rate set before each update from the port's own
copy of the optax schedules (constant, linear warmup, warmup-cosine).
Parameters are nested dicts of leaf tensors that require grad; the step
updates them in place, as JAX's jitted step donates its state.

On a mesh each rank runs the step on its block of the global batch, as
JAX's step with the batch sharded over "dp": the loss, metrics and
batch-norm statistics are the global batch's (train/objective.py), the
gradients are summed over "dp" after the backward, and AdamW runs on each
rank's own leaves. Leaves that `state_shardings` row-shards over "mp" (the
embedding tables and their moments, parallel.train_state_shardings) are
this rank's block (`shard_train_state`), looked up through
parallel.sharded_embedding; every other leaf is replicated and stays equal
on every rank, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models import scorer
from ..models.layers import Params, State
from ..parallel import collectives
from ..parallel.sharding import local_block
from ..utils import resolve_device
from .objective import build_targets, nann_loss

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    params: Params
    bn_state: State
    opt_state: torch.optim.AdamW
    step: int


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(`a/b/0/c` name, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


# ------------------------------------------------- optax's schedules, copied


def _linear_schedule(init_value: float, end_value: float,
                     transition_steps: int) -> Schedule:
    """optax.schedules.linear_schedule (polynomial, power 1, begin 0)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int,
                           alpha: float) -> Schedule:
    """optax.schedules.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def _warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                  warmup_steps: int, decay_steps: int,
                                  end_value: float) -> Schedule:
    """optax.schedules.warmup_cosine_decay_schedule: the linear warmup,
    then the cosine decay from `warmup_steps` on (join_schedules)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def lr_schedule_fn(tcfg: TrainConfig, total_steps: Optional[int] = None
                   ) -> Schedule:
    """Learning-rate schedule from TrainConfig (step.py:37-62): a function of
    the count of previous optimizer updates."""
    base = tcfg.learning_rate
    horizon = tcfg.lr_total_steps or total_steps or 0
    if tcfg.lr_schedule == "constant":
        if tcfg.warmup_steps <= 0:
            return lambda count: base
        return _linear_schedule(0.0, base, tcfg.warmup_steps)
    if tcfg.lr_schedule == "cosine":
        if horizon <= 0:
            raise ValueError("lr_schedule='cosine' needs a decay horizon: "
                             "set lr_total_steps or pass total_steps")
        return _warmup_cosine_decay_schedule(
            init_value=0.0 if tcfg.warmup_steps > 0 else base,
            peak_value=base, warmup_steps=max(tcfg.warmup_steps, 0),
            decay_steps=horizon, end_value=base * tcfg.lr_final_ratio)
    raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r} "
                     "(constant|cosine)")


# ------------------------------------------------------------------- state


def train_state_from(params: Params, bn_state: State, tcfg: TrainConfig
                     ) -> TrainState:
    """A TrainState at step 0 over the given parameters (from `init_scorer`,
    or from JAX's through `models.params_from_jax`) with fresh (zero) AdamW
    moments. The parameter leaves are made to require grad."""
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    # Divergence guard (rounding noise in gradients that are zero in exact
    # arithmetic): every dense bias that feeds a training-mode batch norm,
    # and the keys' last bias under the softmax, gets float32 noise for a
    # gradient, and Adam's first update moves it by up to +-lr with the
    # noise's sign. JAX and the port legitimately differ there after a step;
    # tests/test_torch_train.py names these leaves (ZERO_GRAD_LEAVES).
    opt = torch.optim.AdamW(leaves, lr=tcfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=tcfg.weight_decay)
    return TrainState(params, bn_state, opt, 0)


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig,
                       total_steps: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> Tuple[TrainState, Schedule]:
    """Random parameters (from `generator`, by default seeded with
    tcfg.seed), fresh batch-norm and optimizer state, and the learning-rate
    schedule: (state, schedule)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(tcfg.seed)
    params, bn_state = scorer.init_scorer(mcfg, gen, device=device)
    return (train_state_from(params, bn_state, tcfg),
            lr_schedule_fn(tcfg, total_steps))


def apply_gradients(opt: torch.optim.AdamW, schedule: Schedule,
                    count: int) -> None:
    """One AdamW update from the leaves' .grad.

    Divergence guard (learning rate at step 0): optax evaluates the schedule
    at the count of *previous* updates, so the first update under warmup has
    lr 0; the learning rate is set from schedule(count) before the update (a
    LambdaLR stepped after it would be one step late)."""
    lr = float(schedule(count))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random draw of step `step`.

    Divergence guard (the per-step draw depends on (seed, step) only): JAX
    folds the step into a fixed key, so a resumed run draws what an
    uninterrupted one draws; here each step gets a generator seeded from
    (seed, step) by numpy's SeedSequence, never one generator carried across
    steps. It lives on `device`: a CPU generator cannot feed a CUDA rand."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def _sharded(placements) -> bool:
    return any(hasattr(p, "dim") for p in placements)


def shard_train_state(state: TrainState, shardings, mesh) -> TrainState:
    """This rank's TrainState under `shardings` (parallel.
    train_state_shardings): every leaf and AdamW moment copied as this
    rank's block of it (parallel.local_block; a replicated leaf whole), and
    a new AdamW over the new leaves with the state's hyperparameters. The
    counterpart of JAX's device_put of a TrainState by its shardings."""
    def block(t, placements, mesh):
        return local_block(t.detach(), placements, mesh).clone()

    placed = placed_params(state.params, shardings, mesh, block)
    # the saved param groups bring the state's hyperparameters back
    local = train_state_from(placed, state.bn_state, TrainConfig())
    saved = state.opt_state.state_dict()
    local.opt_state.load_state_dict({
        "state": placed_moments(saved["state"], state.params, shardings,
                                mesh, block),
        "param_groups": saved["param_groups"]})
    return TrainState(placed, state.bn_state, local.opt_state, state.step)


def placed_params(params: Params, shardings, mesh, fn) -> Params:
    """params with fn(leaf, placements, mesh) at every leaf, its placements
    those of shardings["params"]: parallel.local_block (this rank's block
    of a whole leaf) or parallel.whole_leaf (the whole of a block)."""
    return _rebuild(params, {
        name: fn(leaf, _placements(shardings["params"], name), mesh)
        for name, leaf in named_leaves(params)})


def placed_moments(moments: Dict[int, Dict[str, torch.Tensor]],
                   params: Params, shardings, mesh, fn):
    """An AdamW state dict's "state" (by the index of each leaf of
    `params`) with fn(moment, placements, mesh) at every moment that
    shardings["opt_state"] places."""
    names = [name for name, _ in named_leaves(params)]
    return {i: {m: fn(v, shardings["opt_state"][names[i]][m], mesh)
                if m in shardings["opt_state"][names[i]] else v
                for m, v in moment.items()}
            for i, moment in moments.items()}


def _placements(tree, name: str):
    """The placements of the leaf named `a/b/0/c` in a shardings tree."""
    for key in name.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """tree's structure with the leaf named `a/b/0/c` taken from flat."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return flat[prefix.rstrip("/")]


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, schedule: Schedule,
                    item_features: Dict[str, np.ndarray], device="cuda",
                    mesh=None, state_shardings=None) -> Callable:
    """Build the train step.

    Args:
        item_features: "item_id", "cate_id" [num_item] and "weight_tag"
            [num_item] popularity probabilities (numpy or tensors).
        mesh: a parallel.Mesh; if given, each rank steps on its block of the
            global batch (BatchIterator(mesh=...) gives it) and the step
            computes what the single-device step computes on the global
            batch. Every rank of the mesh calls the step.
        state_shardings: with a mesh, parallel.train_state_shardings of the
            state: the state must then be `shard_train_state`'s; default
            every leaf replicated.

    Returns:
        step(state, batch, seed) -> (new_state, metrics): the batch (numpy or
        tensors) is moved to the device; the negatives are drawn from
        step_generator(seed, state.step); metrics are 0-d tensors (with a
        mesh, the global batch's on every rank).
    """
    dev = resolve_device(device)
    group, dp, dp_index, lookup = None, 1, 0, None
    if mesh is not None:
        dp, dp_index = mesh.size("dp"), mesh.index("dp")
        if dp > 1:
            group = mesh.group("dp")
        if state_shardings is not None:
            tables = {name: _sharded(state_shardings["params"][name])
                      for name in ("ht_item", "ht_cate")}
            if len(set(tables.values())) != 1:
                raise ValueError(f"the embedding tables must be sharded "
                                 f"alike, got {tables}")
            if tables["ht_item"]:
                lookup = collectives.sharded_embedding(mesh)

    def on_dev(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    item_ids = on_dev(item_features["item_id"], torch.int32)
    cate_ids = on_dev(item_features["cate_id"], torch.int32)
    probs = on_dev(item_features["weight_tag"], torch.float32)
    log_probs = torch.log(1e-20 + probs)

    def step(state: TrainState, batch, seed: int
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {k: on_dev(v) for k, v in batch.items()}
        targets = build_targets(step_generator(seed, state.step, dev), batch,
                                item_ids, cate_ids, log_probs, probs,
                                tcfg.num_neg, dp, dp_index)
        state.opt_state.zero_grad(set_to_none=True)
        loss, (new_bn, metrics) = nann_loss(state.params, state.bn_state,
                                            mcfg, tcfg, batch, targets,
                                            group, lookup)
        loss.backward()
        if group is not None:
            collectives.all_reduce_grads(
                [leaf for _, leaf in named_leaves(state.params)], group)
        apply_gradients(state.opt_state, schedule, state.step)
        return (TrainState(state.params, new_bn, state.opt_state,
                           state.step + 1), metrics)

    return step
