"""Checkpoint save/restore for TrainState, in the port's own format.

Each checkpoint directory (`step_N/`, as the JAX package lays them out)
holds one `torch.save` file with the full state: params, batch-norm state,
the AdamW state dict and the step, so resume is exact. It is read with
`torch.load(weights_only=True)`. The JAX package's orbax checkpoints do not
load here; the export bundle is what passes between the packages.

On a mesh, a checkpoint holds the whole state under the single-device
names: a row-sharded leaf (and its moments) is gathered whole
(parallel.whole_leaf, collective over "mp") before the rank at place
(0, 0) writes, and restored into each rank's block by parallel.local_block.
So a checkpoint of a dp x mp run restores into a single-device run, and the
reverse.
"""

from __future__ import annotations

import os

import torch

from ..models.scorer import _map
from ..parallel.collectives import whole_leaf
from ..parallel.sharding import local_block
from .step import TrainState, named_leaves, placed_moments, placed_params

CHECKPOINT_FILE = "train_state.pt"


def is_lead(mesh) -> bool:
    """Whether this rank writes what the run writes: the only rank without
    a mesh, the rank at place (0, 0) of one."""
    return mesh is None or (mesh.index("dp") == 0 and mesh.index("mp") == 0)


def save_train_state(path: str, state: TrainState, mesh=None,
                     shardings=None) -> None:
    """Write `path/train_state.pt`, replacing one that is there; the file
    appears whole or not at all. With a mesh every rank calls it (the
    row-sharded leaves of `shardings`, parallel.train_state_shardings, are
    gathered whole) and the rank at (0, 0) writes."""
    params = _map(state.params, torch.Tensor.detach)
    opt = state.opt_state.state_dict()
    if shardings is not None:
        opt["state"] = placed_moments(opt["state"], params, shardings, mesh,
                                      whole_leaf)
        params = placed_params(params, shardings, mesh, whole_leaf)
    if not is_lead(mesh):
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save({"params": params, "bn_state": state.bn_state,
                "opt_state": opt, "step": int(state.step)}, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def restore_train_state(path: str, template: TrainState, mesh=None,
                        shardings=None) -> TrainState:
    """Restore into `template`: its parameter tensors take the saved values
    in place (so its optimizer keeps them), its optimizer the saved moments
    and counts. Leaves are matched by name, so a checkpoint whose tree lists
    them in another order (one carried over from the JAX package's
    parameters by `models.params_from_jax`) restores too; names and shapes
    must match. With a mesh and `shardings`, the template holds this rank's
    blocks (train.step.shard_train_state) and takes its blocks of the saved
    whole leaves."""
    device = next(named_leaves(template.params))[1].device
    saved = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                       map_location=device, weights_only=True)
    if shardings is not None:
        saved["opt_state"]["state"] = placed_moments(
            saved["opt_state"]["state"], saved["params"], shardings, mesh,
            local_block)
        saved["params"] = placed_params(saved["params"], shardings, mesh,
                                        local_block)
    want = list(named_leaves(template.params))
    got = dict(named_leaves(saved["params"]))
    if {n: t.shape for n, t in want} != {n: t.shape for n, t in got.items()}:
        raise ValueError(f"checkpoint {path} does not match the template's "
                         f"parameters")
    with torch.no_grad():
        for name, leaf in want:
            leaf.copy_(got[name])
    # the optimizer's state is keyed by each leaf's place in its tree
    saved_at = {name: i for i, name in enumerate(got)}
    opt = saved["opt_state"]
    moments = {j: opt["state"][saved_at[name]]
               for j, (name, _) in enumerate(want)
               if saved_at[name] in opt["state"]}
    template.opt_state.load_state_dict(
        {"state": moments, "param_groups": opt["param_groups"]})
    return TrainState(template.params, saved["bn_state"], template.opt_state,
                      int(saved["step"]))
