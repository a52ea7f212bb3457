"""The NANN target-attention scorer in PyTorch.

Counterpart of `nann_tpu/models/scorer.py`. Parameters and batch-norm state
are nested dicts of tensors with the JAX pytree's structure and names:

    params: ht_item, ht_cate, item_tower[3], att{q1,q1_prelu,q2,k1,k1_prelu,k2},
            head[4]   (each tower/head entry a DNN block: dense [bn] [prelu])
    state:  item_tower[3], head[4]   ({"bn": {mean, var}} or {} per block)

so the flat `a/b/0/c` names of an export bundle (`delivery/export.py`) map onto
them one for one. Serving reads only `att` and `head` (`scorer_forward`, eval
mode); training and extraction run the embedding tables and the item tower
too (`user_embed`, `item_tower`, `scorer_forward_train`, `score_pairs`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..utils import resolve_device, torch_dtype
from . import layers
from .layers import Params, State

ITEM_TOWER_SPECS = (("bn", "prelu"), ("bn", "prelu"), (None, None))
HEAD_SPECS = (("bn", "prelu"), ("bn", "prelu"), ("bn", "prelu"), (None, None))
_STATE_LEAVES = ("mean", "var")


def init_scorer(mcfg: ModelConfig, generator: torch.Generator = None,
                device="cuda") -> Tuple[Params, State]:
    """Random parameters and fresh batch-norm state from a torch.Generator
    (initialisers of nann_tpu/models/layers.py; the numbers differ from JAX's
    for the same seed)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d, d_item, d_user = mcfg.emb_dim, mcfg.item_emb_dim, mcfg.user_emb_dim
    emb_std = 1.0 / math.sqrt(d)
    params: Params = {
        "ht_item": emb_std * layers._truncated_normal((mcfg.num_item + 1, d), gen),
        "ht_cate": emb_std * layers._truncated_normal((mcfg.num_cate + 1, d), gen),
    }
    state: State = {}
    tower_p, tower_s, in_dim = [], [], d_item
    for (norm, act), out_dim in zip(ITEM_TOWER_SPECS, mcfg.item_tower_dims):
        p, s = layers.dnn_init(gen, in_dim, out_dim, True, norm, act)
        tower_p.append(p)
        tower_s.append(s)
        in_dim = out_dim
    params["item_tower"], state["item_tower"] = tower_p, tower_s

    m1, m2 = mcfg.att_proj_mult1, mcfg.att_proj_mult2
    params["att"] = {
        "q1": layers.dense_init(gen, d_item, m1 * d_user),
        "q1_prelu": layers.prelu_init(m1 * d_user),
        "q2": layers.dense_init(gen, m1 * d_user, m2 * d_user),
        "k1": layers.dense_init(gen, d_user, m1 * d_user),
        "k1_prelu": layers.prelu_init(m1 * d_user),
        "k2": layers.dense_init(gen, m1 * d_user, m2 * d_user),
    }
    head_p, head_s = [], []
    in_dim = d_user + mcfg.item_tower_dims[-1]
    for i, ((norm, act), out_dim) in enumerate(zip(HEAD_SPECS, mcfg.head_dims)):
        p, s = layers.dnn_init(gen, in_dim, out_dim, i < len(mcfg.head_dims) - 1,
                               norm, act)
        head_p.append(p)
        head_s.append(s)
        in_dim = out_dim
    params["head"], state["head"] = head_p, head_s
    return _to(params, dev), _to(state, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def nonlinear_attention(att: Params, item_emb: torch.Tensor,
                        user_seq_emb: torch.Tensor, dt) -> torch.Tensor:
    """Target attention (scorer.py:134-155).

    item_emb [B, N, d_item] (queries), user_seq_emb [B, L, d_user] (keys and
    values) -> [B, N, d_user]."""
    q = layers.prelu(att["q1_prelu"], layers.dense(att["q1"], item_emb, dt))
    q = layers.dense(att["q2"], q, dt)
    k = layers.prelu(att["k1_prelu"], layers.dense(att["k1"], user_seq_emb, dt))
    k = layers.dense(att["k2"], k, dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    weights = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(weights.float(), user_seq_emb.to(dt).float()).to(dt)


def _masked_lookup(table: torch.Tensor, ids: torch.Tensor,
                   lookup: Optional[Callable] = None) -> torch.Tensor:
    """Embedding lookup with id 0 (padding/missing) mapped to the zero
    vector (scorer.py:99-104). `lookup(table, ids)` replaces the dense
    lookup: for a row-sharded table, parallel.sharded_embedding's."""
    emb = lookup(table, ids) if lookup else F.embedding(ids.long(), table)
    return emb * (ids > 0).to(emb.dtype).unsqueeze(-1)


def user_embed(params: Params, item_ids: torch.Tensor, cate_ids: torch.Tensor,
               lookup: Optional[Callable] = None) -> torch.Tensor:
    """Behavior sequence -> user sequence embedding [B, L, 2*emb_dim]
    (scorer.py:107-113); `lookup` for row-sharded tables."""
    e_item = _masked_lookup(params["ht_item"], item_ids, lookup)
    e_cate = _masked_lookup(params["ht_cate"], cate_ids, lookup)
    return torch.cat([e_item, e_cate], dim=-1)


def item_tower(params: Params, state: State, mcfg: ModelConfig,
               item_ids: torch.Tensor, cate_ids: torch.Tensor, training: bool,
               group=None, lookup: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, State]:
    """Item/category ids -> (item embedding [..., item_emb_dim] float32, new
    state) (scorer.py:116-131); in eval mode the state comes back as it
    went in. In training mode `group` (the "dp" process group) takes the
    batch norms' statistics over the global batch; `lookup` is for
    row-sharded tables."""
    x = torch.cat([_masked_lookup(params["ht_item"], item_ids, lookup),
                   _masked_lookup(params["ht_cate"], cate_ids, lookup)],
                  dim=-1)
    dt = torch_dtype(mcfg.compute_dtype)
    new_tower = []
    for p, s, (norm, act) in zip(params["item_tower"], state["item_tower"],
                                 ITEM_TOWER_SPECS):
        if training:
            x, ns = layers.dnn_apply_train(p, s, x, norm, act,
                                           mcfg.bn_momentum, mcfg.bn_epsilon,
                                           dt, group)
        else:
            x, ns = layers.dnn_apply(p, s, x, norm, act, mcfg.bn_epsilon,
                                     dt), s
        new_tower.append(ns)
    return x.float(), {**state, "item_tower": new_tower}


def _head_input(params: Params, user_seq_emb: torch.Tensor,
                item_emb: torch.Tensor, dt) -> torch.Tensor:
    """concat(target attention, item embedding): the head's input."""
    att_out = nonlinear_attention(params["att"], item_emb.to(dt),
                                  user_seq_emb.to(dt), dt)
    return torch.cat([att_out, item_emb.to(dt)], dim=-1)


def scorer_forward(params: Params, state: State, mcfg: ModelConfig,
                   user_seq_emb: torch.Tensor, item_emb: torch.Tensor
                   ) -> torch.Tensor:
    """Eval-mode scorer (scorer.py:158-178): user_seq_emb [B, L, d_user],
    item_emb [B, N, d_item] -> logits [B, N] float32."""
    dt = torch_dtype(mcfg.compute_dtype)
    x = _head_input(params, user_seq_emb, item_emb, dt)
    for p, s, (norm, act) in zip(params["head"], state["head"], HEAD_SPECS):
        x = layers.dnn_apply(p, s, x, norm, act, mcfg.bn_epsilon, dt)
    return x.squeeze(-1).float()


def scorer_forward_train(params: Params, state: State, mcfg: ModelConfig,
                         user_seq_emb: torch.Tensor, item_emb: torch.Tensor,
                         group=None) -> Tuple[torch.Tensor, State]:
    """Training-mode scorer (scorer.py:155-178 with training=True): the
    head's batch norms over the batch (with `group`, the "dp" process
    group, over the global batch) -> (logits [B, N] float32, new state)."""
    dt = torch_dtype(mcfg.compute_dtype)
    x = _head_input(params, user_seq_emb, item_emb, dt)
    new_head = []
    for p, s, (norm, act) in zip(params["head"], state["head"], HEAD_SPECS):
        x, ns = layers.dnn_apply_train(p, s, x, norm, act, mcfg.bn_momentum,
                                       mcfg.bn_epsilon, dt, group)
        new_head.append(ns)
    return x.squeeze(-1).float(), {**state, "head": new_head}


def score_pairs(params: Params, state: State, mcfg: ModelConfig,
                user_item_ids: torch.Tensor, user_cate_ids: torch.Tensor,
                target_item_ids: torch.Tensor, target_cate_ids: torch.Tensor,
                training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """End-to-end scoring from raw ids: (logits, item_emb, new_state)
    (scorer.py:181-195)."""
    user_seq = user_embed(params, user_item_ids, user_cate_ids)
    item_emb, state = item_tower(params, state, mcfg, target_item_ids,
                                 target_cate_ids, training)
    if training:
        logits, state = scorer_forward_train(params, state, mcfg, user_seq,
                                             item_emb)
    else:
        logits = scorer_forward(params, state, mcfg, user_seq, item_emb)
    return logits, item_emb, state


# ------------------------------------------------------------ flat bundle names


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested params/state -> {"a/b/0/c": float32 array}, the names
    nann_tpu/delivery/export.py:40 `_flatten` writes."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree.detach().float().cpu().numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for name, value in flat.items():
        node = root
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..k-1 become lists, as the pytree had them."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise ValueError(f"non-contiguous list indices {sorted(node)}")
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(flat: Dict[str, np.ndarray], device="cuda"
                    ) -> Tuple[Params, State]:
    """Flat bundle arrays (the union of scorer_params.npz and bn_state.npz)
    -> the port's (params, state) as float32 tensors on `device`.

    State blocks without batch norm are empty dicts in the pytree and so have
    no names in the bundle; they are rebuilt from the parameter structure."""
    dev = resolve_device(device)
    p_flat = {k: v for k, v in flat.items()
              if k.rsplit("/", 1)[-1] not in _STATE_LEAVES}
    s_flat = {k: v for k, v in flat.items()
              if k.rsplit("/", 1)[-1] in _STATE_LEAVES}
    params = _unflatten(p_flat)
    state_tree = _unflatten(s_flat) if s_flat else {}
    state: State = {}
    for tower in ("item_tower", "head"):
        if tower not in params:
            raise KeyError(f"bundle has no '{tower}' parameters")
        have = state_tree.get(tower, [])
        state[tower] = []
        for i, block in enumerate(params[tower]):
            if "bn" in block:
                bn = have[i]["bn"] if i < len(have) else None
                if bn is None:
                    raise KeyError(f"bundle has no {tower}/{i}/bn statistics")
                state[tower].append({"bn": bn})
            else:
                state[tower].append({})
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return _to(_map(params, to_t), dev), _to(_map(state, to_t), dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)
