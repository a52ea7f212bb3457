"""Brute-force full-catalogue scoring: the recall oracle
(nann_tpu/search/brute_force.py).

Every item is scored against every query, in chunks, through the same
frontier scorer the search uses (the CUDA kernel on the card), and the global
top-k is taken with lax.top_k's tie order (lower index first).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ModelConfig
from ..kernels.frontier_scorer import kernel_weights, score_frontier
from ..models.layers import Params, State
from ..ops.scorer_kernel import fold_scorer, precompute_user
from ..utils import torch_dtype


def brute_force_topk(params: Params, state: State, mcfg: ModelConfig,
                     user_seq_emb: torch.Tensor, item_embs: torch.Tensor,
                     k: int = 200, chunk_size: int = 8192
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """user_seq_emb [B, L, d_user], item_embs [N, d_item] ->
    (top_idx [B, min(k, N)] int32 row indices, top_scores [B, min(k, N)]).

    item_embs is a float table: the oracle of an int8 index is the float
    table of the same items, as in the JAX package, which has no int8
    oracle."""
    if item_embs.dtype == torch.int8:
        raise TypeError("the brute-force oracle takes a float32 or bfloat16 "
                        "item table, not a packed int8 one: score the float "
                        "table of the same items")
    dt = torch_dtype(mcfg.compute_dtype)
    dev = item_embs.device
    user = user_seq_emb.to(dev)
    B, n = user.shape[0], item_embs.shape[0]
    folded = fold_scorer(params, state, mcfg)
    k_proj, v = precompute_user(folded, user, dt)
    weights = kernel_weights(folded, dt)
    chunks = []
    for c0 in range(0, n, chunk_size):
        ids = torch.arange(c0, min(c0 + chunk_size, n), dtype=torch.int32,
                           device=dev)[None].expand(B, -1).contiguous()
        valid = torch.ones(ids.shape, dtype=torch.bool, device=dev)
        chunks.append(score_frontier(weights, k_proj, v, item_embs, ids, valid))
    scores = torch.cat(chunks, dim=-1)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[:, :min(k, n)]
    return order.int(), scores.gather(-1, order)
