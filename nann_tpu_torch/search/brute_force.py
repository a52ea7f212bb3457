"""Brute-force full-catalogue scoring: the recall oracle
(nann_tpu/search/brute_force.py).

Every item is scored against every query, in chunks, through the same
frontier scorer the search uses (the CUDA kernel on the card), and the global
top-k is taken by the `row_topk` kernel with lax.top_k's tie order (lower
index first).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ModelConfig
from ..kernels.frontier_scorer import kernel_weights, score_frontier
from ..kernels import select_ops
from ..models.layers import Params, State
from ..ops.scorer_kernel import fold_scorer, precompute_user
from ..utils import torch_dtype


def brute_force_topk(params: Params, state: State, mcfg: ModelConfig,
                     user_seq_emb: torch.Tensor, item_embs: torch.Tensor,
                     k: int = 200, chunk_size: int = 8192
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """user_seq_emb [B, L, d_user], item_embs [N, d_item] ->
    (top_idx [B, k] int32 row indices, top_scores [B, k]).

    As the JAX oracle, which pads the catalogue to a multiple of chunk_size
    and takes the top k of the padded width: for N < k <= N_pad (N rounded
    up to chunk_size) the columns beyond N hold pad indices N, N+1, ...
    (ascending: ties go to the lower index) scored -inf; k > N_pad raises
    ValueError, where lax.top_k fails.

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
    n_pad = -(-n // chunk_size) * chunk_size
    if k > n_pad:
        raise ValueError(f"k = {k} exceeds the {n} items padded to "
                         f"{n_pad} (chunk_size {chunk_size})")
    folded = fold_scorer(params, state, mcfg)
    k_proj, v = precompute_user(folded, user, dt)
    weights = kernel_weights(folded, dt)
    chunks = []
    for c0 in range(0, n, chunk_size):
        ids = torch.arange(c0, min(c0 + chunk_size, n), dtype=torch.int32,
                           device=dev)[None].expand(B, -1).contiguous()
        valid = torch.ones(ids.shape, dtype=torch.bool, device=dev)
        chunks.append(score_frontier(weights, k_proj, v, item_embs, ids, valid))
    if k > n:      # the padding's -inf columns that lax.top_k would reach
        chunks.append(torch.full((B, k - n), float("-inf"), device=dev))
    top_scores, top_idx = select_ops.row_topk(torch.cat(chunks, dim=-1), k)
    return top_idx, top_scores
