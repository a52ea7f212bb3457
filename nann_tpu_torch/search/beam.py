"""Model-scored HNSW beam search, batched over queries.

Counterpart of `nann_tpu/search/beam.py` for the serving default:
semantics="eval" (`search_eval`, beam.py:588-641), hop_mode="filtered",
the sorted visited list (`ListBackend`, :326-409) and exact top-k. JAX
writes one query and `vmap`s it; here every tensor carries the batch as its
first axis `[B, ...]`, and every shape is the one the JAX program has, so the
same truncations and ties fall the same way.

Each hop: neighbor expansion -> in-frontier dedup and visited test by one
sort over tagged keys -> unbiased truncation to the hop's frontier cap ->
scoring of the fresh rows through the frontier-scorer kernel
(`kernels/frontier_scorer.py`), which gathers the rows itself, from a float
item table or a packed int8 one (`SearchIndex.from_artifacts(dtype="int8")`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ModelConfig, SearchConfig
from ..index.quantize import pack_quantized
from ..index.reorder import bfs_order, relabel
from ..kernels.frontier_scorer import (frontier_scorer_plain, kernel_weights,
                                       score_frontier)
from ..models.layers import Params, State
from ..ops.scorer_kernel import fold_scorer, precompute_user
from ..utils import resolve_device, torch_dtype

NEG_INF = float("-inf")
IMAX = 2**31 - 1          # frontier-side pad key (odd), and "no key"
K_PAD_V = 2**31 - 2       # visited-side pad key (even)
SALT_MULT = 0x1F123BB5    # per-hop truncation salt, beam.py:518-519


@dataclasses.dataclass
class SearchIndex:
    """Device-resident retrieval state."""

    item_embs: torch.Tensor            # [N, d_item], or int8 [N, d_item+4]
    item_ids: torch.Tensor             # [N] int32 external ids
    enter_points: torch.Tensor         # [n_ep] int32 node indices
    neighbors: Dict[int, torch.Tensor]  # level -> [N, deg_l] int32, self-padded

    @property
    def num_items(self) -> int:
        return self.item_embs.shape[0]

    @staticmethod
    def from_artifacts(art, item_embs: np.ndarray, item_ids: np.ndarray,
                       dtype=torch.float32, reorder: str = None,
                       device="cuda") -> "SearchIndex":
        """Packed artifacts (index.load_index) + catalogue -> device tensors
        (beam.py:108-137).

        dtype is the item table's: float32, bfloat16, or "int8" (or
        torch.int8), which packs each row as symmetric int8 values and its
        float32 scale, int8 [N, d+4] (index/quantize.py); the frontier
        scorer dequantizes the gathered rows to the compute type.

        reorder="bfs" relabels the nodes in breadth-first order from the
        enter points (index/reorder.py) before the table is packed."""
        if reorder not in (None, "bfs"):
            raise ValueError(f"reorder must be None or 'bfs', got {reorder!r}")
        dev = resolve_device(device)
        enter, neigh = np.asarray(art.enter_points), art.neighbors
        item_embs = np.asarray(item_embs, np.float32)
        item_ids = np.asarray(item_ids)
        if reorder == "bfs":
            order = bfs_order(neigh[0], enter, item_embs.shape[0])
            enter, neigh, item_embs, item_ids = relabel(
                enter, neigh, item_embs, item_ids, order)
        if dtype in ("int8", torch.int8):
            embs = pack_quantized(item_embs).to(dev)
        else:
            embs = torch.as_tensor(item_embs).to(dev, dtype).contiguous()
        return SearchIndex(
            item_embs=embs,
            item_ids=torch.as_tensor(item_ids.astype(np.int32)).to(dev),
            enter_points=torch.as_tensor(enter.astype(np.int32)).to(dev),
            neighbors={l: torch.as_tensor(np.asarray(v, np.int32)).to(dev)
                       for l, v in neigh.items()},
        )


def level_topn_default(scfg: SearchConfig, semantics: str = None) -> np.ndarray:
    """The default runtime search budget (beam.py:140-159).

    serving layout: [k_start, k per level start-1..1, k per level-0 hop, k_final]
    eval layout:    [k_start, k per level start-1..0, k_final]"""
    semantics = semantics or scfg.semantics
    ks = [scfg.top_k_per_level[scfg.hnsw_start_level]]
    if semantics == "serving":
        for level in range(scfg.hnsw_start_level - 1, 0, -1):
            ks.append(scfg.top_k_per_level[level])
        ks.extend([scfg.top_k_per_level[0]] * scfg.num_scoring_per_level[0])
    else:
        for level in range(scfg.hnsw_start_level - 1, -1, -1):
            ks.append(scfg.top_k_per_level[level])
    ks.append(max(scfg.topk_eval))
    return np.asarray(ks, np.int32)


def _masked_topk(ids: torch.Tensor, scores: torch.Tensor, k_static: int,
                 k_runtime: int, sentinel: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis at a static width, with the runtime budget
    applied as a mask (beam.py:172-183). Ties go to the lower index, as
    lax.top_k breaks them: a stable descending sort, not torch.topk."""
    k = min(k_static, ids.shape[-1])
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    top_scores = scores.gather(-1, order)
    top_ids = ids.gather(-1, order)
    live = torch.arange(k, device=ids.device) < k_runtime
    return (torch.where(live, top_ids, sentinel),
            torch.where(live, top_scores, NEG_INF))


def _select_fresh(key: torch.Tensor, salt: int, f_cap: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compaction to the scoring cap (beam.py:186-222, exact branch): the
    smallest f_cap salted keys. Keys are an XOR bijection of the ids, so the
    truncation of an overflowing hop is pseudo-random, not biased to low ids;
    the second XOR recovers the ids. Returns (fresh ids [B, f_cap], whose
    invalid slots hold n, and fresh_valid [B, f_cap])."""
    fresh_key = torch.sort(key, dim=-1).values[..., :f_cap]
    fresh_valid = fresh_key != IMAX
    return torch.where(fresh_valid, fresh_key ^ salt, n), fresh_valid


class ListBackend:
    """The visited set as an unordered id list (beam.py:326-409).

    Membership, in-frontier dedup and the union are computed by ONE sort over
    tagged keys, 2*id (visited, even) and 2*id+1 (frontier, odd): a frontier
    key directly after its even twin is visited, equal adjacent odd keys are
    duplicates. Keys need n < 2^30 in int32."""

    PAD = 2**31 - 1

    @staticmethod
    def vis_reset_mark(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Level entry: the visited list becomes the level's candidates."""
        return torch.where(valid, ids.int(), ListBackend.PAD)

    @staticmethod
    def dedup_filter_mark(vis: torch.Tensor, nb: torch.Tensor, n: int,
                          salt: int, f_cap: int):
        """vis [B, V] visited list, nb [B, M] flattened expansion (invalid
        entries = n) -> (fresh [B, f_cap], fresh_valid, new vis,
        num_fresh [B] capped at f_cap)."""
        if n >= 2**30:
            raise ValueError(f"tagged keys need n < 2^30, got {n}")
        # clamp before doubling so pad entries cannot overflow int32
        key_vis = torch.where(vis < n, vis.clamp(max=n) * 2, K_PAD_V)
        key_nb = torch.where(nb < n, nb.clamp(max=n) * 2 + 1, IMAX)
        merged = torch.sort(torch.cat([key_vis, key_nb], dim=-1), dim=-1).values
        prev = torch.cat([torch.full_like(merged[:, :1], -1), merged[:, :-1]],
                         dim=-1)
        is_nb = (merged & 1) == 1
        real = merged < K_PAD_V
        first = merged != prev            # dedup: equal odd keys are adjacent
        visited = prev == merged - 1      # the even twin sorts directly before
        fresh_mask = is_nb & real & first & ~visited
        num_fresh = fresh_mask.sum(-1)

        # logical shift: clear what an arithmetic shift copies of the sign bit
        ids = (merged >> 1) & 0x7FFFFFFF
        key = torch.where(fresh_mask, ids ^ salt, IMAX)
        fresh, fresh_valid = _select_fresh(key, salt, f_cap, n)
        # mark_policy="scored": exactly the selected (scored) nodes join the
        # list, which grows by f_cap per hop; its order is irrelevant, the
        # next hop re-sorts
        new_vis = torch.cat(
            [vis, torch.where(fresh_valid, fresh, ListBackend.PAD)], dim=-1)
        return fresh, fresh_valid, new_vis, num_fresh.clamp(max=f_cap)


def filter_expand(be: ListBackend, neighbors_l: torch.Tensor, vis: torch.Tensor,
                  cand_ids: torch.Tensor, cand_scores: torch.Tensor, f_cap: int,
                  n: int, salt: int):
    """The filter half of one hop (beam.py:225-247): neighbor expansion of
    the live candidates -> dedup + visited test + mark -> compaction to f_cap.
    Returns (fresh [B, f_cap], fresh_valid, vis, num_fresh [B])."""
    valid_cand = cand_scores > NEG_INF
    nb = neighbors_l[cand_ids.long().clamp(0, neighbors_l.shape[0] - 1)]
    nb = torch.where(valid_cand[..., None], nb, n).reshape(nb.shape[0], -1)
    return be.dedup_filter_mark(vis, nb, n, salt, min(f_cap, nb.shape[1]))


def hop_salt(mix: int, n: int, f_cap: int) -> int:
    """Per-hop truncation salt (beam.py:518-519); 0 when nothing overflows."""
    return (SALT_MULT * (mix + 1)) & 0x3FFFFFFF if n > f_cap else 0


def make_searcher(mcfg: ModelConfig, scfg: SearchConfig, *,
                  scorer_impl: str = "kernel"):
    """Build the batched search.

    Returns search_eval(params, state, index, user_seq_emb, level_topn):
        user_seq_emb [B, L, d_user], level_topn int vector (level_topn_default)
        -> (top item ids [B, k_final] int32 (-1 = empty slot),
            top scores [B, k_final] float32,
            num_scoring [B, 1 + hops] int32: rows scored per hop, enter
            points first)

    scorer_impl "kernel" scores through `score_frontier` (the CUDA kernel on
    the card, its plain version on the CPU); "plain" always runs the plain
    version, which is what the kernel path is held against on the card."""
    scfg.check_ported()
    if scorer_impl not in ("kernel", "plain"):
        raise ValueError(f"scorer_impl must be 'kernel' or 'plain', "
                         f"got {scorer_impl!r}")
    score_fn = score_frontier if scorer_impl == "kernel" else \
        frontier_scorer_plain
    be = ListBackend()
    dt = torch_dtype(mcfg.compute_dtype)
    start = scfg.hnsw_start_level
    k_start_cap = scfg.top_k_per_level[start]
    k_final_cap = max(max(scfg.topk_eval), 1)

    def search_eval(params: Params, state: State, index: SearchIndex,
                    user_seq_emb: torch.Tensor, level_topn):
        """Eval-graph semantics: per level, merged top-k results; the next
        hop's candidates are the fresh nodes scoring >= the current k-th."""
        ltn = [int(x) for x in np.asarray(level_topn).reshape(-1)]
        dev = index.item_embs.device
        user = user_seq_emb.to(dev)
        B = user.shape[0]
        folded = fold_scorer(params, state, mcfg)
        k_proj, v = precompute_user(folded, user, dt)
        weights = kernel_weights(folded, dt)

        def score(ids, valid):
            return score_fn(weights, k_proj, v, index.item_embs,
                            ids.contiguous(), valid.contiguous())

        n = index.num_items
        ep = index.enter_points[None].expand(B, -1)
        ep_scores = score(ep, torch.ones(ep.shape, dtype=torch.bool, device=dev))
        num_scoring = [torch.full((B,), ep.shape[1], dtype=torch.int32,
                                  device=dev)]
        res_ids, res_scores = _masked_topk(ep, ep_scores, k_start_cap, ltn[0], n)

        t = 1
        for level in range(start - 1, -1, -1):
            vis = be.vis_reset_mark(res_ids, res_scores > NEG_INF)
            cand_ids, cand_scores = res_ids, res_scores
            k_cap = scfg.top_k_per_level[level]
            for _ in range(scfg.num_scoring_per_level[level]):
                f_cap = scfg.frontier_cap
                fresh, fresh_valid, vis, cnt = filter_expand(
                    be, index.neighbors[level], vis, cand_ids, cand_scores,
                    f_cap, n, hop_salt(len(num_scoring), n, f_cap))
                fscores = score(fresh, fresh_valid)
                num_scoring.append(cnt.int())
                res_ids, res_scores = _masked_topk(
                    torch.cat([res_ids, fresh], dim=-1),
                    torch.cat([res_scores, fscores], dim=-1),
                    k_cap, ltn[t], n)
                # candidates: fresh nodes scoring >= the k-th result
                kth = torch.where(res_scores > NEG_INF, res_scores,
                                  float("inf")).amin(-1, keepdim=True)
                cand_ids, cand_scores = _masked_topk(fresh, fscores, k_cap,
                                                     ltn[t], n)
                live = cand_scores >= kth
                cand_ids = torch.where(live, cand_ids, n)
                cand_scores = torch.where(live, cand_scores, NEG_INF)
            t += 1

        final_ids, final_scores = _masked_topk(res_ids, res_scores, k_final_cap,
                                               ltn[-1], n)
        top_items = torch.where(
            final_scores > NEG_INF,
            index.item_ids[final_ids.long().clamp(0, n - 1)], -1)
        return top_items, final_scores, torch.stack(num_scoring, dim=-1)

    return search_eval
