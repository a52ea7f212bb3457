"""The port's batched search against the JAX package: top-k ties, the salted
truncation, the tagged-key visited list, one hop's filter, the whole
search_eval over a 2,000-item HNSW graph, and the brute-force oracle.

Ids, num_scoring and the selection helpers must match exactly. Whole
searches sum float32 products in another order than XLA, so a near-tie may
fall the other way: they must agree on most queries outright and overlap
almost entirely on the rest, with the scores of common ids within 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nann_tpu.config import SearchConfig as JSearchConfig
from nann_tpu.index import build_and_save_index, load_index as j_load_index
from nann_tpu.search import SearchIndex as JSearchIndex
from nann_tpu.search import brute_force_topk as j_brute_force
from nann_tpu.search import make_searcher as j_make_searcher
from nann_tpu.search import beam as jbeam
from nann_tpu.utils import calc_pr as j_calc_pr

from nann_tpu_torch.config import SearchConfig
from nann_tpu_torch.index import load_index
from nann_tpu_torch.kernels import select_ops
from nann_tpu_torch.models import params_from_jax
from nann_tpu_torch.search import (SearchIndex, brute_force_topk,
                                   level_topn_default, make_searcher)
from nann_tpu_torch.search import beam
from nann_tpu_torch.utils import calc_pr

from test_torch_scorer import jax_model, port_config

NUM_ITEMS = 2000
NUM_QUERIES = 32


def _jax_rows(fn, *args):
    """Run a one-query JAX function over the rows of batched numpy inputs."""
    return jax.jit(jax.vmap(fn))(*[jnp.asarray(a) for a in args])


# ---------------------------------------------------------------- unit parity


def test_masked_topk_runtime_k():
    ids = torch.tensor([[5, 6, 7, 8, 9]], dtype=torch.int32)
    scores = torch.tensor([[0.1, 0.9, 0.5, float("-inf"), 0.7]])
    top_ids, top_scores = beam._masked_topk(ids, scores, 4, 2, sentinel=99,
                                            sel=select_ops.selects())
    assert top_ids.tolist() == [[6, 9, 99, 99]]
    assert top_scores[0, 2] == float("-inf")


@pytest.mark.parametrize("k_static,k_runtime", [(8, 8), (16, 5), (64, 40)])
def test_masked_topk_ties_match_jax(k_static, k_runtime):
    """lax.top_k breaks ties toward the lower index; so must the port, with
    many equal scores and -inf entries in every row."""
    rng = np.random.default_rng(k_static)
    scores = rng.integers(0, 6, (6, 48)).astype(np.float32) / 4
    scores[rng.random(scores.shape) < 0.2] = -np.inf
    ids = rng.permutation(1000)[:48 * 6].reshape(6, 48).astype(np.int32)
    got_ids, got_scores = beam._masked_topk(
        torch.from_numpy(ids), torch.from_numpy(scores), k_static, k_runtime,
        999, sel=select_ops.selects())
    want_ids, want_scores = _jax_rows(
        lambda i, s: jbeam._masked_topk(i, s, k_static, k_runtime, 999),
        ids, scores)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_scores.numpy(), np.asarray(want_scores))


@pytest.mark.parametrize("mix,f_cap", [(1, 16), (3, 40), (0, 200)])
def test_select_fresh_matches_jax(mix, f_cap):
    """Salted keys, an overflowing frontier (more fresh ids than f_cap) and
    one that fits; the XOR salt must pick the same subset as JAX."""
    n = 5000
    salt = beam.hop_salt(mix, n, f_cap)
    assert salt == ((0x1F123BB5 * (mix + 1)) & 0x3FFFFFFF if n > f_cap else 0)
    rng = np.random.default_rng(mix)
    ids = np.stack([rng.choice(n, 120, replace=False) for _ in range(4)])
    key = np.where(rng.random(ids.shape) < 0.8, ids ^ salt,
                   beam.IMAX).astype(np.int32)
    got = beam._select_fresh(torch.from_numpy(key), salt, f_cap, n,
                             sel=select_ops.selects())
    want = _jax_rows(lambda k: jbeam._select_fresh(
        k, jnp.int32(2**31 - 1), jnp.int32(salt), f_cap, n, "exact"), key)
    for g, w in zip(got, want):      # fresh, fresh_valid, sel
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dedup_case(seed, n, width=64):
    rng = np.random.default_rng(seed)
    vis = rng.integers(0, n, (4, 50)).astype(np.int32)
    vis[rng.random(vis.shape) < 0.3] = beam.ListBackend.PAD
    nb = rng.integers(0, n, (4, width)).astype(np.int32)
    nb[:, :10] = vis[:, :10]                          # some already visited
    nb[:, 10:20] = nb[:, 20:30]                       # in-frontier duplicates
    nb[rng.random(nb.shape) < 0.1] = n                # masked expansion
    return vis, nb


@pytest.mark.parametrize("n,f_cap,mix", [(3000, 24, 2), (3000, 500, 1),
                                         (2**30 - 7, 16, 4)])
def test_dedup_filter_mark_matches_jax(n, f_cap, mix):
    """Tagged keys 2*id+tag up to n < 2^30 (the last case puts ids next to
    the limit: the logical shift must not let the int32 sign bit leak)."""
    vis, nb = _dedup_case(mix, n)
    if n > 2**29:
        vis = np.where(vis < n, n - 1 - vis % 97, vis).astype(np.int32)
        nb = np.where(nb < n, n - 1 - nb % 97, nb).astype(np.int32)
    salt = beam.hop_salt(mix, n, f_cap)
    got = beam.ListBackend().dedup_filter_mark(
        torch.from_numpy(vis), torch.from_numpy(nb), 0, n, salt, f_cap)
    be = jbeam.ListBackend()
    want = _jax_rows(lambda v, b: be.dedup_filter_mark(
        v, b, jnp.uint8(0), n, jnp.int32(salt), f_cap, "exact", "scored"),
        vis, nb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_visited_list_grows_by_f_cap():
    """mark_policy="scored": the list gains exactly the selected nodes,
    padded to f_cap, on every hop."""
    n, f_cap = 3000, 24
    vis, nb = _dedup_case(3, n)
    fresh, fresh_valid, new_vis, _ = beam.ListBackend().dedup_filter_mark(
        torch.from_numpy(vis), torch.from_numpy(nb), 0, n,
        beam.hop_salt(3, n, f_cap), f_cap)
    assert new_vis.shape == (vis.shape[0], vis.shape[1] + f_cap)
    np.testing.assert_array_equal(new_vis[:, :vis.shape[1]].numpy(), vis)
    added = new_vis[:, vis.shape[1]:]
    assert torch.equal(added[fresh_valid], fresh[fresh_valid])
    assert (added[~fresh_valid] == beam.ListBackend.PAD).all()


def test_filter_expand_matches_jax():
    n, f_cap, mix = 400, 96, 1
    rng = np.random.default_rng(7)
    neighbors = rng.integers(0, n, (n, 8)).astype(np.int32)
    cand = rng.integers(0, n, (3, 20)).astype(np.int32)
    cand_scores = rng.standard_normal((3, 20)).astype(np.float32)
    cand_scores[:, -4:] = -np.inf
    vis = np.where(rng.random((3, 20)) < 0.5, cand, beam.ListBackend.PAD
                   ).astype(np.int32)
    salt = beam.hop_salt(mix, n, f_cap)
    got = beam.filter_expand(beam.ListBackend(), torch.from_numpy(neighbors),
                             torch.from_numpy(vis), 0, torch.from_numpy(cand),
                             torch.from_numpy(cand_scores), f_cap, n, salt)
    be = jbeam.ListBackend()
    want = _jax_rows(lambda v, c, s: jbeam.filter_expand(
        be, jnp.asarray(neighbors), v, jnp.uint8(0), c, s, f_cap, n,
        jnp.int32(salt), "exact", "scored"), vis, cand, cand_scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("semantics", ["eval", "serving"])
def test_level_topn_default_matches_jax(semantics):
    np.testing.assert_array_equal(
        level_topn_default(SearchConfig(), semantics),
        jbeam.level_topn_default(JSearchConfig(), semantics))


@pytest.mark.parametrize("option,value", [("semantics", "online"),
                                          ("hop_mode", "narrow"),
                                          ("vis_impl", "bitmap"),
                                          ("topk_impl", "sorted"),
                                          ("mark_policy", "none"),
                                          ("frontier_cap_per_hop",
                                           (2048, 2048))])
def test_invalid_options_raise(option, value):
    """make_searcher validates its config: an unknown choice, or per-hop
    caps of the wrong length (the defaults have four expansion hops)."""
    mcfg = port_config(jax_model()[0])
    scfg = dataclasses.replace(SearchConfig(), **{option: value})
    with pytest.raises(ValueError):
        make_searcher(mcfg, scfg)


def test_calc_pr_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        gt, ret = rng.integers(0, 50, 20), rng.integers(0, 50, 30)
        assert calc_pr(gt, ret) == j_calc_pr(gt, ret)
    assert calc_pr(3, [1, 3]) == j_calc_pr(3, [1, 3])


# -------------------------------------------------------- whole-search parity


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    jcfg, jp, js, flat = jax_model(seed=1)
    rng = np.random.default_rng(0)
    item_embs = rng.standard_normal((NUM_ITEMS, jcfg.item_emb_dim)).astype(
        np.float32)
    item_ids = np.arange(10, NUM_ITEMS + 10)
    d = str(tmp_path_factory.mktemp("torch_search_idx"))
    build_and_save_index(item_embs, 2, 16, d, ef_construction=40)
    jidx = JSearchIndex.from_artifacts(j_load_index(d, 2), item_embs, item_ids)
    tidx = SearchIndex.from_artifacts(load_index(d, 2), item_embs, item_ids,
                                      device="cpu")
    params, state = params_from_jax(flat, device="cpu")
    users = rng.standard_normal(
        (NUM_QUERIES, jcfg.max_seq_length, jcfg.user_emb_dim)).astype(np.float32)
    return jcfg, jp, js, params, state, jidx, tidx, users, d


def run_both(graph, scfg_kw):
    jcfg, jp, js, params, state, jidx, tidx, users, _ = graph
    jscfg = JSearchConfig(**scfg_kw)
    search = jax.jit(jax.vmap(j_make_searcher(jcfg, jscfg),
                              in_axes=(None, None, None, 0, None)))
    want = search(jp, js, jidx, jnp.asarray(users),
                  jnp.asarray(jbeam.level_topn_default(jscfg)))
    scfg = SearchConfig(**scfg_kw)
    got = make_searcher(port_config(jcfg), scfg)(
        params, state, tidx, torch.from_numpy(users), level_topn_default(scfg))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def assert_search_parity(got, want, min_overlap=0.99, min_identical=0.9):
    (gi, gs, gn), (wi, ws, wn) = got, want
    assert gi.shape == wi.shape and gn.shape == wn.shape
    same = [np.array_equal(gi[q], wi[q]) and np.array_equal(gn[q], wn[q])
            for q in range(len(gi))]
    overlaps = []
    for q in range(len(gi)):
        g, w = gi[q][gi[q] >= 0], wi[q][wi[q] >= 0]
        common, g_at, w_at = np.intersect1d(g, w, return_indices=True)
        overlaps.append(len(common) / max(len(w), 1))
        np.testing.assert_allclose(gs[q][gi[q] >= 0][g_at],
                                   ws[q][wi[q] >= 0][w_at],
                                   rtol=2e-4, atol=2e-4)
    assert np.mean(overlaps) >= min_overlap, overlaps
    assert np.mean(same) >= min_identical, same


@pytest.mark.parametrize("scfg_kw", [
    {},                                                   # the shipped defaults
    {"frontier_cap": 256, "top_k_per_level": (100, 50, 20),
     "topk_eval": (50,)},                                 # truncating hops
], ids=["defaults", "cap256"])
def test_search_eval_matches_jax(graph, scfg_kw):
    got, want = run_both(graph, scfg_kw)
    if scfg_kw:
        # the cap truncates: hops overflow and the salt picks the subset
        assert (want[2][:, 1:] == 256).any()
    assert_search_parity(got, want)


def test_search_results_are_sorted_unique_and_mapped(graph):
    *_, tidx, users, _ = graph
    jcfg, _jp, _js, params, state = graph[:5]
    items, scores, ns = make_searcher(port_config(jcfg), SearchConfig())(
        params, state, tidx, torch.from_numpy(users[:4]),
        level_topn_default(SearchConfig()))
    assert items.dtype == torch.int32 and ns.dtype == torch.int32
    assert ns.shape == (4, 5)
    for row, sc in zip(items.numpy(), scores.numpy()):
        got = row[row >= 0]
        assert len(set(got.tolist())) == len(got)
        assert set(got.tolist()) <= set(range(10, NUM_ITEMS + 10))
        assert np.all(np.diff(sc[row >= 0]) <= 0)


def test_brute_force_matches_jax(graph):
    jcfg, jp, js, params, state, jidx, tidx, users, _ = graph
    want_idx, want_scores = j_brute_force(jp, js, jcfg, jnp.asarray(users[:8]),
                                          jidx.item_embs, k=100, chunk_size=512)
    got_idx, got_scores = brute_force_topk(params, state, port_config(jcfg),
                                           torch.from_numpy(users[:8]),
                                           tidx.item_embs, k=100,
                                           chunk_size=512)
    want_idx, want_scores = np.asarray(want_idx), np.asarray(want_scores)
    overlap = np.mean([len(np.intersect1d(g, w)) / 100
                       for g, w in zip(got_idx.numpy(), want_idx)])
    assert overlap >= 0.99
    np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=2e-4,
                               atol=2e-4)


def test_brute_force_pads_like_jax_when_k_exceeds_the_catalogue(graph):
    """k > n: JAX pads the catalogue to a multiple of chunk_size and takes
    the top k of the padded width, so the tail holds pad indices n, n+1, ...
    scored -inf; the port returns the same [B, k]. k beyond the padded
    width is refused, where lax.top_k fails."""
    jcfg, jp, js, params, state, jidx, tidx, users, _ = graph
    n, k = 50, 64
    want_idx, want_scores = j_brute_force(
        jp, js, jcfg, jnp.asarray(users[:2]), jidx.item_embs[:n], k=k,
        chunk_size=512)
    got_idx, got_scores = brute_force_topk(
        params, state, port_config(jcfg), torch.from_numpy(users[:2]),
        tidx.item_embs[:n].contiguous(), k=k, chunk_size=512)
    want_idx, want_scores = np.asarray(want_idx), np.asarray(want_scores)
    assert got_idx.shape == want_idx.shape == (2, k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(np.isneginf(got_scores.numpy()),
                                  np.isneginf(want_scores))
    np.testing.assert_array_equal(got_idx.numpy()[:, n:],
                                  np.broadcast_to(np.arange(n, k), (2, k - n)))
    np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(ValueError):
        brute_force_topk(params, state, port_config(jcfg),
                         torch.from_numpy(users[:2]),
                         tidx.item_embs[:n].contiguous(), k=65, chunk_size=64)


def test_search_index_from_artifacts(graph):
    *_, tidx, _users, d = graph
    art = load_index(d, 2)
    assert tidx.num_items == NUM_ITEMS
    assert tidx.item_embs.dtype == torch.float32
    assert tidx.item_ids.dtype == torch.int32
    np.testing.assert_array_equal(tidx.enter_points.numpy(), art.enter_points)
    for level, nb in art.neighbors.items():
        np.testing.assert_array_equal(tidx.neighbors[level].numpy(), nb)
    bf = SearchIndex.from_artifacts(art, np.zeros((NUM_ITEMS, 32)),
                                    np.arange(NUM_ITEMS),
                                    dtype=torch.bfloat16, device="cpu")
    assert bf.item_embs.dtype == torch.bfloat16
