"""The port's int8 index and BFS relabel against the JAX package.

Quantization, packing, unpacking and the relabel must equal JAX's bit for
bit; the int8 index's tensors must equal JAX's int8 index. The plain
frontier scorer on a packed table is held against JAX's dequantize-then-score
chain (2e-4 at float32, 0.05 at bfloat16, tests/test_scorer_kernel.py) and
against the Pallas int8 kernel in interpret mode (0.02, as
tests/test_scorer_kernel.py:78-94 runs it). At float32 compute the int8
search returns JAX's ids exactly, with and without the BFS relabel.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nann_tpu.config import SearchConfig as JSearchConfig
from nann_tpu.delivery.export import export_model as j_export_model
from nann_tpu.delivery.verify_export import \
    load_serving_bundle as j_load_serving_bundle
from nann_tpu.experimental.pallas_scorer import make_pallas_frontier_scorer
from nann_tpu.index import build_and_save_index, load_index as j_load_index
from nann_tpu.index import quantize as jq
from nann_tpu.index import reorder as jr
from nann_tpu.ops import scorer_kernel as j_sk
from nann_tpu.search import SearchIndex as JSearchIndex
from nann_tpu.search import make_searcher as j_make_searcher
from nann_tpu.search import beam as jbeam

from nann_tpu_torch.config import SearchConfig
from nann_tpu_torch.delivery import load_search_config, load_serving_bundle
from nann_tpu_torch.index import load_index
from nann_tpu_torch.index import quantize as q8
from nann_tpu_torch.index import reorder
from nann_tpu_torch.kernels import frontier_scorer as fs
from nann_tpu_torch.models import params_from_jax
from nann_tpu_torch.ops import fold_scorer, precompute_user
from nann_tpu_torch.search import (SearchIndex, brute_force_topk,
                                   level_topn_default, make_searcher)
from nann_tpu_torch.serving import Engine, EngineConfig

from test_torch_scorer import jax_model, port_config

NUM_ITEMS = 1500
NUM_QUERIES = 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 0.05}


def _embs(kind: str, n=64, d=32, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d)).astype(np.float32) * 3
    if kind == "halfway":
        # every row's max is 127, so its scale is 1 and its values fall
        # exactly half a step between two int8 levels: np.rint rounds them to
        # even
        embs = (rng.integers(-254, 255, (n, d)) / 2).astype(np.float32)
        embs[:, 0] = 127
    elif kind == "zero_rows":
        embs[::3] = 0
    return embs


def _f32(x) -> np.ndarray:
    """A JAX array or torch tensor (float32 or bfloat16) as float32 numpy;
    exact, so equal arrays mean equal bits."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------- quantize, bit exact


@pytest.mark.parametrize("kind", ["normal", "halfway", "zero_rows"])
def test_quantize_embeddings_matches_jax(kind):
    embs = _embs(kind)
    q, scales = q8.quantize_embeddings(embs)
    jq_, jscales = jq.quantize_embeddings(embs)
    assert q.dtype == np.int8 and scales.dtype == np.float32
    np.testing.assert_array_equal(q, jq_)
    np.testing.assert_array_equal(scales.view(np.int32),
                                  jscales.view(np.int32))


@pytest.mark.parametrize("kind", ["normal", "zero_rows"])
def test_pack_quantized_matches_jax(kind):
    embs = _embs(kind)
    got = q8.pack_quantized(embs)
    assert got.dtype == torch.int8 and got.shape == (64, 36)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.pack_quantized(embs)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dequantize_rows_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    q, scales = jq.quantize_embeddings(_embs("normal", seed=1))
    got = q8.dequantize_rows(torch.from_numpy(q), torch.from_numpy(scales),
                             tdt)
    want = jq.dequantize_rows(jnp.asarray(q), jnp.asarray(scales), jdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_unpack_rows_matches_jax(dt):
    """Gathered rows [B, F, d+4]: the scale bytes bitcast back to float32."""
    jdt, tdt = DTYPES[dt]
    packed = q8.pack_quantized(_embs("normal", n=100, seed=2))
    ids = np.random.default_rng(2).integers(0, 100, (3, 40))
    got = q8.unpack_rows(packed[torch.from_numpy(ids)], 32, tdt)
    want = jq.unpack_rows(jnp.take(jnp.asarray(packed.numpy()), ids, axis=0),
                          32, jdt)
    assert got.shape == (3, 40, 32)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_quantized_table_take_matches_jax():
    embs = _embs("normal", n=50, d=16, seed=3)
    ids = np.array([0, 7, 49, 7])
    table, jtable = q8.QuantizedTable(embs), jq.QuantizedTable(embs)
    assert table.shape == jtable.shape == (50, 20)
    np.testing.assert_array_equal(
        _f32(table.take(torch.from_numpy(ids), torch.bfloat16)),
        _f32(jtable.take(jnp.asarray(ids), jnp.bfloat16)))


# ------------------------------------------------------------- BFS relabel


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    jcfg, jp, js, flat = jax_model(seed=1)
    rng = np.random.default_rng(0)
    item_embs = rng.standard_normal((NUM_ITEMS, jcfg.item_emb_dim)).astype(
        np.float32)
    item_ids = np.arange(10, NUM_ITEMS + 10)
    d = str(tmp_path_factory.mktemp("torch_quantize_idx"))
    build_and_save_index(item_embs, 2, 16, d, ef_construction=40)
    params, state = params_from_jax(flat, device="cpu")
    users = rng.standard_normal(
        (NUM_QUERIES, jcfg.max_seq_length, jcfg.user_emb_dim)).astype(
            np.float32)
    return jcfg, jp, js, params, state, item_embs, item_ids, users, d


def test_bfs_order_matches_jax(graph):
    *_, d = graph
    art = j_load_index(d, 2)
    got = reorder.bfs_order(art.neighbors[0], art.enter_points, NUM_ITEMS)
    want = jr.bfs_order(art.neighbors[0], art.enter_points, NUM_ITEMS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(NUM_ITEMS))


def test_bfs_order_appends_unreached_nodes():
    neighbors0 = np.array([[1, 1], [0, 0], [2, 2], [4, 4], [3, 3]], np.int32)
    got = reorder.bfs_order(neighbors0, np.array([1]), 5)
    np.testing.assert_array_equal(got, jr.bfs_order(neighbors0, np.array([1]),
                                                    5))
    assert got.tolist() == [1, 0, 2, 3, 4]


def test_relabel_matches_jax(graph):
    *_, item_embs, item_ids, _users, d = graph
    art = j_load_index(d, 2)
    order = jr.bfs_order(art.neighbors[0], art.enter_points, NUM_ITEMS)
    got = reorder.relabel(art.enter_points, art.neighbors, item_embs,
                          item_ids, order)
    want = jr.relabel(art.enter_points, art.neighbors, item_embs, item_ids,
                      order)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert sorted(got[1]) == sorted(want[1])
    for level in want[1]:
        assert got[1][level].dtype == np.int32
        np.testing.assert_array_equal(got[1][level], want[1][level])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


# ----------------------------------------------------------- the int8 index


@pytest.mark.parametrize("reorder_kw", [None, "bfs"], ids=["plain", "bfs"])
def test_from_artifacts_int8_matches_jax(graph, reorder_kw):
    *_, item_embs, item_ids, _users, d = graph
    want = JSearchIndex.from_artifacts(j_load_index(d, 2), item_embs,
                                       item_ids, dtype="int8",
                                       reorder=reorder_kw)
    got = SearchIndex.from_artifacts(load_index(d, 2), item_embs, item_ids,
                                     dtype="int8", reorder=reorder_kw,
                                     device="cpu")
    assert got.item_embs.dtype == torch.int8
    assert got.item_embs.shape == (NUM_ITEMS, item_embs.shape[1] + 4)
    np.testing.assert_array_equal(got.item_embs.numpy(),
                                  np.asarray(want.item_embs))
    np.testing.assert_array_equal(got.item_ids.numpy(),
                                  np.asarray(want.item_ids))
    np.testing.assert_array_equal(got.enter_points.numpy(),
                                  np.asarray(want.enter_points))
    assert sorted(got.neighbors) == sorted(want.neighbors)
    for level, nb in want.neighbors.items():
        np.testing.assert_array_equal(got.neighbors[level].numpy(),
                                      np.asarray(nb))
    same = SearchIndex.from_artifacts(load_index(d, 2), item_embs, item_ids,
                                      dtype=torch.int8, reorder=reorder_kw,
                                      device="cpu")
    assert torch.equal(same.item_embs, got.item_embs)


def test_from_artifacts_rejects_unknown_reorder(graph):
    *_, item_embs, item_ids, _users, d = graph
    with pytest.raises(ValueError, match="reorder"):
        SearchIndex.from_artifacts(load_index(d, 2), item_embs, item_ids,
                                   reorder="dfs", device="cpu")


# ------------------------------------------- plain frontier scorer, packed


def _packed_case(graph, tdt, B=3, F=256, seed=4):
    jcfg, jp, js, params, state, item_embs, *_ = graph
    rng = np.random.default_rng(seed)
    user = rng.standard_normal((B, jcfg.max_seq_length,
                                jcfg.user_emb_dim)).astype(np.float32)
    ids = rng.integers(-3, NUM_ITEMS + 3, (B, F)).astype(np.int32)
    valid = rng.random((B, F)) > 0.1
    packed = q8.pack_quantized(item_embs)
    folded = fold_scorer(params, state, port_config(jcfg))
    k_proj, v = precompute_user(folded, torch.from_numpy(user), tdt)
    got = fs.score_frontier(fs.kernel_weights(folded, tdt), k_proj, v, packed,
                            torch.from_numpy(ids), torch.from_numpy(valid))
    return got, user, ids, valid, packed


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_scorer_packed_matches_jax(graph, dt):
    """The port's plain scorer on a packed table against JAX's
    score_frontier_reference(unpack_rows(take(packed)))."""
    jcfg, jp, js = graph[:3]
    jdt, tdt = DTYPES[dt]
    launches = fs.score_frontier.launches, fs.score_frontier.launches_int8
    got, user, ids, valid, packed = _packed_case(graph, tdt)
    assert (fs.score_frontier.launches,
            fs.score_frontier.launches_int8) == launches
    jf = j_sk.fold_scorer(jp, js, jcfg)
    jpacked = jnp.asarray(packed.numpy())

    @jax.jit
    @jax.vmap
    def want_fn(u, i):
        wk, wv = j_sk.precompute_user(jf, u, dt=jdt)
        rows = jq.unpack_rows(jnp.take(jpacked, jnp.clip(i, 0, NUM_ITEMS - 1),
                                       axis=0), jcfg.item_emb_dim, jdt)
        return j_sk.score_frontier_reference(jf, wk, wv, rows, dt=jdt)

    want = np.asarray(want_fn(user, ids))
    got = got.numpy()
    assert np.isneginf(got[~valid]).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL[dt],
                               atol=TOL[dt])


def test_plain_scorer_packed_matches_pallas_int8_interpret(graph):
    """The Pallas int8 kernel (packed_int8=True) dequantizes to bfloat16 in
    VMEM; the port's plain scorer at bfloat16 must agree with it."""
    jcfg, jp, js = graph[:3]
    got, user, ids, valid, packed = _packed_case(graph, torch.bfloat16, B=1)
    rows = packed[torch.from_numpy(ids[0]).long().clamp(0, NUM_ITEMS - 1)]
    d = jcfg.item_emb_dim
    q = jnp.asarray(rows[:, :d].numpy())
    scales = jnp.asarray(rows[:, d:].contiguous().view(torch.float32).numpy())
    jf = j_sk.fold_scorer(jp, js, jcfg)
    wk, wv = j_sk.precompute_user(jf, jnp.asarray(user[0]), dt=jnp.bfloat16)
    score = make_pallas_frontier_scorer(jcfg, tile=256, interpret=True,
                                        packed_int8=True)
    want = np.asarray(score(jf, wk, wv, q, scales))
    np.testing.assert_allclose(got[0].numpy()[valid[0]], want[valid[0]],
                               rtol=0.02, atol=0.02)


# ------------------------------------------------------ search and serving


@pytest.mark.parametrize("reorder_kw,cap", [(None, 4096), ("bfs", 4096),
                                            (None, 64), ("bfs", 64)],
                         ids=["plain", "bfs", "plain-cap64", "bfs-cap64"])
def test_search_int8_matches_jax(graph, reorder_kw, cap):
    """float32 compute on an int8 index: the same ids as JAX's searcher on
    its int8 index, scores within 2e-4. At frontier_cap 64 the ground hops
    overflow the cap, so the truncation of a relabelled index is held too."""
    jcfg, jp, js, params, state, item_embs, item_ids, users, d = graph
    jscfg = JSearchConfig(frontier_cap=cap)
    jidx = JSearchIndex.from_artifacts(j_load_index(d, 2), item_embs,
                                       item_ids, dtype="int8",
                                       reorder=reorder_kw)
    search = jax.jit(jax.vmap(j_make_searcher(jcfg, jscfg),
                              in_axes=(None, None, None, 0, None)))
    wi, ws, wn = (np.asarray(x) for x in search(
        jp, js, jidx, jnp.asarray(users),
        jnp.asarray(jbeam.level_topn_default(jscfg))))
    scfg = SearchConfig(frontier_cap=cap)
    tidx = SearchIndex.from_artifacts(load_index(d, 2), item_embs, item_ids,
                                      dtype="int8", reorder=reorder_kw,
                                      device="cpu")
    gi, gs, gn = (x.numpy() for x in make_searcher(port_config(jcfg), scfg)(
        params, state, tidx, torch.from_numpy(users),
        level_topn_default(scfg)))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gs, ws, rtol=2e-4, atol=2e-4)
    assert (gn.max() == cap) == (cap == 64)


def test_brute_force_rejects_int8(graph):
    jcfg, _jp, _js, params, state, item_embs, *_ = graph
    with pytest.raises(TypeError, match="int8"):
        brute_force_topk(params, state, port_config(jcfg),
                         torch.zeros((1, jcfg.max_seq_length,
                                      jcfg.user_emb_dim)),
                         q8.pack_quantized(item_embs))


@pytest.fixture(scope="module")
def int8_bundle(graph, tmp_path_factory):
    jcfg, jp, js, _params, _state, item_embs, item_ids, _users, d = graph
    jscfg = JSearchConfig(top_k_per_level=(200, 100, 50), topk_eval=(100,))
    bundle = str(tmp_path_factory.mktemp("torch_int8_bundle") / "bundle")
    j_export_model(bundle, jp, js, jcfg, jscfg, item_ids=item_ids,
                   item_embs=item_embs, index_dir=d)
    return bundle, jscfg


def test_load_serving_bundle_int8_matches_jax(int8_bundle):
    bundle, jscfg = int8_bundle
    *_, jidx = j_load_serving_bundle(bundle, jscfg, dtype="int8")
    *_, index = load_serving_bundle(bundle, dtype="int8", device="cpu")
    assert index.item_embs.dtype == torch.int8
    np.testing.assert_array_equal(index.item_embs.numpy(),
                                  np.asarray(jidx.item_embs))
    np.testing.assert_array_equal(index.item_ids.numpy(),
                                  np.asarray(jidx.item_ids))


def test_engine_serves_int8_bundle(int8_bundle, graph):
    """The engine on an int8 bundle answers each request as the direct
    search of the same int8 index does."""
    bundle, _ = int8_bundle
    users = graph[7]
    params, state, mcfg, index = load_serving_bundle(bundle, dtype="int8",
                                                     device="cpu")
    scfg = load_search_config(bundle)
    items, scores, _ = (x.numpy() for x in make_searcher(mcfg, scfg)(
        params, state, index, torch.from_numpy(users),
        level_topn_default(scfg)))
    engine = Engine(mcfg, scfg, params, state, index,
                    EngineConfig(batch_buckets=(1, 4, 16), wait_ms=2.0))
    try:
        futures = [engine.submit(u) for u in users]
        answers = [f.result(timeout=60) for f in futures]
    finally:
        engine.shutdown()
    for i, (got_items, got_scores) in enumerate(answers):
        live = items[i] >= 0
        np.testing.assert_array_equal(got_items, items[i][live])
        np.testing.assert_array_equal(got_scores, scores[i][live])


# ---------------------------------------------- what the kernel's wrapper takes


@pytest.fixture
def weights(graph):
    jcfg, _jp, _js, params, state = graph[:5]
    folded = fold_scorer(params, state, port_config(jcfg))
    k_proj, v = precompute_user(folded, torch.zeros((2, 12, 32)),
                                torch.float32)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    valid = torch.ones((2, 8), dtype=torch.bool)
    return fs.kernel_weights(folded, torch.float32), k_proj, v, ids, valid


def test_check_takes_a_packed_table(weights):
    w, k_proj, v, ids, valid = weights
    fs._check(w, k_proj, v, torch.zeros((10, 36), dtype=torch.int8), ids,
              valid)
    fs._check(w, k_proj, v, torch.zeros((10, 32)), ids, valid)


def test_check_rejects_a_packed_table_of_the_wrong_width(weights):
    w, k_proj, v, ids, valid = weights
    for width in (32, 35, 40):
        with pytest.raises(ValueError, match="D\\+4"):
            fs._check(w, k_proj, v, torch.zeros((10, width), dtype=torch.int8),
                      ids, valid)


def test_check_rejects_d_not_a_multiple_of_4(weights):
    w, k_proj, v, ids, valid = weights
    w = dict(w, q1_k=w["q1_k"][:30].contiguous())
    with pytest.raises(ValueError, match="D % 4"):
        fs._check(w, k_proj, v, torch.zeros((10, 34), dtype=torch.int8), ids,
                  valid)


def test_check_rejects_a_misaligned_packed_table(weights):
    w, k_proj, v, ids, valid = weights
    buf = torch.zeros(10 * 36 + 1, dtype=torch.int8)
    table = buf[1:].view(10, 36)
    assert table.is_contiguous() and table.data_ptr() % 4
    with pytest.raises(ValueError, match="aligned"):
        fs._check(w, k_proj, v, table, ids, valid)


def test_check_rejects_a_float_table_of_another_type(weights):
    w, k_proj, v, ids, valid = weights
    with pytest.raises(TypeError, match="packed int8"):
        fs._check(w, k_proj, v, torch.zeros((10, 32), dtype=torch.bfloat16),
                  ids, valid)


class _FakeLib:
    """Stands in for the kernel library: only its struct-layout exports."""

    def __init__(self, size=None, storage_offset=None):
        size = size or ctypes.sizeof(fs.FrontierScorerArgs)
        offset = storage_offset or fs.FrontierScorerArgs.storage.offset
        self.nann_scorer_args_size = lambda: size
        self.nann_scorer_args_storage_offset = lambda: offset


def test_struct_guard_passes_the_same_layout():
    fs.check_struct(_FakeLib())


@pytest.mark.parametrize("layout", [{"size": 256}, {"storage_offset": 252}],
                         ids=["size", "storage_offset"])
def test_struct_guard_raises_on_another_layout(layout):
    """Dropping `storage` from one side keeps the size (tail padding) but
    moves the last field's offset; a field added in the middle changes the
    size."""
    with pytest.raises(RuntimeError, match="differs"):
        fs.check_struct(_FakeLib(**layout))


def test_args_struct_ends_with_the_type_and_storage_fields():
    names = [f[0] for f in fs.FrontierScorerArgs._fields_]
    assert names[-2:] == ["dtype", "storage"]
    assert ctypes.sizeof(fs.FrontierScorerArgs) == 264
    assert fs.FrontierScorerArgs.storage.offset == 260
