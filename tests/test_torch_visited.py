"""The byte-map visited backend of the port against the JAX package: the
plain versions of the gather and scatter kernels against the TPU probe
kernels they replace (scripts/probe_kernel_ops.py), the wrappers' checks,
the fresh-node selection of every topk_impl, and one hop's dedup, visited
test and mark on both backends, visited bytes included.

The probe script cannot be imported (it runs its probes from main() and
prints the devices at import), so each probe body is restated here and run
through `pl.pallas_call(..., interpret=True)` as the probe builds it.
`build_gather_2d`'s body does not trace (its take_along_axis pairs a 3-D
table with 2-D indices, which the test shows); its function, `t[i // 128,
i % 128]`, the probe's own check (`tab[idx]`), runs as a jnp expression.

Everything is integer data, so everything compares exactly, except where
topk_impl="approx" truncates: JAX's CPU stand-in for approx_min_k sorts the
float32 keys without a stable order, so of the equal floats at the cut it
may take others than the port, which takes the lower index first.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nann_tpu.search import beam as jbeam

from nann_tpu_torch.kernels import select_ops
from nann_tpu_torch.kernels import visited_ops as vo
from nann_tpu_torch.search import beam

N_ITEMS = 200_064        # the probe's table, a multiple of 128
EXPAND = 12_800          # the probe's ids: 400 candidates x 32 neighbours


@pytest.fixture(scope="module")
def probe():
    """The probe's inputs (probe_kernel_ops.py:169-172), from its seed."""
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 250, size=(N_ITEMS,)).astype(np.int32)
    idx = rng.integers(0, N_ITEMS, size=(EXPAND,)).astype(np.int32)
    return tab, tab.reshape(-1, 128), idx, idx.reshape(-1, 128)


def _interpret(kern, out_shape, *args):
    """The probe's pallas_call, whole arrays in VMEM, in interpret mode."""
    call = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(jax.jit(call)(*[jnp.asarray(a) for a in args]))


def test_gather_elems_matches_build_gather_flat(probe):
    tab, tab2d, _idx, idx2d = probe

    def kern(tab_ref, idx_ref, out_ref):            # probe_kernel_ops.py:174
        t = tab_ref[:].reshape(-1)
        i = idx_ref[:].reshape(-1)
        out_ref[:] = jnp.take(t, i).reshape(out_ref.shape)

    want = _interpret(kern, idx2d.shape, tab2d, idx2d)
    got = vo.gather_elems(torch.from_numpy(tab), torch.from_numpy(idx2d),
                          N_ITEMS - 1)
    assert got.dtype == torch.int32 and got.shape == idx2d.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.reshape(-1), tab[idx2d.reshape(-1)])


def test_gather_elems_matches_build_gather_2d(probe):
    tab, tab2d, _idx, idx2d = probe

    def kern(tab_ref, idx_ref, out_ref):            # probe_kernel_ops.py:249
        t = tab_ref[:]
        i = idx_ref[:]
        out_ref[:] = jnp.take_along_axis(
            jnp.take(t, i // 128, axis=0), (i % 128)[..., None].reshape(
                i.shape[0], 128), axis=1)

    with pytest.raises(ValueError, match="same number of dimensions"):
        _interpret(kern, idx2d.shape, tab2d, idx2d)
    # the row gather then the lane select, ranks matched
    want = np.asarray(jax.jit(lambda t, i: jnp.take_along_axis(
        jnp.take(t, i // 128, axis=0), (i % 128)[..., None], axis=2)[..., 0])(
            jnp.asarray(tab2d), jnp.asarray(idx2d)))
    got = vo.gather_elems(torch.from_numpy(tab2d).reshape(-1),
                          torch.from_numpy(idx2d), N_ITEMS - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.reshape(-1), tab[idx2d.reshape(-1)])


def test_gather_rows_matches_build_gather_rows(probe):
    _tab, tab2d, _idx, idx2d = probe

    def kern(tab_ref, idx_ref, out_ref):            # probe_kernel_ops.py:235
        rows = idx_ref[:, 0] // 128
        out_ref[:] = jnp.take(tab_ref[:], rows, axis=0)

    want = _interpret(kern, (idx2d.shape[0], 128), tab2d, idx2d)
    got = vo.gather_rows(torch.from_numpy(tab2d),
                         torch.from_numpy(idx2d[:, 0] // 128))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_set_matches_build_scatter(probe):
    """The probe draws its ids with replacement: duplicates all store 7."""
    tab, tab2d, idx, idx2d = probe
    assert len(np.unique(idx)) < len(idx)

    def kern(tab_ref, idx_ref, out_ref):            # probe_kernel_ops.py:199
        t = tab_ref[:].reshape(-1)
        i = idx_ref[:].reshape(-1)
        out_ref[:] = t.at[i].set(7, unique_indices=True).reshape(
            out_ref.shape)

    want = _interpret(kern, tab2d.shape, tab2d, idx2d)
    table = torch.from_numpy(tab.copy())
    got = vo.scatter_set(table, torch.from_numpy(idx2d), 7)
    assert got is table                              # in place
    np.testing.assert_array_equal(got.numpy().reshape(tab2d.shape), want)


# -------------------------------------------------- the wrappers on the CPU


def test_gather_elems_clips_like_jax():
    """Per-query uint8 rows clipped to n (vis_unvisited) and a shared int32
    row clipped to n - 1 (take_ids), ids past both ends."""
    rng = np.random.default_rng(1)
    n = 50
    vis = rng.integers(0, 256, (3, n + 7)).astype(np.uint8)
    item_ids = rng.integers(0, 10**6, n).astype(np.int32)
    ids = rng.integers(-20, n + 20, (3, 40)).astype(np.int32)
    got = vo.gather_elems(torch.from_numpy(vis), torch.from_numpy(ids), n)
    want = jax.vmap(lambda v, i: jnp.take(v, jnp.clip(i, 0, n)))(
        jnp.asarray(vis), jnp.asarray(ids))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = vo.gather_elems(torch.from_numpy(item_ids), torch.from_numpy(ids),
                          n - 1)
    want = jnp.take(jnp.asarray(item_ids), jnp.clip(jnp.asarray(ids), 0,
                                                    n - 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_clips_like_jax():
    rng = np.random.default_rng(2)
    table = rng.integers(0, 1000, (30, 32)).astype(np.int32)
    ids = rng.integers(-5, 35, (4, 9)).astype(np.int32)
    got = vo.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    be = jbeam.LocalBackend()
    want = be.take_rows(jnp.asarray(table), jnp.asarray(ids), 30)
    assert got.shape == (4, 9, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_set_per_query_rows_and_dropped_ids():
    """Each query writes its own row; ids past the row's end are dropped,
    as a JAX scatter drops them."""
    rng = np.random.default_rng(3)
    vis = np.full((3, 40), 255, np.uint8)
    ids = rng.integers(0, 48, (3, 12)).astype(np.int32)
    got = vo.scatter_set(torch.from_numpy(vis.copy()), torch.from_numpy(ids),
                         2)
    want = jax.vmap(lambda v, i: v.at[i].set(jnp.uint8(2)))(
        jnp.asarray(vis), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (ids >= 40).any()


@pytest.mark.parametrize("case", ["table_type", "ids_type", "batch", "hi",
                                  "strided", "rows_type", "value"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    vis = torch.zeros((2, 10), dtype=torch.uint8)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    calls = {
        "table_type": (TypeError, lambda: vo.gather_elems(vis.long(), ids, 5)),
        "ids_type": (TypeError, lambda: vo.gather_elems(vis, ids.long(), 5)),
        "batch": (ValueError, lambda: vo.scatter_set(vis, ids[:1], 1)),
        "hi": (ValueError, lambda: vo.gather_elems(vis, ids, 10)),
        "strided": (ValueError, lambda: vo.gather_elems(
            torch.zeros((2, 20), dtype=torch.uint8)[:, ::2], ids, 5)),
        "rows_type": (TypeError, lambda: vo.gather_rows(vis, ids)),
        "value": (ValueError, lambda: vo.scatter_set(vis, ids, 256)),
    }
    error, call = calls[case]
    with pytest.raises(error):
        call()


def test_cpu_tensors_launch_nothing():
    before = (vo.gather_elems.launches, vo.gather_rows.launches,
              vo.scatter_set.launches)
    vis = torch.zeros((2, 10), dtype=torch.uint8)
    ids = torch.ones((2, 4), dtype=torch.int32)
    vo.gather_elems(vis, ids, 9)
    vo.scatter_set(vis, ids, 3)
    vo.gather_rows(torch.zeros((5, 32), dtype=torch.int32), ids)
    assert (vo.gather_elems.launches, vo.gather_rows.launches,
            vo.scatter_set.launches) == before


class _FakeLib:
    """The two layout functions of a built library, with chosen answers."""

    def __init__(self, size=None, offset=None):
        size = size or ctypes.sizeof(vo.VisitedArgs)
        offset = offset or vo.VisitedArgs.elem_size.offset
        self.nann_visited_args_size = lambda: size
        self.nann_visited_args_elem_size_offset = lambda: offset


def test_struct_guard_passes_the_same_layout():
    vo.check_struct(_FakeLib())


@pytest.mark.parametrize("layout", [{"size": 88}, {"offset": 72}],
                         ids=["size", "last_offset"])
def test_struct_guard_raises_on_another_layout(layout):
    with pytest.raises(RuntimeError, match="differs"):
        vo.check_struct(_FakeLib(**layout))


def test_args_struct_layout():
    """Nine 8-byte fields, then the 4-byte value and element size."""
    assert ctypes.sizeof(vo.VisitedArgs) == 80
    assert vo.VisitedArgs.value.offset == 72
    assert vo.VisitedArgs.elem_size.offset == 76


# ------------------------------------------- the element kernels' launch plan

# (label, op, element bytes, B, M, per query, span, path) at the search's
# shapes on chip_smoke's workload (100,000 items, trash 400 x 64, B = 64)
_PATH_PLANS = [
    ("vis_unvisited", "gather", 1, 64, 25_600, True, 100_001, "global"),
    ("vis_mark, filtered hop", "scatter", 1, 64, 25_600, True, 125_600,
     "global"),
    ("vis_mark, wide hop", "scatter", 1, 64, 8_192, True, 125_600, "global"),
    ("vis_reset_mark", "scatter", 1, 64, 400, True, 125_600, "global"),
    ("lane gather, _masked_topk ids", "gather", 4, 64, 400, True, 4_496,
     "global"),
    ("lane gather, approx keys", "gather", 4, 64, 4_096, True, 33_992,
     "global"),
    ("lane gather, wide neighbours", "gather", 4, 64, 8_192, True, 25_600,
     "staged"),
    ("take_ids", "gather", 4, 1, 64 * 200, False, 100_000, "global"),
    ("probe build_gather_flat", "gather", 4, 1, 12_800, False, 200_064,
     "global"),
    ("probe build_scatter", "scatter", 4, 1, 12_800, False, 200_064,
     "global"),
]


def _plan(op, sz, B, M, per_query, span, sms=vo.H100_SMS):
    return vo._visited_plan(op == "scatter", sz, B, M, per_query, span, sms)


def _staged_smem(span_bytes, M):
    def copy(n):
        return -(-n // 16) * 16 + 16
    return vo.BARRIER_BYTES + copy(span_bytes) + copy(4 * M)


@pytest.mark.parametrize("case", _PATH_PLANS, ids=[c[0] for c in _PATH_PLANS])
def test_visited_plan_at_the_path_shapes(case):
    """The path the search's shapes take, and what each path's plan holds:
    a staged plan one block of STAGE_THREADS a query row, its shared bytes
    the barrier, the span and the row of ids, each padded to 16 bytes and
    one 16-byte unit more; a global plan one resident wave of 256-thread
    blocks at most, no more blocks a row than its ids fill."""
    _label, op, sz, B, M, per_query, span, path = case
    p = _plan(op, sz, B, M, per_query, span)
    assert p.path == path
    if path == "staged":
        assert p == vo.VisitedPlan("staged", (1, B), vo.STAGE_THREADS,
                                   _staged_smem(span * sz, M))
        assert p.smem_bytes <= vo.BLOCK_SMEM
    else:
        gx, gy = p.grid
        assert (p.threads, p.smem_bytes) == (vo.THREADS, 0)
        assert gy == min(B, vo.MAX_GRID_Y)
        waves = vo.SCATTER_WAVES if op == "scatter" else vo.GATHER_WAVES
        assert gx * gy <= vo.H100_SMS * vo.WAVE_BLOCKS_PER_SM * waves + gy
        assert (gx - 1) * vo.THREADS < M


def test_visited_plan_stages_only_the_clip_span():
    """A staged gather stages [0, hi] of its row, not what lies past hi."""
    table = torch.zeros((64, 25_600), dtype=torch.int32)
    ids = torch.zeros((64, 8_192), dtype=torch.int32)
    whole = vo.visited_plan("gather", table, ids, 25_599)
    part = vo.visited_plan("gather", table, ids, 15_999)
    assert whole.path == part.path == "staged"
    assert whole.smem_bytes - part.smem_bytes == 4 * 9_600


def _bench_visited():
    """scripts/bench_visited.py, whose `plan_bounds` lists the shapes on
    each side of every bound of the plan."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "bench_visited.py")
    spec = importlib.util.spec_from_file_location("bench_visited", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (label, rows, ids a row, span, staged): int32 gathers on each side of
# every bound of the staged path on 132 SMs
_BOUNDS = _bench_visited().plan_bounds(vo, vo.H100_SMS)


@pytest.mark.parametrize("case", _BOUNDS, ids=[c[0] for c in _BOUNDS])
def test_visited_plan_bounds(case):
    """Each side of every bound of the staged path: the cost ratio, the
    least ids of a launch, one row an SM, shared memory. Only a gather of
    int32 rows, one per query, is ever staged; no plan asks for more shared
    memory than a block has."""
    _label, B, M, span, staged = case
    p = _plan("gather", 4, B, M, True, span)
    assert p.path == ("staged" if staged else "global")
    assert p.smem_bytes <= vo.BLOCK_SMEM
    if staged:
        assert p.smem_bytes == _staged_smem(span * 4, M)
    if _label == "span and ids filling shared memory":
        assert p.smem_bytes == vo.BLOCK_SMEM
    for op, sz, per_query in (("gather", 4, False), ("gather", 1, True),
                              ("scatter", 4, True), ("scatter", 1, True)):
        assert _plan(op, sz, B, M, per_query, span).path == "global"


@pytest.mark.parametrize("B", [1, 3, 64, 1000, 70_000])
@pytest.mark.parametrize("M", [1, 3, 4, 400, 25_600, 1_000_000])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("op", ["gather", "scatter"])
def test_visited_plan_global_grid(B, M, sms, op):
    """The global path's grid: GATHER_WAVES (SCATTER_WAVES) resident waves
    of the device's SMs at most (WAVE_BLOCKS_PER_SM blocks an SM, rounded up
    to whole rows), at least one block a row, and no more blocks a row than
    its ids fill at one a thread; past MAX_GRID_Y rows, the grid's rows
    stride over the rest."""
    p = _plan(op, 4, B, M, False, 10**9, sms)
    gx, gy = p.grid
    waves = vo.SCATTER_WAVES if op == "scatter" else vo.GATHER_WAVES
    wave = sms * vo.WAVE_BLOCKS_PER_SM * waves
    assert p.path == "global" and gy == min(B, vo.MAX_GRID_Y) and gx >= 1
    assert gx == min(-(-wave // gy), -(-M // vo.THREADS))


# --------------------------------------------------- one hop, both backends


def _jax_rows(fn, *args):
    return jax.jit(jax.vmap(fn))(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("topk_impl", ["exact", "topk", "approx"])
@pytest.mark.parametrize("f_cap", [24, 60], ids=["overflow", "fits"])
def test_select_fresh_matches_jax(topk_impl, f_cap):
    """fresh, fresh_valid and the selected positions `sel`, at a cap that
    the fresh keys overflow and one they fit under (both below the key
    count, so "topk" and "approx" select)."""
    n, mix = 5000, 2
    salt = beam.hop_salt(mix, n, f_cap)
    rng = np.random.default_rng(f_cap)
    ids = np.stack([rng.choice(n, 90, replace=False) for _ in range(4)])
    live = rng.random(ids.shape) < (0.8 if f_cap == 24 else 0.5)
    key = np.where(live, ids ^ salt, beam.IMAX).astype(np.int32)
    got = [g.numpy() for g in beam._select_fresh(
        torch.from_numpy(key), salt, f_cap, n, topk_impl,
        sel=select_ops.selects())]
    want = [np.asarray(w) for w in _jax_rows(lambda k: jbeam._select_fresh(
        k, jnp.int32(2**31 - 1), jnp.int32(salt), f_cap, n, topk_impl), key)]
    if topk_impl != "approx":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    _assert_approx_selection(key, f_cap, salt, got, want)


def _assert_approx_selection(key, f_cap, salt, got, want):
    """The port takes the f_cap smallest float32 keys, the lower index first
    among equal floats; JAX's selection may differ only among the keys equal
    (as float32) to the f_cap-th smallest."""
    (gf, gv, gs), (wf, wv, ws) = got, want
    keyf = key.astype(np.float32)
    for q in range(key.shape[0]):
        ki = np.argsort(keyf[q], kind="stable")[:f_cap]
        np.testing.assert_array_equal(gs[q], np.isin(np.arange(key.shape[1]),
                                                     ki) & (key[q] != beam.IMAX))
        np.testing.assert_array_equal(gf[q][gv[q]], key[q][ki][gv[q]] ^ salt)
        assert gv[q].sum() == wv[q].sum()
        edge = keyf[q][ki[-1]]
        differ = np.flatnonzero(gs[q] != ws[q])
        assert (keyf[q][differ] == edge).all()


def _bytemap_case(seed, n, B=4, width=64, trash=80):
    """A byte-map [B, n + trash] stamped with epochs 0 (this level), 1 (an
    earlier level) and 255, and an expansion with visited nodes,
    in-frontier duplicates and masked entries."""
    rng = np.random.default_rng(seed)
    vis = rng.choice(np.array([0, 1, 255], np.uint8), (B, n + trash),
                     p=[0.3, 0.3, 0.4])
    nb = rng.integers(0, n, (B, width)).astype(np.int32)
    nb[:, 10:20] = nb[:, 20:30]                       # in-frontier duplicates
    nb[rng.random(nb.shape) < 0.1] = n                # masked expansion
    return vis, nb


def _assert_hop_matches(got, want, salt, approx, exact_vis):
    """(fresh, fresh_valid, vis, num_fresh) of the port against JAX's.

    Under approx, the counts and fresh_valid agree exactly; the fresh ids
    agree as a set, except for ids whose salted key equals, as a float32,
    the largest key taken (the cut among equal floats), and the visited
    state differs only at those ids; `exact_vis` holds it exactly where the
    selection does not reach it (mark_policy="all")."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    if not approx:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    (gf, gv, g_vis, gn), (wf, wv, w_vis, wn) = got, want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gn, wn)
    for q in range(len(gf)):
        g, w = set(gf[q][gv[q]].tolist()), set(wf[q][wv[q]].tolist())
        cut = np.float32(max(i ^ salt for i in g))
        tied = {i for i in g | w if np.float32(i ^ salt) == cut}
        assert g ^ w <= tied, (g ^ w, tied)
        if exact_vis:
            np.testing.assert_array_equal(g_vis[q], w_vis[q])
        elif g_vis.dtype == np.uint8:
            assert set(np.flatnonzero(g_vis[q] != w_vis[q]).tolist()) <= tied
        else:
            assert set(g_vis[q].tolist()) ^ set(w_vis[q].tolist()) <= tied


def _bytemap_case(seed, n, B=4, width=64, trash=80):
    """A byte-map [B, n + trash] stamped with epochs 0 (this level), 1 (an
    earlier level) and 255, and an expansion with visited nodes,
    in-frontier duplicates and masked entries."""
    rng = np.random.default_rng(seed)
    vis = rng.choice(np.array([0, 1, 255], np.uint8), (B, n + trash),
                     p=[0.3, 0.3, 0.4])
    nb = rng.integers(0, n, (B, width)).astype(np.int32)
    nb[:, 10:20] = nb[:, 20:30]                       # in-frontier duplicates
    nb[rng.random(nb.shape) < 0.1] = n                # masked expansion
    return vis, nb


@pytest.mark.parametrize("mark_policy", ["all", "scored"])
@pytest.mark.parametrize("topk_impl", ["exact", "topk", "approx"])
@pytest.mark.parametrize("f_cap", [12, 48], ids=["overflow", "fits"])
def test_bytemap_dedup_filter_mark_matches_jax(mark_policy, topk_impl, f_cap):
    """fresh, fresh_valid, the visited bytes and num_fresh."""
    n, mix, epoch = 3000, 3, 0
    vis, nb = _bytemap_case(f_cap, n)
    salt = beam.hop_salt(mix, n, f_cap)
    got = beam.LocalBackend().dedup_filter_mark(
        torch.from_numpy(vis.copy()), torch.from_numpy(nb), epoch, n, salt,
        f_cap, topk_impl, mark_policy)
    jbe = jbeam.LocalBackend()
    want = _jax_rows(lambda v, b: jbe.dedup_filter_mark(
        v, b, jnp.uint8(epoch), n, jnp.int32(salt), f_cap, topk_impl,
        mark_policy), vis, nb)
    assert ((got[3] == f_cap) == (f_cap == 12)).all()
    _assert_hop_matches(got, want, salt, topk_impl == "approx",
                        exact_vis=mark_policy == "all")


@pytest.mark.parametrize("mark_policy", ["all", "scored"])
@pytest.mark.parametrize("topk_impl", ["exact", "approx"])
@pytest.mark.parametrize("n,f_cap,mix", [(3000, 24, 2), (3000, 500, 1)])
def test_list_dedup_filter_mark_matches_jax(mark_policy, topk_impl, n, f_cap,
                                            mix):
    """Both mark policies on the list: "scored" appends the selected nodes,
    "all" keeps the masked merge, old entries and every fresh node."""
    rng = np.random.default_rng(mix)
    vis = rng.integers(0, n, (4, 50)).astype(np.int32)
    vis[rng.random(vis.shape) < 0.3] = beam.ListBackend.PAD
    nb = rng.integers(0, n, (4, 64)).astype(np.int32)
    nb[:, :10] = vis[:, :10]
    nb[:, 10:20] = nb[:, 20:30]
    nb[rng.random(nb.shape) < 0.1] = n
    salt = beam.hop_salt(mix, n, f_cap)
    f_cap = min(f_cap, 64)
    got = beam.ListBackend().dedup_filter_mark(
        torch.from_numpy(vis), torch.from_numpy(nb), 0, n, salt, f_cap,
        topk_impl, mark_policy)
    jbe = jbeam.ListBackend()
    want = _jax_rows(lambda v, b: jbe.dedup_filter_mark(
        v, b, jnp.uint8(0), n, jnp.int32(salt), f_cap, topk_impl,
        mark_policy), vis, nb)
    grow = f_cap if mark_policy == "scored" else 64
    assert got[2].shape == (4, 50 + grow)
    _assert_hop_matches(got, want, salt, topk_impl == "approx",
                        exact_vis=mark_policy == "all")


@pytest.mark.parametrize("mark_policy", ["all", "scored"])
def test_bytemap_filter_expand_matches_jax(mark_policy):
    """take_rows of the neighbour table, then the hop, at level entry:
    the candidates stamped first (vis_reset_mark)."""
    n, f_cap, mix, epoch = 400, 96, 1, 1
    rng = np.random.default_rng(7)
    neighbors = rng.integers(0, n, (n, 8)).astype(np.int32)
    cand = rng.integers(0, n, (3, 20)).astype(np.int32)
    cand_scores = rng.standard_normal((3, 20)).astype(np.float32)
    cand_scores[:, -4:] = -np.inf
    vis = np.full((3, n + 160), 255, np.uint8)
    salt = beam.hop_salt(mix, n, f_cap)
    be = beam.LocalBackend()
    tvis = be.vis_reset_mark(torch.from_numpy(vis.copy()),
                             torch.from_numpy(cand),
                             torch.from_numpy(cand_scores) > beam.NEG_INF,
                             epoch, n)
    got = beam.filter_expand(be, torch.from_numpy(neighbors), tvis, epoch,
                             torch.from_numpy(cand),
                             torch.from_numpy(cand_scores), f_cap, n, salt,
                             "exact", mark_policy)
    jbe = jbeam.LocalBackend()

    def hop(v, c, s):
        v = jbe.vis_reset_mark(v, c, s > jbeam.NEG_INF, jnp.uint8(epoch), n)
        return jbeam.filter_expand(jbe, jnp.asarray(neighbors), v,
                                   jnp.uint8(epoch), c, s, f_cap, n,
                                   jnp.int32(salt), "exact", mark_policy)

    want = _jax_rows(hop, vis, cand, cand_scores)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pad_trash_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 100, (3, 30)).astype(np.int32)
    valid = rng.random((3, 30)) < 0.6
    got = beam._pad_trash(torch.from_numpy(ids), torch.from_numpy(valid), 100)
    want = _jax_rows(lambda i, v: jbeam._pad_trash(i, v, 100), ids, valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
