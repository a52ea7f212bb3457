"""The row sort, row top-k and lane gather of the port against the JAX
package, on the CPU: their plain versions (what the wrappers run on CPU
tensors) against the TPU probe kernels they replace
(scripts/probe_kernel_ops.py) and against jnp.sort, jnp.argsort, lax.top_k
and jnp.take_along_axis on rows with ties, -inf, -0.0 and +0.0 and negative
int32; the lane gather is `visited_ops.gather_elems` of a per-query table
with the clip bound W - 1 (`beam._take_along`); the wrappers' checks; the
ops layer (nann_tpu_torch/ops) against nann_tpu/ops on the inputs of
tests/test_ops.py and tests/test_ragged_device.py; and the search's selects
switched to their plain versions.

The probe script cannot be imported (it runs its probes from main() and
prints the devices at import), so each probe body is restated here and run
through `pl.pallas_call(..., interpret=True)` as the probe builds it.

Tolerance: none. Every comparison is exact, values by their bits (so -0.0
is not +0.0), indices and their order included.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nann_tpu.ops import bitmap as jbitmap
from nann_tpu.ops import idmap as jidmap
from nann_tpu.ops import ragged as jragged
from nann_tpu.ops import ragged_device as jrd
from nann_tpu.ops import topk as jtopk

from nann_tpu_torch.kernels import select_ops as so
from nann_tpu_torch.kernels import visited_ops as vo
from nann_tpu_torch.ops import bitmap, idmap, ragged, ragged_device as rd, topk
from nann_tpu_torch.search import beam

N_ITEMS = 200_064        # the probe's table, a multiple of 128
EXPAND = 12_800          # the probe's ids: 400 candidates x 32 neighbours


@pytest.fixture(scope="module")
def probe():
    """The probe's inputs (probe_kernel_ops.py:169-172), from its seed."""
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 250, size=(N_ITEMS,)).astype(np.int32)
    idx = rng.integers(0, N_ITEMS, size=(EXPAND,)).astype(np.int32)
    return tab.reshape(-1, 128), idx.reshape(-1, 128)


def _interpret(kern, out_shape, *args):
    """The probe's pallas_call, whole arrays in VMEM, in interpret mode."""
    call = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return np.asarray(jax.jit(call)(*[jnp.asarray(a) for a in args]))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ----------------------------------------------- the probes, interpret mode


def test_row_sort_matches_build_sort(probe):
    _tab2d, idx2d = probe

    def kern(x_ref, out_ref):                       # probe_kernel_ops.py:213
        out_ref[:] = jnp.sort(x_ref[:], axis=-1)

    want = _interpret(kern, idx2d.shape, idx2d)
    _assert_exact(so.row_sort(torch.from_numpy(idx2d)), want)


def test_row_topk_matches_build_topk(probe):
    _tab2d, idx2d = probe

    def kern(x_ref, out_ref):                       # probe_kernel_ops.py:223
        v, _ = jax.lax.top_k(x_ref[:].reshape(1, -1), 128)
        out_ref[:] = v

    want = _interpret(kern, (1, 128), idx2d)
    values, indices = so.row_topk(torch.from_numpy(idx2d).reshape(1, -1), 128)
    _assert_exact(values, want)
    np.testing.assert_array_equal(idx2d.reshape(-1)[indices.numpy()], want)


def test_take_along_matches_build_take_along(probe):
    tab2d, idx2d = probe

    def kern(tab_ref, idx_ref, out_ref):            # probe_kernel_ops.py:187
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:] % 128,
                                         axis=1)

    want = _interpret(kern, idx2d.shape, tab2d[:idx2d.shape[0]], idx2d)
    got = vo.gather_elems(torch.from_numpy(tab2d[:idx2d.shape[0]].copy()),
                          torch.from_numpy(idx2d % 128), 127)
    _assert_exact(got, want)


# ------------------------------------------- edge rows against jnp and lax


def _edge_rows(dtype, seed, B=5, W=300):
    """Rows of many ties, runs of -inf, -0.0 beside +0.0 (float32); negative
    keys, the extremes of int32 and many equal pads (int32)."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        x = rng.integers(-8, 8, (B, W)).astype(np.float32) / 4
        x[rng.random((B, W)) < 0.2] = -np.inf
        x[:, W // 3:W // 3 + W // 10] = -np.inf
        x[rng.random((B, W)) < 0.1] = -0.0
        x[0] = rng.standard_normal(W)
    else:
        x = rng.integers(-2**31, 2**31 - 1, (B, W), dtype=np.int64).astype(
            np.int32)
        x[:, ::3] = 2**31 - 1
        x[:, 1::7] = -(2**31)
        x[1:, 2::5] = rng.integers(-3, 3, (B - 1, len(range(2, W, 5))))
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
def test_row_sort_matches_jnp_sort(dtype):
    x = _edge_rows(dtype, 1)
    values, perm = so.row_sort(torch.from_numpy(x), with_perm=True)
    want_perm = np.asarray(jnp.argsort(jnp.asarray(x), axis=-1, stable=True))
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    _assert_exact(values, np.take_along_axis(x, want_perm, axis=-1))
    # values equal jnp.sort's, -0.0 and +0.0 aside (a sort may swap them)
    np.testing.assert_array_equal(values.numpy(),
                                  np.asarray(jnp.sort(jnp.asarray(x), axis=-1)))
    assert perm.dtype == torch.int32


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("k", [1, 37, 300])
def test_row_topk_matches_lax_top_k(dtype, k):
    """Exact on rows of ties and -inf; -0.0 is made +0.0 first (see the
    next test)."""
    x = _edge_rows(dtype, k)
    if dtype == np.float32:
        x = x + np.float32(0)                       # -0.0 -> +0.0
    values, indices = so.row_topk(torch.from_numpy(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_i))
    _assert_exact(values, want_v)


def test_row_topk_ties_signed_zeros():
    """-0.0 and +0.0 tie, as torch.sort (the plain version) and jnp.sort
    compare them, so the lower index comes first; XLA's CPU top_k ranks +0.0
    above -0.0. The two orders differ only among the zeros."""
    x = np.asarray([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0]], np.float32)
    _, indices = so.row_topk(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(indices.numpy(), [[2, 0, 1, 3, 4, 5]])
    _, want = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(np.asarray(want), [[2, 0, 4, 1, 3, 5]])
    x = _edge_rows(np.float32, 11)
    _, got = so.row_topk(torch.from_numpy(x), 300)
    _, want = jax.lax.top_k(jnp.asarray(x), 300)
    differ = got.numpy() != np.asarray(want)
    assert differ.any()
    assert (np.take_along_axis(x, got.numpy(), -1)[differ] == 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
def test_row_topk_smallest_is_the_stable_sort_prefix(dtype):
    """largest=False: the k smallest in ascending order, ties to the lower
    index; for int32 keys away from INT32_MIN this is lax.top_k of the
    negated keys, as the search's "topk" selection takes it."""
    x = _edge_rows(dtype, 7)
    values, indices = so.row_topk(torch.from_numpy(x), 120, largest=False)
    want_i = np.argsort(x, axis=-1, kind="stable")[:, :120]
    np.testing.assert_array_equal(indices.numpy(), want_i)
    _assert_exact(values, np.take_along_axis(x, want_i, axis=-1))
    if dtype == np.int32:
        x = np.maximum(x, -(2**31) + 1)
        _, want = jax.lax.top_k(-jnp.asarray(x), 120)
        _, got = so.row_topk(torch.from_numpy(x), 120, largest=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
def test_take_along_matches_jnp(dtype):
    """int32 as it is, float32 moved as its bits."""
    rng = np.random.default_rng(3)
    table = _edge_rows(dtype, 3)
    idx = rng.integers(0, table.shape[1], (table.shape[0], 500)).astype(
        np.int32)
    t = torch.from_numpy(table)
    got = beam._take_along(so.selects(), t.view(torch.int32),
                           torch.from_numpy(idx)).view(t.dtype)
    _assert_exact(got, jnp.take_along_axis(jnp.asarray(table),
                                           jnp.asarray(idx), axis=1))


def test_take_along_clips_to_the_row():
    """An index outside [0, W) reads the row's first or last element, on
    the card as on the CPU (the kernel and its plain version agree)."""
    table = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    idx = torch.tensor([[-5, 0, 9, 10], [30, -1, 3, 2**31 - 1]],
                       dtype=torch.int32)
    got = beam._take_along(so.selects(), table, idx)
    assert got.tolist() == [[0, 0, 9, 9], [19, 10, 13, 19]]


# -------------------------------------------------------------- the wrappers


@pytest.mark.parametrize("case", ["sort_type", "sort_rank", "sort_strided",
                                  "topk_k", "topk_negative_k", "topk_type",
                                  "along_type", "along_idx_type",
                                  "along_batch", "along_device"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros((2, 10), dtype=torch.int32)
    idx = torch.zeros((2, 4), dtype=torch.int32)

    def along(table, i):
        return beam._take_along(so.selects(), table, i)

    calls = {
        "sort_type": (TypeError, lambda: so.row_sort(x.long())),
        "sort_rank": (ValueError, lambda: so.row_sort(x[0])),
        "sort_strided": (ValueError, lambda: so.row_sort(x[:, ::2])),
        "topk_k": (ValueError, lambda: so.row_topk(x, 11)),
        "topk_negative_k": (ValueError, lambda: so.row_topk(x, -1)),
        "topk_type": (TypeError, lambda: so.row_topk(x.double(), 2)),
        "along_type": (TypeError, lambda: along(x.half(), idx)),
        "along_idx_type": (TypeError, lambda: along(x, idx.long())),
        "along_batch": (ValueError, lambda: along(x, idx[:1])),
        "along_device": (ValueError, lambda: along(
            x, torch.zeros((2, 4), dtype=torch.int32, device="meta"))),
    }
    error, call = calls[case]
    with pytest.raises(error):
        call()


def test_cpu_tensors_launch_nothing():
    before = (so.row_sort.launches, so.row_topk.launches,
              vo.gather_elems.launches)
    x = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    so.row_sort(x, with_perm=True)
    so.row_topk(x.float(), 3, largest=False)
    beam._take_along(so.selects(), x, torch.ones((2, 4), dtype=torch.int32))
    assert (so.row_sort.launches, so.row_topk.launches,
            vo.gather_elems.launches) == before


def test_empty_rows_and_k_zero():
    x = torch.zeros((3, 0), dtype=torch.int32)
    assert so.row_sort(x).shape == (3, 0)
    v, i = so.row_topk(torch.ones((3, 5)), 0)
    assert v.shape == i.shape == (3, 0)


class _FakeLib:
    """The two layout functions of a built library, with chosen answers."""

    def __init__(self, size=None, offset=None):
        size = size or ctypes.sizeof(so.SelectArgs)
        offset = offset or so.SelectArgs.largest.offset
        self.nann_select_args_size = lambda: size
        self.nann_select_args_largest_offset = lambda: offset


def test_struct_guard_passes_the_same_layout():
    so.check_struct(_FakeLib())


@pytest.mark.parametrize("layout", [{"size": 80}, {"offset": 64}],
                         ids=["size", "last_offset"])
def test_struct_guard_raises_on_another_layout(layout):
    with pytest.raises(RuntimeError, match="differs"):
        so.check_struct(_FakeLib(**layout))


def test_args_struct_layout():
    """Four pointers, four 8-byte counts, then two 4-byte flags."""
    assert ctypes.sizeof(so.SelectArgs) == 72
    assert so.SelectArgs.scratch_words.offset == 56
    assert so.SelectArgs.is_float.offset == 64
    assert so.SelectArgs.largest.offset == 68


# ------------------------------------------------------ the row sort's plan

_T, _S = so.SORT_TILE, so.SHORT_ROW


@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("W,path,tiles", [
    (1, "short", 1), (_T - 1, "short", 1), (_T, "short", 1),
    (_T + 1, "short", 1), (_S, "short", 1), (_S + 1, "tiled", 3),
    (3 * _T - 1, "tiled", 3), (3 * _T, "tiled", 3), (3 * _T + 1, "tiled", 4),
    (33992, "tiled", 9), (100_000, "tiled", 25)])
def test_sort_plan_by_width(B, W, path, tiles):
    """The width picks the path; a tiled row is cut into ceil(W / T) tiles,
    and its scratch covers the last word the kernels index: the second
    index buffer's last slot of the last row, then the tile counts of every
    digit and of one digit, the bucket bases and the flags."""
    got_path, got_tiles, words = so._sort_plan(B, W)
    assert (got_path, got_tiles) == (path, tiles)
    if path == "short":
        assert words == 0
        return
    stride = tiles * _T
    assert stride >= W and stride - W < _T
    last_id = 3 * B * stride + (B - 1) * stride + (W - 1)
    tile_all_end = 4 * B * stride + B * tiles * 4 * 256
    tile_cnt_end = tile_all_end + B * tiles * 256
    bucket_end = tile_cnt_end + B * 4 * 256
    assert last_id < 4 * B * stride <= tile_all_end
    assert words == bucket_end + B


@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("W,k,path,tiles", [
    (1, 1, "short", 1), (90, 90, "short", 1), (4496, 400, "short", 1),
    (_S, _S, "short", 1), (_S + 1, 1, "tiled", 3), (_S + 1, _S, "tiled", 3),
    (_S + 1, _S + 1, "tiled", 3), (3 * _T, 200, "tiled", 3),
    (3 * _T + 1, 200, "tiled", 4), (25600, _S, "tiled", 7),
    (33992, 4096, "tiled", 9), (33992, _S + 1, "tiled", 9),
    (100_000, 200, "tiled", 25)])
def test_topk_plan_by_width(B, W, k, path, tiles):
    """The width picks the path as the sort's does; a tiled row is cut into
    ceil(W / T) tiles, and its scratch covers the last word the kernels
    index: one digit's tile counts, the tiles' keys below the bucket and in
    it, the AND and OR of each tile's keys that share the prefix, the rows'
    state, the winners' keys and indices, then the candidates'
    (k <= S) or the sorted winners', their permutation and the tiled sort's
    scratch of [B, k] (k > S)."""
    got_path, got_tiles, words = so._topk_plan(B, W, k)
    assert (got_path, got_tiles) == (path, tiles)
    if path == "short":
        assert words == 0
        return
    assert (tiles - 1) * _T < W <= tiles * _T
    last_tile_hist = (B - 1) * tiles * 256 + (tiles - 1) * 256 + 255
    state_end = B * tiles * 256 + 4 * B * tiles + B * so._STATE_WORDS
    win_id_end = state_end + 2 * B * k
    assert last_tile_hist < state_end
    if k <= _S:
        assert words == win_id_end + 2 * B * _S
    else:
        sort_words = so._sort_plan(B, k)[2]
        assert so._sort_plan(B, k)[0] == "tiled"
        assert words == win_id_end + 2 * B * k + sort_words


@pytest.mark.parametrize("plain", [False, True])
def test_selects_switch_all_three(plain):
    sel = so.selects(plain)
    names = [f.__name__ for f in sel]
    suffix = "_plain" if plain else ""
    assert names == [n + suffix for n in so.Selects._fields]


def test_plain_backends_take_the_plain_selects():
    for backend in (beam.ListBackend(plain=True), beam.LocalBackend(plain=True)):
        assert backend.sel == so.selects(True)
    be = beam.ListBackend()
    assert be.sel == so.selects(False)
    # the merge sort and the selection run what the backend holds
    sorted_widths = []

    def recording_sort(x, with_perm=False):
        sorted_widths.append(x.shape[1])
        return so.row_sort_plain(x, with_perm)

    be.sel = be.sel._replace(row_sort=recording_sort)
    vis = torch.tensor([[3, 7, be.PAD]], dtype=torch.int32)
    nb = torch.tensor([[7, 1, 2, 2, 50]], dtype=torch.int32)
    fresh, fresh_valid, _, num_fresh = be.dedup_filter_mark(
        vis, nb, 0, 50, 0, 5)
    assert sorted_widths == [8, 8]
    assert fresh[fresh_valid].tolist() == [1, 2] and num_fresh.tolist() == [2]


# ---------------------------------------------------------------- ops.topk


def test_blaze_topk_matches_jax():
    """tests/test_ops.py's rows, then rows with ties and -inf."""
    v = np.asarray([[0.1, 0.9, 0.5, 0.7], [1.0, -1.0, 0.0, 2.0]], np.float32)
    rng = np.random.default_rng(4)
    ties = (rng.integers(0, 5, (6, 40)) / 2).astype(np.float32)
    ties[rng.random(ties.shape) < 0.2] = -np.inf
    cases = [(v, np.asarray([2, 3]), 4), (v, 2, 3),
             (ties, rng.integers(0, 30, 6), 25),
             (rng.integers(-3, 3, (4, 30)).astype(np.int32), 7, 9)]
    for values, k, k_cap in cases:
        for ascending in (False, True):
            got = topk.blaze_topk(torch.from_numpy(values),
                                  torch.as_tensor(k), k_cap, ascending)
            want = jtopk.blaze_topk(jnp.asarray(values), jnp.asarray(k), k_cap,
                                    ascending)
            for g, w in zip(got, want):
                _assert_exact(g, w)


def test_host_batch_topk_on_rt_matches_jax():
    vals = np.asarray([3.0, 1.0, 2.0, 9.0, 8.0])
    splits = np.asarray([0, 3, 5])
    for ascending in (False, True):
        got = topk.batch_topk_on_rt(vals, splits, np.asarray([2, 1]),
                                    ascending)
        want = jtopk.batch_topk_on_rt(vals, splits, np.asarray([2, 1]),
                                      ascending)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -------------------------------------------------------- ops.ragged_device


def _rag(*rows):
    splits = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    vals = np.concatenate([np.asarray(r, np.int64) for r in rows]) if rows \
        else np.zeros(0, np.int64)
    return vals, splits


def _rand_rag(rng, nrows, maxlen, hi, unique=False):
    rows = []
    for _ in range(nrows):
        ln = int(rng.integers(0, maxlen + 1))
        row = (rng.choice(hi, size=min(ln, hi), replace=False) if unique
               else rng.integers(0, hi, size=ln))
        rows.append(np.asarray(row, np.int64))
    return _rag(*rows)


def _padded(rag, width):
    """The same padded rows for both packages."""
    mine = rd.from_ragged(*rag, width=width, device="cpu")
    theirs = jrd.from_ragged(*rag, width=width)
    for m, t in zip(mine, theirs):
        _assert_exact(m, t)
    return mine, theirs


def _assert_padded_equal(got, want):
    for g, w in zip(got, want):
        _assert_exact(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_ops_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = _rand_rag(rng, 6, 10, 20, unique=True)
    b = _rand_rag(rng, 6, 10, 20, unique=True)
    (ap, jap), (bp, jbp) = _padded(a, 16), _padded(b, 16)
    for name in ("set_union", "set_intersection", "set_difference"):
        got = getattr(rd, name)(ap, bp)
        _assert_padded_equal(got, jax.jit(getattr(jrd, name))(jap, jbp))
        # and the host oracle, as sets per row
        want = getattr(ragged, name)(a, b)
        np.testing.assert_array_equal(rd.to_ragged(*got)[0], want[0])


def test_set_ops_with_duplicates_match_jax():
    """Rows that repeat values (sets are formed by the dedup)."""
    rng = np.random.default_rng(9)
    a = _rand_rag(rng, 5, 12, 8)
    b = _rand_rag(rng, 5, 12, 8)
    (ap, jap), (bp, jbp) = _padded(a, 12), _padded(b, 12)
    for name in ("set_union", "set_intersection", "set_difference"):
        _assert_padded_equal(getattr(rd, name)(ap, bp),
                             getattr(jrd, name)(jap, jbp))


@pytest.mark.parametrize("unique", [False, True])
def test_group_gather_matches_jax(unique):
    params = _rag([0, 1], [2, 3, 4], [5, 6], [7, 8, 9])
    idx = _rag([0, 1], [], [1, 3])
    (pv, pm), (jpv, jpm) = _padded(params, 3)
    (iv, im), (jiv, jim) = _padded(idx, 4)
    got = rd.group_gather(pv, pm, (iv, im), unique=unique)
    _assert_padded_equal(got, jrd.group_gather(jpv, jpm, (jiv, jim),
                                               unique=unique))
    host = ragged.group_gather(params, idx, unique=unique)
    if not unique:
        np.testing.assert_array_equal(rd.to_ragged(*got)[0], host[0])


def test_batch_gather_concat_splits_match_jax():
    data = _rag([10, 11, 12], [20, 21])
    idx = _rag([2, 0], [1])
    (dp, jdp), (ip, jip) = _padded(data, 4), _padded(idx, 4)
    g = rd.batch_gather_on_rt(dp, ip)
    jg = jrd.batch_gather_on_rt(jdp, jip)
    _assert_padded_equal(g, jg)
    np.testing.assert_array_equal(rd.to_ragged(*g)[0], [12, 10, 21])
    c = rd.batch_concat_on_rt(dp, g)
    _assert_padded_equal(c, jrd.batch_concat_on_rt(jdp, jg))
    np.testing.assert_array_equal(rd.to_ragged(*c)[1], [0, 5, 8])
    s = rd.splits_gather(dp, torch.tensor([1, 0]))
    _assert_padded_equal(s, jrd.splits_gather(jdp, jnp.asarray([1, 0])))


def test_ragged_device_batch_topk_matches_jax():
    rng = np.random.default_rng(3)
    rows = [rng.standard_normal(int(rng.integers(0, 9))).astype(np.float32)
            for _ in range(5)]
    padded = np.zeros((5, 8), np.float32)
    mask = np.zeros((5, 8), bool)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
        mask[i, :len(r)] = True
    padded[2, :3] = padded[2, 3:6] = 0.5          # ties
    for k in (np.asarray([3, 1, 4, 2, 8]), 3):
        for ascending in (False, True):
            got = rd.batch_topk_on_rt(torch.from_numpy(padded),
                                      torch.from_numpy(mask),
                                      torch.as_tensor(k), 8, ascending)
            want = jrd.batch_topk_on_rt(jnp.asarray(padded),
                                        jnp.asarray(mask), jnp.asarray(k), 8,
                                        ascending)
            _assert_padded_equal(got, want)


def test_to_ragged_matches_jax():
    rag = _rand_rag(np.random.default_rng(5), 4, 6, 30)
    (v, m), (jv, jm) = _padded(rag, 6)
    for g, w in zip(rd.to_ragged(v, m), jrd.to_ragged(jv, jm)):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- ops.ragged


def test_host_ragged_matches_jax():
    """Every host op of tests/test_ops.py's inputs, and random rows."""
    a, b = _rag([1, 2, 3], [5], []), _rag([2, 4], [5], [7])
    rng = np.random.default_rng(6)
    ra, rb = _rand_rag(rng, 5, 8, 12), _rand_rag(rng, 5, 8, 12)
    params = _rag([0, 1], [2, 3, 4], [5, 6], [7, 8, 9])
    idx = _rag([0, 1], [], [1, 3])
    data, didx = _rag([10, 11, 12], [20, 21]), _rag([2, 0], [1])
    calls = [(name, args) for name in ("set_union", "set_intersection",
                                       "set_difference", "batch_concat_on_rt")
             for args in ((a, b), (ra, rb))]
    calls += [("group_gather", (params, idx)),
              ("group_gather", (_rag([1, 2], [2, 3]), _rag([0, 1]), True)),
              ("batch_gather_on_rt", (data, didx)),
              ("splits_gather", (data, np.asarray([1, 0])))]
    for name, args in calls:
        for g, w in zip(getattr(ragged, name)(*args),
                        getattr(jragged, name)(*args)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# --------------------------------------------------------------- ops.bitmap


def _t(ids):
    return torch.tensor(ids, dtype=torch.int32)


def _j(ids):
    return jnp.asarray(ids, jnp.int32)


@pytest.mark.parametrize("ids,num_bits", [
    ([0, 1, 31, 32, 63, 64, 100], 128), ([5, 5, 5, 7], 64),
    ([31, 63, -4, 200, 31, 0], 64), ([], 40)])
def test_bitmap_init_and_test_match_jax(ids, num_bits):
    bm = bitmap.bitmap_init(_t(ids), num_bits)
    jbm = jbitmap.bitmap_init(_j(ids), num_bits)
    _assert_exact(bm, jbm)
    probe = _t(list(range(-3, num_bits + 3)))
    _assert_exact(bitmap.bitmap_test(bm, probe),
                  jbitmap.bitmap_test(jbm, _j(probe.tolist())))


def test_bitmap_differences_match_jax():
    """tests/test_ops.py's chain, and random ids with duplicates."""
    rng = np.random.default_rng(8)
    bm, jbm = torch.zeros(2, dtype=torch.int32), jnp.zeros(2, jnp.int32)
    batches = [[4, 4, 9, 1], [9, 2, 4, 60], [10, 20, 10],
               rng.integers(-5, 70, 40).tolist()]
    for ids in batches:
        got = bitmap.bitmap_difference(_t(ids), bm)
        want = jbitmap.bitmap_difference(_j(ids), jbm)
        for g, w in zip(got, want):
            _assert_exact(g, w)
        got = bitmap.bitmap_ref_difference(_t(ids), bm)
        want = jbitmap.bitmap_ref_difference(_j(ids), jbm)
        for g, w in zip(got, want):
            _assert_exact(g, w)
        bm, jbm = got[2], want[2]


def test_bloom_matches_jax():
    """tests/test_ops.py's chain, and ids whose uint32 view is large."""
    _assert_exact(bitmap.bloom_hashes(_t([0, 1, 2**31 - 1, -1, -(2**31)]), 77),
                  jbitmap.bloom_hashes(_j([0, 1, 2**31 - 1, -1, -(2**31)]), 77))
    bm, jbm = torch.zeros(1024, dtype=torch.int32), jnp.zeros(1024, jnp.int32)
    for ids in ([100, 2000, 55555], [100, 777, 2000],
                [-7, 3, 3, 2**31 - 1, 99999]):
        got = bitmap.bloom_filter_difference(_t(ids), bm)
        want = jbitmap.bloom_filter_difference(_j(ids), jbm)
        for g, w in zip(got, want):
            _assert_exact(g, w)
        bm, jbm = got[2], want[2]


# ---------------------------------------------------------------- ops.idmap


def test_idmap_matches_jax():
    keys, values = np.asarray([10, 5, 30]), np.asarray([1, 2, 3])
    mine = idmap.IdMap(keys, values, default=-7, device="cpu")
    theirs = jidmap.IdMap(keys, values, default=-7)
    queries = [5, 10, 30, 99, -1, 0]
    np.testing.assert_array_equal(mine.lookup(torch.tensor(queries)).numpy(),
                                  np.asarray(theirs.lookup(jnp.asarray(queries))))
    for g, w in zip(mine.lookup_v2(queries),
                    theirs.lookup_v2(jnp.asarray(queries))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
