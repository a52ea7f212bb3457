"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the frontier scorer on float tables and on packed int8 tables, the
byte-map backend's gathers and scatter (compared exactly: integer copies),
and the row sort, row top-k and lane gather (compared exactly: values,
indices and their order, ties, -inf, -0.0 and +0.0 included).

These tests need an NVIDIA GPU with nvcc (they build the kernels) and skip
elsewhere. They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerances: float32 2e-4 x (1 + |ref|) (another summation order), bfloat16
0.05 x (1 + |ref|) (a layer's rounding may fall to the next bf16 value),
those of tests/test_scorer_kernel.py.
"""

import time

import numpy as np
import pytest
import torch

from nann_tpu_torch.config import ModelConfig, SearchConfig
from nann_tpu_torch.index import build_and_save_index, load_index
from nann_tpu_torch.index.quantize import pack_quantized
from nann_tpu_torch.kernels import frontier_scorer as fs
from nann_tpu_torch.kernels import select_ops as so
from nann_tpu_torch.kernels import visited_ops as vo
from nann_tpu_torch.models import init_scorer
from nann_tpu_torch.ops import fold_scorer, precompute_user
from nann_tpu_torch.search import SearchIndex, level_topn_default, make_searcher
from nann_tpu_torch.search import beam

pytestmark = pytest.mark.cuda

SERVING = ModelConfig(emb_dim=32, max_seq_length=50, compute_dtype="bfloat16")
NARROW = ModelConfig(emb_dim=16, max_seq_length=12,
                     item_tower_dims=(32, 32, 32), head_dims=(64, 32, 16, 1))
TOL = {torch.float32: 2e-4, torch.bfloat16: 0.05}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(mcfg, dt, dev, B=4, F=1000, L=None, n=5000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params, state = init_scorer(mcfg, gen, device=dev)
    folded = fold_scorer(params, state, mcfg)
    L = L or mcfg.max_seq_length
    user = torch.randn((B, L, mcfg.user_emb_dim), generator=gen).to(dev)
    k_proj, v = precompute_user(folded, user, dt)
    table = torch.randn((n, mcfg.item_emb_dim), generator=gen).to(dev, dt)
    ids = torch.randint(-3, n + 3, (B, F), generator=gen,
                        dtype=torch.int32).to(dev)
    valid = (torch.rand((B, F), generator=gen) > 0.1).to(dev)
    return fs.kernel_weights(folded, dt), k_proj, v, table, ids, valid


@pytest.mark.parametrize("mcfg", [SERVING, NARROW], ids=["serving", "narrow"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("L", [None, 1, 7])
def test_kernel_matches_plain(cuda, mcfg, dt, L):
    args = _inputs(mcfg, dt, cuda, L=L)
    before = fs.score_frontier.launches
    got = fs.score_frontier(*args)
    assert fs.score_frontier.launches == before + 1
    want = fs.frontier_scorer_plain(*args)
    torch.cuda.synchronize()
    valid = args[-1]
    assert torch.isneginf(got[~valid]).all()
    assert torch.isfinite(got[valid]).all()
    rel = ((got - want)[valid].abs() / (1 + want[valid].abs())).max().item()
    assert rel <= TOL[dt]


@pytest.mark.parametrize("F", [1, 31, 33])
def test_kernel_ragged_frontier(cuda, F):
    args = _inputs(SERVING, torch.bfloat16, cuda, B=3, F=F)
    got = fs.score_frontier(*args)
    want = fs.frontier_scorer_plain(*args)
    valid = args[-1]
    assert got.shape == (3, F)
    torch.testing.assert_close(got[~valid], want[~valid])
    rel = ((got - want)[valid].abs() / (1 + want[valid].abs())).max().item()
    assert rel <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("storage", ["rows", "int8"])
def test_kernel_is_deterministic_per_row(cuda, dt, storage):
    """A row's score does not depend on the batch around it (the engine pads
    and groups requests freely)."""
    make = _inputs if storage == "rows" else _int8_inputs
    w, k_proj, v, table, ids, valid = make(SERVING, dt, cuda)
    full = fs.score_frontier(w, k_proj, v, table, ids, valid)
    one = fs.score_frontier(w, k_proj[2:3].contiguous(), v[2:3].contiguous(),
                            table, ids[2:3].contiguous(),
                            valid[2:3].contiguous())
    assert torch.equal(full[2:3], one)


def _prefix_valid(F, dev):
    """Search-shaped masks: each query's valid rows first, padding after, at
    ragged lengths (none, one, the 32-row and 128-row block edges, all)."""
    lens = torch.tensor([0, 1, 31, 32, 33, 127, 128, 129, F])
    return (torch.arange(F)[None] < lens[:, None]).to(dev)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("storage", ["rows", "int8"])
def test_kernel_prefix_mask(cuda, dt, storage):
    """Valid rows a prefix of each query, as the search gives them: whole
    blocks of padding write -inf without scoring, the rest agree with the
    plain version."""
    make = _inputs if storage == "rows" else _int8_inputs
    F = 300
    w, k_proj, v, table, ids, _ = make(SERVING, dt, cuda, B=9, F=F)
    valid = _prefix_valid(F, cuda)
    got = fs.score_frontier(w, k_proj, v, table, ids, valid)
    want = fs.frontier_scorer_plain(w, k_proj, v, table, ids, valid)
    torch.cuda.synchronize()
    assert torch.isneginf(got[~valid]).all()
    assert torch.isfinite(got[valid]).all()
    rel = ((got - want)[valid].abs() / (1 + want[valid].abs())).max().item()
    assert rel <= TOL[dt]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("storage", ["rows", "int8"])
def test_kernel_row_tiles_do_not_change_scores(cuda, dt, storage):
    """The same ids scored at F and at F + 17 with trailing padding give
    identical scores: where a frontier ends does not move a row's score."""
    make = _inputs if storage == "rows" else _int8_inputs
    F = 250
    w, k_proj, v, table, ids, valid = make(SERVING, dt, cuda, B=3, F=F)
    pad = torch.zeros((3, 17), dtype=torch.int32, device=cuda)
    ids2 = torch.cat([ids, pad], dim=1)
    valid2 = torch.cat([valid, pad.bool()], dim=1)
    short = fs.score_frontier(w, k_proj, v, table, ids, valid)
    long = fs.score_frontier(w, k_proj, v, table, ids2, valid2)
    assert torch.equal(long[:, :F], short)
    assert torch.isneginf(long[:, F:]).all()


def test_kernel_opts_in_once_per_device(cuda):
    """The shared-memory opt-in runs once per device (nann_scorer_init),
    not in the launch: many launches in a row over both compute types and
    both storages all run and agree with the plain version."""
    import os
    src = open(os.path.join(os.path.dirname(fs.__file__), os.pardir, "csrc",
                            "frontier_scorer.cu")).read()
    launch = src[src.index("int launch(const NannScorerArgs& a"):]
    launch = launch[:launch.index("\n}\n")]
    assert "cudaFuncSetAttribute" not in launch
    cases = [make(SERVING, dt, cuda, B=2, F=300)
             for make in (_inputs, _int8_inputs)
             for dt in (torch.bfloat16, torch.float32)]
    for _ in range(8):
        for args in cases:
            got = fs.score_frontier(*args)
            want = fs.frontier_scorer_plain(*args)
            valid = args[-1]
            rel = ((got - want)[valid].abs()
                   / (1 + want[valid].abs())).max().item()
            assert rel <= TOL[args[1].dtype]
    torch.cuda.synchronize()
    assert fs._init.cache_info().currsize == 1


@pytest.mark.parametrize("mcfg", [SERVING, NARROW], ids=["serving", "narrow"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["rows", "int8"])
def test_scorer_plan_matches_the_library(cuda, mcfg, dt, storage):
    """The wrapper's plan is the library's: rows, threads and shared memory
    equal, and the device holds at least the blocks an SM it counts on (two
    at the serving width)."""
    make = _inputs if storage == "rows" else _int8_inputs
    args = make(mcfg, dt, cuda, B=2, F=64)
    plan = fs.scorer_plan(*args[:4])
    got = fs.library_plan(*args)
    assert got[:3] == plan[:3]
    assert got.blocks_per_sm >= plan.blocks_per_sm
    if mcfg is SERVING:
        assert got.blocks_per_sm >= 2


def test_kernel_rejects_what_it_does_not_take(cuda):
    w, k_proj, v, table, ids, valid = _inputs(NARROW, torch.float32, cuda)
    with pytest.raises(TypeError):
        fs.score_frontier(w, k_proj, v, table.half(), ids, valid)
    with pytest.raises(ValueError):
        fs.score_frontier(w, k_proj, v, table, ids[:, ::2], valid[:, ::2])


def test_search_kernel_path_matches_plain_path(cuda, tmp_path):
    mcfg = NARROW
    scfg = SearchConfig(frontier_cap=512)
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((3000, mcfg.item_emb_dim)).astype(np.float32)
    build_and_save_index(embs, 2, 16, str(tmp_path), ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(str(tmp_path), 2), embs,
                                       np.arange(3000), device=cuda)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(1), cuda)
    users = torch.from_numpy(rng.standard_normal(
        (16, mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32))
    ltn = level_topn_default(scfg)
    before = fs.score_frontier.launches
    got = make_searcher(mcfg, scfg)(params, state, index, users, ltn)
    assert fs.score_frontier.launches == before + 5
    want = make_searcher(mcfg, scfg, scorer_impl="plain")(params, state,
                                                          index, users, ltn)
    gi, wi = got[0].cpu().numpy(), want[0].cpu().numpy()
    overlap = np.mean([len(np.intersect1d(g[g >= 0], w[w >= 0]))
                       / max((w >= 0).sum(), 1) for g, w in zip(gi, wi)])
    assert overlap >= 0.99


# ------------------------------------------------- packed int8 item tables


def _int8_inputs(mcfg, dt, dev, B=4, F=1000, n=5000, seed=0):
    """_inputs with the table packed as int8 [n, D+4] (index/quantize.py);
    dt is the compute type."""
    w, k_proj, v, table, ids, valid = _inputs(mcfg, dt, dev, B=B, F=F, n=n,
                                              seed=seed)
    packed = pack_quantized(table.float().cpu().numpy() * 3).to(dev)
    return w, k_proj, v, packed, ids, valid


@pytest.mark.parametrize("mcfg", [SERVING, NARROW], ids=["serving", "narrow"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_int8_kernel_matches_plain(cuda, mcfg, dt):
    args = _int8_inputs(mcfg, dt, cuda)
    before = fs.score_frontier.launches, fs.score_frontier.launches_int8
    got = fs.score_frontier(*args)
    assert (fs.score_frontier.launches,
            fs.score_frontier.launches_int8) == (before[0], before[1] + 1)
    want = fs.frontier_scorer_plain(*args)
    torch.cuda.synchronize()
    valid = args[-1]
    assert torch.isneginf(got[~valid]).all()
    assert torch.isfinite(got[valid]).all()
    rel = ((got - want)[valid].abs() / (1 + want[valid].abs())).max().item()
    assert rel <= TOL[dt]


@pytest.mark.parametrize("F", [1, 31, 33])
def test_int8_kernel_ragged_frontier(cuda, F):
    args = _int8_inputs(SERVING, torch.bfloat16, cuda, B=3, F=F)
    got = fs.score_frontier(*args)
    want = fs.frontier_scorer_plain(*args)
    valid = args[-1]
    assert got.shape == (3, F)
    torch.testing.assert_close(got[~valid], want[~valid])
    rel = ((got - want)[valid].abs() / (1 + want[valid].abs())).max().item()
    assert rel <= TOL[torch.bfloat16]


def test_int8_search_launches_the_int8_kernel(cuda, tmp_path):
    mcfg = NARROW
    scfg = SearchConfig(frontier_cap=512)
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((3000, mcfg.item_emb_dim)).astype(np.float32)
    build_and_save_index(embs, 2, 16, str(tmp_path), ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(str(tmp_path), 2), embs,
                                       np.arange(3000), dtype="int8",
                                       device=cuda)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(1), cuda)
    users = torch.from_numpy(rng.standard_normal(
        (16, mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32))
    ltn = level_topn_default(scfg)
    before = fs.score_frontier.launches, fs.score_frontier.launches_int8
    got = make_searcher(mcfg, scfg)(params, state, index, users, ltn)
    assert (fs.score_frontier.launches,
            fs.score_frontier.launches_int8) == (before[0], before[1] + 5)
    want = make_searcher(mcfg, scfg, scorer_impl="plain")(params, state,
                                                          index, users, ltn)
    gi, wi = got[0].cpu().numpy(), want[0].cpu().numpy()
    overlap = np.mean([len(np.intersect1d(g[g >= 0], w[w >= 0]))
                       / max((w >= 0).sum(), 1) for g, w in zip(gi, wi)])
    assert overlap >= 0.99


# ------------------------------------- the byte-map's gathers and scatter


def _launches():
    return (vo.gather_elems.launches, vo.gather_rows.launches,
            vo.scatter_set.launches)


@pytest.mark.parametrize("shared", [False, True], ids=["per_query", "shared"])
def test_gather_elems_matches_plain(cuda, shared):
    """uint8 rows per query clipped to n (vis_unvisited), or one int32 row
    for the batch clipped to n - 1 (take_ids); ids past both ends."""
    gen = torch.Generator().manual_seed(0)
    n = 5000
    if shared:
        table = torch.randint(0, 2**31 - 1, (n,), generator=gen,
                              dtype=torch.int32)
        hi = n - 1
    else:
        table = torch.randint(0, 256, (8, n + 300), generator=gen,
                              dtype=torch.uint8)
        hi = n
    ids = torch.randint(-50, n + 50, (8, 3000), generator=gen,
                        dtype=torch.int32)
    table, ids = table.to(cuda), ids.to(cuda)
    before = _launches()
    got = vo.gather_elems(table, ids, hi)
    assert _launches() == (before[0] + 1, before[1], before[2])
    torch.testing.assert_close(got, vo.gather_elems_plain(table, ids, hi),
                               rtol=0, atol=0)


@pytest.mark.parametrize("width", [32, 64, 128, 7])
def test_gather_rows_matches_plain(cuda, width):
    """Rows of 4-, 8- and 16-byte loads, and a width none divides."""
    gen = torch.Generator().manual_seed(width)
    table = torch.randint(0, 10**6, (4000, width), generator=gen,
                          dtype=torch.int32).to(cuda)
    ids = torch.randint(-9, 4009, (16, 400), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = _launches()
    got = vo.gather_rows(table, ids)
    assert _launches() == (before[0], before[1] + 1, before[2])
    assert got.shape == (16, 400, width)
    torch.testing.assert_close(got, vo.gather_rows_plain(table, ids), rtol=0,
                               atol=0)


def test_scatter_set_matches_plain(cuda):
    """Per-query uint8 rows with unique ids (masked positions to trash
    slots), then one shared int32 row with repeated ids; ids past the row
    are dropped."""
    gen = torch.Generator().manual_seed(3)
    n, trash = 5000, 1000
    vis = torch.full((8, n + trash), 255, dtype=torch.uint8)
    ids = torch.stack([torch.randperm(n + trash + 40, generator=gen)[:900]
                       for _ in range(8)]).int()
    vis, ids = vis.to(cuda), ids.to(cuda)
    before = _launches()
    got = vo.scatter_set(vis.clone(), ids, 3)
    assert _launches() == (before[0], before[1], before[2] + 1)
    torch.testing.assert_close(got, vo.scatter_set_plain(vis.clone(), ids, 3),
                               rtol=0, atol=0)
    flat = torch.zeros(200_064, dtype=torch.int32, device=cuda)
    dup = torch.randint(0, 200_064, (12_800,), generator=gen,
                        dtype=torch.int32).to(cuda)
    torch.testing.assert_close(vo.scatter_set(flat.clone(), dup, 7),
                               vo.scatter_set_plain(flat.clone(), dup, 7),
                               rtol=0, atol=0)


def test_visited_ops_reject_what_they_do_not_take(cuda):
    vis = torch.zeros((2, 10), dtype=torch.uint8, device=cuda)
    ids = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        vo.gather_elems(vis.float(), ids, 5)
    with pytest.raises(ValueError):
        vo.scatter_set(vis, ids.cpu(), 1)


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


_PATH_CASES = _bench_visited().plan_bounds(vo, vo.H100_SMS)


def _element_inputs(op, dtype, rows, M, span, seed):
    """A table of `rows` x (span + 7) (a scatter's: rows x span) and ids in
    [-9, W + 9): below 0, past the clip bound and past the row, with
    repeats."""
    gen = torch.Generator().manual_seed(seed)
    W = span + 7
    width = span if op == "scatter" else W
    table = torch.randint(0, 250, (rows, width), generator=gen,
                          dtype=torch.int32).to(dtype)
    ids = torch.randint(-9, W + 9, (rows, M), generator=gen, dtype=torch.int32)
    arg = 7 if op == "scatter" else span - 1
    return table, ids, arg


def _run_element(op, table, ids, arg):
    """(kernel, plain) outputs; a scatter on two copies of the table."""
    if op == "gather":
        return (vo.gather_elems(table, ids, arg),
                vo.gather_elems_plain(table, ids, arg))
    return (vo.scatter_set(table.clone(), ids, arg),
            vo.scatter_set_plain(table.clone(), ids, arg))


@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("case", range(len(_PATH_CASES)))
def test_element_kernels_match_plain_on_both_paths(cuda, op, dtype, case):
    """gather_elems and scatter_set bit-exact against their plain versions
    on each side of every plan bound (scripts/bench_visited.py's
    plan_bounds; only an int32 gather is staged): odd
    widths, hi below the row's end, ids below 0 and past the row, repeated
    ids (a scatter's store one value), a row and its ids filling a block's
    shared memory."""
    label, rows, M, span, staged = _PATH_CASES[case]
    table, ids, arg = _element_inputs(op, dtype, rows, M, span, case)
    table, ids = table.to(cuda), ids.to(cuda)
    staged &= op == "gather" and dtype == torch.int32
    assert vo.visited_plan(op, table, ids, arg).path == \
        ("staged" if staged else "global"), label
    before = _launches()
    got, want = _run_element(op, table, ids, arg)
    torch.cuda.synchronize()
    assert _launches()[0 if op == "gather" else 2] == \
        before[0 if op == "gather" else 2] + 1
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_element_kernels_take_ids_off_16_bytes(cuda, op, dtype, offset):
    """Ids whose base is not 16-byte aligned (a view at an offset), on a
    shared row and on per-query rows of both paths (the last shape stages an
    int32 gather)."""
    gen = torch.Generator().manual_seed(offset)
    for rows, W, M in ((1, 5003, 999), (6, 501, 333), (6, 4099, 37),
                       (64, 8003, 4097)):
        shared = rows == 1
        table = torch.randint(0, 250, (W,) if shared else (rows, W),
                              generator=gen, dtype=torch.int32).to(dtype)
        flat = torch.randint(-9, W + 9, (rows * M + offset,), generator=gen,
                             dtype=torch.int32).to(cuda)
        ids = flat[offset:].view(rows, M)
        assert ids.data_ptr() % 16 != 0
        arg = 7 if op == "scatter" else W - 2
        table = table.to(cuda)
        staged = vo.visited_plan(op, table, ids, arg).path == "staged"
        assert staged == (rows == 64 and op == "gather"
                          and dtype == torch.int32)
        _assert_bits_equal(*_run_element(op, table, ids, arg))


@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["uint8", "int32"])
def test_element_kernels_take_more_rows_than_the_grid_height(cuda, op, dtype):
    """Past MAX_GRID_Y query rows the grid's rows stride over the rest."""
    rows = vo.MAX_GRID_Y + 7
    table, ids, arg = _element_inputs(op, dtype, rows, 3, 5, rows)
    assert vo.visited_plan(op, table, ids, arg).grid[1] == vo.MAX_GRID_Y
    _assert_bits_equal(*_run_element(op, table.to(cuda), ids.to(cuda), arg))


@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_query", "shared"])
def test_element_kernels_take_empty_ids(cuda, op, shared):
    table = torch.arange(60, dtype=torch.int32, device=cuda)
    if not shared:
        table = table.view(3, 20)
    ids = torch.empty((3, 0), dtype=torch.int32, device=cuda)
    before = _launches()
    got, want = _run_element(op, table, ids, 7 if op == "scatter" else 19)
    assert _launches() == before
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("case", range(len(_PATH_CASES)))
def test_visited_plan_matches_the_library(cuda, op, dtype, case):
    """The wrapper's plan is the library's at the device's SM count, and the
    device holds the blocks an SM the plan counts on: one wave of
    WAVE_BLOCKS_PER_SM on the global path, one staged block; a staged block
    of span and ids that fill shared memory takes all of it."""
    _label, rows, M, span, _staged = _PATH_CASES[case]
    table, ids, arg = _element_inputs(op, dtype, rows, M, span, case)
    table, ids = table.to(cuda), ids.to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got, blocks = vo.library_plan(op, table, ids, arg)
    assert got == vo.visited_plan(op, table, ids, arg, sms)
    assert blocks >= (1 if got.path == "staged" else vo.WAVE_BLOCKS_PER_SM)
    if got.path == "staged" and \
            _PATH_CASES[case][0] == "span and ids filling shared memory":
        assert got.smem_bytes == vo.BLOCK_SMEM


def test_visited_ops_opt_in_once_per_device(cuda):
    """The shared-memory opt-in runs once per device (nann_visited_init),
    not in a launch: many staged and global launches in a row all agree
    with the plain versions."""
    import os
    src = open(os.path.join(os.path.dirname(vo.__file__), os.pardir, "csrc",
                            "visited_ops.cu")).read()
    launches = src[src.index("template <typename T>\nint launch_gather_elems"):
                   src.index("// The kernel of a")]
    assert "cudaFuncSetAttribute" not in launches
    for _ in range(4):
        for dtype in (torch.uint8, torch.int32):
            for case in (0, 1, len(_PATH_CASES) - 1):
                _label, rows, M, span, _ = _PATH_CASES[case]
                for op in ("gather", "scatter"):
                    table, ids, arg = _element_inputs(op, dtype, rows, M,
                                                      span, case)
                    _assert_bits_equal(*_run_element(op, table.to(cuda),
                                                     ids.to(cuda), arg))
    assert vo._init.cache_info().currsize == 1


def test_bytemap_search_kernel_path(cuda, tmp_path):
    """The byte-map search on the kernels: every new kernel launches, its
    ids equal the list search's (the same scorer kernel scores the same
    fresh rows), and it overlaps its plain path."""
    mcfg = NARROW
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((3000, mcfg.item_emb_dim)).astype(np.float32)
    build_and_save_index(embs, 2, 16, str(tmp_path), ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(str(tmp_path), 2), embs,
                                       np.arange(3000), device=cuda)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(1), cuda)
    users = torch.from_numpy(rng.standard_normal(
        (16, mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32))
    out = {}
    for vis_impl in ("list", "bytemap"):
        scfg = SearchConfig(frontier_cap=512, vis_impl=vis_impl)
        before = _launches()
        out[vis_impl] = make_searcher(mcfg, scfg)(
            params, state, index, users, level_topn_default(scfg))
        after = _launches()
    assert all(a > b for a, b in zip(after, before))
    for a, b in zip(out["list"], out["bytemap"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    plain = make_searcher(mcfg, scfg, scorer_impl="plain")(
        params, state, index, users, level_topn_default(scfg))
    assert _launches() == after
    gi, wi = out["bytemap"][0].cpu().numpy(), plain[0].cpu().numpy()
    overlap = np.mean([len(np.intersect1d(g[g >= 0], w[w >= 0]))
                       / max((w >= 0).sum(), 1) for g, w in zip(gi, wi)])
    assert overlap >= 0.99


# ------------------------------------- the row sort, top-k and lane gather


def _edge_rows(B, W, dtype, seed):
    """Rows salted with what a select can get wrong: many ties, runs of
    -inf, -0.0 beside +0.0 (float32); negative keys, the extremes of int32
    and thousands of equal pads (int32)."""
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.float32:
        x = torch.randint(-8, 8, (B, W), generator=gen).float() / 4
        x[torch.rand((B, W), generator=gen) < 0.2] = float("-inf")
        x[:, W // 3:W // 3 + W // 10] = float("-inf")
        x[torch.rand((B, W), generator=gen) < 0.1] = -0.0
        x[0] = torch.randn(W, generator=gen)
    else:
        x = torch.randint(-2**31, 2**31 - 1, (B, W), generator=gen,
                          dtype=torch.int32)
        x[:, ::3] = 2**31 - 1
        x[:, 1::7] = -(2**31)
        x[1:, 2::5] = torch.randint(-3, 3, (B - 1, len(range(2, W, 5))),
                                    generator=gen, dtype=torch.int32)
    return x


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


_T, _S = so.SORT_TILE, so.SHORT_ROW


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("W", [1, 128, 2970, _T - 1, _T, _T + 1, _S,
                               2 * _T + 1, 3 * _T - 1, 3 * _T, 3 * _T + 1,
                               33992, 100_000])
def test_row_sort_matches_plain(cuda, dtype, B, W):
    """Every boundary of the design: short rows (one block) up to S = 2T,
    then tiles of T keys (S + 1 = 2T + 1 is the first tiled width, three
    tiles, the last holding one key), the search's widths and the ops
    layer's [1, 100,000]."""
    x = _edge_rows(B, W, dtype, W).to(cuda)
    before = so.row_sort.launches
    got, perm = so.row_sort(x, with_perm=True)
    assert so.row_sort.launches == before + 1
    want, want_perm = so.row_sort_plain(x, with_perm=True)
    _assert_bits_equal(got, want)
    torch.testing.assert_close(perm, want_perm, rtol=0, atol=0)
    _assert_bits_equal(so.row_sort(x), want)


@pytest.mark.parametrize("W", [5000, 3 * _T + 5], ids=["short", "tiled"])
@pytest.mark.parametrize("kind", ["equal", "low_digit", "middle_digits",
                                  "tagged"])
def test_row_sort_skips_shared_digits(cuda, W, kind):
    """Rows whose keys share digits: every digit (no pass runs: the row as
    it is), all but the lowest, the two outer ones, and the list merge's
    tagged keys (id << 1 | flag, high digits shared)."""
    gen = torch.Generator().manual_seed(W)
    B = 3
    if kind == "equal":
        x = torch.full((B, W), -7, dtype=torch.int32)
    elif kind == "low_digit":
        x = torch.randint(0, 256, (B, W), generator=gen, dtype=torch.int32)
    elif kind == "middle_digits":
        x = torch.randint(0, 2**16, (B, W), generator=gen,
                          dtype=torch.int32) << 8
    else:
        x = (torch.randint(0, 100_000, (B, W), generator=gen,
                           dtype=torch.int32) << 1) | torch.randint(
                               0, 2, (B, W), generator=gen, dtype=torch.int32)
    x = x.to(cuda)
    got, perm = so.row_sort(x, with_perm=True)
    want, want_perm = so.row_sort_plain(x, with_perm=True)
    _assert_bits_equal(got, want)
    torch.testing.assert_close(perm, want_perm, rtol=0, atol=0)


@pytest.mark.parametrize("W", [2970, _S, 33992])
def test_row_sort_is_deterministic(cuda, W):
    """Two calls give the same bits: a key's place never depends on which
    block ran first."""
    x = _edge_rows(64, W, torch.float32, W + 1).to(cuda)
    first = so.row_sort(x, with_perm=True)
    second = so.row_sort(x, with_perm=True)
    _assert_bits_equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_row_sort_plan_matches_the_library(cuda):
    """`_sort_plan`'s scratch is the library's, the library refuses a
    scratch one word short, and both paths fit two blocks on an SM."""
    lib = so._library()
    for B, W in [(1, _S + 1), (3, 3 * _T), (64, 33992), (1, 100_000)]:
        assert lib.nann_row_sort_scratch_words(B, W) == so._sort_plan(B, W)[2]
    x = torch.zeros((2, 3 * _T), dtype=torch.int32, device=cuda)
    words = so._sort_plan(2, 3 * _T)[2]
    scratch = torch.empty(words, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        so._launch("nann_row_sort", so.SelectArgs(
            x=x.data_ptr(), out=torch.empty_like(x).data_ptr(),
            scratch=scratch.data_ptr(), B=2, W=3 * _T,
            scratch_words=words - 1), x.device)
    for path in so.SORT_PATHS:
        assert so.blocks_per_sm(path, cuda) >= 2


# (W, k): the search's widths and the paths' boundaries (short rows up to
# S keys, tiles above; k = W; k above S, whose winners go through the tiled
# sort), with k in {1, W, 200, 4096, S, S + 1} where k <= W, and the
# search's ground merge [4496] k 400
_TOPK_WK = sorted({(W, k)
                   for W in (1, 7, 90, 400, 2970, 4496, _S, _S + 1, 25600,
                             33992, 100_000)
                   for k in (1, W, 200, 4096, _S, _S + 1) if k <= W}
                  | {(4496, 400)})


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("W,k", _TOPK_WK)
def test_row_topk_matches_plain(cuda, dtype, largest, B, W, k):
    x = _edge_rows(B, W, dtype, W + k).to(cuda)
    before = so.row_topk.launches
    got_v, got_i = so.row_topk(x, k, largest)
    assert so.row_topk.launches == before + 1
    want_v, want_i = so.row_topk_plain(x, k, largest)
    _assert_bits_equal(got_v, want_v)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)


@pytest.mark.parametrize("W,k", [(4496, 400), (33992, 4096), (100_000, 200)])
def test_row_topk_is_deterministic(cuda, W, k):
    """Two calls give the same bits: no place depends on which block ran
    first."""
    x = _edge_rows(64, W, torch.float32, W + 2).to(cuda)
    first, second = so.row_topk(x, k), so.row_topk(x, k)
    _assert_bits_equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("kind", ["equal", "neginf_run", "one_digit"])
@pytest.mark.parametrize("W,k", [(5000, 1), (5000, 200), (5000, 4096),
                                 (33992, 1), (33992, 200), (33992, 4096),
                                 (33992, _S + 1)])
def test_row_topk_tie_group_spans_tiles(cuda, kind, W, k):
    """Tie groups across tiles (and across a short row's warps), taken
    lowest index first: every key equal; a run of -inf from key 100 to
    W - 100 after random keys, so that the k-th largest of a k above the 200
    finite keys is -inf inside the run; float32 keys in [1, 2), which all
    share their first digit (every seventh 1.5)."""
    gen = torch.Generator().manual_seed(k)
    if kind == "equal":
        x = torch.full((3, W), -2.5)
    elif kind == "neginf_run":
        x = torch.randn((3, W), generator=gen)
        x[:, 100:W - 100] = float("-inf")
    else:
        x = 1 + torch.rand((3, W), generator=gen)
        x[:, ::7] = 1.5
    x = x.to(cuda)
    for largest in (True, False):
        got_v, got_i = so.row_topk(x, k, largest)
        want_v, want_i = so.row_topk_plain(x, k, largest)
        _assert_bits_equal(got_v, want_v)
        torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)


def test_row_topk_plan_matches_the_library(cuda):
    """`_topk_plan`'s scratch is the library's, and the library refuses a
    tiled top-k's scratch one word short."""
    lib = so._library()
    for B, W, k in [(1, _S, 200), (1, _S + 1, 1), (3, 3 * _T, _S),
                    (64, 33992, 4096), (64, 33992, _S + 1),
                    (64, 100_000, 200)]:
        assert lib.nann_row_topk_scratch_words(B, W, k) == \
            so._topk_plan(B, W, k)[2]
    x = torch.zeros((2, 3 * _T), device=cuda)
    words = so._topk_plan(2, 3 * _T, 200)[2]
    scratch = torch.empty(words, dtype=torch.int32, device=cuda)
    out = torch.empty((2, 200), device=cuda)
    idx = torch.empty((2, 200), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        so._launch("nann_row_topk", so.SelectArgs(
            x=x.data_ptr(), out=out.data_ptr(), perm=idx.data_ptr(),
            scratch=scratch.data_ptr(), B=2, W=3 * _T, K=200,
            scratch_words=words - 1, is_float=1, largest=1), x.device)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
def test_take_along_matches_plain(cuda, dtype):
    """The lane gather is gather_elems of a per-query table, hi = W - 1;
    float32 moves as its bits. Indices past either end are clipped."""
    gen = torch.Generator().manual_seed(5)
    table = _edge_rows(8, 25600, dtype, 5).to(cuda).view(torch.int32)
    idx = torch.randint(-8, 25608, (8, 8192), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = vo.gather_elems.launches
    got = beam._take_along(so.selects(), table, idx)
    assert vo.gather_elems.launches == before + 1
    _assert_bits_equal(got, vo.gather_elems_plain(table, idx, 25599))


def test_selects_reject_what_they_do_not_take(cuda):
    x = torch.zeros((2, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        so.row_sort(x.long())
    with pytest.raises(ValueError):
        so.row_topk(x, 11)
    with pytest.raises(ValueError):
        beam._take_along(so.selects(), x, x.cpu())


def test_list_search_kernel_selects_equal_plain_selects(cuda, tmp_path,
                                                         monkeypatch):
    """One scorer (the kernel), the selects on the kernels or on their plain
    versions: ids, scores and num_scoring are identical, and each select
    kernel launched."""
    mcfg = NARROW
    scfg = SearchConfig(frontier_cap=512)
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((3000, mcfg.item_emb_dim)).astype(np.float32)
    build_and_save_index(embs, 2, 16, str(tmp_path), ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(str(tmp_path), 2), embs,
                                       np.arange(3000), device=cuda)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(1), cuda)
    users = torch.from_numpy(rng.standard_normal(
        (16, mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32))
    args = (params, state, index, users, level_topn_default(scfg))
    wrappers = (so.row_sort, so.row_topk, vo.gather_elems)
    before = [w.launches for w in wrappers]
    got = make_searcher(mcfg, scfg)(*args)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    plain = so.selects(plain=True)
    monkeypatch.setattr(so, "selects", lambda plain_=False: plain)
    want = make_searcher(mcfg, scfg)(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------- serving engine


def test_kernel_inits_run_twice_harmlessly(cuda):
    """Two engines' threads can both miss a once-per-device init's cache
    (functools.lru_cache runs the body in each): every init run again, from
    two threads at once, leaves the kernels launching and agreeing with
    their plain versions."""
    import threading
    index = torch.cuda.current_device()
    inits = (fs._init, so._init, vo._init)
    for init in inits:
        init(index)
    errors = []

    def run_all():
        try:
            for init in inits:
                init.__wrapped__(index)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run_all) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    args = _inputs(SERVING, torch.bfloat16, cuda, B=2, F=300)
    got, want = fs.score_frontier(*args), fs.frontier_scorer_plain(*args)
    valid = args[-1]
    assert ((got - want)[valid].abs() / (1 + want[valid].abs())).max() <= \
        TOL[torch.bfloat16]
    keys = torch.randn(4, 9000, device=cuda)
    _assert_bits_equal(so.row_sort(keys), so.row_sort_plain(keys))
    table, ids, arg = _element_inputs("gather", torch.int32,
                                      *_PATH_CASES[-1][1:4], 0)
    _assert_bits_equal(*_run_element("gather", table.to(cuda), ids.to(cuda),
                                      arg))


def test_engine_on_the_card(cuda, tmp_path):
    """The serving engine on CUDA: pinned uploads and copies, CUDA-event
    device times, one wait per drain; answers equal the direct search before
    and after a model swap, and a model on another device is refused."""
    from nann_tpu_torch.serving import Engine, EngineConfig
    from nann_tpu_torch.serving.pool import _place
    mcfg, scfg = NARROW, SearchConfig(frontier_cap=512)
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((3000, mcfg.item_emb_dim)).astype(np.float32)
    build_and_save_index(embs, 2, 16, str(tmp_path), ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(str(tmp_path), 2), embs,
                                       np.arange(3000), device="cpu")
    models = [_place(*init_scorer(mcfg, torch.Generator().manual_seed(s),
                                  "cpu"), index, cuda) for s in (1, 2)]
    users = rng.standard_normal(
        (24, mcfg.max_seq_length, mcfg.user_emb_dim)).astype(np.float32)
    ltn = level_topn_default(scfg)
    search = make_searcher(mcfg, scfg)
    eng = Engine(mcfg, scfg, *models[0],
                 EngineConfig(batch_buckets=(1, 4, 16), wait_ms=2.0))
    try:
        for model in models:
            eng.swap_model(*model)
            items, scores, _ = (x.cpu().numpy() for x in search(
                *model, torch.from_numpy(users), ltn))
            futures = [eng.submit(u) for u in users]
            for i, f in enumerate(futures):
                got_items, got_scores = f.result(timeout=60)
                keep = items[i] >= 0
                np.testing.assert_array_equal(got_items, items[i][keep])
                np.testing.assert_array_equal(got_scores, scores[i][keep])
        with pytest.raises(ValueError, match="serves on cuda"):
            eng.swap_model(*_place(*models[0], "cpu"))
        deadline = time.perf_counter() + 60
        while (eng.metrics.device_us.snapshot()["count"]
               != eng.metrics.batch_size.snapshot()["count"]
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        dev_us = eng.metrics.device_us.snapshot()
        assert dev_us["count"] == eng.metrics.batch_size.snapshot()["count"]
        assert dev_us["p50"] > 0 and eng.metrics.failures.count == 0
    finally:
        eng.shutdown()


def _train_inputs(mcfg, tcfg, n_items=5000, B=64, seed=0):
    """A batch, its targets (drawn on the CPU) and starting parameters, all
    on the CPU."""
    from nann_tpu_torch.train import objective
    gen = torch.Generator().manual_seed(seed)
    L = mcfg.max_seq_length
    probs = torch.rand(n_items, generator=gen) + 0.01
    probs /= probs.sum()
    batch = {"item_ids": torch.randint(0, n_items + 1, (B, L), generator=gen,
                                       dtype=torch.int32),
             "cate_ids": torch.randint(0, mcfg.num_cate + 1, (B, L),
                                       generator=gen, dtype=torch.int32),
             "gt_item_id": torch.randint(1, n_items + 1, (B,), generator=gen,
                                         dtype=torch.int32),
             "gt_cate_id": torch.randint(1, mcfg.num_cate + 1, (B,),
                                         generator=gen, dtype=torch.int32)}
    batch["weight_tag"] = probs[batch["gt_item_id"].long() - 1]
    targets = objective.build_targets(
        gen, batch, torch.arange(1, n_items + 1, dtype=torch.int32),
        torch.randint(1, mcfg.num_cate + 1, (n_items,), generator=gen,
                      dtype=torch.int32), torch.log(1e-20 + probs), probs,
        tcfg.num_neg)
    params, state = init_scorer(mcfg, gen, device="cpu")
    return batch, targets, params, state


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """nann_loss and its gradients on the card against the CPU on the same
    parameters and targets, float32: loss rtol 1e-5, gradients atol 1e-5
    (another summation order, and FGSM's sign of an element near 0)."""
    import dataclasses
    from nann_tpu_torch.config import TrainConfig
    from nann_tpu_torch.train import objective
    from nann_tpu_torch.train.step import named_leaves, train_state_from
    mcfg = dataclasses.replace(NARROW, num_item=5000, num_cate=40)
    tcfg = TrainConfig(batch_size=64, num_neg=20, adv_eps=1e-3)
    batch, targets, params, state = _train_inputs(mcfg, tcfg)
    out = []
    for dev in ("cpu", cuda):
        st = train_state_from(_tree_to(params, dev), _tree_to(state, dev),
                              tcfg)
        loss, (_, metrics) = objective.nann_loss(
            st.params, st.bn_state, mcfg, tcfg, _tree_to(batch, dev),
            _tree_to(targets, dev))
        loss.backward()
        out.append((float(loss.detach()), {
            k: leaf.grad.cpu() for k, leaf in named_leaves(st.params)},
            float(metrics["loss_adv"])))
    (loss_c, grads_c, _), (loss_g, grads_g, adv_g) = out
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    assert adv_g >= 0
    for k in grads_c:
        torch.testing.assert_close(grads_g[k], grads_c[k], rtol=0, atol=1e-5,
                                   msg=k)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.detach().clone().to(dev)


@pytest.mark.parametrize("n,k", [(300_000, 4096), (300_000, 20_000)])
def test_sample_negatives_kernel_equals_plain(cuda, n, k):
    """The sampler through row_topk on the card against the plain top-k of
    the same Gumbel-perturbed row: the same index set (and order)."""
    from nann_tpu_torch.train import sampler
    probs = torch.rand(n, generator=torch.Generator().manual_seed(n)) + 1e-3
    log_probs = torch.log(probs / probs.sum()).to(cuda)
    keys = sampler.gumbel_keys(torch.Generator(cuda).manual_seed(5),
                               log_probs)
    before = so.row_topk.launches
    got = sampler.sample_negatives(torch.Generator(cuda).manual_seed(5),
                                   log_probs, k)
    assert so.row_topk.launches == before + 1
    want = so.row_topk_plain(keys, k)[1].reshape(-1)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (k,)
    assert set(got.tolist()) == set(want.tolist())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_tree_search_kernel_path_equals_plain_path(cuda, dt):
    """The tree search at the CLI's beam 200 and branch 16 (3,200-row
    frontiers, unpadded) through the scorer kernel, row_topk and the
    gathers, against its plain path; every kernel of the path launches."""
    from nann_tpu_torch.index import build_tree
    from nann_tpu_torch.search import DeviceTree, make_tree_searcher
    mcfg = ModelConfig(emb_dim=32, max_seq_length=50, compute_dtype=dt)
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((5000, mcfg.item_emb_dim)).astype(np.float32)
    tree = DeviceTree.from_tree(build_tree(embs, branch=16),
                                np.arange(1, 5001), dtype=dt, device=cuda)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(1),
                                device=cuda)
    users = torch.randn((16, 50, mcfg.user_emb_dim),
                        generator=torch.Generator().manual_seed(2))
    ops = (fs.score_frontier, so.row_topk, vo.gather_elems, vo.gather_rows)
    before = [op.launches for op in ops]
    got = make_tree_searcher(mcfg, beam_width=200, topk=200)(
        params, state, tree, users)
    torch.cuda.synchronize()
    assert all(op.launches > b for op, b in zip(ops, before))
    want = make_tree_searcher(mcfg, beam_width=200, topk=200,
                              scorer_impl="plain")(params, state, tree, users)
    gi, gs = (t.cpu().numpy() for t in got)
    wi, ws = (t.cpu().numpy() for t in want)
    overlaps = []
    for q in range(len(gi)):
        assert len(np.unique(gi[q])) == 200 and gi[q].min() >= 1
        common, g_at, w_at = np.intersect1d(gi[q], wi[q],
                                            return_indices=True)
        overlaps.append(len(common) / 200)
        rel = np.abs(gs[q][g_at] - ws[q][w_at]) / (1 + np.abs(ws[q][w_at]))
        assert rel.max() <= TOL[getattr(torch, dt)]
    assert np.mean(overlaps) >= 0.98, overlaps


@pytest.fixture
def solo_group(cuda):
    """A gloo world of this one process (the sharded lookup's group)."""
    import socket
    import torch.distributed as dist
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _lookup_case(cuda, lo=3000, rows=2000, width=32):
    """A dense float32 table [6000, width], this rank's block of it (rows
    [lo, lo + rows)), ids over the whole table with repeats, a cotangent."""
    gen = torch.Generator().manual_seed(width)
    dense = torch.randn((6000, width), generator=gen)
    ids = torch.randint(0, 6000, (400, 201), generator=gen, dtype=torch.int32)
    ids[0, :50] = lo + 7
    ct = torch.randn((400, 201, width), generator=gen)
    return (dense.to(cuda), dense[lo:lo + rows].contiguous().to(cuda),
            ids.to(cuda), ct.to(cuda))


def test_sharded_lookup_matches_plain(cuda, solo_group):
    """The row-sharded lookup's forward through the gather_rows kernel
    equals its plain version: the owned rows of the dense table, zeros for
    the rows other ranks own."""
    from nann_tpu_torch.parallel import collectives
    lo, rows = 3000, 2000
    dense, block, ids, _ = _lookup_case(cuda, lo, rows)
    before = vo.gather_rows.launches
    got = collectives.sharded_lookup(block, ids, lo, solo_group)
    torch.cuda.synchronize()
    assert vo.gather_rows.launches == before + 1
    mine = (ids >= lo) & (ids < lo + rows)
    want = torch.where(mine[..., None], dense[ids.long()], 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = collectives.sharded_lookup(block, ids, lo, solo_group,
                                       vo.gather_rows_plain)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_sharded_lookup_backward_matches_index_add(cuda, solo_group):
    """Its backward: the block's rows of index_add_ of the gradient rows
    into a dense table."""
    from nann_tpu_torch.parallel import collectives
    lo, rows = 3000, 2000
    dense, block, ids, ct = _lookup_case(cuda, lo, rows)
    block.requires_grad_(True)
    (collectives.sharded_lookup(block, ids, lo, solo_group) * ct
     ).sum().backward()
    want = torch.zeros_like(dense).index_add_(
        0, ids.reshape(-1).long(), ct.reshape(-1, ct.shape[-1]))
    torch.testing.assert_close(block.grad, want[lo:lo + rows], rtol=1e-5,
                               atol=1e-5)
