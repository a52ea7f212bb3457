"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the frontier scorer on float tables and on packed int8 tables.

These tests need an NVIDIA GPU with nvcc (they build the kernels) and skip
elsewhere. They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerances: float32 2e-4 x (1 + |ref|) (another summation order), bfloat16
0.05 x (1 + |ref|) (a layer's rounding may fall to the next bf16 value),
those of tests/test_scorer_kernel.py.
"""

import numpy as np
import pytest
import torch

from nann_tpu_torch.config import ModelConfig, SearchConfig
from nann_tpu_torch.index import build_and_save_index, load_index
from nann_tpu_torch.index.quantize import pack_quantized
from nann_tpu_torch.kernels import frontier_scorer as fs
from nann_tpu_torch.models import init_scorer
from nann_tpu_torch.ops import fold_scorer, precompute_user
from nann_tpu_torch.search import SearchIndex, level_topn_default, make_searcher

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


def test_kernel_is_deterministic_per_row(cuda):
    """A row's score does not depend on the batch around it (the engine pads
    and groups requests freely)."""
    w, k_proj, v, table, ids, valid = _inputs(SERVING, torch.bfloat16, cuda)
    full = fs.score_frontier(w, k_proj, v, table, ids, valid)
    one = fs.score_frontier(w, k_proj[2:3].contiguous(), v[2:3].contiguous(),
                            table, ids[2:3].contiguous(),
                            valid[2:3].contiguous())
    assert torch.equal(full[2:3], one)


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
