"""The port's scorer against the JAX package: layers, scorer_forward, the
folded scorer, its plain frontier scorer, and the Pallas kernel in interpret
mode. Inputs come from numpy with a seed; JAX parameters reach the port
through params_from_jax.

Tolerances are those of tests/test_scorer_kernel.py: 2e-4 in float32 (two
libraries summing in different orders), 0.05 in bfloat16 (rounding of the
intermediate layers falls differently).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nann_tpu.config import ModelConfig as JModelConfig
from nann_tpu.delivery.export import _flatten
from nann_tpu.experimental.pallas_scorer import make_pallas_frontier_scorer
from nann_tpu.models import init_scorer as j_init_scorer
from nann_tpu.models import layers as j_layers
from nann_tpu.models import scorer as j_scorer
from nann_tpu.ops import scorer_kernel as j_sk

from nann_tpu_torch.config import ModelConfig
from nann_tpu_torch.kernels import frontier_scorer as fs
from nann_tpu_torch.models import init_scorer, params_from_jax, scorer_forward
from nann_tpu_torch.models import layers
from nann_tpu_torch.models.scorer import flatten
from nann_tpu_torch.ops import fold_scorer, precompute_user, \
    score_frontier_reference

SMALL = dict(num_item=50, num_cate=10, emb_dim=16, max_seq_length=12,
             item_tower_dims=(32, 32, 32), head_dims=(64, 32, 16, 1))
TOL = {"float32": 2e-4, "bfloat16": 0.05}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def jax_model(seed: int = 0, compute_dtype: str = "float32"):
    """JAX params with non-trivial batch-norm statistics (so folding is
    exercised) -> (jax mcfg, params, state, flat bundle arrays)."""
    jcfg = JModelConfig(**SMALL, compute_dtype=compute_dtype)
    params, state = jax.jit(lambda key: j_init_scorer(key, jcfg))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for tower in ("item_tower", "head"):
        for p, s in zip(params[tower], state[tower]):
            if "bn" in s:
                dim = s["bn"]["mean"].shape[0]
                s["bn"] = {"mean": jnp.asarray(rng.normal(0, .3, dim), jnp.float32),
                           "var": jnp.asarray(rng.uniform(.5, 2, dim), jnp.float32)}
                p["bn"] = {"gamma": jnp.asarray(rng.uniform(.5, 1.5, dim), jnp.float32),
                           "beta": jnp.asarray(rng.normal(0, .1, dim), jnp.float32)}
    flat = {**_flatten(params), **_flatten(state)}
    return jcfg, params, state, flat


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def model():
    jcfg, jp, js, flat = jax_model()
    params, state = params_from_jax(flat, device="cpu")
    rng = np.random.default_rng(1)
    user = rng.standard_normal((3, 12, 32)).astype(np.float32)
    items = rng.standard_normal((3, 256, 32)).astype(np.float32)
    return jcfg, jp, js, flat, params, state, user, items


def test_params_from_jax_round_trips_every_name(model):
    _jcfg, _jp, _js, flat, params, state = model[:6]
    back = {**flatten(params), **flatten(state)}
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)


def test_init_scorer_has_the_jax_structure():
    jcfg, jp, js, _ = jax_model()
    params, state = init_scorer(port_config(jcfg),
                                torch.Generator().manual_seed(0), device="cpu")
    want = {**_flatten(jp), **_flatten(js)}
    got = {**flatten(params), **flatten(state)}
    assert {k: v.shape for k, v in got.items()} == \
        {k: np.asarray(v).shape for k, v in want.items()}


def test_init_scorer_is_seeded():
    mcfg = ModelConfig(**SMALL)
    a = flatten(init_scorer(mcfg, torch.Generator().manual_seed(3), "cpu")[0])
    b = flatten(init_scorer(mcfg, torch.Generator().manual_seed(3), "cpu")[0])
    c = flatten(init_scorer(mcfg, torch.Generator().manual_seed(4), "cpu")[0])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["att/q1/kernel"], c["att/q1/kernel"])


@pytest.mark.parametrize("op", ["dense", "prelu", "batch_norm", "dnn_apply"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layers_match_jax(model, op, dt):
    _jcfg, jp, js, _flat, params, state = model[:6]
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    jblock, tblock = jp["head"][0], params["head"][0]
    jbn, tbn = js["head"][0]["bn"], state["head"][0]["bn"]
    if op == "dense":
        want = j_layers.dense(jblock["dense"], jnp.asarray(x), jdt)
        got = layers.dense(tblock["dense"], t(x), tdt)
    elif op == "prelu":
        want = j_layers.prelu(jblock["prelu"], jnp.asarray(x[:, :64], jdt))
        got = layers.prelu(tblock["prelu"], t(x).to(tdt))
    elif op == "batch_norm":
        want, _ = j_layers.batch_norm(jblock["bn"], jbn,
                                      jnp.asarray(x, jdt), False)
        got = layers.batch_norm(tblock["bn"], tbn, t(x).to(tdt))
    else:
        want, _ = j_layers.dnn_apply(jblock, js["head"][0], jnp.asarray(x),
                                     False, "bn", "prelu", compute_dtype=jdt)
        got = layers.dnn_apply(tblock, state["head"][0], t(x), "bn", "prelu",
                               compute_dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_scorer_forward_matches_jax(dt):
    jcfg, jp, js, flat = jax_model(seed=5, compute_dtype=dt)
    params, state = params_from_jax(flat, device="cpu")
    rng = np.random.default_rng(5)
    user = rng.standard_normal((2, 12, 32)).astype(np.float32)
    items = rng.standard_normal((2, 64, 32)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, u, i: j_scorer.scorer_forward(
        p, s, jcfg, u, i, training=False))(jp, js, user, items)
    got = scorer_forward(params, state, port_config(jcfg), t(user), t(items))
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL[dt], atol=TOL[dt])


def test_fold_scorer_matches_jax(model):
    jcfg, jp, js, _flat, params, state = model[:6]
    want = j_sk.fold_scorer(jp, js, jcfg)
    got = fold_scorer(params, state, port_config(jcfg))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_precompute_user_matches_jax(model, dt):
    jcfg, jp, js, _flat, params, state, user, _ = model
    jdt, tdt = DTYPES[dt]
    jf = j_sk.fold_scorer(jp, js, jcfg)
    folded = fold_scorer(params, state, port_config(jcfg))
    k_proj, v = precompute_user(folded, t(user), tdt)
    wk, wv = jax.jit(jax.vmap(lambda u: j_sk.precompute_user(jf, u, dt=jdt)))(
        user)
    np.testing.assert_allclose(k_proj.float().numpy(),
                               np.asarray(wk, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(wv, np.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_score_frontier_reference_matches_jax(model, dt):
    jcfg, jp, js, _flat, params, state, user, items = model
    jdt, tdt = DTYPES[dt]
    jf = j_sk.fold_scorer(jp, js, jcfg)
    folded = fold_scorer(params, state, port_config(jcfg))
    k_proj, v = precompute_user(folded, t(user), tdt)
    got = score_frontier_reference(folded, k_proj, v, t(items), tdt)

    @jax.jit
    @jax.vmap
    def want_fn(u, e):
        wk, wv = j_sk.precompute_user(jf, u, dt=jdt)
        return j_sk.score_frontier_reference(jf, wk, wv, e, dt=jdt)

    np.testing.assert_allclose(got.numpy(), np.asarray(want_fn(user, items)),
                               rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_scorer_matches_pallas_interpret(model, dt):
    """The Pallas kernel pads the sequence to 128 lanes and masks the pad to
    -inf; the port attends over exactly L keys. Both must agree."""
    jcfg, jp, js, _flat, params, state, user, items = model
    jdt, tdt = DTYPES[dt]
    jf = j_sk.fold_scorer(jp, js, jcfg)
    score = make_pallas_frontier_scorer(jcfg, tile=256, interpret=True)
    folded = fold_scorer(params, state, port_config(jcfg))
    k_proj, v = precompute_user(folded, t(user[:1]), tdt)
    got = score_frontier_reference(folded, k_proj, v, t(items[:1]), tdt)[0]
    wk, wv = j_sk.precompute_user(jf, jnp.asarray(user[0]), dt=jdt)
    want = score(jf, wk, wv, jnp.asarray(items[0], jdt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL[dt], atol=TOL[dt])


def test_folded_scorer_equals_scorer_forward(model):
    jcfg, _jp, _js, _flat, params, state, user, items = model
    mcfg = port_config(jcfg)
    folded = fold_scorer(params, state, mcfg)
    k_proj, v = precompute_user(folded, t(user), torch.float32)
    got = score_frontier_reference(folded, k_proj, v, t(items), torch.float32)
    want = scorer_forward(params, state, mcfg, t(user), t(items))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wrapper_on_cpu_runs_the_plain_version(model, dt):
    """CPU tensors take the plain version: rows gathered with ids clipped to
    the table, invalid rows -inf, and no kernel launch counted."""
    jcfg, _jp, _js, _flat, params, state, user, _ = model
    tdt = DTYPES[dt][1]
    rng = np.random.default_rng(3)
    table = t(rng.standard_normal((100, 32))).to(tdt)
    ids = torch.from_numpy(rng.integers(-5, 110, (3, 40)).astype(np.int32))
    valid = torch.from_numpy(rng.random((3, 40)) > 0.2)
    folded = fold_scorer(params, state, port_config(jcfg))
    weights = fs.kernel_weights(folded, tdt)
    k_proj, v = precompute_user(folded, t(user), tdt)
    before = fs.score_frontier.launches
    got = fs.score_frontier(weights, k_proj, v, table, ids, valid)
    assert fs.score_frontier.launches == before
    rows = table[ids.long().clamp(0, 99)]
    want = score_frontier_reference(weights, k_proj, v, rows, tdt)
    assert torch.isneginf(got[~valid]).all()
    torch.testing.assert_close(got[valid], want[valid], rtol=0, atol=0)


def _kernel_inputs(dt=torch.float32, B=2, F=64, L=12):
    mcfg = ModelConfig(**SMALL)
    params, state = init_scorer(mcfg, torch.Generator().manual_seed(0), "cpu")
    folded = fold_scorer(params, state, mcfg)
    weights = fs.kernel_weights(folded, dt)
    k_proj, v = precompute_user(folded, torch.randn(B, L, 32), dt)
    table = torch.randn(500, 32).to(dt)
    ids = torch.randint(0, 500, (B, F), dtype=torch.int32)
    valid = torch.ones(B, F, dtype=torch.bool)
    return dict(weights=weights, k_proj=k_proj, v=v, table=table, ids=ids,
                valid=valid)


def test_kernel_checks_accept_good_inputs():
    fs._check(**_kernel_inputs())
    fs._check(**_kernel_inputs(torch.bfloat16))


@pytest.mark.parametrize("fault", ["ids_int64", "valid_float", "table_fp16",
                                   "kproj_dtype", "seq_too_long",
                                   "batch_mismatch", "weight_shape",
                                   "weight_dtype", "not_contiguous"])
def test_kernel_checks_reject_bad_inputs(fault):
    a = _kernel_inputs()
    if fault == "ids_int64":
        a["ids"] = a["ids"].long()
    elif fault == "valid_float":
        a["valid"] = a["valid"].float()
    elif fault == "table_fp16":
        a["table"] = a["table"].half()
    elif fault == "kproj_dtype":
        a["k_proj"] = a["k_proj"].to(torch.bfloat16)
    elif fault == "seq_too_long":
        a["k_proj"] = torch.zeros(2, 65, a["k_proj"].shape[2])
        a["v"] = torch.zeros(2, 65, a["v"].shape[2])
    elif fault == "batch_mismatch":
        a["ids"], a["valid"] = a["ids"][:1], a["valid"][:1]
    elif fault == "weight_shape":
        a["weights"]["h2_k"] = a["weights"]["h2_k"][:, :24].contiguous()
    elif fault == "weight_dtype":
        a["weights"]["q1_k"] = a["weights"]["q1_k"].to(torch.bfloat16)
    else:
        a["table"] = a["table"].t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        fs._check(**a)


# the serving width of bench.py and the NARROW configuration of
# tests/test_torch_kernels.py: (D, DU, H1, DK, G1, G2, G3, L)
SERVING_WIDTHS = (64, 64, 128, 256, 128, 64, 32, 50)
NARROW_WIDTHS = (32, 32, 64, 128, 64, 32, 16, 12)


@pytest.mark.parametrize("widths", [SERVING_WIDTHS, NARROW_WIDTHS],
                         ids=["serving", "narrow"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["rows", "int8"])
def test_scorer_plan(widths, dt, packed):
    """The launch plan the wrapper mirrors from csrc/frontier_scorer.cu:
    bfloat16 blocks of 128 rows (8 warps of 16 rows), float32 blocks of 32
    rows and 256 threads; shared memory within a block's 232,448 bytes; two
    blocks an SM at the serving width in both compute types; the same plan
    for both storages."""
    plan = fs._scorer_plan(dt, packed, *widths)
    assert plan == fs._scorer_plan(dt, not packed, *widths)
    if dt == torch.bfloat16:
        assert (plan.rows, plan.threads) == (128, 256)
    else:
        assert (plan.rows, plan.threads) == (32, 256)
    assert 0 < plan.smem_bytes <= 232_448
    if widths == SERVING_WIDTHS:
        assert plan.smem_bytes == {torch.bfloat16: 111_104,
                                   torch.float32: 107_336}[dt]
        assert plan.blocks_per_sm >= 2
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233_472


def test_scorer_plan_takes_fewer_rows_for_wide_models():
    """Rows a block depend on the widths alone: a model too wide for two
    blocks of 128 bf16 rows takes fewer rows (here 32, in one block an SM);
    widths no block holds get no plan, and the wrapper refuses them."""
    wide = (64, 64, 512, 512, 256, 512, 32, 50)
    plan = fs._scorer_plan(torch.bfloat16, False, *wide)
    assert (plan.rows, plan.threads, plan.blocks_per_sm) == (32, 64, 1)
    assert plan.smem_bytes <= 232_448
    assert fs._scorer_plan(torch.bfloat16, False, 64, 64, 2048, 512, 256,
                           2048, 32, 50).rows == 0
    a = _kernel_inputs(torch.bfloat16)
    a["weights"]["q1_k"] = torch.zeros(32, 4096, dtype=torch.bfloat16)
    a["weights"]["q1_b"] = a["weights"]["q1_alpha"] = torch.zeros(4096)
    a["weights"]["q2_k"] = torch.zeros(4096, a["k_proj"].shape[2],
                                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        fs._check(**a)
