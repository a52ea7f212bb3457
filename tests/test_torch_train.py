"""The port's training and extraction against the JAX package, on the CPU.

Sizes are those of tests/test_train.py: 300 items, 20 categories, emb_dim 8,
L = 10, towers 16, head (32, 16, 8, 1), batch 32, num_neg 8, float32. Inputs
come from numpy seeds; JAX parameters reach the port through
params_from_jax, and the port's sampler is replaced by JAX's draw wherever
targets are compared (the two RNGs differ).

Tolerances: data, batches and target ids exact; expected counts rtol 1e-6;
layers, the loss and the batch-norm state rtol 1e-5 (two libraries summing
in other orders; the state also atol 1e-8, as a batch mean near 0 is the
difference of terms 1e4 times larger);
towers and scores 2e-4 (the float32 bar of tests/test_torch_scorer.py);
gradients atol 1e-6 + rtol 1e-4. Two kinds of values are held by an absolute
tolerance only, because their exact value is 0 and float32 leaves noise:
the gradients of ZERO_GRAD_LEAVES (which Adam's first update turns into
steps of up to +-lr with the noise's sign, so the whole-step test leaves
those parameters out), and `loss_adv`, where sign(d loss_xe / d item_emb)
may flip for an element near 0.
"""

import dataclasses
import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nann_tpu.config import ModelConfig as JModelConfig
from nann_tpu.config import TrainConfig as JTrainConfig
from nann_tpu.data import BatchIterator as JBatchIterator
from nann_tpu.data import synthetic_dataset as j_synthetic_dataset
from nann_tpu.delivery import extract as j_extract
from nann_tpu.delivery.export import _flatten
from nann_tpu.models import init_scorer as j_init_scorer
from nann_tpu.models import layers as j_layers
from nann_tpu.models import scorer as j_scorer
from nann_tpu.train import objective as j_objective
from nann_tpu.train import sampler as j_sampler
from nann_tpu.train import step as j_step

from nann_tpu_torch.config import ModelConfig, TrainConfig
from nann_tpu_torch.data import BatchIterator, synthetic_dataset
from nann_tpu_torch.delivery import (extract_item_embeddings,
                                     extract_user_embeddings)
from nann_tpu_torch.models import (item_tower, params_from_jax, score_pairs,
                                   user_embed)
from nann_tpu_torch.models import layers
from nann_tpu_torch.models.scorer import flatten
from nann_tpu_torch.train import objective, sampler
from nann_tpu_torch.train import step as t_step
from nann_tpu_torch.train.dataclasses_io import (restore_train_state,
                                                 save_train_state)
from nann_tpu_torch.train.loop import (_prune_checkpoints, checkpoint_steps,
                                       latest_checkpoint_step, train_loop)

SMALL = dict(num_item=300, num_cate=20, emb_dim=8, max_seq_length=10,
             item_tower_dims=(16, 16, 16), head_dims=(32, 16, 8, 1))
TRAIN = dict(batch_size=32, num_neg=8, learning_rate=1e-3, adv_eps=1e-3)
DATA = dict(num_item=300, num_cate=20, num_users=100, max_seq_length=10,
            samples_per_user=3)
# leaves whose gradient is 0 in exact arithmetic: every dense bias that feeds
# a training-mode batch norm (the norm subtracts the batch mean), and the
# keys' last bias (softmax over the keys ignores a shift all keys share)
ZERO_GRAD_LEAVES = ("item_tower/0/dense/bias", "item_tower/1/dense/bias",
                    "head/0/dense/bias", "head/1/dense/bias",
                    "head/2/dense/bias", "att/k2/bias")
CPU = "cpu"
# optax computes Adam's bias correction 1 - b2**t in float32, where
# 1 - float32(0.999) is 1.3e-5 below 0.001: its steps are about 6.4e-6 x lr
# longer than torch's, which takes it in double. Parameters are compared
# with rtol 1e-6 plus this much x lr for each update.
ADAM_ATOL = 1e-5


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def assert_state_close(got: dict, want: dict):
    """Flat batch-norm states (or their parts) equal within rtol 1e-5,
    atol 1e-8."""
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_start(seed: int = 0):
    """JAX's initial params and bn state -> (params, state, flat arrays)."""
    jcfg = JModelConfig(**SMALL)
    params, state = jax.jit(lambda key: j_init_scorer(key, jcfg))(
        jax.random.PRNGKey(seed))
    return params, state, {**np_tree(params), **np_tree(state)}


def port_start(seed: int = 0, tcfg=None):
    """The port's TrainState from JAX's initial params, fresh AdamW."""
    params, state = params_from_jax(jax_start(seed)[2], device=CPU)
    return t_step.train_state_from(params, state, tcfg or TrainConfig(**TRAIN))


@functools.lru_cache(maxsize=None)
def dataset():
    return j_synthetic_dataset(**DATA)


def first_batch(n=32):
    train = dataset()[0]
    return {k: v[:n] for k, v in train.items()}


def jax_features():
    return {k: jnp.asarray(v) for k, v in dataset()[2].items()}


@functools.lru_cache(maxsize=None)
def jax_targets(key: int = 3, fold=None):
    """JAX's targets for the first batch, and its sampler's draw, from
    PRNGKey(key) (folded with `fold`, as JAX's step folds its step in)."""
    feats = jax_features()
    batch = {k: jnp.asarray(v) for k, v in first_batch().items()}
    log_probs = jnp.log(1e-20 + feats["weight_tag"])
    rng = jax.random.PRNGKey(key)
    if fold is not None:
        rng = jax.random.fold_in(rng, fold)
    draw = j_sampler.sample_negatives(rng, log_probs,
                                      TRAIN["num_neg"] * TRAIN["batch_size"])
    targets = j_objective.build_targets(rng, batch, feats["item_id"],
                                        feats["cate_id"], log_probs,
                                        feats["weight_tag"], TRAIN["num_neg"])
    return ({k: np.asarray(v) for k, v in targets.items()}, np.asarray(draw))


def port_batch():
    return {k: t(v) for k, v in first_batch().items()}


def use_draw(monkeypatch, draw):
    """Make the port's build_targets take JAX's draw."""
    monkeypatch.setattr(objective, "sample_negatives",
                        lambda gen, log_probs, k: t(draw).to(torch.int32))


# ------------------------------------------------------------------- config


def test_train_config_matches_jax():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    assert dataclasses.asdict(TrainConfig(dp=2)) == \
        dataclasses.asdict(JTrainConfig(dp=2))


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [DATA, dict(num_item=1000, num_cate=7,
                                           num_users=30, max_seq_length=6,
                                           samples_per_user=2, seed=5)],
                         ids=["small", "seed5"])
def test_synthetic_dataset_equals_jax(kw):
    want = j_synthetic_dataset(**kw)
    got = synthetic_dataset(**kw)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 3])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_iterator_equals_jax(prefetch, drop_remainder):
    train = dataset()[0]
    kw = dict(batch_size=64, epochs=3, seed=1, drop_remainder=drop_remainder)
    it = BatchIterator(train, prefetch=prefetch, **kw)
    jit_ = JBatchIterator(train, prefetch=prefetch, **kw)
    assert len(it) == len(jit_) and it.batches_per_epoch == \
        jit_.batches_per_epoch
    _batches_equal(it, jit_)
    for k in (1, it.batches_per_epoch, len(it) - 1, len(it)):
        _batches_equal(it.iter_from(k), jit_.iter_from(k))


def test_batch_iterator_prefetch_thread_exits():
    it = iter(BatchIterator(dataset()[0], batch_size=64, epochs=50, seed=3,
                            prefetch=2))
    next(it)
    it.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            th.name == "batch-prefetch" and th.is_alive()
            for th in threading.enumerate()):
        time.sleep(0.05)
    assert not any(th.name == "batch-prefetch" and th.is_alive()
                   for th in threading.enumerate())


# ------------------------------------------------------------------ sampler


def test_expected_count_matches_jax():
    probs = dataset()[2]["weight_tag"]
    want = j_sampler.expected_count(jnp.asarray(probs), 256)
    got = sampler.expected_count(t(probs), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_samples_unique_and_in_range():
    for n, k in ((1000, 200), (50, 50)):
        log_probs = torch.log(torch.full((n,), 1.0 / n))
        idx = sampler.sample_negatives(torch.Generator().manual_seed(n),
                                       log_probs, k)
        assert idx.dtype == torch.int32 and idx.shape == (k,)
        assert len(np.unique(idx.numpy())) == k
        assert idx.min() >= 0 and idx.max() < n


def test_popular_items_sampled_more():
    n = 2000
    w = np.ones(n)
    w[7] = 100.0
    log_probs = torch.log(t(w / w.sum()).float())
    hits = sum(7 in sampler.sample_negatives(
        torch.Generator().manual_seed(trial), log_probs, 20).tolist()
        for trial in range(200))
    # p(item 7 in a sample) ~ 0.62; a uniform item's ~ 1%
    assert hits / 200 > 0.4


def test_marginal_frequency_tracks_popularity():
    n, k, trials = 500, 50, 300
    w = np.random.default_rng(5).random(n) + 0.01
    p = w / w.sum()
    log_probs = torch.log(t(p).float())
    counts = np.zeros(n)
    for trial in range(trials):
        idx = sampler.sample_negatives(torch.Generator().manual_seed(trial),
                                       log_probs, k)
        counts[idx.numpy()] += 1
    assert np.corrcoef(counts / trials, 1 - (1 - p) ** k)[0, 1] > 0.95


def test_step_generator_depends_on_seed_and_step_only():
    def draw(seed, step):
        return torch.rand(8, generator=t_step.step_generator(seed, step, CPU))
    assert torch.equal(draw(1, 5), draw(1, 5))
    assert not torch.equal(draw(1, 5), draw(1, 6))
    assert not torch.equal(draw(1, 5), draw(2, 5))


def test_build_targets_equals_jax(monkeypatch):
    want, draw = jax_targets()
    use_draw(monkeypatch, draw)
    feats = dataset()[2]
    probs = t(feats["weight_tag"])
    got = objective.build_targets(
        torch.Generator(), port_batch(), t(feats["item_id"]),
        t(feats["cate_id"]), torch.log(1e-20 + probs), probs,
        TRAIN["num_neg"])
    for k in ("item_id", "cate_id", "labels"):
        assert got[k].dtype == t(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["log_exp_cnt"].numpy(),
                               want["log_exp_cnt"], rtol=1e-6)


def test_build_targets_needs_enough_items():
    probs = torch.full((10,), 0.1)
    with pytest.raises(ValueError, match="num_neg"):
        objective.build_targets(torch.Generator(), port_batch(),
                                torch.arange(1, 11), torch.ones(10),
                                torch.log(probs), probs, 8)


# ------------------------------------------------------------ layers, towers


def _bn_block(rng, dim, norm):
    p = {"dense": {"kernel": rng.normal(0, .3, (12, dim)).astype(np.float32),
                   "bias": rng.normal(0, .1, dim).astype(np.float32)}}
    s = {}
    if norm == "bn":
        p["bn"] = {"gamma": rng.uniform(.5, 1.5, dim).astype(np.float32),
                   "beta": rng.normal(0, .1, dim).astype(np.float32)}
        s["bn"] = {"mean": rng.normal(0, .3, dim).astype(np.float32),
                   "var": rng.uniform(.5, 2, dim).astype(np.float32)}
    elif norm == "ln":
        p["ln"] = {"gamma": rng.uniform(.5, 1.5, dim).astype(np.float32),
                   "beta": rng.normal(0, .1, dim).astype(np.float32)}
    p["prelu"] = {"alpha": rng.uniform(.1, .4, dim).astype(np.float32)}
    return p, s


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return t(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(0)
    p, s = _bn_block(rng, 16, "bn")
    x = rng.normal(1, 2, (5, 7, 16)).astype(np.float32)
    want_y, want_s = j_layers.batch_norm(_to_jax(p["bn"]), _to_jax(s["bn"]),
                                         jnp.asarray(x), True, 0.99, 1e-3)
    got_y, got_s = layers.batch_norm_train(_to_torch(p["bn"]),
                                           _to_torch(s["bn"]), t(x), 0.99,
                                           1e-3)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-6)
    assert_state_close({k: v.numpy() for k, v in got_s.items()},
                       {k: np.asarray(v) for k, v in want_s.items()})


@pytest.mark.parametrize("norm,act", [("bn", "prelu"), ("ln", "relu"),
                                      ("ln", "prelu"), (None, "relu"),
                                      (None, None)])
@pytest.mark.parametrize("training", [True, False])
def test_dnn_apply_matches_jax(norm, act, training):
    rng = np.random.default_rng(1)
    p, s = _bn_block(rng, 16, norm)
    x = rng.normal(0, 1, (6, 12)).astype(np.float32)
    want, want_s = j_layers.dnn_apply(_to_jax(p), _to_jax(s), jnp.asarray(x),
                                      training, norm, act)
    if training:
        got, got_s = layers.dnn_apply_train(_to_torch(p), _to_torch(s), t(x),
                                            norm, act)
        assert_state_close(flatten(got_s), np_tree(want_s))
    else:
        got = layers.dnn_apply(_to_torch(p), _to_torch(s), t(x), norm, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def trained_like_jax():
    """JAX params with non-trivial batch-norm statistics (eval mode uses
    them) -> (jax params, jax state, port params, port state)."""
    jp, js, _ = jax_start(1)
    rng = np.random.default_rng(1)
    js = jax.tree.map(lambda a: a, js)
    for tower in ("item_tower", "head"):
        for s in js[tower]:
            if "bn" in s:
                dim = s["bn"]["mean"].shape[0]
                s["bn"] = {"mean": jnp.asarray(rng.normal(0, .3, dim),
                                               jnp.float32),
                           "var": jnp.asarray(rng.uniform(.5, 2, dim),
                                              jnp.float32)}
    params, state = params_from_jax({**np_tree(jp), **np_tree(js)},
                                    device=CPU)
    return jp, js, params, state


def _ids(rng, shape, hi):
    ids = rng.integers(0, hi + 1, shape).astype(np.int32)
    ids.flat[::7] = 0                       # padding
    return ids


def test_user_embed_matches_jax():
    jp, _js, params, _ = trained_like_jax()
    rng = np.random.default_rng(2)
    items, cates = _ids(rng, (4, 10), 300), _ids(rng, (4, 10), 20)
    want = j_scorer.user_embed(jp, jnp.asarray(items), jnp.asarray(cates))
    got = user_embed(params, t(items), t(cates))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert not got[torch.from_numpy(items == 0)][:, :8].any()


@pytest.mark.parametrize("training", [True, False])
def test_item_tower_matches_jax(training):
    jp, js, params, state = trained_like_jax()
    rng = np.random.default_rng(3)
    items, cates = _ids(rng, (4, 9), 300), _ids(rng, (4, 9), 20)
    jcfg, mcfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    want, want_s = j_scorer.item_tower(jp, js, jcfg, jnp.asarray(items),
                                       jnp.asarray(cates), training)
    got, got_s = item_tower(params, state, mcfg, t(items), t(cates), training)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    assert_state_close(flatten(got_s), np_tree(want_s))


@pytest.mark.parametrize("training", [True, False])
def test_score_pairs_matches_jax(training):
    jp, js, params, state = trained_like_jax()
    rng = np.random.default_rng(4)
    args = (_ids(rng, (4, 10), 300), _ids(rng, (4, 10), 20),
            _ids(rng, (4, 9), 300), _ids(rng, (4, 9), 20))
    jcfg, mcfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    want, want_emb, want_s = j_scorer.score_pairs(
        jp, js, jcfg, *map(jnp.asarray, args), training=training)
    got, got_emb, got_s = score_pairs(params, state, mcfg, *map(t, args),
                                      training=training)
    assert got.shape == (4, 9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_emb.detach().numpy(),
                               np.asarray(want_emb), rtol=2e-4, atol=2e-4)
    assert_state_close(flatten(got_s), np_tree(want_s))


# ------------------------------------------------------- loss and gradients


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(adv_eps: float, compute_dtype: str = "float32",
                       key: int = 3, fold=None):
    """JAX's metrics, new bn state and gradients at its initial params on
    the first batch and jax_targets(key, fold)."""
    jp, js, _ = jax_start(0)
    jcfg = JModelConfig(**SMALL, compute_dtype=compute_dtype)
    jtcfg = JTrainConfig(**{**TRAIN, "adv_eps": adv_eps})
    targets, _ = jax_targets(key, fold)
    batch = {k: jnp.asarray(v) for k, v in first_batch().items()}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(params):
        return j_objective.nann_loss(params, js, jcfg, jtcfg, batch, jt)
    (loss, (new_bn, metrics)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    return ({k: float(v) for k, v in metrics.items()}, np_tree(new_bn),
            np_tree(grads))


def port_loss(adv_eps: float, compute_dtype: str = "float32"):
    mcfg = ModelConfig(**SMALL, compute_dtype=compute_dtype)
    tcfg = TrainConfig(**{**TRAIN, "adv_eps": adv_eps})
    st = port_start(0, tcfg)
    targets = {k: t(v) for k, v in jax_targets()[0].items()}
    loss, (new_bn, metrics) = objective.nann_loss(
        st.params, st.bn_state, mcfg, tcfg, port_batch(), targets)
    return st, loss, new_bn, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("adv_eps", [1e-3, 0.0])
def test_nann_loss_matches_jax(adv_eps):
    want_m, want_bn, _ = jax_loss_and_grads(adv_eps)
    _st, loss, new_bn, got_m = port_loss(adv_eps)
    assert float(loss.detach()) == pytest.approx(got_m["loss"])
    for k in ("loss", "loss_xe", "acc", "acc_origin"):
        assert got_m[k] == pytest.approx(want_m[k], rel=1e-5), k
    assert got_m["loss_adv"] == pytest.approx(want_m["loss_adv"], abs=1e-6)
    if adv_eps > 0:
        assert got_m["loss_adv"] > 0
    else:
        assert got_m["loss_adv"] == 0.0
    assert_state_close(flatten(new_bn), want_bn)


def test_nann_loss_bfloat16_matches_jax():
    """compute_dtype="bfloat16" keeps JAX's cast points: the loss within the
    bfloat16 tolerance of tests/test_torch_scorer.py."""
    want_m, _, _ = jax_loss_and_grads(1e-3, "bfloat16")
    got_m = port_loss(1e-3, "bfloat16")[3]
    for k in ("loss", "loss_xe"):
        assert got_m[k] == pytest.approx(want_m[k], rel=0.05, abs=0.05), k


@pytest.mark.parametrize("adv_eps", [1e-3, 0.0])
def test_gradients_match_jax(adv_eps):
    _, _, want = jax_loss_and_grads(adv_eps)
    st, loss, _, _ = port_loss(adv_eps)
    loss.backward()
    got = {name: leaf.grad.numpy() for name, leaf in
           t_step.named_leaves(st.params)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ZERO_GRAD_LEAVES:     # zero in exact arithmetic, on both sides
        assert np.abs(want[k]).max() < 1e-6 and np.abs(got[k]).max() < 1e-6


# ------------------------------------------------ schedules, AdamW, the step


SCHEDULES = {
    "constant": dict(),
    "warmup": dict(warmup_steps=4),
    "cosine": dict(lr_schedule="cosine"),
    "warmup-cosine": dict(lr_schedule="cosine", warmup_steps=3),
    "cosine-horizon": dict(lr_schedule="cosine", lr_total_steps=12,
                           lr_final_ratio=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    kw = {**SCHEDULES[name], "learning_rate": 3e-3}
    want = j_step.lr_schedule_fn(JTrainConfig(**kw), total_steps=20)
    got = t_step.lr_schedule_fn(TrainConfig(**kw), total_steps=20)
    values = [float(want(c)) for c in range(25)]
    np.testing.assert_allclose([got(c) for c in range(25)], values,
                               rtol=1e-6, atol=1e-10)
    if kw.get("warmup_steps"):
        assert got(0) == 0.0


def test_lr_schedule_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="horizon"):
        t_step.lr_schedule_fn(TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="lr_schedule"):
        t_step.lr_schedule_fn(TrainConfig(lr_schedule="nope"), total_steps=10)


@pytest.mark.parametrize("name", ["constant", "warmup"])
def test_adamw_matches_optax(name):
    """The port's AdamW on JAX's gradients equals optax.adamw over 3 steps,
    up to optax's float32 bias correction (ADAM_ATOL)."""
    tcfg_kw = {**TRAIN, **SCHEDULES[name], "weight_decay": 1e-2}
    jtcfg, tcfg = JTrainConfig(**tcfg_kw), TrainConfig(**tcfg_kw)
    jp = jax_start(0)[0]
    tx = optax.adamw(j_step.lr_schedule_fn(jtcfg), weight_decay=jtcfg.weight_decay)
    opt_state = tx.init(jp)
    st = port_start(0, tcfg)
    schedule = t_step.lr_schedule_fn(tcfg)
    rng = np.random.default_rng(7)
    for count in range(3):
        grads_np = {k: rng.normal(0, 1e-2, v.shape).astype(np.float32)
                    for k, v in np_tree(jp).items()}
        grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(grads_np[k]) for k in _flatten(jp)])
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, leaf in t_step.named_leaves(st.params):
            leaf.grad = t(grads_np[k])
        t_step.apply_gradients(st.opt_state, schedule, count)
    want = np_tree(jp)
    for k, leaf in t_step.named_leaves(st.params):
        np.testing.assert_allclose(
            leaf.detach().numpy(), want[k], rtol=1e-6,
            atol=3 * ADAM_ATOL * tcfg.learning_rate, err_msg=k)


def test_train_step_matches_jax(monkeypatch):
    """JAX's jitted step against the port's, from the same params, with the
    port's sampler returning the draw JAX's step made (its key folded with
    the step)."""
    jcfg, jtcfg = JModelConfig(**SMALL), JTrainConfig(**TRAIN)
    jp, js, flat = jax_start(0)
    start = {k: v.copy() for k, v in flat.items()}
    tx = optax.adamw(j_step.lr_schedule_fn(jtcfg),
                     weight_decay=jtcfg.weight_decay)
    jstate = j_step.TrainState(jp, js, tx.init(jp), jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in first_batch().items()}
    jnew, jm = j_step.make_train_step(jcfg, jtcfg, tx, jax_features())(
        jstate, jbatch, jax.random.PRNGKey(11))
    use_draw(monkeypatch, jax_targets(11, 0)[1])

    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(**TRAIN)
    params, state = params_from_jax(start, device=CPU)
    st = t_step.train_state_from(params, state, tcfg)
    step = t_step.make_train_step(mcfg, tcfg, t_step.lr_schedule_fn(tcfg),
                                  dataset()[2], device=CPU)
    new, metrics = step(st, first_batch(), 12)
    assert new.step == 1
    for k in ("loss", "loss_xe", "acc", "acc_origin"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(metrics["loss_adv"]) == pytest.approx(float(jm["loss_adv"]),
                                                       abs=1e-6)
    assert_state_close(flatten(new.bn_state), np_tree(jnew.bn_state))
    # Adam's first update moves an element by lr * g / (|g| + 1e-8), which
    # the gradient test's atol 1e-6 does not fix where |g| is below it: there
    # both sides stay within lr of the same decayed start. That is every
    # element of ZERO_GRAD_LEAVES (float32 noise around 0), which are left
    # out, and a few elements elsewhere.
    grads = jax_loss_and_grads(TRAIN["adv_eps"], key=11, fold=0)[2]
    lr = tcfg.learning_rate
    want_p, got_p = np_tree(jnew.params), flatten(new.params)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        small = np.abs(grads[k]) < 1e-6
        if k in ZERO_GRAD_LEAVES:
            assert small.all(), k
            continue
        np.testing.assert_allclose(got_p[k][~small], want_p[k][~small],
                                   rtol=1e-5, atol=ADAM_ATOL * lr, err_msg=k)
        np.testing.assert_allclose(got_p[k][small], want_p[k][small], rtol=0,
                                   atol=2 * lr, err_msg=k)


def _small_run(tmp_path, name, num_steps, **tkw):
    mcfg = ModelConfig(**SMALL)
    tcfg = TrainConfig(**{**TRAIN, "print_freq": 1, **tkw})
    train, _, feats = dataset()
    ckpt = str(tmp_path / name)
    state, metrics = train_loop(mcfg, tcfg, train, feats, ckpt_dir=ckpt,
                                num_steps=num_steps, device=CPU,
                                metrics_path=str(tmp_path / f"{name}.jsonl"))
    return state, metrics, ckpt


def test_loss_decreases_over_steps():
    """61 steps and the bar of tests/test_train.py:43: the mean loss_xe of
    the last 5 steps under 0.9 x that of the first 5."""
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(**TRAIN)
    train, _, feats = dataset()
    state, schedule = t_step.create_train_state(mcfg, tcfg, device=CPU)
    step = t_step.make_train_step(mcfg, tcfg, schedule, feats, device=CPU)
    losses = []
    for i, batch in enumerate(BatchIterator(train, 32, epochs=20, seed=0)):
        state, metrics = step(state, batch, 42)
        losses.append(float(metrics["loss_xe"]))
        if i >= 60:
            break
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert float(metrics["loss_adv"]) >= 0
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.9, (first, last)


# -------------------------------------------------------------- checkpoints


def test_checkpoint_round_trip(tmp_path):
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(**TRAIN)
    state, _ = _small_run(tmp_path, "a", 3)[:2]
    other, _ = t_step.create_train_state(
        mcfg, tcfg, generator=torch.Generator().manual_seed(9), device=CPU)
    save_train_state(str(tmp_path / "step_3"), state)
    restored = restore_train_state(str(tmp_path / "step_3"), other)
    assert restored.step == 3 and restored.params is other.params
    for (k, a), (_, b) in zip(t_step.named_leaves(state.params),
                              t_step.named_leaves(restored.params)):
        assert torch.equal(a, b), k
    for k, v in flatten(state.bn_state).items():
        np.testing.assert_array_equal(flatten(restored.bn_state)[k], v)
    want, got = state.opt_state.state_dict(), restored.opt_state.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k in s:
            assert torch.equal(s[k], got["state"][i][k]), (i, k)


def test_restore_rejects_another_shape(tmp_path):
    state, _, _ = _small_run(tmp_path, "a", 1)
    save_train_state(str(tmp_path / "x"), state)
    other, _ = t_step.create_train_state(
        ModelConfig(**{**SMALL, "num_item": 301}), TrainConfig(**TRAIN),
        device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        restore_train_state(str(tmp_path / "x"), other)


def test_restore_matches_leaves_by_name(tmp_path):
    """A checkpoint whose tree lists the leaves in another order (JAX's
    parameters through params_from_jax) restores leaf by name, the AdamW
    moments with their own leaves."""
    state, _, _ = _small_run(tmp_path, "a", 3)
    names = [k for k, _ in t_step.named_leaves(state.params)]
    reordered = dict(reversed(list(state.params.items())))
    assert [k for k, _ in t_step.named_leaves(reordered)] != names
    opt = torch.optim.AdamW([leaf for _, leaf in
                             t_step.named_leaves(reordered)])
    saved_at = {k: i for i, k in enumerate(names)}
    moments = state.opt_state.state_dict()["state"]
    opt.load_state_dict({
        "state": {j: moments[saved_at[k]] for j, (k, _) in
                  enumerate(t_step.named_leaves(reordered))},
        "param_groups": state.opt_state.state_dict()["param_groups"]})
    save_train_state(str(tmp_path / "x"), t_step.TrainState(
        reordered, state.bn_state, opt, state.step))

    other, _ = t_step.create_train_state(
        ModelConfig(**SMALL), TrainConfig(**TRAIN),
        generator=torch.Generator().manual_seed(9), device=CPU)
    restored = restore_train_state(str(tmp_path / "x"), other)
    got = restored.opt_state.state_dict()["state"]
    for j, (k, leaf) in enumerate(t_step.named_leaves(restored.params)):
        want = dict(t_step.named_leaves(state.params))[k]
        assert torch.equal(leaf, want), k
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[j][m], moments[saved_at[k]][m]), (k, m)


def test_latest_checkpoint_step_and_pruning(tmp_path):
    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    for name in ("step_10", "step_200", "step_3", "junk", "step_x"):
        (tmp_path / name).mkdir()
    assert checkpoint_steps(str(tmp_path)) == [3, 10, 200]
    assert latest_checkpoint_step(str(tmp_path)) == 200
    _prune_checkpoints(str(tmp_path), keep=2)
    assert checkpoint_steps(str(tmp_path)) == [10, 200]
    assert (tmp_path / "junk").exists()


def test_loop_saves_prunes_and_logs(tmp_path):
    _, metrics, ckpt = _small_run(tmp_path, "a", 7, save_freq=3,
                                  max_to_keep=2)
    # saves at steps 0, 3, 6 (step_1, step_4, step_7), the newest two kept
    assert checkpoint_steps(ckpt) == [4, 7]
    lines = (tmp_path / "a.jsonl").read_text().splitlines()
    assert len(lines) == 7
    assert set(metrics) == {"loss", "loss_xe", "loss_adv", "acc",
                            "acc_origin"}


def test_loop_saves_at_the_end_when_the_data_runs_out(tmp_path):
    # 300 samples, batch 32: 9 batches an epoch, 2 epochs, a budget of 50
    state, _, ckpt = _small_run(tmp_path, "a", 50, train_epochs=2,
                                save_freq=100)
    assert state.step == 18
    assert checkpoint_steps(ckpt) == [1, 18]


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    full, full_m, _ = _small_run(tmp_path, "full", 6, save_freq=100)
    _small_run(tmp_path, "resumed", 4, save_freq=100)
    resumed, resumed_m, ckpt = _small_run(tmp_path, "resumed", 6,
                                          save_freq=100)
    assert checkpoint_steps(ckpt) == [1, 4, 6]
    assert resumed.step == full.step == 6
    assert resumed_m == full_m
    for (k, a), (_, b) in zip(t_step.named_leaves(full.params),
                              t_step.named_leaves(resumed.params)):
        assert torch.equal(a, b), k
    for k, v in flatten(full.bn_state).items():
        np.testing.assert_array_equal(flatten(resumed.bn_state)[k], v)
    # a finished budget is not run again
    again, again_m, _ = _small_run(tmp_path, "resumed", 6, save_freq=100)
    assert again.step == 6 and again_m == {}


# --------------------------------------------------------------- extraction


def test_extract_item_embeddings_matches_jax():
    jp, js, params, state = trained_like_jax()
    feats = dataset()[2]
    jcfg, mcfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    want_ids, want = j_extract.extract_item_embeddings(jp, js, jcfg, feats,
                                                       batch_size=128)
    got_ids, got = extract_item_embeddings(params, state, mcfg, feats,
                                           batch_size=128)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got.dtype == np.float32 and got.shape == (300, 16)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_extract_user_embeddings_matches_jax():
    jp, _js, params, _ = trained_like_jax()
    test = dataset()[1]
    want = j_extract.extract_user_embeddings(jp, test)
    got = extract_user_embeddings(params, test)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------- device


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(**TRAIN)
    train, _, feats = dataset()
    for call in (lambda: t_step.create_train_state(mcfg, tcfg),
                 lambda: t_step.make_train_step(mcfg, tcfg, lambda c: 1e-3,
                                                feats),
                 lambda: train_loop(mcfg, tcfg, train, feats,
                                    ckpt_dir=str(tmp_path), num_steps=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.listdir(tmp_path)
