"""Data-parallel training in the port (TrainConfig.dp, the step on a mesh,
global batch norms and loss, BatchIterator(mesh), the row-sharded train
state, the CLI's --dp) against JAX's step on the conftest's 8-device mesh
and against the port's single-device step, on gloo worlds of CPU ranks.

Sizes and tolerances are tests/test_torch_train.py's (300 items, emb_dim 8,
batch 32, num_neg 8, adv_eps 1e-3): metrics and batch-norm state rtol 1e-5
(loss_adv atol 1e-6), gradients rtol 1e-4 + atol 1e-6, parameters against
JAX rtol 1e-5 + ADAM_ATOL x lr, and against the port's own single-device
step rtol 1e-6 + ADAM_ATOL x lr; an element whose gradient is below 1e-6
within 2 x lr (Adam's first update turns its float32 noise into a step of
up to lr with the noise's sign), ZERO_GRAD_LEAVES left out. Leaves that
every rank holds whole are equal across ranks bit for bit.

One world of 2 ranks and one of 4 run every case (tests/torch_world.py's
`dp_train_cases`); JAX's side runs in this process. The row-sharded case
(dp=1 x mp=2) needs table rows that split over 2: 299 items and 19
categories (300 and 20 rows).
"""

import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from nann_tpu.config import ModelConfig as JModelConfig
from nann_tpu.config import TrainConfig as JTrainConfig
from nann_tpu.data import BatchIterator as JBatchIterator
from nann_tpu.models import layers as j_layers
from nann_tpu.train import step as j_step

from nann_tpu_torch.config import ModelConfig, TrainConfig
from nann_tpu_torch.data import BatchIterator, synthetic_dataset
from nann_tpu_torch.models import layers
from nann_tpu_torch.models.scorer import flatten
from nann_tpu_torch.train import step as t_step
from nann_tpu_torch.train.dataclasses_io import (restore_train_state,
                                                 save_train_state)

import torch_world
from test_torch_train import (ADAM_ATOL, CPU, DATA, SMALL, TRAIN,
                              ZERO_GRAD_LEAVES, assert_state_close, dataset,
                              first_batch, jax_features, jax_loss_and_grads,
                              jax_start, jax_targets, np_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP_SMALL = dict(SMALL, num_item=299, num_cate=19)
MP_DATA = dict(DATA, num_item=299, num_cate=19)
LR = TRAIN["learning_rate"]
METRICS = ("loss", "loss_xe", "loss_adv", "acc", "acc_origin")


def _cfg(model):
    return np.asarray(json.dumps({"model": model, "train": TRAIN}))


@functools.lru_cache(maxsize=None)
def mp_dataset():
    return synthetic_dataset(**MP_DATA)


@functools.lru_cache(maxsize=None)
def single_checkpoint():
    """A single-device state after one step on the mp data, and its
    checkpoint's directory."""
    mcfg, tcfg = ModelConfig(**MP_SMALL), TrainConfig(**TRAIN)
    train, _, feats = mp_dataset()
    state, schedule = t_step.create_train_state(
        mcfg, tcfg, generator=torch.Generator().manual_seed(3), device=CPU)
    step = t_step.make_train_step(mcfg, tcfg, schedule, feats, device=CPU)
    state, _ = step(state, next(iter(BatchIterator(train, 32, seed=4))), 5)
    path = os.path.join(tempfile.mkdtemp(prefix="dp_single_"), "step_1")
    save_train_state(path, state)
    return state, path


def _bn_case():
    rng = np.random.default_rng(0)
    dim = 16
    return {"bn_x": rng.normal(1, 2, (8, 7, dim)).astype(np.float32),
            "bn_ct": rng.normal(0, 1, (8, 7, dim)).astype(np.float32),
            "bn_p/gamma": rng.uniform(.5, 1.5, dim).astype(np.float32),
            "bn_p/beta": rng.normal(0, .1, dim).astype(np.float32),
            "bn_s/mean": rng.normal(0, .3, dim).astype(np.float32),
            "bn_s/var": rng.uniform(.5, 2, dim).astype(np.float32)}


def _lookup_case():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 24, (5, 6)).astype(np.int32)
    ids[0, :3] = 7                       # a row looked up more than once
    return {"lookup_table": rng.normal(0, 1, (24, 4)).astype(np.float32),
            "lookup_ids": ids,
            "lookup_ct": rng.normal(0, 1, (5, 6, 4)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def world(n: int):
    """Every rank's outputs of dp_train_cases on a world of n ranks, and the
    checkpoint directory the ranks wrote into."""
    train, _, feats = dataset()
    mp_train, _, mp_feats = mp_dataset()
    ckpt = tempfile.mkdtemp(prefix=f"dp_world{n}_")
    payload = {
        **_bn_case(), **_lookup_case(),
        "cfg": _cfg(SMALL), "mp_cfg": _cfg(MP_SMALL),
        **{f"p0/{k}": v for k, v in jax_start(0)[2].items()},
        "draw": jax_targets(11, 0)[1],
        **{f"batch/{k}": v for k, v in first_batch().items()},
        **{f"feat/{k}": v for k, v in feats.items()},
        **{f"train/{k}": v for k, v in train.items()},
        **{f"mp_feat/{k}": v for k, v in mp_feats.items()},
        **{f"mp_train/{k}": v for k, v in mp_train.items()},
        "ckpt_dir": np.asarray(ckpt),
        "single_ckpt": np.asarray(single_checkpoint()[1]),
    }
    return torch_world.run_world("dp_train_cases", payload, n), ckpt


def _sub(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def assert_params_close(got, want, grads, rtol):
    """Parameters after a step at the file's tolerances: elements whose
    gradient is below 1e-6 within 2 x lr, ZERO_GRAD_LEAVES left out."""
    assert sorted(got) == sorted(want)
    for k in want:
        small = np.abs(grads[k]) < 1e-6
        if k in ZERO_GRAD_LEAVES:
            assert small.all(), k
            continue
        np.testing.assert_allclose(got[k][~small], want[k][~small],
                                   rtol=rtol, atol=ADAM_ATOL * LR, err_msg=k)
        np.testing.assert_allclose(got[k][small], want[k][small], rtol=0,
                                   atol=2 * LR, err_msg=k)


def assert_metrics_close(got, want):
    for k in METRICS:
        if k == "loss_adv":
            assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6)
        else:
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  rel=1e-5), k


# --------------------------------------------------------- the batch norm


@pytest.mark.parametrize("n", [2, 4])
def test_batch_norm_train_global_equals_whole_batch(n):
    """Each rank's block normalised by the global batch's statistics: the
    values, the new state and the input gradients equal batch_norm_train
    over the whole batch and JAX's batch_norm(training=True)."""
    case = _bn_case()
    outs, _ = world(n)
    x = torch.from_numpy(case["bn_x"]).requires_grad_()
    p = {"gamma": torch.from_numpy(case["bn_p/gamma"]),
         "beta": torch.from_numpy(case["bn_p/beta"])}
    s = {"mean": torch.from_numpy(case["bn_s/mean"]),
         "var": torch.from_numpy(case["bn_s/var"])}
    y, st = layers.batch_norm_train(p, s, x, 0.99, 1e-3)
    (y * torch.from_numpy(case["bn_ct"])).sum().backward()

    def jax_bn(xj):
        return j_layers.batch_norm({k: jnp.asarray(v.numpy())
                                    for k, v in p.items()},
                                   {k: jnp.asarray(v.numpy())
                                    for k, v in s.items()},
                                   xj, True, 0.99, 1e-3)
    (jy, jst), vjp = jax.vjp(jax_bn, jnp.asarray(case["bn_x"]))
    (jdx,) = vjp((jnp.asarray(case["bn_ct"]),
                  jax.tree.map(jnp.zeros_like, jst)))

    got_y = np.concatenate([o["bn_y"] for o in outs])
    got_dx = np.concatenate([o["bn_dx"] for o in outs])
    for want_y, want_dx, want_s in (
            (y.detach().numpy(), x.grad.numpy(),
             {k: v.numpy() for k, v in st.items()}),
            (np.asarray(jy), np.asarray(jdx),
             {k: np.asarray(v) for k, v in jst.items()})):
        np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_dx, want_dx, rtol=1e-4, atol=1e-6)
        for o in outs:
            assert_state_close(_sub(o, "bn_state"), want_s)
    for o in outs[1:]:
        for k in ("mean", "var"):
            assert np.array_equal(o[f"bn_state/{k}"],
                                  outs[0][f"bn_state/{k}"]), k


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_sum_differentiates_twice(n):
    """(sum_r x_r^2)^2 from each rank's share: the gradient 4 S x_r, and the
    second derivative of the ranks' gradients' sum, 4 S + 8 x_r sum_r x_r."""
    outs, _ = world(n)
    x = 0.5 * np.arange(1, n + 1)
    S = (x ** 2).sum()
    for r, o in enumerate(outs):
        assert float(o["ar_grad"]) == pytest.approx(4 * S * x[r], rel=1e-12)
        assert float(o["ar_hess"]) == pytest.approx(
            4 * S + 8 * x[r] * x.sum(), rel=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_lookup_matches_dense(n):
    """The row-sharded lookup: the rows of the dense table on every rank,
    and each rank's gradient block the dense table's gradient rows
    (index_add_ of the rows it owns)."""
    case = _lookup_case()
    outs, _ = world(n)
    table = torch.from_numpy(case["lookup_table"]).requires_grad_()
    ids = torch.from_numpy(case["lookup_ids"]).long()
    (table[ids] * torch.from_numpy(case["lookup_ct"])).sum().backward()
    rows = table.shape[0] // n
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["lookup"], case["lookup_table"][
            case["lookup_ids"]])
        np.testing.assert_allclose(o["lookup_grad"], table.grad.numpy()[
            r * rows:(r + 1) * rows], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the dp step


@functools.lru_cache(maxsize=None)
def jax_dp_step():
    """JAX's step on the conftest's 8 devices (the batch sharded over
    "dp"), from its initial parameters, on PRNGKey(11)."""
    jcfg, jtcfg = JModelConfig(**SMALL), JTrainConfig(**TRAIN)
    jp, js, _ = jax_start(0)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    tx = optax.adamw(j_step.lr_schedule_fn(jtcfg),
                     weight_decay=jtcfg.weight_decay)
    jstate = j_step.TrainState(jp, js, tx.init(jp), np.zeros((), np.int32))
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    step = j_step.make_train_step(jcfg, jtcfg, tx, jax_features(), mesh=mesh)
    jnew, jm = step(jstate, first_batch(), jax.random.PRNGKey(11))
    return ({k: float(v) for k, v in jm.items()}, np_tree(jnew.params),
            np_tree(jnew.bn_state))


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_jax_dp_step(n):
    """One step over n ranks, each on its block of the batch, with JAX's
    draw: on every rank the global metrics, the new batch-norm state and
    the parameters of JAX's step on 8 devices."""
    want_m, want_p, want_bn = jax_dp_step()
    grads = jax_loss_and_grads(TRAIN["adv_eps"], key=11, fold=0)[2]
    outs, _ = world(n)
    for o in outs:
        assert int(o["jax_step/step"]) == 1
        assert_metrics_close(_sub(o, "jax_step/metrics"), want_m)
        assert_state_close(_sub(o, "jax_step/bn"), want_bn)
        assert_params_close(_sub(o, "jax_step/params"), want_p, grads,
                            rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_leaves_are_bit_equal(n):
    """Parameters, AdamW moments and batch-norm state equal on every rank,
    bit for bit, after every step."""
    outs, _ = world(n)
    tags = ["jax_step"] + ([f"steps/{k}" for k in range(3)] if n == 2
                           else [])
    for tag in tags:
        want = _sub(outs[0], tag)
        assert any(k.startswith("exp_avg_sq/") for k in want)
        for o in outs[1:]:
            got = _sub(o, tag)
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), (tag, k)


def test_three_dp_steps_equal_single_device_steps():
    """Three dp=2 steps, each equal to the port's single-device step from
    the same state (the checkpoint rank 0 wrote before it) on the global
    batch."""
    outs, ckpt = world(2)
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(**TRAIN)
    train, _, feats = dataset()
    batches = BatchIterator(train, 32, seed=0)
    for k, batch in zip(range(3), batches):
        state, schedule = t_step.create_train_state(
            mcfg, tcfg, generator=torch.Generator().manual_seed(9),
            device=CPU)
        state = restore_train_state(f"{ckpt}/pre_{k}", state)
        assert state.step == k
        step = t_step.make_train_step(mcfg, tcfg, schedule, feats,
                                      device=CPU)
        new, metrics = step(state, batch, 12)
        grads = {name: leaf.grad.numpy()
                 for name, leaf in t_step.named_leaves(new.params)}
        for o in outs:
            assert int(o[f"steps/{k}/step"]) == k + 1
            assert_metrics_close(_sub(o, f"steps/{k}/metrics"), metrics)
            assert_state_close(_sub(o, f"steps/{k}/bn"),
                               flatten(new.bn_state))
            assert_params_close(_sub(o, f"steps/{k}/params"),
                                flatten(new.params), grads, rtol=1e-6)


# ---------------------------------------------------- the row-sharded state


def _mp_whole(outs, tag, kind):
    """The ranks' blocks of the tables stacked, the other leaves rank 0's."""
    got = _sub(outs[0], f"{tag}/{kind}")
    for k in got:
        if k.split("/")[0] in ("ht_item", "ht_cate"):
            got[k] = np.concatenate([_sub(o, f"{tag}/{kind}")[k]
                                     for o in outs])
    return got


def test_mp2_step_equals_single_device_step():
    """dp=1 x mp=2 with train_state_shardings: each rank holds half of each
    table's rows and looks them up through the sharded lookup; the step
    equals the single-device step, the blocks its tables' rows."""
    outs, _ = world(2)
    mcfg, tcfg = ModelConfig(**MP_SMALL), TrainConfig(**TRAIN)
    train, _, feats = mp_dataset()
    state, schedule = t_step.create_train_state(mcfg, tcfg, device=CPU)
    step = t_step.make_train_step(mcfg, tcfg, schedule, feats, device=CPU)
    new, metrics = step(state, next(iter(BatchIterator(train, 32, seed=0))),
                        12)
    grads = {name: leaf.grad.numpy()
             for name, leaf in t_step.named_leaves(new.params)}
    want = flatten(new.params)
    for r, o in enumerate(outs):
        assert_metrics_close(_sub(o, "mp/metrics"), metrics)
        assert_state_close(_sub(o, "mp/bn"), flatten(new.bn_state))
        blocks = _sub(o, "mp/params")
        for table, rows in (("ht_item", 150), ("ht_cate", 10)):
            assert blocks[table].shape == (rows, 8)
    assert_params_close(_mp_whole(outs, "mp", "params"), want, grads,
                        rtol=1e-6)


def test_mp2_checkpoint_restores_into_single_device_state():
    """The dp=1 x mp=2 step's checkpoint holds the whole tables under the
    single-device names: it restores into a single-device TrainState equal
    to the ranks' blocks, moments included."""
    outs, ckpt = world(2)
    template, _ = t_step.create_train_state(
        ModelConfig(**MP_SMALL), TrainConfig(**TRAIN),
        generator=torch.Generator().manual_seed(9), device=CPU)
    restored = restore_train_state(f"{ckpt}/mp_step_1", template)
    assert restored.step == 1
    for kind, got in (("params", flatten(restored.params)),
                      ("bn", flatten(restored.bn_state))):
        want = _mp_whole(outs, "mp", kind)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    moments = restored.opt_state.state_dict()["state"]
    for m in ("exp_avg", "exp_avg_sq"):
        want = _mp_whole(outs, "mp", m)
        for i, (name, _) in enumerate(t_step.named_leaves(restored.params)):
            np.testing.assert_array_equal(moments[i][m].numpy(), want[name],
                                          err_msg=(m, name))


def test_single_device_checkpoint_restores_into_mp2_state():
    """A single-device checkpoint restores into the row-sharded state: each
    rank's blocks (parameters and moments) the saved tables' rows."""
    outs, _ = world(2)
    state, _ = single_checkpoint()
    want_p = flatten(state.params)
    moments = state.opt_state.state_dict()["state"]
    names = [name for name, _ in t_step.named_leaves(state.params)]
    for kind, want in [("params", want_p)] + [
            (m, {name: moments[i][m].numpy() for i, name in enumerate(names)})
            for m in ("exp_avg", "exp_avg_sq")]:
        got = _mp_whole(outs, "restored", kind)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(kind, k))
    for o in outs:
        assert int(o["restored/step"]) == 1
        assert_state_close(_sub(o, "restored/bn"), flatten(state.bn_state))


# -------------------------------------------------------------- the batches


@pytest.mark.parametrize("n", [2, 4])
def test_batch_iterator_blocks_equal_jax_batches(n):
    """The ranks' blocks of every batch, concatenated in "dp" order, are
    JAX's batches (also resumed from batch 11); a batch that does not split
    over dp raises."""
    outs, _ = world(n)
    train = dataset()[0]
    want = list(JBatchIterator(train, 32, epochs=2, seed=1))
    got_n = len({k.split("/")[1] for k in outs[0] if k.startswith("iter/")})
    assert got_n == len(want) == 18
    for i, w in enumerate(want):
        for k in w:
            got = np.concatenate([o[f"iter/{i}/{k}"] for o in outs])
            np.testing.assert_array_equal(got, w[k], err_msg=(i, k))
    for i, w in enumerate(JBatchIterator(train, 32, epochs=2,
                                         seed=1).iter_from(11)):
        got = np.concatenate([o[f"iter_from/{i}/gt_item_id"] for o in outs])
        np.testing.assert_array_equal(got, w["gt_item_id"])
    for o in outs:
        assert int(o["iter_raises"]) == 1


# ------------------------------------------------------------------ the CLI


def _cli(tmp, dp):
    root = os.path.join(tmp, f"dp{dp}")
    argv = ["--job-type", "train", "--dp", str(dp), "--device", "cpu",
            "--synthetic", "--num-item", "300", "--num-cate", "20",
            "--num-users", "100", "--max-seq-length", "10", "--emb-dim", "8",
            "--batch-size", "32", "--num-neg", "8", "--adv-eps", "1e-3",
            "--learning-rate", "1e-3", "--max-steps", "4", "--save-freq", "2",
            "--print-freq", "1", "--output-root", root]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "nann_tpu_torch.main",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(root, "train_metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return root, lines, proc.stdout


def test_cli_dp2_trains_like_dp1(tmp_path):
    """`--dp 2 --device cpu` starts a second rank over gloo: the same
    checkpoints, each written whole by rank 0, one metrics line a step, and
    per-step losses equal to a --dp 1 run's within rtol 1e-5."""
    root2, lines2, out2 = _cli(str(tmp_path), 2)
    root1, lines1, _ = _cli(str(tmp_path), 1)
    assert "--dp 2: 2 ranks, backend gloo" in out2
    assert [m["step"] for m in lines2] == [m["step"] for m in lines1] == \
        [0, 1, 2, 3]
    for m2, m1 in zip(lines2, lines1):
        for k in ("loss", "loss_xe", "acc", "acc_origin"):
            assert m2[k] == pytest.approx(m1[k], rel=1e-5), (m2["step"], k)
        assert m2["loss_adv"] == pytest.approx(m1["loss_adv"], abs=1e-6)
    for root in (root1, root2):
        model = os.path.join(root, "model")
        assert sorted(os.listdir(model)) == ["step_1", "step_3", "step_4"]
        for d in os.listdir(model):
            assert os.listdir(os.path.join(model, d)) == ["train_state.pt"]
    mcfg = ModelConfig(num_item=300, num_cate=20, emb_dim=8,
                       max_seq_length=10, item_tower_dims=(16, 16, 16))
    for root in (root1, root2):
        template, _ = t_step.create_train_state(mcfg, TrainConfig(**TRAIN),
                                                device=CPU)
        assert restore_train_state(os.path.join(root, "model", "step_4"),
                                   template).step == 4
