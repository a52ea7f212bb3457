"""A gloo world of CPU ranks for the port's mesh tests, and the programs its
ranks run.

`run_world(target, payload)` writes the payload (numpy arrays) to a file,
starts `world` processes of this file, each `python torch_world.py target
rank world port payload out`, waits for all of them within `timeout`
seconds, kills what is left and fails if any rank failed, and returns each
rank's output arrays. A rank joins the world over gloo (tcp on localhost, a
port from bind(0)), runs `target(rank, payload)` on one torch thread and
saves what it returns.

The ranks import torch and the port only: the JAX side of a comparison runs
in the test process, and the index reaches the ranks as arrays.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# tests/test_distributed_search.py's fixture
NUM_ITEMS = 1024
# the distributed searcher's cases: name -> (search options, mesh, queries)
CASES = ["list", "bytemap", "batched", "eval", "serving", "wide", "mp2_dp2",
         "batch_axis"]


def configs():
    from nann_tpu_torch.config import ModelConfig, SearchConfig
    mcfg = ModelConfig(num_item=NUM_ITEMS, num_cate=16, emb_dim=8,
                       max_seq_length=6, item_tower_dims=(16, 16, 16),
                       head_dims=(16, 8, 8, 1))
    scfg = SearchConfig(top_k_per_level=(64, 32, 16), topk_eval=(64,),
                        frontier_cap=512)
    return mcfg, scfg


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(target: str, payload, world: int = 4, timeout: float = 240):
    """Run `target` on `world` ranks; returns [rank's outputs] by rank."""
    tmp = tempfile.mkdtemp(prefix="torch_world_")
    path = os.path.join(tmp, "payload.npz")
    np.savez(path, **payload)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, HERE]))
    port = str(free_port())
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, str(rank),
             str(world), port, path, os.path.join(tmp, f"out{rank}.npz")],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    failed = []
    try:
        for rank, p in enumerate(procs):
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                if p.wait(timeout=max(left, 1)) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    if failed:
        raise AssertionError(f"rank(s) {failed} of {target} failed or timed "
                             f"out:\n" + "\n".join(
                                 f"--- rank {r}\n{t[-3000:]}"
                                 for r, t in enumerate(texts)))
    return [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
            for r in range(world)]


# ------------------------------------------------------------ rank programs


def _params(payload, prefix):
    from nann_tpu_torch.models import params_from_jax
    flat = {k[len(prefix):]: v for k, v in payload.items()
            if k.startswith(prefix)}
    return params_from_jax(flat, device="cpu")


def _index(payload, dtype=None):
    import torch
    from nann_tpu_torch.index import IndexArtifacts
    from nann_tpu_torch.search import SearchIndex
    neighbors = {int(k.split("_")[1]): v for k, v in payload.items()
                 if k.startswith("neighbors_")}
    art = IndexArtifacts(enter_points=payload["enter_points"],
                         neighbors=neighbors, num_items=NUM_ITEMS,
                         max_degree=max(v.shape[1]
                                        for v in neighbors.values()))
    return SearchIndex.from_artifacts(art, payload["item_embs"],
                                      payload["item_ids"],
                                      dtype=dtype or torch.float32,
                                      device="cpu")


def _as_placements(p) -> str:
    return " ".join(type(x).__name__ + (f"({x.dim})" if hasattr(x, "dim")
                                        else "") for x in p)


def parallel_cases(rank, payload):
    """tests/test_parallel.py's cases on this rank."""
    import torch
    from nann_tpu_torch.config import ModelConfig
    from nann_tpu_torch.models import init_scorer
    from nann_tpu_torch.parallel import (index_shardings, make_mesh,
                                         param_shardings, shard_pytree,
                                         sharded_gather,
                                         train_state_shardings)
    from nann_tpu_torch.config import TrainConfig
    from nann_tpu_torch.train.step import create_train_state

    out = {}
    m22 = make_mesh(dp=2, mp=2)
    m2 = make_mesh(mp=2)
    out["shape_2x2"] = np.asarray([m22.shape["dp"], m22.shape["mp"]])
    out["shape_mp2"] = np.asarray([m2.shape["dp"], m2.shape["mp"]])
    out["coords"] = np.asarray([m22.index("dp"), m22.index("mp")])
    import torch.distributed as dist
    out["mp_group"] = np.asarray(dist.get_process_group_ranks(
        m22.group("mp")))
    out["dp_group"] = np.asarray(dist.get_process_group_ranks(
        m22.group("dp")))
    for name, kw in (("raises_4x2", dict(dp=4, mp=2)),
                     ("raises_mp3", dict(mp=3))):
        try:
            make_mesh(**kw)
            out[name] = np.asarray(0)
        except ValueError:
            out[name] = np.asarray(1)

    # the param rules, and the placement of divisible tables
    mesh = m22
    mcfg = ModelConfig(num_item=64, num_cate=8, emb_dim=8, max_seq_length=4,
                       item_tower_dims=(16, 16, 16), head_dims=(16, 8, 8, 1))
    params, _ = init_scorer(mcfg, torch.Generator().manual_seed(0), "cpu")
    sh = param_shardings(mesh, params)
    out["rule_ht_item"] = np.asarray(_as_placements(sh["ht_item"]))
    out["rule_ht_cate"] = np.asarray(_as_placements(sh["ht_cate"]))
    out["rule_q1"] = np.asarray(_as_placements(sh["att"]["q1"]["kernel"]))
    params["ht_item"] = torch.arange(64 * 8.).reshape(64, 8)
    params["ht_cate"] = torch.arange(8 * 8.).reshape(8, 8)
    placed = shard_pytree(params, sh, mesh)
    out["placed_ht_item"] = placed["ht_item"].numpy()
    out["placed_q1"] = placed["att"]["q1"]["kernel"].numpy()
    out["q1"] = params["att"]["q1"]["kernel"].numpy()

    # the index rules
    index = _index(payload)
    ish = index_shardings(mesh, index)
    out["rule_item_embs"] = np.asarray(_as_placements(ish.item_embs))
    out["rule_item_ids"] = np.asarray(_as_placements(ish.item_ids))
    out["rule_enter_points"] = np.asarray(_as_placements(ish.enter_points))
    out["rule_neighbors"] = np.asarray(" | ".join(
        _as_placements(p) for p in ish.neighbors.values()))
    local = shard_pytree(index, ish, mesh)
    out["placed_item_embs"] = local.item_embs.numpy()
    out["placed_item_ids"] = local.item_ids.numpy()

    # the train state's rule: tables and their AdamW moments row-sharded
    state, _ = create_train_state(mcfg, TrainConfig(), device="cpu")
    tsh = train_state_shardings(mesh, state)
    out["rule_state_ht_item"] = np.asarray(_as_placements(
        tsh["params"]["ht_item"]))
    out["rule_state_moment"] = np.asarray(_as_placements(
        tsh["opt_state"]["ht_item"]["exp_avg_sq"]))
    out["rule_state_other"] = np.asarray(_as_placements(
        tsh["opt_state"]["att/q1/kernel"]["exp_avg"]))

    # sharded_gather against a dense gather: 1-D ids on mp=2 of a dp=2
    # mesh, 2-D ids on mp=4
    table, ids = payload["table"], payload["ids"]
    rows = table.shape[0] // 2
    block = torch.from_numpy(table[mesh.index("mp") * rows:][:rows].copy())
    out["gather_1d"] = sharded_gather(mesh)(block, torch.from_numpy(
        ids)).numpy()
    m4 = make_mesh(dp=1, mp=4)
    t4 = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    out["gather_2d"] = sharded_gather(m4)(
        t4[m4.index("mp") * 8:][:8].contiguous(),
        torch.tensor([[0, 31], [5, 16]], dtype=torch.int32)).numpy()
    # rows reduced as integers: bfloat16 rows with -0.0, packed int8 rows
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        src = torch.from_numpy(payload[f"rows_{name}"])
        full = src.view(dtype) if dtype == torch.bfloat16 else src
        got = sharded_gather(m4)(full[m4.index("mp") * 8:][:8].contiguous(),
                                 torch.from_numpy(payload["row_ids"]))
        out[f"gather_{name}"] = (got.view(torch.int16) if dtype ==
                                 torch.bfloat16 else got).numpy()
    return out


def _run_cases(mcfg, scfg, params, state, index, users, mesh4, mesh22,
               names):
    import torch
    from nann_tpu_torch.search import level_topn_default
    from nann_tpu_torch.search.distributed import (make_distributed_searcher,
                                                   shard_index)
    out = {}
    one = torch.from_numpy(users[:1])
    batch4 = torch.from_numpy(users[1:5])
    cases = {
        "list": (scfg, mesh4, one, {}),
        "bytemap": (dataclasses.replace(scfg, vis_impl="bytemap"), mesh4,
                    one, {}),
        "batched": (scfg, mesh4, batch4, dict(batch=4)),
        "eval": (scfg, mesh4, one, dict(semantics="eval")),
        "serving": (scfg, mesh4, one, dict(semantics="serving")),
        "wide": (dataclasses.replace(scfg, hop_mode="wide"), mesh4, batch4,
                 {}),
        "mp2_dp2": (scfg, mesh22, one, {}),
        "batch_axis": (scfg, mesh22, batch4, dict(batch=4, batch_axis="dp")),
    }
    shards = {id(mesh4): shard_index(mesh4, index),
              id(mesh22): shard_index(mesh22, index)}
    for name in names:
        cfg, mesh, user, kw = cases[name]
        search = make_distributed_searcher(mcfg, cfg, mesh, **kw)
        got = search(params, state, shards[id(mesh)], user,
                     level_topn_default(cfg, kw.get("semantics")))
        for key, t in zip(("items", "scores", "ns"), got):
            out[f"{name}_{key}"] = t.numpy()
    return out


def distributed_cases(rank, payload):
    """tests/test_distributed_search.py's cases (and more) on this rank."""
    from nann_tpu_torch.parallel import make_mesh
    mcfg, scfg = configs()
    params, state = _params(payload, "p0/")
    mesh4 = make_mesh(dp=1, mp=4)
    mesh22 = make_mesh(dp=2, mp=2)
    users = payload["users"]
    out = _run_cases(mcfg, scfg, params, state, _index(payload), users,
                     mesh4, mesh22, CASES)
    int8 = _run_cases(mcfg, scfg, params, state, _index(payload, "int8"),
                      users, mesh4, mesh22, ["list"])
    out.update({f"int8_{k}": v for k, v in int8.items()})
    out.update(_engine_case(rank, payload, mcfg, scfg, params, state,
                            mesh4))
    return out


def _engine_case(rank, payload, mcfg, scfg, params, state, mesh):
    """Engine(mesh=...) on rank 0 and EngineFollower on the others; rank 0
    also serves the whole index from a local engine. Each serves the same
    requests, swaps to a second model, and serves them again."""
    from nann_tpu_torch.search.distributed import shard_index
    from nann_tpu_torch.serving import Engine, EngineConfig, EngineFollower
    index = _index(payload)
    params1, state1 = _params(payload, "p1/")
    shard, shard1 = shard_index(mesh, index), shard_index(mesh, index)
    users = payload["engine_users"]
    cfg = dict(batch_buckets=(1, 2), wait_ms=1.0)
    out = {}
    if mesh.index("mp") != 0:
        follower = EngineFollower(mcfg, scfg, params, state, shard, mesh)
        follower.swap_model(params1, state1, shard1)
        follower.join(timeout=200)
        out["follower_batches"] = np.asarray(follower.batches)
        return out
    eng_local = Engine(mcfg, scfg, params, state, index,
                       EngineConfig(**cfg, warmup=False))
    eng_mesh = Engine(mcfg, scfg, params, state, shard,
                      EngineConfig(**cfg, mesh=mesh))
    try:
        for tag in ("before", "after"):
            if tag == "after":
                eng_local.swap_model(params1, state1, index)
                eng_mesh.swap_model(params1, state1, shard1)
            for name, eng in (("local", eng_local), ("mesh", eng_mesh)):
                answers = [eng.search_sync(u, timeout=60) for u in users]
                k = max(len(a[0]) for a in answers)
                items = np.full((len(users), k), -1, np.int32)
                for i, (a, _) in enumerate(answers):
                    items[i, :len(a)] = a
                out[f"engine_{name}_{tag}"] = items
    finally:
        eng_mesh.shutdown()
        eng_local.shutdown()
    return out


# ------------------------------------------------ data-parallel training


def _sub(payload, prefix):
    """The payload's arrays under `prefix/`, by their names after it."""
    return {k[len(prefix) + 1:]: v for k, v in payload.items()
            if k.startswith(prefix + "/")}


def _train_configs(payload, prefix="cfg"):
    import json
    from nann_tpu_torch.config import ModelConfig, TrainConfig
    cfg = json.loads(str(payload[prefix]))
    return ModelConfig(**cfg["model"]), TrainConfig(**cfg["train"])


def _state_out(state, tag, out):
    """A TrainState's leaves, bn state and AdamW moments by name, and the
    step, under `tag/`."""
    from nann_tpu_torch.models.scorer import flatten
    from nann_tpu_torch.train.step import named_leaves
    # copies: the step updates the tensors in place, and .numpy() shares
    for k, v in flatten(state.params).items():
        out[f"{tag}/params/{k}"] = v.copy()
    for k, v in flatten(state.bn_state).items():
        out[f"{tag}/bn/{k}"] = v.copy()
    moments = state.opt_state.state_dict()["state"]
    for i, (name, _) in enumerate(named_leaves(state.params)):
        for m in ("exp_avg", "exp_avg_sq"):
            if i in moments:
                out[f"{tag}/{m}/{name}"] = moments[i][m].numpy().copy()
    out[f"{tag}/step"] = np.asarray(state.step)


def _metrics_out(metrics, tag, out):
    for k, v in metrics.items():
        out[f"{tag}/metrics/{k}"] = np.asarray(float(v))


def dp_train_cases(rank, payload):
    """Data-parallel training on a world of 2 or 4 ranks: the global batch
    norm, the all-reduce's second derivative, the row-sharded lookup, the
    dp step from JAX's initial parameters on JAX's draw, BatchIterator's
    blocks; on 2 ranks also three dp steps (each from a checkpoint the test
    steps from on one rank) and a dp=1 x mp=2 step with
    train_state_shardings, its checkpoint, and a restore of a single-device
    checkpoint into the row-sharded state."""
    import torch
    import torch.distributed as dist
    from nann_tpu_torch.data import BatchIterator
    from nann_tpu_torch.models import layers
    from nann_tpu_torch.parallel import (all_reduce_sum, make_mesh,
                                         sharded_embedding,
                                         train_state_shardings)
    from nann_tpu_torch.train import objective
    from nann_tpu_torch.train import step as t_step
    from nann_tpu_torch.train.dataclasses_io import (restore_train_state,
                                                     save_train_state)

    world = dist.get_world_size()
    mesh = make_mesh(dp=world, mp=1)
    group = mesh.group("dp")
    out = {}

    # the batch norm over this rank's block of x, backprop of its share
    x, ct = payload["bn_x"], payload["bn_ct"]
    n = x.shape[0] // world
    xb = torch.from_numpy(x[rank * n:(rank + 1) * n].copy()).requires_grad_()
    bn_p = {k: torch.from_numpy(v) for k, v in _sub(payload, "bn_p").items()}
    bn_s = {k: torch.from_numpy(v) for k, v in _sub(payload, "bn_s").items()}
    y, st = layers.batch_norm_train(bn_p, bn_s, xb, 0.99, 1e-3, group)
    (y * torch.from_numpy(ct[rank * n:(rank + 1) * n])).sum().backward()
    out["bn_y"] = y.detach().numpy()
    out["bn_dx"] = xb.grad.numpy()
    for k, v in st.items():
        out[f"bn_state/{k}"] = v.numpy()

    # (sum_r x_r^2)^2 from each rank's share, differentiated twice
    xr = torch.tensor(0.5 * (rank + 1), dtype=torch.float64,
                      requires_grad=True)
    total = all_reduce_sum(xr ** 2, group)
    (g,) = torch.autograd.grad(total ** 2 / world, xr, create_graph=True)
    (h,) = torch.autograd.grad(g, xr)
    out["ar_grad"], out["ar_hess"] = g.detach().numpy(), h.numpy()

    # the row-sharded lookup on an mp mesh: forward and its gradient block
    mpm = make_mesh(dp=1, mp=world)
    table = payload["lookup_table"]
    rows = table.shape[0] // world
    block = torch.from_numpy(table[rank * rows:(rank + 1) * rows].copy()
                             ).requires_grad_()
    got = sharded_embedding(mpm)(block, torch.from_numpy(payload["lookup_ids"]))
    (got * torch.from_numpy(payload["lookup_ct"])).sum().backward()
    out["lookup"] = got.detach().numpy()
    out["lookup_grad"] = block.grad.numpy()

    mcfg, tcfg = _train_configs(payload)
    feats = _sub(payload, "feat")
    train = _sub(payload, "train")

    # BatchIterator's blocks, and the batch that does not split
    it = BatchIterator(train, 32, epochs=2, seed=1, mesh=mesh, prefetch=2)
    for i, b in enumerate(it):
        for k, v in b.items():
            out[f"iter/{i}/{k}"] = v
    for i, b in enumerate(it.iter_from(11)):
        out[f"iter_from/{i}/gt_item_id"] = b["gt_item_id"]
    try:
        BatchIterator(train, 4 * world + 1, mesh=mesh)
        out["iter_raises"] = np.asarray(0)
    except ValueError:
        out["iter_raises"] = np.asarray(1)

    if world == 2:
        # three dp steps, each from a checkpoint the test steps from
        state, schedule = t_step.create_train_state(mcfg, tcfg, device="cpu")
        step = t_step.make_train_step(mcfg, tcfg, schedule, feats, "cpu",
                                      mesh=mesh)
        ckpt = str(payload["ckpt_dir"])
        for k, batch in enumerate(BatchIterator(train, 32, seed=0,
                                                mesh=mesh)):
            if k == 3:
                break
            save_train_state(f"{ckpt}/pre_{k}", state, mesh)
            dist.barrier()
            state, metrics = step(state, batch, 12)
            _state_out(state, f"steps/{k}", out)
            _metrics_out(metrics, f"steps/{k}", out)

        # dp=1 x mp=2 with the tables row-sharded
        mp_mcfg, _ = _train_configs(payload, "mp_cfg")
        m12 = make_mesh(dp=1, mp=2)
        whole, schedule = t_step.create_train_state(mp_mcfg, tcfg,
                                                    device="cpu")
        sh = train_state_shardings(m12, whole)
        local = t_step.shard_train_state(whole, sh, m12)
        mp_train = _sub(payload, "mp_train")
        step = t_step.make_train_step(mp_mcfg, tcfg, schedule,
                                      _sub(payload, "mp_feat"), "cpu",
                                      mesh=m12, state_shardings=sh)
        batch = next(iter(BatchIterator(mp_train, 32, seed=0, mesh=m12)))
        local, metrics = step(local, batch, 12)
        _state_out(local, "mp", out)
        _metrics_out(metrics, "mp", out)
        save_train_state(f"{ckpt}/mp_step_1", local, m12, sh)
        # a single-device checkpoint into the row-sharded state
        fresh, _ = t_step.create_train_state(
            mp_mcfg, tcfg, generator=torch.Generator().manual_seed(5),
            device="cpu")
        template = t_step.shard_train_state(fresh, sh, m12)
        restored = restore_train_state(str(payload["single_ckpt"]), template,
                                       m12, sh)
        _state_out(restored, "restored", out)

    # one dp step from JAX's initial parameters on JAX's draw
    params, state = _params(payload, "p0/")
    st0 = t_step.train_state_from(params, state, tcfg)
    draw = torch.from_numpy(payload["draw"]).to(torch.int32)
    objective.sample_negatives = lambda gen, log_probs, k: draw
    step = t_step.make_train_step(mcfg, tcfg, t_step.lr_schedule_fn(tcfg),
                                  feats, "cpu", mesh=mesh)
    batch = {k: v[rank * (32 // world):(rank + 1) * (32 // world)]
             for k, v in _sub(payload, "batch").items()}
    new, metrics = step(st0, batch, 12)
    _state_out(new, "jax_step", out)
    _metrics_out(metrics, "jax_step", out)
    return out


def _main(argv) -> None:
    import torch
    import torch.distributed as dist
    target, rank, world, port, payload, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = globals()[target](rank, dict(np.load(payload)))
        np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
