"""The port's serving front ends on the CPU, against the JAX package's where
it has them: the TF-Serving wire codec byte for byte, the REST server
(predict, status, errors, reload), the gRPC server, the model reloader and
selector, and the engine pool. Bundles are written by nann_tpu's
export_model (float32 compute); scores are held within 2e-4, ids exactly."""

import dataclasses
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nann_tpu.serving import Engine as JEngine
from nann_tpu.serving import EngineConfig as JEngineConfig
from nann_tpu.serving import EnginePool as JEnginePool
from nann_tpu.serving import NannServer as JNannServer
from nann_tpu.serving import tfs_proto as j_tfs_proto
from nann_tpu.delivery.verify_export import \
    load_serving_bundle as j_load_serving_bundle

from nann_tpu_torch.delivery import load_search_config, load_serving_bundle
from nann_tpu_torch.search import level_topn_default, make_searcher
from nann_tpu_torch.serving import (Engine, EngineConfig, EnginePool,
                                    ModelReloader, ModelSelector, NannServer,
                                    RequestRejected, tfs_proto)

from test_torch_serving import write_jax_bundles

WAIT_S = 30
TOL = dict(rtol=2e-4, atol=2e-4)   # float32 scores, port against JAX


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return write_jax_bundles(tmp_path_factory.mktemp("torch_frontends"))


def _port_model(bundle):
    params, state, mcfg, index = load_serving_bundle(bundle, device="cpu")
    return mcfg, load_search_config(bundle), params, state, index


def _direct(bundle, users, **scfg_kw):
    """The port's direct search of `users` on `bundle` (its SearchConfig,
    with `scfg_kw` replaced): per request (ids, scores), invalid slots
    stripped."""
    mcfg, scfg, params, state, index = _port_model(bundle)
    scfg = dataclasses.replace(scfg, **scfg_kw)
    items, scores, _ = (x.numpy() for x in make_searcher(mcfg, scfg)(
        params, state, index, torch.from_numpy(np.asarray(users, np.float32)),
        level_topn_default(scfg)))
    return [(i[i >= 0], s[i >= 0]) for i, s in zip(items, scores)]


def _engine(bundle, scfg_kw=None, **cfg):
    """The port's engine on `bundle` (its SearchConfig, with `scfg_kw`
    replaced), small buckets, no warm-up."""
    mcfg, scfg, params, state, index = _port_model(bundle)
    return Engine(mcfg, dataclasses.replace(scfg, **(scfg_kw or {})), params,
                  state, index,
                  EngineConfig(**{"batch_buckets": (1, 4), "wait_ms": 1.0,
                                  "warmup": False, **cfg}))


@pytest.fixture(scope="module")
def engine(bundles):
    eng = _engine(bundles[0][0])
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def jax_engine(bundles):
    dirs, jscfg, _ = bundles
    jp, js, jm, jidx = j_load_serving_bundle(dirs[0], jscfg)
    eng = JEngine(jm, jscfg, jp, js, jidx,
                  JEngineConfig(batch_buckets=(4,), wait_ms=1.0))
    yield eng
    eng.shutdown()


# ------------------------------------------------------------ wire codec


def _arrays():
    rng = np.random.default_rng(0)
    out = {np.dtype(np.float32): rng.standard_normal((3, 5)),
           np.dtype(np.float64): rng.standard_normal((2, 3)),
           np.dtype(np.float16): rng.standard_normal((2, 2, 2)),
           np.dtype(np.bool_): rng.integers(0, 2, (4, 1))}
    for dt in (np.int32, np.uint8, np.int16, np.int8, np.int64, np.uint16,
               np.uint32, np.uint64):
        info = np.iinfo(dt)
        out[np.dtype(dt)] = rng.integers(max(info.min, -300),
                                         min(info.max, 300), (1, 6))
    out = {dt: np.asarray(a).astype(dt) for dt, a in out.items()}
    if tfs_proto._BFLOAT16 is not None:
        out[tfs_proto._BFLOAT16] = rng.standard_normal(7).astype(
            tfs_proto._BFLOAT16)
    out["scalar int32"] = np.asarray(-7, np.int32)
    out["empty float32"] = np.zeros((0, 4), np.float32)
    return out


ARRAYS = _arrays()


def test_codec_covers_every_dtype_it_encodes():
    assert set(tfs_proto._NP_TO_DT) <= set(ARRAYS)
    assert tfs_proto._NP_TO_DT == j_tfs_proto._NP_TO_DT


@pytest.mark.parametrize("key", list(ARRAYS), ids=str)
def test_tensor_bytes_equal_jax_and_decode_both_ways(key):
    arr = ARRAYS[key]
    buf = tfs_proto.encode_tensor(arr)
    assert buf == j_tfs_proto.encode_tensor(arr)
    # both encode a 0-d array as [1] (np.ascontiguousarray gives ndim >= 1)
    shape = np.ascontiguousarray(arr).shape
    for got in (tfs_proto.decode_tensor(buf), j_tfs_proto.decode_tensor(buf)):
        assert got.dtype == arr.dtype and got.shape == shape
        np.testing.assert_array_equal(got, arr)


def test_predict_messages_equal_jax_and_decode_both_ways():
    rng = np.random.default_rng(1)
    inputs = {"comm_seq": rng.standard_normal((1, 96)).astype(np.float16),
              "level_topn": np.array([40, 20, 10, 8], np.int32)}
    outputs = {"top_k": rng.integers(1, 500, (2, 8)).astype(np.int32),
               "scores": rng.standard_normal((2, 8)).astype(np.float32)}
    pairs = [(m.encode_predict_request(inputs, "nann", "serving_default"),
              m.encode_predict_response(outputs, "nann"))
             for m in (tfs_proto, j_tfs_proto)]
    assert pairs[0] == pairs[1]
    req, resp = pairs[0]
    for m in (tfs_proto, j_tfs_proto):
        spec, got = m.decode_predict_request(req)
        assert spec == {"name": "nann", "signature_name": "serving_default"}
        for k, v in inputs.items():
            np.testing.assert_array_equal(got[k], v)
        _spec, got = m.decode_predict_response(resp)
        for k, v in outputs.items():
            np.testing.assert_array_equal(got[k], v)


def test_codec_decodes_the_val_fields():
    """Small tensors as TF's make_tensor_proto writes them: packed int_val,
    a broadcast float_val, half_val bit patterns."""
    tag, varint, ld = tfs_proto._tag, tfs_proto._enc_varint, \
        tfs_proto._len_delim
    shape = lambda *dims: ld(2, b"".join(  # noqa: E731
        ld(2, tag(1, 0) + varint(d)) for d in dims))
    ints = tag(1, 0) + varint(tfs_proto.DT_INT32) + shape(3) + ld(
        7, b"".join(varint(v) for v in (40, -20, 10)))
    floats = tag(1, 0) + varint(tfs_proto.DT_FLOAT) + shape(2, 2) + \
        tag(5, 5) + np.float32(1.5).tobytes()
    half = np.array([0.5, -3.0], np.float16)
    halves = tag(1, 0) + varint(tfs_proto.DT_HALF) + shape(2) + ld(
        13, b"".join(varint(int(v)) for v in half.view(np.uint16)))
    for buf, want in ((ints, np.array([40, -20, 10], np.int32)),
                      (floats, np.full((2, 2), 1.5, np.float32)),
                      (halves, half)):
        for m in (tfs_proto, j_tfs_proto):
            got = m.decode_tensor(buf)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- REST


def _call(port, path, payload=None, raw=None):
    """POST (or GET when there is no body) -> (status, JSON reply)."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers(engine, jax_engine):
    """The port's NannServer and JAX's, each on its engine, on free ports."""
    out = [NannServer(engine, port=0), JNannServer(jax_engine, port=0)]
    for s in out:
        s.start()
    yield out
    for s in out:
        s.stop()


PREDICT = "/v1/models/nann:predict"


@pytest.mark.parametrize("form", ["flat with budget", "[L, d] default"])
def test_predict_matches_jax_server(servers, bundles, form):
    _dirs, _jscfg, users = bundles
    for i in range(3):
        user = users[i]
        inputs = ({"comm_seq": user.reshape(1, -1).tolist(),
                   "level_topn": [50, 25, 10, 8]}
                  if form == "flat with budget"
                  else {"comm_seq": user.tolist()})
        (s_got, got), (s_want, want) = [
            _call(s.port, PREDICT, {"inputs": inputs}) for s in servers]
        assert s_got == s_want == 200
        assert set(got["outputs"]) == set(want["outputs"]) == {"top_k",
                                                               "scores"}
        assert got["outputs"]["top_k"] == want["outputs"]["top_k"]
        np.testing.assert_allclose(got["outputs"]["scores"],
                                   want["outputs"]["scores"], **TOL)
        assert len(got["outputs"]["top_k"][0]) == (
            8 if form == "flat with budget" else 50)


@pytest.mark.parametrize("path,payload,raw", [
    (PREDICT, None, b"{not json"),
    (PREDICT, {"inputs": {"level_topn": [1, 2, 3]}}, None),
    (PREDICT, {"inputs": {"comm_seq": [[1.0, 2.0]]}}, None),
    (PREDICT, {}, None),
    ("/v1/models/nann:explain", {"inputs": {}}, None),
    ("/v1/models/nann", None, None),
    ("/elsewhere", None, None),
    ("/v1/models/nann:reload", {}, None),
], ids=["invalid json", "no comm_seq", "wrong shape", "no inputs",
        "unknown verb", "status", "unknown path", "reload without dir"])
def test_replies_match_jax_server(servers, path, payload, raw):
    """Status codes (200, 400, 404) and bodies equal JAX's."""
    got, want = [_call(s.port, path, payload, raw) for s in servers]
    assert got == want
    assert got[0] in (200, 400, 404)


def test_full_queue_is_429_on_both(bundles):
    """An engine whose queue is full rejects: the server answers 429."""
    dirs, jscfg, users = bundles
    jp, js, jm, jidx = j_load_serving_bundle(dirs[0], jscfg)
    engines = [_engine(dirs[0], max_queue=1),
               JEngine(jm, jscfg, jp, js, jidx,
                       JEngineConfig(batch_buckets=(1,), max_queue=1,
                                     warmup=False))]
    servers = []
    try:
        for eng in engines:
            # stop the dispatcher and leave one request queued
            eng._stop.set()
            eng._dispatcher.join(timeout=WAIT_S)
            eng._completer.join(timeout=WAIT_S)
            eng._stop.clear()
            eng.submit(users[0])
            servers.append(NannServer(eng, port=0) if isinstance(eng, Engine)
                           else JNannServer(eng, port=0))
            servers[-1].start()
        got, want = [_call(s.port, PREDICT,
                           {"inputs": {"comm_seq": users[1].tolist()}})
                     for s in servers]
        assert got == want == (429, {"error": "queue full"})
    finally:
        for s in servers:
            s.stop()
        for eng in engines:
            eng.shutdown()


def test_concurrent_predicts_equal_the_direct_search(servers, bundles):
    dirs, _jscfg, users = bundles
    want = _direct(dirs[0], users)
    got = [None] * len(users)

    def client(c):
        for i in range(c, len(users), 4):
            got[i] = _call(servers[0].port, PREDICT,
                           {"inputs": {"comm_seq": users[i].tolist()}})

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT_S)
    for (status, reply), (items, scores) in zip(got, want):
        assert status == 200
        assert reply["outputs"]["top_k"][0] == items.tolist()
        np.testing.assert_array_equal(
            np.asarray(reply["outputs"]["scores"][0], np.float32), scores)


def test_reload_swaps_in_a_second_bundle(bundles):
    dirs, _jscfg, users = bundles
    before, after = _direct(dirs[0], users[:4]), _direct(dirs[1], users[:4])
    eng = _engine(dirs[0])
    server = NannServer(eng, port=0)
    server.start()
    try:
        status, reply = _call(server.port, "/v1/models/nann:reload",
                              {"export_dir": dirs[1]})
        assert (status, reply) == (200, {"status": "reloaded",
                                         "export_dir": dirs[1]})
        assert eng._model[2].item_embs.device == eng.device
        for i, (items, scores) in enumerate(after):
            got = eng.search_sync(users[i], timeout=WAIT_S)
            np.testing.assert_array_equal(got[0], items)
            np.testing.assert_array_equal(got[1], scores)
        assert any(not np.array_equal(a[0], b[0])
                   for a, b in zip(before, after))
        # a bundle that does not load leaves the model in place
        status, reply = _call(server.port, "/v1/models/nann:reload",
                              {"export_dir": dirs[1] + "_missing"})
        assert status == 500 and reply["error"]
        np.testing.assert_array_equal(eng.search_sync(users[0])[0],
                                      after[0][0])
    finally:
        server.stop()
        eng.shutdown()


# ------------------------------------------------------------------- gRPC


@pytest.fixture(scope="module")
def grpc_servers(engine, jax_engine):
    pytest.importorskip("grpc")
    from nann_tpu.serving.grpc_server import NannGrpcServer as JGrpcServer

    from nann_tpu_torch.serving.grpc_server import NannGrpcServer
    out = [NannGrpcServer(engine, port=0), JGrpcServer(jax_engine, port=0)]
    for s in out:
        s.start()
    yield out
    for s in out:
        s.stop()


def _grpc_call(port, inputs):
    import grpc

    from nann_tpu_torch.serving.grpc_server import make_client_call
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        return make_client_call(ch)(inputs, timeout=WAIT_S)


@pytest.mark.parametrize("form", ["fp16 [1, L*d] with budget",
                                  "fp32 [3, L*d]", "fp32 [2, L, d]"])
def test_grpc_predict_equals_the_engine_and_jax(grpc_servers, engine, bundles,
                                                form):
    _dirs, _jscfg, users = bundles
    L, d = engine.mcfg.max_seq_length, engine.mcfg.user_emb_dim
    ltn = None
    if form.startswith("fp16"):
        comm = users[:1].reshape(1, L * d).astype(np.float16)
        ltn = np.array([50, 25, 10, 8], np.int32)
    elif "[3" in form:
        comm = users[:3].reshape(3, L * d)
    else:
        comm = users[3:5]
    inputs = {"comm_seq": comm} if ltn is None else {"comm_seq": comm,
                                                     "level_topn": ltn}
    got, want = [_grpc_call(s.port, inputs) for s in grpc_servers]
    assert set(got) == {"top_k", "scores"}
    assert got["top_k"].dtype == np.int32 and got["scores"].dtype == np.float32
    np.testing.assert_array_equal(got["top_k"], want["top_k"])
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    rows = comm.astype(np.float32).reshape(-1, L, d)
    assert got["top_k"].shape[0] == len(rows)
    for row, ids, sc in zip(rows, got["top_k"], got["scores"]):
        items, scores = engine.search_sync(row, ltn, timeout=WAIT_S)
        np.testing.assert_array_equal(ids[:len(items)], items)
        np.testing.assert_array_equal(sc[:len(items)], scores)


@pytest.mark.parametrize("inputs", [
    {"comm_seq": np.zeros((1, 7), np.float32)},
    {"level_topn": np.array([1, 2, 3], np.int32)},
    {"comm_seq": np.zeros((0,), np.float32)},
], ids=["wrong size", "no comm_seq", "empty"])
def test_grpc_bad_input_is_invalid_argument(grpc_servers, inputs):
    import grpc
    for s in grpc_servers:
        with pytest.raises(grpc.RpcError) as ei:
            _grpc_call(s.port, inputs)
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


# ------------------------------------------------------- reloader, selector


def test_reloader_picks_up_a_new_version(bundles, tmp_path):
    dirs, _jscfg, users = bundles
    export_dir = str(tmp_path / "served")
    shutil.copytree(dirs[0], export_dir)
    eng = _engine(export_dir)
    try:
        reloader = ModelReloader(eng, export_dir, eng.scfg)
        assert not reloader.check_once()          # unchanged: no reload
        shutil.copytree(dirs[1], export_dir, dirs_exist_ok=True)
        assert reloader.check_once()
        assert reloader.reload_count == 1
        for i, (items, scores) in enumerate(_direct(dirs[1], users[:3])):
            got = eng.search_sync(users[i], timeout=WAIT_S)
            np.testing.assert_array_equal(got[0], items)
            np.testing.assert_array_equal(got[1], scores)
    finally:
        eng.shutdown()


def test_reloader_skips_a_swap_when_the_bundle_changes_during_its_load(
        bundles, tmp_path):
    dirs, _jscfg, users = bundles
    export_dir = str(tmp_path / "served")
    shutil.copytree(dirs[0], export_dir)
    old = _direct(dirs[0], users[:1])[0][0]
    eng = _engine(export_dir)
    try:
        reloader = ModelReloader(eng, export_dir, eng.scfg)
        load = reloader._loader
        landed = []

        def loader_racing_an_export():
            out = load()
            if not landed:              # another export lands mid-load
                landed.append(1)
                with open(os.path.join(export_dir, "VERSION"), "w") as f:
                    f.write("a later export")
            return out

        reloader._loader = loader_racing_an_export
        shutil.copytree(dirs[1], export_dir, dirs_exist_ok=True)
        assert not reloader.check_once()
        assert reloader.reload_count == 0
        np.testing.assert_array_equal(eng.search_sync(users[0])[0], old)
        assert reloader.check_once()              # the next poll swaps
        np.testing.assert_array_equal(eng.search_sync(users[0])[0],
                                      _direct(dirs[1], users[:1])[0][0])
    finally:
        eng.shutdown()


def test_reloader_polls_from_its_thread(bundles, tmp_path):
    dirs, _jscfg, _ = bundles
    export_dir = str(tmp_path / "served")
    shutil.copytree(dirs[0], export_dir)
    eng = _engine(export_dir)
    reloader = ModelReloader(eng, export_dir, eng.scfg, poll_interval_s=0.02)
    try:
        reloader.start()
        shutil.copytree(dirs[1], export_dir, dirs_exist_ok=True)
        t_end = time.perf_counter() + WAIT_S
        while reloader.reload_count == 0 and time.perf_counter() < t_end:
            time.sleep(0.01)
        assert reloader.reload_count == 1
    finally:
        reloader.stop()
        eng.shutdown()


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_selector_switches_on_a_timer(bundles, cold):
    """Two engines, the list and the byte-map backend, behind one selector:
    it cycles through both, and every answer is the direct search's."""
    dirs, _jscfg, users = bundles
    engines = {"list": _engine(dirs[0]),
               "bytemap": _engine(dirs[0], {"vis_impl": "bytemap"})}
    want = {"list": _direct(dirs[0], users),
            "bytemap": _direct(dirs[0], users, vis_impl="bytemap")}
    sel = ModelSelector(engines)
    try:
        assert sel.active_name == "list"
        sel.select("bytemap")
        assert sel.active is engines["bytemap"]
        with pytest.raises(KeyError):
            sel.select("missing")
        seen, answers = set(), []
        sel.start_switching(0.02, cold_switching=cold)
        t_end = time.perf_counter() + WAIT_S
        i = 0
        while (len(seen) < 2 or i < len(users)) and \
                time.perf_counter() < t_end:
            seen.add(sel.active_name)
            k = i % len(users)          # one client, waiting for each answer
            answers.append((k, sel.submit(users[k]).result(timeout=WAIT_S)))
            i += 1
        sel.stop()
        assert seen == {"list", "bytemap"}
        for k, (items, scores) in answers:
            assert any(np.array_equal(items, w[k][0])
                       and np.array_equal(scores, w[k][1])
                       for w in want.values()), k
    finally:
        sel.stop()
        for eng in engines.values():
            eng.shutdown()


# ------------------------------------------------------------------- pool


class _Gate:
    """A search that waits for release: holds an engine's dispatcher."""

    def __init__(self, search):
        self.search, self.open, self.entered = search, threading.Event(), \
            threading.Event()

    def __call__(self, *args):
        self.entered.set()
        assert self.open.wait(WAIT_S)
        return self.search(*args)


@pytest.fixture(scope="module")
def pool(bundles):
    mcfg, scfg, params, state, index = _port_model(bundles[0][0])
    p = EnginePool(mcfg, scfg, params, state, index, devices=["cpu", "cpu"],
                   config=EngineConfig(batch_buckets=(1, 4), wait_ms=1.0,
                                       warmup=False))
    yield p
    p.shutdown()


def test_pool_spreads_load_over_its_engines(pool, bundles):
    dirs, _jscfg, users = bundles
    want = _direct(dirs[0], users)
    before = pool.aggregate_metrics()["per_engine"]
    futures = [pool.submit(u) for u in users]
    for fut, (items, scores) in zip(futures, want):
        got = fut.result(timeout=WAIT_S)
        np.testing.assert_array_equal(got[0], items)
        np.testing.assert_array_equal(got[1], scores)
    agg = pool.aggregate_metrics()
    served = [a - b for a, b in zip(agg["per_engine"], before)]
    assert sum(served) == len(users) and all(n > 0 for n in served), served
    assert all(e.device == torch.device("cpu") for e in pool.engines)


def test_pool_swaps_every_engine(pool, bundles):
    dirs, _jscfg, users = bundles
    model = _port_model(dirs[1])
    pool.swap_model(*model[2:])
    try:
        for eng in pool.engines:
            for i, (items, scores) in enumerate(_direct(dirs[1], users[:2])):
                got = eng.search_sync(users[i], timeout=WAIT_S)
                np.testing.assert_array_equal(got[0], items)
                np.testing.assert_array_equal(got[1], scores)
    finally:
        pool.swap_model(*_port_model(dirs[0])[2:])


def test_pool_routes_around_a_stalled_engine(pool, bundles):
    """Engine 0 holds a batch in its search and 10 requests in its queue:
    the pool sends new requests to engine 1, and they are answered."""
    dirs, _jscfg, users = bundles
    stalled = pool.engines[0]
    gate = _Gate(stalled._search)
    stalled._search = gate
    try:
        held = [stalled.submit(users[0])]
        assert gate.entered.wait(WAIT_S)
        held += [stalled.submit(users[i % len(users)]) for i in range(10)]
        assert stalled.depth() >= 10
        count1 = pool.engines[1].metrics.throughput.count
        want = _direct(dirs[0], users[:6])
        for fut, (items, _scores) in zip([pool.submit(u) for u in users[:6]],
                                         want):
            np.testing.assert_array_equal(fut.result(timeout=WAIT_S)[0],
                                          items)
        assert pool.engines[1].metrics.throughput.count - count1 == 6
    finally:
        gate.open.set()
        stalled._search = gate.search
    for fut in held:
        fut.result(timeout=WAIT_S)


def test_pool_rejects_only_when_every_engine_is_full(bundles):
    dirs, _jscfg, users = bundles
    mcfg, scfg, params, state, index = _port_model(dirs[0])
    p = EnginePool(mcfg, scfg, params, state, index, devices=["cpu", "cpu"],
                   config=EngineConfig(batch_buckets=(1,), max_queue=1,
                                       warmup=False))
    gates = [_Gate(e._search) for e in p.engines]
    for e, g in zip(p.engines, gates):
        e._search = g
    try:
        held = []
        for e, g in zip(p.engines, gates):   # each engine holds a batch
            held.append(e.submit(users[0]))
            assert g.entered.wait(WAIT_S)
        held += [e.submit(users[1]) for e in p.engines]   # and fills its queue
        assert [e.depth() for e in p.engines] == [1, 1]
        over = p.submit(users[4])
        with pytest.raises(RequestRejected, match="queue full"):
            over.result(timeout=WAIT_S)
        assert sum(e.metrics.rejected.count for e in p.engines) == 2
        for g in gates:
            g.open.set()
        for fut in held:
            assert len(fut.result(timeout=WAIT_S)[0]) == 50
    finally:
        for g in gates:
            g.open.set()
        p.shutdown()


def test_pool_metrics_keys_match_jax(pool, bundles):
    dirs, jscfg, _ = bundles
    jp, js, jm, jidx = j_load_serving_bundle(dirs[0], jscfg)
    jpool = JEnginePool(jm, jscfg, jp, js, jidx, devices=jax.devices()[:2],
                        config=JEngineConfig(batch_buckets=(1,), warmup=False))
    try:
        want = jpool.aggregate_metrics()
    finally:
        jpool.shutdown()
    got = pool.aggregate_metrics()
    assert set(got) == set(want)
    assert len(got["per_engine"]) == len(want["per_engine"]) == 2


def test_pool_wants_a_card_by_default(bundles, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg, scfg, params, state, index = _port_model(bundles[0][0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnginePool(mcfg, scfg, params, state, index)
