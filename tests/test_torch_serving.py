"""The port's serving engine on the CPU: answers, batching, admission
(queue cap, deadlines, bad requests) and shutdown; the answers of JAX's
engine on a JAX-exported bundle; hot swap, calibration, runmeta record and
replay, the device-time and saturated-cap meters, and the reporter."""

import dataclasses
import functools
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nann_tpu.config import SearchConfig as JSearchConfig
from nann_tpu.delivery import export_model as j_export_model
from nann_tpu.delivery.verify_export import \
    load_serving_bundle as j_load_serving_bundle
from nann_tpu.index import build_and_save_index as j_build_and_save_index
from nann_tpu.serving import Engine as JEngine
from nann_tpu.serving import EngineConfig as JEngineConfig
from nann_tpu.serving import MetricsRegistry as JMetricsRegistry

from nann_tpu_torch.config import ModelConfig, SearchConfig
from nann_tpu_torch.delivery import load_search_config, load_serving_bundle
from nann_tpu_torch.index import build_and_save_index, load_index
from nann_tpu_torch.models import init_scorer
from nann_tpu_torch.search import SearchIndex, level_topn_default, make_searcher
from nann_tpu_torch.serving import (Engine, EngineConfig, LoadGenConfig,
                                    MetricsRegistry, RequestRejected,
                                    run_load_test)

from test_torch_scorer import jax_model

MCFG = ModelConfig(num_item=100, num_cate=10, emb_dim=8, max_seq_length=8,
                   item_tower_dims=(16, 16, 16), head_dims=(16, 8, 8, 1))
SCFG = SearchConfig(top_k_per_level=(50, 25, 10), topk_eval=(50,),
                    frontier_cap=512)
WAIT_S = 30


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params, state = init_scorer(MCFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((1000, MCFG.item_emb_dim)).astype(np.float32)
    d = str(tmp_path_factory.mktemp("torch_engine_idx"))
    build_and_save_index(embs, 2, 8, d, ef_construction=40)
    index = SearchIndex.from_artifacts(load_index(d, 2, max_degree=16), embs,
                                       np.arange(1, 1001), device="cpu")
    users = rng.standard_normal((24, 8, 16)).astype(np.float32)
    direct = make_searcher(MCFG, SCFG)(params, state, index,
                                       torch.from_numpy(users),
                                       level_topn_default(SCFG))
    return params, state, index, users, [d.numpy() for d in direct]


@pytest.fixture(scope="module")
def engine(setup):
    params, state, index, *_ = setup
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4, 16), wait_ms=2.0))
    yield eng
    eng.shutdown()


def _expect(direct, i):
    items, scores, _ = direct
    keep = items[i] >= 0
    return items[i][keep], scores[i][keep]


def test_sync_request_matches_direct_search(engine, setup):
    *_, users, direct = setup
    items, scores = engine.search_sync(users[0], timeout=WAIT_S)
    want_items, want_scores = _expect(direct, 0)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_array_equal(scores, want_scores)
    assert len(items) == 50 and np.all(np.diff(scores) <= 0)


def test_concurrent_requests_are_all_answered(engine, setup):
    *_, users, direct = setup
    futures = [None] * len(users)

    def client(c):
        for i in range(c, len(users), 4):
            futures[i] = engine.submit(users[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT_S)
    assert not any(th.is_alive() for th in threads)
    for i, fut in enumerate(futures):
        items, _ = fut.result(timeout=WAIT_S)
        np.testing.assert_array_equal(items, _expect(direct, i)[0])
    assert engine.metrics.batch_size.snapshot()["max"] > 1
    assert engine.metrics.failures.count == 0


def test_mixed_level_topn_requests(engine, setup):
    params, state, index, users, _ = setup
    small = np.array([20, 10, 10, 5], np.int32)
    f_small = engine.submit(users[1], level_topn=small)
    f_default = engine.submit(users[2])
    want = make_searcher(MCFG, SCFG)(params, state, index,
                                     torch.from_numpy(users[1:2]), small)
    items, _ = f_small.result(timeout=WAIT_S)
    assert len(items) == 5
    np.testing.assert_array_equal(items, want[0][0][want[0][0] >= 0].numpy())
    assert len(f_default.result(timeout=WAIT_S)[0]) == 50


@pytest.mark.parametrize("user_shape,ltn_len", [((8, 15), 4), ((8, 16), 3)])
def test_malformed_request_fails_its_future(engine, user_shape, ltn_len):
    fut = engine.submit(np.zeros(user_shape, np.float32),
                        level_topn=np.ones(ltn_len, np.int32))
    with pytest.raises(ValueError):
        fut.result(timeout=WAIT_S)


class _Gate:
    """A search that waits for release: holds the dispatcher mid-batch."""

    def __init__(self, search):
        self.search, self.open, self.entered = search, threading.Event(), \
            threading.Event()

    def __call__(self, *args):
        self.entered.set()
        assert self.open.wait(WAIT_S)
        return self.search(*args)


def _gated_engine(setup, **cfg):
    params, state, index, *_ = setup
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4), warmup=False, **cfg))
    gate = _Gate(eng._search)
    eng._search = gate
    return eng, gate


def test_full_queue_rejects(setup):
    *_, users, direct = setup
    eng, gate = _gated_engine(setup, max_queue=3, wait_ms=0.0)
    try:
        first = eng.submit(users[0])
        assert gate.entered.wait(WAIT_S)        # dispatcher holds one batch
        queued = [eng.submit(users[i]) for i in range(1, 4)]
        rejected = [eng.submit(users[i]) for i in range(4, 6)]
        for fut in rejected:
            with pytest.raises(RequestRejected, match="queue full"):
                fut.result(timeout=WAIT_S)
        assert eng.metrics.rejected.count == 2
        gate.open.set()
        for i, fut in enumerate([first] + queued):
            np.testing.assert_array_equal(fut.result(timeout=WAIT_S)[0],
                                          _expect(direct, i)[0])
    finally:
        gate.open.set()
        eng.shutdown()


def test_expired_deadline_rejects(setup):
    *_, users, _ = setup
    eng, gate = _gated_engine(setup, wait_ms=0.0)
    try:
        first = eng.submit(users[0])
        assert gate.entered.wait(WAIT_S)
        late = eng.submit(users[1], deadline_ms=1.0)
        patient = eng.submit(users[2], deadline_ms=60_000.0)
        time.sleep(0.05)
        gate.open.set()
        with pytest.raises(RequestRejected, match="deadline"):
            late.result(timeout=WAIT_S)
        assert len(first.result(timeout=WAIT_S)[0]) == 50
        assert len(patient.result(timeout=WAIT_S)[0]) == 50
    finally:
        gate.open.set()
        eng.shutdown()


def test_shutdown_answers_or_rejects_everything(setup):
    *_, users, _ = setup
    eng, gate = _gated_engine(setup, wait_ms=0.0)
    futures = [eng.submit(users[0])]
    assert gate.entered.wait(WAIT_S)
    futures += [eng.submit(users[i]) for i in range(1, 6)]
    threading.Timer(0.1, gate.open.set).start()
    eng.shutdown()
    assert not eng._dispatcher.is_alive() and not eng._completer.is_alive()
    for fut in futures:
        assert fut.done()
        if fut.exception() is not None:
            assert isinstance(fut.exception(), RequestRejected)
    assert futures[0].exception() is None
    late = eng.submit(users[0])
    with pytest.raises(RequestRejected):
        late.result(timeout=WAIT_S)


def test_metrics_report(engine, setup):
    *_, users, _ = setup
    engine.search_sync(users[3], timeout=WAIT_S)
    lines = engine.metrics.report_lines()
    assert any("throughput" in line for line in lines)
    assert engine.metrics.latency_us.snapshot()["count"] >= 1
    t_end = time.perf_counter() + WAIT_S
    while engine.depth() and time.perf_counter() < t_end:
        time.sleep(0.01)
    assert engine.depth() == 0


@pytest.mark.parametrize("options", [
    {"vis_impl": "bytemap", "semantics": "serving"},
    {"hop_mode": "wide", "mark_policy": "all", "topk_impl": "approx"}],
    ids=["bytemap-serving", "wide-all-approx"])
def test_engine_serves_other_search_options(setup, options):
    """The engine runs whatever search its SearchConfig asks for, with that
    config's level_topn layout, and answers as the direct search does."""
    params, state, index, users, _ = setup
    scfg = dataclasses.replace(SCFG, **options)
    direct = [d.numpy() for d in make_searcher(MCFG, scfg)(
        params, state, index, torch.from_numpy(users[:4]),
        level_topn_default(scfg))]
    eng = Engine(MCFG, scfg, params, state, index,
                 EngineConfig(batch_buckets=(1, 4), wait_ms=2.0))
    try:
        futures = [eng.submit(users[i]) for i in range(4)]
        for i, f in enumerate(futures):
            items, scores = f.result(timeout=WAIT_S)
            want_items, want_scores = _expect(direct, i)
            np.testing.assert_array_equal(items, want_items)
            np.testing.assert_array_equal(scores, want_scores)
    finally:
        eng.shutdown()


def test_engine_config_defaults_match_jax():
    """The same bucket ladder (up to 128) and the same options, but the
    sharded and staged paths, which the port does not have."""
    got = dataclasses.asdict(EngineConfig())
    want = dataclasses.asdict(JEngineConfig())
    assert got == {k: v for k, v in want.items()
                   if k not in ("mesh", "staged")}
    assert tuple(got["batch_buckets"]) == (1, 4, 16, 64, 128)


# ------------------------------------------------- a JAX-exported bundle

BUNDLE_ITEMS = 600
BUNDLE_SCFG = dict(top_k_per_level=(50, 25, 10), topk_eval=(50,),
                   frontier_cap=512)


def write_jax_bundles(root, seeds=(2, 3)):
    """Bundles written by nann_tpu's export_model over one catalogue and one
    graph, a model (float32 compute) of each seed; and 12 requests.
    Returns (bundle dirs, JAX SearchConfig, users [12, L, d_user])."""
    rng = np.random.default_rng(7)
    jscfg = JSearchConfig(**BUNDLE_SCFG)
    embs = rng.standard_normal((BUNDLE_ITEMS, 32)).astype(np.float32)
    index_dir = str(root / "index")
    j_build_and_save_index(embs, 2, 8, index_dir, ef_construction=40)
    dirs = []
    for seed in seeds:
        jcfg, jp, js, _ = jax_model(seed=seed)
        d = str(root / f"bundle_{seed}")
        j_export_model(d, jp, js, jcfg, jscfg,
                       item_ids=np.arange(1, BUNDLE_ITEMS + 1), item_embs=embs,
                       index_dir=index_dir)
        dirs.append(d)
    users = rng.standard_normal(
        (12, jcfg.max_seq_length, jcfg.user_emb_dim)).astype(np.float32)
    return dirs, jscfg, users


@pytest.fixture(scope="module")
def jax_bundles(tmp_path_factory):
    return write_jax_bundles(tmp_path_factory.mktemp("torch_serving_bundles"))


def test_engine_matches_jax_engine_on_a_jax_bundle(jax_bundles):
    """The same 12 requests through JAX's engine and the port's, each on the
    bundle as its own package loads it (float32 compute): equal ids, scores
    within 2e-4."""
    dirs, jscfg, users = jax_bundles
    jp, js, jm, jidx = j_load_serving_bundle(dirs[0], jscfg)
    j_eng = JEngine(jm, jscfg, jp, js, jidx,
                    JEngineConfig(batch_buckets=(16,), wait_ms=2.0))
    params, state, mcfg, index = load_serving_bundle(dirs[0], device="cpu")
    eng = Engine(mcfg, load_search_config(dirs[0]), params, state, index,
                 EngineConfig(batch_buckets=(1, 4, 16), wait_ms=2.0))
    try:
        want = [f.result(timeout=WAIT_S) for f in
                [j_eng.submit(u) for u in users]]
        got = [f.result(timeout=WAIT_S) for f in
               [eng.submit(u) for u in users]]
    finally:
        j_eng.shutdown()
        eng.shutdown()
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------- hot swap


@pytest.fixture(scope="module")
def second_model(setup):
    """Another seed's params on the same index, and its direct answers."""
    *_, index, users, _ = setup
    params2, state2 = init_scorer(MCFG, torch.Generator().manual_seed(1),
                                  "cpu")
    direct2 = make_searcher(MCFG, SCFG)(params2, state2, index,
                                        torch.from_numpy(users),
                                        level_topn_default(SCFG))
    return params2, state2, [d.numpy() for d in direct2]


def test_swap_model_answers_with_the_new_model(setup, second_model):
    params, state, index, users, direct = setup
    params2, state2, direct2 = second_model
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4), wait_ms=1.0, warmup=False))
    try:
        np.testing.assert_array_equal(eng.search_sync(users[0])[0],
                                      _expect(direct, 0)[0])
        eng.swap_model(params2, state2, index)
        for i in range(4):
            items, scores = eng.search_sync(users[i], timeout=WAIT_S)
            want_items, want_scores = _expect(direct2, i)
            np.testing.assert_array_equal(items, want_items)
            np.testing.assert_array_equal(scores, want_scores)
        assert not np.array_equal(_expect(direct, 0)[0],
                                  _expect(direct2, 0)[0])
    finally:
        eng.shutdown()


def test_concurrent_submitters_across_swaps_all_resolve(setup, second_model):
    """Twelve threads (more than the cores) submit, with a short switch
    interval, while the model is swapped back and forth: every Future
    resolves, to the answer of one of the two models, and the engine's count
    of dispatched requests returns to 0."""
    params, state, index, users, direct = setup
    params2, state2, direct2 = second_model
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4, 16), wait_ms=1.0,
                              warmup=False))
    n_threads, per_thread = 12, 6
    futures = [[] for _ in range(n_threads)]

    def client(c):
        for k in range(per_thread):
            i = (n_threads * k + c) % len(users)
            futures[c].append((i, eng.submit(users[i])))
            time.sleep(0.001)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for th in threads:
            th.start()
        for k in range(8):
            eng.swap_model(*((params2, state2) if k % 2 == 0
                             else (params, state)), index)
            time.sleep(0.003)
        for th in threads:
            th.join(timeout=WAIT_S)
        assert not any(th.is_alive() for th in threads)
        answers = [(i, f.result(timeout=WAIT_S)[0])
                   for per in futures for i, f in per]
        t_end = time.perf_counter() + WAIT_S
        while eng.depth() and time.perf_counter() < t_end:
            time.sleep(0.01)
        assert eng.depth() == 0
    finally:
        sys.setswitchinterval(interval)
        eng.shutdown()
    assert len(answers) == n_threads * per_thread
    for i, items in answers:
        assert (np.array_equal(items, _expect(direct, i)[0])
                or np.array_equal(items, _expect(direct2, i)[0])), i
    assert eng.metrics.failures.count == 0
    assert eng.metrics.throughput.count == n_threads * per_thread


# -------------------------------------------------------------- calibration


def _small_windows(monkeypatch):
    """Calibration windows of 50 ms, 2 rounds (the keyword arguments of
    Engine._calibrate), so that a test calibrates in well under a second."""
    monkeypatch.setattr(Engine, "_calibrate", functools.partialmethod(
        Engine._calibrate, window_s=0.05, repeats=2))


def test_calibration_measures_then_reads_its_file(setup, tmp_path,
                                                  monkeypatch):
    _small_windows(monkeypatch)
    params, state, index, users, direct = setup
    path = tmp_path / "calibration.json"
    cfg = EngineConfig(batch_buckets=(1, 4), wait_ms=1.0, warmup=False,
                       calibrate=True, calibration_file=str(path))
    eng = Engine(MCFG, SCFG, params, state, index, cfg)
    try:
        assert eng.calibration_source == "measured"
        assert eng._serve_cap in (1, 4)
        assert set(eng.bucket_qps) == {1, 4}
        np.testing.assert_array_equal(eng.search_sync(users[0])[0],
                                      _expect(direct, 0)[0])
    finally:
        eng.shutdown()
    prof = json.loads(path.read_text())
    (key, entry), = prof.items()
    assert key == eng._calibration_fingerprint()
    assert set(entry) == {"serve_bucket", "bucket_qps", "ts"}
    assert entry["serve_bucket"] == eng._serve_cap
    assert set(entry["bucket_qps"]) == {"1", "4"}

    again = Engine(MCFG, SCFG, params, state, index, cfg)
    try:
        assert again.calibration_source == "cached"
        assert again._serve_cap == eng._serve_cap
        assert again.bucket_qps == {int(k): v
                                    for k, v in entry["bucket_qps"].items()}
    finally:
        again.shutdown()


def test_calibration_fingerprint_follows_the_search(setup):
    params, state, index, *_ = setup
    cfg = EngineConfig(batch_buckets=(1, 4), warmup=False)
    prints = []
    for scfg, c in ((SCFG, cfg), (dataclasses.replace(SCFG, frontier_cap=256),
                                  cfg),
                    (SCFG, dataclasses.replace(cfg, batch_buckets=(1, 8)))):
        eng = Engine(MCFG, scfg, params, state, index, c)
        prints.append(eng._calibration_fingerprint())
        eng.shutdown()
    assert len(set(prints)) == 3
    assert eng._device_name() == "cpu"


def test_serve_bucket_caps_the_batches(setup):
    """An explicit serving bucket skips calibration and caps batch
    formation at the smallest bucket that holds it."""
    params, state, index, users, direct = setup
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4, 16), wait_ms=5.0,
                              warmup=False, serve_bucket=3, calibrate=True))
    try:
        assert eng._serve_cap == 4 and eng.calibration_source == "none"
        futures = [eng.submit(users[i]) for i in range(12)]
        for i, f in enumerate(futures):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S)[0],
                                          _expect(direct, i)[0])
        assert eng.metrics.batch_size.snapshot()["max"] <= 4
    finally:
        eng.shutdown()


# ------------------------------------------------- runmeta, meters, reporter


def test_runmeta_record_dump_and_replay(setup, tmp_path):
    params, state, index, users, _ = setup
    eng = Engine(MCFG, SCFG, params, state, index,
                 EngineConfig(batch_buckets=(1, 4), wait_ms=1.0,
                              record_requests=4, warmup=False))
    try:
        for i in range(6):
            eng.search_sync(users[i], timeout=WAIT_S)
        path = str(tmp_path / "runmeta.npz")
        assert eng.dump_runmeta(path) == 4      # the last 4 kept
        with np.load(path) as rec:
            assert set(rec.files) == {"user_seq_emb", "level_topn",
                                      "latency_us"}
            np.testing.assert_array_equal(rec["user_seq_emb"], users[2:6])
            assert rec["level_topn"].shape == (4, len(level_topn_default(SCFG)))
            assert rec["latency_us"].shape == (4,)
            assert rec["latency_us"].min() > 0
        res = run_load_test(eng, LoadGenConfig(duration_s=1.0, qps=100,
                                               num_producers=1,
                                               replay_path=path),
                            verbose=False)
        assert set(res) == {"qps", "total", "rejected", "failures",
                            "latency_p50_us", "latency_p99_us",
                            "device_p50_us", "device_p99_us", "mean_batch",
                            "duration_s"}
        assert res["total"] >= 1 and res["failures"] == 0
    finally:
        eng.shutdown()


def test_device_us_and_batch_size_count_every_batch(engine, setup):
    *_, users, _ = setup
    for f in [engine.submit(users[i]) for i in range(8)]:
        f.result(timeout=WAIT_S)
    t_end = time.perf_counter() + WAIT_S
    while (engine.metrics.device_us.snapshot()["count"]
           != engine.metrics.batch_size.snapshot()["count"]
           and time.perf_counter() < t_end):
        time.sleep(0.01)
    dev = engine.metrics.device_us.snapshot()
    assert dev["count"] == engine.metrics.batch_size.snapshot()["count"] > 0
    assert dev["p50"] > 0


def test_cap_saturated_counts_requests_at_a_per_hop_cap(setup):
    """Every hop of every request reaches a per-hop cap of 8 rows."""
    params, state, index, users, _ = setup
    hops = sum(SCFG.num_scoring_per_level[:SCFG.hnsw_start_level])
    scfg = dataclasses.replace(SCFG, frontier_cap_per_hop=(8,) * hops)
    direct = [d.numpy() for d in make_searcher(MCFG, scfg)(
        params, state, index, torch.from_numpy(users[:6]),
        level_topn_default(scfg))]
    assert (direct[2][:, 1:] == 8).all()
    eng = Engine(MCFG, scfg, params, state, index,
                 EngineConfig(batch_buckets=(1, 4), wait_ms=1.0, warmup=False))
    try:
        for i, f in enumerate([eng.submit(users[i]) for i in range(6)]):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S)[0],
                                          _expect(direct, i)[0])
        assert eng.metrics.cap_saturated.count == 6
    finally:
        eng.shutdown()


def test_report_lines_match_jax():
    assert MetricsRegistry("m").report_lines() == \
        JMetricsRegistry("m").report_lines()


def test_reporter_writes_to_its_sink_until_stopped():
    metrics = MetricsRegistry("r")
    for _ in range(2):                # a stopped reporter starts again
        lines = []
        metrics.start_reporter(0.01, lines.append)
        t_end = time.perf_counter() + WAIT_S
        while len(lines) < 10 and time.perf_counter() < t_end:
            time.sleep(0.01)
        metrics.stop_reporter()
        n = len(lines)
        time.sleep(0.05)
        assert n >= 10 and len(lines) == n
        assert lines[:5] == metrics.report_lines()

