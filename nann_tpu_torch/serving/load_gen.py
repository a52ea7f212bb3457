"""Load generator (nann_tpu/serving/load_gen.py): producer threads submit
requests at a target rate (-1: as fast as the engine admits them) for a
fixed time, and the engine's meters give the run's throughput, latency,
device time and batch size.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict

import numpy as np

from .engine import Engine


@dataclasses.dataclass
class LoadGenConfig:
    duration_s: float = 10.0
    qps: float = -1.0                # -1 = as fast as admitted
    num_producers: int = 4
    report_interval_s: float = 3.0
    seed: int = 0
    replay_path: str = ""            # runmeta npz from Engine.dump_runmeta:
    #                                  replay its requests instead of random
    #                                  ones


def run_load_test(engine: Engine, config: LoadGenConfig,
                  verbose: bool = True) -> Dict[str, float]:
    """Drive the engine; returns this run's summary metrics (the counts are
    this run's, the histograms the engine's)."""
    stop = threading.Event()
    mcfg = engine.mcfg
    inflight_sem = threading.Semaphore(engine.config.max_queue)

    replay = None
    if config.replay_path:
        with np.load(config.replay_path) as rec:
            replay = (rec["user_seq_emb"].astype(np.float32),
                      rec["level_topn"].astype(np.int32))

    def producer(tid: int):
        # requests are made before the paced loop: drawing each one there
        # costs the loop its rate on a busy host
        per_thread_qps = (config.qps / config.num_producers
                          if config.qps > 0 else None)
        if replay is not None:
            pool_u, pool_l = replay
        else:
            rng = np.random.default_rng(config.seed + tid)
            pool_u = rng.standard_normal(
                (64, mcfg.max_seq_length, mcfg.user_emb_dim)
            ).astype(np.float32)
            pool_l = None
        next_t = time.perf_counter()
        i = tid
        while not stop.is_set():
            if per_thread_qps:
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(min(next_t - now, 0.05))
                    continue
                next_t += 1.0 / per_thread_qps
            user = pool_u[i % len(pool_u)]
            ltn = pool_l[i % len(pool_l)] if pool_l is not None else None
            i += config.num_producers
            if not inflight_sem.acquire(timeout=0.1):
                continue
            fut = engine.submit(user, ltn)
            fut.add_done_callback(lambda _f: inflight_sem.release())

    threads = [threading.Thread(target=producer, args=(t,), daemon=True)
               for t in range(config.num_producers)]
    if verbose:
        engine.metrics.start_reporter(config.report_interval_s)
    # the meters count over the engine's life: report this run's part
    count0 = engine.metrics.throughput.count
    rejected0 = engine.metrics.rejected.count
    failures0 = engine.metrics.failures.count
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(config.duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=1)
    wall = time.monotonic() - t0
    time.sleep(0.3)   # drain
    if verbose:
        engine.metrics.stop_reporter()

    lat = engine.metrics.latency_us.snapshot()
    bs = engine.metrics.batch_size.snapshot()
    dev = engine.metrics.device_us.snapshot()
    return {
        "qps": (engine.metrics.throughput.count - count0) / wall,
        "total": engine.metrics.throughput.count - count0,
        "rejected": engine.metrics.rejected.count - rejected0,
        "failures": engine.metrics.failures.count - failures0,
        "latency_p50_us": lat["p50"],
        "latency_p99_us": lat["p99"],
        "device_p50_us": dev["p50"],
        "device_p99_us": dev["p99"],
        "mean_batch": bs["mean"],
        "duration_s": wall,
    }
