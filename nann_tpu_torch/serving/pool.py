"""Engines over several devices, one each (nann_tpu/serving/pool.py).

Each device gets its own Engine, with the model's params and the search
index copied into its memory; a request goes to the least-loaded engine.
The devices share nothing, so throughput grows with their number. On one
card the pool holds one engine.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, SearchConfig
from ..models.layers import Params, State
from ..models.scorer import _to
from ..search.beam import SearchIndex
from ..utils import resolve_device
from .engine import Engine, EngineConfig, RequestRejected

logger = logging.getLogger("nann_tpu_torch.pool")


def _place(params: Params, state: State, index: SearchIndex,
           device: torch.device):
    """(params, state, index) with every tensor on `device`."""
    return _to(params, device), _to(state, device), SearchIndex(**{
        f.name: _to(getattr(index, f.name), device)
        for f in dataclasses.fields(index)})


class EnginePool:
    """One engine a device; requests go to the least-loaded engine."""

    def __init__(self, mcfg: ModelConfig, scfg: SearchConfig, params: Params,
                 state: State, index: SearchIndex,
                 devices: Optional[Sequence] = None,
                 config: Optional[EngineConfig] = None):
        """devices: torch devices (or their names); every CUDA device by
        default, which raises where there is no card."""
        if devices is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.engines: List[Engine] = []
        for dev in devices:
            self.engines.append(Engine(
                mcfg, scfg, *_place(params, state, index, resolve_device(dev)),
                config))
        self._rr = itertools.cycle(range(len(self.engines)))
        self._lock = threading.Lock()
        logger.info("engine pool over %d devices", len(self.engines))

    def submit(self, user_seq_emb: np.ndarray, level_topn=None,
               deadline_ms: Optional[float] = None) -> Future:
        """Route to the least-loaded engine (Engine.depth()); round-robin
        breaks ties. An engine whose queue is full passes the request to the
        next least-loaded one; only when all are full is it rejected."""
        with self._lock:
            start = next(self._rr)
        order = sorted(range(len(self.engines)),
                       key=lambda i: (self.engines[i].depth(),
                                      (i - start) % len(self.engines)))
        fut = None
        for i in order:
            fut = self.engines[i].submit(user_seq_emb, level_topn, deadline_ms)
            exc = fut.exception() if fut.done() else None
            if not isinstance(exc, RequestRejected):
                return fut
        return fut  # every engine full: the rejection stands

    def search_sync(self, user_seq_emb: np.ndarray, level_topn=None,
                    timeout: float = 60):
        return self.submit(user_seq_emb, level_topn).result(timeout=timeout)

    def swap_model(self, params: Params, state: State,
                   index: SearchIndex) -> None:
        """Swap the model into every engine, copied to each one's device."""
        for eng in self.engines:
            eng.swap_model(*_place(params, state, index, eng.device))

    def aggregate_metrics(self) -> dict:
        total = sum(e.metrics.throughput.count for e in self.engines)
        rejected = sum(e.metrics.rejected.count for e in self.engines)
        failures = sum(e.metrics.failures.count for e in self.engines)
        lats = [e.metrics.latency_us.snapshot() for e in self.engines]
        return {
            "total": total,
            "rejected": rejected,
            "failures": failures,
            "latency_p50_us": float(np.mean([s["p50"] for s in lats])),
            "latency_p99_us": float(np.max([s["p99"] for s in lats])),
            "per_engine": [e.metrics.throughput.count for e in self.engines],
        }

    def shutdown(self) -> None:
        for e in self.engines:
            e.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
