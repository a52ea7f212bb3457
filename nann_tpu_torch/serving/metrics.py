"""Serving metrics: event meters, histograms and a periodic reporter
(nann_tpu/serving/metrics.py)."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Meter:
    """Event count and mean rate since creation."""

    def __init__(self):
        self.count = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    @property
    def mean_rate(self) -> float:
        dt = time.monotonic() - self._t0
        return self.count / dt if dt > 0 else 0.0


class Histogram:
    """Histogram over a bounded window of recent values."""

    def __init__(self, max_samples: int = 100_000):
        self._vals: List[float] = []
        self._max = max_samples
        self._lock = threading.Lock()

    def update(self, value: float) -> None:
        with self._lock:
            if len(self._vals) >= self._max:
                self._vals = self._vals[self._max // 2:]
            self._vals.append(value)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count = len(self._vals)
            vals = np.asarray(self._vals) if self._vals else np.zeros(1)
        return {"count": count, "mean": float(vals.mean()),
                "p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "p99": float(np.percentile(vals, 99)),
                "max": float(vals.max())}


class MetricsRegistry:
    """The engine's metric set, and a reporter that writes it periodically."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.throughput = Meter()
        self.failures = Meter()
        self.rejected = Meter()
        self.latency_us = Histogram()
        self.batch_size = Histogram()
        # a batch's time on the device: on CUDA the stream's time from its
        # first launch to its last (CUDA events, idle between launches
        # included); on the CPU the host's clock around the search
        self.device_us = Histogram()
        # requests whose hop expansion reached a per-hop frontier cap
        # (SearchConfig.frontier_cap_per_hop): nonzero means the tuned caps
        # truncate live traffic
        self.cap_saturated = Meter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def report_lines(self) -> List[str]:
        lat = self.latency_us.snapshot()
        bs = self.batch_size.snapshot()
        dev = self.device_us.snapshot()
        return [
            f"[{self.name}] device_us/batch: p50={dev['p50']:.0f} "
            f"p99={dev['p99']:.0f}",
            f"[{self.name}] throughput: {self.throughput.mean_rate:.1f}/s "
            f"(total {self.throughput.count})",
            f"[{self.name}] latency_us: p50={lat['p50']:.0f} "
            f"p95={lat['p95']:.0f} p99={lat['p99']:.0f} max={lat['max']:.0f}",
            f"[{self.name}] batch_size: mean={bs['mean']:.1f} p99={bs['p99']:.0f}",
            f"[{self.name}] failures: {self.failures.count} "
            f"rejected: {self.rejected.count} "
            f"cap_saturated: {self.cap_saturated.count}",
        ]

    def start_reporter(self, interval_s: float = 3.0,
                       sink: Callable[[str], None] = print) -> None:
        """Write report_lines() to `sink` every `interval_s` seconds, from a
        thread of its own, until stop_reporter()."""
        self.stop_reporter()
        stop = self._stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                for line in self.report_lines():
                    sink(line)

        self._thread = threading.Thread(target=loop, name="nann-metrics",
                                        daemon=True)
        self._thread.start()

    def stop_reporter(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
            self._thread = None
