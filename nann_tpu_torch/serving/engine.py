"""The serving engine: micro-batched dispatch of the batched search.

Counterpart of nann_tpu/serving/engine.py (its `mesh` and `staged` options
excepted):

  * a bounded request queue is the admission control (a full queue rejects);
  * a dispatcher thread collects up to the serving cap of requests within a
    `wait_ms` window, drops those whose admission deadline passed, pads the
    batch to the next bucket of the ladder and launches the search; on CUDA
    the users go up from pinned memory and the results come back into pinned
    memory by non-blocking copies, and a CUDA event closes the batch;
  * a completion thread drains every batch in flight, waits once (on the
    last batch's event: the stream's order implies the earlier ones) and
    resolves each request's Future with (item ids, scores), invalid slots
    stripped;
  * every bucket is warmed once at start (this builds the kernel library);
    with `calibrate=True` the live engine measures each bucket's throughput
    and serves at the smallest bucket within `noise_frac` of the best,
    cached in `calibration_file`;
  * `swap_model` replaces (params, state, index) between batches;
  * `record_requests` keeps the last requests for `dump_runmeta`.

Every thread launches on the device's default stream, so memory of a model
swapped out is reused only after the kernels that read it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, SearchConfig
from ..models.layers import Params, State
from ..search.beam import SearchIndex, level_topn_default, make_searcher
from .metrics import MetricsRegistry

logger = logging.getLogger("nann_tpu_torch.serving")


class RequestRejected(Exception):
    """Rejected at admission: queue full, deadline passed, or shutdown."""


@dataclasses.dataclass
class EngineConfig:
    batch_buckets: Sequence[int] = (1, 4, 16, 64, 128)
    calibrate: bool = False           # measure each bucket's qps at start and
    #                                   serve at the best (smallest of a tie)
    serve_bucket: Optional[int] = None  # explicit serving cap (no calibration)
    calibration_file: Optional[str] = None  # keep and reuse the calibration,
    #                                         keyed by _calibration_fingerprint
    wait_ms: float = 5.0              # micro-batch window
    max_queue: int = 256              # admitted requests beyond this are rejected
    warmup: bool = True
    record_requests: int = 0          # keep the last N served requests for
    #                                   dump_runmeta


@dataclasses.dataclass
class _Request:
    user_seq_emb: np.ndarray
    level_topn: np.ndarray
    future: Future
    enqueue_t: float
    deadline_ms: Optional[float] = None

    def expired(self, now: float) -> bool:
        return (self.deadline_ms is not None
                and (now - self.enqueue_t) * 1e3 > self.deadline_ms)


@dataclasses.dataclass
class _Batch:
    """A dispatched batch: its requests, its results on the host (pinned and
    still being copied on CUDA), and what times it."""

    requests: List[_Request]
    host: List[torch.Tensor]          # items, scores (, num_scoring)
    start: Optional[torch.cuda.Event]   # CUDA: before the first launch
    end: Optional[torch.cuda.Event]     # CUDA: after the last launch
    copied: Optional[torch.cuda.Event]  # CUDA: after the copies to the host
    host_us: float = 0.0                # CPU: host clock around the search


class Engine:
    """Serves requests against one (params, state, index) on the index's
    device."""

    def __init__(self, mcfg: ModelConfig, scfg: SearchConfig, params: Params,
                 state: State, index: SearchIndex,
                 config: Optional[EngineConfig] = None):
        self.mcfg = mcfg
        self.scfg = scfg
        self.config = config or EngineConfig()
        self.metrics = MetricsRegistry("nann")
        self._model = (params, state, index)   # swapped under _model_lock
        self._model_lock = threading.Lock()
        self._device = index.item_embs.device
        self._search = make_searcher(mcfg, scfg)
        self._buckets = sorted(self.config.batch_buckets)
        self._default_ltn = level_topn_default(scfg)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self.config.max_queue)
        self._inflight: "queue.Queue[_Batch]" = queue.Queue(maxsize=8)
        self._holdback: List[_Request] = []     # dispatcher thread only
        self._current_batch: List[_Request] = []  # dispatcher thread only
        self._active = 0                        # dispatched, not completed
        self._active_lock = threading.Lock()
        self._recorded = collections.deque(
            maxlen=max(self.config.record_requests, 1))
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="nann-dispatch", daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="nann-complete", daemon=True)
        if self.config.warmup:
            self.warmup()
        self._serve_cap = self._buckets[-1]
        if self.config.serve_bucket is not None:
            self._serve_cap = min(b for b in self._buckets
                                  if b >= self.config.serve_bucket)
        self._dispatcher.start()
        self._completer.start()
        self.bucket_qps = {}
        self.calibration_source = "none"
        if self.config.serve_bucket is None and self.config.calibrate:
            cached = self._load_calibration()
            if cached is not None:
                self._serve_cap = cached
                self.calibration_source = "cached"
            else:
                # the live engine, threads running: the path traffic takes
                self._serve_cap = self._calibrate()
                self.calibration_source = "measured"
                self._save_calibration(self._serve_cap)

    @property
    def device(self) -> torch.device:
        return self._device

    def _on_device(self):
        """The engine's device as the thread's current CUDA device: the
        kernels launch on its stream."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    # ------------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        """Run every bucket once (the first run builds the kernel library)."""
        params, state, index = self._model
        rng = np.random.default_rng(0)
        with self._on_device():
            for b in self._buckets:
                t0 = time.perf_counter()
                user = torch.from_numpy(rng.standard_normal(
                    (b, self.mcfg.max_seq_length, self.mcfg.user_emb_dim)
                ).astype(np.float32))
                out = self._search(params, state, index, user,
                                   self._default_ltn)
                out[0].cpu()
                logger.info("warmup bucket B=%d: %.3fs", b,
                            time.perf_counter() - t0)

    def _calibrate(self, window_s: float = 0.6, repeats: int = 3,
                   noise_frac: float = 0.12) -> int:
        """Measure each bucket's saturated throughput through the live engine
        (queue, micro-batch, dispatch, completion) and return the serving
        bucket: the smallest whose median of `repeats` windows is within
        `noise_frac` of the best median. Rounds go across the buckets in turn,
        so that a slow stretch of the host hits every bucket's samples."""
        rng = np.random.default_rng(0)
        user = rng.standard_normal(
            (self.mcfg.max_seq_length, self.mcfg.user_emb_dim)
        ).astype(np.float32)

        def _drain(timeout: float = 15.0) -> None:
            t_end = time.perf_counter() + timeout
            while self.depth() and time.perf_counter() < t_end:
                time.sleep(0.002)
            if self.depth():
                # a backlog the timeout cannot clear would spoil the next
                # window: reject the undispatched rest of the probes
                flushed = 0
                while True:
                    try:
                        r = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if not r.future.done():
                        r.future.set_exception(RequestRejected(
                            "calibration flush"))
                    flushed += 1
                logger.info("calibration drain timed out: flushed %d queued "
                            "probes", flushed)

        def _window(b: int) -> float:
            _drain()
            count0 = self.metrics.throughput.count
            # keep batch formation and the 8 batches in flight saturated,
            # with a bounded backlog
            depth_cap = min(24 * b, 4 * self.config.max_queue)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < window_s:
                if self.depth() >= depth_cap:
                    time.sleep(0.001)
                    continue
                fut = self.submit(user)
                if fut.done() and fut.exception() is not None:
                    time.sleep(0.001)    # queue full: let it move
            _drain()
            wall = time.perf_counter() - t0
            return (self.metrics.throughput.count - count0) / max(wall, 1e-9)

        samples = {b: [] for b in self._buckets}
        for rep in range(repeats):
            for b in self._buckets:
                if rep > 0 and max(samples[b]) < 1.0:
                    continue             # a dead bucket: no more windows
                self._serve_cap = b      # the dispatcher reads it each cycle
                samples[b].append(_window(b))
        self.bucket_qps = {b: float(np.median(s)) for b, s in samples.items()}
        best_q = max(self.bucket_qps.values())
        chosen = min(b for b, q in self.bucket_qps.items()
                     if q >= (1.0 - noise_frac) * best_q)
        logger.info("calibrated serve bucket B=%d (median engine qps by "
                    "bucket: %s; smallest within %d%% of best)", chosen,
                    {k: round(v, 1) for k, v in self.bucket_qps.items()},
                    round(noise_frac * 100))
        return chosen

    # ------------------------------------------------- calibration persistence

    def _device_name(self) -> str:
        if self._device.type == "cuda":
            return f"{torch.cuda.get_device_name(self._device)} {self._device}"
        return "cpu"

    def _calibration_fingerprint(self) -> str:
        """A key over what the per-bucket curve depends on: the device, the
        search (catalogue size, caps, visited backend, table type) and the
        bucket ladder."""
        with self._model_lock:
            index = self._model[2]
        fp = {
            "device": self._device_name(),
            "buckets": list(self._buckets),
            "items": int(index.item_embs.shape[0]),
            "seq": self.mcfg.max_seq_length,
            "user_emb": self.mcfg.user_emb_dim,
            "emb_dtype": str(index.item_embs.dtype),
            "frontier_cap": self.scfg.frontier_cap,
            "frontier_cap_per_hop": list(self.scfg.frontier_cap_per_hop or ()),
            "vis_impl": self.scfg.vis_impl,
            "staged": False,
        }
        return hashlib.md5(
            json.dumps(fp, sort_keys=True).encode()).hexdigest()[:16]

    def _load_calibration(self) -> Optional[int]:
        path = self.config.calibration_file
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                prof = json.load(f)
        except (OSError, ValueError) as e:
            logger.info("calibration file unreadable (%r): re-measuring", e)
            return None
        ent = prof.get(self._calibration_fingerprint())
        if not ent or ent.get("serve_bucket") not in self._buckets:
            return None
        self.bucket_qps = {int(k): float(v)
                           for k, v in ent.get("bucket_qps", {}).items()}
        logger.info("calibration loaded from %s: B=%d (measured %s)", path,
                    ent["serve_bucket"], ent.get("ts", "?"))
        return int(ent["serve_bucket"])

    def _save_calibration(self, serve_bucket: int) -> None:
        path = self.config.calibration_file
        if not path:
            return
        prof = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    prof = json.load(f)
            except (OSError, ValueError):
                prof = {}
        prof[self._calibration_fingerprint()] = {
            "serve_bucket": serve_bucket,
            "bucket_qps": {str(k): round(v, 1)
                           for k, v in self.bucket_qps.items()},
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                json.dump(prof, f, indent=1)
        except OSError as e:
            logger.info("calibration save failed: %r", e)

    def swap_model(self, params: Params, state: State,
                   index: SearchIndex) -> None:
        """Replace the model between batches: batches already dispatched
        finish on the old one. The new model must be on the engine's
        device."""
        if index.item_embs.device != self._device:
            raise ValueError(f"the engine serves on {self._device}, the new "
                             f"index is on {index.item_embs.device}")
        with self._model_lock:
            self._model = (params, state, index)
        logger.info("model swapped")

    def shutdown(self) -> None:
        """Stop both threads and reject whatever is still queued."""
        self._stop.set()
        for t in (self._dispatcher, self._completer):
            if t.is_alive():
                t.join(timeout=60)
            if t.is_alive():
                logger.warning("shutdown: %s still alive after 60s", t.name)
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if not r.future.done():
                r.future.set_exception(RequestRejected("engine shutdown"))
        for r in self._holdback:
            if not r.future.done():
                r.future.set_exception(RequestRejected("engine shutdown"))
        self._holdback.clear()

    def dump_runmeta(self, path: str) -> int:
        """Write the recorded requests (inputs, budgets, latency) as npz, for
        a replay by LoadGenConfig(replay_path=...). Returns their count."""
        recs = list(self._recorded)
        if not recs:
            return 0
        users = np.stack([r[0] for r in recs])
        ltns = np.stack([r[1] for r in recs])
        lat = np.asarray([r[3] for r in recs], np.float32)
        np.savez(path, user_seq_emb=users, level_topn=ltns, latency_us=lat)
        return len(recs)

    # --------------------------------------------------------------- serving

    def submit(self, user_seq_emb: np.ndarray,
               level_topn: Optional[np.ndarray] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request [L, d_user]; the Future resolves to
        (top item ids [k], scores [k]) with invalid slots stripped.
        deadline_ms: reject the request if it is still queued after this."""
        fut: Future = Future()
        ltn = self._default_ltn if level_topn is None else \
            np.asarray(level_topn, np.int32)
        user = np.asarray(user_seq_emb, np.float32)
        want = (self.mcfg.max_seq_length, self.mcfg.user_emb_dim)
        if ltn.shape != self._default_ltn.shape or user.shape != want:
            fut.set_exception(ValueError(
                f"need user_seq_emb {want} and level_topn "
                f"{self._default_ltn.shape}, got {user.shape} / {ltn.shape}"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RequestRejected("engine shutdown"))
            return fut
        try:
            self._queue.put_nowait(_Request(user, ltn, fut, time.perf_counter(),
                                            deadline_ms))
        except queue.Full:
            self.metrics.rejected.mark()
            fut.set_exception(RequestRejected("queue full"))
        return fut

    def search_sync(self, user_seq_emb: np.ndarray,
                    level_topn: Optional[np.ndarray] = None,
                    timeout: float = 60):
        return self.submit(user_seq_emb, level_topn).result(timeout=timeout)

    def depth(self) -> int:
        """Requests queued + held back + dispatched and not yet completed."""
        with self._active_lock:
            active = self._active
        return self._queue.qsize() + len(self._holdback) + active

    # ------------------------------------------------------------- internals

    def _take_batch(self) -> List[_Request]:
        """Up to the serving cap of requests within the wait_ms window;
        held-back requests go first."""
        batch = list(self._holdback)
        self._holdback.clear()
        if not batch:
            try:
                batch.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                return []
        deadline = time.perf_counter() + self.config.wait_ms / 1e3
        while len(batch) < self._serve_cap:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch_loop(self) -> None:
        with self._on_device():
            while not self._stop.is_set():
                try:
                    self._dispatch_once()
                except Exception as e:  # noqa: BLE001 - keep serving later requests
                    logger.exception("dispatch failed")
                    self.metrics.failures.mark(len(self._current_batch))
                    for r in self._current_batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                self._current_batch = []

    def _dispatch_once(self) -> None:
        batch = self._take_batch()
        now = time.perf_counter()
        for r in batch:
            if r.expired(now):
                self.metrics.rejected.mark()
                r.future.set_exception(RequestRejected("deadline exceeded"))
        batch = [r for r in batch if not r.expired(now)]
        if not batch:
            return
        ltn0 = batch[0].level_topn
        self._holdback.extend(
            r for r in batch if not np.array_equal(r.level_topn, ltn0))
        batch = [r for r in batch if np.array_equal(r.level_topn, ltn0)]
        self._current_batch = batch

        bucket = min(b for b in self._buckets if b >= len(batch))
        cuda = self._device.type == "cuda"
        users = torch.zeros((bucket, self.mcfg.max_seq_length,
                             self.mcfg.user_emb_dim), pin_memory=cuda)
        users_np = users.numpy()
        for i, r in enumerate(batch):
            users_np[i] = r.user_seq_emb
        with self._model_lock:
            params, state, index = self._model
        n_host = 3 if self.scfg.frontier_cap_per_hop else 2
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            copied = torch.cuda.Event()
            users_dev = users.to(self._device, non_blocking=True)
            start.record()
            out = self._search(params, state, index, users_dev, ltn0)
            end.record()
            # pinned buffers of this batch's own: reused only after it is
            # resolved and the copies are done
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in out[:n_host]]
            for h, o in zip(host, out):
                h.copy_(o, non_blocking=True)
            copied.record()
            item = _Batch(batch, host, start, end, copied)
        else:
            t0 = time.perf_counter()
            out = self._search(params, state, index, users, ltn0)
            item = _Batch(batch, list(out[:n_host]), None, None, None,
                          (time.perf_counter() - t0) * 1e6)
        with self._active_lock:
            self._active += len(batch)
        while True:   # stop-aware put: shutdown must not wait on a full queue
            try:
                self._inflight.put(item, timeout=1.0)
                break
            except queue.Full:
                if self._stop.is_set():
                    for r in batch:
                        r.future.set_exception(RequestRejected("engine shutdown"))
                    with self._active_lock:
                        self._active -= len(batch)
                    return
        self.metrics.batch_size.update(len(batch))

    def _complete_loop(self) -> None:
        # keep draining after stop until the dispatcher has put its last batch
        while not (self._stop.is_set() and self._inflight.empty()
                   and not self._dispatcher.is_alive()):
            try:
                pending = [self._inflight.get(timeout=0.05)]
            except queue.Empty:
                continue
            # drain everything in flight and wait once: the last batch's event
            # follows every earlier batch's work on the stream
            while True:
                try:
                    pending.append(self._inflight.get_nowait())
                except queue.Empty:
                    break
            try:
                if pending[-1].copied is not None:
                    pending[-1].copied.synchronize()
            except Exception as e:  # noqa: BLE001 - fail the drained batches
                logger.exception("completion failed")
                for b in pending:
                    self._fail(b.requests, e)
                continue
            for b in pending:
                try:
                    self._resolve(b)
                except Exception as e:  # noqa: BLE001 - fail this batch, go on
                    logger.exception("completion failed")
                    self._fail(b.requests, e)
                    continue
                with self._active_lock:
                    self._active -= len(b.requests)

    def _fail(self, requests: List[_Request], e: Exception) -> None:
        self.metrics.failures.mark(len(requests))
        for r in requests:
            if not r.future.done():
                r.future.set_exception(e)
        with self._active_lock:
            self._active -= len(requests)

    def _resolve(self, b: _Batch) -> None:
        """Record the batch's device time and saturated caps, and answer its
        requests from the host copies."""
        self.metrics.device_us.update(
            b.start.elapsed_time(b.end) * 1e3 if b.start is not None
            else b.host_us)
        items = b.host[0].numpy()
        scores = b.host[1].numpy()
        if self.scfg.frontier_cap_per_hop:
            # num_scoring's column 0 is the enter points; the hops follow
            ns = b.host[2].numpy()[:len(b.requests), 1:]
            caps = np.asarray(self.scfg.frontier_cap_per_hop)
            h = min(ns.shape[1], len(caps))
            sat = int((ns[:, :h] >= caps[:h]).any(axis=1).sum())
            if sat:
                self.metrics.cap_saturated.mark(sat)
        now = time.perf_counter()
        for i, r in enumerate(b.requests):
            keep = items[i] >= 0
            r.future.set_result((items[i][keep], scores[i][keep]))
            lat_us = (now - r.enqueue_t) * 1e6
            self.metrics.latency_us.update(lat_us)
            if self.config.record_requests:
                self._recorded.append((r.user_seq_emb, r.level_topn,
                                       items[i][keep], np.float32(lat_us)))
        self.metrics.throughput.mark(len(b.requests))
