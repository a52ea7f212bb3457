"""Model hot reload and selection between models
(nann_tpu/serving/selector.py):

  ModelReloader  watches an export directory; when its version marker
                 changes it loads the new bundle off the serving path, on
                 the engine's device, and swaps it into the engine (batches
                 in flight finish on the old model).
  ModelSelector  named engines with an active one, and optional timed
                 switching, hot or cold (the outgoing engine drained first).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from ..config import SearchConfig
from ..delivery.export import read_version
from ..delivery.verify_export import load_serving_bundle
from .engine import Engine

logger = logging.getLogger("nann_tpu_torch.selector")


def _version_marker(export_dir: str) -> str:
    """The bundle's version marker, the reload trigger.

    export_model writes VERSION last, so a marker means a complete bundle.
    A bundle without one (written by another tool) falls back to the latest
    modification time of its files."""
    v = read_version(export_dir)
    if v:
        return v
    latest = 0.0
    for root, _dirs, files in os.walk(export_dir):
        for f in files:
            try:
                latest = max(latest, os.path.getmtime(os.path.join(root, f)))
            except OSError:
                pass
    return f"mtime:{latest}" if latest else ""


class ModelReloader:
    """Watch an export dir; hot-swap the engine when the bundle changes."""

    def __init__(self, engine: Engine, export_dir: str, scfg: SearchConfig,
                 poll_interval_s: float = 5.0,
                 loader: Optional[Callable] = None):
        self.engine = engine
        self.export_dir = export_dir
        self.scfg = scfg
        self.poll_interval_s = poll_interval_s
        self._loader = loader or self._default_loader
        self._marker = _version_marker(export_dir)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reload_count = 0

    def _default_loader(self):
        params, state, _mcfg, index = load_serving_bundle(
            self.export_dir, self.scfg, device=self.engine.device)
        return params, state, index

    def check_once(self) -> bool:
        """Poll once; reload if the bundle changed. Returns True on reload."""
        marker = _version_marker(self.export_dir)
        if not marker or marker == self._marker:
            return False
        logger.info("bundle change detected in %s; reloading",
                    self.export_dir)
        params, state, index = self._loader()   # not under the engine's lock
        # another export that landed during the load may have mixed two
        # bundles' files: skip the swap and retry at the next poll
        if _version_marker(self.export_dir) != marker:
            logger.info("bundle changed again during load; skipping swap")
            return False
        self.engine.swap_model(params, state, index)
        self._marker = marker
        self.reload_count += 1
        return True

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.check_once()
                except Exception as e:  # noqa: BLE001 - keep the old model
                    logger.info("reload failed, keeping current model: %s", e)

        self._thread = threading.Thread(target=loop, name="nann-reload",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class ModelSelector:
    """Named engines with an active model and optional timed switching."""

    def __init__(self, engines: Dict[str, Engine]):
        if not engines:
            raise ValueError("need at least one engine")
        self._engines = dict(engines)
        self._order = list(engines)
        self._active = self._order[0]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def active(self) -> Engine:
        with self._lock:
            return self._engines[self._active]

    @property
    def active_name(self) -> str:
        with self._lock:
            return self._active

    def select(self, name: str) -> None:
        with self._lock:
            if name not in self._engines:
                raise KeyError(name)
            self._active = name

    def submit(self, *args, **kwargs):
        return self.active.submit(*args, **kwargs)

    def start_switching(self, switch_interval_s: float,
                        cold_switching: bool = False) -> None:
        """Cycle the active model on a timer. cold_switching: wait (up to
        5 s) until the outgoing engine has nothing queued or in flight
        (Engine.depth()) before traffic goes to the next one."""

        def loop():
            i = 0
            while not self._stop.wait(switch_interval_s):
                outgoing = self.active
                i = (i + 1) % len(self._order)
                if cold_switching:
                    deadline = time.monotonic() + 5.0
                    while (outgoing.depth() > 0
                           and time.monotonic() < deadline):
                        time.sleep(0.01)
                self.select(self._order[i])
                logger.info("switched active model -> %s%s", self._order[i],
                            " (cold)" if cold_switching else "")

        self._thread = threading.Thread(target=loop, name="nann-switch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
