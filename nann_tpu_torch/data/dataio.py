"""Input pipeline: shuffled, repeated, batched host arrays.

The numpy iterator of nann_tpu/data/dataio.py: the dataset (a dict of
arrays) is shuffled per epoch by `default_rng(seed + epoch)`, batched with
drop-remainder, and produced on a background thread, so a seed gives the
same batches in both packages. It yields numpy batches; the train step moves
each to its device. With a mesh it yields this rank's block of each global
batch: rows [i * B / dp, (i + 1) * B / dp) at "dp" place i, the rows a
P("dp") sharding gives device i in JAX.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchIterator:
    """Epoch-shuffled batch iterator over a dict-of-arrays dataset."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 epochs: int = 1, drop_remainder: bool = True, seed: int = 0,
                 mesh=None, prefetch: int = 2):
        self.data = data
        self.batch_size = batch_size
        self.epochs = epochs
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.prefetch = prefetch
        self.num_samples = len(next(iter(data.values())))
        self._dp, self._dp_index = 1, 0
        if mesh is not None:
            self._dp, self._dp_index = mesh.size("dp"), mesh.index("dp")
            if batch_size % self._dp:
                raise ValueError(f"batch_size {batch_size} does not split "
                                 f"over dp={self._dp}")

    def __len__(self) -> int:
        return self.batches_per_epoch * self.epochs

    @property
    def batches_per_epoch(self) -> int:
        return (self.num_samples // self.batch_size if self.drop_remainder
                else -(-self.num_samples // self.batch_size))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate from global batch `start_batch`, with `prefetch` batches
        materialized ahead on a background thread (host indexing overlaps
        the train step in flight)."""
        if self.prefetch <= 0:
            yield from self._produce(start_batch)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END, _ERR = object(), object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._produce(start_batch):
                    if not put(b):
                        return
                put(_END)
            except BaseException as e:  # propagate into the consumer
                put((_ERR, e))

        t = threading.Thread(target=worker, daemon=True,
                             name="batch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if (isinstance(item, tuple) and len(item) == 2
                        and item[0] is _ERR):
                    raise item[1]
                yield item
        finally:
            stop.set()  # consumer done/abandoned: let the worker exit

    def _produce(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume fast-forward: skipped epochs cost nothing; the within-epoch
        offset just starts later in that epoch's permutation, so a resumed
        run sees exactly the batches the interrupted schedule still owed
        it."""
        per_epoch = self.batches_per_epoch
        first_epoch, offset = ((start_batch // per_epoch,
                                start_batch % per_epoch)
                               if per_epoch else (self.epochs, 0))
        for epoch in range(first_epoch, self.epochs):
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(self.num_samples)
            end = (self.num_samples - self.num_samples % self.batch_size
                   if self.drop_remainder else self.num_samples)
            start0 = offset * self.batch_size if epoch == first_epoch else 0
            for start in range(start0, end, self.batch_size):
                idx = order[start:start + self.batch_size]
                yield {k: v[self._block(idx)] for k, v in self.data.items()}

    def _block(self, idx: np.ndarray) -> np.ndarray:
        """This rank's block of a global batch's indices."""
        if self._dp == 1:
            return idx
        if len(idx) % self._dp:
            raise ValueError(f"a batch of {len(idx)} does not split over "
                             f"dp={self._dp}")
        n = len(idx) // self._dp
        return idx[self._dp_index * n:(self._dp_index + 1) * n]
