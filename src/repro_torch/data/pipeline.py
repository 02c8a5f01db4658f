"""Prefetching, restartable data pipeline (port of
``repro.data.pipeline``: ``DataPipeline`` and ``ShardedBatcher``).

Because generators are stateless (batch = f(seed, step)), resuming from
a step index reproduces the exact stream: there is no iterator state to
persist.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class DataPipeline:
    """Iterator over f(step) with optional prefetch (a daemon thread,
    started here only when ``prefetch > 0``) and explicit step
    accounting."""

    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 start_step: int = 0, prefetch: int = 2):
        self._fn = batch_fn
        self.step = start_step
        self._prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if prefetch > 0:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._fn(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._thread is None:
            batch = self._fn(self.step)
            self.step += 1
            return batch
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        """Stop the prefetch thread and wait for it (it wakes at least
        every half second)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


class ShardedBatcher:
    """This rank's rows of each global batch, the batch dim sharded over
    the mesh's data axes (``dp_axes``, outer first; a batch they do not
    divide stays whole)."""

    def __init__(self, batch_fn, mesh, dp_axes=("data",), prefetch: int = 0):
        from repro_torch.launch.mesh import mesh_axes
        self.mesh = mesh
        axes = mesh_axes(mesh)
        self.dp_axes = tuple(a for a in dp_axes if a in axes)
        self._ways = int(np.prod([axes[a] for a in self.dp_axes]))
        self.pipe = DataPipeline(batch_fn, prefetch=prefetch)

    def sharding_for(self, arr: np.ndarray):
        from repro_torch.distributed.sharding import LeafSharding, \
            spec_placements
        lead = self.dp_axes if arr.shape[0] % self._ways == 0 else None
        spec = (lead,) + (None,) * (arr.ndim - 1)
        return LeafSharding(self.mesh, spec, spec_placements(self.mesh, spec))

    def __next__(self):
        from repro_torch.distributed.sharding import place
        batch = next(self.pipe)
        return {k: place(np.asarray(v), self.sharding_for(v))
                for k, v in batch.items()}

    def __iter__(self):
        return self
