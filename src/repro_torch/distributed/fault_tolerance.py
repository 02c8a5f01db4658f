"""Fault tolerance for serving: heartbeat liveness (a port of
``repro.distributed.fault_tolerance.HeartbeatMonitor``).

``HeartbeatMonitor`` is file-based liveness, one file per worker;
workers past the deadline are reported dead.  The serving engine beats
once per scheduler tick, the front-end closes an engine's admission
gate when its beat goes stale, and the fleet router fails it over.  The
reference's training-side policies (``Supervisor``, ``SkipStraggler``,
``elastic_restore``) are not yet ported.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class HeartbeatMonitor:
    """File-based liveness; ``clock`` is injectable so the serving
    fleet's failover tests can drive dead/revived transitions without
    real sleeps (the router and its engines share one clock)."""
    root: str
    deadline_s: float = 60.0
    clock: Callable[[], float] = time.time

    def beat(self, worker: str):
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"{worker}.hb")
        with open(path, "w") as f:
            f.write(str(self.clock()))

    def dead_workers(self) -> List[str]:
        now = self.clock()
        dead = []
        if not os.path.isdir(self.root):
            return dead
        for name in os.listdir(self.root):
            if not name.endswith(".hb"):
                continue
            with open(os.path.join(self.root, name)) as f:
                try:
                    last = float(f.read().strip())
                except ValueError:
                    last = 0.0
            if now - last > self.deadline_s:
                dead.append(name[:-3])
        return dead

    def age(self, worker: str) -> Optional[float]:
        """Seconds since ``worker`` last beat (None: never beat).

        The serving control plane beats once per scheduler tick
        (``ServeEngine.step``); ``serve.frontend`` reads staleness via
        ``dead_workers`` to close the engine's admission gate when the
        decode loop wedges."""
        path = os.path.join(self.root, f"{worker}.hb")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            try:
                last = float(f.read().strip())
            except ValueError:
                return None
        return self.clock() - last
