"""Fault tolerance: restart supervision, elastic resharding, stragglers
and heartbeats (a port of ``repro.distributed.fault_tolerance``).

Checkpoint/restart is the backbone (``CheckpointManager`` commits
atomically); this module adds the cluster-side policies:

  * ``Supervisor``      — run-to-completion wrapper: on a step failure
    it rebuilds the trainer (which resumes from the newest committed
    checkpoint) and retries, up to ``max_restarts``;
  * ``elastic_restore`` — load a checkpoint saved on mesh A onto mesh B:
    leaves are read as full arrays and each rank places its shard of B
    where ``distributed.tensor_parallel.layout`` puts it;
  * ``HeartbeatMonitor``— file-based liveness, one file per worker;
    workers past the deadline are reported dead.  The serving engine
    beats once per scheduler tick, the front-end closes an engine's
    admission gate when its beat goes stale, and the fleet router fails
    it over;
  * ``SkipStraggler``   — the synchronous-skip straggler policy
    (``train.loop.Trainer``'s ``on_straggler`` hook).
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.tensor_parallel import layout, mesh_rules

log = logging.getLogger("fault_tolerance")


@dataclass
class Supervisor:
    """Restart loop around a training function.

    ``make_trainer()`` returns a ``Trainer`` that resumes itself from its
    checkpoint directory; a failed ``run`` is retried on a fresh one
    until ``num_steps`` steps are done, or re-raised after
    ``max_restarts`` restarts."""
    make_trainer: Callable[[], Any]
    max_restarts: int = 3
    restarts: int = 0

    def run(self, num_steps: int) -> Any:
        while True:
            trainer = self.make_trainer()
            remaining = num_steps - trainer.state.step
            if remaining <= 0:
                return trainer
            try:
                trainer.run(remaining)
                return trainer
            except Exception as e:  # noqa: BLE001 - any step failure
                self.restarts += 1
                log.warning("training failed at step %d (%s); restart %d/%d",
                            trainer.state.step, e, self.restarts,
                            self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise


def elastic_restore(ckpt_dir: str, template, new_mesh,
                    step: Optional[int] = None, *, cfg, masks=None):
    """Restore a checkpoint onto a different mesh (elastic scaling):
    ``template["params"]`` leaves (a model of ``cfg``, pruned by
    ``masks``) come back as this rank's shards of ``new_mesh``, placed
    as the rank-local model runs them (``tensor_parallel.layout``:
    blocks whose shard would split a head or a 128-tile stay whole),
    everything else whole.  Returns (step, tree);
    ``ShardedModel.from_local(tree["params"], template["params"], cfg,
    mesh_rules(new_mesh, cfg), masks)`` runs it."""
    shardings = None
    if isinstance(template, dict) and "params" in template:
        shardings = {"params": layout(template["params"], cfg,
                                      mesh_rules(new_mesh, cfg), masks)[0]}
    return CheckpointManager(ckpt_dir).restore(template, step=step,
                                               shardings=shardings)


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


@dataclass
class SkipStraggler:
    """Synchronous-skip policy: tolerate up to ``budget`` slow steps per
    window of ``window`` steps, then escalate (callback — e.g. trigger
    re-slicing) and start counting afresh."""
    deadline_s: float
    budget: int = 3
    window: int = 100
    escalate: Callable[[int], None] = lambda step: None
    _events: List[int] = field(default_factory=list)

    def __call__(self, step: int, dt: float):
        self._events = [s for s in self._events if step - s < self.window]
        self._events.append(step)
        log.warning("straggler at step %d: %.2fs > %.2fs (%d/%d in window)",
                    step, dt, self.deadline_s, len(self._events), self.budget)
        if len(self._events) > self.budget:
            self.escalate(step)
            self._events.clear()
