"""Serving front-end: streaming, admission control, health (a port of
``repro.serve.frontend``; pure host code over the port's engine).

``ServeFrontend`` wraps a ``ServeEngine`` with the request-facing half
of the control plane:

* **Streaming** — ``submit`` returns a ``StreamHandle``; iterating it
  yields tokens as the scheduler produces them (the iterator pumps the
  scheduler between yields, so a single-threaded caller still sees
  per-token streaming).  A per-request ``on_token`` callback fires the
  moment each token is sampled, including for requests the caller never
  iterates.
* **Admission control** — the engine's intake queue is bounded
  (``queue_limit``, default = slot count); when it is full, submissions
  park in the front-end's bounded *wait queue* and drain FIFO as slots
  free.  ONLY the retryable ``"capacity"`` rejection is parked —
  structural rejections (empty prompt, oversize, bad budget, unhealthy)
  are re-raised to the caller immediately, because retrying cannot fix
  them.
* **Deadlines** — requests carry ``deadline_s`` (relative to
  admission).  The engine cancels expired slots mid-decode; the
  front-end sweeps its wait queue with the same clock so a request that
  never reached a slot still counts as a deadline miss.
* **Health** — if a ``HeartbeatMonitor`` is wired in, every ``pump``
  checks whether the engine's decode-loop heartbeat went stale and
  flips the engine's health gate: admission stops (``submit`` raises
  ``SubmitRejected("unhealthy")``) while in-flight decode is left
  alone.  When beats resume, the gate reopens automatically.

The front-end is deliberately synchronous + re-entrant (``pump`` is the
event loop's tick), so it composes with any outer loop — the CLI
daemon, a fleet router, or a test driving a fake clock.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, Iterator, List, Optional

import numpy as np

from repro_torch.serve.engine import Request, ServeEngine, SubmitRejected


class StreamHandle:
    """Per-request streaming view.

    Iterate to receive tokens as they are generated::

        handle = frontend.submit(prompt, max_new_tokens=32)
        for tok in handle:
            print(tok)

    Iteration pumps the front-end until this request finishes (done,
    expired, or rejected), yielding each new token exactly once.
    ``result()`` blocks (pumps) to completion and returns the Request.
    """

    def __init__(self, frontend: "ServeFrontend", request: Request):
        self.frontend = frontend
        self.request = request

    @property
    def uid(self):
        return self.request.uid

    @property
    def tokens(self) -> List[int]:
        return self.request.tokens

    @property
    def done(self) -> bool:
        return self.request.done or self.request.status == "rejected"

    @property
    def status(self) -> str:
        return self.request.status

    def __iter__(self) -> Iterator[int]:
        i = 0
        while True:
            toks = self.request.tokens
            while i < len(toks):
                yield toks[i]
                i += 1
            if self.done:
                return
            fe = self.frontend
            if fe.engine.idle and not fe.waiting:
                return          # nothing in flight: no more tokens ever
            fe.pump(1)

    def result(self) -> Request:
        for _ in self:
            pass
        return self.request


class ServeFrontend:
    """Admission + streaming + health layer over one ``ServeEngine``.

    ``max_queue`` bounds the wait queue; a capacity rejection with the
    wait queue already full is re-raised to the caller (backpressure all
    the way out).  The engine's own intake queue is bounded to its slot
    count unless the caller configured ``queue_limit`` explicitly.
    """

    def __init__(self, engine: ServeEngine, *, max_queue: int = 64,
                 heartbeat=None, heartbeat_worker: Optional[str] = None):
        self.engine = engine
        if engine.queue_limit is None:
            engine.queue_limit = max(engine.slots, 1)
        if heartbeat is not None:
            engine.heartbeat = heartbeat
            if heartbeat_worker is not None:
                engine.heartbeat_worker = heartbeat_worker
        self.max_queue = max_queue
        self.waiting: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self._uids = itertools.count()

    @property
    def clock(self):
        return self.engine.clock

    # -- admission ---------------------------------------------------------
    def submit(self, prompt=None, *, request: Optional[Request] = None,
               uid=None, max_new_tokens: int = 16, eos_id=None,
               deadline_s: Optional[float] = None, frames=None,
               on_token=None) -> StreamHandle:
        """Admit a request (or park it when the engine is full).

        Returns a ``StreamHandle`` for the (possibly waiting) request.
        Raises ``SubmitRejected`` for non-retryable rejections and for
        capacity rejections once the wait queue itself is full.
        """
        req = request
        if req is None:
            if prompt is None:
                raise ValueError("submit() needs a prompt or a request")
            req = Request(uid=next(self._uids) if uid is None else uid,
                          prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          deadline_s=deadline_s, frames=frames,
                          on_token=on_token)
        self._check_health()
        if req.submitted_at is None:
            # deadline covers wait-queue time too: the clock starts at
            # admission, not at slot assignment
            req.submitted_at = self.clock()
        try:
            self.engine.submit(req)
        except SubmitRejected as e:
            if e.retryable and len(self.waiting) < self.max_queue:
                req.status = "waiting"
                self.waiting.append(req)
            else:
                req.status = "rejected"
                self.rejected.append(req)
                raise
        return StreamHandle(self, req)

    # -- health ------------------------------------------------------------
    def _check_health(self) -> None:
        hb, eng = self.engine.heartbeat, self.engine
        if hb is None:
            return
        if eng.heartbeat_worker in hb.dead_workers():
            if eng.health.healthy:
                eng.set_health(
                    False,
                    f"heartbeat from {eng.heartbeat_worker!r} older than "
                    f"{hb.deadline_s}s — decode loop presumed wedged")
        elif not eng.health.healthy \
                and eng.health.reason.startswith("heartbeat"):
            # beats resumed: reopen the gate we closed (never overrides
            # a health state someone else set for another reason)
            eng.set_health(True)

    # -- the event loop ----------------------------------------------------
    def _expire_waiting(self, out: List[Request]) -> None:
        keep: Deque[Request] = deque()
        while self.waiting:
            req = self.waiting.popleft()
            if (req.deadline_s is not None
                    and self.clock() - req.submitted_at > req.deadline_s):
                self.engine.expire(req)    # books the miss in the report
                out.append(req)
            else:
                keep.append(req)
        self.waiting = keep

    def _drain_waiting(self) -> None:
        while self.waiting:
            req = self.waiting[0]
            try:
                self.engine.submit(req)
            except SubmitRejected as e:
                if e.retryable:
                    return                 # still full: keep FIFO order
                self.waiting.popleft()     # structural: drop, don't retry
                req.status = "rejected"
                self.rejected.append(req)
            else:
                self.waiting.popleft()

    def pump(self, steps: int = 1) -> List[Request]:
        """Advance the control plane ``steps`` scheduler ticks:
        health check → wait-queue deadline sweep → FIFO drain into the
        engine → one engine tick.  Returns requests finished during the
        call (completed or expired)."""
        done: List[Request] = []
        for _ in range(steps):
            self._check_health()
            self._expire_waiting(done)
            self._drain_waiting()
            if self.engine.idle and not self.waiting:
                break
            done.extend(self.engine.step())
        self.finished.extend(done)
        return done

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        """Pump until the engine and wait queue are both empty."""
        done: List[Request] = []
        for _ in range(max_steps):
            if self.engine.idle and not self.waiting:
                break
            done.extend(self.pump(1))
        return done

    @property
    def idle(self) -> bool:
        return self.engine.idle and not self.waiting
