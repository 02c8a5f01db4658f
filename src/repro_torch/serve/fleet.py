"""Fleet router: N continuous-batching engines behind one dispatcher (a
port of ``repro.serve.fleet``; pure host code over the port's engines).

The scale-out layer above ``ServeEngine``/``ServeFrontend`` — the
serving analogue of the paper's "one ReRAM chip cannot hold the model"
premise: one engine cannot hold the traffic, so the fleet spreads it.

* **Dispatch** — every logical request is tracked in a ``FleetRecord``
  and handed to the least-loaded live engine (slot occupancy + intake +
  wait queue, ties broken by free paged-KV blocks).  Each engine keeps
  its own continuous-batching scheduler and ``ServeFrontend``-style
  wait queue; the router never reaches into a scheduler mid-flight.
* **Failover** — engines beat a shared
  ``distributed.fault_tolerance.HeartbeatMonitor`` once per scheduler
  tick.  A stale worker (or an explicit ``kill``) fails the engine:
  its waiting AND in-flight requests are evicted and re-dispatched
  onto survivors in original submission order.  A continuation
  re-prefills from prompt + the tokens already emitted, so a *greedy*
  stream resumes exactly where the dead engine left it — no request is
  lost, none is duplicated (sampled decode also loses nothing, but the
  per-request noise stream restarts, so continuation tokens may
  differ).  A failed engine whose beats RESUME after the failure is
  re-admitted for new dispatches (flap re-admission).
* **Reporting** — ``report`` merges per-engine ``ServeReport``s with
  fleet-level percentiles recomputed over logical records, so a
  request that moved engines is counted once, with its true
  end-to-end latency.
* **Hot-swap** — ``TicketManager.swap(router, name)`` fans a
  zero-drain swap across every live engine with all-or-nothing
  rollback (``swap_targets`` is the hook it dispatches on).

The accounting invariants (every uid finishes exactly once; merged
totals equal per-engine sums) hold by construction and are checked by
the tests.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import Request, ServeEngine, SubmitRejected
from repro_torch.serve.frontend import ServeFrontend


@dataclass
class FleetRecord:
    """One logical request, across however many engines it touches."""
    uid: Any
    prompt: np.ndarray
    max_new_tokens: int
    seq: int                              # fleet-wide FIFO position
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    frames: Optional[np.ndarray] = None
    on_token: Optional[Callable[[int], None]] = None
    tokens: List[int] = field(default_factory=list)
    engine: Optional[int] = None          # current engine index
    req: Optional[Request] = None         # current engine-level request
    status: str = "pending"
    redispatches: int = 0
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status in ("done", "expired", "rejected")

    @property
    def generation(self) -> Optional[int]:
        return self.req.generation if self.req is not None else None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass
class FleetReport:
    """Merged fleet accounting: totals are sums over engines, latency
    percentiles are recomputed over LOGICAL records (a request that
    failed over is one sample with its true end-to-end latency)."""
    engines: int = 0
    live_engines: int = 0
    requests: int = 0                 # logical finished (done + expired)
    tokens_generated: int = 0         # across every engine it touched
    failovers: int = 0
    redispatched: int = 0
    swaps: int = 0
    wall_s: float = 0.0
    tokens_per_s: float = 0.0
    ttft_p50: float = 0.0             # submit → first token (queue wait
    ttft_p95: float = 0.0             # + prefill, fleet-level)
    tps_p50: float = 0.0
    tps_p95: float = 0.0
    deadline_misses: int = 0
    per_engine: List[Any] = field(default_factory=list)


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class FleetRouter:
    """Least-loaded dispatch + failover drain over N serve engines.

    ``engines`` are ready-built ``ServeEngine``s (sharded or not — the
    router is mesh-agnostic).  ``monitor`` wires heartbeat-driven
    failover: each engine beats ``<worker_prefix><i>`` once per tick,
    and ``pump`` fails over any live engine the monitor reports dead.
    Without a monitor, only explicit ``kill(i)`` fails engines.

    All engines should share one ``clock`` (pass it to the engines and
    the monitor) so deadlines and failover agree on time; the router
    reads time from the first engine.
    """

    def __init__(self, engines: Sequence[ServeEngine], *,
                 monitor=None, max_queue: int = 64,
                 worker_prefix: str = "engine"):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self.monitor = monitor
        self.frontends = [ServeFrontend(e, max_queue=max_queue)
                          for e in engines]
        self._workers: List[str] = []
        for i, fe in enumerate(self.frontends):
            eng = fe.engine
            if monitor is not None and eng.heartbeat is None:
                eng.heartbeat = monitor
                eng.heartbeat_worker = f"{worker_prefix}{i}"
            self._workers.append(eng.heartbeat_worker)
        self.live = set(range(len(self.frontends)))
        self._failed: Dict[int, float] = {}   # idx → clock at failure
        self.records: Dict[Any, FleetRecord] = {}
        self.finished: List[FleetRecord] = []
        self.rejected: List[FleetRecord] = []
        self.failovers = 0
        self.redispatched = 0
        self._uids = itertools.count()
        self._seq = itertools.count()
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        # real-time instrumentation: router bookkeeping vs engine step
        # (the fleet bench asserts dispatch overhead < 5% of step time)
        self.dispatch_s = 0.0
        self.step_s = 0.0

    # -- clock -------------------------------------------------------------
    @property
    def clock(self):
        return self.frontends[0].engine.clock

    # -- dispatch ----------------------------------------------------------
    def _load(self, i: int):
        """Least-loaded key: slots + intake + wait queue, then free KV
        blocks (more free blocks wins), then index for determinism."""
        fe = self.frontends[i]
        eng = fe.engine
        active = sum(g.active_count() for g in eng.generations)
        free_blocks = sum(g.pool.available for g in eng.generations
                          if g.pool is not None)
        return (active + len(eng.queue) + len(fe.waiting),
                -free_blocks, i)

    def _engine_request(self, rec: FleetRecord) -> Request:
        """Engine-level request for a (possibly resumed) record: the
        prompt is the original prompt plus every token already emitted,
        the budget is what remains — greedy decode continues the stream
        bit-exactly."""
        prompt = rec.prompt
        if rec.tokens:
            prompt = np.concatenate(
                [np.asarray(prompt, np.int32),
                 np.asarray(rec.tokens, np.int32)])

        def shim(tok: int, rec=rec) -> None:
            rec.tokens.append(tok)
            if rec.first_token_at is None:
                rec.first_token_at = self.clock()
            if rec.on_token is not None:
                rec.on_token(tok)

        return Request(uid=rec.uid, prompt=np.asarray(prompt, np.int32),
                       max_new_tokens=rec.max_new_tokens - len(rec.tokens),
                       eos_id=rec.eos_id, deadline_s=rec.deadline_s,
                       frames=rec.frames, on_token=shim,
                       submitted_at=rec.submitted_at)

    def _dispatch(self, rec: FleetRecord, *, force: bool = False) -> None:
        """Hand ``rec`` to the least-loaded live engine.  ``force``
        (failover path) bypasses the wait-queue cap: an evicted request
        was already admitted once and must not be lost to backpressure.
        """
        if not self.live:
            raise RuntimeError(
                f"request {rec.uid}: no live engines to dispatch onto")
        i = min(self.live, key=self._load)
        fe = self.frontends[i]
        req = self._engine_request(rec)
        rec.engine, rec.req = i, req
        try:
            fe.engine.submit(req)
        except SubmitRejected as e:
            if e.retryable and (force or len(fe.waiting) < fe.max_queue):
                req.status = "waiting"
                fe.waiting.append(req)
            else:
                rec.status = req.status = "rejected"
                self.rejected.append(rec)
                raise
        rec.status = req.status

    def submit(self, prompt=None, *, uid=None, max_new_tokens: int = 16,
               eos_id=None, deadline_s: Optional[float] = None,
               frames=None, on_token=None) -> FleetRecord:
        """Admit one logical request to the fleet.

        Returns its ``FleetRecord`` (live view: ``tokens`` grows as the
        owning engine decodes; ``status`` ends at done/expired).
        Raises ``SubmitRejected`` exactly like a single engine would."""
        t0 = time.perf_counter()
        if prompt is None:
            raise ValueError("submit() needs a prompt")
        uid = next(self._uids) if uid is None else uid
        if uid in self.records:
            raise ValueError(f"duplicate request uid {uid!r}")
        rec = FleetRecord(uid=uid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens,
                          seq=next(self._seq), eos_id=eos_id,
                          deadline_s=deadline_s, frames=frames,
                          on_token=on_token, submitted_at=self.clock())
        if self._t0 is None:
            self._t0 = rec.submitted_at
        self.records[uid] = rec
        try:
            self._dispatch(rec)
        finally:
            self.dispatch_s += time.perf_counter() - t0
        return rec

    # -- failover ----------------------------------------------------------
    def kill(self, i: int) -> List[FleetRecord]:
        """Fail engine ``i`` NOW (deterministic failure injection; the
        heartbeat path calls the same drain).  Returns the re-dispatched
        records."""
        return self._fail(i, reason="killed")

    def _fail(self, i: int, reason: str) -> List[FleetRecord]:
        if i not in self.live:
            return []
        self.live.discard(i)
        now = self.monitor.clock() if self.monitor is not None \
            else self.clock()
        self._failed[i] = now
        self.failovers += 1
        fe = self.frontends[i]
        fe.engine.set_health(False, f"failover: {reason}")
        orphans = list(fe.engine.evict_all())
        while fe.waiting:
            req = fe.waiting.popleft()
            req.status = "evicted"
            orphans.append(req)
        recs = sorted((self.records[r.uid] for r in orphans),
                      key=lambda rec: rec.seq)
        for rec in recs:                       # FIFO order preserved
            rec.redispatches += 1
            self.redispatched += 1
            self._dispatch(rec, force=True)
        return recs

    def _check_fleet_health(self) -> None:
        if self.monitor is None:
            return
        dead = set(self.monitor.dead_workers())
        for i in sorted(self.live):
            if self._workers[i] in dead:
                self._fail(i, reason="heartbeat stale")
        # flap re-admission: a failed engine whose beats resumed AFTER
        # the failure comes back for new dispatches (its old work
        # already moved — nothing is duplicated)
        now = self.monitor.clock()
        for i in sorted(self._failed):
            age = self.monitor.age(self._workers[i])
            if age is None or age > self.monitor.deadline_s:
                continue
            if (now - age) > self._failed[i]:
                self._readmit(i)

    def _readmit(self, i: int) -> None:
        self._failed.pop(i, None)
        self.frontends[i].engine.set_health(True)
        self.live.add(i)

    # -- the event loop ----------------------------------------------------
    def _book_finished(self, fin: List[Request],
                       done: List[FleetRecord]) -> None:
        for req in fin:
            rec = self.records.get(req.uid)
            if rec is None or rec.req is not req or rec.done:
                continue
            rec.status = req.status
            rec.finished_at = req.finished_at \
                if req.finished_at is not None else self.clock()
            self.finished.append(rec)
            done.append(rec)

    def pump(self, steps: int = 1) -> List[FleetRecord]:
        """Advance the fleet ``steps`` ticks: health/failover sweep,
        then one frontend pump per live engine.  Returns the logical
        records that finished during the call."""
        done: List[FleetRecord] = []
        for _ in range(steps):
            t0 = time.perf_counter()
            self._check_fleet_health()
            t1 = time.perf_counter()
            self.dispatch_s += t1 - t0
            for i in sorted(self.live):
                s0 = time.perf_counter()
                fin = self.frontends[i].pump(1)
                self.step_s += time.perf_counter() - s0
                b0 = time.perf_counter()
                self._book_finished(fin, done)
                self.dispatch_s += time.perf_counter() - b0
            self._t_last = self.clock()
        return done

    def drain(self, max_steps: int = 1_000_000) -> List[FleetRecord]:
        """Pump until every live engine and wait queue is empty."""
        done: List[FleetRecord] = []
        for _ in range(max_steps):
            if self.idle:
                break
            done.extend(self.pump(1))
        return done

    @property
    def idle(self) -> bool:
        return all(self.frontends[i].idle for i in self.live)

    # -- hot-swap ----------------------------------------------------------
    def swap_targets(self):
        """(index, engine) for every live engine — the hook
        ``TicketManager.swap`` fans the all-or-nothing fleet swap over.
        """
        return [(i, self.frontends[i].engine) for i in sorted(self.live)]

    # -- accounting --------------------------------------------------------
    @property
    def report(self) -> FleetReport:
        fin = self.finished
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        tokens = sum(len(r.tokens) for r in self.records.values())
        ttft = [r.ttft for r in fin if r.ttft is not None]
        tps = [len(r.tokens) / max(r.finished_at - r.submitted_at, 1e-9)
               for r in fin
               if r.tokens and r.finished_at is not None
               and r.submitted_at is not None]
        per = [fe.engine.report for fe in self.frontends]
        return FleetReport(
            engines=len(self.frontends),
            live_engines=len(self.live),
            requests=len(fin),
            tokens_generated=tokens,
            failovers=self.failovers,
            redispatched=self.redispatched,
            swaps=sum(p.swaps for p in per),
            wall_s=wall,
            tokens_per_s=tokens / wall if wall > 0 else 0.0,
            ttft_p50=_pct(ttft, 50), ttft_p95=_pct(ttft, 95),
            tps_p50=_pct(tps, 50), tps_p95=_pct(tps, 95),
            deadline_misses=sum(p.deadline_misses for p in per),
            per_engine=per,
        )
