"""Continuous-batching serving engine over the paged KV cache.

A port of ``repro.serve.engine.ServeEngine``'s paged path.  The engine
keeps a fixed array of decode *slots*.  Each request is prefilled on its
own — right-padded to a length bucket and masked with ``valid_len``, or,
where the model cannot mask padding (MoE routing), at the prompt's own
length — and its dense prefill cache is scattered into blocks of a
shared KV (or MLA latent) pool (``serve.paging.BlockPool`` over
``models.transformer`` pools).
All slots then advance through one paged decode step per token, each at
its own position, and a finished slot is refilled from the queue at the
next tick.  A request is admitted when ``ceil((prompt + budget) /
BLOCK)`` blocks can be reserved, so decode never runs out of blocks.

Given the pruned ticket's ``masks``, every GQA attention, MLP and MoE
expert projection of prefill and decode goes through the block-sparse
kernels (``kernels.bsmm``; the experts batched, one launch per
projection), skipping dead 128x128 crossbar tiles, and decode attention
reads only live KV (or MLA latent) blocks (``kernels.paged_attention``).

Not yet ported: dense-slot (non-paged) engines, hot-swap generations
(``swap``/``rollback``), meshes and heartbeats.  Sampling happens on the
host from per-request numpy streams, as in the reference, so greedy
streams are comparable one to one.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch._bridge import resolve_device
from repro_torch.kernels.paged_attention import BLOCK_TOKENS
from repro_torch.models import transformer as tfm
from repro_torch.models.plans import PlanStats, build_decode_plan
from repro_torch.serve.paging import BlockPool, blocks_needed


class SubmitRejected(ValueError):
    """Structured admission rejection; ``reason`` is one of
    ``"capacity"`` (the only retryable one), ``"oversize"``,
    ``"empty_prompt"`` or ``"bad_budget"``."""

    RETRYABLE = ("capacity",)

    def __init__(self, reason: str, message: str, uid=None):
        self.reason = reason
        self.uid = uid
        super().__init__(message)

    @property
    def retryable(self) -> bool:
        return self.reason in self.RETRYABLE


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # seconds from submission after which the request is cancelled
    deadline_s: Optional[float] = None
    # streaming: called with each token the moment it is sampled
    on_token: Optional[Callable[[int], None]] = None
    # pending -> queued -> active -> done | expired
    status: str = "pending"
    generation: Optional[int] = None
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass
class ServeReport:
    """Cumulative scheduler/throughput accounting (see ``report``)."""
    requests: int = 0
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    slot_occupancy: float = 0.0     # mean busy-slot fraction per decode step
    wall_s: float = 0.0
    tokens_per_s: float = 0.0
    bsmm_enabled: bool = False
    routed_matmuls: int = 0
    live_tiles: int = 0
    total_tiles: int = 0
    skipped_tile_fraction: float = 0.0
    ttft_p50: float = 0.0
    ttft_p95: float = 0.0
    tps_p50: float = 0.0
    tps_p95: float = 0.0
    deadline_misses: int = 0
    swaps: int = 0
    paged: bool = False
    kv_blocks: int = 0              # pool size (incl. scratch)
    kv_blocks_live: int = 0         # blocks holding live context right now
    kv_blocks_peak: int = 0         # max simultaneous live blocks
    kv_block_bytes: int = 0         # KV bytes per block across all layers
    kv_bytes_per_token: float = 0.0  # mean KV bytes read per decoded token


def _default_buckets(limit: int) -> List[int]:
    """Power-of-two prefill buckets capped at the largest admissible
    prefill length (``limit - 1``: every request decodes >= 1 token)."""
    top = max(limit - 1, 1)
    out, b = [], 8
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return out


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


class ServeEngine:
    """Continuous-batching scheduler on the paged KV path.

    ``masks`` (optional): the pruned ticket's mask pytree — turns on
    block-sparse prefill and decode.  ``temperature <= 0`` is greedy.
    ``kv_blocks`` sizes the block pool (default: one scratch block plus
    room for every slot at ``capacity``); the largest admissible request
    is then ``(kv_blocks - 1) * BLOCK`` tokens.  ``device`` (default
    ``"cuda"``) must hold ``params``; ``device="cpu"`` runs the kernels'
    plain versions.
    """

    def __init__(self, *, params, cfg, batch_slots: int = 8,
                 capacity: int = 512, temperature: float = 0.0,
                 sample_seed: int = 0, masks=None,
                 queue_limit: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 paged: Optional[bool] = None,
                 kv_blocks: Optional[int] = None,
                 mesh=None, heartbeat=None, device="cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            raise _not_ported("ServeEngine(mesh=)")
        if heartbeat is not None:
            raise _not_ported("ServeEngine(heartbeat=)")
        if paged is False or not tfm.supports_paged_decode(cfg):
            raise _not_ported("the dense-slot (non-paged) engine")
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"params live on {params['embed']['table'].device}"
                             f", the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.slots = batch_slots
        self.temperature = temperature
        self.sample_seed = sample_seed
        self.paged = True
        if kv_blocks is None:
            kv_blocks = self.slots * blocks_needed(capacity, BLOCK_TOKENS) + 1
        if kv_blocks < 2:
            raise ValueError(f"kv_blocks must be >= 2, got {kv_blocks}")
        self.kv_blocks = int(kv_blocks)
        self.max_context = (self.kv_blocks - 1) * BLOCK_TOKENS
        self._buckets = _default_buckets(self.max_context)
        self._masked_prefill = tfm.supports_masked_prefill(cfg)
        self.queue_limit = queue_limit
        self.clock = clock or time.perf_counter

        # the ticket's TilePlans drive both prefill and decode
        self.plan, self.plan_stats = (build_decode_plan(masks)
                                      if masks is not None
                                      else (None, PlanStats()))

        self.pool = BlockPool(self.kv_blocks)
        with torch.inference_mode():
            self.paged_caches = tfm.make_paged_caches(cfg, self.kv_blocks,
                                                      device=self.device)
        self._block_bytes = tfm.paged_cache_bytes(
            tfm.paged_cache_spec(cfg, self.kv_blocks)) // self.kv_blocks
        nb = self.kv_blocks - 1     # one request may hold every block
        self.tables = np.zeros((self.slots, nb), np.int32)
        self.lens = np.zeros((self.slots,), np.int32)
        self.slot_nblocks = np.zeros((self.slots,), np.int64)
        self.slot_reqs: List[Optional[Request]] = [None] * self.slots
        self.slot_rngs: List[Optional[np.random.Generator]] = \
            [None] * self.slots
        self.cur = np.zeros((self.slots,), np.int64)

        self.queue: Deque[Request] = deque()
        self._finished: List[Request] = []
        self._prefills = 0
        self._decode_steps = 0
        self._tokens = 0
        self._busy_acc = 0
        self._deadline_misses = 0
        self._kv_bytes = 0           # analytic KV bytes read by paged decode
        self._kv_tokens = 0          # tokens decoded on the paged path
        self._kv_peak = 0            # peak live blocks
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    def swap(self, params, masks=None) -> int:
        raise _not_ported("hot-swap (ServeEngine.swap)")

    def rollback(self, gid: int) -> None:
        raise _not_ported("ServeEngine.rollback")

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if n < 1:
            raise SubmitRejected(
                "empty_prompt", f"request {req.uid}: empty prompt", req.uid)
        if req.max_new_tokens < 1:
            raise SubmitRejected(
                "bad_budget", f"request {req.uid}: max_new_tokens must be "
                f">= 1, got {req.max_new_tokens}", req.uid)
        if n + req.max_new_tokens > self.max_context:
            raise SubmitRejected(
                "oversize",
                f"request {req.uid}: prompt ({n}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the paged KV limit "
                f"((kv_blocks-1)*BLOCK = {self.max_context}); shorten the "
                "request or raise kv_blocks", req.uid)
        if self.queue_limit is not None \
                and len(self.queue) >= self.queue_limit:
            raise SubmitRejected(
                "capacity", f"request {req.uid}: intake queue full "
                f"({self.queue_limit}); retry when slots free", req.uid)
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        req.status = "queued"
        self.queue.append(req)

    # -- sampling ----------------------------------------------------------
    def _rng_for(self, req: Request) -> np.random.Generator:
        # per-request stream: sampling stays batch-invariant
        return np.random.default_rng((self.sample_seed, req.uid))

    def _sample_row(self, logits_row: np.ndarray,
                    rng: np.random.Generator) -> int:
        """Greedy argmax, or temperature sampling via the Gumbel trick."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / self.temperature
        g = rng.gumbel(size=z.shape)
        return int(np.argmax(z + g))

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _prefill_request(self, req: Request, rng):
        """Single-request prefill → (first token, caches, S).

        Bucketed and masked where the model supports it, else at the
        prompt's exact length (S = n).  The dense cache's capacity is S:
        it lives only until it is scattered into pool blocks."""
        prompt = np.asarray(req.prompt, np.int32)
        n = len(prompt)
        S = self._bucket(n) if self._masked_prefill else n
        toks = np.zeros((1, S), np.int64)
        toks[0, :n] = prompt                            # right-pad
        valid_len = (torch.tensor([n], dtype=torch.int32, device=self.device)
                     if self._masked_prefill else None)
        logits, caches = tfm.prefill(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(toks, device=self.device)}, S,
            valid_len=valid_len, plan=self.plan)
        tok = self._sample_row(logits[0, -1].float().cpu().numpy(), rng)
        return tok, caches, S

    # -- lifecycle helpers -------------------------------------------------
    def _finish(self, req: Request, status: str,
                out: Optional[List[Request]] = None) -> None:
        req.done = True
        req.status = status
        req.finished_at = self.clock()
        self._finished.append(req)
        if out is not None:
            out.append(req)

    def _emit_token(self, req: Request, tok: int) -> None:
        req.tokens.append(tok)
        self._tokens += 1
        if req.first_token_at is None:
            req.first_token_at = self.clock()
        if req.on_token is not None:
            req.on_token(tok)

    def _expired(self, req: Request) -> bool:
        return (req.deadline_s is not None and req.submitted_at is not None
                and self.clock() - req.submitted_at > req.deadline_s)

    def _expire_queue(self, out: List[Request]) -> None:
        keep: Deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            if self._expired(req):
                self._deadline_misses += 1
                self._finish(req, "expired", out)
            else:
                keep.append(req)
        self.queue = keep

    def _free_slot(self, s: int) -> None:
        """Release a slot and its blocks: the table row resets to the
        scratch block, the length to zero."""
        req = self.slot_reqs[s]
        if req is not None:
            self.pool.release(req.uid)
        self.tables[s, :] = 0
        self.lens[s] = 0
        self.slot_nblocks[s] = 0
        self.slot_reqs[s] = None
        self.slot_rngs[s] = None

    def _expire_slots(self, out: List[Request]) -> None:
        for s in range(self.slots):
            req = self.slot_reqs[s]
            if req is not None and self._expired(req):
                self._deadline_misses += 1
                self._finish(req, "expired", out)
                self._free_slot(s)

    # -- the scheduler -----------------------------------------------------
    def _adopt_request(self, req: Request, s: int, caches, n: int,
                       S: int) -> None:
        """Scatter a request's prefill caches into blocks drawn from its
        reservation and point slot ``s``'s table row at them; entries
        past the prompt (the padded bucket tail) go to the scratch
        block, where ``lens`` masks them."""
        nb_real = blocks_needed(n, BLOCK_TOKENS)
        nb_total = blocks_needed(S, BLOCK_TOKENS)
        blocks = [self.pool.alloc(req.uid) for _ in range(nb_real)]
        blocks += [0] * (nb_total - nb_real)
        tfm.adopt_prefill(self.cfg, self.paged_caches, caches, blocks)
        self.tables[s, :] = 0
        self.tables[s, :nb_real] = blocks[:nb_real]
        self.lens[s] = n
        self.slot_nblocks[s] = nb_real

    def _refill(self, out: List[Request]) -> None:
        for s in range(self.slots):
            while self.slot_reqs[s] is None and self.queue:
                req = self.queue.popleft()
                if self._expired(req):
                    self._deadline_misses += 1
                    self._finish(req, "expired", out)
                    continue
                n = len(req.prompt)
                # the request enters a slot only when its whole block
                # budget can be reserved; short on blocks, it waits at
                # the FIFO head until finished requests release theirs
                need = blocks_needed(n + req.max_new_tokens, BLOCK_TOKENS)
                if not self.pool.can_reserve(need):
                    self.queue.appendleft(req)
                    return
                self.pool.reserve(req.uid, need)
                rng = self._rng_for(req)
                tok, caches, S = self._prefill_request(req, rng)
                self._prefills += 1
                req.generation = 0
                req.status = "active"
                self._emit_token(req, tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or req.max_new_tokens <= 1):
                    self.pool.release(req.uid)
                    self._finish(req, "done", out)   # done at prefill
                    continue
                self._adopt_request(req, s, caches, n, S)
                self.slot_reqs[s] = req
                self.slot_rngs[s] = rng
                self.cur[s] = tok
        self._kv_peak = max(self._kv_peak, self.pool.live)

    def _decode(self, out: List[Request]) -> None:
        active = [s for s in range(self.slots)
                  if self.slot_reqs[s] is not None]
        if not active:
            return
        # alloc-on-append: the block the new token lands in must exist
        # before the decode step writes it (drawn from the reservation)
        for s in active:
            req = self.slot_reqs[s]
            while self.slot_nblocks[s] <= self.lens[s] // BLOCK_TOKENS:
                pid = self.pool.alloc(req.uid)
                self.tables[s, self.slot_nblocks[s]] = pid
                self.slot_nblocks[s] += 1
        self._kv_peak = max(self._kv_peak, self.pool.live)
        # copy the host-side tables/lens at the device boundary: on the
        # CPU torch.as_tensor would alias the numpy buffers the
        # scheduler mutates in place below
        dev = self.device
        logits, self.paged_caches = tfm.decode_step_paged(
            self.params, self.cfg, self.paged_caches,
            torch.as_tensor(self.cur[:, None].copy(), device=dev),
            torch.as_tensor(self.tables.copy(), device=dev),
            torch.as_tensor(self.lens.copy(), device=dev),
            plan=self.plan)
        # analytic bytes: the kernel reads ceil((len+1)/BLOCK) live
        # blocks per active row
        self._kv_bytes += self._block_bytes * sum(
            blocks_needed(int(self.lens[s]) + 1, BLOCK_TOKENS)
            for s in active)
        self._kv_tokens += len(active)
        self.lens[active] += 1
        self._decode_steps += 1
        self._busy_acc += len(active)
        logits_h = logits[:, 0].float().cpu().numpy()
        for s in active:
            req = self.slot_reqs[s]
            tok = self._sample_row(logits_h[s], self.slot_rngs[s])
            self._emit_token(req, tok)
            self.cur[s] = tok
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.tokens) >= req.max_new_tokens):
                self._finish(req, "done", out)
                self._free_slot(s)  # refilled next tick

    def step(self) -> List[Request]:
        """One scheduler tick: deadline sweep, slot refill, one decode
        step.  Returns the requests that finished this tick."""
        if self._t0 is None:
            self._t0 = self.clock()
        out: List[Request] = []
        with torch.inference_mode():
            self._expire_queue(out)
            self._expire_slots(out)
            if self.queue:
                self._refill(out)
            self._decode(out)
        self._t_last = self.clock()
        return out

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_reqs)

    @property
    def kv_blocks_live(self) -> int:
        return self.pool.live

    def run(self) -> List[Request]:
        """Serve everything in the queue to completion; returns the
        requests that finished during this call."""
        start = len(self._finished)
        while not self.idle:
            self.step()
        return self._finished[start:]

    # -- accounting --------------------------------------------------------
    @property
    def report(self) -> ServeReport:
        fin = self._finished
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        ttft = [r.ttft for r in fin if r.ttft is not None]
        tps = [len(r.tokens) / max(r.finished_at - r.submitted_at, 1e-9)
               for r in fin
               if r.tokens and r.finished_at is not None
               and r.submitted_at is not None]
        st = self.plan_stats
        return ServeReport(
            requests=len(fin),
            prefills=self._prefills,
            decode_steps=self._decode_steps,
            tokens_generated=self._tokens,
            slot_occupancy=(self._busy_acc / (self._decode_steps * self.slots)
                            if self._decode_steps else 0.0),
            wall_s=wall,
            tokens_per_s=self._tokens / wall if wall > 0 else 0.0,
            bsmm_enabled=self.plan is not None,
            routed_matmuls=st.routed,
            live_tiles=st.live_tiles,
            total_tiles=st.total_tiles,
            skipped_tile_fraction=st.skipped_tile_fraction,
            ttft_p50=_pct(ttft, 50), ttft_p95=_pct(ttft, 95),
            tps_p50=_pct(tps, 50), tps_p95=_pct(tps, 95),
            deadline_misses=self._deadline_misses,
            swaps=0,
            paged=True,
            kv_blocks=self.kv_blocks,
            kv_blocks_live=self.kv_blocks_live,
            kv_blocks_peak=self._kv_peak,
            kv_block_bytes=self._block_bytes,
            kv_bytes_per_token=(self._kv_bytes / self._kv_tokens
                                if self._kv_tokens else 0.0),
        )
