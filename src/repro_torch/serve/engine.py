"""Continuous-batching serving engine: slot refill mid-decode, ticket
generations for zero-drain hot-swap, health and heartbeats.

A port of ``repro.serve.engine.ServeEngine``.  The engine keeps a fixed
array of decode *slots*.  Each request is prefilled on its own —
right-padded to a length bucket and masked with ``valid_len``, or,
where the model cannot mask padding (MoE routing), at the prompt's own
length — and all slots then advance through one decode step per token,
each at its own position; a finished slot is refilled from the queue at
the next tick.

Encoder-decoder models (``prefill_fn``/``decode_fn`` from
``models.encdec``) take the **frames lane**: a request carries its
encoder frames beside the decoder prompt, is prefilled at the prompt's
exact length into a dense slot (the decoder's KV cache and each layer's
cross K/V, made once), and decodes like any other slot.

Two cache layouts, as in the reference.  **Paged** (the default where
the architecture allows it and ``decode_fn`` is the stock
``transformer.decode_step``): the prefill cache is scattered into blocks
of a shared KV (or MLA latent) pool (``serve.paging.BlockPool``), decode
reads only live blocks (``kernels.paged_attention``), and a request is
admitted when ``ceil((prompt + budget) / BLOCK)`` blocks can be
reserved.  **Dense-slot** (``paged=False``, and the only layout of
windowed and recurrent models): every slot owns capacity rows of a
dense cache (a windowed layer's ring of ``min(window, capacity)`` rows,
an RG-LRU layer's state), the prefill cache is spliced into its lane,
and decode runs ``decode_fn`` over all slots.

**Ticket generations.**  The engine's params + tile plan + caches +
slot state are a *generation*.  ``swap(params, masks)`` installs a new
one without draining traffic: requests already in slots finish on the
generation that prefilled them (their outputs are identical to a
swap-free run), every later admission prefills on the new ticket, and a
drained old generation retires.  ``rollback`` discards a just-installed
generation that has served nothing (the ticket manager's verification
path).  ``step()`` is one scheduler tick — deadline sweep, refill, one
decode per live generation, heartbeat — so a front-end can interleave
admission, streaming, health checks and hot-swaps between ticks.

Given the pruned ticket's ``masks``, every GQA attention, MLP and MoE
expert projection of prefill and decode goes through the block-sparse
kernels (``kernels.bsmm``), skipping dead 128x128 crossbar tiles, and
every prefill attends through the flash attention kernel
(``kernels.flash_attention``; a windowed layer past one window through
the reference's two-chunk form).  Sampling happens on the host from
per-request numpy streams, as in the reference, so greedy and sampled
streams are comparable one to one.

**Meshes.**  ``mesh=`` (a ``launch.mesh`` ``(data, model)`` mesh; every
rank builds the same engine and drives it in lockstep) places the
parameters by the sharding rules (``distributed.sharding``, with
``head_dim=cfg.head_dim``) and runs the model rank-local
(``distributed.tensor_parallel``): on a model axis M > 1 the attention
runs at Hq/M and Hkv/M heads (MLA at H/M heads over the whole latent),
the MLP at d_ff/M columns, the experts at E/M per rank, the RG-LRU at
its local channels, the mLSTM and sLSTM at their local heads and the
vocabulary at V/M rows, each rank's block-sparse plans built from its
own mask shard; the paged and slot caches hold the local kv heads, the
recurrent states their local widths, the MLA latent pool every head's
latent, and the frames lane's cross K/V the local heads.  On the data axis every rank runs the same host
scheduler (block tables replicated): slots ``[d·B/D, (d+1)·B/D)``
belong to data rank d, which alone prefills their requests and decodes
their rows; logits rows are gathered (prefill's broadcast) over the
data axis before sampling, so every rank's scheduler state stays
identical.  The rules are installed only for the engine's own calls, so
engines on different meshes and meshless ones coexist in a process.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._bridge import resolve_device, tree_zip
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.kernels.paged_attention import BLOCK_TOKENS
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.plans import PlanStats, build_decode_plan
from repro_torch.serve.paging import BlockPool, blocks_needed


class SubmitRejected(ValueError):
    """Structured admission rejection; ``reason`` is one of
    ``"capacity"`` (the only retryable one), ``"oversize"``,
    ``"empty_prompt"``, ``"bad_budget"`` or ``"unhealthy"`` (the
    engine's health gate is closed: admission stops, in-flight decode
    continues)."""

    RETRYABLE = ("capacity",)

    def __init__(self, reason: str, message: str, uid=None):
        self.reason = reason
        self.uid = uid
        super().__init__(message)

    @property
    def retryable(self) -> bool:
        return self.reason in self.RETRYABLE


@dataclass
class EngineHealth:
    healthy: bool = True
    reason: str = "ok"


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # enc-dec lane: precomputed encoder frames (T_enc, d_model)
    frames: Optional[np.ndarray] = None
    # seconds from submission after which the request is cancelled
    deadline_s: Optional[float] = None
    # streaming: called with each token the moment it is sampled
    on_token: Optional[Callable[[int], None]] = None
    # pending -> queued/waiting -> active -> done | expired | rejected
    # (| evicted: a fleet failover moved it to another engine)
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


@dataclass
class _Generation:
    """One ticket's serving bundle: params + masks + plan + the slot
    lanes it is decoding.  Swaps append a new one; old ones drain."""
    gid: int
    params: Any
    masks: Any                      # the ticket's masks (None: unpruned)
    plan: Any
    plan_stats: PlanStats
    cfg: Any                        # the config the model runs (local heads)
    slot_reqs: List[Optional[Request]]
    slot_rngs: List[Optional[np.random.Generator]]
    cur: np.ndarray
    slot_caches: Any = None         # dense-slot caches (paged=False)
    served: int = 0                 # requests prefilled on this ticket
    # paged-KV state (None when the engine runs dense caches)
    pool: Optional[BlockPool] = None
    paged_caches: Any = None        # block pools, one per attention layer
    tables: Optional[np.ndarray] = None        # (slots, NB) int32
    lens: Optional[np.ndarray] = None          # (slots,) int32 tokens written
    slot_nblocks: Optional[np.ndarray] = None  # blocks allocated per slot
    # the rank-local model on a mesh (None: meshless)
    sharded: Optional[tpar.ShardedModel] = None

    def active_count(self) -> int:
        return sum(1 for r in self.slot_reqs if r is not None)

    def free_slot(self, s: int) -> None:
        self.slot_reqs[s] = None
        self.slot_rngs[s] = None


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


class ServeEngine:
    """Continuous-batching scheduler over prefill/decode functions.

    ``prefill_fn``/``decode_fn`` default to ``transformer.prefill`` and
    ``transformer.decode_step``.  ``masks`` (optional): the pruned
    ticket's mask pytree — turns on block-sparse prefill and decode
    (``use_bsmm=False`` forces it off; it is never forced on without
    masks).  ``temperature <= 0`` or ``greedy=True`` is greedy.

    ``paged`` (None: auto) puts decode on the paged KV cache where the
    architecture supports it and ``decode_fn`` is the stock
    ``decode_step``; ``kv_blocks`` sizes each generation's block pool
    (default: one scratch block plus room for every slot at
    ``capacity``), and the largest admissible request is then
    ``(kv_blocks - 1) * BLOCK`` tokens.  With ``paged=False`` each slot
    holds ``capacity`` cache rows and that is the limit.

    ``queue_limit`` bounds the intake queue (``SubmitRejected
    ("capacity")`` beyond it); ``clock`` injects a time source;
    ``heartbeat`` (a ``distributed.fault_tolerance.HeartbeatMonitor``)
    is beaten as ``heartbeat_worker`` once per ``step``.  ``device``
    (default ``"cuda"``) must hold ``params``; ``device="cpu"`` runs the
    kernels' plain versions.  ``mesh`` serves on a mesh under the rules
    ``distributed.tensor_parallel.mesh_rules`` derives from it, every
    rank driving its own copy of the engine with the same calls;
    ``batch_slots`` must divide over the data axis.
    """

    def __init__(self, *, params, cfg, prefill_fn=None, decode_fn=None,
                 batch_slots: int = 8, capacity: int = 512,
                 greedy: Optional[bool] = None, temperature: float = 0.0,
                 sample_seed: int = 0, masks=None,
                 use_bsmm: Optional[bool] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 queue_limit: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 heartbeat=None, heartbeat_worker: str = "engine",
                 paged: Optional[bool] = None,
                 kv_blocks: Optional[int] = None,
                 mesh=None, device="cuda"):
        self.device = resolve_device(device)
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.cfg = cfg
        self.capacity = capacity
        self.slots = batch_slots
        self.mesh = mesh
        self.rules = rules = (tpar.mesh_rules(mesh, cfg) if mesh is not None
                              else None)
        dp = rules.dp_size if rules is not None else 1
        if batch_slots % dp:
            raise ValueError(f"batch_slots ({batch_slots}) must divide over "
                             f"the {dp} data shards")
        self._dp = dp
        self._data_group = mesh.get_group("data") if dp > 1 else None
        d = mesh.get_local_rank("data") if dp > 1 else 0
        self._lo, self._hi = d * batch_slots // dp, (d + 1) * batch_slots // dp
        # greedy=None derives from temperature; an explicit greedy wins
        self.greedy = (temperature <= 0.0) if greedy is None else greedy
        self.temperature = temperature
        self.sample_seed = sample_seed
        self._prefill_fn = prefill_fn or tfm.prefill
        self._decode_fn = decode_fn or tfm.decode_step
        # (uid, f32 logits row) of every sampled token, when set: a
        # check's view of the numbers behind a stream
        self.logits_sink: Optional[Callable[[Any, np.ndarray], None]] = None
        self._use_bsmm = use_bsmm
        self._masked_prefill = tfm.supports_masked_prefill(cfg)

        paged_ok = (tfm.supports_paged_decode(cfg)
                    and self._decode_fn is tfm.decode_step)
        if paged is None:
            paged = paged_ok
        elif paged and not paged_ok:
            raise ValueError(
                "paged=True needs a paged-capable architecture (all-global-"
                "attention) and the stock transformer.decode_step decode_fn")
        self.paged = bool(paged)
        if self.paged:
            if kv_blocks is None:
                kv_blocks = self.slots * blocks_needed(capacity,
                                                       BLOCK_TOKENS) + 1
            if kv_blocks < 2:
                raise ValueError(f"kv_blocks must be >= 2, got {kv_blocks}")
            self.kv_blocks = int(kv_blocks)
            self.max_context = (self.kv_blocks - 1) * BLOCK_TOKENS
            self._block_bytes = tfm.paged_cache_bytes(
                tfm.paged_cache_spec(cfg, self.kv_blocks)) // self.kv_blocks
        else:
            self.kv_blocks = 0
            self.max_context = capacity
            self._block_bytes = 0
        self._buckets = (sorted(prefill_buckets) if prefill_buckets
                         else _default_buckets(self.max_context))

        self.queue_limit = queue_limit
        self.clock = clock or time.perf_counter
        self.heartbeat = heartbeat
        self.heartbeat_worker = heartbeat_worker
        self.health = EngineHealth()

        self.queue: Deque[Request] = deque()
        self._axes = None                # cache batch axes (dense slots)
        self._gens: List[_Generation] = []
        self._next_gid = 0
        self._finished: List[Request] = []
        self._prefills = 0
        self._decode_steps = 0
        self._tokens = 0
        self._busy_acc = 0
        self._deadline_misses = 0
        self._swaps = 0
        self._kv_bytes = 0           # analytic KV bytes read by paged decode
        self._kv_tokens = 0          # tokens decoded on the paged path
        self._kv_peak = 0            # peak live blocks across generations
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._install_generation(params, masks, use_bsmm)

    # -- generations (the hot-swap machinery) ------------------------------
    def _install_generation(self, params, masks, use_bsmm) -> int:
        where = params["embed"]["table"].device
        if where != self.device:
            raise ValueError(f"params live on {where}, the engine on "
                             f"{self.device}")
        sharded, cfg = None, self.cfg
        if self.rules is not None:
            # this rank's shards; its plans come from its own mask shard
            sharded = tpar.ShardedModel.from_full(params, self.cfg,
                                                  self.rules, masks)
            params, cfg = sharded.params, sharded.cfg
            if masks is not None:
                masks = tpar.localize(masks, sharded.shardings,
                                      contiguous=False)
        # the ticket's TilePlans drive both prefill and decode
        plan, stats = (build_decode_plan(masks) if masks is not None
                       else (None, PlanStats()))
        if use_bsmm is False:
            plan, stats = None, PlanStats()
        elif use_bsmm and plan is None:
            raise ValueError("use_bsmm=True needs masks with routable "
                             "dense projections")
        gen = _Generation(
            gid=self._next_gid, params=params, masks=masks, plan=plan,
            plan_stats=stats, cfg=cfg,
            slot_reqs=[None] * self.slots, slot_rngs=[None] * self.slots,
            cur=np.zeros((self.slots,), np.int64), sharded=sharded)
        if self.paged:
            gen.pool = BlockPool(self.kv_blocks)
            with torch.inference_mode():
                gen.paged_caches = tfm.make_paged_caches(
                    cfg, self.kv_blocks, device=self.device)
            nb = self.kv_blocks - 1     # one request may hold every block
            gen.tables = np.zeros((self.slots, nb), np.int32)
            gen.lens = np.zeros((self.slots,), np.int32)
            gen.slot_nblocks = np.zeros((self.slots,), np.int64)
        self._next_gid += 1
        self._gens.append(gen)
        return gen.gid

    @property
    def current_generation(self) -> int:
        """Generation id new admissions will prefill on."""
        return self._gens[-1].gid

    @property
    def generations(self) -> Tuple[_Generation, ...]:
        """Live ticket generations, oldest → newest (a read-only view)."""
        return tuple(self._gens)

    @property
    def params(self):
        """The newest generation's parameters."""
        return self._gens[-1].params

    @property
    def plan(self):
        """The newest generation's tile plan (None: dense)."""
        return self._gens[-1].plan

    @property
    def kept_whole(self) -> List[Tuple[str, tuple]]:
        """[(path, spec)] of the newest generation's leaves kept whole on
        every model rank against their spec (see
        ``distributed.tensor_parallel``)."""
        sm = self._gens[-1].sharded
        return [] if sm is None else list(sm.whole)

    # -- mesh plumbing -----------------------------------------------------
    def _scope(self, gen: _Generation, groups: Optional[int] = None):
        """The generation's rules and tensor-parallel context, installed
        for one model call (nothing on a meshless engine)."""
        if gen.sharded is None:
            return contextlib.nullcontext()
        return gen.sharded.scope(groups)

    def _owns(self, s: int) -> bool:
        """True when slot ``s`` belongs to this rank's data shard."""
        return self._lo <= s < self._hi

    def swap(self, params, masks=None, use_bsmm: Optional[bool] = None
             ) -> int:
        """Install a new ticket generation WITHOUT draining traffic.

        In-flight requests finish on the generation that prefilled them;
        every admission from this call on prefills on the new ticket.
        Returns the new generation id (``rollback`` it if a post-swap
        verification fails)."""
        if use_bsmm is None:
            use_bsmm = self._use_bsmm
        gid = self._install_generation(params, masks, use_bsmm)
        self._swaps += 1
        return gid

    def rollback(self, gid: int) -> None:
        """Discard a just-swapped generation that has served nothing."""
        gen = self._gens[-1]
        if gen.gid != gid:
            raise ValueError(f"generation {gid} is not the newest "
                             f"swapped-in generation")
        if gen.served or gen.active_count():
            raise RuntimeError(f"generation {gid} already served "
                               f"{gen.served} request(s); cannot roll back")
        if len(self._gens) == 1:
            raise ValueError("cannot roll back the only live generation")
        self._gens.pop()
        self._swaps -= 1

    def _gen_by_gid(self, gid: int) -> _Generation:
        for g in self._gens:
            if g.gid == gid:
                return g
        raise KeyError(f"no live generation {gid}")

    # -- health ------------------------------------------------------------
    def set_health(self, healthy: bool, reason: str = "ok") -> None:
        self.health = EngineHealth(healthy, reason)

    def evict_all(self) -> List[Request]:
        """Failover drain: remove every queued and in-slot request WITHOUT
        finishing it.  Slots free, paged blocks return to their pools, and
        the requests come back unfinished (status ``"evicted"``, emitted
        tokens kept) so a fleet router can re-dispatch them."""
        out: List[Request] = []
        for gen in self._gens:
            for s in range(self.slots):
                req = gen.slot_reqs[s]
                if req is not None:
                    self._free_slot(gen, s)
                    req.status = "evicted"
                    out.append(req)
        while self.queue:
            req = self.queue.popleft()
            req.status = "evicted"
            out.append(req)
        return out

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if not self.health.healthy:
            raise SubmitRejected(
                "unhealthy", f"request {req.uid}: engine is unhealthy "
                f"({self.health.reason}); admission stopped", req.uid)
        n = len(req.prompt)
        if n < 1:
            raise SubmitRejected(
                "empty_prompt", f"request {req.uid}: empty prompt", req.uid)
        if req.max_new_tokens < 1:
            raise SubmitRejected(
                "bad_budget", f"request {req.uid}: max_new_tokens must be "
                f">= 1, got {req.max_new_tokens}", req.uid)
        if n + req.max_new_tokens > self.max_context:
            what = (f"paged KV limit ((kv_blocks-1)*BLOCK = "
                    f"{self.max_context})" if self.paged
                    else f"KV-cache capacity ({self.capacity})")
            raise SubmitRejected(
                "oversize",
                f"request {req.uid}: prompt ({n}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds {what}; shorten the "
                "request or raise capacity", req.uid)
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
        if self.greedy or self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / self.temperature
        g = rng.gumbel(size=z.shape)
        return int(np.argmax(z + g))

    # -- cache plumbing ----------------------------------------------------
    def _empty_slot_caches(self, proto):
        """Zeros shaped like a single-request prefill cache with the batch
        axis = slot count (a scalar index gets a slot axis appended)."""
        if self._axes is None:
            # an encoder-decoder's caches are a list of per-layer
            # {"self", "cross"} dicts, batch axis 0 throughout
            axes_of = (encdec.cache_batch_axes if self.cfg.is_encoder_decoder
                       else tfm.cache_batch_axes)
            self._axes = axes_of(self.cfg, proto)

        def mk(leaf, a):
            shape = list(leaf.shape)
            lanes = self._hi - self._lo     # this data shard's slots
            if leaf.ndim <= a:
                shape.append(lanes)
            else:
                shape[a] = lanes
            return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
        return tree_zip(mk, proto, self._axes)

    def _splice(self, slot_caches, caches, s: int) -> None:
        """Copy a single-request prefill cache into slot ``s``'s lanes,
        in place."""
        def sp(dst, src, a):
            src = src if src.ndim <= a else src.select(a, 0)
            dst.select(a, s).copy_(src)
        tree_zip(sp, slot_caches, caches, self._axes)

    def _frames(self, frames) -> torch.Tensor:
        """One request's encoder frames as a (1, T, d) float32 batch."""
        return torch.as_tensor(np.asarray(frames, np.float32)[None],
                               device=self.device)

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _plankw(self, gen: _Generation) -> dict:
        # plan= only when a plan exists, so prefill/decode fns that never
        # learned it keep working on unpruned engines
        return {} if gen.plan is None else {"plan": gen.plan}

    def _prefill_request(self, gen: _Generation, req: Request, rng,
                         s: int = 0):
        """Single-request prefill into slot ``s`` → (first token, caches,
        S); on a mesh only the slot's data shard runs it (caches None on
        the other ranks) and broadcasts the logits row.

        Bucketed and masked where the model supports it, else at the
        prompt's exact length (always with encoder frames, which ride in
        the batch as ``"frames"``).  ``S`` is the dense cache length: the
        padded prompt (paged: the cache lives only until it is scattered
        into pool blocks) or the engine's capacity (dense slots)."""
        prompt = np.asarray(req.prompt, np.int64)
        n = len(prompt)
        owner_d = s * self._dp // self.slots
        owner = self._owns(s)
        batch = {}
        if req.frames is not None:
            batch["frames"] = self._frames(req.frames)
        if self._masked_prefill and req.frames is None:
            S = self._bucket(n)
            toks = np.zeros((1, S), np.int64)
            toks[0, :n] = prompt                            # right-pad
            kw = dict(valid_len=torch.tensor([n], dtype=torch.int32,
                                             device=self.device))
        else:
            S = n
            toks, kw = prompt[None], {}
        cap = S if self.paged else self.capacity
        batch["tokens"] = torch.as_tensor(toks, device=self.device)
        caches = None
        if owner:
            with self._scope(gen):
                logits, caches = self._prefill_fn(gen.params, gen.cfg, batch,
                                                  cap, **kw,
                                                  **self._plankw(gen))
            row = logits[0, -1].float()
        else:
            row = torch.empty((self.cfg.padded_vocab,), dtype=torch.float32,
                              device=self.device)
        if self._dp > 1:            # the owner's row to every data rank
            tpar.collective("broadcast", row, self._data_group,
                            src=torch.distributed.get_global_rank(
                                self._data_group, owner_d))
        row = row.cpu().numpy()
        if self.logits_sink is not None:
            self.logits_sink(req.uid, row)
        return self._sample_row(row, rng), caches, cap

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

    def expire(self, req: Request) -> None:
        """Mark a not-yet-admitted request deadline-expired (the front-end's
        wait-queue sweep books misses here so the report counts each
        once)."""
        self._deadline_misses += 1
        self._finish(req, "expired")

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

    def _free_slot(self, gen: _Generation, s: int) -> None:
        """Release a slot and its paged-KV state: blocks go back to the
        generation's pool, the table row resets to the scratch block, the
        length to zero."""
        req = gen.slot_reqs[s]
        if gen.pool is not None and req is not None:
            gen.pool.release(req.uid)
            gen.tables[s, :] = 0
            gen.lens[s] = 0
            gen.slot_nblocks[s] = 0
        gen.free_slot(s)

    def _expire_slots(self, out: List[Request]) -> None:
        for gen in self._gens:
            for s in range(self.slots):
                req = gen.slot_reqs[s]
                if req is not None and self._expired(req):
                    self._deadline_misses += 1
                    self._finish(req, "expired", out)
                    self._free_slot(gen, s)

    # -- the scheduler -----------------------------------------------------
    def _adopt_request(self, gen: _Generation, req: Request, s: int,
                       caches, n: int, S: int) -> None:
        """Scatter a request's prefill caches into blocks drawn from its
        reservation and point slot ``s``'s table row at them; entries
        past the prompt (the padded bucket tail) go to the scratch block,
        where ``lens`` masks them."""
        nb_real = blocks_needed(n, BLOCK_TOKENS)
        nb_total = blocks_needed(S, BLOCK_TOKENS)
        blocks = [gen.pool.alloc(req.uid) for _ in range(nb_real)]
        blocks += [0] * (nb_total - nb_real)
        if caches is not None:          # this rank's data shard owns s
            self.adopt(gen, caches, blocks)
        gen.tables[s, :] = 0
        gen.tables[s, :nb_real] = blocks[:nb_real]
        gen.lens[s] = n
        gen.slot_nblocks[s] = nb_real

    def adopt(self, gen: _Generation, caches, blocks) -> None:
        """Copy a single-request prefill cache (capacity = its padded
        length S) into ``gen``'s pool at ``blocks``, ⌈S/BLOCK⌉ physical
        ids in logical order, in place: the copy every admission makes
        (``_adopt_request``), callable without a request."""
        tfm.adopt_prefill(gen.cfg, gen.paged_caches, caches, blocks)

    def _refill(self, out: List[Request]) -> None:
        gen = self._gens[-1]            # admissions target: newest ticket
        for s in range(self.slots):
            while gen.slot_reqs[s] is None and self.queue:
                req = self.queue.popleft()
                if self._expired(req):
                    self._deadline_misses += 1
                    self._finish(req, "expired", out)
                    continue
                n = len(req.prompt)
                if gen.pool is not None:
                    # the request enters a slot only when its whole block
                    # budget can be reserved; short on blocks, it waits
                    # at the FIFO head until finished requests free theirs
                    need = blocks_needed(n + req.max_new_tokens,
                                         BLOCK_TOKENS)
                    if not gen.pool.can_reserve(need):
                        self.queue.appendleft(req)
                        return
                    gen.pool.reserve(req.uid, need)
                rng = self._rng_for(req)
                tok, caches, S = self._prefill_request(gen, req, rng, s)
                self._prefills += 1
                gen.served += 1
                req.generation = gen.gid
                req.status = "active"
                self._emit_token(req, tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or req.max_new_tokens <= 1):
                    if gen.pool is not None:
                        gen.pool.release(req.uid)
                    self._finish(req, "done", out)   # done at prefill
                    continue
                if gen.pool is not None:
                    self._adopt_request(gen, req, s, caches, n, S)
                elif caches is not None:
                    if gen.slot_caches is None:
                        gen.slot_caches = self._empty_slot_caches(caches)
                    self._splice(gen.slot_caches, caches, s - self._lo)
                gen.slot_reqs[s] = req
                gen.slot_rngs[s] = rng
                gen.cur[s] = tok
        self._kv_peak = max(self._kv_peak, self.kv_blocks_live)

    def _decode_gen(self, gen: _Generation, out: List[Request]) -> None:
        active = [s for s in range(self.slots)
                  if gen.slot_reqs[s] is not None]
        if not active:
            return
        dev = self.device
        lo, hi = self._lo, self._hi     # this rank's slots (all: meshless)
        # a data shard whose own slots are all idle (or, on dense slots,
        # have never held a request) computes nothing this tick
        mine = any(lo <= s < hi for s in active) and (
            gen.pool is not None or gen.slot_caches is not None)
        # copy the host-side arrays at the device boundary: on the CPU
        # torch.as_tensor would alias the numpy buffers the scheduler
        # mutates in place below
        tok = torch.as_tensor(gen.cur[lo:hi, None].copy(), device=dev)
        if gen.pool is not None:
            # alloc-on-append: the block the new token lands in must exist
            # before the decode step writes it (drawn from the reservation)
            for s in active:
                req = gen.slot_reqs[s]
                while gen.slot_nblocks[s] <= gen.lens[s] // BLOCK_TOKENS:
                    pid = gen.pool.alloc(req.uid)
                    gen.tables[s, gen.slot_nblocks[s]] = pid
                    gen.slot_nblocks[s] += 1
            self._kv_peak = max(self._kv_peak, self.kv_blocks_live)
            if mine:
                with self._scope(gen, groups=1):
                    logits, gen.paged_caches = tfm.decode_step_paged(
                        gen.params, gen.cfg, gen.paged_caches, tok,
                        torch.as_tensor(gen.tables[lo:hi].copy(), device=dev),
                        torch.as_tensor(gen.lens[lo:hi].copy(), device=dev),
                        **self._plankw(gen))
            # analytic bytes: the kernel reads ceil((len+1)/BLOCK) live
            # blocks per active row
            self._kv_bytes += self._block_bytes * sum(
                blocks_needed(int(gen.lens[s]) + 1, BLOCK_TOKENS)
                for s in active)
            self._kv_tokens += len(active)
            gen.lens[active] += 1
        elif mine:
            with self._scope(gen, groups=1):
                logits, gen.slot_caches = self._decode_fn(
                    gen.params, gen.cfg, gen.slot_caches, tok,
                    **self._plankw(gen))
        self._decode_steps += 1
        self._busy_acc += len(active)
        rows = (logits[:, 0].float() if mine else torch.zeros(
            (hi - lo, self.cfg.padded_vocab), dtype=torch.float32,
            device=dev))
        if self._dp > 1:                # every data shard's rows, in order
            rows = tpar.collective("all_gather", rows, self._data_group,
                                   dim=0)
        logits_h = rows.cpu().numpy()
        for s in active:
            req = gen.slot_reqs[s]
            if self.logits_sink is not None:
                self.logits_sink(req.uid, logits_h[s])
            t = self._sample_row(logits_h[s], gen.slot_rngs[s])
            self._emit_token(req, t)
            gen.cur[s] = t
            if ((req.eos_id is not None and t == req.eos_id)
                    or len(req.tokens) >= req.max_new_tokens):
                self._finish(req, "done", out)
                self._free_slot(gen, s)  # refilled next tick

    def step(self) -> List[Request]:
        """One scheduler tick: deadline sweep, slot refill (newest
        generation), one decode step per generation with live slots,
        retire drained generations, heartbeat.  Returns the requests
        that finished this tick."""
        if self._t0 is None:
            self._t0 = self.clock()
        out: List[Request] = []
        with torch.inference_mode():
            self._expire_queue(out)
            self._expire_slots(out)
            if self.queue:
                self._refill(out)
            for gen in list(self._gens):
                self._decode_gen(gen, out)
        newest = self._gens[-1]
        self._gens = [g for g in self._gens
                      if g is newest or g.active_count()]
        self._t_last = self.clock()
        if self.heartbeat is not None:
            self.heartbeat.beat(self.heartbeat_worker)
        return out

    @property
    def idle(self) -> bool:
        return not self.queue and all(g.active_count() == 0
                                      for g in self._gens)

    @property
    def kv_blocks_live(self) -> int:
        """Blocks holding live context, summed over live generations."""
        return sum(g.pool.live for g in self._gens if g.pool is not None)

    def run(self) -> List[Request]:
        """Serve everything in the queue to completion; returns the
        requests that finished during this call."""
        start = len(self._finished)
        while not self.idle:
            self.step()
        return self._finished[start:]

    # -- verification ------------------------------------------------------
    def smoke_decode(self, prompt, max_new: int, *,
                     gid: Optional[int] = None, frames=None) -> List[int]:
        """Greedy-decode one probe prompt through a generation's prefill
        and dense decode WITHOUT touching slot state or the queue — the
        ticket manager verifies a swapped-in generation against the
        ticket's recorded fingerprint before committing to it.  A probe
        longer than ``capacity`` (possible with paged admission) runs
        through a dense cache sized to it.  ``frames`` (enc-dec) ride in
        the prefill batch, as in the frames lane."""
        gen = self._gens[-1] if gid is None else self._gen_by_gid(gid)
        prompt = np.asarray(prompt, np.int64)
        cap = max(self.capacity, len(prompt) + max_new)
        kw = self._plankw(gen)
        with torch.inference_mode(), self._scope(gen):
            batch = {"tokens": torch.as_tensor(prompt[None],
                                               device=self.device)}
            if frames is not None:
                batch["frames"] = self._frames(frames)
            logits, caches = self._prefill_fn(gen.params, gen.cfg, batch,
                                              cap, **kw)
            tok = int(np.argmax(logits[0, -1].float().cpu().numpy()))
            out = [tok]
            for _ in range(max_new - 1):
                logits, caches = self._decode_fn(
                    gen.params, gen.cfg, caches,
                    torch.tensor([[tok]], device=self.device), **kw)
                tok = int(np.argmax(logits[0, 0].float().cpu().numpy()))
                out.append(tok)
        return out

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
        cur = self._gens[-1]
        st = cur.plan_stats
        return ServeReport(
            requests=len(fin),
            prefills=self._prefills,
            decode_steps=self._decode_steps,
            tokens_generated=self._tokens,
            slot_occupancy=(self._busy_acc / (self._decode_steps * self.slots)
                            if self._decode_steps else 0.0),
            wall_s=wall,
            tokens_per_s=self._tokens / wall if wall > 0 else 0.0,
            bsmm_enabled=cur.plan is not None,
            routed_matmuls=st.routed,
            live_tiles=st.live_tiles,
            total_tiles=st.total_tiles,
            skipped_tile_fraction=st.skipped_tile_fraction,
            ttft_p50=_pct(ttft, 50), ttft_p95=_pct(ttft, 95),
            tps_p50=_pct(tps, 50), tps_p95=_pct(tps, 95),
            deadline_misses=self._deadline_misses,
            swaps=self._swaps,
            paged=self.paged,
            kv_blocks=self.kv_blocks,
            kv_blocks_live=self.kv_blocks_live,
            kv_blocks_peak=self._kv_peak,
            kv_block_bytes=self._block_bytes,
            kv_bytes_per_token=(self._kv_bytes / self._kv_tokens
                                if self._kv_tokens else 0.0),
        )
