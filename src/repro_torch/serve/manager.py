"""Ticket manager: register exported tickets, verify, hot-swap live (a
port of ``repro.serve.manager``).

The deployment half of the lottery-ticket story: ``prune --ticket``
exports ``(w_init, masks)`` with the resolved recipe + quantize bits
embedded, and this module turns those directories into *serveable,
verified, swappable* artifacts:

* ``load_ticket`` — ticket dir → (rewound params, masks, meta), with
  the stored mask keys/shapes validated against the serving config's
  template FIRST (``import_ticket`` silently skips mismatched keys,
  which would otherwise surface as a deep traceback much later).
* ``TicketManager.register`` — loads a candidate, rejects arch/recipe
  mismatches against the running config (``TicketError`` with a
  machine-readable ``reason``), and records its **accuracy
  fingerprint**: the greedy smoke-decode of a fixed probe prompt
  through a throwaway engine.  Greedy decode is deterministic, so the
  fingerprint pins the ticket's end-to-end numerics (params ⊙ masks,
  tile plans, cache layout) in a handful of tokens.
* ``TicketManager.swap`` — installs the candidate into a LIVE engine as
  a new generation (``ServeEngine.swap``: in-flight requests keep
  decoding on the old ticket, new admissions prefill on the new one),
  re-runs the smoke-decode *through the swapped-in generation*, and
  rolls the generation back if it disagrees with the recorded
  fingerprint.  Traffic is never drained either way.

The manager sits below the adapter layer (it needs only a params
template + prunable predicate + prefill/decode fns); every engine it
builds runs on ``device`` (default ``"cuda"``), where the template
lives.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import lottery
from repro_torch.core.masks import make_masks, tree_flatten_with_path
from repro_torch.serve.engine import ServeEngine


class TicketError(RuntimeError):
    """Ticket rejected at registration/verification.

    ``reason``: ``"shape_mismatch"`` (stored masks do not fit the
    serving config's template), ``"arch_mismatch"`` (ticket metadata
    names a different arch), ``"recipe_mismatch"`` (manager requires a
    specific recipe), ``"unknown_ticket"`` (swap of an unregistered
    name)."""

    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


class TicketMismatch(TicketError):
    """Ticket on disk does not fit the serving parameter template
    (usually pruned at a different --scale or --arch)."""

    def __init__(self, message: str):
        super().__init__("shape_mismatch", message)


def load_ticket(path: str, params_template, prunable,
                arch_name: str = "?"):
    """Ticket dir → (rewound params, masks, meta) shaped like the
    template.  Raises ``TicketMismatch`` when the stored mask
    keys/shapes disagree with ``make_masks(params_template, prunable)``.
    """
    masks_tmpl = make_masks(params_template, prunable)
    tmpl_shapes = {f"m:{p}": tuple(leaf.shape)
                   for p, leaf in tree_flatten_with_path(masks_tmpl)
                   if leaf is not None}
    data = np.load(os.path.join(path, "ticket.npz"))
    stored = {k: tuple(data[k].shape) for k in data.files
              if k.startswith("m:")}
    if stored != tmpl_shapes:
        missing = sorted(set(tmpl_shapes) - set(stored))
        extra = sorted(set(stored) - set(tmpl_shapes))
        wrong = sorted(k for k in set(stored) & set(tmpl_shapes)
                       if stored[k] != tmpl_shapes[k])
        raise TicketMismatch(
            f"ticket at {path} does not match {arch_name}: "
            f"{len(missing)} masks missing, {len(extra)} unexpected, "
            f"{len(wrong)} wrong-shaped"
            + (f" (e.g. {wrong[0]}: {stored[wrong[0]]} vs "
               f"{tmpl_shapes[wrong[0]]})" if wrong else "")
            + " — was it pruned at a different --scale or --arch?")
    w, m = lottery.import_ticket(path, params_template, masks_tmpl)
    return lottery.rewind(w, m), m, lottery.ticket_meta(path)


@dataclass
class TicketRecord:
    """A registered, verified, fingerprinted ticket."""
    name: str
    path: str
    meta: dict
    params: Any
    masks: Any
    fingerprint: Tuple[int, ...]

    @property
    def recipe_name(self) -> Optional[str]:
        return (self.meta.get("recipe") or {}).get("name")

    @property
    def sparsity(self) -> Optional[float]:
        return self.meta.get("sparsity")


@dataclass
class SwapEvent:
    """Outcome of one hot-swap attempt (kept in ``history``)."""
    ticket: str
    gid: int
    accepted: bool
    reason: str = "ok"
    expected: Tuple[int, ...] = ()
    observed: Tuple[int, ...] = ()
    skipped_tile_fraction: float = 0.0
    engine: Optional[int] = None    # fleet swaps: which engine index


@dataclass
class FleetSwapEvent:
    """Outcome of one all-or-nothing fleet-wide swap.

    ``accepted`` iff EVERY live engine verified the candidate; when any
    engine's smoke-decode disagrees with the fingerprint, the engines
    already swapped are rolled back (``rolled_back``) and the fleet
    keeps serving the previous ticket everywhere — the fleet never
    splits across tickets."""
    ticket: str
    accepted: bool
    events: List[SwapEvent] = field(default_factory=list)
    rolled_back: int = 0
    reason: str = "ok"

    @property
    def gid(self) -> int:
        return self.events[0].gid if self.events else -1


class TicketManager:
    """Registry + verifier + hot-swapper for exported tickets.

    ``probe_prompt``/``probe_tokens`` define the accuracy fingerprint
    (greedy smoke-decode); for encoder-decoder configs a deterministic
    ``probe_frames`` is generated so the probe exercises the full
    frames→tokens lane.  ``expect_recipe`` (optional) pins deployments
    to one recipe name: candidates pruned with anything else are
    rejected at ``register`` time.
    """

    def __init__(self, *, cfg, params_template, prunable,
                 prefill_fn: Callable, decode_fn: Callable,
                 probe_prompt=None, probe_tokens: int = 8,
                 probe_frames=None, expect_recipe: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = device
        self.params_template = params_template
        self.prunable = prunable
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        if probe_prompt is None:
            vocab = int(getattr(cfg, "vocab_size", 256) or 256)
            probe_prompt = (np.arange(1, 9) % max(vocab - 1, 1) + 1)
        self.probe_prompt = np.asarray(probe_prompt, np.int32)
        self.probe_tokens = probe_tokens
        if probe_frames is None and getattr(cfg, "is_encoder_decoder",
                                            False):
            rng = np.random.RandomState(0)
            probe_frames = rng.randn(cfg.encoder_seq_len,
                                     cfg.d_model).astype(np.float32) * 0.1
        self.probe_frames = probe_frames
        self.expect_recipe = expect_recipe
        self.tickets: Dict[str, TicketRecord] = {}
        self.active: Optional[str] = None
        self.history: List[SwapEvent] = []

    @classmethod
    def from_adapter(cls, adapter, *, seed: int = 0, **kw):
        """Build a manager for a registry adapter's serving surface (on
        the adapter's device)."""
        import torch
        prefill_fn, decode_fn = adapter.serve_fns()
        gen = torch.Generator(device=adapter.device).manual_seed(seed)
        return cls(cfg=adapter.cfg, params_template=adapter.init_params(gen),
                   prunable=adapter.prunable,
                   prefill_fn=prefill_fn, decode_fn=decode_fn,
                   device=adapter.device, **kw)

    # -- fingerprinting ----------------------------------------------------
    def _probe_engine(self, params, masks) -> ServeEngine:
        cap = len(self.probe_prompt) + self.probe_tokens + 1
        return ServeEngine(params=params, cfg=self.cfg,
                           prefill_fn=self.prefill_fn,
                           decode_fn=self.decode_fn,
                           batch_slots=1, capacity=cap, masks=masks,
                           device=self.device)

    def fingerprint(self, params, masks) -> Tuple[int, ...]:
        """Greedy smoke-decode of the probe prompt on a throwaway
        engine — the reference the live swapped-in generation must
        reproduce exactly."""
        eng = self._probe_engine(params, masks)
        return tuple(eng.smoke_decode(self.probe_prompt,
                                      self.probe_tokens,
                                      frames=self.probe_frames))

    # -- registration ------------------------------------------------------
    def register(self, name: str, path: str) -> TicketRecord:
        """Load + verify a ticket against the running config.

        Raises ``TicketMismatch`` on shape mismatch and ``TicketError``
        (reasons ``"arch_mismatch"`` / ``"recipe_mismatch"``) on
        metadata disagreement."""
        params, masks, meta = load_ticket(
            path, self.params_template, self.prunable,
            arch_name=getattr(self.cfg, "name", "?"))
        meta = meta or {}
        arch = meta.get("arch")
        cfg_name = getattr(self.cfg, "name", None)
        if arch is not None and cfg_name is not None and arch != cfg_name:
            raise TicketError(
                "arch_mismatch",
                f"ticket {name!r} was pruned on arch {arch!r}; this "
                f"engine serves {cfg_name!r}")
        if self.expect_recipe is not None:
            rname = (meta.get("recipe") or {}).get("name")
            if rname != self.expect_recipe:
                raise TicketError(
                    "recipe_mismatch",
                    f"ticket {name!r} came from recipe {rname!r}; this "
                    f"deployment requires {self.expect_recipe!r}")
        rec = TicketRecord(name=name, path=path, meta=meta,
                           params=params, masks=masks,
                           fingerprint=self.fingerprint(params, masks))
        self.tickets[name] = rec
        return rec

    # -- serving -----------------------------------------------------------
    def make_engine(self, name: str, **engine_kw) -> ServeEngine:
        """Fresh engine serving a registered ticket."""
        rec = self._require(name)
        eng = ServeEngine(params=rec.params, cfg=self.cfg,
                          prefill_fn=self.prefill_fn,
                          decode_fn=self.decode_fn,
                          masks=rec.masks, device=self.device, **engine_kw)
        self.active = name
        return eng

    def _require(self, name: str) -> TicketRecord:
        if name not in self.tickets:
            raise TicketError(
                "unknown_ticket",
                f"ticket {name!r} is not registered "
                f"(have: {sorted(self.tickets)})")
        return self.tickets[name]

    def _swap_engine(self, engine: ServeEngine, name: str,
                     rec: TicketRecord,
                     engine_idx: Optional[int] = None) -> SwapEvent:
        """Install + verify on ONE engine (no manager state touched)."""
        gid = engine.swap(rec.params, masks=rec.masks)
        observed = tuple(engine.smoke_decode(self.probe_prompt,
                                             self.probe_tokens, gid=gid,
                                             frames=self.probe_frames))
        if observed != rec.fingerprint:
            engine.rollback(gid)
            return SwapEvent(
                ticket=name, gid=gid, accepted=False,
                reason="smoke-decode disagrees with recorded accuracy "
                       "fingerprint — rolled back",
                expected=rec.fingerprint, observed=observed,
                skipped_tile_fraction=engine.report.skipped_tile_fraction,
                engine=engine_idx)
        return SwapEvent(
            ticket=name, gid=gid, accepted=True,
            expected=rec.fingerprint, observed=observed,
            skipped_tile_fraction=engine.report.skipped_tile_fraction,
            engine=engine_idx)

    def swap(self, target, name: str):
        """Hot-swap a registered ticket into a live engine/front-end —
        or across a whole fleet.

        Single engine: installs the candidate as a new generation
        (traffic keeps flowing), smoke-decodes the probe THROUGH that
        generation, and rolls back if the output disagrees with the
        fingerprint recorded at registration.  The scheduler is not
        stepped between install and verdict, so a rolled-back
        generation never serves a request.  Returns a ``SwapEvent``.

        Fleet (``target`` exposes ``swap_targets()``, e.g.
        ``serve.fleet.FleetRouter``): the same install+verify fans over
        every live engine, ALL-OR-NOTHING — the first verification
        failure rolls back every engine already swapped, so the fleet
        never serves two tickets at once.  Zero-drain either way:
        in-flight requests finish on the generation that prefilled
        them.  Returns a ``FleetSwapEvent``."""
        rec = self._require(name)
        targets = getattr(target, "swap_targets", None)
        if targets is not None:
            committed: List[Tuple[ServeEngine, int]] = []
            events: List[SwapEvent] = []
            accepted = True
            for idx, engine in targets():
                ev = self._swap_engine(engine, name, rec, engine_idx=idx)
                events.append(ev)
                if not ev.accepted:
                    accepted = False
                    break
                committed.append((engine, ev.gid))
            if accepted:
                self.active = name
                fev = FleetSwapEvent(ticket=name, accepted=True,
                                     events=events)
            else:
                for engine, gid in reversed(committed):
                    engine.rollback(gid)
                fev = FleetSwapEvent(
                    ticket=name, accepted=False, events=events,
                    rolled_back=len(committed),
                    reason=f"engine {events[-1].engine} failed "
                           "verification — fleet rolled back")
            self.history.append(fev)
            return fev
        engine: ServeEngine = getattr(target, "engine", target)
        ev = self._swap_engine(engine, name, rec)
        if ev.accepted:
            self.active = name
        self.history.append(ev)
        return ev
