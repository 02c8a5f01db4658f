"""PruningSession: staged prune programs (recipes) as a resumable,
observable session (port of ``repro.api.session``).

    adapter = make_adapter("vgg11", scale="full", batch_size=128)
    session = PruningSession(adapter, PruneConfig(), ckpt_dir="/ckpt/prune")
    result = session.run()          # recipe interpreter, resumable

The session interprets a ``api.recipes.Recipe`` — an ordered tuple of
stages (``prune`` at one granularity, ``quantize`` for a
quantization-aware retrain, ``ablate`` for the schedule-ablation
sweep) — and owns the loop state (stage cursor ``(stage_idx, step)``,
masks, baseline accuracy, event history).  State checkpoints through
``CheckpointManager`` after every round, so a run killed mid-stage
resumes from the last completed round.  Each round emits a
``PruneEvent`` to registered callbacks.

Recipe resolution order (first match wins): explicit ``recipe=``,
explicit ``granularities=``, ``cfg.recipe``, ``adapter.recipe`` (the
family-tuned recipe), ``adapter.granularities``, ``cfg.granularities``.

Crossbar geometry comes from ``PruneConfig.xbar_rows/xbar_cols`` and is
threaded into scoring, zeroing and the hardware report.  Masks are
float32 tensors on the adapter's device; pruning decisions run on the
host (``core.algorithm.prune_step``).  The reference seeds
``jax.random.PRNGKey(seed)``; the port draws its initial weights from a
``torch.Generator`` seeded with ``seed``, so the values differ by design.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, pack_json, unpack_json
from repro_torch.configs.base import PruneConfig
from repro_torch.core import lottery
from repro_torch.core.algorithm import PruneEvent, PruneResult, prune_step
from repro_torch.core.hardware import HWReport, analyze_masks
from repro_torch.core.masks import apply_masks, make_masks, sparsity_fraction
from repro_torch.core.quantize import fake_quantize_tree
from repro_torch.core.strategies import TileGeometry

log = logging.getLogger("realprune.session")

_STATE_FIELDS = ("stage_idx", "step", "itr", "prune_rounds")
# checkpoint layout version: bump when the saved keys/encoding change.
# Missing template keys restore as template zeros (checkpoint.manager
# fills by path), so an explicit marker is the ONLY reliable way to
# tell an older-layout checkpoint from a fresh one.
_CKPT_FMT = 2


def structured_prune(params, schedule: Sequence[Tuple[str, float]], *,
                     prunable: Callable, conv_pred: Callable = None,
                     cfg: Optional[PruneConfig] = None, block: int = 32):
    """One-shot crossbar-aware pruning: apply a fixed (granularity,
    fraction) schedule to trained weights without the accuracy gate.

    The config's crossbar geometry drives every step.  Returns masks.
    """
    cfg = cfg or PruneConfig()
    geom = TileGeometry.from_config(cfg)
    conv_pred = conv_pred or (lambda p: False)
    masks = make_masks(params, prunable)
    for gran, frac in schedule:
        masks = prune_step(params, masks, gran, frac, conv_pred,
                           block=block, geometry=geom)
    return masks


def _resolve_session_recipe(recipe, granularities, adapter, cfg):
    from repro_torch.api import recipes as rcp

    if recipe is not None:
        return rcp.resolve_recipe(recipe)
    # flat schedules compile with the config's per-round fraction —
    # the legacy knob keeps steering the legacy surface
    rate = cfg.prune_fraction
    if granularities:
        return rcp.from_granularities(granularities, rate=rate)
    # cfg.recipe defaults to None, so when set it is caller intent and
    # outranks the family registry's default recipe/schedule
    if getattr(cfg, "recipe", None):
        return rcp.resolve_recipe(cfg.recipe)
    a_recipe = getattr(adapter, "recipe", None)
    if a_recipe is not None:
        return rcp.resolve_recipe(a_recipe)
    a_grans = getattr(adapter, "granularities", None)
    if a_grans:
        return rcp.from_granularities(a_grans, rate=rate,
                                      name="family-schedule")
    return rcp.from_granularities(cfg.granularities, rate=rate,
                                  name="config-schedule")


class PruningSession:
    """Interpret a prune recipe over a ``ModelAdapter`` with resume +
    streaming events."""

    def __init__(self, adapter, cfg: Optional[PruneConfig] = None, *,
                 recipe=None,
                 granularities: Optional[Sequence[str]] = None,
                 baseline_accuracy: Optional[float] = None,
                 seed: int = 0, block: int = 32,
                 ckpt_dir: Optional[str] = None, keep: int = 3,
                 callbacks: Sequence[Callable[[PruneEvent], None]] = ()):
        self.adapter = adapter
        self.cfg = cfg or PruneConfig()
        self.geometry = TileGeometry.from_config(self.cfg)
        self.recipe = _resolve_session_recipe(recipe, granularities,
                                              adapter, self.cfg)
        self.baseline_accuracy = baseline_accuracy
        self.seed = seed
        self.block = block
        self.callbacks = list(callbacks)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep,
                                       async_save=False)
                     if ckpt_dir else None)
        self.result: Optional[PruneResult] = None
        # bits of the last ACCEPTED quantize stage (None until one runs)
        self.quantize_bits: Optional[int] = None
        # live view of the committed masks while run() is in flight
        # (callbacks read this for per-stage accounting)
        self.masks = None
        self._w_init = None

    @property
    def grans(self) -> List[str]:
        """Prune-stage granularities in program order (legacy surface)."""
        return list(self.recipe.prune_granularities)

    # -- checkpoint plumbing ----------------------------------------------
    def _save(self, state: dict, masks, baseline, history):
        if self.ckpt is None:
            return
        self.ckpt.save(state["itr"], {
            "fmt": np.asarray(_CKPT_FMT, np.int64),
            "masks": masks,
            "state": np.asarray([state[f] for f in _STATE_FIELDS],
                                np.int64),
            # float64 on purpose: a float32 baseline would downcast on
            # restore and could flip the ``acc >= baseline - tol`` gate
            "baseline": np.asarray(baseline, np.float64),
            "hist": pack_json([dataclasses.asdict(e) for e in history]),
            "recipe": pack_json(self.recipe.to_dict())}, blocking=True)

    def _restore(self, masks_template):
        if self.ckpt is None:
            return None
        # numpy templates restore as the stored arrays; byte-array
        # templates take their shape from disk, so variable-length JSON
        # payloads (history, recipe) round-trip losslessly
        tmpl = {"fmt": np.zeros((), np.int64),
                "masks": masks_template,
                "state": np.zeros((len(_STATE_FIELDS),), np.int64),
                "baseline": np.zeros((), np.float64),
                "hist": np.zeros((0,), np.uint8),
                "recipe": np.zeros((0,), np.uint8)}
        step, tree = self.ckpt.restore(tmpl)
        if step is None:
            return None
        if int(np.asarray(tree["fmt"])) != _CKPT_FMT:
            raise ValueError(
                f"session checkpoint at {self.ckpt.root} uses an older "
                f"(pre-recipe) or unknown layout — resuming it would "
                f"silently re-prune already-pruned masks; finish it with "
                f"the code that wrote it, or start over with a fresh "
                f"ckpt_dir")
        stored = unpack_json(tree["recipe"], default=None)
        if stored is not None and stored != self.recipe.to_dict():
            same_name = stored.get("name") == self.recipe.name
            raise ValueError(
                f"checkpoint at {self.ckpt.root} was written by recipe "
                f"{stored.get('name')!r}, but this session runs "
                f"{self.recipe.name!r}"
                + (" (same name, different stage parameters — e.g. a "
                   "--steps override rewrites per-stage retrain "
                   "budgets)" if same_name else "")
                + "; resuming a different program would corrupt the "
                "run history — pass the original recipe or a fresh "
                "ckpt_dir")
        history = [PruneEvent(**d)
                   for d in unpack_json(tree["hist"], default=[])]
        state = dict(zip(_STATE_FIELDS,
                         (int(v) for v in np.asarray(tree["state"]))))
        log.info("resumed pruning session at stage %d step %d "
                 "(%d events, sparsity %.3f)", state["stage_idx"],
                 state["step"], len(history),
                 sparsity_fraction(tree["masks"]))
        return state, tree["masks"], float(tree["baseline"]), history

    # -- the interpreter ---------------------------------------------------
    def _gate(self, stage) -> float:
        return (self.cfg.accuracy_tolerance if stage.accuracy_drop is None
                else stage.accuracy_drop)

    def _emit(self, event: PruneEvent, history: List[PruneEvent]):
        history.append(event)
        log.info("iter %d [%s/%s] sparsity %.3f->%.3f acc %.4f (%s)",
                 event.iteration, event.stage, event.granularity,
                 event.sparsity_before, event.sparsity_after,
                 event.accuracy,
                 "keep" if event.accepted else
                 ("scored" if event.kind == "ablate" else "undo"))

    def run(self, gen: Optional[torch.Generator] = None) -> PruneResult:
        """Run (or resume) the recipe to completion.  ``gen`` (default: a
        generator on the adapter's device seeded with ``seed``) draws the
        initial weights."""
        adapter = self.adapter
        stages = self.recipe.stages
        if gen is None:
            gen = torch.Generator(
                device=getattr(adapter, "device", "cpu")).manual_seed(
                    self.seed)
        w_init = adapter.init_params(gen)                   # t=0 snapshot
        self._w_init = w_init
        masks = make_masks(w_init, adapter.prunable)
        state = dict.fromkeys(_STATE_FIELDS, 0)
        history: List[PruneEvent] = []
        baseline = self.baseline_accuracy
        self.quantize_bits = None

        restored = self._restore(masks)
        if restored is not None:
            state, masks, baseline, history = restored
            for e in history:       # re-derive accepted-quantize state
                if e.kind == "quantize" and e.accepted:
                    self.quantize_bits = stages[e.stage_idx].bits
        elif baseline is None:
            trained = adapter.train(w_init, masks)          # dense baseline
            baseline = float(adapter.evaluate(trained, masks))
            log.info("baseline accuracy: %.4f", baseline)
            self._save(state, masks, baseline, history)

        self.masks = masks
        params = apply_masks(w_init, masks)
        while state["stage_idx"] < len(stages):
            stage = stages[state["stage_idx"]]
            fresh = []
            if stage.kind == "prune":
                masks, params, done = self._prune_round(
                    stage, state, w_init, params, masks, baseline,
                    history, fresh)
            elif stage.kind == "quantize":
                done = self._quantize_round(stage, state, params, masks,
                                            baseline, history, fresh)
            else:
                done = self._ablate_round(stage, state, params, masks,
                                          history, fresh)
            if done:
                state["stage_idx"] += 1
                state["step"] = 0
            self.masks = masks
            self._save(state, masks, baseline, history)
            for e in fresh:
                for cb in self.callbacks:
                    cb(e)
        final_params = apply_masks(w_init, masks)
        self.result = PruneResult(masks=masks, params=final_params,
                                  history=history,
                                  recipe=self.recipe.to_dict())
        return self.result

    # -- stage bodies ------------------------------------------------------
    def _prune_round(self, stage, state, w_init, params, masks, baseline,
                     history, fresh):
        """One train→prune→gate round; Algorithm 1 lines 3-8."""
        cfg, adapter = self.cfg, self.adapter
        if state["prune_rounds"] >= cfg.max_iters:
            # global prune budget spent: skip remaining prune stages
            # (quantize/ablate stages still run)
            return masks, params, True
        state["itr"] += 1
        state["prune_rounds"] += 1
        state["step"] += 1
        trained = adapter.train(params, masks,
                                stage.retrain_steps)        # line 3
        # adapters that retrain through the block-sparse kernel rebuild
        # their plan from the current masks each round, so each deeper
        # prune round retrains with fewer tile passes
        pstats = getattr(adapter, "last_plan_stats", None)
        if pstats is not None and pstats.routed:
            log.info("iter %d retrain: %d matmuls block-sparse, "
                     "%.1f%% tiles skipped", state["itr"], pstats.routed,
                     100.0 * pstats.skipped_tile_fraction)
        cand = prune_step(trained, masks, stage.granularity,  # line 4
                          stage.rate, adapter.conv_pred,
                          block=self.block, geometry=self.geometry)
        cand_params = apply_masks(trained, cand)
        acc = float(adapter.evaluate(cand_params, cand))      # line 5
        s_before = sparsity_fraction(masks)
        s_after = sparsity_fraction(cand)
        ok = acc >= baseline - self._gate(stage)
        comm = getattr(adapter, "last_comm_stats", None) or {}
        if comm:
            log.info("iter %d retrain comm: %.1f%% of grads on the wire "
                     "(%.1f KiB/step)", state["itr"],
                     100.0 * comm["sent_fraction"],
                     comm["bytes_per_step"] / 1024.0)
        event = PruneEvent(state["itr"], stage.granularity, s_before,
                           s_after, acc, ok, stage=stage.name,
                           stage_idx=state["stage_idx"], kind="prune",
                           comm_sent_fraction=float(
                               comm.get("sent_fraction", 0.0)),
                           comm_bytes_per_step=int(
                               comm.get("bytes_per_step", 0)))
        self._emit(event, history)
        fresh.append(event)
        if ok:
            masks = cand
        done = (not ok                                       # lines 6-7
                or (stage.max_rounds is not None
                    and state["step"] >= stage.max_rounds)
                or (stage.target_sparsity is not None
                    and s_after >= stage.target_sparsity))
        params = apply_masks(w_init, masks)                  # line 8
        return masks, params, done

    def _quantize_round(self, stage, state, params, masks, baseline,
                        history, fresh):
        """Quantization-aware retrain of the current ticket, gated on
        its accuracy under fake quantization at ``stage.bits``."""
        adapter = self.adapter
        state["itr"] += 1
        state["step"] += 1
        trained = adapter.train(params, masks, stage.retrain_steps,
                                quantize_bits=stage.bits)
        q_params = fake_quantize_tree(trained, adapter.prunable,
                                      stage.bits)
        acc = float(adapter.evaluate(q_params, masks))
        s = sparsity_fraction(masks)
        ok = acc >= baseline - self._gate(stage)
        event = PruneEvent(state["itr"], f"int{stage.bits}", s, s, acc,
                           ok, stage=stage.name,
                           stage_idx=state["stage_idx"], kind="quantize")
        self._emit(event, history)
        fresh.append(event)
        if ok:
            self.quantize_bits = stage.bits
        return True

    def _ablate_round(self, stage, state, params, masks, history, fresh):
        """Schedule-ablation sweep: retrain once, score one prune round
        per granularity, commit NOTHING (masks are unchanged)."""
        adapter = self.adapter
        sweep = stage.granularities
        trained = adapter.train(params, masks, stage.retrain_steps)
        s_before = sparsity_fraction(masks)
        while state["step"] < len(sweep):
            g = sweep[state["step"]]
            state["itr"] += 1
            state["step"] += 1
            cand = prune_step(trained, masks, g, stage.rate,
                              adapter.conv_pred, block=self.block,
                              geometry=self.geometry)
            acc = float(adapter.evaluate(apply_masks(trained, cand),
                                         cand))
            event = PruneEvent(state["itr"], g, s_before,
                               sparsity_fraction(cand), acc, False,
                               stage=stage.name,
                               stage_idx=state["stage_idx"],
                               kind="ablate")
            self._emit(event, history)
            fresh.append(event)
        return True

    # -- handoffs ----------------------------------------------------------
    def _require_result(self) -> PruneResult:
        if self.result is None:
            raise RuntimeError("run() the session first")
        return self.result

    @property
    def init_params(self):
        """The t=0 snapshot the winning ticket rewinds to."""
        if self._w_init is None:
            raise RuntimeError("run() the session first")
        return self._w_init

    def ticket_meta(self) -> dict:
        """Metadata embedded in exported tickets: the resolved recipe
        (the reproducibility payload — rerunning it on the same config
        regenerates the ticket) plus the quantization outcome.

        ``arch`` is the session CONFIG's name for human provenance —
        for tiny-scale runs that is the scaled variant (e.g.
        ``vgg11-smoke``), not a registered arch id, so don't feed it
        back to ``make_adapter``; load tickets with the same
        ``--arch``/``--scale`` pair that pruned them (the CLI's shape
        validation catches mismatches).
        """
        res = self._require_result()
        return {"recipe": self.recipe.to_dict(),
                "quantize_bits": self.quantize_bits,
                "arch": getattr(self.adapter.cfg, "name", None),
                "sparsity": res.sparsity}

    def export_ticket(self, path: str) -> None:
        """Serialise the winning ticket (w_init, masks) — paper §V.C —
        with the resolved recipe embedded in its metadata."""
        res = self._require_result()
        lottery.export_ticket(path, lottery.snapshot(self._w_init),
                              res.masks, meta=self.ticket_meta())

    def finetune(self, steps: Optional[int] = None, **kwargs):
        """Continue training the ticket through the adapter's Trainer.

        After an accepted quantize stage the fine-tune stays
        quantization-aware (pass ``quantize_bits=None`` to opt out).
        """
        res = self._require_result()
        if self.quantize_bits is not None:
            kwargs.setdefault("quantize_bits", self.quantize_bits)
        return self.adapter.train(res.params, res.masks, steps, **kwargs)

    def serve_engine(self, *, batch_slots: int = 8, capacity: int = 512,
                     greedy: Optional[bool] = None, temperature: float = 0.0,
                     sample_seed: int = 0, use_bsmm: Optional[bool] = None):
        """Hand the pruned ticket straight to a ``ServeEngine`` on the
        adapter's device.

        The ticket's masks ride along, so the engine derives the
        per-layer 128×128 tile bitmaps and routes prefill AND decode
        projections through the block-sparse kernel (``use_bsmm=False``
        opts out).
        """
        from repro_torch.serve import ServeEngine
        res = self._require_result()
        prefill_fn, decode_fn = self.adapter.serve_fns()
        return ServeEngine(params=res.params, cfg=self.adapter.cfg,
                           prefill_fn=prefill_fn, decode_fn=decode_fn,
                           batch_slots=batch_slots, capacity=capacity,
                           greedy=greedy, temperature=temperature,
                           sample_seed=sample_seed, masks=res.masks,
                           use_bsmm=use_bsmm, device=self.adapter.device)

    def hardware_report(self, activation_volumes=None) -> HWReport:
        """Crossbar accounting of the final masks at the session's
        (config-driven) geometry.  When a quantize stage was accepted,
        the report carries the fixed-point width so its byte accounting
        (``HWReport.weight_bytes``) includes quantized storage."""
        res = self._require_result()
        return analyze_masks(res.masks, self.adapter.conv_pred,
                             activation_volumes=activation_volumes,
                             xbar_rows=self.geometry.rows,
                             xbar_cols=self.geometry.cols,
                             quant_bits=self.quantize_bits,
                             dtype=getattr(self.adapter.cfg, "dtype",
                                           None))
