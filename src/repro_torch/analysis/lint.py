"""The lint driver: one arch → one ``Report``, all analyzers (port of
``repro.analysis.lint``).

``lint_arch`` builds the real objects (adapter, masks, tile plans, a
live ``ServeEngine`` for serving families) exactly the way a run would,
in the reference's order, then verifies them and runs the hot paths
once under the dispatch audit:

  1. recipe lint — the family's tuned recipe (or an explicit one)
     against the family's capabilities (R-rules);
  2. invariant verification — a ``structured_prune`` mask set at the
     config's crossbar geometry, its per-leaf ``XbarStats`` accounting,
     the decode/train tile plans vs the masks' tile reduction, a real
     prefill adopted into the paged pool, and cross-generation
     consistency after a live hot-swap (P-rules);
  3. dispatch audit — the train step (forward and backward, under
     autograd), prefill, dense decode and paged decode, each run once
     and checked for dense routing misses, f64 values and host round
     trips (J-rules).

At ``scale="tiny"`` on the CPU an arch takes seconds; on the card
(``device="cuda"``, the default) the audited closures launch the real
kernels.  The audited prefill is the reference's 8-token prompt on a
64-row engine at tiny scale, a 128-token one on a 256-row engine at full
scale (``_PROMPT``), so that full-width projections take the routes a
real prompt takes.  ``hlo=True`` (the reference's compiled-HLO cross-check) is not
ported: it raises ``NotImplementedError`` until a counterpart of
``launch/hlo_analysis`` exists.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, ContextManager, Dict, Optional, Sequence

import torch

from repro_torch.analysis.dispatch_audit import (audit_closure,
                                                 audit_engine_sharding,
                                                 unambiguous_covered)
from repro_torch.analysis.findings import Report
from repro_torch.analysis.invariants import (_walk_plan_leaves,
                                             verify_decode_plan,
                                             verify_engine,
                                             verify_mask_accounting,
                                             verify_paged_reconstruction,
                                             verify_tile_plan)
from repro_torch.analysis.recipe_lint import lint_recipe_for_family

# modest per-granularity fractions: enough pruning to produce dead
# tiles at tiny scale without collapsing any layer to all-zero
_LINT_FRACTION = 0.3
_EXPERT_FRACTION = 0.25

#: (prompt tokens of the audited prefill, the lint engine's capacity):
#: the reference's 8 and 64 at tiny scale; at full scale 128 and 256, so
#: that the prefill's projections take the route a real prompt takes
#: (``wgmma`` from 64 bf16 rows)
_PROMPT = {"tiny": (8, 64), "full": (128, 256)}

HLO_REFUSAL = ("the compiled-HLO cross-check (J206/J207) waits on a "
               "counterpart of launch/hlo_analysis, which is not yet "
               "ported to repro_torch")

#: ``probe(where)`` → a context manager entered around each audited
#: closure (a caller's view of what the closure launched)
Probe = Callable[[str], ContextManager]


def _lint_schedule(spec) -> Sequence:
    grans = spec.granularities or ("filter", "channel", "index")
    return [(g, _EXPERT_FRACTION if g == "expert" else _LINT_FRACTION)
            for g in grans]


def lint_arch(arch: Any, *, recipe: Any = None, scale: str = "tiny",
              seed: int = 0, hlo: bool = False, device="cuda",
              probe: Optional[Probe] = None) -> Report:
    """Run every analyzer but the kernel audit against one registered
    arch, on ``device``.

    ``recipe`` overrides the family's tuned recipe (name, path, dict, or
    instance); ``probe`` wraps each audited closure (see ``Probe``).
    """
    if hlo:
        raise NotImplementedError(HLO_REFUSAL)
    from repro_torch.api.registry import make_adapter, resolve_config
    from repro_torch.api.session import structured_prune
    from repro_torch.configs import PruneConfig

    report = Report()
    cfg, spec = resolve_config(arch)
    name = arch if isinstance(arch, str) else getattr(cfg, "name", "arch")
    prefix = f"{name}/"
    probe = probe or (lambda where: contextlib.nullcontext())

    # -- 1. recipe lint ----------------------------------------------------
    rec = recipe if recipe is not None else spec.recipe
    if rec is not None:
        report.extend(lint_recipe_for_family(rec, spec,
                                             where_prefix=prefix))

    # -- 2. masks + plans at the config's crossbar geometry ----------------
    adapter = make_adapter(arch, scale=scale, device=device)
    gen = torch.Generator(device=adapter.device).manual_seed(seed)
    params = adapter.init_params(gen)
    pcfg = PruneConfig()
    masks = structured_prune(params, _lint_schedule(spec),
                             prunable=adapter.prunable,
                             conv_pred=adapter.conv_pred, cfg=pcfg)
    report.extend(verify_mask_accounting(
        masks, adapter.conv_pred, rows=pcfg.xbar_rows,
        cols=pcfg.xbar_cols, where=f"{name}/masks"))

    # -- 3. family-shaped plan verification + dispatch audit ---------------
    if spec.family == "cnn":
        _lint_cnn(report, name, adapter, params, masks, probe)
    else:
        _lint_lm(report, name, adapter, params, masks, probe)

    if spec.serves:
        _lint_serving(report, name, adapter, spec, params, masks, probe,
                      *_PROMPT[scale])
    return report


def _grad_step(loss: Callable, params) -> Callable:
    """A closure that differentiates ``loss(params_with_grad)`` with
    respect to every floating-point leaf: the train step's forward and
    backward, as the reference's ``value_and_grad``."""
    from repro_torch._bridge import tree_map
    from repro_torch.core.masks import tree_flatten_with_path

    def step():
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True)
                         if torch.is_tensor(t) and t.is_floating_point()
                         else t, params)
            leaves = [t for _, t in tree_flatten_with_path(p)
                      if torch.is_tensor(t) and t.requires_grad]
            value = loss(p)
            torch.autograd.grad(value, leaves, allow_unused=True)
    return step


def _lint_cnn(report: Report, name: str, adapter, params, masks,
              probe: Probe) -> None:
    from repro_torch.train.plans import cnn_train_plan

    plans, _ = cnn_train_plan(masks)
    for path, leaf in _walk_plan_leaves(plans):
        report.extend(verify_tile_plan(
            leaf, where=f"{name}/train_plan/{path}"))
    covered = unambiguous_covered(plans, params)
    cfg, cnn = adapter.cfg, adapter._cnn
    batch = adapter._batch(0, 2)
    state = adapter._bn0
    step = _grad_step(lambda p: cnn.loss_fn(p, state, cfg, batch,
                                            train=True, plans=plans)[0],
                      params)
    where = f"{name}/train_step"
    with probe(where):
        report.extend(audit_closure(step, covered=covered, where=where))


def _lint_lm(report: Report, name: str, adapter, params, masks,
             probe: Probe) -> None:
    covered: Dict = {}
    cfg = adapter.cfg
    if adapter.family == "audio":
        # enc-dec masks carry no decode-plan structure; the step is
        # audited for promotions and host round trips only
        mod = adapter._mod
        loss = lambda p, b: mod.loss_fn(p, cfg, b)[0]
    else:
        from repro_torch.models.plans import build_decode_plan
        from repro_torch.train.plans import lm_train_plan

        plan, stats = build_decode_plan(masks)
        report.extend(verify_decode_plan(
            masks, plan, stats, where=f"{name}/decode_plan"))
        train_plan, _ = lm_train_plan(masks)
        covered = unambiguous_covered(train_plan, params)
        tfm = adapter._tfm
        loss = lambda p, b: tfm.loss_fn(p, cfg, b, plan=train_plan)[0]

    batch = adapter._batch(0)
    step = _grad_step(lambda p: loss(p, batch), params)
    where = f"{name}/train_step"
    with probe(where):
        report.extend(audit_closure(step, covered=covered, where=where))


def _serving(fn: Callable) -> Callable:
    """``fn`` run as the engine runs it: under inference mode."""
    def run(*args):
        with torch.inference_mode():
            return fn(*args)
    return run


def _lint_serving(report: Report, name: str, adapter, spec, params,
                  masks, probe: Probe, prompt: int, capacity: int) -> None:
    from repro_torch.core.masks import apply_masks
    from repro_torch.kernels.paged_attention import BLOCK_TOKENS
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paging import blocks_needed

    cfg = adapter.cfg   # the SCALED config the params were built for
    dev = adapter.device
    prefill_fn, decode_fn = adapter.serve_fns()
    with torch.no_grad():
        masked = apply_masks(params, masks)
    eng = ServeEngine(params=masked, cfg=cfg, prefill_fn=prefill_fn,
                      decode_fn=decode_fn, masks=masks, batch_slots=2,
                      capacity=capacity, device=dev)
    gen = eng.generations[-1]
    covered = unambiguous_covered(gen.plan, masked)
    plankw = {} if gen.plan is None else {"plan": gen.plan}

    toks = torch.zeros((1, prompt), dtype=torch.long, device=dev)
    batch = {"tokens": toks}
    if spec.family == "audio":
        batch["frames"] = torch.zeros(
            (1, int(cfg.encoder_seq_len), int(cfg.d_model)),
            dtype=torch.float32, device=dev)
    out = {}

    def prefill(p, cap):
        out["prefill"] = prefill_fn(p, cfg, batch, cap, **plankw)

    where = f"{name}/prefill"
    with probe(where):
        report.extend(audit_closure(_serving(prefill),
                                    [masked, eng.capacity],
                                    covered=covered, where=where))
    if "prefill" not in out:            # the prefill raised (J204)
        return

    # decode runs against SLOT-shaped caches (batch axis = engine
    # slots), zeros shaped by the prefill's caches through the engine's
    # own cache plumbing
    slot_caches = eng._empty_slot_caches(out["prefill"][1])
    tok = torch.zeros((eng.slots, 1), dtype=torch.long, device=dev)
    where = f"{name}/decode"
    with probe(where):
        report.extend(audit_closure(
            _serving(lambda p, c, t: decode_fn(p, cfg, c, t, **plankw)),
            [masked, slot_caches, tok], covered=covered, where=where))

    if eng.paged:
        # paged decode closure: the same audit against the generation's
        # pools, an all-scratch table and empty lengths
        tbl = torch.zeros((eng.slots, eng.kv_blocks - 1), dtype=torch.int32,
                          device=dev)
        lens = torch.zeros((eng.slots,), dtype=torch.int32, device=dev)
        where = f"{name}/decode_paged"
        with probe(where):
            report.extend(audit_closure(
                _serving(lambda p, c, t, tb, ln: tfm.decode_step_paged(
                    p, cfg, c, t, tb, ln, **plankw)),
                [masked, gen.paged_caches, tok, tbl, lens],
                covered=covered, where=where))
        # adopt a real prefill into the pool through the engine's own
        # copy and demand the gathered logical order reproduce the dense
        # cache bit for bit (P114); the paged admission prefills at the
        # prompt's padded length, so does this
        if spec.family != "audio":
            n = int(toks.shape[1])
            with torch.inference_mode():
                _, dense_c = prefill_fn(masked, cfg, batch, n, **plankw)
                blocks = list(range(1, blocks_needed(n, BLOCK_TOKENS) + 1))
                eng.adopt(gen, dense_c, blocks)
            report.extend(verify_paged_reconstruction(
                gen.paged_caches, dense_c, blocks, n,
                where=f"{name}/paged"))

    # live hot-swap, then cross-generation consistency (P112) — paged
    # engines also get pool/table balance checks here (P113/P115)
    eng.swap(masked, masks)
    report.extend(verify_engine(eng, where=f"{name}/engine"))
    # sharding placement (J208): nothing to place on a meshless engine
    report.extend(audit_engine_sharding(eng, where=f"{name}/engine"))


def lint_kernels() -> Report:
    """K300–K306 over every ``default_cases()`` launch spec
    (``analysis.kernel_audit``): final-writer coverage, read bounds,
    liveness against the truth source, f32 accumulators, the H100's
    shared memory, and the H100 cost model.  Host numpy only."""
    from repro_torch.analysis.kernel_audit import audit_kernels

    report = Report()
    report.extend(audit_kernels())
    return report


def lint_all(names: Optional[Sequence[str]] = None, *,
             scale: str = "tiny", seed: int = 0, hlo: bool = False,
             device="cuda") -> Dict[str, Report]:
    """``lint_arch`` over every registered arch (or ``names``)."""
    from repro_torch.api.registry import list_adaptable

    out: Dict[str, Report] = {}
    for name in (names if names is not None else list_adaptable()):
        out[name] = lint_arch(name, scale=scale, seed=seed, hlo=hlo,
                              device=device)
    return out
