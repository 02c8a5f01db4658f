"""Recipe linter: static checks of ``Recipe``/``Stage`` programs (port
of ``repro.analysis.recipe_lint``).

Runs entirely on the recipe data — no model, no training.  Checks a
program against the target family's capabilities (``FamilySpec``) and
against the session interpreter's actual semantics, which is where the
subtle rules come from:

* ``retrain_steps=0`` does NOT mean "no retraining": the adapters treat
  a falsy budget as "use my default", so a zero budget silently trains
  the full default schedule (R004).
* A stage whose ``target_sparsity`` is already met by an earlier stage
  still runs at least one round before its exit check — the target is
  dead text (R003).
* The per-stage exit ``s_after >= target`` composes multiplicatively:
  each accepted round prunes ``rate`` of the *remaining* weights, so a
  stage capped at ``max_rounds`` can reach at most
  ``1 - (1-s0)·(1-rate)^max_rounds`` (R007).

Rule codes R001–R009; see ``analysis.findings.RULES``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, error, warning
from repro_torch.api.recipes import Recipe, RecipeLike, resolve_recipe

_REACH_EPS = 1e-9


def lint_recipe(spec: RecipeLike, *,
                allowed_granularities: Optional[Sequence[str]] = None,
                family: str = "",
                where_prefix: str = "") -> List[Finding]:
    """Lint one recipe (instance, registered name, dict, or .json path).

    ``allowed_granularities``: the family's valid prune granularities
    (``api.registry.family_granularities``); None skips the family
    check (R002).  ``family`` only labels the finding messages.
    """
    try:
        recipe = resolve_recipe(spec)
    except (ValueError, TypeError, KeyError, FileNotFoundError) as e:
        label = spec if isinstance(spec, str) else \
            (spec.get("name", "?") if isinstance(spec, dict) else "?")
        return [error("R001", f"{where_prefix}recipe:{label}", str(e))]

    findings: List[Finding] = []

    def loc(i: int, stage) -> str:
        return f"{where_prefix}recipe:{recipe.name}/stage[{i}]:{stage.name}"

    allowed = (None if allowed_granularities is None
               else set(allowed_granularities))
    # best-case sparsity reachable so far (every round accepted), used
    # for both the monotonicity check and the reachability bound
    best_sparsity = 0.0
    last_target: Optional[float] = None
    quantized_at: Optional[int] = None
    seen_prune = False
    seen_names = {}

    for i, s in enumerate(recipe.stages):
        if s.name in seen_names:
            findings.append(warning(
                "R008", loc(i, s),
                f"stage name {s.name!r} duplicates stage"
                f"[{seen_names[s.name]}] — resume and event attribution "
                f"key on stage identity; give stages distinct names"))
        else:
            seen_names[s.name] = i

        if s.retrain_steps is not None and s.retrain_steps <= 0:
            findings.append(error(
                "R004", loc(i, s),
                f"retrain_steps={s.retrain_steps} is not a zero-retrain "
                f"budget: falsy budgets silently fall back to the "
                f"adapter's default schedule; drop the field or set a "
                f"positive budget"))

        if s.kind == "prune":
            seen_prune = True
            if allowed is not None and s.granularity not in allowed:
                fam = f" for family {family!r}" if family else ""
                findings.append(error(
                    "R002", loc(i, s),
                    f"granularity {s.granularity!r} is not usable"
                    f"{fam}; allowed: {sorted(allowed)} (it would run "
                    f"but prune nothing — no leaves expose groups)"))
            if quantized_at is not None:
                findings.append(warning(
                    "R006", loc(i, s),
                    f"prune stage after quantize stage"
                    f"[{quantized_at}] — pruning after QAT invalidates "
                    f"the calibrated quantized accuracy the quantize "
                    f"gate accepted; order prune stages first"))
            if s.target_sparsity is not None:
                if last_target is not None and \
                        s.target_sparsity <= last_target:
                    findings.append(error(
                        "R003", loc(i, s),
                        f"target_sparsity={s.target_sparsity} does not "
                        f"exceed the previous target {last_target} — "
                        f"the target is already met when the stage "
                        f"starts, so it bounds nothing (the stage still "
                        f"runs one unbudgeted round)"))
                last_target = s.target_sparsity
                if s.max_rounds is not None:
                    reach = 1.0 - (1.0 - best_sparsity) * \
                        (1.0 - s.rate) ** s.max_rounds
                    if reach + _REACH_EPS < s.target_sparsity:
                        findings.append(warning(
                            "R007", loc(i, s),
                            f"target_sparsity={s.target_sparsity} is "
                            f"unreachable: {s.max_rounds} rounds at "
                            f"rate={s.rate} reach at most {reach:.3f} "
                            f"even if every round is accepted"))
            # advance the best-case sparsity bound
            if s.max_rounds is not None:
                best = 1.0 - (1.0 - best_sparsity) * \
                    (1.0 - s.rate) ** s.max_rounds
            else:
                best = 1.0  # unbounded rounds can approach 1.0
            if s.target_sparsity is not None:
                best = min(best, max(s.target_sparsity, best_sparsity))
            best_sparsity = max(best_sparsity, best)
        elif s.kind == "quantize":
            if not seen_prune:
                findings.append(warning(
                    "R005", loc(i, s),
                    "quantize stage before any prune stage: QAT "
                    "calibrates a dense model, so the quantized "
                    "accuracy gate measures nothing about the ticket "
                    "this recipe is supposed to produce"))
            quantized_at = i

    if not seen_prune:
        findings.append(warning(
            "R009", f"{where_prefix}recipe:{recipe.name}",
            "recipe has no prune stage — it commits no masks "
            "(measurement-only programs like the ablation sweep are "
            "fine; anything meant to produce a ticket is not)"))
    return findings


def lint_recipe_for_family(spec: RecipeLike, family_spec,
                           where_prefix: str = "") -> List[Finding]:
    """Lint a recipe against a ``FamilySpec`` (granularity capability)."""
    from repro_torch.api.registry import family_granularities
    return lint_recipe(
        spec,
        allowed_granularities=family_granularities(family_spec),
        family=family_spec.family,
        where_prefix=where_prefix)
