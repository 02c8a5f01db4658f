"""Declarative PruneRecipe API: staged prune programs (port of
``repro.api.recipes``, pure Python: recipes serialise to the same JSON
in both packages).

The paper's result is a *program*, not a knob: Algorithm 1 walks a
granularity schedule behind an accuracy gate, the ticket retrains from
scratch, and the hardware saving assumes the ReRAM-native fixed-point
representation.  A ``Recipe`` makes that program first-class — an
ordered tuple of ``Stage``s, each declaring what it does and how it is
budgeted/gated — and ``PruningSession`` interprets it (resumable
mid-stage, checkpoint carries ``(stage_idx, step)``).

Stage kinds:

  ``prune``     — iterative rounds at one granularity (any name in
                  ``core.strategies``): train → prune ``rate`` of the
                  remaining weights → eval-gate.  The stage ends when a
                  round is rejected (coarse→fine hand-off), when
                  ``target_sparsity`` is reached, or after
                  ``max_rounds`` accepted+rejected rounds.
  ``quantize``  — quantization-aware retrain: the ticket trains with
                  straight-through fake quantization at ``bits``
                  (``core.quantize`` × masks wired into the train
                  step) and is gated on its *quantized* accuracy.
  ``ablate``    — the paper's schedule-ablation table: retrain once,
                  then score a one-round prune at every granularity in
                  ``granularities`` (whole-``xbar`` included by
                  default) WITHOUT committing any mask — pure
                  measurement, streamed as ``kind="ablate"`` events.

Recipes serialise losslessly (``to_dict``/``from_dict``, JSON file
round-trip), are registered by name (``register_recipe`` /
``get_recipe``), and compile from the legacy flat surface
(``from_granularities`` — the ``granularities=`` shim).  Built-ins:

  paper        — filter → channel → index (Algorithm 1's schedule)
  paper-quant  — the paper schedule + an 8-bit quantize stage
  paper-xbar   — whole-xbar first pass, then the paper schedule
  ablation     — the schedule-ablation sweep (xbar/filter/channel/index)

Per-family tuned full-scale recipes live in ``api.registry``
(``FamilySpec.recipe``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.strategies import PAPER_SCHEDULE, require_strategies

STAGE_KINDS = ("prune", "quantize", "ablate")

# default ablation sweep: the coarsest crossbar-aligned structure first
ABLATION_SWEEP: Tuple[str, ...] = ("xbar",) + PAPER_SCHEDULE


@dataclass(frozen=True)
class Stage:
    """One step of a prune program.  Field semantics by ``kind``:

    prune:    ``granularity`` (required), ``rate`` per round,
              ``target_sparsity`` / ``max_rounds`` stage budgets.
    quantize: ``bits`` (8 or 16 — the platform's fixed-point widths).
    ablate:   ``granularities`` sweep, scored at ``rate``.

    Shared: ``retrain_steps`` overrides the adapter's per-round train
    budget; ``accuracy_drop`` overrides the session's gate tolerance
    for this stage only (``None`` → ``PruneConfig.accuracy_tolerance``).
    """
    kind: str
    name: str = ""
    granularity: Optional[str] = None
    rate: float = 0.25
    target_sparsity: Optional[float] = None
    max_rounds: Optional[int] = None
    retrain_steps: Optional[int] = None
    accuracy_drop: Optional[float] = None
    bits: int = 8
    granularities: Tuple[str, ...] = ()

    def __post_init__(self):
        # validation errors name the offending field (and, through
        # ``Recipe``'s wrapping, the recipe name + stage index)
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"field 'kind': unknown stage kind "
                             f"{self.kind!r}; known: {STAGE_KINDS}")
        if self.kind == "prune":
            if not self.granularity:
                raise ValueError("field 'granularity': prune stage "
                                 "needs a granularity")
            require_strategies([self.granularity])
            if not (0.0 < self.rate < 1.0):
                raise ValueError(f"field 'rate': prune rate must be in "
                                 f"(0, 1), got {self.rate}")
            if self.target_sparsity is not None and not (
                    0.0 < self.target_sparsity < 1.0):
                raise ValueError(f"field 'target_sparsity': must be in "
                                 f"(0, 1), got {self.target_sparsity}")
            if self.max_rounds is not None and self.max_rounds < 1:
                raise ValueError(f"field 'max_rounds': must be >= 1, "
                                 f"got {self.max_rounds}")
        elif self.kind == "quantize":
            if self.bits not in (8, 16):
                raise ValueError(f"field 'bits': quantize bits must be "
                                 f"8 or 16, got {self.bits}")
        elif self.kind == "ablate":
            sweep = self.granularities or ABLATION_SWEEP
            require_strategies(sweep)
            object.__setattr__(self, "granularities", tuple(sweep))
            if not (0.0 < self.rate < 1.0):
                raise ValueError(f"field 'rate': ablate rate must be in "
                                 f"(0, 1), got {self.rate}")
        if not self.name:
            object.__setattr__(self, "name", self._default_name())

    def _default_name(self) -> str:
        if self.kind == "prune":
            return f"prune:{self.granularity}"
        if self.kind == "quantize":
            return f"quantize:int{self.bits}"
        return "ablate:" + ",".join(self.granularities)

    def to_dict(self) -> dict:
        out = {"kind": self.kind, "name": self.name}
        if self.kind == "prune":
            out.update(granularity=self.granularity, rate=self.rate)
            if self.target_sparsity is not None:
                out["target_sparsity"] = self.target_sparsity
            if self.max_rounds is not None:
                out["max_rounds"] = self.max_rounds
        elif self.kind == "quantize":
            out["bits"] = self.bits
        else:
            out.update(granularities=list(self.granularities),
                       rate=self.rate)
        if self.retrain_steps is not None:
            out["retrain_steps"] = self.retrain_steps
        if self.accuracy_drop is not None:
            out["accuracy_drop"] = self.accuracy_drop
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Stage":
        d = dict(d)
        if "granularities" in d:
            d["granularities"] = tuple(d["granularities"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown stage field(s) {unknown}; "
                             f"known: {sorted(known)}")
        return cls(**d)


def prune_stage(granularity: str, **kw) -> Stage:
    return Stage(kind="prune", granularity=granularity, **kw)


def quantize_stage(bits: int = 8, **kw) -> Stage:
    return Stage(kind="quantize", bits=bits, **kw)


def ablate_stage(granularities: Sequence[str] = (), **kw) -> Stage:
    return Stage(kind="ablate", granularities=tuple(granularities), **kw)


@dataclass(frozen=True)
class Recipe:
    """An ordered, serializable prune program."""
    name: str
    stages: Tuple[Stage, ...]
    description: str = ""

    def __post_init__(self):
        if not self.stages:
            raise ValueError(f"recipe {self.name!r} has no stages")
        stages = []
        for i, s in enumerate(self.stages):
            if isinstance(s, Stage):
                stages.append(s)
                continue
            try:
                stages.append(Stage.from_dict(s))
            except (ValueError, TypeError, KeyError) as e:
                label = ""
                if isinstance(s, dict) and (s.get("name") or s.get("kind")):
                    label = f" ({s.get('name') or s.get('kind')})"
                raise type(e)(
                    f"recipe {self.name!r} stage[{i}]{label}: {e}") from e
        object.__setattr__(self, "stages", tuple(stages))

    @property
    def prune_granularities(self) -> Tuple[str, ...]:
        return tuple(s.granularity for s in self.stages
                     if s.kind == "prune")

    @property
    def quantize_bits(self) -> Optional[int]:
        """Bits of the last quantize stage (None without one)."""
        bits = [s.bits for s in self.stages if s.kind == "quantize"]
        return bits[-1] if bits else None

    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "stages": [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, d: dict) -> "Recipe":
        # raw stage dicts go through __post_init__, which wraps their
        # validation errors with the recipe name + stage index/name
        return cls(name=d["name"], description=d.get("description", ""),
                   stages=tuple(d["stages"]))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Recipe":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "Recipe":
        with open(path) as f:
            return cls.from_json(f.read())

    def replace(self, **kw) -> "Recipe":
        return dataclasses.replace(self, **kw)

    def with_retrain_steps(self, steps: int) -> "Recipe":
        """Every stage's retrain budget overridden to ``steps`` — what
        an explicit ``--steps`` means regardless of where the recipe
        came from (tuned budgets are full-scale; smoke runs aren't)."""
        return self.replace(stages=tuple(
            dataclasses.replace(s, retrain_steps=steps)
            for s in self.stages))


def from_granularities(granularities: Sequence[str], *,
                       rate: float = 0.25, name: str = "legacy",
                       **stage_kw) -> Recipe:
    """Compile a flat granularity schedule to a staged recipe — the
    ``granularities=`` shim.  One prune stage per granularity with no
    per-stage budget reproduces the old cursor loop exactly: rounds
    repeat at a granularity until one is rejected, then the program
    falls through to the next (finer) stage."""
    grans = require_strategies(granularities)
    return Recipe(
        name=name,
        description="compiled from a flat granularity schedule",
        stages=tuple(prune_stage(g, rate=rate, **stage_kw)
                     for g in grans))


# ---------------------------------------------------------------------------
# Named-recipe registry
# ---------------------------------------------------------------------------
_RECIPES: Dict[str, Recipe] = {}


def register_recipe(recipe: Recipe) -> Recipe:
    """Later registrations replace earlier ones (project overrides)."""
    _RECIPES[recipe.name] = recipe
    return recipe


def get_recipe(name: str) -> Recipe:
    if name not in _RECIPES:
        raise KeyError(f"unknown recipe {name!r}; "
                       f"registered: {available_recipes()}")
    return _RECIPES[name]


def available_recipes() -> Tuple[str, ...]:
    return tuple(sorted(_RECIPES))


RecipeLike = Union[Recipe, str, dict]


def resolve_recipe(spec: RecipeLike) -> Recipe:
    """Recipe instance | registered name | path to a .json | dict."""
    if isinstance(spec, Recipe):
        return spec
    if isinstance(spec, dict):
        return Recipe.from_dict(spec)
    if isinstance(spec, str):
        if spec in _RECIPES:
            return _RECIPES[spec]
        if spec.endswith(".json") or os.path.sep in spec:
            if not os.path.exists(spec):
                raise FileNotFoundError(
                    f"recipe file {spec!r} not found (and no registered "
                    f"recipe has that name; known: {available_recipes()})")
            return Recipe.load(spec)
        raise KeyError(f"unknown recipe {spec!r}; registered: "
                       f"{available_recipes()} (or pass a path to a "
                       ".json recipe file)")
    raise TypeError(f"cannot resolve a recipe from {type(spec).__name__}")


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------
register_recipe(Recipe(
    name="paper",
    description="Algorithm 1's coarse-to-fine schedule: filter -> "
                "channel -> index, 25% of remaining weights per round.",
    stages=tuple(prune_stage(g) for g in PAPER_SCHEDULE)))

register_recipe(Recipe(
    name="paper-quant",
    description="The paper schedule followed by an int8 "
                "quantization-aware retrain of the winning ticket "
                "(the ReRAM-native fixed-point representation).",
    stages=tuple(prune_stage(g) for g in PAPER_SCHEDULE)
    + (quantize_stage(8),)))

register_recipe(Recipe(
    name="paper-xbar",
    description="Whole-crossbar first pass (coarsest structure), then "
                "the paper schedule.",
    stages=(prune_stage("xbar"),)
    + tuple(prune_stage(g) for g in PAPER_SCHEDULE)))

register_recipe(Recipe(
    name="ablation",
    description="Schedule-ablation sweep: score one prune round at "
                "each granularity (incl. whole-xbar) without "
                "committing masks — the paper's ablation table.",
    stages=(ablate_stage(ABLATION_SWEEP),)))
