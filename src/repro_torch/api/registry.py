"""Family-keyed adapter registry: ``make_adapter(name)`` (port of
``repro.api.registry``).

Every registered config maps through its ``family`` to ONE entry here;
the entry is data — which adapter class drives the family, which
prunability/conv predicates apply, which granularity schedule
Algorithm 1 walks, how to scale the config down for CPU runs.

    adapter = make_adapter("vgg11", scale="full", batch_size=128)
    result = PruningSession(adapter, PruneConfig(max_iters=2)).run()

Families → adapters, as in the reference: dense, moe, hybrid, ssm and
vlm → ``LMAdapter`` (moe walks whole experts first: the ``expert``
granularity and the ``moe-full`` recipe), audio → ``EncDecAdapter``,
cnn → ``CNNAdapter``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.api.adapters import (CNNAdapter, EncDecAdapter, LMAdapter,
                                      ModelAdapter)
from repro_torch.api.recipes import (Recipe, prune_stage, quantize_stage,
                                     register_recipe)
from repro_torch.configs import (ArchConfig, CNNConfig, get_arch, get_cnn,
                                 list_archs, list_cnns, scaled_down,
                                 scaled_down_cnn)
from repro_torch.core.masks import cnn_conv_path, family_prunable

SCALES = ("tiny", "full")


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Registry entry: everything family-specific, as data."""
    family: str
    adapter_factory: Callable[..., ModelAdapter]
    prunable: Callable[[str, Any], bool]
    conv_pred: Optional[Callable[[str], bool]] = None
    # None → PruneConfig.granularities (the paper's schedule)
    granularities: Optional[Tuple[str, ...]] = None
    # granularities that exist in the strategy registry but are inert
    # for this family (``expert`` outside MoE exposes no prunable groups)
    excluded_granularities: Tuple[str, ...] = ()
    # tuned full-scale prune program (registered recipe name); applied
    # at scale="full" only
    recipe: Optional[str] = None
    # cfg → reduced same-family cfg for scale="tiny"
    scale_tiny: Callable[[Any], Any] = lambda cfg: cfg
    # adapter kwargs that make scale="tiny" runs CPU-seconds cheap
    smoke_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # the adapter exposes a ServeEngine prefill/decode pair
    serves: bool = False


_FAMILIES: Dict[str, FamilySpec] = {}


def register_family(spec: FamilySpec) -> FamilySpec:
    """Later registrations replace earlier ones (project overrides)."""
    _FAMILIES[spec.family] = spec
    return spec


def get_family(family: str) -> FamilySpec:
    if family not in _FAMILIES:
        raise KeyError(f"no adapter family {family!r}; "
                       f"registered: {sorted(_FAMILIES)}")
    return _FAMILIES[family]


def available_families() -> Tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def family_granularities(spec: FamilySpec) -> Tuple[str, ...]:
    """Granularities a recipe may schedule for this family: every
    registered strategy minus the family's exclusions."""
    from repro_torch.core.strategies import available_strategies
    return tuple(g for g in available_strategies()
                 if g not in spec.excluded_granularities)


def _tiny_arch(cfg: ArchConfig) -> ArchConfig:
    return scaled_down(cfg, dtype="float32")


_LM_SMOKE = dict(steps=6, batch_size=2, seq_len=16, eval_batches=1,
                 warmup=2)

# ---------------------------------------------------------------------------
# Tuned full-scale recipes (FamilySpec.recipe points at these by name),
# the reference's: coarse stages prune aggressively with long retrains,
# fine stages mop up with shorter ones, and every family finishes with
# the ReRAM-native int8 QAT stage.
# ---------------------------------------------------------------------------
register_recipe(Recipe(
    name="cnn-full",
    description="Tuned full-scale CNN program (VGG/ResNet on CIFAR): "
                "the paper schedule at 25%/round with a mop-up index "
                "pass, then int8 quantization-aware retrain.",
    stages=(
        prune_stage("filter", rate=0.25, retrain_steps=400),
        prune_stage("channel", rate=0.25, retrain_steps=400),
        prune_stage("index", rate=0.20, retrain_steps=300,
                    target_sparsity=0.95),
        quantize_stage(8, retrain_steps=300),
    )))

register_recipe(Recipe(
    name="dense-full",
    description="Tuned full-scale dense-LM program: coarse filter "
                "pass, crossbar-aligned channel/index passes at a "
                "gentler rate (LM loss cliffs are sharper than CNN "
                "accuracy), then int8 QAT.",
    stages=(
        prune_stage("filter", rate=0.20, retrain_steps=300),
        prune_stage("channel", rate=0.20, retrain_steps=300),
        prune_stage("index", rate=0.15, retrain_steps=200,
                    target_sparsity=0.90),
        quantize_stage(8, retrain_steps=200),
    )))

register_recipe(Recipe(
    name="moe-full",
    description="Tuned full-scale MoE program: whole-expert slices "
                "first (bounded rounds — the router needs survivors), "
                "then the dense-LM schedule over what remains, then "
                "int8 QAT.",
    stages=(
        prune_stage("expert", rate=0.25, max_rounds=3, retrain_steps=300),
        prune_stage("filter", rate=0.20, retrain_steps=300),
        prune_stage("channel", rate=0.20, retrain_steps=200),
        prune_stage("index", rate=0.15, retrain_steps=200,
                    target_sparsity=0.90),
        quantize_stage(8, retrain_steps=200),
    )))

for _fam in ("dense", "moe", "hybrid", "ssm", "vlm"):
    register_family(FamilySpec(
        family=_fam,
        adapter_factory=LMAdapter,
        prunable=family_prunable(_fam),
        granularities=(("expert", "filter", "channel", "index")
                       if _fam == "moe" else None),
        excluded_granularities=() if _fam == "moe" else ("expert",),
        recipe="moe-full" if _fam == "moe" else "dense-full",
        scale_tiny=_tiny_arch,
        smoke_kwargs=_LM_SMOKE,
        serves=True,
    ))

register_family(FamilySpec(
    family="audio",
    adapter_factory=EncDecAdapter,
    prunable=family_prunable("audio"),
    excluded_granularities=("expert",),
    recipe="dense-full",
    scale_tiny=_tiny_arch,
    smoke_kwargs=dict(steps=4, batch_size=2, seq_len=12, eval_batches=1),
    serves=True,
))

register_family(FamilySpec(
    family="cnn",
    adapter_factory=CNNAdapter,
    prunable=family_prunable("cnn"),
    conv_pred=cnn_conv_path,
    excluded_granularities=("expert",),
    recipe="cnn-full",
    scale_tiny=scaled_down_cnn,
    smoke_kwargs=dict(steps=6, batch_size=8, eval_batches=1,
                      eval_batch_size=16),
))


def list_adaptable() -> Sequence[str]:
    """Every registered arch name ``make_adapter`` accepts."""
    return list(list_archs()) + list(list_cnns())


def resolve_config(arch):
    """Name or config instance → (config, FamilySpec)."""
    if isinstance(arch, (ArchConfig, CNNConfig)):
        return arch, get_family(arch.family)
    try:
        cfg = get_arch(arch)
    except KeyError:
        try:
            cfg = get_cnn(arch)
        except KeyError:
            raise KeyError(f"unknown arch {arch!r}; "
                           f"known: {list_adaptable()}") from None
    return cfg, get_family(cfg.family)


def make_adapter(arch, *, scale: str = "tiny",
                 **adapter_kwargs) -> ModelAdapter:
    """One working ``ModelAdapter`` for a registered arch.

    ``arch``: a name from ``list_adaptable()`` or a config instance
    (used as it is).  ``scale``: "tiny" reduces the config for CPU runs
    and defaults the adapter's training budget to seconds; "full" keeps
    the registered config and the adapter class defaults, and attaches
    the family's tuned recipe (``adapter.recipe``).  Explicit
    ``adapter_kwargs`` (``device=`` among them; adapters default to
    "cuda") always win over the smoke defaults.
    """
    cfg, spec = resolve_config(arch)
    is_instance = isinstance(arch, (ArchConfig, CNNConfig))
    kwargs = dict(adapter_kwargs)
    full_scale = False
    if not is_instance:
        if scale not in SCALES:
            raise ValueError(f"unknown scale {scale!r}; known: {SCALES}")
        if scale == "tiny":
            cfg = spec.scale_tiny(cfg)
            kwargs = {**spec.smoke_kwargs, **kwargs}
        else:
            full_scale = True
    adapter = spec.adapter_factory(cfg, **kwargs)
    adapter.family = spec.family
    adapter.prunable_pred = spec.prunable
    adapter.conv_path_pred = spec.conv_pred
    adapter.granularities = spec.granularities
    adapter.recipe = spec.recipe if full_scale else None
    return adapter
