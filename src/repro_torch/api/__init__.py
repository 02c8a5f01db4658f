"""``repro_torch.api`` — the entry point for pruning, retraining and
serving (port of ``repro.api``).  The command line is ``python -m repro_torch.api`` (``api.cli``).

    from repro_torch.api import PruningSession, make_adapter
    adapter = make_adapter("vgg11", scale="full", batch_size=128)
    session = PruningSession(adapter, PruneConfig(max_iters=2))
    result = session.run()
    session.export_ticket("tickets/vgg11")

plus ``structured_prune`` for one-shot (no accuracy gate) schedules.
"""
from repro_torch.api.adapters import (  # noqa: F401
    CNNAdapter, EncDecAdapter, FunctionAdapter, LMAdapter, ModelAdapter,
    ServeUnsupported,
)
from repro_torch.api.recipes import (  # noqa: F401
    Recipe, Stage, ablate_stage, available_recipes, from_granularities,
    get_recipe, prune_stage, quantize_stage, register_recipe, resolve_recipe,
)
from repro_torch.api.registry import (  # noqa: F401
    FamilySpec, available_families, get_family, list_adaptable, make_adapter,
    register_family,
)
from repro_torch.api.session import (PruningSession,  # noqa: F401
                                     structured_prune)
from repro_torch.core.algorithm import PruneEvent, PruneResult  # noqa: F401
from repro_torch.core.strategies import (  # noqa: F401
    GranularityStrategy, TileGeometry, available_strategies, get_strategy,
    register_strategy,
)
