"""ReaLPrune core: the paper's contribution as a composable library
(port of ``repro.core``).

Layering (bottom → top):

crossbar.py   — weight→crossbar unroll mapping + tile accounting
                (geometry-parametric: xr×xc, default 128×128)
masks.py      — mask pytrees, prunability predicates
strategies.py — GranularityStrategy registry: filter/channel/index
                (+ltp/block/cap/xbar/expert) group shapes, by name
scoring.py    — global lowest-percentile group selection
algorithm.py  — prune_step primitive + realprune/lottery_baseline
                shims over repro_torch.api.PruningSession (imported
                lazily: api imports core)
lottery.py    — winning-ticket snapshot/rewind/export
hardware.py   — crossbar savings accounting (Figs 2 & 6)
perf_model.py — pipelined ReRAM execution model (Figs 7 & 8)
quantize.py   — fixed-point storage and the QAT fake pass
packing.py    — pruned FFNs packed into narrower dense matmuls

The user-facing entry point is ``repro_torch.api``; pruning decisions
stay host-side (numpy), a one-time offline effort (paper §V.C).
"""
from repro_torch.core.masks import (  # noqa: F401
    apply_masks, cnn_is_conv, cnn_prunable, lm_prunable, make_masks,
    mask_grads, sparsity, sparsity_fraction,
)
from repro_torch.core.strategies import (  # noqa: F401
    GranularityStrategy, GroupSet, TileGeometry, available_strategies,
    get_strategy, register_strategy,
)

# algorithm imports repro_torch._bridge, which imports core.masks (and so
# this package): its names load on first use, which breaks the cycle
_ALGORITHM = ("PruneEvent", "PruneResult", "lottery_baseline", "prune_step",
              "realprune")


def __getattr__(name):
    if name in _ALGORITHM:
        from repro_torch.core import algorithm
        return getattr(algorithm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_ALGORITHM))
