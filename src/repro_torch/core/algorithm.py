"""ReaLPrune — Algorithm 1 of the paper (port of ``repro.core.algorithm``).

    Input : model, pruning percentage p
    Output: pruned model (masks + rewound weights)
    1: w ← w_initial
    2: while itr < MAX_ITER and no accuracy drop:
    3:     Train for E epochs
    4:     Prune(p) by crossbar structure + weight magnitude
    5:     if new_accuracy < baseline_accuracy:
    6:         undo last pruning step
    7:         switch to finer pruning strategy
    8:     reinitialize remaining weights with w_initial
    return pruned model

The loop itself lives in ``api.session.PruningSession``;
``realprune`` / ``lottery_baseline`` here are thin shims that wrap
caller-supplied ``train_fn``/``eval_fn`` closures in a
``FunctionAdapter`` and run a session.  ``prune_step`` — one
crossbar-aware prune at a named granularity — is the shared primitive.
Pruning decisions run host-side on numpy copies of the weights and
masks, leaf by leaf in the reference's order, so the same weights and
masks give the same new masks in both packages; each new mask leaf
goes back as a float32 tensor on its old leaf's device.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._bridge import to_numpy
from repro_torch.configs.base import PruneConfig
from repro_torch.core import masks as masks_lib
from repro_torch.core import scoring
from repro_torch.core.masks import sparsity_fraction, tree_flatten_with_path
from repro_torch.core.strategies import TileGeometry

log = logging.getLogger("realprune")


@dataclass
class PruneEvent:
    iteration: int
    granularity: str
    sparsity_before: float
    sparsity_after: float
    accuracy: float
    accepted: bool
    # which stage of the prune program produced this event
    stage: str = ""
    stage_idx: int = 0
    kind: str = "prune"              # prune | quantize | ablate
    # data-parallel retrain comm accounting (mask-aware compression)
    comm_sent_fraction: float = 0.0
    comm_bytes_per_step: int = 0


@dataclass
class PruneResult:
    masks: dict
    params: dict                     # rewound to w_init ⊙ mask
    history: List[PruneEvent] = field(default_factory=list)
    # resolved recipe dict the session ran (embedded in exported tickets)
    recipe: Optional[dict] = None

    @property
    def sparsity(self) -> float:
        return sparsity_fraction(self.masks)

    def stage_events(self, stage_idx: int) -> List[PruneEvent]:
        return [e for e in self.history if e.stage_idx == stage_idx]

    @property
    def ablation(self) -> List[PruneEvent]:
        """The schedule-ablation table rows (events from ablate stages)."""
        return [e for e in self.history if e.kind == "ablate"]


def _leaf_items(params, masks, prunable_conv: Callable[[str], bool]):
    """[(path, np weight, np mask, is_conv, mask leaf)] for prunable
    leaves, in the reference's order."""
    flat_p = dict(tree_flatten_with_path(params))
    return [(p, to_numpy(flat_p[p]), to_numpy(m), prunable_conv(p), m)
            for p, m in tree_flatten_with_path(masks) if m is not None]


def prune_step(params, masks, granularity: str, fraction: float,
               conv_pred: Callable[[str], bool], block: int = 32,
               geometry: Optional[TileGeometry] = None):
    """One crossbar-aware prune of ``fraction`` of remaining weights."""
    items = _leaf_items(params, masks, conv_pred)
    group_sets = [scoring.group_scores(p, w, m, granularity, conv,
                                       block=block, geometry=geometry)
                  for (p, w, m, conv, _) in items]
    remaining = sum(int(m.sum()) for (_, _, m, _, _) in items)
    kills = scoring.select_global_prune(group_sets, fraction, remaining)
    gs_by_path = {gs.path: gs for gs in group_sets}
    by_path = {p: (m, leaf) for (p, _, m, _, leaf) in items}
    new_masks = masks
    for path, kill in kills.items():
        old, leaf = by_path[path]
        new_leaf = scoring.zero_groups(old, gs_by_path[path], kill)
        device = leaf.device if torch.is_tensor(leaf) else "cpu"
        new_masks = masks_lib.tree_set(
            new_masks, path,
            torch.as_tensor(np.asarray(new_leaf, np.float32), device=device))
    return new_masks


def realprune(
    *,
    init_params,
    train_fn: Callable,            # (params, masks) -> trained params
    eval_fn: Callable,             # (params, masks) -> accuracy (float)
    prunable: Callable,            # (path, leaf) -> bool
    conv_pred: Callable,           # (path) -> bool: leaf is a conv kernel
    cfg: PruneConfig,
    baseline_accuracy: Optional[float] = None,
    granularities: Optional[Sequence[str]] = None,
):
    """Run Algorithm 1 and return the sparsest no-accuracy-drop model
    (a shim over ``api.PruningSession``)."""
    from repro_torch.api.adapters import FunctionAdapter
    from repro_torch.api.session import PruningSession

    adapter = FunctionAdapter(params=init_params, train_fn=train_fn,
                              eval_fn=eval_fn, prunable=prunable,
                              conv_pred=conv_pred)
    return PruningSession(adapter, cfg, granularities=granularities,
                          baseline_accuracy=baseline_accuracy).run()


def lottery_baseline(*, init_params, train_fn, eval_fn, prunable, conv_pred,
                     cfg: PruneConfig, method: str,
                     baseline_accuracy: Optional[float] = None):
    """Iterative single-granularity baselines: LTP / Block / CAP — the
    same loop as Algorithm 1 with one granularity and no coarse-to-fine
    switch (the paper's baselines, §V.A)."""
    gran = {"ltp": "ltp", "block": "block", "cap": "cap"}[method]
    return realprune(init_params=init_params, train_fn=train_fn,
                     eval_fn=eval_fn, prunable=prunable, conv_pred=conv_pred,
                     cfg=cfg, baseline_accuracy=baseline_accuracy,
                     granularities=[gran])
