"""Group scoring for crossbar-aware pruning (paper §IV.B; port of
``repro.core.scoring``, a numpy copy).

Granularities on the unrolled weight matrix M (R×C), crossbars xr×xc
(``TileGeometry``, default 128×128):

  * ``filter``  — one whole column (conv: one filter IC·K·K; dense: one
                  output unit).  The only granularity that also removes
                  an activation.
  * ``channel`` — conv: the K² rows of one input channel within one
                  column (paper Fig. 3c); dense: the xr-row crossbar
                  segment of one column.  Zeroing it frees a crossbar
                  column.
  * ``index``   — one row restricted to one xc-column crossbar
                  (paper Fig. 3d).  Zeroing it frees a crossbar row.

Group score = mean |w| over the group's weights (paper: "average
weight").  Pruning selects the globally lowest-scoring *alive* groups
across all layers until the requested fraction of remaining weights is
removed — the paper's "lowest p percentile by magnitude, considering
all the filters/channels/… of the CNN".

Baselines reuse the same machinery with their own group shapes:
  * ``ltp``   — every single weight is its own group (unstructured).
  * ``block`` — square b×b blocks (BLK-REW [9] adapted to crossbars).
  * ``cap``   — full xr-row crossbar column segments (CAP [7]): same
                as dense 'channel' for every layer type.

The group shapes themselves live in ``core.strategies`` as a
registry of ``GranularityStrategy`` objects; this module keeps the
selection machinery (``select_global_prune``) and thin compatibility
wrappers dispatching by name.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.strategies import (  # noqa: F401  (re-exported for compat)
    DEFAULT_GEOMETRY, GranularityStrategy, GroupSet, TileGeometry,
    available_strategies, get_strategy, register_strategy,
)

GRANULARITIES = ("filter", "channel", "index")
BASELINE_GRANULARITIES = ("ltp", "block", "cap")


def group_scores(path: str, w: np.ndarray, mask: np.ndarray,
                 granularity: str, conv: bool, block: int = 32,
                 geometry: Optional[TileGeometry] = None) -> GroupSet:
    """Compute per-group scores for one leaf (dispatch by name)."""
    return get_strategy(granularity).score(
        path, w, mask, conv=conv, geom=geometry or DEFAULT_GEOMETRY,
        block=block)


def zero_groups(mask: np.ndarray, gs: GroupSet, kill: np.ndarray
                ) -> np.ndarray:
    """Return a new leaf mask with the ``kill`` groups zeroed.

    ``kill`` has the same shape as ``gs.scores`` (bool).  The zeroing
    geometry comes from ``gs.meta`` — always the one scored with.
    """
    return get_strategy(gs.granularity).zero(mask, gs, kill)


def select_global_prune(group_sets: List[GroupSet], fraction: float,
                        remaining_weights: int) -> Dict[str, np.ndarray]:
    """Pick the lowest-scoring alive groups across all leaves until
    ~``fraction`` of ``remaining_weights`` are covered.

    Returns {path: kill bool array (same shape as that leaf's scores)}.
    """
    scores, sizes, owners = [], [], []
    for gi, gs in enumerate(group_sets):
        flat_alive = gs.alive.reshape(-1)
        flat_scores = gs.scores.reshape(-1)[flat_alive]
        flat_sizes = gs.sizes.reshape(-1)[flat_alive]
        idx = np.nonzero(flat_alive)[0]
        scores.append(flat_scores)
        sizes.append(flat_sizes)
        owners.append(np.stack([np.full(idx.shape, gi), idx], axis=1))
    if not scores:
        return {}
    scores = np.concatenate(scores)
    sizes = np.concatenate(sizes)
    owners = np.concatenate(owners)
    target = fraction * remaining_weights
    order = np.argsort(scores, kind="stable")
    csum = np.cumsum(sizes[order])
    n_kill = int(np.searchsorted(csum, target) + 1)
    n_kill = min(n_kill, len(order))
    chosen = owners[order[:n_kill]]
    kills: Dict[int, List[int]] = {}
    for gi, flat_i in chosen:
        kills.setdefault(int(gi), []).append(int(flat_i))
    out = {}
    for gi, flat_list in kills.items():
        gs = group_sets[gi]
        k = np.zeros(gs.scores.size, bool)
        k[flat_list] = True
        out[gs.path] = k.reshape(gs.scores.shape)
    return out
