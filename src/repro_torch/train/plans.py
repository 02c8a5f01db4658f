"""Mask pytree → training-time ``TilePlan`` pytrees (port of
``repro.train.plans``).

Once a ticket's masks are known, every retrain step's products —
forward, dx and dw — run through the block-sparse kernels and scale
with the live-tile count.  The LM plan reuses the decode-plan walker:
the training forward consumes the same structure (segments → positions
→ {"attn": {...}, "mlp": {...}}) as prefill and decode.
``cnn_train_plan`` plans a CNN's FC layers and head (its convs stay on
cuDNN; their crossbar accounting lives in ``core.crossbar``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels.bsmm import make_tile_plan
from repro_torch.models.plans import PlanStats, build_decode_plan


def lm_train_plan(masks, *, tile: int = MXU_TILE
                  ) -> Tuple[Optional[list], PlanStats]:
    """Transformer mask pytree → (train plan, PlanStats).

    Stacked segments union their bitmaps over the repeats axis (see
    ``models.plans.build_decode_plan``) — conservative but exact, since
    pruned weights are exact zeros.
    """
    return build_decode_plan(masks, tile=tile)


def cnn_train_plan(masks, *, tile: int = MXU_TILE
                   ) -> Tuple[Optional[dict], PlanStats]:
    """CNN mask pytree → ({"fc": [plan|None, ...], "head": plan|None},
    PlanStats) for ``models.cnn.forward`` — or (None, stats) when no FC
    or head weight is routable (shapes that don't tile stay dense).
    Mask leaves may be numpy arrays or tensors."""
    stats = PlanStats()
    if not isinstance(masks, dict):
        return None, stats

    def leaf_plan(entry: Any, label: str):
        m = entry.get("w") if isinstance(entry, dict) else None
        if m is None:
            return None
        m = (m != 0).cpu().numpy() if torch.is_tensor(m) else np.asarray(m)
        if m.ndim != 2:
            return None
        plan = make_tile_plan(m, tile=tile)
        if plan is None:
            stats.dense_fallback += 1
            return None
        stats.routed += 1
        stats.live_tiles += plan.live_tiles
        stats.total_tiles += plan.total_tiles
        stats.by_layer.append((label, plan.live_tiles, plan.total_tiles))
        return plan

    fc = [leaf_plan(e, f"fc.{j}") for j, e in enumerate(masks.get("fc", []))]
    head = leaf_plan(masks.get("head"), "head")
    if head is None and not any(p is not None for p in fc):
        return None, stats
    return {"fc": fc, "head": head}, stats
