"""Mask pytree → per-projection ``TilePlan`` walker.

A port of ``repro.models.plans.build_decode_plan``: the attention
(``wq/wk/wv/wo``), MLP (``up/gate/down``) and MoE groups (the stacked
expert tensors ``up/gate/down`` and the ``shared`` expert MLP).  MLA
attention carries no ``wq`` and runs dense, as in the reference.  The
plan mirrors ``params["segments"]`` so ``models.transformer`` threads
it layer by layer; the same plan drives prefill and decode.

Stacked segments run one loop body over their repeats and the experts
of a layer share one batched launch, so bitmaps are **unioned over the
repeats and expert axes**: a tile is skipped only when it is dead in
every layer and expert sharing the product.  That is conservative but
exact — pruned weights are exact zeros.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels.bsmm import GeometryError, TilePlan, make_tile_plan

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("up", "gate", "down")
_EXPERT_KEYS = ("up", "gate", "down")   # stacked (E, d, d_ff) MoE tensors


@dataclass
class PlanStats:
    """Aggregate tile accounting across every routed projection."""
    routed: int = 0             # projections with a bsmm plan
    dense_fallback: int = 0     # prunable projections left dense
    live_tiles: int = 0
    total_tiles: int = 0
    by_layer: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def skipped_tile_fraction(self) -> float:
        if self.total_tiles == 0:
            return 0.0
        return 1.0 - self.live_tiles / self.total_tiles


def _union_mask(mask) -> Optional[np.ndarray]:
    """Mask leaf (numpy array or tensor) → 2-D union over leading axes.

    A tensor is reduced one leading axis at a time, so an expanded view
    (a ticket's (K, N) mask broadcast to (reps, E, K, N)) is never
    copied to its full size; an axis of stride 0 repeats one slice, so
    its union is that slice."""
    if mask is None:
        return None
    if torch.is_tensor(mask):
        m = mask
        while m.ndim > 2:
            m = m[0] if m.stride(0) == 0 else m.any(dim=0)
        m = (m != 0).cpu().numpy()
    else:
        m = np.asarray(mask)
        if m.ndim > 2:
            m = (m != 0).any(axis=tuple(range(m.ndim - 2)))
    if m.ndim != 2:
        return None
    return m


def _plan_group(masks: Dict[str, Any], keys, label: str, stats: PlanStats,
                *, tile: int, strict: bool) -> Optional[Dict[str, TilePlan]]:
    group: Dict[str, TilePlan] = {}
    for key in keys:
        m2 = _union_mask(masks.get(key))
        if m2 is None:
            continue
        plan = make_tile_plan(m2, tile=tile, strict=strict,
                              where=f"{label}.{key}")
        if plan is None:                  # shape does not tile — stay dense
            stats.dense_fallback += 1
            continue
        group[key] = plan
        stats.routed += 1
        stats.live_tiles += plan.live_tiles
        stats.total_tiles += plan.total_tiles
        stats.by_layer.append((f"{label}.{key}", plan.live_tiles,
                               plan.total_tiles))
    return group or None


def build_decode_plan(masks, *, tile: int = MXU_TILE, strict: bool = False
                      ) -> Tuple[Optional[list], PlanStats]:
    """Mask pytree → (plan mirroring params['segments'], PlanStats).

    Returns ``(None, empty stats)`` when the masks carry no routable
    projection (MLA attention is never routed).
    """
    if tile <= 0:
        raise GeometryError(f"tile edge must be positive, got {tile}",
                            tile=tile, where="build_decode_plan")
    stats = PlanStats()
    if not isinstance(masks, dict) or "segments" not in masks:
        return None, stats
    plan: list = []
    any_entry = False
    for s_idx, pos_trees in enumerate(masks["segments"]):
        seg_plan = []
        for pos, ptree in enumerate(pos_trees):
            entry: Dict[str, Any] = {}
            if not isinstance(ptree, dict):
                seg_plan.append(None)
                continue
            attn = ptree.get("attn")
            if isinstance(attn, dict) and "wq" in attn:
                g = _plan_group(attn, _ATTN_KEYS, f"seg{s_idx}.{pos}.attn",
                                stats, tile=tile, strict=strict)
                if g:
                    entry["attn"] = g
            ffn = ptree.get("mlp")
            if isinstance(ffn, dict):
                g = _plan_group(ffn, _MLP_KEYS, f"seg{s_idx}.{pos}.mlp",
                                stats, tile=tile, strict=strict)
                if g:
                    entry["mlp"] = g
            moe = ptree.get("moe")
            if isinstance(moe, dict):
                # stacked (E, d, d_ff) expert tensors union over the
                # expert axis (and the repeats axis) into ONE shared
                # plan: the batched expert kernel runs every expert
                # with it
                g = _plan_group(moe, _EXPERT_KEYS, f"seg{s_idx}.{pos}.moe",
                                stats, tile=tile, strict=strict)
                moe_entry: Dict[str, Any] = dict(g) if g else {}
                shared = moe.get("shared")
                if isinstance(shared, dict):
                    sg = _plan_group(shared, _MLP_KEYS,
                                     f"seg{s_idx}.{pos}.moe.shared",
                                     stats, tile=tile, strict=strict)
                    if sg:
                        moe_entry["shared"] = sg
                if moe_entry:
                    entry["moe"] = moe_entry
            any_entry = any_entry or bool(entry)
            seg_plan.append(entry or None)
        plan.append(seg_plan)
    if not any_entry:
        return None, stats
    return plan, stats
