"""Mask pytree → training-time ``TilePlan`` pytrees (port of
``repro.train.plans``).

Once a ticket's masks are known, every retrain step's products —
forward, dx and dw — run through the block-sparse kernels and scale
with the live-tile count.  The LM plan reuses the decode-plan walker:
the training forward consumes the same structure (segments → positions
→ {"attn": {...}, "mlp": {...}}) as prefill and decode.
``cnn_train_plan`` comes with the CNN slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import MXU_TILE
from repro_torch.models.plans import PlanStats, build_decode_plan


def lm_train_plan(masks, *, tile: int = MXU_TILE
                  ) -> Tuple[Optional[list], PlanStats]:
    """Transformer mask pytree → (train plan, PlanStats).

    Stacked segments union their bitmaps over the repeats axis (see
    ``models.plans.build_decode_plan``) — conservative but exact, since
    pruned weights are exact zeros.
    """
    return build_decode_plan(masks, tile=tile)
