"""Public wrappers around the block-sparse kernels (port of
``repro.kernels.ops``).

``sparse_dense`` is the drop-in replacement for ``x @ w`` once a weight
has been ReaLPruned: it derives the tile plan from the mask (host side)
and runs the differentiable block-sparse product.  Shapes that do not
tile fall back to the dense masked oracle, as in the reference.
``tile_stats`` is the device-side per-tile (liveness, Σ|w|), kernel #9.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import ref
from repro_torch.kernels.bsmm import (make_tile_plan, plan_matmul,  # noqa: F401
                                      tile_bitmap)
from repro_torch.kernels.tile_stats import tile_stats  # noqa: F401


def tile_density(mask: np.ndarray, bk: int = MXU_TILE,
                 bn: int = MXU_TILE) -> float:
    """Fraction of live tiles — the kernels' compute/bandwidth cost."""
    return float(tile_bitmap(mask, bk, bn).mean())


def sparse_dense(x, w, mask: np.ndarray, *, bk: int = MXU_TILE,
                 bn: int = MXU_TILE):
    """x (..., K) @ pruned w (K, N) skipping dead 128×128 tiles.

    ``mask``: host numpy elementwise {0,1} (static — pruning is offline).
    Differentiable: forward and both backward products run block-sparse
    (``bsmm.bsmm_apply``); the explicit ``w * mask`` keeps the weight
    gradient elementwise-exact against the dense masked oracle.  Ragged
    K/N (or rectangular tiles) fall back to the dense oracle.
    """
    K, N = w.shape
    plan = make_tile_plan(mask, tile=bk) if bk == bn else None
    m = torch.as_tensor(np.asarray(mask), dtype=w.dtype, device=w.device)
    if plan is None:
        lead = x.shape[:-1]
        out = ref.masked_matmul_ref(x.reshape(-1, K), w, m)
        return out.reshape(*lead, N)
    return plan_matmul(x, w * m, plan)
