"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

``bsmm_ref`` is the block-sparse product's oracle; ``bsmm.py``,
``tile_stats.py`` and ``paged_attention.py`` keep each kernel's plain
version beside it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MXU_TILE


def expand_tile_mask(tile_mask, bk: int, bn: int, K: int, N: int):
    """(K/bk, N/bn) {0,1} → (K, N) elementwise mask."""
    m = torch.as_tensor(tile_mask)
    m = m.repeat_interleave(bk, dim=0).repeat_interleave(bn, dim=1)
    return m[:K, :N]


def bsmm_ref(x, w, tile_mask, bk: int = MXU_TILE, bn: int = MXU_TILE):
    """Block-sparse matmul oracle: x @ (w ⊙ expand(tile_mask)), f32
    accumulation, output in x's dtype.

    x: (M, K); w: (K, N); tile_mask: (ceil(K/bk), ceil(N/bn)).
    """
    K, N = w.shape
    m = expand_tile_mask(torch.as_tensor(tile_mask, device=w.device)
                         .to(w.dtype), bk, bn, K, N)
    return torch.matmul(x.float(), (w * m).float()).to(x.dtype)


def masked_matmul_ref(x, w, mask):
    """Elementwise-masked matmul oracle: ``x @ (w ⊙ mask)`` with f32
    accumulation, output in x's dtype."""
    wm = w * mask.to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def tile_stats_ref(w, bk: int = MXU_TILE, bn: int = MXU_TILE):
    """Per (bk, bn) tile: (any-nonzero, Σ|w|) — oracle for tile_stats.

    w: (K, N) → (nt_k, nt_n) bool liveness + (nt_k, nt_n) f32 |w| sums,
    ragged edges zero-padded (``tile_stats_plain`` with a bool
    liveness, as the reference's oracle returns it)."""
    from repro_torch.kernels.tile_stats import tile_stats_plain
    live, sums = tile_stats_plain(w, bk, bn)
    return live.bool(), sums
