"""Per-tile statistics of a weight: liveness and Σ|w| per crossbar tile
(port of ``repro.kernels.tile_stats``).

For every (bk, bn) tile of a (K, N) weight, ``live`` (int32) says
whether any entry is nonzero and ``sums`` (float32) holds Σ|w|: the
device-side form of ``core.crossbar.xbar_stats`` (``live.sum()`` is its
``xbars_needed_strict``).  ``tile_stats_for_config`` takes the tile
extents from a ``PruneConfig``'s crossbar geometry.  A ragged last row
or column of tiles reads as zero.

Dispatch: ``tile_stats`` launches the CUDA kernel of
``csrc/tile_stats.cu`` (the replacement of the reference's Pallas
``_tile_stats_kernel``) for a CUDA tensor and runs ``tile_stats_plain``
for a CPU tensor; any other device raises.  The operand contract (a
contiguous float32 or bfloat16 weight) is checked on every device.  It
counts its launches in ``tile_stats.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build, _mark

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(w: torch.Tensor, bk: int, bn: int) -> None:
    if w.ndim != 2:
        raise ValueError(f"tile_stats takes a 2-D weight, got {tuple(w.shape)}")
    if bk <= 0 or bn <= 0:
        raise ValueError(f"tile extents must be positive, got ({bk}, {bn})")
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"tile_stats takes float32 or bfloat16, got {w.dtype}")


def tile_stats_plain(w: torch.Tensor, bk: int = MXU_TILE,
                     bn: int = MXU_TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: zero-pad to whole tiles, then per tile
    ``any(w != 0)`` (int32) and ``Σ|w|`` in float32."""
    _check(w, bk, bn)
    K, N = w.shape
    wp = F.pad(w.float(), (0, (-N) % bn, 0, (-K) % bk))
    kt, nt = wp.shape[0] // bk, wp.shape[1] // bn
    tiles = wp.reshape(kt, bk, nt, bn)
    sums = tiles.abs().sum(dim=(1, 3))
    live = (tiles != 0).any(dim=3).any(dim=1).to(torch.int32)
    return live, sums


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("tile_stats")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_stats_launch.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    lib.tile_stats_launch.restype = i
    return lib


@_mark.marked
def tile_stats(w: torch.Tensor, *, bk: int = MXU_TILE,
               bn: int = MXU_TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #9: w (K, N) → (live (⌈K/bk⌉, ⌈N/bn⌉) int32, sums of |w|
    (same shape) float32)."""
    _check(w, bk, bn)
    if not w.is_contiguous():
        raise ValueError("tile_stats: w must be contiguous")
    if w.device.type == "cpu":
        return tile_stats_plain(w, bk, bn)
    if w.device.type != "cuda":
        raise ValueError(f"tile_stats: unsupported device {w.device}")
    K, N = w.shape
    shape = (-(-K // bk), -(-N // bn))
    live = torch.empty(shape, dtype=torch.int32, device=w.device)
    sums = torch.empty(shape, dtype=torch.float32, device=w.device)
    lib = _lib()
    code = lib.tile_stats_launch(
        w.data_ptr(), live.data_ptr(), sums.data_ptr(), K, N, bk, bn,
        _DTYPE_CODES[w.dtype], torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(lib, code, "tile_stats")
    tile_stats.launches += 1
    return live, sums


tile_stats.launches = 0


def tile_stats_for_config(w: torch.Tensor, prune_cfg):
    """Tile stats at a ``PruneConfig``'s crossbar geometry
    (``xbar_rows`` × ``xbar_cols``), so the device-side bitmap agrees
    with the host-side ``xbar_stats`` accounting for the same config."""
    return tile_stats(w, bk=int(prune_cfg.xbar_rows),
                      bn=int(prune_cfg.xbar_cols))
