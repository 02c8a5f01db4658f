"""Crossbar mapping: how weight tensors land on 128×128 ReRAM crossbars
(port of ``repro.core.crossbar``: a numpy copy, so both packages count
the same crossbars from the same masks).

This reproduces the paper's §IV.A mapping exactly (Fig. 3a):

  * A Conv layer with OC filters of shape (IC, K, K) unrolls to a matrix
    of shape (IC·K·K, OC) — rows indexed by (ic, kx, ky) so one filter
    *channel* is a contiguous K² row block of one column; one *filter*
    is a whole column; one *index* (ic,kx,ky) is a whole row.
  * The matrix is tiled into ⌈R/xr⌉ × ⌈C/xc⌉ crossbars (xr×xc is the
    crossbar geometry — the paper's 128×128 by default; every function
    takes it as a parameter so ``PruneConfig.xbar_rows/xbar_cols``
    flows through the whole stats path).
  * A crossbar row/column can be power-gated or reused only if every
    cell in it (within that crossbar) is zero (Fig. 2).

The same 128×128 geometry is the block-sparse kernels' plan tile, and
``kernels.tile_stats`` computes each tile's liveness on the card, so
the paper's "hardware savings" and the kernels' skipped-tile counts
agree.

All functions here are host-side numpy: pruning decisions are a
one-time offline step (paper §V.C) — only mask *application* runs on
the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from repro_torch.configs.base import MXU_TILE

XBAR_ROWS = MXU_TILE
XBAR_COLS = MXU_TILE


# ---------------------------------------------------------------------------
# Weight-tensor → unrolled-matrix views
# ---------------------------------------------------------------------------
def conv_to_matrix(w: np.ndarray) -> np.ndarray:
    """(K, K, IC, OC) → (IC·K·K, OC) with rows ordered (ic, kx, ky)."""
    K1, K2, IC, OC = w.shape
    return np.transpose(w, (2, 0, 1, 3)).reshape(IC * K1 * K2, OC)


def matrix_to_conv(m: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    K1, K2, IC, OC = shape
    return np.transpose(m.reshape(IC, K1, K2, OC), (1, 2, 0, 3))


def leaf_matrices(w: np.ndarray, conv: bool = False) -> Tuple[np.ndarray, str]:
    """View a prunable leaf as a batch of unrolled matrices.

    Returns (batched matrix of shape (B, R, C), layout tag) where the
    layout tag lets ``matrices_to_leaf`` invert the view.
      * conv (K,K,IC,OC)     → (1, IC·K·K, OC)      tag 'conv'
      * 2D dense (in, out)   → (1, in, out)          tag 'dense'
      * ND stacked (…, in, out) → (prod(…), in, out) tag 'stack'

    ``conv`` must be passed explicitly (the caller knows the model);
    shape heuristics would misclassify stacked per-layer LM params.
    """
    if conv:
        assert w.ndim == 4, w.shape
        return conv_to_matrix(w)[None], "conv"
    if w.ndim == 2:
        return w[None], "dense"
    if w.ndim >= 3:
        lead = int(np.prod(w.shape[:-2]))
        return w.reshape(lead, w.shape[-2], w.shape[-1]), "stack"
    raise ValueError(f"not a prunable leaf shape: {w.shape}")


def matrices_to_leaf(m: np.ndarray, shape: Tuple[int, ...], tag: str
                     ) -> np.ndarray:
    if tag == "conv":
        return matrix_to_conv(m[0], shape)
    if tag == "dense":
        return m[0]
    return m.reshape(shape)


# ---------------------------------------------------------------------------
# Crossbar tiling of one matrix
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class XbarGrid:
    rows: int
    cols: int
    n_row_tiles: int
    n_col_tiles: int

    @property
    def n_xbars(self) -> int:
        return self.n_row_tiles * self.n_col_tiles


def grid_of(matrix_shape: Tuple[int, int], xr: int = XBAR_ROWS,
            xc: int = XBAR_COLS) -> XbarGrid:
    R, C = matrix_shape
    return XbarGrid(R, C, -(-R // xr), -(-C // xc))


def iter_xbars(R: int, C: int, xr: int = XBAR_ROWS, xc: int = XBAR_COLS
               ) -> Iterator[Tuple[int, int, slice, slice]]:
    """Yield (tile_i, tile_j, row_slice, col_slice) of the actual extents."""
    for i in range(-(-R // xr)):
        for j in range(-(-C // xc)):
            yield (i, j, slice(i * xr, min((i + 1) * xr, R)),
                   slice(j * xc, min((j + 1) * xc, C)))


# ---------------------------------------------------------------------------
# Per-crossbar savings accounting (paper Fig. 2 semantics)
# ---------------------------------------------------------------------------
@dataclass
class XbarStats:
    """Savings for one unrolled matrix (counts over actual extents)."""
    total_cells: int = 0
    nonzero_cells: int = 0
    saved_cells: int = 0          # cells in all-zero rows/cols per crossbar
    n_xbars: int = 0
    xbars_fully_free: int = 0     # whole crossbar zero → turn off
    xbars_needed_packed: int = 0  # ceil(live cell area / xbar area) (reuse)
    xbars_needed_strict: int = 0  # crossbars containing any non-zero
    live_area: int = 0            # Σ live_rows × live_cols per crossbar
    xbar_rows: int = XBAR_ROWS    # geometry the stats were computed with
    xbar_cols: int = XBAR_COLS

    def merge(self, o: "XbarStats"):
        if (o.xbar_rows, o.xbar_cols) != (self.xbar_rows, self.xbar_cols):
            raise ValueError(
                f"cannot merge XbarStats computed under different crossbar "
                f"geometries: {self.xbar_rows}x{self.xbar_cols} vs "
                f"{o.xbar_rows}x{o.xbar_cols} — recompute both at one "
                "geometry first")
        for f in ("total_cells", "nonzero_cells", "saved_cells", "n_xbars",
                  "xbars_fully_free", "xbars_needed_strict", "live_area"):
            setattr(self, f, getattr(self, f) + getattr(o, f))
        # packed count recomputed from live_area under this geometry
        self.xbars_needed_packed = -(-self.live_area
                                     // (self.xbar_rows * self.xbar_cols))


def xbar_stats(mask_matrix: np.ndarray, xr: int = XBAR_ROWS,
               xc: int = XBAR_COLS) -> XbarStats:
    """mask_matrix: (R, C) of {0,1} — 1 = weight kept."""
    R, C = mask_matrix.shape
    st = XbarStats(total_cells=R * C,
                   nonzero_cells=int(mask_matrix.sum()),
                   xbar_rows=xr, xbar_cols=xc)
    for _, _, rs, cs in iter_xbars(R, C, xr, xc):
        blk = mask_matrix[rs, cs]
        r_live = int((blk.any(axis=1)).sum())
        c_live = int((blk.any(axis=0)).sum())
        nr, nc = blk.shape
        st.n_xbars += 1
        st.saved_cells += nr * nc - r_live * c_live
        st.live_area += r_live * c_live
        if r_live == 0:
            st.xbars_fully_free += 1
        else:
            st.xbars_needed_strict += 1
    st.xbars_needed_packed = -(-st.live_area // (xr * xc))
    return st


def alive_columns(mask_matrix: np.ndarray) -> np.ndarray:
    """Columns (output units / filters) with any surviving weight."""
    return mask_matrix.any(axis=0)
