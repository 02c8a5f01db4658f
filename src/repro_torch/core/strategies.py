"""Granularity strategies: pluggable group shapes for crossbar pruning
(port of ``repro.core.strategies``: a numpy copy, so both packages
score, tie-break and zero groups identically).

The paper's granularities (§IV.B) and the baselines (§V.A) all follow
one contract on the unrolled weight matrix M (B, R, C):

  * ``score``  — per-group mean |w| over alive entries, plus the group
    sizes/liveness needed for global percentile selection;
  * ``zero``   — kill a boolean selection of groups in a leaf mask.

Each shape is a ``GranularityStrategy`` registered by name, so new
granularities (e.g. whole-crossbar ``xbar`` pruning) plug into
Algorithm 1 without touching the loop or the selection machinery.

Crossbar geometry is explicit: strategies take a ``TileGeometry``
(built from ``PruneConfig.xbar_rows/xbar_cols``) instead of reading the
module-level 128×128 constants, and record it in ``GroupSet.meta`` so
zeroing always uses the geometry the groups were scored with.

Registered names:
  filter / channel / index   — the paper's coarse→fine schedule
  ltp / block / cap          — the baselines (unstructured / BLK-REW / CAP)
  xbar                       — whole-crossbar tiles (coarsest structure)
  expert                     — whole MoE experts (one (d, d_ff) slice of a
                               stacked expert tensor per group)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.crossbar import (XBAR_COLS, XBAR_ROWS, leaf_matrices,
                                 matrices_to_leaf)


@dataclass(frozen=True)
class TileGeometry:
    """ReRAM crossbar extents (== the block-sparse kernels' plan tile)."""
    rows: int = XBAR_ROWS
    cols: int = XBAR_COLS

    @classmethod
    def from_config(cls, cfg) -> "TileGeometry":
        """Geometry from any config with xbar_rows/xbar_cols (PruneConfig)."""
        return cls(int(cfg.xbar_rows), int(cfg.xbar_cols))

    @property
    def cells(self) -> int:
        return self.rows * self.cols


DEFAULT_GEOMETRY = TileGeometry()


@dataclass
class GroupSet:
    """Flattened groups of one leaf at one granularity.

    ``scores`` — (n_groups, …) mean |w| over group entries (alive mask
                 applied by caller).
    ``sizes``  — same shape: number of surviving weights in each group.
    ``alive``  — same shape, bool: group has any surviving weight.
    ``meta``   — layout info needed to zero a group in the leaf's mask,
                 including the scoring geometry ("xr"/"xc").
    """
    path: str
    granularity: str
    scores: np.ndarray
    sizes: np.ndarray
    alive: np.ndarray
    meta: Dict


def _group_reduce(x: np.ndarray, mask: np.ndarray, axes: Tuple[int, ...]):
    """(mean|x| over alive entries, any(mask), alive count) over ``axes``."""
    absx = np.abs(x) * mask
    cnt = mask.sum(axis=axes)
    scores = absx.sum(axis=axes) / np.maximum(cnt, 1e-9)
    return scores, mask.any(axis=axes), cnt.astype(np.int64)


def _pad_to(x: np.ndarray, r: int, c: int):
    R, C = x.shape[-2:]
    pr, pc = (-R) % r, (-C) % c
    if pr or pc:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, pr), (0, pc)]
        x = np.pad(x, pad)
    return x


class GranularityStrategy:
    """One group shape: how to score groups and how to zero them."""

    name: str = ""

    def score(self, path: str, w: np.ndarray, mask: np.ndarray, *,
              conv: bool, geom: TileGeometry = DEFAULT_GEOMETRY,
              block: int = 32) -> GroupSet:
        raise NotImplementedError

    def zero(self, mask: np.ndarray, gs: GroupSet,
             kill: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- shared plumbing ---------------------------------------------------
    def _matrices(self, w, mask, conv):
        wm, tag = leaf_matrices(w, conv)
        mm, _ = leaf_matrices(mask, conv)
        return wm, mm, tag

    def _base_meta(self, w, tag, conv, wm, geom) -> Dict:
        B, R, C = wm.shape
        return {"tag": tag, "shape": w.shape, "conv": conv, "B": B,
                "R": R, "C": C, "xr": geom.rows, "xc": geom.cols}

    def _mask_matrix(self, mask, gs):
        mm, tag = leaf_matrices(mask, gs.meta["conv"])
        return mm.copy(), tag

    def _to_leaf(self, mm, gs, tag):
        return matrices_to_leaf(mm, gs.meta["shape"], tag)


_REGISTRY: Dict[str, GranularityStrategy] = {}


def register_strategy(strategy):
    """Register a strategy instance (or class) under its ``name``.

    Usable as a class decorator; later registrations replace earlier
    ones so projects can override a builtin shape.
    """
    inst = strategy() if isinstance(strategy, type) else strategy
    if not inst.name:
        raise ValueError(f"{inst!r} has no name")
    _REGISTRY[inst.name] = inst
    return strategy


def get_strategy(name: str) -> GranularityStrategy:
    if name not in _REGISTRY:
        raise KeyError(f"unknown granularity {name!r}; "
                       f"registered: {available_strategies()}")
    return _REGISTRY[name]


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# The paper's coarse→fine schedule (Algorithm 1 walks these in order);
# recipes and the legacy ``granularities=`` shims both start from it.
PAPER_SCHEDULE: Tuple[str, ...] = ("filter", "channel", "index")


def require_strategies(names) -> Tuple[str, ...]:
    """Validate a granularity schedule eagerly (recipe parse time), so a
    typo fails before any training instead of rounds in."""
    names = tuple(names)
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise KeyError(f"unknown granularities {unknown!r}; "
                       f"registered: {available_strategies()}")
    return names


# ---------------------------------------------------------------------------
# The paper's granularities
# ---------------------------------------------------------------------------
@register_strategy
class FilterStrategy(GranularityStrategy):
    """One whole column: a conv filter (IC·K·K) or a dense output unit.

    The only granularity that also removes an activation.
    """
    name = "filter"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        scores, alive, sizes = _group_reduce(wm, mm, (1,))     # (B, C)
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        mm *= ~kill[:, None, :]
        return self._to_leaf(mm, gs, tag)


@register_strategy
class ChannelStrategy(GranularityStrategy):
    """Conv: the K² rows of one input channel within one column (Fig. 3c);
    dense: the xbar-rows crossbar segment of one column.  Zeroing one
    frees a crossbar column."""
    name = "channel"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        B, R, C = wm.shape
        if conv:
            K = w.shape[0]
            ic = w.shape[2]
            wv = wm.reshape(B, ic, K * K, C)
            mv = mm.reshape(B, ic, K * K, C)
            scores, alive, sizes = _group_reduce(wv, mv, (2,))  # (B, ic, C)
            meta["kk"] = K * K
        else:
            wp, mp = (_pad_to(wm, geom.rows, 1), _pad_to(mm, geom.rows, 1))
            nt = wp.shape[1] // geom.rows
            wv = wp.reshape(B, nt, geom.rows, C)
            mv = mp.reshape(B, nt, geom.rows, C)
            scores, alive, sizes = _group_reduce(wv, mv, (2,))  # (B, nt, C)
            meta["nt"] = nt
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        B, R, C = mm.shape
        if gs.meta["conv"]:
            kk = gs.meta["kk"]
            ic = kill.shape[1]
            mv = mm.reshape(B, ic, kk, C)
            mv *= ~kill[:, :, None, :]
            mm = mv.reshape(B, R, C)
        else:
            nt, xr = gs.meta["nt"], gs.meta["xr"]
            mp = _pad_to(mm, xr, 1)
            mv = mp.reshape(B, nt, xr, C)
            mv *= ~kill[:, :, None, :]
            mm = mv.reshape(B, nt * xr, C)[:, :R, :]
        return self._to_leaf(mm, gs, tag)


@register_strategy
class IndexStrategy(GranularityStrategy):
    """One row restricted to one xbar-cols crossbar (Fig. 3d); zeroing
    one frees a crossbar row."""
    name = "index"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        B, R, C = wm.shape
        wp, mp = _pad_to(wm, 1, geom.cols), _pad_to(mm, 1, geom.cols)
        nt = wp.shape[2] // geom.cols
        wv = wp.reshape(B, R, nt, geom.cols)
        mv = mp.reshape(B, R, nt, geom.cols)
        scores, alive, sizes = _group_reduce(wv, mv, (3,))      # (B, R, nt)
        meta["nt"] = nt
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        B, R, C = mm.shape
        nt, xc = gs.meta["nt"], gs.meta["xc"]
        mp = _pad_to(mm, 1, xc)
        mv = mp.reshape(B, R, nt, xc)
        mv *= ~kill[:, :, :, None]
        mm = mv.reshape(B, R, nt * xc)[:, :, :C]
        return self._to_leaf(mm, gs, tag)


# ---------------------------------------------------------------------------
# Baselines (paper §V.A) and the whole-crossbar extension
# ---------------------------------------------------------------------------
@register_strategy
class LTPStrategy(GranularityStrategy):
    """Every single weight is its own group (unstructured LTH)."""
    name = "ltp"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        scores = np.abs(wm) * mm
        alive = mm.astype(bool)
        sizes = np.ones_like(scores, dtype=np.int64)
        return GroupSet(path, self.name, scores, sizes, alive, meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        mm *= ~kill
        return self._to_leaf(mm, gs, tag)


@register_strategy
class BlockStrategy(GranularityStrategy):
    """Square b×b blocks (BLK-REW [9] adapted to crossbars)."""
    name = "block"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        B = wm.shape[0]
        wp, mp = _pad_to(wm, block, block), _pad_to(mm, block, block)
        nr, nc = wp.shape[1] // block, wp.shape[2] // block
        wv = wp.reshape(B, nr, block, nc, block)
        mv = mp.reshape(B, nr, block, nc, block)
        scores, alive, sizes = _group_reduce(wv, mv, (2, 4))    # (B, nr, nc)
        meta["nr"], meta["nc"], meta["block"] = nr, nc, block
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        B, R, C = mm.shape
        nr, nc, blk = gs.meta["nr"], gs.meta["nc"], gs.meta["block"]
        mp = _pad_to(mm, blk, blk)
        mv = mp.reshape(B, nr, blk, nc, blk)
        mv *= ~kill[:, :, None, :, None]
        mm = mv.reshape(B, nr * blk, nc * blk)[:, :R, :C]
        return self._to_leaf(mm, gs, tag)


@register_strategy
class CapStrategy(GranularityStrategy):
    """Full xbar-rows crossbar column segments (CAP [7]): the dense
    'channel' shape for every layer type."""
    name = "cap"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        return get_strategy("channel").score(path, w, mask, conv=False,
                                             geom=geom, block=block)

    def zero(self, mask, gs, kill):  # pragma: no cover - gs says "channel"
        return get_strategy("channel").zero(mask, gs, kill)


@register_strategy
class XbarStrategy(GranularityStrategy):
    """Whole crossbars: one xr×xc tile of the unrolled matrix per group.

    The coarsest crossbar-aligned structure — killing a group turns an
    entire crossbar off (and frees a whole block-sparse kernel tile).  Not part
    of the paper's schedule; demonstrates registry pluggability and is
    useful as an aggressive first pass before 'filter'.
    """
    name = "xbar"

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        B = wm.shape[0]
        wp = _pad_to(wm, geom.rows, geom.cols)
        mp = _pad_to(mm, geom.rows, geom.cols)
        nr, nc = wp.shape[1] // geom.rows, wp.shape[2] // geom.cols
        wv = wp.reshape(B, nr, geom.rows, nc, geom.cols)
        mv = mp.reshape(B, nr, geom.rows, nc, geom.cols)
        scores, alive, sizes = _group_reduce(wv, mv, (2, 4))    # (B, nr, nc)
        meta["nr"], meta["nc"] = nr, nc
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        B, R, C = mm.shape
        nr, nc = gs.meta["nr"], gs.meta["nc"]
        xr, xc = gs.meta["xr"], gs.meta["xc"]
        mp = _pad_to(mm, xr, xc)
        mv = mp.reshape(B, nr, xr, nc, xc)
        mv *= ~kill[:, :, None, :, None]
        mm = mv.reshape(B, nr * xr, nc * xc)[:, :R, :C]
        return self._to_leaf(mm, gs, tag)


@register_strategy
class ExpertStrategy(GranularityStrategy):
    """Whole MoE experts: one (d, d_ff) slice of a stacked expert tensor
    per group (the ROADMAP's MoE expert-level pruning scenario).

    Stacked expert leaves — ``(E, d, d_ff)`` ``up``/``gate``/``down``
    tensors, or their scanned ``(reps, E, d, d_ff)`` forms — unroll to a
    batch of B matrices (``leaf_matrices`` tag 'stack'); each matrix is
    one expert in one layer, and killing a group turns that expert off
    entirely (every crossbar it occupies powers down, and the bsmm
    retrain plan drops all its tiles).  Leaves that are not routed
    expert stacks (attention, dense MLPs, convs, and the always-on
    shared-expert MLP — which processes EVERY token, so it is never a
    unit the router can route around) expose NO alive groups, so
    global percentile selection never touches them — the schedule then
    falls through to finer granularities for the rest of the network.

    Crossbar geometry does not subdivide the group (an expert is the
    unit regardless of tile shape); it is still recorded in ``meta`` for
    the accounting path.
    """
    name = "expert"

    @staticmethod
    def _is_expert_leaf(path: str, tag: str, conv: bool, B: int) -> bool:
        parts = path.lower().split("/")
        # scanned shared-expert MLPs are (reps, d, ff) stacks under
        # .../moe/shared/... — layer repeats, not routed experts
        return tag == "stack" and not conv and B > 1 and \
            "moe" in parts and "shared" not in parts

    def score(self, path, w, mask, *, conv, geom=DEFAULT_GEOMETRY, block=32):
        wm, mm, tag = self._matrices(w, mask, conv)
        meta = self._base_meta(w, tag, conv, wm, geom)
        B = wm.shape[0]
        if not self._is_expert_leaf(path, tag, conv, B):
            zeros = np.zeros((B,))
            return GroupSet(path, self.name, zeros,
                            np.zeros((B,), np.int64),
                            np.zeros((B,), bool), meta)
        scores, alive, sizes = _group_reduce(wm, mm, (1, 2))    # (B,)
        return GroupSet(path, self.name, scores, sizes,
                        alive.astype(bool), meta)

    def zero(self, mask, gs, kill):
        mm, tag = self._mask_matrix(mask, gs)
        mm *= ~kill[:, None, None]
        return self._to_leaf(mm, gs, tag)
