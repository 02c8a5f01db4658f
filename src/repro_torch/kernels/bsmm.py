"""Block-sparse matmul: the paper's "turned-off crossbar" on the H100.

A 128x128 weight tile whose crossbar is power-gated is never read and
never multiplied.  A ``TilePlan`` lists, for every output column tile j,
the live K tiles ``idx[j, :counts[j]]``; the CUDA kernels in
``csrc/bsmm.cu`` walk exactly those.  They replace the Pallas TPU
kernels of ``repro/kernels/bsmm.py``: ``_bsmm_kernel`` and
``_bsmm_epilogue_kernel`` (forward), ``_bsmm_dx_kernel`` and
``_bsmm_dw_kernel`` (backward).  ``bsmm_batched``, ``bsmm_batched_dx``
and ``bsmm_batched_dw`` are kernels #1, #3 and #4 over a stack of
experts sharing one plan, each in one launch: the counterpart of the
reference's ``jax.vmap`` of ``plan_matmul`` (and of its VJP) over the
expert axis.

Dispatch: ``bsmm``, ``bsmm_epilogue``, ``bsmm_batched``, ``bsmm_dx``,
``bsmm_dw``, ``bsmm_batched_dx`` and ``bsmm_batched_dw`` launch their
kernel for CUDA tensors and run their plain PyTorch
versions (``*_plain``) for CPU tensors; any other device raises.  The 2-D
forward (#1 and #2) takes the CUDA route ``bsmm_route`` picks from the
call's shape (weight streaming below 64 rows, TMA and ``wgmma`` for
bfloat16 from 64, CUDA-core FMA for float32) and cuts each column tile's
live list into ``bsmm_splits`` pieces, summed in split order inside the
same launch; dw (#4) takes ``bsmm_dw_route`` and cuts each live tile's
rows into ``bsmm_dw_splits`` pieces; dx (#3) takes ``bsmm_dx_route``
(TMA and ``wgmma`` for bfloat16 from 64 rows) and cuts each K-row
tile's live list into ``bsmm_dx_splits`` pieces.  The batched forward
(#1b) takes ``bsmm_batched_route`` (TMA and ``wgmma`` for bfloat16 from
64 rows an expert, weight streaming at up to 32 rows over a grid that
fills the card twice, the CUDA-core walk otherwise) and cuts lists into
``bsmm_batched_splits`` pieces; the batched dx (#3b) and dw (#4b) take
dx's and dw's rules with their grids counted over all experts.  The
batched ``wgmma`` kernels run one expert's blocks together and give a
last row block of at most 64 rows one 64-row slice.  On ``wgmma`` (and
bfloat16 dw) the pieces of a tile form one thread-block cluster and
meet in shared memory; on ``stream`` and ``fma`` they meet in a
workspace allocated once per device and stream (``_scratch``).  Those
wrappers count their launches by route in ``.launches_by_route`` and
their split launches in ``.split_launches``.
``masked_matmul`` (the reference's ``masked_matmul_pallas``, kernel #5,
``csrc/masked_matmul.cu``) is the crossbar-unaware LTP baseline beside
them: a dense grid that reads every weight and mask tile and skips only
the product of all-zero mask tiles, through the CUDA kernel that
``masked_route`` picks from the shapes (split-K streaming below 64 rows,
TMA and ``wgmma`` for bfloat16 from 64, CUDA-core FMA for float32),
counted by kernel in ``masked_matmul.launches_by_route``.  Each
wrapper counts its kernel launches in ``.launches``, and marks its
body for the lint's dispatch audit (``kernels._mark``).  ``bsmm_apply`` is
the differentiable product (a ``torch.autograd.Function``): forward
through ``bsmm``/``bsmm_epilogue``, backward through ``bsmm_dx`` and
``bsmm_dw``, on either device; ``bsmm_batched_apply`` is its
expert-batched twin, forward through ``bsmm_batched`` and backward
through ``bsmm_batched_dx`` and ``bsmm_batched_dw`` (one launch each for
all experts, each counted by route).

Every wrapper checks its operand contract (devices, dtypes, contiguity,
16-byte aligned bases) on every device, so a CPU call refuses what the
card refuses; the CUDA kernels' own limits, the 128 tile
(``kernel_tile``) and the grid's expert count (``batched_grid``), are
checked on the card route only.

The host-side plan builders (``tile_bitmap``, ``compact_tile_indices``,
``make_tile_plan``) are numpy copies of the reference's, so both
packages derive the same plan from the same mask.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build, _mark


class GeometryError(ValueError):
    """A mask/weight shape disagrees with the tile/crossbar geometry.

    Carries the offending ``shape``, the ``tile`` edge, and a ``where``
    location naming the projection."""

    def __init__(self, reason: str, *, shape=None, tile=None, where=""):
        self.reason = reason
        self.shape = None if shape is None else tuple(shape)
        self.tile = tile
        self.where = where
        parts = [reason]
        if shape is not None:
            parts.append(f"shape={self.shape}")
        if tile is not None:
            parts.append(f"tile={tile}")
        if where:
            parts.append(f"at {where}")
        super().__init__(" | ".join(parts))


def tile_bitmap(mask: np.ndarray, bk: int = MXU_TILE,
                bn: int = MXU_TILE) -> np.ndarray:
    """Elementwise {0,1} mask (K, N) → tile liveness (⌈K/bk⌉, ⌈N/bn⌉)."""
    m = np.asarray(mask) != 0
    K, N = m.shape
    pk, pn = (-K) % bk, (-N) % bn
    if pk or pn:
        m = np.pad(m, ((0, pk), (0, pn)))
    return m.reshape(m.shape[0] // bk, bk, m.shape[1] // bn, bn) \
            .any(axis=(1, 3)).astype(np.int32)


def compact_tile_indices(tile_mask: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray, int]:
    """Per column j of the (Kt, Nt) tile mask: live k indices + counts.

    Returns (idx (Nt, KMAX) int32, count (Nt,) int32, KMAX).
    Dead slots point at tile 0 and are never read.
    """
    tm = np.asarray(tile_mask) != 0
    Kt, Nt = tm.shape
    counts = tm.sum(axis=0).astype(np.int32)
    kmax = max(int(counts.max()) if Nt else 0, 1)
    idx = np.zeros((Nt, kmax), np.int32)
    for j in range(Nt):
        live = np.nonzero(tm[:, j])[0]
        idx[j, : len(live)] = live
    return idx, counts, kmax


class PlanTensors(NamedTuple):
    """A ``TilePlan``'s int32 index arrays on one device."""
    idx: torch.Tensor
    counts: torch.Tensor
    idx_t: torch.Tensor
    counts_t: torch.Tensor
    kk: torch.Tensor
    nn: torch.Tensor


@dataclass(frozen=True, eq=False)
class TilePlan:
    """Static bsmm dispatch data for one pruned (K, N) weight.

    The forward plan (``idx``/``counts``/``kmax``) steers ``x @ w`` past
    dead K tiles; the transposed plan (``idx_t``/``counts_t``/``nmax``)
    steers dx past dead N tiles and the flat live-tile coordinates
    (``kk``/``nn``) list the tiles dw computes.  ``device_tensors``
    caches the int32 copies the kernels read, once per device, and
    ``route_and_splits`` the CUDA route and split count of a call shape.
    """
    idx: np.ndarray          # (Nt, KMAX) int32 — live K-tile ids per column
    counts: np.ndarray       # (Nt,) int32
    kmax: int
    tile: int
    live_tiles: int
    total_tiles: int
    idx_t: Optional[np.ndarray] = None     # (Kt, NMAX) live N-tile ids per row
    counts_t: Optional[np.ndarray] = None  # (Kt,)
    nmax: int = 1
    kk: Optional[np.ndarray] = None        # (L,) K-tile id of each live tile
    nn: Optional[np.ndarray] = None        # (L,) N-tile id of each live tile
    _dev: Dict[torch.device, PlanTensors] = field(default_factory=dict,
                                                   repr=False)
    _split: Dict[tuple, Tuple[str, int]] = field(default_factory=dict,
                                                 repr=False)
    _launch: Dict[tuple, tuple] = field(default_factory=dict, repr=False)

    def device_tensors(self, device) -> PlanTensors:
        """Every index array as an int32 tensor on ``device``, copied
        once."""
        device = torch.device(device)
        got = self._dev.get(device)
        if got is None:
            if self.idx_t is None or self.kk is None:
                raise ValueError("TilePlan lacks backward metadata — rebuild "
                                 "it with make_tile_plan()")
            got = PlanTensors(*(
                torch.as_tensor(a, dtype=torch.int32).to(device)
                for a in (self.idx, self.counts, self.idx_t, self.counts_t,
                          self.kk, self.nn)))
            self._dev[device] = got
        return got

    def route_and_splits(self, kind: str, M: int, dtype: torch.dtype,
                         experts: int = 1) -> Tuple[str, int]:
        """``(bsmm_route, bsmm_splits)`` for the 2-D forward (``kind``
        "fwd"), ``(bsmm_batched_route, bsmm_batched_splits)`` for the
        expert-batched forward ("batched", or "fwd" with ``experts`` > 1),
        ``(bsmm_dx_route, bsmm_dx_splits)`` for dx ("dx") or
        ``(bsmm_dw_route, bsmm_dw_splits)`` for dw ("dw") at M rows of
        ``dtype`` (each of ``experts`` experts' rows, for the batched
        forms), computed once per shape."""
        if kind == "fwd" and experts > 1:
            kind = "batched"
        key = (kind, M, dtype, experts)
        got = self._split.get(key)
        if got is None:
            K = len(self.counts_t) * self.tile if self.counts_t is not None \
                else None
            N = len(self.counts) * self.tile
            if kind == "batched":
                got = (bsmm_batched_route(M, N, dtype, experts),
                       bsmm_batched_splits(M, N, dtype, self, experts))
            elif kind == "fwd":
                got = (bsmm_route(M, K, N, dtype, self),
                       bsmm_splits(M, K, N, dtype, self))
            elif kind == "dx":
                got = (bsmm_dx_route(M, dtype),
                       bsmm_dx_splits(M, K, N, dtype, self, experts))
            else:
                got = (bsmm_dw_route(dtype),
                       bsmm_dw_splits(self.live_tiles, M, dtype, experts))
            self._split[key] = got
        return got

    def launch_consts(self, M: int, dtype: torch.dtype) -> tuple:
        """The 2-D forward's (route, splits, route code, counters, kmax)
        at M rows of ``dtype``: one lookup a call."""
        key = (M, dtype)
        got = self._launch.get(key)
        if got is None:
            route, S = self.route_and_splits("fwd", M, dtype)
            per_col, rows = _route_blocks(route, M)
            got = (route, S, _BSMM_ROUTES[route],
                   len(self.counts) * per_col * rows, self.kmax)
            self._launch[key] = got
        return got


def make_tile_plan(mask: np.ndarray, *, tile: int = MXU_TILE,
                   strict: bool = False,
                   where: str = "make_tile_plan") -> Optional[TilePlan]:
    """Elementwise {0,1} mask (K, N) → ``TilePlan``.

    A shape that does not tile evenly returns ``None`` (the caller's
    dense path) — or, with ``strict=True``, raises ``GeometryError``.
    An invalid ``tile`` always raises.
    """
    if tile <= 0:
        raise GeometryError(f"tile edge must be positive, got {tile}",
                            tile=tile, where=where)
    m = np.asarray(mask)
    if m.ndim != 2:
        if strict:
            raise GeometryError("mask must be 2-D to tile",
                                shape=m.shape, tile=tile, where=where)
        return None
    K, N = m.shape
    if K == 0 or N == 0 or K % tile or N % tile:
        if strict:
            raise GeometryError("mask shape does not tile evenly",
                                shape=m.shape, tile=tile, where=where)
        return None
    bitmap = tile_bitmap(m, tile, tile)
    idx, counts, kmax = compact_tile_indices(bitmap)
    idx_t, counts_t, nmax = compact_tile_indices(bitmap.T)
    kk, nn = np.nonzero(bitmap)
    return TilePlan(idx=idx, counts=counts, kmax=kmax, tile=tile,
                    live_tiles=int(bitmap.sum()),
                    total_tiles=int(bitmap.size),
                    idx_t=idx_t, counts_t=counts_t, nmax=nmax,
                    kk=kk.astype(np.int32), nn=nn.astype(np.int32))


# ---------------------------------------------------------------------------
# Epilogue activations (f32 accumulator → act → output dtype)
# ---------------------------------------------------------------------------
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}


def _check_act(act: Optional[str]) -> None:
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue act {act!r}; "
                         f"known: {sorted(k for k in _ACT_CODES if k)}")


def _epilogue(z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    _check_act(act)
    if act == "relu":
        return torch.relu(z)
    if act == "gelu":                      # jax.nn.gelu's default tanh form
        return F.gelu(z, approximate="tanh")
    if act == "silu":
        return F.silu(z)
    return z


# ---------------------------------------------------------------------------
# Plain versions: the same function, column tile by column tile
# ---------------------------------------------------------------------------
def _live_tile_product(x2: torch.Tensor, w: torch.Tensor,
                       plan: TilePlan) -> torch.Tensor:
    """f32 (M, N) = Σ over live tiles only, as the kernel sums."""
    M, K = x2.shape
    N = w.shape[1]
    T = plan.tile
    xt = x2.reshape(M, K // T, T)
    wt = w.reshape(K // T, T, N)
    out = torch.zeros((M, N), dtype=torch.float32, device=x2.device)
    for j in range(N // T):
        c = int(plan.counts[j])
        if c == 0:
            continue
        live = torch.as_tensor(plan.idx[j, :c], dtype=torch.long,
                               device=x2.device)
        xg = xt.index_select(1, live).reshape(M, c * T).float()
        wg = wt.index_select(0, live)[:, :, j * T:(j + 1) * T] \
            .reshape(c * T, T).float()
        out[:, j * T:(j + 1) * T] = xg @ wg
    return out


def bsmm_plain(x2: torch.Tensor, w: torch.Tensor,
               plan: TilePlan) -> torch.Tensor:
    """Plain version of kernel #1: ``x2 @ (w ⊙ tile bitmap)``, f32
    accumulation, output in x2's dtype."""
    return _live_tile_product(x2, w, plan).to(x2.dtype)


def bsmm_epilogue_plain(x2: torch.Tensor, w: torch.Tensor, plan: TilePlan,
                        bias: Optional[torch.Tensor],
                        act: Optional[str]) -> torch.Tensor:
    """Plain version of kernel #2: the product, ``+ bias`` in f32, the
    activation in f32, then the cast."""
    z = _live_tile_product(x2, w, plan)
    if bias is not None:
        z = z + bias.float()
    return _epilogue(z, act).to(x2.dtype)


def bsmm_batched_plain(a: torch.Tensor, w: torch.Tensor,
                       plan: TilePlan) -> torch.Tensor:
    """Plain version of the expert-batched kernel #1: ``a[e] (M, K) @
    (w[e] (K, N) ⊙ tile bitmap)`` for every expert e, one plan for all,
    f32 accumulation, output (E, M, N) in a's dtype."""
    E, M, K = a.shape
    N = w.shape[2]
    T = plan.tile
    at = a.reshape(E, M, K // T, T)
    wt = w.reshape(E, K // T, T, N)
    out = torch.zeros((E, M, N), dtype=torch.float32, device=a.device)
    for j in range(N // T):
        c = int(plan.counts[j])
        if c == 0:
            continue
        live = torch.as_tensor(plan.idx[j, :c], dtype=torch.long,
                               device=a.device)
        ag = at.index_select(2, live).reshape(E, M, c * T).float()
        wg = wt[..., j * T:(j + 1) * T].index_select(1, live) \
            .reshape(E, c * T, T).float()
        out[..., j * T:(j + 1) * T] = torch.bmm(ag, wg)
    return out.to(a.dtype)


def bsmm_batched_dx_plain(g: torch.Tensor, w: torch.Tensor,
                          plan: TilePlan) -> torch.Tensor:
    """Plain version of the expert-batched kernel #3: ``g[e] (M, N) @
    (w[e] (K, N) ⊙ tile bitmap)ᵀ`` → (E, M, K) for every expert e, one
    plan for all, K-row tile by K-row tile over its live N tiles, f32
    accumulation, output in g's dtype."""
    E, M, N = g.shape
    K = w.shape[1]
    T = plan.tile
    gt = g.reshape(E, M, N // T, T)
    out = torch.zeros((E, M, K), dtype=torch.float32, device=g.device)
    for k in range(K // T):
        c = int(plan.counts_t[k])
        if c == 0:
            continue
        live = torch.as_tensor(plan.idx_t[k, :c], dtype=torch.long,
                               device=g.device)
        gg = gt.index_select(2, live).reshape(E, M, c * T).float()
        wk = w[:, k * T:(k + 1) * T].reshape(E, T, N // T, T) \
            .index_select(2, live).reshape(E, T, c * T).float()
        out[..., k * T:(k + 1) * T] = torch.bmm(gg, wk.transpose(1, 2))
    return out.to(g.dtype)


def bsmm_dx_plain(g: torch.Tensor, w: torch.Tensor,
                  plan: TilePlan) -> torch.Tensor:
    """Plain version of kernel #3: ``g (M, N) @ (w ⊙ tile bitmap)ᵀ`` →
    (M, K), the batched plain version at one expert."""
    return bsmm_batched_dx_plain(g[None], w[None], plan)[0]


def bsmm_batched_dw_plain(x: torch.Tensor, g: torch.Tensor,
                          plan: TilePlan) -> torch.Tensor:
    """Plain version of the expert-batched kernel #4: for each expert e
    and live tile l of the shared plan, ``x[e][:, kk[l]]ᵀ @ g[e][:,
    nn[l]]`` in f32, written into a zero dense (E, K, N) grad in x's dtype
    (the weight's); tiles dead in the plan stay zero."""
    E, M, K = x.shape
    N = g.shape[2]
    T = plan.tile
    Kt, Nt = K // T, N // T
    dw = torch.zeros((E, Kt, Nt, T, T), dtype=torch.float32, device=x.device)
    if plan.live_tiles:
        kk = torch.as_tensor(plan.kk, dtype=torch.long, device=x.device)
        nn = torch.as_tensor(plan.nn, dtype=torch.long, device=x.device)
        xg = x.reshape(E, M, Kt, T).index_select(2, kk).float()  # (E, M, L, T)
        gg = g.reshape(E, M, Nt, T).index_select(2, nn).float()  # (E, M, L, T)
        dw[:, kk, nn] = torch.einsum("emlk,emln->elkn", xg, gg)
    return dw.permute(0, 1, 3, 2, 4).reshape(E, K, N).to(x.dtype)


def bsmm_dw_plain(x2: torch.Tensor, g: torch.Tensor,
                  plan: TilePlan) -> torch.Tensor:
    """Plain version of kernel #4: the (K, N) weight grad of ``x2 @ w``,
    live tiles only, the batched plain version at one expert."""
    return bsmm_batched_dw_plain(x2[None], g[None], plan)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("bsmm")
    lib.bsmm2d_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP]
    lib.bsmm2d_launch.restype = _I
    lib.bsmm_batched_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _VP]
    lib.bsmm_batched_launch.restype = _I
    lib.bsmm_dx_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                   _I, _I, _VP]
    lib.bsmm_dx_launch.restype = _I
    lib.bsmm_dw_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                   _I, _I, _I, _I, _VP]
    lib.bsmm_dw_launch.restype = _I
    lib.bsmm_batched_dx_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                           _I, _I, _I, _I, _I, _VP]
    lib.bsmm_batched_dx_launch.restype = _I
    lib.bsmm_batched_dw_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                           _I, _I, _I, _I, _I, _I, _I, _VP]
    lib.bsmm_batched_dw_launch.restype = _I
    lib.bsmm_wgmma_smem.argtypes = [_I]
    lib.bsmm_wgmma_smem.restype = _I
    return lib


def wgmma_smem_bytes(alone: bool) -> int:
    """Dynamic shared memory a block of the wgmma kernels (the 2-D
    forward's ``wgmma`` route, bfloat16 dx and dw) asks for (builds the
    library): a ring of 32 KB stages, its barriers and 1 KB of
    alignment; three stages, so that two blocks fit an SM, in a grid of
    more blocks than the card has SMs, six where each block has its SM
    to itself (``alone``)."""
    return _lib().bsmm_wgmma_smem(int(alone))


# ---------------------------------------------------------------------------
# Routes and splits of the 2-D forward (#1, #2) and of dw (#4), chosen on
# the host from the call's shape and plan alone
# ---------------------------------------------------------------------------
#: SMs of the H100; the split rules size their grids by it
_SMS = 132
#: below this many rows the 2-D forward (and kernel #5) streams weights
_STREAM_M = 64
#: the 2-D forward's route codes (csrc/bsmm.cu bsmm2d_launch)
_BSMM_ROUTES = {"stream": 0, "fma": 1, "wgmma": 2}
_DW_ROUTES = ("wgmma", "fma")
#: dx's route codes (csrc/bsmm.cu bsmm_dx_launch)
_DX_ROUTES = {"simt": 0, "wgmma": 1}
_STREAM_COLS = 32       # columns a block of the stream route
_WGMMA_ROWS = 128       # rows a block of the wgmma route
_FMA_ROWS = 64          # rows a block of the CUDA-core routes (#1, #5)
#: pieces at most of one 128 x 128 output tile on wgmma, fma and dw
#: (wgmma's and bf16 dw's pieces form one thread-block cluster)
_MAX_TILE_PIECES = 4
#: blocks of the stream route an SM holds at once (its launch bounds)
_STREAM_PER_SM = 3
#: the least tiles (forward) or 64/32-row steps (dw) a piece of the
#: longest list keeps: shorter pieces cost more than they save
#: (measured on the H100: PERF.md)
_MIN_PIECE_TILES = 2
_MIN_PIECE_STEPS = 16
#: split grids of the wgmma route keep to one block an SM with room for
#: the pieces' clusters to pack into the card's GPCs
_CLUSTER_GRID = 96
#: split grids of the fma route keep to four blocks an SM
_FMA_PER_SM = 4


def bsmm_route(M: int, K: int, N: int, dtype: torch.dtype,
               plan: TilePlan) -> str:
    """Which CUDA kernel computes the 2-D forward (#1 and #2) at M rows
    of ``dtype``, by the name ``bsmm.launches_by_route`` counts it under:

    - ``"stream"``: every M < 64 (decode rows), both dtypes: each column
      tile's live list split into pieces, weights streamed through a
      ``cp.async`` ring;
    - ``"wgmma"``: bfloat16 from 64 rows, TMA and ``wgmma``;
    - ``"fma"``: float32 from 64 rows, on the CUDA cores (no TF32).

    ``K``, ``N`` and ``plan`` do not change the route (the batched form
    and dx keep their own kernels)."""
    if M < _STREAM_M:
        return "stream"
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def split_pieces(count: int, S: int) -> Tuple[Tuple[int, int], ...]:
    """The pieces ``[t0, t1)`` of a live list of ``count`` tiles cut for
    ``S`` splits: ``min(S, max(count, 1))`` contiguous pieces of whole
    tiles whose sizes differ by at most one (an empty list is one empty
    piece).  The kernels cut every column tile's list (and dw every
    tile's rows) by this rule."""
    parts = min(S, max(count, 1))
    return tuple((z * count // parts, (z + 1) * count // parts)
                 for z in range(parts))


def _route_blocks(route: str, M: int) -> Tuple[int, int]:
    """(blocks a column tile, row blocks) of a route's grid at M rows."""
    if route == "stream":
        return MXU_TILE // _STREAM_COLS, -(-M // (8 if M <= 8 else 32))
    return 1, -(-M // (_WGMMA_ROWS if route == "wgmma" else _FMA_ROWS))


def bsmm_splits(M: int, K: int, N: int, dtype: torch.dtype,
                plan: TilePlan) -> int:
    """How many pieces the 2-D forward cuts each column tile's live list
    into at (M, K, N, dtype, plan) (1: no split).  A column's list is cut
    into ``split_pieces(counts[j], S)``, never more pieces than it has
    tiles; only the blocks of live columns work.

    Every piece of the longest list keeps at least 2 tiles.

    - ``stream``: the most pieces (up to 16) whose working blocks all
      stay resident at once, 3 an SM on the card's 132 SMs: one round of
      blocks, each streaming as many tiles as that allows;
    - ``wgmma``: the most pieces, at most 4, whose grid stays within 96
      blocks (one block an SM, with room for the pieces' clusters to
      pack into the card's GPCs);
    - ``fma``: the most pieces, at most 4, within four blocks an SM.

    The caps come from timing every split count on the H100 (PERF.md).

    A function of the shape and the plan alone, so a call is bitwise
    repeatable at a fixed (M, K, N, plan)."""
    route = bsmm_route(M, K, N, dtype, plan)
    per_col, rows = _route_blocks(route, M)
    counts = np.asarray(plan.counts)
    top = int(counts.max()) if counts.size else 0

    def working(S):
        return per_col * rows * int(np.minimum(counts, S).sum())

    longest = max(1, top // _MIN_PIECE_TILES)
    if route == "stream":
        return max([S for S in range(1, min(longest, 16) + 1)
                    if working(S) <= _STREAM_PER_SM * _SMS] or [1])
    grid = (N // MXU_TILE) * rows
    cap = min(_MAX_TILE_PIECES, longest)
    per = _CLUSTER_GRID if route == "wgmma" else _FMA_PER_SM * _SMS
    return max(1, min(cap, per // grid))


def bsmm_dx_route(M: int, dtype: torch.dtype) -> str:
    """dx's CUDA kernel (``bsmm_dx.launches_by_route``): ``"wgmma"``
    (TMA and ``wgmma``, w read K-major) for bfloat16 from 64 rows,
    ``"simt"`` (the CUDA-core transposed walk) for float32 and for
    bfloat16 below 64 rows."""
    return "wgmma" if dtype == torch.bfloat16 and M >= _STREAM_M else "simt"


def bsmm_dx_splits(M: int, K: int, N: int, dtype: torch.dtype,
                   plan: TilePlan, experts: int = 1) -> int:
    """How many pieces dx cuts each K-row tile's live N list
    (``counts_t``) into, under the forward's ``wgmma`` rule: at most 4,
    each piece of the longest list keeping 2 tiles, the grid (K / 128
    column tiles x 128-row blocks, times ``experts`` for the batched dx,
    whose M is each expert's rows) within 96 blocks; 1 on ``simt``.  A
    function of the shape and the plan alone."""
    if bsmm_dx_route(M, dtype) != "wgmma":
        return 1
    counts = np.asarray(plan.counts_t)
    top = int(counts.max()) if counts.size else 0
    grid = experts * (K // MXU_TILE) * -(-M // _WGMMA_ROWS)
    cap = min(_MAX_TILE_PIECES, max(1, top // _MIN_PIECE_TILES))
    return max(1, min(cap, _CLUSTER_GRID // grid))


#: the expert-batched forward's route codes (csrc/bsmm.cu
#: bsmm_batched_launch)
_BATCHED_ROUTES = {"stream": 0, "simt": 1, "wgmma": 2}
#: rows an expert up to which the batched forward may stream weights
#: (four 8-row blocks of the streaming kernel)
_BATCHED_STREAM_M = 32


def bsmm_batched_route(M: int, N: int, dtype: torch.dtype,
                       experts: int) -> str:
    """Which CUDA kernel computes the expert-batched forward (#1b) at M
    rows an expert of ``dtype`` over ``experts`` experts and N output
    columns, by the name ``bsmm_batched.launches_by_route`` counts it
    under:

    - ``"wgmma"``: bfloat16 from 64 rows (training capacity): TMA and
      ``wgmma`` over 3-D maps, one launch for all experts;
    - ``"stream"``: at most 32 rows (decode, MoE prefill) of more than
      one expert where the grid of experts x column tiles x 8-row blocks
      fills the card twice: each live weight tile streamed through
      registers;
    - ``"simt"``: every other call (float32 from 33 rows or on a
      narrow grid, bfloat16 at 33-63 rows or on a narrow grid): the
      CUDA-core tile walk.

    Like every rule here it counts the H100 SXM's ``_SMS`` = 132 SMs,
    not the running card's, so that the route (and with it the bits) is
    a function of the shape alone."""
    if dtype == torch.bfloat16 and M >= _STREAM_M:
        return "wgmma"
    blocks = experts * (N // MXU_TILE) * -(-M // 8)
    if experts > 1 and M <= _BATCHED_STREAM_M and blocks >= 2 * _SMS:
        return "stream"
    return "simt"


def bsmm_batched_splits(M: int, N: int, dtype: torch.dtype, plan: TilePlan,
                        experts: int) -> int:
    """How many pieces the batched forward cuts each column tile's live
    list into: on ``wgmma`` the 2-D forward's ``wgmma`` rule with the
    grid (column tiles x 128-row blocks) counted over all ``experts``
    experts (at most 4 pieces, each piece of the longest list keeping 2
    tiles, the grid within 96 blocks: at MoE shapes it is 1); 1 on
    ``stream`` and ``simt``.  A function of the shape and the plan
    alone."""
    if bsmm_batched_route(M, N, dtype, experts) != "wgmma":
        return 1
    counts = np.asarray(plan.counts)
    top = int(counts.max()) if counts.size else 0
    grid = experts * (N // MXU_TILE) * -(-M // _WGMMA_ROWS)
    cap = min(_MAX_TILE_PIECES, max(1, top // _MIN_PIECE_TILES))
    return max(1, min(cap, _CLUSTER_GRID // grid))


def bsmm_dw_route(dtype: torch.dtype) -> str:
    """dw's CUDA kernel (``bsmm_dw.launches_by_route``): ``"wgmma"`` (TMA
    and ``wgmma``) for bfloat16, ``"fma"`` (CUDA cores) for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def bsmm_dw_splits(L: int, M: int, dtype: torch.dtype,
                   experts: int = 1) -> int:
    """How many pieces dw cuts each live tile's rows (its contraction)
    into: pieces only while the grid of ``L`` tiles (of each of
    ``experts`` experts, for the batched dw, whose M is each expert's
    rows) stays within one block an SM, at most 4, each keeping at least
    16 row steps (64 rows bfloat16, 32 float32: shorter pieces measured
    slower); else 1."""
    if L <= 0:
        return 1
    steps = -(-M // (64 if dtype == torch.bfloat16 else 32))
    return max(1, min(_MAX_TILE_PIECES, steps // _MIN_PIECE_STEPS,
                      _SMS // (experts * L)))


#: the split workspace and counters, one pair per (device, stream):
#: launches on one stream run in order, so they share it (like a BLAS
#: library's workspace), and every caller of the kernels uses the same
_SCRATCH: Dict[Tuple[torch.device, int],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, ws_numel: int,
             counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 workspace that split pieces of the ``stream`` and ``fma``
    kernels store their partial tiles in and the int32 counters that find
    the last piece of an output block, of ``device`` and ``stream``:
    allocated once and grown, never per call.  The kernels leave the
    counters at zero.  They grow outside any graph capture only: warm a
    call up on the capturing stream first, and replay no graph captured
    before they grew."""
    key = (device, stream)
    got = _SCRATCH.get(key)
    if got is None or got[0].numel() < ws_numel or got[1].numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "bsmm: the split workspace must grow outside graph capture "
                "(call once on this stream before capturing)")
        have = (0, 0) if got is None else (got[0].numel(), got[1].numel())
        got = (torch.empty(max(ws_numel, have[0], 1), dtype=torch.float32,
                           device=device),
               torch.zeros(max(counters, have[1], 1), dtype=torch.int32,
                           device=device))
        _SCRATCH[key] = got
    return got


def _check_operands(x2, w, plan: TilePlan, bias, where: str):
    if x2.ndim != 2 or w.ndim != 2:
        raise GeometryError("bsmm takes x (M, K) and w (K, N)",
                            shape=(*x2.shape, *w.shape), where=where)
    M, K = x2.shape
    if w.shape[0] != K:
        raise GeometryError("x/w contraction dims disagree",
                            shape=(K, w.shape[0]), where=where)
    N = w.shape[1]
    if (plan.counts.shape[0] * plan.tile != N
            or (plan.counts_t is not None
                and plan.counts_t.shape[0] * plan.tile != K)):
        raise GeometryError("TilePlan does not cover the weight",
                            shape=(K, N), tile=plan.tile, where=where)
    if x2.dtype != w.dtype or x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"{where}: x and w must share float32 or bfloat16, "
                        f"got {x2.dtype} and {w.dtype}")
    if x2.device != w.device:
        raise ValueError(f"{where}: x on {x2.device}, w on {w.device}")
    if bias is not None and (bias.dtype != x2.dtype or bias.numel() != N
                             or bias.device != x2.device):
        raise ValueError(f"{where}: bias must be ({N},) {x2.dtype} on "
                         f"{x2.device}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError(f"{where}: bias must be contiguous")


def _check_layout(where: str, *ts) -> None:
    """The kernels' operand layout, checked on every device: contiguous
    operands whose bases are 16-byte aligned (the kernels load 16 bytes
    at a time)."""
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{where}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{where}: operands must be 16-byte aligned (the "
                         "kernel loads 16 bytes at a time)")


def kernel_tile(where: str, *edges: int) -> None:
    """The tile edges the CUDA kernels take: 128 (the plain versions take
    any edge the shapes tile by)."""
    if any(e != MXU_TILE for e in edges):
        raise GeometryError(f"the CUDA kernel tiles at {MXU_TILE}",
                            tile=edges[0] if len(edges) == 1 else edges,
                            where=where)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_2d(x2, w, plan: TilePlan, bias, act, epi: int,
               where: str) -> Tuple[torch.Tensor, str, int]:
    """Launch the 2-D forward on the route and split count ``plan``
    gives the call's shape; returns (out, route, splits)."""
    kernel_tile(where, plan.tile)
    device = x2.device
    dev = plan.device_tensors(device)
    M, K = x2.shape
    N = w.shape[1]
    route, S, code, counters, kmax = plan.launch_consts(M, x2.dtype)
    stream = _stream(x2)
    out = torch.empty((M, N), dtype=x2.dtype, device=device)
    ws = cnt = None
    if S > 1 and route != "wgmma":     # wgmma's pieces meet in a cluster
        ws, cnt = _scratch(device, stream, S * M * N, counters)
        ws, cnt = ws.data_ptr(), cnt.data_ptr()
    lib = _lib()
    err = lib.bsmm2d_launch(
        x2.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), ws, cnt, dev.idx.data_ptr(), dev.counts.data_ptr(), M,
        K, N, kmax, _DTYPE_CODES[x2.dtype], epi, _ACT_CODES[act], code, S,
        stream)
    if err:
        _build.check(lib, err, where)
    return out, route, S


@_mark.marked
def bsmm(x2: torch.Tensor, w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Kernel #1: ``x2 (M, K) @ (w ⊙ tile bitmap) (K, N)`` in x2's dtype,
    on the CUDA route ``bsmm_route`` names, each column tile's live list
    cut as ``bsmm_splits`` says."""
    _check_operands(x2, w, plan, None, "bsmm")
    _check_layout("bsmm", x2, w)
    if x2.device.type == "cpu":
        return bsmm_plain(x2, w, plan)
    if x2.device.type != "cuda":
        raise ValueError(f"bsmm: unsupported device {x2.device}")
    out, route, S = _launch_2d(x2, w, plan, None, None, 0, "bsmm")
    bsmm.launches += 1
    bsmm.launches_by_route[route] += 1
    bsmm.split_launches += S > 1
    return out


bsmm.launches = 0
#: launches by the kernel that ran (``bsmm_route``'s names)
bsmm.launches_by_route = {k: 0 for k in _BSMM_ROUTES}
#: launches whose live lists were cut (``bsmm_splits`` > 1)
bsmm.split_launches = 0


@_mark.marked
def bsmm_epilogue(x2: torch.Tensor, w: torch.Tensor, plan: TilePlan,
                  bias: Optional[torch.Tensor] = None,
                  act: Optional[str] = None) -> torch.Tensor:
    """Kernel #2: kernel #1 with ``+ bias`` and relu/gelu/silu fused into
    the flush, in the f32 accumulator (after the split pieces' sum)."""
    _check_act(act)
    _check_operands(x2, w, plan, bias, "bsmm_epilogue")
    _check_layout("bsmm_epilogue", x2, w)
    if x2.device.type == "cpu":
        return bsmm_epilogue_plain(x2, w, plan, bias, act)
    if x2.device.type != "cuda":
        raise ValueError(f"bsmm_epilogue: unsupported device {x2.device}")
    out, route, S = _launch_2d(x2, w, plan, bias, act, 1, "bsmm_epilogue")
    bsmm_epilogue.launches += 1
    bsmm_epilogue.launches_by_route[route] += 1
    bsmm_epilogue.split_launches += S > 1
    return out


bsmm_epilogue.launches = 0
bsmm_epilogue.launches_by_route = {k: 0 for k in _BSMM_ROUTES}
bsmm_epilogue.split_launches = 0


_MAX_GRID_Z = 65535     # experts one batched launch takes (CUDA grid z)


def batched_grid(E: int, where: str = "bsmm_batched") -> None:
    """The expert count one batched launch (forward, dx or dw) takes:
    the CUDA grid's z extent (the plain versions take any)."""
    if E > _MAX_GRID_Z:
        raise GeometryError(f"{where} takes at most {_MAX_GRID_Z} experts",
                            shape=(E,), where=where)


@_mark.marked
def bsmm_batched(a: torch.Tensor, w: torch.Tensor,
                 plan: TilePlan) -> torch.Tensor:
    """Kernel #1 batched over experts: ``a (E, M, K)`` and ``w (E, K, N)``
    → ``out[e] = a[e] @ (w[e] ⊙ tile bitmap)``, (E, M, N) in a's dtype,
    in ONE launch over all experts, on the CUDA route
    ``bsmm_batched_route`` names, each column tile's live list cut as
    ``bsmm_batched_splits`` says.  The plan is shared: build it from the
    union of the expert masks (``models.plans``)."""
    if a.ndim != 3 or w.ndim != 3 or a.shape[0] != w.shape[0]:
        raise GeometryError("bsmm_batched takes a (E, M, K) and w (E, K, N)",
                            shape=(*a.shape, *w.shape), where="bsmm_batched")
    E, M, K = a.shape
    _check_operands(a[0], w[0], plan, None, "bsmm_batched")
    _check_layout("bsmm_batched", a, w)
    N = w.shape[2]
    if a.device.type == "cpu":
        return bsmm_batched_plain(a, w, plan)
    if a.device.type != "cuda":
        raise ValueError(f"bsmm_batched: unsupported device {a.device}")
    batched_grid(E, "bsmm_batched")
    kernel_tile("bsmm_batched", plan.tile)
    stream = _stream(a)
    dev = plan.device_tensors(a.device)
    route, S = plan.route_and_splits("batched", M, a.dtype, E)
    lib = _lib()
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    code = lib.bsmm_batched_launch(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   dev.idx.data_ptr(), dev.counts.data_ptr(),
                                   E, M, K, N, plan.kmax,
                                   _DTYPE_CODES[a.dtype],
                                   _BATCHED_ROUTES[route], S, stream)
    _build.check(lib, code, "bsmm_batched")
    _count(bsmm_batched, route, S)
    return out


bsmm_batched.launches = 0
#: launches by the kernel that ran (``bsmm_batched_route``'s names)
bsmm_batched.launches_by_route = {k: 0 for k in _BATCHED_ROUTES}
#: launches whose live lists were cut (``bsmm_batched_splits`` > 1)
bsmm_batched.split_launches = 0


def _check_grad_operands(a, b, plan: TilePlan, where: str,
                         batched: bool = False):
    """``a`` (M, A) and ``b`` (M, B) with the plan covering (A, B)
    (dw: x and g) — or, for dx, (M, N) and the (K, N) weight; with
    ``batched``, each with a leading expert axis of one length."""
    nd = 3 if batched else 2
    if a.ndim != nd or b.ndim != nd or (batched and a.shape[0] != b.shape[0]):
        raise GeometryError(f"{where} takes {nd}-D operands"
                            + (" of one expert count" if batched else ""),
                            shape=(*a.shape, *b.shape), where=where)
    if plan.counts_t is None or plan.kk is None:
        raise ValueError(f"{where}: TilePlan lacks backward metadata — "
                         "rebuild it with make_tile_plan()")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"{where}: operands must share float32 or bfloat16, "
                        f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{where}: operands on {a.device} and {b.device}")


def _plan_covers(plan: TilePlan, K: int, N: int) -> bool:
    return (plan.counts.shape[0] * plan.tile == N
            and plan.counts_t.shape[0] * plan.tile == K)


def _dx(g, w, plan: TilePlan, where: str, batched: bool):
    """dx of ``g`` and ``w`` (2-D, or with an expert axis when
    ``batched``): the plain version on the CPU, else one launch.
    Returns (dx, route, splits), route None for the plain version."""
    _check_grad_operands(g, w, plan, where, batched)
    *_, M, N = g.shape
    K = w.shape[-2]
    if w.shape[-1] != N or not _plan_covers(plan, K, N):
        raise GeometryError(f"{where}: g, w and the TilePlan disagree",
                            shape=(*g.shape, *w.shape), tile=plan.tile,
                            where=where)
    _check_layout(where, g, w)
    if g.device.type == "cpu":
        plain = bsmm_batched_dx_plain if batched else bsmm_dx_plain
        return plain(g, w, plan), None, 0
    if g.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {g.device}")
    E = g.shape[0] if batched else 1
    batched_grid(E, where)
    kernel_tile(where, plan.tile)
    stream = _stream(g)
    dev = plan.device_tensors(g.device)
    route, S = plan.route_and_splits("dx", M, g.dtype, E)
    lib = _lib()
    out = torch.empty((*g.shape[:-1], K), dtype=g.dtype, device=g.device)
    args = (g.data_ptr(), w.data_ptr(), out.data_ptr(), dev.idx_t.data_ptr(),
            dev.counts_t.data_ptr())
    shape = (M, K, N, plan.nmax, _DTYPE_CODES[g.dtype], _DX_ROUTES[route], S)
    code = (lib.bsmm_batched_dx_launch(*args, E, *shape, stream) if batched
            else lib.bsmm_dx_launch(*args, *shape, stream))
    _build.check(lib, code, where)
    return out, route, S


def _dw(x, g, plan: TilePlan, where: str, batched: bool):
    """dw of ``x`` and ``g`` (2-D, or with an expert axis when
    ``batched``) into a zeroed grad: the plain version on the CPU, else
    one launch (none when no tile is live).  Returns (dw, route, splits),
    route None where no kernel ran."""
    _check_grad_operands(x, g, plan, where, batched)
    *_, M, K = x.shape
    N = g.shape[-1]
    if g.shape[-2] != M or not _plan_covers(plan, K, N):
        raise GeometryError(f"{where}: x, g and the TilePlan disagree",
                            shape=(*x.shape, *g.shape), tile=plan.tile,
                            where=where)
    _check_layout(where, x, g)
    if x.device.type == "cpu":
        plain = bsmm_batched_dw_plain if batched else bsmm_dw_plain
        return plain(x, g, plan), None, 0
    if x.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {x.device}")
    E = x.shape[0] if batched else 1
    batched_grid(E, where)
    kernel_tile(where, plan.tile)
    stream = _stream(x)
    out = torch.zeros((*x.shape[:-2], K, N), dtype=x.dtype, device=x.device)
    L = plan.live_tiles
    if L == 0:                          # nothing live: no launch
        return out, None, 0
    route, S = plan.route_and_splits("dw", M, x.dtype, E)
    ws = cnt = None
    if S > 1 and route == "fma":        # wgmma's pieces meet in a cluster
        ws, cnt = _scratch(x.device, stream,
                           E * S * L * MXU_TILE * MXU_TILE, E * L)
    dev = plan.device_tensors(x.device)
    lib = _lib()
    args = (x.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(), dev.kk.data_ptr(),
            dev.nn.data_ptr())
    tail = (L, M, K, N, _DTYPE_CODES[x.dtype], S, stream)
    code = (lib.bsmm_batched_dw_launch(*args, E, *tail) if batched
            else lib.bsmm_dw_launch(*args, *tail))
    _build.check(lib, code, where)
    return out, route, S


def _count(fn, route: Optional[str], S: int) -> None:
    """One launch of ``fn``'s kernel on ``route`` (none: no launch)."""
    if route is None:
        return
    fn.launches += 1
    fn.launches_by_route[route] += 1
    fn.split_launches += S > 1


@_mark.marked
def bsmm_dx(g: torch.Tensor, w: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Kernel #3: ``g (M, N) @ (w ⊙ tile bitmap)ᵀ`` → (M, K) in g's
    dtype, over the transposed plan's live N tiles only, on the CUDA
    route ``bsmm_dx_route`` names, each K-row tile's live list cut as
    ``bsmm_dx_splits`` says."""
    out, route, S = _dx(g, w, plan, "bsmm_dx", False)
    _count(bsmm_dx, route, S)
    return out


bsmm_dx.launches = 0
#: launches by the kernel that ran (``bsmm_dx_route``'s names)
bsmm_dx.launches_by_route = {k: 0 for k in _DX_ROUTES}
#: launches whose live lists were cut (``bsmm_dx_splits`` > 1)
bsmm_dx.split_launches = 0


@_mark.marked
def bsmm_batched_dx(g: torch.Tensor, w: torch.Tensor,
                    plan: TilePlan) -> torch.Tensor:
    """Kernel #3 batched over experts: ``g (E, M, N)`` and ``w (E, K, N)``
    → ``dx[e] = g[e] @ (w[e] ⊙ tile bitmap)ᵀ``, (E, M, K) in g's dtype,
    in ONE launch, the plan shared (the union of the expert masks).  The
    route is ``bsmm_dx_route`` at each expert's M rows; the split count
    ``bsmm_dx_splits`` with the grid counted over all E experts (96
    blocks hold few experts, so at MoE shapes it is 1)."""
    out, route, S = _dx(g, w, plan, "bsmm_batched_dx", True)
    _count(bsmm_batched_dx, route, S)
    return out


bsmm_batched_dx.launches = 0
bsmm_batched_dx.launches_by_route = {k: 0 for k in _DX_ROUTES}
bsmm_batched_dx.split_launches = 0


@_mark.marked
def bsmm_dw(x2: torch.Tensor, g: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Kernel #4: the (K, N) weight grad of ``x2 (M, K) @ w`` for the
    cotangent ``g (M, N)``, live tiles only, in x2's dtype; dead tiles
    are exactly zero (never computed).  The CUDA kernel is
    ``bsmm_dw_route``'s, each tile's rows cut as ``bsmm_dw_splits``
    says and the pieces summed in order."""
    out, route, S = _dw(x2, g, plan, "bsmm_dw", False)
    _count(bsmm_dw, route, S)
    return out


bsmm_dw.launches = 0
#: launches by the kernel that ran (``bsmm_dw_route``'s names)
bsmm_dw.launches_by_route = {k: 0 for k in _DW_ROUTES}
#: launches whose rows were cut (``bsmm_dw_splits`` > 1)
bsmm_dw.split_launches = 0


@_mark.marked
def bsmm_batched_dw(x: torch.Tensor, g: torch.Tensor,
                    plan: TilePlan) -> torch.Tensor:
    """Kernel #4 batched over experts: the (E, K, N) grads of ``x[e] (M,
    K) @ w[e]`` for the cotangents ``g (E, M, N)`` on the live tiles of
    the shared plan (the union of the expert masks), in x's dtype, in
    ONE launch; tiles dead in the plan are exactly zero.  A tile live in
    the union but dead in one expert's own mask gets that expert's
    nonzero grad there, as the reference's does: the masked optimizer
    zeroes it.  The route is ``bsmm_dw_route``'s; the split count
    ``bsmm_dw_splits`` with the grid counted over all E experts."""
    out, route, S = _dw(x, g, plan, "bsmm_batched_dw", True)
    _count(bsmm_batched_dw, route, S)
    return out


bsmm_batched_dw.launches = 0
bsmm_batched_dw.launches_by_route = {k: 0 for k in _DW_ROUTES}
bsmm_batched_dw.split_launches = 0


# ---------------------------------------------------------------------------
# The crossbar-unaware LTP baseline: every tile read, dead tiles skip the math
# ---------------------------------------------------------------------------
_MASK_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2,
               torch.uint8: 2}


def _check_masked(x, w, mask, bm: int, bk: int, bn: int):
    if x.ndim != 2 or w.ndim != 2 or mask.shape != w.shape:
        raise GeometryError("masked_matmul takes x (M, K), w (K, N) and a "
                            "mask shaped like w",
                            shape=(*x.shape, *w.shape, *mask.shape),
                            where="masked_matmul")
    M, K = x.shape
    N = w.shape[1]
    if w.shape[0] != K:
        raise GeometryError("x/w contraction dims disagree",
                            shape=(K, w.shape[0]), where="masked_matmul")
    if min(bm, bk, bn) <= 0 or M % bm or K % bk or N % bn:
        raise GeometryError(f"shapes must tile {(bm, bk, bn)}",
                            shape=(M, K, N), where="masked_matmul")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"masked_matmul: x and w must share float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if not x.device == w.device == mask.device:
        raise ValueError(f"masked_matmul: x on {x.device}, w on {w.device}, "
                         f"mask on {mask.device}")


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        bk: int = MXU_TILE, bn: int = MXU_TILE) -> torch.Tensor:
    """Plain version of kernel #5: ``x @ (w ⊙ mask)`` with the product
    taken in w's dtype, every (bk, bn) tile whose mask is all zero
    contributing nothing (a skipped tile adds no term, whatever w holds
    there), f32 accumulation, output in x's dtype."""
    K, N = w.shape
    live = (mask != 0).reshape(K // bk, bk, N // bn, bn).any(dim=3) \
        .any(dim=1)
    keep = live.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    wm = torch.where(keep, w * mask.to(w.dtype), torch.zeros((), dtype=w.dtype,
                                                            device=w.device))
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


#: the C entry point's kernel codes (csrc/masked_matmul.cu)
_MASKED_KERNELS = {"stream": 0, "fma": 1, "wgmma": 2}


def _masked_row_blocks(M: int) -> int:
    """Row blocks of kernel #5's grid at M rows: the streaming kernel
    takes 8 or 32 rows a block, the CUDA-core kernel 64."""
    if M < _STREAM_M:
        rows = 8 if M <= 8 else 32
    else:
        rows = _FMA_ROWS
    return -(-M // rows)


def masked_splits(M: int, K: int, N: int) -> Tuple[Tuple[int, int], ...]:
    """The K-splits of kernel #5's launch at (M, K, N), as (k0, k1) row
    ranges: each a whole number of 128-row tiles, none empty, together
    covering [0, K).  Below 64 rows the grid (column tiles x row blocks
    x splits) covers at least two waves of the card's 132 SMs, and at up
    to 8 rows as many blocks as three to an SM where that is more (the
    streaming kernel holds three there, so a grid of up to 396 blocks
    runs in one round); at 64 rows or more the CUDA-core route splits
    only when its grid would fill less than one wave, and the wgmma
    route never splits.  It depends on the shape alone, never on the
    data, so a call is bitwise repeatable at a fixed (M, K, N); a row's
    bits may change with M."""
    kt, cols, rows = K // MXU_TILE, N // MXU_TILE, _masked_row_blocks(M)
    g = cols * rows
    if M < _STREAM_M:
        per_sm = 3 if M <= 8 else 1         # blocks an SM holds
        s = max(-(-2 * _SMS // g), per_sm * _SMS // g)
    elif g < _SMS:
        s = -(-_SMS // g)
    else:
        s = 1
    s = max(1, min(kt, s))
    per = -(-kt // s)
    return tuple((k * MXU_TILE, min(k + per, kt) * MXU_TILE)
                 for k in range(0, kt, per))


def masked_route(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """Which CUDA kernel computes kernel #5 at (M, K, N, dtype), by the
    name ``masked_matmul.launches_by_route`` counts it under:

    - ``"stream"``: every M < 64 (decode rows), both dtypes: split-K
      weight streaming;
    - ``"wgmma"``: bfloat16 at M >= 64 (TMA and ``wgmma``), never split;
    - ``"fma"``: float32 at M >= 64 on the CUDA cores, split where
      ``masked_splits`` cuts K (its grid would fill less than one
      wave)."""
    if M < _STREAM_M:
        return "stream"
    return "wgmma" if dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def _masked_lib():
    lib = _build.library("masked_matmul")
    lib.masked_matmul_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                         _I, _I, _I, _I, _I, _VP]
    lib.masked_matmul_launch.restype = _I
    lib.masked_matmul_wgmma_smem.argtypes = [_I]
    lib.masked_matmul_wgmma_smem.restype = _I
    return lib


def masked_wgmma_smem_bytes(mask_dtype: torch.dtype) -> int:
    """Dynamic shared memory of kernel #5's wgmma route for a mask of
    ``mask_dtype``, as its launch asks for it (builds the library)."""
    return _masked_lib().masked_matmul_wgmma_smem(_MASK_CODES[mask_dtype])


@_mark.marked
def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, *,
                  bm: int = MXU_TILE, bk: int = MXU_TILE,
                  bn: int = MXU_TILE) -> torch.Tensor:
    """Kernel #5 (the reference's ``masked_matmul_pallas``):
    ``x (M, K) @ (w ⊙ mask) (K, N)`` over a dense grid of (bm, bk, bn)
    tiles, f32 accumulation, output in x's dtype.  Every tile of w and
    of the mask is read; the product is skipped only for a (bk, bn)
    tile whose mask is all zero — the crossbar-unaware LTP baseline's
    cost.  Raises ``GeometryError`` when M, K or N do not tile.  The
    CUDA kernels tile at (bk, bn) = (128, 128) and mask ragged rows
    themselves, so ``bm`` only sets which row counts are accepted.  The
    kernel is chosen by ``masked_route`` and K is cut by
    ``masked_splits``, from the shapes alone; the split partials are
    summed in split order, so two calls give the same bits."""
    _check_masked(x, w, mask, bm, bk, bn)
    if mask.dtype not in _MASK_CODES:
        raise TypeError(f"masked_matmul: the mask must be float32, "
                        f"bfloat16 or one byte a value, got {mask.dtype}")
    _check_layout("masked_matmul", x, w, mask)
    if x.device.type == "cpu":
        return masked_matmul_plain(x, w, mask, bk, bn)
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul: unsupported device {x.device}")
    kernel_tile("masked_matmul", bk, bn)
    M, K = x.shape
    N = w.shape[1]
    route = masked_route(M, K, N, x.dtype)
    splits = ((0, K),) if route == "wgmma" else masked_splits(M, K, N)
    per = (splits[0][1] - splits[0][0]) // MXU_TILE
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((len(splits), M, N), dtype=torch.float32,
                     device=x.device) if len(splits) > 1 else None
    lib = _masked_lib()
    code = lib.masked_matmul_launch(
        x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, K, N,
        _DTYPE_CODES[x.dtype], _MASK_CODES[mask.dtype],
        _MASKED_KERNELS[route], per, len(splits),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "masked_matmul")
    masked_matmul.launches += 1
    masked_matmul.launches_by_route[route] += 1
    masked_matmul.split_launches += len(splits) > 1
    return out


masked_matmul.launches = 0
#: launches by the kernel that ran (``masked_route``'s names)
masked_matmul.launches_by_route = {k: 0 for k in _MASKED_KERNELS}
#: launches whose K was cut (``masked_splits``), whichever kernel ran
masked_matmul.split_launches = 0


# ---------------------------------------------------------------------------
# The differentiable product (the reference's custom_vjp, bsmm.py:484-558)
# ---------------------------------------------------------------------------
def _act_vjp(z: torch.Tensor, g: torch.Tensor, act: str) -> torch.Tensor:
    """Pull ``g`` back through the activation at ``z``, in z's dtype."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        return torch.autograd.grad(_epilogue(zz, act), zz, g)[0]


def _forward(x2, w, plan: TilePlan, bias, act):
    """Kernel #1 when there is neither bias nor activation, else #2."""
    if bias is None and act is None:
        return bsmm(x2, w, plan)
    return bsmm_epilogue(x2, w, plan, bias, act)


class BsmmApply(torch.autograd.Function):
    """``x (..., K) @ (w ⊙ tile bitmap) (+ bias, act)``: forward through
    kernel #1 (or #2 with a bias or an activation), backward through #3
    (dx) and #4 (dw).  With an activation the backward recomputes the
    pre-activation block-sparsely through kernel #2 with no activation
    and pulls the cotangent through the activation in x's dtype; with a
    bias it returns ``db = dz.sum(0)`` beside dx and dw."""

    @staticmethod
    def forward(ctx, x, w, bias, plan, act):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        ctx.plan, ctx.act = plan, act
        ctx.save_for_backward(x2, w, bias)
        return _forward(x2, w, plan, bias, act) \
            .reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x2, w, bias = ctx.saved_tensors
        plan, act = ctx.plan, ctx.act
        dz = g.reshape(-1, g.shape[-1]).contiguous()
        if act is not None:
            z = bsmm_epilogue(x2, w, plan, bias, None)
            dz = _act_vjp(z, dz, act).contiguous()
        dx = bsmm_dx(dz, w, plan).to(x2.dtype)
        dw = bsmm_dw(x2, dz, plan).to(w.dtype)
        db = None if bias is None else dz.sum(0).to(bias.dtype)
        return dx.reshape(*g.shape[:-1], x2.shape[1]), dw, db, None, None


class BsmmBatchedApply(torch.autograd.Function):
    """``a[e] (C, K) @ (w[e] ⊙ tile bitmap) (K, N)`` for every expert e,
    one shared plan: forward through the batched kernel #1, backward
    through the batched #3 (da) and #4 (dw), each one launch for all
    experts — the port's counterpart of the reference's ``jax.vmap`` of
    ``plan_matmul``'s custom VJP over the expert axis."""

    @staticmethod
    def forward(ctx, a, w, plan):
        ctx.plan = plan
        ctx.save_for_backward(a, w)
        return bsmm_batched(a, w, plan)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.contiguous()
        da = bsmm_batched_dx(g, w, ctx.plan).to(a.dtype)
        dw = bsmm_batched_dw(a, g, ctx.plan).to(w.dtype)
        return da, dw, None


def bsmm_batched_apply(a, w, plan: TilePlan):
    """Differentiable expert-batched ``a (E, C, K) @ (w (E, K, N) ⊙ tile
    bitmap)`` → (E, C, N).  The backward always computes both grads (a
    fixed number of launches a step); dw is zero on tiles dead in the
    plan.  With gradients off the forward kernel is called directly."""
    if plan.idx_t is None or plan.kk is None:
        raise ValueError("TilePlan lacks backward metadata — rebuild it "
                         "with make_tile_plan()")
    a = a.contiguous()
    if not torch.is_grad_enabled():
        return bsmm_batched(a, w, plan)
    return BsmmBatchedApply.apply(a, w, plan)


def bsmm_apply(x, w, plan: TilePlan, bias=None, act: Optional[str] = None):
    """Differentiable ``x (..., K) @ (w ⊙ tile bitmap) (K, N)``.

    Forward and both backward products run block-sparse, so a retrain
    step's cost scales with the live tiles in every pass.  The backward
    is exact for the tile-masked product: dw is zero on dead tiles
    (never computed).  The backward always computes dx and dw, so a
    step launches a fixed number of kernels.  With gradients off
    (serving runs under ``torch.inference_mode()``) the forward kernel
    is called directly: no autograd node, nothing saved.
    """
    if plan.idx_t is None or plan.kk is None:
        raise ValueError("TilePlan lacks backward metadata — rebuild it "
                         "with make_tile_plan()")
    _check_act(act)
    if not torch.is_grad_enabled():
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return _forward(x2, w, plan, bias, act) \
            .reshape(*x.shape[:-1], w.shape[1])
    return BsmmApply.apply(x, w, bias, plan, act)


def plan_matmul(x, w, plan: Optional[TilePlan], bias=None,
                act: Optional[str] = None):
    """x (..., K) @ w (K, N) routed through the block-sparse kernel.

    ``plan=None`` is the dense path: ``x @ w``, then bias and activation
    unfused in x's dtype, as the reference does.  With a plan the call
    goes through ``bsmm_apply`` (differentiable on either device): the
    rows are flattened and handed to ``bsmm`` (no bias, no activation)
    or ``bsmm_epilogue``; the kernels mask a ragged row count
    themselves, so rows are not padded.
    """
    if plan is None:
        out = x @ w
        if bias is not None:
            out = out + bias
        return _epilogue(out, act)
    K = x.shape[-1]
    N = w.shape[-1]
    planK = plan.counts_t.shape[0] * plan.tile \
        if plan.counts_t is not None else None
    planN = plan.counts.shape[0] * plan.tile
    if w.shape[-2] != K:
        raise GeometryError("x/w contraction dims disagree",
                            shape=(K, w.shape[-2]), where="plan_matmul")
    if N != planN or (planK is not None and K != planK):
        raise GeometryError(
            f"TilePlan covers ({planK}, {planN}) but the weight is "
            f"({K}, {N}) — plan built from different masks?",
            shape=(K, N), tile=plan.tile, where="plan_matmul")
    return bsmm_apply(x, w, plan, bias=bias, act=act)
