"""Launch specs: what each CUDA launch of the port reads, writes and
holds, block by block — the object ``analysis.kernel_audit`` checks
(the counterpart of ``repro.kernels.spec``'s ``KernelSpec``).

A ``LaunchSpec`` describes one launch of one kernel at concrete shapes:
its grid, threads a block, cluster and dynamic shared memory, its
accumulator and partial dtypes, and for every block of the grid the
output rectangles it finally writes, the operand rectangles it reads
(through the plan's lists or the block table) and whether it does work.
Split pieces of one output block carry a common ``meets`` key and meet
in a ``"workspace"`` (the last piece to finish writes the block) or in
a ``"cluster"`` (each rank writes its own rows).

The specs are built from the wrappers' own host rules — ``bsmm_route``,
``bsmm_splits``, ``split_pieces``, ``_route_blocks``, the dx, dw and
batched routes and splits, ``masked_route``/``masked_splits``,
``fused_route``/``fused_wgmma_smem_bytes`` — never copies of them.  The
block geometry that lives only in the ``.cu`` launchers (rows and
columns a block, ring stages, the shared-memory plans) is written down
once here; on the card ``chip_smoke.py`` holds every default case to
its kernel (NaN sentinels, the libraries' shared-memory figures).

Every rectangle is ``(r0, r1, c0, c1)`` in a 2-D view of its tensor:
x (M, K), w (K, N), out (M, N); experts stack on the rows ((E·M, K),
(E·K, N)); a paged pool is (P·T, Hkv·d), an attention operand (B·S,
H·d).  Numpy only: nothing here touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import bsmm as _bsmm
from repro_torch.kernels import paged_attention as _paged

Rect = Tuple[int, int, int, int]            # (r0, r1, c0, c1)
Read = Tuple[str, Rect]                     # (operand, rectangle)

#: dynamic shared memory one H100 block may take (the .cu static_asserts)
SMEM_LIMIT = _paged._SMEM_LIMIT
#: meeting places of split pieces
MEETS = ("workspace", "cluster")
_T = MXU_TILE
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


@dataclass(frozen=True)
class Block:
    """One block of a launch's grid."""
    coord: Tuple[int, int, int]             # blockIdx (x, y, z)
    works: bool                             # runs past its early return
    writes: Tuple[Rect, ...] = ()           # output it finally writes
    reads: Tuple[Read, ...] = ()
    cls: Tuple[int, ...] = ()               # the output block it serves
    meets: Optional[Tuple[int, ...]] = None  # split group (pieces of cls)
    flops: float = 0.0
    partial_bytes: int = 0                  # f32 partial stored to global


@dataclass(frozen=True)
class LaunchSpec:
    """The full launch geometry of one CUDA kernel call."""
    name: str
    kernel: str                             # the kernel table's "#1" ...
    route: str
    grid: Tuple[int, int, int]
    threads: int
    cluster: Tuple[int, int, int]
    smem: int                               # dynamic shared memory, bytes
    splits: int
    meet: str                               # "workspace" | "cluster"
    operands: Dict[str, Tuple[int, int]]    # name -> 2-D extent
    itemsize: Dict[str, int]                # name -> bytes an element
    output: str                             # the written operand
    region: np.ndarray = field(repr=False)  # (R, C) bool: must be written
    blocks: Tuple[Block, ...] = field(repr=False)
    acc_dtype: str = "float32"
    state_dtype: str = "float32"            # partials / softmax state
    table: Optional[np.ndarray] = field(default=None, repr=False)
    pool_blocks: int = 0                    # P of a paged pool

    def working(self):
        return [b for b in self.blocks if b.works]


# ---------------------------------------------------------------------------
# Shared memory of the .cu launchers (written once here; chip_smoke.py
# holds the wgmma figures to the libraries' own)
# ---------------------------------------------------------------------------
_RING_STAGE = 4 * 64 * 128                  # bsmm.cu wg::STAGE: 32 KB
_RING_SHARED, _RING_ALONE = 3, 6


def ring_smem(grid_blocks: int) -> int:
    """bsmm.cu ``wg::Ring<ST>::SMEM`` of a grid: 6 stages where each
    block has its SM (at most the card's SMs), else 3."""
    st = _RING_ALONE if grid_blocks <= _bsmm._SMS else _RING_SHARED
    return st * _RING_STAGE + 16 * st + 1024


def stream2d_smem(dtype: torch.dtype, BM: int) -> int:
    """bsmm.cu ``Stream2d<T, BM>::SMEM``: 6 cp.async stages of a
    32-column w slab and BM x rows."""
    e = _ELEM[dtype]
    tc = dtype == torch.bfloat16 and BM == 8
    R = (256 // 16) * (16 // e)
    rowb = 32 * e
    gpad = 64 if (not tc and rowb == 64) else 0
    w = R * rowb + 16 * gpad
    x = BM * (R * e + (16 if tc else 0))
    return 6 * (w + x)


def masked_stream_smem(dtype: torch.dtype, mask_itemsize: int,
                       BM: int) -> int:
    """masked_matmul.cu ``Stream<T, MT, BM>::SMEM``."""
    e = _ELEM[dtype]
    R = 32 if e == 2 else 16
    return 4 * (R * _T * e + R * _T * mask_itemsize + BM * R * e)


def masked_wgmma_smem(mask_itemsize: int) -> int:
    """masked_matmul.cu ``wg::Plan<MT>::SMEM`` (256-row blocks)."""
    box = 64 * 128
    stage = 256 * 128 + 2 * box + mask_itemsize * box
    stages = min(4, (SMEM_LIMIT - 1024 - 64) // stage)
    return stages * stage + 16 * stages + 1024


_FLASH_BK = {(1, 1): 128, (2, 1): 128, (2, 2): 128, (3, 1): 128,
             (3, 2): 128, (3, 3): 64, (4, 1): 64, (4, 2): 64, (4, 3): 64,
             (4, 4): 64}


def flash_wgmma_geometry(hd: int, dv: int) -> Tuple[int, int]:
    """(keys a tile, dynamic shared memory) of flash_attention.cu's
    bf16 instantiation at (hd, dv): ``wg::Plan<HC, DC, BK>``."""
    hc, dc = -(-hd // 64), -(-dv // 64)
    bk = _FLASH_BK[(hc, dc)]
    q = hc * 128 * 128
    k = hc * bk * 128
    v = dc * bk * 128
    return bk, q + 2 * k + 2 * v + 8 * (1 + 2 * 2) + 1024


def flash_f32_smem(hd: int, dv: int) -> int:
    """flash_attention.cu ``launch_f32``'s shared memory."""
    nc = next(n for lim, n in ((32, 2), (64, 4), (128, 8), (192, 12),
                               (256, 16)) if dv <= lim)
    return 4 * (2 * hd * 68 + 64 * 68 + 64 * 16 * nc)


def paged_simt_smem(geo, elem: int, fused: bool) -> int:
    """paged_attention.cu ``launch``'s shared memory (the rule
    ``_check_kernel_geometry`` checks)."""
    g = min(geo.Hq // geo.Hkv, _paged._GB)
    tg = _paged._THREADS // (geo.dv // 2)
    smem = 4 * (g * (geo.hd + geo.T) + tg * g * geo.dv + 2 * g)
    return smem if fused else smem + elem * geo.T * (geo.hd + geo.dv)


# ---------------------------------------------------------------------------
# Block-sparse products (#1, #2, #1b, #3, #3b, #4, #4b)
# ---------------------------------------------------------------------------
def block_geometry(kind: str, route: str, M: int) -> Tuple[int, int]:
    """(rows, columns) one output block of a block-sparse walk covers at
    M rows, as the .cu launchers set them: ``kind`` "fwd" (the 2-D
    forward), "batched" (#1b) or "dx"; ``route`` the wrapper's."""
    if route == "wgmma":
        return _T, _T
    if route == "fma":
        return _bsmm._FMA_ROWS, _T
    if route == "stream":               # 2-D: 8 or 32 rows of 32 columns
        return ((8 if M <= 8 else 32, _bsmm._STREAM_COLS) if kind == "fwd"
                else (8, _T))           # #1b: bsmm_stream_kernel, 8 rows
    return (_T, _T) if M >= _T else (16, 32)   # simt: the CUDA-core walk


def _rows_slice(rows: int, z: int, S: int) -> Tuple[int, int]:
    """bsmm.cu ``cluster_sum``: rank z of S writes these tile rows."""
    return rows * z // S, rows * (z + 1) // S


def _walk_spec(name, kernel, route, *, plan, E, M, A, B, dtype, S, trans,
               grid_of, cluster_z, threads, smem, BM, BN):
    """A forward-shaped walk: for every output block (expert, row block,
    BN columns of a 128 tile t), piece z of t's live list (the plan's
    ``idx``/``counts``; ``trans``: dx's ``idx_t``/``counts_t``), reading
    the left operand's columns and the weight's tiles of each listed
    tile.  A is the contraction width, B the output width (the forward:
    K, N; dx: N, K).  ``grid_of(e, mb, cb, z)`` gives the block's coord."""
    idx = plan.idx_t if trans else plan.idx
    counts = plan.counts_t if trans else plan.counts
    e_ = _ELEM[dtype]
    cpt = _T // BN                          # blocks a 128 tile
    rb = -(-M // BM)
    meet = "cluster" if cluster_z else "workspace"
    lhs, wn, out = ("g", "w", "dx") if trans else ("x", "w", "out")
    blocks = []
    for e in range(E):
        for t in range(B // _T):
            c = int(counts[t])
            pieces = _bsmm.split_pieces(c, S)
            for mb in range(rb):
                m0 = mb * BM
                rows = min(BM, M - m0)
                r0 = e * M + m0
                for sub in range(cpt):
                    n0 = t * _T + sub * BN
                    cls = (e, mb, t * cpt + sub)
                    group = cls if S > 1 else None
                    for z in range(S):
                        coord = grid_of(e, mb, t * cpt + sub, z)
                        if z < len(pieces):
                            t0, t1 = pieces[z]
                        elif cluster_z:
                            t0 = t1 = 0     # an empty piece sums a slice
                        else:
                            blocks.append(Block(coord, False, cls=cls,
                                                meets=group))
                            continue
                        reads = []
                        for q in range(t0, t1):
                            kt = int(idx[t, q])
                            reads.append((lhs, (r0, r0 + rows, kt * _T,
                                                (kt + 1) * _T)))
                            if trans:       # w (K, N): K rows n0.., tile kt
                                reads.append((wn, (e * B + n0, e * B + n0 + BN,
                                                   kt * _T, (kt + 1) * _T)))
                            else:           # w (K, N): tile kt, columns n0..
                                reads.append((wn, (e * A + kt * _T,
                                                   e * A + (kt + 1) * _T, n0,
                                                   n0 + BN)))
                        if cluster_z and S > 1:
                            a, b = _rows_slice(rows, z, S)
                            writes = ((r0 + a, r0 + b, n0, n0 + BN),)
                        else:
                            writes = ((r0, r0 + rows, n0, n0 + BN),)
                        part = (rows * BN * 4 if not cluster_z
                                and len(pieces) > 1 else 0)
                        blocks.append(Block(
                            coord, True, writes, tuple(reads), cls, group,
                            2.0 * BM * BN * _T * (t1 - t0), part))
    region = np.ones((E * M, B), bool)
    return LaunchSpec(
        name, kernel, route, _grid_extent(blocks), threads,
        (1, 1, S if cluster_z else 1), smem, S, meet,
        {lhs: (E * M, A), wn: (E * (B if trans else A),
                              A if trans else B), out: (E * M, B)},
        {lhs: e_, wn: e_, out: e_}, out, region, tuple(blocks))


def _grid_extent(blocks) -> Tuple[int, int, int]:
    c = np.array([b.coord for b in blocks])
    return tuple(int(v) + 1 for v in c.max(axis=0))


def bsmm_fwd_spec(plan, M: int, dtype: torch.dtype = torch.bfloat16, *,
                  epilogue: bool = False) -> LaunchSpec:
    """The 2-D forward (#1, #2 with ``epilogue``) at M rows: the route
    and split count of ``TilePlan.route_and_splits``."""
    K = len(plan.counts_t) * plan.tile
    N = len(plan.counts) * plan.tile
    route, S = plan.route_and_splits("fwd", M, dtype)
    BM, BN = block_geometry("fwd", route, M)
    kw = dict(plan=plan, E=1, M=M, A=K, B=N, dtype=dtype, S=S, trans=False,
              BM=BM, BN=BN)
    name = "bsmm_epilogue" if epilogue else "bsmm"
    kernel = "#2" if epilogue else "#1"
    if route == "stream":
        return _walk_spec(name, kernel, route, **kw,
                          grid_of=lambda e, mb, cb, z: (cb, mb, z),
                          cluster_z=False, threads=256,
                          smem=stream2d_smem(dtype, BM))
    blocks = -(-M // BM) * (N // _T) * S
    return _walk_spec(name, kernel, route, **kw,
                      grid_of=lambda e, mb, cb, z: (mb, cb, z),
                      cluster_z=route == "wgmma",
                      threads=160 if route == "wgmma" else 256,
                      smem=ring_smem(blocks) if route == "wgmma" else 0)


def bsmm_dx_spec(plan, M: int, dtype: torch.dtype = torch.bfloat16,
                 E: int = 1) -> LaunchSpec:
    """dx (#3; #3b with E > 1 experts of M rows each): the route of
    ``bsmm_dx_route`` and the split count of ``bsmm_dx_splits``."""
    K = len(plan.counts_t) * plan.tile
    N = len(plan.counts) * plan.tile
    route, S = plan.route_and_splits("dx", M, dtype, E)
    name, kernel = ("bsmm_batched_dx", "#3b") if E > 1 else ("bsmm_dx",
                                                           "#3")
    if route == "wgmma":
        rb = -(-M // _T)
        kt = K // _T
        if E > 1:                           # expert-major, 1-D in x
            grid_of = lambda e, mb, cb, z: ((e * kt + cb) * rb + mb, 0, z)
        else:
            grid_of = lambda e, mb, cb, z: (mb, cb, z)
        return _walk_spec(name, kernel, route, plan=plan, E=E, M=M, A=N,
                          B=K, dtype=dtype, S=S, trans=True,
                          grid_of=grid_of, cluster_z=True, threads=160,
                          smem=ring_smem(E * rb * kt * S), BM=_T, BN=_T)
    BM, BN = block_geometry("dx", route, M)
    return _walk_spec(name, kernel, route, plan=plan, E=E, M=M, A=N, B=K,
                      dtype=dtype, S=1, trans=True,
                      grid_of=lambda e, mb, cb, z: (cb, mb, e),
                      cluster_z=False, threads=256, smem=0, BM=BM, BN=BN)


def bsmm_batched_spec(plan, E: int, M: int,
                      dtype: torch.dtype = torch.bfloat16) -> LaunchSpec:
    """The expert-batched forward (#1b): ``bsmm_batched_route`` and
    ``bsmm_batched_splits`` at M rows an expert."""
    K = len(plan.counts_t) * plan.tile
    N = len(plan.counts) * plan.tile
    route, S = plan.route_and_splits("batched", M, dtype, E)
    if route == "wgmma":
        rb, nt = -(-M // _T), N // _T
        return _walk_spec(
            "bsmm_batched", "#1b", route, plan=plan, E=E, M=M, A=K, B=N,
            dtype=dtype, S=S, trans=False,
            grid_of=lambda e, mb, cb, z: ((e * nt + cb) * rb + mb, 0, z),
            cluster_z=True, threads=160, smem=ring_smem(E * rb * nt * S),
            BM=_T, BN=_T)
    BM, BN = block_geometry("batched", route, M)
    return _walk_spec(
        "bsmm_batched", "#1b", route, plan=plan, E=E, M=M, A=K, B=N,
        dtype=dtype, S=1, trans=False,
        grid_of=((lambda e, mb, cb, z: (mb, cb, e)) if route == "stream"
                 else (lambda e, mb, cb, z: (cb, mb, e))),
        cluster_z=False, threads=256, smem=0, BM=BM, BN=BN)


def bsmm_dw_spec(plan, M: int, dtype: torch.dtype = torch.bfloat16,
                 E: int = 1) -> LaunchSpec:
    """dw (#4; #4b with E > 1): one block per (live tile l, piece z of
    its row steps, expert e), ``bsmm_dw_route``/``bsmm_dw_splits``.  Its
    region is the live tiles only: the wrapper zero-fills the rest."""
    K = len(plan.counts_t) * plan.tile
    N = len(plan.counts) * plan.tile
    route, S = plan.route_and_splits("dw", M, dtype, E)
    e_ = _ELEM[dtype]
    step = 64 if route == "wgmma" else 32
    steps = -(-M // step)
    pieces = _bsmm.split_pieces(steps, S)
    cluster = route == "wgmma"
    L = plan.live_tiles
    region = np.zeros((E * K, N), bool)
    blocks = []
    for e in range(E):
        for l in range(L):
            k0, n0 = int(plan.kk[l]) * _T, int(plan.nn[l]) * _T
            region[e * K + k0:e * K + k0 + _T, n0:n0 + _T] = True
            cls = (e, l)
            group = cls if S > 1 else None
            for z in range(S):
                if z < len(pieces):
                    s0, s1 = pieces[z]
                elif cluster:
                    s0 = s1 = 0
                else:
                    blocks.append(Block((l, z, e), False, cls=cls,
                                        meets=group))
                    continue
                r0, r1 = e * M + s0 * step, e * M + min(s1 * step, M)
                reads = ((("x", (r0, r1, k0, k0 + _T)),
                          ("g", (r0, r1, n0, n0 + _T))) if s1 > s0 else ())
                if cluster and S > 1:
                    a, b = _rows_slice(_T, z, S)
                    writes = ((e * K + k0 + a, e * K + k0 + b, n0,
                               n0 + _T),)
                else:
                    writes = ((e * K + k0, e * K + k0 + _T, n0, n0 + _T),)
                part = _T * _T * 4 if not cluster and len(pieces) > 1 else 0
                blocks.append(Block((l, z, e), True, writes, reads, cls,
                                    group, 2.0 * (s1 - s0) * step * _T * _T,
                                    part))
    name, kernel = ("bsmm_batched_dw", "#4b") if E > 1 else ("bsmm_dw",
                                                           "#4")
    return LaunchSpec(
        name, kernel, route, (max(L, 1), S, E), 160 if cluster else 256,
        (1, S if cluster else 1, 1),
        ring_smem(L * S * E) if cluster else 0, S,
        "cluster" if cluster else "workspace",
        {"x": (E * M, K), "g": (E * M, N), "dw": (E * K, N)},
        {"x": e_, "g": e_, "dw": e_}, "dw", region, tuple(blocks))


# ---------------------------------------------------------------------------
# The LTP baseline (#5), tile statistics (#9)
# ---------------------------------------------------------------------------
def masked_matmul_spec(M: int, K: int, N: int,
                       dtype: torch.dtype = torch.bfloat16,
                       mask_dtype: torch.dtype = torch.bfloat16
                       ) -> LaunchSpec:
    """#5 on ``masked_route``'s kernel, K cut by ``masked_splits``
    (never on ``wgmma``); split partials meet in a workspace that a
    reduce kernel sums.  Every tile of w and of the mask is read."""
    route = _bsmm.masked_route(M, K, N, dtype)
    splits = ((0, K),) if route == "wgmma" else _bsmm.masked_splits(M, K, N)
    S = len(splits)
    e_ = _ELEM[dtype]
    me = torch.empty((), dtype=mask_dtype).element_size()
    if route == "stream":
        BM = 8 if M <= 8 else 32
        smem = masked_stream_smem(dtype, me, BM)
    elif route == "wgmma":
        BM, smem = 256, masked_wgmma_smem(me)
    else:
        BM, smem = 64, (_T * _T + _T * (64 + 1)) * 4
    blocks = []
    for mb in range(-(-M // BM)):
        m0 = mb * BM
        rows = min(BM, M - m0)
        for j in range(N // _T):
            n0 = j * _T
            cls = (mb, j)
            for z, (k0, k1) in enumerate(splits):
                reads = [("x", (m0, m0 + rows, k0, k1)),
                         ("w", (k0, k1, n0, n0 + _T)),
                         ("mask", (k0, k1, n0, n0 + _T))]
                coord = (mb, j, 0) if route == "wgmma" else (j, mb, z)
                blocks.append(Block(
                    coord, True, ((m0, m0 + rows, n0, n0 + _T),),
                    tuple(reads), cls, cls if S > 1 else None,
                    2.0 * BM * _T * (k1 - k0),
                    rows * _T * 4 if S > 1 else 0))
    return LaunchSpec(
        "masked_matmul", "#5", route, _grid_extent(blocks),
        384 if route == "wgmma" else 256, (1, 1, 1), smem, S, "workspace",
        {"x": (M, K), "w": (K, N), "mask": (K, N), "out": (M, N)},
        {"x": e_, "w": e_, "mask": me, "out": e_}, "out",
        np.ones((M, N), bool), tuple(blocks))


def tile_stats_spec(K: int, N: int, dtype: torch.dtype = torch.float32
                    ) -> LaunchSpec:
    """#9: one block per 128 x 128 tile, writing its live flag and sum
    (the output is the (Kt, Nt) tile grid)."""
    kt, nt = -(-K // _T), -(-N // _T)
    blocks = []
    for t in range(kt * nt):
        i, j = divmod(t, nt)
        blocks.append(Block(
            (t, 0, 0), True, ((i, i + 1, j, j + 1),),
            (("w", (i * _T, min((i + 1) * _T, K), j * _T,
                    min((j + 1) * _T, N))),), (i, j)))
    return LaunchSpec(
        "tile_stats", "#9", "simt", (kt * nt, 1, 1), 256, (1, 1, 1), 0, 1,
        "workspace", {"w": (K, N), "stats": (kt, nt)},
        {"w": _ELEM[dtype], "stats": 8}, "stats", np.ones((kt, nt), bool),
        tuple(blocks))


# ---------------------------------------------------------------------------
# Attention: paged decode (#6, #7) and flash prefill (#8)
# ---------------------------------------------------------------------------
def paged_attention_spec(geo, tables: np.ndarray, lengths: Sequence[int],
                         dtype: torch.dtype = torch.bfloat16, *,
                         fused: bool = False) -> LaunchSpec:
    """#6 (``fused=False``: its own value pool) or #7 (values the first
    dv lanes of each key row, on ``fused_route``'s kernel).  Block (x,
    b, j) reads logical block j of sequence b through the table, for a
    group of query heads (x), and stores f32 partials; the combine kernel
    writes each (sequence, head) row once.  The simt kernels read a
    block's first ``len - j·T`` rows, the wgmma kernel the whole block
    (TMA), masking past ``len``."""
    tables = np.asarray(tables)
    lengths = [int(n) for n in lengths]
    route = _paged.fused_route(geo, dtype) if fused else "simt"
    e_ = _ELEM[dtype]
    G = geo.Hq // geo.Hkv
    if route == "wgmma":
        heads, ngb = _paged._WG_HEADS, G // _paged._WG_HEADS
        smem, threads = _paged.fused_wgmma_smem_bytes(geo.hd), 256
    else:
        heads, ngb = _paged._GB, -(-G // _paged._GB)
        smem, threads = paged_simt_smem(geo, e_, fused), _paged._THREADS
    kw = geo.Hkv * geo.hd
    blocks = []
    for x in range(geo.Hkv * ngb):
        h, g0 = divmod(x, ngb)
        g0 *= heads
        gn = min(heads, G - g0)
        hq0 = h * G + g0
        for b in range(geo.B):
            n = lengths[b]
            cls = (x, b)
            out = ((b * geo.Hq + hq0, b * geo.Hq + hq0 + gn, 0, geo.dv),)
            for j in range(geo.NB):
                if j * geo.T >= n:
                    blocks.append(Block((x, b, j), False, cls=cls,
                                        meets=cls))
                    continue
                live = min(geo.T, n - j * geo.T)
                rows = geo.T if route == "wgmma" else live
                p = int(tables[b, j])
                r = (p * geo.T, p * geo.T + rows)
                reads = [("q", (b * geo.Hq + hq0, b * geo.Hq + hq0 + gn,
                                0, geo.hd)),
                         ("k_pool", (*r, h * geo.hd, (h + 1) * geo.hd))]
                if not fused:
                    reads.append(("v_pool", (*r, h * geo.dv,
                                             (h + 1) * geo.dv)))
                blocks.append(Block(
                    (x, b, j), True, out, tuple(reads), cls, cls,
                    2.0 * gn * rows * (geo.hd + geo.dv),
                    gn * (geo.dv + 2) * 4))
    operands = {"q": (geo.B * geo.Hq, geo.hd),
                "k_pool": (geo.P * geo.T, kw),
                "out": (geo.B * geo.Hq, geo.dv)}
    itemsize = {"q": e_, "k_pool": e_, "out": e_}
    if not fused:
        operands["v_pool"] = (geo.P * geo.T, geo.Hkv * geo.dv)
        itemsize["v_pool"] = e_
    return LaunchSpec(
        "paged_attention", "#7" if fused else "#6", route,
        (geo.Hkv * ngb, geo.B, geo.NB), threads, (1, 1, 1), smem,
        geo.NB, "workspace", operands, itemsize, "out",
        np.ones((geo.B * geo.Hq, geo.dv), bool), tuple(blocks),
        table=tables, pool_blocks=geo.P)


def flash_attention_spec(B: int, S: int, Hq: int, Hkv: int, hd: int,
                         dv: int, dtype: torch.dtype = torch.bfloat16, *,
                         causal: bool = True) -> LaunchSpec:
    """#8: block (query tile, head, batch) walks the key tiles its
    queries may see (all, or under ``causal`` those up to its last
    query), on the route the dtype picks."""
    e_ = _ELEM[dtype]
    if dtype == torch.bfloat16:
        route, BQ, threads = "wgmma", 128, 384
        BK, smem = flash_wgmma_geometry(hd, dv)
    else:
        route, BQ, BK, threads = "simt", 64, 64, 256
        smem = flash_f32_smem(hd, dv)
    G = Hq // Hkv
    nkt = -(-S // BK)
    blocks = []
    for b in range(B):
        for h in range(Hq):
            kh = h // G
            for qt in range(-(-S // BQ)):
                q0 = qt * BQ
                q1 = min(q0 + BQ, S)
                nk = min(nkt, -(-(q0 + BQ) // BK)) if causal else nkt
                reads = [("q", (b * S + q0, b * S + q1, h * hd,
                                (h + 1) * hd))]
                for j in range(nk):
                    k0, k1 = j * BK, min((j + 1) * BK, S)
                    reads.append(("k", (b * S + k0, b * S + k1, kh * hd,
                                        (kh + 1) * hd)))
                    reads.append(("v", (b * S + k0, b * S + k1, kh * dv,
                                        (kh + 1) * dv)))
                blocks.append(Block(
                    (qt, h, b), True,
                    ((b * S + q0, b * S + q1, h * dv, (h + 1) * dv),),
                    tuple(reads), (b, h, qt), None,
                    2.0 * BQ * BK * (hd + dv) * nk))
    return LaunchSpec(
        "flash_attention", "#8", route, (-(-S // BQ), Hq, B), threads,
        (1, 1, 1), smem, 1, "workspace",
        {"q": (B * S, Hq * hd), "k": (B * S, Hkv * hd),
         "v": (B * S, Hkv * dv), "out": (B * S, Hq * dv)},
        {"q": e_, "k": e_, "v": e_, "out": e_}, "out",
        np.ones((B * S, Hq * dv), bool), tuple(blocks))
