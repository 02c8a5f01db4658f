"""Deterministic pipelined ReRAM execution model (paper §V.A, Figs 7-8;
port of ``repro.core.perf_model``), and the H100 launch cost model.

Target chip (paper): 256 tiles × 96 crossbars of 128×128 cells @10 MHz.
CNN layers execute in a pipeline (PipeLayer [1]): every layer processes
a different image simultaneously, so throughput is set by the slowest
layer.  A conv layer with output O×O must stream O² windows through its
crossbar grid — one window per crossbar cycle — so its per-image time is
O²/r cycles given r-way weight replication.  Training ≈ 3 passes
(forward, error backward, weight gradient) [1].

Iso-area (Fig. 7): a fixed crossbar budget first stores every layer's
(pruned) weights; the remainder replicates slow layers.  The optimal
continuous waterfill equalises t = O²_l/r_l:
    t* = Σ_l (xb_l · O²_l) / B_compute,   r_l = O²_l / t*.
Pruning shrinks xb_l, freeing budget for replication — exactly the
mechanism the paper credits for its 19.7× mean speedup.

Iso-performance (Fig. 6): replication factors are fixed to the
*unpruned* model's waterfill (equal parallelism ⇒ equal performance);
pruned models then need Σ r_l·xb'_l crossbars.

Every number of this first half is of the paper's modelled ReRAM chip,
not of the device the port runs on.  The second half (``KernelCost``)
counts the port's own CUDA launches on the H100 — passes, flops and
bytes, not time — for the kernel audit's K306, where the reference's
counts its TPU kernels' grids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.crossbar import XBAR_COLS, XBAR_ROWS

# paper / ISAAC [2] constants
XBARS_PER_TILE = 96
N_TILES = 256
TOTAL_XBARS = XBARS_PER_TILE * N_TILES          # 24576
XBAR_FREQ_HZ = 10e6
TRAIN_PASSES = 3.0                              # fwd + err-bwd + wgrad
ACT_CELLS_PER_XBAR = XBAR_ROWS * XBAR_COLS
# ISAAC stores 16-bit fixed-point values in 2-bit cells: 8 cells/weight.
# This is why an unpruned CNN nearly saturates the 24576-crossbar chip
# (paper §V.C: ">80% of the crossbars" for ResNet-18 C11-C17) and why
# pruning frees enough area for ~20× replication speedups.
CELLS_PER_WEIGHT = 8


@dataclass
class LayerPerf:
    name: str
    out_positions: float        # O² (conv windows) or 1 (FC)
    xbars: int                  # crossbars to store this layer's weights
    act_xbars: float = 0.0      # crossbars to store activations


def conv_layer_perf(cfg, xbars_per_layer: Dict[str, int],
                    act_volumes: Optional[Dict[str, float]] = None,
                    cells_per_weight: int = CELLS_PER_WEIGHT,
                    pipelined_training: bool = True,
                    act_cells_per_xbar: float = ACT_CELLS_PER_XBAR
                    ) -> List[LayerPerf]:
    """Build LayerPerf list for a CNNConfig given per-layer crossbar needs.

    ``xbars_per_layer`` counts single-cell-per-weight crossbars (the
    mapping unit of core.crossbar); the 16-bit/2-bit-cell encoding
    multiplies physical crossbars by ``cells_per_weight``.
    ``act_cells_per_xbar`` is the crossbar cell capacity — pass
    ``xbar_rows * xbar_cols`` when using non-default geometry.

    Pipelined training (PipeLayer [1]) keeps layer l's activations
    resident until the backward pass returns to it: in-flight copies ≈
    2·(L − l).  This is what makes an unpruned deep CNN saturate the
    chip (paper §V.C) — and why filter-wise pruning, the only kind that
    removes activations, matters for training.
    """
    size = cfg.image_size
    acts = act_volumes or {}
    L = len(cfg.convs)
    layers = []
    for i, spec in enumerate(cfg.convs):
        if spec.stride > 1:
            size //= spec.stride
        copies = 2 * (L - i) if pipelined_training else 1
        act_xb = np.ceil(acts.get(f"convs/{i}/w", 0.0) * copies
                         * cells_per_weight / act_cells_per_xbar)
        layers.append(LayerPerf(
            f"C{i + 1}", float(size * size),
            xbars_per_layer.get(f"convs/{i}/w", 0) * cells_per_weight,
            act_xb))
        if spec.pool:
            size //= 2
    for j in range(len(cfg.fc) + 1):
        key = f"fc/{j}/w" if j < len(cfg.fc) else "head/w"
        if key in xbars_per_layer:
            layers.append(LayerPerf(key, 1.0,
                                    xbars_per_layer[key] * cells_per_weight,
                                    0.0))
    return layers


@dataclass
class PipelineResult:
    cycles_per_image: float
    replication: List[float]
    storage_xbars: float
    compute_budget: float

    @property
    def time_per_image_s(self) -> float:
        return self.cycles_per_image / XBAR_FREQ_HZ


def waterfill(layers: Sequence[LayerPerf], budget: int = TOTAL_XBARS,
              train: bool = True,
              replication: Optional[Sequence[float]] = None
              ) -> PipelineResult:
    """Pipeline time under a crossbar budget with optimal replication.

    If ``replication`` is given it is used as-is (iso-performance mode);
    otherwise the continuous waterfill above allocates the budget.
    """
    storage = sum(l.xbars + l.act_xbars for l in layers)
    passes = TRAIN_PASSES if train else 1.0
    if replication is None:
        b_compute = max(budget - storage, 1.0)
        # replicas beyond the first copy: budget for (r_l - 1) · xb_l
        num = sum(l.xbars * l.out_positions for l in layers)
        t_star = num / (b_compute + sum(l.xbars for l in layers))
        repl = [max(1.0, l.out_positions / max(t_star, 1e-12))
                for l in layers]
        # respect the budget exactly: scale down if the floor-at-1 pushed over
        cost = sum((r - 1.0) * l.xbars for r, l in zip(repl, layers))
        if cost > b_compute:
            scale = b_compute / cost
            repl = [1.0 + (r - 1.0) * scale for r in repl]
    else:
        repl = list(replication)
    cycles = max(l.out_positions / r for l, r in zip(layers, repl)) * passes
    return PipelineResult(cycles, repl, storage,
                          max(budget - storage, 0.0))


def iso_area_speedup(unpruned: Sequence[LayerPerf],
                     pruned: Sequence[LayerPerf],
                     budget: int = TOTAL_XBARS) -> float:
    """Fig. 7: training speedup of the pruned model, equal crossbar budget."""
    t0 = waterfill(unpruned, budget).cycles_per_image
    t1 = waterfill(pruned, budget).cycles_per_image
    return t0 / t1


def iso_perf_xbars(unpruned: Sequence[LayerPerf],
                   pruned: Sequence[LayerPerf],
                   budget: int = TOTAL_XBARS) -> Dict[str, float]:
    """Fig. 6: crossbars needed by the pruned model at equal parallelism."""
    base = waterfill(unpruned, budget)
    need_unpruned = sum(r * l.xbars + l.act_xbars
                        for r, l in zip(base.replication, unpruned))
    need_pruned = sum(r * l.xbars + l.act_xbars
                      for r, l in zip(base.replication, pruned))
    return {
        "unpruned_xbars": need_unpruned,
        "pruned_xbars": need_pruned,
        "savings": 1.0 - need_pruned / max(need_unpruned, 1e-9),
    }


# ---------------------------------------------------------------------------
# The H100 launch cost model (the counterpart of the reference's
# ``KernelCost`` half, which costs its TPU grids): each CUDA launch's
# traffic as it is launched, with no elision —
#
#   * passes    — blocks that do work;
#   * flops     — the multiply-adds those blocks issue at the route's
#                 block sizes (a block's full rows, even past M);
#   * hbm_bytes — every operand rectangle a working block reads (rows
#                 past M are the kernels' zero fill, not read), every
#                 output element written once, and f32 split partials
#                 stored and read back once.  #2's bias vector is not
#                 counted.
#
# The numbers come from plan metadata and the wrappers' route rules in
# closed form; ``analysis.kernel_audit`` (K306) enumerates the same
# three from each ``kernels.spec.LaunchSpec`` block by block and
# compares, so the cost model and the launch specs cannot silently
# diverge.  A consistency oracle, not a clock.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class KernelCost:
    """Predicted cost of one CUDA launch under the no-elision model."""
    passes: int
    flops: float
    hbm_bytes: float


_TILE = XBAR_ROWS       # the plan's 128 tile


def _elem(dtype) -> int:
    import torch
    return 2 if dtype == torch.bfloat16 else 4


def _walk_cost(counts, S: int, *, E: int, M: int, B: int, BM: int, BN: int,
               elem: int, cluster: bool) -> KernelCost:
    """A block-sparse walk over output tiles whose live lists are
    ``counts``, cut into ``S`` pieces each (pieces of a list of c tiles:
    min(S, max(c, 1))), rows in blocks of BM, columns of BN."""
    c = np.asarray(counts, np.int64)
    parts = np.minimum(S, np.maximum(c, 1))
    rb, cpt = -(-M // BM), _TILE // BN
    live = int(c.sum())
    passes = E * rb * cpt * (S * len(c) if cluster else int(parts.sum()))
    flops = E * rb * cpt * live * 2.0 * BM * BN * _TILE
    lhs = E * cpt * live * M * _TILE * elem
    w = E * rb * cpt * live * _TILE * BN * elem
    out = E * M * B * elem
    part = 0 if cluster else \
        2 * E * cpt * M * BN * 4 * int(parts[parts > 1].sum())
    return KernelCost(passes, flops, float(lhs + w + out + part))


def _walk(kind: str, plan, M: int, dtype, E: int = 1) -> KernelCost:
    """A block-sparse walk's cost on the route and split count the
    wrapper gives it, at the block sizes its launcher uses."""
    from repro_torch.kernels.spec import block_geometry
    route, S = plan.route_and_splits(kind, M, dtype, E)
    counts = plan.counts_t if kind == "dx" else plan.counts
    BM, BN = block_geometry(kind, route, M)
    return _walk_cost(counts, S, E=E, M=M, B=len(counts) * _TILE, BM=BM,
                      BN=BN, elem=_elem(dtype), cluster=route == "wgmma")


def bsmm_fwd_cost(plan, M: int, dtype) -> KernelCost:
    """The 2-D forward (#1, #2) at M rows of ``dtype``."""
    return _walk("fwd", plan, M, dtype)


def bsmm_batched_cost(plan, E: int, M: int, dtype) -> KernelCost:
    """The expert-batched forward (#1b), M rows an expert."""
    return _walk("batched", plan, M, dtype, E)


def bsmm_dx_cost(plan, M: int, dtype, E: int = 1) -> KernelCost:
    """dx (#3; #3b with E experts), over the transposed plan."""
    return _walk("dx", plan, M, dtype, E)


def bsmm_dw_cost(plan, M: int, dtype, E: int = 1) -> KernelCost:
    """dw (#4; #4b): each of the L live tiles' rows cut into pieces."""
    route, S = plan.route_and_splits("dw", M, dtype, E)
    step = 64 if route == "wgmma" else 32
    steps = -(-M // step)
    n = min(S, max(steps, 1))
    L, t2 = int(plan.live_tiles), _TILE * _TILE
    cluster = route == "wgmma"
    passes = E * L * (S if cluster else n)
    flops = E * L * 2.0 * steps * step * t2
    hbm = E * L * (2 * M * _TILE + t2) * _elem(dtype)
    if not cluster and n > 1:
        hbm += 2 * E * L * n * t2 * 4
    return KernelCost(passes, flops, float(hbm))


def paged_decode_cost(lengths, *, hq: int, hkv: int, hd: int, dv: int,
                      block_tokens: int, route: str, fused: bool,
                      dtype) -> KernelCost:
    """Paged decode (#6, #7 with ``fused``): sequence b touches
    ⌈len/T⌉ blocks for every head group; the simt kernels read a block's
    live rows, the wgmma kernel all T (TMA); each working block stores
    (heads, dv + 2) f32 partials, which the combine kernel reads back
    before writing (B, Hq, dv)."""
    from repro_torch.kernels import paged_attention as kp
    T, G = block_tokens, hq // hkv
    heads = kp._WG_HEADS if route == "wgmma" else kp._GB
    groups = hkv * -(-G // heads)
    nb = sum(-(-int(n) // T) for n in lengths)
    rows = nb * T if route == "wgmma" else sum(int(n) for n in lengths)
    e = _elem(dtype)
    kv = rows * (hd + (0 if fused else dv)) * e
    q = hq * nb * hd * e
    part = 2 * hq * nb * (dv + 2) * 4
    out = len(lengths) * hq * dv * e
    flops = 2.0 * hq * rows * (hd + dv)
    return KernelCost(groups * nb, flops,
                      float(groups * kv + q + part + out))


def flash_cost(*, batch: int, seq: int, hq: int, hkv: int, hd: int,
               dv: int, bq: int, bk: int, causal: bool,
               dtype) -> KernelCost:
    """Flash attention (#8): query tile i of bq rows reads the key tiles
    up to its last query under ``causal`` (all without)."""
    e = _elem(dtype)
    nkt = -(-seq // bk)
    passes, flops, hbm = 0, 0.0, 0
    for i in range(-(-seq // bq)):
        q0, q1 = i * bq, min((i + 1) * bq, seq)
        nk = min(nkt, -(-(q0 + bq) // bk)) if causal else nkt
        keys = min(nk * bk, seq)
        passes += 1
        flops += 2.0 * bq * bk * (hd + dv) * nk
        hbm += (q1 - q0) * (hd + dv) * e + keys * (hd + dv) * e
    heads = batch * hq
    return KernelCost(heads * passes, heads * flops, float(heads * hbm))
