"""Hardware-savings accounting (paper Figs. 2 & 6; port of
``repro.core.hardware``, host-side numpy).

'Hardware savings' = fraction of ReRAM cells that can be turned off or
reused; a cell qualifies only when its entire crossbar row or column is
zero (Fig. 2).  Crossbar *count* savings additionally assume freed
rows/columns can be repacked with other layers' live weights (the
paper's "reused for other purposes"): needed crossbars = ⌈live area /
crossbar area⌉, where live area per crossbar is live_rows × live_cols.

Training also stores activations (paper §IV.A): only *filter-wise*
pruning (a dead output unit) removes an activation, so activation
savings = fraction of dead output columns, weighted by each layer's
activation volume.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch._bridge import to_numpy
from repro_torch.core import crossbar as xb
from repro_torch.core.masks import tree_flatten_with_path


@dataclass
class LayerHW:
    path: str
    stats: xb.XbarStats
    alive_outputs: int
    total_outputs: int
    activation_volume: float = 0.0   # elements per sample (for weighting)
    # per-out-channel quantization scale entries of the RAW leaf
    # (``core.quantize`` reduces over axis=-2, so a (kh,kw,cin,cout)
    # conv carries kh*kw*cout scales, not the cout of its unrolled view)
    scale_entries: int = 0


_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def dtype_bytes(dtype: Optional[str]) -> int:
    """Stored bytes per weight for a config ``dtype`` string (CNN
    configs carry no dtype and store float32)."""
    return _DTYPE_BYTES.get(dtype or "float32", 4)


@dataclass
class HWReport:
    layers: List[LayerHW] = field(default_factory=list)
    # fixed-point width an accepted quantize stage retrained at (None →
    # weights stored full precision); drives the byte accounting below
    quant_bits: Optional[int] = None
    # bytes per unquantized weight (2 for bfloat16 archs, 4 for the
    # float32 CNNs) — pass the config's dtype to analyze_masks
    dtype_bytes: int = 4

    # ---- weights ----
    @property
    def total_cells(self):
        return sum(l.stats.total_cells for l in self.layers)

    @property
    def nonzero_cells(self):
        return sum(l.stats.nonzero_cells for l in self.layers)

    @property
    def saved_cells(self):
        return sum(l.stats.saved_cells for l in self.layers)

    @property
    def sparsity(self) -> float:
        return 1.0 - self.nonzero_cells / max(self.total_cells, 1)

    @property
    def cell_savings(self) -> float:
        """Paper's 'hardware savings' over weight cells."""
        return self.saved_cells / max(self.total_cells, 1)

    @property
    def xbars_unpruned(self) -> int:
        return sum(l.stats.n_xbars for l in self.layers)

    @property
    def xbars_needed(self) -> int:
        return sum(l.stats.xbars_needed_packed for l in self.layers)

    @property
    def xbars_needed_strict(self) -> int:
        return sum(l.stats.xbars_needed_strict for l in self.layers)

    @property
    def xbar_savings(self) -> float:
        return 1.0 - self.xbars_needed / max(self.xbars_unpruned, 1)

    # ---- storage bytes (compose with packing, no double-count) ----
    def weight_bytes(self, bits: Optional[int] = None,
                     dtype_bytes: Optional[int] = None) -> Dict[str, float]:
        """Stored weight bytes: dense, pruned+packed, and (when a
        quantize stage ran) quantized+packed.

        Packing keeps only live cells, so pruned bytes count
        ``nonzero_cells`` — the quantized figure applies ``bits`` to
        those SAME live cells (plus one float32 scale per live
        per-out-channel scale entry), so pruning and quantization
        savings compose instead of double-counting.  ``bits`` defaults
        to the report's ``quant_bits``; ``dtype_bytes`` to the report's
        storage dtype (bfloat16 archs store 2 bytes per weight).
        """
        bits = self.quant_bits if bits is None else bits
        db = self.dtype_bytes if dtype_bytes is None else dtype_bytes
        out = {
            "dense_bytes": float(self.total_cells * db),
            "pruned_bytes": float(self.nonzero_cells * db),
            "dtype_bytes": db,
            "quant_bits": bits,
            "quantized_bytes": None,
        }
        if bits is not None:
            # scales for live output columns only (packing drops dead
            # ones, and a dead conv channel drops all kh*kw of its
            # scales with it); scales themselves are float32
            alive_scales = sum(
                l.scale_entries * l.alive_outputs / max(l.total_outputs, 1)
                for l in self.layers)
            out["quantized_bytes"] = float(
                self.nonzero_cells * bits / 8 + alive_scales * 4)
        return out

    # ---- activations ----
    @property
    def activation_savings(self) -> float:
        tot = sum(l.activation_volume for l in self.layers)
        if tot == 0:
            return 0.0
        dead = sum(l.activation_volume * (1 - l.alive_outputs
                                          / max(l.total_outputs, 1))
                   for l in self.layers)
        return dead / tot

    def combined_xbar_savings(self, act_cells_per_xbar: float = 16384.0,
                              act_weight: float = 1.0) -> float:
        """Crossbar savings counting weight + activation storage.

        Activations of layer l occupy ⌈volume/16384⌉ crossbars; only
        filter-pruned outputs are removed (paper §V.B: "fewer
        activations are pruned than weights").
        """
        w_base = self.xbars_unpruned
        w_need = self.xbars_needed
        a_base = a_need = 0.0
        for l in self.layers:
            if l.activation_volume <= 0:
                continue
            per_out = l.activation_volume / max(l.total_outputs, 1)
            a_base += np.ceil(l.activation_volume * act_weight
                              / act_cells_per_xbar)
            a_need += np.ceil(per_out * l.alive_outputs * act_weight
                              / act_cells_per_xbar)
        base, need = w_base + a_base, w_need + a_need
        return 1.0 - need / max(base, 1.0)


def analyze_masks(masks, conv_pred: Callable[[str], bool],
                  activation_volumes: Optional[Dict[str, float]] = None,
                  xbar_rows: int = xb.XBAR_ROWS,
                  xbar_cols: int = xb.XBAR_COLS,
                  quant_bits: Optional[int] = None,
                  dtype: Optional[str] = None) -> HWReport:
    """Crossbar accounting for every prunable leaf of a mask pytree.

    ``xbar_rows``/``xbar_cols`` set the crossbar geometry for the whole
    stats path (pass ``PruneConfig.xbar_rows/xbar_cols`` to match the
    geometry the masks were pruned with).  ``quant_bits`` records the
    fixed-point width of an accepted quantize stage and ``dtype`` the
    config's storage dtype, so ``HWReport.weight_bytes`` reports real
    quantized vs stored bytes (a bfloat16 arch stores 2 bytes/weight).
    """
    report = HWReport(quant_bits=quant_bits,
                      dtype_bytes=dtype_bytes(dtype))
    vols = activation_volumes or {}

    for p, leaf in tree_flatten_with_path(masks):
        if leaf is None:
            continue
        raw = to_numpy(leaf)
        mats, _ = xb.leaf_matrices(raw, conv_pred(p))
        agg = xb.XbarStats(xbar_rows=xbar_rows, xbar_cols=xbar_cols)
        alive_out = total_out = 0
        for b in range(mats.shape[0]):
            st = xb.xbar_stats(mats[b] != 0, xr=xbar_rows, xc=xbar_cols)
            agg.merge(st)
            alive_out += int(xb.alive_columns(mats[b] != 0).sum())
            total_out += mats[b].shape[1]
        scales = raw.size // raw.shape[-2] if raw.ndim >= 2 else 0
        report.layers.append(LayerHW(p, agg, alive_out, total_out,
                                     vols.get(p, 0.0),
                                     scale_entries=scales))
    return report


def cnn_activation_volumes(cfg) -> Dict[str, float]:
    """Activation elements per sample for each conv layer of a CNNConfig."""
    size = cfg.image_size
    vols = {}
    for i, spec in enumerate(cfg.convs):
        size = size // spec.stride if spec.stride > 1 else size
        vols[f"convs/{i}/w"] = float(size * size * spec.out_channels)
        if spec.pool:
            size //= 2
    return vols
