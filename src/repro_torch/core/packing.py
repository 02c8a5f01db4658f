"""Physical packing of pruned FFNs — "freed crossbars reused", realised
(port of ``repro.core.packing``).

The paper's hardware saving comes from *reusing* crossbar rows and
columns freed by structured pruning (Fig. 2/3).  The dense analogue
packs the surviving FFN columns into a narrower matmul: a
filter/channel-pruned (d, ff) ``up``/``gate`` pair with s % dead columns
becomes (d, ff'), ff' = live columns rounded up to the 128-wide tile,
with ``down``'s rows packed identically.

Stacked layers share one ff' (the most live columns over the stack, so
no layer loses weights); per-layer column permutations differ.  The
permutations are computed on the host from the masks; the gathers run
in torch on the weights' device (``index_select``), so bf16 weights
stay bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MXU_TILE

LANE = MXU_TILE


def _nonzero_any(m, axis: int) -> np.ndarray:
    """``(m != 0).any(axis)`` on the mask's own device, as numpy bool."""
    t = torch.as_tensor(m)
    return (t != 0).any(dim=axis).cpu().numpy()


def _live_columns(masks_up, masks_gate, masks_down) -> np.ndarray:
    """A column is dead iff dead in up AND gate AND the down row. (…, ff)"""
    dead = ~_nonzero_any(masks_up, -2)
    if masks_gate is not None:
        dead &= ~_nonzero_any(masks_gate, -2)
    dead &= ~_nonzero_any(masks_down, -1)
    return ~dead


def packed_width(live: np.ndarray) -> int:
    """Shared ff' for a (possibly stacked) live map (…, ff)."""
    per_layer = live.reshape(-1, live.shape[-1]).sum(axis=-1)
    return max(LANE, int(-(-int(per_layer.max()) // LANE) * LANE))


def _perm_for(live_row: np.ndarray, ffp: int) -> np.ndarray:
    """Column permutation: live columns first, padded with dead ones."""
    live_idx = np.nonzero(live_row)[0]
    dead_idx = np.nonzero(~live_row)[0]
    perm = np.concatenate([live_idx, dead_idx])[:ffp]
    if len(perm) < ffp:      # ff < ffp cannot happen (ffp ≤ ff by clamp)
        perm = np.pad(perm, (0, ffp - len(perm)))
    return perm.astype(np.int32)


def _masked(w, m):
    return w * torch.as_tensor(m, device=w.device).to(w.dtype)


def pack_ffn(up, gate, down, m_up, m_gate, m_down
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                        int]:
    """Pack one FFN (2-D (d, ff) or stacked (…, d, ff)) to ff' columns.

    Returns (up', gate', down', ff').  Weights are mask-applied before
    packing so dead-but-kept padding columns are exact zeros.  A mask
    may broadcast over a stacked weight's leading axes.
    """
    up_n = _masked(up, m_up)
    gate_n = None if gate is None else _masked(gate, m_gate)
    down_n = _masked(down, m_down)
    live = _live_columns(m_up, m_gate, m_down)
    lead = up_n.shape[:-2]
    live = np.broadcast_to(live, (*lead, live.shape[-1]))
    ffp = min(packed_width(live), up_n.shape[-1])

    up2 = up_n.reshape(-1, *up_n.shape[-2:])
    down2 = down_n.reshape(-1, *down_n.shape[-2:])
    gate2 = None if gate_n is None else gate_n.reshape(-1,
                                                      *gate_n.shape[-2:])
    live2 = live.reshape(-1, live.shape[-1])

    ups, gates, downs = [], [], []
    for i in range(up2.shape[0]):
        perm = torch.as_tensor(_perm_for(live2[i], ffp), dtype=torch.long,
                               device=up_n.device)
        ups.append(up2[i].index_select(-1, perm))
        if gate2 is not None:
            gates.append(gate2[i].index_select(-1, perm))
        downs.append(down2[i].index_select(0, perm))
    up_p = torch.stack(ups).reshape(*lead, up_n.shape[-2], ffp)
    down_p = torch.stack(downs).reshape(*lead, ffp, down_n.shape[-1])
    gate_p = None if gate2 is None else torch.stack(gates).reshape(
        *lead, gate_n.shape[-2], ffp)
    return up_p, gate_p, down_p, ffp


def pack_lm_params(params, masks, cfg):
    """Pack every dense MLP of a transformer params tree.

    Returns (packed_params, packed_cfg); when no column packs away, the
    input pair itself.  Only dense ``mlp`` blocks are packed (MoE
    experts pack per expert the same way through ``pack_ffn`` on their
    stacked (E, d, ff) leaves).
    """
    global_ffp = 0
    # first pass: the shared ff' across all layers
    for seg_p, seg_m in zip(params["segments"], masks["segments"]):
        for p, m in zip(seg_p, seg_m):
            if isinstance(p, dict) and "mlp" in p and m.get("mlp"):
                live = _live_columns(m["mlp"]["up"], m["mlp"].get("gate"),
                                     m["mlp"]["down"])
                global_ffp = max(global_ffp, packed_width(live))
    if global_ffp == 0 or global_ffp >= cfg.d_ff:
        return params, cfg

    def fit(w, axis):
        # clamp to the global width: pad with zero columns (rows)
        cur = w.shape[axis]
        if cur == global_ffp:
            return w
        pad = [0, 0] * (w.ndim - axis - 1) + [0, global_ffp - cur]
        return F.pad(w, pad)

    new_segments = []
    for seg_p, seg_m in zip(params["segments"], masks["segments"]):
        new_pos = []
        for p, m in zip(seg_p, seg_m):
            if isinstance(p, dict) and "mlp" in p and m.get("mlp"):
                mlp_p = dict(p["mlp"])
                up, gate, down, _ = pack_ffn(
                    mlp_p["up"], mlp_p.get("gate"), mlp_p["down"],
                    m["mlp"]["up"], m["mlp"].get("gate"),
                    m["mlp"]["down"])
                mlp_p["up"] = fit(up, up.ndim - 1)
                if gate is not None:
                    mlp_p["gate"] = fit(gate, gate.ndim - 1)
                mlp_p["down"] = fit(down, down.ndim - 2)
                p = {**p, "mlp": mlp_p}
            new_pos.append(p)
        new_segments.append(new_pos)
    packed = {**params, "segments": new_segments}
    return packed, dataclasses.replace(cfg, d_ff=global_ffp,
                                       name=cfg.name + "-packed")
