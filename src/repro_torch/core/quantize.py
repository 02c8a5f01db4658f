"""Fixed-point weight quantization, the ReRAM-native representation
(port of the parts of ``repro.core.quantize`` a recipe's ``quantize``
stage needs).

The paper's platform computes in 16-bit fixed point.  Scheme:
per-output-channel symmetric, scale = max|w| / qmax over axis -2;
masked (pruned) weights quantize to exact 0 at any scale.
``fake_quantize`` is the straight-through pass of a recipe's
``quantize`` stage: the forward sees the fixed-point value, the backward
the identity.  Rounding is half-to-even in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.masks import tree_map_with_path


class QTensor(NamedTuple):
    q: torch.Tensor          # int8/int16 values
    scale: torch.Tensor      # (..., 1, out) f32 per-output-channel scales


_QMAX = {torch.int8: 127.0, torch.int16: 32767.0}


def quantize(w, bits: int = 8) -> QTensor:
    """w: (..., in, out) → QTensor with per-out-channel scales."""
    dtype = torch.int8 if bits == 8 else torch.int16
    qmax = _QMAX[dtype]
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-12) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(dtype)
    return QTensor(q=q, scale=scale)


def dequantize(qt: QTensor, dtype=torch.bfloat16):
    return (qt.q.float() * qt.scale).to(dtype)


def fake_quantize(w, bits: int = 8):
    """Straight-through fake quantization: forward sees the fixed-point
    value, backward sees identity; masked weights round-trip to 0."""
    wq = dequantize(quantize(w, bits), torch.float32).to(w.dtype)
    return w + (wq - w).detach()


def fake_quantize_tree(params, predicate, bits: int = 8):
    """STE fake-quantize every ≥2-D leaf where predicate(path, leaf)
    (wraps a training loss: ``loss(fake_quantize_tree(p, pred), batch)``)."""
    def f(path, leaf):
        # per-out-channel scales need an (in, out) trailing pair; 1-D
        # leaves (norm gains, biases) stay full precision
        if (leaf is not None and getattr(leaf, "ndim", 0) >= 2
                and predicate(path, leaf)):
            return fake_quantize(leaf, bits)
        return leaf

    return tree_map_with_path(f, params)
