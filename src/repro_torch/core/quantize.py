"""Fixed-point weight quantization, the ReRAM-native representation
(port of ``repro.core.quantize``).

The paper's platform computes in 16-bit fixed point.  Scheme:
per-output-channel symmetric, scale = max|w| / qmax over axis -2, so a
stacked ``(R, in, out)`` or ``(E, d, ff)`` leaf gets one scale per layer
or expert and per column; masked (pruned) weights quantize to exact 0 at
any scale.  Quantize *after* ``core.packing`` so that scales cover only
live columns.  ``fake_quantize`` is the straight-through pass of a
recipe's ``quantize`` stage: the forward sees the fixed-point value, the
backward the identity.  Rounding is half-to-even in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.masks import tree_flatten_with_path, tree_map_with_path

# elements of one f32 temporary of the fake pass: a stacked leaf larger
# than this is quantized in slices of its leading axis (the same bits,
# since every scale is per leading index and column)
_CHUNK_ELEMS = 1 << 27


class QTensor(NamedTuple):
    q: torch.Tensor          # int8/int16 values
    scale: torch.Tensor      # (..., 1, out) f32 per-output-channel scales

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


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


def qmatmul(x, qt: QTensor):
    """x @ dequant(qt): the int values in x's dtype, then the per-column
    scale on the product."""
    return (x @ qt.q.to(x.dtype)) * qt.scale[..., 0, :].to(x.dtype)


def _slices(w):
    """Leading-axis slices of ``w`` whose f32 copies stay near
    ``_CHUNK_ELEMS`` elements (one slice for a 2-D leaf)."""
    if w.ndim < 3 or w.numel() <= _CHUNK_ELEMS:
        return [slice(None)]
    per = max(1, _CHUNK_ELEMS // (w.numel() // w.shape[0]))
    return [slice(i, i + per) for i in range(0, w.shape[0], per)]


def fake_quantize(w, bits: int = 8):
    """Straight-through fake quantization: forward sees the fixed-point
    value, backward sees identity; masked weights round-trip to 0.

    The quantize chain runs under ``no_grad`` (the f32 temporaries of a
    leaf that requires grad would otherwise stay alive in its graph),
    slice by slice along a large stacked leaf's leading axis."""
    with torch.no_grad():
        delta = torch.empty_like(w)
        for s in _slices(w):
            wq = dequantize(quantize(w[s], bits), torch.float32).to(w.dtype)
            delta[s] = wq - w[s]
    return w + delta


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


def quantize_tree(params, predicate, bits: int = 8):
    """Quantize every leaf where predicate(path, leaf); others pass."""
    def f(path, leaf):
        if leaf is not None and predicate(path, leaf):
            return quantize(leaf, bits)
        return leaf

    return tree_map_with_path(f, params)


def tree_bytes(tree) -> int:
    """Stored bytes of a (possibly quantized) parameter tree: a QTensor
    counts its int values and its scales."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in tree_flatten_with_path(tree)
               if leaf is not None)
