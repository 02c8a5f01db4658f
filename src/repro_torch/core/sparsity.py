"""Sparsity statistics over mask pytrees (port of
``repro.core.sparsity``; mask leaves may be numpy arrays or tensors)."""
from __future__ import annotations

from typing import Dict

from repro_torch._bridge import to_numpy
from repro_torch.core.masks import tree_flatten_with_path


def per_leaf_sparsity(masks) -> Dict[str, float]:
    out = {}
    for path, leaf in tree_flatten_with_path(masks):
        if leaf is not None:
            m = to_numpy(leaf)
            out[path] = 1.0 - float(m.sum()) / m.size
    return out


def summary(masks) -> Dict[str, float]:
    total = nz = 0
    for _, m in tree_flatten_with_path(masks):
        if m is None:
            continue
        m = to_numpy(m)
        total += m.size
        nz += float(m.sum())
    return {
        "prunable_weights": total,
        "nonzero_weights": nz,
        "sparsity": 1.0 - nz / max(total, 1),
        "remaining_fraction": nz / max(total, 1),
    }
