"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

Only the oracle this slice needs is here; ``bsmm.py`` and
``paged_attention.py`` keep each kernel's plain version beside it.
"""
from __future__ import annotations

import torch


def masked_matmul_ref(x, w, mask):
    """Elementwise-masked matmul oracle: ``x @ (w ⊙ mask)`` with f32
    accumulation, output in x's dtype."""
    wm = w * mask.to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)
