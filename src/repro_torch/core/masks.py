"""Mask pytrees and prunability predicates (port of ``repro.core.masks``).

A mask pytree mirrors the parameter pytree: prunable leaves get a
{0,1} array (numpy) or tensor; non-prunable leaves get ``None``.  A mask
leaf may also broadcast to its parameter: a (K, N) mask on a stacked
(reps, K, N) weight prunes every layer alike.

Prunable for LMs: every ≥2-D projection matrix — embeddings,
unembedding, norms, routers, biases and conv kernels excluded (the
reference's exclusion list, copied), and for each model family the
reference's predicate (``family_prunable``) where the port serves the
family (dense and MoE so far).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree

# path substrings excluded from pruning for LM params
_LM_EXCLUDE = ("embed", "unembed", "norm", "router", "lam", "conv",
               "patch_proj", "frame_adapter", "bi", "bf", "bq", "bk", "bv",
               "up_b", "down_b", "bz", "bo")


def path_str(path) -> str:
    """``torch.utils._pytree`` key path → "a/0/b" (same form as the
    reference's ``core.masks.path_str``)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def lm_prunable(path: str, leaf) -> bool:
    if leaf.ndim < 2:
        return False
    low = path.lower()
    return not any(tok in low.split("/")[-1] or tok in low
                   for tok in _LM_EXCLUDE)


# ---------------------------------------------------------------------------
# Per-family predicates (the reference's, copied, for the families the
# port can serve; the others come with their slices)
# ---------------------------------------------------------------------------
def moe_prunable(path: str, leaf) -> bool:
    """MoE transformers: dense projections plus the stacked per-expert
    ``up``/``gate``/``down`` tensors ``(E, d, d_ff)`` (and their stacked
    ``(reps, E, d, d_ff)`` forms).  Routers stay dense — killing router
    columns would silently disable experts without freeing crossbars."""
    return lm_prunable(path, leaf)


_FAMILY_PRUNABLE = {
    "dense": lm_prunable,
    "moe": moe_prunable,
}
_NOT_YET_PORTED = ("hybrid", "ssm", "vlm", "audio", "cnn")


def family_prunable(family: str):
    """The prunability predicate for a registered config family."""
    if family in _NOT_YET_PORTED:
        raise NotImplementedError(f"the {family!r} prunability predicate is "
                                  "not yet ported to repro_torch")
    if family not in _FAMILY_PRUNABLE:
        raise KeyError(f"no prunable predicate for family {family!r}; "
                       f"known: {sorted(_FAMILY_PRUNABLE)}")
    return _FAMILY_PRUNABLE[family]


def make_masks(params, prunable: Callable[[str, Any], bool]):
    """Full-ones float32 masks (on each leaf's device) for prunable
    leaves, None elsewhere."""
    def mk(path, leaf):
        if prunable(path_str(path), leaf):
            return torch.ones(leaf.shape, dtype=torch.float32,
                              device=leaf.device)
        return None
    return _pytree.tree_map_with_path(mk, params)


def _as_factor(m, p: torch.Tensor) -> torch.Tensor:
    """A mask leaf as a tensor on p's device that multiplies p without
    changing its dtype (a bool mask broadcasts as it is)."""
    m = torch.as_tensor(m, device=p.device)
    return m if m.dtype == torch.bool else m.to(p.dtype)


def apply_masks(params, masks):
    """params ⊙ masks (identity where a mask leaf is None).

    Mask leaves may be numpy arrays or tensors of any shape that
    broadcasts to the parameter."""
    def rec(p, m):
        if m is None:
            return p
        if isinstance(p, dict):
            return {k: rec(v, m.get(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(rec(a, b) for a, b in zip(p, m))
        return p * _as_factor(m, p)

    return rec(params, masks)


def apply_masks_(params, masks):
    """``apply_masks`` IN PLACE: each masked leaf is multiplied by its
    mask where it lies, so no masked copy of a full-width weight is
    made.  Returns ``params``."""
    def rec(p, m):
        if m is None:
            return
        if isinstance(p, dict):
            for k, v in p.items():
                rec(v, m.get(k))
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, m):
                rec(a, b)
        else:
            p.mul_(_as_factor(m, p))

    rec(params, masks)
    return params


def mask_grads(grads, masks):
    """Zero gradients of pruned weights (keeps them pruned under any
    optimizer)."""
    return apply_masks(grads, masks)


def _count(m) -> Tuple[int, int]:
    """(size, live) of one mask leaf."""
    if torch.is_tensor(m):
        return m.numel(), int(torch.count_nonzero(m).item())
    m = np.asarray(m)
    return m.size, int(np.count_nonzero(m))


def sparsity(masks) -> Tuple[int, int]:
    """(pruned_weights, total_prunable_weights)."""
    total = pruned = 0
    for m in _pytree.tree_leaves(masks):
        if m is None:
            continue
        size, live = _count(m)
        total += size
        pruned += size - live
    return pruned, total


def sparsity_fraction(masks) -> float:
    p, t = sparsity(masks)
    return p / max(t, 1)


def flat_mask_items(masks) -> List[Tuple[str, Any]]:
    """[(path, mask)] for prunable leaves, in pytree order (masks come
    back as they are: numpy arrays or tensors)."""
    flat, _ = _pytree.tree_flatten_with_path(masks)
    return [(path_str(p), m) for p, m in flat if m is not None]
