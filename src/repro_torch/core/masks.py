"""Mask pytrees and prunability predicates (port of ``repro.core.masks``).

A mask pytree mirrors the parameter pytree: prunable leaves get a
{0,1} array (numpy) or tensor; non-prunable leaves get ``None``.  A mask
leaf may also broadcast to its parameter: a (K, N) mask on a stacked
(reps, K, N) weight prunes every layer alike.

Prunable (the reference's predicates, copied):
  * CNN: all conv kernels and FC matrices (paths under convs/shortcuts/
    fc/head) — BN scales/biases excluded.
  * LM: every ≥2-D projection matrix — embeddings, unembedding, norms,
    routers, biases and conv kernels excluded.
``family_prunable`` maps each model family (dense, moe, hybrid, ssm,
vlm, audio, cnn) to its predicate.

``tree_flatten_with_path`` walks a pytree in the reference's (JAX's)
leaf order — dict keys sorted, ``None`` a leaf — so everything that
depends on leaf order (global prune selection ties, checkpoint
manifests, hardware reports) agrees with the reference.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

# path substrings excluded from pruning for LM params
_LM_EXCLUDE = ("embed", "unembed", "norm", "router", "lam", "conv",
               "patch_proj", "frame_adapter", "bi", "bf", "bq", "bk", "bv",
               "up_b", "down_b", "bz", "bo")


def path_str(path) -> str:
    """A key path (``torch.utils._pytree``'s or JAX's) → "a/0/b" (the
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


def tree_flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(path string, leaf)] in JAX's order: dict keys sorted, lists,
    tuples and NamedTuples in order, ``None`` kept as a leaf."""
    out: List[Tuple[str, Any]] = []

    def visit(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    visit(tree, ())
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree):
    """``fn(path string, leaf)`` over every leaf (``None`` included),
    same nesting."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(v, path + (str(i),))
                                for i, v in enumerate(node)))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, path + (str(i),))
                              for i, v in enumerate(node))
        return fn("/".join(path), node)

    return rec(tree, ())


def lm_prunable(path: str, leaf) -> bool:
    if leaf.ndim < 2:
        return False
    low = path.lower()
    return not any(tok in low.split("/")[-1] or tok in low
                   for tok in _LM_EXCLUDE)


def cnn_prunable(path: str, leaf) -> bool:
    low = path.lower()
    if "bn" in low or "scale" in low or "bias" in low:
        return False
    if low.endswith("/b"):
        return False
    return leaf.ndim >= 2


def cnn_is_conv(path: str, leaf) -> bool:
    return leaf.ndim == 4


def cnn_conv_path(path: str) -> bool:
    """Path-level conv predicate for CNN params (the ``conv_pred``
    adapters and the family registry share)."""
    return "convs" in path or "shortcuts" in path


# ---------------------------------------------------------------------------
# Per-family predicates (the reference's, copied): the data the adapter
# registry hangs off each family entry
# ---------------------------------------------------------------------------
def moe_prunable(path: str, leaf) -> bool:
    """MoE transformers: dense projections plus the stacked per-expert
    ``up``/``gate``/``down`` tensors ``(E, d, d_ff)`` (and their stacked
    ``(reps, E, d, d_ff)`` forms).  Routers stay dense — killing router
    columns would silently disable experts without freeing crossbars."""
    return lm_prunable(path, leaf)


def recurrent_prunable(path: str, leaf) -> bool:
    """RG-LRU / xLSTM (hybrid + ssm families): in/gate/out projections,
    the block-diagonal per-head recurrence weights ``(H, bs, bs)``, and
    sLSTM input/recurrent matrices.  Temporal conv1d kernels, Λ decay
    vectors, and per-channel gate biases are excluded."""
    return lm_prunable(path, leaf)


def encdec_prunable(path: str, leaf) -> bool:
    """Encoder-decoder (whisper-style): encoder/decoder self-attention,
    MLPs, AND the decoder cross-attention ``xattn`` projections.  The
    frame-adapter stub and embeddings are excluded."""
    return lm_prunable(path, leaf)


_FAMILY_PRUNABLE = {
    "dense": lm_prunable,
    "moe": moe_prunable,
    "hybrid": recurrent_prunable,
    "ssm": recurrent_prunable,
    "vlm": lm_prunable,
    "audio": encdec_prunable,
    "cnn": cnn_prunable,
}


def family_prunable(family: str):
    """The prunability predicate for a registered config family."""
    if family not in _FAMILY_PRUNABLE:
        raise KeyError(f"no prunable predicate for family {family!r}; "
                       f"known: {sorted(_FAMILY_PRUNABLE)}")
    return _FAMILY_PRUNABLE[family]


def make_masks(params, prunable: Callable[[str, Any], bool]):
    """Full-ones float32 masks (on each leaf's device) for prunable
    leaves, None elsewhere."""
    def mk(path, leaf):
        if prunable(path, leaf):
            return torch.ones(leaf.shape, dtype=torch.float32,
                              device=leaf.device)
        return None
    return tree_map_with_path(mk, params)


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
    for _, m in tree_flatten_with_path(masks):
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
    """[(path, mask)] for prunable leaves, in the reference's order
    (masks come back as they are: numpy arrays or tensors)."""
    return [(p, m) for p, m in tree_flatten_with_path(masks)
            if m is not None]


def tree_set(tree, path: str, value):
    """Functionally set a leaf by its path string (numpy or tensors)."""
    keys = path.split("/")

    def rec(node, ks):
        k = ks[0]
        if isinstance(node, dict):
            new = dict(node)
            new[k] = value if len(ks) == 1 else rec(node[k], ks[1:])
            return new
        if isinstance(node, (list, tuple)):
            idx = int(k)
            items = list(node)
            items[idx] = value if len(ks) == 1 else rec(items[idx], ks[1:])
            return type(node)(items) if not isinstance(node, list) else items
        raise TypeError(f"cannot descend into {type(node)} at {k}")

    return rec(tree, keys)
