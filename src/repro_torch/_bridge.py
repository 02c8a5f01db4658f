"""Carry parameter pytrees between numpy and the port's tensors.

The reference's parameter pytree (dicts, lists and NamedTuples of JAX
arrays, mapped to numpy by the caller) becomes the same nesting of torch
tensors here, and back.  Also the device check every entry point runs,
and the mask helpers copied from ``repro.core.masks``.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA must really be there.

    There is no fallback: asking for ``"cuda"`` on a machine without a
    card raises instead of quietly running the plain CPU versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions")
        if dev.index is None:       # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _map(fn: Callable, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX's arrays come through as
        # ml_dtypes.bfloat16, whose bits torch reads as its bfloat16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, *, device, dtype=None):
    """numpy pytree → the same nesting of tensors on ``device``.

    ``dtype`` casts floating leaves (integer leaves keep theirs)."""
    dev = resolve_device(device)

    def conv(a):
        t = _tensor_from_numpy(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return _map(conv, tree)


def to_numpy(tree):
    """Tensor pytree → numpy pytree.  bfloat16 leaves come back as
    float32 (exact: every bfloat16 value is a float32 value)."""
    def conv(t):
        if not torch.is_tensor(t):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(conv, tree)


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


def apply_masks(params, masks):
    """params ⊙ masks (identity where a mask leaf is None).

    Mask leaves may be numpy arrays or tensors of any shape that
    broadcasts to the parameter (a (K, N) mask on a (reps, K, N) stacked
    weight prunes every layer alike)."""
    def ap(p, m):
        if m is None:
            return p
        m = torch.as_tensor(m, device=p.device)
        return p * m.to(p.dtype)

    def rec(p, m):
        if m is None:
            return p
        if isinstance(p, dict):
            return {k: rec(v, m.get(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(rec(a, b) for a, b in zip(p, m))
        return ap(p, m)

    return rec(params, masks)


def tree_leaves(tree) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def tree_index(tree, i: int):
    """Slice every leaf of a stacked pytree at ``i`` on its leading axis
    (views: writes through them land in the stacked tensor)."""
    return _map(lambda t: t[i], tree)


def tree_stack(trees: list) -> Any:
    """Stack same-structure pytrees along a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_stack([t[i] for t in trees])
                             for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)
