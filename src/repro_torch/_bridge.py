"""Carry parameter pytrees between numpy and the port's tensors.

The reference's parameter pytree (dicts, lists and NamedTuples of JAX
arrays, mapped to numpy by the caller) becomes the same nesting of torch
tensors here, and back.  Also the device check every entry point runs
and the pytree helpers; the mask helpers live in ``core.masks`` and are
re-exported here.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.masks import (apply_masks, path_str,  # noqa: F401
                                    tree_map_with_path)

# leaves the reference keeps in float32 whatever the tree's dtype (the
# RG-LRU's decay parameter Λ, the mLSTM's and sLSTM's gate biases)
_F32_LEAVES = ("lam", "bi", "bf", "bz", "bo")


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


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf (None stays None), same nesting."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX's arrays come through as
        # ml_dtypes.bfloat16, whose bits torch reads as its bfloat16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _port_tuple(node):
    """The port's NamedTuple of the same name as ``node``'s (a reference
    cache: ``KVCache``, ``MLACache``, ``RGLRUState``, ``MLSTMState``,
    ``SLSTMState``, ``CrossKV``), else its own."""
    from repro_torch.models import attention, encdec, recurrent
    for mod in (attention, recurrent, encdec):
        cls = getattr(mod, type(node).__name__, None)
        if cls is not None and getattr(cls, "_fields", None) == node._fields:
            return cls
    return type(node)


def params_from_numpy(tree, *, device, dtype=None):
    """numpy pytree → the same nesting of tensors on ``device``.

    ``dtype`` casts floating leaves (integer leaves keep theirs, and so
    do the recurrent cells' float32 Λ and gate biases).  The reference's
    cache NamedTuples become the port's, so a reference prefill's caches
    decode here."""
    dev = resolve_device(device)

    def conv(path, a):
        if a is None:
            return None
        t = _tensor_from_numpy(a)
        if (dtype is not None and t.is_floating_point()
                and path.split("/")[-1] not in _F32_LEAVES):
            t = t.to(dtype)
        return t.to(dev)

    def retype(node):
        if isinstance(node, dict):
            return {k: retype(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return _port_tuple(node)(*(retype(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(retype(v) for v in node)
        return node

    return tree_map_with_path(conv, retype(tree))


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

    return tree_map(conv, tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """``tree``'s nesting with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_zip(fn: Callable, tree, *others):
    """``fn(leaf, *other_leaves)`` over trees of one nesting (leaves
    paired in ``tree_leaves`` order); None leaves of ``tree`` stay
    None."""
    flat = [tree_leaves(o) for o in others]
    return tree_unflatten(tree, [fn(*a) for a in zip(tree_leaves(tree),
                                                      *flat)])


def tree_unbind(tree, n: int) -> list:
    """A stacked pytree → ``n`` per-repeat pytrees of views.  Each leaf
    is unbound once, so a backward through all ``n`` views stacks their
    grads in one step instead of adding ``n`` full-size zero-padded
    slices."""
    per_leaf = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[i] for u in per_leaf]) for i in range(n)]


def tree_index(tree, i: int):
    """Slice every leaf of a stacked pytree at ``i`` on its leading axis
    (views: writes through them land in the stacked tensor)."""
    return tree_map(lambda t: t[i], tree)


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
