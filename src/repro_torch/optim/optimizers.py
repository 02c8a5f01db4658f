"""Optimizers as (init, update) pairs over pytrees (port of
``repro.optim.optimizers``).

``masked`` wraps any optimizer for lottery-ticket training: gradients of
pruned weights are zeroed *before* the inner update and the updated
params are re-masked *after*, so pruned weights stay exactly zero under
momentum/weight decay.

The updates run in float32 and cast back to the parameter dtype, as the
reference does.  The optimizer state (momenta, moments) is updated IN
PLACE, leaf by leaf: the reference's jitted step donates it, so the old
state is dead either way, and a functional update would hold a second
full copy of the f32 moments (25.7 GB for llama3.2-3b).  A leaf of
more than ``_CHUNK`` elements (an embedding table, a stack of layers or
experts) is updated in blocks of leading-axis slices of at most that
size, so the f32 temporaries stay small (a 926 M-element embedding
would take ~3.7 GB per temporary); the update is elementwise, so the
blocks give the bits the whole leaf would.  New parameters are new
tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch._bridge import tree_leaves, tree_map, tree_zip
from repro_torch.core.masks import apply_masks

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (new_params, new_state)


def _tree_zeros_like(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def _step0():
    return torch.zeros((), dtype=torch.int32)


#: elements of one block of a leaf's update (64 Mi: 256 MB an f32 temporary)
_CHUNK = 1 << 26


def _sliced(fn, p: torch.Tensor, *state) -> torch.Tensor:
    """New ``p`` = ``fn(p, *state)`` (an elementwise update, which may
    update ``state`` in place), over blocks of leading-axis slices of at
    most ``_CHUNK`` elements; a slice larger than that is cut the same
    way along its own leading axis."""
    if p.ndim < 2 or p.numel() <= _CHUNK:
        return fn(p, *state)
    out = torch.empty_like(p)
    per = p[0].numel()
    if per >= _CHUNK:
        for i in range(p.shape[0]):
            out[i] = _sliced(fn, p[i], *(s[i] for s in state))
        return out
    rows = _CHUNK // per
    for i in range(0, p.shape[0], rows):
        blk = slice(i, i + rows)
        out[blk] = fn(p[blk], *(s[blk] for s in state))
    return out


def sgd(lr_fn, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum — the paper's training recipe (LR 0.1, m 0.9)."""

    def init(params):
        return {"mu": _tree_zeros_like(params), "step": _step0()}

    def update(grads, state, params):
        lr = lr_fn(state["step"])

        def upd(p, g, m):
            g = g.to(_F32)
            if weight_decay:
                g = g + weight_decay * p.to(_F32)
            m.mul_(momentum).add_(g)
            step_dir = g + momentum * m if nesterov else m
            return (p.to(_F32) - lr * step_dir).to(p.dtype)

        new_params = tree_zip(lambda p, g, m: _sliced(upd, p, g, m),
                              params, grads, state["mu"])
        return new_params, {"mu": state["mu"], "step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _tree_zeros_like(params), "v": _tree_zeros_like(params),
                "step": _step0()}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(state["step"])
        bc1 = 1 - torch.tensor(b1, dtype=_F32) ** step.to(_F32)
        bc2 = 1 - torch.tensor(b2, dtype=_F32) ** step.to(_F32)

        def upd(p, g, m, v):
            g = g.to(_F32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / bc1) / ((v / bc2).sqrt() + eps) \
                + weight_decay * p.to(_F32)
            return (p.to(_F32) - lr * delta).to(p.dtype)

        new_params = tree_zip(lambda p, g, m, v: _sliced(upd, p, g, m, v),
                              params, grads, state["m"], state["v"])
        return new_params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


def with_gradient_clipping(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params):
        sq = [g.to(_F32).square().sum() for g in tree_leaves(grads)]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        gnorm = torch.sqrt(total)
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        # a low-precision grad times the f32 scale is f32, as in JAX
        grads = tree_map(lambda g: g.to(_F32) * scale, grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def masked(opt: Optimizer, masks) -> Optimizer:
    """Lottery-ticket wrapper: keep pruned coordinates exactly zero."""

    def update(grads, state, params):
        grads = apply_masks(grads, masks)
        new_params, new_state = opt.update(grads, state, params)
        return apply_masks(new_params, masks), new_state

    return Optimizer(opt.init, update)
