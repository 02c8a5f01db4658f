"""The kernel wrappers' body mark, read by ``analysis.dispatch_audit``.

Every public kernel wrapper (``bsmm``, ``bsmm_epilogue``,
``bsmm_batched``, ``bsmm_dx``, ``bsmm_dw``, ``bsmm_batched_dx``,
``bsmm_batched_dw``, ``masked_matmul``, ``paged_attention``,
``flash_attention``, ``tile_stats``) is wrapped by ``marked``: while
its body runs — the CUDA launch on the card, the plain version (whose
dense ``aten.mm`` on the weights is the point of a kernel) on the CPU —
``depth`` is above zero, and each call adds one to ``entered``.  The
audit skips the aten ops issued at ``depth > 0``, as the reference's
jaxpr audit does not descend into a ``pallas_call``, and reads
``entered`` to see that a closure reached a kernel at all.

The mark is two integer updates and one Python frame a call — no
context manager, no registered op — and changes no result, route,
split count or launch count.

``trace`` is the ``launch.hlo_analysis.StepTrace`` being recorded (None
outside one).  ``traced`` is each wrapper's first check: with fake
operands under an active trace the wrapper launches nothing, records
the launch its rule would make, and returns a fake output; a fake
operand with no trace active raises.

``alike_steps`` is the model layer's loop over alike steps (the sLSTM's
tokens, the mLSTM's chunks): a plain Python loop, or under a trace one
step recorded as all of them.
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: kernel bodies being run right now (a wrapper may call another)
depth = 0
#: wrapper calls since import (the audit reads its growth)
entered = 0
#: the active StepTrace, set and cleared by the trace itself
trace = None


def traced(*ts) -> bool:
    """True when an operand is a fake tensor and a ``StepTrace`` is
    active (the wrapper's fake branch); a fake first operand with no
    trace active raises: no launch can take it.  With no trace (every
    real launch) the check is one ``isinstance`` of the first operand:
    fakes and real tensors do not mix in one call."""
    if trace is not None:
        return any(isinstance(t, FakeTensor) for t in ts)
    if isinstance(ts[0], FakeTensor):
        raise RuntimeError("a fake tensor reached a kernel wrapper with no "
                           "StepTrace active")
    return False


def marked(fn):
    """Mark ``fn``'s body for the dispatch audit (see the module)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global depth, entered
        depth += 1
        entered += 1
        try:
            return fn(*args, **kwargs)
        finally:
            depth -= 1

    return wrapper


class _RepeatedStep(torch.autograd.Function):
    """One loop step run under the trace's ``repeated``, its backward
    too: the step's graph is built inside the forward and differentiated
    in the backward, both recorded ``n`` times over.  The step's graph
    keeps its own saved tensors (identity hooks over remat's), so that
    its backward recomputes no checkpointed layer inside ``repeated``.
    Every step's gradient of an input in ``summed`` adds into its sum."""

    @staticmethod
    def forward(ctx, fn, n, summed, *args):
        ins = tuple(a.detach().requires_grad_(a.is_floating_point())
                    for a in args)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t), trace.repeated(n):
            outs = fn(*ins)
        ctx.n, ctx.summed, ctx.ins, ctx.outs = n, summed, ins, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        pairs = [(o, g) for o, g in zip(ctx.outs, gouts)
                 if g is not None and o.requires_grad]
        wrt = [i for i, a in enumerate(ctx.ins) if a.requires_grad]
        grads = [None] * len(ctx.ins)
        with trace.repeated(ctx.n):
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [ctx.ins[i] for i in wrt],
                                      [g for _, g in pairs],
                                      allow_unused=True)
        for i, g in zip(wrt, got):
            grads[i] = g
        with trace.repeated(ctx.n - 1):
            for i, g in enumerate(grads):
                if g is not None and i in ctx.summed:
                    g.add(g)
        return (None, None, None, *grads)


def alike_steps(step, n: int, dim: int, consts, xs, carry):
    """The loop ``y_i, carry = step(consts, xs_i, carry)`` for i < ``n``,
    ``xs_i`` the i-th of n equal slices of every tensor of ``xs`` along
    ``dim`` → (the y_i concatenated along ``dim``, the last carry).
    ``consts`` are the tensors every step reads.

    With fake operands under a trace it runs the first step only,
    recorded as the n — forward, and backward where autograd records,
    the steps' gradients of ``consts`` and ``xs`` summed (as an eager
    backward adds each step's slice gradient into the whole) — its
    y standing for every step's: the trace's stand-in for a loop that
    would issue n times the same ops one by one (the reference's HLO
    counts a ``while`` body by its trip count)."""
    size = xs[0].shape[dim] // n
    if n > 1 and trace is not None and traced(*xs):
        k, m = len(consts), len(xs)

        def flat(*a):
            y, c = step(a[:k], [x.narrow(dim, 0, size) for x in a[k:k + m]],
                        a[k + m:])
            return (y, *c)

        args = (*consts, *xs, *carry)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            out = _RepeatedStep.apply(flat, n, frozenset(range(k + m)),
                                      *args)
        else:
            with trace.repeated(n):
                out = flat(*args)
        y = out[0]
        shape = list(y.shape)
        shape.insert(dim, n)
        return y.unsqueeze(dim).expand(shape).flatten(dim, dim + 1), out[1:]
    ys = []
    for i in range(n):
        y, carry = step(consts, [x.narrow(dim, i * size, size) for x in xs],
                        carry)
        ys.append(y)
    return torch.cat(ys, dim), carry
