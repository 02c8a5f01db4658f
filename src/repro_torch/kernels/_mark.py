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
"""
from __future__ import annotations

import functools

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
