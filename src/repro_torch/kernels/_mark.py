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
"""
from __future__ import annotations

import functools

#: kernel bodies being run right now (a wrapper may call another)
depth = 0
#: wrapper calls since import (the audit reads its growth)
entered = 0


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
