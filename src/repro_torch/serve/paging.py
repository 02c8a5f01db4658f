"""Block-pool allocator for the paged KV cache (a copy of
``repro.serve.paging``).

``BlockPool`` is the host-side bookkeeping half of paging: a free list
of physical block ids over the device pools that
``models.transformer.make_paged_caches`` allocates.

Admission is reservation-based so it is decided at refill time without
deadlock: a request *reserves* ``ceil((prompt + budget) / BLOCK)`` blocks
up front, then draws them down one ``alloc`` at a time as decode crosses
block boundaries.  ``available`` subtracts outstanding reservations from
the free list, so if a reservation fits, every later ``alloc`` of that
request is guaranteed.

Block id 0 (by default) is the *scratch* block: idle slot rows in the
block table point at it, so the decode kernel's table always holds
valid ids and inactive-lane appends land somewhere harmless.  It is
never handed out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class PoolError(RuntimeError):
    """Violation of pool discipline (double-free, alloc w/o reserve...)."""


class BlockPool:
    """Free-list allocator over ``num_blocks`` physical KV blocks."""

    def __init__(self, num_blocks: int, *, reserved_ids: Tuple[int, ...] = (0,)):
        if num_blocks <= len(reserved_ids):
            raise ValueError(
                f"pool needs > {len(reserved_ids)} blocks, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.reserved_ids = tuple(int(i) for i in reserved_ids)
        # LIFO free list → recently-freed blocks are reused first (warm)
        self._free: List[int] = [i for i in range(num_blocks - 1, -1, -1)
                                 if i not in self.reserved_ids]
        self._owned: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self.peak = 0

    @property
    def live(self) -> int:
        """Blocks currently holding some request's KV state."""
        return sum(len(v) for v in self._owned.values())

    @property
    def outstanding(self) -> int:
        """Reserved-but-not-yet-allocated blocks."""
        return sum(self._reserved.values())

    @property
    def available(self) -> int:
        """Blocks admissible to *new* reservations right now."""
        return len(self._free) - self.outstanding

    def owned(self, uid: int) -> Tuple[int, ...]:
        return tuple(self._owned.get(uid, ()))

    def check(self) -> None:
        """Internal consistency: every block accounted for exactly once."""
        seen = set(self.reserved_ids)
        for pid in self._free:
            if pid in seen:
                raise PoolError(f"block {pid} double-tracked (free)")
            seen.add(pid)
        for uid, pids in self._owned.items():
            for pid in pids:
                if pid in seen:
                    raise PoolError(f"block {pid} double-tracked (uid {uid})")
                seen.add(pid)
        if len(seen) != self.num_blocks:
            raise PoolError(
                f"{self.num_blocks - len(seen)} blocks leaked "
                f"(free={len(self._free)} live={self.live})")
        if self.outstanding > len(self._free):
            raise PoolError("reservations exceed free blocks")

    def can_reserve(self, n: int) -> bool:
        return n <= self.available

    def reserve(self, uid: int, n: int) -> None:
        """Admit ``uid`` with a guaranteed budget of ``n`` blocks total."""
        if n <= 0:
            raise ValueError(f"reservation must be positive, got {n}")
        if uid in self._reserved or uid in self._owned:
            raise PoolError(f"uid {uid} already admitted")
        if not self.can_reserve(n):
            raise PoolError(
                f"cannot reserve {n} blocks ({self.available} available)")
        self._reserved[uid] = n
        self._owned[uid] = []

    def alloc(self, uid: int) -> int:
        """Draw one block from ``uid``'s reservation."""
        if uid not in self._owned:
            raise PoolError(f"uid {uid} not admitted")
        if self._reserved.get(uid, 0) <= 0:
            raise PoolError(f"uid {uid} reservation exhausted "
                            f"({len(self._owned[uid])} blocks drawn)")
        pid = self._free.pop()
        self._reserved[uid] -= 1
        self._owned[uid].append(pid)
        self.peak = max(self.peak, self.live)
        return pid

    def release(self, uid: int) -> Tuple[int, ...]:
        """Free everything ``uid`` holds (blocks + remaining reservation)."""
        if uid not in self._owned:
            raise PoolError(f"uid {uid} not admitted")
        pids = self._owned.pop(uid)
        self._reserved.pop(uid, None)
        self._free.extend(reversed(pids))
        return tuple(pids)


def blocks_needed(tokens: int, block: int) -> int:
    """ceil(tokens / block) — the admission formula's block count."""
    return -(-tokens // block)
