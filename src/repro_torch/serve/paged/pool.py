"""Fixed-size KV block allocator: free list + per-block refcounts.

The pool is pure host-side bookkeeping — it never touches device memory.
Device block arrays are ``(L, num_blocks, ..., block_size, ...)``; one
physical block id indexes every layer at once, so "a block" here is one
integer and the engine translates pool decisions into batched device
updates (kv_pos invalidation on allocation, block copies on COW).

Ownership model:

  * refcount == number of logical owners (slot table entries + prefix
    index entries).  ``alloc`` hands out refcount-1 blocks; ``fork``
    adds an owner (prefix sharing); ``release`` drops one and returns
    the block to the free list at zero.
  * block 0 is the *null block*: unallocated block-table entries map to
    it on device so gathers stay in bounds.  It is never allocated,
    forked or released — its ``kv_pos`` stays -1 forever.
  * copy-on-write is a two-step owned by the engine: ``cow`` re-homes
    one owner of a shared block onto a fresh block and reports the
    (src, dst) pair; the engine then issues the device copy.  A block
    with refcount > 1 is never written in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Reserved null block id (device alias for "unallocated").
NULL_BLOCK = 0


class BlockPool:
    """Allocator over ``num_blocks`` fixed-size KV blocks (id 0 reserved)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved null "
                             f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are re-used first, which
        # keeps the working set of touched blocks small
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: List[int] = [0] * num_blocks
        self._ref[NULL_BLOCK] = 1     # permanently owned by the pool
        self.allocs = 0
        self.frees = 0
        self.cow_copies = 0

    # -- primitives ----------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """A fresh block with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        b = self._free.pop()
        assert self._ref[b] == 0, f"free-list block {b} had refcount {self._ref[b]}"
        self._ref[b] = 1
        self.allocs += 1
        return b

    def fork(self, block: int) -> int:
        """Add an owner to a live block (prefix sharing)."""
        self._check_live(block)
        self._ref[block] += 1
        return block

    def release(self, block: int) -> bool:
        """Drop one owner; True if the block returned to the free list."""
        self._check_live(block)
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            self.frees += 1
            return True
        return False

    def cow(self, block: int) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Resolve exclusive ownership of ``block`` before a write.

        refcount == 1: already exclusive — returns (block, None).
        refcount > 1: re-homes this owner onto a fresh block, returns
        (dst, (src, dst)) so the engine can issue the device copy.
        Raises RuntimeError when the pool is exhausted (the engine runs
        prefix-index eviction and retries before letting that escape).
        """
        self._check_live(block)
        if self._ref[block] == 1:
            return block, None
        dst = self.alloc()
        if dst is None:
            raise RuntimeError("BlockPool exhausted during copy-on-write")
        self._ref[block] -= 1     # this owner moves to dst
        self.cow_copies += 1
        return dst, (block, dst)

    def _check_live(self, block: int) -> None:
        if not (0 < block < self.num_blocks):
            raise ValueError(f"invalid block id {block} "
                             f"(null block 0 is never owned)")
        if self._ref[block] <= 0:
            raise ValueError(f"block {block} is not allocated")

    # -- introspection -------------------------------------------------------
    def refcount(self, block: int) -> int:
        return self._ref[block]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        """Allocated blocks, excluding the reserved null block."""
        return (self.num_blocks - 1) - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.live_blocks / max(self.num_blocks - 1, 1)

    def stats(self) -> Dict[str, float]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "live_blocks": self.live_blocks,
            "free_blocks": self.free_blocks,
            "occupancy": round(self.occupancy, 4),
            "allocs": self.allocs,
            "frees": self.frees,
            "cow_copies": self.cow_copies,
        }
