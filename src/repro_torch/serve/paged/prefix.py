"""Prefix index: a trie over full prompt blocks mapping shared prefixes
(and, for operator fields, content hashes) to live KV blocks.

Keys are exact *chain keys*: block j of a prompt is addressed by
``(key_{j-1}, tuple(tokens[j*bs:(j+1)*bs]))`` with a root sentinel at
j = -1.  Chain keys compare by value (no hashing collisions — dict
equality does the exact comparison), so a hit guarantees the cached
block was written by the byte-identical token prefix at the same
positions.

The index is itself a refcount holder: registering a block ``fork``s it
so the donor request finishing does not free it, and evicting an entry
``release``s it.  Eviction is LRU over *leaf* entries only — an interior
entry's children would become unreachable garbage if their parent left
the trie first.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pool import BlockPool

_ROOT = ("<root>",)


def content_key(x) -> str:
    """Content hash of an operator input field: exact bytes of the
    f32-normalised array plus its shape.  Two fields with equal keys are
    bitwise-identical inputs, so memoised outputs are bitwise-valid."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    h = hashlib.sha1(a.tobytes())
    h.update(str(a.shape).encode())
    return h.hexdigest()


@dataclasses.dataclass
class _Entry:
    block: int
    parent: Optional[Tuple]      # parent chain key (None for depth-0)
    children: int = 0
    last_used: int = 0


class PrefixIndex:
    """Trie over full prompt blocks -> physical KV block ids."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._entries: Dict[Tuple, _Entry] = {}
        self.hits = 0            # lookups that matched >= 1 block
        self.misses = 0
        self.tokens_reused = 0   # prefill tokens skipped via hits
        self.evictions = 0

    @staticmethod
    def _chain(tokens: Sequence[int], block_size: int) -> List[Tuple]:
        """Chain keys for every *full* block of ``tokens``."""
        keys: List[Tuple] = []
        parent: Tuple = _ROOT
        for j in range(len(tokens) // block_size):
            key = (parent, tuple(tokens[j * block_size:(j + 1) * block_size]))
            keys.append(key)
            parent = key
        return keys

    # -- lookup / register ---------------------------------------------------
    def lookup(self, tokens: Sequence[int], block_size: int,
               max_blocks: int, now: int) -> List[int]:
        """Longest cached prefix of ``tokens``: block ids, each ``fork``ed
        for the caller (the caller owns one ref per returned block).
        ``max_blocks`` caps the walk — the engine passes ``(P-1)//bs`` so
        a fully-cached prompt still leaves one token to produce the first
        generation logits."""
        out: List[int] = []
        for key in self._chain(tokens, block_size)[:max_blocks]:
            e = self._entries.get(key)
            if e is None:
                break
            e.last_used = now
            out.append(self.pool.fork(e.block))
        if out:
            self.hits += 1
            self.tokens_reused += len(out) * block_size
        else:
            self.misses += 1
        return out

    def register(self, tokens: Sequence[int], block_ids: Sequence[int],
                 block_size: int, now: int) -> int:
        """Register the full prompt blocks of ``tokens`` (whose physical
        blocks are ``block_ids[j]``) for reuse.  Blocks already indexed
        under the same chain key keep the incumbent (first writer wins —
        both hold bit-identical data).  Returns the number of newly
        indexed blocks, each ``fork``ed so the index owns one ref."""
        added = 0
        for j, key in enumerate(self._chain(tokens, block_size)):
            e = self._entries.get(key)
            if e is not None:
                e.last_used = now
                continue
            self._entries[key] = _Entry(
                block=self.pool.fork(block_ids[j]), parent=key[0]
                if key[0] is not _ROOT else None, last_used=now)
            if key[0] is not _ROOT:
                parent = self._entries.get(key[0])
                if parent is not None:
                    parent.children += 1
            added += 1
        return added

    # -- eviction ------------------------------------------------------------
    def evict_one(self) -> bool:
        """Release the least-recently-used *leaf* entry's block back to
        the pool (its owners elsewhere keep it alive).  False when the
        index is empty."""
        leaf_key, leaf = None, None
        for key, e in self._entries.items():
            if e.children == 0 and (leaf is None
                                    or e.last_used < leaf.last_used):
                leaf_key, leaf = key, e
        if leaf_key is None:
            return False
        del self._entries[leaf_key]
        if leaf.parent is not None:
            parent = self._entries.get(leaf.parent)
            if parent is not None:
                parent.children -= 1
        self.pool.release(leaf.block)
        self.evictions += 1
        return True

    def evict_until(self, pool_free: int) -> int:
        """Evict LRU leaves until the pool has ``pool_free`` free blocks
        (or the index empties).  Returns blocks actually freed."""
        freed = 0
        while self.pool.free_blocks < pool_free:
            before = self.pool.free_blocks
            if not self.evict_one():
                break
            freed += self.pool.free_blocks - before
        return freed

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
        }
