"""Search-space enumeration: legal tile candidates per kernel family.

The reference's interface (``Candidate``, ``candidates``,
``legal_blocks``) over the port's tunables: the launch parameters its
wrappers hand the kernels without a rebuild.

* ``spectral_fused`` (``fused_fwd`` / ``fused_bwd``): the batch tile of
  each direction, a power of two of at most min(8, B) rows (the kernels
  keep a mode's rows of a tile in registers) whose scratch between stages
  fits in half the L2 (``fused_fwd_scratch_bytes`` forward,
  ``fused_scratch_bytes`` backward, the budget ``pick_block_b`` leaves),
  with the slab within a block's shared memory (``fused_smem_bytes``).
* ``lshared`` (``ls_fwd`` / ``ls_bwd_x``): the splits of each ``ls_mix``
  launch, a power of two from 1 to the outputs a (degree, channel tile)
  holds, ``ls_splits_max`` = B·⌈M/128⌉.
* ``dense``, ``dense-fused`` and ``cp`` have no launch tile: their tiles
  are compile-time constants of ``csrc/`` (``dense_stream.cuh``,
  ``FwdTile``/``BwdTile``) and their grids come from the SM count, so
  ``candidates`` returns no point for them.

Forward and backward tiles are enumerated independently, then crossed:
the tuner times each (block_fwd, block_bwd) pair as one forward plus
backward, the unit the wrappers pin.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.spectral_contract import (
    L2_BUDGET,
    SMEM_LIMIT,
    fused_fwd_scratch_bytes,
    fused_scratch_bytes,
    fused_smem_bytes,
    ls_splits_max,
)

#: the batch tiles ``pick_block_b`` walks
BLOCKS_B = (8, 4, 2, 1)

#: the families whose kernels take a launch tile
TUNED = ("lshared", "spectral_fused")

#: the headroom ``pick_block_b`` leaves: half the L2
DEFAULT_BUDGET = L2_BUDGET // 2


def fused_axes(shape: Sequence[int]) -> Tuple[
        int, int, int, Tuple[int, ...], Tuple[int, ...]]:
    """Unpack a ``spectral_fused`` shape key ``(B, I, O, *spatial,
    *modes)`` — spatial and modes have equal length, so the split is
    unambiguous for any rank."""
    B, I, O = (int(s) for s in shape[:3])
    rest = shape[3:]
    d = len(rest) // 2
    if d < 1 or len(rest) != 2 * d:
        raise ValueError(f"malformed spectral_fused shape {tuple(shape)}")
    spatial = tuple(int(s) for s in rest[:d])
    modes = tuple(int(s) for s in rest[d:])
    return B, I, O, spatial, modes


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (family, shape, dtype, fwd/bwd tile) point of the search."""

    family: str            # lshared | spectral_fused (dense | dense-fused | cp: no tile)
    shape: Tuple[int, ...]  # dense: (B,I,O,M)  cp: (B,I,O,R,M)
                            # lshared: (B,I,O,L,Mm)
                            # spectral_fused: (B,I,O,*spatial,*modes)
    dtype: str             # storage dtype name, e.g. "bfloat16"
    block_fwd: int
    block_bwd: int


def family_itemsize(family: str, dtype: str) -> int:
    """Bytes/element the family's kernels stream: the storage dtype's —
    except the cast-fusing families (dense-fused, spectral_fused), which
    read f32 operands and round them on the way in."""
    if family in ("dense-fused", "spectral_fused"):
        return 4
    return getattr(torch, dtype).itemsize


def tile_scratch_bytes(family: str, shape: Sequence[int], block: int,
                       direction: str) -> int:
    """The L2 scratch one ``spectral_fused`` launch keeps between stages
    at batch tile ``block`` (``direction``: "fwd" | "bwd"); 0 for the
    other families, whose tiles take no scratch."""
    if family != "spectral_fused":
        return 0
    _B, I, O, spatial, modes = fused_axes(shape)
    fn = fused_fwd_scratch_bytes if direction == "fwd" else fused_scratch_bytes
    return fn(block, I, O, spatial, modes)


def legal_blocks(family: str, shape: Sequence[int], dtype: str,  # noqa: ARG001
                 direction: str, *,
                 budget: int = DEFAULT_BUDGET) -> List[int]:
    """Every tile the port's rule admits for this key and direction,
    largest first (the heuristics' own preference); empty for a family
    with no launch tile, or a fused shape whose slab does not fit a
    block's shared memory.  ``dtype`` keeps the reference's signature: the
    fused kernels stream f32 whatever the storage dtype, and the splits
    depend on no dtype."""
    if family == "spectral_fused":
        B, _I, _O, spatial, modes = fused_axes(shape)
        if fused_smem_bytes(spatial, modes) > SMEM_LIMIT:
            return []
        out = [b for b in BLOCKS_B if b <= max(min(8, B), 1)
               and tile_scratch_bytes(family, shape, b, direction) <= budget]
        return out or [1]  # ``pick_block_b``'s own last resort
    if family == "lshared":
        B, _I, _O, _L, M = (int(s) for s in shape)
        top = ls_splits_max(B, M)
        return [1 << k for k in range(top.bit_length() - 1, -1, -1)]
    if family in ("dense", "dense-fused", "cp"):
        return []
    raise ValueError(f"unknown kernel family {family!r}")


def candidates(family: str, shape: Sequence[int], dtype: str, *,
               budget: int = DEFAULT_BUDGET,
               limit: Optional[int] = None) -> List[Candidate]:
    """The (block_fwd × block_bwd) cross of legal tiles for one key; no
    point for a family with no launch tile.

    ``limit`` caps the cross for smoke runs: pairs are ordered
    largest-tile-first, so a truncated search still covers the region the
    heuristic lives in plus its neighbours.
    """
    fwd = legal_blocks(family, shape, dtype, "fwd", budget=budget)
    bwd = legal_blocks(family, shape, dtype, "bwd", budget=budget)
    pairs = list(itertools.product(fwd, bwd))
    if limit is not None:
        pairs = pairs[:max(1, int(limit))]
    return [
        Candidate(family=family, shape=tuple(int(s) for s in shape),
                  dtype=dtype, block_fwd=f, block_bwd=b)
        for f, b in pairs
    ]
