"""PagedLMEngine: the continuous-batching LM engine over a paged KV
cache — fixed-size blocks, copy-on-write, and prefix sharing.

The engine subclasses :class:`~repro_torch.serve.engine.LMEngine` and
swaps only the cache/step layer: scheduling, chunked prefill, sampling
and accounting are inherited unchanged, so the paged path is the dense
path plus a block indirection.  Bit-identity is by construction — the
paged steps (:func:`~repro_torch.models.lm.lm_paged_decode_step` /
``lm_paged_prefill_chunk``) gather each layer's dense view out of the
block arrays in the dense cache's layout, run the *exact* dense
attention step on it, and scatter the written rows back.

Host-side protocol per tick (before the device step):

  1. map the ring rows this tick will write to logical blocks;
  2. allocate table entries still unbacked (queueing a ``kv_pos = -1``
     invalidation for the fresh block — its rows may be stale);
  3. copy-on-write any mapped block with refcount > 1 (prefix-shared or
     ring-wrapped), queueing one batched device copy;
  4. flush the queued invalidations/copies as one indexed update per
     array, refresh the device block table if the mapping changed.

Prefix sharing: at admission the prompt is walked through the
:class:`~repro_torch.serve.paged.prefix.PrefixIndex`; every matched full
block is mapped (refcount++) and its tokens are *skipped* from prefill —
the slot starts at ``hits * block_size``.  At prefill completion the
prompt's full blocks are registered for future requests.  Restricted to
pure-attention, non-MoE archs: SSD recurrent state cannot be skipped
into, and MoE expert routing is batch-composition-dependent.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.lm import init_paged_cache, lm_paged_decode_step, lm_paged_prefill_chunk
from repro_torch.obs import trace as obs_trace
from repro_torch.precision import FULL, PrecisionPolicy

from ..engine import LMEngine, Request
from .pool import BlockPool
from .prefix import PrefixIndex


class PagedLMEngine(LMEngine):
    """``LMEngine`` over ``num_blocks`` KV blocks of ``block_size`` rows
    (default: full backing for every slot, one table's worth of spare
    blocks for prefix survivors, and the null block).  ``prefix_sharing``
    maps cached prompt blocks into new requests.  Pure-SSD archs have no
    KV rows to page and run the dense path (``stats()["paged"]`` says so).
    """

    kind = "lm_paged"

    def __init__(
        self,
        params,
        cfg: LMArchConfig,
        n_slots: int = 4,
        max_len: int = 512,
        policy: PrecisionPolicy = FULL,
        scheduler: str = "fcfs",
        prefill_chunk: Optional[int] = None,
        seed: int = 0,
        telemetry: bool = False,
        record_logits: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefix_sharing: bool = True,
        mesh=None,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise ValueError(
                "PagedLMEngine is single-host (block tables are host "
                "state); use the dense LMEngine for mesh serving")
        self.block_size = block_size
        self._num_blocks_arg = num_blocks
        self._prefix_sharing = prefix_sharing
        # pure-SSD archs have no KV rows to page: the engine degrades to
        # the dense path (pool/prefix stay None, stats say so)
        self._paged = cfg.mixer in ("attn", "hymba")
        self.pool: Optional[BlockPool] = None
        self.prefix: Optional[PrefixIndex] = None
        self._prefix_ok = False
        self._pending_resets: List[int] = []
        self._pending_copies: List[Tuple[int, int]] = []
        self._peak_live_blocks = 0
        super().__init__(
            params, cfg, n_slots=n_slots, max_len=max_len, policy=policy,
            mesh=None, scheduler=scheduler, prefill_chunk=prefill_chunk,
            seed=seed, telemetry=telemetry, record_logits=record_logits, device=device)

    # -- build hooks -----------------------------------------------------------
    def _build_cache(self):
        if not self._paged:
            return super()._build_cache()
        W, bs = self._kv_len, self.block_size
        if W % bs:
            raise ValueError(
                f"block_size {bs} must divide the cache width {W} "
                f"(max_len, or the SWA window for ring caches)")
        self._nbt = W // bs
        num_blocks = (self._num_blocks_arg
                      or self.n_slots * self._nbt + self._nbt + 1)
        self.pool = BlockPool(num_blocks, bs)
        self.prefix = PrefixIndex(self.pool) if self._prefix_sharing else None
        self._prefix_ok = (self._prefix_sharing and self.cfg.mixer == "attn"
                           and not self.cfg.moe_experts)
        # host block table: -1 = unbacked (the device table reads the null block)
        self._bt = np.full((self.n_slots, self._nbt), -1, np.int64)
        self._bt_dev = None
        self._bt_dirty = True
        # the view the dense step reads must have the dense cache's dtype:
        # serve/paged/kv_blocks follows serve/kv_cache in every rule set
        return init_paged_cache(
            self.cfg, self.n_slots, num_blocks, bs, self.max_len,
            dtype=self.policy.at("serve/paged/kv_blocks").compute_dtype, device=self.device)

    def _build_steps(self):
        if not self._paged:
            return super()._build_steps()
        params, cfg, policy = self.params, self.cfg, self.policy
        self._decode = lambda c, bt, act, t: lm_paged_decode_step(params, c, bt, act, t, cfg,
                                                                  policy)
        self._chunk = lambda c, bt, t, n: lm_paged_prefill_chunk(params, c, bt, t, n, cfg,
                                                                 policy)

    # -- block bookkeeping -----------------------------------------------------
    def _alloc_block(self) -> int:
        """A fresh exclusively-owned block, evicting LRU prefix entries
        under pool pressure.  Fresh blocks may hold a previous owner's
        rows, so their kv_pos is queued for invalidation."""
        b = self.pool.alloc()
        if b is None and self.prefix is not None:
            self.prefix.evict_until(1)
            obs_trace.event("serve/paged/evict", category="paged", tick=self._ticks)
            b = self.pool.alloc()
        if b is None:
            raise RuntimeError(
                f"KV block pool exhausted ({self.pool.num_blocks} blocks, "
                f"{len(self.prefix) if self.prefix else 0} prefix entries) "
                f"— raise num_blocks or lower n_slots/max_len")
        self._pending_resets.append(b)
        return b

    def _exclusive(self, block: int) -> int:
        """Copy-on-write: resolve exclusive ownership of ``block`` before
        this tick's write lands in it."""
        if self.pool.refcount(block) == 1:
            return block
        if self.pool.free_blocks == 0 and self.prefix is not None:
            self.prefix.evict_until(1)
            obs_trace.event("serve/paged/evict", category="paged", tick=self._ticks)
        dst, copy = self.pool.cow(block)
        if copy is not None:
            self._pending_copies.append(copy)
            obs_trace.event("serve/paged/cow", category="paged",
                            src=copy[0], dst=copy[1], tick=self._ticks)
        return dst

    def _prepare_writes(self, slot_rows: List[Tuple[int, List[int]]]):
        """Back every ring row written this tick with an exclusively
        owned block, then flush the queued device updates."""
        for i, rows in slot_rows:
            for j in sorted({r // self.block_size for r in rows}):
                b = int(self._bt[i, j])
                if b <= 0:
                    self._bt[i, j] = self._alloc_block()
                    self._bt_dirty = True
                else:
                    nb = self._exclusive(b)
                    if nb != b:
                        self._bt[i, j] = nb
                        self._bt_dirty = True
        self._flush_block_updates()
        self._peak_live_blocks = max(self._peak_live_blocks, self.pool.live_blocks)

    @torch.inference_mode()
    def _flush_block_updates(self):
        """One batched indexed update per cache array for all of this
        tick's COW copies and fresh-block invalidations.  Destinations are
        fresh blocks, never sources."""
        if not (self._pending_copies or self._pending_resets):
            return
        c = self.cache
        if self._pending_copies:
            srcs = torch.tensor([s for s, _ in self._pending_copies], device=self.device)
            dsts = torch.tensor([d for _, d in self._pending_copies], device=self.device)
            for k in ("k", "v", "c_kv", "k_rope", "kv_pos"):
                if k in c:
                    c[k][:, dsts] = c[k][:, srcs]
            self._pending_copies = []
        if self._pending_resets:
            ids = torch.tensor(self._pending_resets, device=self.device)
            c["kv_pos"][:, ids] = -1
            self._pending_resets = []

    def _block_table_dev(self) -> torch.Tensor:
        """The device block table (unbacked entries read the null block):
        one host-to-device copy, and only when the mapping changed."""
        if self._bt_dirty or self._bt_dev is None:
            self._bt_dev = torch.from_numpy(np.maximum(self._bt, 0)).to(self.device)
            self._bt_dirty = False
        return self._bt_dev

    # -- engine hooks ----------------------------------------------------------
    def _admit_slot(self, i: int, req: Request) -> int:
        if not (self._paged and self._prefix_ok and self.prefix is not None):
            return 0
        # cap: a fully-cached prompt must still leave >= 1 token so the
        # first generation has logits to come from
        max_blocks = min((len(req.prompt) - 1) // self.block_size, self._nbt)
        if max_blocks <= 0:
            return 0
        hit = self.prefix.lookup(req.prompt, self.block_size, max_blocks, self._ticks)
        for j, b in enumerate(hit):
            self._bt[i, j] = b
        if hit:
            self._bt_dirty = True
            obs_trace.event("serve/paged/prefix_hit", category="paged",
                            uid=req.uid, blocks=len(hit),
                            tokens=len(hit) * self.block_size)
        return len(hit) * self.block_size

    @torch.inference_mode()
    def _reset_slots(self, admitted: List[Tuple[int, int]]):
        if not self._paged:
            return super()._reset_slots(admitted)
        # per-slot state only: block invalidation is per *block*, done at
        # allocation time (kv_pos here is block-indexed, not slot-indexed)
        ids = torch.tensor([i for i, _ in admitted], dtype=torch.long, device=self.device)
        starts = torch.tensor([s for _, s in admitted], dtype=torch.int32, device=self.device)
        c = self.cache
        c["step"][ids] = starts
        if "ssd_state" in c:
            c["ssd_state"][:, ids] = 0.0

    def _release_slot(self, i: int):
        if not self._paged:
            return
        for j in range(self._nbt):
            b = int(self._bt[i, j])
            if b > 0:
                self.pool.release(b)
        self._bt[i, :] = -1
        self._bt_dirty = True

    def _on_prefill_complete(self, i: int, req: Request):
        if not (self._paged and self._prefix_ok and self.prefix is not None):
            return
        P = len(req.prompt)
        # register only full blocks of prompts that never wrapped the
        # ring (wrapped blocks hold later positions than their index)
        if P < self.block_size or P > self._kv_len:
            return
        blocks = [int(self._bt[i, j]) for j in range(P // self.block_size)]
        if any(b <= 0 for b in blocks):
            return
        self.prefix.register(req.prompt, blocks, self.block_size, self._ticks)

    # -- device steps ----------------------------------------------------------
    def _run_decode(self, tokens: np.ndarray) -> np.ndarray:
        if not self._paged:
            return super()._run_decode(tokens)
        active = np.asarray([s is not None for s in self.slots])
        self._prepare_writes([(i, [self.slot_pos[i] % self._kv_len])
                              for i, s in enumerate(self.slots) if s is not None])
        # ``active`` stays on the host: the step finds its write rows there
        logits, self.cache = self._decode(self.cache, self._block_table_dev(),
                                          torch.from_numpy(active),
                                          torch.from_numpy(tokens).to(self.device))
        return logits.cpu().numpy()

    def _run_chunk(self, tokens: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        if not self._paged:
            return super()._run_chunk(tokens, n_valid)
        slot_rows = []
        for i, s in enumerate(self.slots):
            k = int(n_valid[i])
            if s is None or k == 0:
                continue
            slot_rows.append((i, [(self.slot_pos[i] + t) % self._kv_len for t in range(k)]))
        self._prepare_writes(slot_rows)
        logits, self.cache = self._chunk(self.cache, self._block_table_dev(),
                                         torch.from_numpy(tokens).to(self.device),
                                         torch.from_numpy(n_valid))
        return logits.cpu().numpy()

    # -- stats -----------------------------------------------------------------
    def _fragmentation(self) -> float:
        """Internal fragmentation: unused rows inside slot-mapped blocks
        as a fraction of their capacity (paged blocks never fragment
        externally — any free block serves any request)."""
        slot_blocks = int((self._bt > 0).sum())
        if not slot_blocks:
            return 0.0
        used = sum(min(self.slot_pos[i], self._kv_len)
                   for i, s in enumerate(self.slots) if s is not None)
        return max(0.0, 1.0 - used / (slot_blocks * self.block_size))

    def _extra_stats(self) -> Dict[str, Any]:
        out = super()._extra_stats()
        if not self._paged:
            out["paged"] = {"active": False,
                            "reason": f"{self.cfg.mixer} arch has no KV rows"}
            return out
        paged = {
            "active": True,
            **self.pool.stats(),
            "blocks_per_slot": self._nbt,
            "peak_live_blocks": self._peak_live_blocks,
            "fragmentation": round(self._fragmentation(), 4),
            "prefix": self.prefix.stats() if self.prefix is not None else {"enabled": False},
        }
        out["paged"] = paged
        if self._telemetry_on:
            # pool gauges through the autoprec tap (no-op unless a
            # collector is in scope, like every other telemetry site)
            from repro_torch.autoprec.telemetry import tap

            tap("serve/paged/pool", torch.tensor(
                [self.pool.occupancy, paged["fragmentation"], float(self.pool.cow_copies)],
                dtype=torch.float32, device=self.device))
        return out

    def _reset_extra_counters(self) -> None:
        super()._reset_extra_counters()
        self._peak_live_blocks = self.pool.live_blocks if self.pool is not None else 0
