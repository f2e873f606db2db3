"""ServingRuntime — the continuous-batching inference loop — PyTorch port
of ``repro.serving.runtime`` (monolithic per-slot cache).

Ties together the scheduler (host policy), the per-slot cache, and the
presplit weight wrapping around two eager device steps:

* ``decode``: one token for every decode-ready slot, each at its OWN
  sequence position (the per-slot ``cur_len`` vector).  Free and
  mid-prefill slots carry ``cur == 0``, which makes their cache-row writes
  no-ops, so one step serves any occupancy pattern.
* ``chunk`` (per bucket length Lb): the decode step run over Lb positions,
  teacher-forcing a SLICE of each participating prompt RIGHT-ALIGNED in
  the bucket, resuming ``base`` tokens into the slot's cache.  With
  ``prefill_chunk=None`` the slice is the whole prompt; with a chunk size
  C each scheduler round feeds at most C prompt tokens per pending slot
  and then decodes the resident slots.  Splitting the loop is bitwise
  exact: each chunk resumes from exactly the cache the previous one
  wrote.  Slots not in the call are frozen by a per-slot select.  State
  families (ssm, hybrid) bucket by exact length: their recurrent states
  integrate every fed position, so a right-aligned slice padded at its
  front would be integrated too.  Under chunking their decode step also
  freezes the mid-prefill slots by a per-slot select (``_decode_select``):
  a neighbour's decode step must not integrate into a half-prefilled
  state (attention rows need no select: ``cur == 0`` writes nothing).

The weight split-cache: with an ozimmu engine, ``wrap_params`` freezes
every projection weight's int8 digit slices once, and every step consumes
the wrapped tree — B-side splitting drops out of the steps entirely,
bit-identical to the unwrapped path.

Both steps run inside ``plan.static_plan()``: an ``auto`` spec resolves
every contraction to the static plan, as the reference's jitted steps do
(its planner probes only concrete operands), and never syncs the host to
probe.

The context families (vlm, encdec) take ``ctx``, ONE slot's context
(the patch embeddings; the encoder output): the single-slot template's
cross K/V are projected from it once, and the slot cache's from ``ctx``
repeated across the slots, as the reference does.  The cross K/V are
never written by a step; ``reset_slot`` copies the template's into an
admitted slot with the other leaves.

With ``page_block`` the cache is a block-paged pool
(:class:`~repro_torch.serving.kvcache.PagedKV`) instead: every step
gathers the slots' contiguous view from the pool on the device (rows not
yet written zeroed, as the monolithic cache holds them), runs the same
decode step, and writes back the appended rows (decode) or the chunk's
span (prefill); state leaves merge per participating slot, so no decode
step needs ``_decode_select``.  Blocks are allocated as sequences grow;
when the pool runs dry the scheduler evicts the latest-admitted slot,
whose request re-prefills its prompt and generated tokens later.  A paged
run gives the monolithic runtime's tokens.  The prefix cache, which
aliases the pool's blocks, comes with a later slice of the port and
raises until then.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import plan
from repro_torch.core.engine import presplit_trace_counts
from repro_torch.models import api
from repro_torch.serving import presplit as presplit_mod
from repro_torch.serving.kvcache import (STATE_DESCRIPTORS, PagedKV,
                                         SlotCacheOps)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServingRuntime"]

_STATE_FAMILIES = ("ssm", "hybrid")


def _has_state_leaves(cfg) -> bool:
    desc = STATE_DESCRIPTORS.get(cfg.family)
    return desc is not None and "state" in desc.values()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingRuntime:
    """Continuous-batching server over one model + parameter set.

    Args (keyword-only after ``params``, as in the reference):
      cfg: ModelConfig (the engine spec rides inside it).
      params: model parameters (raw; moved to ``device`` and wrapped
        internally when presplit).
      slots: decode-slot count (the step's batch dimension).
      max_len: per-slot cache capacity (prompt + generation budget).
      prefill_chunk: max prompt tokens fed per slot per scheduler round;
        None prefills whole prompts in one call.
      presplit: freeze weight splits (default: on for ozimmu engines).
      now: clock (injectable for deterministic tests).
      ctx: static per-slot context of the vlm/encdec families, shaped
        for ONE slot (the runtime shares it across slots, as the
        reference does); moved to ``device``.
      device: where the model runs; default the CUDA card (raises when
        there is none — pass ``device="cpu"`` for the plain versions).
      page_block: positions per KV block — enables the paged pool
        (every family; pure-state families page nothing but gain the
        per-slot state machinery); None keeps the monolithic cache.
      page_blocks: pool size in blocks (default: full capacity,
        slots * max_len / page_block; fewer exercise eviction).
      prefix_cache: comes with the prefix-cache slice of the port; raises.
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128,
                 page_block: Optional[int] = None,
                 page_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache=False, presplit: Optional[bool] = None,
                 ctx=None, now=time.monotonic, device=None):
        if prefix_cache:
            raise NotImplementedError("the prefix cache comes with the "
                                      "prefix-cache slice of the port; use "
                                      "prefix_cache=False")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.device = resolve_device(device)
        self.cfg, self.model = cfg, api.get_model(cfg)
        self.n_slots, self.max_len = slots, max_len
        self.prefill_chunk = prefill_chunk
        engine = cfg.engine
        params = _to_device(params, self.device)
        self.split_cache = None
        self._wrapped_bytes = 0       # weight bytes whose split is frozen
        self._avoided_split_bytes = 0  # splitter input bytes skipped so far
        use_presplit = engine.is_ozimmu if presplit is None else presplit
        if use_presplit and engine.is_ozimmu:
            self.params, self.split_cache = presplit_mod.wrap_params(
                params, engine)
            self._wrapped_bytes = presplit_mod.wrapped_weight_bytes(
                self.params, engine)
        else:
            self.params = params
        self.sched = Scheduler(
            slots, bucket="exact" if cfg.family in _STATE_FAMILIES
            else "pow2")
        self.ops = SlotCacheOps(cfg, self.model)
        self.metrics = ServingMetrics(now=now)
        self._now = now
        ctx = None if ctx is None else ctx.to(self.device)
        # single-slot template: the admission reset source (monolithic
        # always; paged only for families with resident state leaves)
        self._template = None
        self.paged: Optional[PagedKV] = None
        self.cache = None
        with torch.no_grad():
            if page_block is None or _has_state_leaves(cfg):
                self._template = self.model.init_cache(
                    cfg, 1, max_len, params=self.params, ctx=ctx,
                    device=self.device)
            if page_block is not None:
                if not PagedKV.supported(cfg, self.model, max_len):
                    raise ValueError(
                        f"paged KV unsupported for family {cfg.family!r} "
                        f"(see repro_torch.serving.kvcache); use "
                        f"page_block=None")
                self.paged = PagedKV(cfg, self.model, slots, max_len,
                                     block=page_block, n_blocks=page_blocks,
                                     template=self._template,
                                     device=self.device)
            else:
                self.cache = self.model.init_cache(
                    cfg, slots, max_len, params=self.params,
                    ctx=None if ctx is None else torch.cat([ctx] * slots),
                    device=self.device)
        # under chunking, monolithic decode freezes mid-prefill slots'
        # recurrent states (the reference's rule; paged state leaves merge
        # per active slot instead)
        self._decode_select = (prefill_chunk is not None
                               and self.paged is None
                               and cfg.family in _STATE_FAMILIES)
        # host-side per-slot decode state
        self._cur = np.ones((slots,), np.int32)
        self._last_tok = np.zeros((slots,), np.int32)
        self._evictions_at_reset = 0
        self._presplit_counts0 = presplit_trace_counts()
        self._presplit_rate = None

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits[:, -1, :self.cfg.vocab],
                            dim=-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _decode(self, toks: np.ndarray, cur: np.ndarray,
                active: np.ndarray) -> np.ndarray:
        """One decode step.  Idle slots carry ``cur == 0`` (their attention
        rows are not written; their other leaves are reset at admission);
        with ``_decode_select`` only the ``active`` slots take the step's
        cache.  Paged: the step runs on the pool's gathered view, and
        writes back the appended rows and the active slots' state."""
        cur_d = self._tensor(cur)
        if self.paged is not None:
            tables = self.paged.device_tables()
            active_d = self._tensor(active)
            with plan.static_plan():
                logits, cache = self.model.decode_step(
                    self.params, self.cfg,
                    self.paged.gather(tables, lengths=cur_d - 1),
                    self._tensor(toks), cur_d)
            self.paged.scatter_rows(tables, cache, cur_d, active_d)
            return self._argmax(logits)
        with plan.static_plan():
            logits, cache = self.model.decode_step(
                self.params, self.cfg, self.cache, self._tensor(toks), cur_d)
        if self._decode_select:
            cache = self.ops.select_slots(cache, self.cache,
                                          self._tensor(active))
        self.cache = cache
        return self._argmax(logits)

    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, start: np.ndarray,
                 base: np.ndarray, newmask: np.ndarray) -> np.ndarray:
        """The decode step over the bucket; each participating slot's chunk
        is right-aligned and resumes ``base`` tokens in.  Paged: the
        participating slots' view is gathered once (the rows past ``base``
        zeroed), and each slot's span is written back after the loop."""
        Lb = toks.shape[1]
        # every position's (slots,) cur vector, copied to the device once
        curs = np.stack([np.where(newmask & (i >= start),
                                  base + i - start + 1, 0)
                         for i in range(Lb)]).astype(np.int32)
        toks_d, curs_d = self._tensor(toks), self._tensor(curs)
        mask_d = self._tensor(newmask)
        if self.paged is not None:
            before = self.paged.gather(
                self.paged.device_tables(),
                lengths=self._tensor(np.where(newmask, base, 0)))
        else:
            before = self.cache
        cache, logits = before, None
        with plan.static_plan():
            for i in range(Lb):
                logits, cache = self.model.decode_step(
                    self.params, self.cfg, cache, toks_d[:, i:i + 1],
                    curs_d[i])
        if self.paged is None:
            self.cache = self.ops.select_slots(cache, before, mask_d)
            return self._argmax(logits)
        for slot in np.flatnonzero(newmask):
            length, span_start = self._span_args(int(base[slot]),
                                                 Lb - int(start[slot]))
            self.paged.write_slot_prefix(int(slot), cache, length,
                                         start=span_start)
        self.paged.set_state_from(cache, mask_d)
        return self._argmax(logits)

    def _span_args(self, done: int, clen: int) -> Tuple[int, int]:
        """(length, start) for the pool write-back of a chunk that fed
        positions [done, done+clen): the straight span, or the whole ring
        when the chunk wrapped a windowed cache."""
        seq = self.paged.seq_len
        end = done + clen
        if done >= seq or end > seq:
            return seq, 0
        return end, done

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None,
               arrival: Optional[float] = None) -> Request:
        plen = len(prompt)
        if plen + max_new > self.max_len and not self.cfg.window:
            raise ValueError(f"prompt({plen}) + max_new({max_new}) exceeds "
                             f"max_len={self.max_len}")
        req = self.sched.submit(prompt, max_new, eos_id=eos_id,
                                arrival=self._now() if arrival is None
                                else arrival)
        self.metrics.requests_submitted += 1   # after validation
        return req

    def _pool_pressure(self, protect: int) -> bool:
        """Free pool blocks: the scheduler preempts its latest-admitted
        slot (``protect`` itself when no other is left).  False when
        ``protect`` was evicted."""
        t0 = self._now()
        try:
            victim = self.sched.pick_victim(protect=protect)
            if victim is None:
                victim = protect
            self.sched.evict(victim)
            self.paged.free_slot(victim)
            return victim != protect
        finally:
            self.metrics.observe_timing("eviction", self._now() - t0)

    def _alloc_or_evict(self, slot: int, length: int) -> bool:
        """Block allocation for positions [0, length) with eviction
        pressure; False when the requesting slot itself was evicted."""
        while not self.paged.ensure(slot, length):
            if not self._pool_pressure(slot):
                return False
        return True

    def _cow_or_evict(self, slot: int, block_idxs) -> bool:
        """Copy-on-write with eviction pressure (a copy needs one free
        block); False when the requesting slot itself was evicted."""
        block_idxs = list(block_idxs)
        copies0 = self.paged.cow_copies
        t0 = self._now()
        try:
            while not self.paged.cow_for_write(slot, block_idxs):
                if not self._pool_pressure(slot):
                    return False
            return True
        finally:
            if self.paged.cow_copies > copies0:
                self.metrics.observe_timing("cow_copy", self._now() - t0)

    def _writable(self, slot: int, length: int, blocks) -> bool:
        """Paged: allocate ``slot``'s blocks for positions [0, length) and
        privatize the table entries ``blocks`` the next write touches;
        False when the slot was evicted on the way."""
        return self._alloc_or_evict(slot, length) and \
            self._cow_or_evict(slot, blocks)

    def _finish(self, slot: int, req: Request, now: float):
        if self.paged is not None:
            self.paged.free_slot(slot)
        self.metrics.record_finish(req, now)

    def _plan_chunks(self) -> List[Tuple[int, Request, int]]:
        """One (slot, request, chunk_len) plan per pending-prefill slot."""
        plans = []
        for slot, req in self.sched.pending_prefill():
            total = len(req.prefill_tokens())
            clen = total - self.sched.slots[slot].prefilled
            if self.prefill_chunk is not None:
                clen = min(clen, self.prefill_chunk)
            plans.append((slot, req, clen))
        return plans

    def _do_prefill_round(self):
        """Feed ONE chunk into every pending-prefill slot (grouped by
        chunk-length bucket); final chunks produce the slot's first
        token."""
        plans = self._plan_chunks()
        for Lb, group in self.sched.chunk_groups(plans):
            if self.paged is not None:
                group = self._paged_ready(group)
                if not group:
                    continue
            toks = np.zeros((self.n_slots, Lb), np.int32)
            start = np.full((self.n_slots,), Lb, np.int32)
            base = np.zeros((self.n_slots,), np.int32)
            newmask = np.zeros((self.n_slots,), bool)
            for slot, req, clen in group:
                done = self.sched.slots[slot].prefilled
                pt = req.prefill_tokens()
                toks[slot, Lb - clen:] = pt[done:done + clen]
                start[slot] = Lb - clen
                base[slot] = done
                newmask[slot] = True
            t0 = self._now()
            nxt = self._prefill(toks, start, base, newmask)
            now = self._now()
            self.metrics.prefill_calls += 1
            self.metrics.observe_timing("prefill_call", now - t0)
            # every fed position consumes every frozen weight split
            self._avoided_split_bytes += Lb * self._wrapped_bytes
            for slot, req, clen in group:
                done = self.sched.slots[slot].prefilled
                total = len(req.prefill_tokens())
                self.metrics.prefill_tokens += clen
                if done + clen < total:
                    self.sched.on_chunk(slot, clen)
                    self.metrics.prefill_chunks += 1
                    continue
                self.metrics.tokens_generated += 1  # the first new token
                finished = self.sched.on_prefilled(slot, int(nxt[slot]), now)
                self._cur[slot] = self.sched.slots[slot].pos + 1 \
                    if not finished else 1
                self._last_tok[slot] = int(nxt[slot])
                if finished:
                    self._finish(slot, req, now)

    def _paged_ready(self, group):
        """The members of a chunk group whose blocks are allocated and
        privatized for the chunk's write-back span.  An allocation may
        evict members (this group's or a later one's): those are dropped."""
        ready = []
        for slot, req, clen in group:
            if self.sched.slots[slot].request is not req:
                continue    # evicted by an earlier allocation this round
            done = self.sched.slots[slot].prefilled
            blocks = ()
            if self.paged.paged_names:
                length, start = self._span_args(done, clen)
                blocks = range(start // self.paged.block,
                               -(-length // self.paged.block))
            if self._writable(slot, done + clen, blocks):
                ready.append((slot, req, clen))
        return [(s, r, c) for s, r, c in ready
                if self.sched.slots[s].request is r]

    def _do_decode(self):
        active_idx = self.sched.decode_slots()
        if self.paged is not None:
            # this step writes row cur - 1: the slot needs cur positions
            # allocated and the written block privatized
            survivors = []
            for slot in active_idx:
                if self.sched.slots[slot].request is None:
                    continue    # evicted by pressure from a peer
                cur = int(self._cur[slot])
                blocks = ()
                if self.paged.paged_names:
                    blocks = [(cur - 1) % self.paged.seq_len
                              // self.paged.block]
                if self._writable(slot, cur, blocks):
                    survivors.append(slot)
            active_idx = [s for s in survivors
                          if self.sched.slots[s].request is not None]
        if not active_idx:
            return
        active = np.zeros((self.n_slots,), bool)
        active[active_idx] = True
        # per-slot position of the token written this step; 0 for idle
        # slots = "write nothing" (cache_update_row no-op)
        cur = np.where(active, self._cur, 0).astype(np.int32)
        toks = self._last_tok[:, None].astype(np.int32)
        t0 = self._now()
        nxt = self._decode(toks, cur, active)
        now = self._now()
        self.metrics.decode_steps += 1
        self.metrics.observe_timing("decode_step", now - t0)
        self._avoided_split_bytes += self._wrapped_bytes
        for slot in active_idx:
            req = self.sched.slots[slot].request
            self.metrics.tokens_generated += 1
            if self.sched.on_token(slot, int(nxt[slot]), now):
                self._finish(slot, req, now)
            else:
                self._cur[slot] = self.sched.slots[slot].pos + 1
                self._last_tok[slot] = int(nxt[slot])

    def step(self) -> bool:
        """One scheduler round: admit new requests, feed one prefill chunk
        per pending slot, then decode one token for every fully-prefilled
        slot.  Returns False when idle."""
        if self.sched.all_done:
            return False
        self.metrics.start()
        self.metrics.sample_queue(self.sched.queue_depth)
        for slot, _ in self.sched.admit():
            if self.paged is not None:
                self.paged.reset_state_slot(slot)
            else:
                self.cache = self.ops.reset_slot(self.cache, slot,
                                                 self._template)
        self._do_prefill_round()
        self._do_decode()
        return True

    def run(self, max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Drive the loop until every submitted request finished (or
        ``max_steps`` rounds); returns the metrics summary."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.metrics.stop()
        self.metrics.evictions = self.sched.evictions - \
            self._evictions_at_reset
        if self.split_cache is not None:
            d = self.split_cache.stats.as_dict()
            # MEASURED hit rate from the engine's consumption counters:
            # the fraction of wrapped-weight contractions whose frozen
            # split actually applied
            counts = presplit_trace_counts()
            d_used = counts["used"] - self._presplit_counts0["used"]
            d_fb = counts["fallback"] - self._presplit_counts0["fallback"]
            if d_used + d_fb:
                self._presplit_rate = d_used / (d_used + d_fb)
            rate = self._presplit_rate
            if rate is None:
                rate = 0.0
            d.update({
                "frozen_weight_bytes": self._wrapped_bytes,
                "avoided_split_bytes": self._avoided_split_bytes,
                "weight_split_hit_rate": rate,
            })
            self.metrics.split_cache = d
        return self.metrics.summary()

    def reset_metrics(self):
        """Fresh metrics window; scheduler and caches are untouched."""
        self.metrics = ServingMetrics(now=self._now)
        self._avoided_split_bytes = 0
        self._evictions_at_reset = self.sched.evictions
        self._presplit_counts0 = presplit_trace_counts()

    def generate(self, prompts: List[np.ndarray], max_new: int,
                 eos_id: Optional[int] = None) -> List[np.ndarray]:
        """Submit a batch and run to completion; returns prompt+generated
        per request, in submission order."""
        reqs = [self.submit(p, max_new, eos_id=eos_id) for p in prompts]
        self.run()
        return [np.concatenate([r.prompt,
                                np.asarray(r.generated, np.int32)])
                for r in reqs]
