"""Per-slot cache operations + block-paged KV-cache pool — PyTorch port of
``repro.serving.kvcache``.

Two layers:

:class:`SlotCacheOps` — family-generic *monolithic* slot operations,
driven by the model's ``cache_axes``: the ``"cache_batch"`` logical axis
marks the slot dimension of every cache leaf.  The runtime uses them to
freeze non-participating slots around a prefill call (a per-slot select)
and to reset a slot at admission.

:class:`PagedKV` — a block-paged pool replacing the monolithic
``(layers, slots, max_len, ...)`` buffers.  Which leaves page is a
**per-family state descriptor** (:data:`STATE_DESCRIPTORS`): every cache
leaf is either

``paged``
    a sequence-indexed buffer ``(*lead, slot, seq, *tail)`` — the
    attention K/V stacks (dense/moe/vlm/hybrid), the MLA latent rows, the
    encdec decoder K/V.  These live in the pool: ``n_blocks`` blocks of
    ``block`` positions per leaf, with a host-side block table per slot,
    blocks allocated on demand as the sequence grows.

``state``
    a constant-size per-slot row with NO sequence axis — the mamba2
    conv/ssm states, the recurrentgemma conv/lru states, and the
    admission-time context caches (encdec/vlm cross K/V, read-only during
    decode).  They stay resident ``(*lead, slots, *tail)``, reset from the
    single-slot template at admission and merged per active slot after
    each step (a mid-prefill neighbour's recurrent state must never take
    a decode step's rows).

Blocks are reference-counted; every write path goes through
:meth:`PagedKV.cow_for_write` first, so a block shared by several tables
(the prefix cache of a later slice aliases them) is copied to a private
block before a write lands.

The decode step consumes a contiguous ``(…, slot, seq, …)`` view:
:meth:`PagedKV.gather` materializes it from the pool on the device (one
``index_select`` a paged leaf through the device block tables), the
model runs unchanged, and :meth:`PagedKV.scatter_rows` writes back the one
row per active slot the step appended; inactive slots write to a trash
block (id ``n_blocks``, never allocated).  Unallocated table entries
point at block 0, and a freed block keeps its old rows, so a gathered view
holds other sequences' rows beyond a slot's written length.  Attention
masks them, but an emulated contraction splits its B operand by column
maxima over the whole key axis, so ``gather(..., lengths=...)`` zeroes the
rows at or past each slot's written length: the view is then the
monolithic cache's, whose unwritten rows are the template's zeros, and a
paged step computes what a monolithic one computes, bit for bit.

All pool and state operations run on the device, in place, with no host
synchronization; the host-side tables go to the device once a step
(:meth:`PagedKV.device_tables`).  The reference's gather and scatter are
``jnp.take`` / ``.at[].set`` outside any Pallas kernel; these are their
PyTorch indexing counterparts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["SlotCacheOps", "PagedKV", "STATE_DESCRIPTORS",
           "state_descriptor"]


# -- per-family state descriptor --------------------------------------------
#
# Leaf name -> kind for every serving family, as in the reference.  A family
# absent here (or a cache leaf absent from its entry) cannot serve paged —
# ``PagedKV.supported`` says so instead of mis-paging it.

STATE_DESCRIPTORS: Dict[str, Dict[str, str]] = {
    "dense":   {"k": "paged", "v": "paged"},
    "moe":     {"k": "paged", "v": "paged"},
    "mla_moe": {"latent": "paged", "k_rope": "paged"},
    "vlm":     {"k": "paged", "v": "paged",
                "cross_k": "state", "cross_v": "state"},
    "encdec":  {"k": "paged", "v": "paged",
                "cross_k": "state", "cross_v": "state"},
    "ssm":     {"conv": "state", "ssm": "state"},
    "hybrid":  {"k": "paged", "v": "paged",
                "conv": "state", "lru": "state",
                "tail_conv": "state", "tail_lru": "state"},
}


def state_descriptor(cfg) -> Dict[str, str]:
    """The family's leaf-name -> {"paged", "state"} map (KeyError for a
    family without one — then only the monolithic cache serves it)."""
    return STATE_DESCRIPTORS[cfg.family]


def _slot_axes(model, cfg) -> Dict[str, int]:
    """{leaf: slot axis}, from each leaf's logical axes (never its rank:
    the vlm's self K/V sit at axis 2, its cross K/V at 1)."""
    return {name: ax.index("cache_batch")
            for name, ax in model.cache_axes(cfg).items()}


class SlotCacheOps:
    """Per-slot select / reset on a monolithic cache dict."""

    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model
        self._slot_axis = _slot_axes(model, cfg)

    def select_slots(self, new_cache, old_cache, mask: torch.Tensor):
        """Leaves of ``new_cache`` where ``mask`` (slots,) is set, along
        each leaf's slot axis; ``old_cache`` elsewhere."""
        out = {}
        for name, new in new_cache.items():
            shape = [1] * new.ndim
            shape[self._slot_axis[name]] = mask.shape[0]
            out[name] = torch.where(mask.reshape(shape), new,
                                    old_cache[name])
        return out

    def reset_slot(self, cache, slot_idx: int, template):
        """Write a freshly initialized single-slot cache (``template``,
        from ``init_cache(cfg, 1, ...)``) into slot ``slot_idx``, in
        place."""
        for name, leaf in cache.items():
            ax = self._slot_axis[name]
            leaf.select(ax, slot_idx).copy_(template[name].select(ax, 0))
        return cache


class PagedKV:
    """Block-paged pool + host-side block tables (see module docstring).

    ``paged`` leaves (all sharing one sequence length) live in the pool,
    ``state`` leaves stay resident per slot.  The paged leaves' shapes and
    dtypes come from a shape-only ``init_cache`` on the ``meta`` device
    (the monolithic cache is never built); the state leaves are tiled from
    ``template``, the concrete single-slot cache the runtime resets a slot
    from (required when the family has state leaves; for the context
    families it carries the projected cross K/V).
    """

    def __init__(self, cfg, model, n_slots: int, max_len: int,
                 block: int = 16, n_blocks: Optional[int] = None,
                 template=None, device=None):
        self.cfg, self.model = cfg, model
        self.n_slots = n_slots
        self.device = resolve_device(device)
        desc = state_descriptor(cfg)
        shapes = model.init_cache(cfg, n_slots, max_len, device="meta")
        unknown = sorted(set(shapes) - set(desc))
        if unknown:
            raise ValueError(f"cache leaves {unknown} missing from the "
                             f"{cfg.family!r} state descriptor")
        self._slot_ax = _slot_axes(model, cfg)
        self.kinds = {name: desc[name] for name in shapes}
        self.paged_names = sorted(n for n, k in self.kinds.items()
                                  if k == "paged")
        self.state_names = sorted(n for n, k in self.kinds.items()
                                  if k == "state")
        seqs = {shapes[n].shape[self._slot_ax[n] + 1]
                for n in self.paged_names}
        if len(seqs) > 1:
            raise ValueError(f"paged KV needs one shared sequence length "
                             f"across paged leaves, got {sorted(seqs)}")
        self.seq_len = seqs.pop() if seqs else 0
        if self.seq_len % block != 0:
            raise ValueError(f"block={block} must divide the cache length "
                             f"{self.seq_len}")
        self.block = block
        self.blocks_per_slot = self.seq_len // block
        if n_blocks is None:
            n_blocks = n_slots * self.blocks_per_slot
        if not self.paged_names:
            n_blocks = 0          # pure-state family: nothing to page
        self.n_blocks = n_blocks
        # host-side tables: unallocated entries point at block 0; the
        # trash block id is n_blocks
        self.tables = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self.allocated = np.zeros((n_slots,), np.int32)    # blocks per slot
        self.free_blocks: List[int] = list(range(n_blocks - 1, -1, -1))
        # per-block reference counts: >1 means the block is aliased and
        # must copy-on-write
        self.refcount = np.zeros((max(n_blocks, 1),), np.int32)
        self.cow_copies = 0
        self.pool: Dict[str, torch.Tensor] = {}
        for name in self.paged_names:
            leaf, ax = shapes[name], self._slot_ax[name]
            lead, tail = leaf.shape[:ax], leaf.shape[ax + 2:]
            self.pool[name] = torch.zeros(
                lead + (self.n_blocks + 1, self.block) + tail,
                dtype=leaf.dtype, device=self.device)
        self.state: Dict[str, torch.Tensor] = {}
        self.state_template: Dict[str, torch.Tensor] = {}
        if self.state_names:
            if template is None:
                raise ValueError(f"family {cfg.family!r} has state leaves "
                                 f"{self.state_names}; PagedKV needs the "
                                 f"single-slot template")
            for name in self.state_names:
                t = template[name]
                reps = [1] * t.ndim
                reps[self._slot_ax[name]] = n_slots
                self.state_template[name] = t
                self.state[name] = t.repeat(reps)

    # -- support probe ---------------------------------------------------

    @staticmethod
    def supported(cfg, model, max_len: int) -> bool:
        """Whether this (family, max_len) pair can serve paged: a state
        descriptor covering every cache leaf, and one shared sequence
        length across the paged leaves (a shape-only ``init_cache``; the
        context families' cross K/V are state leaves, whose shapes do not
        matter here)."""
        desc = STATE_DESCRIPTORS.get(cfg.family)
        if desc is None:
            return False
        cache = model.init_cache(cfg, 1, max_len, device="meta")
        if set(cache) - set(desc):
            return False
        axes = _slot_axes(model, cfg)
        seqs = set()
        for name, leaf in cache.items():
            if desc[name] != "paged":
                continue
            if leaf.ndim < axes[name] + 2:
                return False
            seqs.add(leaf.shape[axes[name] + 1])
        return len(seqs) <= 1

    # -- device ops ------------------------------------------------------

    def device_tables(self) -> torch.Tensor:
        """The host block tables on the device (once a step)."""
        return torch.from_numpy(self.tables.astype(np.int64)).to(
            self.device)

    def gather(self, tables: torch.Tensor, lengths=None):
        """The full contiguous cache dict the model's decode step consumes:
        each paged leaf read through the (S, bps) device ``tables``, the
        state leaves as they are.  ``lengths`` (S,) on the device: the rows
        each slot has written; rows at or past it (within the ring: none
        once ``lengths >= seq_len``) are zeroed, as the monolithic cache
        holds them."""
        out = dict(self.state)
        if self.paged_names:
            flat = tables.reshape(-1)
            valid = None
            if lengths is not None:
                valid = torch.arange(self.seq_len, device=tables.device
                                     )[None, :] < lengths[:, None]
        for name in self.paged_names:
            pleaf, ax = self.pool[name], self._slot_ax[name]
            lead, tail = pleaf.shape[:ax], pleaf.shape[ax + 2:]
            view = pleaf.index_select(ax, flat).reshape(
                lead + (self.n_slots, self.seq_len) + tail)
            if valid is not None:
                view.masked_fill_(~valid.reshape(
                    (1,) * ax + valid.shape + (1,) * len(tail)), 0)
            out[name] = view
        return out

    def scatter_rows(self, tables: torch.Tensor, cache, cur_len: torch.Tensor,
                     active: torch.Tensor):
        """Write back what one decode step changed, in place: the one
        appended row per active slot for paged leaves (position ``(cur_len
        - 1) mod seq``, the monolithic ``cache_update_row`` arithmetic;
        inactive slots go to the trash block), and a per-active-slot merge
        for state leaves (inactive and mid-prefill slots keep theirs)."""
        if self.paged_names:
            pos = ((cur_len.to(torch.int64) - 1) % self.seq_len)
            off = pos % self.block
            blk = tables.gather(1, (pos // self.block)[:, None])[:, 0]
            blk = torch.where(active, blk, self.n_blocks)
            slots = torch.arange(self.n_slots, device=pos.device)
            for name in self.paged_names:
                pleaf, ax = self.pool[name], self._slot_ax[name]
                sl = (slice(None),) * ax
                rows = cache[name][sl + (slots, pos)]
                pleaf[sl + (blk, off)] = rows.to(pleaf.dtype)
        self._merge_state(cache, active)

    def _merge_state(self, cache, mask: torch.Tensor):
        """State leaves: ``cache``'s where ``mask`` is set, the resident
        ones elsewhere.  ``torch.where`` promotes as the monolithic
        runtime's per-slot select does, so a leaf a step widens (the
        hybrid's conv windows under f32 activations) keeps the step's
        dtype; a leaf the step did not touch (the cross K/V) is kept as
        is."""
        for name in self.state_names:
            new, old = cache[name], self.state[name]
            if new is old:
                continue
            shape = [1] * new.ndim
            shape[self._slot_ax[name]] = self.n_slots
            self.state[name] = torch.where(mask.reshape(shape), new, old)

    def _copy_block(self, src: int, dst: int):
        """Device copy of one pool block (the copy-on-write body)."""
        for name in self.paged_names:
            pleaf, ax = self.pool[name], self._slot_ax[name]
            pleaf.select(ax, dst).copy_(pleaf.select(ax, src))

    def write_slot_prefix(self, slot: int, cache, length: int,
                          start: int = 0):
        """Persist positions [start, length) of ``slot`` from a contiguous
        cache view into the slot's allocated blocks (prefill / chunk
        write-back), whole blocks from ``start``'s.  ``start`` skips blocks
        already persisted by earlier chunks (and never rewrites aliased
        prefix blocks below it)."""
        if not self.paged_names:
            return
        length = min(length, self.seq_len)
        start = min(start, length)
        b0 = start // self.block
        nb_used = -(-length // self.block)
        n_span = nb_used - b0
        if n_span <= 0:
            return
        assert nb_used <= int(self.allocated[slot]), (nb_used,
                                                      self.allocated[slot])
        if not self.cow_for_write(slot, range(b0, nb_used)):
            raise RuntimeError("pool exhausted during copy-on-write "
                               "span write")   # caller sized the pool
        ids = torch.from_numpy(self.tables[slot, b0:nb_used].astype(
            np.int64)).to(self.device)
        for name in self.paged_names:
            pleaf, ax = self.pool[name], self._slot_ax[name]
            cleaf = cache[name]
            lead, tail = cleaf.shape[:ax], cleaf.shape[ax + 2:]
            span = cleaf.select(ax, slot).narrow(ax, b0 * self.block,
                                                 n_span * self.block)
            pleaf.index_copy_(ax, ids, span.reshape(
                lead + (n_span, self.block) + tail).to(pleaf.dtype))

    # -- host-side block management --------------------------------------

    def ensure(self, slot: int, length: int) -> bool:
        """Allocate blocks so positions [0, length) are writable; False
        when the pool is exhausted (caller evicts and retries)."""
        if not self.paged_names:
            return True           # pure-state family: nothing to allocate
        need = -(-min(length, self.seq_len) // self.block)
        if need > self.blocks_per_slot:
            raise ValueError(f"sequence length {length} exceeds the slot "
                             f"capacity {self.seq_len}")
        if need > self.n_blocks:
            # evicting every other slot could never free enough
            raise ValueError(f"sequence length {length} needs {need} "
                             f"blocks but the pool holds only "
                             f"{self.n_blocks}; raise page_blocks")
        while self.allocated[slot] < need:
            if not self.free_blocks:
                return False
            b = self.free_blocks.pop()
            self.tables[slot, self.allocated[slot]] = b
            self.allocated[slot] += 1
            self.refcount[b] = 1
        return True

    def free_slot(self, slot: int):
        n = int(self.allocated[slot])
        self._release(int(b) for b in self.tables[slot, :n])
        self.tables[slot, :] = 0
        self.allocated[slot] = 0

    def _release(self, blocks):
        for b in blocks:
            self.refcount[b] -= 1
            assert self.refcount[b] >= 0, f"refcount underflow on block {b}"
            if self.refcount[b] == 0:
                self.free_blocks.append(b)

    # -- block sharing (the prefix cache's aliasing) ---------------------

    def adopt_blocks(self, slot: int, blocks: Sequence[int]):
        """Alias shared blocks into the FRONT of an empty slot's table."""
        assert int(self.allocated[slot]) == 0, "adopt into a used slot"
        for j, b in enumerate(blocks):
            self.tables[slot, j] = int(b)
            self.refcount[int(b)] += 1
        self.allocated[slot] = len(blocks)

    def share_blocks(self, slot: int, n_blocks: int) -> List[int]:
        """Take shared references on the slot's first ``n_blocks``
        blocks; the caller owns them and must release_blocks() them."""
        assert n_blocks <= int(self.allocated[slot])
        blocks = [int(b) for b in self.tables[slot, :n_blocks]]
        for b in blocks:
            self.refcount[b] += 1
        return blocks

    def release_blocks(self, blocks: Sequence[int]):
        """Drop shared references taken by share_blocks/adopt_blocks."""
        self._release(int(b) for b in blocks)

    def cow_for_write(self, slot: int, block_idxs) -> bool:
        """Copy-on-write: before writing through the given table indices
        of ``slot``, replace any SHARED physical block (refcount > 1) with
        a private copy.  False when the pool has no free block for the
        copy (caller frees/evicts and retries)."""
        for j in sorted({int(i) for i in block_idxs}):
            b = int(self.tables[slot, j])
            if self.refcount[b] <= 1:
                continue
            if not self.free_blocks:
                return False
            nb = self.free_blocks.pop()
            self._copy_block(b, nb)
            self.refcount[b] -= 1
            self.refcount[nb] = 1
            self.tables[slot, j] = nb
            self.cow_copies += 1
        return True

    @property
    def free_block_count(self) -> int:
        return len(self.free_blocks)

    @property
    def live_blocks(self) -> int:
        """Blocks holding at least one reference (live + free ==
        n_blocks always)."""
        return int((self.refcount[:self.n_blocks] > 0).sum())

    # -- state leaves ----------------------------------------------------

    def set_state_from(self, cache, mask: torch.Tensor):
        """Adopt the state leaves of a cache view where ``mask`` (slots,)
        is set (the prefill write-back for the non-paged leaves)."""
        self._merge_state(cache, mask)

    def reset_state_slot(self, slot: int):
        """Admission-time state reset from the single-slot template (the
        paged counterpart of SlotCacheOps.reset_slot; paged leaves need
        no reset — the gather zeroes rows not yet written)."""
        for name in self.state_names:
            ax = self._slot_ax[name]
            self.state[name].select(ax, slot).copy_(
                self.state_template[name].select(ax, 0))

    def snapshot_state(self, slot: int) -> Dict[str, torch.Tensor]:
        """Single-slot copy of the state leaves."""
        return {name: self.state[name].narrow(
                    self._slot_ax[name], slot, 1).clone()
                for name in self.state_names}

    def restore_state(self, slot: int, snap: Dict[str, torch.Tensor]):
        for name in self.state_names:
            ax = self._slot_ax[name]
            self.state[name].select(ax, slot).copy_(snap[name].select(ax, 0))
