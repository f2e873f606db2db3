"""Prefix KV cache: frozen shared prefixes served by block aliasing —
PyTorch port of ``repro.serving.prefix_cache``.

The serving-level counterpart of the weight split-cache: the split-cache
amortizes weight splitting across requests, this module amortizes
prefill across requests that share a token prefix (the system-prompt
regime).

A publication freezes a slot's state after it consumed the first ``m``
prompt tokens (``m`` block-aligned, and at most ``len(prompt) - 1`` so a
hit still has at least one suffix token to feed: the final prefill
call's last-position logits are the first-token prediction):

* **paged leaves**: the slot's first ``m / block`` pool blocks are
  published by reference (:meth:`PagedKV.share_blocks`), not copied; the
  entry holds a reference count on each.  A later request whose prompt
  starts with the same ``m`` tokens adopts those block ids into its table
  (:meth:`PagedKV.adopt_blocks`): prefill for the aliased positions is a
  host-side table write.  The pool's copy-on-write keeps aliasing sound
  where a writer reaches a shared block (the ring of a windowed cache,
  whose first span after a hit rewrites the whole ring).
* **state leaves**: recurrent conv / ssm / lru rows have no per-position
  structure to alias, so the entry stores a single-slot snapshot taken at
  the ``m``-token boundary; a hit restores it.  The runtime forces a
  chunk boundary at ``m`` during the cold prefill so that this snapshot
  exists.

The key is ``(config name, family, engine spec, mesh key)`` + the prefix
length + the prefix's int32 bytes.  The engine spec keeps a deterministic
engine and its ``:prob`` twin from aliasing each other's blocks.

A hit gives the cold path's tokens bit for bit: the adopted blocks and
snapshot were written by the same chunk calls over the same tokens, and
the hit's first chunk gathers the view with the rows at or past ``m``
zeroed, as the cold path's chunk from ``m`` does.

Entries pin blocks only by reference count.  Under pool pressure the
runtime releases LRU entries before it preempts a live request;
``max_entries`` caps the table itself.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.split_cache import _mesh_key
from repro_torch.obs import registry as _obs
from repro_torch.serving.kvcache import PagedKV

__all__ = ["PrefixCache", "PrefixEntry", "PrefixStats", "config_key"]

def config_key(cfg) -> Tuple:
    """The non-token half of the prefix key: numerically distinct
    pipelines (det vs ``:prob``, other meshes) never alias each other's
    prefixes."""
    return (cfg.name, cfg.family, cfg.engine_spec, _mesh_key())


@dataclasses.dataclass
class PrefixEntry:
    """One frozen prefix: shared block references + state snapshot."""

    key: Tuple
    length: int                       # prefix tokens covered
    blocks: List[int]                 # shared references into the pool
    state: Dict[str, Any]             # single-slot state-leaf snapshot
    hits: int = 0


@dataclasses.dataclass
class PrefixStats:
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0               # prefill tokens served by aliasing
    inserted: int = 0
    evicted: int = 0                  # dropped (LRU cap or pool pressure)

    def as_dict(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "hit_tokens": self.hit_tokens,
            "inserted": self.inserted,
            "evicted": self.evicted,
        }


class PrefixCache:
    """LRU table of frozen prefixes over ONE :class:`PagedKV` pool.

    Bound to a pool because entries hold physical block ids.  The config
    half of the key is carried per entry, so a lookup under another
    config's key misses.
    """

    def __init__(self, paged: PagedKV, cfg, max_entries: int = 128):
        self.paged = paged
        self.block = paged.block
        self.key0 = config_key(cfg)
        self.max_entries = max_entries
        # LRU order: front = coldest, popped first
        self.entries: "OrderedDict[Tuple, PrefixEntry]" = OrderedDict()
        self.stats = PrefixStats()

    # -- keying ----------------------------------------------------------

    def _key(self, tokens, m: int, key0: Optional[Tuple] = None) -> Tuple:
        toks = np.asarray(tokens[:m], np.int32)
        return (self.key0 if key0 is None else key0, m, toks.tobytes())

    def max_publish_len(self, plen: int) -> int:
        """Longest publishable prefix of a ``plen``-token prompt: the
        largest block multiple <= plen - 1 (0 = too short to publish)."""
        return ((plen - 1) // self.block) * self.block

    # -- lookup / adoption -----------------------------------------------

    def lookup(self, tokens, key0: Optional[Tuple] = None
               ) -> Optional[PrefixEntry]:
        """Longest frozen prefix of ``tokens`` (block-aligned, leaving
        >= 1 suffix token), or None.  Counts a hit or a miss."""
        m = self.max_publish_len(len(tokens))
        while m >= self.block:
            e = self.entries.get(self._key(tokens, m, key0))
            if e is not None:
                self.entries.move_to_end(e.key)
                e.hits += 1
                self.stats.hits += 1
                self.stats.hit_tokens += m
                if _obs.enabled():
                    reg = _obs.get_registry()
                    reg.inc("prefix_cache.hits", 1)
                    reg.inc("prefix_cache.hit_tokens", m)
                return e
            m -= self.block
        self.stats.misses += 1
        if _obs.enabled():
            _obs.get_registry().inc("prefix_cache.misses", 1)
        return None

    def adopt(self, slot: int, entry: PrefixEntry) -> int:
        """Install a frozen prefix into an empty slot: alias the blocks,
        restore the state snapshot.  Returns the prefix length (the slot's
        starting ``prefilled``)."""
        self.paged.adopt_blocks(slot, entry.blocks)
        self.paged.restore_state(slot, entry.state)
        return entry.length

    # -- publication -----------------------------------------------------

    def publish(self, tokens, m: int, slot: int) -> int:
        """Freeze the first ``m`` tokens from ``slot`` (whose cache holds
        them, written back).  Stateless families also publish every
        shorter aligned length, so that partial overlaps still hit; state
        families publish only ``m``, the one boundary a snapshot exists
        for.  Returns the number of entries inserted."""
        assert 0 < m <= len(tokens) - 1 and m % self.block == 0, \
            f"unpublishable prefix length {m} for {len(tokens)} tokens"
        state = self.paged.snapshot_state(slot)
        lengths = [m] if self.paged.state_names else \
            range(m, 0, -self.block)
        inserted = 0
        for length in lengths:
            key = self._key(tokens, length)
            if key in self.entries:
                self.entries.move_to_end(key)   # refreshed, not replaced
                continue
            nb = min(length // self.block, self.paged.blocks_per_slot)
            blocks = self.paged.share_blocks(slot, nb)
            self.entries[key] = PrefixEntry(key, length, blocks, state)
            inserted += 1
            self.stats.inserted += 1
            if _obs.enabled():
                _obs.get_registry().inc("prefix_cache.inserted", 1)
        while len(self.entries) > self.max_entries:
            self.release_one()
        return inserted

    # -- eviction --------------------------------------------------------

    def release_one(self) -> bool:
        """Drop the LRU entry, releasing its block references (blocks
        whose count reaches zero return to the free list).  False when
        empty: the runtime then preempts a live slot."""
        if not self.entries:
            return False
        _, e = self.entries.popitem(last=False)
        self.paged.release_blocks(e.blocks)
        self.stats.evicted += 1
        if _obs.enabled():
            _obs.get_registry().inc("prefix_cache.evicted", 1)
        return True

    def clear(self):
        while self.release_one():
            pass

    def reset_stats(self):
        """Fresh counting window (the entries stay)."""
        self.stats = PrefixStats()

    def __len__(self) -> int:
        return len(self.entries)

    def summary(self) -> Dict[str, Any]:
        d = self.stats.as_dict()
        d["entries"] = len(self.entries)
        return d
