"""Per-slot cache operations — PyTorch port of ``SlotCacheOps`` from
``repro.serving.kvcache``.

Family-generic *monolithic* slot operations, driven by the model's
``cache_axes``: the ``"cache_batch"`` logical axis marks the slot dimension
of every cache leaf.  The runtime uses them to freeze non-participating
slots around a prefill call (a per-slot select) and to reset a slot at
admission.  The block-paged pool (``PagedKV``) and its state descriptors
come with the paged-KV slice of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["SlotCacheOps"]


class SlotCacheOps:
    """Per-slot select / reset on a monolithic cache dict."""

    def __init__(self, cfg, model):
        self.cfg, self.model = cfg, model
        self._slot_axis: Dict[str, int] = {
            name: ax.index("cache_batch")
            for name, ax in model.cache_axes(cfg).items()}

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
