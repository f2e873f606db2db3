"""Serving runtime: continuous batching + persistent weight split-cache —
PyTorch port of ``repro.serving`` (scheduler, metrics, per-slot cache
ops and the block-paged KV pool with its per-family state descriptors,
the prefix KV cache over that pool, presplit wrapping,
:class:`ServingRuntime`)."""
from repro_torch.serving.kvcache import (STATE_DESCRIPTORS, PagedKV,
                                         state_descriptor)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServingRuntime", "ServingMetrics", "Request", "Scheduler",
           "PagedKV", "PrefixCache", "STATE_DESCRIPTORS",
           "state_descriptor"]
