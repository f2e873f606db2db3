"""Serving metrics: tokens/s, TTFT, queue depth, split-cache savings —
PyTorch-port copy of ``repro.serving.metrics`` (plain Python).

Every counter and distribution lives in a **private**
:class:`repro_torch.obs.registry.MetricsRegistry` (names under
``serving.*``), and :meth:`ServingMetrics.summary` is a view over it:
summaries are per measurement window, and interleaved runtimes must never
bleed into each other.  Percentiles are linear-interpolation
(:func:`repro_torch.obs.registry.percentile`), exact at small N.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry, hist_stats, percentile

__all__ = ["ServingMetrics"]

_COUNTERS = ("requests_submitted", "requests_finished", "tokens_generated",
             "prefill_tokens", "decode_steps", "prefill_calls",
             "prefill_chunks", "evictions")

# per-round timing histograms (seconds), recorded by the runtime loop
TIMING_HISTS = ("decode_step", "prefill_call", "eviction", "cow_copy")


def _counter(name: str):
    key = f"serving.{name}"

    def get(self) -> int:
        return int(self.registry.value(key))

    def set_(self, value: int):
        self.registry.inc(key, value - self.registry.value(key))

    return property(get, set_)


class ServingMetrics:
    """One measurement window's serving counters over a private registry.

    The constructor keeps the historical dataclass-style signature
    (``ServingMetrics(now=...)``); counters read/write through the
    registry so ``m.decode_steps += 1`` works unchanged."""

    def __init__(self, now=time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        self.now = now                  # injectable clock (virtual-time
                                        # tests share it with the registry)
        self.registry = registry if registry is not None \
            else MetricsRegistry(now=now)
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self.split_cache: Optional[Dict[str, Any]] = None
        self.prefix_cache: Optional[Dict[str, Any]] = None

    requests_submitted = _counter("requests_submitted")
    requests_finished = _counter("requests_finished")
    tokens_generated = _counter("tokens_generated")
    prefill_tokens = _counter("prefill_tokens")
    decode_steps = _counter("decode_steps")
    prefill_calls = _counter("prefill_calls")
    prefill_chunks = _counter("prefill_chunks")  # non-final chunk calls
    evictions = _counter("evictions")

    # -- distributions ---------------------------------------------------

    @property
    def ttft(self) -> List[float]:
        return list(self.registry.hist_values("serving.ttft_s"))

    @property
    def latency(self) -> List[float]:
        return list(self.registry.hist_values("serving.latency_s"))

    @property
    def queue_depth_samples(self) -> List[int]:
        return [int(v) for v in
                self.registry.hist_values("serving.queue_depth")]

    def observe_timing(self, phase: str, seconds: float):
        """One per-round phase timing (``phase`` in :data:`TIMING_HISTS`:
        decode_step / prefill_call / eviction / cow_copy)."""
        self.registry.observe(f"serving.{phase}_s", seconds)

    def timer(self, phase: str):
        """Context manager recording its elapsed time as
        :meth:`observe_timing` (uses the injectable clock)."""
        return self.registry.timer(f"serving.{phase}_s")

    # -- lifecycle -------------------------------------------------------

    def start(self):
        if self.started_at is None:
            self.started_at = self.now()

    def stop(self):
        self.stopped_at = self.now()

    @property
    def elapsed(self) -> float:
        if self.started_at is None:
            return 0.0
        end = self.stopped_at if self.stopped_at is not None else self.now()
        return max(end - self.started_at, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.elapsed

    def record_finish(self, req, end_time: float):
        self.requests_finished += 1
        if req.first_token_at is not None:
            self.registry.observe("serving.ttft_s",
                                  req.first_token_at - req.arrival)
        self.registry.observe("serving.latency_s", end_time - req.arrival)

    def sample_queue(self, depth: int):
        self.registry.observe("serving.queue_depth", int(depth))

    # -- the public view -------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        ttft = self.ttft
        lat = self.latency
        qd = self.queue_depth_samples
        timings = {}
        for phase in TIMING_HISTS:
            stats = hist_stats(
                self.registry.hist_values(f"serving.{phase}_s"))
            if stats is not None:
                timings[phase] = {k: stats[k] for k in
                                  ("count", "mean", "p50", "p95", "p99",
                                   "max")}
        return {
            "requests": {"submitted": self.requests_submitted,
                         "finished": self.requests_finished},
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "evictions": self.evictions,
            "elapsed_s": round(self.elapsed, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "ttft_s": {"mean": (sum(ttft) / len(ttft)) if ttft else None,
                       "p50": _pct(ttft, 0.5), "p95": _pct(ttft, 0.95),
                       "p99": _pct(ttft, 0.99)},
            "latency_s": {"mean": (sum(lat) / len(lat)) if lat else None,
                          "p95": _pct(lat, 0.95), "p99": _pct(lat, 0.99)},
            "queue_depth": {"max": max(qd) if qd else 0,
                            "mean": (sum(qd) / len(qd)) if qd else 0.0,
                            "p95": _pct(qd, 0.95) if qd else 0.0},
            "timings_s": timings,
            "split_cache": self.split_cache,
            "prefix_cache": self.prefix_cache,
        }


def _pct(vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile, None on empty input (the summary
    contract for windows that finished no requests)."""
    if not vals:
        return None
    return percentile(vals, q)
