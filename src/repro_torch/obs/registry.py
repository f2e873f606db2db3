"""Process-wide metrics registry: labeled counters, gauges, histograms —
a copy of ``repro.obs.registry`` (pure standard library) for the port.

All recording happens on the host; nothing here touches tensor values.

Two registries matter in practice:

* the process-global default (``get_registry()``);
* per-:class:`~repro_torch.serving.metrics.ServingMetrics` private
  instances — serving counters must not bleed between interleaved
  runtimes, so each metrics window owns its own registry.

Disabled mode is a true no-op: every mutator early-returns before
touching locks or dicts.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricsRegistry", "Snapshot", "get_registry", "set_registry",
    "enabled", "set_enabled", "disabled", "percentile", "hist_stats",
]

# (metric name, canonicalised labels) — the registry's row key.  Labels
# are sorted (k, str(v)) pairs so kwarg order never splits a series.
Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


# -- percentiles ---------------------------------------------------------

def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), q in
    [0, 1].  Unlike nearest-rank-with-rounding this is exact at small N:
    percentile([1, 2, 3, 4], 0.5) == 2.5, not 3."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of empty sequence")
    if len(vals) == 1:
        return float(vals[0])
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def hist_stats(values: Iterable[float]) -> Optional[Dict[str, float]]:
    """Summary block for one histogram series (None when empty)."""
    vals = list(values)
    if not vals:
        return None
    return {
        "count": len(vals),
        "sum": float(sum(vals)),
        "mean": float(sum(vals) / len(vals)),
        "min": float(min(vals)),
        "max": float(max(vals)),
        "p50": percentile(vals, 0.50),
        "p95": percentile(vals, 0.95),
        "p99": percentile(vals, 0.99),
    }


# -- snapshots -----------------------------------------------------------

class Snapshot:
    """Immutable copy of a registry's state at one instant.

    Supports ``diff`` (counter deltas + histogram suffixes since an older
    snapshot — histograms only ever append, so the suffix is exact),
    ``merge`` (union of two registries for the unified export), and
    ``as_dict`` (the JSON document ``--metrics-json`` writes)."""

    def __init__(self, counters: Dict[Key, float], gauges: Dict[Key, float],
                 hists: Dict[Key, Tuple[float, ...]], taken_at: float = 0.0):
        self.counters = counters
        self.gauges = gauges
        self.hists = hists
        self.taken_at = taken_at

    # accessors ----------------------------------------------------------

    def value(self, name: str, **labels: Any) -> float:
        return self.counters.get(_key(name, labels), 0.0)

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        return self.gauges.get(_key(name, labels))

    def hist_values(self, name: str, **labels: Any) -> Tuple[float, ...]:
        return self.hists.get(_key(name, labels), ())

    def total(self, name: str, **labels: Any) -> float:
        """Sum of a counter across every label set that carries all of
        the given ``labels`` (all series of ``name`` when none given)."""
        want = set(_key(name, labels)[1])
        return sum(v for (n, ls), v in self.counters.items()
                   if n == name and want.issubset(ls))

    def names(self) -> List[str]:
        seen = []
        for d in (self.counters, self.gauges, self.hists):
            for n, _ in d:
                if n not in seen:
                    seen.append(n)
        return sorted(seen)

    # algebra ------------------------------------------------------------

    def diff(self, older: "Snapshot") -> "Snapshot":
        counters = {}
        for k, v in self.counters.items():
            d = v - older.counters.get(k, 0.0)
            if d:
                counters[k] = d
        gauges = dict(self.gauges)
        hists = {}
        for k, vals in self.hists.items():
            prev = len(older.hists.get(k, ()))
            if len(vals) > prev:
                hists[k] = vals[prev:]
        return Snapshot(counters, gauges, hists, self.taken_at)

    def merge(self, other: "Snapshot") -> "Snapshot":
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0.0) + v
        gauges = dict(self.gauges)
        gauges.update(other.gauges)
        hists = dict(self.hists)
        for k, vals in other.hists.items():
            hists[k] = hists.get(k, ()) + vals
        return Snapshot(counters, gauges, hists,
                        max(self.taken_at, other.taken_at))

    # export -------------------------------------------------------------

    @staticmethod
    def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
        if not labels:
            return ""
        return "{%s}" % ",".join(f"{k}={v}" for k, v in labels)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-able document.  ``totals`` sums each counter across its
        label sets — the stable surface CI smoke assertions key on."""
        counters: Dict[str, Dict[str, float]] = {}
        for (name, labels), v in sorted(self.counters.items()):
            counters.setdefault(name, {})[self._label_str(labels) or "total"] = v
        gauges: Dict[str, Dict[str, float]] = {}
        for (name, labels), v in sorted(self.gauges.items()):
            gauges.setdefault(name, {})[self._label_str(labels) or "total"] = v
        hists: Dict[str, Dict[str, Any]] = {}
        for (name, labels), vals in sorted(self.hists.items()):
            hists.setdefault(name, {})[self._label_str(labels) or "total"] = \
                hist_stats(vals)
        totals = {}
        for (name, _), v in self.counters.items():
            totals[name] = totals.get(name, 0.0) + v
        return {"taken_at": self.taken_at, "totals": totals,
                "counters": counters, "gauges": gauges, "histograms": hists}


# -- the registry --------------------------------------------------------

class MetricsRegistry:
    """Thread-safe labeled counters / gauges / histograms.

    The clock is injectable (``now``) so timing histograms are testable
    against a virtual clock — the serving runtime threads its own
    ``_now`` through, matching its deterministic-time test harness."""

    def __init__(self, now: Callable[[], float] = time.monotonic,
                 enabled: bool = True):
        self.now = now
        self._enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[Key, float] = {}
        self._gauges: Dict[Key, float] = {}
        self._hists: Dict[Key, List[float]] = {}

    # enable / disable ---------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    # recording ----------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels: Any):
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels: Any):
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels: Any):
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._hists.setdefault(k, []).append(float(value))

    @contextlib.contextmanager
    def timer(self, name: str, **labels: Any):
        if not self._enabled:
            yield
            return
        t0 = self.now()
        try:
            yield
        finally:
            self.observe(name, self.now() - t0, **labels)

    # reads --------------------------------------------------------------

    def value(self, name: str, **labels: Any) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def hist_values(self, name: str, **labels: Any) -> Tuple[float, ...]:
        with self._lock:
            return tuple(self._hists.get(_key(name, labels), ()))

    def total(self, name: str, **labels: Any) -> float:
        return self.snapshot().total(name, **labels)

    def snapshot(self) -> Snapshot:
        with self._lock:
            return Snapshot(dict(self._counters), dict(self._gauges),
                            {k: tuple(v) for k, v in self._hists.items()},
                            taken_at=self.now())

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def is_empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._hists)


# -- process-global default ---------------------------------------------

_REGISTRY = MetricsRegistry()
_ENABLED = True  # mirrored module-level for the cheapest hot-path gate


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the old one."""
    global _REGISTRY
    old, _REGISTRY = _REGISTRY, reg
    return old


def enabled() -> bool:
    """The gate hot call sites check before building labels — a plain
    module-global read, so disabled mode costs one bool test."""
    return _ENABLED and _REGISTRY._enabled


def set_enabled(on: bool):
    global _ENABLED
    _ENABLED = bool(on)
    (_REGISTRY.enable if on else _REGISTRY.disable)()


@contextlib.contextmanager
def disabled():
    """Scoped kill switch (used by the overhead assertion in tests)."""
    prev = _ENABLED
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)
