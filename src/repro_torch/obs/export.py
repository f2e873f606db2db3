"""Exporters: Prometheus text exposition + JSON, with a format lint — a
copy of ``repro.obs.export`` (pure standard library) for the port.

The JSON document is :meth:`repro_torch.obs.registry.Snapshot.as_dict` plus
optional sidecars (the planner ledger, a serving summary) — the payload
``launch/serve.py --metrics-json`` writes and the CI smoke parses.

The Prometheus exporter emits the text exposition format (one ``# TYPE``
per metric family, counters suffixed ``_total``, histograms rendered as
summaries with ``quantile`` labels).  :func:`lint_prometheus` /
:func:`parse_prometheus` validate and round-trip the output — the test
suite's format gate, so a drive-by rename can't silently break scrapes.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry, Snapshot, percentile

__all__ = ["to_json", "metrics_document", "to_prometheus",
           "lint_prometheus", "parse_prometheus", "unified_snapshot"]

_QUANTILES = (0.5, 0.95, 0.99)


def unified_snapshot(*extra: "MetricsRegistry | Snapshot") -> Snapshot:
    """The process-global registry's snapshot merged with any extra
    registries/snapshots (per-runtime serving registries, typically)."""
    from repro_torch.obs import registry as _reg
    snap = _reg.get_registry().snapshot()
    for e in extra:
        if e is None:
            continue
        snap = snap.merge(e if isinstance(e, Snapshot) else e.snapshot())
    return snap


def metrics_document(snap: Snapshot, *, ledger: bool = True,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The full JSON document: snapshot + plan-ledger summary + extras."""
    doc = snap.as_dict()
    if ledger:
        from repro_torch.core import plan as _plan
        doc["plan_ledger"] = _plan.get_ledger().summary()
    if extra:
        doc.update(extra)
    return doc


def to_json(snap: Snapshot, *, ledger: bool = True,
            extra: Optional[Dict[str, Any]] = None, indent: int = 2) -> str:
    return json.dumps(metrics_document(snap, ledger=ledger, extra=extra),
                      indent=indent, sort_keys=True)


# -- Prometheus text exposition ------------------------------------------

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# one sample line: name{labels} value   (labels optional)
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\})?"
    r" (-?(?:[0-9.eE+-]+|Inf|NaN))$")
_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")


def _prom_name(name: str, prefix: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", f"{prefix}_{name}" if prefix
                 else name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _label_str(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(v)}"' for k, v in labels
             if _LABEL_OK.match(k)]
    if extra:
        parts = [extra] + parts
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(snap: Snapshot, prefix: str = "repro") -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines = []
    by_name: Dict[str, list] = {}
    for (name, labels), v in sorted(snap.counters.items()):
        by_name.setdefault(_prom_name(name, prefix) + "_total",
                           []).append(("counter", labels, v))
    for (name, labels), v in sorted(snap.gauges.items()):
        by_name.setdefault(_prom_name(name, prefix),
                           []).append(("gauge", labels, v))
    for pname, rows in sorted(by_name.items()):
        lines.append(f"# TYPE {pname} {rows[0][0]}")
        for _, labels, v in rows:
            lines.append(f"{pname}{_label_str(labels)} {_fmt(v)}")
    for (name, labels), vals in sorted(snap.hists.items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} summary")
        for q in _QUANTILES:
            qlabel = 'quantile="%s"' % q
            lines.append(f"{pname}{_label_str(labels, qlabel)} "
                         f"{_fmt(percentile(vals, q))}")
        lines.append(f"{pname}_sum{_label_str(labels)} {_fmt(sum(vals))}")
        lines.append(f"{pname}_count{_label_str(labels)} {len(vals)}")
    return "\n".join(lines) + "\n" if lines else ""


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


def lint_prometheus(text: str) -> None:
    """Validate exposition-format text; raises ValueError with the
    offending line.  Checks: sample-line grammar, metric/label name
    charset, exactly one ``# TYPE`` per family declared before its first
    sample, and a known type keyword."""
    declared: Dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {i}: malformed TYPE line: {line!r}")
            _, _, name, typ = parts
            if not _NAME_OK.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            if typ not in _TYPES:
                raise ValueError(f"line {i}: unknown type {typ!r}")
            if name in declared:
                raise ValueError(f"line {i}: duplicate TYPE for {name!r}")
            declared[name] = typ
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample line: {line!r}")
        name = m.group(1)
        base = name
        for suffix in ("_sum", "_count", "_bucket"):
            if name.endswith(suffix) and name[:-len(suffix)] in declared:
                base = name[:-len(suffix)]
        if base not in declared:
            raise ValueError(f"line {i}: sample {name!r} has no preceding "
                             f"# TYPE declaration")
        float(m.group(3))  # value must parse


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse sample lines into ``{"name{labels}": value}`` (validated
    first) — the exporter round-trip used by tests."""
    lint_prometheus(text)
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out
