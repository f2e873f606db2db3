"""Observability layer of the port: metrics registry, profiler tracing,
exporters (``repro.obs`` on PyTorch).

The package is import-light on purpose — ``repro_torch.obs.registry``
pulls in nothing outside the standard library, so core modules can record
metrics without creating import cycles.
"""

from repro_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    Snapshot,
    enabled,
    get_registry,
    set_enabled,
)
