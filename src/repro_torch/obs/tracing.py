"""Profiler tracing: named emulation phases + run-level trace capture — the
port of ``repro.obs.tracing`` on ``torch.profiler``.

Two scope flavors, both no-ops while the obs layer is disabled:

* :func:`phase_scope` — a ``torch.profiler.record_function`` range named
  ``ozimmu/<name>`` around the emulation's phases (``split``,
  ``group_gemm``, ``ladder``, ``scale_accum``) and the kernel launches
  (``kernel/split_fused``, ``kernel/group_gemm``, ``kernel/scale_accum``,
  ``kernel/unscale``), so a trace shows which phase launched each kernel.
  The reference's ``jax.named_scope`` is free metadata on a traced
  program; a ``record_function`` range is two dispatched operations a
  call.  So a scope opens a range only while a profiler is recording as
  well, and is otherwise the shared ``contextlib.nullcontext()``: with
  nobody tracing, the instrumented path dispatches exactly the operations
  and launches exactly the kernels of the uninstrumented one.
* :func:`host_scope` — the same range around host work (a split-cache
  freeze on a miss).  PyTorch has one mechanism for both; the two names
  keep the reference's call sites apart.

Run-level capture: :func:`profile` brackets a whole run with
``torch.profiler.profile`` (``--profile-dir`` on serve and train) and
writes ``<trace_dir>/trace.json`` (Chrome trace format; Perfetto reads
it).  Failures to start or write the trace degrade to a warning:
observability never takes the workload down.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import torch

from repro_torch.obs import registry as _registry

__all__ = ["phase_scope", "host_scope", "profile", "PHASES"]

# The emulation pipeline's phase names: every phase scope is
# ozimmu/<one of these> (or ozimmu/kernel/<kernel> around a launch).
PHASES = ("split", "group_gemm", "ladder", "scale_accum")

_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def phase_scope(name: str):
    """A profiler range ``ozimmu/<name>`` while obs is enabled and a
    profiler records; the shared null context otherwise."""
    if _profiler_enabled() and _registry.enabled():
        return torch.profiler.record_function(f"ozimmu/{name}")
    return _NULL


def host_scope(name: str):
    """Host-side range ``ozimmu/<name>`` (the python thread's timeline of
    an active trace): :func:`phase_scope` under the reference's second
    name."""
    return phase_scope(name)


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """Trace the enclosed run (CPU, and the card when there is one) into
    ``trace_dir/trace.json`` when ``trace_dir`` is set; a plain
    passthrough when None."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # profiler unavailable / already running
        prof = None
        print(f"[obs] profiler trace unavailable ({e}); continuing "
              f"without", file=sys.stderr)
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      "trace.json"))
            except Exception as e:
                print(f"[obs] profiler trace not written ({e})",
                      file=sys.stderr)
