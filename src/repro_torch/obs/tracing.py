"""Run-level trace capture — the ``profile`` part of ``repro.obs.tracing``
on ``torch.profiler``.

:func:`profile` brackets a whole run with ``torch.profiler.profile`` (the
trainer's ``--profile-dir``) and writes ``<trace_dir>/trace.json``
(Chrome trace format; Perfetto reads it).  Failures to start or write the
trace degrade to a warning: observability never takes the workload down.
The reference's named emulation-phase scopes have no caller in the port
yet and come with its observability slice.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import torch

__all__ = ["profile"]


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
