#!/usr/bin/env python3
"""Serve and trace the port on the card under one engine spec, for any
tree of the port.

    python tools/serve_trace.py [--src DIR] [--spec SPEC]

Runs the serve phase of ``chip_smoke.py`` (this checkout's: full-width
internlm2-1.8b, random weights from seed 0, 4 slots, 8 requests of prompt
32 and 16 new tokens, then 11 model steps under ``torch.profiler``) against
the port under ``--src`` (default: this checkout's ``src``).  So a tree
unpacked from another commit (``git archive``) is measured by the same
code: tok/s and TTFT, the launches, and the trace's device operations,
device ms and idle share a model step, by kernel.  It holds every tree to
what all of them do: one split launch per split operand, four group GEMMs
a contraction on the skinny route, request 0 equal to the monolithic
greedy loop, prefill logits within 1e-3 of the f32 engine.  Needs one CUDA
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory holding repro_torch")
    ap.add_argument("--spec", default="oz2_h-4:df32:fast2:fused")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_trace: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"serve_trace: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"[serve_trace] {card}; port under {src}")
    chip_smoke.phase_serve(torch.device("cuda"), args.spec,
                           ("split_fused", "group_gemm"),
                           tag=f"serve_trace {args.spec}", trace=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
