#!/usr/bin/env python3
"""Monolithic against paged serving on the card, in turns.

    python tools/paged_ab.py [--turns 2]

Full-width internlm2-1.8b under ``ozimmu_h-4:df32:fused`` (random weights
from seed 0), the requests of ``chip_smoke.py``'s serve phase (4 slots, 8
prompts of 32 tokens, 16 new tokens, max_len 48), served by a fresh
runtime per run in the order monolithic, paged with the slots' full pool,
paged with a pool of 8 blocks (evictions), then the same backwards, for
``--turns`` rounds: ms a model step (a position a prefill call feeds, or a
decode step), tok/s, evictions and model steps of each.  Then each of the
monolithic and the full-pool paged runtimes traces 11 model steps with
``torch.profiler`` (``chip_smoke.serve_trace``: device operations, device
ms and idle share a step, by kernel).  Every run's tokens must equal the
first monolithic run's.  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = configs.get_config("internlm2_1_8b", engine_spec=cs.MODEL_SPEC)
    model = api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(cs.SEED), device=dev)
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab, size=cs.PROMPT, dtype=np.int32)
               for _ in range(cs.REQUESTS)]
    kinds = {"monolithic": {},
             "paged full pool": dict(page_block=cs.PAGE_BLOCK,
                                     prefill_chunk=cs.PAGE_CHUNK),
             "paged pool 8": dict(page_block=cs.PAGE_BLOCK,
                                  page_blocks=cs.PAGE_POOL,
                                  prefill_chunk=cs.PAGE_CHUNK)}

    def runtime(kind):
        return ServingRuntime(cfg, params, slots=cs.SLOTS,
                              max_len=cs.PROMPT + cs.GEN, device=dev,
                              **kinds[kind])

    first = None
    order = list(kinds) + list(kinds)[::-1]
    for turn in range(args.turns):
        for kind in order:
            rt = runtime(kind)
            fed = []
            prefill = rt._prefill

            def counted(toks, *a, prefill=prefill, fed=fed):
                fed.append(toks.shape[1])
                return prefill(toks, *a)
            rt._prefill = counted
            torch.cuda.synchronize()
            reqs = [rt.submit(p, cs.GEN) for p in prompts]
            t0 = time.perf_counter()
            s = rt.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = sum(fed) + s["decode_steps"]
            toks = [r.generated for r in reqs]
            if first is None:
                first = toks
            if toks != first:
                raise AssertionError(f"{kind}: tokens differ from the first "
                                     f"monolithic run's")
            cs.log(f"[paged_ab] {card}; turn {turn} {kind}: "
                   f"{dt / steps * 1e3:.2f} ms a model step, "
                   f"{s['tokens_per_s']:.2f} tok/s, {steps} model steps, "
                   f"evictions {s['evictions']}, tokens equal")
            del rt
            torch.cuda.empty_cache()
    for kind in ("monolithic", "paged full pool"):
        rt = runtime(kind)
        reqs = [rt.submit(p, cs.GEN) for p in prompts]
        s = rt.run()
        steps = s["prefill_calls"] * (
            cs.PROMPT if kind == "monolithic" else cs.PAGE_CHUNK) + \
            s["decode_steps"]
        cs.serve_trace(rt, prompts, f"paged_ab {kind}", s,
                       untraced_steps=steps)
        del rt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
