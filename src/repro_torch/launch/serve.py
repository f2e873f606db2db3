"""Serving driver over the continuous-batching runtime — PyTorch port of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
        --requests 8 --slots 4 --prompt-len 32 --gen 16 \
        --engine ozimmu_h-4:df32:fused

Runs on the CUDA card unless ``--device cpu`` is given (the kernels' plain
versions).  Like the reference it serves the arch's smoke config unless
``--full`` asks for the published one; weights are random, drawn from
``--seed``.  The vlm and encdec archs serve with the reference's static
per-slot context (:func:`slot_context`).  ``--page-block`` serves every
family from the block-paged KV pool.  ``--prefix-cache``, ``--mesh``,
``--metrics-json`` and ``--profile-dir`` keep the reference's flags and
raise until the slices that bring them (prefix cache, distributed, obs).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import plan
from repro_torch.models import api, encdec
from repro_torch.serving import ServingRuntime


def make_runtime(cfg, params, *, slots: int, max_len: int,
                 page_block: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 presplit: Optional[bool] = None, ctx=None,
                 device=None) -> ServingRuntime:
    return ServingRuntime(cfg, params, slots=slots, max_len=max_len,
                          page_block=page_block, prefill_chunk=prefill_chunk,
                          prefix_cache=prefix_cache, presplit=presplit,
                          ctx=ctx, device=device)


def slot_context(cfg, params, prompt_len: int):
    """Static single-slot context for the vlm/encdec families (shared
    across slots), exactly the reference's: zero patch embeddings (1,
    vision_seq, d_model) for vlm, the encoder's output over zero frames
    (1, prompt_len, d_model) for encdec; None for the other families.
    On the parameters' device."""
    device = params["embed"].device
    if cfg.family == "vlm":
        return torch.zeros((1, cfg.vision_seq, cfg.d_model),
                           dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        frames = torch.zeros((1, prompt_len, cfg.d_model),
                             dtype=torch.float32, device=device)
        with torch.no_grad():
            return encdec.encode(params, cfg, frames)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="decode slots (the step's batch dimension)")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-block", type=int, default=None,
                    help="positions per KV block: enables the paged "
                         "KV-cache pool (every family; state leaves stay "
                         "resident per the family descriptor)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="max prompt tokens fed per slot per scheduler "
                         "round (chunked prefill; default whole-prompt)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix cache (not ported yet)")
    ap.add_argument("--no-presplit", action="store_true",
                    help="disable the weight split-cache (A/B baseline; "
                         "ozimmu engines only)")
    ap.add_argument("--engine", "--matmul_engine", dest="engine",
                    default="bf16",
                    help="matmul engine spec, e.g. bf16, f32 or "
                         "ozimmu_h-4:df32:fused")
    ap.add_argument("--mesh", default=None, help="(not ported yet)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="(not ported yet)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="(not ported yet)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config instead of the "
                         "smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for flag, later in (("prefix_cache", "prefix-cache"),
                        ("mesh", "distributed"), ("metrics_json", "obs"),
                        ("profile_dir", "obs")):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} comes "
                                      f"with the {later} slice of the port")
    n_requests = args.requests if args.requests is not None else args.slots
    device = resolve_device(args.device)

    cfg = configs.get_config(args.arch, smoke=not args.full,
                             engine_spec=args.engine)
    oz_cfg = cfg.engine.ozimmu_config
    if oz_cfg is not None:
        print(f"[serve] engine {args.engine}: "
              f"{plan.describe_config(oz_cfg, cfg.d_model, cfg.d_model, cfg.d_model)}")
    model = api.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, generator=gen, device=device)
    ctx = slot_context(cfg, params, args.prompt_len)
    runtime = make_runtime(cfg, params, slots=args.slots,
                           max_len=args.max_len,
                           page_block=args.page_block,
                           prefill_chunk=args.prefill_chunk,
                           presplit=False if args.no_presplit else None,
                           ctx=ctx, device=device)
    if runtime.split_cache is not None:
        st = runtime.split_cache.stats
        print(f"[serve] split-cache: froze {st.misses} weight splits "
              f"({st.cached_bytes / 1e6:.2f} MB resident)")
    if len(plan.get_ledger()):
        print(f"[serve] planner: {plan.get_ledger().describe()}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len,
                            dtype=np.int32) for _ in range(n_requests)]
    t0 = time.time()
    reqs = [runtime.submit(p, args.gen) for p in prompts]
    s = runtime.run()
    dt = time.time() - t0
    outs = [np.concatenate([r.prompt, np.asarray(r.generated, np.int32)])
            for r in reqs]
    print(f"[serve] {args.arch} on {device}: {s['tokens_generated']} tokens "
          f"from {s['requests']['finished']} requests in {dt:.2f}s "
          f"({s['tokens_per_s']:.1f} tok/s, slots={args.slots}, "
          f"prefill_calls={s['prefill_calls']}, "
          f"evictions={s['evictions']})")
    if s["ttft_s"]["mean"] is not None:
        print(f"[serve] TTFT mean {s['ttft_s']['mean']:.3f}s "
              f"p95 {s['ttft_s']['p95']:.3f}s; queue depth max "
              f"{s['queue_depth']['max']}")
    if s["split_cache"] is not None:
        sc = s["split_cache"]
        print(f"[serve] split-cache: weight-split hit rate "
              f"{sc['weight_split_hit_rate']:.2f}, "
              f"{sc['avoided_split_bytes'] / 1e6:.2f} MB of decode-time "
              f"re-splitting avoided")
    print("[serve] sample continuation:",
          outs[0][-args.gen:][:16].tolist())
    return s


if __name__ == "__main__":
    main()
