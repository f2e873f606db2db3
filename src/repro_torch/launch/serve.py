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
family from the block-paged KV pool, and ``--prefix-cache`` adds the
prefix KV cache over it (the random prompts here share no prefix, so the
hit rate it prints is 0.00).  ``--metrics-json PATH`` writes the unified
metrics document (the process registry's emulation, split-cache,
prefix-cache and planner counters merged with the runtime's serving
registry, the plan ledger's summary, and at the end the serving summary
and ``decode_observed``), every ``--metrics-every`` scheduler rounds and
once at the end; ``--profile-dir DIR`` traces the serving loop into
``DIR/trace.json`` with the emulation's ``ozimmu/*`` phase ranges.

``--mesh model=N`` serves on N ranks, one process each (SPMD), with an
``@model`` engine spec sharding every emulated contraction over them
(``ozimmu_h-4:df32:fused@model``: bitwise the single-device tokens).  The
process group comes from torchrun (``torchrun --nproc-per-node N -m
repro_torch.launch.serve ...``) or is already initialized by the caller
(:func:`repro_torch.launch.mesh.init_distributed`): gloo when ranks
share one card or run on the CPU, NCCL when each rank has a card of its
own (that route has not yet run on any host; the one-card runs use
gloo).  Every
rank holds the whole model; rank 0 prints.

``--mesh data=N`` (or ``pod=N``, or both) splits the slots over the N
batch ranks: each rank's cache holds its S/N slots and every rank runs
every model call on its own rows, its greedy tokens gathered so that the
replicated schedulers agree (:class:`~repro_torch.serving.ServingRuntime`);
the MoE archs exchange their experts' tokens over ``data`` by
all-to-all.  ``--mesh data=2,model=2`` composes both: the ``@model``
groups lie within a data line.  Every rank serves the same requests, and
the summary rank 0 prints is the global schedule's.  The paged pool and
the prefix cache under a batch axis of more than one rank raise
``NotImplementedError``: a prefix hit would need blocks that live on the
rank that wrote them.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import plan
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, encdec
from repro_torch.obs import export as obs_export
from repro_torch.obs import tracing as obs_tracing
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


def dump_metrics(path: str, runtime: ServingRuntime,
                 final: bool = False) -> None:
    """Write the unified metrics document (the global registry merged with
    the runtime's private serving registry, plus the plan ledger) to
    ``path``, atomically through ``path.tmp``.  Final dumps embed the
    serving summary and the decode-observed counters."""
    snap = obs_export.unified_snapshot(runtime.metrics.registry)
    extra = None
    if final:
        extra = {"serving_summary": runtime.metrics.summary()}
        if runtime.decode_observed is not None:
            extra["decode_observed"] = runtime.decode_observed
    text = obs_export.to_json(snap, extra=extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text + "\n")
    os.replace(tmp, path)


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
                    help="cache shared prompt prefixes as frozen paged "
                         "blocks (requires --page-block)")
    ap.add_argument("--no-presplit", action="store_true",
                    help="disable the weight split-cache (A/B baseline; "
                         "ozimmu engines only)")
    ap.add_argument("--engine", "--matmul_engine", dest="engine",
                    default="bf16",
                    help="matmul engine spec, e.g. bf16, f32 or "
                         "ozimmu_h-4:df32:fused")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. 'data=2' (the slots split over "
                         "the ranks) or 'model=2' (the contractions of an "
                         "'@model' engine sharded over them), or both "
                         "(torchrun); default no mesh (single device)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the unified metrics document (registry "
                         "snapshot + plan ledger + serving summary) to "
                         "PATH; with --metrics-every also periodically "
                         "during the run")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="dump --metrics-json every N scheduler rounds "
                         "(0 = final dump only)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the serving loop with torch.profiler into "
                         "DIR/trace.json (Perfetto reads it)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config instead of the "
                         "smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_requests = args.requests if args.requests is not None else args.slots
    batch = [a for a, n in (mesh_lib.spec_axes(args.mesh) if args.mesh
                            else {}).items() if a != "model" and n > 1]
    if batch and (args.page_block is not None or args.prefix_cache):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the paged pool and the prefix cache are "
            f"not split over the {'/'.join(batch)} batch ranks yet (a "
            f"prefix hit would need blocks that live on the rank that "
            f"wrote them); serve without --page-block there")
    with mesh_lib.process_group(args.mesh, args.device) as device:
        mesh = mesh_lib.parse_mesh_spec(args.mesh)
        if mesh is not None and mesh.rank == 0:
            backend = dist.get_backend() if dist.is_initialized() \
                else "one process"
            print(f"[serve] mesh {mesh.shape} over {compat.world()[1]} "
                  f"ranks ({backend}, {device}); rank 0 prints")
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(compat.set_mesh(mesh))
                stack.enter_context(use_rules(mesh_lib.mesh_rules(
                    mesh, args.arch)))
            return _serve(args, n_requests, device,
                          lead=mesh is None or mesh.rank == 0)


def _serve(args, n_requests: int, device, lead: bool):
    """Serve ``args``'s requests on ``device``.  Only the ``lead`` rank
    prints and writes the metrics document and the trace."""
    say = print if lead else (lambda *a, **kw: None)
    if not lead:
        args.metrics_json = args.profile_dir = None
    cfg = configs.get_config(args.arch, smoke=not args.full,
                             engine_spec=args.engine)
    oz_cfg = cfg.engine.ozimmu_config
    if oz_cfg is not None:
        say(f"[serve] engine {args.engine}: "
            f"{plan.describe_config(oz_cfg, cfg.d_model, cfg.d_model, cfg.d_model)}")
    model = api.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, generator=gen, device=device)
    ctx = slot_context(cfg, params, args.prompt_len)
    runtime = make_runtime(cfg, params, slots=args.slots,
                           max_len=args.max_len,
                           page_block=args.page_block,
                           prefill_chunk=args.prefill_chunk,
                           prefix_cache=args.prefix_cache,
                           presplit=False if args.no_presplit else None,
                           ctx=ctx, device=device)
    if runtime.split_cache is not None:
        st = runtime.split_cache.stats
        say(f"[serve] split-cache: froze {st.misses} weight splits "
            f"({st.cached_bytes / 1e6:.2f} MB resident)")
    if len(plan.get_ledger()):
        say(f"[serve] planner: {plan.get_ledger().describe()}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len,
                            dtype=np.int32) for _ in range(n_requests)]
    t0 = time.time()
    reqs = [runtime.submit(p, args.gen) for p in prompts]
    with obs_tracing.profile(args.profile_dir):
        rounds = 0
        while runtime.step():
            rounds += 1
            if (args.metrics_json and args.metrics_every
                    and rounds % args.metrics_every == 0):
                dump_metrics(args.metrics_json, runtime)
    s = runtime.run()  # no rounds left; closes the metrics window
    dt = time.time() - t0
    outs = [np.concatenate([r.prompt, np.asarray(r.generated, np.int32)])
            for r in reqs]
    if args.metrics_json:
        dump_metrics(args.metrics_json, runtime, final=True)
        say(f"[serve] metrics written to {args.metrics_json}")
    say(f"[serve] {args.arch} on {device}: {s['tokens_generated']} tokens "
        f"from {s['requests']['finished']} requests in {dt:.2f}s "
        f"({s['tokens_per_s']:.1f} tok/s, slots={args.slots}, "
        f"prefill_calls={s['prefill_calls']}, "
        f"evictions={s['evictions']})")
    if s["ttft_s"]["mean"] is not None:
        say(f"[serve] TTFT mean {s['ttft_s']['mean']:.3f}s "
            f"p95 {s['ttft_s']['p95']:.3f}s; queue depth max "
            f"{s['queue_depth']['max']}")
    if s["split_cache"] is not None:
        sc = s["split_cache"]
        say(f"[serve] split-cache: weight-split hit rate "
            f"{sc['weight_split_hit_rate']:.2f}, "
            f"{sc['avoided_split_bytes'] / 1e6:.2f} MB of decode-time "
            f"re-splitting avoided")
    if s.get("prefix_cache") is not None:
        pc = s["prefix_cache"]
        say(f"[serve] prefix-cache: hit rate {pc['hit_rate']:.2f} "
            f"({pc['hit_tokens']} prefill tokens aliased, "
            f"{pc['entries']} entries)")
    if runtime.decode_observed is not None:
        obs = runtime.decode_observed
        say(f"[serve] observed per decode step: "
            f"{obs['contractions']:.0f} contractions, "
            f"{obs['int8_gemms']:.0f} int8 GEMMs "
            f"({obs['int8_gemms_presplit']:.0f} on presplit weights), "
            f"{obs['highprec_adds']:.0f} high-precision adds")
    say("[serve] sample continuation:",
        outs[0][-args.gen:][:16].tolist())
    return s


if __name__ == "__main__":
    main()
