#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. Build every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the card's name and
   power limit.
2. Each kernel at the main paths' shapes (internlm2-1.8b full width,
   k = 4; decode m = slots, prefill m = slots x prompt length; plus the
   DGEMM shapes) against its plain PyTorch version on the same CUDA
   tensors: bitwise equal, with kernel, plain-version, bound and library
   times.
3. DGEMM: ``ozimmu_matmul`` under ``ozimmu_h-8:f64:fused`` at n = 4096,
   error against ``torch.matmul`` in f64, plus a small input that must
   equal the CPU plain-version pipeline bit for bit.
3b. Ozaki-II DGEMM: the same under ``oz2_h-8:f64:fast2:fused`` on the same
   inputs, then once under ``oz2_h-auto:f64:fast2:prob:fused`` (the k the
   planner resolves, and its error).
4. Serve: ``ServingRuntime`` on the published internlm2-1.8b config
   (24 layers, random weights from a seed) under ``ozimmu_h-4:df32:fused``
   with the weight split-cache on; the first request's tokens must equal a
   monolithic greedy loop, and the full-width prefill logits must agree
   with the native f32 engine.
4b. Ozaki-II serve: the same under ``oz2_h-4:df32:fast2:fused``.

The launch counts of phases 3, 3b, 4 and 4b are zeroed just before each
path runs and read just after; every kernel of a path must have launched.
The last three lines are the card (``nvidia-smi``), the per-kernel JSON
record and the result JSON.  Exits non-zero without a CUDA card, and when
run outside the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS = 67e12          # outside the tensor cores
F64_FLOPS = 34e12          # outside the tensor cores

MODEL_SPEC = "ozimmu_h-4:df32:fused"
DGEMM_SPEC = "ozimmu_h-8:f64:fused"
OZ2_MODEL_SPEC = "oz2_h-4:df32:fast2:fused"
OZ2_DGEMM_SPEC = "oz2_h-8:f64:fast2:fused"
OZ2_AUTO_SPEC = "oz2_h-auto:f64:fast2:prob:fused"
SLOTS, REQUESTS, PROMPT, GEN = 4, 8, 32, 16
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def same(x, y) -> bool:
    """Bitwise equality (NaN patterns included) of two tensors or tuples."""
    import torch
    if isinstance(x, tuple):
        return all(same(a, b) for a, b in zip(x, y))
    if x.dtype.is_floating_point:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(x.view(bits[x.dtype]), y.view(bits[y.dtype]))
    return torch.equal(x, y)


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """One dict per (kernel, shape) on seeded inputs at the path's shapes:
    ``run``/``plain`` (fresh outputs, for the bitwise check), ``bench``
    (the timed kernel call), ``library`` (a one-call PyTorch yardstick or
    None), and the bytes/operations the function must move/do."""
    import torch
    from repro_torch.core.splitting import _pow2_ceil, compute_beta
    from repro_torch.kernels import ops
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf

    gen = torch.Generator(device=dev).manual_seed(SEED)
    d, f, vocab = 2048, 8192, 92672          # padded vocab (multiple of 256)
    f32, f64 = torch.float32, torch.float64
    cases = []

    def add(kernel, label, run, plain, moved, ops_, peak, reps, bench=None,
            library=None):
        cases.append(dict(kernel=kernel, label=label, run=run, plain=plain,
                          bench=bench or run, library=library, bytes=moved,
                          ops=ops_, peak=peak, reps=reps))

    def split_case(label, shape, dtype, k, axis, reps):
        x = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        n = shape[-1] if axis == 0 else shape[-2]
        beta = compute_beta(n)
        rowmax = x.abs().amax(dim=-1 if axis == 0 else -2)
        inv = 1.0 / (_pow2_ceil(rowmax) * (2.0 ** (1 - beta)))
        add("split_fused", label,
            lambda: sf.split_fused(x, inv, k=k, beta=beta, axis=axis),
            lambda: sf.split_fused_ref(x, inv, k=k, beta=beta, axis=axis),
            nbytes(x, inv) + k * x.numel(), 0.0, F32_FLOPS, reps)

    def gemm_case(label, m, n, p, k, reps, batch=()):
        dtype = f64 if k == 8 else f32
        a = torch.randn(batch + (m, n), generator=gen, device=dev,
                        dtype=dtype)
        w = torch.randn(batch + (n, p), generator=gen, device=dev,
                        dtype=dtype)
        beta = compute_beta(n)
        da = ops.split_fused(a, k, beta, axis=0).digits
        db = ops.split_fused(w, k, beta, axis=1).digits
        ia, ib = list(range(k)), list(range(k - 1, -1, -1))  # group g=k+1
        library = None
        if not batch and m > 16:
            a_cat = torch.cat([da[i] for i in ia], dim=-1)
            b_cat = torch.cat([db[j] for j in ib], dim=-2)
            library = lambda: torch._int_mm(a_cat, b_cat)
        B, G = math.prod(batch), k
        add("group_gemm", label, lambda: gg.group_gemm(da, db, ia, ib),
            lambda: gg.group_gemm_ref(da, db, ia, ib),
            B * (G * (m * n + n * p) + 4 * m * p), 2.0 * B * G * m * n * p,
            INT8_OPS_PER_S, reps, library=library)

    def accum_case(kernel, label, m, p, dtype, reps):
        p32 = torch.randint(-2 ** 30, 2 ** 30, (m, p), generator=gen,
                            device=dev, dtype=torch.int32)
        srow = torch.pow(2.0, torch.randint(-40, -20, (m,), generator=gen,
                                            device=dev)).to(dtype)
        scol = torch.pow(2.0, torch.randint(-4, 4, (p,), generator=gen,
                                            device=dev)).to(dtype)
        c = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
        peak = F64_FLOPS if dtype == f64 else F32_FLOPS
        if kernel == "scale_accum":
            lo = c * 2.0 ** -30
            hi_b, lo_b = c.clone(), lo.clone()
            add(kernel, label,
                lambda: sa.scale_accum(p32, srow, scol, c.clone(),
                                       lo.clone()),
                lambda: sa.scale_accum_ref(p32, srow, scol, c, lo),
                nbytes(p32, srow, scol) + 4 * nbytes(c), 24.0 * c.numel(),
                peak, reps,
                bench=lambda: sa.scale_accum(p32, srow, scol, hi_b, lo_b))
        else:
            c_b = c.clone()
            add(kernel, label,
                lambda: sa.scale_accum_plain(p32, srow, scol, c.clone()),
                lambda: sa.scale_accum_plain_ref(p32, srow, scol, c),
                nbytes(p32, srow, scol) + 2 * nbytes(c), 3.0 * c.numel(),
                peak, reps,
                bench=lambda: sa.scale_accum_plain(p32, srow, scol, c_b))

    def const_case(kernel, label, m, p, word, dtype, reps):
        hi = 2 ** 52 if word == torch.int64 else 2 ** 30
        w = torch.randint(-hi, hi, (1, m, p), generator=gen, device=dev,
                          dtype=word)
        s = torch.pow(2.0, torch.randint(-60, -30, (1,), generator=gen,
                                         device=dev)).to(dtype)
        c = torch.randn((1, m, p), generator=gen, device=dev, dtype=dtype)
        peak = F64_FLOPS if dtype == f64 else F32_FLOPS
        if kernel == "scale_accum_const":
            lo = c * 2.0 ** -30
            hi_b, lo_b = c.clone(), lo.clone()
            add(kernel, label,
                lambda: sa.scale_accum_const(w, s, c.clone(), lo.clone()),
                lambda: sa.scale_accum_const_ref(w, s, c, lo),
                nbytes(w, s) + 4 * nbytes(c), 22.0 * c.numel(), peak, reps,
                bench=lambda: sa.scale_accum_const(w, s, hi_b, lo_b))
        else:
            c_b = c.clone()
            add(kernel, label,
                lambda: sa.scale_accum_const_plain(w, s, c.clone()),
                lambda: sa.scale_accum_const_plain_ref(w, s, c),
                nbytes(w, s) + 2 * nbytes(c), 3.0 * c.numel(), peak, reps,
                bench=lambda: sa.scale_accum_const_plain(w, s, c_b))

    def unscale_case(label, m, p, dtype, reps):
        x = torch.randn((1, m, p), generator=gen, device=dev, dtype=dtype)
        ra = torch.pow(2.0, torch.randint(-20, 20, (1, m), generator=gen,
                                          device=dev)).to(dtype)
        rb = torch.pow(2.0, torch.randint(-20, 20, (1, p), generator=gen,
                                          device=dev)).to(dtype)
        add("unscale", label, lambda: sa.unscale(x, ra, rb),
            lambda: sa.unscale_ref(x, ra, rb), nbytes(ra, rb) + 2 * nbytes(x),
            2.0 * x.numel(), F64_FLOPS if dtype == f64 else F32_FLOPS, reps)

    split_case("decode lm_head A (4x2048) f32 k=4", (SLOTS, d), f32, 4, 0,
               50)
    split_case("prefill A (128x2048) f32 k=4", (SLOTS * PROMPT, d), f32, 4,
               0, 50)
    split_case("freeze w_gate B (2048x8192) f32 k=4 axis=1", (d, f), f32, 4,
               1, 10)
    split_case("DGEMM A (4096x4096) f64 k=8", (4096, 4096), f64, 8, 0, 5)
    gemm_case("decode lm_head (4x2048x92672) G=4", SLOTS, d, vocab, 4, 5)
    gemm_case("decode w_gate (4x2048x8192) G=4", SLOTS, d, f, 4, 20)
    gemm_case("prefill w_gate (128x2048x8192) G=4", SLOTS * PROMPT, d, f, 4,
              10)
    gemm_case("decode scores (32 x 2x128x48) G=4", 2, 128, PROMPT + GEN, 4,
              50, batch=(SLOTS * 8,))
    gemm_case("DGEMM (4096^3) G=8", 4096, 4096, 4096, 8, 2)
    accum_case("scale_accum", "decode lm_head (4x92672)", SLOTS, vocab, f32,
               50)
    accum_case("scale_accum", "prefill w_gate (128x8192)", SLOTS * PROMPT,
               f, f32, 50)
    accum_case("scale_accum_plain", "DGEMM (4096x4096) f64", 4096, 4096, f64,
               20)
    accum_case("scale_accum_plain", "decode w_gate (4x8192) f32", SLOTS, f,
               f32, 50)
    i32, i64 = torch.int32, torch.int64
    const_case("scale_accum_const", "decode lm_head (4x92672)", SLOTS, vocab,
               i32, f32, 50)
    const_case("scale_accum_const", "(4096x4096)", 4096, 4096, i32, f32, 20)
    const_case("scale_accum_const_plain", "DGEMM (4096x4096) int64 word f64",
               4096, 4096, i64, f64, 20)
    const_case("scale_accum_const_plain",
               "decode lm_head (4x92672) int32 word f32", SLOTS, vocab, i32,
               f32, 50)
    unscale_case("DGEMM (4096x4096) f64", 4096, 4096, f64, 20)
    unscale_case("decode lm_head (4x92672) f32", SLOTS, vocab, f32, 50)
    return cases


# the first case of each kernel is the one its top-level record reports
MAIN_CASE = {"split_fused": "decode lm_head A (4x2048) f32 k=4",
             "group_gemm": "decode lm_head (4x2048x92672) G=4",
             "scale_accum": "decode lm_head (4x92672)",
             "scale_accum_plain": "DGEMM (4096x4096) f64",
             "scale_accum_const": "decode lm_head (4x92672)",
             "scale_accum_const_plain": "DGEMM (4096x4096) int64 word f64",
             "unscale": "decode lm_head (4x92672) f32"}

# the path whose launch count a kernel's record reports
MAIN_PATH = {"split_fused": "serve", "group_gemm": "serve",
             "scale_accum": "serve", "scale_accum_plain": "dgemm",
             "scale_accum_const": "serve_oz2",
             "scale_accum_const_plain": "dgemm_oz2", "unscale": "serve_oz2"}

# why no single PyTorch call is a library yardstick for a kernel
NO_LIBRARY = {
    "split_fused": "no one PyTorch call extracts k digits",
    "group_gemm": "torch._int_mm needs m > 16",
    "scale_accum": "no one PyTorch call does the int32 split and TwoSum",
    "scale_accum_plain": "convert and two scalings are separate calls",
    "scale_accum_const": "no one PyTorch call does the int32 split and "
                         "TwoSum",
    "scale_accum_const_plain": "the convert is a call of its own; "
                               "torch.add(c, word, alpha=s) takes s from "
                               "the host and may contract into an FMA",
    "unscale": "a two-sided scaling is two calls (or an outer product "
               "first)",
}

KERNELS = {
    "split_fused": ("src/repro_torch/kernels/csrc/split_fused.cu",
                    "src/repro/kernels/split_fused.py:102"),
    "group_gemm": ("src/repro_torch/kernels/csrc/group_gemm.cu",
                   "src/repro/kernels/group_gemm.py:58"),
    "scale_accum": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                    "src/repro/kernels/scale_accum.py:139"),
    "scale_accum_plain": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                          "src/repro/kernels/scale_accum.py:171"),
    "scale_accum_const": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                          "src/repro/kernels/scale_accum.py:222"),
    "scale_accum_const_plain": ("src/repro_torch/kernels/csrc/"
                                "scale_accum.cu",
                                "src/repro/kernels/scale_accum.py:246"),
    "unscale": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                "src/repro/kernels/scale_accum.py:197"),
}


def phase_kernels(dev):
    import torch
    from repro_torch.kernels import reset_launches
    results = {}
    for c in kernel_cases(dev):
        out_k, out_p = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        if not same(out_k, out_p):
            raise AssertionError(f"{c['kernel']} [{c['label']}]: kernel "
                                 f"output is not bitwise equal to the plain "
                                 f"version")
        del out_k, out_p
        ms = time_ms(c["bench"], c["reps"])
        plain_ms = time_ms(c["plain"], max(1, c["reps"] // 5))
        lib = c["library"]
        lib_ms = None if lib is None else time_ms(lib, c["reps"])
        b_ms, b_by = bound_ms(c["bytes"], c["ops"], c["peak"])
        results.setdefault(c["kernel"], []).append({
            "label": c["label"], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
        log(f"[kernels] {c['kernel']:17s} {c['label']:42s} bitwise ok  "
            f"{ms:9.4f} ms  plain {plain_ms:9.4f} ms  bound {b_ms:8.4f} ms "
            f"({b_by})  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    reset_launches()     # comparison launches do not count
    return results


# ---------------------------------------------------------------------------
# phase 3: DGEMM
# ---------------------------------------------------------------------------

def dgemm_inputs(dev):
    """The small input and the paper's phi = 0.5 inputs at n = 4096, the
    same for every DGEMM phase (one seed)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    f64 = torch.float64
    a = torch.randn((48, 200), generator=gen, device=dev, dtype=f64)
    b = torch.randn((200, 40), generator=gen, device=dev, dtype=f64)
    n = 4096
    mats = []
    for _ in range(2):
        u = torch.rand((n, n), generator=gen, device=dev, dtype=f64)
        z = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
        mats.append((u - 0.5) * torch.exp(0.5 * z))
    return (a, b), tuple(mats)


def phase_dgemm(dev, spec, kernels, tag="dgemm"):
    """``ozimmu_matmul`` under ``spec`` at n = 4096 against ``torch.matmul``
    in f64 (error <= 1e-8), after a small input that must equal the CPU
    plain-version pipeline; every kernel in ``kernels`` must launch."""
    import torch
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = parse_spec(spec)
    (a, b), (A, B) = dgemm_inputs(dev)
    small = ozimmu_matmul(a, b, cfg)
    small_cpu = ozimmu_matmul(a.cpu(), b.cpu(), cfg)
    if not same(small.cpu(), small_cpu):
        raise AssertionError(f"{tag}: the card's fused pipeline differs from "
                             f"the CPU plain-version pipeline")
    n = A.shape[0]
    ozimmu_matmul(A, B, cfg)                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    C = ozimmu_matmul(A, B, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    ref = torch.matmul(A, B)
    err = float((C - ref).abs().max() / ref.abs().max())
    ref_ms = time_ms(lambda: torch.matmul(A, B), 3)
    log(f"[{tag}] {spec} n={n}: {dt * 1e3:.1f} ms (torch.matmul f64 "
        f"{ref_ms:.2f} ms); max|C - A@B| / max|A@B| = {err:.3e}; small "
        f"input bitwise equal to the CPU pipeline; launches {counts}")
    if not math.isfinite(err) or err > 1e-8:
        raise AssertionError(f"{tag} error {err:.3e} above 1e-8")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    return counts, ref


def phase_dgemm_auto(dev, spec, ref):
    """One eager auto-k DGEMM: the planner probes the operands on the card;
    print the k it resolved and the error against ``ref``."""
    import torch
    from repro_torch.core import plan
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    _, (A, B) = dgemm_inputs(dev)
    plan.get_ledger().clear()
    t0 = time.perf_counter()
    C = ozimmu_matmul(A, B, parse_spec(spec))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d = plan.get_ledger().entries()[-1]
    err = float((C - ref).abs().max() / ref.abs().max())
    log(f"[dgemm_oz2] {spec} n={A.shape[0]}: resolved k={d.k} "
        f"({'probed' if d.probed else 'static'}, gaps {d.gap_a}/{d.gap_b}, "
        f"needs {d.needed_bits} bits, {d.int8_gemms} int8 GEMMs), "
        f"{dt * 1e3:.1f} ms with the probe; max|C - A@B| / max|A@B| = "
        f"{err:.3e}")
    if not math.isfinite(err) or err > 1e-8:
        raise AssertionError(f"{spec} error {err:.3e} above 1e-8")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def phase_serve(dev, spec, kernels, tag="serve"):
    """Serve full-width internlm2-1.8b under ``spec``; every kernel in
    ``kernels`` must launch."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime

    cfg = configs.get_config("internlm2_1_8b", engine_spec=spec)
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers (depth not cut), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; engine {spec}")
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(cfg, generator=gen, device=dev)
    rt = ServingRuntime(cfg, params, slots=SLOTS, max_len=PROMPT + GEN,
                        device=dev)
    torch.cuda.synchronize()
    st = rt.split_cache.stats
    log(f"[{tag}] init + weight freeze {time.perf_counter() - t0:.1f} s: "
        f"{st.misses} weight splits, {st.cached_bytes / 1e9:.2f} GB resident"
        f"; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT, dtype=np.int32)
               for _ in range(REQUESTS)]
    reset_launches()
    reqs = [rt.submit(p, GEN) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    sc = s["split_cache"]
    log(f"[{tag}] {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s p95 {s['ttft_s']['p95']:.3f} s; decode steps "
        f"{s['decode_steps']}, prefill calls {s['prefill_calls']}; "
        f"weight-split hit rate {sc['weight_split_hit_rate']:.3f}")
    log(f"[{tag}] kernel launches {counts}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    if s["requests"]["finished"] != REQUESTS or \
            s["tokens_generated"] != REQUESTS * GEN:
        raise AssertionError(f"{tag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    if sc["weight_split_hit_rate"] != 1.0:
        raise AssertionError(f"weight-split hit rate "
                             f"{sc['weight_split_hit_rate']}")

    # the runtime's contract: request 0 equals a monolithic greedy loop.
    # The loop keeps the runtime's slot width (request 0 in slot 0, the
    # other slots idle at cur = 0): PyTorch's CUDA reductions (the norm's
    # mean, the softmax sum) choose their summation order from the
    # tensor's shape, and every row is computed independently of the
    # others only at equal shapes.
    with torch.no_grad():
        cache = model.init_cache(cfg, SLOTS, PROMPT + GEN, device=dev)
        toks = list(prompts[0])
        feed = list(prompts[0])
        for t in range(PROMPT + GEN - 1):
            step_toks = torch.zeros((SLOTS, 1), dtype=torch.int32,
                                    device=dev)
            step_toks[0, 0] = int(feed[t])
            cur = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
            cur[0] = t + 1
            logits, cache = model.decode_step(rt.params, cfg, cache,
                                              step_toks, cur)
            if t + 1 >= PROMPT:
                nxt = int(torch.argmax(logits[0, -1, :cfg.vocab]))
                toks.append(nxt)
                feed.append(nxt)
    got = np.concatenate([reqs[0].prompt, np.asarray(reqs[0].generated)])
    if not np.array_equal(got, np.asarray(toks)):
        raise AssertionError(f"request 0 differs from the monolithic "
                             f"greedy loop:\n{got.tolist()}\n{toks}")
    log(f"[{tag}] request 0 equals the monolithic greedy loop: "
        f"{got[PROMPT:].tolist()}")

    # full-width prefill logits in f32 activations: the emulated engine
    # (presplit weights) against the native f32 engine on the same weights
    with torch.no_grad():
        tk = torch.from_numpy(prompts[1][None, :16]).to(dev)
        emu = model.forward(rt.params, cfg.with_(dtype="float32"),
                            {"tokens": tk})
        nat = model.forward(params, cfg.with_(dtype="float32",
                                              engine_spec="f32"),
                            {"tokens": tk})
    if not bool(torch.isfinite(emu).all()) or emu.shape != nat.shape:
        raise AssertionError("prefill logits not finite or misshapen")
    rel = float((emu - nat).abs().max() / nat.abs().max())
    log(f"[{tag}] prefill logits (1x16, f32 activations) vs the f32 engine: "
        f"max|diff| / max|logit| = {rel:.3e}")
    if rel > 1e-3:
        raise AssertionError(f"{tag}: emulated prefill logits off by "
                             f"{rel:.3e}")
    del rt, params, emu, nat, cache
    torch.cuda.empty_cache()
    return counts, s


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import _build
    t_start = t0 = time.perf_counter()
    seconds = _build.build(verbose=True)
    log(f"[build] {len(seconds)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in seconds.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    kern = phase_kernels(dev)
    paths = {}
    paths["dgemm"], _ = phase_dgemm(
        dev, DGEMM_SPEC, ("split_fused", "group_gemm", "scale_accum_plain"))
    paths["dgemm_oz2"], ref = phase_dgemm(
        dev, OZ2_DGEMM_SPEC, ("split_fused", "group_gemm",
                              "scale_accum_const_plain", "unscale"),
        tag="dgemm_oz2")
    phase_dgemm_auto(dev, OZ2_AUTO_SPEC, ref)
    del ref
    paths["serve"], _ = phase_serve(
        dev, MODEL_SPEC, ("split_fused", "group_gemm", "scale_accum"))
    paths["serve_oz2"], _ = phase_serve(
        dev, OZ2_MODEL_SPEC, ("split_fused", "group_gemm",
                              "scale_accum_const", "unscale"),
        tag="serve_oz2")

    records = []
    for name, (source, replaces) in KERNELS.items():
        main_rec = next(r for r in kern[name] if r["label"] == MAIN_CASE[name])
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[MAIN_PATH[name]][name],
            "main_path": MAIN_PATH[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "case": main_rec["label"], "cases": kern[name]}
        if rec["library_ms"] is None:
            rec["library_none_reason"] = NO_LIBRARY[name]
        records.append(rec)
    log(f"[total] wall time {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
