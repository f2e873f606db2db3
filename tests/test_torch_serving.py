"""The port's dense model and serving runtime against the reference.

internlm2-1.8b ``smoke()`` config, weights initialized by the JAX model and
carried across with ``params_from_numpy``.

Tolerance.  The emulated contractions are bitwise equal across the two
packages (tests/test_torch_ozimmu.py), but exp (softmax), rsqrt
(RMSNorm), pow/sin/cos (RoPE) and the native f32 matmul differ by an ulp
or so between XLA and PyTorch, and the differences pass through later
layers.  With f32 activations the logits agree to
``max|diff| <= 1e-4 * max|logit|``.  With the published bf16 activations
XLA rounds a fused chain of elementwise ops once where PyTorch rounds
every op, so single bf16 ulps (2^-8 relative) differ and the bound is
``2e-2 * max|logit|``.  Greedy tokens must be identical in every case.

The reference side runs ``ozimmu_h-4:df32`` (its XLA path, jitted); the
port runs ``ozimmu_h-4:df32:fused`` through its kernels' plain versions.
The reference holds its ``:fused`` path bit-identical to the XLA path
(tests/test_fused_pipeline.py), and its interpret-mode Pallas kernels
would triple this file's time.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro.models import api as R_api
from repro_torch import configs as P_configs
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "f32": "f32"}


@pytest.fixture(scope="module")
def ref_params():
    cfg = R_configs.get_config("internlm2_1_8b", smoke=True)
    params, _ = R_api.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("spec", [FUSED, "f32"])
def test_prefill_and_decode_logits_f32_activations(ref_params, spec):
    rparams, nparams = ref_params
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=REF_SPEC[spec], dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec, dtype="float32")
    rm, pm = R_api.get_model(rcfg), P_api.get_model(pcfg)
    pparams = params_from_numpy(nparams, device="cpu")
    toks = _tokens(rcfg.vocab, (2, 8))
    V = rcfg.vocab

    ref = np.asarray(jax.jit(lambda p, t: rm.forward(
        p, rcfg, {"tokens": t}))(rparams, jnp.asarray(toks)))
    out = pm.forward(pparams, pcfg, {"tokens": torch.from_numpy(toks)})
    out = out.numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-4
    np.testing.assert_array_equal(out[..., :V].argmax(-1),
                                  ref[..., :V].argmax(-1))

    step = jax.jit(lambda p, c, t, n: rm.decode_step(p, rcfg, c, t, n))
    rc = rm.init_cache(rcfg, 2, 16)
    pc = pm.init_cache(pcfg, 2, 16, device="cpu")
    for i in range(3):
        cur = np.asarray([i + 1, i + 1], np.int32)
        rl, rc = step(rparams, rc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(cur))
        pl, pc = pm.decode_step(pparams, pcfg, pc,
                                torch.from_numpy(toks[:, i:i + 1]),
                                torch.from_numpy(cur))
        rl, pl = np.asarray(rl), pl.numpy()
        assert _rel(pl, rl) <= 1e-4
        np.testing.assert_array_equal(pl[..., :V].argmax(-1),
                                      rl[..., :V].argmax(-1))
    np.testing.assert_allclose(pc["k"].float().numpy(),
                               np.asarray(rc["k"], np.float32),
                               rtol=1e-2, atol=1e-2)


def test_prefill_logits_bf16_activations(ref_params):
    """The published smoke config as is (bf16 activations)."""
    rparams, nparams = ref_params
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=REF_SPEC[FUSED])
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=FUSED)
    toks = _tokens(rcfg.vocab, (2, 8))
    ref = np.asarray(jax.jit(lambda p, t: R_api.get_model(rcfg).forward(
        p, rcfg, {"tokens": t}))(rparams, jnp.asarray(toks)))
    out = P_api.get_model(pcfg).forward(
        params_from_numpy(nparams, device="cpu"), pcfg,
        {"tokens": torch.from_numpy(toks)}).numpy()
    assert _rel(out, ref) <= 2e-2
    V = rcfg.vocab
    np.testing.assert_array_equal(out[..., :V].argmax(-1),
                                  ref[..., :V].argmax(-1))


def test_init_matches_reference_layout(ref_params):
    """The port's own init (torch.Generator) has the reference's tree,
    shapes, dtypes and dense_param scale rule."""
    _, nparams = ref_params
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    mine = P_api.get_model(cfg).init(cfg, generator=gen, device="cpu")

    def walk(a, b, path=()):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for key in b:
                walk(a[key], b[key], path + (key,))
            return
        assert tuple(a.shape) == b.shape, path
        assert a.dtype == torch.float32, path
        if np.any(b):
            assert b.dtype == np.float32, path
            std_a, std_b = float(a.std()), float(b.std())
            assert abs(std_a / std_b - 1.0) < 0.15, (path, std_a, std_b)
        else:  # the norm weights are zeros in both (f64 in the reference
            # under x64, which its rmsnorm casts to f32)
            assert not torch.any(a), path

    walk(mine, nparams)


def test_runtime_equals_monolithic_greedy_loop():
    """The runtime contract of the reference (tests/test_serving.py):
    continuous batching with chunked prefill produces, per request, the
    tokens of a per-request monolithic greedy decode loop."""
    from repro_torch.serving import ServingRuntime
    from repro_torch.serving.presplit import wrappable_paths
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                               engine_spec=FUSED)
    model = P_api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    prompts = [_tokens(cfg.vocab, (8,), seed=s) for s in range(3)]
    gen, max_len = 4, 32

    def monolithic(prompt):
        cache = model.init_cache(cfg, 1, max_len, device="cpu")
        out = list(prompt)
        for t, tok in enumerate(prompt):
            logits, cache = model.decode_step(
                params, cfg, cache, torch.tensor([[tok]]), torch.tensor(t + 1))
        for g in range(gen):
            nxt = int(torch.argmax(logits[0, -1, :cfg.vocab]))
            out.append(nxt)
            logits, cache = model.decode_step(
                params, cfg, cache, torch.tensor([[nxt]]),
                torch.tensor(len(prompt) + g + 1))
        return np.asarray(out)

    rt = ServingRuntime(cfg, params, slots=2, max_len=max_len,
                        prefill_chunk=4, device="cpu")
    outs = rt.generate([p.copy() for p in prompts], gen)
    for o, p in zip(outs, prompts):
        np.testing.assert_array_equal(o, monolithic(p))
    s = rt.metrics.summary()
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 12
    assert s["prefill_chunks"] > 0 and s["decode_steps"] > 0
    sc = s["split_cache"]
    assert sc["weight_split_hit_rate"] == 1.0
    assert sc["misses"] == len(wrappable_paths(params))


def test_entry_points_raise_without_a_card():
    """No device given and no GPU: the port never falls back to the CPU."""
    from repro_torch.serving import ServingRuntime
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card path is not "
                    "reachable")
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingRuntime(cfg, {}, slots=1, max_len=8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--slots", "1"])


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2", "ozimmu_h-auto:df32"])
def test_runtime_tokens_match_reference(ref_params, spec):
    """Ozaki-II and auto-k serving: the port's runtime (``:fused``, the
    kernels' plain versions) gives the reference runtime's greedy tokens,
    and every frozen weight split has the k of the reference's static plan
    (what its jitted step resolves).  f32 activations, as above."""
    from repro.core import split_cache as R_sc
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch.serving import ServingRuntime
    rparams, nparams = ref_params
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec, dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec + ":fused",
                                dtype="float32")
    prompts = [_tokens(rcfg.vocab, (8,), seed=s) for s in range(3)]
    rrt = RRuntime(rcfg, rparams, slots=2, max_len=32)
    refs = rrt.generate([p.copy() for p in prompts], 4)
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=32, device="cpu")
    outs = prt.generate([p.copy() for p in prompts], 4)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    static_k = R_sc.resolved_k(rcfg.engine.ozimmu_config, rcfg.d_model,
                               np.float32)
    for name in ("lm_head",):
        assert prt.params[name].k == rrt.params[name].k == static_k
    for name, w in prt.params["layers"].items():
        if hasattr(w, "k"):
            assert w.k == rrt.params["layers"][name].k, name
    assert prt.metrics.summary()["split_cache"][
        "weight_split_hit_rate"] == 1.0


def test_runtime_oz2_plain_slot_hygiene():
    """The port's counterpart of the reference's
    ``test_runtime_matches_reference_oz2``: plain oz2 takes ONE digit grid
    per operand, so a stray cache row of an idle or warming-up slot would
    move every other slot's digits.  With 2 slots the tokens equal a
    per-request greedy loop."""
    from repro_torch.serving import ServingRuntime
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                               engine_spec="oz2_h-4:df32:fast:fused")
    model = P_api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    prompts = [_tokens(cfg.vocab, (8,), seed=s) for s in range(3)]

    def reference(prompt):
        cache = model.init_cache(cfg, 1, 64, device="cpu")
        for t, tok in enumerate(prompt):
            logits, cache = model.decode_step(
                params, cfg, cache, torch.tensor([[tok]]), torch.tensor(t + 1))
        out = list(prompt)
        cur = int(torch.argmax(logits[0, -1, :cfg.vocab]))
        for g in range(3):
            out.append(cur)
            logits, cache = model.decode_step(
                params, cfg, cache, torch.tensor([[cur]]),
                torch.tensor(len(prompt) + g + 1))
            cur = int(torch.argmax(logits[0, -1, :cfg.vocab]))
        return np.asarray(out)

    rt = ServingRuntime(cfg, params, slots=2, max_len=64, device="cpu")
    outs = rt.generate([p.copy() for p in prompts], 3)
    for o, p in zip(outs, prompts):
        np.testing.assert_array_equal(o, reference(p))


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2",
                                  "ozimmu_h-auto:df32:prob"])
def test_launcher_serves_and_prints_plan(spec, capsys):
    """``python -m repro_torch.launch.serve --engine <spec>`` serves the
    Ozaki-II and auto-k specs and prints the engine's plan
    (``plan.describe_config``) first."""
    from repro_torch.core import ozimmu, plan
    from repro_torch.launch import serve
    s = serve.main(["--slots", "2", "--requests", "3", "--prompt-len", "6",
                    "--gen", "3", "--max-len", "16", "--engine", spec,
                    "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    lines = capsys.readouterr().out.splitlines()
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    assert lines[0] == (f"[serve] engine {spec}: " + plan.describe_config(
        ozimmu.parse_spec(spec), cfg.d_model, cfg.d_model, cfg.d_model))


def test_auto_k_serving_takes_the_reference_static_plan(ref_params):
    """``ozimmu_h-auto:df32`` served by both runtimes: the reference's
    steps are jitted, so its planner sees tracers and takes the static
    mantissa-coverage plan for every contraction.  The port's runtime runs
    its steps inside ``plan.static_plan()``: every decision it records
    there is static, each contraction shape resolves the reference's k,
    the greedy tokens are equal, and the prefill logits of the runtimes'
    step (teacher-forced, the frozen weight splits) agree to the f32
    bound above."""
    from repro.core import plan as R_plan
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch.core import plan as P_plan
    from repro_torch.serving import ServingRuntime
    spec = "ozimmu_h-auto:df32"
    rparams, nparams = ref_params
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec, dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec + ":fused",
                                dtype="float32")
    prompts = [_tokens(rcfg.vocab, (8,), seed=s) for s in range(3)]

    def contractions(ledger):
        return [d for d in ledger.entries() if d.source == "contraction"]

    R_plan.get_ledger().clear()
    rrt = RRuntime(rcfg, rparams, slots=2, max_len=32)
    refs = rrt.generate([p.copy() for p in prompts], 4)
    ref_k = {(d.m, d.n, d.p): d.k for d in contractions(R_plan.get_ledger())}
    assert ref_k and not any(d.probed for d in
                             contractions(R_plan.get_ledger()))

    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=32, device="cpu")
    P_plan.get_ledger().clear()
    outs = prt.generate([p.copy() for p in prompts], 4)
    mine = contractions(P_plan.get_ledger())
    assert mine and not any(d.probed for d in mine)
    port_k = {(d.m, d.n, d.p): d.k for d in mine}
    assert port_k == ref_k
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)

    rm, pm = R_api.get_model(rcfg), P_api.get_model(pcfg)
    step = jax.jit(lambda p, c, t, n: rm.decode_step(p, rcfg, c, t, n))
    toks = np.stack(prompts[:2])
    rc = rm.init_cache(rcfg, 2, 16)
    pc = pm.init_cache(pcfg, 2, 16, device="cpu")
    P_plan.get_ledger().clear()
    for i in range(toks.shape[1]):
        cur = np.asarray([i + 1, i + 1], np.int32)
        rl, rc = step(rrt.params, rc, jnp.asarray(toks[:, i:i + 1]),
                      jnp.asarray(cur))
        with P_plan.static_plan(), torch.no_grad():
            pl, pc = pm.decode_step(prt.params, pcfg, pc,
                                    torch.from_numpy(toks[:, i:i + 1]),
                                    torch.from_numpy(cur))
        assert _rel(pl.numpy(), np.asarray(rl)) <= 1e-4
    assert not any(d.probed for d in contractions(P_plan.get_ledger()))
