"""The port's vlm family (llama-3.2-vision-11b) against the reference.

``smoke()`` config (2 groups of 1 self + 1 gated cross layer, d 64, 4
query heads of 16 on 2 KV heads, SwiGLU of 96, vocab 256, vision_seq
16), weights initialized by the JAX model and carried across with
``params_from_numpy``; activations f32 unless a test says otherwise.

A vacuous cross path is the trap here: the reference initializes both
gates to zero, so every cross layer is the identity whatever the context.
The fixture draws the gates from a seed (nonzero) on both sides, the
context (patch embeddings) is drawn from a seed, and a control in the
model, decode and runtime tests requires a second context to move the
result past the tolerance.

What is held, and how tightly:

* the parameter tree (``groups/selfs`` stacked (groups, selfs, ...)), the
  cache leaves, dtypes (bf16 cross K/V) and logical axes equal to the
  reference's; the slot cache's select and reset on both slot axes (2 for
  ``k``/``v``, 1 for ``cross_k``/``cross_v``);
* every emulated contraction of ``cross_kv`` and ``cross_block``
  bitwise: the reference's engine calls are recorded and each is
  re-evaluated by the port's engine on the reference's operands, the
  port's own block making the same calls; also with the memory in two
  key chunks, the second padded (``vision_seq`` 1600 over ``kv_chunk``
  1024 at full width), whose padded keys must not count;
* ``forward`` within ``1e-4 * max|logit|`` under ``f32`` and ``:fused``
  (``2e-2`` in bf16 activations); the ``init_cache`` -> ``decode_step``
  loop against the reference's within 1e-4 with equal greedy tokens, and
  against the port's ``forward`` at the reference's ``DECODE_TOL["vlm"]``;
* the runtime's greedy tokens with a context, whole-prompt and chunked,
  equal to the reference runtime's;
* the launch counts a model step and at context time, and the launcher.

The reference side of a comparison under ``ozimmu_h-4:df32:fused`` runs
``ozimmu_h-4:df32`` (its XLA path), whose contractions the reference
holds bit-identical to ``:fused`` (``tests/test_fused_pipeline.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro.core import engine as R_engine
from repro.models import api as R_api
from repro.models import common as R_common
from repro.models import vlm as R_vlm
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.core import engine as P_engine
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import transformer as P_T
from repro_torch.models import vlm as P_vlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit
from tests.torch_parity import contractions_bitwise

torch.set_num_threads(1)

ARCH = "llama32_vision_11b"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "ozimmu_h-4:df32": "ozimmu_h-4:df32",
            "f32": "f32"}
DECODE_TOL_VLM = 2e-2          # the reference's DECODE_TOL["vlm"]


def _cfgs(spec, dtype="float32", **kw):
    rcfg = R_configs.get_config(ARCH, smoke=True,
                                engine_spec=REF_SPEC.get(spec, spec),
                                dtype=dtype, **kw)
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype=dtype, **kw)
    return rcfg, pcfg


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init (jitted), its zero gates replaced by gates
    drawn from a seed, tanh(gate) in +-[0.46, 0.91]."""
    cfg = R_configs.get_config(ARCH, smoke=True)
    model = R_api.get_model(cfg)
    params = jax.jit(lambda k: model.init(k, cfg)[0])(jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    cross = nparams["groups"]["cross"]
    for g in ("gate_attn", "gate_mlp"):
        assert not cross[g].any()                 # the reference's init
        cross[g] = (rng.uniform(0.5, 1.5, cross[g].shape) * rng.choice(
            [-1.0, 1.0], cross[g].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, nparams), nparams


def _context(cfg, batch=1, seed=2):
    """Patch embeddings (batch, vision_seq, d) drawn from a seed."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vision_seq, cfg.d_model)).astype(np.float32)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# every emulated contraction, bitwise
# ---------------------------------------------------------------------------

def _cross_layer(nparams, g=1):
    return jax.tree.map(lambda a: a[g], nparams["groups"]["cross"])


@pytest.mark.parametrize("kv_chunk", [64, 12], ids=["one_chunk", "ragged"])
def test_cross_block_contractions_bitwise(monkeypatch, ref_params, kv_chunk):
    """``cross_kv`` and ``cross_block`` of group 1 on a drawn memory: 7
    projections and the two attention contractions a key chunk, each
    bitwise; the block's output within 1e-5 of max|y|.  With
    ``kv_chunk`` 12 the 16 memory rows take two chunks, the second padded
    to 24 rows: the port's output equals its one-chunk output within
    1e-6 (the padded keys never count)."""
    _, nparams = ref_params
    spec = FUSED
    rcfg, pcfg = _cfgs(spec, kv_chunk=kv_chunk)
    lp = _cross_layer(nparams)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    mem = _context(rcfg, batch=2, seed=5)
    rp = jax.tree.map(jnp.asarray, lp)
    pp = params_from_numpy(lp, device="cpu")
    _, (pk, pv), n = contractions_bitwise(
        monkeypatch, REF_SPEC[spec],
        lambda: R_vlm.cross_kv(rp, rcfg, jnp.asarray(mem)),
        lambda: P_vlm.cross_kv(pp, pcfg, torch.from_numpy(mem)))
    assert n == 2 and tuple(pk.shape) == (2, 16, 2, 16)
    ref, out, n = contractions_bitwise(
        monkeypatch, REF_SPEC[spec],
        lambda: R_vlm.cross_block(rp, rcfg, jnp.asarray(x), jnp.asarray(mem)),
        lambda: P_vlm.cross_block(pp, pcfg, torch.from_numpy(x),
                                  torch.from_numpy(mem)))
    assert n == 7 + 2 * -(-rcfg.vision_seq // kv_chunk)
    assert _rel(out.numpy(), ref) <= 1e-5
    with torch.no_grad():
        one = P_vlm.cross_block(pp, pcfg.with_(kv_chunk=64),
                                torch.from_numpy(x), torch.from_numpy(mem))
        cached = P_vlm.cross_block(pp, pcfg, torch.from_numpy(x), None,
                                   kv_cache=(pk, pv))
    assert _rel(out.numpy(), one.numpy()) <= 1e-6
    assert torch.equal(cached, out)


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree (``groups/selfs``
    stacked (groups, selfs, ...), ``groups/cross`` (groups, ...), 0-d gates
    stacked to (groups,)), shapes, f32 dtypes, scale rule and zero gates;
    ``params_from_numpy`` carries the reference tree across unchanged; and
    the split cache would freeze exactly the reference's paths (the cross
    layers' ``wk``/``wv`` among them, never a gate or a norm)."""
    rparams, nparams = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True)
    mine = P_api.get_model(cfg).init(cfg, generator=torch.Generator(
        ).manual_seed(0), device="cpu")
    carried = params_from_numpy(nparams, device="cpu")

    def walk(a, b, c, path=()):
        if isinstance(b, dict):
            assert set(a) == set(b) == set(c), path
            for key in b:
                walk(a[key], b[key], c[key], path + (key,))
            return
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, path
        np.testing.assert_array_equal(c.numpy(), b)
        if path[-1].startswith("gate_") or path[-1].startswith("ln"):
            assert not torch.any(a), path
        else:
            ratio = float(a.std()) / float(b.std())
            assert abs(ratio - 1.0) < 0.15, (path, ratio)

    walk(mine, nparams, carried)
    assert tuple(mine["groups"]["selfs"]["attn"]["wq"].shape) == (2, 1, 64,
                                                                  64)
    assert tuple(mine["groups"]["cross"]["gate_attn"].shape) == (2,)
    assert P_common.param_count(mine) == R_common.param_count(rparams)
    want = sorted(R_presplit.wrappable_paths(rparams))
    assert sorted(P_presplit.wrappable_paths(carried)) == want
    assert ("groups", "cross", "attn", "wk") in want and len(want) == 15


def test_cache_layout_and_slot_ops(ref_params):
    """``init_cache``'s leaves and ``cache_axes`` equal the reference's,
    without a context (zeros) and with one (the cross K/V projected per
    group through carried weights, bf16, within one bf16 rounding of the
    reference's); the slot cache selects and resets by each leaf's own
    slot axis (2 for ``k``/``v``, 1 for ``cross_k``/``cross_v``)."""
    from repro_torch.serving.kvcache import SlotCacheOps
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    ctx = _context(rcfg, batch=3)
    ref = jax.jit(lambda c: rmodel.init_cache(rcfg, 3, 8, params=rparams,
                                              ctx=c))(jnp.asarray(ctx))
    got = pmodel.init_cache(pcfg, 3, 8,
                            params=params_from_numpy(nparams, device="cpu"),
                            ctx=torch.from_numpy(ctx))
    empty = pmodel.init_cache(pcfg, 3, 8, device="cpu")
    assert set(got) == set(ref) == set(empty)
    for name in ref:
        assert tuple(got[name].shape) == tuple(empty[name].shape) == \
            ref[name].shape, name
        assert got[name].dtype == torch.bfloat16, name
        assert str(ref[name].dtype) == "bfloat16", name
        assert not empty[name].any()
        r = np.asarray(ref[name].astype(jnp.float32))
        assert np.abs(got[name].float().numpy() - r).max() <= \
            2.0 ** -7 * max(np.abs(r).max(), 1e-30), name
    assert tuple(got["cross_k"].shape) == (2, 3, 16, 2, 16)
    assert got["cross_k"].any() and got["cross_v"].any()
    assert pmodel.cache_axes(pcfg) == rmodel.cache_axes(rcfg)
    ops = SlotCacheOps(pcfg, pmodel)
    assert ops._slot_axis == {"k": 2, "v": 2, "cross_k": 1, "cross_v": 1}
    ones = {k: torch.ones_like(v) for k, v in empty.items()}
    ops.reset_slot(ones, 1, pmodel.init_cache(pcfg, 1, 8, device="cpu"))
    sel = ops.select_slots(empty, ones, torch.tensor([True, False, False]))
    for name, ax in ops._slot_axis.items():
        assert not ones[name].select(ax, 1).any()
        assert ones[name].select(ax, 0).all()
        assert not sel[name].narrow(ax, 0, 2).any()
        assert sel[name].select(ax, 2).all()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_fns(ref_params):
    """The reference's jitted forward and decode step, one compile per
    (spec, activation dtype) for the whole module."""
    rparams, _ = ref_params
    fns = {}

    def get(kind, spec, dtype):
        key = (kind, spec, dtype)
        if key not in fns:
            rcfg, _ = _cfgs(spec, dtype=dtype)
            model = R_api.get_model(rcfg)
            fns[key] = jax.jit(
                (lambda t, c: model.forward(rparams, rcfg, {
                    "tokens": t, "image_embeds": c})) if kind == "forward"
                else (lambda c, t, n: model.decode_step(rparams, rcfg, c, t,
                                                        n)))
        return fns[key]
    return get


def _port_forward(nparams, pcfg, toks, ctx):
    with torch.no_grad():
        return P_api.get_model(pcfg).forward(
            params_from_numpy(nparams, device="cpu"), pcfg,
            {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(ctx)}).numpy()


@pytest.mark.parametrize("spec,dtype,tol", [
    ("f32", "float32", 1e-4), (FUSED, "float32", 1e-4),
    (FUSED, "bfloat16", 2e-2)], ids=["f32", "fused", "fused-bf16"])
def test_forward_logits_match_reference(ref_params, ref_fns, spec, dtype,
                                        tol):
    """Logits within ``tol * max|logit|``; in f32 activations the greedy
    tokens equal at every position.  Control: a second context moves the
    port's logits by more than ``tol``."""
    _, nparams = ref_params
    rcfg, pcfg = _cfgs(spec, dtype=dtype)
    toks = _tokens(rcfg.vocab, (2, 8))
    ctx = _context(rcfg, batch=2)
    ref = np.asarray(ref_fns("forward", spec, dtype)(jnp.asarray(toks),
                                                     jnp.asarray(ctx)))
    out = _port_forward(nparams, pcfg, toks, ctx)
    assert out.shape == ref.shape == (2, 8, 256)
    assert np.isfinite(out).all() and _rel(out, ref) <= tol
    if dtype == "float32":
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    other = _port_forward(nparams, pcfg, toks,
                          _context(rcfg, batch=2, seed=9))
    assert _rel(other, out) > 10 * tol


def _decode_loop(model, params, cfg, cache, toks, step=None):
    """Teacher-forced decode over every position of ``toks``; returns the
    logits (B, L, vocab) as numpy."""
    outs = []
    for t in range(toks.shape[1]):
        if step is None:
            with torch.no_grad():
                logits, cache = model.decode_step(
                    params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                    torch.tensor(t + 1))
            outs.append(logits[:, 0].numpy())
        else:
            logits, cache = step(cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(t + 1, jnp.int32))
            outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_decode_loop_matches_reference(ref_params, ref_fns, dtype, tol):
    """``init_cache`` with the context, then 8 teacher-forced
    ``decode_step``s under ``:fused``, against the reference's (its decode
    jitted): logits within ``tol`` at every position, greedy tokens equal
    in f32 activations; and against the port's ``forward`` at the
    reference's ``DECODE_TOL["vlm"]``.  Control: under a second context
    the decode logits move by more than ``tol``."""
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED, dtype=dtype)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    params = params_from_numpy(nparams, device="cpu")
    toks = _tokens(rcfg.vocab, (2, 8), seed=5)
    ctx = _context(rcfg, batch=2)
    cache = jax.jit(lambda c: rmodel.init_cache(
        rcfg, 2, 8, params=rparams, ctx=c))(jnp.asarray(ctx))
    ref = _decode_loop(None, None, None, cache, toks,
                       ref_fns("decode", FUSED, dtype))

    def port(ctx):
        cache = pmodel.init_cache(pcfg, 2, 8, params=params,
                                  ctx=torch.from_numpy(ctx))
        return _decode_loop(pmodel, params, pcfg, cache, toks)
    got = port(ctx)
    assert _rel(got, ref) <= tol
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        with torch.no_grad():
            fwd = pmodel.forward(params, pcfg, {
                "tokens": torch.from_numpy(toks),
                "image_embeds": torch.from_numpy(ctx)}).numpy()
        assert _rel(got, fwd) <= DECODE_TOL_VLM
    assert _rel(port(_context(rcfg, batch=2, seed=9)), got) > 10 * tol


def test_zero_gates_make_the_context_vacuous(ref_params):
    """Why the tests draw the gates: with the reference's zero gates every
    cross layer is the identity, and two contexts give the same logits
    bit for bit."""
    _, nparams = ref_params
    _, pcfg = _cfgs("f32")
    params = params_from_numpy(nparams, device="cpu")
    for g in ("gate_attn", "gate_mlp"):
        params["groups"]["cross"][g] = torch.zeros(2)
    toks = torch.from_numpy(_tokens(pcfg.vocab, (1, 6)))
    with torch.no_grad():
        a, b = (P_api.get_model(pcfg).forward(params, pcfg, {
            "tokens": toks, "image_embeds": torch.from_numpy(
                _context(pcfg, seed=s))}) for s in (2, 9))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runtime_tokens(ref_params):
    """The reference runtime's greedy tokens (``ozimmu_h-4:df32``, f32
    activations, 2 slots, max_len 16) for three prompts, with the drawn
    context; the prompts share one pow2 bucket (one prefill compile)."""
    from repro.serving import ServingRuntime as RRuntime
    rparams, _ = ref_params
    rcfg, _ = _cfgs(FUSED)
    prompts = [_tokens(rcfg.vocab, (n,), seed=3 + n) for n in (5, 7, 6)]
    ctx = jnp.asarray(_context(rcfg))
    refs = RRuntime(rcfg, rparams, slots=2, max_len=16, ctx=ctx).generate(
        [p.copy() for p in prompts], 4)
    return prompts, refs


@pytest.mark.parametrize("chunk", [None, 3], ids=["whole", "chunked"])
def test_runtime_tokens_match_reference(ref_params, ref_runtime_tokens,
                                        chunk):
    """The port's runtime (``:fused``, 2 slots, a context; prompts of 5, 7
    and 6 in the pow2 bucket of 8, with ``prefill_chunk=3`` decode steps
    beside mid-prefill slots) gives the reference runtime's greedy tokens; the
    weight-split hit rate is 1.0.  Control: under a second context the
    continuations differ."""
    from repro_torch.launch.serve import make_runtime
    _, nparams = ref_params
    _, pcfg = _cfgs(FUSED)
    prompts, refs = ref_runtime_tokens

    def serve(seed):
        rt = make_runtime(pcfg, params_from_numpy(nparams, device="cpu"),
                          slots=2, max_len=16, prefill_chunk=chunk,
                          ctx=torch.from_numpy(_context(pcfg, seed=seed)),
                          device="cpu")
        return rt, rt.generate([p.copy() for p in prompts], 4)

    rt, outs = serve(2)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert rt.sched.bucket_fn(5) == 8                 # pow2 buckets
    s = rt.metrics.summary()
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert (s["prefill_chunks"] > 0) == (chunk is not None)
    if chunk is None:
        _, other = serve(9)
        assert any(not np.array_equal(a, b) for a, b in zip(other, outs))


def test_launch_counts(monkeypatch):
    """Under ``:fused`` with the weight splits frozen.  At context time
    (the runtime's construction) each group's cross ``wk``/``wv`` contract
    the ``vision_seq`` memory rows: 4 group GEMMs each, on the large
    route, for the single-slot template and again for the slot cache.  A
    model step: 11 splits and 9 contractions a self layer (7 projection A
    sides, both sides of the 2 attention products); a cross layer 5
    projections (``wq``, ``wo``, the MLP's 3) plus, a key chunk of the
    cached cross K/V, the scores and p@v (both sides split); the LM
    head's.  4 group GEMMs (skinny: 4 slots, 2 query heads a KV head) and
    one df32 epilogue a contraction.  ``kv_chunk`` 12 takes the 16 cross
    rows in 2 chunks, as the published 1600 rows take 2 of 1024.  Counted
    at the kernel wrappers, on the CPU."""
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf
    from repro_torch.serving import ServingRuntime
    counts = {"split": 0, "group_gemm": 0, "epilogue": 0, "large": 0}

    def counting(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            counts[key] += 1
            if key == "group_gemm":
                counts["large"] += gg.route(a[0].shape[-2], True) == "large"
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    counting(sf, "split_whole", "split")
    counting(gg, "group_gemm", "group_gemm")
    counting(sa, "scale_accum_chunks", "epilogue")
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=FUSED,
                               kv_chunk=12)
    model = P_api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    ng = cfg.n_layers // cfg.cross_every
    rt = ServingRuntime(cfg, params, slots=4, max_len=8,
                        ctx=torch.ones((1, cfg.vision_seq, cfg.d_model)),
                        device="cpu")
    context = ng * 2 * 2
    assert counts["group_gemm"] == counts["large"] == context * 4
    assert counts["epilogue"] == context
    counts.update(split=0, group_gemm=0, epilogue=0, large=0)
    with torch.no_grad():
        model.decode_step(rt.params, cfg, rt.cache,
                          torch.zeros((4, 1), dtype=torch.int32),
                          torch.tensor([1, 1, 0, 0], dtype=torch.int32))
    n_self, nk = cfg.cross_every - 1, -(-cfg.vision_seq // cfg.kv_chunk)
    assert nk == 2
    c = ng * (n_self * 9 + 5 + 2 * nk) + 1
    assert counts == {"split": ng * (n_self * 11 + 5 + 4 * nk) + 1,
                      "group_gemm": c * 4, "epilogue": c, "large": 0}


def test_launcher_serves_the_vlm_arch(capsys):
    """``python -m repro_torch.launch.serve --arch llama32_vision_11b``
    serves the smoke config with the reference's static context (zero
    patch embeddings: ``slot_context``)."""
    from repro_torch.launch import serve
    cfg = P_configs.get_config(ARCH, smoke=True)
    ctx = serve.slot_context(cfg, {"embed": torch.zeros(1)}, 5)
    assert tuple(ctx.shape) == (1, 16, 64) and not ctx.any()
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out


def test_frozen_cross_projection_bitwise(ref_params):
    """``engine(mn, wk)`` of group 1's cross layer with ``wk`` frozen by
    ``wrap_params`` on the (groups, n, p) stack and sliced as the group
    loop slices it, bit for bit against the reference's engine on the
    plain weight (the context-time projection of the runtime)."""
    _, nparams = ref_params
    w = nparams["groups"]["cross"]["attn"]["wk"]
    x = np.random.default_rng(8).standard_normal((1, 16, 64)).astype(
        np.float32)
    ref = np.asarray(R_engine.make_engine("ozimmu_h-4:df32")(
        jnp.asarray(x), jnp.asarray(w[1])))
    eng = P_engine.make_engine(FUSED)
    tree, _ = P_presplit.wrap_params(
        {"groups": {"cross": {"attn": {"wk": torch.from_numpy(
            np.array(w))}}}}, eng)
    w_p = P_T.layer_params(tree["groups"], 1)["cross"]["attn"]["wk"]
    assert tuple(w_p.digits.shape) == (4, 64, 32)
    out = eng(torch.from_numpy(x), w_p).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
