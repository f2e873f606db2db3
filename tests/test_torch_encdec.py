"""The port's encdec family (seamless-m4t-medium) against the reference.

``smoke()`` config (2 encoder and 2 decoder layers, d 64, 4 heads of 16,
GELU MLP of 96, vocab 256), weights initialized by the JAX model and
carried across with ``params_from_numpy``; activations f32 unless a test
says otherwise.

A vacuous cross path is the trap here: the reference's serving context
(``slot_context``) runs the encoder over zero frames, whose output is
``rmsnorm(0) = 0``, so its cross K/V are zero and the cross-attention adds
nothing.  The tests draw the frames from a seed, and a control in the
model, decode and runtime tests requires second frames to move the result
past the tolerance.

What is held, and how tightly:

* the parameter tree (``enc_layers``, ``dec_layers`` stacked), the cache
  leaves (bf16, the cross length that of the memory or ``max_len``) and
  logical axes equal to the reference's; the slot cache's select and
  reset on every leaf;
* every emulated contraction of ``encode`` and ``_dec_layer`` (over a
  whole sequence against the memory, and one decode step on the caches)
  bitwise: the port's operands and outputs are recorded and the
  reference engine re-evaluates each (``tests/torch_parity.py``), the
  reference making the same contractions;
* ``forward`` within ``1e-4 * max|logit|`` under ``f32`` and ``:fused``
  (``2e-2`` in bf16 activations); the ``init_cache`` -> ``decode_step``
  loop against the reference's within 1e-4 with equal greedy tokens, and
  against the port's ``forward`` at the reference's
  ``DECODE_TOL["encdec"]``;
* the runtime's greedy tokens with a context (the reference encoder's
  output over drawn frames, handed to both), whole-prompt and chunked,
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
from repro.models import api as R_api
from repro.models import common as R_common
from repro.models import encdec as R_encdec
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import encdec as P_encdec
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit
from tests.torch_parity import contractions_bitwise

torch.set_num_threads(1)

ARCH = "seamless_m4t_medium"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "f32": "f32"}
DECODE_TOL_ENCDEC = 2e-2       # the reference's DECODE_TOL["encdec"]


def _cfgs(spec, dtype="float32", **kw):
    rcfg = R_configs.get_config(ARCH, smoke=True, engine_spec=REF_SPEC[spec],
                                dtype=dtype, **kw)
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype=dtype, **kw)
    return rcfg, pcfg


@pytest.fixture(scope="module")
def ref_params():
    cfg = R_configs.get_config(ARCH, smoke=True)
    model = R_api.get_model(cfg)
    params = jax.jit(lambda k: model.init(k, cfg)[0])(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _frames(cfg, batch=2, n=8, seed=2):
    """Frame embeddings (batch, n, d) drawn from a seed."""
    return np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def ref_fns(ref_params):
    """The reference's jitted encoder, forward and decode step, one
    compile per (kind, spec, activation dtype) for the whole module."""
    rparams, _ = ref_params
    fns = {}

    def get(kind, spec, dtype="float32"):
        key = (kind, spec, dtype)
        if key not in fns:
            rcfg, _ = _cfgs(spec, dtype=dtype)
            model = R_api.get_model(rcfg)
            fns[key] = jax.jit({
                "encode": lambda f: R_encdec.encode(rparams, rcfg, f),
                "forward": lambda t, f: model.forward(
                    rparams, rcfg, {"tokens": t, "frames": f}),
                "cache": lambda m: model.init_cache(
                    rcfg, m.shape[0], 8, params=rparams, ctx=m),
                "decode": lambda c, t, n: model.decode_step(
                    rparams, rcfg, c, t, n)}[kind])
        return fns[key]
    return get


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree (``enc_layers`` and
    ``dec_layers`` stacked, a decoder layer's ``self`` / ``cross``
    attention, GELU ``mlp``, ``ln1`` / ``ln_x`` / ``ln2``; ``ln_enc``),
    shapes, f32 dtypes and scale rule; ``params_from_numpy`` carries the
    reference tree across unchanged; and the split cache would freeze
    exactly the reference's paths."""
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
        if path[-1].startswith("ln"):
            assert not torch.any(a), path
        else:
            ratio = float(a.std()) / float(b.std())
            assert abs(ratio - 1.0) < 0.15, (path, ratio)

    walk(mine, nparams, carried)
    assert set(mine["dec_layers"]) == {"self", "cross", "mlp", "ln1",
                                       "ln_x", "ln2"}
    assert P_common.param_count(mine) == R_common.param_count(rparams)
    want = sorted(R_presplit.wrappable_paths(rparams))
    assert sorted(P_presplit.wrappable_paths(carried)) == want
    assert ("dec_layers", "cross", "wk") in want and len(want) == 17


def test_cache_layout_and_slot_ops(ref_params, ref_fns):
    """``init_cache``'s leaves and ``cache_axes`` equal the reference's:
    without a memory (cross K/V zeros of ``max_len`` rows), and with the
    encoder output of 5 drawn frames (the cross K/V projected per layer,
    5 rows, bf16, within one bf16 rounding of the reference's); the slot
    cache selects and resets every leaf at axis 1."""
    from repro_torch.serving.kvcache import SlotCacheOps
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    mem = np.asarray(ref_fns("encode", FUSED)(jnp.asarray(
        _frames(rcfg, batch=3, n=5))))
    ref = ref_fns("cache", FUSED)(jnp.asarray(mem))
    got = pmodel.init_cache(pcfg, 3, 8,
                            params=params_from_numpy(nparams, device="cpu"),
                            ctx=torch.from_numpy(mem))
    empty = pmodel.init_cache(pcfg, 3, 8, device="cpu")
    zeros_ref = rmodel.init_cache(rcfg, 3, 8)
    assert set(got) == set(ref) == set(empty) == set(zeros_ref)
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape, name
        assert tuple(empty[name].shape) == zeros_ref[name].shape, name
        assert got[name].dtype == empty[name].dtype == torch.bfloat16
        assert str(ref[name].dtype) == "bfloat16", name
        assert not empty[name].any()
        r = np.asarray(ref[name].astype(jnp.float32))
        assert np.abs(got[name].float().numpy() - r).max() <= \
            2.0 ** -7 * max(np.abs(r).max(), 1e-30), name
    assert tuple(got["cross_k"].shape) == (2, 3, 5, 4, 16)
    assert tuple(empty["cross_k"].shape) == (2, 3, 8, 4, 16)
    assert got["cross_k"].any() and got["cross_v"].any()
    assert pmodel.cache_axes(pcfg) == rmodel.cache_axes(rcfg)
    ops = SlotCacheOps(pcfg, pmodel)
    assert set(ops._slot_axis.values()) == {1}
    ones = {k: torch.ones_like(v) for k, v in empty.items()}
    ops.reset_slot(ones, 1, pmodel.init_cache(pcfg, 1, 8, device="cpu"))
    sel = ops.select_slots(empty, ones, torch.tensor([True, False, False]))
    for name in ones:
        assert not ones[name][:, 1].any() and ones[name][:, 0].all()
        assert not sel[name][:, :2].any() and sel[name][:, 2].all()


# ---------------------------------------------------------------------------
# every emulated contraction, bitwise
# ---------------------------------------------------------------------------

def test_encode_contractions_bitwise(monkeypatch, ref_params):
    """``encode`` over 8 drawn frames: 8 contractions a layer (4
    projections, the bidirectional scores and p@v, the GELU MLP's 2), each
    bitwise; the output within 1e-5 of max|y|."""
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    frames = _frames(rcfg)
    pp = params_from_numpy(nparams, device="cpu")
    ref, out, n = contractions_bitwise(
        monkeypatch, REF_SPEC[FUSED],
        lambda: R_encdec.encode(rparams, rcfg, jnp.asarray(frames)),
        lambda: P_encdec.encode(pp, pcfg, torch.from_numpy(frames)))
    assert n == 8 * rcfg.enc_layers
    assert out.shape == ref.shape == (2, 8, 64)
    assert _rel(out.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("mode", ["sequence", "decode"])
def test_dec_layer_contractions_bitwise(monkeypatch, ref_params, mode):
    """Decoder layer 1's ``_dec_layer``: over 3 positions against a drawn
    6-row memory (the cross K/V projected from it: 14 contractions), or
    one decode step at
    position 4 on a K/V cache and precomputed cross K/V (the cache's bf16
    rows cast back to f32, as ``decode_step`` does: 12): every
    contraction bitwise, the output within 1e-5 of max|y| and the new self K/V within
    one bf16 rounding."""
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    rng = np.random.default_rng(6)
    lp_n = jax.tree.map(lambda a: a[1], nparams["dec_layers"])
    rp, pp = jax.tree.map(jnp.asarray, lp_n), params_from_numpy(
        lp_n, device="cpu")
    mem = rng.standard_normal((2, 6, 64)).astype(np.float32)
    Lq = 3 if mode == "sequence" else 1
    x = rng.standard_normal((2, Lq, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Lq, dtype=np.int32) + (
        0 if mode == "sequence" else 3), (2, Lq))
    from repro.models import layers as R_layers
    from repro_torch.models import layers as P_layers
    r_cs = R_layers.rope_cos_sin(jnp.asarray(pos), 16, rcfg.rope_theta)
    p_cs = P_layers.rope_cos_sin(torch.from_numpy(np.ascontiguousarray(pos)),
                                 16, pcfg.rope_theta)
    if mode == "sequence":
        run_ref = lambda: R_encdec._dec_layer(
            rp, rcfg, jnp.asarray(x), *r_cs, jnp.asarray(mem))
        run_port = lambda: P_encdec._dec_layer(
            pp, pcfg, torch.from_numpy(x), *p_cs, torch.from_numpy(mem))
        n_want = 6 + 6 + 2          # the cross K/V projected here
    else:
        kv = [rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
              for _ in range(4)]
        kv = [jnp.asarray(a).astype(jnp.bfloat16) for a in kv]
        f32 = [np.asarray(a.astype(jnp.float32)) for a in kv]
        cur = np.asarray([4, 4], np.int32)
        run_ref = lambda: R_encdec._dec_layer(
            rp, rcfg, jnp.asarray(x), *r_cs,
            self_cache=(kv[0], kv[1]),
            cross_kv_cache=(kv[2].astype(jnp.float32),
                            kv[3].astype(jnp.float32)),
            cur_len=jnp.asarray(cur))
        run_port = lambda: P_encdec._dec_layer(
            pp, pcfg, torch.from_numpy(x), *p_cs,
            self_cache=(torch.from_numpy(f32[0]).bfloat16(),
                        torch.from_numpy(f32[1]).bfloat16()),
            cross_kv_cache=(torch.from_numpy(f32[2]),
                            torch.from_numpy(f32[3])),
            cur_len=torch.from_numpy(cur))
        n_want = 6 + 4 + 2
    (ref, ref_kv), (out, out_kv), n = contractions_bitwise(
        monkeypatch, REF_SPEC[FUSED], run_ref, run_port)
    assert n == n_want
    assert _rel(out.numpy(), ref) <= 1e-5
    if mode == "decode":
        for a, b in zip(out_kv, ref_kv):
            assert a.dtype == torch.bfloat16
            r = b.astype(np.float32)
            assert np.abs(a.float().numpy() - r).max() <= \
                2.0 ** -7 * np.abs(r).max()
    else:
        assert out_kv is None and ref_kv is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _port_forward(nparams, pcfg, toks, frames):
    with torch.no_grad():
        return P_api.get_model(pcfg).forward(
            params_from_numpy(nparams, device="cpu"), pcfg,
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}).numpy()


@pytest.mark.parametrize("spec,dtype,tol", [
    ("f32", "float32", 1e-4), (FUSED, "float32", 1e-4),
    (FUSED, "bfloat16", 2e-2)], ids=["f32", "fused", "fused-bf16"])
def test_forward_logits_match_reference(ref_params, ref_fns, spec, dtype,
                                        tol):
    """Teacher-forced logits over 8 target tokens and 8 drawn frames
    within ``tol * max|logit|``; in f32 activations the greedy tokens
    equal at every position.  Control: second frames move the port's
    logits by more than ``tol``."""
    _, nparams = ref_params
    rcfg, pcfg = _cfgs(spec, dtype=dtype)
    toks = _tokens(rcfg.vocab, (2, 8))
    frames = _frames(rcfg)
    ref = np.asarray(ref_fns("forward", spec, dtype)(jnp.asarray(toks),
                                                     jnp.asarray(frames)))
    out = _port_forward(nparams, pcfg, toks, frames)
    assert out.shape == ref.shape == (2, 8, 256)
    assert np.isfinite(out).all() and _rel(out, ref) <= tol
    if dtype == "float32":
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    other = _port_forward(nparams, pcfg, toks, _frames(rcfg, seed=9))
    assert _rel(other, out) > 10 * tol


def _decode_loop(model, params, cfg, cache, toks, step=None):
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
    """The reference encoder's output over 8 drawn frames handed to both
    ``init_cache``s, then 8 teacher-forced ``decode_step``s under
    ``:fused``: logits within ``tol`` of the reference's at every
    position, greedy tokens equal in f32 activations; in f32 activations
    also the port's own encoder, cache and decode against its ``forward``
    at the reference's ``DECODE_TOL["encdec"]``.  Control: second frames
    move the decode logits by more than ``tol``."""
    _, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED, dtype=dtype)
    pmodel = P_api.get_model(pcfg)
    params = params_from_numpy(nparams, device="cpu")
    toks = _tokens(rcfg.vocab, (2, 8), seed=5)
    frames = _frames(rcfg)
    enc = ref_fns("encode", FUSED, dtype)
    mem = enc(jnp.asarray(frames))
    ref = _decode_loop(None, None, None, ref_fns("cache", FUSED, dtype)(mem),
                       toks, ref_fns("decode", FUSED, dtype))

    def port(mem):
        mem = torch.from_numpy(np.asarray(mem.astype(jnp.float32))).to(
            pcfg.compute_dtype)
        cache = pmodel.init_cache(pcfg, 2, 8, params=params, ctx=mem)
        return _decode_loop(pmodel, params, pcfg, cache, toks)
    got = port(mem)
    assert _rel(got, ref) <= tol
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        with torch.no_grad():
            own = P_encdec.encode(params, pcfg, torch.from_numpy(frames))
            cache = pmodel.init_cache(pcfg, 2, 8, params=params, ctx=own)
            fwd = pmodel.forward(params, pcfg, {
                "tokens": torch.from_numpy(toks),
                "frames": torch.from_numpy(frames)}).numpy()
        own_dec = _decode_loop(pmodel, params, pcfg, cache, toks)
        assert _rel(own_dec, fwd) <= DECODE_TOL_ENCDEC
    assert _rel(port(enc(jnp.asarray(_frames(rcfg, seed=9)))), got) > \
        10 * tol


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runtime_tokens(ref_params, ref_fns):
    """The reference runtime's greedy tokens (``ozimmu_h-4:df32``, f32
    activations, 2 slots, max_len 16) for three prompts sharing the pow2
    bucket of 8, with the reference encoder's output over 6 drawn frames
    as the context (handed to the port's runtime too)."""
    from repro.serving import ServingRuntime as RRuntime
    rparams, _ = ref_params
    rcfg, _ = _cfgs(FUSED)
    prompts = [_tokens(rcfg.vocab, (n,), seed=3 + n) for n in (5, 7, 6)]
    mem = ref_fns("encode", FUSED)(jnp.asarray(_frames(rcfg, batch=1,
                                                       n=6)))
    refs = RRuntime(rcfg, rparams, slots=2, max_len=16, ctx=mem).generate(
        [p.copy() for p in prompts], 4)
    return prompts, np.asarray(mem), refs


@pytest.mark.parametrize("chunk", [None, 3], ids=["whole", "chunked"])
def test_runtime_tokens_match_reference(ref_params, ref_fns,
                                        ref_runtime_tokens, chunk):
    """The port's runtime (``:fused``, 2 slots, the context; with
    ``prefill_chunk=3`` decode steps beside mid-prefill slots) gives the
    reference runtime's greedy tokens; the weight-split hit rate is 1.0.
    Control: under the encoder output of second frames the continuations
    differ."""
    from repro_torch.launch.serve import make_runtime
    _, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    prompts, mem, refs = ref_runtime_tokens

    def serve(ctx):
        rt = make_runtime(pcfg, params_from_numpy(nparams, device="cpu"),
                          slots=2, max_len=16, prefill_chunk=chunk,
                          ctx=torch.from_numpy(ctx), device="cpu")
        return rt, rt.generate([p.copy() for p in prompts], 4)

    rt, outs = serve(mem)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert tuple(rt.cache["cross_k"].shape) == (2, 2, 6, 4, 16)
    s = rt.metrics.summary()
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert (s["prefill_chunks"] > 0) == (chunk is not None)
    if chunk is None:
        other = np.asarray(ref_fns("encode", FUSED)(jnp.asarray(
            _frames(rcfg, batch=1, n=6, seed=9))))
        _, outs2 = serve(other)
        assert any(not np.array_equal(a, b) for a, b in zip(outs2, outs))


def test_launch_counts(monkeypatch):
    """Under ``:fused`` with the weight splits frozen.  The context: the
    encoder over 16 frames (8 contractions a layer) and, at the runtime's
    construction, each decoder layer's cross ``wk``/``wv`` on the 16
    memory rows for the template and again for the slot cache; every one
    of their group GEMMs on the large route.  A model step: a decoder
    layer's 4 self projections and 2 attention contractions, the cross
    ``wq``/``wo`` and 2 attention contractions a key chunk of the cached
    cross K/V, the GELU MLP's 2, and the LM head: 4 group GEMMs (skinny)
    and one df32 epilogue each; a split per A side and per attention B
    side.  Counted at the kernel wrappers, on the CPU."""
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf
    from repro_torch.launch.serve import make_runtime
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
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=FUSED)
    model = P_api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    nl = cfg.n_layers
    with torch.no_grad():
        mem = P_encdec.encode(params, cfg, torch.randn(1, 16, cfg.d_model))
    assert counts["group_gemm"] == counts["large"] == cfg.enc_layers * 8 * 4
    counts.update(split=0, group_gemm=0, epilogue=0, large=0)
    rt = make_runtime(cfg, params, slots=4, max_len=8, ctx=mem,
                      device="cpu")
    assert counts["group_gemm"] == counts["large"] == nl * 2 * 2 * 4
    assert counts["epilogue"] == nl * 2 * 2
    counts.update(split=0, group_gemm=0, epilogue=0, large=0)
    with torch.no_grad():
        model.decode_step(rt.params, cfg, rt.cache,
                          torch.zeros((4, 1), dtype=torch.int32),
                          torch.tensor([1, 1, 0, 0], dtype=torch.int32))
    nk = -(-16 // cfg.kv_chunk)
    c = nl * (10 + 2 * nk) + 1
    assert counts == {"split": nl * (12 + 4 * nk) + 1, "group_gemm": c * 4,
                      "epilogue": c, "large": 0}


def test_launcher_serves_the_encdec_arch(ref_params, capsys):
    """``python -m repro_torch.launch.serve --arch seamless_m4t_medium``
    serves the smoke config with the reference's static context: the
    encoder over zero frames of the prompt length, which is zero
    (``rmsnorm(0)``), as the reference's ``slot_context`` gives."""
    from repro.launch.serve import slot_context as r_slot_context
    from repro_torch.launch import serve
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    ref = np.asarray(jax.jit(lambda p: r_slot_context(rcfg, p, 5))(rparams))
    got = serve.slot_context(pcfg, params_from_numpy(nparams, device="cpu"),
                             5)
    assert tuple(got.shape) == ref.shape == (1, 5, 64)
    assert not got.any() and not ref.any()
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out
