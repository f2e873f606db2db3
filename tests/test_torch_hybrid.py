"""The port's hybrid family (``hybrid``: recurrentgemma-9b) against the
reference.

``smoke()`` config (2 (R, R, A) pattern blocks and 1 tail R layer, d 64,
LRU width 64, 4 query heads of 16 on 1 KV head, window 32, GELU MLP of
96, vocab 256), weights initialized by the JAX model and carried across
with ``params_from_numpy``; activations f32 unless a test says otherwise.
The LM head is tied (``embed.T``); as in ``tests/test_torch_ssm.py`` the
model tests scale ``embed`` by ``EMBED_SCALE`` on both sides, so that
greedy decoding does not merely echo the last token.

What is held, and how tightly:

* the parameter tree (blocks stacked on two leading axes), the cache
  leaves and their logical axes equal to the reference's;
* ``rg_lru`` (the reference's log-space associative scan; here a
  sequential one) within the reference's own scan-vs-step tolerance
  (rtol 1e-4, atol 1e-5, ``tests/test_models.py``), ``rg_lru_step`` and
  ``gelu_mlp`` (the tanh GELU) within ``1e-5 * max|y|``;
* the emulated ``w_x`` projection bit for bit under ``ozimmu_h-4:df32``
  and ``:fused``, frozen on the two-level stack and sliced twice;
* whole-model logits within ``1e-4 * max|logit|`` under ``f32`` and
  ``:fused``; the teacher-forced ``decode_step`` against ``forward`` at
  the reference's ``DECODE_TOL["hybrid"]`` over 40 positions (the K/V
  ring of 32 rows wraps), and against the reference's own decode steps
  over the same 40 positions within 1e-4, cache dtypes leaf by leaf;
* greedy tokens of the port's serving runtime, with whole-prompt and
  chunked prefill, equal to the reference's per-request greedy loop (the
  reference runtime's prefill scan cannot carry this family's cache under
  f32 activations: its block conv windows turn from bf16 to f32 in the
  first step, which ``lax.scan`` refuses; ``ROADMAP.md`` §3);
* the launch counts a model step, and the launcher.

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
from repro.core.engine import make_engine as R_make_engine
from repro.models import api as R_api
from repro.models import common as R_common
from repro.models import hybrid as R_hybrid
from repro.models import layers as R_layers
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.core.engine import make_engine as P_make_engine
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import hybrid as P_hybrid
from repro_torch.models import layers as P_layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit

torch.set_num_threads(1)

ARCH = "recurrentgemma_9b"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "ozimmu_h-4:df32": "ozimmu_h-4:df32",
            "f32": "f32"}
DECODE_TOL_HYBRID = 5e-2       # the reference's DECODE_TOL["hybrid"]
EMBED_SCALE = 0.05


def _cfgs(spec, **kw):
    rcfg = R_configs.get_config(ARCH, smoke=True,
                                engine_spec=REF_SPEC.get(spec, spec),
                                dtype="float32", **kw)
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype="float32", **kw)
    return rcfg, pcfg


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init, jitted (its nested vmaps take ~13 s eagerly,
    ~5 s compiled)."""
    cfg = R_configs.get_config(ARCH, smoke=True)
    model = R_api.get_model(cfg)
    params = jax.jit(lambda k: model.init(k, cfg)[0])(jax.random.PRNGKey(0))
    params = dict(params, embed=params["embed"] * EMBED_SCALE)
    return params, jax.tree.map(np.asarray, params)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree (``blocks/r_layers``
    and ``blocks/r_mlps`` stacked (blocks, R layers, ...)), shapes, f32
    dtypes and scale rule, ``lambda`` in the reference's range (``a^c`` in
    [0.9, 0.999] at r = 1); ``params_from_numpy`` carries the reference
    tree across unchanged; and the split cache would freeze exactly the
    reference's paths (never ``lru_a``, the conv or the tied embedding)."""
    rparams, nparams = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True)
    mine = P_api.get_model(cfg).init(cfg, generator=torch.Generator(
        ).manual_seed(0), device="cpu")
    mine["embed"] = mine["embed"] * EMBED_SCALE
    carried = params_from_numpy(nparams, device="cpu")

    def walk(a, b, c, path=()):
        if isinstance(b, dict):
            assert set(a) == set(b) == set(c), path
            for key in b:
                walk(a[key], b[key], c[key], path + (key,))
            return
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, path
        np.testing.assert_array_equal(c.numpy(), b)
        if not np.any(b):
            assert not torch.any(a), path
        elif path[-1] == "lambda":
            a_c = np.exp(-2 * 8.0 * np.log1p(np.exp(a.numpy())))
            assert a_c.min() >= 0.81 * 0.999 and a_c.max() <= 0.998001, path
        else:
            ratio = float(a.std()) / float(b.std())
            assert abs(ratio - 1.0) < 0.15, (path, ratio)

    walk(mine, nparams, carried)
    assert P_common.param_count(mine) == R_common.param_count(rparams)
    want = sorted(R_presplit.wrappable_paths(rparams))
    assert sorted(P_presplit.wrappable_paths(carried)) == want
    assert not [p for p in want if p[-1] in ("lru_a", "conv_w", "embed")]
    assert len(want) == 16


def test_cache_layout_matches_reference():
    """``init_cache``'s leaves (bf16 conv windows and K/V rings of
    ``min(max_len, window)`` rows, f32 LRU states), zero, and
    ``cache_axes`` equal the reference's; the slot cache finds each
    leaf's slot axis (axis 2 of the blocks' conv and LRU stacks)."""
    from repro_torch.serving.kvcache import SlotCacheOps
    rcfg = R_configs.get_config(ARCH, smoke=True)
    pcfg = P_configs.get_config(ARCH, smoke=True)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    for max_len in (8, 48):
        ref = rmodel.init_cache(rcfg, 3, max_len)
        got = pmodel.init_cache(pcfg, 3, max_len, device="cpu")
        assert set(got) == set(ref)
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape, name
            assert str(got[name].dtype)[6:] == str(ref[name].dtype), name
            assert not got[name].any()
    assert got["k"].shape[2] == 32                  # the window
    assert pmodel.cache_axes(pcfg) == rmodel.cache_axes(rcfg)
    ops = SlotCacheOps(pcfg, pmodel)
    ones = {k: torch.ones_like(v) for k, v in got.items()}
    ops.reset_slot(ones, 1, pmodel.init_cache(pcfg, 1, 48, device="cpu"))
    sel = ops.select_slots(got, ones, torch.tensor([True, False, False]))
    for name, ax in ops._slot_axis.items():
        assert not ones[name].select(ax, 1).any()
        assert ones[name].select(ax, 0).all()
        assert not sel[name].narrow(ax, 0, 2).any()
        assert sel[name].select(ax, 2).all()


# ---------------------------------------------------------------------------
# the RG-LRU, the GELU MLP and the emulated projection
# ---------------------------------------------------------------------------

def _lru_layer(nparams):
    return {k: v[0, 1] for k, v in nparams["blocks"]["r_layers"].items()}


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rg_lru_matches_reference(ref_params, with_h0):
    """The sequential scan against the reference's associative scan over
    9 positions, from zero or from a carried state, at the reference's
    scan-vs-step tolerance."""
    _, nparams = ref_params
    lp = _lru_layer(nparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 \
        else None
    y_r, h_r = R_hybrid.rg_lru(jax.tree.map(jnp.asarray, lp),
                               jnp.asarray(x),
                               None if h0 is None else jnp.asarray(h0))
    y_p, h_p = P_hybrid.rg_lru(params_from_numpy(lp, device="cpu"),
                               torch.from_numpy(x),
                               None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), rtol=1e-4,
                               atol=1e-5)


def test_rg_lru_step_matches_reference(ref_params):
    _, nparams = ref_params
    lp = _lru_layer(nparams)
    rng = np.random.default_rng(2)
    x, h = (rng.standard_normal((3, 64)).astype(np.float32)
            for _ in range(2))
    y_r, h_r = R_hybrid.rg_lru_step(jax.tree.map(jnp.asarray, lp),
                                    jnp.asarray(x), jnp.asarray(h))
    y_p, h_p = P_hybrid.rg_lru_step(params_from_numpy(lp, device="cpu"),
                                    torch.from_numpy(x), torch.from_numpy(h))
    assert _rel(y_p.numpy(), np.asarray(y_r)) <= 1e-5
    assert _rel(h_p.numpy(), np.asarray(h_r)) <= 1e-5


def test_gelu_mlp_matches_reference(ref_params):
    """``gelu_mlp`` under the f32 engine within 1e-5, and the GELU itself
    the reference's tanh form (the erf form parts from it by ~1e-3)."""
    _, nparams = ref_params
    mp = {k: v[1, 0] for k, v in nparams["blocks"]["r_mlps"]["mlp"].items()}
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32)
    ref = np.asarray(R_layers.gelu_mlp(jnp.asarray(x), jnp.asarray(
        mp["w_up"]), jnp.asarray(mp["w_down"]), R_make_engine("f32")))
    out = P_layers.gelu_mlp(torch.from_numpy(x),
                            torch.from_numpy(np.array(mp["w_up"])),
                            torch.from_numpy(np.array(mp["w_down"])),
                            P_make_engine("f32")).numpy()
    assert _rel(out, ref) <= 1e-5
    g = np.linspace(-6, 6, 241, dtype=np.float32)
    np.testing.assert_allclose(P_layers.gelu(torch.from_numpy(g)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(g)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(g)))).max() > 1e-4


@pytest.mark.parametrize("spec", [FUSED, "ozimmu_h-4:df32"])
@pytest.mark.parametrize("frozen", [False, True], ids=["split", "frozen"])
def test_w_x_projection_bitwise(ref_params, spec, frozen):
    """``engine(xn, w_x)`` of block 1's R layer 0 bit for bit, the port's
    weight split on the call or frozen by ``wrap_params`` on the
    (blocks, R layers, n, p) stack and sliced twice, as the block loop
    slices it."""
    from repro_torch.models import transformer as P_T
    _, nparams = ref_params
    x = np.random.default_rng(8).standard_normal((3, 1, 64)).astype(
        np.float32)
    w = nparams["blocks"]["r_layers"]["w_x"]
    ref = np.asarray(R_make_engine(REF_SPEC[spec])(jnp.asarray(x),
                                                   jnp.asarray(w[1, 0])))
    eng = P_make_engine(spec)
    if frozen:
        tree, _ = P_presplit.wrap_params(
            {"blocks": {"r_layers": {"w_x": torch.from_numpy(np.array(w))}}},
            eng)
        block = P_T.layer_params(tree["blocks"], 1)
        w_p = P_T.layer_params(block["r_layers"], 0)["w_x"]
        assert tuple(w_p.digits.shape) == (4, 64, 64)
    else:
        w_p = torch.from_numpy(np.array(w[1, 0]))
    out = eng(torch.from_numpy(x), w_p).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["f32", FUSED])
def test_forward_logits_match_reference(ref_params, spec):
    """L = 40 runs the local attention past its window of 32."""
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs(spec)
    toks = _tokens(rcfg.vocab, (2, 40))
    ref = np.asarray(jax.jit(lambda p, t: R_api.get_model(rcfg).forward(
        p, rcfg, {"tokens": t}))(rparams, jnp.asarray(toks)))
    out = P_api.get_model(pcfg).forward(
        params_from_numpy(nparams, device="cpu"), pcfg,
        {"tokens": torch.from_numpy(toks)}).numpy()
    assert out.shape == ref.shape == (2, 40, pcfg.padded_vocab)
    assert np.isfinite(out).all() and _rel(out, ref) <= 1e-4


def _port_decode(params, cfg, toks, max_len):
    model = P_api.get_model(cfg)
    with torch.no_grad():
        cache = model.init_cache(cfg, toks.shape[0], max_len, device="cpu")
        outs = []
        for t in range(toks.shape[1]):
            logits, cache = model.decode_step(
                params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                torch.tensor(t + 1))
            outs.append(logits[:, 0].numpy())
    return np.stack(outs, axis=1), cache


def test_decode_matches_forward(ref_params):
    """Teacher-forced ``decode_step`` over 40 positions against the
    port's ``forward``: the 32-row K/V ring wraps at position 33 and the
    windowed flash attention of ``forward`` masks the same keys; the
    reference's ``DECODE_TOL["hybrid"]`` (bf16 K/V rows and conv
    windows)."""
    _, nparams = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec="f32")
    params = params_from_numpy(nparams, device="cpu")
    toks = _tokens(cfg.vocab, (2, 40), seed=5)
    with torch.no_grad():
        ref = P_api.get_model(cfg).forward(
            params, cfg, {"tokens": torch.from_numpy(toks)}).numpy()
    got, cache = _port_decode(params, cfg, toks, 40)
    assert cache["k"].shape[2] == 32
    assert _rel(got, ref) <= DECODE_TOL_HYBRID


def test_decode_ring_wrap_matches_reference(ref_params):
    """40 teacher-forced decode steps of the port against the reference's
    (f32 engine, f32 activations, ring of 32 rows): logits within 1e-4 of
    max|logit| at every position, wrapped ones included, and every cache
    leaf in the reference's dtype (the blocks' conv windows promoted to
    f32 by the first step, the tail's cast back to bf16) with the
    reference's values within one bf16 rounding step."""
    rparams, nparams = ref_params
    rcfg, pcfg = _cfgs("f32")
    toks = _tokens(rcfg.vocab, (2, 40), seed=5)
    rmodel = R_api.get_model(rcfg)
    step = jax.jit(lambda c, t, n: rmodel.decode_step(rparams, rcfg, c, t,
                                                      n))
    cache_r, ref = rmodel.init_cache(rcfg, 2, 40), []
    for t in range(40):
        logits, cache_r = step(cache_r, jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(t + 1, jnp.int32))
        ref.append(np.asarray(logits[:, 0]))
    ref = np.stack(ref, axis=1)
    got, cache_p = _port_decode(params_from_numpy(nparams, device="cpu"),
                                pcfg, toks, 40)
    err = np.abs(got - ref).max(axis=(0, 2)) / np.abs(ref).max()
    assert err.max() <= 1e-4, err
    for name, leaf in cache_r.items():
        mine = cache_p[name]
        assert str(mine.dtype)[6:] == str(leaf.dtype), name
        r = np.asarray(leaf.astype(jnp.float32))
        assert np.abs(mine.float().numpy() - r).max() <= \
            2.0 ** -7 * np.abs(r).max(), name
    assert cache_p["conv"].dtype == torch.float32
    assert cache_p["tail_conv"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def ref_greedy(ref_params):
    """The reference's greedy continuation of each prompt under
    ``ozimmu_h-4:df32``: its jitted ``decode_step`` position by position,
    each prompt in a slot of its own at that slot's position (the
    per-request loop ``tests/test_serving.py`` holds the reference's
    runtime to; a slot's rows do not depend on the other slots')."""
    rparams, _ = ref_params
    rcfg, _ = _cfgs(FUSED)
    model = R_api.get_model(rcfg)
    prompts = [_tokens(rcfg.vocab, (n,), seed=3 + n) for n in (4, 7, 5)]
    gen = 5
    step = jax.jit(lambda c, t, n: model.decode_step(rparams, rcfg, c, t, n))
    outs = [list(p) for p in prompts]
    cache = model.init_cache(rcfg, len(prompts), 32)
    for t in range(max(map(len, prompts)) + gen - 1):
        live = [t < len(p) + gen - 1 for p in prompts]
        toks = [[o[t] if ok else 0] for o, ok in zip(outs, live)]
        cur = [t + 1 if ok else 0 for ok in live]
        logits, cache = step(cache, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(cur, jnp.int32))
        nxt = np.asarray(jnp.argmax(logits[:, -1, :rcfg.vocab], axis=-1))
        for o, p, ok, tok in zip(outs, prompts, live, nxt):
            if ok and t + 1 >= len(p):
                o.append(int(tok))
    return prompts, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunked"])
def test_runtime_tokens_match_reference(ref_params, ref_greedy, chunk):
    """The port's runtime (``:fused``, 2 slots, prompts of 4, 7 and 5
    tokens: exact-length buckets; with ``prefill_chunk=2`` decode steps
    beside mid-prefill slots, frozen by ``_decode_select``) against the
    reference's greedy loop under ``ozimmu_h-4:df32``; the weight-split
    hit rate 1.0."""
    from repro_torch.serving import ServingRuntime
    _, nparams = ref_params
    _, pcfg = _cfgs(FUSED)
    prompts, refs = ref_greedy
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=32, prefill_chunk=chunk,
                         device="cpu")
    assert prt._decode_select == (chunk is not None)
    outs = prt.generate([p.copy() for p in prompts], 5)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert len({int(t) for o in outs for t in o[-5:]}) > 3   # not an echo
    s = prt.metrics.summary()
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert (s["prefill_chunks"] > 0) == (chunk is not None)


def test_launch_counts_per_model_step(monkeypatch):
    """Under ``:fused`` with the weight splits frozen, one model step runs
    18 contractions a pattern block (5 a recurrent layer: ``w_x``,
    ``w_gate``, ``w_out``, ``w_up``, ``w_down``; 8 in the attention layer:
    4 projections, the scores, p@v and 2 MLP) and 5 a tail layer, plus
    the tied LM head: 4 group GEMMs and one df32 epilogue each, and a
    split launch per A side, per attention B side (the K/V cache) and for
    the head's unfrozen B side ``embed.T``.  ``lru_a`` (a plain f32
    product) launches none.  The config takes the published 16 query
    heads on one KV head, so the attention's two contractions have 16 A
    rows and take the large route (``group_gemm.route``); the rest have
    the slots' 4.  Counted at the kernel wrappers, on the CPU."""
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

    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=FUSED,
                               n_heads=16)
    model = P_api.get_model(cfg)
    rt = ServingRuntime(cfg, model.init(cfg, generator=torch.Generator(
        ).manual_seed(0), device="cpu"), slots=4, max_len=8, device="cpu")
    counting(sf, "split_whole", "split")
    counting(gg, "group_gemm", "group_gemm")
    counting(sa, "scale_accum_chunks", "epilogue")
    with torch.no_grad():
        model.decode_step(rt.params, cfg, rt.cache,
                          torch.zeros((4, 1), dtype=torch.int32),
                          torch.tensor([1, 1, 0, 0], dtype=torch.int32))
    nb, nt = cfg.n_pattern_blocks, cfg.n_tail_layers
    c = nb * 18 + nt * 5 + 1
    assert counts == {"split": c + nb * 2 + 1, "group_gemm": c * 4,
                      "epilogue": c, "large": nb * 2 * 4}


def test_launcher_serves_the_hybrid_arch(capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma_9b``
    serves the smoke config (``--full`` the published one)."""
    from repro_torch.launch import serve
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out
