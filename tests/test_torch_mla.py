"""The port's MLA family (``mla_moe``: deepseek-v2-236b) against the
reference.

``smoke()`` config (2 layers, d 64, 4 heads of nope dim 16 + rope dim 8, v
head dim 16, kv_lora 32, 8 experts, top 2, 1 shared expert, vocab 256),
weights initialized by the JAX model and carried across with
``params_from_numpy``; activations f32 unless a test says otherwise.

What is held, and how tightly:

* the parameter tree, the cache leaves and their logical axes equal to
  the reference's;
* the up-projection ``engine(latent_full, w_uk)`` (the whole bf16 latent
  cache as the A side, rows past ``cur_len`` zero) and the G = 1 decode
  attention contractions (D = 24, Dv = 16) bit for bit under
  ``ozimmu_h-4:df32`` and ``:fused`` (the reference's Pallas kernels in
  interpret mode);
* ``mla_attention`` within ``1e-5 * max|y|``, with and without a cache
  (RoPE's sin/cos and the softmax's exp differ by an ulp between XLA and
  PyTorch; every contraction is bitwise), and the rows it writes into the
  cache: the latent bitwise, the rope key within one bf16 rounding step;
* whole-model logits within ``1e-4 * max|logit|`` per token, with routing
  flips allowed only where isolated (the reference's rule,
  ``tests/test_models.py``), and the port's teacher-forced
  ``decode_step`` against its ``forward`` at the reference's
  ``DECODE_TOL["mla_moe"]``;
* after four teacher-forced decode steps, the latent and rope-key cache
  rows against the reference's within ``2^-7 * max|row|`` (one bf16
  rounding step of the largest value; the activations feeding them differ
  by ~1e-6 after a layer);
* greedy tokens of the two serving runtimes equal, the launch counts a
  model step, and the launcher.

The reference side of a whole-model comparison under
``ozimmu_h-4:df32:fused`` runs ``ozimmu_h-4:df32`` (its XLA path), whose
contractions the reference holds bit-identical to ``:fused``
(``tests/test_fused_pipeline.py``).
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
from repro.models import layers as R_layers
from repro.models import moe as R_moe
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.core.engine import make_engine as P_make_engine
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import layers as P_layers
from repro_torch.models import moe as P_moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit

torch.set_num_threads(1)

ARCH = "deepseek_v2_236b"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "f32": "f32"}
DECODE_TOL_MLA = 5e-2          # the reference's DECODE_TOL["mla_moe"]
SCORES = (((3,), (3,)), ((0, 1), (0, 2)))   # "bkgd,bskd->bkgs"
PV = (((3,), (1,)), ((0, 1), (0, 2)))       # "bkgs,bskd->bkgd"


def _cfgs(spec, dtype="float32"):
    rcfg = R_configs.get_config(ARCH, smoke=True,
                                engine_spec=REF_SPEC.get(spec, spec),
                                dtype=dtype)
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype=dtype)
    return rcfg, pcfg


@pytest.fixture(scope="module")
def ref_params():
    cfg = R_configs.get_config(ARCH, smoke=True)
    params, axes = R_api.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params), axes


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _bf16(x):
    """f32 values rounded to bf16 and back (numpy has no bf16)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _isolated_flips(got, ref, tol):
    """``(ok, bad)``: per-token errors over ``max|ref|`` at or above
    ``tol`` are routing flips, allowed only where isolated."""
    scale = float(np.abs(ref).max()) + 1e-9
    bad = np.abs(got - ref).max(axis=-1) / scale >= tol       # (B, L)
    consec = (bad[:, 1:] & bad[:, :-1]).any()
    return bad.sum(axis=1).max(initial=0) <= 1 and not consec, bad


def _latent_cache(rng, cfg, cur):
    """A bf16-valued latent cache (B, Lmax, kv_lora) whose rows at or past
    each slot's ``cur`` are zero, as decode finds it."""
    B, Lmax = len(cur), 8
    lat = _bf16(rng.standard_normal((B, Lmax, cfg.kv_lora)).astype(
        np.float32))
    for b, c in enumerate(cur):
        lat[b, c:] = 0.0
    return lat


# ---------------------------------------------------------------------------
# parameters and cache layout
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree, shapes, f32 dtypes
    and scale rule (``w_o`` at ``(H vd) ** -0.5``); ``params_from_numpy``
    carries the reference tree across unchanged; and the split cache
    would freeze exactly the reference's paths (the six MLA projections,
    the shared expert and the LM head; no expert stack, no router)."""
    rparams, nparams, axes = ref_params
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
        if np.any(b):
            ratio = float(a.std()) / float(b.std())
            assert abs(ratio - 1.0) < 0.15, (path, ratio)
        else:
            assert not torch.any(a), path

    walk(mine, nparams, carried)
    assert P_common.param_count(mine) == R_common.param_count(rparams)
    _, layer_ax = R_moe.init_layer(jax.random.PRNGKey(0),
                                   R_configs.get_config(ARCH, smoke=True))
    assert P_common.stack_axes(layer_ax) == axes["layers"]
    want = R_presplit.wrappable_paths(rparams)
    assert P_presplit.wrappable_paths(carried) == want
    assert sorted("/".join(p[1:]) for p in want if p[0] == "layers") == [
        "attn/w_dkv", "attn/w_krope", "attn/w_o", "attn/w_q", "attn/w_uk",
        "attn/w_uv", "moe/shared/w_down", "moe/shared/w_gate",
        "moe/shared/w_up"]


def test_cache_layout_matches_reference():
    """``init_cache``'s latent and rope-key stacks (shapes, bf16, zero)
    and ``cache_axes`` equal the reference's, and the slot cache finds the
    slot axis of both leaves: ``reset_slot`` writes one slot and
    ``select_slots`` keeps the unselected slots' rows."""
    from repro_torch.serving.kvcache import SlotCacheOps
    rcfg = R_configs.get_config(ARCH, smoke=True)
    pcfg = P_configs.get_config(ARCH, smoke=True)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    ref = rmodel.init_cache(rcfg, 3, 8)
    got = pmodel.init_cache(pcfg, 3, 8, device="cpu")
    assert set(got) == set(ref) == {"latent", "k_rope"}
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape
        assert got[name].dtype == torch.bfloat16
        assert ref[name].dtype == jnp.bfloat16 and not got[name].any()
    assert pmodel.cache_axes(pcfg) == rmodel.cache_axes(rcfg)
    ops = SlotCacheOps(pcfg, pmodel)
    ones = {k: torch.ones_like(v) for k, v in got.items()}
    ops.reset_slot(ones, 1, pmodel.init_cache(pcfg, 1, 8, device="cpu"))
    sel = ops.select_slots(got, ones, torch.tensor([True, False, False]))
    for name in got:
        assert not ones[name][:, 1].any() and ones[name][:, 0].all()
        assert not sel[name][:, :2].any() and sel[name][:, 2].all()


# ---------------------------------------------------------------------------
# the emulated contractions MLA adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [FUSED, "ozimmu_h-4:df32"])
def test_up_projection_bitwise(ref_params, spec):
    """``engine(latent_full, w_uk)``: the whole bf16 latent cache (rows
    past each slot's ``cur_len`` zero, a zero row maximum whose scale and
    digits must be the reference's) against the K up-projection, bit for
    bit."""
    _, nparams, _ = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True)
    lat = _latent_cache(np.random.default_rng(4), cfg, cur=[5, 2, 8])
    w = np.array(nparams["layers"]["attn"]["w_uk"][0])
    ref = np.asarray(R_make_engine(spec)(jnp.asarray(lat), jnp.asarray(w)))
    out = P_make_engine(spec)(torch.from_numpy(lat), torch.from_numpy(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert not out[0, 5:].any() and not out[1, 2:].any()


@pytest.mark.parametrize("spec", [FUSED, "ozimmu_h-4:df32"])
@pytest.mark.parametrize("which", ["scores", "p@v"])
def test_decode_attention_contraction_bitwise(spec, which):
    """MLA's decode attention contractions: one query head a KV head (G =
    1), q/k head dim 24 (16 nope + 8 rope), v head dim 16, the cache's
    (B, Lmax, H, D) K and V as the B side, bit for bit."""
    rng = np.random.default_rng(6)
    B, H, Lmax, D, Dv = 3, 4, 8, 24, 16
    if which == "scores":
        lhs = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        rhs = rng.standard_normal((B, Lmax, H, D)).astype(np.float32)
        dn = SCORES
    else:
        lhs = rng.random((B, H, 1, Lmax)).astype(np.float32)
        lhs[0, :, :, 5:] = 0.0             # masked positions
        rhs = rng.standard_normal((B, Lmax, H, Dv)).astype(np.float32)
        dn = PV
    ref = np.asarray(R_layers._edot(R_make_engine(spec), jnp.asarray(lhs),
                                    jnp.asarray(rhs), dn,
                                    out_dtype=jnp.float32))
    out = P_layers._edot(P_make_engine(spec), torch.from_numpy(lhs),
                         torch.from_numpy(rhs), dn,
                         out_dtype=torch.float32)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("cached", [False, True])
def test_mla_attention_matches_reference(ref_params, cached):
    """Layer 0's MLA under ``:fused`` on seeded ``x`` within 1e-5 of
    max|y|.  ``cached``: one decode step per slot at its own ``cur_len``
    (3 slots at 5, 1 and 8, a full cache) into a cache holding earlier
    rows; the written latent row is bitwise the reference's, the rope-key
    row within one bf16 rounding step, and every other row is kept."""
    _, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    lp = _layer0(nparams["layers"]["attn"])
    rng = np.random.default_rng(7)
    B, Lq = (3, 1) if cached else (2, 8)
    x = rng.standard_normal((B, Lq, rcfg.d_model)).astype(np.float32)
    if cached:
        cur = np.array([5, 1, 8], np.int32)
        pos = (cur - 1)[:, None]
        lat = _latent_cache(rng, rcfg, cur - 1)
        kr = _bf16(rng.standard_normal((B, 8, rcfg.rope_head_dim)).astype(
            np.float32))
    else:
        pos = np.broadcast_to(np.arange(Lq, dtype=np.int32), (B, Lq))
    rcs = R_layers.rope_cos_sin(jnp.asarray(pos), rcfg.rope_head_dim,
                                rcfg.rope_theta)
    pcs = P_layers.rope_cos_sin(torch.from_numpy(np.array(pos)),
                                pcfg.rope_head_dim, pcfg.rope_theta)
    rkw = pkw = {}
    if cached:
        rkw = dict(cache=(jnp.asarray(lat, jnp.bfloat16),
                          jnp.asarray(kr, jnp.bfloat16)),
                   cur_len=jnp.asarray(cur))
        pkw = dict(cache=(torch.from_numpy(lat).to(torch.bfloat16),
                          torch.from_numpy(kr).to(torch.bfloat16)),
                   cur_len=torch.from_numpy(cur))
    ref, rcache = R_moe.mla_attention(jax.tree.map(jnp.asarray, lp), rcfg,
                                      jnp.asarray(x), *rcs, **rkw)
    with torch.no_grad():
        out, pcache = P_moe.mla_attention(params_from_numpy(lp, device="cpu"),
                                          pcfg, torch.from_numpy(x), *pcs,
                                          **pkw)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    if not cached:
        assert rcache is None and pcache is None
        return
    (rl, rk), (pl, pk) = [tuple(np.asarray(jnp.asarray(t, jnp.float32))
                                for t in rcache),
                          tuple(t.float().numpy() for t in pcache)]
    np.testing.assert_array_equal(pl, rl)
    rows = np.arange(B), cur - 1
    assert np.abs(pk - rk).max() <= 2.0 ** -7 * np.abs(rk[rows]).max()
    keep = np.ones((B, 8), bool)
    keep[rows] = False
    np.testing.assert_array_equal(pl[keep], lat[keep])
    np.testing.assert_array_equal(pk[keep], kr[keep])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["f32", FUSED])
def test_forward_logits_match_reference(ref_params, spec):
    rparams, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(spec)
    toks = _tokens(rcfg.vocab, (2, 8))
    ref = np.asarray(jax.jit(lambda p, t: R_api.get_model(rcfg).forward(
        p, rcfg, {"tokens": t}))(rparams, jnp.asarray(toks)))
    out = P_api.get_model(pcfg).forward(
        params_from_numpy(nparams, device="cpu"), pcfg,
        {"tokens": torch.from_numpy(toks)}).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    ok, bad = _isolated_flips(out, ref, 1e-4)
    assert ok, bad


@pytest.mark.parametrize("spec", ["f32", FUSED])
def test_decode_matches_forward(ref_params, spec):
    """Teacher-forced ``decode_step`` against ``forward`` (the
    reference's ``test_decode_matches_forward`` for the port): bf16
    latent / rope-key cache, so the reference's ``DECODE_TOL["mla_moe"]``
    and isolation rule."""
    _, nparams, _ = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec)
    model = P_api.get_model(cfg)
    params = params_from_numpy(nparams, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 8)))
    with torch.no_grad():
        ref = model.forward(params, cfg, {"tokens": toks}).numpy()
        cache = model.init_cache(cfg, 2, 8, device="cpu")
        outs = []
        for t in range(8):
            logits, cache = model.decode_step(params, cfg, cache,
                                              toks[:, t:t + 1],
                                              torch.tensor(t + 1))
            outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1).numpy()
    ok, bad = _isolated_flips(got, ref, DECODE_TOL_MLA)
    assert ok, bad


def test_decode_cache_rows_match_reference(ref_params):
    """Four teacher-forced decode steps under ``:fused`` in f32
    activations (per-slot ``cur_len``, one slot a step behind): the latent
    and rope-key rows both caches hold agree within one bf16 rounding step
    of the largest value, and the rows not yet written stay zero.  (In
    bf16 activations the two frameworks round at other places, and a
    layer-0 routing flip moves a whole layer-1 row.)"""
    rparams, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    params = params_from_numpy(nparams, device="cpu")
    toks = _tokens(rcfg.vocab, (2, 4), seed=3)
    rcache = rmodel.init_cache(rcfg, 2, 8)
    pcache = pmodel.init_cache(pcfg, 2, 8, device="cpu")
    rstep = jax.jit(lambda p, c, t, n: rmodel.decode_step(p, rcfg, c, t, n))
    with torch.no_grad():
        for t in range(4):
            cur = np.array([t + 1, t], np.int32)
            _, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.asarray(cur))
            _, pcache = pmodel.decode_step(
                params, pcfg, pcache, torch.from_numpy(toks[:, t:t + 1]),
                torch.from_numpy(cur))
    for name in ("latent", "k_rope"):
        r = np.asarray(jnp.asarray(rcache[name], jnp.float32))
        p = pcache[name].float().numpy()
        assert np.abs(p - r).max() <= 2.0 ** -7 * np.abs(r).max(), name
        assert r[:, 0, :4].any() and r[:, 1, :3].any()
        assert not p[:, 0, 4:].any() and not p[:, 1, 3:].any()


def test_runtime_tokens_match_reference(ref_params):
    """The two serving runtimes' greedy tokens on carried-across weights
    (the reference under ``ozimmu_h-4:df32``, the port ``:fused`` through
    its kernels' plain versions; 2 slots, 3 requests), and the
    weight-split hit rate 1.0."""
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch.serving import ServingRuntime
    rparams, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    prompts = [_tokens(rcfg.vocab, (6,), seed=s) for s in range(3)]
    refs = RRuntime(rcfg, rparams, slots=2, max_len=16).generate(
        [p.copy() for p in prompts], 3)
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=16, device="cpu")
    outs = prt.generate([p.copy() for p in prompts], 3)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert prt.metrics.summary()["split_cache"][
        "weight_split_hit_rate"] == 1.0


def test_launch_counts_per_model_step(monkeypatch):
    """Under ``:fused`` with the weight splits frozen, one model step runs
    (per layer) 19 split launches (9 projection A sides: the six MLA
    projections and the three shared-expert ones; both sides of the 2
    attention products and of the 3 expert products), 14 contractions of
    4 group GEMMs each and one df32 epilogue a contraction; plus the LM
    head's split, 4 group GEMMs and epilogue.  The up-projections' A side
    is the whole cache (slots x max_len = 32 rows), so their 8 group GEMMs
    a layer take the large route on the card and every other one the
    skinny route (``group_gemm.route`` on the shapes handed over).
    Counted at the kernel wrappers, on the CPU."""
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

    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=FUSED)
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
    n = cfg.n_layers
    assert counts == {"split": n * 19 + 1, "group_gemm": (n * 14 + 1) * 4,
                      "epilogue": n * 14 + 1, "large": n * 8}


def test_launcher_serves_the_mla_arch(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek_v2_236b``
    serves the smoke config."""
    from repro_torch.launch import serve
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out
