"""The port's SSM family (``ssm``: mamba2-780m) against the reference.

``smoke()`` config (2 layers, d 64, d_inner 128 in 8 heads of 16, state
16, chunk 32, vocab 256), weights initialized by the JAX model and carried
across with ``params_from_numpy``; activations f32 unless a test says
otherwise.  The LM head is tied (``embed.T``): at the init's embedding
scale of 1 the residual stream is dominated by the token's own embedding
and greedy decoding echoes the last prompt token whatever the layers do,
so the model tests scale ``embed`` by ``EMBED_SCALE`` on both sides.

What is held, and how tightly:

* the parameter tree, the cache leaves and their logical axes equal to
  the reference's;
* ``ssd_chunked`` (a length that no chunk divides) and ``ssd_step``
  within ``1e-5 * max|y|`` (exp and the f32 contractions' summation order
  differ by ulps between XLA and PyTorch);
* the emulated ``w_in`` projection bit for bit under ``ozimmu_h-4:df32``
  and ``:fused``, the weight frozen or not;
* whole-model logits within ``1e-4 * max|logit|`` under ``f32`` and
  ``:fused``; the teacher-forced ``decode_step`` against ``forward`` at
  the reference's ``DECODE_TOL["ssm"]``;
* greedy tokens of the two serving runtimes equal, with whole-prompt and
  chunked prefill (the decode-side freeze of mid-prefill states);
* the launch counts a model step, and the launcher.

The reference side of a projection or whole-model comparison under
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
from repro.models import ssm as R_ssm
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.core.engine import make_engine as P_make_engine
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import ssm as P_ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit

torch.set_num_threads(1)

ARCH = "mamba2_780m"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "ozimmu_h-4:df32": "ozimmu_h-4:df32",
            "f32": "f32"}
DECODE_TOL_SSM = 5e-2          # the reference's DECODE_TOL["ssm"]
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
    cfg = R_configs.get_config(ARCH, smoke=True)
    params, axes = R_api.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    params = dict(params, embed=params["embed"] * EMBED_SCALE)
    return params, jax.tree.map(np.asarray, params), axes


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree, shapes and f32
    dtypes; its random leaves the reference's scale rule and range
    (``dt_bias`` the softplus inverse of steps in [e^-4.6, e^-1.6]), its
    fixed leaves the reference's values (``A_log``, ``D``, zeros);
    ``params_from_numpy`` carries the reference tree across unchanged;
    and the split cache would freeze exactly the reference's paths
    (``w_in`` and ``w_out``; never the tied embedding or the conv)."""
    rparams, nparams, axes = ref_params
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
        if path[-1] in ("A_log", "D") or not np.any(b):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=path)
        elif path[-1] == "dt_bias":
            step = np.log1p(np.exp(a.numpy()))
            assert step.min() >= np.exp(-4.6) * 0.999 and \
                step.max() <= np.exp(-1.6) * 1.001, path
        else:
            ratio = float(a.std()) / float(b.std())
            assert abs(ratio - 1.0) < 0.15, (path, ratio)

    walk(mine, nparams, carried)
    assert P_common.param_count(mine) == R_common.param_count(rparams)
    _, layer_ax = R_ssm.init_mamba_layer(jax.random.PRNGKey(0),
                                         R_configs.get_config(ARCH,
                                                              smoke=True))
    assert P_common.stack_axes(layer_ax) == axes["layers"]
    want = R_presplit.wrappable_paths(rparams)
    assert P_presplit.wrappable_paths(carried) == want
    assert sorted("/".join(p) for p in want) == ["layers/w_in",
                                                 "layers/w_out"]


def test_cache_layout_matches_reference():
    """``init_cache``'s conv window (bf16) and SSM state (f32), zero, and
    ``cache_axes`` equal the reference's; the slot cache finds the slot
    axis of both leaves."""
    from repro_torch.serving.kvcache import SlotCacheOps
    rcfg = R_configs.get_config(ARCH, smoke=True)
    pcfg = P_configs.get_config(ARCH, smoke=True)
    rmodel, pmodel = R_api.get_model(rcfg), P_api.get_model(pcfg)
    ref = rmodel.init_cache(rcfg, 3, 8)
    got = pmodel.init_cache(pcfg, 3, 8, device="cpu")
    assert set(got) == set(ref) == {"conv", "ssm"}
    dtypes = {"conv": torch.bfloat16, "ssm": torch.float32}
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape
        assert got[name].dtype == dtypes[name] and not got[name].any()
        assert str(ref[name].dtype) == str(dtypes[name])[6:]
    assert pmodel.cache_axes(pcfg) == rmodel.cache_axes(rcfg)
    ops = SlotCacheOps(pcfg, pmodel)
    ones = {k: torch.ones_like(v) for k, v in got.items()}
    ops.reset_slot(ones, 1, pmodel.init_cache(pcfg, 1, 8, device="cpu"))
    sel = ops.select_slots(got, ones, torch.tensor([True, False, False]))
    for name in got:
        assert not ones[name][:, 1].any() and ones[name][:, 0].all()
        assert not sel[name][:, :2].any() and sel[name][:, 2].all()


# ---------------------------------------------------------------------------
# the SSD core and the emulated projection
# ---------------------------------------------------------------------------

def _ssd_inputs(Bb, Lq, H, P, N, seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, B, C = f(Bb, Lq, H, P), f(Bb, Lq, N), f(Bb, Lq, N)
    dt = np.log1p(np.exp(f(Bb, Lq, H) - 2.0)).astype(np.float32)
    A = -np.exp(np.linspace(0.0, 2.7, H)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("Lq,chunk", [(37, 8), (16, 32)],
                         ids=["uneven-chunks", "one-chunk"])
def test_ssd_chunked_matches_reference(Lq, chunk):
    """y and the final state within 1e-5 of their max: L = 37 in chunks
    of 8 pads the last chunk with 3 zero positions; L = 16 < chunk takes
    Q = L."""
    ins = _ssd_inputs(2, Lq, 4, 16, 16)
    y_r, h_r = R_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    y_p, h_p = P_ssm.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    assert y_p.dtype == torch.float32 and h_p.dtype == torch.float32
    assert _rel(y_p.numpy(), np.asarray(y_r)) <= 1e-5
    assert _rel(h_p.numpy(), np.asarray(h_r)) <= 1e-5


def test_ssd_step_matches_reference():
    """One decode update from a nonzero state, y and h within 1e-5."""
    x, dt, A, B, C = _ssd_inputs(3, 1, 4, 16, 16, seed=6)
    h = np.random.default_rng(7).standard_normal((3, 4, 16, 16)).astype(
        np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], h)
    y_r, h_r = R_ssm.ssd_step(*map(jnp.asarray, args))
    y_p, h_p = P_ssm.ssd_step(*map(torch.from_numpy, args))
    assert _rel(y_p.numpy(), np.asarray(y_r)) <= 1e-5
    assert _rel(h_p.numpy(), np.asarray(h_r)) <= 1e-5


@pytest.mark.parametrize("spec", [FUSED, "ozimmu_h-4:df32"])
@pytest.mark.parametrize("frozen", [False, True], ids=["split", "frozen"])
def test_w_in_projection_bitwise(ref_params, spec, frozen):
    """``engine(un, w_in)`` (d 64 -> 2 d_inner + 2 N + H = 296 columns,
    the projection whose published width is 6448) bit for bit, the port's
    weight split on the call or frozen by ``wrap_params`` and sliced to
    layer 1."""
    _, nparams, _ = ref_params
    x = np.random.default_rng(8).standard_normal((3, 1, 64)).astype(
        np.float32)
    w = nparams["layers"]["w_in"]
    ref = np.asarray(R_make_engine(REF_SPEC[spec])(jnp.asarray(x),
                                                   jnp.asarray(w[1])))
    eng = P_make_engine(spec)
    if frozen:
        tree, _ = P_presplit.wrap_params(
            {"layers": {"w_in": torch.from_numpy(np.array(w))}}, eng)
        w_p = tree["layers"]["w_in"].layer(1)
    else:
        w_p = torch.from_numpy(np.array(w[1]))
    out = eng(torch.from_numpy(x), w_p).numpy()
    assert out.shape == ref.shape == (3, 1, 296)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["f32", FUSED])
def test_forward_logits_match_reference(ref_params, spec):
    """L = 40 runs the chunked scan over two chunks of 32 (the second
    padded)."""
    rparams, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(spec)
    toks = _tokens(rcfg.vocab, (2, 40))
    ref = np.asarray(jax.jit(lambda p, t: R_api.get_model(rcfg).forward(
        p, rcfg, {"tokens": t}))(rparams, jnp.asarray(toks)))
    out = P_api.get_model(pcfg).forward(
        params_from_numpy(nparams, device="cpu"), pcfg,
        {"tokens": torch.from_numpy(toks)}).numpy()
    assert out.shape == ref.shape == (2, 40, pcfg.padded_vocab)
    assert np.isfinite(out).all() and _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("spec", ["f32", FUSED])
def test_decode_matches_forward(ref_params, spec):
    """Teacher-forced ``decode_step`` (the bf16 conv window cast up and
    back every step, the f32 SSM state) against the chunked ``forward``:
    the reference's ``DECODE_TOL["ssm"]``."""
    _, nparams, _ = ref_params
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec)
    model = P_api.get_model(cfg)
    params = params_from_numpy(nparams, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 12)))
    with torch.no_grad():
        ref = model.forward(params, cfg, {"tokens": toks}).numpy()
        cache = model.init_cache(cfg, 2, 12, device="cpu")
        outs = []
        for t in range(12):
            logits, cache = model.decode_step(params, cfg, cache,
                                              toks[:, t:t + 1],
                                              torch.tensor(t + 1))
            outs.append(logits[:, 0])
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    got = torch.stack(outs, dim=1).numpy()
    assert _rel(got, ref) <= DECODE_TOL_SSM


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunked"])
def test_runtime_tokens_match_reference(ref_params, chunk):
    """The two serving runtimes' greedy tokens (the reference under
    ``ozimmu_h-4:df32``, the port ``:fused``) on prompts of 4, 7 and 5
    tokens in 2 slots: exact-length prefill buckets, and with
    ``prefill_chunk=2`` a decode step beside a mid-prefill slot (frozen by
    ``_decode_select``); the weight-split hit rate 1.0."""
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch.serving import ServingRuntime
    rparams, nparams, _ = ref_params
    rcfg, pcfg = _cfgs(FUSED)
    prompts = [_tokens(rcfg.vocab, (n,), seed=3 + n) for n in (4, 7, 5)]
    refs = RRuntime(rcfg, rparams, slots=2, max_len=32,
                    prefill_chunk=chunk).generate(
        [p.copy() for p in prompts], 5)
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=32, prefill_chunk=chunk,
                         device="cpu")
    assert prt.sched.bucket_fn(7) == 7
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
    per layer 2 contractions (``w_in``, ``w_out``: their A sides split),
    plus the tied LM head, whose B side ``embed.T`` is not frozen (as in
    the reference) and is split every step: 2 n + 2 split launches, 4 group
    GEMMs and one df32 epilogue a contraction.  The SSD, the conv and the
    gates launch none.  Counted at the kernel wrappers, on the CPU."""
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf
    from repro_torch.serving import ServingRuntime
    counts = {"split": 0, "group_gemm": 0, "epilogue": 0}

    def counting(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            counts[key] += 1
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
    assert counts == {"split": 2 * n + 2, "group_gemm": (2 * n + 1) * 4,
                      "epilogue": 2 * n + 1}


def test_launcher_serves_the_ssm_arch(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2_780m`` serves
    the smoke config (``--full`` the published one), chunked prefill
    included."""
    from repro_torch.launch import serve
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--prefill-chunk", "2",
                    "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out
