"""The port's MoE family (deepseek-moe-16b) against the reference.

``smoke()`` config (2 layers, d 64, 8 experts, top 2, 1 shared expert,
vocab 256), weights initialized by the JAX model and carried across with
``params_from_numpy``; activations f32 unless a test says otherwise.

What is held, and how tightly:

* the expert contraction ``engine.dot_general(buf, w, _EXPERT_DNUMS)``
  (an E-batched product) bit for bit, with half of ``buf``'s rows zero as
  a decode step's dispatch buffer has them, under ``ozimmu_h-4:df32`` and
  ``:fused`` (the reference's Pallas kernels in interpret mode);
* the routing (top-k experts, kept pairs, queue slots) equal on the seeded
  inputs below.  ``torch.topk`` and ``lax.top_k`` order near-ties
  differently and the router's f32 product may differ in its last bit
  across the frameworks, so equality is a property of these inputs, which
  hold no near-tie;
* ``moe_ffn`` within ``1e-5 * max|y|`` (softmax, silu and the f32 router
  differ by an ulp between XLA and PyTorch), including a case where a
  skewed router overflows the capacity and pairs are dropped;
* whole-model logits within ``1e-4 * max|logit|`` per token, with routing
  flips allowed only where isolated (at most one bad token a sequence,
  never two in a row: the reference's rule, ``tests/test_models.py``);
  the port's own teacher-forced ``decode_step`` against its ``forward``
  by the same rule at the reference's ``DECODE_TOL["moe"]``;
* greedy tokens of the two serving runtimes equal.

The reference side of a whole-model comparison under
``ozimmu_h-4:df32:fused`` runs ``ozimmu_h-4:df32`` (its XLA path), whose
contractions the reference holds bit-identical to ``:fused``
(``tests/test_fused_pipeline.py``); the expert contraction above is held
against the reference's ``:fused`` path itself.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from repro import configs as R_configs
from repro.core.engine import make_engine as R_make_engine
from repro.models import api as R_api
from repro.models import common as R_common
from repro.models import moe as R_moe
from repro.serving import presplit as R_presplit
from repro_torch import configs as P_configs
from repro_torch.core.engine import make_engine as P_make_engine
from repro_torch.distributed import compat as P_compat
from repro_torch.models import api as P_api
from repro_torch.models import common as P_common
from repro_torch.models import moe as P_moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import presplit as P_presplit

torch.set_num_threads(1)

ARCH = "deepseek_moe_16b"
FUSED = "ozimmu_h-4:df32:fused"
REF_SPEC = {FUSED: "ozimmu_h-4:df32", "f32": "f32"}
DECODE_TOL_MOE = 5e-2          # the reference's DECODE_TOL["moe"]


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
    return params, jax.tree.map(np.asarray, params), axes


def _layer0_moe(nparams):
    return {k: (v[0] if not isinstance(v, dict)
                else {kk: vv[0] for kk, vv in v.items()})
            for k, v in nparams["layers"]["moe"].items()}


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _ref_routing(x, router, cfg):
    """The reference's routing lines (``moe.py:74-93``) on ``x``."""
    T_ = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.topk
    cap = max(8, -(-int(T_ * K * cfg.capacity_factor / E) // 8) * 8)
    gates = jax.nn.softmax(R_moe._router_gates(
        jnp.asarray(x).reshape(T_, -1), jnp.asarray(router)), axis=-1)
    _, sel = lax.top_k(gates, K)
    flat = jax.nn.one_hot(sel, E, dtype=jnp.int32).reshape(T_ * K, E)
    pos = (jnp.cumsum(flat, axis=0) * flat).max(axis=-1) - 1
    keep = (pos >= 0) & (pos < cap)
    slot = jnp.where(keep, pos, cap)
    return cap, np.asarray(sel), np.asarray(keep), np.asarray(slot)


def _port_routing(x, router, cfg):
    T_ = x.shape[0] * x.shape[1]
    cap = P_moe._capacity(cfg, T_)
    gates = torch.softmax(P_moe._router_gates(
        torch.from_numpy(np.array(x)).reshape(T_, -1),
        torch.from_numpy(np.array(router))), dim=-1)
    _, sel, _, slot, keep = P_moe._route(gates, cfg.topk, cap)
    return cap, sel.numpy(), keep.numpy(), slot.numpy()


def _isolated_flips(got, ref, tol):
    """``(ok, bad)``: per-token errors over ``max|ref|`` at or above
    ``tol`` are routing flips, allowed only where isolated."""
    scale = float(np.abs(ref).max()) + 1e-9
    bad = np.abs(got - ref).max(axis=-1) / scale >= tol       # (B, L)
    consec = (bad[:, 1:] & bad[:, :-1]).any()
    return bad.sum(axis=1).max(initial=0) <= 1 and not consec, bad


# ---------------------------------------------------------------------------
# the MoE FFN and its expert contraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [FUSED, "ozimmu_h-4:df32"])
@pytest.mark.parametrize("which", ["gate", "down"])
def test_expert_contraction_bitwise(spec, which):
    """The E-batched expert product, half of the dispatch buffer's rows
    zero (a zero row maximum: its scale and digits must be the
    reference's), bit for bit."""
    rng = np.random.default_rng(3)
    E, cap, d, fe = 8, 8, 64, 32
    n, p = (d, fe) if which == "gate" else (fe, d)
    buf = rng.standard_normal((E, cap, n)).astype(np.float32)
    buf[:, cap // 2:] = 0.0
    buf[1] = 0.0                       # an expert no token reached
    w = (rng.standard_normal((E, n, p)) * E ** -0.5).astype(np.float32)
    ref = R_make_engine(spec).dot_general(jnp.asarray(buf), jnp.asarray(w),
                                          R_moe._EXPERT_DNUMS)
    out = P_make_engine(spec).dot_general(torch.from_numpy(buf),
                                          torch.from_numpy(w),
                                          P_moe._EXPERT_DNUMS)
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert not out[:, cap // 2:].any() and not out[1].any()


@pytest.mark.parametrize("case", ["f32", "fused", "fused-drops"])
def test_moe_ffn_matches_reference(ref_params, case):
    """One layer's MoE FFN on seeded ``x``: the routing equal, the output
    within 1e-5 of max|y|.  ``fused-drops``: a router skewed toward
    experts 0 and 1 sends every token there, so each gets 16 pairs for 8
    slots and the later 8 are dropped (token-major order)."""
    _, nparams, _ = ref_params
    spec = "f32" if case == "f32" else FUSED
    rcfg = R_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype="float32")
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype="float32")
    lp = _layer0_moe(nparams)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, rcfg.d_model)).astype(np.float32)
    if case == "fused-drops":
        x = np.abs(x) + 0.5
        lp["router"] = lp["router"].copy()
        lp["router"][:, 0] += 0.6
        lp["router"][:, 1] += 0.3
    r_route, p_route = (_ref_routing(x, lp["router"], rcfg),
                        _port_routing(x, lp["router"], pcfg))
    for a, b in zip(p_route, r_route):
        np.testing.assert_array_equal(a, b)
    keep = p_route[2]
    assert (not keep.all()) == (case == "fused-drops")
    if case == "fused-drops":
        assert keep.sum() == 16 and set(p_route[1].ravel()) == {0, 1}

    ref = np.asarray(R_moe.moe_ffn(jax.tree.map(jnp.asarray, lp), rcfg,
                                   jnp.asarray(x)))
    out = P_moe.moe_ffn(params_from_numpy(lp, device="cpu"), pcfg,
                        torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_a2a_without_a_mesh_is_the_scatter_path(ref_params):
    """``full()`` sets ``moe_dispatch="a2a"``: with no mesh it is
    ``moe_ffn`` (the reference's own branch), under a mesh-native spec
    too; under a data axis that does not divide the 8 experts (3 ranks)
    it is ``moe_ffn`` too, the reference's fallback (the all-to-all over a
    dividing axis is ``tests/test_torch_moe_a2a.py``'s); an unknown family
    (``get_model`` looks it up as the reference's
    ``_FAMILY_MODULES[cfg.family]`` does) and a family that is not a MoE
    one raise."""
    _, nparams, _ = ref_params
    pcfg = P_configs.get_config(ARCH, smoke=True, dtype="float32",
                                engine_spec=FUSED)
    assert pcfg.moe_dispatch == "a2a"
    lp = params_from_numpy(_layer0_moe(nparams), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, pcfg.d_model)).astype(np.float32))
    assert torch.equal(P_moe.moe_ffn_dispatch(lp, pcfg, x),
                       P_moe.moe_ffn(lp, pcfg, x))
    mcfg = pcfg.with_(engine_spec="ozimmu_h-4:df32@model")
    assert torch.equal(P_moe.moe_ffn_dispatch(lp, mcfg, x),
                       P_moe.moe_ffn(lp, mcfg, x))
    # the mesh surface moe_ffn_a2a reads, for a data axis of 3 ranks (a
    # real one needs 3 processes); 8 % 3 != 0, so no collective runs
    data_mesh = types.SimpleNamespace(empty=False, axis_names=("data",),
                                      shape={"data": 3}, coord={"data": 0},
                                      rank=0)
    with P_compat.set_mesh(data_mesh):
        assert torch.equal(P_moe.moe_ffn_dispatch(lp, pcfg, x),
                           P_moe.moe_ffn(lp, pcfg, x))
    with pytest.raises(KeyError, match="audio"):
        P_api.get_model(pcfg.with_(family="audio"))
    with pytest.raises(ValueError, match="not a MoE family"):
        P_moe.init(pcfg.with_(family="dense"),
                   generator=torch.Generator(), device="cpu")


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
    reference's ``test_decode_matches_forward`` for the port): bf16 K/V
    cache, so the reference's ``DECODE_TOL["moe"]`` and isolation rule."""
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
    ok, bad = _isolated_flips(got, ref, DECODE_TOL_MOE)
    assert ok, bad


def test_runtime_tokens_match_reference(ref_params):
    """The two serving runtimes' greedy tokens on carried-across weights
    (the reference under ``ozimmu_h-4:df32``, the port ``:fused`` through
    its kernels' plain versions), and the weight-split hit rate 1.0."""
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
    (per layer) 17 split launches (7 projection A sides, both sides of the
    2 attention products, both sides of the 3 expert products: the expert
    weights split every step), 12 contractions of 4 group GEMMs each, and
    one df32 epilogue a contraction; plus the LM head's split, 4 group
    GEMMs and epilogue.  The router launches none.  Counted at the kernel
    wrappers the card's launch counts sit in, on the CPU."""
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
    assert counts == {"split": n * 17 + 1, "group_gemm": (n * 12 + 1) * 4,
                      "epilogue": n * 12 + 1}


def test_launcher_serves_the_moe_arch(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek_moe_16b``
    serves the smoke config (``--full`` the published one)."""
    from repro_torch.launch import serve
    s = serve.main(["--arch", ARCH, "--slots", "2", "--requests", "3",
                    "--prompt-len", "5", "--gen", "3", "--max-len", "16",
                    "--engine", FUSED, "--device", "cpu"])
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# parameters: layout, conversion, frozen paths
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(ref_params):
    """The port's own init has the reference's tree, shapes, f32 dtypes
    and scale rule; ``params_from_numpy`` carries the reference tree
    across unchanged; the mirrored helpers agree (``param_count``,
    ``stack_axes``); and the split cache would freeze exactly the
    reference's paths (attention, shared expert, LM head; no expert stack,
    no router)."""
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
    assert P_common.stack_axes(layer_ax) == R_common.stack_axes(layer_ax)
    assert P_common.stack_axes(layer_ax) == axes["layers"]
    want = R_presplit.wrappable_paths(rparams)
    assert P_presplit.wrappable_paths(carried) == want
    assert sorted("/".join(p[1:]) for p in want if p[0] == "layers") == [
        "attn/wk", "attn/wo", "attn/wq", "attn/wv", "moe/shared/w_down",
        "moe/shared/w_gate", "moe/shared/w_up"]
