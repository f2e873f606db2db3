"""The port's mesh layer on 4 gloo ranks on the CPU (one spawn for the
file, shared by its cases; ``tests/torch_mesh_worker.py`` runs the ranks):

* ``@model`` / ``@model/int32`` for every variant, plain and ``:fused``,
  f32 and df32 accumulators, with and without a frozen B split, f64 once
  and the VJP's two cotangents once: bitwise the port's single-device
  result on every rank, with one max a split and one sum a contraction;
* the same held to the reference: one spec a variant (with and without
  the frozen split) and f64 bitwise to its own int32 sharded body (its
  ``_bmm_local`` with ``pmax_scales`` / ``psum_exact_int32`` hooks) under
  ``jax.vmap(axis_name="model")`` on the same shards, and the VJP's
  cotangents to its single-device ``jax.vjp``, which its int32 strategy
  equals bit for bit;
* ``@model/df32`` bitwise to the reference's own sharded body (its
  ``_bmm_local(..., partial=True)`` and ``collectives.psum_df32``) run
  under ``jax.vmap(axis_name="model")`` on the same shards, plain and
  ``:fused``, and the compensated f32/f64 folds to the reference's
  ``psum_compensated`` the same way: the reference's own mesh tests need
  8 forced host devices and fail on this JAX;
* the collectives' contracts (the int32 sum refusing floats with the
  reference's text, the df32 fold keeping what an f32 sum loses).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import ozimmu as R_oz
from repro.distributed import collectives as R_coll
from repro_torch.distributed import collectives as P_coll
from tests.torch_mesh_worker import spawn

WORLD = 4
VARIANTS = ("ozimmu", "ozimmu_rn", "ozimmu_ef", "ozimmu_h", "ozimmu_sm_b",
            "ozimmu_sm_h", "oz2_b", "oz2_h")
# the Ozaki-II variants under both fast modes (the reference's presplit
# sweep covers :fast and :fast2 the same way)
FAST = {"oz2_h": ":fast", "oz2_b": ":fast2"}
INT32_SPECS = [
    f"{name}-{5 if name.startswith('oz2') else 6}:{accum}"
    f"{FAST.get(name, '')}{fused}@model"
    for name in VARIANTS for fused in ("", ":fused")
    for accum in ("f32", "df32")
    if not (fused and name == "ozimmu_rn")]  # adaptive RN has no :fused
F64_SPEC = "ozimmu_h-6:f64:fused@model/int32"
VJP_SPEC = "ozimmu_h-5:df32:fused@model"
# one int32 spec a variant, held to the reference's sharded body; plain
# and :fused, f32 and df32 and both Ozaki-II fast modes among them
REF_INT32_SPECS = ["ozimmu-6:df32:fused@model", "ozimmu_rn-6:f32@model",
                   "ozimmu_ef-6:df32@model", "ozimmu_h-6:f32:fused@model",
                   "ozimmu_sm_b-6:df32:fused@model", "ozimmu_sm_h-6:f32@model",
                   "oz2_b-5:df32:fast2:fused@model", "oz2_h-5:f32:fast@model"]
DN = (((1,), (0,)), ((), ()))
DF32_SPECS = ["ozimmu_h-4:df32@model/df32", "ozimmu_h-4:df32:fused@model/df32",
              "oz2_h-4:df32:fast2:fused@model/df32",
              "ozimmu_h-5:f32@model/df32"]


def phi_mat(rng, m, n, phi=1.0):
    u = rng.uniform(0, 1, (m, n))
    z = rng.standard_normal((m, n))
    return (u - 0.5) * np.exp(phi * z)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    parts = rng.standard_normal((WORLD, 8, 16)) * np.exp(
        8 * rng.standard_normal((WORLD, 8, 16)))
    return dict(
        a=f32(phi_mat(rng, 48, 256)), b=f32(phi_mat(rng, 256, 64)),
        g=f32(rng.standard_normal((48, 64))),
        a64=torch.from_numpy(phi_mat(rng, 32, 256, 2.0)),
        b64=torch.from_numpy(phi_mat(rng, 256, 32, 2.0)),
        part32=f32(parts), part64=torch.from_numpy(parts * np.pi),
        int32_specs=INT32_SPECS, f64_spec=F64_SPEC, vjp_spec=VJP_SPEC,
        df32_specs=DF32_SPECS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs and every rank's results of the ``contractions`` job."""
    x = _inputs()
    return x, spawn("contractions", WORLD, tmp_path_factory.mktemp("mesh"),
                    x)


def _same_on_every_rank(results, get):
    first = get(results[0])
    for r, res in enumerate(results[1:], 1):
        other = get(res)
        if isinstance(first, tuple):
            assert all(torch.equal(p, q) for p, q in zip(first, other)), r
        else:
            assert torch.equal(first, other), r
    return first


def _splits_pmax(spec: str, splits: int) -> int:
    """Maxima a contraction agrees: one a split, k a split for the
    adaptive RN splitter (a fresh maximum per slice)."""
    cfg = R_oz.parse_spec(spec)
    return splits * (cfg.k if cfg.split == "rn" else 1)


@pytest.mark.parametrize("spec", INT32_SPECS)
def test_int32_sharded_bitwise(run, spec):
    """Contraction sharded over 4 ranks == the port's single-device
    emulation, bit for bit, identical on every rank; two splits agree
    their maxima and the stacked products are summed once."""
    _, res = run
    got = _same_on_every_rank(res, lambda r: r["int32"][spec])
    assert torch.equal(got, res[0]["ref"][spec]), spec
    assert res[0]["int32_counts"][spec] == {
        "pmax_scales": _splits_pmax(spec, 2), "psum_exact_int32": 1,
        "psum_df32": 0, "psum_compensated": 0}


@pytest.mark.parametrize("spec", INT32_SPECS)
def test_presplit_sharded_bitwise(run, spec):
    """A frozen full-matrix B split read in rank ranges (views of its
    K-major digits) == the single-device presplit path and the sharded
    uncached path, bit for bit; only A is split."""
    _, res = run
    got = _same_on_every_rank(res, lambda r: r["presplit"][spec])
    assert torch.equal(got, res[0]["ref"]["presplit " + spec]), spec
    assert torch.equal(got, res[0]["int32"][spec]), spec
    assert res[0]["presplit_counts"][spec] == {
        "pmax_scales": _splits_pmax(spec, 1), "psum_exact_int32": 1,
        "psum_df32": 0, "psum_compensated": 0}


def _shards(a, b):
    """``a``'s columns and ``b``'s rows in ``WORLD`` contraction ranges,
    stacked along a leading axis for ``jax.vmap``."""
    return (jnp.asarray(np.stack(np.split(a, WORLD, axis=-1))),
            jnp.asarray(np.stack(np.split(b, WORLD, axis=-2))))


def _ref_int32_body(spec, a, b):
    """The reference's ``@axis/int32`` body (its ``_sharded_fn``, without
    ``shard_map``) on ``a`` @ ``b`` under ``jax.vmap(axis_name="model")``;
    every rank's row must be the same."""
    cfg = R_oz.canonical_fast2(R_oz.parse_spec(spec))

    def body(al, bl):
        return R_oz._bmm_local(
            al, bl, cfg.local(), n_total=a.shape[-1],
            rowmax_reduce=lambda v: R_coll.pmax_scales(v, "model"),
            product_reduce=lambda p: R_coll.psum_exact_int32(p, "model"))
    out = np.asarray(jax.jit(jax.vmap(body, axis_name="model"))(
        *_shards(a, b)))
    assert all(np.array_equal(o, out[0]) for o in out), spec
    return out[0]


@pytest.fixture(scope="module")
def ref_int32(run):
    """The reference's int32 sharded body for :data:`REF_INT32_SPECS` and
    the f64 spec, and its single-device VJP of the VJP spec (jitted)."""
    x, _ = run
    a, b = x["a"].numpy(), x["b"].numpy()
    out = {spec: _ref_int32_body(spec, a, b) for spec in REF_INT32_SPECS}
    out["f64"] = _ref_int32_body(F64_SPEC, x["a64"].numpy(),
                                 x["b64"].numpy())
    cfg = R_oz.parse_spec(VJP_SPEC)
    vjp = jax.jit(lambda p, q, g: jax.vjp(
        lambda p, q: R_oz.ozimmu_dot_general(p, q, DN, cfg), p, q)[1](g))
    out["vjp"] = tuple(np.asarray(t) for t in vjp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(x["g"].numpy())))
    return out


@pytest.mark.parametrize("spec", REF_INT32_SPECS)
def test_int32_matches_reference_sharded_body(run, ref_int32, spec):
    """``@model/int32``, uncached and with a frozen B split, on every
    rank: the reference's int32 sharded body's bits."""
    _, res = run
    want = ref_int32[spec]
    for key in ("int32", "presplit"):
        got = _same_on_every_rank(res, lambda r: r[key][spec]).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), (key, spec)


def test_f64_sharded_bitwise(run, ref_int32):
    """f64 operands and accumulator: the port's single-device result and
    the reference's int32 sharded body, bit for bit."""
    _, res = run
    got = _same_on_every_rank(res, lambda r: r["f64"])
    assert got.dtype == torch.float64
    assert torch.equal(got, res[0]["ref"]["f64"])
    assert np.array_equal(got.numpy(), ref_int32["f64"])


def test_vjp_sharded_bitwise(run, ref_int32):
    """Both cotangents of a sharded contraction (each itself a sharded
    contraction, over p and over m) == the port's single-device VJP and
    the reference's ``jax.vjp``."""
    _, res = run
    da, db = _same_on_every_rank(res, lambda r: r["vjp"])
    ra, rb = res[0]["ref"]["vjp"]
    assert torch.equal(da, ra) and torch.equal(db, rb)
    ja, jb = ref_int32["vjp"]
    assert np.array_equal(da.numpy(), ja) and np.array_equal(db.numpy(), jb)
    assert res[0]["vjp_counts"]["psum_exact_int32"] == 3
    assert res[0]["vjp_counts"]["pmax_scales"] == 6


@pytest.fixture(scope="module")
def ref_bodies(run):
    """The reference's sharded body of each df32-strategy spec under
    ``jax.vmap(axis_name="model")`` over the stacked contraction shards
    (its ``_sharded_fn`` body, without ``shard_map``)."""
    x, _ = run
    a, b = x["a"].numpy(), x["b"].numpy()
    n = a.shape[-1]
    ash, bsh = _shards(a, b)
    out = {}
    for spec in DF32_SPECS:
        cfg = R_oz.canonical_fast2(R_oz.parse_spec(spec))

        def body(al, bl, cfg=cfg):
            part = R_oz._bmm_local(al, bl, cfg.local(), n_total=n,
                                   partial=True)
            if isinstance(part, R_coll.DF32):
                return R_coll.psum_df32(part, "model").to_float(jnp.float32)
            return R_coll.psum_compensated(part, "model").astype(
                jnp.float32)
        out[spec] = np.asarray(jax.jit(jax.vmap(body, axis_name="model"))(
            ash, bsh))
    return out


@pytest.mark.parametrize("spec", DF32_SPECS)
def test_df32_matches_reference_sharded_body(run, ref_bodies, spec):
    """``@model/df32``: each rank's partial accumulator on local grids,
    folded in rank order — the reference's sharded body's bits, the same
    on every rank."""
    _, res = run
    got = _same_on_every_rank(res, lambda r: r["df32"][spec]).numpy()
    want = ref_bodies[spec]
    assert all(np.array_equal(w, want[0]) for w in want)
    assert np.array_equal(got, want[0]), spec


@pytest.mark.parametrize("which", ["comp32", "comp64"])
def test_compensated_fold_matches_reference(run, which):
    """``psum_compensated`` on f32 / f64 partials spanning ~2^±24: the
    reference's Neumaier fold under a named vmap axis, bit for bit."""
    x, res = run
    parts = x["part32" if which == "comp32" else "part64"].numpy()
    want = np.asarray(jax.vmap(lambda p: R_coll.psum_compensated(
        p, "model"), axis_name="model")(jnp.asarray(parts)))
    for r, out in enumerate(res):
        assert out[which].dtype == torch.from_numpy(parts).dtype
        assert np.array_equal(out[which].numpy(), want[r]), r


def test_psum_df32_keeps_what_an_f32_sum_loses(run):
    """hi = (-1)^r 2^25, lo = 1 on 4 ranks: a plain f32 sum of hi + lo
    gives 0 (each partial rounds back to +-2^25), the df32 fold gives 4 —
    the reference's case (2^24, 0.5 on 8 devices) at 4 ranks — and the
    reference's fold gives the same on these partials."""
    _, res = run
    for out in res:
        assert out["cancel"] == (0.0, 4.0)
    his = jnp.asarray([(-1.0) ** r * 2.0 ** 25 for r in range(WORLD)],
                      jnp.float32)
    acc = jax.vmap(lambda h: R_coll.psum_df32(
        R_coll.DF32(h, jnp.float32(1.0)), "model"), axis_name="model")(his)
    assert float((acc.hi + acc.lo)[0]) == 4.0


def test_psum_exact_int32_refuses_float_partials():
    """The reference's TypeError text, raised before any collective."""
    with pytest.raises(TypeError) as want:
        R_coll.psum_exact_int32(jnp.zeros(3, jnp.float32), "model")
    with pytest.raises(TypeError) as got:
        P_coll.psum_exact_int32(torch.zeros(3), "model")
    assert str(got.value) == str(want.value).replace("float32",
                                                     "torch.float32")
