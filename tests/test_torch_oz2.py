"""The port's Ozaki-II family and adaptive-RN splitter against the
reference, bit for bit.

Same numpy inputs through ``repro`` (JAX, x64 on; ``:fused`` and the
kernel bodies run the Pallas kernels in interpret mode, as the reference's
own tests run them) and ``repro_torch`` (CPU tensors: the kernels' plain
versions).  Everything here is exact integer arithmetic, power-of-two
scaling and TwoSum, so every digit, scale, base, ``gbase`` and result must
match to the last bit: the splitters ``split_rn`` and the four oz2/fast2
splitters (library and fused), ``matmul_oz2`` for ``oz2_b``/``oz2_h`` in
full, ``:fast`` and ``:fast2`` mode with f64/f32/df32 accumulators on both
paths, ``ozimmu_rn``, the batched dimension numbers, frozen B splits, and
the plain versions of the three Ozaki-II epilogue kernels.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import accumulate as R_acc
from repro.core import ozimmu as R
from repro.core import split_cache as R_sc
from repro.core import splitting as R_split
from repro.kernels import ops as jops
from repro_torch.core import accumulate as P_acc
from repro_torch.core import ozimmu as P
from repro_torch.core import split_cache as P_sc
from repro_torch.core import splitting as P_split
from repro_torch.kernels import ops as tops
from repro_torch.kernels import scale_accum as P_sa
from tests.conftest import make_phi_matrix
from tests.test_torch_kernels import _assert_bitwise, _hostile

torch.set_num_threads(1)

SPLITTERS = ["split_rn", "split_oz2", "split_oz2_bitmask", "split_oz2_fast2",
             "split_oz2_bitmask_fast2"]


def _batched_hostile(dtype, axis):
    """Two hostile matrices (zero, subnormal, wide-spread and sign-flipped
    rows) as one batch of 2; transposed for the column-scale axis."""
    rng = np.random.default_rng(21)
    a = np.stack([_hostile(rng, 11, 37, dtype) for _ in range(2)])
    if axis == 1:
        a = np.ascontiguousarray(np.swapaxes(a, -1, -2))
    return a


def _assert_split(out, ref):
    _assert_bitwise(out.digits, ref.digits)
    _assert_bitwise(out.scale, ref.scale)
    for name in ("base", "gbase"):
        o, r = getattr(out, name), getattr(ref, name)
        assert (o is None) == (r is None), name
        if r is not None:
            _assert_bitwise(o, r)
    assert (out.beta, out.axis, out.signmag) == (ref.beta, ref.axis,
                                                 ref.signmag)


@pytest.mark.parametrize("name", SPLITTERS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_splitter_bitwise(name, dtype, axis):
    """Library splitters, batched, on hostile rows (the subnormal row
    under the reference's flush-to-zero arithmetic, which the port
    flushes explicitly)."""
    a = _batched_hostile(dtype, axis)
    ref = getattr(R_split, name)(jnp.asarray(a), 4, axis=axis)
    out = getattr(P_split, name)(torch.from_numpy(a), 4, axis=axis)
    _assert_split(out, ref)


@pytest.mark.parametrize("mode", ["oz2_rn", "oz2_bitmask", "oz2_rn_fast2",
                                  "oz2_bitmask_fast2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_fused_oz2_modes_bitwise(mode, dtype, axis):
    """The fused split's oz2 modes: the global grid broadcast onto the
    per-row reciprocal grid equals the reference's constant-grid kernel
    (rank 2) and its batched broadcast."""
    a = _batched_hostile(dtype, axis)
    for x in (a[0], a):
        ref = jops.split_fused(jnp.asarray(x), 4, 7, mode=mode, axis=axis)
        out = tops.split_fused(torch.from_numpy(x), 4, 7, mode=mode,
                               axis=axis)
        _assert_split(out, ref)


def _operands(m=9, n=40, p=7, seed=31):
    """phi = 1 inputs with a row/column exponent spread of 2^+-10, where
    the global oz2 grid and the per-row fast2 grids differ."""
    rng = np.random.default_rng(seed)
    a = make_phi_matrix(rng, m, n, phi=1.0) * 2.0 ** rng.integers(
        -10, 10, (m, 1))
    b = make_phi_matrix(rng, n, p, phi=1.0) * 2.0 ** rng.integers(
        -10, 10, (1, p))
    return a, b


def _both(spec, a, b, dnums=(((1,), (0,)), ((), ())), presplit=False):
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    rsp = R_sc.SplitCache().get(jb, dnums, rcfg) if presplit else None
    psp = P_sc.SplitCache().get(tb, dnums, pcfg) if presplit else None
    ref = R.ozimmu_dot_general(ja, jb, dnums, rcfg, rhs_presplit=rsp)
    out = P.ozimmu_dot_general(ta, tb, dnums, pcfg, rhs_presplit=psp)
    return np.asarray(ref), out.numpy()


OZ2_SPECS = [f"{v}-4:{acc}{mode}{path}" for v in ("oz2_b", "oz2_h")
             for mode in ("", ":fast", ":fast2")
             for acc in ("f64", "f32", "df32") for path in ("", ":fused")]


@pytest.mark.parametrize("spec", OZ2_SPECS)
def test_matmul_oz2_bitwise(spec):
    a, b = _operands()
    ref, out = _both(spec, a, b)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", ["oz2_h-6:f64", "oz2_b-5:df32:fast:fused",
                                  "oz2_h-6:f32:fast2:fused"])
def test_matmul_oz2_k_and_length_bitwise(spec):
    """Larger k and a longer contraction (n = 256): several chunks and
    ladder windows of more than one group."""
    a, b = _operands(m=6, n=256, p=5, seed=32)
    ref, out = _both(spec, a, b)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", [f"ozimmu_rn-{k}:{acc}{path}"
                                  for k, acc in ((4, "f64"), (5, "f32"),
                                                 (6, "df32"))
                                  for path in ("", ":fused")])
def test_ozimmu_rn_bitwise(spec):
    a, b = _operands(seed=33)
    ref, out = _both(spec, a, b)
    np.testing.assert_array_equal(out, ref)


ATTN_DNUMS = (((4,), (3,)), ((0, 2), (0, 2)))


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2:fused",
                                  "oz2_b-5:f64", "oz2_h-4:f32:fast:fused"])
def test_oz2_batched_dnums_bitwise(spec):
    """The attention-score contraction: one global grid per batch element
    (B, KV), per-row fast2 grids within each."""
    rng = np.random.default_rng(34)
    q = rng.standard_normal((2, 5, 2, 3, 16)) * 2.0 ** rng.integers(
        -6, 6, (2, 1, 2, 1, 1))
    k = rng.standard_normal((2, 6, 2, 16)) * 2.0 ** rng.integers(
        -8, 8, (2, 6, 2, 1))
    ref, out = _both(spec, q, k, ATTN_DNUMS)
    assert out.shape == (2, 2, 5, 3, 6)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2:fused", "oz2_b-4:f64",
                                  "oz2_h-4:f32:fast", "ozimmu_rn-4:f64"])
def test_presplit_bitwise(spec):
    """A frozen B split (gbase included) gives the reference's cached
    result and the port's own uncached one."""
    a, b = _operands(seed=35)
    ref, out = _both(spec, a, b, presplit=True)
    np.testing.assert_array_equal(out, ref)
    _, uncached = _both(spec, a, b)
    np.testing.assert_array_equal(out, uncached)


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2:fused",
                                  "oz2_b-4:f64:fast"])
def test_presplit_weight_carries_gbase(spec):
    """Stacked weights freeze per layer with the stack axis leading; each
    layer's PresplitWeight keeps its scalar gbase, and the engine's result
    with the frozen split equals the one without (bit for bit)."""
    from repro_torch.core.engine import make_engine
    from repro_torch.serving.presplit import wrap_params
    rng = np.random.default_rng(36)
    w = torch.from_numpy(rng.standard_normal((2, 24, 10)).astype(np.float32)
                         * 2.0 ** rng.integers(-4, 4, (2, 1, 10)))
    x = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    eng = make_engine(spec)
    wrapped, cache = wrap_params({"layers": {"w_up": w}}, eng)
    pw = wrapped["layers"]["w_up"]
    assert pw.gbase is not None and tuple(pw.gbase.shape) == (2,)
    rcfg = R.parse_spec(spec)
    for i in range(2):
        layer = pw.layer(i)
        ref = R_split.split_oz2_fast2 if "fast2" in spec \
            else R_split.split_oz2_bitmask
        rsp = ref(jnp.asarray(w[i].to(eng.compute_dtype).numpy()), 4,
                  axis=1)
        _assert_bitwise(layer.gbase, rsp.gbase)
        _assert_bitwise(layer.digits, rsp.digits)
        assert layer.split == rcfg.split
        out = eng(x, layer)
        np.testing.assert_array_equal(out.numpy(), eng(x, w[i]).numpy())
    assert cache.stats.misses == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gbases", [(100, 100), (120, 20), (60, 60)])
def test_oz2_window_scales_bitwise(gbases, dtype):
    """The ladder windows' scalar scales against the reference's
    ``_oz2_scale``, bitwise, where the half-exponent factor
    ``2^(-beta*(g//2))`` is subnormal in f32 (g >= 38 at beta 7): XLA reads
    it as zero, so the scale is zero however large the bases."""
    beta, gs = 7, (36, 38, 40, 44)
    ga = np.array([2.0 ** gbases[0], 2.0 ** -gbases[0]], dtype)
    gb = np.array([2.0 ** gbases[1], 1.0], dtype)
    for acc_dtype in {np.float32, dtype}:
        tdt = torch.float32 if acc_dtype == np.float32 else torch.float64
        out = P_acc._oz2_scales(torch.from_numpy(ga), torch.from_numpy(gb),
                                beta, gs, tdt)
        for i, g in enumerate(gs):
            ref = R_acc._oz2_scale(jnp.asarray(ga), jnp.asarray(gb), beta, g,
                                   acc_dtype)
            _assert_bitwise(out[i], ref)


def _epilogue(rng, batch=(2,), m=5, p=11, word=np.int32):
    lo, hi = (-2 ** 62, 2 ** 62) if word == np.int64 else (-2 ** 31,
                                                          2 ** 31)
    w = rng.integers(lo, hi, batch + (m, p)).astype(word)
    s = (2.0 ** rng.integers(-60, -20, batch))
    c = rng.standard_normal(batch + (m, p))
    return w, s, c


def test_scale_accum_const_plain_version_bitwise():
    """df32 ladder window: the reference's const-scale kernel body."""
    rng = np.random.default_rng(41)
    w, s, c = _epilogue(rng)
    hi = c.astype(np.float32)
    lo = (hi * 2.0 ** -26).astype(np.float32)
    s = s.astype(np.float32)
    r_hi, r_lo = jops.oz2_scale_accum(*map(jnp.asarray, (w, s, hi, lo)))
    t_hi, t_lo = P_sa.scale_accum_const_ref(*map(torch.from_numpy,
                                                  (w, s, hi, lo)))
    _assert_bitwise(t_hi, r_hi)
    _assert_bitwise(t_lo, r_lo)


@pytest.mark.parametrize("word,dtype", [(np.int32, np.float32),
                                        (np.int32, np.float64),
                                        (np.int64, np.float64)])
def test_scale_accum_const_plain_plain_version_bitwise(word, dtype):
    """Plain ladder window, the int64 word (f64 ladder) included."""
    rng = np.random.default_rng(42)
    w, s, c = _epilogue(rng, word=word)
    s, c = s.astype(dtype), c.astype(dtype)
    ref = jops.oz2_scale_accum_plain(*map(jnp.asarray, (w, s, c)))
    out = P_sa.scale_accum_const_plain_ref(*map(torch.from_numpy, (w, s, c)))
    _assert_bitwise(out, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unscale_plain_version_bitwise(dtype):
    rng = np.random.default_rng(43)
    x = rng.standard_normal((2, 5, 11)).astype(dtype)
    ra = (2.0 ** rng.integers(-20, 20, (2, 5))).astype(dtype)
    rb = (2.0 ** rng.integers(-20, 20, (2, 11))).astype(dtype)
    ref = jops.oz2_unscale(*map(jnp.asarray, (x, ra, rb)))
    out = P_sa.unscale_ref(*map(torch.from_numpy, (x, ra, rb)))
    _assert_bitwise(out, ref)


def test_oz2_wrappers_take_plain_version_only_on_cpu():
    """A non-CPU tensor never reaches a plain version: the new wrappers
    launch the kernel or raise (the meta device has no kernel)."""
    w = torch.empty((2, 4, 4), dtype=torch.int32, device="meta")
    s = torch.empty((2,), device="meta")
    c = torch.empty((2, 4, 4), device="meta")
    v = torch.empty((2, 4), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        P_sa.scale_accum_const(w, s, c, c)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        P_sa.scale_accum_const_plain(w, s, c)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        P_sa.unscale(c, v, v)
