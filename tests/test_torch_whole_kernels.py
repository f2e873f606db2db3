"""The plain versions of the one-launch split and the one-launch df32
epilogue against the JAX package, bitwise, on the same numpy inputs.

On the card a split is one launch (row maxima, grids, bases, scales and
digits: ``split_fused.split_whole``) and the df32 group-EF epilogue of a
contraction is one launch over all its chunk products
(``scale_accum.scale_accum_chunks``), as is the Ozaki-II df32 epilogue
(``scale_accum.scale_accum_const_windows``: ladder fold, windows, fast2
unscale).  Their plain versions, which the CPU runs and which
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels to,
must equal the reference: the split against its Pallas kernel in
interpret mode (``repro.kernels.ops.split_fused``), the epilogues against
the reference's group-EF and Ozaki-II df32 accumulation with its XLA
epilogue (its Pallas epilogue in interpret mode keeps IEEE subnormals; see
``tests/test_torch_underflow.py``).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import accumulate as R_acc
from repro.core import ozimmu as R
from repro.core import splitting as R_split
from repro.kernels import ops as J_ops
from repro_torch.core import accumulate as P_acc
from repro_torch.core import ozimmu as P
from repro_torch.core import splitting as P_split
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import scale_accum as P_sa
from repro_torch.kernels import split_fused as P_sf
from tests.test_torch_kernels import _assert_bitwise, _hostile
from tests.test_torch_underflow import _rows, _xla_epilogues

torch.set_num_threads(1)

WHOLE_MODES = ["bitmask", "rn_const", "sm", "oz2_bitmask_fast2",
               "oz2_rn_fast2"]


def _batched_rows(kind, dtype):
    """Two batch elements of hostile rows (zero, subnormal, wide-spread and
    sign-flipped rows) or of near-underflow rows (maxima near the bottom of
    the normal range, a subnormal row)."""
    if kind == "hostile":
        rng = np.random.default_rng(21)
        return np.stack([_hostile(rng, 11, 37, dtype) for _ in range(2)])
    return np.stack([_rows(dtype, seed=s, n=37) for s in (3, 4)])


@pytest.mark.parametrize("rows", ["hostile", "underflow"])
@pytest.mark.parametrize("mode", WHOLE_MODES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_whole_split_plain_bitwise(rows, mode, dtype, axis):
    """The one-launch split's plain version (what a CPU tensor takes
    through ``ops.split_fused``) against the reference's fused split:
    digits, scales, bases and ``gbase``, batched."""
    a = _batched_rows(rows, dtype)
    x = a if axis == 0 else np.ascontiguousarray(np.swapaxes(a, -1, -2))
    beta = 8 if mode == "sm" else 7
    ref = J_ops.split_fused(jnp.asarray(x), 4, beta, mode=mode, axis=axis)
    t = torch.from_numpy(x)
    for out in (P_ops.split_fused(t, 4, beta, mode=mode, axis=axis),
                P_ops.split_fused_ref(t, 4, beta, mode=mode, axis=axis)):
        _assert_bitwise(out.digits, ref.digits)
        _assert_bitwise(out.scale, ref.scale)
        _assert_bitwise(out.base, ref.base)
        if mode.endswith("_fast2"):
            _assert_bitwise(out.gbase, ref.gbase)
        else:
            assert out.gbase is None and ref.gbase is None
        assert out.signmag == ref.signmag and out.axis == axis


@pytest.mark.parametrize("mode", ["bitmask", "rn_const", "sm"])
def test_split_whole_ref_is_the_composition(mode):
    """``split_whole_ref`` returns the pieces of the Split the wrapper
    builds: digits in K-major storage for axis 1, scales (k, *batch, r)."""
    a = torch.from_numpy(_batched_rows("hostile", np.float32))
    digits, scale, base, gbase = P_sf.split_whole_ref(
        a, k=3, beta=7, mode=mode, axis=1, gbase=True)
    sp = P_ops.split_fused(a, 3, 7, mode=mode, axis=1)
    _assert_bitwise(digits, sp.digits)
    _assert_bitwise(scale, sp.scale)
    _assert_bitwise(base, sp.base)
    assert digits.transpose(-1, -2).is_contiguous()
    assert tuple(scale.shape) == (3, 2, 37) and tuple(gbase.shape) == (2,)
    assert bool((gbase == 2.0).all())


def _splits(dtype, scale, k, batch=(), m=6, n=64, p=9, seed=5):
    """Reference and port splits (``rn_const``) of the same operands, with
    one row of A and one column of B scaled by ``scale``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(batch + (m, n))
    b = rng.standard_normal(batch + (n, p))
    a[..., 1, :] *= scale
    b[..., :, 2] *= scale
    a, b = a.astype(dtype), b.astype(dtype)
    jsa = R_split.split_rn_const(jnp.asarray(a), k, axis=0)
    jsb = R_split.split_rn_const(jnp.asarray(b), k, axis=1)
    tsa = P_split.split_rn_const(torch.from_numpy(a), k, axis=0)
    tsb = P_split.split_rn_const(torch.from_numpy(b), k, axis=1)
    return jsa, jsb, tsa, tsb


class _Spy:
    """Counts calls of the whole-contraction epilogue hook."""

    def __init__(self):
        self.calls = []
        self.hook = P_ops.scale_accum_contraction

    def __call__(self, prods, groups, *args, **kw):
        self.calls.append(list(groups))
        return self.hook(prods, groups, *args, **kw)


# (k, r, batch, scale): r = None is eq. 12's (one chunk per group at
# n = 64, so C = k); r = 1 and 2 give several chunks per group
EPILOGUES = [(4, None, (), 1.0), (4, None, (3,), 1.0), (4, 1, (), 1.0),
             (6, 2, (2,), 1.0), (5, 1, (), 1e-20), (4, None, (), 1e-30)]


@pytest.mark.parametrize("k,r,batch,scale", EPILOGUES)
@pytest.mark.parametrize("partial", [False, True])
def test_whole_epilogue_plain_bitwise(k, r, batch, scale, partial):
    """The one-launch epilogue's plain version through the
    ``epilogue_fn`` hook against the reference's group-EF df32
    accumulation (its XLA epilogue): the f32 result, or the unrounded
    (hi, lo) with ``partial``."""
    jsa, jsb, tsa, tsb = _splits(np.float32, scale, k, batch)
    ref = R_acc.matmul_group_ef(jsa, jsb, accum="df32", r=r,
                                partial=partial)
    spy = _Spy()
    out = P_acc.matmul_group_ef(tsa, tsb, accum="df32", r=r,
                                partial=partial, epilogue_fn=spy)
    want_chunks = sum(-(-(g - 1) // (r or k)) for g in range(2, k + 2))
    assert len(spy.calls) == 1 and len(spy.calls[0]) == want_chunks
    if partial:
        _assert_bitwise(out.hi, ref.hi)
        _assert_bitwise(out.lo, ref.lo)
    else:
        _assert_bitwise(out, ref)


def test_whole_epilogue_equals_the_per_chunk_loop():
    """``scale_accum_chunks_ref`` (and the CPU's default df32 epilogue) is
    the loop of the one-chunk kernel's plain version ``scale_accum_ref``
    from zero, each chunk with its group's row scale ``base_a *
    2^(-beta g)``, and an f64 output converts the same (hi, lo) as
    ``DF32.to_float``."""
    _, _, tsa, tsb = _splits(np.float32, 1e-20, 5, (2,))
    seen = []

    def record(prods, groups, base_a, base_b, beta, **kw):
        seen.append((prods, groups, base_a, base_b, beta))
        return P_ops.scale_accum_contraction(prods, groups, base_a, base_b,
                                             beta, **kw)

    whole = P_acc.matmul_group_ef(tsa, tsb, accum="df32", r=2, partial=True,
                                  epilogue_fn=record)
    prods, groups, base_a, base_b, beta = seen[0]
    assert len(set(groups)) < len(groups)     # several chunks a group
    hi = torch.zeros(prods[0].shape, dtype=torch.float32)
    lo = torch.zeros_like(hi)
    for prod, g in zip(prods, groups):
        hi, lo = P_sa.scale_accum_ref(prod, base_a * 2.0 ** (-beta * g),
                                      base_b, hi, lo)
    default = P_acc.matmul_group_ef(tsa, tsb, accum="df32", r=2,
                                    partial=True)
    for acc in (whole, default, P_sa.scale_accum_chunks_ref(
            prods, groups, base_a, base_b, beta, partial=True)):
        _assert_bitwise(acc[0], hi)
        _assert_bitwise(acc[1], lo)
    _assert_bitwise(
        P_acc.matmul_group_ef(tsa, tsb, accum="df32", r=2,
                              out_dtype=torch.float64,
                              epilogue_fn=P_ops.scale_accum_contraction),
        whole.to_float(torch.float64))
    with pytest.raises(ValueError, match="one group per chunk"):
        P_sa.scale_accum_chunks([torch.zeros((2, 2), dtype=torch.int32)],
                                [2, 3], torch.ones(2), torch.ones(2), 7)


def _attention_operands(dtype, seed=8):
    """q (B, H, L, D) and k (B, H, S, D) as the model's scores contract
    them, with one head scaled small."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 3, 2, 32))
    k = rng.standard_normal((2, 3, 7, 32))
    q[:, 1] *= 1e-20
    return q.astype(dtype), k.astype(dtype)


ATTN_DNUMS = (((3,), (3,)), ((0, 1), (0, 1)))


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32:fused",
                                  "ozimmu_sm_h-4:df32:fused"])
@pytest.mark.parametrize("shape", ["rank2", "attention"])
def test_fused_products_through_the_whole_epilogue(spec, shape,
                                                   monkeypatch):
    """``:fused`` df32 products go through the whole-contraction hook (one
    call a contraction, no per-chunk epilogue), bitwise against the
    reference's fused pipeline with its XLA epilogue."""
    _xla_epilogues(monkeypatch)
    spy = _Spy()
    monkeypatch.setattr(P_ops, "scale_accum_contraction", spy)
    monkeypatch.setattr(P_ops, "scale_accum_update", None)
    if shape == "rank2":
        rng = np.random.default_rng(9)
        a = rng.standard_normal((8, 64)).astype(np.float32)
        b = rng.standard_normal((64, 8)).astype(np.float32)
        a[2] *= 1e-20
        dnums = (((1,), (0,)), ((), ()))
    else:
        a, b = _attention_operands(np.float32)
        dnums = ATTN_DNUMS
    ref = R.ozimmu_dot_general(jnp.asarray(a), jnp.asarray(b), dnums,
                               R.parse_spec(spec))
    out = P.ozimmu_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                               dnums, P.parse_spec(spec))
    assert len(spy.calls) == 1
    _assert_bitwise(out, ref)


# ---------------------------------------------------------------------------
# the Ozaki-II df32 epilogue (ladder fold, windows, fast2 unscale)
# ---------------------------------------------------------------------------

class _Oz2Spy:
    """Counts calls of the Ozaki-II whole-contraction epilogue hook."""

    def __init__(self):
        self.calls = []
        self.hook = P_ops.oz2_scale_accum_contraction

    def __call__(self, prods, groups, *args, **kw):
        self.calls.append(list(groups))
        return self.hook(prods, groups, *args, **kw)


def _oz2_splits(variant, fast, k, batch, scale, m=6, n=64, p=9, seed=6):
    """Reference and port constant-grid splits of the same operands (rows
    and columns spread by 2^+-10; all of A scaled by ``scale``), and the
    splits' digit magnitude bits."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(batch + (m, n)) * 2.0 ** rng.integers(
        -10, 10, batch + (m, 1)) * scale
    b = rng.standard_normal(batch + (n, p)) * 2.0 ** rng.integers(
        -10, 10, batch + (1, p))
    a, b = a.astype(np.float32), b.astype(np.float32)
    name = {"oz2_b": "split_oz2_bitmask", "oz2_h": "split_oz2"}[variant] + \
        ("_fast2" if fast == "fast2" else "")
    beta = P_split.compute_beta(n)
    split = {"oz2_b": "oz2_bitmask", "oz2_h": "oz2_rn"}[variant]
    jsa, jsb = (getattr(R_split, name)(jnp.asarray(x), k, axis=ax)
                for x, ax in ((a, 0), (b, 1)))
    tsa, tsb = (getattr(P_split, name)(torch.from_numpy(x), k, axis=ax)
                for x, ax in ((a, 0), (b, 1)))
    return jsa, jsb, tsa, tsb, P_split.digit_bits(split, beta)


# (variant, fast, k, r, batch, scale): r = None is eq. 12's (one chunk a
# group at n = 64: 2k - 1 chunks in full mode, 17 at k = 9, 23 at k =
# 12); r = 1 makes a chunk of every pair (25 at k = 5 in full mode, several
# a window); scale 1e-30 puts the window scales below the normal range
OZ2_EPILOGUES = [("oz2_h", "fast2", 4, None, (), 1.0),
                 ("oz2_b", "fast2", 4, None, (3,), 1.0),
                 ("oz2_h", True, 3, None, (), 1.0),
                 ("oz2_b", True, 6, 1, (2,), 1.0),
                 ("oz2_h", False, 9, None, (), 1.0),
                 ("oz2_b", False, 12, None, (2,), 1.0),
                 ("oz2_h", False, 5, 1, (), 1.0),
                 ("oz2_h", "fast2", 5, None, (2,), 1e-30),
                 ("oz2_b", False, 4, None, (), 1e-30)]


@pytest.mark.parametrize("variant,fast,k,r,batch,scale", OZ2_EPILOGUES)
@pytest.mark.parametrize("partial", [False, True])
def test_oz2_whole_epilogue_plain_bitwise(variant, fast, k, r, batch, scale,
                                          partial):
    """The Ozaki-II one-launch epilogue's plain version through the
    ``epilogue_fn`` hook of ``matmul_oz2`` against the reference's
    ``matmul_oz2`` with its df32 accumulator (XLA epilogue): full,
    ``:fast`` and ``:fast2`` bands, the f32 result or the unrounded (hi,
    lo) with ``partial``; the default hook gives the same."""
    jsa, jsb, tsa, tsb, db = _oz2_splits(variant, fast, k, batch, scale)
    kw = dict(accum="df32", fast=fast, r=r, digit_bits=db, partial=partial)
    ref = R_acc.matmul_oz2(jsa, jsb, **kw)
    spy = _Oz2Spy()
    out = P_acc.matmul_oz2(tsa, tsb, epilogue_fn=spy, **kw)
    default = P_acc.matmul_oz2(tsa, tsb, **kw)
    want_chunks = P_acc.oz2_num_chunks(
        k, r or P_split.compute_r(64, P_split.compute_beta(64), db), fast)
    assert len(spy.calls) == 1 and len(spy.calls[0]) == want_chunks
    for got in (out, default):
        if partial:
            _assert_bitwise(got.hi, ref.hi)
            _assert_bitwise(got.lo, ref.lo)
        else:
            _assert_bitwise(got, ref)


def test_oz2_whole_epilogue_is_the_window_loop():
    """``scale_accum_const_windows_ref`` is the loop of the one-window
    kernel's plain version ``scale_accum_const_ref`` from zero over the
    folded words with the reference's window scales, then the fast2
    unscale's plain version per limb; an f64 output converts the same
    (hi, lo) as ``DF32.to_float``."""
    _, _, tsa, tsb, db = _oz2_splits("oz2_h", "fast2", 5, (2,), 1e-20)
    seen = []

    def record(prods, groups, c, beta, *args, **kw):
        seen.append((prods, groups, c, beta) + args)
        return P_ops.oz2_scale_accum_contraction(prods, groups, c, beta,
                                                 *args, **kw)

    kw = dict(accum="df32", fast="fast2", r=1, digit_bits=db)
    whole = P_acc.matmul_oz2(tsa, tsb, partial=True, epilogue_fn=record,
                             **kw)
    prods, groups, c, beta, ga, gb, ba, bb = seen[0]
    windows = P_acc._ladder_windows(groups, c)
    assert c > 1 and any(len(w) > 1 for w in windows)
    hi = torch.zeros(prods[0].shape, dtype=torch.float32)
    lo = torch.zeros_like(hi)
    for w in windows:
        g_hi = w[-1][1]
        word = sum(torch.bitwise_left_shift(prods[i], beta * (g_hi - g))
                   for i, g in w)
        s = R_acc._oz2_scale(jnp.asarray(ga.numpy()), jnp.asarray(gb.numpy()),
                             beta, g_hi, jnp.float32)
        hi, lo = P_sa.scale_accum_const_ref(word, torch.from_numpy(
            np.array(s)), hi, lo)
    ra, rb = ba * (1.0 / ga[..., None]), bb * (1.0 / gb[..., None])
    hi, lo = (P_sa.unscale_ref(x, ra, rb) for x in (hi, lo))
    for acc in (whole, P_sa.scale_accum_const_windows_ref(
            prods, groups, c, beta, ga, gb, ba, bb, partial=True)):
        _assert_bitwise(acc[0], hi)
        _assert_bitwise(acc[1], lo)
    _assert_bitwise(
        P_acc.matmul_oz2(tsa, tsb, out_dtype=torch.float64,
                         epilogue_fn=P_ops.oz2_scale_accum_contraction, **kw),
        whole.to_float(torch.float64))
    with pytest.raises(ValueError, match="one group per chunk"):
        P_sa.scale_accum_const_windows(
            [torch.zeros((2, 2), dtype=torch.int32)], [2, 3], 1, 7,
            torch.ones(()), torch.ones(()))
    with pytest.raises(ValueError, match="ascend from 2"):
        P_sa.scale_accum_const_windows(
            [torch.zeros((2, 2), dtype=torch.int32)] * 2, [3, 2], 1, 7,
            torch.ones(()), torch.ones(()))


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2:fused",
                                  "oz2_b-5:df32:fused",
                                  "oz2_h-10:df32:fused",
                                  "oz2_b-4:df32:fast:fused"])
@pytest.mark.parametrize("shape", ["rank2", "attention"])
def test_fused_oz2_products_through_the_whole_epilogue(spec, shape,
                                                       monkeypatch):
    """``:fused`` Ozaki-II df32 products go through the whole-contraction
    hook (one call a contraction, no per-window or per-limb hook), bitwise
    against the reference's fused pipeline with its XLA epilogue; k = 10
    in full mode gives 19 chunk products."""
    _xla_epilogues(monkeypatch)
    spy = _Oz2Spy()
    monkeypatch.setattr(P_ops, "oz2_scale_accum_contraction", spy)
    monkeypatch.setattr(P_ops, "oz2_scale_accum_update", None)
    monkeypatch.setattr(P_ops, "oz2_unscale_update", None)
    if shape == "rank2":
        rng = np.random.default_rng(10)
        a = rng.standard_normal((8, 64)).astype(np.float32)
        b = rng.standard_normal((64, 8)).astype(np.float32)
        a[2] *= 1e-20
        dnums = (((1,), (0,)), ((), ()))
    else:
        a, b = _attention_operands(np.float32, seed=11)
        dnums = ATTN_DNUMS
    ref = R.ozimmu_dot_general(jnp.asarray(a), jnp.asarray(b), dnums,
                               R.parse_spec(spec))
    out = P.ozimmu_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                               dnums, P.parse_spec(spec))
    assert len(spy.calls) == 1
    _assert_bitwise(out, ref)
