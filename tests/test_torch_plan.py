"""The port's planner (``core/plan.py``), error bounds
(``core/analysis.py``) and auto k against the reference.

The planner is integer bit accounting plus ``frexp`` exponents, so every
decision must be EQUAL to the reference's: ``choose_k_bits`` over a grid
of every split, both eps modes, probed and static; the cost rows of
``plan_contraction`` (k, beta, r, bits covered, probed, int8 GEMMs,
high-precision adds); the static n = 4096 plans the reference's
``BENCH_ozimmu.json`` accuracy rows were measured with; the oz2 ladder
accounting; the error bounds (identical float expressions on the same
numpy inputs, so equal bit for bit).  Auto k must resolve the reference's k in an eager call
(the probe) and through a frozen split (the static plan), on operands
where the two differ.
"""
import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import accumulate as R_acc
from repro.core import analysis as R_an
from repro.core import ozimmu as R
from repro.core import plan as R_plan
from repro.core import split_cache as R_sc
from repro_torch.core import accumulate as P_acc
from repro_torch.core import analysis as P_an
from repro_torch.core import ozimmu as P
from repro_torch.core import plan as P_plan
from repro_torch.core import split_cache as P_sc
from tests.conftest import make_phi_matrix

torch.set_num_threads(1)

SPLITS = ["bitmask", "rn", "rn_const", "sm", "oz2_rn", "oz2_bitmask",
          "oz2_rn_fast2", "oz2_bitmask_fast2"]


@pytest.mark.parametrize("split", SPLITS)
def test_choose_k_bits_matches_reference(split):
    grid = itertools.product(
        (16, 100, 4096, 2 ** 16),                  # n
        (24, 53),                                  # mantissa
        (None, (0, 0), (3, 11), (20, 2)),          # probed gaps
        (False, True, "fast2"),                    # fast flag
        ("deterministic", "probabilistic"),
        (None, 2.0 ** -10, 0.0))                   # delta
    for n, mant, gaps, fast, mode, delta in grid:
        beta = P.splitting.beta_for(split, n)
        assert beta == R.splitting.beta_for(split, n)
        ga, gb = gaps if gaps is not None else (None, None)
        kw = dict(split=split, mantissa=mant, m=7, p=300, gap_a=ga,
                  gap_b=gb, fast=fast, mode=mode, delta=delta)
        for eps in (2.0 ** -40, 2.0 ** -20):
            assert P_plan.choose_k_bits(n, beta, eps, **kw) == \
                R_plan.choose_k_bits(n, beta, eps, **kw), (n, kw, eps)


def test_lambda_bits_and_errors_match_reference():
    for delta in (2.0 ** -20, 2.0 ** -5, 0.3):
        assert P_plan.lambda_bits(delta) == R_plan.lambda_bits(delta)
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError) as r_err:
            R_plan.lambda_bits(bad)
        with pytest.raises(ValueError) as p_err:
            P_plan.lambda_bits(bad)
        assert str(p_err.value) == str(r_err.value)
    with pytest.raises(ValueError, match="target_eps_mode"):
        P_plan.choose_k(64, 7, 2.0 ** -40, split="rn_const", mantissa=53,
                        mode="sometimes")


PLAN_SPECS = ["ozimmu_h-6:f64", "ozimmu-5:df32", "ozimmu_rn-4:f32",
              "ozimmu_sm_h-3", "oz2_h-5:f64", "oz2_b-4:df32:fast",
              "oz2_h-8:f64:fast2", "oz2_h-4:df32:fast2", "ozimmu_h-auto",
              "ozimmu_h-auto:df32:prob", "ozimmu_sm_b-auto:prob",
              "oz2_h-auto:f64:fast2", "oz2_h-auto:f64:fast2:prob",
              "oz2_b-auto:f32:fast", "oz2_h-auto:df32"]

_ROW = ("k", "beta", "r", "bits_needed", "probed", "int8_gemms",
        "highprec_adds")


def _row(pl):
    return tuple(getattr(pl, f) for f in _ROW)


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_plan_contraction_rows_match_reference(spec):
    """Static rows at several shapes, and probed rows on concrete
    operands (f64 and f32)."""
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)
    for m, n, p in ((4, 2048, 92672), (4096, 4096, 4096), (3, 8192, 2048),
                    (33, 100, 17)):
        assert _row(P_plan.plan_contraction(pcfg, m, n, p, _record=False)) \
            == _row(R_plan.plan_contraction(rcfg, m, n, p, _record=False))
    rng = np.random.default_rng(51)
    for dtype in (np.float64, np.float32):
        a = (make_phi_matrix(rng, 12, 70, phi=2.0)
             * 2.0 ** rng.integers(-12, 4, (12, 1))).astype(dtype)
        b = make_phi_matrix(rng, 70, 9, phi=0.5).astype(dtype)
        r = R_plan.plan_contraction(rcfg, 12, 70, 9, a=jnp.asarray(a),
                                    b=jnp.asarray(b), _record=False)
        t = P_plan.plan_contraction(pcfg, 12, 70, 9, a=torch.from_numpy(a),
                                    b=torch.from_numpy(b), _record=False)
        assert _row(t) == _row(r), dtype
        for axis, x in ((0, a), (1, b)):
            assert P_plan.operand_gap_bits(torch.from_numpy(x), axis) == \
                R_plan.operand_gap_bits(jnp.asarray(x), axis)
    assert P_plan.describe_config(pcfg) == R_plan.describe_config(
        rcfg).replace("fused split+epilogue Pallas pipeline",
                      "fused split+epilogue kernel pipeline").replace(
        "pallas group-GEMM", "group-GEMM kernel").replace(
        "XLA path", "plain path")


def test_static_n4096_plans():
    """The plans the reference's ``BENCH_ozimmu.json`` accuracy rows use:
    ``oz2_h-auto:f64:fast2`` is k 10 deterministic and k 8 ``:prob``, in
    the planner and in the split cache's freeze-time resolution."""
    for spec, k in (("oz2_h-auto:f64:fast2", 10),
                    ("oz2_h-auto:f64:fast2:prob", 8),
                    ("ozimmu_h-auto:f64", 10),
                    ("ozimmu_h-auto:f64:prob", 8)):
        pcfg, rcfg = P.parse_spec(spec), R.parse_spec(spec)
        assert P_plan.plan_contraction(pcfg, 4096, 4096, 4096,
                                       _record=False).k == k
        assert P_sc.resolved_k(pcfg, 4096, torch.float64) == k == \
            R_sc.resolved_k(rcfg, 4096, np.float64)
        assert P_sc.resolved_k(pcfg, 4096, torch.float32) == \
            R_sc.resolved_k(rcfg, 4096, np.float32)


@pytest.mark.parametrize("k,r,fast,n,dbits,word_bits", [
    (8, 255, "fast2", 4096, 6, 52), (4, 255, "fast2", 2048, 6, 31),
    (4, 63, "fast2", 8192, 6, 31), (6, 3, False, 256, 7, 31),
    (10, 1, True, 100, 7, 52), (5, 8, False, 64, 6, 52)])
def test_oz2_ladder_accounting_matches_reference(k, r, fast, n, dbits,
                                                 word_bits):
    beta = 7
    for fn, args in (("oz2_num_pairs", (k, fast)),
                     ("oz2_num_chunks", (k, r, fast)),
                     ("oz2_num_highprec_adds",
                      (k, r, beta, n, fast, dbits, word_bits)),
                     ("ladder_width", (n, k, beta, dbits, word_bits)),
                     ("num_highprec_adds", (k, r, True)),
                     ("num_highprec_adds", (k, r, False))):
        assert getattr(P_acc, fn)(*args) == getattr(R_acc, fn)(*args), fn
    assert list(P_acc.oz2_groups(k, fast)) == list(R_acc.oz2_groups(k,
                                                                    fast))


def test_oz2_dgemm_and_serve_plans():
    """The chip run's oz2 paths: ``oz2_h-8:f64:fast2`` at n = 4096 is 36
    int8 GEMMs in 8 group chunks folded into 2 ladder windows (int64
    word); ``oz2_h-4:df32:fast2`` at n = 2048 and 8192 is 10 GEMMs in 4
    chunks, 4 windows (int32 word)."""
    pl = P_plan.plan_contraction(P.parse_spec("oz2_h-8:f64:fast2"), 4096,
                                 4096, 4096, _record=False)
    assert (pl.beta, pl.int8_gemms, pl.highprec_adds) == (7, 36, 2)
    assert P_acc.oz2_num_chunks(8, pl.r, True) == 8
    for n in (2048, 8192):
        pl = P_plan.plan_contraction(P.parse_spec("oz2_h-4:df32:fast2"), 4,
                                     n, 2048, _record=False)
        assert (pl.int8_gemms, pl.highprec_adds) == (10, 4)
        assert P_acc.oz2_num_chunks(4, pl.r, True) == 4


BOUNDS = ["error_bound_ozimmu", "error_bound_group_ef", "error_bound_rn",
          "error_bound_sm", "error_bound_oz2", "prob_error_bound_ozimmu",
          "prob_error_bound_group_ef", "prob_error_bound_rn",
          "prob_error_bound_sm", "prob_error_bound_oz2"]


@pytest.mark.parametrize("name", BOUNDS)
def test_error_bounds_match_reference(name):
    rng = np.random.default_rng(52)
    a = make_phi_matrix(rng, 9, 64, phi=1.0) * 2.0 ** rng.integers(
        -8, 8, (9, 1))
    a[2] = 0.0
    b = make_phi_matrix(rng, 64, 7, phi=1.0)
    kws = [{}]
    if name.endswith("oz2"):
        kws = [dict(fast=False), dict(fast=True), dict(fast="fast2"),
               dict(fast=True, adds=3)]
    for k in (2, 5):
        for kw in kws:
            np.testing.assert_array_equal(
                getattr(P_an, name)(a, b, k, **kw),
                getattr(R_an, name)(a, b, k, **kw))
            np.testing.assert_array_equal(
                getattr(P_an, name)(a.astype(np.float32),
                                    b.astype(np.float32), k, **kw),
                getattr(R_an, name)(a.astype(np.float32),
                                    b.astype(np.float32), k, **kw))


def test_analysis_helpers_match_reference():
    for dt in (np.float32, np.float64):
        assert P_an.unit_roundoff(dt) == R_an.unit_roundoff(dt)
    for count in (0, 1, 5, 4096):
        for delta in (0.0, 2.0 ** -20, 0.5):
            assert P_an.effective_terms(count, delta) == \
                R_an.effective_terms(count, delta)
    for k, r in ((4, 1), (8, 3), (10, 128)):
        assert P_an.accumulation_terms_w(k, r) == \
            R_an.accumulation_terms_w(k, r)
    for args in ((4, 2048, 8192, 4), (4096, 4096, 4096, 8)):
        for group_ef in (False, True):
            assert P_an.flop_counts(*args, group_ef=group_ef) == \
                R_an.flop_counts(*args, group_ef=group_ef)


def _spread_operands():
    """Rows spread over 2^-24..2^0: the probe charges the gap, so the
    probed k (11 for oz2_h fast2, 12 for ozimmu_h) exceeds the static
    plan's (9) at n = 128."""
    rng = np.random.default_rng(53)
    a = make_phi_matrix(rng, 16, 128, phi=0.5) * 2.0 ** rng.integers(
        -24, 1, (16, 1))
    b = make_phi_matrix(rng, 128, 12, phi=0.5)
    return a, b


@pytest.mark.parametrize("spec", ["oz2_h-auto:f64:fast2:fused",
                                  "ozimmu_h-auto:f64"])
def test_auto_k_probed_eager_and_static_presplit(spec):
    """Eager calls probe; a frozen split adopts the static plan's k.  The
    two differ on these operands, and both paths equal the reference's
    (k and result, bit for bit)."""
    a, b = _spread_operands()
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    k_probe = P_plan.auto_k(ta, tb, pcfg)
    k_static = P_sc.resolved_k(pcfg, 128, torch.float64)
    assert k_probe == R_plan.auto_k(ja, jb, rcfg)
    assert k_static == R_sc.resolved_k(rcfg, 128, np.float64)
    assert k_probe > k_static
    dnums = (((1,), (0,)), ((), ()))
    P_plan.get_ledger().clear()
    out = P.ozimmu_dot_general(ta, tb, dnums, pcfg)
    ref = R.ozimmu_dot_general(ja, jb, dnums, rcfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    last = P_plan.get_ledger().entries()[-1]
    assert last.probed and last.k == k_probe
    fixed = P.ozimmu_dot_general(ta, tb, dnums,
                                 pcfg.with_(k=k_probe, auto_k=False))
    np.testing.assert_array_equal(out.numpy(), fixed.numpy())

    psp = P_sc.SplitCache().get(tb, dnums, pcfg)
    rsp = R_sc.SplitCache().get(jb, dnums, rcfg)
    assert psp.digits.shape[0] == k_static == rsp.digits.shape[0]
    out = P.ozimmu_dot_general(ta, tb, dnums, pcfg, rhs_presplit=psp)
    ref = R.ozimmu_dot_general(ja, jb, dnums, rcfg, rhs_presplit=rsp)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    fixed = P.ozimmu_dot_general(ta, tb, dnums,
                                 pcfg.with_(k=k_static, auto_k=False))
    np.testing.assert_array_equal(out.numpy(), fixed.numpy())


def test_ledger_records_and_summarises():
    ledger = P_plan.get_ledger()
    ledger.clear()
    cfg = P.parse_spec("oz2_h-auto:df32:fast2:prob")
    P_sc.resolved_k(cfg, 2048, torch.float32)
    P_plan.plan_contraction(cfg, 4, 2048, 8, a=torch.ones((4, 2048)),
                            b=torch.ones((2048, 8)))
    rows = ledger.entries()
    assert [r.source for r in rows] == ["split_cache", "contraction"]
    assert [r.probed for r in rows] == [False, True]
    s = ledger.summary()
    assert s["decisions"] == 2 and s["probabilistic"] == 2
    assert "2 auto-k decisions (1 probed, 1 static, 2 :prob)" in \
        ledger.describe()
    ledger.clear()
    assert ledger.describe() == "no auto-k decisions recorded"
