"""Rounding-error bounds from §5 of the paper, plus op-count accounting —
PyTorch port of ``repro.core.analysis`` (numpy only, unchanged).

These are used by the planner and by tests (the computed result must
satisfy the bound).

Two bound families live here:

* the **deterministic** worst-case bounds (eq. (18) and its variant
  refinements) — every rounding/truncation error aligned adversarially;
* their **probabilistic** twins (``prob_error_bound_*``), following the
  analysis of Abdelfattah, Dongarra, Fasi, Mikaitis & Tisseur, *Analysis
  of Floating-Point Matrix Multiplication Computed via Integer
  Arithmetic* (arXiv 2506.11277): modeling the per-term splitting
  truncations and accumulation roundings as mean-independent bounded
  random variables, a Hoeffding/Azuma concentration argument replaces
  every "sum of N error terms" factor ``N`` by
  ``lambda(delta) * sqrt(N)`` with ``lambda(delta) =
  sqrt(2 ln(2/delta))``, valid with probability at least ``1 - delta``
  per entry.  ``delta = 0`` makes ``lambda`` infinite and the effective
  factor falls back to ``N`` — the deterministic bound is the exact
  ``delta = 0`` limit, bitwise (the same float expressions evaluate).

The probabilistic model is sharp for the round-to-nearest splits
(``rn``/``rn_const``/``oz2_rn``): their per-slice errors are symmetric
half-ulp roundings, the mean-independence hypothesis of 2506.11277.  The
directed-truncation splits (bitmask, sign-magnitude floor extraction)
have sign-biased residuals on adversarial operands, where sums grow
linearly, not like sqrt(N); their probabilistic bounds hold under the
random-operand model (symmetric element signs re-center the residuals)
and the *planner* additionally charges back a calibrated bias bit for
them (``repro_torch.core.plan``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.core.splitting import (compute_beta, compute_beta_sm,
                                        compute_r)

__all__ = [
    "unit_roundoff",
    "DEFAULT_DELTA",
    "effective_terms",
    "truncation_bound",
    "accumulation_terms_w",
    "error_bound_ozimmu",
    "error_bound_group_ef",
    "error_bound_rn",
    "error_bound_sm",
    "error_bound_oz2",
    "prob_error_bound_ozimmu",
    "prob_error_bound_group_ef",
    "prob_error_bound_rn",
    "prob_error_bound_sm",
    "prob_error_bound_oz2",
    "flop_counts",
]


def unit_roundoff(dtype) -> float:
    return {np.dtype(np.float64): 2.0 ** -53,
            np.dtype(np.float32): 2.0 ** -24}[np.dtype(dtype)]


# Default per-entry failure probability of the probabilistic bounds and
# of the planner's ``target_eps_mode="probabilistic"``: one entry in a
# million runs of a 1k x 1k output, and the concentration constant
# lambda = sqrt(2 ln(2/delta)) ~ 5.4 stays narrow (3 bits).
DEFAULT_DELTA = 2.0 ** -20


def effective_terms(count, delta: float):
    """Effective error-term count under the probabilistic model.

    A sum of ``count`` mean-independent error terms, each bounded by
    ``eps_term``, is at most ``count * eps_term`` deterministically but —
    by Hoeffding's inequality (2506.11277, Thm. 3.2 shape) — at most
    ``sqrt(2 ln(2/delta) * count) * eps_term`` with probability at least
    ``1 - delta``.  Returns ``min(count, lambda(delta) * sqrt(count))``
    as a float; ``delta <= 0`` returns ``float(count)`` (the
    deterministic limit, exact for every count in range here).
    """
    c = float(count)
    if delta <= 0.0:
        return c
    if not delta < 1.0:
        raise ValueError(f"delta must be < 1, got {delta}")
    return min(c, math.sqrt(2.0 * math.log(2.0 / delta) * c))


def _gf(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """g f^T with g_i = ufp(max_j |a_ij|), f_j = ufp(max_i |b_ij|)."""
    def ufp(x):
        out = np.zeros_like(x)
        nz = x != 0
        out[nz] = 2.0 ** np.floor(np.log2(x[nz]))
        return out
    g = ufp(np.max(np.abs(a), axis=1))
    f = ufp(np.max(np.abs(b), axis=0))
    return np.outer(g, f)


def truncation_bound(a: np.ndarray, b: np.ndarray, k: int,
                     beta: int | None = None,
                     delta: float = 0.0) -> np.ndarray:
    """|AB - sum_{s+t<=k+1} A_s B_t| <= 4(k+1) n 2^(-beta k) g f^T — eq. (18).

    ``delta > 0``: the n-term truncation sum concentrates; ``n`` is
    replaced by ``effective_terms(n, delta)`` and the bound holds with
    probability >= 1 - delta per entry (under the mean-independent
    residual model; see the module docstring for where that is sharp).
    """
    n = a.shape[1]
    beta = beta or compute_beta(n)
    return 4.0 * (k + 1) * effective_terms(n, delta) \
        * 2.0 ** (-beta * k) * _gf(a, b)


def accumulation_terms_w(k: int, r: int) -> int:
    """w = ceil(k/r) * (k - (r/2) * floor((k-1)/r)) — §5.2."""
    return math.ceil(k / r) * (k - (r / 2) * math.floor((k - 1) / r))


def error_bound_ozimmu(a: np.ndarray, b: np.ndarray, k: int,
                       u: float | None = None,
                       delta: float = 0.0) -> np.ndarray:
    """Deterministic bound for Alg. 3+4 (without the k'_max sharpening):

        |AB - T_k| <= 4(k+1) n 2^(-beta k) g f^T + (k(k+1)/2 - 1) u |A||B|.

    ``delta > 0`` applies :func:`effective_terms` to both error-term
    counts (the n-term truncation sum and the k(k+1)/2 - 1 accumulation
    roundings); per-entry failure probability <= delta.
    """
    u = u if u is not None else unit_roundoff(a.dtype)
    tb = truncation_bound(a, b, k, delta=delta)
    adds = effective_terms(k * (k + 1) / 2 - 1, delta)
    return tb + adds * u * (np.abs(a) @ np.abs(b))


def error_bound_group_ef(a: np.ndarray, b: np.ndarray, k: int,
                         u: float | None = None,
                         delta: float = 0.0) -> np.ndarray:
    """Bound for Alg. 3+6: |AB - T| <= 4(k+1) n 2^(-beta k) g f^T + (w-1) u |A||B|."""
    u = u if u is not None else unit_roundoff(a.dtype)
    n = a.shape[1]
    beta = compute_beta(n)
    w = accumulation_terms_w(k, compute_r(n, beta))
    adds = effective_terms(max(w - 1, 0), delta)
    return truncation_bound(a, b, k, delta=delta) \
        + adds * u * (np.abs(a) @ np.abs(b))


def error_bound_rn(a: np.ndarray, b: np.ndarray, k: int,
                   u: float | None = None,
                   delta: float = 0.0) -> np.ndarray:
    """Documented bound for the RN variants (ozIMMU_RN / ozIMMU_H).

    Same shape as eq. (18) with the grid anchored at ``2^ceil(log2 max)``
    (up to 2x the ufp anchor of the truncation variants) but only half-ulp
    per-slice rounding; the naive k(k+1)/2 accumulation term dominates the
    group-EF one, so one bound covers both.
    """
    u = u if u is not None else unit_roundoff(a.dtype)
    n = a.shape[1]
    beta = compute_beta(n)
    tb = 4.0 * (k + 1) * effective_terms(n, delta) \
        * 2.0 ** (-beta * k) * (2.0 * _gf(a, b))
    adds = effective_terms(k * (k + 1) / 2, delta)
    return tb + adds * u * (np.abs(a) @ np.abs(b))


def error_bound_sm(a: np.ndarray, b: np.ndarray, k: int,
                   u: float | None = None,
                   delta: float = 0.0) -> np.ndarray:
    """Documented bound for the sign-magnitude variants (ozimmu_sm_b/_h).

    The splitter anchors each row at ``anchor_i = 2 ufp(rowmax_i)`` (so
    the normalized value is strictly inside (-1, 1)) and extracts k
    digits of ``beta_sm = min(8, ...)`` bits, the leading one carrying
    the sign; the elementwise residual after k digits satisfies
    ``|V_A| <= anchor_i 2^(1 - beta k) = 4 g_i 2^(-beta k)`` — exactly
    2x the bitmask residual at equal beta (floor truncation against the
    doubled anchor), so eq. (18)'s band/truncation bound holds with the
    constant doubled:

        |AB - T_k| <= 8(k+1) n 2^(-beta_sm k) g f^T
                      + (k(k+1)/2) u |A||B|.

    The naive accumulation term (ozimmu_sm_b) dominates the group-EF one
    (ozimmu_sm_h, w - 1 adds), so one bound covers both — mirroring
    :func:`error_bound_rn`.  At beta_sm = 8 the truncation term is
    ~2^(k-1) times SMALLER than the beta-7 bound at equal k: the
    (k-1)-bit saving the planner turns into a smaller k.
    """
    u = u if u is not None else unit_roundoff(a.dtype)
    n = a.shape[1]
    beta = compute_beta_sm(n)
    tb = 8.0 * (k + 1) * effective_terms(n, delta) \
        * 2.0 ** (-beta * k) * _gf(a, b)
    adds = effective_terms(k * (k + 1) / 2, delta)
    return tb + adds * u * (np.abs(a) @ np.abs(b))


def _global_anchor(x: np.ndarray) -> float:
    """A power of two >= max|x| (the oz2 shared-grid anchor; conservative
    by at most 2x when max|x| is itself a power of two)."""
    gmax = float(np.max(np.abs(x)))
    if gmax == 0.0:
        return 0.0
    _, e = np.frexp(gmax)
    return float(np.ldexp(1.0, int(e)))


def _row_anchor(x: np.ndarray, axis: int) -> np.ndarray:
    """Per-row (axis=1: per-column) power-of-two anchors >= the row maxima
    — the fast2 equilibrated-grid anchors (conservative by <= 2x each,
    like :func:`_global_anchor`); 0.0 for all-zero rows."""
    rmax = np.max(np.abs(x), axis=axis)
    out = np.zeros_like(rmax)
    nz = rmax > 0
    _, e = np.frexp(rmax[nz])
    out[nz] = np.ldexp(np.ones_like(rmax[nz]), e)
    return out


def error_bound_oz2(a: np.ndarray, b: np.ndarray, k: int,
                    fast: bool | str = True, u: float | None = None,
                    adds: int | None = None,
                    fast2: bool = False,
                    delta: float = 0.0) -> np.ndarray:
    """Documented elementwise bound for the oz2 (constant-scaling) modes.

    With the shared grids anchored at ``EA = 2^ceil(log2 max|A|)`` (resp.
    EB), the splitting truncations satisfy ``|V_A| <= 2 EA 2^(-beta k)``
    elementwise (RN: half that), so

        |AB - T| <= 4 * 2^(-beta k) * (EA * colsum|B| + rowsum|A| * EB
                                       + n * EA * EB)        (truncation)
                  + [fast] 8 k n 2^(-beta k) * EA * EB       (dropped g>k+1)
                  + (adds - 1) u |A||B|
                  + 4 adds n u EA EB                         (accumulation)

    The last term is the conversion/rounding noise of the ladder-window
    terms themselves: a slice product's elementwise magnitude is bounded
    by ``n EA EB 2^(2 beta - beta g)`` — grid noise, NOT ``|A||B|`` — so
    the running accumulator transiently holds O(n EA EB) and each window
    add may round relative to that.  (Negligible for the f64/df32
    accumulators; it is what dominates plain-f32 accumulation on
    wide-spread operands.)

    The anchors are GLOBAL: unlike eq. (18)'s per-row ``g f^T``, rows far
    below the matrix maximum inherit the matrix-level absolute error — the
    price of constant scaling, and exactly what the adversarial oracle
    grid (the reference's tests/test_oracle.py) exercises.

    ``fast2=True`` (equivalently ``fast="fast2"``) selects the improved
    fast-mode scaling (Kawakami & Takahashi; spec token ``:fast2``): the
    per-row power-of-two equilibration anchors every truncation at the
    row's OWN magnitude, so the same bound holds with the scalar anchors
    ``EA``/``EB`` replaced by the per-row/col anchor vectors ``EA_i =
    2^ceil(log2 rowmax_i(A))`` / ``EB_j = 2^ceil(log2 colmax_j(B))`` —
    in particular the dropped-band term tightens from ``8 k n t EA EB``
    to the outer ``8 k n t EA_i EB_j``, which is what restores
    near-full-mode accuracy on wide-exponent-spread operands.  The
    ladder still evaluates the fast band, so the accumulation-count
    accounting is the fast-mode one.
    """
    u = u if u is not None else unit_roundoff(a.dtype)
    n = a.shape[1]
    beta = compute_beta(n)
    fast2 = fast2 or fast == "fast2"
    if fast2:
        fast = True
        ea = _row_anchor(a, axis=1)[:, None]   # (m, 1)
        eb = _row_anchor(b, axis=0)[None, :]   # (1, p)
    else:
        ea, eb = _global_anchor(a), _global_anchor(b)
    t = 2.0 ** (-beta * k)
    n_eff = effective_terms(n, delta)
    colsum = np.sum(np.abs(b), axis=0)
    rowsum = np.sum(np.abs(a), axis=1)
    # each of the three truncation contributions and the dropped band is
    # an n-term sum of bounded residual products, so the probabilistic
    # model replaces its n factor (explicit in the n*EA*EB / dropped
    # terms, inside colsum/rowsum for the cross terms — rescaled by
    # n_eff/n there) by effective_terms(n, delta).
    trunc = 4.0 * t * ((ea * colsum[None, :] + rowsum[:, None] * eb)
                       * (n_eff / n) + n_eff * ea * eb)
    dropped = 8.0 * k * n_eff * t * ea * eb if fast else 0.0
    if adds is None:
        # conservative default: count the ladder windows of the WORST
        # configuration — truncation digit bits (smaller r, more chunks)
        # and the 31-bit int32 word (df32/f32 ladders, least folding) —
        # so one bound covers oz2_b/oz2_h under every accumulator.  Pass
        # the actual count for a tighter bound.
        from repro_torch.core.accumulate import oz2_num_highprec_adds
        r = compute_r(n, beta, beta)
        adds = oz2_num_highprec_adds(k, r, beta, n, fast, beta,
                                     word_bits=31)
    accum = (effective_terms(max(adds - 1, 0), delta) * u
             * (np.abs(a) @ np.abs(b))
             + 4.0 * effective_terms(adds, delta) * n_eff * u * ea * eb)
    return trunc + dropped + accum


def prob_error_bound_ozimmu(a: np.ndarray, b: np.ndarray, k: int,
                            delta: float = DEFAULT_DELTA,
                            u: float | None = None) -> np.ndarray:
    """Probabilistic twin of :func:`error_bound_ozimmu` (arXiv 2506.11277
    model; per-entry failure probability <= ``delta``).  ``delta=0``
    recovers the deterministic bound bitwise."""
    return error_bound_ozimmu(a, b, k, u=u, delta=delta)


def prob_error_bound_group_ef(a: np.ndarray, b: np.ndarray, k: int,
                              delta: float = DEFAULT_DELTA,
                              u: float | None = None) -> np.ndarray:
    """Probabilistic twin of :func:`error_bound_group_ef`."""
    return error_bound_group_ef(a, b, k, u=u, delta=delta)


def prob_error_bound_rn(a: np.ndarray, b: np.ndarray, k: int,
                        delta: float = DEFAULT_DELTA,
                        u: float | None = None) -> np.ndarray:
    """Probabilistic twin of :func:`error_bound_rn` — the sharp case of
    the model: half-ulp RN slice roundings are symmetric and
    mean-independent, exactly the 2506.11277 hypothesis."""
    return error_bound_rn(a, b, k, u=u, delta=delta)


def prob_error_bound_sm(a: np.ndarray, b: np.ndarray, k: int,
                        delta: float = DEFAULT_DELTA,
                        u: float | None = None) -> np.ndarray:
    """Probabilistic twin of :func:`error_bound_sm`.  Holds under the
    random-operand model (symmetric signs re-center the one-sided floor
    truncations); the planner charges a calibrated bias for this split
    on top (``repro_torch.core.plan``)."""
    return error_bound_sm(a, b, k, u=u, delta=delta)


def prob_error_bound_oz2(a: np.ndarray, b: np.ndarray, k: int,
                         fast: bool | str = True,
                         delta: float = DEFAULT_DELTA,
                         u: float | None = None,
                         adds: int | None = None,
                         fast2: bool = False) -> np.ndarray:
    """Probabilistic twin of :func:`error_bound_oz2`."""
    return error_bound_oz2(a, b, k, fast=fast, u=u, adds=adds,
                           fast2=fast2, delta=delta)


def flop_counts(m: int, n: int, p: int, k: int, *, group_ef: bool,
                r: int | None = None) -> dict:
    """Operation accounting for the roofline/perf model.

    Returns int8 MAC count, high-precision (accumulate) element ops, and
    split element passes — the three cost centers of the scheme.
    """
    beta = compute_beta(n)
    r = r or compute_r(n, beta)
    n_pairs = k * (k + 1) // 2
    int8_macs = n_pairs * m * n * p
    if group_ef:
        from repro_torch.core.accumulate import num_highprec_adds
        hp_terms = num_highprec_adds(k, r, True)
    else:
        hp_terms = n_pairs
    # each high-precision term: int32->float convert + 2 diag scalings + add
    hp_elem_ops = hp_terms * m * p * 4
    split_elem_passes = 2 * k  # k extraction passes over each operand
    return dict(beta=beta, r=r, int8_macs=int8_macs, hp_terms=hp_terms,
                hp_elem_ops=hp_elem_ops, split_elem_passes=split_elem_passes)
