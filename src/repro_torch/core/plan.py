"""Per-contraction execution planner for the Ozaki-scheme emulation —
PyTorch port of ``repro.core.plan``.

**Accuracy-driven auto-k** (spec token ``auto``, e.g. ``ozimmu_h-auto``):
instead of a hand-picked slice count, the planner picks the smallest ``k``
whose modeled error stays under ``OzimmuConfig.target_eps`` (default
:data:`DEFAULT_TARGET_EPS`, ~f64-faithful).  The model follows the
exponent-distribution argument of *Improved Scaling for Fast Mode of Ozaki
Scheme II*: the splitting truncation after ``k`` slices is bounded by
``rowmax * 2^(1 - beta k)`` per element, so the bits the contraction needs
are the target bits plus every amplification the measured *elementwise
relative* error picks up on the way:

    needed = bits(target_eps)            # -log2 of the target bound
           + gap(A) + gap(B)             # probed operand exponent ranges:
                                         #   max row-max exponent minus the
                                         #   smallest per-row RMS exponent
                                         #   (output entries live at the
                                         #   row-RMS scale, the truncation
                                         #   at the row-max scale)
           + ceil(log2(m p))             # min |c_ij| over the output under
                                         #   random cancellation shrinks
                                         #   like 1/(m p)
           + ceil(log2(n)) / 2           # sqrt(n) CLT growth of |c| vs the
                                         #   n-term absolute error bound
           + guard                       # 2 bits; +5 for truncation
                                         #   splitting (bitmask digits round
                                         #   away-from-half a full ulp and
                                         #   waste the sign bit)
    k = ceil(needed / beta)

The probe runs whenever the operands are given: PyTorch is eager, so every
call of ``ozimmu_dot_general`` probes (the row reductions run where the
operands live; only the per-row vectors come to the host).  Without
operands the planner gives the static, shape-only plan that covers the
input mantissa (``needed = t + ceil(log2 n) + guard``) — the plan the
reference resolves inside a ``jit`` trace, and the one the split cache
freezes for serving (``split_cache.resolved_k``).  Exponents come from
``frexp`` as everywhere else in the port (no float ``log2``).

**Probabilistic mode** (``OzimmuConfig.target_eps_mode="probabilistic"``,
spec token ``:prob``): the bit model above is worst-case in two places
that the probabilistic analysis of arXiv 2506.11277
(``analysis.prob_error_bound_*``) tightens with probability
``1 - delta`` (``delta`` = ``OzimmuConfig.target_delta``, default
:data:`repro_torch.core.analysis.DEFAULT_DELTA` = 2^-20):

* probed path: the ``ceil(log2(m p))`` min-|c| cancellation charge is an
  order statistic of ~``m p`` near-independent CLT-scale entries; its
  tail is covered by half the bits plus the concentration constant
  ``lambda_bits(delta) = ceil(log2 sqrt(2 ln(2/delta)))`` (3 bits at the
  default delta), so the term becomes
  ``(clog2(m p) + 1)//2 + lambda_bits(delta) + bias``;
* static path: instead of charging worst-case n-growth
  (``ceil(log2 n)``) on top of mantissa coverage, the truncation sum
  concentrates like ``lambda sqrt(n)`` — matching the reference
  product's own accumulated-rounding growth — and the static charge
  collapses to ``max(lambda_bits(delta), guard) + extra + bias``.

``bias`` is a calibrated per-family charge-back for the
directed-truncation splits whose residuals are NOT mean-zero (the
2506.11277 hypothesis): 1 bit for the bitmask splits, 3 for
sign-magnitude (one-sided floor extraction plus the sign-folding
cascade correlating residuals within a row).  Both probabilistic
``needed`` values are clamped to never exceed the deterministic ones,
so ``k_prob <= k_det`` structurally; the dd oracle
(the reference's ``tests/test_oracle.py -k prob``) calibrates the constants against
seeded ensembles at the claimed failure rate.  The static probabilistic
plan intentionally under-delivers an absolute 2^-40 target (it promises
faithful-mantissa coverage plus the concentration margin, not target
bits plus worst-case growth) — bounded by the shaved ``beta (k_det -
k_prob)`` bits and documented in
the reference's docs/algorithms.md#the-probabilistic-planner-prob.

The reference's third decision, the TPU kernel tile table
(``kernel_blocks``/``tile``), has no counterpart: each CUDA kernel of the
port owns its launch geometry, so :class:`Plan` carries no ``blocks``.

The planner's cost accounting reuses the paper's own accounting:
:func:`repro_torch.core.accumulate.num_highprec_adds` for step (iv) and the
fast-mode pair count ``k(k+1)/2`` for step (iii) — see
the reference's ``docs/algorithms.md#the-execution-planner-auto-k``.  The oz2 variants
get their own rows: ``k^2`` (full) / ``k(k+1)/2`` (fast) pairs, ladder-
window adds (``accumulate.oz2_num_highprec_adds``), and an eps model in
which the two probed operand gaps combine as ``max`` instead of sum (the
OS-II constant-scaling analysis — each truncation term carries only its
own operand's spread; the other operand enters via its RMS).

**Static scope.**  The reference probes only concrete operands: inside a
``jax.jit`` trace (its serving step) every ``auto`` contraction takes the
static mantissa-coverage plan.  PyTorch has no trace, so
:func:`static_plan` stands in for one: inside it ``plan_contraction``
ignores the operands and records ``probed=False``, as a traced call does
in the reference (``ServingRuntime`` runs its steps inside it).  Eager
calls outside keep probing, as the reference's eager calls do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple, Union

import numpy as np

import torch

from repro_torch.core.accumulate import (num_highprec_adds,
                                         oz2_num_highprec_adds, oz2_num_pairs)
from repro_torch.core.analysis import DEFAULT_DELTA
from repro_torch.core.splitting import beta_for, compute_r, digit_bits

__all__ = ["DEFAULT_TARGET_EPS", "DEFAULT_DELTA", "Plan",
           "plan_contraction", "auto_k", "operand_gap_bits", "lambda_bits",
           "choose_k", "describe_config",
           "PlanDecision", "PlanLedger", "get_ledger", "choose_k_bits",
           "static_plan"]

# ~f64-faithful: at or below the elementwise relative error a plain FP64
# GEMM measures on the paper's phi-matrix grid (1e-11..7e-12 there), with
# headroom for harder operands.  2^-40 ~= 9.1e-13.
DEFAULT_TARGET_EPS = 2.0 ** -40

# significand bits of the float dtypes the emulation takes
_MANTISSA = {torch.float64: 53, torch.float32: 24}

# Slice counts outside this window are either meaningless (k < 2 cannot
# carry a residual) or pure waste (k*beta beyond mantissa + probe-able
# spread extracts all-zero digits).
K_MIN, K_MAX = 2, 16

_GUARD_BITS = 2
_TRUNC_EXTRA_BITS = 5  # bitmask splitting: ~1 ulp truncation + no sign bit
_SM_EXTRA_BITS = 2     # sign-magnitude: k slices cover beta*k - 1 bits (the
                       # sign occupies one leading-slice bit) + full-ulp
                       # floor truncation vs RN's half ulp


def _clog2(x: int) -> int:
    """Exact integer ceil(log2 x) for x >= 1."""
    return max(0, (int(x) - 1).bit_length())


def _exponents(v: np.ndarray) -> np.ndarray:
    """ceil(log2 v_i) per positive entry via frexp (no log2)."""
    _, e = np.frexp(v)
    return e


def operand_gap_bits(x, axis: int) -> int:
    """Probed exponent range of one operand: bits between the largest
    row-max and the smallest per-row RMS (rows for ``axis=0``, columns for
    ``axis=1``; leading axes are batch).  This is the amplification the
    elementwise relative error of the product inherits from the operand's
    dynamic range; clipped to the operand's mantissa width (spread beyond
    the mantissa is unrepresentable in the input to begin with).

    The O(m*n) reductions run where the operand lives, in its dtype as
    the reference's do; only the per-row vectors come back to the host.
    """
    m_axis = -1 if axis == 0 else -2
    a = x.abs()
    rowmax = a.amax(dim=m_axis).cpu().numpy()
    rowrms = torch.sqrt(torch.mean(torch.square(a), dim=m_axis)).cpu().numpy()
    live = rowmax > 0
    if not live.any():
        return 0
    gap = int(_exponents(rowmax[live]).max()) \
        - int(_exponents(rowrms[live]).min())
    t = _MANTISSA.get(x.dtype, 24)
    return int(min(max(gap, 0), t))


def _bits_of(eps: float) -> int:
    if not (0.0 < eps < 1.0):
        raise ValueError(f"target_eps must be in (0, 1), got {eps}")
    return int(math.ceil(-math.log2(eps)))


def _clamp_k(k: int) -> int:
    return max(K_MIN, min(K_MAX, k))


_TRUNC_SPLITS = ("bitmask", "oz2_bitmask", "oz2_bitmask_fast2")
_SM_SPLITS = ("sm",)
_OZ2_SPLITS = ("oz2_rn", "oz2_bitmask", "oz2_rn_fast2",
               "oz2_bitmask_fast2")

_EPS_MODES = ("deterministic", "probabilistic")

# Charge-back for splits whose truncation residuals are NOT mean-zero
# (the concentration hypothesis): directed bitmask truncation biases one
# ulp direction per element sign; sign-magnitude floor extraction is
# one-sided AND its sign-folding cascade correlates residuals within a
# row.  Calibrated against the adversarial planner grid of
# the reference's tests/test_oracle.py (wide_spread / high-phi cells are where the
# uncorrected sqrt-model first breaks).
_PROB_BIAS_BITS = {"bitmask": 1, "oz2_bitmask": 1, "oz2_bitmask_fast2": 1,
                   "sm": 3}


def lambda_bits(delta: float) -> int:
    """``ceil(log2 sqrt(2 ln(2/delta)))`` — the Hoeffding concentration
    constant of the probabilistic eps model, in bits (3 at the default
    delta = 2^-20)."""
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return max(1, int(math.ceil(
        math.log2(math.sqrt(2.0 * math.log(2.0 / delta))))))


def choose_k(n: int, beta: int, target_eps: float, *, split: str,
             mantissa: int, m: int = 1, p: int = 1,
             gap_a: Optional[int] = None, gap_b: Optional[int] = None,
             fast: Union[bool, str] = False, mode: str = "deterministic",
             delta: Optional[float] = None) -> int:
    """Smallest k meeting ``target_eps``; see :func:`choose_k_bits` for
    the full bit model (this is its first return value)."""
    return choose_k_bits(n, beta, target_eps, split=split,
                         mantissa=mantissa, m=m, p=p, gap_a=gap_a,
                         gap_b=gap_b, fast=fast, mode=mode, delta=delta)[0]


def choose_k_bits(n: int, beta: int, target_eps: float, *, split: str,
                  mantissa: int, m: int = 1, p: int = 1,
                  gap_a: Optional[int] = None, gap_b: Optional[int] = None,
                  fast: Union[bool, str] = False,
                  mode: str = "deterministic",
                  delta: Optional[float] = None) -> Tuple[int, int]:
    """``(k, needed)``: the smallest k meeting ``target_eps`` under the
    bit model above, plus the modeled bit requirement it covers (the
    audit ledger's ``needed_bits`` — ``k * beta - needed`` is the
    planner's slack at the resolved k, before :data:`K_MIN`/:data:`K_MAX`
    clamping).

    ``gap_a``/``gap_b`` are the probed operand exponent ranges; ``None``
    means "no concrete operands" (traced call) and selects the static
    mantissa-coverage plan.

    The oz2 splits (constant scaling) follow the OS-II error analysis
    instead: each truncation term inherits only its OWN operand's spread —
    the other operand enters through its column/row RMS, bounded by
    Cauchy-Schwarz — so the two probed gaps combine as ``max``, not sum
    (docs/algorithms.md#ozaki-scheme-ii).  Fast mode charges one extra bit
    for the dropped g > k+1 groups (they sit at the truncation level).
    The fast2 splits charge the same bit (``fast`` arrives as the
    config's raw fast-mode flag — a bool or ``"fast2"``): fast2's per-row-anchored error is
    elementwise <= the plain fast-mode error at equal k, so the resolved
    k is equal — never larger — and the ``target_eps`` guarantee carries
    over wherever plain fast mode met it.

    The sign-magnitude split charges :data:`_SM_EXTRA_BITS` (its k slices
    cover ``beta*k - 1`` mantissa bits, and its floor extraction truncates
    a full ulp where RN rounds half) — but its ``beta`` is 8, not 7, so
    at equal ``needed`` the resolved k is smaller: ``ceil((needed+2)/8)``
    vs ``ceil(needed/7)``, a strict win whenever needed >= ~50 (every f64
    target), the (k-1)-bit saving the family exists for.

    ``mode="probabilistic"`` resolves k under the concentration model
    (module docstring): the probed ``clog2(m p)`` charge becomes
    ``(clog2(m p)+1)//2 + lambda_bits(delta) + bias`` and the static
    plan covers ``mantissa + max(lambda_bits(delta), guard) + extra +
    bias``; both are clamped to the deterministic ``needed`` so the
    resolved k never exceeds the deterministic one.  ``delta=None``
    uses :data:`repro_torch.core.analysis.DEFAULT_DELTA`; ``delta <= 0``
    recovers deterministic planning exactly.
    """
    if mode not in _EPS_MODES:
        raise ValueError(
            f"target_eps_mode must be one of {_EPS_MODES}, got {mode!r}")
    extra = (_TRUNC_EXTRA_BITS if split in _TRUNC_SPLITS
             else _SM_EXTRA_BITS if split in _SM_SPLITS else 0)
    guard = _GUARD_BITS + extra
    # probabilistic mode with delta <= 0 is the deterministic limit
    prob = mode == "probabilistic"
    if prob:
        delta = DEFAULT_DELTA if delta is None else delta
        if delta <= 0.0:
            prob = False
    # Plain oz2 fast mode (global anchor) gets NO probabilistic shave:
    # its dropped g > k+1 band is a systematic truncation of whole
    # slice-group products against the matrix-level anchor — not
    # mean-zero rounding noise, so the concentration argument does not
    # apply (and the deterministic fast-mode plan is already marginal on
    # wide-phi operands).  fast2's per-row equilibration re-anchors the
    # band at the row scale, restoring the concentration headroom.
    # ``fast`` may arrive as the raw config flag (bool or "fast2") or a
    # bool from a non-canonicalized config, so check both spellings.
    is_fast2 = fast == "fast2" or split.endswith("_fast2")
    if prob and bool(fast) and split in _OZ2_SPLITS and not is_fast2:
        prob = False
    lam = lambda_bits(delta) if prob else 0
    bias = _PROB_BIAS_BITS.get(split, 0) if prob else 0
    if gap_a is None or gap_b is None:
        needed = mantissa + _clog2(n) + guard
        if prob:
            # static: mantissa coverage + concentration margin (which
            # subsumes the base carry guard) + family extras + bias,
            # instead of worst-case n-growth
            needed = min(needed,
                         mantissa + max(lam, _GUARD_BITS) + extra + bias)
    else:
        if split in _OZ2_SPLITS:
            gaps = max(gap_a, gap_b) + int(bool(fast))
        else:
            gaps = gap_a + gap_b
        mp_term = _clog2(m * p)
        needed = (_bits_of(target_eps) + gaps + mp_term
                  + (_clog2(n) + 1) // 2 + guard)
        if prob:
            # probed: the min-|c| order-statistic charge concentrates
            mp_prob = (mp_term + 1) // 2 + lam + bias
            needed = min(needed,
                         _bits_of(target_eps) + gaps + mp_prob
                         + (_clog2(n) + 1) // 2 + guard)
    return _clamp_k(-(-needed // beta)), needed


@dataclasses.dataclass(frozen=True)
class Plan:
    """One contraction's resolved execution parameters + cost accounting."""

    k: int
    beta: int
    r: int
    bits_needed: int           # needed bits the chosen k covers (k * beta)
    probed: bool               # True: concrete-operand probe; False: static
    int8_gemms: int            # slice pairs (step iii): k(k+1)/2 for the
                               # ozimmu family and oz2 fast mode, k^2 for
                               # oz2 full mode
    highprec_adds: int         # step (iv): paper accounting for the ozimmu
                               # family; exponent-ladder windows for oz2

    def describe(self) -> str:
        return (f"k={self.k} (beta={self.beta}, "
                f"{'probed' if self.probed else 'static'}, "
                f"covers {self.bits_needed} bits), "
                f"{self.int8_gemms} int8 GEMMs, "
                f"{self.highprec_adds} high-precision adds")


# ---------------------------------------------------------------------------
# planner audit ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One auto-k resolution, as the planner saw it (docs/observability.md).

    ``predicted_eps`` is the bit model's achieved bound at the resolved
    k: the target shifted by the slack bits ``k*beta - needed`` (negative
    slack — a :data:`K_MAX` clamp — predicts an eps *above* target, which
    is exactly the situation the ledger exists to surface)."""

    source: str                # "contraction" (plan_contraction) |
                               # "split_cache" (weight-freeze resolution)
    spec: str                  # split/accumulate[/fast][@mesh] summary
    mode: str                  # deterministic | probabilistic
    delta: Optional[float]     # :prob failure budget (None when det)
    target_eps: float
    probed: bool               # concrete-operand probe vs static plan
    m: int
    n: int
    p: int
    gap_a: Optional[int]       # probed exponent ranges (None when static)
    gap_b: Optional[int]
    k: int                     # the chosen slice count
    beta: int
    needed_bits: int           # modeled requirement the k covers
    predicted_eps: float
    int8_gemms: int            # cost row at the resolved k
    highprec_adds: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanLedger:
    """Bounded, thread-safe ring of :class:`PlanDecision` rows.

    Queryable (``entries()``, ``summary()``) and cheap to keep always-on:
    recording is one deque append under a lock, and happens only when the
    obs layer is enabled and only at plan-resolution time (once per
    auto-k contraction or weight freeze)."""

    def __init__(self, maxlen: int = 4096):
        import collections
        import threading
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=maxlen)

    def record(self, d: PlanDecision):
        with self._lock:
            self._ring.append(d)

    def entries(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def summary(self) -> dict:
        """Aggregate view: decision counts by spec/mode/k, probe split,
        worst predicted eps — the launch-time startup block."""
        rows = self.entries()
        by_spec: dict = {}
        k_hist: dict = {}
        for d in rows:
            by_spec[d.spec] = by_spec.get(d.spec, 0) + 1
            k_hist[d.k] = k_hist.get(d.k, 0) + 1
        return {
            "decisions": len(rows),
            "probed": sum(1 for d in rows if d.probed),
            "static": sum(1 for d in rows if not d.probed),
            "probabilistic": sum(1 for d in rows
                                 if d.mode == "probabilistic"),
            "by_spec": dict(sorted(by_spec.items())),
            "k_hist": {k: k_hist[k] for k in sorted(k_hist)},
            "worst_predicted_eps": max(
                (d.predicted_eps for d in rows), default=None),
        }

    def describe(self) -> str:
        """One-line human summary for launch logging."""
        s = self.summary()
        if not s["decisions"]:
            return "no auto-k decisions recorded"
        ks = "/".join(f"k={k}x{c}" for k, c in s["k_hist"].items())
        worst = s["worst_predicted_eps"]
        return (f"{s['decisions']} auto-k decisions "
                f"({s['probed']} probed, {s['static']} static"
                + (f", {s['probabilistic']} :prob" if s['probabilistic']
                   else "")
                + f"): {ks}, worst predicted eps {worst:.2e}")


_LEDGER = PlanLedger()


def get_ledger() -> PlanLedger:
    return _LEDGER


def _spec_str(cfg, prob: bool) -> str:
    fast = getattr(cfg, "fast", False)
    mode = "/fast2" if fast == "fast2" else "/fast" if fast else ""
    mesh = getattr(cfg, "mesh_axis", None)
    return (f"{cfg.split}/{cfg.accumulate}{mode}:{cfg.accum_dtype}"
            + (":prob" if prob else "")
            + (f"@{mesh}" if mesh else ""))


def record_decision(cfg, *, m: int, n: int, p: int, k: int, beta: int,
                    needed: int, probed: bool,
                    gap_a: Optional[int] = None,
                    gap_b: Optional[int] = None,
                    source: str = "contraction") -> None:
    """Append one auto-k resolution to the ledger (and mirror a counter
    into the metrics registry).  No-op when the obs layer is disabled."""
    from repro_torch.obs import registry as _obs
    if not _obs.enabled():
        return
    eps = cfg.target_eps if cfg.target_eps is not None else DEFAULT_TARGET_EPS
    mode = getattr(cfg, "target_eps_mode", "deterministic")
    cost = _plan_static(n, k, beta, *_cfg_cost_key(cfg, beta))
    _LEDGER.record(PlanDecision(
        source=source, spec=_spec_str(cfg, mode == "probabilistic"),
        mode=mode, delta=getattr(cfg, "target_delta", None)
        if mode == "probabilistic" else None,
        target_eps=eps, probed=probed, m=m, n=n, p=p,
        gap_a=gap_a, gap_b=gap_b, k=k, beta=beta, needed_bits=needed,
        predicted_eps=math.ldexp(eps, needed - k * beta),
        int8_gemms=cost.int8_gemms, highprec_adds=cost.highprec_adds))
    _obs.get_registry().inc("plan.decisions", 1, source=source, mode=mode,
                            probed=int(probed), k=k)


@functools.lru_cache(maxsize=1024)
def _plan_static(n: int, k: int, beta: int, accumulate: str, fast: bool,
                 dbits: int, word_bits: int) -> Plan:
    if accumulate == "oz2":
        r = compute_r(n, beta, dbits)
        gemms = oz2_num_pairs(k, fast)
        adds = oz2_num_highprec_adds(k, r, beta, n, fast, dbits, word_bits)
    else:
        r = compute_r(n, beta)
        gemms = k * (k + 1) // 2
        adds = num_highprec_adds(k, r, accumulate == "group_ef")
    return Plan(k=k, beta=beta, r=r, bits_needed=k * beta, probed=False,
                int8_gemms=gemms, highprec_adds=adds)


def _word_bits(cfg) -> int:
    """Integer word budget of the oz2 exponent ladder under ``cfg``: 52
    bits (int64 word, exact f64 convert) for the f64 accumulator, 31
    (int32 word) otherwise — mirrors ``accumulate.matmul_oz2`` (the port
    always has f64, as the reference with x64 on)."""
    return 52 if cfg.accum_dtype == "f64" else 31


def _cfg_cost_key(cfg, beta: int) -> Tuple[str, bool, int, int]:
    return (cfg.accumulate, bool(getattr(cfg, "fast", False)),
            digit_bits(cfg.split, beta), _word_bits(cfg))


_SCOPE = threading.local()


@contextlib.contextmanager
def static_plan():
    """Resolve every ``auto`` contraction inside the block with the static
    plan, as the reference's planner does for traced operands (its jitted
    serving step).  Nests; per thread."""
    _SCOPE.depth = getattr(_SCOPE, "depth", 0) + 1
    try:
        yield
    finally:
        _SCOPE.depth -= 1


def _in_static_scope() -> bool:
    return getattr(_SCOPE, "depth", 0) > 0


def plan_contraction(cfg, m: int, n: int, p: int, *,
                     a=None, b=None, _record: bool = True) -> Plan:
    """Resolve the execution plan for ``(m, n) @ (n, p)`` under ``cfg``
    (an :class:`repro_torch.core.ozimmu.OzimmuConfig`).

    With operands ``a``/``b`` and ``cfg.auto_k``, the accuracy probe picks
    k; absent operands, or a call inside :func:`static_plan`, give the
    static mantissa-coverage plan.  Fixed-k
    configs just get the cost accounting.  The oz2 variants are planned against the OS-II
    error model (max-of-gaps, see :func:`choose_k`) and costed with their
    own pair/ladder accounting.
    """
    beta = beta_for(cfg.split, n)
    if not getattr(cfg, "auto_k", False):
        return _plan_static(n, cfg.k, beta, *_cfg_cost_key(cfg, beta))
    eps = cfg.target_eps if cfg.target_eps is not None else DEFAULT_TARGET_EPS
    mantissa = 53 if _bits_of(eps) > 22 else 24
    if a is not None and a.dtype in _MANTISSA:
        mantissa = _MANTISSA[a.dtype]
    gap_a = gap_b = None
    probed = False
    if a is not None and b is not None and not _in_static_scope():
        gap_a = operand_gap_bits(a, axis=0)
        gap_b = operand_gap_bits(b, axis=1)
        probed = True
    k, needed = choose_k_bits(
        n, beta, eps, split=cfg.split, mantissa=mantissa,
        m=m, p=p, gap_a=gap_a, gap_b=gap_b,
        fast=getattr(cfg, "fast", False),
        mode=getattr(cfg, "target_eps_mode", "deterministic"),
        delta=getattr(cfg, "target_delta", None))
    if _record:
        record_decision(cfg, m=m, n=n, p=p, k=k, beta=beta, needed=needed,
                        probed=probed, gap_a=gap_a, gap_b=gap_b)
    base = _plan_static(n, k, beta, *_cfg_cost_key(cfg, beta))
    return dataclasses.replace(base, probed=probed)


def auto_k(a, b, cfg) -> int:
    """The planner's k for canonical batched operands
    ``(*batch, m, n) @ (*batch, n, p)`` (the ``_bmm_impl`` entry shape)."""
    m, n, p = a.shape[-2], a.shape[-1], b.shape[-1]
    return plan_contraction(cfg, m, n, p, a=a, b=b).k


def describe_config(cfg, m: int = 4096, n: int = 4096, p: int = 4096) -> str:
    """One-line human plan summary for an engine config (launch logging)."""
    # _record=False: the 4096^3 illustration shape is not a real decision
    pl = plan_contraction(cfg, m, n, p, _record=False)
    eps = cfg.target_eps if cfg.target_eps is not None else DEFAULT_TARGET_EPS
    prob = getattr(cfg, "target_eps_mode", "deterministic") \
        == "probabilistic"
    kpart = (f"k=auto({'prob ' if prob else ''}target_eps={eps:.1e}, "
             f"static {pl.k} @ n={n})"
             if getattr(cfg, "auto_k", False) else f"k={cfg.k}")
    fused = cfg.use_pallas == "fused"
    fast = getattr(cfg, "fast", False)
    mode = "/fast2" if fast == "fast2" else "/fast" if fast else ""
    return (f"{cfg.split}/{cfg.accumulate}{mode}:{cfg.accum_dtype} {kpart}, "
            f"{'fused split+epilogue kernel pipeline' if fused else 'group-GEMM kernel' if cfg.use_pallas else 'plain path'}, "
            f"{pl.int8_gemms} int8 GEMMs / {pl.highprec_adds} hp adds")
