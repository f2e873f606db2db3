"""Public API: high-precision GEMM emulation on integer matmul units —
PyTorch port of ``repro.core.ozimmu``.

The named variants and the spec grammar are the reference's:

  ===============  ================  =====================
  name             splitting         accumulation
  ===============  ================  =====================
  ``ozimmu``       bitmask (Alg3)    naive (Alg4)
  ``ozimmu_rn``    RN adapt (Alg5)   naive (Alg4)
  ``ozimmu_ef``    bitmask (Alg3)    group-EF (Alg6/7)
  ``ozimmu_h``     RN const (Alg8)   group-EF (Alg6/7)
  ``ozimmu_sm_b``  sign-magnitude    naive (Alg4)
  ``ozimmu_sm_h``  sign-magnitude    group-EF (Alg6/7)
  ``oz2_b``        oz2 trunc (const) exponent ladder
  ``oz2_h``        oz2 RN (const)    exponent ladder
  ===============  ================  =====================

Every spec parses exactly as in the reference (same configs, same error
texts), and every variant executes, with a fixed or an ``auto`` k, on the
plain path and on the ``:fused`` kernel path.  One exception remains:
``@mesh`` specs raise ``NotImplementedError`` at execution (the
distributed slice; ``check_supported``).  On CUDA every variant runs, the
sign-magnitude ones included: the group GEMM takes their stored digits
with their signedness.  ``auto`` k probes the operands of an eager call;
inside ``plan.static_plan()`` (the serving runtime's steps) it takes the
static plan, as the reference's jitted calls do, and a call with a frozen
B split adopts the k the split cache froze (the static plan).

Two entry points: ``ozimmu_matmul(a, b, cfg)`` (rank 2) and
``ozimmu_dot_general(a, b, dimension_numbers, cfg)``, the emulated
``jax.lax.dot_general`` on tensors: batch dims stay batch dims all the way
into the int8 group GEMMs.  Both run on whatever device the caller placed
the operands on: on CUDA every int8 product goes through the hand-written
group-GEMM kernel.  Both are differentiable: a ``torch.autograd.Function``
evaluates the two cotangents through the same emulation under the
transposed dimension numbers (the reference's custom VJP), so the
backward's contractions run the same kernels as the forward's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import accumulate, splitting

__all__ = ["OzimmuConfig", "VARIANTS", "ozimmu_matmul", "ozimmu_dot_general",
           "parse_spec", "canonical_rhs", "canonical_fast2", "variant_name",
           "split_operands", "splitter_for", "check_supported"]

DimensionNumbers = Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]],
                         Tuple[Tuple[int, ...], Tuple[int, ...]]]


@dataclasses.dataclass(frozen=True)
class OzimmuConfig:
    k: int = 8                      # number of slices (fixed-k configs)
    split: str = "rn_const"         # bitmask | rn | rn_const | sm |
                                    # oz2_rn | oz2_bitmask (constant grid)
    accumulate: str = "group_ef"    # naive | group_ef | oz2
    fast: Union[bool, str] = False  # oz2 only: True (``:fast``) or
                                    # "fast2" (``:fast2``)
    accum_dtype: str = "f64"        # f64 | f32 | df32
    use_pallas: Union[bool, str] = False
                                    # False: plain path.  "fused" (spec
                                    # token ``:fused``): fused splitting,
                                    # group-GEMM kernel, fused epilogue.
                                    # True: the group-GEMM kernel only.
    auto_k: bool = False            # spec token ``auto``: accuracy-driven
                                    # k (core/plan.py)
    target_eps: Optional[float] = None
    target_eps_mode: str = "deterministic"
    target_delta: Optional[float] = None
    mesh_axis: Optional[str] = None  # ``@axis`` (distributed slice)
    mesh_reduce: str = "int32"

    def with_(self, **kw) -> "OzimmuConfig":
        return dataclasses.replace(self, **kw)


VARIANTS = {
    "ozimmu": OzimmuConfig(split="bitmask", accumulate="naive"),
    "ozimmu_rn": OzimmuConfig(split="rn", accumulate="naive"),
    "ozimmu_ef": OzimmuConfig(split="bitmask", accumulate="group_ef"),
    "ozimmu_h": OzimmuConfig(split="rn_const", accumulate="group_ef"),
    "ozimmu_sm_b": OzimmuConfig(split="sm", accumulate="naive"),
    "ozimmu_sm_h": OzimmuConfig(split="sm", accumulate="group_ef"),
    "oz2_b": OzimmuConfig(split="oz2_bitmask", accumulate="oz2"),
    "oz2_h": OzimmuConfig(split="oz2_rn", accumulate="oz2"),
}

_SPLITTERS = {
    "bitmask": splitting.split_bitmask,
    "rn": splitting.split_rn,
    "rn_const": splitting.split_rn_const,
    "sm": splitting.split_sm,
    "oz2_rn": splitting.split_oz2,
    "oz2_bitmask": splitting.split_oz2_bitmask,
    "oz2_rn_fast2": splitting.split_oz2_fast2,
    "oz2_bitmask_fast2": splitting.split_oz2_bitmask_fast2,
}


def canonical_fast2(cfg: OzimmuConfig) -> OzimmuConfig:
    """Tie ``cfg.fast == "fast2"`` and the ``*_fast2`` split names
    together (one mode; a hand-built config may set only one half)."""
    if cfg.fast == "fast2" and not cfg.split.endswith("_fast2"):
        return cfg.with_(split=cfg.split + "_fast2")
    if cfg.split.endswith("_fast2") and cfg.fast != "fast2":
        return cfg.with_(fast="fast2")
    return cfg


_VARIANT_NAMES = {(v.split, v.accumulate): name
                  for name, v in VARIANTS.items()}


def variant_name(cfg: OzimmuConfig) -> str:
    split = cfg.split[:-len("_fast2")] if cfg.split.endswith("_fast2") \
        else cfg.split
    return _VARIANT_NAMES.get((split, cfg.accumulate),
                              f"{cfg.split}/{cfg.accumulate}")


_MESH_REDUCES = ("int32", "df32")


@functools.lru_cache(maxsize=256)
def parse_spec(spec: str) -> OzimmuConfig:
    """Parse ``"ozimmu_h-8"`` / ``"oz2_h-auto:fast"`` style strings.

    Grammar (docs/engine.md):
    ``variant["-"k][":"opt]*["@"mesh_axis["/"mesh_reduce]]`` — the
    reference's, with the same configs and error texts.  Memoized: the
    configs are immutable and every engine contraction parses its spec."""
    mesh_axis, mesh_reduce = None, "int32"
    if "@" in spec:
        spec, mesh = spec.split("@", 1)
        mesh_axis, _, reduce_str = mesh.partition("/")
        if reduce_str:
            mesh_reduce = reduce_str
        if not mesh_axis or not mesh_axis.isidentifier():
            raise ValueError(f"bad mesh axis {mesh_axis!r} in engine spec")
        if mesh_reduce not in _MESH_REDUCES:
            raise ValueError(f"unknown mesh reduce {mesh_reduce!r}; "
                             f"options: {_MESH_REDUCES}")
    accum_dtype, use_pallas, fast, prob = "f64", False, False, False
    spec, *opts = spec.split(":")
    seen_accum = False
    for opt in opts:
        if opt in ("f64", "f32", "df32"):
            if seen_accum:
                raise ValueError(f"duplicate accumulator dtype {opt!r} "
                                 f"in engine spec")
            accum_dtype, seen_accum = opt, True
        elif opt == "fused":
            if use_pallas == "fused":
                raise ValueError("duplicate 'fused' token in engine spec")
            use_pallas = "fused"
        elif opt == "prob":
            if prob:
                raise ValueError("duplicate 'prob' token in engine spec")
            prob = True
        elif opt in ("fast", "fast2"):
            if fast == (opt if opt == "fast2" else True):
                raise ValueError(f"duplicate {opt!r} token in engine spec")
            if fast:
                raise ValueError(f"conflicting fast-mode tokens in engine "
                                 f"spec: {opt!r} after "
                                 f"{'fast2' if fast == 'fast2' else 'fast'!r}"
                                 f" (pick one)")
            fast = "fast2" if opt == "fast2" else True
        else:
            raise ValueError(f"unknown engine spec option {opt!r}; "
                             f"options: f64, f32, df32, fused, fast, "
                             f"fast2, prob")
    name, _, kstr = spec.partition("-")
    if name not in VARIANTS:
        raise ValueError(f"unknown ozimmu variant {name!r}; "
                         f"options: {sorted(VARIANTS)}")
    auto_k = kstr == "auto"
    if kstr and not auto_k and (not kstr.isdigit() or int(kstr) < 1):
        raise ValueError(f"bad slice count {kstr!r} in engine spec "
                         f"(an integer >= 1, or 'auto')")
    cfg = VARIANTS[name]
    if fast and cfg.accumulate != "oz2":
        token = "fast2" if fast == "fast2" else "fast"
        raise ValueError(f"the {token!r} token applies to the oz2_* "
                         f"variants only (the ozimmu family always "
                         f"evaluates the fast-mode band); got {name!r}")
    if prob and not auto_k:
        raise ValueError(f"the 'prob' token (probabilistic "
                         f"target_eps_mode) applies to auto-k specs only "
                         f"— a fixed slice count leaves the planner "
                         f"nothing to resolve; got {name!r} with "
                         f"k={kstr or cfg.k}, want e.g. {name}-auto:prob")
    return canonical_fast2(cfg.with_(
        k=cfg.k if (auto_k or not kstr) else int(kstr),
        auto_k=auto_k, accum_dtype=accum_dtype,
        use_pallas=use_pallas, fast=fast,
        target_eps_mode="probabilistic" if prob else "deterministic",
        mesh_axis=mesh_axis, mesh_reduce=mesh_reduce))


def check_supported(cfg: OzimmuConfig) -> None:
    """Raise ``NotImplementedError`` for what parses but the port does not
    execute yet: the mesh-native ``@axis`` specs."""
    if cfg.mesh_axis is not None:
        raise NotImplementedError(
            f"mesh-native specs (@{cfg.mesh_axis}) come with the "
            f"distributed slice of the port")


def splitter_for(cfg: OzimmuConfig, n: int):
    """``split(x, axis) -> Split`` for contraction length ``n`` under
    ``cfg``: the split kernel under ``:fused`` for every constant-ratio
    strategy, the library splitter otherwise and for the adaptive ``rn``
    (its grid needs a fresh row maximum per slice) — bit-identical either
    way."""
    beta = splitting.beta_for(cfg.split, n)
    if cfg.use_pallas == "fused" and cfg.split != "rn":
        from repro_torch.kernels import ops as kops
        return lambda x, axis: kops.split_fused(x, cfg.k, beta,
                                                mode=cfg.split, axis=axis)
    splitter = _SPLITTERS[cfg.split]
    return lambda x, axis: splitter(x, cfg.k, beta=beta, axis=axis)


def split_operands(a: torch.Tensor, b: Optional[torch.Tensor],
                   cfg: OzimmuConfig, *,
                   rhs_presplit: Optional[splitting.Split] = None):
    """Step (i)+(ii): slice A row-wise and B column-wise (per batch
    element).  ``rhs_presplit`` (a frozen column-scale Split from
    :mod:`repro_torch.core.split_cache`) skips the B side; ``b`` may then
    be None."""
    split = splitter_for(cfg, a.shape[-1])
    sa = split(a, 0)
    if rhs_presplit is not None:
        return sa, rhs_presplit
    return sa, split(b, 1)


def _bmm_local(a: torch.Tensor, b: Optional[torch.Tensor],
               cfg: OzimmuConfig, *, partial: bool = False,
               rhs_presplit: Optional[splitting.Split] = None):
    """Single-device emulated batched matmul on canonical operands."""
    sa, sb = split_operands(a, b, cfg, rhs_presplit=rhs_presplit)
    group_gemm_fn = scale_accum_fn = pair_gemm_fn = unscale_fn = None
    epilogue_fn = None
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        if cfg.accumulate == "naive":
            # naive accumulation has no groups: each slice pair is a G=1
            # group GEMM
            pair_gemm_fn = lambda s, t: kops.group_gemm(sa, sb, [(s, t)])
        else:
            group_gemm_fn = lambda pairs: kops.group_gemm(sa, sb, pairs)
        if cfg.use_pallas == "fused":
            scale_accum_fn = (kops.oz2_scale_accum_update
                              if cfg.accumulate == "oz2"
                              else kops.scale_accum_update)
            unscale_fn = kops.oz2_unscale_update
            if cfg.accum_dtype == "df32":
                # df32: the contraction's whole epilogue in one launch
                epilogue_fn = (kops.oz2_scale_accum_contraction
                               if cfg.accumulate == "oz2"
                               else kops.scale_accum_contraction)
    if cfg.accumulate == "naive":
        return accumulate.matmul_naive(
            sa, sb, accum=cfg.accum_dtype, out_dtype=a.dtype,
            partial=partial, scale_accum_fn=scale_accum_fn,
            pair_gemm_fn=pair_gemm_fn)
    if cfg.accumulate == "oz2":
        return accumulate.matmul_oz2(
            sa, sb, accum=cfg.accum_dtype, out_dtype=a.dtype,
            fast=cfg.fast, n_total=a.shape[-1],
            digit_bits=splitting.digit_bits(cfg.split, sa.beta),
            group_gemm_fn=group_gemm_fn, partial=partial,
            scale_accum_fn=scale_accum_fn, unscale_fn=unscale_fn,
            epilogue_fn=epilogue_fn)
    r = splitting.compute_r(a.shape[-1], sa.beta)
    return accumulate.matmul_group_ef(
        sa, sb, accum=cfg.accum_dtype, out_dtype=a.dtype, r=r,
        group_gemm_fn=group_gemm_fn, partial=partial,
        scale_accum_fn=scale_accum_fn, epilogue_fn=epilogue_fn)


def _check_presplit(a: torch.Tensor, b_shape, cfg: OzimmuConfig,
                    sp: splitting.Split) -> None:
    """Consistency checks between a frozen B split and the call (the
    reference's texts)."""
    n = a.shape[-1]
    beta = splitting.beta_for(cfg.split, n)
    if sp.axis != 1:
        raise ValueError(f"rhs_presplit must carry column scales (axis=1), "
                         f"got axis={sp.axis}")
    if bool(sp.signmag) != splitting.is_signmag(cfg.split):
        raise ValueError(
            f"rhs_presplit signmag={bool(sp.signmag)} does not match the "
            f"config's split {cfg.split!r}; sign-magnitude digits decode "
            f"differently from signed digits — re-freeze under the "
            f"current spec")
    if sp.beta != beta:
        raise ValueError(f"rhs_presplit beta={sp.beta} disagrees with the "
                         f"contraction's beta={beta} (n={n}); the split was "
                         f"frozen for a different contraction length")
    if tuple(sp.digits.shape[1:]) != tuple(b_shape):
        raise ValueError(f"rhs_presplit digits {tuple(sp.digits.shape)} do "
                         f"not match the canonical rhs {tuple(b_shape)}")
    if sp.digits.shape[0] != cfg.k:
        raise ValueError(f"rhs_presplit has k={sp.digits.shape[0]} slices, "
                         f"config wants k={cfg.k}; re-freeze under the "
                         f"current spec")
    if cfg.accumulate == "oz2" and sp.gbase is None:
        raise ValueError("oz2 accumulation needs a constant-scaling "
                         "presplit (gbase); the cached split was frozen "
                         "under a per-row strategy")
    if cfg.accumulate == "group_ef" and sp.base is None:
        raise ValueError("group-EF accumulation needs geometric slice "
                         "scales; the cached split was frozen under the "
                         "adaptive RN strategy")
    if sp.scale.dtype != a.dtype:
        raise ValueError(f"rhs_presplit scales are {sp.scale.dtype}, the "
                         f"contraction computes in {a.dtype}; freeze the "
                         f"weight in the engine's compute dtype")


def _bmm_impl(a: torch.Tensor, b: torch.Tensor, cfg: OzimmuConfig,
              rhs_presplit: Optional[splitting.Split] = None
              ) -> torch.Tensor:
    """Emulated batched matmul on canonical operands:
    (*batch, m, n) @ (*batch, n, p) -> (*batch, m, p)."""
    if a.ndim < 2 or b.ndim < 2 or a.shape[-1] != b.shape[-2] or \
            a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"bad batched GEMM shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    cfg = canonical_fast2(cfg)
    check_supported(cfg)
    if cfg.auto_k:
        if rhs_presplit is not None:
            # the split cache resolved auto k at freeze time with the
            # static plan (split_cache.resolved_k); adopt the frozen k
            cfg = cfg.with_(k=int(rhs_presplit.digits.shape[0]),
                            auto_k=False)
        else:
            # eager: the planner probes the operands (outside a
            # plan.static_plan() scope)
            from repro_torch.core import plan
            cfg = cfg.with_(k=plan.auto_k(a, b, cfg), auto_k=False)
    if rhs_presplit is not None:
        _check_presplit(a, b.shape, cfg, rhs_presplit)
    return _bmm_local(a, b, cfg, rhs_presplit=rhs_presplit)


# ---------------------------------------------------------------------------
# general dot_general: canonicalization
# ---------------------------------------------------------------------------

def _canonicalize_dnums(dimension_numbers) -> DimensionNumbers:
    (ac, bc), (ab, bb) = dimension_numbers
    return ((tuple(map(int, ac)), tuple(map(int, bc))),
            (tuple(map(int, ab)), tuple(map(int, bb))))


def _remaining(ndim: int, *exclude: Sequence[int]):
    ex = set()
    for e in exclude:
        ex.update(e)
    return [i for i in range(ndim) if i not in ex]


def canonical_lhs(a: torch.Tensor, dnums: DimensionNumbers):
    """The lhs in the canonical batched layout ``(*batch, m, n)`` plus the
    free-dim shape ``m_shape`` to restore afterwards."""
    (ac, _), (ab, _) = dnums
    a_free = _remaining(a.ndim, ac, ab)
    batch_shape = tuple(a.shape[i] for i in ab)
    m_shape = tuple(a.shape[i] for i in a_free)
    n = math.prod(a.shape[i] for i in ac)
    a3 = a.permute(list(ab) + a_free + list(ac)).reshape(
        batch_shape + (math.prod(m_shape), n))
    return a3, m_shape


def canonical_rhs(b: torch.Tensor, dnums: DimensionNumbers):
    """The rhs of ``dot_general(a, b, dnums)`` in the canonical batched
    layout ``(*batch, n, p)`` the emulation contracts, plus the total
    contraction length n — the layout a frozen B-side Split is computed
    against."""
    (_, bc), (_, bb) = dnums
    b_free = _remaining(b.ndim, bc, bb)
    batch_shape = tuple(b.shape[i] for i in bb)
    n = math.prod(b.shape[i] for i in bc)
    p = math.prod(b.shape[i] for i in b_free)
    b3 = b.permute(list(bb) + list(bc) + b_free).reshape(
        batch_shape + (n, p))
    return b3, n


def check_dnums(a_shape, b_shape, dnums: DimensionNumbers) -> None:
    (ac, bc), (ab, bb) = dnums
    if len(ac) != len(bc) or len(ab) != len(bb):
        raise ValueError(f"mismatched dimension numbers {dnums}")
    for i, j in zip(ac, bc):
        if a_shape[i] != b_shape[j]:
            raise ValueError(f"contraction size mismatch {tuple(a_shape)} @ "
                             f"{tuple(b_shape)}: {dnums}")
    for i, j in zip(ab, bb):
        if a_shape[i] != b_shape[j]:
            raise ValueError(f"batch size mismatch {tuple(a_shape)} @ "
                             f"{tuple(b_shape)}: {dnums}")


def rhs_free_shape(b_shape, dnums: DimensionNumbers):
    (_, bc), (_, bb) = dnums
    return tuple(b_shape[i] for i in _remaining(len(b_shape), bc, bb))


def _dot_general_impl(a: torch.Tensor, b: torch.Tensor,
                      dnums: DimensionNumbers, cfg: OzimmuConfig,
                      rhs_presplit: Optional[splitting.Split] = None
                      ) -> torch.Tensor:
    """Normalize to the canonical batched form and run the emulation.
    Output layout is lax's: (*batch [lhs order], *lhs free, *rhs free)."""
    check_dnums(a.shape, b.shape, dnums)
    a3, m_shape = canonical_lhs(a, dnums)
    batch_shape = a3.shape[:-2]
    b3, _ = canonical_rhs(b, dnums)
    out = _bmm_impl(a3, b3, cfg, rhs_presplit=rhs_presplit)
    return out.reshape(tuple(batch_shape) + m_shape
                       + rhs_free_shape(b.shape, dnums))


# ---------------------------------------------------------------------------
# the VJP against general dimension numbers
# ---------------------------------------------------------------------------

def _ranges_like(*seqs):
    start = 0
    out = []
    for s in seqs:
        out.append(list(range(start, start + len(s))))
        start += len(s)
    return out


def _argsort(seq):
    return sorted(range(len(seq)), key=seq.__getitem__)


def _transpose_operand(g, other, target_ndim: int, dnums: DimensionNumbers,
                       cfg: OzimmuConfig, swap_ans: bool):
    """Cotangent of the lhs of ``dot_general(x, y, dnums)`` (lax's
    ``_dot_general_transpose_lhs`` with the contraction itself emulated).
    For the rhs cotangent, call with the roles of x and y swapped in
    ``dnums`` and ``swap_ans=True``."""
    (xc, yc), (xb, yb) = dnums
    x_kept = _remaining(target_ndim, xc, xb)
    y_kept = _remaining(other.ndim, yc, yb)
    if swap_ans:
        g_batch, g_y_kept, _ = _ranges_like(xb, y_kept, x_kept)
    else:
        g_batch, _, g_y_kept = _ranges_like(xb, x_kept, y_kept)
    dims = ((tuple(g_y_kept), tuple(y_kept)), (tuple(g_batch), tuple(yb)))
    dx = _dot_general_impl(g, other, _canonicalize_dnums(dims), cfg)
    xc_sorted_by_yc = [xc[i] for i in _argsort(yc)]
    out_axes = _argsort(list(xb) + x_kept + xc_sorted_by_yc)
    return dx.permute(out_axes)


class _OzDotGeneral(torch.autograd.Function):
    """The emulated ``dot_general`` with the reference's custom VJP: the
    residuals are the operands, and each cotangent is one emulated
    contraction of ``g`` with the other operand (transposed dimension
    numbers are free re-slices; no precision leaves the scheme).  A frozen
    B split (``rhs_presplit``) only accelerates the forward: it rides
    along as a plain argument, gets no gradient, and both cotangents run
    the regular emulation.  Cotangents an input does not need are not
    computed (the reference's jitted backward drops them as dead code)."""

    @staticmethod
    def forward(ctx, a, b, dnums, cfg, rhs_presplit):
        ctx.dnums, ctx.cfg = dnums, cfg
        ctx.save_for_backward(a, b)
        return _dot_general_impl(a, b, dnums, cfg, rhs_presplit=rhs_presplit)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dnums, cfg = ctx.dnums, ctx.cfg
        (ac, bc), (ab, bb) = dnums
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _transpose_operand(g, b, a.ndim, dnums, cfg, swap_ans=False)
        if ctx.needs_input_grad[1]:
            db = _transpose_operand(g, a, b.ndim, ((bc, ac), (bb, ab)), cfg,
                                    swap_ans=True)
        return da, db, None, None, None


def ozimmu_dot_general(a: torch.Tensor, b: torch.Tensor, dimension_numbers,
                       cfg: OzimmuConfig = VARIANTS["ozimmu_h"],
                       rhs_presplit: Optional[splitting.Split] = None
                       ) -> torch.Tensor:
    """Emulated ``jax.lax.dot_general`` via k-slice INT8 GEMMs.

    ``dimension_numbers`` is the lax contract ``((lhs_contract,
    rhs_contract), (lhs_batch, rhs_batch))``; the output layout is lax's.
    ``rhs_presplit`` (serving): a frozen column-scale Split of the
    canonical rhs (:class:`repro_torch.core.split_cache.SplitCache`) makes
    the call skip the B-side splitter, bit-identical to the uncached path.
    Differentiable (:class:`_OzDotGeneral`) when autograd records and an
    operand requires grad; otherwise the emulation runs directly.
    """
    dnums = _canonicalize_dnums(dimension_numbers)
    if rhs_presplit is not None:
        sp = rhs_presplit
        beta = splitting.beta_for(cfg.split,
                                  math.prod(b.shape[i] for i in dnums[0][1]))
        if bool(sp.signmag) != splitting.is_signmag(cfg.split):
            raise ValueError(
                f"rhs_presplit signmag={sp.signmag} does not match the "
                f"config's split {cfg.split!r}; sign-magnitude digits "
                f"decode differently from signed digits — re-freeze under "
                f"the current spec")
        if sp.beta != beta:
            raise ValueError(f"rhs_presplit beta={sp.beta} disagrees with "
                             f"the contraction's beta={beta}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _OzDotGeneral.apply(a, b, dnums, cfg, rhs_presplit)
    return _dot_general_impl(a, b, dnums, cfg, rhs_presplit=rhs_presplit)


def ozimmu_matmul(a: torch.Tensor, b: torch.Tensor,
                  cfg: OzimmuConfig = VARIANTS["ozimmu_h"]) -> torch.Tensor:
    """Emulated high-precision ``a @ b``: a (m, n), b (n, p), f32 or f64.
    Returns (m, p) in a.dtype."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return ozimmu_dot_general(a, b, (((1,), (0,)), ((), ())), cfg)
