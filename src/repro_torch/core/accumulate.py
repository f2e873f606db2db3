"""Slice-product evaluation + accumulation for the Ozaki scheme — PyTorch
port of ``repro.core.accumulate``.

Two evaluation strategies from the paper:

  * ``matmul_naive``    — Alg. 4: one INT8 GEMM per slice pair (s, t) with
    s+t <= k+1, each converted to high precision, scaled, and added.
  * ``matmul_group_ef`` — Alg. 6/7 (proposed): all pairs on an anti-diagonal
    group g = s+t share the exponent 2^(-beta*g), so they are summed inside
    the integer accumulator (chunks of at most r pairs, eq. 12), then
    converted, scaled and added once per chunk.

High-precision accumulator modes: ``f64`` (paper-faithful; native on
Hopper), ``f32`` and ``df32`` (two-float compensated accumulation, kept for
parity with the reference).

Every INT8 product goes through :func:`repro_torch.kernels.group_gemm.
group_gemm`: on a CUDA tensor that is the hand-written kernel (CUDA has no
int32 matmul), on a CPU tensor its plain version.  ``torch.mm`` on int8 CPU
tensors would return int8 and wrap, so nothing here calls it.

Hooks, as in the reference: ``group_gemm_fn(pairs)``, ``pair_gemm_fn(s, t)``
and ``scale_accum_fn(prod, srow, scol, acc)`` replace the int8 products and
the convert+scale+add epilogue (the ``:fused`` pipeline substitutes the
kernels of ``repro_torch.kernels.ops``).  ``partial=True`` returns the
unrounded accumulator.  The Ozaki-II ladder (``matmul_oz2``) and the mesh
``product_reduce`` hook come with later slices of the port.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.splitting import Split, compute_r, sm_decode_slice

__all__ = [
    "int8_gemm",
    "gemm_slice",
    "matmul_naive",
    "matmul_group_ef",
    "group_gemm_concat",
    "DF32",
    "int32_to_df32",
]

_ACC_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def int8_gemm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(*batch, m, n) int8 @ (*batch, n, p) int8 -> (*batch, m, p) int32.

    Exact barring overflow; runs as a one-pair group GEMM (the kernel on
    CUDA, its plain version on the CPU)."""
    from repro_torch.kernels.group_gemm import group_gemm
    return group_gemm(a8[None], b8[None])


def gemm_slice(sp: Split, i: int) -> torch.Tensor:
    """Slice ``i`` (0-indexed) of a split, widened for the integer GEMM
    (sign-magnitude digits widen to int16 values)."""
    d = sp.digits[i]
    return sm_decode_slice(d, i) if sp.signmag else d


# ---------------------------------------------------------------------------
# double-float (two-float) arithmetic
# ---------------------------------------------------------------------------

class DF32(NamedTuple):
    """Unevaluated sum hi + lo of two f32 tensors, |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to_float(self, dtype=torch.float64) -> torch.Tensor:
        return self.hi.to(dtype) + self.lo.to(dtype)


def _two_sum(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def df32_zero(shape, device) -> DF32:
    """A fresh zero accumulator.  ``hi`` and ``lo`` are separate buffers:
    the fused epilogue updates them in place."""
    return DF32(torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def df32_add_df(c: DF32, x: DF32) -> DF32:
    hi, e = _two_sum(c.hi, x.hi)
    lo = c.lo + e + x.lo
    hi2, e2 = _two_sum(hi, lo)
    return DF32(hi2, e2)


def int32_to_df32(p: torch.Tensor) -> DF32:
    """Exact int32 -> (hi, lo) f32 pair: hi = p with the low 8 bits cleared
    (arithmetic shifts), lo = the low 8 bits in [0, 255]."""
    hi_int = (p >> 8) << 8
    lo_int = p - hi_int
    return DF32(hi_int.to(torch.float32), lo_int.to(torch.float32))


def _outer_scale(p: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor) -> torch.Tensor:
    """diag(sa) @ p @ diag(sb) per batch element, in the reference's
    multiply order ``(p * sa) * sb``."""
    return p * sa[..., :, None] * sb[..., None, :]


def _term_pairs(k: int) -> Sequence[Tuple[int, int]]:
    """Fast-mode slice pairs (1-indexed): s + t <= k + 1."""
    return [(s, g - s) for g in range(2, k + 2) for s in range(1, g)]


# ---------------------------------------------------------------------------
# per-term convert+scale+add — the default (plain) epilogue hooks
# ---------------------------------------------------------------------------

def _scale_accum_df32(prod: torch.Tensor, srow: torch.Tensor,
                      scol: torch.Tensor, acc: DF32) -> DF32:
    """One df32 epilogue step: ``acc += srow * float(prod) * scol``,
    compensated (the reference's exact operation sequence)."""
    term = int32_to_df32(prod)
    term = DF32(_outer_scale(term.hi, srow, scol),
                _outer_scale(term.lo, srow, scol))
    return df32_add_df(acc, term)


def _scale_accum_plain(prod: torch.Tensor, srow: torch.Tensor,
                       scol: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """One plain-accumulator epilogue step in ``acc.dtype`` (f64/f32)."""
    return acc + _outer_scale(prod.to(acc.dtype), srow, scol)


def _out_shape(sa: Split, sb: Split):
    return tuple(sa.digits.shape[1:-1]) + (sb.digits.shape[-1],)


# ---------------------------------------------------------------------------
# Alg. 4 — naive accumulation
# ---------------------------------------------------------------------------

def matmul_naive(sa: Split, sb: Split, *, accum: str = "f64",
                 out_dtype=None, partial: bool = False,
                 scale_accum_fn: Optional[Callable] = None,
                 pair_gemm_fn: Optional[Callable] = None
                 ) -> Union[torch.Tensor, DF32]:
    """One INT8 GEMM + one high-precision scaled add per slice pair.
    Batched: digits ``(k, *batch, m, n)`` / ``(k, *batch, n, p)``."""
    assert sa.axis == 0 and sb.axis == 1, "A needs row scales, B column scales"
    k = sa.digits.shape[0]
    assert sb.digits.shape[0] == k
    out_shape = _out_shape(sa, sb)
    out_dtype = out_dtype or sa.scale.dtype
    device = sa.digits.device
    pairs = _term_pairs(k)
    gemm = pair_gemm_fn or (
        lambda s, t: int8_gemm(gemm_slice(sa, s - 1), gemm_slice(sb, t - 1)))
    prods = [gemm(s, t) for s, t in pairs]

    if accum == "df32":
        fn = scale_accum_fn or _scale_accum_df32
        acc = df32_zero(out_shape, device)
        for (s, t), prod in zip(pairs, prods):
            acc = fn(prod, sa.scale[s - 1].to(torch.float32),
                     sb.scale[t - 1].to(torch.float32), acc)
        return acc if partial else acc.to_float(out_dtype)

    acc_dtype = _ACC_DTYPES[accum]
    fn = scale_accum_fn or _scale_accum_plain
    c = torch.zeros(out_shape, dtype=acc_dtype, device=device)
    for (s, t), prod in zip(pairs, prods):
        c = fn(prod, sa.scale[s - 1].to(acc_dtype),
               sb.scale[t - 1].to(acc_dtype), c)
    return c if partial else c.to(out_dtype)


# ---------------------------------------------------------------------------
# Alg. 6/7 — group-wise error-free accumulation
# ---------------------------------------------------------------------------

def _group_chunks(k: int, r: int):
    """Yield (g, [(s, t), ...]) chunks of size <= r per anti-diagonal group."""
    for g in range(2, k + 2):
        pairs = [(s, g - s) for s in range(1, g)]
        for i in range(0, len(pairs), r):
            yield g, pairs[i:i + r]


def group_gemm_concat(sa: Split, sb: Split, pairs) -> torch.Tensor:
    """sum_{(s,t) in pairs} A_s @ B_t as ONE int8 GEMM over the
    contraction-axis concatenation of the group's slices (the reference's
    XLA realization of Alg. 6's INT32 group sum)."""
    a_cat = torch.cat([gemm_slice(sa, s - 1) for s, _ in pairs], dim=-1)
    b_cat = torch.cat([gemm_slice(sb, t - 1) for _, t in pairs], dim=-2)
    return int8_gemm(a_cat, b_cat)


def matmul_group_ef(sa: Split, sb: Split, *, accum: str = "f64",
                    out_dtype=None, r: Optional[int] = None,
                    group_gemm_fn=None, partial: bool = False,
                    scale_accum_fn: Optional[Callable] = None
                    ) -> Union[torch.Tensor, DF32]:
    """Group-wise error-free accumulation (Alg. 6; Alg. 7 when r >= k).
    Needs geometric slice scales: every pair of group g carries
    ``baseA (x) baseB * 2^(-beta*g)``."""
    assert sa.axis == 0 and sb.axis == 1
    if sa.base is None or sb.base is None:
        raise ValueError("group-EF accumulation needs geometric slice scales "
                         "(bitmask or rn_const splitting); got adaptive RN")
    k = sa.digits.shape[0]
    beta = sa.beta
    n = sa.digits.shape[-1]
    out_shape = _out_shape(sa, sb)
    out_dtype = out_dtype or sa.scale.dtype
    device = sa.digits.device
    if r is None:
        r = compute_r(n, beta)
    gg = group_gemm_fn or (lambda pairs: group_gemm_concat(sa, sb, pairs))
    chunks = list(_group_chunks(k, r))
    prods = [gg(pairs) for _, pairs in chunks]

    # The 2^(-beta*g) group exponent folds into the row scale (exact).
    if accum == "df32":
        fn = scale_accum_fn or _scale_accum_df32
        acc = df32_zero(out_shape, device)
        base_a = sa.base.to(torch.float32)
        base_b = sb.base.to(torch.float32)
        for (g, _), prod in zip(chunks, prods):
            acc = fn(prod, base_a * (2.0 ** (-beta * g)), base_b, acc)
        return acc if partial else acc.to_float(out_dtype)

    acc_dtype = _ACC_DTYPES[accum]
    fn = scale_accum_fn or _scale_accum_plain
    c = torch.zeros(out_shape, dtype=acc_dtype, device=device)
    base_a = sa.base.to(acc_dtype)
    base_b = sb.base.to(acc_dtype)
    for (g, _), prod in zip(chunks, prods):
        c = fn(prod, base_a * (2.0 ** (-beta * g)), base_b, c)
    return c if partial else c.to(out_dtype)
