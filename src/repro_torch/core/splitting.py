"""Slice extraction ("splitting") for the Ozaki scheme — PyTorch port of
``repro.core.splitting``.

This slice ports the per-row geometric strategies the main path needs:

  * ``split_bitmask``  — Alg. 3: truncate consecutive beta-bit groups.
  * ``split_rn_const`` — Alg. 8 (the "H" splitting): round-to-nearest with
    a fixed base scale and constant grid ratio 2^-beta per slice, so slice
    scales form the geometric sequence group-wise error-free accumulation
    (Alg. 6/7) needs.
  * ``split_sm``       — sign-magnitude digits (the ``ozimmu_sm_*``
    family): the sign lives in the leading slice only, trailing digits are
    unsigned magnitudes stored mod 2^8 (decode with :func:`sm_decode`).

plus the adaptive splitter and the Ozaki-II constant-scaling strategies:

  * ``split_rn``      — Alg. 5 (the "RN" splitting): round-to-nearest with
    a grid re-derived from the residual's row maxima every slice; scales
    are not geometric (``base is None``), so only naive accumulation
    applies (``ozimmu_rn``).
  * ``split_oz2`` / ``split_oz2_bitmask`` — Ozaki-II constant scaling
    (``oz2_h`` / ``oz2_b``): the RN / truncation extraction on ONE grid
    per batch element, from the global |a| maximum; the scalar base rides
    in ``Split.gbase``.
  * ``split_oz2_fast2`` / ``split_oz2_bitmask_fast2`` — the improved
    fast-mode scaling (spec token ``:fast2``): every row is equilibrated
    by its own power of two, so the digits are bitwise the per-row
    splitter's and the equilibrated grid is the constant ``gbase = 2``;
    ``matmul_oz2`` unscales by ``base / gbase`` after the ladder.

Every split returns a :class:`Split` with the reference's convention

    A  ~  sum_s diag(scale[s]) @ digits[s]      (axis=0, row scales)
    A  ~  sum_s digits[s] @ diag(scale[s])      (axis=1, column scales)

with ``scale[s] = base * 2^(-beta*(s+1))`` (0-indexed s).  All arithmetic is
power-of-two scaling, rounding to representable grids and exact residual
subtraction, so the digits are bit-identical to the reference's.  Exponents
and powers of two are read from and built from bit patterns, never
``log2``, which is exact on every device.

Float-to-int8 conversion saturates and maps NaN to 0 (:func:`to_int8`), as
XLA's conversion does.

Subnormals: the reference's XLA arithmetic runs with flush-to-zero and
denormals-are-zero (on its CPU as on the TPU), so every multiply, divide,
add and subtract treats a subnormal operand as zero and returns zero for a
subnormal result, and a comparison with zero holds for a subnormal; ``abs``,
``max`` and ``frexp`` do not flush.  The port runs IEEE arithmetic on both
devices and flushes explicitly (:func:`ftz`) at those operations, so a row
whose grid underflows (f32 maxima below about 2^(beta k - 126)) splits as
the reference's does.  For the B operand (``axis=1``) the digit stack is
stored K-major (:func:`kmajor_stack`): each column's n contraction digits
are contiguous, as the card's int8 group GEMM reads them; the logical shape
and values stay the reference's.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "Split",
    "compute_beta",
    "compute_beta_sm",
    "beta_for",
    "compute_r",
    "digit_bits",
    "split_bitmask",
    "split_rn_const",
    "split_sm",
    "split_rn",
    "split_oz2",
    "split_oz2_bitmask",
    "split_oz2_fast2",
    "split_oz2_bitmask_fast2",
    "sm_decode",
    "sm_decode_slice",
    "reconstruct",
    "residual",
    "to_int8",
    "ftz",
    "kmajor_stack",
]


class Split(NamedTuple):
    """k int8 slices of a (possibly batched) matrix plus per-slice scales.

    Attributes:
      digits: ``(k, *batch, m, n)`` int8 slice matrices (for ``axis=1``
              a transposed view of K-major storage, :func:`kmajor_stack`).
      scale:  ``(k, *batch, r)`` per-slice power-of-two scales (r = rows for
              ``axis=0``, columns for ``axis=1``).
      base:   ``(*batch, r)`` geometric base, ``scale[s] = base *
              2^(-beta*(s+1))``.
      beta:   bits per slice.
      axis:   0 if ``scale`` indexes rows, 1 for columns.
      gbase:  ``(*batch,)`` scalar base of the constant-grid (oz2)
              strategies (2 for the fast2 ones); None for the per-row
              strategies.
      signmag: sign-magnitude storage (``split_sm``): slices 1..k-1 are
              unsigned magnitudes stored mod 2^8 — widen through
              :func:`sm_decode` before any arithmetic.
    """

    digits: torch.Tensor
    scale: torch.Tensor
    base: Optional[torch.Tensor]
    beta: int
    axis: int
    gbase: Optional[torch.Tensor] = None
    signmag: bool = False


def compute_beta(n: int) -> int:
    """beta = min(7, floor((31 - ceil(log2 n)) / 2)) — eq. (4) of the paper,
    with the exact integer ceil(log2 n) so ``n * (2^beta - 1)^2 < 2^31``."""
    if n <= 0:
        raise ValueError(f"contraction length must be positive, got {n}")
    clog2 = max(1, (n - 1).bit_length())
    beta = min(7, (31 - clog2) // 2)
    if beta < 1:
        raise ValueError(f"n={n} too large for int8 Ozaki scheme (beta < 1)")
    return beta


def compute_beta_sm(n: int) -> int:
    """beta for the sign-magnitude strategy: min(8, floor((31-log2 n)/2))."""
    if n <= 0:
        raise ValueError(f"contraction length must be positive, got {n}")
    clog2 = max(1, (n - 1).bit_length())
    beta = min(8, (31 - clog2) // 2)
    if beta < 1:
        raise ValueError(f"n={n} too large for int8 Ozaki scheme (beta < 1)")
    return beta


# splits using the sign-magnitude storage convention (Split.signmag=True)
SM_SPLITS = ("sm",)


def is_signmag(split: str) -> bool:
    return split in SM_SPLITS


def beta_for(split: str, n: int) -> int:
    """Slice width of a splitting strategy at contraction length n."""
    return compute_beta_sm(n) if split in SM_SPLITS else compute_beta(n)


def compute_r(n: int, beta: int, digit_bits: Optional[int] = None) -> int:
    """Slice-pair products summable in INT32 without overflow — eq. (12).

    ``digit_bits=None``: digits strictly below 2^beta, so the power-of-two
    ``r = 2^(31 - 2*beta - ceil(log2 n))`` is safe.  With ``digit_bits``
    the digits may attain ±2^digit_bits and one pair is shaved off.
    """
    clog2 = max(1, (n - 1).bit_length())
    if digit_bits is None:
        return max(1, 2 ** max(0, 31 - 2 * beta - clog2))
    return max(1, 2 ** max(0, 31 - 2 * digit_bits - clog2) - 1)


# splits whose digits lie in [-2^(beta-1), 2^(beta-1)] (round-to-nearest)
RN_SPLITS = ("rn", "rn_const", "oz2_rn", "oz2_rn_fast2")


def digit_bits(split: str, beta: int) -> int:
    """Digit magnitude bits of a splitting strategy."""
    return beta - 1 if split in RN_SPLITS else beta


def to_int8(d: torch.Tensor) -> torch.Tensor:
    """Float digits -> int8, saturating, NaN -> 0 (XLA's conversion;
    ``Tensor.to(torch.int8)`` wraps instead)."""
    return torch.nan_to_num(d, nan=0.0).clamp(-128.0, 127.0).to(torch.int8)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """XLA's flush to zero: a subnormal becomes a zero of its sign (NaN and
    infinities pass).  Applied to arithmetic results that can fall below
    the normal range, and to operands that can be subnormal (denormals are
    zero); every consumer of a scale flushes it on the way in, so a
    product of powers of two feeding one is left to it."""
    return x * (x.abs() >= torch.finfo(x.dtype).tiny)


def kmajor_stack(digits, axis: int) -> torch.Tensor:
    """Stack k digit slices ``(*batch, m, n)`` into ``(k, *batch, m, n)``.
    For ``axis=1`` (the B operand) the storage is ``(k, *batch, n_cols,
    n_rows)``, returned as its transposed view: the contraction runs
    contiguous, as the int8 group GEMM reads it on the card."""
    if axis == 0:
        return torch.stack(digits)
    return torch.stack([d.transpose(-1, -2) for d in digits]
                       ).transpose(-1, -2)


def _rowmax(a: torch.Tensor, axis: int) -> torch.Tensor:
    """max_j |a_ij| along the non-scale matrix axis; shape (*batch, r)."""
    return a.abs().amax(dim=-1 if axis == 0 else -2)


def _contract_len(a: torch.Tensor, axis: int) -> int:
    return a.shape[-1] if axis == 0 else a.shape[-2]


_FLOAT_BITS = {torch.float32: (23, 127, torch.int32),
               torch.float64: (52, 1023, torch.int64)}


def _exponent(x: torch.Tensor):
    """``(biased exponent field, fraction bits nonzero)`` of ``x >= 0``
    (a row maximum), read from its bit pattern, and the field's all-ones
    value (infinity and NaN)."""
    mbits, bias, itype = _FLOAT_BITS[x.dtype]
    bits = x.view(itype)
    return bits >> mbits, (bits & ((1 << mbits) - 1)) != 0, 2 * bias + 1


def _pow2_floor(x: torch.Tensor) -> torch.Tensor:
    """2^floor(log2 x) elementwise for ``x >= 0``, as the reference's
    frexp/ldexp give it: 1.0 where x is 0 or subnormal (its ``x == 0``
    under denormals-are-zero), 0.5 for infinity and NaN.  Built from the
    bit pattern: exact, and a handful of operations."""
    mbits = _FLOAT_BITS[x.dtype][0]
    expo, _, top = _exponent(x)
    out = torch.where(expo == 0, 1.0, (expo << mbits).view(x.dtype))
    return torch.where(expo == top, 0.5, out)


def _pow2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2^ceil(log2 x) elementwise for ``x >= 0``: 1.0 where x is 0,
    subnormal, infinity or NaN (the reference's frexp/ldexp); infinity
    above the largest power of two."""
    mbits = _FLOAT_BITS[x.dtype][0]
    expo, frac, top = _exponent(x)
    out = ((expo + frac) << mbits).view(x.dtype)
    return torch.where((expo == 0) | (expo == top), 1.0, out)


def _bcast(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Broadcast a (*batch, r) per-row/col vector against the matrix."""
    return v[..., :, None] if axis == 0 else v[..., None, :]


@functools.lru_cache(maxsize=None)
def _geo_exps(beta: int, k: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """[2^(-beta*s) for s = 1..k] on ``device``, built once per key: a
    host-to-device copy on every split would stall the host on the card.
    Read-only (shared by every caller)."""
    return torch.tensor([2.0 ** (-beta * s) for s in range(1, k + 1)],
                        dtype=dtype, device=device)


def _geo_scales(base: torch.Tensor, beta: int, k: int) -> torch.Tensor:
    """scale[s] = base * 2^(-beta*(s+1)), shape (k, *batch, r)."""
    exps = _geo_exps(beta, k, base.dtype, base.device)
    return ftz(base[None] * exps.reshape((k,) + (1,) * base.ndim))


def split_bitmask(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
                  axis: int = 0,
                  rowmax_reduce: Optional[Callable] = None) -> Split:
    """Alg. 3 — bit-mask splitting in pure float arithmetic (batched)."""
    if beta is None:
        beta = compute_beta(_contract_len(a, axis))
    rowmax = _rowmax(a, axis)
    if rowmax_reduce is not None:
        rowmax = rowmax_reduce(rowmax)
    base = 2.0 * _pow2_floor(rowmax)     # a normal power of two
    digits = _bitmask_extract(a, base, beta, k, axis)
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis)


def _bitmask_extract(a, base, beta: int, k: int, axis: int) -> torch.Tensor:
    """The Alg. 3 truncation loop; returns ``(k, *batch, m, n)`` int8."""
    two_beta = 2.0 ** beta
    r = ftz(ftz(a) * _bcast(ftz(1.0 / base), axis))
    digits = []
    for _ in range(k):
        r = ftz(r * two_beta)
        d = torch.trunc(r)
        r = ftz(r - d)
        digits.append(to_int8(d))
    return kmajor_stack(digits, axis)


def _rn_extract(r, grid, axis: int):
    """One round-to-nearest-even extraction: (slice_value, new_residual).
    ``r`` and ``grid`` are flushed already."""
    g = _bcast(grid, axis)
    s = ftz(torch.round(ftz(r * ftz(1.0 / g))) * g)
    return s, ftz(r - s)


def split_rn(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
             axis: int = 0,
             rowmax_reduce: Optional[Callable] = None) -> Split:
    """Alg. 5 — round-to-nearest splitting with per-slice adaptive
    rescaling: slice s rounds the residual to the nearest multiple of
    ``2^ceil(log2 rowmax(residual)) * 2^(1-beta)``.  Scales are not
    geometric (``base is None``), so only naive accumulation applies (the
    "ozIMMU_RN" configuration).  ``rowmax_reduce`` applies per slice."""
    if beta is None:
        beta = compute_beta(_contract_len(a, axis))
    grid_factor = 2.0 ** (1 - beta)
    r = a
    digits, scales = [], []
    for _ in range(k):
        rowmax = _rowmax(r, axis)
        if rowmax_reduce is not None:
            rowmax = rowmax_reduce(rowmax)
        grid = ftz(_pow2_ceil(rowmax) * grid_factor)
        s, r = _rn_extract(ftz(r), grid, axis)
        d = ftz(s * _bcast(ftz(1.0 / grid), axis))
        digits.append(to_int8(d))
        scales.append(grid)
    return Split(kmajor_stack(digits, axis), torch.stack(scales), None, beta,
                 axis)


def split_rn_const(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
                   axis: int = 0,
                   rowmax_reduce: Optional[Callable] = None) -> Split:
    """Alg. 8 — round-to-nearest splitting with constant grid ratio 2^-beta
    (the "ozIMMU_H" splitting).  Batched; one rowmax pass."""
    if beta is None:
        beta = compute_beta(_contract_len(a, axis))
    rowmax = _rowmax(a, axis)
    if rowmax_reduce is not None:
        rowmax = rowmax_reduce(rowmax)
    mu = ftz(_pow2_ceil(rowmax) * (2.0 ** (1 - beta)))
    digits = _rn_const_extract(a, mu, beta, k, axis)
    base = mu * (2.0 ** beta)            # mu is 0 or normal
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis)


def _rn_const_extract(a, mu, beta: int, k: int, axis: int) -> torch.Tensor:
    """The Alg. 8 RN loop against the first grid ``mu``."""
    two_beta = 2.0 ** beta
    r = ftz(a)
    grid = mu
    digits = []
    for _ in range(k):
        s, r = _rn_extract(r, grid, axis)
        d = ftz(s * _bcast(ftz(1.0 / grid), axis))
        digits.append(to_int8(d))
        grid = ftz(grid * (1.0 / two_beta))
    return kmajor_stack(digits, axis)


def split_sm(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
             axis: int = 0,
             rowmax_reduce: Optional[Callable] = None) -> Split:
    """Sign-magnitude splitting (``ozimmu_sm_b`` / ``ozimmu_sm_h``):
    two's-complement digits of ``a / anchor`` with the strict anchor
    ``2 * 2^floor(log2 rowmax)``; trailing digits stored mod 2^8."""
    if beta is None:
        beta = compute_beta_sm(_contract_len(a, axis))
    rowmax = _rowmax(a, axis)
    if rowmax_reduce is not None:
        rowmax = rowmax_reduce(rowmax)
    anchor = 2.0 * _pow2_floor(rowmax)   # a normal power of two
    digits = _sm_extract(a, anchor, beta, k, axis)
    base = 2.0 * anchor
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis,
                 signmag=True)


def _sm_extract(a, anchor, beta: int, k: int, axis: int) -> torch.Tensor:
    """The sign-magnitude extraction loop (``min(floor(r), 2^beta - 1)``
    clamp on the trailing digits, stored mod 2^8)."""
    two_beta = 2.0 ** beta
    dmax = 2.0 ** beta - 1.0
    r = ftz(ftz(a) * _bcast(ftz(1.0 / anchor), axis))
    r = ftz(r * (2.0 ** (beta - 1)))
    d = torch.floor(r)
    r = ftz(r - d)
    digits = [to_int8(d)]
    for _ in range(k - 1):
        r = ftz(r * two_beta)
        d = torch.clamp(torch.floor(r), max=dmax)
        r = ftz(r - d)
        digits.append(to_int8(torch.where(d > 127.0, d - 256.0, d)))
    return kmajor_stack(digits, axis)


def _global_base(a: torch.Tensor, axis: int,
                 rowmax_reduce: Optional[Callable]) -> torch.Tensor:
    """Per-batch-element global |a| maximum, broadcast back to the per-row
    (``axis=0``) / per-column (``axis=1``) vector shape ``(*batch, r)``
    (reduced through the row maxima, so ``rowmax_reduce`` composes as in
    the per-row splitters)."""
    rowmax = _rowmax(a, axis)
    if rowmax_reduce is not None:
        rowmax = rowmax_reduce(rowmax)
    return rowmax.amax(dim=-1, keepdim=True).expand(rowmax.shape)


def split_oz2(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
              axis: int = 0,
              rowmax_reduce: Optional[Callable] = None) -> Split:
    """Ozaki-II constant scaling, round-to-nearest digits (``oz2_h``): the
    Alg. 8 extraction against ONE grid ``mu = 2^ceil(log2 max|a|) *
    2^(1-beta)`` per batch element, so a slice pair's scale is the scalar
    ``gbaseA * gbaseB * 2^(-beta*(s+t))``."""
    if beta is None:
        beta = compute_beta(_contract_len(a, axis))
    gmax = _global_base(a, axis, rowmax_reduce)
    mu = ftz(_pow2_ceil(gmax) * (2.0 ** (1 - beta)))
    digits = _rn_const_extract(a, mu, beta, k, axis)
    base = mu * (2.0 ** beta)            # mu is 0 or normal
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis,
                 gbase=base[..., 0])


def split_oz2_bitmask(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
                      axis: int = 0,
                      rowmax_reduce: Optional[Callable] = None) -> Split:
    """Ozaki-II constant scaling, truncation digits (``oz2_b``): Alg. 3
    against the shared grid ``base = 2 * 2^floor(log2 max|a|)``."""
    if beta is None:
        beta = compute_beta(_contract_len(a, axis))
    gmax = _global_base(a, axis, rowmax_reduce)
    base = 2.0 * _pow2_floor(gmax)
    digits = _bitmask_extract(a, base, beta, k, axis)
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis,
                 gbase=base[..., 0])


def _with_fast2_gbase(s: Split) -> Split:
    """Attach the constant equilibrated-grid base ``gbase = 2`` to a
    per-row split (the fast2 contract): ``base / gbase`` is then the exact
    power-of-two equilibration factor ``matmul_oz2`` unscales by."""
    return s._replace(gbase=torch.full(s.base.shape[:-1], 2.0,
                                       dtype=s.base.dtype,
                                       device=s.base.device))


def split_oz2_fast2(a: torch.Tensor, k: int, *, beta: Optional[int] = None,
                    axis: int = 0,
                    rowmax_reduce: Optional[Callable] = None) -> Split:
    """Improved fast-mode scaling, RN digits (``oz2_h ... :fast2``): bitwise
    :func:`split_rn_const`'s digits and per-row bases, plus ``gbase = 2``."""
    return _with_fast2_gbase(split_rn_const(a, k, beta=beta, axis=axis,
                                            rowmax_reduce=rowmax_reduce))


def split_oz2_bitmask_fast2(a: torch.Tensor, k: int, *,
                            beta: Optional[int] = None, axis: int = 0,
                            rowmax_reduce: Optional[Callable] = None
                            ) -> Split:
    """Improved fast-mode scaling, truncation digits (``oz2_b ...
    :fast2``): bitwise :func:`split_bitmask`'s digits, plus ``gbase = 2``."""
    return _with_fast2_gbase(split_bitmask(a, k, beta=beta, axis=axis,
                                           rowmax_reduce=rowmax_reduce))


def sm_decode(digits: torch.Tensor) -> torch.Tensor:
    """Widen stored sign-magnitude digits ``(k, ...)`` int8 -> int16:
    slice 0 stays signed, slices 1..k-1 un-wrap to [0, 2^beta - 1]."""
    w = digits.to(torch.int16)
    if w.shape[0] <= 1:
        return w
    t = w[1:]
    return torch.cat([w[:1], torch.where(t < 0, t + 256, t)], dim=0)


def sm_decode_slice(d: torch.Tensor, s: int) -> torch.Tensor:
    """Widen ONE stored slice (0-indexed position ``s``) to int16."""
    w = d.to(torch.int16)
    return w if s == 0 else torch.where(w < 0, w + 256, w)


def reconstruct(split: Split, dtype=None) -> torch.Tensor:
    """sum_s diag(scale[s]) @ digits[s] (or the axis=1 transpose form)."""
    dt = dtype or split.scale.dtype
    digits = sm_decode(split.digits) if split.signmag else split.digits
    d = digits.to(dt)
    if split.axis == 0:
        return torch.sum(d * split.scale[..., :, None], dim=0)
    return torch.sum(d * split.scale[..., None, :], dim=0)


def residual(split: Split, a: torch.Tensor) -> torch.Tensor:
    """Truncation error V_k = A - sum_s A_s (== W_k for axis=1), in ``a``'s
    dtype.  The slices are summed in f64 (the reference's x64 mode):
    summing round-to-nearest slices in f32 would round away the very
    residual being measured."""
    wide = torch.float64
    return ftz(ftz(a.to(wide) - reconstruct(split, wide)).to(a.dtype))
