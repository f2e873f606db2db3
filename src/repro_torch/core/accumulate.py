"""Slice-product evaluation + accumulation for the Ozaki scheme — PyTorch
port of ``repro.core.accumulate``.

Two evaluation strategies from the paper, plus the Ozaki-II
constant-scaling path:

  * ``matmul_naive``    — Alg. 4: one INT8 GEMM per slice pair (s, t) with
    s+t <= k+1, each converted to high precision, scaled, and added.
  * ``matmul_group_ef`` — Alg. 6/7 (proposed): all pairs on an anti-diagonal
    group g = s+t share the exponent 2^(-beta*g), so they are summed inside
    the integer accumulator (chunks of at most r pairs, eq. 12), then
    converted, scaled and added once per chunk.
  * ``matmul_oz2``      — on the shared-grid splits of ``split_oz2*``
    every pair of group g carries one SCALAR scale, so consecutive groups
    also fold into one integer word by exact shifts (the exponent ladder)
    before a single convert+scale+add per window; the fast2 splits add an
    exact two-sided power-of-two unscale at the end.

High-precision accumulator modes: ``f64`` (paper-faithful; native on
Hopper), ``f32`` and ``df32`` (two-float compensated accumulation, kept for
parity with the reference).

Every INT8 product is one call of :func:`slice_group_gemm`, which hands the
digit stacks to :func:`repro_torch.kernels.group_gemm.group_gemm`: on a
CUDA tensor that is the hand-written kernel (CUDA has no int32 matmul), on a
CPU tensor its plain version.  ``torch.mm`` on int8 CPU tensors would return
int8 and wrap, so nothing here calls it.  Sign-magnitude digits are
multiplied as stored, the trailing slices as unsigned bytes; no widened
copy is made.

Hooks, as in the reference: ``group_gemm_fn(pairs)``, ``pair_gemm_fn(s, t)``
and ``scale_accum_fn(prod, srow, scol, acc)`` replace the int8 products and
the convert+scale+add epilogue (the ``:fused`` pipeline substitutes the
kernels of ``repro_torch.kernels.ops``); ``matmul_oz2`` takes
``scale_accum_fn(word, scale, acc)`` and ``unscale_fn(acc, ra, rb)``
instead, and both take ``epilogue_fn`` for their df32 accumulator: the
whole epilogue of a contraction in one call (defaults
:func:`df32_epilogue` and :func:`oz2_df32_epilogue`; the reference has no
such hook, its per-chunk and per-window epilogues run inside one jitted
program).  ``partial=True`` returns the unrounded accumulator.  The mesh ``product_reduce`` hook comes
with the distributed slice of the port.

Subnormals are flushed as the reference's XLA arithmetic flushes them
(``splitting.ftz``): every epilogue reads subnormal scales and
accumulators as zero and flushes each product, sum and narrowing
conversion that can fall below the normal range, so products near the
bottom of the exponent range round as the reference's do, on either
device.  A scale made by multiplying powers of two is handed over
unflushed where its consumer flushes it on the way in (the kernels and
their plain versions do).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.splitting import (Split, _geo_exps, compute_r, ftz,
                                        sm_decode_slice)
from repro_torch.kernels import group_gemm as _gg

__all__ = [
    "matmul_naive",
    "matmul_group_ef",
    "df32_epilogue",
    "matmul_oz2",
    "oz2_df32_epilogue",
    "num_highprec_adds",
    "oz2_groups",
    "oz2_num_pairs",
    "oz2_num_highprec_adds",
    "oz2_num_chunks",
    "ladder_width",
    "slice_group_gemm",
    "gemm_slice",
    "DF32",
    "df32_add",
    "int32_to_df32",
]

_ACC_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def slice_group_gemm(sa: Split, sb: Split,
                     pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """sum over 1-indexed slice pairs (s, t) of A_s @ B_t in int32,
    ``(*batch, m, p)``: one group GEMM that reads the slices in place from
    the digit stacks (Alg. 6's INT32 group sum; one pair is Alg. 4's INT8
    GEMM).  Sign-magnitude digits go in as stored, slices 2..k marked
    unsigned."""
    return _gg.group_gemm(sa.digits, sb.digits, [s - 1 for s, _ in pairs],
                          [t - 1 for _, t in pairs],
                          a_unsigned=[sa.signmag and s > 1 for s, _ in pairs],
                          b_unsigned=[sb.signmag and t > 1 for _, t in pairs])


def gemm_slice(sp: Split, i: int) -> torch.Tensor:
    """Slice ``i`` (0-indexed) of a split as the values it holds: signed
    digits as stored (int8), sign-magnitude digits widened to int16 (slice
    0 signed, the others un-wrapped to [0, 2^beta - 1]).  The group GEMM
    reads stored slices in place; this is the reference's per-slice view
    for callers that multiply one slice at a time."""
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
        hi, lo = self.hi.to(dtype), self.lo.to(dtype)
        if dtype == torch.float64:   # two f32 values: exact, never subnormal
            return hi + lo
        if dtype != torch.float32:   # narrowing
            hi, lo = ftz(hi), ftz(lo)
        return ftz(hi + lo)


def _two_sum(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: a + b = s + e exactly (each operation flushed)."""
    s = ftz(a + b)
    bb = ftz(s - a)
    e = ftz(ftz(a - ftz(s - bb)) + ftz(b - bb))
    return s, e


def df32_zero(shape, device) -> DF32:
    """A fresh zero accumulator.  ``hi`` and ``lo`` are separate buffers:
    the fused epilogue updates them in place."""
    return DF32(torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def df32_add(c: DF32, x: torch.Tensor) -> DF32:
    """c += x (f32) with compensated two-float accumulation, each
    operation flushed."""
    hi, e = _two_sum(c.hi, x)
    lo = ftz(c.lo + e)
    hi2, e2 = _two_sum(hi, lo)
    return DF32(hi2, e2)


def df32_add_df(c: DF32, x: DF32) -> DF32:
    hi, e = _two_sum(c.hi, x.hi)
    lo = ftz(ftz(c.lo + e) + x.lo)
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
    multiply order ``(p * sa) * sb`` (scales read as zero if subnormal)."""
    return ftz(ftz(p * ftz(sa)[..., :, None]) * ftz(sb)[..., None, :])


def _narrow(c: torch.Tensor, dtype) -> torch.Tensor:
    """``c.to(dtype)``, flushing what a narrowing conversion leaves
    subnormal (XLA's convert flushes)."""
    out = c.to(dtype)
    return out if out.dtype == c.dtype or dtype == torch.float64 else \
        ftz(out)


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
    return ftz(acc + _outer_scale(prod.to(acc.dtype), srow, scol))


def num_highprec_adds(k: int, r: int, group_ef: bool) -> int:
    """Number of high-precision matrix additions (paper's accounting)."""
    if not group_ef:
        return k * (k + 1) // 2
    total = 0
    for g in range(2, k + 2):
        total += -(-(g - 1) // r)  # ceil((g-1)/r) chunks for group g
    return total


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
        lambda s, t: slice_group_gemm(sa, sb, [(s, t)]))
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
    return c if partial else _narrow(c, out_dtype)


# ---------------------------------------------------------------------------
# Alg. 6/7 — group-wise error-free accumulation
# ---------------------------------------------------------------------------

def _group_rows(base_a: torch.Tensor, beta: int, gmax: int) -> torch.Tensor:
    """The row scales ``base_a * 2^(-beta*g)`` of groups g = 1..gmax in one
    multiply, ``(gmax, *batch, m)`` (row g-1 for group g); exact powers of
    two, left for the epilogue to flush."""
    exps = _geo_exps(beta, gmax, base_a.dtype, base_a.device)
    return base_a[None] * exps.reshape((gmax,) + (1,) * base_a.ndim)


def df32_epilogue(prods, groups, base_a: torch.Tensor, base_b: torch.Tensor,
                  beta: int, *, partial: bool = False,
                  out_dtype=torch.float32) -> Union[torch.Tensor, DF32]:
    """The df32 epilogue of a group-EF contraction: from a zero accumulator,
    one compensated step per chunk product ``prods[i]`` of group
    ``groups[i]`` (row scale ``base_a * 2^(-beta*g)``, column scale
    ``base_b``), then the conversion to ``out_dtype`` unless ``partial``.
    The default of ``matmul_group_ef``'s ``epilogue_fn`` hook."""
    acc = df32_zero(prods[0].shape, prods[0].device)
    srows = _group_rows(base_a, beta, max(groups))
    for g, prod in zip(groups, prods):
        acc = _scale_accum_df32(prod, srows[g - 1], base_b, acc)
    return acc if partial else acc.to_float(out_dtype)


def _group_chunks(k: int, r: int):
    """Yield (g, [(s, t), ...]) chunks of size <= r per anti-diagonal group."""
    for g in range(2, k + 2):
        pairs = [(s, g - s) for s in range(1, g)]
        for i in range(0, len(pairs), r):
            yield g, pairs[i:i + r]


def matmul_group_ef(sa: Split, sb: Split, *, accum: str = "f64",
                    out_dtype=None, r: Optional[int] = None,
                    group_gemm_fn=None, partial: bool = False,
                    scale_accum_fn: Optional[Callable] = None,
                    epilogue_fn: Optional[Callable] = None
                    ) -> Union[torch.Tensor, DF32]:
    """Group-wise error-free accumulation (Alg. 6; Alg. 7 when r >= k).
    Needs geometric slice scales: every pair of group g carries
    ``baseA (x) baseB * 2^(-beta*g)``.  The df32 accumulator runs its
    whole epilogue through ``epilogue_fn`` (:func:`df32_epilogue`'s
    signature and result; the ``:fused`` pipeline's one-launch kernel), the
    f32/f64 ones one ``scale_accum_fn`` step per chunk."""
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
    gg = group_gemm_fn or (lambda pairs: slice_group_gemm(sa, sb, pairs))
    chunks = list(_group_chunks(k, r))
    prods = [gg(pairs) for _, pairs in chunks]

    # The 2^(-beta*g) group exponent folds into the row scale (exact).
    if accum == "df32":
        return (epilogue_fn or df32_epilogue)(
            prods, [g for g, _ in chunks], sa.base.to(torch.float32),
            sb.base.to(torch.float32), beta, partial=partial,
            out_dtype=out_dtype)

    acc_dtype = _ACC_DTYPES[accum]
    fn = scale_accum_fn or _scale_accum_plain
    c = torch.zeros(out_shape, dtype=acc_dtype, device=device)
    srows = _group_rows(sa.base.to(acc_dtype), beta, k + 1)
    base_b = sb.base.to(acc_dtype)
    for (g, _), prod in zip(chunks, prods):
        c = fn(prod, srows[g - 1], base_b, c)
    return c if partial else _narrow(c, out_dtype)


# ---------------------------------------------------------------------------
# Ozaki-II — constant scaling + exponent-ladder accumulation
# ---------------------------------------------------------------------------

def _clog2(x: int) -> int:
    return max(0, (int(x) - 1).bit_length())


def oz2_groups(k: int, fast):
    """Anti-diagonal groups g = s + t the oz2 modes evaluate: all of
    g = 2..2k in full mode, the band g <= k + 1 when ``fast`` is truthy
    (``True`` or ``"fast2"``)."""
    return range(2, (k + 1 if fast else 2 * k) + 1)


def _oz2_group_pairs(k: int, g: int):
    return [(s, g - s) for s in range(max(1, g - k), min(k, g - 1) + 1)]


def oz2_num_pairs(k: int, fast: bool) -> int:
    """INT8 slice-pair GEMM count: k(k+1)/2 (fast band) or k^2 (full)."""
    return k * (k + 1) // 2 if fast else k * k


def _oz2_chunks(k: int, r: int, fast: bool):
    """Yield (g, [(s, t), ...]) chunks of size <= r, ascending g."""
    for g in oz2_groups(k, fast):
        pairs = _oz2_group_pairs(k, g)
        for i in range(0, len(pairs), r):
            yield g, pairs[i:i + r]


def ladder_width(n: int, k: int, beta: int, digit_bits: int,
                 word_bits: int) -> int:
    """How many consecutive groups fold into ONE integer word: group g's
    sum carries 2^(-beta*g), so c groups combine exactly as
    ``sum_j S_(g+j) << (beta * (c - 1 - j))`` within ``word_bits`` (52 for
    the int64 word of the f64 accumulator, 31 for int32)."""
    head = 1 + _clog2(k) + _clog2(n) + 2 * digit_bits
    return 1 + max(0, (word_bits - head) // beta)


def _ladder_windows(groups: Sequence[int], c: int):
    """Pack the chunks of ascending groups ``groups`` into windows spanning
    <= c groups: lists of (chunk index, g)."""
    windows = []
    for idx, g in enumerate(groups):
        if windows and g - windows[-1][0][1] < c:
            windows[-1].append((idx, g))
        else:
            windows.append([(idx, g)])
    return windows


def oz2_num_highprec_adds(k: int, r: int, beta: int, n: int, fast: bool,
                          digit_bits: int, word_bits: int = 52) -> int:
    """High-precision adds of the oz2 path = number of ladder windows."""
    groups = [g for g, _ in _oz2_chunks(k, r, fast)]
    return len(_ladder_windows(groups, ladder_width(n, k, beta, digit_bits,
                                                    word_bits)))


def oz2_num_chunks(k: int, r: int, fast: bool) -> int:
    """INT32 group-GEMM outputs the ladder folds."""
    return sum(1 for _ in _oz2_chunks(k, r, fast))


@functools.lru_cache(maxsize=None)
def _oz2_exps(beta: int, gs: Tuple[int, ...], dtype: torch.dtype,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves ``2^(-beta*(g//2))`` and ``2^(-beta*(g - g//2))`` of
    each group exponent in ``gs``, on ``device`` once per key, each flushed
    as the operand of a multiply (a half below the normal range of
    ``dtype`` reads as zero)."""
    ea = [2.0 ** (-beta * (g // 2)) for g in gs]
    eb = [2.0 ** (-beta * (g - g // 2)) for g in gs]
    return (ftz(torch.tensor(ea, dtype=dtype, device=device)),
            ftz(torch.tensor(eb, dtype=dtype, device=device)))


def _oz2_scales(gbase_a: torch.Tensor, gbase_b: torch.Tensor, beta: int,
                gs: Sequence[int], dtype) -> torch.Tensor:
    """``(len(gs), *batch)`` scalar scales ``gbaseA * gbaseB * 2^(-beta*g)``
    of the ladder windows topped by the groups ``gs``, the group exponent
    split over the two bases (in the reference's order) so that neither
    factor underflows on its own; every factor is a power of two.  The
    reference's ``_oz2_scale`` exactly: ``ftz(ftz(gbaseA * ftz(ea)) *
    ftz(gbaseB * ftz(eb)))``, each half read as zero where it is
    subnormal, each product flushed."""
    ea, eb = _oz2_exps(beta, tuple(gs), dtype, gbase_a.device)
    shape = (len(gs),) + (1,) * gbase_a.ndim
    return ftz(ftz(gbase_a.to(dtype)[None] * ea.reshape(shape)) *
               ftz(gbase_b.to(dtype)[None] * eb.reshape(shape)))


def _oz2_fold(prods, window, beta: int, word_dtype) -> torch.Tensor:
    """One ladder window's integer word: the chunk products of its groups
    shifted onto the top group's exponent, ``sum prod << beta*(g_hi -
    g)`` (exact within the ladder's word budget)."""
    g_hi = window[-1][1]
    word = None
    for idx, g in window:
        t = prods[idx].to(word_dtype)
        if g_hi != g:
            t = torch.bitwise_left_shift(t, beta * (g_hi - g))
        word = t if word is None else word + t
    return word


def _oz2_ratios(base_a: torch.Tensor, base_b: torch.Tensor,
                gbase_a: torch.Tensor, gbase_b: torch.Tensor):
    """The fast2 unscale factors ``base / gbase`` of both sides, in the
    reference's operations (a reciprocal, then a multiply; powers of
    two)."""
    return (base_a * (1.0 / gbase_a[..., None]),
            base_b * (1.0 / gbase_b[..., None]))


def _oz2_accum_df32(word: torch.Tensor, scale: torch.Tensor,
                    acc: DF32) -> DF32:
    """One ladder-window df32 step: ``acc += scale * float(word)`` with the
    exact low-8-bit int32 split."""
    term = int32_to_df32(word)
    s = ftz(scale)[..., None, None]
    return df32_add_df(acc, DF32(ftz(term.hi * s), ftz(term.lo * s)))


def _oz2_accum_plain(word: torch.Tensor, scale: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """One ladder-window plain step in ``acc.dtype`` (f64: the int64 word
    converts exactly by the 52-bit word budget)."""
    return ftz(acc + ftz(word.to(acc.dtype) * ftz(scale)[..., None, None]))


def _oz2_unscale(acc, ra: torch.Tensor, rb: torch.Tensor):
    """The fast2 epilogue ``C = diag(ra) C_hat diag(rb)``; both limbs of a
    df32 accumulator scale by the same powers of two (exact)."""
    if isinstance(acc, DF32):
        ra32 = ra.to(torch.float32)
        rb32 = rb.to(torch.float32)
        return DF32(_outer_scale(acc.hi, ra32, rb32),
                    _outer_scale(acc.lo, ra32, rb32))
    return _outer_scale(acc, ra.to(acc.dtype), rb.to(acc.dtype))


def oz2_df32_epilogue(prods, groups: Sequence[int], c: int, beta: int,
                      gbase_a: torch.Tensor, gbase_b: torch.Tensor,
                      base_a: Optional[torch.Tensor] = None,
                      base_b: Optional[torch.Tensor] = None, *,
                      partial: bool = False,
                      out_dtype=torch.float32) -> Union[torch.Tensor, DF32]:
    """The df32 epilogue of an Ozaki-II contraction: the int32 chunk
    products ``prods`` of ascending groups ``groups`` fold into ladder
    windows of <= ``c`` groups; from a zero accumulator, one compensated
    step per window with its scalar scale (``gbase_a (*batch,)``,
    ``gbase_b (*batch,)``, ``beta``); with the fast2 bases ``base_a
    (*batch, m)`` and ``base_b (*batch, p)``, the exact unscale by ``base /
    gbase``; then the conversion to ``out_dtype`` unless ``partial``.  The
    default of ``matmul_oz2``'s ``epilogue_fn`` hook."""
    acc = df32_zero(prods[0].shape, prods[0].device)
    windows = _ladder_windows(groups, c)
    scales = _oz2_scales(gbase_a, gbase_b, beta,
                         [window[-1][1] for window in windows],
                         torch.float32)
    for i, window in enumerate(windows):
        acc = _oz2_accum_df32(_oz2_fold(prods, window, beta, torch.int32),
                              scales[i], acc)
    if base_a is not None:
        acc = _oz2_unscale(acc, *_oz2_ratios(base_a, base_b, gbase_a,
                                             gbase_b))
    return acc if partial else acc.to_float(out_dtype)


def matmul_oz2(sa: Split, sb: Split, *, accum: str = "f64",
               out_dtype=None, fast: Union[bool, str] = False,
               r: Optional[int] = None, n_total: Optional[int] = None,
               digit_bits: Optional[int] = None, group_gemm_fn=None,
               partial: bool = False,
               scale_accum_fn: Optional[Callable] = None,
               unscale_fn: Optional[Callable] = None,
               epilogue_fn: Optional[Callable] = None
               ) -> Union[torch.Tensor, DF32]:
    """Ozaki-II evaluation on constant-scaling splits (``Split.gbase``).

    Groups are summed in the int32 group GEMM (chunks of <= r pairs), then
    consecutive groups fold into one integer word by exact shifts (int64
    for the f64 accumulator, int32 otherwise) before ONE convert+scale+add
    per ladder window.  ``fast`` selects the g <= k+1 band; ``"fast2"``
    also applies the exact unscale by ``base / gbase`` at the end.  The
    df32 accumulator runs its whole epilogue (fold, windows, unscale,
    conversion) through ``epilogue_fn`` (:func:`oz2_df32_epilogue`'s
    signature and result; the ``:fused`` pipeline's one-launch kernel).
    The f32/f64 ones fold in plain integer PyTorch, as the reference's
    fold is jnp outside any kernel, with the hooks
    ``scale_accum_fn(word, scale, acc)`` per window and ``unscale_fn(acc,
    ra, rb)`` (the ``:fused`` kernels)."""
    assert sa.axis == 0 and sb.axis == 1
    if sa.gbase is None or sb.gbase is None:
        raise ValueError("oz2 accumulation needs constant-scaling splits "
                         "(split_oz2 / split_oz2_bitmask); got per-row "
                         "scales")
    fast2 = fast == "fast2"
    if fast2 and (sa.base is None or sb.base is None):
        raise ValueError("fast2 needs the per-row bases of the fast2 "
                         "splits (split_oz2_fast2 / "
                         "split_oz2_bitmask_fast2)")
    k = sa.digits.shape[0]
    assert sb.digits.shape[0] == k
    beta = sa.beta
    n = n_total if n_total is not None else sa.digits.shape[-1]
    out_shape = _out_shape(sa, sb)
    out_dtype = out_dtype or sa.scale.dtype
    device = sa.digits.device
    if digit_bits is None:
        digit_bits = beta  # conservative: truncation digits span ±(2^beta-1)
    if r is None:
        r = compute_r(n, beta, digit_bits)
    use_i64 = accum == "f64"
    word_dtype = torch.int64 if use_i64 else torch.int32
    c = ladder_width(n, k, beta, digit_bits, 52 if use_i64 else 31)

    gg = group_gemm_fn or (lambda pairs: slice_group_gemm(sa, sb, pairs))
    chunks = list(_oz2_chunks(k, r, fast))
    prods = [gg(pairs) for _, pairs in chunks]
    groups = [g for g, _ in chunks]

    if accum == "df32":
        return (epilogue_fn or oz2_df32_epilogue)(
            prods, groups, c, beta, sa.gbase, sb.gbase,
            sa.base if fast2 else None, sb.base if fast2 else None,
            partial=partial, out_dtype=out_dtype)

    windows = _ladder_windows(groups, c)
    acc_dtype = _ACC_DTYPES[accum]
    fn = scale_accum_fn or _oz2_accum_plain
    acc = torch.zeros(out_shape, dtype=acc_dtype, device=device)
    scales = _oz2_scales(sa.gbase, sb.gbase, beta,
                         [window[-1][1] for window in windows], acc_dtype)
    for i, window in enumerate(windows):
        acc = fn(_oz2_fold(prods, window, beta, word_dtype), scales[i], acc)
    if fast2:
        acc = (unscale_fn or _oz2_unscale)(
            acc, *_oz2_ratios(sa.base, sb.base, sa.gbase, sb.gbase))
    return acc if partial else _narrow(acc, out_dtype)
