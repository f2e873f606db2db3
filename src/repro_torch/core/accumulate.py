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
instead.  ``partial=True`` returns the unrounded accumulator.  The mesh
``product_reduce`` hook comes with the distributed slice of the port.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.splitting import Split, compute_r
from repro_torch.kernels import group_gemm as _gg

__all__ = [
    "matmul_naive",
    "matmul_group_ef",
    "matmul_oz2",
    "num_highprec_adds",
    "oz2_groups",
    "oz2_num_pairs",
    "oz2_num_highprec_adds",
    "oz2_num_chunks",
    "ladder_width",
    "slice_group_gemm",
    "DF32",
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
    gg = group_gemm_fn or (lambda pairs: slice_group_gemm(sa, sb, pairs))
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


def _ladder_windows(chunks, c: int):
    """Pack the ascending-g chunk list into windows spanning <= c groups."""
    windows = []
    for idx, (g, _) in enumerate(chunks):
        if windows and g - windows[-1][0][1] < c:
            windows[-1].append((idx, g))
        else:
            windows.append([(idx, g)])
    return windows


def oz2_num_highprec_adds(k: int, r: int, beta: int, n: int, fast: bool,
                          digit_bits: int, word_bits: int = 52) -> int:
    """High-precision adds of the oz2 path = number of ladder windows."""
    chunks = list(_oz2_chunks(k, r, fast))
    return len(_ladder_windows(chunks, ladder_width(n, k, beta, digit_bits,
                                                    word_bits)))


def oz2_num_chunks(k: int, r: int, fast: bool) -> int:
    """INT32 group-GEMM outputs the ladder folds."""
    return sum(1 for _ in _oz2_chunks(k, r, fast))


def _oz2_scale(gbase_a: torch.Tensor, gbase_b: torch.Tensor, beta: int,
               g: int, dtype) -> torch.Tensor:
    """(*batch,) scalar scale ``gbaseA * gbaseB * 2^(-beta*g)``, the group
    exponent split over the two bases (in the reference's order) so that
    neither factor underflows on its own; every factor is a power of two."""
    ea = 2.0 ** (-beta * (g // 2))
    eb = 2.0 ** (-beta * (g - g // 2))
    return (gbase_a.to(dtype) * ea) * (gbase_b.to(dtype) * eb)


def _oz2_accum_df32(word: torch.Tensor, scale: torch.Tensor,
                    acc: DF32) -> DF32:
    """One ladder-window df32 step: ``acc += scale * float(word)`` with the
    exact low-8-bit int32 split."""
    term = int32_to_df32(word)
    s = scale[..., None, None]
    return df32_add_df(acc, DF32(term.hi * s, term.lo * s))


def _oz2_accum_plain(word: torch.Tensor, scale: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """One ladder-window plain step in ``acc.dtype`` (f64: the int64 word
    converts exactly by the 52-bit word budget)."""
    return acc + word.to(acc.dtype) * scale[..., None, None]


def _oz2_unscale(acc, ra: torch.Tensor, rb: torch.Tensor):
    """The fast2 epilogue ``C = diag(ra) C_hat diag(rb)``; both limbs of a
    df32 accumulator scale by the same powers of two (exact)."""
    if isinstance(acc, DF32):
        ra32 = ra.to(torch.float32)
        rb32 = rb.to(torch.float32)
        return DF32(_outer_scale(acc.hi, ra32, rb32),
                    _outer_scale(acc.lo, ra32, rb32))
    return _outer_scale(acc, ra.to(acc.dtype), rb.to(acc.dtype))


def matmul_oz2(sa: Split, sb: Split, *, accum: str = "f64",
               out_dtype=None, fast: Union[bool, str] = False,
               r: Optional[int] = None, n_total: Optional[int] = None,
               digit_bits: Optional[int] = None, group_gemm_fn=None,
               partial: bool = False,
               scale_accum_fn: Optional[Callable] = None,
               unscale_fn: Optional[Callable] = None
               ) -> Union[torch.Tensor, DF32]:
    """Ozaki-II evaluation on constant-scaling splits (``Split.gbase``).

    Groups are summed in the int32 group GEMM (chunks of <= r pairs), then
    consecutive groups fold into one integer word by exact shifts (int64
    for the f64 accumulator, int32 otherwise) before ONE convert+scale+add
    per ladder window.  ``fast`` selects the g <= k+1 band; ``"fast2"``
    also applies the exact unscale by ``base / gbase`` at the end.  The
    fold itself is plain integer PyTorch, as the reference's is jnp
    outside any kernel.  Hooks: ``scale_accum_fn(word, scale, acc)`` and
    ``unscale_fn(acc, ra, rb)`` (the ``:fused`` kernels)."""
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
    windows = _ladder_windows(chunks, c)

    def fold(window):
        g_hi = window[-1][1]
        word = None
        for idx, g in window:
            t = prods[idx].to(word_dtype)
            if g_hi != g:
                t = torch.bitwise_left_shift(t, beta * (g_hi - g))
            word = t if word is None else word + t
        return word, g_hi

    def unscale(acc):
        if not fast2:
            return acc
        ra = sa.base * (1.0 / sa.gbase[..., None])
        rb = sb.base * (1.0 / sb.gbase[..., None])
        return (unscale_fn or _oz2_unscale)(acc, ra, rb)

    if accum == "df32":
        fn = scale_accum_fn or _oz2_accum_df32
        acc = df32_zero(out_shape, device)
        for window in windows:
            word, g_hi = fold(window)
            acc = fn(word, _oz2_scale(sa.gbase, sb.gbase, beta, g_hi,
                                      torch.float32), acc)
        acc = unscale(acc)
        return acc if partial else acc.to_float(out_dtype)

    acc_dtype = _ACC_DTYPES[accum]
    fn = scale_accum_fn or _oz2_accum_plain
    acc = torch.zeros(out_shape, dtype=acc_dtype, device=device)
    for window in windows:
        word, g_hi = fold(window)
        acc = fn(word, _oz2_scale(sa.gbase, sb.gbase, beta, g_hi,
                                  acc_dtype), acc)
    acc = unscale(acc)
    return acc if partial else acc.to(out_dtype)
