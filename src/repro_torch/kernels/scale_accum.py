"""Fused convert + scale + add epilogue (step iv): the CUDA kernels of
``csrc/scale_accum.cu`` and their plain PyTorch versions.

Replaces five TPU kernels of ``repro/kernels/scale_accum.py``:

  * ``scale_accum`` (body ``_scale_accum_kernel``) — the df32 accumulator
    ``(hi, lo) += srow * float(P32) * scol``: exact low-8-bit int32 split,
    TwoSum, full TwoSum renormalisation, in the order of
    ``accumulate._scale_accum_df32``.  :func:`scale_accum_chunks` runs the
    whole df32 epilogue of a group-EF contraction in one launch (every
    chunk product from a zero accumulator, the group row scales formed in
    the kernel, the result written once); :func:`scale_accum` is its
    one-chunk case with the accumulator read in;
  * ``scale_accum_plain`` (body ``_scale_accum_plain_kernel``) — the plain
    accumulator ``c += float(P32) * srow * scol`` in c's dtype (f32 or
    f64; the f64 form runs natively on Hopper);
  * ``scale_accum_const`` (body ``_scale_accum_const_kernel``) — the
    Ozaki-II ladder window in df32, ``(hi, lo) += s * float(word)`` with
    one scalar per batch element (``accumulate._oz2_accum_df32``).
    :func:`scale_accum_const_windows` runs the whole Ozaki-II df32
    epilogue of a contraction in one launch (``accumulate.
    oz2_df32_epilogue``: the ladder fold of the chunk products, every
    window's scale formed in the kernel and its compensated step, the
    fast2 unscale, the result written once); :func:`scale_accum_const` is
    the single window with the word, the scale and the accumulator read
    in;
  * ``scale_accum_const_plain`` (body ``_scale_accum_const_plain_kernel``)
    — ``c += float(word) * s``; the word is int32, or int64 for the f64
    ladder (exact: the ladder keeps it within 52 bits);
  * ``unscale`` (body ``_unscale_kernel``) — ``out = x * srow * scol``,
    the exact fast2 power-of-two unscale (``accumulate._oz2_unscale``) of
    the plain f32/f64 accumulators.

Operands: ``p32``/``word``/``x`` ``(*batch, m, p)``, ``srow (*batch, m)``,
``scol (*batch, p)``, the const kernels' scalar ``s (*batch,)`` (a device
tensor, read by the kernel: no host sync).  The CUDA accumulate paths
update the accumulators IN PLACE and return them; callers pass only
buffers they own (the accumulate routines allocate theirs per
contraction).  ``unscale`` and the plain versions return new tensors.

Subnormals: every float operand is read as zero if subnormal and every
multiply, add and subtract flushes a subnormal result to zero, as the
reference's XLA arithmetic does (``splitting.ftz``); kernels and plain
versions alike.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.accumulate import (_ladder_windows, df32_epilogue,
                                         oz2_df32_epilogue)
from repro_torch.core.splitting import ftz
from repro_torch.kernels import LAUNCHES, _build

__all__ = ["scale_accum", "scale_accum_ref", "scale_accum_chunks",
           "scale_accum_chunks_ref", "MAX_CHUNKS", "scale_accum_plain",
           "scale_accum_plain_ref", "scale_accum_const",
           "scale_accum_const_ref", "scale_accum_const_windows",
           "scale_accum_const_windows_ref", "MAX_WORDS",
           "scale_accum_const_plain",
           "scale_accum_const_plain_ref", "unscale", "unscale_ref"]

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS_DF32 = [_p, _p, _p, _p, _p, _ll, _ll, _ll, _p]
_ARGS_PLAIN = [_p, _p, _p, _p, _ll, _ll, _ll, _i, _p]
_ARGS_CONST_DF32 = [_p, _p, _p, _p, _ll, _ll, _ll, _p]
_ARGS_CONST_PLAIN = [_p, _p, _p, _ll, _ll, _ll, _i, _i, _p]
_ARGS_UNSCALE = [_p, _p, _p, _p, _ll, _ll, _ll, _i, _p]
_ARGS_CHUNKS = [_p, _p, _i, _i, _p, _p, _p, _p, _p, _p, _i, _ll, _ll, _ll,
                _p]
_ARGS_WINDOWS = [_p, _p, _p, _i, _i, _p, _p, _p, _p, _i, _p, _p, _p, _p, _i,
                 _ll, _ll, _ll, _p]

MAX_CHUNKS = 16   # chunk products one launch takes (by value)
MAX_WORDS = 32    # chunk products one ladder launch takes (whole windows)


def _two_sum(a, b):
    s = ftz(a + b)
    bb = ftz(s - a)
    e = ftz(ftz(a - ftz(s - bb)) + ftz(b - bb))
    return s, e


def scale_accum_ref(p32, srow, scol, c_hi, c_lo
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the df32 epilogue: the exact
    ``accumulate._scale_accum_df32`` operation sequence."""
    p_hi = (p32 >> 8) << 8
    p_lo = p32 - p_hi
    sr, sc = ftz(srow)[..., :, None], ftz(scol)[..., None, :]
    x_hi = ftz(ftz(p_hi.to(torch.float32) * sr) * sc)
    x_lo = ftz(ftz(p_lo.to(torch.float32) * sr) * sc)
    hi, err = _two_sum(ftz(c_hi), x_hi)
    lo = ftz(ftz(ftz(c_lo) + err) + x_lo)
    return _two_sum(hi, lo)


def scale_accum_plain_ref(p32, srow, scol, c) -> torch.Tensor:
    """Plain version of the plain-accumulator epilogue, in c's dtype."""
    x = ftz(ftz(p32.to(c.dtype) * ftz(srow)[..., :, None]) *
            ftz(scol)[..., None, :])
    return ftz(ftz(c) + x)


def _launch_args(p32, srow, scol, accs, dtype, kernel):
    _build.require_cuda(p32, kernel)
    if p32.dtype != torch.int32:
        raise TypeError(f"{kernel}: p32 must be int32, got {p32.dtype}")
    batch, (m, p) = tuple(p32.shape[:-2]), tuple(p32.shape[-2:])
    for name, t, shape in (("srow", srow, batch + (m,)),
                           ("scol", scol, batch + (p,))):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (srow, scol) + tuple(accs):
        if t.device != p32.device:
            raise ValueError(f"{kernel}: operands live on {t.device} and "
                             f"{p32.device}")
    for t in accs:
        if tuple(t.shape) != tuple(p32.shape) or t.dtype != dtype:
            raise ValueError(f"{kernel}: accumulator must be "
                             f"{tuple(p32.shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} updates its accumulator in place; "
                             f"it must be contiguous")
    return (p32.contiguous().data_ptr(), srow.contiguous().data_ptr(),
            scol.contiguous().data_ptr(), math.prod(batch), m, p)


def scale_accum(p32, srow, scol, c_hi, c_lo
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """df32 epilogue ``(c_hi, c_lo) += srow * float(p32) * scol``; on CUDA
    in place (returns the same tensors)."""
    if p32.device.type == "cpu":
        return scale_accum_ref(p32, srow, scol, c_hi, c_lo)
    # keep the contiguous copies alive across the launch
    p32, srow, scol = p32.contiguous(), srow.contiguous(), scol.contiguous()
    pp, ps, pc, B, m, p = _launch_args(p32, srow, scol, (c_hi, c_lo),
                                       torch.float32, "scale_accum")
    fn = _build.function("scale_accum", "scale_accum_df32", _ARGS_DF32)
    LAUNCHES["scale_accum"] += 1
    _build.check(fn(pp, ps, pc, c_hi.data_ptr(), c_lo.data_ptr(), B, m, p,
                    _build.stream(p32)), "scale_accum")
    return c_hi, c_lo


def scale_accum_chunks_ref(prods, groups, base_a, base_b, beta: int, *,
                           partial: bool = False):
    """Plain version of :func:`scale_accum_chunks`: the CPU's df32
    epilogue ``accumulate.df32_epilogue`` (from a zero (hi, lo), one
    compensated step per chunk with its group's row scale, then
    ``ftz(hi + lo)``), ``(hi, lo)`` with ``partial``."""
    out = df32_epilogue(prods, groups, base_a, base_b, beta,
                        partial=partial)
    return tuple(out) if partial else out


def scale_accum_chunks(prods, groups, base_a, base_b, beta: int, *,
                       partial: bool = False):
    """The whole df32 epilogue of a group-EF contraction: chunk products
    ``prods`` (each ``(*batch, m, p)`` int32) of groups ``groups`` (g >= 1:
    the pairs of group g carry ``2^(-beta g)``), ``base_a (*batch, m)``,
    ``base_b (*batch, p)`` f32.  Returns f32 ``ftz(hi + lo)``, or ``(hi,
    lo)`` with ``partial``.  On CUDA one launch per :data:`MAX_CHUNKS`
    chunks (successive launches carry (hi, lo) through memory)."""
    if len(prods) != len(groups) or not prods:
        raise ValueError(f"need one group per chunk product, got "
                         f"{len(prods)} products and {len(groups)} groups")
    if min(groups) < 1:
        raise ValueError(f"groups start at 1, got {list(groups)}")
    if base_a.device.type == "cpu":
        return scale_accum_chunks_ref(prods, groups, base_a, base_b, beta,
                                      partial=partial)
    _build.require_cuda(base_a, "scale_accum")
    shape = tuple(prods[0].shape)
    # keep the contiguous copies alive across the launches
    prods = [p.contiguous() for p in prods]
    base_a, base_b = base_a.contiguous(), base_b.contiguous()
    _, pa, pb, B, m, p = _launch_args(prods[0], base_a, base_b, (),
                                      torch.float32, "scale_accum")
    for q in prods[1:]:
        if tuple(q.shape) != shape or q.dtype != torch.int32 or \
                q.device != base_a.device:
            raise ValueError(f"scale_accum: chunk products differ: "
                             f"{tuple(q.shape)} {q.dtype} on {q.device} "
                             f"after {shape} int32")
    ptrs = [q.data_ptr() for q in prods]
    dev = base_a.device
    hi = torch.empty(shape, dtype=torch.float32, device=dev)
    many = len(prods) > MAX_CHUNKS
    lo = torch.empty_like(hi) if partial or many else None
    fn = _build.function("scale_accum", "scale_accum_chunks", _ARGS_CHUNKS)
    for i in range(0, len(prods), MAX_CHUNKS):
        part = ptrs[i:i + MAX_CHUNKS]
        last = i + MAX_CHUNKS >= len(prods)
        sum_ = last and not partial
        c_prods = (ctypes.c_void_p * len(part))(*part)
        c_groups = (ctypes.c_int * len(part))(*groups[i:i + MAX_CHUNKS])
        acc_in = (None, None) if i == 0 else (hi.data_ptr(), lo.data_ptr())
        LAUNCHES["scale_accum"] += 1
        _build.check(fn(c_prods, c_groups, len(part), beta, pa, pb, *acc_in,
                        hi.data_ptr(), None if sum_ else lo.data_ptr(),
                        int(sum_), B, m, p, _build.stream(base_a)),
                     "scale_accum")
    return (hi, lo) if partial else hi


def scale_accum_plain(p32, srow, scol, c) -> torch.Tensor:
    """Plain epilogue ``c += float(p32) * srow * scol`` in c's dtype (f32 or
    f64); on CUDA in place (returns the same tensor)."""
    if p32.device.type == "cpu":
        return scale_accum_plain_ref(p32, srow, scol, c)
    if c.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scale_accum_plain accumulates in f32 or f64, got "
                        f"{c.dtype}")
    p32, srow, scol = p32.contiguous(), srow.contiguous(), scol.contiguous()
    pp, ps, pc, B, m, p = _launch_args(p32, srow, scol, (c,), c.dtype,
                                       "scale_accum_plain")
    fn = _build.function("scale_accum", "scale_accum_plain", _ARGS_PLAIN)
    LAUNCHES["scale_accum_plain"] += 1
    _build.check(fn(pp, ps, pc, c.data_ptr(), B, m, p,
                    int(c.dtype == torch.float64), _build.stream(p32)),
                 "scale_accum_plain")
    return c


# ---------------------------------------------------------------------------
# Ozaki-II: one scalar scale per batch element, and the fast2 unscale
# ---------------------------------------------------------------------------

def scale_accum_const_ref(word, s, c_hi, c_lo
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the oz2 df32 window: the exact
    ``accumulate._oz2_accum_df32`` operation sequence."""
    p_hi = (word >> 8) << 8
    p_lo = word - p_hi
    sv = ftz(s)[..., None, None]
    hi, err = _two_sum(ftz(c_hi), ftz(p_hi.to(torch.float32) * sv))
    lo = ftz(ftz(ftz(c_lo) + err) + ftz(p_lo.to(torch.float32) * sv))
    return _two_sum(hi, lo)


def scale_accum_const_plain_ref(word, s, c) -> torch.Tensor:
    """Plain version of the oz2 plain window, in c's dtype."""
    return ftz(ftz(c) + ftz(word.to(c.dtype) * ftz(s)[..., None, None]))


def unscale_ref(x, srow, scol) -> torch.Tensor:
    """Plain version of the fast2 unscale, ``(x * srow) * scol``."""
    return ftz(ftz(ftz(x) * ftz(srow)[..., :, None]) *
               ftz(scol)[..., None, :])


def _check_const(word, s, accs, dtype, word_dtypes, kernel):
    _build.require_cuda(word, kernel)
    if word.dtype not in word_dtypes:
        raise TypeError(f"{kernel}: word must be one of {word_dtypes}, got "
                        f"{word.dtype}")
    batch = tuple(word.shape[:-2])
    if tuple(s.shape) != batch or s.dtype != dtype:
        raise ValueError(f"{kernel}: s must be {batch} {dtype}, got "
                         f"{tuple(s.shape)} {s.dtype}")
    for t in (s,) + tuple(accs):
        if t.device != word.device:
            raise ValueError(f"{kernel}: operands live on {t.device} and "
                             f"{word.device}")
    for t in accs:
        if tuple(t.shape) != tuple(word.shape) or t.dtype != dtype:
            raise ValueError(f"{kernel}: accumulator must be "
                             f"{tuple(word.shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} updates its accumulator in place; "
                             f"it must be contiguous")
    return math.prod(batch), word.shape[-2], word.shape[-1]


def scale_accum_const(word, s, c_hi, c_lo
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """oz2 df32 window ``(c_hi, c_lo) += s * float(word)``, word int32, s
    f32 ``(*batch,)``; on CUDA in place (returns the same tensors)."""
    if word.device.type == "cpu":
        return scale_accum_const_ref(word, s, c_hi, c_lo)
    B, m, p = _check_const(word, s, (c_hi, c_lo), torch.float32,
                           (torch.int32,), "scale_accum_const")
    word, s = word.contiguous(), s.contiguous()
    fn = _build.function("scale_accum", "scale_accum_const_df32",
                         _ARGS_CONST_DF32)
    LAUNCHES["scale_accum_const"] += 1
    _build.check(fn(word.data_ptr(), s.data_ptr(), c_hi.data_ptr(),
                    c_lo.data_ptr(), B, m, p, _build.stream(word)),
                 "scale_accum_const")
    return c_hi, c_lo


def scale_accum_const_windows_ref(prods, groups, c: int, beta: int, gbase_a,
                                  gbase_b, base_a=None, base_b=None, *,
                                  partial: bool = False):
    """Plain version of :func:`scale_accum_const_windows`: the CPU's
    Ozaki-II df32 epilogue ``accumulate.oz2_df32_epilogue`` (the fold, one
    compensated step per ladder window from a zero (hi, lo), the fast2
    unscale, then ``ftz(hi + lo)``), ``(hi, lo)`` with ``partial``."""
    out = oz2_df32_epilogue(prods, groups, c, beta, gbase_a, gbase_b,
                            base_a, base_b, partial=partial)
    return tuple(out) if partial else out


@functools.lru_cache(maxsize=None)
def _window_launches(groups: Tuple[int, ...], c: int, beta: int):
    """The launches of a contraction's ladder windows, whole windows of at
    most :data:`MAX_WORDS` products each: ``(first product, count, shifts,
    tops)``, the last two as the kernel's C arrays (each product's shift
    onto its window's top group; that group at a window's last product,
    else 0)."""
    launches, cur = [], []
    for window in _ladder_windows(groups, c):
        if len(window) > MAX_WORDS:
            raise ValueError(f"scale_accum_const: a ladder window of "
                             f"{len(window)} chunk products; one launch "
                             f"takes at most {MAX_WORDS}")
        if len(cur) + len(window) > MAX_WORDS:
            launches.append(cur)
            cur = []
        g_hi = window[-1][1]
        cur += [(idx, beta * (g_hi - g), g_hi if idx == window[-1][0] else 0)
                for idx, g in window]
    launches.append(cur)
    return tuple((part[0][0], len(part),
                  (ctypes.c_int * len(part))(*[e[1] for e in part]),
                  (ctypes.c_int * len(part))(*[e[2] for e in part]))
                 for part in launches)


def _check_windows(prods, gbase_a, gbase_b, base_a, base_b):
    shape = tuple(prods[0].shape)
    batch, (m, p) = shape[:-2], shape[-2:]
    dev, dtype = gbase_a.device, gbase_a.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scale_accum_const: gbase must be f32 or f64, got "
                        f"{dtype}")
    for q in prods:
        if tuple(q.shape) != shape or q.dtype != torch.int32 or \
                q.device != dev:
            raise ValueError(f"scale_accum_const: chunk products must be "
                             f"{shape} int32 on {dev}, got "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    for name, t, want in (("gbase_a", gbase_a, batch),
                          ("gbase_b", gbase_b, batch),
                          ("base_a", base_a, batch + (m,)),
                          ("base_b", base_b, batch + (p,))):
        if t is not None and (tuple(t.shape) != want or t.dtype != dtype
                              or t.device != dev):
            raise ValueError(f"scale_accum_const: {name} must be {want} "
                             f"{dtype} on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return math.prod(batch), m, p


def scale_accum_const_windows(prods, groups, c: int, beta: int, gbase_a,
                              gbase_b, base_a=None, base_b=None, *,
                              partial: bool = False):
    """The whole df32 epilogue of an Ozaki-II contraction: chunk products
    ``prods`` (each ``(*batch, m, p)`` int32) of ascending groups ``groups``
    (g >= 2: the pairs of group g carry ``gbase_a gbase_b 2^(-beta g)``),
    folded into ladder windows of <= ``c`` groups; ``gbase_a``, ``gbase_b
    (*batch,)``; the fast2 bases ``base_a (*batch, m)``, ``base_b (*batch,
    p)`` (both or neither), all f32 or all f64.  Returns f32 ``ftz(hi +
    lo)``, or ``(hi, lo)`` with ``partial``.  On CUDA one launch per
    :data:`MAX_WORDS` chunk products in whole windows (successive launches
    carry (hi, lo) through memory; the last one unscales and sums)."""
    if len(prods) != len(groups) or not prods:
        raise ValueError(f"need one group per chunk product, got "
                         f"{len(prods)} products and {len(groups)} groups")
    if min(groups) < 2 or list(groups) != sorted(groups):
        raise ValueError(f"groups ascend from 2, got {list(groups)}")
    if (base_a is None) != (base_b is None):
        raise ValueError("scale_accum_const: give both fast2 bases or "
                         "neither")
    if gbase_a.device.type == "cpu":
        return scale_accum_const_windows_ref(prods, groups, c, beta, gbase_a,
                                             gbase_b, base_a, base_b,
                                             partial=partial)
    _build.require_cuda(gbase_a, "scale_accum_const")
    B, m, p = _check_windows(prods, gbase_a, gbase_b, base_a, base_b)
    launches = _window_launches(tuple(groups), c, beta)
    # keep the contiguous copies alive across the launches
    prods = [q.contiguous() for q in prods]
    gbase_a, gbase_b = gbase_a.contiguous(), gbase_b.contiguous()
    bases = (None, None) if base_a is None else \
        (base_a.contiguous(), base_b.contiguous())
    hi = torch.empty(prods[0].shape, dtype=torch.float32,
                     device=gbase_a.device)
    many = len(launches) > 1
    lo = torch.empty_like(hi) if partial or many else None
    fn = _build.function("scale_accum", "scale_accum_const_windows",
                         _ARGS_WINDOWS)
    for i, (first, n, shifts, tops) in enumerate(launches):
        last = i == len(launches) - 1
        sum_ = last and not partial
        ptrs = (ctypes.c_void_p * n)(*[q.data_ptr()
                                       for q in prods[first:first + n]])
        acc_in = (hi.data_ptr(), lo.data_ptr()) if i else (None, None)
        unscale_by = tuple(t.data_ptr() for t in bases) \
            if last and bases[0] is not None else (None, None)
        LAUNCHES["scale_accum_const"] += 1
        _build.check(fn(ptrs, shifts, tops, n, beta, gbase_a.data_ptr(),
                        gbase_b.data_ptr(), *unscale_by,
                        int(gbase_a.dtype == torch.float64), *acc_in,
                        hi.data_ptr(), None if sum_ else lo.data_ptr(),
                        int(sum_), B, m, p, _build.stream(gbase_a)),
                     "scale_accum_const")
    return (hi, lo) if partial else hi


def scale_accum_const_plain(word, s, c) -> torch.Tensor:
    """oz2 plain window ``c += float(word) * s`` in c's dtype (f32 or f64);
    word int32 or int64; on CUDA in place (returns the same tensor)."""
    if word.device.type == "cpu":
        return scale_accum_const_plain_ref(word, s, c)
    if c.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scale_accum_const_plain accumulates in f32 or "
                        f"f64, got {c.dtype}")
    B, m, p = _check_const(word, s, (c,), c.dtype,
                           (torch.int32, torch.int64),
                           "scale_accum_const_plain")
    word, s = word.contiguous(), s.contiguous()
    fn = _build.function("scale_accum", "scale_accum_const_plain",
                         _ARGS_CONST_PLAIN)
    LAUNCHES["scale_accum_const_plain"] += 1
    _build.check(fn(word.data_ptr(), s.data_ptr(), c.data_ptr(), B, m, p,
                    int(word.dtype == torch.int64),
                    int(c.dtype == torch.float64), _build.stream(word)),
                 "scale_accum_const_plain")
    return c


def unscale(x, srow, scol) -> torch.Tensor:
    """fast2 unscale ``(x * srow) * scol`` in x's dtype (f32 or f64), into
    a new tensor."""
    if x.device.type == "cpu":
        return unscale_ref(x, srow, scol)
    _build.require_cuda(x, "unscale")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unscale takes f32 or f64, got {x.dtype}")
    batch, (m, p) = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    for name, t, shape in (("srow", srow, batch + (m,)),
                           ("scol", scol, batch + (p,))):
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"unscale: {name} must be {shape} {x.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"unscale: operands live on {t.device} and "
                             f"{x.device}")
    x, srow, scol = x.contiguous(), srow.contiguous(), scol.contiguous()
    out = torch.empty_like(x)
    fn = _build.function("scale_accum", "unscale", _ARGS_UNSCALE)
    LAUNCHES["unscale"] += 1
    _build.check(fn(x.data_ptr(), srow.data_ptr(), scol.data_ptr(),
                    out.data_ptr(), math.prod(batch), m, p,
                    int(x.dtype == torch.float64), _build.stream(x)),
                 "unscale")
    return out
