"""Fused convert + scale + add epilogue (step iv): the CUDA kernels of
``csrc/scale_accum.cu`` and their plain PyTorch versions.

Replaces two TPU kernels of ``repro/kernels/scale_accum.py``:

  * ``scale_accum`` (body ``_scale_accum_kernel``) — the df32 accumulator
    ``(hi, lo) += srow * float(P32) * scol``: exact low-8-bit int32 split,
    TwoSum, full TwoSum renormalisation, in the order of
    ``accumulate._scale_accum_df32``;
  * ``scale_accum_plain`` (body ``_scale_accum_plain_kernel``) — the plain
    accumulator ``c += float(P32) * srow * scol`` in c's dtype (f32 or
    f64; the f64 form runs natively on Hopper).

Operands: ``p32 (*batch, m, p)`` int32, ``srow (*batch, m)``, ``scol
(*batch, p)``.  The CUDA path updates the accumulators IN PLACE and returns
them; callers pass only buffers they own (the accumulate routines allocate
theirs per contraction).  The plain versions return new tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["scale_accum", "scale_accum_ref", "scale_accum_plain",
           "scale_accum_plain_ref"]

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS_DF32 = [_p, _p, _p, _p, _p, _ll, _ll, _ll, _p]
_ARGS_PLAIN = [_p, _p, _p, _p, _ll, _ll, _ll, _i, _p]


def _two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def scale_accum_ref(p32, srow, scol, c_hi, c_lo
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the df32 epilogue: the exact
    ``accumulate._scale_accum_df32`` operation sequence."""
    p_hi = (p32 >> 8) << 8
    p_lo = p32 - p_hi
    sr, sc = srow[..., :, None], scol[..., None, :]
    x_hi = p_hi.to(torch.float32) * sr * sc
    x_lo = p_lo.to(torch.float32) * sr * sc
    hi, err = _two_sum(c_hi, x_hi)
    lo = c_lo + err + x_lo
    return _two_sum(hi, lo)


def scale_accum_plain_ref(p32, srow, scol, c) -> torch.Tensor:
    """Plain version of the plain-accumulator epilogue, in c's dtype."""
    return c + p32.to(c.dtype) * srow[..., :, None] * scol[..., None, :]


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
