"""Fused k-slice extraction: the CUDA kernel ``csrc/split_fused.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/split_fused.py::split_fused``
(body ``_split_kernel``) and, on the card, the row-maximum and grid
preparation its wrapper does around it: :func:`split_whole` is ONE launch
that takes the maximum |a| of every row (``axis=0``, the A operand) or
column (``axis=1``, the B operand), derives the power-of-two base and
reciprocal grid as :func:`grid` does, and writes the digits, the base, the
k scales ``base * 2^(-beta s)`` and, for the fast2 modes, ``gbase = 2``.
:func:`split_fused` extracts the digits on a reciprocal grid the caller
derived (the Ozaki-II constant-grid modes, whose maximum spans a whole
batch element).  Modes ``bitmask`` (trunc), ``rn_const`` (round half to
even) and ``sm`` (floor, clamp to 2^beta - 1, stored mod 2^8); f32 or
f64 input.

The B stack is written K-major (storage ``(k, *batch, C, R)``, returned as
the transposed view, as ``splitting.kmajor_stack`` makes it): the kernel
transposes through shared memory on the way out.  The B side reads its
operand through its strides (the attention's B operands are permuted views
of the KV cache), so no copy precedes the launch.  Every product and
difference flushes a subnormal result to zero, and ``a``'s subnormals
count as zero, as the reference's arithmetic does (``splitting.ftz``).
Each wrapper launches the kernel for a CUDA tensor and runs its plain
version (:func:`split_whole_ref`, :func:`split_fused_ref`) for a CPU
tensor; nothing else falls back.  Both count under
``LAUNCHES["split_fused"]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.splitting import (_geo_scales, _pow2_ceil,
                                        _pow2_floor, _rowmax, ftz,
                                        kmajor_stack, to_int8)
from repro_torch.kernels import LAUNCHES, _build

__all__ = ["split_whole", "split_whole_ref", "split_fused",
           "split_fused_ref", "grid", "MODES"]

MODES = {"bitmask": 0, "rn_const": 1, "sm": 2}

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = [_p, _p, _p, _ll, _ll, _ll, _p, _i, _i, _i, _i, _p]
_WHOLE_ARGS = [_p, _p, _p, _p, _p, _ll, _ll, _ll, _p, _i, _i, _i, _i, _p]
_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def grid(rowmax: torch.Tensor, beta: int, mode: str):
    """``(base, invgrid)`` of the rows with maxima ``rowmax``: the base the
    scales derive from and the reciprocal first grid the digits multiply
    by, as the reference derives them.  Only the first RN grid ``mu`` can
    underflow, and it is flushed as the reference's (``splitting.ftz``);
    the bases are normal powers of two (or inf), and a subnormal
    ``invgrid`` is read as zero by the digit extraction."""
    if mode == "bitmask":
        base = 2.0 * _pow2_floor(rowmax)
        invgrid = (2.0 ** beta) / base  # 1/grid_1, grid_1 = base*2^-beta
    elif mode == "rn_const":
        mu = ftz(_pow2_ceil(rowmax) * (2.0 ** (1 - beta)))
        base = mu * (2.0 ** beta)
        invgrid = 1.0 / mu
    elif mode == "sm":
        anchor = 2.0 * _pow2_floor(rowmax)
        base = 2.0 * anchor
        invgrid = (2.0 ** (beta - 1)) / anchor
    else:
        raise ValueError(f"fused splitting supports {sorted(MODES)}, "
                         f"got {mode!r}")
    return base, invgrid


def _check(a: torch.Tensor, invgrid: torch.Tensor, mode: str, axis: int):
    if mode not in MODES:
        raise ValueError(f"fused splitting supports {sorted(MODES)}, "
                         f"got {mode!r}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"split_fused takes f32 or f64, got {a.dtype}")
    if invgrid.dtype != a.dtype or invgrid.device != a.device:
        raise TypeError("invgrid must match a's dtype and device")
    want = a.shape[:-1] if axis == 0 else a.shape[:-2] + a.shape[-1:]
    if tuple(invgrid.shape) != tuple(want):
        raise ValueError(f"invgrid {tuple(invgrid.shape)} does not match "
                         f"a {tuple(a.shape)} along axis {axis}")


def _strides(a: torch.Tensor, axis: int):
    """``(a, strides)``: the operand as the kernel reads it and its element
    strides ``(nb1, s0, s1, sr, sc)`` as a C array: batch element b at
    ``(b // nb1) s0 + (b % nb1) s1``, element (r, c) at ``r sr + c sc``.
    Rows (axis 0) are read contiguous; columns (axis 1) through any strides,
    the batch dims merged into at most two (a permuted KV cache needs two),
    else from a contiguous copy."""
    if axis == 0:
        a = a.contiguous()
    dims = []
    for n, st in zip(a.shape[:-2], a.stride()[:-2]):
        if n == 1:
            continue
        if dims and dims[-1][1] == st * n:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 2:
        return _strides(a.contiguous(), axis)
    (_, s0), (nb1, s1) = [(1, 0)] * (2 - len(dims)) + dims
    return a, (_ll * 5)(nb1, s0, s1, a.stride(-2), a.stride(-1))


def split_fused_ref(a: torch.Tensor, invgrid: torch.Tensor, *, k: int,
                    beta: int, mode: str = "rn_const",
                    axis: int = 0) -> torch.Tensor:
    """Plain version: ``(k, *a.shape)`` int8 digits, the kernel's exact
    operation sequence (``_split_kernel`` of the reference)."""
    _check(a, invgrid, mode, axis)
    two_beta = 2.0 ** beta
    inv = invgrid[..., :, None] if axis == 0 else invgrid[..., None, :]
    r = ftz(ftz(a) * ftz(inv))
    outs = []
    if mode == "bitmask":
        for _ in range(k):
            d = torch.trunc(r)
            outs.append(to_int8(d))
            r = ftz(ftz(r - d) * two_beta)
    elif mode == "sm":
        dmax = 2.0 ** beta - 1.0
        d = torch.floor(r)
        outs.append(to_int8(d))
        r = ftz(ftz(r - d) * two_beta)
        for _ in range(1, k):
            d = torch.clamp(torch.floor(r), max=dmax)
            outs.append(to_int8(torch.where(d > 127.0, d - 256.0, d)))
            r = ftz(ftz(r - d) * two_beta)
    else:
        for _ in range(k):
            d = torch.round(r)
            outs.append(to_int8(d))
            r = ftz(ftz(r - d) * two_beta)
    return kmajor_stack(outs, axis)


def split_fused(a: torch.Tensor, invgrid: torch.Tensor, *, k: int, beta: int,
                mode: str = "rn_const", axis: int = 0) -> torch.Tensor:
    """All-k-slice extraction of ``a`` (*batch, R, C) with reciprocal grid
    ``invgrid`` (*batch, R) for ``axis=0`` or (*batch, C) for ``axis=1``.
    Returns ``(k, *batch, R, C)`` int8."""
    if a.device.type == "cpu":
        return split_fused_ref(a, invgrid, k=k, beta=beta, mode=mode,
                               axis=axis)
    _build.require_cuda(a, "split_fused")
    _check(a, invgrid, mode, axis)
    a, strides = _strides(a, axis)
    inv = invgrid.contiguous()
    batch, (R, C) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    # axis 1: K-major storage (k, *batch, C, R), returned transposed
    store = (R, C) if axis == 0 else (C, R)
    out = torch.empty((k,) + batch + store, dtype=torch.int8,
                      device=a.device)
    fn = _build.function("split_fused", f"split_fused_{_NAMES[a.dtype]}",
                         _ARGS)
    LAUNCHES["split_fused"] += 1
    _build.check(fn(a.data_ptr(), inv.data_ptr(), out.data_ptr(),
                    math.prod(batch), R, C, strides, k, beta, MODES[mode],
                    axis, _build.stream(a)), "split_fused")
    return out if axis == 0 else out.transpose(-1, -2)


def _check_whole(a: torch.Tensor, mode: str, axis: int):
    if mode not in MODES:
        raise ValueError(f"fused splitting supports {sorted(MODES)}, "
                         f"got {mode!r}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if a.dtype not in _NAMES:
        raise TypeError(f"split_whole takes f32 or f64, got {a.dtype}")
    if a.ndim < 2 or a.shape[-1 if axis == 0 else -2] == 0:
        raise ValueError(f"split_whole needs a non-empty contraction, got "
                         f"{tuple(a.shape)} along axis {axis}")


def split_whole_ref(a: torch.Tensor, *, k: int, beta: int,
                    mode: str = "rn_const", axis: int = 0,
                    gbase: bool = False):
    """Plain version of :func:`split_whole`: row maxima, :func:`grid`,
    :func:`split_fused_ref` and the geometric scales, as separate PyTorch
    operations in the order the reference's wrapper runs them."""
    _check_whole(a, mode, axis)
    base, invgrid = grid(_rowmax(a, axis), beta, mode)
    digits = split_fused_ref(a, invgrid, k=k, beta=beta, mode=mode,
                             axis=axis)
    g = torch.full(base.shape[:-1], 2.0, dtype=base.dtype,
                   device=base.device) if gbase else None
    return digits, _geo_scales(base, beta, k), base, g


def split_whole(a: torch.Tensor, *, k: int, beta: int,
                mode: str = "rn_const", axis: int = 0, gbase: bool = False):
    """The whole split of ``a`` (*batch, R, C) in one launch: ``(digits,
    scale, base, gbase)`` with digits ``(k, *batch, R, C)`` int8 (K-major
    storage for ``axis=1``), scale ``(k, *batch, r)``, base ``(*batch,
    r)`` (r = R for ``axis=0``, C for ``axis=1``) in ``a``'s dtype, and
    ``gbase`` ``(*batch,)`` = 2 when asked for (the fast2 modes), else
    None."""
    if a.device.type == "cpu":
        return split_whole_ref(a, k=k, beta=beta, mode=mode, axis=axis,
                               gbase=gbase)
    _build.require_cuda(a, "split_fused")
    _check_whole(a, mode, axis)
    a, strides = _strides(a, axis)
    batch, (R, C) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    store = (R, C) if axis == 0 else (C, R)
    r = (R,) if axis == 0 else (C,)
    dev = a.device
    out = torch.empty((k,) + batch + store, dtype=torch.int8, device=dev)
    base = torch.empty(batch + r, dtype=a.dtype, device=dev)
    scale = torch.empty((k,) + batch + r, dtype=a.dtype, device=dev)
    g = torch.empty(batch, dtype=a.dtype, device=dev) if gbase else None
    fn = _build.function("split_fused", f"split_whole_{_NAMES[a.dtype]}",
                         _WHOLE_ARGS)
    LAUNCHES["split_fused"] += 1
    _build.check(fn(a.data_ptr(), out.data_ptr(), base.data_ptr(),
                    scale.data_ptr(), None if g is None else g.data_ptr(),
                    math.prod(batch), R, C, strides, k, beta, MODES[mode],
                    axis, _build.stream(a)), "split_fused")
    return (out if axis == 0 else out.transpose(-1, -2)), scale, base, g

