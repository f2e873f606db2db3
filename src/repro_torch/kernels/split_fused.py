"""Fused k-slice extraction: the CUDA kernel ``csrc/split_fused.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/split_fused.py::split_fused``
(body ``_split_kernel``): each element is read once and all k int8 digits
are emitted from registers.  Modes ``bitmask`` (trunc), ``rn_const``
(round half to even) and ``sm`` (floor, clamp to 2^beta - 1, stored mod
2^8); f32 or f64 input.

The reciprocal grid is per row (``axis=0``, the A operand) or per column
(``axis=1``, the B operand).  The B stack is written K-major (storage
``(k, *batch, C, R)``, returned as the transposed view, as
``splitting.kmajor_stack`` makes it): the kernel transposes through shared
memory on the way out.  Every product and difference flushes a subnormal
result to zero, and ``a``'s subnormals count as zero, as the reference's
arithmetic does (``splitting.ftz``).  :func:`split_fused` launches the
kernel for a CUDA tensor and runs :func:`split_fused_ref` for a CPU
tensor; nothing else falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.splitting import ftz, kmajor_stack, to_int8
from repro_torch.kernels import LAUNCHES, _build

__all__ = ["split_fused", "split_fused_ref", "MODES"]

MODES = {"bitmask": 0, "rn_const": 1, "sm": 2}

_p, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = [_p, _p, _p, _ll, _ll, _ll, _i, _i, _i, _i, _p]


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
    a = a.contiguous()
    inv = invgrid.contiguous()
    batch, (R, C) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    # axis 1: K-major storage (k, *batch, C, R), returned transposed
    store = (R, C) if axis == 0 else (C, R)
    out = torch.empty((k,) + batch + store, dtype=torch.int8,
                      device=a.device)
    name = {torch.float32: "split_fused_f32",
            torch.float64: "split_fused_f64"}[a.dtype]
    fn = _build.function("split_fused", name, _ARGS)
    LAUNCHES["split_fused"] += 1
    _build.check(fn(a.data_ptr(), inv.data_ptr(), out.data_ptr(),
                    math.prod(batch), R, C, k, beta, MODES[mode], axis,
                    _build.stream(a)), "split_fused")
    return out if axis == 0 else out.transpose(-1, -2)

