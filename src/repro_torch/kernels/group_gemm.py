"""INT8 group GEMM with an INT32 accumulator: the CUDA kernel
``csrc/group_gemm.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/group_gemm.py::group_gemm`` (body
``_group_gemm_kernel``): per batch element,

    C[b] = sum_g A[ia[g], b] @ B[ib[g], b]      (m x n) @ (n x p) -> int32

exact while the pair count stays within r (eq. 12; the caller's contract).
The operands are whole digit stacks ``(K, *batch, m, n)`` / ``(K, *batch,
n, p)`` and the pairs index into them, so a group's slices are read in
place: the wrapper gathers and concatenates nothing.

Sign-magnitude digits (``split_sm``) are passed as stored, int8, with the
signedness of each pair's operands (``a_unsigned`` / ``b_unsigned``: the
trailing slices hold magnitudes in [0, 255] stored mod 2^8).  The kernel
multiplies the stored bytes in the matching signed/unsigned form; the
plain version widens them to int16 first, as the reference does.

The plain version contracts in f64: every partial sum is an integer below
2^53, so it is exact in any summation order, on the CPU and on the card
alike (``torch.mm`` on int8 CPU tensors would wrap in int8, and CUDA has
no int32 matmul).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["group_gemm", "group_gemm_ref", "MAX_G"]

MAX_G = 32   # pairs per launch (the kernel takes their offsets by value)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_p, _p, _p, _i, _i, _i, _i, _i, _ll, _ll, _p, _p, ctypes.c_uint,
         ctypes.c_uint, _p]

Flags = Optional[Sequence[bool]]


def _pairs(a8, b8, ia, ib, a_unsigned, b_unsigned):
    ia = list(range(a8.shape[0])) if ia is None else [int(i) for i in ia]
    ib = list(range(b8.shape[0])) if ib is None else [int(i) for i in ib]
    if len(ia) != len(ib) or not ia:
        raise ValueError(f"need matching, non-empty pair lists, got "
                         f"{len(ia)} and {len(ib)}")
    if a8.shape[1:-2] != b8.shape[1:-2] or a8.shape[-1] != b8.shape[-2]:
        raise ValueError(f"bad group GEMM shapes {tuple(a8.shape)} @ "
                         f"{tuple(b8.shape)}")
    ua = [False] * len(ia) if a_unsigned is None else \
        [bool(u) for u in a_unsigned]
    ub = [False] * len(ib) if b_unsigned is None else \
        [bool(u) for u in b_unsigned]
    if len(ua) != len(ia) or len(ub) != len(ib):
        raise ValueError(f"need one signedness flag per pair, got "
                         f"{len(ua)} and {len(ub)} for {len(ia)} pairs")
    return ia, ib, ua, ub


def _widen(d: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """A stored slice as the values it holds: int16, the low byte taken
    unsigned for a sign-magnitude magnitude (a no-op on digits already
    widened)."""
    w = d.to(torch.int16)
    return w & 0xFF if unsigned else w


def _bits(flags) -> int:
    """Per-pair flags as the kernel's bit mask (bit g: pair g)."""
    return sum(1 << g for g, f in enumerate(flags) if f)


def group_gemm_ref(a8: torch.Tensor, b8: torch.Tensor,
                   ia: Optional[Sequence[int]] = None,
                   ib: Optional[Sequence[int]] = None, *,
                   a_unsigned: Flags = None,
                   b_unsigned: Flags = None) -> torch.Tensor:
    """Plain version: ``sum_g a8[ia[g]] @ b8[ib[g]]`` in int32, as one f64
    contraction over the concatenated slices, each widened to the values it
    holds (exact: integer partial sums below 2^53)."""
    ia, ib, ua, ub = _pairs(a8, b8, ia, ib, a_unsigned, b_unsigned)
    a_cat = torch.cat([_widen(a8[i], u) for i, u in zip(ia, ua)], dim=-1)
    b_cat = torch.cat([_widen(b8[j], u) for j, u in zip(ib, ub)], dim=-2)
    return torch.matmul(a_cat.to(torch.float64),
                        b_cat.to(torch.float64)).to(torch.int32)


def group_gemm(a8: torch.Tensor, b8: torch.Tensor,
               ia: Optional[Sequence[int]] = None,
               ib: Optional[Sequence[int]] = None, *,
               a_unsigned: Flags = None,
               b_unsigned: Flags = None) -> torch.Tensor:
    """``sum_g a8[ia[g]] @ b8[ib[g]]`` -> ``(*batch, m, p)`` int32.

    a8 ``(Ka, *batch, m, n)``, b8 ``(Kb, *batch, n, p)``; ``ia``/``ib``
    default to all slices in order.  ``a_unsigned[g]`` / ``b_unsigned[g]``
    (default all False) mark pair g's slices as unsigned bytes (the
    trailing sign-magnitude digits).  On CUDA the digits must be int8, as
    stored."""
    if a8.device.type == "cpu":
        return group_gemm_ref(a8, b8, ia, ib, a_unsigned=a_unsigned,
                              b_unsigned=b_unsigned)
    _build.require_cuda(a8, "group_gemm")
    ia, ib, ua, ub = _pairs(a8, b8, ia, ib, a_unsigned, b_unsigned)
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise ValueError(
            f"the CUDA group GEMM takes the stored int8 digits (with their "
            f"signedness), got {a8.dtype} x {b8.dtype}")
    if b8.device != a8.device:
        raise ValueError("group_gemm operands live on different devices")
    batch = tuple(a8.shape[1:-2])
    m, n, p = a8.shape[-2], a8.shape[-1], b8.shape[-1]
    out = torch.empty(batch + (m, p), dtype=torch.int32, device=a8.device)
    B = math.prod(batch)
    if out.numel() == 0:
        return out
    a8, b8 = a8.contiguous(), b8.contiguous()
    a_slice, b_slice = B * m * n, B * n * p
    if len(ia) > MAX_G:
        raise ValueError(f"at most {MAX_G} pairs per group GEMM, got "
                         f"{len(ia)}")
    a_off = (ctypes.c_longlong * len(ia))(*[i * a_slice for i in ia])
    b_off = (ctypes.c_longlong * len(ib))(*[j * b_slice for j in ib])
    fn = _build.function("group_gemm", "group_gemm_s8", _ARGS)
    LAUNCHES["group_gemm"] += 1
    _build.check(fn(a8.data_ptr(), b8.data_ptr(), out.data_ptr(), B, m, n,
                    p, len(ia), m * n, n * p, ctypes.addressof(a_off),
                    ctypes.addressof(b_off), _bits(ua), _bits(ub),
                    _build.stream(a8)),
                 "group_gemm")
    return out
