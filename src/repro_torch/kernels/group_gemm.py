"""INT8 group GEMM with an INT32 accumulator: the CUDA kernel
``csrc/group_gemm.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/group_gemm.py::group_gemm`` (body
``_group_gemm_kernel``): per batch element,

    C[b] = sum_g A[ia[g], b] @ B[ib[g], b]      (m x n) @ (n x p) -> int32

exact while the pair count stays within r (eq. 12; the caller's contract).
The operands are whole digit stacks ``(K, *batch, m, n)`` / ``(K, *batch,
n, p)`` and the pairs index into them, so a group's slices are read in
place: the wrapper gathers and concatenates nothing.

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
_ARGS = [_p, _p, _p, _i, _i, _i, _i, _i, _ll, _ll, _p, _p, _p]


def _pairs(a8, b8, ia, ib):
    ia = list(range(a8.shape[0])) if ia is None else [int(i) for i in ia]
    ib = list(range(b8.shape[0])) if ib is None else [int(i) for i in ib]
    if len(ia) != len(ib) or not ia:
        raise ValueError(f"need matching, non-empty pair lists, got "
                         f"{len(ia)} and {len(ib)}")
    if a8.shape[1:-2] != b8.shape[1:-2] or a8.shape[-1] != b8.shape[-2]:
        raise ValueError(f"bad group GEMM shapes {tuple(a8.shape)} @ "
                         f"{tuple(b8.shape)}")
    return ia, ib


def group_gemm_ref(a8: torch.Tensor, b8: torch.Tensor,
                   ia: Optional[Sequence[int]] = None,
                   ib: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain version: ``sum_g a8[ia[g]] @ b8[ib[g]]`` in int32, as one f64
    contraction over the concatenated slices (exact: integer partial sums
    below 2^53)."""
    ia, ib = _pairs(a8, b8, ia, ib)
    a_cat = torch.cat([a8[i] for i in ia], dim=-1).to(torch.float64)
    b_cat = torch.cat([b8[j] for j in ib], dim=-2).to(torch.float64)
    return torch.matmul(a_cat, b_cat).to(torch.int32)


def group_gemm(a8: torch.Tensor, b8: torch.Tensor,
               ia: Optional[Sequence[int]] = None,
               ib: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``sum_g a8[ia[g]] @ b8[ib[g]]`` -> ``(*batch, m, p)`` int32.

    a8 ``(Ka, *batch, m, n)``, b8 ``(Kb, *batch, n, p)``; ``ia``/``ib``
    default to all slices in order.  On CUDA the operands must be int8
    (the sign-magnitude family's widened int16 digits come with a later
    slice of the port)."""
    if a8.device.type == "cpu":
        return group_gemm_ref(a8, b8, ia, ib)
    _build.require_cuda(a8, "group_gemm")
    ia, ib = _pairs(a8, b8, ia, ib)
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise NotImplementedError(
            f"the CUDA group GEMM takes int8 digits, got {a8.dtype} x "
            f"{b8.dtype}; the widened sign-magnitude form is not ported yet")
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
                    ctypes.addressof(b_off), _build.stream(a8)),
                 "group_gemm")
    return out
