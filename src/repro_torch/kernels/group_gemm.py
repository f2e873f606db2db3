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

On the card both operands must be K-major, as the int8 tensor-core
instructions take them: A with its n contraction bytes contiguous (what the
``axis=0`` split makes) and B STORED ``(K, *batch, p, n)``, i.e. a
transposed view (what the ``axis=1`` split makes, see
``splitting.kmajor_stack``).  The wrapper reads the strides and copies
nothing, and an operand in another layout raises.  :func:`route` picks one
of the kernel's two routes: ``large``
(wgmma tensor cores fed by TMA) above :data:`SKINNY_MAX_M` rows when the
strides allow TMA, ``skinny`` (streaming, split over the contraction)
otherwise.  Each launch counts under ``group_gemm`` and under its route.

The plain version contracts in f64: every partial sum is an integer below
2^53, so it is exact in any summation order, on the CPU and on the card
alike (``torch.mm`` on int8 CPU tensors would wrap in int8, and CUDA has
no int32 matmul).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["group_gemm", "group_gemm_ref", "route", "tma_aligned", "MAX_G",
           "SKINNY_MAX_M"]

MAX_G = 32   # pairs per launch (the kernel takes their indices by value)

# the crossover: at most this many rows take the skinny route.  Measured
# with chip_smoke.py on the H100 at n = 2048, p = 8192, G = 4 (PERF.md):
# skinny 0.030 / 0.047 ms against large 0.061 / 0.062 ms at m = 4 / 8, but
# 0.101 / 0.203 ms against 0.062 ms at m = 16 / 32
SKINNY_MAX_M = 8

_p, _i, _ll, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
_LARGE_ARGS = [_p, _p, _p, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _ll,
               _ll, _i, _p, _p, _u, _u, _p]
_SKINNY_ARGS = [_p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _ll, _ll,
                _i, _p, _p, _u, _u, _p]

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
    holds (exact: integer partial sums below 2^53).  Any layout."""
    ia, ib, ua, ub = _pairs(a8, b8, ia, ib, a_unsigned, b_unsigned)
    a_cat = torch.cat([_widen(a8[i], u) for i, u in zip(ia, ua)], dim=-1)
    b_cat = torch.cat([_widen(b8[j], u) for j, u in zip(ib, ub)], dim=-2)
    return torch.matmul(a_cat.to(torch.float64),
                        b_cat.to(torch.float64)).to(torch.int32)


# ---------------------------------------------------------------------------
# layout: strides, K-major, TMA alignment, route
# ---------------------------------------------------------------------------

def _strides(t: torch.Tensor, contraction: int) -> Optional[Tuple[int, ...]]:
    """``(ld, batch stride, slice stride)`` in elements of a digit stack
    ``(K, *batch, r0, r1)`` whose ``contraction`` axis (-1 for A, -2 for B)
    is contiguous and whose batch axes flatten into one; None otherwise.
    ``ld`` is the stride of the other matrix axis.  Strides of size-1 axes
    do not matter and come out consistent."""
    other = -2 if contraction == -1 else -1
    shape, st = t.shape, t.stride()
    if shape[contraction] > 1 and st[contraction] != 1:
        return None
    ld = st[other] if shape[other] > 1 else max(1, shape[contraction])
    rows = shape[other]
    bs = rows * ld
    batch = list(range(1, t.ndim - 2))
    # the batch axes must flatten: innermost first, each a whole multiple
    step = None
    for ax in reversed(batch):
        if shape[ax] == 1:
            continue
        if step is None:
            step = st[ax]
            expect = st[ax] * shape[ax]
        elif st[ax] != expect:
            return None
        else:
            expect = st[ax] * shape[ax]
    if step is not None:
        bs = step
    ss = st[0] if shape[0] > 1 else bs * max(1, math.prod(shape[1:-2]))
    return ld, bs, ss


def tma_aligned(t: torch.Tensor, contraction: int) -> bool:
    """The large route's TMA rule: a 16-byte aligned base and 16-byte
    multiples for every stride it walks (rows, batch, slices)."""
    st = _strides(t, contraction)
    return st is not None and t.data_ptr() % 16 == 0 and \
        all(s % 16 == 0 for s in st)


def route(m: int, aligned: bool) -> str:
    """``large`` for more than :data:`SKINNY_MAX_M` rows on TMA-aligned
    stacks, ``skinny`` otherwise (decode shapes, and shapes TMA cannot
    address)."""
    return "large" if m > SKINNY_MAX_M and aligned else "skinny"


# launch plans by (shapes, strides, alignment, pairs, options): the checks,
# route and static arguments of a call, computed once per layout (a serve
# step repeats the same few hundred)
_PLANS: dict = {}


def _launch_plan(a8, b8, ia, ib, a_unsigned, b_unsigned, which):
    """``(route, output shape, static C arguments or None, ctypes arrays
    they point into)`` of one call; raises on what no route takes."""
    ia, ib, ua, ub = _pairs(a8, b8, ia, ib, a_unsigned, b_unsigned)
    if len(ia) > MAX_G:
        raise ValueError(f"at most {MAX_G} pairs per group GEMM, got "
                         f"{len(ia)}")
    sa, sb = _strides(a8, -1), _strides(b8, -2)
    if sa is None or sb is None:
        raise ValueError(
            f"the CUDA group GEMM takes K-major digit stacks (A "
            f"contraction-contiguous, B stored (K, *batch, p, n)), got "
            f"strides {a8.stride()} and {b8.stride()}; the splits make "
            f"them so)")
    batch = tuple(a8.shape[1:-2])
    m, n, p = a8.shape[-2], a8.shape[-1], b8.shape[-1]
    B = math.prod(batch)
    aligned = tma_aligned(a8, -1) and tma_aligned(b8, -2)
    which = which or route(m, aligned)
    if which not in ("large", "skinny") or (which == "large" and
                                             not aligned):
        raise ValueError(f"route {which!r} cannot take this shape (the "
                         f"large route needs TMA-aligned stacks)")
    if B * m * p == 0 or n == 0:
        return which, batch + (m, p), None, None
    G = len(ia)
    c_ia, c_ib = (ctypes.c_int * G)(*ia), (ctypes.c_int * G)(*ib)
    ptrs = (G, ctypes.addressof(c_ia), ctypes.addressof(c_ib), _bits(ua),
            _bits(ub))
    if which == "large":
        tail = (B, m, n, p, a8.shape[0], b8.shape[0], *sa, *sb, *ptrs)
    else:
        tail = (B, m, n, p, *sa, *sb, *ptrs)
    return which, batch + (m, p), tail, (c_ia, c_ib)


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
    stored, and K-major (see the module docstring); :func:`route` picks
    the kernel's route."""
    if a8.device.type == "cpu":
        return group_gemm_ref(a8, b8, ia, ib, a_unsigned=a_unsigned,
                              b_unsigned=b_unsigned)
    return _launch(a8, b8, ia, ib, a_unsigned, b_unsigned)


def _launch(a8, b8, ia=None, ib=None, a_unsigned=None, b_unsigned=None,
            which: Optional[str] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on route ``which`` (``large`` /
    ``skinny``), or on :func:`route`'s choice when None.  Only the
    crossover measurement and its test name a route."""
    _build.require_cuda(a8, "group_gemm")
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise ValueError(
            f"the CUDA group GEMM takes the stored int8 digits (with their "
            f"signedness), got {a8.dtype} x {b8.dtype}")
    if b8.device != a8.device:
        raise ValueError("group_gemm operands live on different devices")
    key = (a8.shape, a8.stride(), b8.shape, b8.stride(),
           a8.data_ptr() % 16, b8.data_ptr() % 16,
           None if ia is None else tuple(ia),
           None if ib is None else tuple(ib),
           None if a_unsigned is None else tuple(a_unsigned),
           None if b_unsigned is None else tuple(b_unsigned), which)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _launch_plan(a8, b8, ia, ib, a_unsigned, b_unsigned, which)
        if len(_PLANS) >= 4096:
            _PLANS.clear()
        _PLANS[key] = plan
    which, out_shape, tail, _keep = plan
    out = torch.empty(out_shape, dtype=torch.int32, device=a8.device)
    if tail is None:           # nothing to contract: an empty or zero sum
        return out.zero_()
    fn = _build.function("group_gemm", f"group_gemm_{which}",
                         _LARGE_ARGS if which == "large" else _SKINNY_ARGS)
    LAUNCHES["group_gemm"] += 1
    LAUNCHES[f"group_gemm_{which}"] += 1
    err = fn(a8.data_ptr(), b8.data_ptr(), out.data_ptr(), *tail,
             _build.stream(a8))
    _build.check(err, f"group_gemm ({which})")
    return out
