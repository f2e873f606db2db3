"""Split-level wrappers around the kernels — PyTorch port of
``repro.kernels.ops``.

They derive row maxima, bases and reciprocal grids exactly as the reference
does, then hand the tensors to the kernel modules (the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor).  The reference pads every
operand to the TPU's 128-lane tiles and takes its tile sizes from the
planner; the CUDA kernels mask their own ragged edges and own their tile
sizes, so nothing here pads.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.splitting import (Split, _geo_scales, _pow2_ceil,
                                        _pow2_floor, _rowmax, sm_decode)
from repro_torch.kernels import group_gemm as _gg
from repro_torch.kernels import scale_accum as _sa
from repro_torch.kernels import split_fused as _sf

__all__ = ["split_fused", "group_gemm", "scale_accum_update"]


def split_fused(a: torch.Tensor, k: int, beta: int, *,
                mode: str = "rn_const", axis: int = 0) -> Split:
    """Fused splitting (Alg. 3 ``bitmask`` / Alg. 8 ``rn_const`` / the
    sign-magnitude ``sm``): the same :class:`Split` as the library
    splitters, bit for bit, in ``a``'s own dtype.  ``a`` is ``(*batch, m,
    n)``; ``axis=1`` (column scales, for B) indexes the grid per column
    instead of transposing.  The oz2 constant-grid modes come with a later
    slice of the port."""
    rowmax = _rowmax(a, axis)
    if mode == "bitmask":
        base = 2.0 * _pow2_floor(rowmax)
        invgrid = (2.0 ** beta) / base  # 1/grid_1, grid_1 = base*2^-beta
    elif mode == "rn_const":
        mu = _pow2_ceil(rowmax) * (2.0 ** (1 - beta))
        base = mu * (2.0 ** beta)
        invgrid = 1.0 / mu
    elif mode == "sm":
        anchor = 2.0 * _pow2_floor(rowmax)
        base = 2.0 * anchor
        invgrid = (2.0 ** (beta - 1)) / anchor
    elif mode.startswith("oz2"):
        raise NotImplementedError(
            f"fused splitting mode {mode!r} (Ozaki-II) is not ported yet; "
            f"it comes with the oz2/fast2 slice")
    else:
        raise ValueError(f"fused splitting supports bitmask/rn_const/sm, "
                         f"got {mode!r}")
    digits = _sf.split_fused(a, invgrid, k=k, beta=beta, mode=mode,
                             axis=axis)
    return Split(digits, _geo_scales(base, beta, k), base, beta, axis,
                 signmag=(mode == "sm"))


def group_gemm(sa: Split, sb: Split, pairs: Sequence[Tuple[int, int]]
               ) -> torch.Tensor:
    """sum over 1-indexed slice pairs of A_s @ B_t in int32 — the
    ``group_gemm_fn`` hook of ``accumulate.matmul_group_ef`` (after partial
    application of sa, sb).  Output ``(*batch, m, p)``."""
    da = sm_decode(sa.digits) if sa.signmag else sa.digits
    db = sm_decode(sb.digits) if sb.signmag else sb.digits
    return _gg.group_gemm(da, db, [s - 1 for s, _ in pairs],
                          [t - 1 for _, t in pairs])


def scale_accum_update(prod: torch.Tensor, srow: torch.Tensor,
                       scol: torch.Tensor, acc):
    """``scale_accum_fn`` hook: one fused convert+scale+add epilogue step
    (df32 pair or plain accumulator, by ``acc``'s type), bit-identical to
    the plain epilogue.  On CUDA the accumulator is updated in place."""
    from repro_torch.core.accumulate import DF32  # local: import cycle
    if isinstance(acc, DF32):
        return DF32(*_sa.scale_accum(prod, srow, scol, acc.hi, acc.lo))
    return _sa.scale_accum_plain(prod, srow, scol, acc)
