"""Split-level wrappers around the kernels — PyTorch port of
``repro.kernels.ops``.

They derive row maxima, bases and reciprocal grids exactly as the reference
does, then hand the tensors to the kernel modules (the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor).  The reference pads every
operand to the TPU's 128-lane tiles and takes its tile sizes from the
planner; the CUDA kernels mask their own ragged edges and own their tile
sizes, so nothing here pads — except :func:`flash_attention`, whose padding
decides what a fully masked row averages, and which pads as the reference
does.
"""
from __future__ import annotations

import torch

from repro_torch.core.accumulate import DF32, slice_group_gemm
from repro_torch.core.splitting import (Split, _geo_scales, _global_base,
                                        _pow2_ceil, _pow2_floor, _rowmax,
                                        _with_fast2_gbase)
from repro_torch.kernels import scale_accum as _sa
from repro_torch.kernels import split_fused as _sf

__all__ = ["split_fused", "group_gemm", "scale_accum_update",
           "oz2_scale_accum_update", "oz2_unscale_update",
           "flash_attention"]

# fused-split mode -> the kernel's extraction mode
_KERNEL_MODE = {"bitmask": "bitmask", "oz2_bitmask": "bitmask",
                "oz2_bitmask_fast2": "bitmask", "rn_const": "rn_const",
                "oz2_rn": "rn_const", "oz2_rn_fast2": "rn_const", "sm": "sm"}


def split_fused(a: torch.Tensor, k: int, beta: int, *,
                mode: str = "rn_const", axis: int = 0) -> Split:
    """Fused splitting (Alg. 3 ``bitmask`` / Alg. 8 ``rn_const`` / the
    sign-magnitude ``sm`` / the oz2 constant-grid modes ``oz2_bitmask`` /
    ``oz2_rn`` and their fast2 twins): the same :class:`Split` as the
    library splitters, bit for bit, in ``a``'s own dtype.  ``a`` is
    ``(*batch, m, n)``; ``axis=1`` (column scales, for B) indexes the grid
    per column instead of transposing.

    The plain oz2 modes broadcast the global maximum of each batch element
    onto the per-row reciprocal grid, which is bit-identical to the
    reference's constant-grid kernel, so the kernel needs no mode of its
    own.  The fast2 modes keep the per-row grids and attach ``gbase = 2``
    (``splitting._with_fast2_gbase``)."""
    if mode not in _KERNEL_MODE:
        raise ValueError(f"fused splitting supports {sorted(_KERNEL_MODE)}"
                         f", got {mode!r}")
    kmode = _KERNEL_MODE[mode]
    rowmax = (_global_base(a, axis, None) if mode in ("oz2_rn", "oz2_bitmask")
              else _rowmax(a, axis))
    if kmode == "bitmask":
        base = 2.0 * _pow2_floor(rowmax)
        invgrid = (2.0 ** beta) / base  # 1/grid_1, grid_1 = base*2^-beta
    elif kmode == "rn_const":
        mu = _pow2_ceil(rowmax) * (2.0 ** (1 - beta))
        base = mu * (2.0 ** beta)
        invgrid = 1.0 / mu
    else:
        anchor = 2.0 * _pow2_floor(rowmax)
        base = 2.0 * anchor
        invgrid = (2.0 ** (beta - 1)) / anchor
    digits = _sf.split_fused(a, invgrid, k=k, beta=beta, mode=kmode,
                             axis=axis)
    sp = Split(digits, _geo_scales(base, beta, k), base, beta, axis,
               gbase=base[..., 0] if mode in ("oz2_rn", "oz2_bitmask")
               else None, signmag=(mode == "sm"))
    return _with_fast2_gbase(sp) if mode.endswith("_fast2") else sp


# the ``group_gemm_fn`` / ``pair_gemm_fn`` hook of ``accumulate`` (after
# partial application of sa, sb): the accumulator's own Split-level group GEMM
group_gemm = slice_group_gemm


def scale_accum_update(prod: torch.Tensor, srow: torch.Tensor,
                       scol: torch.Tensor, acc):
    """``scale_accum_fn`` hook: one fused convert+scale+add epilogue step
    (df32 pair or plain accumulator, by ``acc``'s type), bit-identical to
    the plain epilogue.  On CUDA the accumulator is updated in place."""
    if isinstance(acc, DF32):
        return DF32(*_sa.scale_accum(prod, srow, scol, acc.hi, acc.lo))
    return _sa.scale_accum_plain(prod, srow, scol, acc)


def oz2_scale_accum_update(word: torch.Tensor, s: torch.Tensor, acc):
    """``scale_accum_fn`` hook of ``accumulate.matmul_oz2``: one ladder
    window's convert+scale+add through the const-scale kernels (df32 pair
    or plain accumulator, by ``acc``'s type), bit-identical to the plain
    epilogue.  On CUDA the accumulator is updated in place."""
    if isinstance(acc, DF32):
        return DF32(*_sa.scale_accum_const(word, s, acc.hi, acc.lo))
    return _sa.scale_accum_const_plain(word, s, acc)


def oz2_unscale_update(acc, ra: torch.Tensor, rb: torch.Tensor):
    """``unscale_fn`` hook of ``accumulate.matmul_oz2`` (fast2): the exact
    two-sided power-of-two unscale through the kernel, once per limb of a
    df32 accumulator."""
    if isinstance(acc, DF32):
        ra32, rb32 = ra.to(torch.float32), rb.to(torch.float32)
        return DF32(_sa.unscale(acc.hi, ra32, rb32),
                    _sa.unscale(acc.lo, ra32, rb32))
    return _sa.unscale(acc, ra.to(acc.dtype), rb.to(acc.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, qc: int = 256,
                    kc: int = 512, q_offset: int = 0) -> torch.Tensor:
    """The fused flash-attention forward on ``(B, L, H, D)`` tensors.

    q (B, Lq, H, D); k, v (B, Lk, KV, D/Dv).  Pads the lengths to the
    reference's tile multiples ``qc``/``kc`` (its padding contract: a row
    with every key masked averages v over the padded keys too), flattens
    (B, H) into the kernel's leading axis, maps the GQA groups without
    expanding K/V, and slices the padding back off.  The CUDA kernel picks
    its own tiles; only the summation order differs from the reference."""
    from repro_torch.kernels import flash_attention as _fa
    B, Lq, H, D = q.shape
    _, Lk, KV, Dv = v.shape
    qc = min(qc, max(8, Lq))
    kc = min(kc, max(8, Lk))
    Lq_p = -(-Lq // qc) * qc
    Lk_p = -(-Lk // kc) * kc

    def pad(x, total):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, total - x.shape[1]))

    qt = pad(q, Lq_p).transpose(1, 2).reshape(B * H, Lq_p, D)
    kt = pad(k, Lk_p).transpose(1, 2).reshape(B * KV, Lk_p, D)
    vt = pad(v, Lk_p).transpose(1, 2).reshape(B * KV, Lk_p, Dv)
    o, _ = _fa.flash_attention_fwd(qt, kt, vt, group=H // KV, causal=causal,
                                   window=window, q_offset=q_offset, lk=Lk)
    return o.reshape(B, H, Lq_p, Dv).transpose(1, 2)[:, :Lq]
