"""Split-level wrappers around the kernels — PyTorch port of
``repro.kernels.ops``.

On the card the split is one launch of the split kernel (row maxima,
bases, reciprocal grids, scales and digits); only the Ozaki-II
constant-grid modes derive their grid here first (their maximum spans a
whole batch element).  The df32 epilogue of a contraction is one launch
over all its chunk products: the group-EF one of the epilogue kernel, the
Ozaki-II one (ladder fold, windows, fast2 unscale) of the const-scale
kernel.  A CPU tensor takes the kernels' plain versions, the same
operations as separate PyTorch calls.  The reference pads every operand
to the TPU's 128-lane tiles and takes its tile sizes from the planner;
the CUDA kernels mask their own ragged edges and own their tile sizes, so
nothing here pads — except :func:`flash_attention`, whose padding decides
what a fully masked row averages, and which pads as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core.accumulate import DF32, slice_group_gemm
from repro_torch.core.splitting import Split, _geo_scales, _global_base
from repro_torch.kernels import scale_accum as _sa
from repro_torch.kernels import split_fused as _sf

__all__ = ["split_fused", "split_fused_ref", "group_gemm",
           "scale_accum_update", "scale_accum_contraction",
           "oz2_scale_accum_update", "oz2_scale_accum_contraction",
           "oz2_unscale_update",
           "flash_attention"]

# fused-split mode -> the kernel's extraction mode
_KERNEL_MODE = {"bitmask": "bitmask", "oz2_bitmask": "bitmask",
                "oz2_bitmask_fast2": "bitmask", "rn_const": "rn_const",
                "oz2_rn": "rn_const", "oz2_rn_fast2": "rn_const", "sm": "sm"}


# the Ozaki-II constant-grid modes: one maximum per batch element
_GLOBAL = ("oz2_rn", "oz2_bitmask")


def _check_mode(mode: str) -> None:
    if mode not in _KERNEL_MODE:
        raise ValueError(f"fused splitting supports {sorted(_KERNEL_MODE)}"
                         f", got {mode!r}")


def _split(a, k, beta, mode, axis, plain: bool) -> Split:
    """The Split through the kernels' wrappers, or their plain versions
    (``plain``).  The constant-grid modes derive each batch element's
    maximum and grid here (``split_fused.grid``) and extract the digits on
    it; every other mode is one whole split."""
    _check_mode(mode)
    kmode = _KERNEL_MODE[mode]
    if mode in _GLOBAL:
        base, invgrid = _sf.grid(_global_base(a, axis, None), beta, kmode)
        extract = _sf.split_fused_ref if plain else _sf.split_fused
        digits = extract(a, invgrid, k=k, beta=beta, mode=kmode, axis=axis)
        return Split(digits, _geo_scales(base, beta, k), base, beta, axis,
                     gbase=base[..., 0])
    whole = _sf.split_whole_ref if plain else _sf.split_whole
    digits, scale, base, gbase = whole(a, k=k, beta=beta, mode=kmode,
                                       axis=axis,
                                       gbase=mode.endswith("_fast2"))
    return Split(digits, scale, base, beta, axis, gbase=gbase,
                 signmag=(mode == "sm"))


def split_fused(a: torch.Tensor, k: int, beta: int, *,
                mode: str = "rn_const", axis: int = 0) -> Split:
    """Fused splitting (Alg. 3 ``bitmask`` / Alg. 8 ``rn_const`` / the
    sign-magnitude ``sm`` / the oz2 constant-grid modes ``oz2_bitmask`` /
    ``oz2_rn`` and their fast2 twins): the same :class:`Split` as the
    library splitters, bit for bit, in ``a``'s own dtype.  ``a`` is
    ``(*batch, m, n)``; ``axis=1`` (column scales, for B) indexes the grid
    per column instead of transposing.

    On the card every per-row mode is ONE launch of the split kernel
    (``split_fused.split_whole``): no PyTorch operation runs around it.
    The plain oz2 modes broadcast the global maximum of each batch element
    onto the per-row reciprocal grid, which is bit-identical to the
    reference's constant-grid kernel; that grid is derived here and the
    digits come from the kernel.  The fast2 modes keep the per-row grids
    and attach ``gbase = 2`` (``splitting._with_fast2_gbase``).  A CPU
    tensor takes the plain versions (:func:`split_fused_ref`)."""
    return _split(a, k, beta, mode, axis, plain=False)


def split_fused_ref(a: torch.Tensor, k: int, beta: int, *,
                    mode: str = "rn_const", axis: int = 0) -> Split:
    """Plain version of :func:`split_fused` (on either device): the
    maxima, grid, digits and scales as separate PyTorch operations."""
    return _split(a, k, beta, mode, axis, plain=True)


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


def scale_accum_contraction(prods, groups, base_a: torch.Tensor,
                            base_b: torch.Tensor, beta: int, *,
                            partial: bool = False,
                            out_dtype=torch.float32):
    """``epilogue_fn`` hook of ``accumulate.matmul_group_ef`` (df32
    accumulator): the whole epilogue of a contraction, every chunk product
    ``prods`` with its group in ``groups``, through one launch of the
    epilogue kernel (``scale_accum.scale_accum_chunks``), bit-identical to
    the per-chunk plain epilogue and ``DF32.to_float``.  ``partial``
    returns the :class:`DF32` accumulator; an output dtype other than f32
    converts it here."""
    if partial or out_dtype != torch.float32:
        acc = DF32(*_sa.scale_accum_chunks(prods, groups, base_a, base_b,
                                           beta, partial=True))
        return acc if partial else acc.to_float(out_dtype)
    return _sa.scale_accum_chunks(prods, groups, base_a, base_b, beta)


def oz2_scale_accum_update(word: torch.Tensor, s: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """``scale_accum_fn`` hook of ``accumulate.matmul_oz2`` (f32/f64
    accumulators; the df32 one takes :func:`oz2_scale_accum_contraction`):
    one ladder window's convert+scale+add through the const-scale kernel,
    bit-identical to the plain epilogue.  On CUDA the accumulator is
    updated in place."""
    return _sa.scale_accum_const_plain(word, s, acc)


def oz2_scale_accum_contraction(prods, groups, c: int, beta: int,
                                gbase_a: torch.Tensor,
                                gbase_b: torch.Tensor, base_a=None,
                                base_b=None, *, partial: bool = False,
                                out_dtype=torch.float32):
    """``epilogue_fn`` hook of ``accumulate.matmul_oz2`` (df32
    accumulator): the whole epilogue of a contraction, the chunk products
    ``prods`` of groups ``groups`` folded into ladder windows of <= ``c``
    groups, every window's step and (given the fast2 bases) the unscale,
    through one launch of ``scale_accum.scale_accum_const_windows``,
    bit-identical to ``accumulate.oz2_df32_epilogue``.  ``partial``
    returns the :class:`DF32` accumulator; an output dtype other than f32
    converts it here."""
    if partial or out_dtype != torch.float32:
        acc = DF32(*_sa.scale_accum_const_windows(
            prods, groups, c, beta, gbase_a, gbase_b, base_a, base_b,
            partial=True))
        return acc if partial else acc.to_float(out_dtype)
    return _sa.scale_accum_const_windows(prods, groups, c, beta, gbase_a,
                                         gbase_b, base_a, base_b)


def oz2_unscale_update(acc: torch.Tensor, ra: torch.Tensor,
                       rb: torch.Tensor) -> torch.Tensor:
    """``unscale_fn`` hook of ``accumulate.matmul_oz2`` (fast2; f32/f64
    accumulators): the exact two-sided power-of-two unscale through the
    kernel."""
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
