"""INT8 gradient compression with error feedback — PyTorch port of
``repro.optim.compress``.

The Ozaki splitting (Alg. 8, rn_const) is a deterministic int8 quantizer
with a power-of-two, row-wise scale: slice 1 of a k = 1 split is the
round-to-nearest int8 digit matrix.  :func:`compress` quantizes a gradient
with it and carries the residual (the paper's V_k) to the next step as
error feedback; :func:`compressed_psum` all-reduces gradients across a
mesh axis that way: the row scales agreed by a max across the axis, the
digits re-quantized against them and summed exactly in int32, the sum
scaled back and divided by the axis size.

The reference declares ``TrainConfig.compress_pod_grads`` but its train
step never reads it; the port's step raises on it
(:mod:`repro_torch.launch.steps`).  This module is the library, as the
reference's is.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.core import splitting
from repro_torch.core.splitting import ftz
from repro_torch.distributed import collectives

__all__ = ["CompressState", "init_state", "compress", "decompress",
           "compressed_psum"]


class CompressState(NamedTuple):
    """Per-parameter error-feedback residuals (same tree as params)."""
    residual: torch.Tensor


def init_state(grads):
    """Zero f32 residuals shaped like ``grads``."""
    return tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)


def _as_2d(g: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    shape = tuple(g.shape)
    if g.ndim == 1:
        return g.reshape(1, -1), shape
    return g.reshape(-1, shape[-1]), shape


def _fed_back(g: torch.Tensor, err: torch.Tensor):
    """``g + err`` in f32, as rows: ``(x, shape)``."""
    return _as_2d(ftz(g.to(torch.float32) + err.to(torch.float32)))


def compress(g: torch.Tensor, err: torch.Tensor):
    """g + err -> (int8 digits, f32 row scales, new residual): a k = 1
    rn_const split."""
    x, shape = _fed_back(g, err)
    sp = splitting.split_rn_const(x, 1, axis=0)
    recon = splitting.reconstruct(sp, torch.float32)
    new_err = ftz(x - recon).reshape(shape)
    return sp.digits[0], sp.scale[0], new_err


def decompress(digits: torch.Tensor, scale: torch.Tensor,
               shape) -> torch.Tensor:
    out = ftz(digits.to(torch.float32) * scale[:, None])
    return out.reshape(shape)


def compressed_psum(grads, err_tree, axis_name: str):
    """All-reduce ``grads`` over ``axis_name`` of the installed mesh in int8
    digits and f32 row scales.  Returns ``(mean_grads, new_err_tree)``.

    Each leaf: quantize with error feedback, agree the power-of-two row
    scales by a max across the axis (:func:`collectives.pmax_scales`),
    re-quantize against them (the digits stay int8-safe: ``|x| <= rowmax
    <= scale * 2^(beta-1)``), sum the digits exactly in int32
    (:func:`collectives.psum_exact_int32`) and rescale by the scale over
    the axis size: two collectives a leaf, identical bits on every rank."""
    size = collectives._group(axis_name)[1]

    def one(g, err):
        x, shape = _fed_back(g, err)
        sp = splitting.split_rn_const(x, 1, axis=0)
        scale = collectives.pmax_scales(sp.scale[0], axis_name)[:, None]
        d = torch.round(x / scale).to(torch.int32)
        total = collectives.psum_exact_int32(d.clone(), axis_name)
        mean = ftz(ftz(total.to(torch.float32) * scale) / size)
        new_err = ftz(x - ftz(d.to(torch.float32) * scale))
        return mean.reshape(shape), new_err.reshape(shape)

    flat_g, treedef = tree.flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, tree.leaves(err_tree))]
    return (tree.unflatten(treedef, [o[0] for o in outs]),
            tree.unflatten(treedef, [o[1] for o in outs]))
