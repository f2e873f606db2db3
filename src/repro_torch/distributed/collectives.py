"""Error-free cross-rank reductions for the sharded Ozaki emulation —
PyTorch port of ``repro.distributed.collectives``.

When a contraction is sharded over a mesh axis, every rank holds a partial
product, and the cross-rank sum is exactly the kind of high-precision
matrix addition the paper's Alg. 6/7 works to minimize.  A plain float sum
would throw away the accuracy the scheme paid for, so:

  * :func:`pmax_scales` — the splitters' ``rowmax_reduce`` hook: every
    rank extracts its digits on the same power-of-two grid as the
    unsharded run.
  * :func:`psum_exact_int32` — the int32 slice/group products summed
    across ranks before any conversion: exact (the global-n bounds of eq.
    (4)/(12) hold every partial sum under 2^31), so the sharded emulation
    is bit-identical to the unsharded one.
  * :func:`psum_df32` / :func:`psum_compensated` — the partial high-
    precision accumulators (``partial=True``) gathered and folded in rank
    order with TwoSum, so every rank computes the same bits.

The data axis of training adds two more:

  * :func:`pmean` — the loss and the gradients of the ranks' shares of a
    batch, summed in f32 across the ``batch`` rule's axes and divided by
    their size, so every rank holds the same bits.
  * :func:`all_gather_cat` — the ZeRO-1 update's parameter slices,
    gathered and concatenated back into whole parameters.

The data axis of serving and the MoE expert exchange add two:

  * :func:`all_to_all` — equal blocks exchanged over one axis (the MoE
    dispatch and its return), differentiable: its backward is the reverse
    exchange of the cotangent.
  * :func:`all_gather_rows` — every batch rank's rows (the serving
    runtime's greedy tokens), concatenated in rank order.

Each takes the axis name(s) of the installed mesh
(:func:`repro_torch.distributed.compat.set_mesh`) and runs one collective
on each axis's process group, under a ``ozimmu/mesh/<name>`` phase scope;
:data:`COUNTS` counts the contraction collectives by function and
:data:`DATA_COUNTS` the data axis's.  On a gloo group a CUDA tensor is
staged through host memory by gloo itself, its all-to-all's too; a failed
collective raises.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.accumulate import DF32, _two_sum, df32_add_df
from repro_torch.core.splitting import ftz
from repro_torch.distributed import compat
from repro_torch.obs import tracing as _tracing

__all__ = ["psum_exact_int32", "psum_df32", "psum_compensated",
           "pmax_scales", "pmean", "all_gather_cat", "all_to_all",
           "all_gather_rows", "COUNTS", "DATA_COUNTS", "reset_counts"]

COUNTS: Dict[str, int] = {"pmax_scales": 0, "psum_exact_int32": 0,
                          "psum_df32": 0, "psum_compensated": 0}
DATA_COUNTS: Dict[str, int] = {"pmean": 0, "all_gather_cat": 0,
                               "all_to_all": 0, "all_gather_rows": 0}


def reset_counts() -> None:
    for counts in (COUNTS, DATA_COUNTS):
        for name in counts:
            counts[name] = 0


def _count(name: str) -> None:
    (COUNTS if name in COUNTS else DATA_COUNTS)[name] += 1


def _group(axis_name: str):
    """The process group of this rank's line along ``axis_name`` of the
    installed mesh, and the axis size."""
    mesh = compat.get_abstract_mesh()
    if mesh.empty or axis_name not in mesh.axis_names:
        raise ValueError(f"no installed mesh has an axis {axis_name!r} "
                         f"(installed: {mesh!r})")
    return mesh.group(axis_name), mesh.size(axis_name)


def _all_reduce(x: torch.Tensor, op, axis_name: str,
                name: str) -> torch.Tensor:
    """Reduce ``x`` across the axis in place (a strided ``x`` is copied
    first) and return it: the hooks hand over the fresh maxima or stacked
    products, which nothing else reads."""
    group, size = _group(axis_name)
    if size == 1:
        return x
    out = x.contiguous()
    with _tracing.phase_scope(f"mesh/{name}"):
        _count(name)
        dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, axis_name: str, name: str
                ) -> List[torch.Tensor]:
    """Every rank's ``x`` along the axis, in axis order."""
    group, size = _group(axis_name)
    x = x.contiguous()
    if size == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(size)]
    with _tracing.phase_scope(f"mesh/{name}"):
        _count(name)
        dist.all_gather(parts, x, group=group)
    return parts


def pmax_scales(v: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Elementwise max of per-row/col |a| maxima across the mesh axis.

    Used as the splitters' ``rowmax_reduce`` hook so every shard of a
    contraction-sharded operand extracts digits on the SAME power-of-two
    grid as the unsharded run — the precondition for summing INT32
    partials exactly (and for bitwise equality with the unsharded path).
    ``v`` is overwritten."""
    return _all_reduce(v, dist.ReduceOp.MAX, axis_name, "pmax_scales")


def psum_exact_int32(p: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Exact cross-rank sum of INT32 partial slice/group products.

    ``p`` may be a single product or the stacked ``(G, *batch, m, p)``
    tensor of all products of a GEMM (one collective for the whole
    scheme).  The no-overflow argument requires that the global
    contraction length was used for beta (eq. 4) and r (eq. 12) — the
    sharded engine path does this — so the sum of partials equals the
    unsharded INT32 product bit for bit.  ``p`` is overwritten."""
    if p.dtype != torch.int32:
        raise TypeError(f"psum_exact_int32 needs int32 partials, got "
                        f"{p.dtype}; float partials lose exactness")
    return _all_reduce(p, dist.ReduceOp.SUM, axis_name, "psum_exact_int32")


def psum_df32(c: DF32, axis_name: str) -> DF32:
    """Error-free sum of a DF32 (two-float) partial accumulator.

    Gathers both limbs (one collective of the stacked pair) and folds the
    per-rank partials with compensated double-float addition in rank
    order — deterministic and identical on every rank.  The result stays
    unevaluated (hi, lo); round once, at the end, via ``.to_float``."""
    parts = _all_gather(torch.stack([c.hi, c.lo]), axis_name, "psum_df32")
    acc = DF32(parts[0][0], parts[0][1])
    for part in parts[1:]:
        acc = df32_add_df(acc, DF32(part[0], part[1]))
    return acc


def psum_compensated(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Compensated sum of a plain float partial accumulator.

    For ``f64``/``f32`` partial accumulators: gather, then a Neumaier fold
    in rank order — the running error term absorbs what each addition
    rounds away and is added back once at the end (each operation
    flushed, as the reference's arithmetic)."""
    parts = _all_gather(x, axis_name, "psum_compensated")
    s = parts[0]
    e = torch.zeros_like(s)
    for part in parts[1:]:
        s, err = _two_sum(s, part)
        e = ftz(e + err)
    return ftz(s + e)


def pmean(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The mean of ``x`` across the ranks of ``axes`` (the data-parallel
    axes, :func:`repro_torch.distributed.sharding.rule_axes`): an f32 SUM
    on each axis's group in turn, then one division by their product.
    Every rank gets the same bits (an all-reduce hands each rank the one
    reduced value).  ``x`` is overwritten when it is f32 and contiguous."""
    out = x.to(torch.float32)
    size = 1
    for axis in axes:
        out = _all_reduce(out, dist.ReduceOp.SUM, axis, "pmean")
        size *= _group(axis)[1]
    return out / size if size > 1 else out


def all_gather_cat(x: torch.Tensor, dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated on ``dim`` in the
    ranks' row-major order over ``axes`` (the first axis outermost): the
    innermost axis is gathered first, so each later gather joins whole
    blocks.  Undoes a split of ``dim`` into that many equal slices."""
    for axis in reversed(tuple(axes)):
        parts = _all_gather(x, axis, "all_gather_cat")
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return x


def _exchange(x: torch.Tensor, axis: str) -> torch.Tensor:
    """One ``all_to_all_single`` of ``x``'s equal leading blocks over the
    axis: block j of this rank goes to rank j, and block i of the result
    came from rank i."""
    group = _group(axis)[0]
    x = x.contiguous()
    out = torch.empty_like(x)
    with _tracing.phase_scope("mesh/all_to_all"):
        _count("all_to_all")
        dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The exchange of equal blocks; the cotangent takes the same
    exchange back (the block permutation is its own inverse)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Exchange ``x``'s leading dim, split into one equal block a rank of
    ``axis``: rank r sends its block j to rank j and receives rank i's
    block r as its block i (``lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=False)`` on a ``(size, ...)`` array).
    Differentiable; one collective a call, forward or backward."""
    size = _group(axis)[1]
    if x.shape[0] % size:
        raise ValueError(f"all_to_all over {axis!r} ({size} ranks) needs a "
                         f"leading dim divisible by it, got {tuple(x.shape)}")
    if size == 1:
        return x
    return _AllToAll.apply(x, axis)


def all_gather_rows(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Every rank's int32 rows along ``axes`` (one or two batch axes, in
    mesh order), concatenated on dim 0 in the ranks' row-major order over
    ``axes``: the innermost axis is gathered first.  Counted once a
    call."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_gather_rows gathers int32 rows, got {x.dtype}")
    if not axes:
        return x
    out = x.contiguous()
    with _tracing.phase_scope("mesh/all_gather_rows"):
        _count("all_gather_rows")
        for axis in reversed(tuple(axes)):
            group, size = _group(axis)
            if size > 1:
                parts = [torch.empty_like(out) for _ in range(size)]
                dist.all_gather(parts, out, group=group)
                out = torch.cat(parts, 0)
    return out
