"""AdamW with ZeRO-1 sharded optimizer state — PyTorch port of
``repro.optim.adamw``.

Functional, as the reference: ``init(params, cfg) -> OptState`` and
``step(grads, params, state, cfg) -> (params, state, metrics)``, with the
reference's update written out by hand (``torch.optim.AdamW`` places eps
and the decay differently): gradients clipped by their global norm,
bias-corrected moments, the decay decoupled and applied to the f32 base
(the master copy when ``master_f32``), linear warmup then cosine decay to
``min_lr_frac``.

ZeRO-1: the reference names, for each parameter, its largest unsharded
axis divisible by the ``zero`` mesh axes (``zero_axes``) and lets XLA
partition the moments (and the master copy) on it.  The port's models
carry no logical axes and every rank holds every parameter whole, so
:func:`zero_axes` works on shapes: the largest dim divisible by the
divisor (the first of equal ones), the dim the reference picks when no
logical axis maps to a mesh axis.  Given those ``state_axes`` under a
mesh whose ``zero`` rule spans more than one rank, ``mu``, ``nu`` and
``master`` hold this rank's slice of that dim only; :func:`step` clips by
the global norm of the whole gradients (which every rank holds, averaged),
updates its slices elementwise and gathers the new parameter slices over
the ``zero`` axes (one ``all_gather`` a parameter on each axis).  The
update being elementwise, the gathered parameters are bitwise the
unsharded update's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import rule_axes

__all__ = ["OptConfig", "OptState", "init", "lr_at", "global_norm", "step",
           "zero_axes", "zero_divisor", "zero_slice", "zero_gather"]

@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_f32: bool = False        # keep f32 master params


class OptState(NamedTuple):
    mu: Any
    nu: Any
    master: Optional[Any]
    count: torch.Tensor             # int32 scalar: updates taken


# ---------------------------------------------------------------------------
# ZeRO-1 dims
# ---------------------------------------------------------------------------

def zero_divisor(fallback: int = 1) -> int:
    """The number of ZeRO-1 shards: the product of the installed mesh's
    axes that the active ``zero`` rule names (``("data",)``, or ``("pod",
    "data")`` in the multi-pod tables), else ``fallback`` (the reference's
    ``zero_divisor`` argument, used when no mesh is installed)."""
    size = rule_axes("zero")[1]
    return size if size > 1 else fallback


def zero_axes(params, divisor: int) -> List[Optional[int]]:
    """For each leaf of ``params`` in flatten order, the dim its ZeRO-1
    state is split on: the largest dim divisible by the divisor (the
    first of equal ones), None where no dim is.  The divisor is
    :func:`zero_divisor` with ``divisor`` as the fallback, as the
    reference derives it."""
    n = zero_divisor(divisor)
    out = []
    for p in tree.leaves(params):
        best, best_dim = None, 0
        for i, size in enumerate(p.shape):
            if size % n == 0 and size > best_dim:
                best, best_dim = i, size
        out.append(best)
    return out


def zero_slice(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """This rank's ZeRO-1 slice of a whole ``x`` (a view): its share of
    ``dim`` over the installed mesh's ``zero`` axes; ``x`` itself where
    ``dim`` is None or the state is not split."""
    _, size, index = rule_axes("zero")
    if dim is None or size == 1:
        return x
    chunk = x.shape[dim] // size
    return x.narrow(dim, index * chunk, chunk)


def zero_gather(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The whole tensor of every rank's :func:`zero_slice` ``x`` (one
    ``all_gather`` on each ``zero`` axis); ``x`` itself where ``dim`` is
    None or the state is not split."""
    names, size, _ = rule_axes("zero")
    if dim is None or size == 1:
        return x
    return collectives.all_gather_cat(x, dim, names)


def init(params, cfg: OptConfig = OptConfig(),
         state_axes: Optional[List[Optional[int]]] = None) -> OptState:
    """Zero f32 moments (and the f32 master copy) on each parameter's
    device; with ``state_axes`` (:func:`zero_axes`) under a mesh that
    splits the state, this rank's slices of them only."""
    flat, treedef = tree.flatten(params)
    dims = state_axes if state_axes is not None else [None] * len(flat)
    own = [zero_slice(p, d) for p, d in zip(flat, dims)]
    mu = tree.unflatten(treedef, [torch.zeros(
        p.shape, dtype=torch.float32, device=p.device) for p in own])
    nu = tree.tree_map(torch.clone, mu)
    master = (tree.unflatten(treedef, [p.to(torch.float32, copy=True)
                                       for p in own])
              if cfg.master_f32 else None)
    return OptState(mu, nu, master,
                    torch.zeros((), dtype=torch.int32, device=flat[0].device))


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac`` (f32, as the
    reference).  The cosine is taken in f64 and rounded to f32: XLA's f32
    cosine is all but correctly rounded, PyTorch's f32 one is not."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (flatten order) of sum(g^2), in f32."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in tree.leaves(grads)))


@torch.no_grad()
def step(grads, params, state: OptState, cfg: OptConfig,
         state_axes: Optional[List[Optional[int]]] = None):
    """One AdamW update.  Returns (new_params, new_state, metrics).  With
    ``state_axes`` the state holds the slices :func:`init` gave it: each
    split leaf is updated on this rank's slice and gathered whole."""
    count = state.count + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, state.count)
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)

    def upd(g, p, m, v, master):
        g = g.to(torch.float32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        mhat = m / c1
        vhat = v / c2
        base = master if master is not None else p.to(torch.float32)
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * base)
        return new.to(p.dtype), m, v, new

    def zero_upd(g, p, m, v, master, dim):
        new_p, m, v, new = upd(zero_slice(g, dim), zero_slice(p, dim), m, v,
                               master)
        return zero_gather(new_p, dim), m, v, new

    flat_p, treedef = tree.flatten(params)
    flat_g, flat_m, flat_v = (tree.leaves(t) for t in
                              (grads, state.mu, state.nu))
    flat_ma = (tree.leaves(state.master) if state.master is not None
               else [None] * len(flat_p))
    dims = state_axes if state_axes is not None else [None] * len(flat_p)
    outs = [zero_upd(*leaf) for leaf in
            zip(flat_g, flat_p, flat_m, flat_v, flat_ma, dims)]
    new_p, new_m, new_v = (tree.unflatten(treedef, [o[j] for o in outs])
                           for j in range(3))
    new_master = (tree.unflatten(treedef, [o[3] for o in outs])
                  if state.master is not None else None)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(new_m, new_v, new_master, count), metrics
