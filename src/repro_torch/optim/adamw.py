"""AdamW — PyTorch port of ``repro.optim.adamw`` (single device).

Functional, as the reference: ``init(params, cfg) -> OptState`` and
``step(grads, params, state, cfg) -> (params, state, metrics)``, with the
reference's update written out by hand (``torch.optim.AdamW`` places eps
and the decay differently): gradients clipped by their global norm,
bias-corrected moments, the decay decoupled and applied to the f32 base
(the master copy when ``master_f32``), linear warmup then cosine decay to
``min_lr_frac``.  The reference's ZeRO-1 state sharding (``zero_axes``,
the ``state_axes`` hooks) comes with the distributed slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree

__all__ = ["OptConfig", "OptState", "init", "lr_at", "global_norm", "step"]

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


def init(params, cfg: OptConfig = OptConfig()) -> OptState:
    """Zero f32 moments (and the f32 master copy) on each parameter's
    device."""
    mu = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    nu = tree.tree_map(torch.clone, mu)
    master = (tree.tree_map(lambda p: p.to(torch.float32, copy=True), params)
              if cfg.master_f32 else None)
    device = tree.leaves(params)[0].device
    return OptState(mu, nu, master,
                    torch.zeros((), dtype=torch.int32, device=device))


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
def step(grads, params, state: OptState, cfg: OptConfig):
    """One AdamW update.  Returns (new_params, new_state, metrics)."""
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

    flat_p, treedef = tree.flatten(params)
    flat_g, flat_m, flat_v = (tree.leaves(t) for t in
                              (grads, state.mu, state.nu))
    flat_ma = (tree.leaves(state.master) if state.master is not None
               else [None] * len(flat_p))
    outs = [upd(g, p, m, v, ma) for g, p, m, v, ma in
            zip(flat_g, flat_p, flat_m, flat_v, flat_ma)]
    new_p, new_m, new_v = (tree.unflatten(treedef, [o[j] for o in outs])
                           for j in range(3))
    new_master = (tree.unflatten(treedef, [o[3] for o in outs])
                  if state.master is not None else None)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(new_m, new_v, new_master, count), metrics
