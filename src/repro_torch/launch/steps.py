"""The train step — PyTorch port of ``repro.launch.steps`` (training part).

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: the loss ``next_token_loss(forward(params, batch))`` and its
gradients by autograd (the emulated contractions differentiate through
``ozimmu``'s autograd Function, the attention through the flash recompute
backward, the layer stack in remat blocks), optionally over strided
microbatches accumulated in ``accum_dtype``, then one AdamW update.  Every
family trains: the MoE routing weights differentiate through ``topk``,
the dispatch and the combine (the expert choice itself, like the
reference's, is discrete), the SSD and RG-LRU scans through their plain
PyTorch operations, the vlm's gates and the encdec's encoder through the
same autograd.  A parameter the loss does not reach (the hybrid's
placeholder tail stack when a config has no tail layers) gets a zero
gradient, as ``jax.grad`` gives it.

Under a mesh (:mod:`repro_torch.launch.train` installs it) each rank takes
its share of the batch, rows split over the ``batch`` rule's axes
(``data``; the pipeline hands each rank its rows); the loss and every
gradient are averaged over those axes (:func:`collectives.pmean`: an f32
SUM, then a division by their size), and AdamW updates the ZeRO-1 slices
of its state (``opt_axes``) and gathers the parameters whole.  Ranks of
one ``model`` line take the same rows: an ``@model`` engine shards their
contractions.  A MoE arch with ``moe_dispatch="a2a"`` exchanges its
experts' tokens over ``data`` inside the loss; its gradient reaches the
rank that owns each expert, and the mean gives every rank the whole
batch's.  The reference's ``compress_pod_grads`` (int8 gradient
compression across the ``pod`` axis) raises: the reference declares it,
but its step never reads it.  The serve steps live in
:mod:`repro_torch.serving`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch import optim, tree
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import get_rules, rule_axes
from repro_torch.models import api
from repro_torch.models.common import ModelConfig

__all__ = ["TrainConfig", "TrainState", "init_state", "state_axes",
           "state_shardings", "loss_and_grads", "batch_mean",
           "make_train_step"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1             # gradient-accumulation chunks a step
    accum_dtype: str = "float32"      # grad accumulation buffer dtype
    compress_pod_grads: bool = False  # int8+EF all-reduce across "pod"


class TrainState(NamedTuple):
    params: Any
    opt: optim.OptState
    step: torch.Tensor                # int32 scalar


def state_axes(params, zero_divisor: int = 1):
    """The ZeRO-1 dims of ``params``' optimizer state
    (:func:`optim.zero_axes`) when sharding rules are active, as the
    reference shards its state only then; else None."""
    return optim.zero_axes(params, zero_divisor) if get_rules() else None


def init_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
               generator: torch.Generator, device=None,
               zero_divisor: int = 1) -> TrainState:
    """Random parameters from ``generator`` on ``device``, zero AdamW
    state (this rank's ZeRO-1 slices of it under a mesh that splits it:
    :func:`state_axes`), step 0."""
    params = api.get_model(cfg).init(cfg, generator=generator,
                                     device=device)
    return TrainState(params, optim.init(params, opt_cfg,
                                         state_axes(params, zero_divisor)),
                      torch.zeros((), dtype=torch.int32, device=device))


def state_shardings(state: TrainState, opt_axes):
    """The split dim of each leaf of ``state`` in flatten order (None for
    a whole leaf): ``opt_axes`` for the moments and the master copy, None
    elsewhere.  The checkpoint's ``shardings``."""
    n = len(tree.leaves(state.params))
    dims = list(opt_axes) if opt_axes is not None else [None] * n
    opt = dims * (3 if state.opt.master is not None else 2)
    return [None] * n + opt + [None, None]


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """``(loss, grads)`` of ``next_token_loss(forward(params, batch))``
    (the reference's ``jax.value_and_grad(loss_fn)``): the loss detached,
    the gradients a tree shaped like ``params`` (zeros where the loss
    does not reach a leaf)."""
    inputs = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    flat, treedef = tree.flatten(inputs)
    with torch.enable_grad():
        logits = api.get_model(cfg).forward(inputs, cfg, batch)
        loss = api.next_token_loss(logits, batch["tokens"])
        del logits
        grads = tree.unflatten(treedef, list(torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)))
    return loss.detach(), grads


def batch_mean(loss: torch.Tensor, grads):
    """The loss and gradients of this rank's rows averaged over the
    installed mesh's ``batch`` axes (one :func:`collectives.pmean` each):
    the whole batch's, every rank holding the same bits.  Unchanged
    without such axes."""
    axes = rule_axes("batch")[0]
    if not axes:
        return loss, grads
    return (collectives.pmean(loss, axes),
            tree.tree_map(lambda g: collectives.pmean(g, axes), grads))


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    tcfg: TrainConfig = TrainConfig(), opt_axes=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold ``loss``, ``grad_norm`` and ``lr`` as scalar tensors.  ``batch``
    holds this rank's rows; ``opt_axes`` are the ZeRO-1 dims the state
    was built with (:func:`state_axes`).  ``compress_pod_grads`` raises:
    the reference declares it, but its step never reads it."""
    if tcfg.compress_pod_grads:
        raise NotImplementedError("compress_pod_grads (int8 gradient "
                                  "compression across the pod axis): the "
                                  "reference declares the flag, but its "
                                  "step never reads it")
    acc_dt = _DTYPES[tcfg.accum_dtype]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        n_mb = tcfg.microbatches
        if n_mb == 1:
            loss, grads = loss_and_grads(cfg, state.params, batch)
        else:
            def split_mb(x, i):
                # STRIDED split, as the reference: microbatch i takes rows
                # i, i + n_mb, ... of the batch
                B = x.shape[0]
                assert B % n_mb == 0, (B, n_mb)
                return x.reshape(B // n_mb, n_mb, *x.shape[1:])[:, i]

            loss = None
            grads = tree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), state.params)
            for i in range(n_mb):
                mb = {k: split_mb(v, i) for k, v in batch.items()}
                mb_loss, mb_grads = loss_and_grads(cfg, state.params, mb)
                grads = tree.tree_map(lambda a, g: a + g.to(acc_dt), grads,
                                      mb_grads)
                del mb_grads
                loss = mb_loss if loss is None else loss + mb_loss
            loss = loss / n_mb
            grads = tree.tree_map(lambda g: g / n_mb, grads)
        loss, grads = batch_mean(loss, grads)
        new_params, new_opt, metrics = optim.step(grads, state.params,
                                                  state.opt, opt_cfg,
                                                  opt_axes)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
