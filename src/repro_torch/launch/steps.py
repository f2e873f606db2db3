"""The train step — PyTorch port of ``repro.launch.steps`` (training part).

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``: the loss ``next_token_loss(forward(params, batch))`` and its
gradients by autograd (the emulated contractions differentiate through
``ozimmu``'s autograd Function, the attention through the flash recompute
backward, the layer stack in remat blocks), optionally over strided
microbatches accumulated in ``accum_dtype``, then one AdamW update.  The
reference's int8 gradient compression across the ``pod`` axis and its
ZeRO-1 state sharding come with the distributed slice of the port; the
dense family trains, every other family raises naming what it lacks
(``_UNTRAINED``).  The serve steps live in :mod:`repro_torch.serving`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from repro_torch import optim, tree
from repro_torch.models import api
from repro_torch.models.common import ModelConfig

__all__ = ["TrainConfig", "TrainState", "init_state", "loss_and_grads",
           "make_train_step"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}

# what training each served family still lacks in the port
_UNTRAINED = {
    "moe": "its routing gradient and load-balance loss",
    "mla_moe": "its routing gradient and load-balance loss",
    "ssm": "the gradient of its chunked SSD scan, held to the reference's",
    "hybrid": "the gradients of its RG-LRU scan and windowed attention, "
              "held to the reference's",
    "vlm": "the data pipeline's patch-embedding input and the gradient of "
           "its gated cross-attention path, held to the reference's",
    "encdec": "the data pipeline's frame input and the gradient of its "
              "encoder and cross-attention path, held to the reference's",
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1             # gradient-accumulation chunks a step
    accum_dtype: str = "float32"      # grad accumulation buffer dtype
    compress_pod_grads: bool = False  # int8+EF all-reduce across "pod"


class TrainState(NamedTuple):
    params: Any
    opt: optim.OptState
    step: torch.Tensor                # int32 scalar


def init_state(cfg: ModelConfig, opt_cfg: optim.OptConfig,
               generator: torch.Generator, device=None) -> TrainState:
    """Random parameters from ``generator`` on ``device``, zero AdamW
    state, step 0."""
    params = api.get_model(cfg).init(cfg, generator=generator,
                                     device=device)
    return TrainState(params, optim.init(params, opt_cfg),
                      torch.zeros((), dtype=torch.int32, device=device))


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """``(loss, grads)`` of ``next_token_loss(forward(params, batch))``
    (the reference's ``jax.value_and_grad(loss_fn)``): the loss detached,
    the gradients a tree shaped like ``params``."""
    inputs = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    flat, treedef = tree.flatten(inputs)
    with torch.enable_grad():
        logits = api.get_model(cfg).forward(inputs, cfg, batch)
        loss = api.next_token_loss(logits, batch["tokens"])
        del logits
        grads = tree.unflatten(treedef, list(torch.autograd.grad(loss, flat)))
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold ``loss``, ``grad_norm`` and ``lr`` as scalar tensors."""
    if tcfg.compress_pod_grads:
        raise NotImplementedError("compress_pod_grads (int8 gradient "
                                  "compression across the pod axis) comes "
                                  "with the distributed slice of the port")
    if cfg.family != "dense":
        raise NotImplementedError(f"training the {cfg.family!r} family "
                                  f"({_UNTRAINED.get(cfg.family, 'its model')}"
                                  f") comes with a later slice of the port")
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
        new_params, new_opt, metrics = optim.step(grads, state.params,
                                                  state.opt, opt_cfg)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
