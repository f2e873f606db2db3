"""Uniform model API — PyTorch port of ``repro.models.api`` for the
families ported so far (dense, moe, mla_moe, ssm, hybrid).

    init(cfg, generator=..., device=...)   -> params
    forward(params, cfg, batch)            -> logits (B, L, vocab) f32
    init_cache(cfg, batch_size, max_len, device=None) -> cache
    cache_axes(cfg)                        -> logical axes of the cache
    decode_step(params, cfg, cache, tokens, cur_len) -> (logits, cache)

``batch`` is a dict with ``tokens`` (B, L).  The vlm and encdec families
(per-slot context) come with later slices of the port, and ``get_model``
raises for them until then.  The shared next-token loss lives here too;
of the ported families only the dense one trains (``launch/steps.py``
says what each other family lacks).
"""
from __future__ import annotations

import types
from typing import Any, Dict, Optional

import torch

from repro_torch.models import hybrid, moe, ssm, transformer
from repro_torch.models.common import ModelConfig

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "mla_moe": moe,
                   "ssm": ssm, "hybrid": hybrid}


class Model(types.SimpleNamespace):
    pass


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"the {cfg.family!r} family comes with a "
                                  f"later slice of the port")

    def forward(params, cfg, batch: Dict[str, Any]):
        return mod.forward(params, cfg, batch["tokens"])

    return Model(init=mod.init, forward=forward, init_cache=mod.init_cache,
                 cache_axes=mod.cache_axes, decode_step=mod.decode_step,
                 module=mod)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:].

    The gold logit is a masked sum over the (padded) vocab axis, as in the
    reference (its form keeps vocab-sharded logits sharded); ``mask``
    (B, L) weights the target positions ``mask[:, 1:]``."""
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab_iota == targets[..., None], logits,
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device)).sum(dim=-1)
    nll = logz - gold
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
