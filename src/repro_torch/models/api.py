"""Uniform model API across the seven families — PyTorch port of
``repro.models.api``.

    init(cfg, generator=..., device=...)   -> params
    forward(params, cfg, batch)            -> logits (B, L, vocab) f32
    init_cache(cfg, batch_size, max_len, params=None, ctx=None,
               device=None)                -> cache
    cache_axes(cfg)                        -> logical axes of the cache
    decode_step(params, cfg, cache, tokens, cur_len) -> (logits, cache)

``batch`` is a dict: ``tokens`` (B, L) always; ``image_embeds`` (B,
vision_seq, d) for the vlm family; ``frames`` (B, F, d) for encdec.
``ctx`` is the context the cache's cross K/V are projected from (the
patch embeddings for vlm, the encoder output for encdec; ``params`` then
required).  The shared next-token loss lives here too; every family
trains through it (``launch/steps.py``).
"""
from __future__ import annotations

import types
from typing import Any, Dict, Optional

import torch

from repro_torch.models import encdec, hybrid, moe, ssm, transformer, vlm
from repro_torch.models.common import ModelConfig

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "mla_moe": moe,
                   "vlm": vlm, "encdec": encdec, "ssm": ssm,
                   "hybrid": hybrid}


class Model(types.SimpleNamespace):
    pass


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES[cfg.family]

    def forward(params, cfg, batch: Dict[str, Any]):
        tokens = batch["tokens"]
        if cfg.family == "vlm":
            return mod.forward(params, cfg, tokens, batch["image_embeds"])
        if cfg.family == "encdec":
            return mod.forward(params, cfg, tokens, batch["frames"])
        return mod.forward(params, cfg, tokens)

    def init_cache(cfg, batch_size, max_len, params=None, ctx=None,
                   device=None):
        if cfg.family == "vlm":
            return mod.init_cache(cfg, batch_size, max_len,
                                  image_embeds=ctx, params=params,
                                  device=device)
        if cfg.family == "encdec":
            return mod.init_cache(cfg, batch_size, max_len, memory=ctx,
                                  params=params, device=device)
        return mod.init_cache(cfg, batch_size, max_len, device=device)

    return Model(init=mod.init, forward=forward, init_cache=init_cache,
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
