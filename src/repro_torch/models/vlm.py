"""Llama-3.2-Vision-style VLM backbone: a dense GQA decoder with gated
cross-attention layers interleaved every ``cross_every`` layers (40 = 8 x
(4 self + 1 cross) for llama-3.2-vision-11b).  PyTorch port of
``repro.models.vlm``.

The modality frontend is a stub, as in the reference: the model takes
precomputed patch embeddings (B, vision_seq, d_model) as its
cross-attention memory.  The parameters stack by *group*: ``groups/selfs``
on two leading axes ``(n_groups, cross_every - 1, ...)``, ``groups/cross``
on one.  The reference's scans over groups and over a group's self layers
are Python loops here (:func:`repro_torch.models.transformer.layer_params`
slices one group, then one self layer of it, frozen weights included).

Every projection and both attention contractions run through the engine.
The gates ``gate_attn`` / ``gate_mlp`` scale the cross layer's two
residual branches by their ``tanh``; the reference initializes them to
zero, so a freshly initialized cross layer is the identity.  The decode
cache holds each group's self-attention K/V and the cross K/V of the
context, computed once (:func:`init_cache`) and stored as bf16 whatever
the activation dtype, cast back to it every decode step, as the
reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, dense_param, init_stacked


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_cross_layer(cfg: ModelConfig, normal, zeros) -> Dict[str, Any]:
    """One gated cross-attention layer: GQA projections (``wk``/``wv``
    read the memory), the MLP, three norms and the two scalar gates
    (zero, as in the reference)."""
    d = cfg.d_model
    return {"attn": T.init_attn(cfg, normal), "mlp": T.init_mlp(cfg, normal),
            "ln1": zeros((d,)), "ln2": zeros((d,)), "ln_kv": zeros((d,)),
            "gate_attn": zeros(()), "gate_mlp": zeros(())}


def init_group(cfg: ModelConfig, generator: torch.Generator, n_groups: int,
               device=None) -> Dict[str, Any]:
    """``n_groups`` stacked groups of ``cross_every - 1`` self layers
    (stacked ``(n_groups, cross_every - 1, ...)``) and one cross layer."""
    n_self = cfg.cross_every - 1
    return {
        "selfs": init_stacked(generator, (n_groups, n_self),
                              lambda normal, zeros: T.init_dense_layer(
                                  cfg, normal, zeros), device=device),
        "cross": init_stacked(generator, n_groups,
                              lambda normal, zeros: init_cross_layer(
                                  cfg, normal, zeros), device=device),
    }


def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scale rule
    (f32), drawn from ``generator`` on ``device``."""
    if cfg.n_layers % cfg.cross_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"cross_every {cfg.cross_every}")
    d, g = cfg.d_model, generator
    return {
        "embed": dense_param(g, (cfg.padded_vocab, d), scale=1.0,
                             device=device),
        "groups": init_group(cfg, g, _n_groups(cfg), device=device),
        "ln_f": torch.zeros((d,), dtype=torch.float32, device=device),
        "lm_head": dense_param(g, (d, cfg.padded_vocab), device=device),
    }


# ---------------------------------------------------------------------------
# cross-attention block
# ---------------------------------------------------------------------------

def cross_kv(p, cfg: ModelConfig, memory: torch.Tensor):
    """The cross K/V of ``memory`` (B, Lv, d) for one cross layer ``p``:
    ``(k, v)`` (B, Lv, KV, hd), each an engine projection of the
    ``ln_kv``-normalized memory."""
    eng = cfg.engine
    B, Lv, _ = memory.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    mn = L.rmsnorm(memory, p["ln_kv"], cfg.norm_eps)
    k = eng(mn, p["attn"]["wk"]).reshape(B, Lv, KV, hd)
    v = eng(mn, p["attn"]["wv"]).reshape(B, Lv, KV, hd)
    return k, v


def cross_block(p, cfg: ModelConfig, x, memory, *, kv_cache=None):
    """Gated cross-attention against the memory (B, Lv, d), then the gated
    MLP.  ``kv_cache``: precomputed ``(k, v)`` (decode), else they are
    projected from ``memory``."""
    eng = cfg.engine
    B, Lq, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xn = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = eng(xn, p["attn"]["wq"]).reshape(B, Lq, H, hd)
    k, v = cross_kv(p, cfg, memory) if kv_cache is None else kv_cache
    out = L.attention_flash(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk, engine=eng)
    out = eng(out.reshape(B, Lq, H * hd), p["attn"]["wo"])
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
    xn2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    mlp_out = L.swiglu(xn2, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], eng)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * mlp_out


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def _group_fwd(gp, cfg: ModelConfig, x, cos, sin, memory, *,
               self_cache=None, cross_kv_cache=None, cur_len=None):
    """One group: its self layers (whole sequence, or one decode step on
    ``self_cache`` = (k, v) stacks of the group), then its cross layer.
    Returns (x, the updated (k, v) stacks or None)."""
    n_self = cfg.cross_every - 1
    new_kv = None
    if self_cache is None:
        x = T.scan_layers(lambda lp, xc: T.dense_layer(lp, cfg, xc, cos,
                                                        sin)[0],
                          gp["selfs"], x, n_layers=n_self)
    else:
        ks, vs = [], []
        for j in range(n_self):
            x, (kc, vc) = T.dense_layer(
                T.layer_params(gp["selfs"], j), cfg, x, cos, sin,
                cache=(self_cache[0][j], self_cache[1][j]), cur_len=cur_len)
            ks.append(kc)
            vs.append(vc)
        new_kv = (torch.stack(ks), torch.stack(vs))
    x = cross_block(gp["cross"], cfg, x, memory, kv_cache=cross_kv_cache)
    return x, new_kv


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            image_embeds: torch.Tensor, positions=None) -> torch.Tensor:
    """tokens (B, L), image_embeds (B, vision_seq, d_model) -> logits (B,
    L, padded_vocab) f32."""
    B, Lq = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    memory = image_embeds.to(cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(Lq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Lq)
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    x = T.scan_layers(lambda gp, x: _group_fwd(gp, cfg, x, cos, sin,
                                               memory)[0],
                      params["groups"], x, n_layers=_n_groups(cfg),
                      remat_block=cfg.remat_block)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.logits_head(x, params["lm_head"], cfg.engine)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               image_embeds: Optional[torch.Tensor] = None, params=None,
               device=None):
    """Each group's self-attention K/V (``(groups, cross_every - 1, batch,
    max_len, KV, hd)``) and the cross K/V (``(groups, batch, Lv, KV,
    hd)``), all bf16.  With ``image_embeds`` (batch, Lv, d) the cross K/V
    are projected from it through ``params``, group by group (the
    reference vmaps over the groups; the projections are the same per
    group); without it they are zeros of ``vision_seq`` rows."""
    ng, n_self = _n_groups(cfg), cfg.cross_every - 1
    KV, hd = cfg.n_kv_heads, cfg.hd
    if image_embeds is not None:
        device = image_embeds.device
    bf16 = torch.bfloat16
    shape = (ng, n_self, batch, max_len, KV, hd)
    cache = {"k": torch.zeros(shape, dtype=bf16, device=device),
             "v": torch.zeros(shape, dtype=bf16, device=device)}
    if image_embeds is not None:
        memory = image_embeds.to(cfg.compute_dtype)
        kvs = [cross_kv(T.layer_params(params["groups"], g)["cross"], cfg,
                        memory) for g in range(ng)]
        cache["cross_k"] = torch.stack([k.to(bf16) for k, _ in kvs])
        cache["cross_v"] = torch.stack([v.to(bf16) for _, v in kvs])
    else:
        cshape = (ng, batch, cfg.vision_seq, KV, hd)
        cache["cross_k"] = torch.zeros(cshape, dtype=bf16, device=device)
        cache["cross_v"] = torch.zeros(cshape, dtype=bf16, device=device)
    return cache


def cache_axes(cfg: ModelConfig):
    return {
        "k": ("layers", None, "cache_batch", None, "cache_heads", "cache_hd"),
        "v": ("layers", None, "cache_batch", None, "cache_heads", "cache_hd"),
        "cross_k": ("layers", "cache_batch", None, "cache_heads", None),
        "cross_v": ("layers", "cache_batch", None, "cache_heads", None),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                cur_len):
    """One-token decode: tokens (B, 1) at position ``cur_len - 1`` (a
    scalar or per slot).  The cross K/V are read, never written.  Returns
    (logits (B, 1, vocab), new_cache)."""
    B = tokens.shape[0]
    cur_len = torch.as_tensor(cur_len, device=tokens.device)
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    pos = L.decode_positions(cur_len, B)
    cos, sin = L.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    for g in range(_n_groups(cfg)):
        x, (k_n, v_n) = _group_fwd(
            T.layer_params(params["groups"], g), cfg, x, cos, sin, None,
            self_cache=(cache["k"][g], cache["v"][g]),
            cross_kv_cache=(cache["cross_k"][g].to(x.dtype),
                            cache["cross_v"][g].to(x.dtype)),
            cur_len=cur_len)
        ks.append(k_n)
        vs.append(v_n)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.logits_head(x, params["lm_head"], cfg.engine)
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    return logits, new_cache
