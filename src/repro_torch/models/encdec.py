"""Seamless-M4T-style encoder-decoder backbone (audio family) — PyTorch
port of ``repro.models.encdec``.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, frames, d_model).  Encoder: a
bidirectional self-attention stack with RoPE.  Decoder: causal
self-attention, cross-attention to the encoder output, then the MLP
(GELU for seamless-m4t-medium).  Serving decodes one token against the
decoder's K/V cache and the cross K/V projected once from the encoder
output (:func:`init_cache`), stored as bf16 and cast back to the
activation dtype every step, as the reference does.  Every projection and
attention contraction runs through the engine; the reference's scans over
the stacked layers are Python loops here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, dense_param, init_stacked


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_dec_layer(cfg: ModelConfig, normal, zeros) -> Dict[str, Any]:
    """One decoder layer: self-attention, cross-attention (``wk``/``wv``
    read the encoder output), the MLP and three norms."""
    d = cfg.d_model
    return {"self": T.init_attn(cfg, normal),
            "cross": T.init_attn(cfg, normal),
            "mlp": T.init_mlp(cfg, normal),
            "ln1": zeros((d,)), "ln_x": zeros((d,)), "ln2": zeros((d,))}


def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scale rule
    (f32), drawn from ``generator`` on ``device``."""
    d, g = cfg.d_model, generator
    return {
        "embed": dense_param(g, (cfg.padded_vocab, d), scale=1.0,
                             device=device),
        "enc_layers": init_stacked(g, cfg.enc_layers,
                                   lambda normal, zeros: T.init_dense_layer(
                                       cfg, normal, zeros), device=device),
        "dec_layers": init_stacked(g, cfg.n_layers,
                                   lambda normal, zeros: init_dec_layer(
                                       cfg, normal, zeros), device=device),
        "ln_enc": torch.zeros((d,), dtype=torch.float32, device=device),
        "ln_f": torch.zeros((d,), dtype=torch.float32, device=device),
        "lm_head": dense_param(g, (d, cfg.padded_vocab), device=device),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d_model) -> the normalized encoder output (B, F,
    d_model) in the activation dtype."""
    eng = cfg.engine
    B, F, _ = frames.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = frames.to(cfg.compute_dtype)
    positions = torch.arange(F, dtype=torch.int32,
                             device=frames.device).expand(B, F)
    cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)

    def body(lp, x):
        xn = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q = eng(xn, lp["attn"]["wq"]).reshape(B, F, H, hd)
        k = eng(xn, lp["attn"]["wk"]).reshape(B, F, KV, hd)
        v = eng(xn, lp["attn"]["wv"]).reshape(B, F, KV, hd)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        out = L.attention_flash(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk, engine=eng)
        x = x + eng(out.reshape(B, F, H * hd), lp["attn"]["wo"])
        return T.mlp_block(lp, cfg, x)

    x = T.scan_layers(body, params["enc_layers"], x,
                      n_layers=cfg.enc_layers, remat_block=cfg.remat_block)
    return L.rmsnorm(x, params["ln_enc"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def cross_kv(lp, cfg: ModelConfig, memory: torch.Tensor):
    """The cross K/V (B, Lk, KV, hd) of the encoder output ``memory`` (B,
    Lk, d) for decoder layer ``lp`` (no norm: ``encode`` normalized it)."""
    eng = cfg.engine
    B, Lk, _ = memory.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = eng(memory, lp["cross"]["wk"]).reshape(B, Lk, KV, hd)
    v = eng(memory, lp["cross"]["wv"]).reshape(B, Lk, KV, hd)
    return k, v


def _dec_layer(lp, cfg: ModelConfig, x, cos, sin, memory=None, *,
               self_cache=None, cross_kv_cache=None, cur_len=None):
    """Causal self-attention (on ``self_cache`` at decode), cross-attention
    to ``memory`` or to the precomputed ``cross_kv_cache``, then the MLP.
    Returns (x, the updated self K/V or None)."""
    x, new_kv = T.attn_block({"attn": lp["self"], "ln1": lp["ln1"]}, cfg, x,
                             cos, sin, cache=self_cache, cur_len=cur_len)
    eng = cfg.engine
    B, Lq, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xn = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    q = eng(xn, lp["cross"]["wq"]).reshape(B, Lq, H, hd)
    k, v = cross_kv(lp, cfg, memory) if cross_kv_cache is None \
        else cross_kv_cache
    out = L.attention_flash(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk, engine=eng)
    x = x + eng(out.reshape(B, Lq, H * hd), lp["cross"]["wo"])
    return T.mlp_block(lp, cfg, x), new_kv


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, positions=None) -> torch.Tensor:
    """Teacher-forced decode over the whole target: tokens (B, L), frames
    (B, F, d_model) -> logits (B, L, padded_vocab) f32."""
    memory = encode(params, cfg, frames)
    B, Lq = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(Lq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Lq)
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    x = T.scan_layers(lambda lp, x: _dec_layer(lp, cfg, x, cos, sin,
                                               memory)[0],
                      params["dec_layers"], x, n_layers=cfg.n_layers,
                      remat_block=cfg.remat_block)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.logits_head(x, params["lm_head"], cfg.engine)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               memory: Optional[torch.Tensor] = None, params=None,
               device=None):
    """The decoder's self K/V and the cross K/V, ``(n_layers, batch, L,
    KV, hd)`` bf16 each.  With ``memory`` (the encoder output, (batch, Lk,
    d)) and ``params`` the cross K/V are projected from it, layer by layer
    (the reference vmaps over the layers); otherwise they are zeros of
    ``max_len`` rows."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    if memory is not None:
        device = memory.device
    bf16 = torch.bfloat16
    shape = (cfg.n_layers, batch, max_len, KV, hd)
    cache = {"k": torch.zeros(shape, dtype=bf16, device=device),
             "v": torch.zeros(shape, dtype=bf16, device=device)}
    if memory is not None and params is not None:
        kvs = [cross_kv(T.layer_params(params["dec_layers"], i), cfg, memory)
               for i in range(cfg.n_layers)]
        cache["cross_k"] = torch.stack([k.to(bf16) for k, _ in kvs])
        cache["cross_v"] = torch.stack([v.to(bf16) for _, v in kvs])
    else:
        cache["cross_k"] = torch.zeros(shape, dtype=bf16, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=bf16, device=device)
    return cache


def cache_axes(cfg: ModelConfig):
    ax = ("layers", "cache_batch", None, "cache_heads", "cache_hd")
    return {"k": ax, "v": ax, "cross_k": ax, "cross_v": ax}


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
    for i in range(cfg.n_layers):
        x, (k_n, v_n) = _dec_layer(
            T.layer_params(params["dec_layers"], i), cfg, x, cos, sin,
            self_cache=(cache["k"][i], cache["v"][i]),
            cross_kv_cache=(cache["cross_k"][i].to(x.dtype),
                            cache["cross_v"][i].to(x.dtype)),
            cur_len=cur_len)
        ks.append(k_n)
        vs.append(v_n)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.logits_head(x, params["lm_head"], cfg.engine)
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    return logits, new_cache
