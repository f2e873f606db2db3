"""Dense decoder-only transformer (GQA + RoPE), forward and decode —
PyTorch port of ``repro.models.transformer``.

Parameters keep the reference's layout: one dict whose ``"layers"`` leaves
are stacked along a leading layer axis, ``(n_layers, ...)``.  The
reference's ``lax.scan`` over that axis is a Python loop here
(:func:`layer_params` slices one layer), and its remat blocks are
``torch.utils.checkpoint`` blocks of ``cfg.remat_block`` layers
(:func:`scan_layers`).  The reference's ``expand_kv`` replicates KV heads
for sharding only and has no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import PresplitWeight
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, dense_param,
                                       init_stacked)
from repro_torch.tree import leaves as tree_leaves


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, normal) -> Dict[str, Any]:
    """GQA projection weights; ``normal(shape, scale=None)`` draws a leaf
    (see :func:`repro_torch.models.common.init_stacked`)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": normal((d, H * hd)), "wk": normal((d, KV * hd)),
            "wv": normal((d, KV * hd)),
            "wo": normal((H * hd, d), (H * hd) ** -0.5)}


def init_mlp(cfg: ModelConfig, normal,
             d_ff: Optional[int] = None) -> Dict[str, Any]:
    """SwiGLU (or, with ``mlp_type="gelu"``, GELU) weights of width
    ``d_ff`` (default ``cfg.d_ff``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "gelu":
        return {"w_up": normal((d, f)), "w_down": normal((f, d), f ** -0.5)}
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
    return {"w_gate": normal((d, f)), "w_up": normal((d, f)),
            "w_down": normal((f, d), f ** -0.5)}


def init_dense_layer(cfg: ModelConfig, normal, zeros) -> Dict[str, Any]:
    """One attention + MLP layer (``normal``/``zeros`` as
    :func:`repro_torch.models.common.init_stacked` hands them)."""
    d = cfg.d_model
    return {"attn": init_attn(cfg, normal), "mlp": init_mlp(cfg, normal),
            "ln1": zeros((d,)), "ln2": zeros((d,))}


def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and ``dense_param``
    scale rule, drawn from ``generator`` on ``device`` (f32 weights)."""
    d, g = cfg.d_model, generator
    return {
        "embed": dense_param(g, (cfg.padded_vocab, d), scale=1.0,
                             device=device),
        "layers": init_stacked(g, cfg.n_layers,
                               lambda normal, zeros: init_dense_layer(
                                   cfg, normal, zeros), device=device),
        "ln_f": torch.zeros((d,), dtype=torch.float32, device=device),
        "lm_head": dense_param(g, (d, cfg.padded_vocab), device=device),
    }


def layer_params(stacked, i: int):
    """Layer ``i`` of the stacked ``"layers"`` tree (tensors and
    :class:`PresplitWeight` wrappers alike)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if isinstance(stacked, PresplitWeight):
        return stacked.layer(i)
    return stacked[i]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def attn_block(p, cfg: ModelConfig, x, cos, sin, *, cache=None,
               cur_len=None, window=None):
    """Pre-norm GQA attention.  cache=(k, v) (B, Lmax, KV, hd) -> decode;
    returns (x + attn, new_cache)."""
    eng = cfg.engine
    B, Lq, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = eng(xn, p["attn"]["wq"]).reshape(B, Lq, H, hd)
    k = eng(xn, p["attn"]["wk"]).reshape(B, Lq, KV, hd)
    v = eng(xn, p["attn"]["wv"]).reshape(B, Lq, KV, hd)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    new_cache = None
    if cache is None:
        out = L.attention_flash(q, k, v, causal=True, window=window,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                engine=eng)
    else:
        kc, vc = cache
        cache_len = kc.shape[1]
        valid_len = torch.clamp(torch.as_tensor(cur_len, device=x.device),
                                max=cache_len)
        kc = L.cache_update_row(kc, k, cur_len)
        vc = L.cache_update_row(vc, v, cur_len)
        new_cache = (kc, vc)
        out = L.attention_decode(q, kc, vc, valid_len, window=None,
                                 engine=eng)
    out = eng(out.reshape(B, Lq, H * hd), p["attn"]["wo"])
    return x + out, new_cache


def mlp_block(p, cfg: ModelConfig, x):
    xn = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.mlp_type == "gelu":
        out = L.gelu_mlp(xn, p["mlp"]["w_up"], p["mlp"]["w_down"],
                         cfg.engine)
    else:
        out = L.swiglu(xn, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], cfg.engine)
    return x + out


def dense_layer(p, cfg, x, cos, sin, cache=None, cur_len=None):
    x, new_cache = attn_block(p, cfg, x, cos, sin, cache=cache,
                              cur_len=cur_len, window=cfg.window)
    return mlp_block(p, cfg, x), new_cache


# ---------------------------------------------------------------------------
# layer stack with remat blocks
# ---------------------------------------------------------------------------

def _unbind(t):
    if isinstance(t, dict):
        return {k: _unbind(v) for k, v in t.items()}
    return t.unbind(0)


def scan_layers(body, stacked, x, *, n_layers: int, remat_block: int = 1):
    """``x = body(layer_params, x)`` over the stacked layers in order (the
    reference's ``scan_layers``).  When autograd records through the
    layers (grad enabled and a layer parameter requiring grad), every
    block of ``remat_block`` layers runs under non-reentrant
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    blocks: the block keeps only its input, and the backward recomputes
    its forward, kernels included.  The stacks are unbound once, so the
    backward stacks each leaf's layer gradients once (the gradient of a
    slice would add a zero-filled copy of the whole stack a layer)."""
    def block(x, lo, hi):
        for i in range(lo, hi):
            x = body(layer_params(stacked, i), x)
        return x

    if not (torch.is_grad_enabled() and
            any(isinstance(t, torch.Tensor) and t.requires_grad
                for t in tree_leaves(stacked))):
        return block(x, 0, n_layers)
    rb = max(1, remat_block)
    assert n_layers % rb == 0, (n_layers, rb)
    stacked = _unbind(stacked)
    for lo in range(0, n_layers, rb):
        x = checkpoint(block, x, lo, lo + rb, use_reentrant=False)
    return x


# ---------------------------------------------------------------------------
# full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, L) -> logits (B, L, padded_vocab) f32."""
    return run_forward(params, cfg, tokens, positions, dense_layer)


def run_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: Optional[torch.Tensor], layer, *,
                rope_dim: Optional[int] = None) -> torch.Tensor:
    """The full-sequence forward of a decoder stack whose layer is
    ``layer(p, cfg, x, cos, sin)``, through :func:`scan_layers` with
    ``cfg.remat_block``.  RoPE rotates ``rope_dim`` features (default
    ``cfg.hd``; MLA rotates its rope head dim)."""
    B, Lq = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(Lq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Lq)
    cos, sin = L.rope_cos_sin(positions, rope_dim or cfg.hd, cfg.rope_theta)
    x = scan_layers(lambda lp, x: layer(lp, cfg, x, cos, sin)[0],
                    params["layers"], x, n_layers=cfg.n_layers,
                    remat_block=cfg.remat_block)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.logits_head(x, params["lm_head"], cfg.engine)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    KV, hd = cfg.n_kv_heads, cfg.hd
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, cache_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def cache_axes(cfg: ModelConfig):
    ax = ("layers", "cache_batch", None, "cache_heads", "cache_hd")
    return {"k": ax, "v": ax}


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                cur_len):
    """One-token decode: tokens (B, 1) at absolute position cur_len - 1;
    ``cur_len`` a scalar or a (B,) vector (per slot).  Returns (logits
    (B, 1, vocab), new_cache)."""
    return run_decode(params, cfg, cache, tokens, cur_len, dense_layer)


def run_decode(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
               cur_len, layer, *, rope_dim: Optional[int] = None,
               cache_keys: Tuple[str, ...] = ("k", "v")):
    """:func:`decode_step` of a decoder stack whose layer is ``layer(p,
    cfg, x, cos, sin, cache=(...), cur_len=...)``, handed layer ``i`` of
    the cache stacks ``cache_keys`` in that order (the K/V stacks by
    default) and returning them updated in the same order.  RoPE rotates
    ``rope_dim`` features (default ``cfg.hd``)."""
    B = tokens.shape[0]
    cur_len = torch.as_tensor(cur_len, device=tokens.device)
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    pos = L.decode_positions(cur_len, B)
    cos, sin = L.rope_cos_sin(pos, rope_dim or cfg.hd, cfg.rope_theta)
    new = {name: [] for name in cache_keys}
    for i in range(cfg.n_layers):
        x, leaves = layer(layer_params(params["layers"], i), cfg, x, cos,
                          sin, cache=tuple(cache[name][i]
                                           for name in cache_keys),
                          cur_len=cur_len)
        for name, leaf in zip(cache_keys, leaves):
            new[name].append(leaf)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.logits_head(x, params["lm_head"], cfg.engine)
    return logits, {name: torch.stack(v) for name, v in new.items()}
