"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
(sliding-window) MQA attention in the pattern (R, R, A) —
recurrentgemma-9b.  PyTorch port of ``repro.models.hybrid``.

The layers come in two kinds, so the parameters stack by *pattern block*
(``blocks/r_layers`` and ``blocks/r_mlps`` are stacked on two leading
axes, ``(n_pattern_blocks, n_r, ...)``; ``blocks/attn_layer`` on one); the
remaining R layers (38 = 12 x 3 + 2) form the tail.  The reference's scan
over blocks is a Python loop here (:func:`repro_torch.models.transformer.
layer_params` slices one block, then one R layer of it, frozen weights
included).

RG-LRU recurrence (Griffin eq. 4-6):
    r_t = sigmoid(W_a x_t + b_a)             # recurrence gate
    i_t = sigmoid(x_t + b_x)                 # input gate
    a_t = exp(-c softplus(Lambda) r_t)       # in (0, 1), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

``W_a`` (``lru_a``) is a plain f32 product, outside the engine, as in the
reference; every projection, the attention's two contractions and the tied
LM head run through the engine.  The cache keeps the reference's dtypes
leaf by leaf: bf16 conv windows and K/V ring buffers of ``min(max_len,
window)`` rows, f32 LRU states.  The blocks' conv windows are not cast
(under f32 activations the first step promotes them to f32, as the
reference's concatenation does); the tail's are cast up and back to bf16
every step.  Every cache update builds new tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, dense_param, init_stacked

_LRU_C = 8.0
_F32 = torch.float32


def _n_r(cfg: ModelConfig) -> int:
    return sum(1 for c in cfg.pattern if c == "R")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_recurrent_layer(cfg: ModelConfig, normal, zeros, lead,
                         generator: torch.Generator, device=None
                         ) -> Dict[str, Any]:
    """A stack (leading axes ``lead``) of recurrent layers with the
    reference's shapes and distributions; ``Lambda`` is drawn so that
    ``a^c`` lies in [0.9, 0.999] at r = 1 (Griffin's appendix)."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    u = torch.empty(tuple(lead) + (w,), dtype=_F32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=generator)
    return {
        "w_x": normal((d, w)),                  # conv branch in-projection
        "w_gate": normal((d, w)),               # gate branch (GELU)
        "conv_w": normal((4, w), 0.5),
        "conv_b": zeros((w,)),
        "lru_a": normal((w, w), w ** -0.5),     # W_a
        "lru_a_b": zeros((w,)),
        "lru_x_b": zeros((w,)),
        "lambda": torch.log(torch.expm1(-torch.log(u) / (2 * _LRU_C))),
        "w_out": normal((w, d), w ** -0.5),
        "ln": zeros((d,)),
    }


def _init_mlp_with_ln(cfg: ModelConfig, normal, zeros) -> Dict[str, Any]:
    return {"mlp": T.init_mlp(cfg, normal), "ln2": zeros((cfg.d_model,))}


def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scale rule
    (f32), drawn from ``generator`` on ``device``.  The LM head is tied:
    the logits contract ``embed.T``."""
    g, nb = generator, cfg.n_pattern_blocks
    nr, nt = (nb, _n_r(cfg)), max(cfg.n_tail_layers, 1)

    def stack(n, layer_init):
        return init_stacked(g, n, layer_init, device=device)

    return {
        "embed": dense_param(g, (cfg.padded_vocab, cfg.d_model), scale=1.0,
                             device=device),
        "blocks": {
            "r_layers": stack(nr, lambda normal, zeros: init_recurrent_layer(
                cfg, normal, zeros, nr, g, device)),
            "r_mlps": stack(nr, lambda normal, zeros: _init_mlp_with_ln(
                cfg, normal, zeros)),
            "attn_layer": stack(nb, lambda normal, zeros: T.init_dense_layer(
                cfg, normal, zeros)),
        },
        "tail_r": stack(nt, lambda normal, zeros: init_recurrent_layer(
            cfg, normal, zeros, (nt,), g, device)),
        "tail_m": stack(nt, lambda normal, zeros: _init_mlp_with_ln(
            cfg, normal, zeros)),
        "ln_f": torch.zeros((cfg.d_model,), dtype=_F32, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_coeffs(p, x):
    """Per-step log-decay and input: x (Bb, L, w) -> (log_a, v), both f32.
    ``x @ W_a`` is a full f32 product (never TF32), as the reference's."""
    xf = x.to(_F32)
    with L.ieee_f32_matmul():
        ra = torch.matmul(xf, p["lru_a"].to(_F32))
    r = torch.sigmoid(ra + p["lru_a_b"].to(_F32))
    i = torch.sigmoid(xf + p["lru_x_b"].to(_F32))
    log_a = -_LRU_C * F.softplus(p["lambda"].to(_F32)) * r
    a2 = torch.exp(2.0 * log_a)
    v = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, v


def rg_lru(p, x, h0: Optional[torch.Tensor] = None):
    """The diagonal linear recurrence h_t = a_t h_{t-1} + v_t over x (Bb,
    L, w) from h0 (Bb, w) or zeros.  Returns (h (Bb, L, w) in x's dtype,
    h_last f32).

    The reference runs ``lax.associative_scan`` in log space; this is a
    sequential scan, the order :func:`rg_lru_step` takes, and the two
    agree within the reference's own scan-vs-step tolerance (rtol 1e-4,
    atol 1e-5; ``tests/test_models.py``)."""
    log_a, v = _lru_coeffs(p, x)
    a = torch.exp(log_a)
    h = torch.zeros_like(v[:, 0]) if h0 is None else h0.to(_F32)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + v[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rg_lru_step(p, x1, h):
    """One step: x1 (Bb, w), h (Bb, w) -> (y in x1's dtype, h_new f32)."""
    log_a, v = _lru_coeffs(p, x1[:, None])
    h_new = torch.exp(log_a[:, 0]) * h.to(_F32) + v[:, 0]
    return h_new.to(x1.dtype), h_new


def recurrent_block(p, cfg: ModelConfig, x, *, conv_state=None,
                    lru_state=None):
    """The Griffin recurrent block over x (Bb, L, d): the whole sequence
    when ``conv_state`` is None, one decode step otherwise.  Returns (out,
    new_conv, new_lru)."""
    eng = cfg.engine
    Lq = x.shape[1]
    xn = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    branch = eng(xn, p["w_x"])
    gate = L.gelu(eng(xn, p["w_gate"]))
    conv_w = p["conv_w"].to(branch.dtype)
    new_conv = None
    if conv_state is None:
        acc = branch * conv_w[-1]
        for i in range(3):
            acc = acc + F.pad(branch, (0, 0, 3 - i, 0))[:, :Lq] * conv_w[i]
        conv_out = acc + p["conv_b"].to(acc.dtype)
        y, new_lru = rg_lru(p, conv_out, lru_state)
    else:
        # the reference's concatenation promotes a bf16 window to the
        # branch's dtype; a plain contraction, not the engine
        dt = torch.promote_types(conv_state.dtype, branch.dtype)
        window = torch.cat([conv_state.to(dt), branch.to(dt)], dim=1)
        acc = torch.einsum("btc,tc->bc", window, conv_w.to(dt))
        conv_out = acc + p["conv_b"].to(acc.dtype)
        y1, new_lru = rg_lru_step(p, conv_out, lru_state)
        y = y1[:, None]
        new_conv = window[:, 1:]
    return x + eng(y * gate, p["w_out"]), new_conv, new_lru


def _mlp(p, cfg: ModelConfig, x):
    xn = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + L.gelu_mlp(xn, p["mlp"]["w_up"], p["mlp"]["w_down"],
                          cfg.engine)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _block_fwd(bp, cfg: ModelConfig, x, cos, sin, caches=None,
               cur_len=None):
    """One (R, R, A) pattern block.  ``caches``: this block's ``conv``
    (n_r, ...), ``lru`` (n_r, ...), ``k`` and ``v``, or None for the whole
    sequence.  Returns (x, new caches or None)."""
    convs, lrus = [], []
    for i in range(_n_r(cfg)):
        x, conv_n, lru_n = recurrent_block(
            T.layer_params(bp["r_layers"], i), cfg, x,
            conv_state=caches["conv"][i] if caches else None,
            lru_state=caches["lru"][i] if caches else None)
        x = _mlp(T.layer_params(bp["r_mlps"], i), cfg, x)
        convs.append(conv_n)
        lrus.append(lru_n)
    ap = bp["attn_layer"]
    x, attn_new = T.attn_block(ap, cfg, x, cos, sin,
                               cache=(caches["k"], caches["v"])
                               if caches else None,
                               cur_len=cur_len, window=cfg.window)
    x = _mlp(ap, cfg, x)
    if not caches:
        return x, None
    return x, {"conv": torch.stack(convs), "lru": torch.stack(lrus),
               "k": attn_new[0], "v": attn_new[1]}


def _tail(params, cfg: ModelConfig, i: int):
    return (T.layer_params(params["tail_r"], i),
            T.layer_params(params["tail_m"], i))


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions=None) -> torch.Tensor:
    """tokens (B, L) -> logits (B, L, padded_vocab) f32 (tied head)."""
    B, Lq = tokens.shape
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(Lq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Lq)
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    x = T.scan_layers(lambda bp, x: _block_fwd(bp, cfg, x, cos, sin)[0],
                      params["blocks"], x, n_layers=cfg.n_pattern_blocks,
                      remat_block=cfg.remat_block)
    for i in range(cfg.n_tail_layers):
        rp, mp = _tail(params, cfg, i)
        x = _mlp(mp, cfg, recurrent_block(rp, cfg, x)[0])
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.logits_head(x, params["embed"].T, cfg.engine)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

_BLOCK_KEYS = ("conv", "lru", "k", "v")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The blocks' conv windows (bf16) and LRU states (f32), their K/V
    ring buffers of ``min(max_len, window)`` rows (bf16), and the tail's
    conv windows and LRU states."""
    w = cfg.lru_width or cfg.d_model
    nb, nt = cfg.n_pattern_blocks, max(cfg.n_tail_layers, 1)
    attn_len = min(max_len, cfg.window) if cfg.window else max_len
    bf16 = torch.bfloat16

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (nb, batch, attn_len, cfg.n_kv_heads, cfg.hd)
    return {"conv": zeros((nb, _n_r(cfg), batch, 3, w), bf16),
            "lru": zeros((nb, _n_r(cfg), batch, w), _F32),
            "k": zeros(kv, bf16), "v": zeros(kv, bf16),
            "tail_conv": zeros((nt, batch, 3, w), bf16),
            "tail_lru": zeros((nt, batch, w), _F32)}


def cache_axes(cfg: ModelConfig):
    return {
        "conv": ("layers", None, "cache_batch", None, "mlp"),
        "lru": ("layers", None, "cache_batch", "mlp"),
        "k": ("layers", "cache_batch", None, "cache_heads", "cache_hd"),
        "v": ("layers", "cache_batch", None, "cache_heads", "cache_hd"),
        "tail_conv": ("layers", "cache_batch", None, "mlp"),
        "tail_lru": ("layers", "cache_batch", "mlp"),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                cur_len):
    """One-token decode: tokens (B, 1) at position ``cur_len - 1``
    (a scalar or per slot).  Returns (logits (B, 1, vocab), new_cache)."""
    B = tokens.shape[0]
    cur_len = torch.as_tensor(cur_len, device=tokens.device)
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    pos = L.decode_positions(cur_len, B)
    cos, sin = L.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
    new = {k: [] for k in _BLOCK_KEYS}
    for b in range(cfg.n_pattern_blocks):
        x, nc = _block_fwd(T.layer_params(params["blocks"], b), cfg, x, cos,
                           sin, caches={k: cache[k][b] for k in _BLOCK_KEYS},
                           cur_len=cur_len)
        for k in _BLOCK_KEYS:
            new[k].append(nc[k])
    new = {k: torch.stack(v) for k, v in new.items()}
    tail_conv, tail_lru = [], []
    for i in range(cfg.n_tail_layers):
        rp, mp = _tail(params, cfg, i)
        x, conv_n, lru_n = recurrent_block(
            rp, cfg, x, conv_state=cache["tail_conv"][i].to(x.dtype),
            lru_state=cache["tail_lru"][i])
        x = _mlp(mp, cfg, x)
        tail_conv.append(conv_n.to(torch.bfloat16))
        tail_lru.append(lru_n)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.logits_head(x, params["embed"].T, cfg.engine)
    new["tail_conv"] = torch.stack(tail_conv) if tail_conv \
        else cache["tail_conv"]
    new["tail_lru"] = torch.stack(tail_lru) if tail_lru \
        else cache["tail_lru"]
    return logits, new
