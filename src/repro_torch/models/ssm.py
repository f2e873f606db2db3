"""Mamba2 (SSD, the state-space duality form): mamba2-780m — PyTorch port
of ``repro.models.ssm``.

The SSD form computes the selective state-space recurrence as chunked
products (an intra-chunk quadratic term and an inter-chunk state carry);
its two projections (``w_in``, ``w_out``) and the tied LM head run through
the model's engine, every other operation is plain PyTorch, as in the
reference.

``decode_step(params, cfg, cache, tokens, cur_len)`` keeps a
constant-size cache a slot: the bf16 conv window ``(L, B, d_conv - 1,
conv_dim)`` and the f32 SSM state ``(L, B, H, P, N)``.  ``cur_len`` is not
read: a recurrent state integrates every position it is fed, which is why
the serving runtime groups this family's prefills by exact length.  Every
cache update builds new tensors; none writes its input in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, dense_param, init_stacked

_F32 = torch.float32


def _dims(cfg: ModelConfig):
    d_inner = cfg.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return d_inner, n_heads, cfg.ssm_headdim, cfg.d_state


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_mamba_layer(cfg: ModelConfig, normal, zeros, n: int,
                     generator: torch.Generator, device=None
                     ) -> Dict[str, Any]:
    """A stack of ``n`` Mamba2 layers with the reference's shapes and
    distributions: ``A_log = log(linspace(1, 16, H))`` in every layer,
    ``dt_bias`` the softplus inverse of ``exp(U(0, 1) * 3 - 4.6)`` (steps
    of ~1e-3 to 1e-1), ``D`` ones."""
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N          # x, B, C all pass through the conv
    u = torch.rand((n, H), generator=generator, dtype=_F32, device=device)
    return {
        # order: [z (gate), x, B, C, dt]
        "w_in": normal((d, 2 * d_inner + 2 * N + H)),
        "conv_w": normal((cfg.d_conv, conv_dim), 0.5),
        "conv_b": zeros((conv_dim,)),
        "A_log": torch.log(torch.linspace(
            1.0, 16.0, H, dtype=_F32, device=device)).expand(n, H).clone(),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * 3.0 - 4.6))),
        "D": torch.ones((n, H), dtype=_F32, device=device),
        "norm_w": zeros((d_inner,)),
        "w_out": normal((d_inner, d), d_inner ** -0.5),
        "ln": zeros((d,)),
    }


def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scale rule
    (f32), drawn from ``generator`` on ``device``.  The LM head is tied:
    the logits contract ``embed.T``."""
    g, n = generator, cfg.n_layers
    return {
        "embed": dense_param(g, (cfg.padded_vocab, cfg.d_model), scale=1.0,
                             device=device),
        "layers": init_stacked(g, n, lambda normal, zeros: init_mamba_layer(
            cfg, normal, zeros, n, g, device), device=device),
        "ln_f": torch.zeros((cfg.d_model,), dtype=_F32, device=device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _f32_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=f32)``: the operands (in
    their own dtype, rounded as the reference rounds them) contracted in
    f32."""
    return torch.einsum(eq, *(o.to(_F32) for o in ops))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD: y[t] = C[t] . h[t]; h[t] = exp(dt_t A) h[t-1] +
    dt_t B[t] (x) x[t].

    x (Bb, L, H, P); dt (Bb, L, H) > 0; A (H,) < 0; B, C (Bb, L, N) (one
    group, shared across heads).  Returns y (Bb, L, H, P) in x's dtype and
    the final state (Bb, H, P, N) f32.  ``Q = min(chunk, L)``; L is padded
    with zeros to a multiple of Q."""
    Bb, Lq, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, Lq)
    nc = -(-Lq // Q)
    pad = nc * Q - Lq
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)

    dA = dtc * A                                      # (Bb, nc, Q, H) < 0
    cum = torch.cumsum(dA, dim=2)                     # l_q = sum_{s<=q}
    seg_total = cum[:, :, -1, :]                      # (Bb, nc, H)

    # intra-chunk: scores[b,c,q,s,h] = (C_q . B_s) exp(l_q - l_s) dt_s,
    # s <= q; the upper triangle is -inf BEFORE the exp (exp overflows)
    cb = _f32_einsum("bcqn,bcsn->bcqs", Cc, Bc)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,c,q,s,h)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    decay = decay.masked_fill(~causal[None, None, :, :, None],
                              float("-inf"))
    w = torch.exp(decay) * dtc[:, :, None, :, :]
    scores = cb[..., None] * w
    y_intra = _f32_einsum("bcqsh,bcshp->bcqhp", scores.to(x.dtype), xc)

    # chunk states: S_c = sum_s exp(l_Q - l_s) dt_s B_s (x) x_s
    w_state = torch.exp(seg_total[:, :, None, :] - cum) * dtc
    S = _f32_einsum("bcsh,bcsn,bcshp->bchpn", w_state.to(x.dtype),
                    Bc.to(x.dtype), xc)

    # inter-chunk recurrence over c: h_in(c) = exp(seg_total) h_in(c-1)
    # + S(c-1); h_entry[c] is the state at the entry of chunk c
    h = torch.zeros((Bb, H, P, N), dtype=_F32, device=x.device)
    entries = []
    for c in range(nc):
        entries.append(h)
        h = h * torch.exp(seg_total[:, c])[:, :, None, None] + S[:, c]
    h_entry = torch.stack(entries, dim=1)             # (b, nc, h, p, n)

    y_inter = _f32_einsum("bcqn,bchpn->bcqhp", Cc.to(x.dtype),
                          h_entry.to(x.dtype))
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :Lq]
    return y.to(x.dtype), h


def ssd_step(x, dt, A, B, C, h):
    """One-token SSD update: x (Bb, H, P); dt (Bb, H); B, C (Bb, N); h
    (Bb, H, P, N) f32 -> (y (Bb, H, P) in x's dtype, h_new)."""
    dA = torch.exp(dt * A)                            # (Bb, H)
    xdt = x * dt[..., None]                           # promotes to f32
    dBx = B.to(xdt.dtype)[:, None, None, :] * xdt[..., None]
    h = h * dA[:, :, None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", h, C.to(h.dtype))
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(z, cfg: ModelConfig):
    """gate, x, B, C, dt_raw: the reference splits at the indices
    [d_inner, 2 d_inner, 2 d_inner + N, 2 d_inner + 2 N]."""
    d_inner, H, P, N = _dims(cfg)
    return torch.split(z, [d_inner, d_inner, N, N, H], dim=-1)


def mamba_block(p, cfg: ModelConfig, u, *, conv_state=None,
                ssm_state=None):
    """u (Bb, L, d).  The whole sequence when the states are None; one
    decode step (L == 1) otherwise.  Returns (out, new_conv_state,
    new_ssm_state)."""
    eng = cfg.engine
    d_inner, H, P, N = _dims(cfg)
    Bb, Lq, _ = u.shape
    un = L.rmsnorm(u, p["ln"], cfg.norm_eps)
    proj = eng(un, p["w_in"])
    gate, xbc_x, Bp, Cp, dt_raw = _split_proj(proj, cfg)
    xbc = torch.cat([xbc_x, Bp, Cp], dim=-1)            # conv channels
    conv_w = p["conv_w"].to(xbc.dtype)                  # (d_conv, conv_dim)

    new_conv = None
    if conv_state is None:
        # causal depthwise conv by shifted adds (d_conv is 4)
        acc = xbc * conv_w[-1]
        for i in range(cfg.d_conv - 1):
            shift = cfg.d_conv - 1 - i
            acc = acc + F.pad(xbc, (0, 0, shift, 0))[:, :Lq] * conv_w[i]
        xbc = F.silu(acc + p["conv_b"].to(acc.dtype))
    else:
        # conv_state: (Bb, d_conv - 1, conv_dim) of past inputs; a plain
        # contraction, as in the reference (not the engine)
        window = torch.cat([conv_state, xbc], dim=1)   # (Bb, d_conv, C)
        acc = torch.einsum("btc,tc->bc", window, conv_w)[:, None]
        xbc = F.silu(acc + p["conv_b"].to(acc.dtype))
        new_conv = window[:, 1:]

    x, Bp, Cp = torch.split(xbc, [d_inner, N, N], dim=-1)
    x = x.reshape(Bb, Lq, H, P)
    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))
    A = -torch.exp(p["A_log"].to(_F32))

    if ssm_state is None:
        y, h_final = ssd_chunked(x, dt, A, Bp.to(x.dtype), Cp.to(x.dtype),
                                 cfg.chunk)
    else:
        y1, h_final = ssd_step(x[:, 0], dt[:, 0], A, Bp[:, 0].to(x.dtype),
                               Cp[:, 0].to(x.dtype), ssm_state)
        y = y1[:, None]
    y = y + x * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bb, Lq, d_inner)
    # gated RMSNorm (mamba2's norm before the out-projection, silu gate)
    y = L.rmsnorm(y, p["norm_w"], cfg.norm_eps) * F.silu(gate)
    out = eng(y, p["w_out"])
    return u + out, new_conv, h_final


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions=None) -> torch.Tensor:
    """tokens (B, L) -> logits (B, L, padded_vocab) f32 (tied head)."""
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    x = T.scan_layers(lambda lp, x: mamba_block(lp, cfg, x)[0],
                      params["layers"], x, n_layers=cfg.n_layers,
                      remat_block=cfg.remat_block)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return L.logits_head(x, params["embed"].T, cfg.engine)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Constant-size state a layer: the bf16 conv window and the f32 SSM
    state (``max_len`` is not read)."""
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N
    return {"conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                                 conv_dim), dtype=torch.bfloat16,
                                device=device),
            "ssm": torch.zeros((cfg.n_layers, batch, H, P, N), dtype=_F32,
                               device=device)}


def cache_axes(cfg: ModelConfig):
    return {"conv": ("layers", "cache_batch", None, "mlp"),
            "ssm": ("layers", "cache_batch", "heads", None, None)}


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                cur_len):
    """One-token decode: tokens (B, 1).  Each layer's conv window is cast
    up to the activation dtype and its update back to the cache's (bf16),
    as the reference does.  Returns (logits (B, 1, vocab), new_cache)."""
    x = L.embed_tokens(tokens, params["embed"], cfg.compute_dtype)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        conv = cache["conv"][i]
        x, conv_n, ssm_n = mamba_block(
            T.layer_params(params["layers"], i), cfg, x,
            conv_state=conv.to(x.dtype), ssm_state=cache["ssm"][i])
        convs.append(conv_n.to(conv.dtype))
        ssms.append(ssm_n)
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = L.logits_head(x, params["embed"].T, cfg.engine)
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
