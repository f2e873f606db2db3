"""Layer library: norms, RoPE, GQA attention, MLPs, embeddings — PyTorch
port of ``repro.models.layers``.

All contractions route through the model's ``MatmulEngine``, so any layer
runs its GEMMs through the INT8 Ozaki emulation under an ozimmu spec, in
the forward and in the backward alike.  The reference's ``shard(...)``
layout hints have no counterpart: the port has no mesh yet.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core.engine import dot_general

NEG_INF = -1e30


def _edot(engine, lhs, rhs, dimension_numbers, out_dtype=None):
    """Batched contraction for the attention blocks: through the engine
    under an ozimmu spec; a plain contraction otherwise (bf16/f32 operands
    accumulate in f32, as ``preferred_element_type`` does in the
    reference)."""
    if engine is None or not engine.is_ozimmu:
        acc = torch.float64 if torch.float64 in (lhs.dtype, rhs.dtype) \
            else torch.float32
        out = dot_general(lhs.to(acc), rhs.to(acc), dimension_numbers)
        return out.to(out_dtype or lhs.dtype)
    return engine.dot_general(lhs, rhs, dimension_numbers,
                              out_dtype=out_dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., L) int -> cos/sin (..., L, dim//2) f32."""
    half = dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(theta, expo)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, L, H, D); cos/sin (B, L, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _scores_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Lq, Lk) bool mask from absolute positions."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _pad_seq(x: torch.Tensor, total: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, L, ...) to ``total``."""
    if x.shape[1] == total:
        return x
    pad = x.new_zeros((x.shape[0], total - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0, engine=None) -> torch.Tensor:
    """Chunked online-softmax (flash-style) GQA attention.

    q (B, Lq, H, D); k, v (B, Lk, KV, D/Dv) with H % KV == 0.  The score
    and output contractions are (B, KV)-batched dot_generals through
    ``engine`` — the reference's loop structure, with its scans written as
    Python loops.  Differentiable through :class:`_Flash`, the reference's
    recompute backward: score blocks are recomputed, never stored, and
    every backward contraction goes through ``engine`` too.  No flash
    kernel runs here (the reference's training attention reaches none)."""
    args = (engine, bool(causal), window, int(q_chunk), int(kv_chunk),
            int(q_offset))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, *args)
    return _flash_fwd_impl(q, k, v, *args)[0]


def _flash_dims(q, k, v, q_chunk, kv_chunk):
    B, Lq, H, D = q.shape
    _, Lk, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    qc, kc = min(q_chunk, Lq), min(kv_chunk, Lk)
    nq, nk = -(-Lq // qc), -(-Lk // kc)
    return B, Lq, H, D, Lk, KV, Dv, G, qc, kc, nq, nk


def _flash_fwd_impl(q, k, v, engine, causal, window, q_chunk, kv_chunk,
                    q_offset):
    """``(out, (outs, lses))``: the attention and, per q chunk, the
    normalized outputs ``(nq, B, KV, G, qc, Dv)`` and log-sum-exps
    ``(nq, B, KV, G, qc)`` (+inf on rows with every key masked) the
    backward recomputes from."""
    B, Lq, H, D, Lk, KV, Dv, G, qc, kc, nq, nk = _flash_dims(
        q, k, v, q_chunk, kv_chunk)
    dev = q.device
    q = _pad_seq(q, nq * qc)
    k = _pad_seq(k, nk * kc)
    v = _pad_seq(v, nk * kc)
    scale = D ** -0.5
    qg = q.reshape(B, nq, qc, KV, G, D)
    kg = k.reshape(B, nk, kc, KV, D)
    vg = v.reshape(B, nk, kc, KV, Dv)
    outs, lses = [], []
    for qi in range(nq):
        qblk = qg[:, qi] * scale                      # (B, qc, KV, G, D)
        q_pos = qi * qc + torch.arange(qc, device=dev) + q_offset
        m_run = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qc, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk, vblk = kg[:, ki], vg[:, ki]
            k_pos = ki * kc + torch.arange(kc, device=dev)
            # scores: einsum "bqkgd,bskd->bkgqs" (contract d)
            s = _edot(engine, qblk, kblk, (((4,), (3,)), ((0, 2), (0, 2))),
                      out_dtype=torch.float32).permute(0, 1, 3, 2, 4)
            mask = _scores_mask(q_pos, k_pos, causal, window)
            mask &= (k_pos < Lk)[None, :]
            s = s.masked_fill(~mask[None, None, None], NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            # output: einsum "bkgqs,bskd->bkgqd" (contract s)
            pv = _edot(engine, p.to(v.dtype), vblk,
                       (((4,), (1,)), ((0, 1), (0, 2))),
                       out_dtype=torch.float32)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        outs.append(acc / torch.clamp(l_run, min=1e-30)[..., None])
        # logsumexp per row; +inf on fully masked (padding) rows, so that
        # exp(s - lse) == 0 in the backward's recomputation
        lses.append(torch.where(
            l_run > 0, m_run + torch.log(torch.clamp(l_run, min=1e-30)),
            torch.full_like(l_run, float("inf"))))
    outs, lses = torch.stack(outs), torch.stack(lses)
    out = outs.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * qc, H, Dv)
    return out[:, :Lq].to(q.dtype), (outs, lses)


def _flash_bwd_impl(q, k, v, outs, lses, dout, engine, causal, window,
                    q_chunk, kv_chunk, q_offset):
    """The flash backward: recompute p block by block from ``lses``; never
    materialize L^2.  Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Lq, H, D, Lk, KV, Dv, G, qc, kc, nq, nk = _flash_dims(
        q, k, v, q_chunk, kv_chunk)
    dev, f32 = q.device, torch.float32
    q_pad = _pad_seq(q, nq * qc)
    k_pad = _pad_seq(k, nk * kc)
    v_pad = _pad_seq(v, nk * kc)
    dout = _pad_seq(dout.to(f32), nq * qc)
    scale = D ** -0.5
    qg = q_pad.reshape(B, nq, qc, KV, G, D)
    kg = k_pad.reshape(B, nk, kc, KV, D)
    vg = v_pad.reshape(B, nk, kc, KV, Dv)
    # dout in (nq, B, KV, G, qc, Dv) to match the outs/lses block layout
    dg = dout.reshape(B, nq, qc, KV, G, Dv).permute(1, 0, 3, 4, 2, 5)
    # delta_i = rowsum(dout_i * out_i): (nq, B, KV, G, qc)
    delta = (dg * outs).sum(dim=-1)
    dq_acc = torch.zeros((B, nq, qc, KV, G, D), dtype=f32, device=dev)
    dks, dvs = [], []
    for ki in range(nk):
        kblk, vblk = kg[:, ki], vg[:, ki]            # (B, kc, KV, D/Dv)
        k_pos = ki * kc + torch.arange(kc, device=dev)
        dk_blk = torch.zeros((B, kc, KV, D), dtype=f32, device=dev)
        dv_blk = torch.zeros((B, kc, KV, Dv), dtype=f32, device=dev)
        for qi in range(nq):
            qblk = qg[:, qi] * scale                  # (B, qc, KV, G, D)
            q_pos = qi * qc + torch.arange(qc, device=dev) + q_offset
            # recomputed scores (the forward's contraction)
            s = _edot(engine, qblk, kblk, (((4,), (3,)), ((0, 2), (0, 2))),
                      out_dtype=f32).permute(0, 1, 3, 2, 4)
            mask = _scores_mask(q_pos, k_pos, causal, window)
            mask &= (k_pos < Lk)[None, :]
            s = s.masked_fill(~mask[None, None, None], NEG_INF)
            p = torch.exp(s - lses[qi][..., None])   # (B, KV, G, qc, kc)
            do_blk = dg[qi]                           # (B, KV, G, qc, Dv)
            # dv: einsum "bkgqs,bkgqd->bskd" (contract g, q)
            dv_blk = dv_blk + _edot(
                engine, p, do_blk, (((2, 3), (2, 3)), ((0, 1), (0, 1))),
                out_dtype=f32).permute(0, 2, 1, 3)
            # dp: einsum "bkgqd,bskd->bkgqs" (contract d)
            dp = _edot(engine, do_blk, vblk.to(f32),
                       (((4,), (3,)), ((0, 1), (0, 2))), out_dtype=f32)
            ds = p * (dp - delta[qi][..., None])      # (B, KV, G, qc, kc)
            # dq: einsum "bkgqs,bskd->bqkgd" (contract s)
            dq_blk = _edot(engine, ds, kblk.to(f32),
                           (((4,), (1,)), ((0, 1), (0, 2))),
                           out_dtype=f32).permute(0, 3, 1, 2, 4) * scale
            dq_acc[:, qi] += dq_blk
            # dk: einsum "bkgqs,bqkgd->bskd" (contract g, q); qblk
            # already carries `scale`, so dk needs no extra factor
            dk_blk = dk_blk + _edot(
                engine, ds, qblk.to(f32),
                (((2, 3), (3, 1)), ((0, 1), (0, 2))),
                out_dtype=f32).permute(0, 2, 1, 3)
        dks.append(dk_blk)
        dvs.append(dv_blk)
    dq = dq_acc.reshape(B, nq * qc, H, D)[:, :Lq]
    dk = torch.stack(dks, dim=1).reshape(B, nk * kc, KV, D)[:, :Lk]
    dv = torch.stack(dvs, dim=1).reshape(B, nk * kc, KV, Dv)[:, :Lk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """:func:`attention_flash` with the reference's custom VJP: the
    residuals are q, k, v and the per-chunk outputs and log-sum-exps;
    the backward recomputes the score blocks (:func:`_flash_bwd_impl`)."""

    @staticmethod
    def forward(ctx, q, k, v, engine, causal, window, q_chunk, kv_chunk,
                q_offset):
        out, (outs, lses) = _flash_fwd_impl(q, k, v, engine, causal, window,
                                            q_chunk, kv_chunk, q_offset)
        ctx.save_for_backward(q, k, v, outs, lses)
        ctx.args = (engine, causal, window, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, outs, lses = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, outs, lses, dout, *ctx.args)
        return (dq, dk, dv) + (None,) * 6


def decode_positions(cur_len, batch: int) -> torch.Tensor:
    """(B, 1) absolute position ``cur_len - 1`` of the token being decoded;
    ``cur_len`` is a scalar (lock-step) or (B,) (per slot)."""
    c = (torch.as_tensor(cur_len) - 1).to(torch.int32)
    if c.ndim == 0:
        return c.expand(batch, 1)
    return c[:, None]


def ring_row_index(cur_len, cache_len: int):
    """Cache row a decode step at sequence position ``cur_len`` writes:
    ``(cur_len - 1) mod cache_len``."""
    return (torch.as_tensor(cur_len) - 1) % cache_len


def cache_update_row(buf: torch.Tensor, new: torch.Tensor,
                     cur_len) -> torch.Tensor:
    """A copy of the per-slot cache ``buf`` (B, L, ...) with the decode-step
    row ``new`` (B, 1, ...) written at ``(cur_len - 1) mod L``.  Vector
    slots with ``cur_len == 0`` are no-ops (the old row is kept)."""
    c = torch.as_tensor(cur_len, device=buf.device)
    idx = ring_row_index(c, buf.shape[1])
    new = new.to(buf.dtype)
    out = buf.clone()
    if c.ndim == 0:
        out[:, int(idx)] = new[:, 0]
        return out
    b_idx = torch.arange(buf.shape[0], device=buf.device)
    old = buf[b_idx, idx]
    live = (c > 0).reshape((-1,) + (1,) * (new.ndim - 2))
    out[b_idx, idx] = torch.where(live, new[:, 0], old)
    return out


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: Optional[int] = None,
                     engine=None) -> torch.Tensor:
    """Single-position attention against a (B, Lmax, KV, D) cache.

    q (B, 1, H, D); cur_len () or (B,): valid cache positions INCLUDING the
    current token.  Score and output contractions are (B, KV)-batched
    dot_generals through ``engine``."""
    B, _, H, D = q.shape
    Lmax, KV = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = H // KV
    qg = (q * D ** -0.5).reshape(B, KV, G, D)
    # scores: einsum "bkgd,bskd->bkgs" (contract d)
    s = _edot(engine, qg, k_cache, (((3,), (3,)), ((0, 1), (0, 2))),
              out_dtype=torch.float32)
    pos = torch.arange(Lmax, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device)
    cur = cur[:, None] if cur.ndim == 1 else cur.reshape(1, 1)
    valid = pos[None, :] < cur                      # (B or 1, Lmax)
    if window is not None:
        valid &= pos[None, :] >= cur - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    # output: einsum "bkgs,bskd->bkgd" (contract s)
    out = _edot(engine, p.to(v_cache.dtype), v_cache,
                (((3,), (1,)), ((0, 1), (0, 2))), out_dtype=torch.float32)
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# projections / MLPs / embeddings
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ieee_f32_matmul():
    """Full f32 products on the card whatever the caller set
    (``torch.backends.cuda.matmul.allow_tf32``): the plain f32 products
    the reference keeps outside the engine (the MoE router, the RG-LRU
    gate)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def swiglu(x, w_gate, w_up, w_down, engine):
    h = F.silu(engine(x, w_gate)) * engine(x, w_up)
    return engine(h, w_down)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (PyTorch's default, the erf
    form, differs by up to ~1e-3)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(x, w_up, w_down, engine):
    return engine(gelu(engine(x, w_up)), w_down)


def embed_tokens(tokens: torch.Tensor, emb: torch.Tensor,
                 dtype) -> torch.Tensor:
    return emb[tokens].to(dtype)


def logits_head(x: torch.Tensor, emb_or_w, engine) -> torch.Tensor:
    """x (B, L, d) @ W (d, vocab) -> f32 logits."""
    return engine(x, emb_or_w).to(torch.float32)
