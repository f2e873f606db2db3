"""Mixture-of-Experts families, forward and decode — PyTorch port of
``repro.models.moe``: ``moe`` (deepseek-moe-16b: GQA attention) and
``mla_moe`` (deepseek-v2: multi-head latent attention).

Routing is capacity-based (drop-on-overflow) with scatter dispatch into an
``(E, cap, d)`` expert buffer, and the expert FFN is three E-batched
contractions through the model's engine: under an ozimmu spec all E
experts are emulated in one batched ``dot_general`` per weight, the expert
weights split on every call (the serving split cache freezes only plain
projections, as the reference's does).

MLA keeps a per-position cache of the compressed latent ``(L, B, max_len,
kv_lora)`` and the shared rope key ``(L, B, max_len, rope_head_dim)``,
both bf16, and up-projects the whole cache to K and V on every decode step
(``engine(latent_full, w_uk)``, the reference's computation); its
attention has one query head a KV head (G = 1), q/k head dim ``hd +
rope_head_dim``, v head dim ``v_head_dim``.

Left for later slices, and raising until then:

* the expert-parallel all-to-all body of ``moe_ffn_a2a`` (a mesh; the
  distributed slice).  Without a mesh the reference's ``a2a`` dispatch is
  its scatter path, and so it is here;
* ``aux_load_balance_loss`` (training).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, dense_param, init_stacked

_EXPERT_DNUMS = (((2,), (1,)), ((0,), (0,)))  # "ecd,edf->ecf": E-batched GEMM


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("moe", "mla_moe"):
        raise ValueError(f"the {cfg.family!r} family is not a MoE family "
                         f"(moe, mla_moe)")


def _is_mla(cfg: ModelConfig) -> bool:
    _check_family(cfg)
    return cfg.family == "mla_moe"


def _rope_dim(cfg: ModelConfig) -> int:
    """MLA rotates its rope head dim, GQA the whole head."""
    return cfg.rope_head_dim if _is_mla(cfg) else cfg.hd


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def init_moe_ffn(cfg: ModelConfig, normal) -> Dict[str, Any]:
    """Router, expert and shared-expert weights; ``normal(shape,
    scale=None)`` draws a leaf with the reference's ``dense_param`` rule
    (an expert stack ``(E, d, fe)`` takes ``E ** -0.5`` as the reference's
    does)."""
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    params = {
        "router": normal((d, E)),
        "w_gate": normal((E, d, fe)),
        "w_up": normal((E, d, fe)),
        "w_down": normal((E, fe, d), fe ** -0.5),
    }
    if cfg.n_shared_experts:
        params["shared"] = T.init_mlp(
            cfg, normal, d_ff=cfg.d_ff_expert * cfg.n_shared_experts)
    return params


def _router_gates(xt: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """Router logits in f32 regardless of the engine dtype (a native f32
    product, never TF32): expert selection is discrete, and a quantized
    near-tie flips top-k choices that no tolerance absorbs."""
    with L.ieee_f32_matmul():
        return torch.matmul(xt.to(torch.float32),
                            router_w.to(torch.float32))


def _route(gates: torch.Tensor, topk: int, cap: int):
    """``(w, sel, e_idx, slot, keep)`` of the reference's capacity routing
    on softmaxed ``gates`` (T, E): the renormalized top-k weights and
    experts, and each (token, choice) pair's expert, 0-based position in
    its expert's queue (token-major order decides who is dropped; a
    dropped pair points at row ``cap``) and whether it is kept."""
    T_, E = gates.shape
    w, sel = torch.topk(gates, topk)                        # (T, K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renorm
    flat = F.one_hot(sel, E).reshape(T_ * topk, E)
    pos = (torch.cumsum(flat, dim=0) * flat).amax(dim=-1) - 1
    keep = (pos >= 0) & (pos < cap)
    e_idx = sel.reshape(T_ * topk)
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    return w, sel, e_idx, slot, keep


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-expert capacity: ``int(T K cf / E)`` rounded up to a multiple of
    8, at least 8."""
    cap = int(tokens * cfg.topk * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  Capacity-dropped top-k routing."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.topk
    eng = cfg.engine
    T_ = B * S
    cap = _capacity(cfg, T_)
    xt = x.reshape(T_, d)

    gates = torch.softmax(_router_gates(xt, p["router"]), dim=-1)  # (T, E)
    w, _, e_idx, slot, keep = _route(gates, K, cap)

    # dispatch: (E, cap+1, d) buffer; the +1 row absorbs drops
    buf = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, slot), xt.repeat_interleave(K, dim=0),
                   accumulate=True)
    buf = buf[:, :cap]

    # expert FFN: expert-batched GEMMs (E, cap, d) x (E, d, fe) through the
    # engine
    h = eng.dot_general(buf, p["w_gate"].to(x.dtype), _EXPERT_DNUMS)
    u = eng.dot_general(buf, p["w_up"].to(x.dtype), _EXPERT_DNUMS)
    h = F.silu(h) * u
    out_e = eng.dot_general(h, p["w_down"].to(x.dtype), _EXPERT_DNUMS)

    # combine: gather back and weight
    out_pad = torch.cat([out_e, out_e.new_zeros((E, 1, d))], dim=1)
    gathered = out_pad[e_idx, slot]                        # (T*K, d)
    wk = (w.reshape(T_ * K, 1) * keep[:, None]).to(x.dtype)
    out = (gathered * wk).reshape(T_, K, d).sum(dim=1)

    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"],
                             eng).reshape(T_, d)
    return out.reshape(B, S, d)


def moe_ffn_a2a(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The expert-parallel dispatch.  The port has no mesh yet, so this is
    the reference's no-mesh branch: the scatter path.  A mesh-native
    engine spec asks for a mesh and raises."""
    spec = cfg.engine.ozimmu_config
    if spec is not None and spec.mesh_axis is not None:
        raise NotImplementedError(
            "the MoE all-to-all over a mesh comes with the distributed "
            "slice of the port")
    return moe_ffn(p, cfg, x)


def moe_ffn_dispatch(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe_dispatch == "a2a":
        return moe_ffn_a2a(p, cfg, x)
    return moe_ffn(p, cfg, x)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, normal) -> Dict[str, Any]:
    """MLA projection weights (the reference's ``init_mla``): the latent
    down-projection, the shared rope key, a full Q projection, the latent
    up-projections to K and V, and the output projection; ``normal(shape,
    scale=None)`` draws a leaf."""
    d, H = cfg.d_model, cfg.n_heads
    dl, dr, hd = cfg.kv_lora, cfg.rope_head_dim, cfg.hd
    vd = cfg.v_head_dim or hd
    return {"w_dkv": normal((d, dl)), "w_krope": normal((d, dr)),
            "w_q": normal((d, H * (hd + dr))), "w_uk": normal((dl, H * hd)),
            "w_uv": normal((dl, H * vd)),
            "w_o": normal((H * vd, d), (H * vd) ** -0.5)}


def mla_attention(p, cfg: ModelConfig, x, cos, sin, *, cache=None,
                  cur_len=None):
    """MLA on the normed ``x`` (B, L, d).  ``cache=(latent, k_rope)``
    (B, Lmax, kv_lora) and (B, Lmax, rope_head_dim) -> decode: the step's
    rows are written at ``cur_len - 1`` and the WHOLE cache is
    up-projected to K and V.  Returns ``(out, new_cache)``."""
    eng = cfg.engine
    B, Lq, _ = x.shape
    H, hd, dr = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    vd = cfg.v_head_dim or hd

    latent = eng(x, p["w_dkv"])                            # (B, L, dl)
    k_rope = L.apply_rope(eng(x, p["w_krope"]).reshape(B, Lq, 1, dr), cos,
                          sin)                             # shared by heads
    q = eng(x, p["w_q"]).reshape(B, Lq, H, hd + dr)
    q = torch.cat([q[..., :hd], L.apply_rope(q[..., hd:], cos, sin)], dim=-1)

    new_cache = valid = None
    if cache is not None:
        lat_c, kr_c = cache
        lat_c = L.cache_update_row(lat_c, latent, cur_len)
        kr_c = L.cache_update_row(kr_c, k_rope[:, :, 0], cur_len)
        new_cache = (lat_c, kr_c)
        latent_full = lat_c.to(x.dtype)
        k_rope_full = kr_c[:, :, None].to(x.dtype)
        valid = torch.clamp(torch.as_tensor(cur_len, device=x.device),
                            max=lat_c.shape[1])
    else:
        latent_full, k_rope_full = latent, k_rope

    Lk = latent_full.shape[1]
    k_nope = eng(latent_full, p["w_uk"]).reshape(B, Lk, H, hd)
    v = eng(latent_full, p["w_uv"]).reshape(B, Lk, H, vd)
    k = torch.cat([k_nope, k_rope_full.expand(B, Lk, H, dr)], dim=-1)
    if cache is None:
        out = L.attention_flash(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk, engine=eng)
    else:
        out = L.attention_decode(q, k, v, valid, engine=eng)
    return eng(out.reshape(B, Lq, H * vd), p["w_o"]), new_cache


# ---------------------------------------------------------------------------
# model assembly (both MoE families)
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, generator: torch.Generator,
         device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and
    ``dense_param`` scale rule, drawn from ``generator`` on ``device`` (f32
    weights)."""
    init_attn = init_mla if _is_mla(cfg) else T.init_attn
    d, g = cfg.d_model, generator
    return {
        "embed": dense_param(g, (cfg.padded_vocab, d), scale=1.0,
                             device=device),
        "layers": init_stacked(g, cfg.n_layers, lambda normal, zeros: {
            "attn": init_attn(cfg, normal),
            "moe": init_moe_ffn(cfg, normal),
            "ln1": zeros((d,)), "ln2": zeros((d,))}, device=device),
        "ln_f": torch.zeros((d,), dtype=torch.float32, device=device),
        "lm_head": dense_param(g, (d, cfg.padded_vocab), device=device),
    }


def layer_fwd(lp, cfg: ModelConfig, x, cos, sin, cache=None, cur_len=None):
    if _is_mla(cfg):
        xn = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn_out, new_cache = mla_attention(lp["attn"], cfg, xn, cos, sin,
                                            cache=cache, cur_len=cur_len)
        x = x + attn_out
    else:
        x, new_cache = T.attn_block({"attn": lp["attn"], "ln1": lp["ln1"]},
                                    cfg, x, cos, sin, cache=cache,
                                    cur_len=cur_len)
    xn2 = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + moe_ffn_dispatch(lp["moe"], cfg, xn2), new_cache


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions=None) -> torch.Tensor:
    """tokens (B, L) -> logits (B, L, padded_vocab) f32."""
    return T.run_forward(params, cfg, tokens, positions, layer_fwd,
                         rope_dim=_rope_dim(cfg))


_MLA_CACHE_AXES = {"latent": ("layers", "cache_batch", None, "kv_lora"),
                   "k_rope": ("layers", "cache_batch", None, "cache_hd")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """``moe``: the dense K/V stacks.  ``mla_moe``: the latent and rope-key
    stacks, bf16."""
    if not _is_mla(cfg):
        return T.init_cache(cfg, batch, max_len, device=device)
    shape = (cfg.n_layers, batch, max_len)
    return {"latent": torch.zeros(shape + (cfg.kv_lora,),
                                  dtype=torch.bfloat16, device=device),
            "k_rope": torch.zeros(shape + (cfg.rope_head_dim,),
                                  dtype=torch.bfloat16, device=device)}


def cache_axes(cfg: ModelConfig):
    """Logical axes of :func:`init_cache`'s leaves (the reference's
    ``api.get_model`` ``cache_axes`` for the MoE families)."""
    return dict(_MLA_CACHE_AXES) if _is_mla(cfg) else T.cache_axes(cfg)


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                cur_len):
    """One-token decode over the cache stacks (K/V, or latent / rope key);
    as :func:`repro_torch.models.transformer.decode_step`."""
    keys = tuple(_MLA_CACHE_AXES) if _is_mla(cfg) else ("k", "v")
    return T.run_decode(params, cfg, cache, tokens, cur_len, layer_fwd,
                        rope_dim=_rope_dim(cfg), cache_keys=keys)
