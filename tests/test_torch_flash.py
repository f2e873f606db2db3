"""The port's flash attention against the reference's Pallas kernels.

Same numpy inputs through ``repro.kernels`` (JAX; the Pallas kernels in
interpret mode, ``repro.kernels.ops.INTERPRET``) and ``repro_torch.kernels``
(CPU tensors: the kernels' plain versions), in the kernels' own
tolerances (``tests/test_flash_kernel.py``): forward 2e-5 in f32 and 2e-2
in bf16, backward 2e-4.  Attention is not bitwise across the frameworks
(exp and the summation order differ); the masks, the finite sentinel and
the padding are the same, so the fully masked rows agree too.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as J_fa
from repro.kernels import ops as J_ops
from repro_torch.kernels import flash_attention as P_fa
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from tests.test_flash_kernel import CASES

torch.set_num_threads(1)

_DT = {"f32": (jnp.float32, torch.float32, 2e-5),
       "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,Dv,causal,window,qc,kc", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_matches_reference_kernel(B, Lq, Lk, H, KV, D, Dv, causal,
                                          window, qc, kc, dt):
    """``ops.flash_attention`` of both packages: layout, padding, GQA."""
    jdt, tdt, tol = _DT[dt]
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, Lq, H, D)), jdt, tdt)
    jk, tk = _pair(rng.standard_normal((B, Lk, KV, D)), jdt, tdt)
    jv, tv = _pair(rng.standard_normal((B, Lk, KV, Dv)), jdt, tdt)
    want = J_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 qc=qc, kc=kc)
    got = P_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                qc=qc, kc=kc)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _close(_f32(got), want, tol)


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,Dv,causal,window,qc,kc",
                         CASES[:3])
def test_forward_lse_and_backward_match_reference_kernels(
        B, Lq, Lk, H, KV, D, Dv, causal, window, qc, kc):
    """The kernel-level functions on the reference's padded layout: o, lse
    and (dq, dk, dv), dk/dv unexpanded."""
    rng = np.random.default_rng(2)
    group = H // KV
    Lq_p, Lk_p = -(-Lq // qc) * qc, -(-Lk // kc) * kc
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B * H, Lq_p, D), (B * KV, Lk_p, D), (B * KV, Lk_p, Dv),
             (B * H, Lq_p, Dv))]
    jq, jk, jv, jdo = map(jnp.asarray, arrs)
    tq, tk, tv, tdo = map(torch.from_numpy, arrs)
    kw = dict(group=group, causal=causal, window=window, lk=Lk)
    jo, jlse = J_fa.flash_attention_fwd(jq, jk, jv, qc=qc, kc=kc, **kw)
    to, tlse = P_fa.flash_attention_fwd(tq, tk, tv, **kw)
    _close(to.numpy(), jo, 2e-5)
    _close(tlse.numpy(), jlse, 2e-5)
    jgrads = J_fa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, qc=qc,
                                      kc=kc, **kw)
    tgrads = P_fa.flash_attention_bwd(tq, tk, tv, to, tlse, tdo, **kw)
    for t, j in zip(tgrads, jgrads):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j, 2e-4)


def test_backward_matches_autograd_of_the_oracle():
    """The plain backward equals autograd of the port's naive oracle (the
    reference's own check of its kernels, on the port's side)."""
    rng = np.random.default_rng(3)
    BKV, group, L, D = 2, 2, 40, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((BKV * group, L, D), (BKV, L, D), (BKV, L, D),
                             (BKV * group, L, D)))
    o, lse = P_fa.flash_attention_fwd(q, k, v, group=group, window=11)
    dq, dk, dv = P_fa.flash_attention_bwd(q, k, v, o, lse, do, group=group,
                                          window=11)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    (P_ref.flash_attention_ref(q, k, v, group=group, window=11) * do
     ).sum().backward()
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        _close(got.numpy(), want.numpy(), 2e-4)


@pytest.mark.parametrize("Lk,kc", [(24, 8), (20, 8)])
def test_fully_masked_rows(Lk, kc):
    """Rows at q_offset < 0 see no key under causality: the finite sentinel
    makes them the uniform average of v over the (padded) keys in both
    packages — with and without padding of the keys — and the backward
    recomputes p = 1 there from lse, as the reference does."""
    rng = np.random.default_rng(4)
    B, Lq, H, KV, D = 1, 16, 2, 1, 8
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Lq, H, D), (B, Lk, KV, D), (B, Lk, KV, D))]
    want = J_ops.flash_attention(*map(jnp.asarray, arrs), causal=True,
                                 qc=8, kc=kc, q_offset=-5)
    got = P_ops.flash_attention(*map(torch.from_numpy, arrs), causal=True,
                                qc=8, kc=kc, q_offset=-5).numpy()
    _close(got, want, 2e-5)
    Lk_p = -(-Lk // kc) * kc
    vpad = np.zeros((Lk_p, D), np.float32)
    vpad[:Lk] = arrs[2][0, :, 0]
    np.testing.assert_allclose(got[0, :5, 0], np.broadcast_to(
        vpad.mean(0), (5, D)), rtol=1e-5, atol=1e-6)

    q = np.ascontiguousarray(arrs[0].transpose(0, 2, 1, 3)[0])
    k = np.ascontiguousarray(arrs[1].transpose(0, 2, 1, 3)[0])
    v = np.ascontiguousarray(arrs[2].transpose(0, 2, 1, 3)[0])
    do = rng.standard_normal((H, Lq, D)).astype(np.float32)
    kw = dict(group=H // KV, causal=True, q_offset=-5)
    jo, jlse = J_fa.flash_attention_fwd(*map(jnp.asarray, (q, k, v)), qc=8,
                                        kc=Lk, **kw)
    jg = J_fa.flash_attention_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                                  jnp.asarray(do), qc=8, kc=Lk, **kw)
    to, tlse = P_fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                        **kw)
    tg = P_fa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), to,
                                  tlse, torch.from_numpy(do), **kw)
    for t, j in zip(tg, jg):
        _close(t.numpy(), j, 2e-4)


def test_kernel_entry_matches_model_attention():
    """``ops.flash_attention`` equals the port's engine-routed
    ``layers.attention_flash`` (native engine), as the reference's kernel
    equals its model layer (tests/test_flash_kernel.py)."""
    from repro_torch.models.layers import attention_flash
    rng = np.random.default_rng(1)
    B, L, H, KV, D = 2, 33, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, L, H, D), (B, L, KV, D), (B, L, KV, D)))
    got = P_ops.flash_attention(q, k, v, causal=True, qc=16, kc=16)
    want = attention_flash(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    _close(got.numpy(), want.numpy(), 3e-5)


def test_wrappers_take_plain_version_only_on_cpu():
    """A non-CPU tensor never reaches a plain version (the meta device has
    no kernel)."""
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        P_fa.flash_attention_fwd(q, q, q)
    lse = torch.empty((2, 8, 1), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        P_fa.flash_attention_bwd(q, q, q, q, lse, q)


# ---------------------------------------------------------------------------
# The CUDA kernels' rounding, emulated in plain PyTorch and held to the
# reference's Pallas kernels before any card run.
#
# bf16 route (wgmma): bf16 x bf16 products summed in f32, the scale applied
# to S after the product (bf16 operands cannot carry the reference's f32
# ``q * scale``); online softmax over key tiles, P rounded to bf16 for PV
# while l sums the f32 p; in the backward P is rounded to bf16 for dV,
# and dS is carried as two bf16 terms, hi = bf16(dS) and lo = bf16(dS -
# hi), each through its own product (one bf16 term fails the bf16 bound
# on dq and dk where fully masked rows give p = 1 on every key).
# f32 route (3xTF32): each f32 operand split as hi = rna_tf32(x), lo =
# trunc_tf32(x - hi), every product formed as hi.hi + hi.lo + lo.hi with
# f32 sums; q is scaled in f32 before its split, as the reference scales.
# ---------------------------------------------------------------------------

_F32 = torch.float32


def _bits_round(x, *, nearest):
    """x rounded to tf32 (10 mantissa bits): to nearest with ties away
    from zero (``cvt.rna.tf32.f32``) or truncated (what the tensor core
    keeps of an f32 register)."""
    b = x.contiguous().view(torch.int32)
    if nearest:
        b = b + 0x1000
    return (b & ~0x1FFF).view(_F32)


def _split_tf32(x):
    hi = _bits_round(x, nearest=True)
    return hi, _bits_round(x - hi, nearest=False)


def _mm(a, b, route):
    """a @ b as the route's tensor cores form it."""
    if route == "bf16":
        return torch.matmul(a.to(torch.bfloat16).to(_F32),
                            b.to(torch.bfloat16).to(_F32))
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)) + \
        torch.matmul(al, bh)


def _emu_scores(q, k, group, causal, window, q_offset, route):
    """Masked f32 scores (BH, Lq, Lk) as the route computes them."""
    D = q.shape[-1]
    scale = float(D) ** -0.5
    kg = k.repeat_interleave(group, dim=0).to(_F32)
    if route == "bf16":
        s = _mm(q.to(_F32), kg.transpose(-1, -2), route) * scale
    else:
        s = _mm(q.to(_F32) * scale, kg.transpose(-1, -2), route)
    mask = P_fa._mask(q.shape[1], k.shape[1], k.shape[1], causal, window,
                      q_offset, q.device)
    return s.masked_fill(~mask, P_fa.NEG_INF)


def _emu_fwd(q, k, v, group, causal, window, q_offset, route, bk):
    """Online softmax over key tiles of ``bk`` keys."""
    s = _emu_scores(q, k, group, causal, window, q_offset, route)
    vg = v.repeat_interleave(group, dim=0).to(_F32)
    BH, Lq, Lk = s.shape
    m = torch.full((BH, Lq, 1), P_fa.NEG_INF)
    l = torch.zeros((BH, Lq, 1))
    acc = torch.zeros((BH, Lq, v.shape[-1]))
    for k0 in range(0, Lk, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).to(_F32) if route == "bf16" else p
        acc = acc * corr + _mm(pv, vg[:, k0:k0 + bk], route)
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(lc), torch.full_like(l, np.inf))
    return (acc / lc).to(q.dtype), lse


def _emu_bwd(q, k, v, out, lse, dout, group, causal, window, q_offset,
             route):
    scale = float(q.shape[-1]) ** -0.5
    s = _emu_scores(q, k, group, causal, window, q_offset, route)
    p = torch.exp(s - lse)
    do = dout.to(_F32)
    kg = k.repeat_interleave(group, dim=0).to(_F32)
    vg = v.repeat_interleave(group, dim=0).to(_F32)
    delta = (do * out.to(_F32)).sum(-1, keepdim=True)
    ds = p * (_mm(do, vg.transpose(-1, -2), route) - delta)
    if route == "bf16":
        p = p.to(torch.bfloat16).to(_F32)
        hi = ds.to(torch.bfloat16).to(_F32)
        lo = (ds - hi).to(torch.bfloat16).to(_F32)
        qf = q.to(_F32)
        dq = (torch.matmul(hi, kg) + torch.matmul(lo, kg)) * scale
        dkg = (torch.matmul(hi.transpose(-1, -2), qf) +
               torch.matmul(lo.transpose(-1, -2), qf)) * scale
    else:
        dq = _mm(ds, kg, route) * scale
        dkg = _mm(ds.transpose(-1, -2), q.to(_F32) * scale, route)
    dvg = _mm(p.transpose(-1, -2), do, route)
    BKV = k.shape[0]
    dk = dkg.reshape((BKV, group) + dkg.shape[1:]).sum(1)
    dv = dvg.reshape((BKV, group) + dvg.shape[1:]).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _assert_route_close(got, want, route, tol):
    """The card test's bounds: bf16 outputs within 2e-2 |y| + min(2e-2,
    4e-3 max|y|); f32 within ``tol`` (2e-5 forward, 2e-4 backward)."""
    got = torch.as_tensor(np.asarray(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    if route == "bf16":
        atol = min(2e-2, 4e-3 * float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=2e-2, atol=atol)
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


EMU_CASES = [  # BKV, group, L, D, causal, window, q_offset
    (1, 2, 256, 128, True, None, 0),
    (2, 2, 200, 64, True, 37, 0),           # window, ragged key tiles
    (1, 4, 96, 32, False, None, 0),         # non-causal GQA
    (1, 2, 136, 128, True, None, -9),       # fully masked rows
]


@pytest.mark.parametrize("case", EMU_CASES)
@pytest.mark.parametrize("route", ["bf16", "tf32x3"])
def test_kernel_rounding_matches_reference_kernels(case, route):
    """Each CUDA route's rounding (emulated above) against the reference's
    Pallas forward and backward in interpret mode, on the same numpy
    inputs: bf16 inputs for the bf16 route, f32 for 3xTF32."""
    BKV, group, L, D, causal, window, q_offset = case
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if route == "bf16"
                else (jnp.float32, torch.float32))
    rng = np.random.default_rng(5)
    shapes = ((BKV * group, L, D), (BKV, L, D), (BKV, L, D),
              (BKV * group, L, D))
    pairs = [_pair(rng.standard_normal(s), jdt, tdt) for s in shapes]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = pairs
    kw = dict(group=group, causal=causal, window=window, q_offset=q_offset)
    jo, jlse = J_fa.flash_attention_fwd(jq, jk, jv, qc=L, kc=L, **kw)
    bk = 128 if route == "bf16" else 64   # the forward kernels' key tiles
    to, tlse = _emu_fwd(tq, tk, tv, group, causal, window, q_offset, route,
                        bk)
    _assert_route_close(_f32(to), jo, route, 2e-5)
    _close(tlse.numpy(), jlse, 2e-5)
    # the backward from the reference's forward, as the card test does
    tout = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tdt)
    tl = torch.from_numpy(np.array(jlse))
    jg = J_fa.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, qc=L, kc=L,
                                  **kw)
    tg = _emu_bwd(tq, tk, tv, tout, tl, tdo, group, causal, window,
                  q_offset, route)
    for t, j in zip(tg, jg):
        assert tuple(t.shape) == tuple(j.shape)
        _assert_route_close(_f32(t), j, route, 2e-4)
