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
