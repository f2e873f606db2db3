"""The port's differentiable emulated GEMM and flash attention against the
reference.

Same numpy inputs through the JAX reference (x64 on; ``:fused`` runs its
Pallas kernels in interpret mode; the reference's VJPs are jitted, which
saves the time of its op-by-op emulation) and the port on the CPU (the
kernels' plain versions).  What is held, and how tightly:

* the emulated ``dot_general``'s VJP bit for bit (``jax.vjp`` against
  ``torch.autograd.grad``) for plain 2-D, 3-D batched, the attention's
  (B, KV)-batched score and the flash backward's two-axis ``dk``
  dimension numbers under ``ozimmu_h-4:df32`` and ``:fused``; the presplit
  variant gives the same cotangents and none to the frozen split; the
  engine's casts pass the gradient through;
* ``attention_flash``'s output and gradients (several q and kv chunks,
  causal, windowed, ``q_offset``) within ``1e-5 * max|.|`` under ``f32``
  and ``ozimmu_h-4:df32`` (exp and the row sums differ by an ulp between
  XLA and PyTorch).

The training loop's modules are held in ``tests/test_torch_train.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import engine as R_engine
from repro.core import ozimmu as R
from repro.core import split_cache as R_sc
from repro.models import layers as R_layers
from repro_torch.core import engine as P_engine
from repro_torch.core import ozimmu as P
from repro_torch.core import split_cache as P_sc
from repro_torch.models import layers as P_layers

torch.set_num_threads(1)

SPECS = ["ozimmu_h-4:df32", "ozimmu_h-4:df32:fused"]


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---------------------------------------------------------------------------
# the emulated dot_general's VJP
# ---------------------------------------------------------------------------

# (name, lhs shape, rhs shape, dimension numbers)
VJP_CASES = [
    ("plain 2-D", (9, 40), (40, 7), (((1,), (0,)), ((), ()))),
    ("3-D batched", (3, 9, 40), (3, 40, 7), (((2,), (1,)), ((0,), (0,)))),
    # the flash scores "bqkgd,bskd->bkgqs": q (B, qc, KV, G, D), k
    ("attention scores", (2, 5, 2, 3, 16), (2, 4, 2, 16),
     (((4,), (3,)), ((0, 2), (0, 2)))),
    # the flash backward's dk "bkgqs,bqkgd->bskd": ds, q (contract g, q)
    ("dk two-axis", (2, 2, 3, 5, 4), (2, 5, 2, 3, 16),
     (((2, 3), (3, 1)), ((0, 1), (0, 2)))),
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_ozimmu_vjp_bitwise(spec, case):
    """Both cotangents bit for bit: the same emulation under the same
    transposed dimension numbers, then the same transpose."""
    _, a_shape, b_shape, dnums = case
    rng = np.random.default_rng(3)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)

    @jax.jit
    def ref(x, y, g):
        out, vjp = jax.vjp(
            lambda x, y: R.ozimmu_dot_general(x, y, dnums, rcfg), x, y)
        return (out,) + vjp(g)

    g = rng.standard_normal(jax.eval_shape(
        lambda x, y: R.ozimmu_dot_general(x, y, dnums, rcfg),
        jnp.asarray(a), jnp.asarray(b)).shape).astype(np.float32)
    out, rda, rdb = ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    pout = P.ozimmu_dot_general(ta, tb, dnums, pcfg)
    np.testing.assert_array_equal(pout.detach().numpy(), np.asarray(out))
    pda, pdb = torch.autograd.grad(pout, (ta, tb), torch.from_numpy(g))
    assert pda.shape == ta.shape and pdb.shape == tb.shape
    np.testing.assert_array_equal(pda.numpy(), np.asarray(rda))
    np.testing.assert_array_equal(pdb.numpy(), np.asarray(rdb))


@pytest.mark.parametrize("spec", SPECS)
def test_ozimmu_vjp_presplit(spec):
    """With a frozen B split the cotangents are those of the plain call
    (the reference's), and the split gets no gradient."""
    dnums = (((1,), (0,)), ((), ()))
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 48)).astype(np.float32)
    b = rng.standard_normal((48, 10)).astype(np.float32)
    g = rng.standard_normal((6, 10)).astype(np.float32)
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)
    rsp = R_sc.SplitCache().get(jnp.asarray(b), dnums, rcfg)

    @jax.jit
    def ref(x, y, g, sp):
        return jax.vjp(lambda x, y: R.ozimmu_dot_general(
            x, y, dnums, rcfg, rhs_presplit=sp), x, y)[1](g)

    rda, rdb = ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), rsp)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    psp = P_sc.SplitCache().get(tb.detach(), dnums, pcfg)
    psp = psp._replace(scale=psp.scale.clone().requires_grad_())
    out = P.ozimmu_dot_general(ta, tb, dnums, pcfg, rhs_presplit=psp)
    plain = P.ozimmu_dot_general(ta.detach(), tb.detach(), dnums, pcfg)
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
    pda, pdb, dscale = torch.autograd.grad(
        out, (ta, tb, psp.scale), torch.from_numpy(g), allow_unused=True)
    assert dscale is None and not psp.digits.requires_grad
    np.testing.assert_array_equal(pda.numpy(), np.asarray(rda))
    np.testing.assert_array_equal(pdb.numpy(), np.asarray(rdb))


def test_engine_contraction_differentiates_through_the_casts():
    """``MatmulEngine.dot_general`` under an ozimmu spec on bf16 operands:
    the gradient reaches the bf16 leaves through the casts to the compute
    dtype and back."""
    eng = P_engine.make_engine("ozimmu_h-4:df32:fused")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    xb = x.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    out = eng(xb, wb)
    assert out.dtype == torch.bfloat16
    g = torch.ones_like(out)
    dx, dw = torch.autograd.grad(out, (xb, wb), g)
    assert dx.dtype == dw.dtype == torch.bfloat16
    pcfg = P.parse_spec("ozimmu_h-4:df32:fused")
    x32, w32 = xb.detach().float(), wb.detach().float()
    want_dx = P.ozimmu_dot_general(torch.ones((4, 8)), w32,
                                   (((1,), (1,)), ((), ())), pcfg)
    np.testing.assert_array_equal(dx.float().numpy(),
                                  want_dx.to(torch.bfloat16).float().numpy())
    want_dw = P.ozimmu_dot_general(torch.ones((4, 8)), x32,
                                   (((0,), (0,)), ((), ())), pcfg).T
    np.testing.assert_array_equal(dw.float().numpy(),
                                  want_dw.to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# attention_flash's VJP
# ---------------------------------------------------------------------------

FLASH_CASES = {"causal": dict(), "window": dict(window=5),
               "q_offset": dict(q_offset=3)}


@pytest.mark.parametrize("spec", ["f32", "ozimmu_h-4:df32"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_attention_flash_vjp(spec, case):
    """Lq = Lk = 12 in q chunks of 5 and kv chunks of 4 (3 x 3 blocks,
    ragged), GQA 4/2: the output and dq, dk, dv within 1e-5 of max|.| of
    the reference's custom VJP, every contraction through the engine."""
    kw = dict(causal=True, q_chunk=5, kv_chunk=4, **FLASH_CASES[case])
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    g = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    reng, peng = R_engine.make_engine(spec), P_engine.make_engine(spec)
    out, vjp = jax.vjp(lambda a, b, c: R_layers.attention_flash(
        a, b, c, engine=reng, **kw), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    pout = P_layers.attention_flash(*leaves, engine=peng, **kw)
    assert _rel(pout.detach().numpy(), out) <= 1e-5
    grads = torch.autograd.grad(pout, leaves, torch.from_numpy(g))
    for name, p, r in zip("qkv", grads, ref):
        assert p.shape == r.shape
        assert _rel(p.numpy(), r) <= 1e-5, name
