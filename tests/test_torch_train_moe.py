"""Training of the MoE families (deepseek-moe-16b ``moe``, deepseek-v2-236b
``mla_moe``) against the reference.

The reference's ``smoke()`` parameters are carried across
(``models/convert.params_from_numpy``) and one numpy batch of the pipeline
goes through both; every check runs f32 activations (the frameworks
round bf16 activations at different places):

* the routing (each layer's top-k experts on the forward's own router
  inputs) equal to the reference's before any gradient is compared: a
  ``torch.topk`` near-tie flipped against ``lax.top_k`` would move a
  token's gradient to another expert; a ``drops`` case cuts the
  capacity factor to 0.25 (8 rows an expert for 64 (token, choice)
  pairs), so that queues overflow (dropped pairs asserted) and the
  gradients pass the drops;
* the loss within 1e-6 of its value, relative (a few f32 ulps at the
  smoke loss of ~6), and every gradient leaf within ``1e-5 * max|g|``
  under ``f32`` and ``1e-4 * max|g|`` under ``ozimmu_h-4:df32``, against
  ``jax.value_and_grad``: the routing weights through ``topk``, the
  dispatch's ``index_put_`` and the combine's gather, the E-batched
  expert contractions through ``ozimmu``'s autograd Function, MLA's G = 1
  attention (D 24 / Dv 16 here) through the flash recompute backward;
* gradients bitwise equal across remat blocks of 1 and 2 layers under
  ``:fused`` (the recompute repeats the routing);
* the kernel launches of one smoke train step under ``:fused``, counted at
  the wrappers, equal to ``chip_smoke.train_step_launches``;
* ``aux_load_balance_loss`` and its gradient with respect to the gates
  within 1e-6 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as R_configs
from repro.models import api as R_api
from repro.models import moe as R_moe
from repro_torch import configs as P_configs
from repro_torch import tree as P_tree
from repro_torch.models import api as P_api
from repro_torch.models import moe as P_moe
from repro_torch.models.convert import params_from_numpy
from tests.torch_parity import (ref_train_params, remat_gradients,
                                train_batch, train_launches, train_parity)

torch.set_num_threads(1)

ARCHS = ["deepseek_moe_16b", "deepseek_v2_236b"]
SPECS = [("f32", 1e-5, False), ("ozimmu_h-4:df32", 1e-4, False),
         ("f32", 1e-5, True)]


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    return arch, ref_train_params(arch), train_batch(arch)


def _routing(arch, spec, params, batch, monkeypatch, **overrides):
    """Each layer's (T, K) expert selection in the reference's forward
    (eager, its scans unrolled) and in the port's, on their own router
    inputs, and the port's kept-pair masks."""
    ref, port, keep = [], [], []
    top_k = lax.top_k

    def r_top_k(x, k):
        out = top_k(x, k)
        ref.append(np.asarray(out[1]))
        return out
    route = P_moe._route

    def p_route(gates, topk, cap):
        out = route(gates, topk, cap)
        port.append(out[1].numpy())
        keep.append(out[4].numpy())
        return out
    rcfg = R_configs.get_config(arch, smoke=True, engine_spec=spec,
                                dtype="float32", **overrides)
    pcfg = P_configs.get_config(arch, smoke=True, engine_spec=spec,
                                dtype="float32", **overrides)
    monkeypatch.setattr(jax.lax, "top_k", r_top_k)
    checkpoint = jax.checkpoint
    monkeypatch.setattr(jax, "checkpoint", lambda fun=None, **kw: (
        fun if fun is not None else (lambda f: f)))
    with jax.disable_jit():
        R_api.get_model(rcfg).forward(
            jax.tree.map(jnp.asarray, params), rcfg,
            {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(jax, "checkpoint", checkpoint)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(P_moe, "_route", p_route)
    with torch.no_grad():
        P_api.get_model(pcfg).forward(
            params_from_numpy(params, device="cpu"), pcfg,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    monkeypatch.setattr(P_moe, "_route", route)
    return ref, port, keep


@pytest.mark.parametrize("spec,tol,drops", SPECS,
                         ids=["f32", "ozimmu_h-4:df32", "f32-drops"])
def test_gradients_match_reference(arch_params, spec, tol, drops,
                                   monkeypatch):
    arch, params, batch = arch_params
    overrides = dict(capacity_factor=0.25) if drops else {}
    ref, port, keep = _routing(arch, spec, params, batch, monkeypatch,
                               **overrides)
    assert (not all(k.all() for k in keep)) == drops
    n_layers = P_configs.get_config(arch, smoke=True).n_layers
    assert len(ref) == len(port) == n_layers
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)
    rloss, ploss, leaves = train_parity(arch, spec, params, batch,
                                        **overrides)
    assert abs(ploss - rloss) <= 1e-6 * abs(rloss)
    names = [path for path, _ in leaves]
    assert any("router" in n for n in names)
    bad = [(path, rel) for path, rel in leaves if not rel <= tol]
    assert not bad, bad


def test_remat_blocks_give_equal_gradients(arch_params):
    arch, params, batch = arch_params
    (l1, g1), (l2, g2) = remat_gradients(arch, params, batch)
    assert float(l1) == float(l2)
    for a, b in zip(P_tree.leaves(g1), P_tree.leaves(g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launch_counts(monkeypatch, arch):
    """deepseek-moe-16b ``smoke()``: 12 contractions a layer forward (7 of
    attention, the 3 expert products over the capacity's rows, the shared
    expert's 3), the same in the recompute, 25 backward, and the LM head's
    3 (101 a step); deepseek-v2-236b's MLA 14 a layer forward (117)."""
    counts, want, n = train_launches(monkeypatch, arch)
    assert n == {"deepseek_moe_16b": 101, "deepseek_v2_236b": 117}[arch]
    assert counts == want


@pytest.mark.parametrize("E,K", [(8, 2), (64, 6)])
def test_aux_load_balance_loss(E, K):
    """The Switch-style auxiliary loss on softmaxed seeded gates and
    their top-k, and its gradient with respect to the gates (the
    selections are constants of it), against the reference's."""
    rng = np.random.default_rng(E)
    logits = rng.standard_normal((96, E)).astype(np.float32) * 2
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    sel = np.asarray(lax.top_k(jnp.asarray(gates), K)[1])
    ref, ref_g = jax.value_and_grad(
        lambda g: R_moe.aux_load_balance_loss(g, jnp.asarray(sel), E))(
            jnp.asarray(gates))
    pg = torch.from_numpy(gates.copy()).requires_grad_()
    out = P_moe.aux_load_balance_loss(pg, torch.from_numpy(sel.copy()), E)
    out.backward()
    assert out.dtype == torch.float32
    assert abs(float(out.detach()) - float(ref)) <= 1e-6
    np.testing.assert_allclose(pg.grad.numpy(), np.asarray(ref_g),
                               rtol=0, atol=1e-6)
