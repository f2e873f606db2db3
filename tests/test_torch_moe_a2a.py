"""The port's MoE all-to-all dispatch (``moe_ffn_a2a``) over a ``data``
mesh axis, against the reference's ``moe_ffn``.

On 2 gloo ranks on the CPU (one spawn for the file,
``tests/torch_mesh_worker.py``'s ``moe_a2a`` job), one MoE layer of
deepseek-moe-16b's smoke config (8 experts, top 2, 1 shared expert) and of
deepseek-v2-236b's (8 experts, top 2), seeded parameters of the port's
``init_moe_ffn`` handed to the reference as numpy, f32 activations,
``ozimmu_h-4:df32``.  The two smoke configs agree in every field the
reference's ``moe_ffn`` reads, so one compile of it a capacity factor
serves both layers.
Each rank holds 64 tokens (4 x 16).  The reference runs in this process,
on the same numpy inputs, while the ranks run.

* Each rank's output is the port's ``moe_ffn`` on that rank's rows bit for
  bit, at ``capacity_factor=4.0`` (capacity 64: nothing drops, and the
  two ranks' rows are also the whole-batch ``moe_ffn``'s bit for bit) and
  at 1.0 (capacity 16 against a mean load of 16 a expert: pairs drop,
  asserted).  Against the reference's ``moe_ffn`` on the rank's rows: the
  routing (experts, kept pairs, queue slots) equal and the output within
  ``1e-5 * max|y|``.  Not bitwise: softmax, silu and the f32 router differ
  by an ulp between XLA and PyTorch (``tests/test_torch_moe.py``); every
  emulated expert contraction is bitwise (``test_expert_contraction_
  bitwise`` there).
* The gradients: ``sum(y ** 2)`` of each rank's rows differentiated
  through both all-to-alls, each rank's gradients averaged by
  ``steps.batch_mean``, against the reference's ``jax.grad`` of the mean
  of the two ranks' losses (its ``moe_ffn`` on each rank's rows): every
  leaf within ``1e-5 * max|g|`` (f32 activations: the reference's own
  bf16 limit, ``5e-3 * max|g|``, is far looser), the loss within 1e-6
  relative.  Before the mean, a rank holds zero in the experts it does not
  own.
* The all-to-alls: exactly 2 a forward and 2 a backward a layer.
* Under non-reentrant checkpoint with the backward on a thread of its own
  (autograd runs a CUDA backward, and the recompute inside it, on a
  device thread): the recompute and the backward see the rank's mesh,
  the gradients bitwise the unchecked run's, 2 + 2 + 2 all-to-alls.
* ``n_experts`` that the axis does not divide (7 over 2 ranks) take the
  scatter path: ``moe_ffn``'s output, no all-to-all.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from repro import configs as R_configs
from repro.models import moe as R_moe
from repro_torch import configs as P_configs
from repro_torch import tree as P_tree
from repro_torch.models import moe as P_moe
from repro_torch.models.common import init_stacked
from repro_torch.models.convert import params_from_numpy
from tests.torch_mesh_worker import start

torch.set_num_threads(1)

SPEC = "ozimmu_h-4:df32"
MOE, MLA = "deepseek_moe_16b", "deepseek_v2_236b"
ROWS = (4, 16)                   # a rank's tokens: 64
CASES = {"moe cf4": (MOE, 4.0), "moe cf1": (MOE, 1.0),
         "mla cf4": (MLA, 4.0), "mla cf1": (MLA, 1.0)}


# what the reference's moe_ffn reads of its config
MOE_FIELDS = ("d_model", "n_experts", "topk", "d_ff_expert",
              "n_shared_experts", "capacity_factor", "engine_spec", "dtype")


def _layer_moe(arch, seed):
    """One MoE layer's parameters from the port's ``init_moe_ffn`` (the
    reference's tree and scale rule) drawn from ``seed``, as numpy, and
    the arch's width."""
    cfg = P_configs.get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(seed)
    stack = init_stacked(gen, 1, lambda normal, _: P_moe.init_moe_ffn(
        cfg, normal))
    return P_tree.tree_map(lambda t: t[0].numpy(), stack), cfg.d_model


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ROWS + (d,)).astype(np.float32)
            for _ in range(2)]


def _rcfg(arch, cf, **kw):
    return R_configs.get_config(arch, smoke=True, engine_spec=SPEC,
                                dtype="float32", capacity_factor=cf, **kw)


def _pcfg(arch, cf, **kw):
    return P_configs.get_config(arch, smoke=True, engine_spec=SPEC,
                                dtype="float32", capacity_factor=cf, **kw)


def _ref_routing(x, router, cfg):
    """The reference's routing lines (``moe.py:74-93``) on ``x``."""
    T_ = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.topk
    cap = max(8, -(-int(T_ * K * cfg.capacity_factor / E) // 8) * 8)
    gates = jax.nn.softmax(R_moe._router_gates(
        jnp.asarray(x).reshape(T_, -1), jnp.asarray(router)), axis=-1)
    _, sel = lax.top_k(gates, K)
    flat = jax.nn.one_hot(sel, E, dtype=jnp.int32).reshape(T_ * K, E)
    pos = (jnp.cumsum(flat, axis=0) * flat).max(axis=-1) - 1
    keep = (pos >= 0) & (pos < cap)
    return [np.asarray(a) for a in (sel, keep, jnp.where(keep, pos, cap))]


def _port_routing(x, router, cfg):
    T_ = x.shape[0] * x.shape[1]
    gates = torch.softmax(P_moe._router_gates(
        torch.from_numpy(x).reshape(T_, -1), torch.from_numpy(router)),
        dim=-1)
    _, sel, _, slot, keep = P_moe._route(gates, cfg.topk,
                                         P_moe._capacity(cfg, T_))
    return [sel.numpy(), keep.numpy(), slot.numpy()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results; the reference's ``moe_ffn`` on each rank's rows
    and its gradient of the ranks' mean loss, computed while they run."""
    layers = {MOE: _layer_moe(MOE, 0), MLA: _layer_moe(MLA, 1)}
    xs = {arch: _inputs(d, seed) for seed, (arch, (_, d)) in
          enumerate(layers.items(), 5)}
    cases = {name: {"arch": arch, "cf": cf,
                    "params": params_from_numpy(layers[arch][0], "cpu"),
                    "x": [torch.from_numpy(x) for x in xs[arch]]}
             for name, (arch, cf) in CASES.items()}
    seven = {k: (v[..., :7] if k == "router" else v[:7]) if k != "shared"
             else v for k, v in layers[MOE][0].items()}
    fallback = {"arch": MOE, "cf": 4.0, "with": {"n_experts": 7},
                "params": params_from_numpy(seven, "cpu"),
                "x": cases["moe cf4"]["x"]}
    wait = start("moe_a2a", 2, tmp_path_factory.mktemp("moe_a2a"), {
        "spec": SPEC, "cases": cases, "grad_case": "moe cf4",
        "fallback": fallback})

    # one compile a capacity factor for both archs; at 4.0 the forward
    # comes with its loss sum(y ** 2) and gradient (for the MoE layer)
    for cf in (4.0, 1.0):
        assert all(getattr(_rcfg(MOE, cf), f) == getattr(_rcfg(MLA, cf), f)
                   for f in MOE_FIELDS)
    fwd = {4.0: jax.jit(jax.value_and_grad(
               lambda p, x: (lambda y: (jnp.sum(y ** 2), y))(
                   R_moe.moe_ffn(p, _rcfg(MOE, 4.0), x)), has_aux=True)),
           1.0: jax.jit(lambda p, x: R_moe.moe_ffn(p, _rcfg(MOE, 1.0), x))}
    ref, per_rank = {}, []
    for name, (arch, cf) in CASES.items():
        lp = jax.tree.map(jnp.asarray, layers[arch][0])
        ref[name] = []
        for x in xs[arch]:
            out = fwd[cf](lp, jnp.asarray(x))
            if cf == 4.0:
                (loss, y), grads = out
                if arch == MOE:
                    per_rank.append(jax.tree.map(
                        lambda t: np.asarray(t, np.float64), (loss, grads)))
                out = y
            ref[name].append(np.asarray(out))
    # the mean of the ranks' losses and gradients, averaged in f64
    loss, grads = jax.tree.map(lambda a, b: (a + b) / 2, *per_rank)
    return dict(ranks=wait(), ref=ref, layers=layers, xs=xs,
                loss=float(loss), grads=grads)


@pytest.mark.parametrize("name", list(CASES))
def test_a2a_is_moe_ffn_on_each_ranks_rows(run, name):
    """Each rank's ``moe_ffn_a2a`` output: the port's ``moe_ffn`` on its
    rows bit for bit; the reference's routing, and its output within 1e-5
    of max|y|; at capacity factor 1.0 pairs drop, at 4.0 none does and
    the ranks' rows are the whole batch's ``moe_ffn`` bit for bit; two
    all-to-alls, no other collective."""
    arch, cf = CASES[name]
    params = params_from_numpy(run["layers"][arch][0], "cpu")
    pcfg, rcfg = _pcfg(arch, cf), _rcfg(arch, cf)
    outs, dropped = [], 0
    for r, out in enumerate(run["ranks"]):
        y, counts = out[name]
        x = run["xs"][arch][r]
        assert counts == {"pmean": 0, "all_gather_cat": 0,
                          "all_to_all": 2, "all_gather_rows": 0}
        own = P_moe.moe_ffn(params, pcfg, torch.from_numpy(x))
        assert y.dtype == torch.float32 and torch.equal(y, own)
        p_route = _port_routing(x, run["layers"][arch][0]["router"], pcfg)
        r_route = _ref_routing(x, run["layers"][arch][0]["router"], rcfg)
        for a, b in zip(p_route, r_route):
            np.testing.assert_array_equal(a, b)
        dropped += int((~p_route[1]).sum())
        ref = run["ref"][name][r]
        assert y.shape == ref.shape and torch.isfinite(y).all()
        assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        outs.append(y)
    assert (dropped > 0) == (cf == 1.0)
    if cf == 4.0:
        whole = P_moe.moe_ffn(params, pcfg, torch.from_numpy(
            np.concatenate(run["xs"][arch])))
        assert torch.equal(torch.cat(outs), whole)


def test_a2a_gradients_average_to_the_reference(run):
    """``sum(y ** 2)`` on each rank's rows, back through both
    all-to-alls, averaged over ``data``: every leaf (router, the three
    expert stacks, the shared expert) within 1e-5 of its max|g| of the
    reference's gradient of the ranks' mean loss, bitwise equal on both
    ranks; before the mean each rank's expert stacks are zero outside its
    own 4 experts; 2 all-to-alls forward, 2 backward."""
    ref = run["grads"]
    for r, out in enumerate(run["ranks"]):
        g = out["grad"]
        zero = {"pmean": 0, "all_gather_cat": 0, "all_gather_rows": 0}
        assert g["fwd"] == g["bwd"] == {**zero, "all_to_all": 2}
        assert abs(float(g["loss"]) - run["loss"]) <= 1e-6 * run["loss"]
        for key in ("w_gate", "w_up", "w_down"):
            own = g["own"][key]
            mine = slice(4 * r, 4 * r + 4)
            assert own[mine].abs().max() > 0
            assert not torch.cat([own[:4 * r], own[4 * r + 4:]]).any()
        got, want = P_tree.leaves(g["grads"]), jax.tree.leaves(ref)
        assert len(got) == len(want) == 7
        for p, w in zip(got, want):
            assert tuple(p.shape) == w.shape
            assert np.abs(p.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert all(torch.equal(a, b) for a, b in zip(
        P_tree.leaves(run["ranks"][0]["grad"]["grads"]),
        P_tree.leaves(run["ranks"][1]["grad"]["grads"])))


def test_a2a_remat_backward_on_another_thread(run):
    """The gradient case under non-reentrant ``torch.utils.checkpoint``,
    its backward run on a thread of its own (autograd runs a CUDA
    backward, and the recompute inside it, on a device thread): the
    recompute and the backward see the rank's mesh, so each rank's
    gradients equal the unchecked run's bit for bit, and the all-to-alls
    are 2 in the forward, 2 in the recompute, 2 in the backward."""
    for out in run["ranks"]:
        got = out["remat_thread"]
        assert got["raised"] == []
        assert got["counts"] == {"pmean": 0, "all_gather_cat": 0,
                                 "all_to_all": 6, "all_gather_rows": 0}
        assert all(torch.equal(a, b) for a, b in zip(
            P_tree.leaves(got["grads"]), P_tree.leaves(out["grad"]["own"])))


def test_a2a_with_indivisible_experts_is_the_scatter_path(run):
    """7 experts over a data axis of 2: ``moe_ffn``'s output bit for bit
    and no all-to-all (the reference's fallback)."""
    for out in run["ranks"]:
        equal, counts = out["fallback"]
        assert equal
        assert counts["all_to_all"] == 0
