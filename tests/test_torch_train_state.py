"""Training of the state families (mamba2-780m ``ssm``, recurrentgemma-9b
``hybrid``) against the reference.

The reference's ``smoke()`` parameters are carried across (the tied
heads' ``embed`` scaled by 0.05, as the serving tests do: at the init's
scale the head echoes the last token and the loss saturates) and one
numpy batch of the pipeline goes through both, in f32 activations:

* ``ssd_chunked``'s gradients (x, dt, A, B, C, over a length no chunk
  divides, from the output and the final state) within ``1e-5 * max|g|``;
* ``rg_lru``'s and ``recurrent_block``'s gradients at the reference's
  scan-vs-step tolerance, :data:`SCAN_TOL` of max|g|: the port scans
  sequentially, the reference in log space (``lax.associative_scan``),
  and the two orders round differently;
* the loss within 1e-6 of its value, relative, and every gradient leaf
  within ``1e-5 * max|g|`` (``f32``) and ``1e-4 * max|g|``
  (``ozimmu_h-4:df32``) against ``jax.value_and_grad`` -- the hybrid's
  leaves at :data:`SCAN_TOL` under both engines -- at 16 positions (one
  SSD chunk, inside the attention's window of 32) and, under ``f32``, at
  40 (two SSD chunks, the last padded; past the hybrid's window);
* gradients bitwise equal across remat blocks of 1 and 2 layers (pattern
  blocks for the hybrid) under ``:fused``;
* the kernel launches of one smoke train step under ``:fused``, counted at
  the wrappers, equal to ``chip_smoke.train_step_launches``;
* a cut hybrid (one pattern block, no tail layer: the card phase's cut)
  trains, and its unused tail stack gets the reference's zero gradients;
* a hybrid ``TrainState`` (its two-level block stacks) checkpointed by
  either package restores into the other leaf for leaf.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro import optim as R_optim
from repro.checkpoint import Checkpointer as R_Checkpointer
from repro.launch import steps as R_steps
from repro.models import hybrid as R_hybrid
from repro.models import ssm as R_ssm
from repro_torch import configs as P_configs
from repro_torch import optim as P_optim
from repro_torch import tree as P_tree
from repro_torch.checkpoint import Checkpointer as P_Checkpointer
from repro_torch.launch import steps as P_steps
from repro_torch.models import hybrid as P_hybrid
from repro_torch.models import ssm as P_ssm
from repro_torch.models.convert import params_from_numpy
from tests.torch_parity import (_rel, ref_train_params, remat_gradients,
                                train_batch, train_launches, train_parity)

torch.set_num_threads(1)

ARCHS = ["mamba2_780m", "recurrentgemma_9b"]
# the reference's own scan-vs-step tolerance (rtol 1e-4,
# tests/test_models.py), read against each leaf's max|g|
SCAN_TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    return request.param, ref_train_params(request.param)


def _grads_ref(fn, args):
    return jax.jit(jax.grad(fn, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))


def _grads_port(fn, args):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    fn(*ts).backward()
    return [t.grad for t in ts]


def test_ssd_chunked_gradients():
    """x, dt, A, B, C of the chunked scan over L = 37 in chunks of 8 (the
    last padded), from a seeded projection of y and of the final state."""
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    Bb, Lq, H, P, N = 2, 37, 4, 16, 16
    x, B, C = f(Bb, Lq, H, P), f(Bb, Lq, N), f(Bb, Lq, N)
    dt = np.log1p(np.exp(f(Bb, Lq, H) - 2.0)).astype(np.float32)
    A = -np.exp(np.linspace(0.0, 2.7, H)).astype(np.float32)
    wy, wh = f(Bb, Lq, H, P), f(Bb, H, P, N)

    def r_loss(*a):
        y, h = R_ssm.ssd_chunked(*a, 8)
        return (y * wy).sum() + (h * wh).sum()

    def p_loss(*a):
        y, h = P_ssm.ssd_chunked(*a, 8)
        return (y * torch.from_numpy(wy)).sum() + \
            (h * torch.from_numpy(wh)).sum()
    args = (x, dt, A, B, C)
    for r, p in zip(_grads_ref(r_loss, args), _grads_port(p_loss, args)):
        assert _rel(p.numpy(), r) <= 1e-5


def _lru_layer(params):
    return {k: v[0, 1] for k, v in params["blocks"]["r_layers"].items()}


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rg_lru_gradients(with_h0):
    """The recurrence's gradients (its parameters, x and h0) over 40
    positions, the sequential scan against the reference's associative
    scan."""
    lp = _lru_layer(ref_train_params("recurrentgemma_9b"))
    names = ["lambda", "lru_a", "lru_a_b", "lru_x_b"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    wy, wh = (rng.standard_normal(s).astype(np.float32)
              for s in ((2, 40, 64), (2, 64)))
    args = [lp[n] for n in names] + [x] + ([h0] if with_h0 else [])

    def loss(mod, *a):
        p = dict(zip(names, a[:len(names)]))
        y, h = mod.rg_lru(p, a[len(names)], a[-1] if with_h0 else None)
        tw = torch.from_numpy if mod is P_hybrid else jnp.asarray
        return (y * tw(wy)).sum() + (h * tw(wh)).sum()
    ref = _grads_ref(lambda *a: loss(R_hybrid, *a), args)
    port = _grads_port(lambda *a: loss(P_hybrid, *a), args)
    for r, p in zip(ref, port):
        assert _rel(p.numpy(), r) <= SCAN_TOL


@pytest.mark.parametrize("spec", ["f32", "ozimmu_h-4:df32"])
def test_recurrent_block_gradients(spec):
    """The Griffin recurrent block (both engine projections of x, the
    conv, the RG-LRU, the gate and ``w_out``) over 40 positions: every
    parameter's and x's gradient."""
    params = ref_train_params("recurrentgemma_9b")
    lp = {k: v[1, 0] for k, v in params["blocks"]["r_layers"].items()}
    names = sorted(lp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    w = rng.standard_normal((2, 40, 64)).astype(np.float32)
    rcfg = R_configs.get_config("recurrentgemma_9b", smoke=True,
                                engine_spec=spec, dtype="float32")
    pcfg = P_configs.get_config("recurrentgemma_9b", smoke=True,
                                engine_spec=spec, dtype="float32")
    args = [lp[n] for n in names] + [x]

    def r_loss(*a):
        return (R_hybrid.recurrent_block(dict(zip(names, a[:-1])), rcfg,
                                         a[-1])[0] * w).sum()

    def p_loss(*a):
        return (P_hybrid.recurrent_block(dict(zip(names, a[:-1])), pcfg,
                                         a[-1])[0] *
                torch.from_numpy(w)).sum()
    ref = _grads_ref(r_loss, args)
    for name, r, p in zip(names + ["x"], ref, _grads_port(p_loss, args)):
        assert _rel(p.numpy(), r) <= SCAN_TOL, name


@pytest.mark.parametrize("spec,tol,seq", [("f32", 1e-5, 16),
                                          ("ozimmu_h-4:df32", 1e-4, 16),
                                          ("f32", 1e-5, 40)],
                         ids=["f32", "ozimmu_h-4:df32", "f32-L40"])
def test_gradients_match_reference(arch_params, spec, tol, seq):
    arch, params = arch_params
    if arch == "recurrentgemma_9b":
        tol = SCAN_TOL
    rloss, ploss, leaves = train_parity(arch, spec, params,
                                        train_batch(arch, seq_len=seq))
    assert abs(ploss - rloss) <= 1e-6 * abs(rloss)
    bad = [(path, rel) for path, rel in leaves if not rel <= tol]
    assert not bad, bad


def test_remat_blocks_give_equal_gradients(arch_params):
    arch, params = arch_params
    (l1, g1), (l2, g2) = remat_gradients(arch, params, train_batch(arch))
    assert float(l1) == float(l2)
    for a, b in zip(P_tree.leaves(g1), P_tree.leaves(g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launch_counts(monkeypatch, arch):
    """mamba2-780m ``smoke()``: ``w_in`` and ``w_out`` a layer, forward,
    recompute and both cotangents, and the tied head's 3 (19 a step);
    recurrentgemma-9b: 18 a pattern block forward and recompute, 5 a tail
    layer forward, 35 / 10 backward, and the head's 3 (164)."""
    counts, want, n = train_launches(monkeypatch, arch)
    assert n == {"mamba2_780m": 19, "recurrentgemma_9b": 164}[arch]
    assert counts == want


CUT = dict(n_pattern_blocks=1, n_tail_layers=0, n_layers=3)


def test_cut_hybrid_trains_with_zero_tail_gradients():
    """One pattern block and no tail layer, as the card phase cuts the
    published config: the tail stack the init keeps (one R layer) is
    never read, and gets the reference's zero gradients; every other leaf
    within :data:`SCAN_TOL`; then a train step runs."""
    arch = "recurrentgemma_9b"
    rcfg = R_configs.get_config(arch, smoke=True, dtype="float32", **CUT)
    params, _ = R_hybrid.init(jax.random.PRNGKey(3), rcfg)
    params = jax.tree.map(np.array, params)
    params["embed"] *= np.float32(0.05)
    rloss, ploss, leaves = train_parity(arch, "f32", params,
                                        train_batch(arch), **CUT)
    assert abs(ploss - rloss) <= 1e-6 * abs(rloss)
    assert not [(p, r) for p, r in leaves if not r <= SCAN_TOL]
    pcfg = P_configs.get_config(arch, smoke=True, dtype="float32", **CUT)
    pparams = params_from_numpy(params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(arch).items()}
    _, grads = P_steps.loss_and_grads(pcfg, pparams, batch)
    for name in ("tail_r", "tail_m"):
        assert all(not g.any() for g in P_tree.leaves(grads[name]))
    state = P_steps.TrainState(pparams, P_optim.init(pparams,
                                                     P_optim.OptConfig()),
                               torch.zeros((), dtype=torch.int32))
    _, metrics = P_steps.make_train_step(pcfg, P_optim.OptConfig())(
        state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))


def test_hybrid_checkpoints_cross_between_packages(tmp_path):
    """A reference checkpoint of the hybrid's smoke TrainState (AdamW with
    f32 masters) restores into the port's leaf for leaf, the port writes
    the same manifest back, and the reference restores the port's."""
    arch = "recurrentgemma_9b"
    ocfg = dict(master_f32=True)
    rstate, _, _ = R_steps.init_state(
        jax.random.PRNGKey(1), R_configs.get_config(arch, smoke=True),
        R_optim.OptConfig(**ocfg))
    pstate = P_steps.init_state(P_configs.get_config(arch, smoke=True),
                                P_optim.OptConfig(**ocfg),
                                torch.Generator().manual_seed(1), "cpu")
    R_Checkpointer(str(tmp_path / "ref")).save(0, rstate, blocking=True)
    restored, step = P_Checkpointer(str(tmp_path / "ref")).restore(pstate)
    assert step == 0 and isinstance(restored, P_steps.TrainState)
    rleaves = jax.tree.leaves(rstate)
    assert len(rleaves) == len(P_tree.leaves(restored))
    for r, p in zip(rleaves, P_tree.leaves(restored)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert restored.params["blocks"]["r_layers"]["w_x"].shape[:2] == (2, 2)
    P_Checkpointer(str(tmp_path / "port")).save(0, restored, blocking=True)
    manifests = [json.loads((tmp_path / d / "step_00000000" /
                             "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    back, _ = R_Checkpointer(str(tmp_path / "port")).restore(rstate)
    for r, b in zip(rleaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(r))
