"""The data axis of the port's training against the reference.

On 2 gloo ranks on the CPU (one spawn for the file,
``tests/torch_mesh_worker.py``'s ``training`` job), internlm2-1.8b's smoke
config under ``ozimmu_h-4:df32``:

* ``data=2``: step 0's loss and gradients, each rank's rows averaged over
  ``data``, against the reference's whole-batch ``jax.value_and_grad``
  (jitted once; f32 activations on both sides), within 1e-5 (the loss)
  and ``1e-4 * max|g|`` a leaf.  Not bitwise: a weight's cotangent
  contracts over the tokens, and the emulation's split scales follow the
  tokens a rank holds; 1e-4 is the tolerance the single-process port is
  held to (``tests/test_torch_train.py``).  The ranks' averaged
  gradients are bitwise equal; so are their parameters after every step
  of ``train.main([..., "--mesh", "data=2"])``, whose losses track the
  one-process run within 1e-3;
* ZeRO-1: the sharded AdamW update bitwise the unsharded one on the same
  gradients (parameters, and each rank's slices of the moments and the
  master copy); the split dim of every family's smoke parameters equal to
  the reference's ``optim.zero_axes`` (no rules, divisor 2);
* the checkpoint: written at ``data=2`` and restored on one process, and
  the reverse, bit for bit;
* ``optim.compress``: ``compress`` / ``decompress`` bitwise to the
  reference's over 3 error-feedback steps, ``compressed_psum`` bitwise to
  the reference's under ``jax.vmap(axis_name="data")`` on the same two
  shards;
* ``model=2``: ``train.main`` under ``ozimmu_h-4:df32@model`` gives the
  one-process losses under ``ozimmu_h-4:df32`` bitwise on both ranks
  (the ``@model`` contractions' contract);
* the MoE all-to-all: deepseek-moe-16b's smoke config at
  ``capacity_factor=4.0`` (nothing drops, on a rank or in the whole
  batch) on ``data=2``, its experts' tokens exchanged by all-to-all
  (``moe_dispatch="a2a"``), seeded parameters of the port's ``init``:
  step 0's averaged loss under ``ozimmu_h-4:df32`` within 1e-5 and every
  gradient leaf within ``1e-3 * max|g|`` of the reference's whole-batch
  ``jax.value_and_grad`` under its native ``f32`` engine (f32
  activations; one MoE layer is held to the reference under the same
  emulated spec in ``tests/test_torch_moe_a2a.py``), the ranks' averaged
  gradients bitwise equal, the all-to-alls of a rank's step exact (two a
  layer in the forward, in the remat recompute and in the backward), and
  ``train.main --mesh data=2`` on the arch keeping the ranks' parameters
  bitwise equal after each step.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro import optim as R_optim
from repro.launch import steps as R_steps
from repro.models import api as R_api
from repro.optim import compress as R_compress
from repro_torch import configs as P_configs
from repro_torch import optim as P_optim
from repro_torch import tree as P_tree
from repro_torch.checkpoint import Checkpointer as P_Checkpointer
from repro_torch.launch import steps as P_steps
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import compress as P_compress
from tests.torch_mesh_worker import start

torch.set_num_threads(1)

ARCH = "internlm2_1_8b"
SPEC = "ozimmu_h-4:df32"
N_LEAVES = 12                    # the smoke model's parameter leaves
MOE = "deepseek_moe_16b"
MOE_CF = 4.0
# the MoE model's whole-batch reference runs its native f32 engine: under
# SPEC its jit takes ~35 s on the CPU, under f32 ~3 s
MOE_REF_SPEC = "f32"


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _shards(seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        w = rng.standard_normal((8, 16)).astype(np.float32)
        w[3] = 0.0                                   # a zero row
        out.append({"w": w,
                    "b": rng.standard_normal(16).astype(np.float32) * 1e-3,
                    "t": rng.standard_normal((2, 3, 8)).astype(np.float32)})
    return out


def _reference(params, toks, arch=ARCH, spec=SPEC, **overrides):
    """The reference's whole-batch loss and gradients under ``spec`` (f32
    activations), jitted."""
    cfg = R_configs.get_config(arch, smoke=True, engine_spec=spec,
                               dtype="float32", **overrides)
    model = R_api.get_model(cfg)

    def loss_fn(p):
        return R_api.next_token_loss(
            model.forward(p, cfg, {"tokens": jnp.asarray(toks)}),
            jnp.asarray(toks))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.tree.leaves(_np(grads))


def _one_process_checkpoint(params, toks, path):
    """A one-process checkpoint of a port TrainState after one AdamW
    step (nonzero moments) at ``path``; returns the state."""
    cfg = P_configs.get_config(ARCH, smoke=True, engine_spec=SPEC)
    _, grads = P_steps.loss_and_grads(cfg, params, {"tokens": toks})
    ocfg = P_optim.OptConfig()
    params, opt, _ = P_optim.step(grads, params, P_optim.init(params, ocfg),
                                  ocfg)
    state = P_steps.TrainState(params, opt,
                               torch.ones((), dtype=torch.int32))
    P_Checkpointer(path).save(1, state, blocking=True)
    return state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, with the reference's whole-batch step computed
    while they run: the reference's smoke parameters, a batch of 4 x 16,
    and a one-process checkpoint for the ranks to restore."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    cfg = R_configs.get_config(ARCH, smoke=True)
    r_params, _ = R_api.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    params = params_from_numpy(_np(r_params), "cpu")
    toks = np.random.default_rng(9).integers(0, 256, (4, 16),
                                             dtype=np.int32)
    one = _one_process_checkpoint(params, torch.from_numpy(toks),
                                  str(tmp / "one_ckpt"))
    moe_cfg = P_configs.get_config(MOE, smoke=True)
    moe_params = P_api.get_model(moe_cfg).init(
        moe_cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    moe_toks = np.random.default_rng(10).integers(0, 256, (4, 16),
                                                  dtype=np.int32)
    wait = start("training", 2, tmp, {
        "moe": {"spec": SPEC, "cf": MOE_CF,
                "params": moe_params,
                "tokens": torch.from_numpy(moe_toks)},
        "spec": SPEC, "params": params, "tokens": torch.from_numpy(toks),
        "one_ckpt": str(tmp / "one_ckpt"),
        "mesh_ckpt": str(tmp / "mesh_ckpt"),
        "shards": [{k: torch.from_numpy(v) for k, v in s.items()}
                   for s in _shards()]})
    loss, grads = _reference(r_params, toks)
    moe = _reference(P_tree.tree_map(lambda t: t.numpy(), moe_params),
                     moe_toks, MOE, spec=MOE_REF_SPEC,
                     capacity_factor=MOE_CF)
    return dict(ranks=wait(), loss=loss, grads=grads, one_ckpt=one,
                mesh_ckpt=str(tmp / "mesh_ckpt"), moe=moe)


def _rel(out, ref_):
    out, ref_ = np.asarray(out, np.float64), np.asarray(ref_, np.float64)
    return np.abs(out - ref_).max() / max(np.abs(ref_).max(), 1e-300)


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# data=2: the batch split and the gradient mean
# ---------------------------------------------------------------------------

def test_data_split_step0_matches_reference_whole_batch(run):
    """Step 0 on 2 x 2 rows, averaged over ``data``, against the
    reference's step on the 4 rows: the loss within 1e-5, each gradient
    leaf within 1e-4 of its max|g|; the ranks agree bit for bit; one f32
    SUM a leaf and one for the loss."""
    out = run["ranks"]
    for r in out:
        assert abs(r["loss"] - run["loss"]) <= 1e-5
        assert len(r["grads"]) == len(run["grads"]) == N_LEAVES
        for p, g in zip(r["grads"], run["grads"]):
            assert tuple(p.shape) == g.shape
            assert _rel(p.numpy(), g) <= 1e-4
    assert out[0]["loss"] == out[1]["loss"]
    assert _equal(out[0]["grads"], out[1]["grads"])
    assert out[0]["mean_counts"] == {"pmean": N_LEAVES + 1,
                                     "all_gather_cat": 0, "all_to_all": 0,
                                     "all_gather_rows": 0}


def test_data_split_train_keeps_ranks_bitwise_equal(run):
    """``train.main`` with ``--mesh data=2``: both ranks' parameters equal
    bit for bit after each of 3 steps, the same losses on both, within
    1e-3 of the one-process run (the averaged gradients are not bitwise
    the whole batch's)."""
    out = run["ranks"]
    a, b = out[0]["train_params"], out[1]["train_params"]
    assert len(a) == len(b) == 3
    for pa, pb in zip(a, b):
        assert _equal(pa, pb)
    assert not _equal(a[0], a[2])
    assert out[0]["train"] == out[1]["train"]
    np.testing.assert_allclose(out[0]["train"], out[0]["single"], rtol=0,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def test_zero1_update_bitwise_unsharded(run):
    """Two AdamW steps (clipping, warmup, the f32 master copy) on sharded
    state == on whole state: parameters bitwise, each rank's moment and
    master slices bitwise the whole state's slices; one gather a
    parameter."""
    out = run["ranks"]
    for r in out:
        whole, zero = r["zero"]["params"]
        assert _equal(whole, zero)
        whole_slices, slices = r["zero"]["state"]
        assert _equal([t.contiguous() for t in whole_slices], slices)
        assert all(d is not None for d in r["zero_axes"])
        assert r["zero_counts"] == {"pmean": 0,
                                    "all_gather_cat": N_LEAVES,
                                    "all_to_all": 0, "all_gather_rows": 0}
    # the ranks hold different halves of the same state
    assert not _equal(out[0]["zero"]["state"][1], out[1]["zero"]["state"][1])


def _zero_dims_reference(arch):
    cfg = R_configs.get_config(arch, smoke=True)
    shapes, axes = R_steps.params_shapes(cfg)
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        e is None or isinstance(e, str) for e in x)
    aug = jax.tree.leaves(R_optim.zero_axes(axes, shapes, 2),
                          is_leaf=is_axes)
    assert len(aug) == len(jax.tree.leaves(shapes))
    return [a.index("zero") if "zero" in a else None for a in aug]


@pytest.mark.parametrize("arch", P_configs.ARCH_IDS)
def test_zero_dims_match_reference(arch):
    """The dim each parameter's ZeRO-1 state is split on, against the
    reference's ``zero_axes`` with no rules installed (divisor 2)."""
    cfg = P_configs.get_config(arch, smoke=True)
    params = P_api.get_model(cfg).init(cfg, generator=torch.Generator(),
                                       device="meta")
    assert P_optim.zero_axes(params, 2) == _zero_dims_reference(arch)


# ---------------------------------------------------------------------------
# the checkpoint across meshes
# ---------------------------------------------------------------------------

def test_checkpoint_written_on_two_ranks_restores_on_one(run):
    """``train.main --mesh data=2 --ckpt-dir``'s last checkpoint (rank 0
    wrote the gathered state) restores into a one-process TrainState: the
    parameters are the ranks' last ones, and rank r's moment slices are
    the r-th halves of the restored moments, bit for bit."""
    out, path = run["ranks"], run["mesh_ckpt"]
    cfg = P_configs.get_config(ARCH, smoke=True)
    like = P_steps.init_state(cfg, P_optim.OptConfig(),
                              torch.Generator().manual_seed(0), "cpu")
    restored, step = P_Checkpointer(path).restore(like)
    assert step == 3
    assert _equal(P_tree.leaves(restored.params),
                  out[0]["train_params"][-1])
    dims = out[0]["zero_axes"]
    for r, rank in enumerate(out):
        state = rank["train_state"]
        for whole, mine, d in zip(P_tree.leaves((restored.opt.mu,
                                                 restored.opt.nu)),
                                  state, dims * 2):
            half = whole.shape[d] // 2
            assert torch.equal(whole.narrow(d, r * half, half), mine)


def test_checkpoint_written_on_one_process_restores_on_two(run):
    """A one-process checkpoint restored on each ``data=2`` rank: the
    parameters whole, the moments as the rank's halves, bit for bit."""
    out = run["ranks"]
    whole = P_tree.leaves(run["one_ckpt"])
    n = N_LEAVES
    for r, rank in enumerate(out):
        step, leaves = rank["restored"]
        assert step == 1 and len(leaves) == len(whole)
        assert _equal(leaves[:n], whole[:n])
        for w, mine, d in zip(whole[n:3 * n], leaves[n:3 * n],
                              rank["zero_axes"] * 2):
            half = w.shape[d] // 2
            assert torch.equal(w.narrow(d, r * half, half), mine)
        assert _equal(leaves[3 * n:], whole[3 * n:])


# ---------------------------------------------------------------------------
# optim.compress
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 16), (16,), (2, 3, 8)])
def test_compress_matches_reference(shape):
    """Three error-feedback steps: digits, row scales, residuals and the
    decompressed gradient bitwise the reference's."""
    rng = np.random.default_rng(11)
    r_err = jnp.zeros(shape, jnp.float32)
    p_err = torch.zeros(shape)
    for _ in range(3):
        g = rng.standard_normal(shape).astype(np.float32)
        rd, rs, r_err = R_compress.compress(jnp.asarray(g), r_err)
        pd, ps, p_err = P_compress.compress(torch.from_numpy(g), p_err)
        for p, r in ((pd, rd), (ps, rs), (p_err, r_err)):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        rows = rd.shape[0]
        np.testing.assert_array_equal(
            P_compress.decompress(pd, ps, shape).numpy(),
            np.asarray(R_compress.decompress(rd, rs, shape)))
        assert rows == (1 if len(shape) == 1 else int(np.prod(shape[:-1])))


def test_compressed_psum_matches_reference(run):
    """Three steps of ``compressed_psum`` with error feedback on each
    rank's shard == the reference's body under ``jax.vmap(axis_name=
    "data")`` on the stacked shards: means and residuals bitwise, two
    collectives a leaf a step."""
    out = run["ranks"]
    shards = _shards()
    stacked = {k: jnp.asarray(np.stack([s[k] for s in shards]))
               for k in shards[0]}
    fn = jax.jit(jax.vmap(lambda g, e: R_compress.compressed_psum(g, e,
                                                                  "data"),
                          axis_name="data"))
    err = jax.tree.map(jnp.zeros_like, stacked)
    for step in range(3):
        mean, err = fn(stacked, err)
        for r, rank in enumerate(out):
            p_mean, p_err = rank["psum"][step]
            for key in stacked:
                np.testing.assert_array_equal(p_mean[key].numpy(),
                                              np.asarray(mean[key][r]))
                np.testing.assert_array_equal(p_err[key].numpy(),
                                              np.asarray(err[key][r]))
    assert out[0]["psum_counts"] == {"pmax_scales": 9,
                                     "psum_exact_int32": 9,
                                     "psum_df32": 0, "psum_compensated": 0}


# ---------------------------------------------------------------------------
# model=2
# ---------------------------------------------------------------------------

def test_train_model_axis_gives_single_device_losses(run):
    """``train.main --mesh model=2`` under ``ozimmu_h-4:df32@model``: both
    ranks' 3 losses (the third after a nonzero update) equal the
    one-process run's under ``ozimmu_h-4:df32``, bit for bit."""
    out = run["ranks"]
    assert len(out[0]["single"]) == 3
    for r in out:
        assert r["model"] == out[0]["single"]


# ---------------------------------------------------------------------------
# the MoE all-to-all
# ---------------------------------------------------------------------------

def test_moe_a2a_step0_matches_reference_whole_batch(run):
    """deepseek-moe-16b (2 layers of 8 experts, top 2) at capacity factor
    4.0 on 2 x 2 rows, the experts' tokens exchanged by all-to-all,
    averaged over ``data``, under ``ozimmu_h-4:df32``: the loss within
    1e-5 and each of the 16 gradient leaves within 1e-3 of its max|g| of
    the reference's step on the 4 rows under its native f32 engine; the
    ranks agree bit for bit; two all-to-alls a layer in
    the forward, two in its remat recompute, two in the backward."""
    out = run["ranks"]
    loss, grads = run["moe"]
    for r in out:
        m = r["moe"]
        assert abs(m["loss"] - loss) <= 1e-5
        assert len(m["grads"]) == len(grads) == 16
        for p, g in zip(m["grads"], grads):
            assert tuple(p.shape) == g.shape
            assert _rel(p.numpy(), g) <= 1e-3
        assert m["counts"] == {"pmean": 0, "all_gather_cat": 0,
                               "all_to_all": 3 * 2 * 2,
                               "all_gather_rows": 0}
    assert out[0]["moe"]["loss"] == out[1]["moe"]["loss"]
    assert _equal(out[0]["moe"]["grads"], out[1]["moe"]["grads"])


def test_moe_a2a_train_keeps_ranks_bitwise_equal(run):
    """``train.main --arch deepseek_moe_16b --mesh data=2`` (capacity
    factor 4.0): both ranks' parameters equal bit for bit after each of 2
    steps, finite losses equal on both."""
    out = run["ranks"]
    a, b = out[0]["moe"]["train_params"], out[1]["moe"]["train_params"]
    assert len(a) == len(b) == 2
    for pa, pb in zip(a, b):
        assert _equal(pa, pb)
    assert not _equal(a[0], a[1])
    losses = out[0]["moe"]["train"]
    assert losses == out[1]["moe"]["train"] and len(losses) == 2
    assert np.isfinite(losses).all()
