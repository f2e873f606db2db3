"""The port's training path against the reference.

Same numpy inputs through the JAX reference (x64 on) and the port on the
CPU (the kernels' plain versions).  The differentiable emulated GEMM and
flash attention are held in ``tests/test_torch_train_vjp.py``; here:

* ``next_token_loss`` within 1e-6, the smoke model's gradients within
  ``1e-5 * max|g|`` (``f32``) and ``1e-4 * max|g|`` (``ozimmu_h-4:df32``)
  of each leaf, and bitwise across remat blocks of 1 and 2 layers;
* AdamW within 1e-6 relative over three steps (clipping and warmup
  active), ``lr_at`` equal;
* ``Pipeline.batch_at`` equal; checkpoints written by either package
  restore into the other; ``train()`` from a reference checkpoint within
  1e-4 of the reference's losses, restart-equivalent bit for bit, and
  microbatched within 1e-6;
* the kernel launches of one smoke train step under ``:fused``, counted
  at the kernel wrappers.

Model activations are f32 where gradients are compared (the two
frameworks round bf16 activations at different places).
"""
import json
import math
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro import optim as R_optim
from repro.checkpoint import Checkpointer as R_Checkpointer
from repro.data import pipeline as R_data
from repro.launch import steps as R_steps
from repro.models import api as R_api
from repro_torch import configs as P_configs
from repro_torch import optim as P_optim
from repro_torch import tree as P_tree
from repro_torch.checkpoint import Checkpointer as P_Checkpointer
from repro_torch.data import pipeline as P_data
from repro_torch.launch import steps as P_steps
from repro_torch.launch import train as P_train
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCH = "internlm2_1_8b"


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---------------------------------------------------------------------------
# the loss and the model's gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_next_token_loss(masked):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 7, 256)).astype(np.float32) * 4
    toks = rng.integers(0, 250, (3, 7), dtype=np.int32)
    mask = (rng.uniform(size=(3, 7)) < 0.6).astype(np.int32) if masked \
        else None
    ref = R_api.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                                None if mask is None else jnp.asarray(mask))
    out = P_api.next_token_loss(torch.from_numpy(logits),
                                torch.from_numpy(toks),
                                None if mask is None
                                else torch.from_numpy(mask))
    assert abs(float(out) - float(ref)) <= 1e-6


def _smoke(spec, **kw):
    rcfg = R_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype="float32", **kw)
    pcfg = P_configs.get_config(ARCH, smoke=True, engine_spec=spec,
                                dtype="float32", **kw)
    return rcfg, pcfg


@pytest.fixture(scope="module")
def smoke_params():
    rcfg, _ = _smoke("f32")
    params, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    return jax.tree.map(np.asarray, params)


def _tokens(shape=(2, 16), seed=9):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("spec,tol", [("f32", 1e-5),
                                      ("ozimmu_h-4:df32", 1e-4)])
def test_model_gradients_match_reference(smoke_params, spec, tol):
    """``jax.grad`` of ``next_token_loss . forward`` against the port's
    autograd (remat blocks on both sides), leaf by leaf."""
    rcfg, pcfg = _smoke(spec)
    toks = _tokens()
    model = R_api.get_model(rcfg)

    def loss_fn(p):
        return R_api.next_token_loss(
            model.forward(p, rcfg, {"tokens": jnp.asarray(toks)}),
            jnp.asarray(toks))

    rloss, rgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, smoke_params))
    ploss, pgrads = P_steps.loss_and_grads(
        pcfg, params_from_numpy(smoke_params, device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    assert abs(float(ploss) - float(rloss)) <= 1e-5
    rflat, pflat = jax.tree.leaves(rgrads), P_tree.leaves(pgrads)
    assert len(rflat) == len(pflat)
    for r, p in zip(rflat, pflat):
        assert p.shape == r.shape
        assert _rel(p.numpy(), r) <= tol


def test_remat_blocks_give_equal_gradients(smoke_params):
    """Remat blocks of 1 and 2 layers recompute the same forward: the
    port's gradients are bitwise equal under ``:fused``."""
    _, pcfg = _smoke("ozimmu_h-4:df32:fused")
    toks = {"tokens": torch.from_numpy(_tokens())}
    params = params_from_numpy(smoke_params, device="cpu")
    outs = [P_steps.loss_and_grads(pcfg.with_(remat_block=rb), params, toks)
            for rb in (1, 2)]
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(P_tree.leaves(outs[0][1]), P_tree.leaves(outs[1][1])):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError):
        P_steps.loss_and_grads(pcfg.with_(remat_block=3), params, toks)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "layers": {"b": (rng.standard_normal((2, 3)) * scale).astype(
                np.float32)},
            "a": (rng.standard_normal((4,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("master_f32", [False, True])
def test_adamw_matches_reference(master_f32):
    """Three steps on the same params, grads and state: clipping active
    (|g| ~ 30 against a clip of 1) and the warmup ramp under way."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
                  master_f32=master_f32)
    rcfg, pcfg = R_optim.OptConfig(**cfg_kw), P_optim.OptConfig(**cfg_kw)
    rng = np.random.default_rng(10)
    params = _opt_tree(rng)
    rp = jax.tree.map(jnp.asarray, params)
    pp = params_from_numpy(params, device="cpu")
    rs, ps = R_optim.init(rp, None, rcfg), P_optim.init(pp, pcfg)
    for _ in range(3):
        grads = _opt_tree(rng, scale=10.0)
        rp, rs, rm = R_optim.step(jax.tree.map(jnp.asarray, grads), rp, rs,
                                  rcfg)
        pp, ps, pm = P_optim.step(params_from_numpy(grads, device="cpu"), pp,
                                  ps, pcfg)
        assert float(rm["grad_norm"]) > 1.0           # clipping active
        assert float(pm["lr"]) == float(rm["lr"])
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * float(rm["grad_norm"])
        for r, p in zip(jax.tree.leaves((rp, rs)), P_tree.leaves((pp, ps))):
            assert tuple(p.shape) == tuple(r.shape)
            if p.dtype == torch.int32:
                assert int(p) == int(r)
            else:
                assert _rel(p.numpy(), r) <= 1e-6


def test_lr_schedule_equal():
    """Every step of a warmup + cosine schedule, against the reference's
    eager ``lr_at``.  The port rounds an f64 cosine to f32, which XLA's
    f32 cosine equals at every argument here (and at 99.6% of the steps
    of a 1000-step schedule); PyTorch's own f32 cosine differs by an ulp
    more often."""
    kw = dict(lr=3e-3, warmup_steps=3, total_steps=12, min_lr_frac=0.1)
    rcfg, pcfg = R_optim.OptConfig(**kw), P_optim.OptConfig(**kw)
    for s in range(16):
        r = R_optim.lr_at(rcfg, jnp.asarray(s, jnp.int32))
        p = P_optim.lr_at(pcfg, torch.tensor(s, dtype=torch.int32))
        assert p.dtype == torch.float32 and float(p) == float(r), s


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source,hosts", [("synthetic", 1),
                                          ("synthetic", 2), ("file", 1)])
def test_pipeline_batches_equal(tmp_path, source, hosts):
    kw = dict(seq_len=40, global_batch=4, vocab=300, seed=4)
    if source == "file":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 60000, 5000).astype(
            np.uint16).tofile(path)
        kw["source"] = f"file:{path}"
    rcfg, pcfg = R_data.DataConfig(**kw), P_data.DataConfig(**kw)
    for host in range(hosts):
        rp = R_data.Pipeline(rcfg, host_id=host, num_hosts=hosts)
        pp = P_data.Pipeline(pcfg, host_id=host, num_hosts=hosts)
        for step in (0, 1, 7):
            r, p = rp.batch_at(step), pp.batch_at(step)
            assert sorted(r) == sorted(p)
            for key in r:
                assert p[key].dtype == r[key].dtype
                np.testing.assert_array_equal(p[key], r[key])


def _ptree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "scalar": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_roundtrip_async_and_retention(tmp_path):
    ck = P_Checkpointer(str(tmp_path / "a"))
    t = _ptree()
    ck.save(10, t, blocking=True)
    restored, step = ck.restore(t)
    assert step == 10
    for a, b in zip(P_tree.leaves(t), P_tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ck = P_Checkpointer(str(tmp_path / "b"), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _ptree(s))
    ck.wait()
    steps = ck.list_steps()
    assert steps[-1] == 4 and len(steps) <= 2
    restored, step = ck.restore(_ptree())
    assert step == 4 and torch.equal(restored["w"], _ptree(4)["w"])
    with pytest.raises(FileNotFoundError):
        P_Checkpointer(str(tmp_path / "empty")).restore(t)


def test_checkpoints_cross_between_packages(tmp_path):
    """A reference checkpoint of a smoke TrainState restores into the
    port's TrainState leaf for leaf, the port writes it back with the
    same manifest, and the reference restores the port's."""
    rcfg = R_configs.get_config(ARCH, smoke=True)
    pcfg = P_configs.get_config(ARCH, smoke=True)
    ocfg = dict(master_f32=True)
    rstate, _, _ = R_steps.init_state(jax.random.PRNGKey(1), rcfg,
                                      R_optim.OptConfig(**ocfg))
    pstate = P_steps.init_state(pcfg, P_optim.OptConfig(**ocfg),
                                torch.Generator().manual_seed(1), "cpu")
    R_Checkpointer(str(tmp_path / "ref")).save(0, rstate, blocking=True)
    restored, step = P_Checkpointer(str(tmp_path / "ref")).restore(pstate)
    assert step == 0 and isinstance(restored, P_steps.TrainState)
    rleaves = jax.tree.leaves(rstate)
    assert len(rleaves) == len(P_tree.leaves(restored))
    for r, p in zip(rleaves, P_tree.leaves(restored)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    P_Checkpointer(str(tmp_path / "port")).save(0, restored, blocking=True)
    manifests = [json.loads((tmp_path / d / "step_00000000" /
                             "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    back, _ = R_Checkpointer(str(tmp_path / "port")).restore(rstate)
    for r, b in zip(rleaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(r))


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------

TRAIN_KW = dict(smoke=True, global_batch=2, seq_len=16, log_every=0, seed=3)


def test_train_from_a_reference_checkpoint(tmp_path, monkeypatch):
    """Both trainers resume from the same step-0 checkpoint (written by
    the reference) and take 3 steps under ``f32`` (the engine and, through
    each package's config registry, the activations): the losses agree
    within 1e-4."""
    import repro_torch.configs
    from repro.launch.train import train as r_train
    for mod in (R_configs, repro_torch.configs):
        get = mod.get_config
        monkeypatch.setattr(mod, "get_config", lambda *a, _get=get, **kw:
                            _get(*a, **kw).with_(dtype="float32"))
    rcfg = R_configs.get_config(ARCH, smoke=True, engine_spec="f32")
    rstate, _, _ = R_steps.init_state(
        jax.random.PRNGKey(2), rcfg, R_optim.OptConfig(total_steps=3))
    R_Checkpointer(str(tmp_path / "r")).save(0, rstate, blocking=True)
    shutil.copytree(tmp_path / "r", tmp_path / "p")
    _, ref = r_train(ARCH, n_steps=3, ckpt_dir=str(tmp_path / "r"),
                     engine="f32", **TRAIN_KW)
    lines = []
    _, out = P_train.train(ARCH, n_steps=3, ckpt_dir=str(tmp_path / "p"),
                           engine="f32", device="cpu", print_fn=lines.append,
                           **TRAIN_KW)
    assert "[train] resumed from step 0" in lines
    assert len(out) == len(ref) == 3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert P_Checkpointer(str(tmp_path / "p")).latest_step() == 3


def test_train_restart_equivalence(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, resume and train to
    4: the resumed losses are bitwise the straight run's."""
    straight = P_train.train(ARCH, n_steps=4, device="cpu", **TRAIN_KW)[1]
    ck = str(tmp_path / "ck")
    P_train.train(ARCH, n_steps=2, ckpt_dir=ck, ckpt_every=2, device="cpu",
                  **TRAIN_KW)
    resumed = P_train.train(ARCH, n_steps=4, ckpt_dir=ck, ckpt_every=10,
                            device="cpu", **TRAIN_KW)[1]
    assert resumed == straight[2:]


def test_train_microbatches():
    """Two strided microbatches accumulate the same step as one batch."""
    one = P_train.train(ARCH, n_steps=2, device="cpu", global_batch=4,
                        seq_len=16, log_every=0, seed=5)[1]
    two = P_train.train(ARCH, n_steps=2, device="cpu", global_batch=4,
                        seq_len=16, log_every=0, seed=5, microbatches=2)[1]
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)


def test_train_step_launch_counts(monkeypatch):
    """One smoke train step under ``:fused`` launches what
    ``chip_smoke.train_step_launches`` reckons for the card (two splits and
    one df32 epilogue a contraction, a group GEMM a group-EF chunk; 2 x 9
    + 1 forward, 2 x 9 recompute and 2 x 19 + 2 backward contractions),
    counted at the kernel wrappers on the CPU."""
    import chip_smoke
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf
    counts = {"split_fused": 0, "group_gemm": 0, "scale_accum": 0}

    def counting(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    cfg = P_configs.get_config(ARCH, smoke=True,
                               engine_spec="ozimmu_h-4:df32:fused")
    B, L = 2, 16
    state = P_steps.init_state(cfg, P_optim.OptConfig(),
                               torch.Generator().manual_seed(0), "cpu")
    step = P_steps.make_train_step(cfg, P_optim.OptConfig())
    batch = {"tokens": torch.from_numpy(_tokens((B, L)))}
    counting(sf, "split_whole", "split_fused")
    counting(gg, "group_gemm", "group_gemm")
    counting(sa, "scale_accum_chunks", "scale_accum")
    _, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    want, n = chip_smoke.train_step_launches(cfg, B, L)
    assert n == 2 * 9 + 1 + 2 * 9 + 2 * 19 + 2
    assert counts == {k: want[k] for k in counts}


def test_train_step_refuses_what_later_slices_bring():
    cfg = P_configs.get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="distributed"):
        P_steps.make_train_step(cfg, P_optim.OptConfig(),
                                P_steps.TrainConfig(compress_pod_grads=True))
    moe = P_configs.get_config("deepseek_moe_16b", smoke=True)
    with pytest.raises(NotImplementedError, match="moe"):
        P_steps.make_train_step(moe, P_optim.OptConfig())
    with pytest.raises(NotImplementedError, match="distributed"):
        P_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--mesh", "data=2"])


def test_launcher_trains_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --device cpu --steps 2 --batch
    2 --seq 16`` trains the smoke config and prints its loss lines."""
    losses = P_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert "[train] step     1  loss" in out
    assert "[train] step     2  loss" in out
    assert "[train] first-1 mean loss" in out
