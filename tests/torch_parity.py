"""Shared helpers of the port's model parity tests (not collected).

* :func:`contractions_bitwise`: every emulated contraction of a block,
  held bitwise to the reference's.  The reference runs its contractions
  inside jitted code (and its scans trace their bodies once), so its
  operands are not at hand; instead the port's operands and outputs are
  recorded call by call, the reference's contraction shapes are recorded
  from a trace with its scans unrolled, and the reference engine
  re-evaluates each of the port's contractions on the port's own operands.
* :func:`family_model` / :func:`family_context`: a family's ``smoke()``
  model under ``:fused`` from the port's seeded init, and a seeded
  context, as the serving family tests use them (against vacuous checks:
  the tied heads' ``embed`` scaled by :data:`EMBED_SCALE`, the vlm's gates
  and the context families' contexts drawn from a seed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as R_configs
from repro.core import engine as R_engine
from repro.models import api as R_api
from repro_torch import configs as P_configs
from repro_torch import optim as P_optim
from repro_torch import tree as P_tree
from repro_torch.core import engine as P_engine
from repro_torch.launch import serve as P_serve
from repro_torch.models import api as P_api
from repro_torch.data import Pipeline as P_Pipeline
from repro_torch.launch import steps as P_steps
from repro_torch.launch import train as P_train
from repro_torch.models import encdec as P_encdec
from repro_torch.models.convert import params_from_numpy

FUSED = "ozimmu_h-4:df32:fused"
# the tied heads (mamba2, recurrentgemma) echo the last token at the
# init's embedding scale
EMBED_SCALE = 0.05

_REF_DOTS = {}


def _ref_dot(ref_spec, lhs, rhs, dnums):
    """The reference engine's contraction of numpy operands, jitted once
    per spec, shapes and dimension numbers (small programs compile
    faster than one program of them all)."""
    key = (ref_spec, lhs.shape, rhs.shape, repr(dnums))
    if key not in _REF_DOTS:
        eng = R_engine.make_engine(ref_spec)
        _REF_DOTS[key] = jax.jit(lambda a, b: eng.dot_general(
            a, b, dnums, out_dtype=jnp.float32))
    return np.asarray(_REF_DOTS[key](jnp.asarray(lhs), jnp.asarray(rhs)))


def contractions_bitwise(monkeypatch, ref_spec, run_ref, run_port):
    """``run_port`` (recording every emulated contraction's operands and
    output) and ``run_ref`` (the reference: traced with its scans
    unrolled, which records the operand shapes of every emulated
    contraction) must make the same contractions in order, and each of
    the port's outputs must equal the reference engine's on the port's
    operands bit for bit (:func:`_ref_dot`).  Returns both results (the
    reference's as numpy, jitted) and the number of contractions."""
    ref_shapes, port_calls = [], []
    r_orig = R_engine.MatmulEngine.dot_general
    p_orig = P_engine.MatmulEngine.dot_general

    def r_rec(self, lhs, rhs, dnums, out_dtype=None):
        if self.is_ozimmu:
            ref_shapes.append((tuple(lhs.shape),
                               tuple(getattr(rhs, "array", rhs).shape)))
        return r_orig(self, lhs, rhs, dnums, out_dtype=out_dtype)

    def p_rec(self, lhs, rhs, dnums, out_dtype=None):
        out = p_orig(self, lhs, rhs, dnums, out_dtype=out_dtype)
        if self.is_ozimmu:
            # bf16 operands (the K/V cache rows) enter the emulation as
            # f32 on both sides: carried across as f32, exactly
            port_calls.append((lhs.float().numpy(),
                               getattr(rhs, "array", rhs).float().numpy(),
                               dnums, out.numpy()))
        return out
    monkeypatch.setattr(P_engine.MatmulEngine, "dot_general", p_rec)
    with torch.no_grad():
        out = run_port()
    monkeypatch.setattr(P_engine.MatmulEngine, "dot_general", p_orig)
    # unrolled: scans loop in Python under disable_jit, and a remat'ed
    # scan body (traced once per signature) is called through plainly
    monkeypatch.setattr(R_engine.MatmulEngine, "dot_general", r_rec)
    checkpoint = jax.checkpoint
    monkeypatch.setattr(jax, "checkpoint", lambda fun=None, **kw: (
        fun if fun is not None else (lambda f: f)))
    with jax.disable_jit():
        jax.eval_shape(run_ref)
    monkeypatch.setattr(jax, "checkpoint", checkpoint)
    monkeypatch.setattr(R_engine.MatmulEngine, "dot_general", r_orig)
    assert ref_shapes == [(c[0].shape, c[1].shape) for c in port_calls]
    assert ref_shapes
    for lhs, rhs, dnums, p_out in port_calls:
        assert p_out.dtype == np.float32
        np.testing.assert_array_equal(
            p_out.view(np.int32),
            _ref_dot(ref_spec, lhs, rhs, dnums).view(np.int32))
    return jax.tree.map(np.asarray, jax.jit(run_ref)()), out, \
        len(port_calls)


def family_model(arch):
    """``arch``'s ``smoke()`` config under :data:`FUSED` and its seeded
    parameters on the CPU; the tied heads' ``embed`` scaled by
    :data:`EMBED_SCALE`, the vlm's gates drawn as +-U(0.5, 1.5) (the
    init's zero gates make every cross layer the identity)."""
    cfg = P_configs.get_config(arch, smoke=True, engine_spec=FUSED)
    model = P_api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(cfg, generator=gen, device="cpu")
    if cfg.family in ("ssm", "hybrid"):
        params["embed"].mul_(EMBED_SCALE)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            g = params["groups"]["cross"][name]
            sign = torch.where(torch.rand(g.shape, generator=gen) < 0.5,
                               -1.0, 1.0)
            g.copy_((torch.rand(g.shape, generator=gen) + 0.5) * sign)
    return cfg, params


def family_context(cfg, params, rows, seed):
    """``slot_context``'s context with its zero patch embeddings / frames
    drawn N(0, 1) from ``seed``; None for the families without one."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        return torch.randn((1, cfg.vision_seq, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        with torch.no_grad():
            return P_encdec.encode(params, cfg, torch.randn(
                (1, rows, cfg.d_model), generator=gen))
    assert P_serve.slot_context(cfg, params, rows) is None
    return None


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_L = 2, 16


def ref_train_params(arch, seed=0):
    """The reference's ``smoke()`` parameters of ``arch`` as numpy, with
    the controls of :func:`family_model`: the tied heads' ``embed`` scaled
    by :data:`EMBED_SCALE`, the vlm's zero gates drawn as +-U(0.5, 1.5)
    (with zero gates no gradient reaches a cross layer's weights)."""
    cfg = R_configs.get_config(arch, smoke=True, dtype="float32")
    params, _ = R_api.get_model(cfg).init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree.map(lambda x: np.array(x), params)
    if cfg.family in ("ssm", "hybrid"):
        params["embed"] *= np.float32(EMBED_SCALE)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        cross = params["groups"]["cross"]
        for name in ("gate_attn", "gate_mlp"):
            shape = cross[name].shape
            cross[name] = (rng.uniform(0.5, 1.5, shape) * rng.choice(
                [-1.0, 1.0], shape)).astype(np.float32)
    return params


def train_batch(arch, seed=3, seq_len=TRAIN_L):
    """One numpy batch of the port's pipeline (bitwise the reference's)
    at :data:`TRAIN_B` x ``seq_len`` for ``arch``'s smoke config: the
    tokens, and the vlm's patch rows / the encdec's frames."""
    cfg = P_configs.get_config(arch, smoke=True)
    return P_Pipeline(P_train.data_config(
        cfg, seq_len=seq_len, global_batch=TRAIN_B, seed=seed)).batch_at(0)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(out - ref).max()
    scale = np.abs(ref).max()
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def train_parity(arch, spec, params, batch, **overrides):
    """``(reference loss, port loss, [(path, rel)])``: ``jax.value_and_
    grad`` of ``next_token_loss . forward`` (jitted, f32 activations)
    against the port's :func:`repro_torch.launch.steps.loss_and_grads` on
    the same parameters and batch; ``rel`` is a leaf's max|diff| over its
    reference max|g|.  ``overrides`` go to both configs."""
    rcfg = R_configs.get_config(arch, smoke=True, engine_spec=spec,
                                dtype="float32", **overrides)
    pcfg = P_configs.get_config(arch, smoke=True, engine_spec=spec,
                                dtype="float32", **overrides)
    model = R_api.get_model(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return R_api.next_token_loss(model.forward(p, rcfg, jb),
                                     jb["tokens"])

    rloss, rgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    ploss, pgrads = P_steps.loss_and_grads(
        pcfg, params_from_numpy(params, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    pflat = P_tree.leaves(pgrads)
    assert len(paths) == len(pflat)
    out = []
    for path, r, p in zip(paths, jax.tree.leaves(rgrads), pflat):
        assert tuple(p.shape) == tuple(r.shape), path
        out.append((path, _rel(p.numpy(), r)))
    return float(rloss), float(ploss), out


def remat_gradients(arch, params, batch):
    """The port's loss and gradients under :data:`FUSED` with remat blocks
    of 1 and of 2 units (layers, pattern blocks, groups)."""
    pcfg = P_configs.get_config(arch, smoke=True, engine_spec=FUSED,
                                dtype="float32")
    pparams = params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [P_steps.loss_and_grads(pcfg.with_(remat_block=rb), pparams, tb)
            for rb in (1, 2)]


def train_launches(monkeypatch, arch):
    """``(counted, predicted)`` kernel launches of one smoke train step of
    ``arch`` under :data:`FUSED` (bf16 activations, the port's own init,
    the pipeline's batch): split, group GEMM and df32 epilogue calls
    counted at the kernel wrappers on the CPU, against
    ``chip_smoke.train_step_launches``, the construction the card phase
    asserts."""
    import math

    import chip_smoke
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    from repro_torch.kernels import split_fused as sf
    counts = {"split_fused": 0, "group_gemm": 0, "scale_accum": 0}
    for module, name, key in ((sf, "split_whole", "split_fused"),
                              (gg, "group_gemm", "group_gemm"),
                              (sa, "scale_accum_chunks", "scale_accum")):
        def wrapped(*a, _fn=getattr(module, name), _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)
    cfg = P_configs.get_config(arch, smoke=True, engine_spec=FUSED)
    state = P_steps.init_state(cfg, P_optim.OptConfig(),
                               torch.Generator().manual_seed(0), "cpu")
    step = P_steps.make_train_step(cfg, P_optim.OptConfig())
    batch = {k: torch.from_numpy(v) for k, v in train_batch(arch).items()}
    _, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))
    want, n = chip_smoke.train_step_launches(cfg, TRAIN_B, TRAIN_L)
    return counts, {k: want[k] for k in counts}, n
