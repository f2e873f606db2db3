"""Shared helper of the port's model parity tests (not collected): every
emulated contraction of a block, held bitwise to the reference's.

The reference runs its contractions inside jitted code (and its scans
trace their bodies once), so its operands are not at hand; instead the
port's operands and outputs are recorded call by call, the reference's
contraction shapes are recorded from a trace with its scans unrolled, and
the reference engine re-evaluates each of the port's contractions on the
port's own operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engine as R_engine
from repro_torch.core import engine as P_engine

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
