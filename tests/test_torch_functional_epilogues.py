"""The port's functional epilogues (``repro_torch.kernels.ops.scale_accum``,
``scale_accum_plain``, ``oz2_scale_accum``, ``oz2_scale_accum_plain``,
``oz2_unscale``) against the reference's functions of the same names
(``repro.kernels.ops``, Pallas in interpret mode as ``tests/`` runs it),
bitwise on the same numpy inputs, rank 2 and batched; the accumulators
passed in stay as they were, and each equals its ``*_update`` hook form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.core.accumulate import DF32
from repro_torch.kernels import ops as P_ops

torch.set_num_threads(1)


def _bits(x):
    x = np.asarray(x)
    return x.view({4: np.int32, 8: np.int64}[x.dtype.itemsize])


def _equal(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_array_equal(_bits(port), _bits(ref))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("batch", [(), (3,)])
def test_scale_accum_matches_reference(rng, batch):
    m, p = 24, 140
    p32 = rng.integers(-2 ** 30, 2 ** 30, batch + (m, p)).astype(np.int32)
    srow = (2.0 ** rng.integers(-20, 20, batch + (m,))).astype(np.float32)
    scol = (2.0 ** rng.integers(-20, 20, batch + (p,))).astype(np.float32)
    c_hi = rng.standard_normal(batch + (m, p)).astype(np.float32)
    c_lo = (rng.standard_normal(batch + (m, p)) * 1e-7).astype(np.float32)
    args = (p32, srow, scol, c_hi, c_lo)
    ins = _t(*args)
    keep = [t.clone() for t in ins]
    hi, lo = P_ops.scale_accum(*ins)
    whi, wlo = R_ops.scale_accum(*_j(*args))
    _equal(hi, whi)
    _equal(lo, wlo)
    for t, k in zip(ins, keep):
        assert torch.equal(t, k)
    upd = P_ops.scale_accum_update(ins[0], ins[1], ins[2],
                                   DF32(ins[3].clone(), ins[4].clone()))
    assert torch.equal(upd.hi, hi) and torch.equal(upd.lo, lo)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_scale_accum_plain_matches_reference(rng, dtype, batch):
    m, p = 16, 130
    p32 = rng.integers(-2 ** 30, 2 ** 30, batch + (m, p)).astype(np.int32)
    srow = (2.0 ** rng.integers(-20, 20, batch + (m,))).astype(dtype)
    scol = (2.0 ** rng.integers(-20, 20, batch + (p,))).astype(dtype)
    c = rng.standard_normal(batch + (m, p)).astype(dtype)
    ins = _t(p32, srow, scol, c)
    keep = ins[3].clone()
    got = P_ops.scale_accum_plain(*ins)
    _equal(got, R_ops.scale_accum_plain(*_j(p32, srow, scol, c)))
    assert torch.equal(ins[3], keep)
    assert torch.equal(P_ops.scale_accum_update(*ins[:3], ins[3].clone()),
                       got)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_oz2_scale_accum_matches_reference(rng, batch):
    m, p = 24, 140
    word = rng.integers(-2 ** 30, 2 ** 30, batch + (m, p)).astype(np.int32)
    s = (2.0 ** rng.integers(-10, 10, batch)).astype(np.float32)
    c_hi = rng.standard_normal(batch + (m, p)).astype(np.float32)
    c_lo = (rng.standard_normal(batch + (m, p)) * 1e-7).astype(np.float32)
    ins = _t(word, s, c_hi, c_lo)
    keep = [t.clone() for t in ins]
    hi, lo = P_ops.oz2_scale_accum(*ins)
    whi, wlo = R_ops.oz2_scale_accum(*_j(word, s, c_hi, c_lo))
    _equal(hi, whi)
    _equal(lo, wlo)
    for t, k in zip(ins, keep):
        assert torch.equal(t, k)
    upd = P_ops.oz2_scale_accum_update(ins[0], ins[1],
                                       DF32(ins[2].clone(), ins[3].clone()))
    assert torch.equal(upd.hi, hi) and torch.equal(upd.lo, lo)


@pytest.mark.parametrize("word_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("acc_dtype", [np.float32, np.float64])
def test_oz2_scale_accum_plain_matches_reference(rng, word_dtype,
                                                 acc_dtype):
    m, p = 16, 130
    word = rng.integers(-2 ** 50, 2 ** 50, (1, m, p)).astype(word_dtype)
    s = (2.0 ** rng.integers(-10, 10, (1,))).astype(acc_dtype)
    c = rng.standard_normal((1, m, p)).astype(acc_dtype)
    ins = _t(word, s, c)
    keep = ins[2].clone()
    got = P_ops.oz2_scale_accum_plain(*ins)
    _equal(got, R_ops.oz2_scale_accum_plain(*_j(word, s, c)))
    assert torch.equal(ins[2], keep)
    assert torch.equal(P_ops.oz2_scale_accum_update(ins[0], ins[1],
                                                    ins[2].clone()), got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_oz2_unscale_matches_reference(rng, dtype, batch):
    m, p = 20, 136
    x = rng.standard_normal(batch + (m, p)).astype(dtype)
    ra = (2.0 ** rng.integers(-20, 20, batch + (m,))).astype(np.float64)
    rb = (2.0 ** rng.integers(-20, 20, batch + (p,))).astype(np.float64)
    ins = _t(x, ra, rb)
    got = P_ops.oz2_unscale(*ins)
    _equal(got, R_ops.oz2_unscale(*_j(x, ra, rb)))
    assert torch.equal(P_ops.oz2_unscale_update(*ins), got)
    lo = ins[0] * 2.0 ** -30
    upd = P_ops.oz2_unscale_update(DF32(ins[0], lo), ins[1], ins[2])
    assert torch.equal(upd.hi, got)
    assert torch.equal(upd.lo, P_ops.oz2_unscale(lo, ins[1], ins[2]))
