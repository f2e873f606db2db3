"""The port's plain kernel versions against the JAX Pallas kernels.

Each plain PyTorch version (``repro_torch.kernels.*_ref``, what the
wrappers run on CPU tensors and what ``chip_smoke.py`` holds every CUDA
kernel to on the card) must be BITWISE equal to the reference's Pallas
kernel run in interpret mode (``repro.kernels.ops.INTERPRET``), on the same
numpy inputs.  The split wrapper (row maxima, bases, reciprocal grids,
axis 1, batch) is covered through ``ops.split_fused`` of both packages.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.splitting import Split as JSplit
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.group_gemm import group_gemm_ref
from repro_torch.kernels.scale_accum import (scale_accum_plain_ref,
                                             scale_accum_ref)

torch.set_num_threads(1)


def _bits(x):
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.view({4: np.int32, 8: np.int64}[x.dtype.itemsize])
    return x


def _assert_bitwise(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _hostile(rng, m, n, dtype):
    """Rows of tests/test_oracle.py's hostile grid: a zero row, a
    subnormal row, a wide exponent spread, sign-flipped rows."""
    a = rng.standard_normal((m, n))
    e = rng.integers(-30, 1, (m, n)).astype(np.float64)
    a[1] = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0) * \
        rng.uniform(0.5, 1.0, n) * 2.0 ** e[1]                 # wide spread
    a[0] = 0.0                                                 # zero row
    tiny = np.finfo(dtype).smallest_subnormal
    a[2] = tiny * rng.integers(1, 8, n)                        # subnormal
    a[3] = -np.abs(a[3])                                       # sign flip
    a[4::2] *= -1.0
    a[:, 3] = 0.0
    return a.astype(dtype)


@pytest.mark.parametrize("mode", ["bitmask", "rn_const", "sm"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_fused_plain_bitwise(mode, dtype, axis):
    rng = np.random.default_rng(3)
    a = _hostile(rng, 11, 37, dtype)
    if axis == 1:
        a = np.ascontiguousarray(a.T)
    beta = 8 if mode == "sm" else 7
    ref = jops.split_fused(jnp.asarray(a), 4, beta, mode=mode, axis=axis)
    out = tops.split_fused(torch.from_numpy(a), 4, beta, mode=mode,
                           axis=axis)
    _assert_bitwise(out.digits, ref.digits)
    _assert_bitwise(out.scale, ref.scale)
    _assert_bitwise(out.base, ref.base)
    assert out.signmag == ref.signmag and out.axis == ref.axis == axis


@pytest.mark.parametrize("axis", [0, 1])
def test_split_fused_plain_batched(axis):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 9, 20)) * \
        2.0 ** rng.integers(-20, 20, (2, 3, 9, 1))
    ref = jops.split_fused(jnp.asarray(a), 5, 6, mode="rn_const", axis=axis)
    out = tops.split_fused(torch.from_numpy(a), 5, 6, mode="rn_const",
                           axis=axis)
    _assert_bitwise(out.digits, ref.digits)
    _assert_bitwise(out.scale, ref.scale)


def _digits(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_group_gemm_plain_bitwise(G, batch):
    """Ragged m/n/p (no tile multiples), G pairs out of a k=4 stack."""
    rng = np.random.default_rng(5 + G)
    k, m, n, p = 4, 13, 70, 9
    da = _digits(rng, (k,) + batch + (m, n))
    db = _digits(rng, (k,) + batch + (n, p))
    pairs = [(1, 3), (2, 2), (3, 1)] if G == 3 else [(2, 4)]
    one = np.ones((k,) + batch + (m,))
    sa = JSplit(jnp.asarray(da), jnp.asarray(one), None, 7, 0)
    sb = JSplit(jnp.asarray(db), jnp.asarray(np.ones((k,) + batch + (p,))),
                None, 7, 1)
    ref = jops.group_gemm(sa, sb, pairs)
    out = group_gemm_ref(torch.from_numpy(da), torch.from_numpy(db),
                         [s - 1 for s, _ in pairs],
                         [t - 1 for _, t in pairs])
    _assert_bitwise(out, ref)


def _epilogue_inputs(rng, dtype, batch=(2,), m=5, p=11):
    p32 = rng.integers(-2 ** 31, 2 ** 31, batch + (m, p)).astype(np.int32)
    srow = (2.0 ** rng.integers(-40, -10, batch + (m,))).astype(dtype)
    scol = (2.0 ** rng.integers(-6, 6, batch + (p,))).astype(dtype)
    c = rng.standard_normal(batch + (m, p)).astype(dtype)
    return p32, srow, scol, c


def test_scale_accum_plain_bitwise():
    """df32 epilogue: TwoSum order, low-8-bit split, renormalisation."""
    rng = np.random.default_rng(6)
    p32, srow, scol, hi = _epilogue_inputs(rng, np.float32)
    lo = (hi * 2.0 ** -26).astype(np.float32)
    r_hi, r_lo = jops.scale_accum(*map(jnp.asarray, (p32, srow, scol, hi,
                                                     lo)))
    t_hi, t_lo = scale_accum_ref(*map(torch.from_numpy, (p32, srow, scol, hi,
                                                         lo)))
    _assert_bitwise(t_hi, r_hi)
    _assert_bitwise(t_lo, r_lo)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scale_accum_plain_accumulator_bitwise(dtype):
    rng = np.random.default_rng(7)
    p32, srow, scol, c = _epilogue_inputs(rng, dtype)
    ref = jops.scale_accum_plain(*map(jnp.asarray, (p32, srow, scol, c)))
    out = scale_accum_plain_ref(*map(torch.from_numpy, (p32, srow, scol, c)))
    _assert_bitwise(out, ref)


def test_wrappers_take_plain_version_only_on_cpu():
    """A non-CPU tensor never reaches a plain version: the wrappers launch
    the kernel or raise (here: the meta device has no kernel)."""
    from repro_torch.kernels import group_gemm, scale_accum, split_fused
    a = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        split_fused.split_fused(a, torch.empty((4,), device="meta"), k=2,
                                beta=7)
    d = torch.empty((2, 4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        group_gemm.group_gemm(d, d.transpose(1, 2))
    p = torch.empty((4, 4), dtype=torch.int32, device="meta")
    v = torch.empty((4,), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        scale_accum.scale_accum_plain(p, v, v, torch.empty((4, 4),
                                                           device="meta"))
