"""Near-underflow rows: the port bitwise against the reference with IEEE
arithmetic on the CPU (PyTorch's default; ``torch.set_flush_denormal`` is
never switched on here).

The reference's XLA arithmetic flushes subnormal operands and results to
zero.  For rows whose maxima lie near the bottom of the normal range the
later slices' grids ``mu * 2^(-beta j)`` and the epilogue's scale products
fall below it, so an IEEE port would keep subnormals where the reference
has zeros: saturated digits instead of zero digits, and products that
differ.  The port flushes explicitly (``splitting.ftz``), so its splits
and whole products must equal the reference's.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import accumulate as R_acc
from repro.core import ozimmu as R
from repro.core import splitting as R_split
from repro.kernels import ops as J_ops
from repro_torch.core import ozimmu as P
from repro_torch.core import splitting as P_split
from repro_torch.kernels import ops as P_ops
from tests.test_torch_kernels import _assert_bitwise

torch.set_num_threads(1)

MAXIMA = {np.float32: [1e-36, 4e-37, 1e-37, "subnormal"],
          np.float64: [1e-305, 1e-307, "subnormal"]}


def _rows(dtype, seed=0, n=64):
    """One row per maximum of ``MAXIMA`` (the smallest subnormal times
    small integers for "subnormal"), then two ordinary rows."""
    rng = np.random.default_rng(seed)
    maxima = MAXIMA[dtype]
    a = rng.standard_normal((len(maxima) + 2, n))
    for i, mx in enumerate(maxima):
        if mx == "subnormal":
            a[i] = np.finfo(dtype).smallest_subnormal * rng.integers(-7, 8, n)
        else:
            row = rng.uniform(-1.0, 1.0, n)
            row[0] = 1.0
            a[i] = row * mx
    return a.astype(dtype)


def _assert_split(out, ref):
    _assert_bitwise(out.digits, ref.digits)
    _assert_bitwise(out.scale, ref.scale)
    if ref.base is not None:
        _assert_bitwise(out.base, ref.base)


@pytest.mark.parametrize("name", ["split_rn_const", "split_rn",
                                  "split_oz2_fast2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [4, 8])
def test_library_splitters_near_underflow(name, dtype, axis, k):
    a = _rows(dtype)
    x = a if axis == 0 else np.ascontiguousarray(a.T)
    assert float(torch.tensor([1e-40]) * 1.0) != 0.0  # IEEE subnormals
    ref = getattr(R_split, name)(jnp.asarray(x), k, axis=axis)
    out = getattr(P_split, name)(torch.from_numpy(x), k, axis=axis)
    _assert_split(out, ref)


@pytest.mark.parametrize("mode", ["rn_const", "oz2_rn_fast2", "bitmask",
                                  "sm"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_fused_split_plain_near_underflow(mode, dtype, axis):
    """``ops.split_fused`` on CPU tensors: the wrapper's grids and the
    split kernel's plain version."""
    a = _rows(dtype, seed=1)
    x = a if axis == 0 else np.ascontiguousarray(a.T)
    beta = 8 if mode == "sm" else 7
    ref = J_ops.split_fused(jnp.asarray(x), 4, beta, mode=mode, axis=axis)
    out = P_ops.split_fused(torch.from_numpy(x), 4, beta, mode=mode,
                            axis=axis)
    _assert_split(out, ref)


def test_rn_const_row_of_1e37_splits_to_zero_digits():
    """The case that showed the fault: an f32 row with maximum 1e-37 at
    k = 4 has a first grid below the normal range; the reference flushes
    it and gives zero digits, where IEEE arithmetic saturates."""
    a = np.full((1, 64), 1e-37, np.float32)
    a[0, 1:] *= np.linspace(-1.0, 1.0, 63, dtype=np.float32)
    ref = R_split.split_rn_const(jnp.asarray(a), 4)
    out = P_split.split_rn_const(torch.from_numpy(a), 4)
    _assert_bitwise(out.digits, ref.digits)
    assert not out.digits.any()


def _operands(dtype, scale, seed=2):
    """8x64 @ 64x8 with row 2 of A and column 3 of B scaled by ``scale``:
    products near ``scale^2``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((8, 64))
    b = rng.standard_normal((64, 8))
    a[2] *= scale
    b[:, 3] *= scale
    return a.astype(dtype), b.astype(dtype)


PRODUCTS = [("ozimmu_h-4:df32", np.float32, s) for s in (1e-20, 1e-30)] + \
    [("oz2_h-4:df32:fast2", np.float32, s) for s in (1e-20, 1e-30)] + \
    [("ozimmu_h-8:f64", np.float64, s) for s in (1e-150, 1e-290, 1e-300)]


@pytest.mark.parametrize("spec,dtype,scale", PRODUCTS)
def test_products_near_underflow(spec, dtype, scale):
    """Whole ``ozimmu_matmul`` products, bitwise."""
    a, b = _operands(dtype, scale)
    ref = R.ozimmu_matmul(jnp.asarray(a), jnp.asarray(b), R.parse_spec(spec))
    out = P.ozimmu_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          P.parse_spec(spec))
    _assert_bitwise(out, ref)


def _xla_epilogues(monkeypatch):
    """Route the reference's ``:fused`` pipeline through its XLA epilogue
    (its own ``accumulate`` functions) instead of the Pallas epilogue
    kernels.  In interpret mode those kernels keep IEEE subnormals, unlike
    the reference's XLA arithmetic, so its fused products depart from its
    library products near the bottom of the range; the reference's fused
    split and group GEMM stay in place."""
    def update(prod, srow, scol, acc):
        if isinstance(acc, R_acc.DF32):
            return R_acc._scale_accum_df32(prod, srow, scol, acc)
        return R_acc._scale_accum_plain(prod, srow, scol, acc)

    def oz2_update(word, s, acc):
        if isinstance(acc, R_acc.DF32):
            return R_acc._oz2_accum_df32(word, s, acc)
        return R_acc._oz2_accum_plain(word, s, acc)

    monkeypatch.setattr(J_ops, "scale_accum_update", update)
    monkeypatch.setattr(J_ops, "oz2_scale_accum_update", oz2_update)
    monkeypatch.setattr(J_ops, "oz2_unscale_update", R_acc._oz2_unscale)


FUSED = [("ozimmu_h-4:df32:fused", np.float32, s) for s in (1e-20, 1e-30)] \
    + [("oz2_h-4:df32:fast2:fused", np.float32, s) for s in (1e-20, 1e-30)] \
    + [("ozimmu_sm_h-4:df32:fused", np.float32, s) for s in (1e-20, 1e-30)] \
    + [("ozimmu_h-8:f64:fused", np.float64, s)
       for s in (1e-150, 1e-290, 1e-300)]


@pytest.mark.parametrize("spec,dtype,scale", FUSED)
def test_fused_products_near_underflow(spec, dtype, scale, monkeypatch):
    """The port's ``:fused`` pipeline (its plain versions, what the card's
    kernels are held to) against the reference's fused split and group
    GEMM with the reference's XLA epilogue, bitwise."""
    _xla_epilogues(monkeypatch)
    a, b = _operands(dtype, scale)
    ref = R.ozimmu_matmul(jnp.asarray(a), jnp.asarray(b), R.parse_spec(spec))
    out = P.ozimmu_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          P.parse_spec(spec))
    _assert_bitwise(out, ref)
