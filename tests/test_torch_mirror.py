"""Public helpers of the reference's ``core`` that the port mirrors name
for name, held bit for bit on the same numpy inputs: the split's
truncation residual (``splitting.residual``, reconstructed in f64 as the
reference's x64 mode does), the compensated two-float add
(``accumulate.df32_add``, flushed as XLA flushes) and a split's slice as
the integer GEMM takes it (``accumulate.gemm_slice``).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import accumulate as R_acc
from repro.core import splitting as R_split
from repro_torch.core import accumulate as P_acc
from repro_torch.core import splitting as P_split

torch.set_num_threads(1)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def _operand(dtype, seed=0):
    """Rows spanning 2^-40 .. 2^40 with a zero row: the residual's scale
    follows each row's maximum."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((6, 40)) * np.exp2(
        rng.integers(-40, 40, (6, 1)))
    a[2] = 0.0
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("split", ["split_rn_const", "split_bitmask",
                                   "split_sm"])
def test_residual_bitwise(split, dtype):
    a = _operand(dtype)
    for axis in (0, 1):
        rs = getattr(R_split, split)(jnp.asarray(a), 3, axis=axis)
        ps = getattr(P_split, split)(torch.from_numpy(a), 3, axis=axis)
        ref = np.asarray(R_split.residual(rs, jnp.asarray(a)))
        got = P_split.residual(ps, torch.from_numpy(a)).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.any(got)


def test_df32_add_bitwise():
    """A chain of adds into a (hi, lo) accumulator, with summands from
    1e30 down to near the bottom of the normal range (the flushes)."""
    rng = np.random.default_rng(1)
    xs = (rng.standard_normal((8, 64)) * np.exp2(rng.integers(
        -126, 100, (8, 64)))).astype(np.float32)
    xs[3, :8] = np.float32(1.5e-38)
    rc = R_acc.df32_zero((64,))
    pc = P_acc.df32_zero((64,), "cpu")
    for x in xs:
        rc = R_acc.df32_add(rc, jnp.asarray(x))
        pc = P_acc.df32_add(pc, torch.from_numpy(x))
    for r, p in ((rc.hi, pc.hi), (rc.lo, pc.lo)):
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(r))


@pytest.mark.parametrize("split", ["split_rn_const", "split_sm"])
def test_gemm_slice_equal(split):
    a = _operand(np.float64, seed=2)
    rs = getattr(R_split, split)(jnp.asarray(a), 4)
    ps = getattr(P_split, split)(torch.from_numpy(a), 4)
    for i in range(4):
        ref = np.asarray(R_acc.gemm_slice(rs, i))
        got = P_acc.gemm_slice(ps, i)
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        np.testing.assert_array_equal(got.numpy(), ref)
