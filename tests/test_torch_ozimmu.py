"""The port's ``ozimmu_dot_general`` against the reference, bit for bit.

Same numpy inputs through ``repro.core.ozimmu`` (JAX, x64 on; ``:fused``
runs the Pallas kernels in interpret mode) and ``repro_torch.core.ozimmu``
(CPU tensors: the kernels' plain versions).  The emulation is exact
integer arithmetic plus power-of-two scaling and TwoSum, so every result
must match to the last bit: ``ozimmu_h`` and ``ozimmu`` at k in {4, 8} x
{f64, f32, df32} x {plain path, ``:fused``}, rank 2, the batched attention
dimension numbers, and ``rhs_presplit`` through the split cache.  The spec
grammar must give the same configs and the same error texts.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import ozimmu as R
from repro.core import split_cache as R_sc
from repro_torch.core import ozimmu as P
from repro_torch.core import split_cache as P_sc
from tests.conftest import make_phi_matrix
from tests.test_docs_specs import SPECS as DOC_SPECS

torch.set_num_threads(1)

SPECS = [f"{v}-{k}:{acc}{path}" for v in ("ozimmu_h", "ozimmu")
         for k in (4, 8) for acc in ("f64", "f32", "df32")
         for path in ("", ":fused")]


def _both(spec, a, b, dnums, presplit=False):
    rcfg, pcfg = R.parse_spec(spec), P.parse_spec(spec)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if presplit:
        rsp = R_sc.SplitCache().get(jb, dnums, rcfg)
        psp = P_sc.SplitCache().get(tb, dnums, pcfg)
        ref = R.ozimmu_dot_general(ja, jb, dnums, rcfg, rhs_presplit=rsp)
        out = P.ozimmu_dot_general(ta, tb, dnums, pcfg, rhs_presplit=psp)
    else:
        ref = R.ozimmu_dot_general(ja, jb, dnums, rcfg)
        out = P.ozimmu_dot_general(ta, tb, dnums, pcfg)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("spec", SPECS)
def test_rank2_bitwise(spec):
    rng = np.random.default_rng(11)
    a = make_phi_matrix(rng, 9, 40, phi=1.0)
    b = make_phi_matrix(rng, 40, 7, phi=1.0)
    ref, out = _both(spec, a, b, (((1,), (0,)), ((), ())))
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


ATTN_DNUMS = (((4,), (3,)), ((0, 2), (0, 2)))


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32:fused",
                                  "ozimmu-8:f64:fused"])
def test_batched_attention_dnums_bitwise(spec):
    """The flash-attention score contraction: q (B, qc, KV, G, D) with
    k (B, kc, KV, D), batch (B, KV), contract D."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 5, 2, 3, 16))
    k = rng.standard_normal((2, 6, 2, 16)) * 2.0 ** rng.integers(
        -8, 8, (2, 6, 2, 1))
    ref, out = _both(spec, q, k, ATTN_DNUMS)
    assert out.shape == (2, 2, 5, 3, 6)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32:fused", "ozimmu_h-8:f64",
                                  "ozimmu-4:f32:fused"])
def test_presplit_bitwise(spec):
    """rhs_presplit through the split cache equals the reference's cached
    path and the port's own uncached path."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((9, 40))
    w = rng.standard_normal((40, 7))
    dnums = (((1,), (0,)), ((), ()))
    ref, out = _both(spec, x, w, dnums, presplit=True)
    np.testing.assert_array_equal(out, ref)
    _, uncached = _both(spec, x, w, dnums)
    np.testing.assert_array_equal(out, uncached)


def test_parse_spec_matches_reference():
    """Every documented spec parses to the same config in both packages
    (the grammar is ported whole, even where execution waits for a later
    slice)."""
    specs = sorted({s for _, s in DOC_SPECS}) + [
        "ozimmu_h-4:df32:fused", "ozimmu-8:f64", "ozimmu_sm_b-8:fused",
        "oz2_h-4:fast2:df32", "ozimmu_h-auto:prob@model/df32"]
    for spec in specs:
        assert dataclasses.asdict(P.parse_spec(spec)) == \
            dataclasses.asdict(R.parse_spec(spec)), spec


BAD_SPECS = ["ozimmu_x-4", "ozimmu_h-0", "ozimmu_h-4:f16",
             "ozimmu_h-4:f32:df32", "ozimmu_h-4:fused:fused",
             "ozimmu_h-4:fast", "oz2_h-4:fast:fast2", "oz2_h-4:fast2:fast2",
             "ozimmu_h-4:prob", "ozimmu_h-auto:prob:prob",
             "ozimmu_h-4@", "ozimmu_h-4@model/f64", "ozimmu_h-k"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_error_texts(spec):
    with pytest.raises(ValueError) as r_err:
        R.parse_spec(spec)
    with pytest.raises(ValueError) as p_err:
        P.parse_spec(spec)
    assert str(p_err.value) == str(r_err.value)


@pytest.mark.parametrize("spec,later", [
    ("ozimmu_h-4@model", "distributed")])
def test_unported_specs_raise_naming_their_slice(spec, later):
    a = torch.ones((2, 8), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=later):
        P.ozimmu_matmul(a, a.T, P.parse_spec(spec))
