"""The sign-magnitude family (``ozimmu_sm_b`` / ``ozimmu_sm_h``) in the port
against the reference, bit for bit.

The port multiplies the STORED sign-magnitude digits (slice 0 signed,
trailing slices unsigned magnitudes stored mod 2^8) with each slice's
signedness; the reference widens them to int16 first.  The integer sums are
exact either way, so the group GEMM, the whole ``ozimmu_dot_general`` and
the served greedy tokens must agree exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import ozimmu as R
from repro.core.splitting import Split as JSplit
from repro.kernels import ops as J_ops
from repro_torch.core import ozimmu as P
from repro_torch.core.splitting import Split as PSplit
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels.group_gemm import group_gemm_ref
from tests.conftest import make_phi_matrix
from tests.test_torch_kernels import _assert_bitwise

torch.set_num_threads(1)


def _sm_digits(rng, k, shape):
    """Stored sign-magnitude digits with the extremes in place: slice 0 in
    [-128, 127] with -128 and 127 present, trailing slices in [0, 255]
    stored mod 2^8 with 0 and 255 (stored -1) present."""
    d = np.empty((k,) + shape, np.int8)
    d[0] = rng.integers(-128, 128, shape)
    d[0].flat[:2] = (-128, 127)
    mag = rng.integers(0, 256, (k - 1,) + shape)
    mag.reshape(k - 1, -1)[:, :2] = (255, 0)
    d[1:] = mag.astype(np.uint8).view(np.int8)
    return d


@pytest.mark.parametrize("pairs", [[(1, 1)], [(1, 3), (2, 2), (3, 1)],
                                   [(2, 4), (3, 3), (4, 2)]])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_group_gemm_stored_digits_bitwise(pairs, batch):
    """The plain group GEMM on the stored digits with their signedness (the
    form the kernel takes) equals the reference's ``ops.group_gemm`` on the
    same ``split_sm`` digits (widened there)."""
    rng = np.random.default_rng(len(pairs) + len(batch))
    k, m, n, p = 4, 13, 70, 9
    da, db = _sm_digits(rng, k, batch + (m, n)), \
        _sm_digits(rng, k, batch + (n, p))
    one_a, one_b = np.ones((k,) + batch + (m,)), np.ones((k,) + batch + (p,))
    ref = J_ops.group_gemm(
        JSplit(jnp.asarray(da), jnp.asarray(one_a), None, 8, 0,
               signmag=True),
        JSplit(jnp.asarray(db), jnp.asarray(one_b), None, 8, 1,
               signmag=True), pairs)
    ta, tb = torch.from_numpy(da), torch.from_numpy(db)
    out = group_gemm_ref(ta, tb, [s - 1 for s, _ in pairs],
                         [t - 1 for _, t in pairs],
                         a_unsigned=[s > 1 for s, _ in pairs],
                         b_unsigned=[t > 1 for _, t in pairs])
    _assert_bitwise(out, ref)
    hook = P_ops.group_gemm(
        PSplit(ta, torch.from_numpy(one_a), None, 8, 0, signmag=True),
        PSplit(tb, torch.from_numpy(one_b), None, 8, 1, signmag=True),
        pairs)
    _assert_bitwise(hook, ref)


SM_SPECS = [f"{v}-{k}:{acc}{path}" for v in ("ozimmu_sm_h", "ozimmu_sm_b")
            for k, acc in ((4, "df32"), (8, "f64"), (5, "f32"))
            for path in ("", ":fused")]


@pytest.mark.parametrize("spec", SM_SPECS)
def test_sm_dot_general_bitwise(spec):
    """Both accumulations (group-EF and the pairwise naive route, one slice
    pair per group GEMM), plain and ``:fused``, on the paper's phi
    inputs."""
    rng = np.random.default_rng(21)
    a = make_phi_matrix(rng, 9, 300, phi=1.0)
    b = make_phi_matrix(rng, 300, 7, phi=1.0)
    dnums = (((1,), (0,)), ((), ()))
    ref = R.ozimmu_dot_general(jnp.asarray(a), jnp.asarray(b), dnums,
                               R.parse_spec(spec))
    out = P.ozimmu_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                               dnums, P.parse_spec(spec))
    _assert_bitwise(out, np.asarray(ref))


def test_sm_serving_tokens_match_reference():
    """``ozimmu_sm_h-4:df32:fused`` greedy serving of the smoke config: the
    port's runtime (the kernels' plain versions) gives the reference
    runtime's tokens, with every weight split frozen once.  f32
    activations, as tests/test_torch_serving.py."""
    from repro import configs as R_configs
    from repro.models import api as R_api
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch import configs as P_configs
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving import ServingRuntime
    spec = "ozimmu_sm_h-4:df32"
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec, dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=spec + ":fused", dtype="float32")
    rparams, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    nparams = jax.tree.map(np.asarray, rparams)
    prompts = [np.random.default_rng(s).integers(0, rcfg.vocab, (8,),
                                                 dtype=np.int32)
               for s in range(3)]
    refs = RRuntime(rcfg, rparams, slots=2, max_len=32).generate(
        [p.copy() for p in prompts], 4)
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         slots=2, max_len=32, device="cpu")
    outs = prt.generate([p.copy() for p in prompts], 4)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert prt.params["lm_head"].digits.dtype == torch.int8
    assert prt.params["lm_head"].split == "sm"
    assert prt.metrics.summary()["split_cache"][
        "weight_split_hit_rate"] == 1.0
