"""The group GEMM's layout contract and route rule, on the CPU.

On the card the group GEMM takes K-major digit stacks (B stored
``(K, *batch, p, n)``, seen transposed) and picks one of two routes from
the shape and the strides.  Those choices are plain Python; this file
checks them at the main path's shapes (meta tensors stand in for the large
ones), and that the K-major B stacks the splits now make hold the same
values as before: the reference's digits, and the same plain group GEMM
results as contiguous stacks.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import splitting as R_split
from repro.kernels import ops as J_ops
from repro_torch.core import split_cache as P_sc
from repro_torch.core import splitting as P_split
from repro_torch.kernels import group_gemm as gg
from repro_torch.kernels import ops as P_ops
from tests.test_torch_kernels import _assert_bitwise

torch.set_num_threads(1)


def _kmajor_b(rng, k, batch, n, p):
    store = rng.integers(-128, 128, (k,) + batch + (p, n)).astype(np.int8)
    return torch.from_numpy(store).transpose(-1, -2)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("signmag", [False, True])
def test_plain_group_gemm_same_on_kmajor_views(batch, signmag):
    """The plain version gives the same int32 sums on a K-major B view as
    on its contiguous copy (every signedness form)."""
    rng = np.random.default_rng(1)
    k, m, n, p = 4, 5, 70, 9
    a = torch.from_numpy(rng.integers(-128, 128, (k,) + batch + (m, n))
                         .astype(np.int8))
    b = _kmajor_b(rng, k, batch, n, p)
    assert gg._strides(b, -2) is not None and not b.is_contiguous()
    ia, ib = [0, 1, 3], [3, 2, 0]
    ua = [signmag and i > 0 for i in ia]
    ub = [signmag and j > 0 for j in ib]
    got = gg.group_gemm(a, b, ia, ib, a_unsigned=ua, b_unsigned=ub)
    want = gg.group_gemm_ref(a, b.contiguous(), ia, ib, a_unsigned=ua,
                             b_unsigned=ub)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("name", ["split_rn_const", "split_bitmask",
                                  "split_sm", "split_rn", "split_oz2",
                                  "split_oz2_fast2"])
def test_library_splits_store_b_kmajor(name):
    """axis=1 splits store their digits K-major; the values stay the
    reference's (batched)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 48, 20)) * 2.0 ** rng.integers(-8, 8,
                                                               (2, 1, 20))
    out = getattr(P_split, name)(torch.from_numpy(x), 4, axis=1)
    ref = getattr(R_split, name)(jnp.asarray(x), 4, axis=1)
    assert out.digits.transpose(-1, -2).is_contiguous()
    assert gg._strides(out.digits, -2) is not None
    _assert_bitwise(out.digits, ref.digits)
    a = getattr(P_split, name)(torch.from_numpy(x), 4, axis=0)
    assert a.digits.is_contiguous()


@pytest.mark.parametrize("mode", ["rn_const", "bitmask", "sm",
                                  "oz2_rn_fast2"])
def test_fused_split_stores_b_kmajor(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40, 24))
    beta = 8 if mode == "sm" else 7
    out = P_ops.split_fused(torch.from_numpy(x), 5, beta, mode=mode, axis=1)
    ref = J_ops.split_fused(jnp.asarray(x), 5, beta, mode=mode, axis=1)
    assert out.digits.transpose(-1, -2).is_contiguous()
    _assert_bitwise(out.digits, ref.digits)


def _meta(shape, kmajor=False):
    """A meta tensor with the strides of a contiguous A stack, or of a
    K-major B stack ``(K, *batch, n, p)``."""
    if not kmajor:
        return torch.empty(shape, dtype=torch.int8, device="meta")
    store = shape[:-2] + (shape[-1], shape[-2])
    return torch.empty(store, dtype=torch.int8,
                       device="meta").transpose(-1, -2)


# (label, A stack shape, B stack shape, route): internlm2-1.8b decode at
# 4 slots (k = 4), its batched attention contractions (4 slots x 8 KV
# heads, 2 query heads per KV head, cache 48), the n = 4096 DGEMM (k = 8)
MAIN_PATH = [
    ("lm_head", (4, 4, 2048), (4, 2048, 92672), "skinny"),
    ("wq/wo", (4, 4, 2048), (4, 2048, 2048), "skinny"),
    ("wk/wv", (4, 4, 2048), (4, 2048, 1024), "skinny"),
    ("w_gate/w_up", (4, 4, 2048), (4, 2048, 8192), "skinny"),
    ("w_down", (4, 4, 8192), (4, 8192, 2048), "skinny"),
    ("scores", (4, 32, 2, 128), (4, 32, 128, 48), "skinny"),
    ("p@v", (4, 32, 2, 48), (4, 32, 48, 128), "skinny"),
    ("dgemm", (8, 4096, 4096), (8, 4096, 4096), "large"),
    ("middle m", (4, 32, 2048), (4, 2048, 8192), "large"),
    ("crossover 8", (4, 8, 2048), (4, 2048, 8192), "skinny"),
    ("crossover 16", (4, 16, 2048), (4, 2048, 8192), "large"),
    ("small dgemm, n = 200", (8, 48, 200), (8, 200, 40), "skinny"),
]


@pytest.mark.parametrize("case", MAIN_PATH, ids=[c[0] for c in MAIN_PATH])
def test_route_and_alignment_at_main_path_shapes(case):
    _, sa, sb, want = case
    a, b = _meta(sa), _meta(sb, kmajor=True)
    assert gg._strides(a, -1) is not None and gg._strides(b, -2) is not None
    aligned = gg.tma_aligned(a, -1) and gg.tma_aligned(b, -2)
    assert aligned == (sa[-1] % 16 == 0)
    assert gg.route(sa[-2], aligned) == want


def test_strides_and_alignment_rule():
    """``_strides`` reads (row, batch, slice) strides; the TMA rule wants a
    16-byte base and 16-byte strides, and a p-contiguous B is no K-major
    stack."""
    b = _meta((4, 32, 128, 48), kmajor=True)
    assert gg._strides(b, -2) == (128, 48 * 128, 32 * 48 * 128)
    a = _meta((4, 32, 2, 128))
    assert gg._strides(a, -1) == (128, 256, 32 * 256)
    assert gg._strides(_meta((4, 2048, 1024)), -2) is None
    odd = _meta((4, 5, 24), kmajor=True)
    assert gg._strides(odd, -2) == (5, 5 * 24, 5 * 24)
    assert not gg.tma_aligned(odd, -2)
    assert gg.tma_aligned(_meta((4, 64, 32), kmajor=True), -2)
    # a layer of the frozen stack: slice stride n*p, no batch
    layers = _meta((3, 4, 2048, 1024), kmajor=True)
    assert gg._strides(layers[1], -2) == (2048, 2048 * 1024, 2048 * 1024)
    assert gg.route(4, True) == "skinny" and gg.route(9, True) == "large"
    assert gg.route(4096, False) == "skinny"


def test_stack_leading_keeps_frozen_digits_kmajor():
    """The frozen weights of a layer stack keep the split's K-major
    storage through ``stack_leading``: one tensor, each layer's slice
    stack K-major, values those of the per-layer split."""
    from repro_torch.core.ozimmu import parse_spec
    cfg = parse_spec("ozimmu_h-4:df32:fused")
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 64, 40)).astype(np.float32))
    dnums = (((1,), (1,)), ((0,), (0,)))
    sp = P_sc.SplitCache().get(w, dnums, cfg, layout="stack_leading")
    assert tuple(sp.digits.shape) == (3, 4, 64, 40)
    assert sp.digits.transpose(-1, -2).is_contiguous()
    for i in range(3):
        layer = sp.digits[i]
        assert gg._strides(layer, -2) is not None
        one = P_ops.split_fused(w[i], 4, P_split.compute_beta(64), axis=1)
        _assert_bitwise(layer, one.digits)


def test_launch_plan_refuses_p_contiguous_b():
    """No route takes a p-contiguous B: the launch plan raises instead of
    copying it, and takes the same values once stored K-major."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-128, 128, (2, 8, 16))
                         .astype(np.int8))
    flat = torch.from_numpy(rng.integers(-128, 128, (2, 16, 8))
                            .astype(np.int8))
    with pytest.raises(ValueError, match="K-major"):
        gg._launch_plan(a, flat, None, None, None, None, None)
    kb = flat.transpose(-1, -2).contiguous().transpose(-1, -2)
    which, shape, tail, _ = gg._launch_plan(a, kb, None, None, None, None,
                                            None)
    assert (which, shape, tail[:4]) == ("skinny", (8, 8), (1, 8, 16, 8))
