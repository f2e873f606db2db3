"""Kernel checks that need the CUDA card (marker ``cuda``; skipped without
one).  This file imports no JAX, so it also runs on a machine with the card
and PyTorch only:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel must be bitwise equal to its plain version on the same CUDA
tensors, on ragged shapes the kernels mask themselves.
"""
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype.is_floating_point:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["bitmask", "rn_const", "sm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_fused_kernel(dev, mode, dtype, axis):
    from repro_torch.kernels import ops, split_fused
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((3, 37, 53), generator=g, dtype=dtype, device=dev)
    a[:, 0] = 0.0
    sp = ops.split_fused(a, 5, 7, mode=mode, axis=axis)
    ref = ops.split_fused(a.cpu(), 5, 7, mode=mode, axis=axis)
    assert torch.equal(sp.digits.cpu(), ref.digits)
    inv = torch.rand((3, 37) if axis == 0 else (3, 53), generator=g,
                     dtype=dtype, device=dev) * 8
    assert _same(split_fused.split_fused(a, inv, k=4, beta=7, mode=mode,
                                         axis=axis),
                 split_fused.split_fused_ref(a, inv, k=4, beta=7, mode=mode,
                                             axis=axis))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("batch", [(), (5,)])
def test_group_gemm_kernel(dev, G, batch):
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(1)
    da = torch.randint(-128, 128, (4,) + batch + (67, 131), generator=g,
                       device=dev, dtype=torch.int8)
    db = torch.randint(-128, 128, (4,) + batch + (131, 45), generator=g,
                       device=dev, dtype=torch.int8)
    ia, ib = list(range(G)), list(range(G - 1, -1, -1))
    assert torch.equal(group_gemm(da, db, ia, ib),
                       group_gemm_ref(da, db, ia, ib))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_accum_kernels(dev, dtype):
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(2)
    p32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 33, 77), generator=g,
                        device=dev, dtype=torch.int32)
    srow = torch.pow(2.0, torch.randint(-30, -5, (2, 33), generator=g,
                                        device=dev)).to(dtype)
    scol = torch.pow(2.0, torch.randint(-4, 4, (2, 77), generator=g,
                                        device=dev)).to(dtype)
    c = torch.randn((2, 33, 77), generator=g, device=dev, dtype=dtype)
    assert _same(sa.scale_accum_plain(p32, srow, scol, c.clone()),
                 sa.scale_accum_plain_ref(p32, srow, scol, c))
    if dtype == torch.float32:
        lo = c * 2.0 ** -26
        hi_k, lo_k = sa.scale_accum(p32, srow, scol, c.clone(), lo.clone())
        hi_r, lo_r = sa.scale_accum_ref(p32, srow, scol, c, lo)
        assert _same(hi_k, hi_r) and _same(lo_k, lo_r)
