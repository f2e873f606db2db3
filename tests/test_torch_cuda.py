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


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("batch", [(), (5,)])
def test_group_gemm_kernel_sign_magnitude(dev, G, batch):
    """The stored sign-magnitude digits (slice 0 signed, the others unsigned
    bytes) in every signedness form, extremes included."""
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(6)
    da = torch.randint(-128, 128, (4,) + batch + (67, 131), generator=g,
                       device=dev, dtype=torch.int8)
    db = torch.randint(-128, 128, (4,) + batch + (131, 45), generator=g,
                       device=dev, dtype=torch.int8)
    for d in (da, db):
        d.view(4, -1)[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
        d.view(4, -1)[1:, :2] = torch.tensor([-1, 0], dtype=torch.int8)
    ia, ib = list(range(G)), list(range(G - 1, -1, -1))
    ua, ub = [i > 0 for i in ia], [j > 0 for j in ib]
    assert torch.equal(
        group_gemm(da, db, ia, ib, a_unsigned=ua, b_unsigned=ub),
        group_gemm_ref(da, db, ia, ib, a_unsigned=ua, b_unsigned=ub))
    assert torch.equal(
        group_gemm(da, db, ia, ib, a_unsigned=[True] * G,
                   b_unsigned=[True] * G),
        group_gemm_ref(da, db, ia, ib, a_unsigned=[True] * G,
                       b_unsigned=[True] * G))


FLASH = [  # BKV, group, Lq, Lk, D, Dv, causal, window, q_offset, lk
    (2, 2, 70, 70, 16, 16, True, None, 0, None),
    (1, 4, 37, 100, 32, 8, False, None, 0, 90),
    (2, 2, 130, 130, 64, 64, True, 17, 0, None),
    (1, 2, 40, 40, 128, 128, True, None, -9, None),    # fully masked rows
]


@pytest.mark.parametrize("case", FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels(dev, case, dtype):
    """Forward and backward kernels against their plain versions, ragged
    lengths, GQA, windows, key padding and fully masked rows; the
    reference's tolerances in f32 (2e-5 forward, 2e-4 backward; lse is f32
    in both dtypes and held to them).  A bf16 output is held to the
    reference's relative 2e-2 with an absolute term of one bf16 unit
    roundoff (4e-3) of its largest value, at most 2e-2."""
    from repro_torch.kernels import flash_attention as fa
    BKV, group, Lq, Lk, D, Dv, causal, window, q_offset, lk = case
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((BKV * group, Lq, D), (BKV, Lk, D),
                             (BKV, Lk, Dv), (BKV * group, Lq, Dv)))
    kw = dict(group=group, causal=causal, window=window, q_offset=q_offset,
              lk=lk)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, **kw)
    _assert_flash_close(o, o_r, 2e-5)
    _assert_flash_close(lse, lse_r, 2e-5)
    got = fa.flash_attention_bwd(q, k, v, o_r, lse_r, do, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _assert_flash_close(a, b, 2e-4)


def _assert_flash_close(got, want, tol):
    if got.dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        atol = min(2e-2, 4e-3 * float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=2e-2, atol=atol)
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


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


@pytest.mark.parametrize("word,dtype", [(torch.int32, torch.float32),
                                        (torch.int32, torch.float64),
                                        (torch.int64, torch.float64),
                                        (torch.int64, torch.float32)])
def test_scale_accum_const_kernels(dev, word, dtype):
    """The Ozaki-II ladder windows, one scalar scale per batch element."""
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(3)
    hi = 2 ** 62 if word == torch.int64 else 2 ** 31 - 1
    w = torch.randint(-hi, hi, (3, 29, 83), generator=g, device=dev,
                      dtype=word)
    s = torch.pow(2.0, torch.randint(-60, -20, (3,), generator=g,
                                     device=dev)).to(dtype)
    c = torch.randn((3, 29, 83), generator=g, device=dev, dtype=dtype)
    assert _same(sa.scale_accum_const_plain(w, s, c.clone()),
                 sa.scale_accum_const_plain_ref(w, s, c))
    if word == torch.int32 and dtype == torch.float32:
        lo = c * 2.0 ** -26
        hi_k, lo_k = sa.scale_accum_const(w, s, c.clone(), lo.clone())
        hi_r, lo_r = sa.scale_accum_const_ref(w, s, c, lo)
        assert _same(hi_k, hi_r) and _same(lo_k, lo_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [(), (4,)])
def test_unscale_kernel(dev, dtype, batch):
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(batch + (37, 61), generator=g, device=dev, dtype=dtype)
    ra = torch.pow(2.0, torch.randint(-30, 30, batch + (37,), generator=g,
                                      device=dev)).to(dtype)
    rb = torch.pow(2.0, torch.randint(-30, 30, batch + (61,), generator=g,
                                      device=dev)).to(dtype)
    assert _same(sa.unscale(x, ra, rb), sa.unscale_ref(x, ra, rb))


@pytest.mark.parametrize("spec", ["oz2_h-4:df32:fast2:fused",
                                  "oz2_b-5:f64:fused", "oz2_h-6:f32:fast:fused",
                                  "ozimmu_rn-4:df32:fused",
                                  "ozimmu_sm_h-8:f64:fused",
                                  "ozimmu_sm_b-4:fused"])
def test_fused_pipeline_equals_cpu(dev, spec):
    """The whole emulated GEMM on the card (split, group GEMM, ladder,
    epilogue and unscale kernels) equals the CPU plain-version pipeline;
    the sign-magnitude specs run the group GEMM on stored digits, grouped
    (``ozimmu_sm_h``) and pairwise (``ozimmu_sm_b``)."""
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    g = torch.Generator(device=dev).manual_seed(5)
    dtype = torch.float64 if ":f64" in spec else torch.float32
    a = torch.randn((45, 300), generator=g, device=dev, dtype=dtype)
    a = a * torch.pow(2.0, torch.randint(-10, 10, (45, 1), generator=g,
                                         device=dev)).to(dtype)
    b = torch.randn((300, 33), generator=g, device=dev, dtype=dtype)
    cfg = parse_spec(spec)
    assert _same(ozimmu_matmul(a, b, cfg).cpu(),
                 ozimmu_matmul(a.cpu(), b.cpu(), cfg))
