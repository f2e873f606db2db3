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


def _stack_a(g, dev, k, batch, m, n):
    return torch.randint(-128, 128, (k,) + batch + (m, n), generator=g,
                         device=dev, dtype=torch.int8)


def _stack_b(g, dev, k, batch, n, p):
    """A B digit stack as the axis=1 split stores it: K-major storage
    (k, *batch, p, n) seen as (k, *batch, n, p)."""
    return torch.randint(-128, 128, (k,) + batch + (p, n), generator=g,
                         device=dev, dtype=torch.int8).transpose(-1, -2)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("batch", [(), (5,)])
def test_group_gemm_kernel(dev, G, batch):
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(1)
    da = _stack_a(g, dev, 4, batch, 67, 131)
    db = _stack_b(g, dev, 4, batch, 131, 45)
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
    da = _stack_a(g, dev, 4, batch, 67, 131)
    db = _stack_b(g, dev, 4, batch, 131, 45)
    for d in (da, db):
        first = d[(0,) + (0,) * len(batch)]
        first[:2, 0] = torch.tensor([-128, 127], dtype=torch.int8)
        rest = d[(slice(1, None),) + (0,) * len(batch)]
        rest[:, :2, 0] = torch.tensor([-1, 0], dtype=torch.int8)
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


# (label, batch, m, n, p, route the wrapper must take).  n keeps
# G n 255^2 < 2^31 at G = 32 for the unsigned forms.
GEMM_SHAPES = [
    ("dgemm-like", (), 200, 320, 130, "large"),
    ("batched large", (3,), 130, 256, 200, "large"),
    ("mid m", (), 32, 512, 300, "large"),
    ("decode m4", (), 4, 1024, 700, "skinny"),
    ("decode attention m2", (32,), 2, 128, 48, "skinny"),
    ("decode m1 ragged p", (), 1, 96, 33, "skinny"),
    ("unaligned n", (2,), 13, 70, 9, "skinny"),
    ("unaligned large m", (), 150, 100, 77, "skinny"),
]
FORMS = {"signed": lambda g: (False, False),
         "sign-magnitude": lambda g: (g % 4 > 0, (g + 1) % 4 > 0),
         "unsigned A": lambda g: (True, False),
         "unsigned B": lambda g: (False, True)}


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=[s[0] for s in
                                                     GEMM_SHAPES])
@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_group_gemm_routes(dev, shape, G, form):
    """Both routes bitwise against the plain version: ragged m/n/p, G up
    to MAX_G, batched and not, every signedness form, slices picked out
    of order; the wrapper takes the route its rule names."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    _, batch, m, n, p, want = shape
    g = torch.Generator(device=dev).manual_seed(G * 7 + m)
    k = 6
    da = _stack_a(g, dev, k, batch, m, n)
    db = _stack_b(g, dev, k, batch, n, p)
    ia = [i % k for i in range(G)]
    ib = [(5 * i + 1) % k for i in range(G)]
    ua, ub = zip(*(FORMS[form](i) for i in range(G)))
    before = dict(LAUNCHES)
    got = group_gemm(da, db, ia, ib, a_unsigned=ua, b_unsigned=ub)
    assert LAUNCHES[f"group_gemm_{want}"] == before[f"group_gemm_{want}"] + 1
    assert torch.equal(got, group_gemm_ref(da, db, ia, ib, a_unsigned=ua,
                                           b_unsigned=ub))


@pytest.mark.parametrize("route", ["large", "skinny"])
def test_group_gemm_forced_route_mid_m(dev, route):
    """The crossover region (m = 16..64) runs right on either route."""
    from repro_torch.kernels.group_gemm import _launch, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(9)
    for m in (16, 17, 48, 64):
        da = _stack_a(g, dev, 4, (), m, 256)
        db = _stack_b(g, dev, 4, (), 256, 257)
        assert torch.equal(_launch(da, db, which=route),
                           group_gemm_ref(da, db))


@pytest.mark.parametrize("p", [1000, 8192, 20000, 92672])
def test_group_gemm_split_over_contraction(dev, p):
    """Decode shapes (m = 4, n = 2048, G = 4) from w_gate to the LM head's
    width: the fewer column tiles, the more blocks split the (pair, chunk)
    units (16, 8, 4 and 1 splits here), and the atomicAdd combination is
    bitwise the plain version's."""
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(10)
    da = _stack_a(g, dev, 4, (), 4, 2048)
    db = _stack_b(g, dev, 4, (), 2048, p)
    ia, ib = [0, 1, 2, 3], [3, 2, 1, 0]
    assert torch.equal(group_gemm(da, db, ia, ib),
                       group_gemm_ref(da, db, ia, ib))


def test_group_gemm_takes_kmajor_only(dev):
    """A p-contiguous B raises on the card; a K-major copy of it (a
    transposed view of (K, p, n) storage) is taken."""
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(11)
    da = _stack_a(g, dev, 2, (), 8, 64)
    db = torch.randint(-128, 128, (2, 64, 40), generator=g, device=dev,
                       dtype=torch.int8)
    with pytest.raises(ValueError, match="K-major"):
        group_gemm(da, db)
    dk = db.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(group_gemm(da, dk), group_gemm_ref(da, db))


FLASH = [  # BKV, group, Lq, Lk, D, Dv, causal, window, q_offset, lk
    (2, 2, 70, 70, 16, 16, True, None, 0, None),
    (1, 4, 37, 100, 32, 8, False, None, 0, 90),
    (2, 2, 130, 130, 64, 64, True, 17, 0, None),
    (1, 2, 40, 40, 128, 128, True, None, -9, None),    # fully masked rows
    (2, 2, 50, 61, 20, 12, True, 5, 3, None),          # D, Dv not 8-aligned
    (1, 2, 4000, 4000, 128, 128, True, None, 0, None),  # ragged main width
    (1, 2, 1000, 1000, 128, 128, True, 300, 0, None),   # window
    (1, 2, 500, 500, 128, 128, True, None, -100, None),  # fully masked rows
]


@pytest.mark.parametrize("case", FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels(dev, case, dtype):
    """Forward and backward kernels against their plain versions, ragged
    lengths, GQA, windows, key padding and fully masked rows; the
    reference's tolerances in f32 (2e-5 forward, 2e-4 backward; lse is f32
    in both dtypes and held to them).  A bf16 output is held to the
    reference's relative 2e-2 with an absolute term of one bf16 unit
    roundoff (4e-3) of its largest value, at most 2e-2.  Every launch
    counts under its dtype's route (bf16 ``wgmma``, f32 ``tf32x3``)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as fa
    BKV, group, Lq, Lk, D, Dv, causal, window, q_offset, lk = case
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((BKV * group, Lq, D), (BKV, Lk, D),
                             (BKV, Lk, Dv), (BKV * group, Lq, Dv)))
    kw = dict(group=group, causal=causal, window=window, q_offset=q_offset,
              lk=lk)
    routes = {r: LAUNCHES[r] for r in ("flash_wgmma", "flash_tf32x3")}
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, **kw)
    _assert_flash_close(o, o_r, 2e-5)
    _assert_flash_close(lse, lse_r, 2e-5)
    got = fa.flash_attention_bwd(q, k, v, o_r, lse_r, do, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
    mine = "flash_" + fa.route(dtype)
    for r, n in routes.items():
        assert LAUNCHES[r] - n == (3 if r == mine else 0), r
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _assert_flash_close(a, b, 2e-4)


@pytest.mark.parametrize("seed", range(4))
def test_flash_f32_backward_fully_masked_rows_full_width(dev, seed):
    """The 3xTF32 backward at internlm2-1.8b's attention width (L 4096, 16
    query and 8 KV heads, D 128) with 100 fully masked rows (q_offset
    -100), where p is 1 on every key and the gradients' sums over 4096
    keys cancel: within the reference's 2e-4 of the plain version, on
    several draws."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(100 + seed)
    q, k, v, do = (torch.randn(s, generator=g, device=dev)
                   for s in ((16, 4096, 128), (8, 4096, 128),
                             (8, 4096, 128), (16, 4096, 128)))
    kw = dict(group=2, causal=True, q_offset=-100)
    o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, b in zip(got, want):
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


def _near_underflow(g, dev, dtype, m, n):
    """Rows whose maxima sit near the bottom of the normal range (f32
    1e-36, 4e-37, 1e-37; f64 1e-305, 1e-307) plus a subnormal row, among
    ordinary rows: their grids and scale products underflow."""
    tiny = torch.finfo(dtype).tiny
    maxima = [1e-36, 4e-37, 1e-37] if dtype == torch.float32 else \
        [1e-305, 1e-307]
    a = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
    for i, mx in enumerate(maxima):
        a[i] = a[i] / a[i].abs().max() * mx
    a[len(maxima)] = tiny * torch.rand((n,), generator=g, device=dev,
                                       dtype=dtype)
    return a


@pytest.mark.parametrize("mode", ["bitmask", "rn_const", "sm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_fused_kernel_underflow(dev, mode, dtype, axis):
    """Near-underflow rows: the kernel flushes where its plain version
    does (bitwise), through the whole Split of ops.split_fused too."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(12)
    a = _near_underflow(g, dev, dtype, 9, 70)
    a = a if axis == 0 else a.T.contiguous()
    beta = 8 if mode == "sm" else 7
    sp = ops.split_fused(a, 6, beta, mode=mode, axis=axis)
    ref = ops.split_fused(a.cpu(), 6, beta, mode=mode, axis=axis)
    assert torch.equal(sp.digits.cpu(), ref.digits)
    assert _same(sp.scale.cpu(), ref.scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epilogue_kernels_underflow(dev, dtype):
    """Scale products that fall below the normal range, and subnormal
    accumulator operands: every epilogue kernel flushes as its plain
    version does."""
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(13)
    itype, mant, bias = (torch.int32, 23, 127) if dtype == torch.float32 \
        else (torch.int64, 52, 1023)

    def pow2(lo, hi, shape):  # exact normal powers of two 2^[lo, hi)
        e = torch.randint(lo, hi, shape, generator=g, device=dev)
        return ((e + bias).to(itype) << mant).view(dtype)

    emin = -150 if dtype == torch.float32 else -1050
    p32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 17, 41), generator=g,
                        device=dev, dtype=torch.int32)
    srow = pow2(emin // 2, emin // 2 + 20, (2, 17))
    scol = pow2(emin // 2 - 20, emin // 2 + 2, (2, 41))
    c = torch.randn((2, 17, 41), generator=g, device=dev, dtype=dtype) * \
        torch.finfo(dtype).tiny * 4
    assert _same(sa.scale_accum_plain(p32, srow, scol, c.clone()),
                 sa.scale_accum_plain_ref(p32, srow, scol, c))
    assert _same(sa.unscale(c, srow, scol), sa.unscale_ref(c, srow, scol))
    s = pow2(emin + 30, emin + 40, (2,))
    assert _same(sa.scale_accum_const_plain(p32, s, c.clone()),
                 sa.scale_accum_const_plain_ref(p32, s, c))
    if dtype == torch.float32:
        lo = c * 2.0 ** -20
        hi_k, lo_k = sa.scale_accum(p32, srow, scol, c.clone(), lo.clone())
        hi_r, lo_r = sa.scale_accum_ref(p32, srow, scol, c, lo)
        assert _same(hi_k, hi_r) and _same(lo_k, lo_r)
        hi_k, lo_k = sa.scale_accum_const(p32, s, c.clone(), lo.clone())
        hi_r, lo_r = sa.scale_accum_const_ref(p32, s, c, lo)
        assert _same(hi_k, hi_r) and _same(lo_k, lo_r)


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32:fused",
                                  "ozimmu_h-8:f64:fused",
                                  "oz2_h-4:df32:fast2:fused",
                                  "ozimmu_sm_h-4:df32:fused",
                                  "ozimmu_h-4:df32"])
def test_pipeline_underflow_equals_cpu(dev, spec):
    """A row of A and a column of B scaled toward the bottom of the range
    (products near 1e-40 in f32, 1e-300 in f64): the card equals the CPU
    pipeline bit for bit, fused and library paths alike."""
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    g = torch.Generator(device=dev).manual_seed(14)
    f64 = ":f64" in spec
    dtype = torch.float64 if f64 else torch.float32
    a = torch.randn((12, 96), generator=g, device=dev, dtype=dtype)
    b = torch.randn((96, 10), generator=g, device=dev, dtype=dtype)
    for i, s in enumerate([1e-150, 1e-290, 1e-300] if f64 else
                          [1e-20, 1e-30]):
        a[i] *= s
        b[:, i] *= s
    cfg = parse_spec(spec)
    assert _same(ozimmu_matmul(a, b, cfg).cpu(),
                 ozimmu_matmul(a.cpu(), b.cpu(), cfg))


def _hostile_rows(g, dev, dtype, batch, m, n):
    """Ordinary rows plus a zero row, a row with NaN, a row with an
    infinity, a subnormal row, a row at the top of the range (its base
    overflows to inf) and near-underflow rows."""
    a = torch.randn(batch + (m, n), generator=g, device=dev, dtype=dtype)
    fi = torch.finfo(dtype)
    a[..., 0, :] = 0.0
    a[..., 1, 3] = float("nan")
    a[..., 2, 5] = -float("inf")
    a[..., 3, :] = fi.tiny * torch.rand(batch + (n,), generator=g,
                                        device=dev, dtype=dtype)
    a[..., 4, :] *= fi.max / 8
    a[..., 5, :] *= 1e-36 if dtype == torch.float32 else 1e-305
    a[..., 6, :] *= 1e-37 if dtype == torch.float32 else 1e-307
    return a


WHOLE_MODES = ["bitmask", "rn_const", "sm", "oz2_bitmask_fast2",
               "oz2_rn_fast2", "oz2_rn", "oz2_bitmask"]
# (batch, R, C, k): ragged (no multiple of 4: the scalar paths), aligned
# (16-byte loads, packed stores), long columns (several 128-row tiles)
WHOLE_SHAPES = [((3,), 37, 53, 5), ((2,), 64, 128, 4), ((), 300, 36, 3)]


@pytest.mark.parametrize("mode", WHOLE_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", WHOLE_SHAPES, ids=["ragged", "aligned",
                                                     "long"])
def test_split_whole_kernel(dev, mode, dtype, axis, shape):
    """The one-launch split (row maxima, grids, bases, scales, digits) on
    hostile rows against its plain version on the card, bitwise: every
    field of the Split, one launch a split."""
    from repro_torch.kernels import LAUNCHES, ops
    batch, R, C, k = shape
    g = torch.Generator(device=dev).manual_seed(15)
    a = _hostile_rows(g, dev, dtype, batch, R, C)
    if axis == 1:
        a = a.transpose(-1, -2).contiguous()
    beta = 8 if mode == "sm" else 7
    before = LAUNCHES["split_fused"]
    sp = ops.split_fused(a, k, beta, mode=mode, axis=axis)
    assert LAUNCHES["split_fused"] == before + 1
    ref = ops.split_fused_ref(a, k, beta, mode=mode, axis=axis)
    assert torch.equal(sp.digits, ref.digits)
    assert sp.digits.stride() == ref.digits.stride()
    assert _same(sp.scale, ref.scale) and _same(sp.base, ref.base)
    assert (sp.gbase is None) == (ref.gbase is None)
    if ref.gbase is not None:
        assert _same(sp.gbase, ref.gbase)


@pytest.mark.parametrize("shape,axis", [((4, 2048), 0), ((4, 8192), 0),
                                        ((32, 128, 48), 1),
                                        ((32, 48, 128), 1),
                                        ((8192, 96), 1), ((2, 4096, 40), 1)])
def test_split_whole_kernel_decode_shapes(dev, shape, axis):
    """The serve path's shapes: decode A rows, the attention B operands
    (batched, axis 1), a long weight column strip."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(16)
    a = torch.randn(shape, generator=g, device=dev)
    for mode in ("rn_const", "sm"):
        sp = ops.split_fused(a, 4, 7, mode=mode, axis=axis)
        ref = ops.split_fused_ref(a, 4, 7, mode=mode, axis=axis)
        assert torch.equal(sp.digits, ref.digits)
        assert _same(sp.scale, ref.scale) and _same(sp.base, ref.base)


@pytest.mark.parametrize("axis", [0, 1])
def test_split_whole_kernel_many_slices(dev, axis):
    """k = 14 in f64: the column kernel's digit tile needs more than 48 KB
    of shared memory (opted in at launch)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(17)
    a = torch.randn((200, 260), generator=g, device=dev,
                    dtype=torch.float64)
    sp = ops.split_fused(a, 14, 7, mode="rn_const", axis=axis)
    ref = ops.split_fused_ref(a, 14, 7, mode="rn_const", axis=axis)
    assert torch.equal(sp.digits, ref.digits)
    assert _same(sp.scale, ref.scale)


# the attention's B operands as serving passes them: (batch, KV, R, C)
# views of a (batch, L, KV, D) cache; each name gives the storage's dims in
# the view's order (0 batch, 1 KV, 2 R, 3 C) and the permutation back
_CACHE_VIEWS = {"scores (D, L): rows of unit stride": ((0, 3, 1, 2),
                                                       (0, 2, 3, 1)),
                "p@v (L, D): rows strided": ((0, 2, 1, 3), (0, 2, 1, 3))}


def _cache_view(x, name):
    """``x`` (batch, KV, R, C) stored as a KV cache: the same values in a
    permuted view of a cache tensor, as ``canonical_rhs`` hands it over."""
    order, back = _CACHE_VIEWS[name]
    store = torch.empty([x.shape[i] for i in order], dtype=x.dtype,
                        device=x.device)
    view = store.permute(*back)
    view.copy_(x)
    assert tuple(view.shape) == tuple(x.shape) and not view.is_contiguous()
    return view


@pytest.mark.parametrize("mode", WHOLE_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", sorted(_CACHE_VIEWS))
def test_split_whole_kernel_reads_cache_views(dev, mode, dtype, layout):
    """The column split reads its operand through its strides: on the KV
    cache's permuted views (hostile rows, ragged R and C) it equals the
    split of the contiguous copy bitwise, with no copy made."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(22)
    x = _hostile_rows(g, dev, dtype, (2, 3), 37, 53)
    view = _cache_view(x, layout)
    beta = 8 if mode == "sm" else 7
    sp = ops.split_fused(view, 5, beta, mode=mode, axis=1)
    ref = ops.split_fused_ref(x, 5, beta, mode=mode, axis=1)
    assert torch.equal(sp.digits, ref.digits)
    assert _same(sp.scale, ref.scale) and _same(sp.base, ref.base)
    if ref.gbase is not None:
        assert _same(sp.gbase, ref.gbase)


def _dispatched(fn):
    """The aten operations ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


# what a one-launch wrapper may dispatch: its output allocations and views
_ALLOC_OR_VIEW = {"aten.empty.memory_format", "aten.transpose.int"}


@pytest.mark.parametrize("mode", ["rn_const", "sm", "oz2_rn_fast2"])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_wrapper_runs_no_pytorch_op(dev, mode, axis):
    """On the card a per-row split is its kernel alone: no reduction, grid
    or scale operation of PyTorch around it."""
    from repro_torch.kernels import ops
    a = torch.randn((4, 2048), device=dev)
    ops.split_fused(a, 4, 7, mode=mode, axis=axis)          # builds
    seen = _dispatched(lambda: ops.split_fused(a, 4, 7, mode=mode,
                                               axis=axis))
    assert set(seen) <= _ALLOC_OR_VIEW, seen


@pytest.mark.parametrize("layout", sorted(_CACHE_VIEWS))
def test_split_wrapper_runs_no_pytorch_op_on_cache_views(dev, layout):
    """The attention's B operands at serve shapes (4 slots, 8 KV heads,
    head dim 128, 48 cached positions), as permuted views of the cache:
    the split is its kernel alone, no copy before it."""
    from repro_torch.kernels import ops
    shape = (4, 8, 128, 48) if layout.startswith("scores") else \
        (4, 8, 48, 128)
    a = _cache_view(torch.randn(shape, device=dev), layout)
    for mode in ("rn_const", "sm"):
        ops.split_fused(a, 4, 7, mode=mode, axis=1)
        seen = _dispatched(lambda: ops.split_fused(a, 4, 7, mode=mode,
                                                   axis=1))
        assert set(seen) <= _ALLOC_OR_VIEW, seen


def _chunk_inputs(g, dev, batch, m, p, C, tiny=False):
    prods = [torch.randint(-2 ** 31, 2 ** 31 - 1, batch + (m, p),
                           generator=g, device=dev, dtype=torch.int32)
             for _ in range(C)]
    lo, hi = (-75, -60) if tiny else (-30, 5)
    base_a = torch.pow(2.0, torch.randint(lo, hi, batch + (m,), generator=g,
                                          device=dev).float())
    base_b = torch.pow(2.0, torch.randint(lo, hi, batch + (p,), generator=g,
                                          device=dev).float())
    return prods, base_a, base_b


@pytest.mark.parametrize("C", [1, 4, 10, 16, 17, 36])
@pytest.mark.parametrize("shape", [((2,), 5, 36), ((3,), 7, 13),
                                   ((), 4, 9268)],
                         ids=["aligned", "ragged", "decode"])
@pytest.mark.parametrize("partial", [False, True])
def test_scale_accum_chunks_kernel(dev, C, shape, partial):
    """The whole-contraction df32 epilogue against its plain version,
    bitwise: C chunks (more than one launch above 16), groups repeating as
    small r makes them, the f32 sum or (hi, lo)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import scale_accum as sa
    batch, m, p = shape
    g = torch.Generator(device=dev).manual_seed(18 + C)
    prods, base_a, base_b = _chunk_inputs(g, dev, batch, m, p, C)
    groups = [2 + i // 3 for i in range(C)]
    before = LAUNCHES["scale_accum"]
    got = sa.scale_accum_chunks(prods, groups, base_a, base_b, 7,
                                partial=partial)
    assert LAUNCHES["scale_accum"] == before + -(-C // sa.MAX_CHUNKS)
    want = sa.scale_accum_chunks_ref(prods, groups, base_a, base_b, 7,
                                     partial=partial)
    if partial:
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    else:
        assert _same(got, want)


def test_scale_accum_chunks_kernel_underflow(dev):
    """Row and column scales whose products with the int32 sums fall below
    the normal range, and group exponents that make the row scale
    subnormal: the kernel flushes as its plain version does."""
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(19)
    prods, base_a, base_b = _chunk_inputs(g, dev, (2,), 6, 44, 4, tiny=True)
    for beta in (7, 20):
        got = sa.scale_accum_chunks(prods, [2, 3, 4, 5], base_a, base_b,
                                    beta)
        want = sa.scale_accum_chunks_ref(prods, [2, 3, 4, 5], base_a,
                                         base_b, beta)
        assert _same(got, want)


def test_epilogue_wrapper_runs_no_pytorch_op(dev):
    """On the card a contraction's df32 epilogue is its kernel alone: no
    zeroing, row-scale or conversion operation of PyTorch around it."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(20)
    prods, base_a, base_b = _chunk_inputs(g, dev, (), 4, 2048, 4)
    run = lambda: ops.scale_accum_contraction(prods, [2, 3, 4, 5], base_a,
                                              base_b, 7)
    run()
    seen = _dispatched(run)
    assert set(seen) <= _ALLOC_OR_VIEW, seen


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32:fused",
                                  "ozimmu_sm_h-4:df32:fused",
                                  "ozimmu_ef-3:df32:fused"])
def test_fused_attention_product_equals_cpu(dev, spec):
    """A batched (attention-shaped) emulated product on the card, with its
    one-launch splits and epilogue, equals the CPU plain-version pipeline
    bit for bit; one epilogue launch per contraction."""
    from repro_torch.core.ozimmu import ozimmu_dot_general, parse_spec
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn((4, 8, 2, 128), generator=g, device=dev)
    k = torch.randn((4, 8, 48, 128), generator=g, device=dev)
    q[:, 3] *= 1e-20
    dnums = (((3,), (3,)), ((0, 1), (0, 1)))
    cfg = parse_spec(spec)
    before = dict(LAUNCHES)
    out = ozimmu_dot_general(q, k, dnums, cfg)
    assert LAUNCHES["scale_accum"] == before["scale_accum"] + 1
    assert LAUNCHES["split_fused"] == before["split_fused"] + 2
    assert _same(out.cpu(), ozimmu_dot_general(q.cpu(), k.cpu(), dnums, cfg))


_INT32_MIN = -2 ** 31


def _window_inputs(g, dev, batch, m, p, C, dtype=torch.float32, tiny=False):
    """C int32 chunk products over the whole int32 range, with hostile
    words planted in the first elements of the first two windows (two
    chunks a group: products 0, 1 of group 2, 2, 3 of group 3): +-2^30,
    INT32_MIN + 1, and the two-group fold (-2^24) << 7 + 1 = INT32_MIN + 1;
    power-of-two gbases (batch,) and fast2 bases (batch, m), (batch, p) in
    ``dtype``."""
    prods = [torch.randint(_INT32_MIN, 2 ** 31 - 1, batch + (m, p),
                           generator=g, device=dev, dtype=torch.int32)
             for _ in range(C)]
    flat = [q.view(-1) for q in prods]
    if flat[0].numel() >= 4:
        flat[0][:3] = torch.tensor([2 ** 30, -2 ** 30, _INT32_MIN + 1])
        for i, v in enumerate([-2 ** 24, 0, 1, 0][:C]):
            flat[i][3] = v
    lo, hi = (-70, -55) if tiny else (-30, 30)

    def pow2(shape, lo=lo, hi=hi):
        return torch.pow(2.0, torch.randint(lo, hi, shape, generator=g,
                                            device=dev).to(dtype))
    return prods, pow2(batch), pow2(batch), pow2(batch + (m,), -40, 40), \
        pow2(batch + (p,), -40, 40)


@pytest.mark.parametrize("C", [1, 4, 17, 36])
@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("shape", [((2,), 5, 36), ((3,), 7, 13),
                                   ((), 4, 9268)],
                         ids=["aligned", "ragged", "decode"])
@pytest.mark.parametrize("fast2", [False, True])
@pytest.mark.parametrize("partial", [False, True])
def test_scale_accum_const_windows_kernel(dev, C, c, shape, fast2, partial):
    """The Ozaki-II whole-contraction df32 epilogue against its plain
    version, bitwise: C chunk products two a group, windows of one group
    (c = 1) or two (c = 2, the lower group shifted by beta), hostile
    words, more than one launch above 32 products, the fast2 unscale or
    none, the f32 sum or (hi, lo)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import scale_accum as sa
    batch, m, p = shape
    g = torch.Generator(device=dev).manual_seed(30 + C)
    prods, ga, gb, ba, bb = _window_inputs(g, dev, batch, m, p, C)
    bases = (ba, bb) if fast2 else (None, None)
    groups = [2 + i // 2 for i in range(C)]
    before = LAUNCHES["scale_accum_const"]
    got = sa.scale_accum_const_windows(prods, groups, c, 7, ga, gb, *bases,
                                       partial=partial)
    assert LAUNCHES["scale_accum_const"] == before + -(-C // sa.MAX_WORDS)
    want = sa.scale_accum_const_windows_ref(prods, groups, c, 7, ga, gb,
                                            *bases, partial=partial)
    if partial:
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    else:
        assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tiny", [False, True])
def test_scale_accum_const_windows_kernel_scales(dev, dtype, tiny):
    """f32 and f64 gbases and bases (the scales formed from the f32
    conversion of the gbases, the unscale factors in the bases' dtype);
    tiny gbases put the window scales and their products below the normal
    range, and groups up to 2k = 20 make the half exponents subnormal."""
    from repro_torch.kernels import scale_accum as sa
    g = torch.Generator(device=dev).manual_seed(40)
    prods, ga, gb, ba, bb = _window_inputs(g, dev, (2,), 6, 44, 19, dtype,
                                           tiny=tiny)
    groups = list(range(2, 21))
    for c in (1, 3):
        got = sa.scale_accum_const_windows(prods, groups, c, 7, ga, gb, ba,
                                           bb)
        want = sa.scale_accum_const_windows_ref(prods, groups, c, 7, ga, gb,
                                                ba, bb)
        assert _same(got, want)


def test_oz2_epilogue_wrapper_runs_no_pytorch_op(dev):
    """On the card an Ozaki-II contraction's df32 epilogue is its kernel
    alone: no fold, scale, ratio, zeroing, unscale or conversion operation
    of PyTorch around it."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(41)
    prods, ga, gb, ba, bb = _window_inputs(g, dev, (), 4, 2048, 4)
    for c in (1, 2):
        run = lambda: ops.oz2_scale_accum_contraction(prods, [2, 3, 4, 5], c,
                                                      7, ga, gb, ba, bb)
        run()
        seen = _dispatched(run)
        assert set(seen) <= _ALLOC_OR_VIEW, seen


@pytest.mark.parametrize("spec,dtype,windows", [
    ("oz2_h-4:df32:fast2:fused", torch.float32, 1),
    ("oz2_h-4:df32:fast2:fused", torch.float64, 1),
    ("oz2_b-17:df32:fused", torch.float32, 2)])
@pytest.mark.parametrize("shape", ["rank2", "attention"])
def test_oz2_df32_pipeline_one_launch_a_contraction(dev, spec, dtype,
                                                    windows, shape):
    """An Ozaki-II df32 product on the card equals the CPU plain-version
    pipeline bit for bit with one epilogue launch a contraction (two for
    the 33 chunk products of k = 17 in full mode) and no unscale launch:
    rank 2 at n = 300, and the attention's batched scores (n = 128: two
    groups a ladder window); f64 inputs keep f64 bases."""
    from repro_torch.core.ozimmu import ozimmu_dot_general, parse_spec
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device=dev).manual_seed(42)
    if shape == "rank2":
        a = torch.randn((45, 300), generator=g, device=dev, dtype=dtype)
        a = a * torch.pow(2.0, torch.randint(-10, 10, (45, 1), generator=g,
                                             device=dev)).to(dtype)
        b = torch.randn((300, 33), generator=g, device=dev, dtype=dtype)
        dnums = (((1,), (0,)), ((), ()))
    else:
        a = torch.randn((4, 8, 2, 128), generator=g, device=dev, dtype=dtype)
        b = torch.randn((4, 8, 48, 128), generator=g, device=dev,
                        dtype=dtype)
        a[:, 3] *= 1e-20
        dnums = (((3,), (3,)), ((0, 1), (0, 1)))
    cfg = parse_spec(spec)
    before = dict(LAUNCHES)
    out = ozimmu_dot_general(a, b, dnums, cfg)
    assert LAUNCHES["scale_accum_const"] == \
        before["scale_accum_const"] + windows
    assert LAUNCHES["unscale"] == before["unscale"]
    assert _same(out.cpu(), ozimmu_dot_general(a.cpu(), b.cpu(), dnums, cfg))


def _plain_split(x, beta, axis, chunks):
    """The plain split's digits, scales and bases of ``x``, run on
    ``chunks`` slices of its leading axis (independent rows or columns per
    batch element) and concatenated."""
    from repro_torch.kernels import ops
    parts = [ops.split_fused_ref(xc, 4, beta, axis=axis)
             for xc in x.chunk(chunks)]
    return (torch.cat([p.digits for p in parts], 1),
            torch.cat([p.scale for p in parts], 1),
            torch.cat([p.base for p in parts], 0))


def _contraction_kernels(a, w, route, chunks=1):
    """One k = 4 contraction of ``a`` (*batch, m, n) with ``w`` (*batch,
    n, p) kernel by kernel, as the pipeline runs it: the split of both
    sides, the four group GEMMs (groups 2..5) on ``route`` and the df32
    epilogue, each bitwise to its plain version on the same tensors (the
    plain split and group GEMM run on ``chunks`` slices of the leading
    axis: a 160-expert stack's plain temporaries would not fit whole)."""
    from repro_torch.core.splitting import compute_beta
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa
    beta = compute_beta(a.shape[-1])
    sps = []
    for x, axis in ((a, 0), (w, 1)):
        sp = ops.split_fused(x, 4, beta, axis=axis)
        digits, scale, base = _plain_split(x, beta, axis, chunks)
        assert torch.equal(sp.digits, digits)
        assert _same(sp.scale, scale) and _same(sp.base, base)
        sps.append(sp)
    da, db = sps[0].digits, sps[1].digits
    prods = []
    for grp in range(2, 6):
        pairs = [(i, grp - i) for i in range(1, grp) if i <= 4 and
                 grp - i <= 4]
        ia, ib = [s - 1 for s, _ in pairs], [t - 1 for _, t in pairs]
        before = LAUNCHES[f"group_gemm_{route}"]
        out = gg.group_gemm(da, db, ia, ib)
        assert LAUNCHES[f"group_gemm_{route}"] == before + 1
        ref = torch.cat([gg.group_gemm_ref(ac, bc, ia, ib) for ac, bc in
                         zip(da.chunk(chunks, 1), db.chunk(chunks, 1))])
        assert torch.equal(out, ref)
        prods.append(out)
    groups = [2, 3, 4, 5]
    assert _same(sa.scale_accum_chunks(prods, groups, sps[0].base,
                                       sps[1].base, beta),
                 sa.scale_accum_chunks_ref(prods, groups, sps[0].base,
                                           sps[1].base, beta))
    return sps


def _moe_buffer(g, dev, E, cap, n, live):
    """A MoE dispatch buffer (E, cap, n): ``live`` tokens' rows filled
    expert by expert from the front of each queue, the rest zero."""
    a = torch.zeros((E, cap, n), device=dev)
    fill = [0] * E
    for _ in range(live):
        e = int(torch.randint(0, E, (1,), generator=g, device=dev))
        if fill[e] < cap:
            a[e, fill[e]] = torch.randn((n,), generator=g, device=dev)
            fill[e] += 1
    return a


@pytest.mark.parametrize("E,cap,n,p", [(64, 8, 2048, 1408),
                                       (64, 8, 1408, 2048),
                                       (160, 8, 5120, 1536),
                                       (8, 16, 200, 72)])
def test_moe_expert_kernels(dev, E, cap, n, p):
    """deepseek-moe-16b's and deepseek-v2-236b's expert contractions at
    decode (and a ragged small one): the split of the E-batched A with
    mostly zero rows and of the bf16-valued expert stack, the skinny group
    GEMM over the E batch (the experts on the grid's z axis) and the df32
    epilogue, each bitwise to its plain version on the same tensors, on
    the route the main path takes.  A 160-expert stack's plain versions
    run in 8 expert chunks."""
    g = torch.Generator(device=dev).manual_seed(21)
    a = _moe_buffer(g, dev, E, cap, n, live=24)
    w = torch.randn((E, n, p), generator=g, device=dev).to(
        torch.bfloat16).float()
    sps = _contraction_kernels(a, w, "skinny",
                               chunks=8 if E * n * p > 1e9 else 1)
    assert not sps[0].digits[:, ~a.any(-1)].any()


def test_moe_expert_contraction_equals_cpu(dev):
    """The E-batched expert product through the engine on the card
    (``ozimmu_h-4:df32:fused``, bf16 operands as the MoE layer passes
    them) equals the CPU plain-version pipeline bit for bit, zero rows
    included, with one split a side, 4 group GEMMs and one epilogue."""
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.moe import _EXPERT_DNUMS
    g = torch.Generator(device=dev).manual_seed(22)
    buf = _moe_buffer(g, dev, 64, 8, 2048, live=24).to(torch.bfloat16)
    w = torch.randn((64, 2048, 1408), generator=g,
                    device=dev).to(torch.bfloat16)
    eng = make_engine("ozimmu_h-4:df32:fused")
    before = dict(LAUNCHES)
    out = eng.dot_general(buf, w, _EXPERT_DNUMS)
    assert {k: LAUNCHES[k] - before[k] for k in
            ("split_fused", "group_gemm", "group_gemm_skinny",
             "scale_accum")} == {"split_fused": 2, "group_gemm": 4,
                                 "group_gemm_skinny": 4, "scale_accum": 1}
    ref = eng.dot_general(buf.cpu(), w.cpu(), _EXPERT_DNUMS)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.cpu().view(torch.int16), ref.view(torch.int16))


def test_mla_up_projection_large_route(dev):
    """deepseek-v2-236b's latent up-projection at decode: the whole bf16
    latent cache of 4 slots x max_len 24 (96 rows, the last 4 of each slot
    zero) against w_uk (512 x 128 heads x 128), on the large route."""
    g = torch.Generator(device=dev).manual_seed(23)
    lat = torch.randn((4, 24, 512), generator=g, device=dev)
    lat[:, 20:] = 0.0
    a = lat.to(torch.bfloat16).float().reshape(96, 512)
    w = torch.randn((512, 16384), generator=g, device=dev) * 512 ** -0.5
    sps = _contraction_kernels(a, w, "large")
    assert not sps[0].digits.reshape(4, 4, 24, 512)[:, :, 20:].any()


def test_mla_up_projection_equals_cpu(dev):
    """The up-projection through the engine on the card (bf16 latent cache
    as the model passes it) equals the CPU plain-version pipeline bit for
    bit, with one split a side, 4 large-route group GEMMs and one
    epilogue."""
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device=dev).manual_seed(24)
    lat = torch.randn((4, 24, 512), generator=g, device=dev)
    lat[:, 20:] = 0.0
    lat = lat.to(torch.bfloat16)
    w = torch.randn((512, 16384), generator=g, device=dev) * 512 ** -0.5
    eng = make_engine("ozimmu_h-4:df32:fused")
    before = dict(LAUNCHES)
    out = eng(lat, w)
    assert {k: LAUNCHES[k] - before[k] for k in
            ("split_fused", "group_gemm", "group_gemm_large",
             "scale_accum")} == {"split_fused": 2, "group_gemm": 4,
                                 "group_gemm_large": 4, "scale_accum": 1}
    ref = eng(lat.cpu(), w.cpu())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.cpu().view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("which", ["scores", "p@v"])
def test_mla_decode_attention_kernels(dev, which):
    """MLA's decode attention contractions at deepseek-v2-236b's width:
    4 slots x 128 heads, one query row a head (G = 1), q/k head dim 192
    (128 nope + 64 rope), v head dim 128, max_len 24; the B side is the
    freshly concatenated k (or the up-projected v) as the engine reads it,
    a permuted view."""
    from repro_torch.core.ozimmu import canonical_rhs
    g = torch.Generator(device=dev).manual_seed(25)
    if which == "scores":
        a = torch.randn((4, 128, 1, 192), generator=g, device=dev)
        kv = torch.randn((4, 24, 128, 192), generator=g, device=dev)
        dn = (((3,), (3,)), ((0, 1), (0, 2)))
    else:
        a = torch.rand((4, 128, 1, 24), generator=g, device=dev)
        a[:, :, :, 20:] = 0.0              # positions past cur_len
        kv = torch.randn((4, 24, 128, 128), generator=g, device=dev)
        dn = (((3,), (1,)), ((0, 1), (0, 2)))
    w = canonical_rhs(kv, dn)[0]
    assert not w.is_contiguous()
    _contraction_kernels(a, w, "skinny")


# internlm2-1.8b's train step at global batch 8 x seq 256 (one attention
# chunk): (lhs shape, rhs shape, dimension numbers) of a contraction, each
# operand as the emulation's canonical layout makes it
_TRAIN_CONTRACTIONS = {
    # w_gate's weight cotangent: its output cotangent contracted over the
    # token axes (a transposed view) with the layer input
    "dW w_gate": ((8, 256, 8192), (8, 256, 2048),
                  (((0, 1), (0, 1)), ((), ()))),
    # w_gate's input cotangent: B is the weight contracted over its output
    # axis (a transposed view)
    "dx w_gate": ((8, 256, 8192), (2048, 8192), (((2,), (1,)), ((), ()))),
    # the scores of the forward, the remat recompute and the flash
    # backward: (B x KV = 64)-batched, m = G x qc = 512
    "scores": ((8, 256, 8, 2, 128), (8, 256, 8, 128),
               (((4,), (3,)), ((0, 2), (0, 2)))),
    # the flash backward's dk (contract g, q)
    "dk": ((8, 8, 2, 256, 256), (8, 256, 8, 2, 128),
           (((2, 3), (3, 1)), ((0, 1), (0, 2)))),
}


@pytest.mark.parametrize("case", sorted(_TRAIN_CONTRACTIONS))
def test_train_contraction_kernels(dev, case):
    """The train step's contractions at full width kernel by kernel on the
    large route: the splits of the canonical operands (transposed and
    permuted views among them), four group GEMMs and the df32 epilogue,
    each bitwise to its plain version."""
    from repro_torch.core.ozimmu import canonical_lhs, canonical_rhs
    a_shape, b_shape, dn = _TRAIN_CONTRACTIONS[case]
    g = torch.Generator(device=dev).manual_seed(30)
    a = canonical_lhs(torch.randn(a_shape, generator=g, device=dev), dn)[0]
    w = canonical_rhs(torch.randn(b_shape, generator=g, device=dev), dn)[0]
    _contraction_kernels(a, w, "large")


def test_train_contraction_vjp_equals_cpu(dev):
    """A projection through the engine with autograd on the card: the
    output and both cotangents equal the CPU plain-version pipeline bit
    for bit, with 2 splits, 4 large-route group GEMMs and one epilogue for
    each of the three contractions."""
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import LAUNCHES
    eng = make_engine("ozimmu_h-4:df32:fused")
    g = torch.Generator().manual_seed(31)
    x = torch.randn((2, 64, 512), generator=g)
    w = torch.randn((512, 1024), generator=g) * 512 ** -0.5
    gout = torch.randn((2, 64, 1024), generator=g)
    res = {}
    for d in (dev, torch.device("cpu")):
        xl, wl = (t.to(d).requires_grad_() for t in (x, w))
        before = dict(LAUNCHES)
        out = eng(xl, wl)
        dx, dw = torch.autograd.grad(out, (xl, wl), gout.to(d))
        res[d.type] = (out.detach().cpu(), dx.cpu(), dw.cpu())
        if d.type == "cuda":
            assert {k: LAUNCHES[k] - before[k] for k in
                    ("split_fused", "group_gemm", "group_gemm_large",
                     "scale_accum")} == {"split_fused": 6, "group_gemm": 12,
                                         "group_gemm_large": 12,
                                         "scale_accum": 3}
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _same(a, b)


def test_smoke_train_step_on_card_equals_cpu(dev):
    """One smoke train step (internlm2-1.8b ``smoke()``, f32 activations,
    ``ozimmu_h-4:df32:fused``) on the card against the CPU: the loss within
    1e-5 and every gradient leaf within 1e-4 of its max|g| (the card's
    elementwise exp, rsqrt and sums differ from the CPU's by an ulp; every
    contraction is bitwise), and the full step's loss and grad norm
    finite."""
    import math
    from repro_torch import configs, optim, tree
    from repro_torch.launch import steps as S
    cfg = configs.get_config("internlm2_1_8b", smoke=True, dtype="float32",
                             engine_spec="ozimmu_h-4:df32:fused")
    state = S.init_state(cfg, optim.OptConfig(),
                         torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    lc, gc = S.loss_and_grads(cfg, state.params, {"tokens": toks})
    on_card = tree.tree_map(lambda t: t.to(dev), state)
    ld, gd = S.loss_and_grads(cfg, on_card.params, {"tokens": toks.to(dev)})
    assert abs(float(ld) - float(lc)) <= 1e-5
    for a, b in zip(tree.leaves(gd), tree.leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())
    _, metrics = S.make_train_step(cfg, optim.OptConfig())(
        on_card, {"tokens": toks.to(dev)})
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_236b",
                                  "mamba2_780m", "recurrentgemma_9b",
                                  "llama32_vision_11b",
                                  "seamless_m4t_medium"])
def test_smoke_family_train_step_on_card_equals_cpu(dev, arch):
    """One smoke train step of each other family (``smoke()``, f32
    activations, ``ozimmu_h-4:df32:fused``, the pipeline's batch with its
    patch rows or frames) on the card against the CPU, as
    :func:`test_smoke_train_step_on_card_equals_cpu` holds the dense one:
    the loss within 1e-5, every gradient leaf within 1e-4 of its max|g|
    (zero leaves equal), the same expert choices, and the full step's
    loss and grad norm finite.  The tied heads' ``embed`` is scaled by
    0.05 and the vlm's gates drawn from the seed, as the card phase does."""
    import math
    from repro_torch import configs, optim, tree
    from repro_torch.data import Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import data_config, device_batch
    from repro_torch.models import moe
    cfg = configs.get_config(arch, smoke=True, dtype="float32",
                             engine_spec="ozimmu_h-4:df32:fused")
    gen = torch.Generator().manual_seed(0)
    state = S.init_state(cfg, optim.OptConfig(), gen, "cpu")
    params = state.params
    if cfg.family in ("ssm", "hybrid"):
        params["embed"].mul_(0.05)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            g = params["groups"]["cross"][name]
            g.copy_(torch.rand(g.shape, generator=gen) + 0.5)
    np_batch = Pipeline(data_config(cfg, seq_len=32, global_batch=2,
                                    seed=1)).batch_at(0)
    sels = {"cpu": [], "cuda": []}
    route = moe._route

    def recording(gates, topk, cap):
        out = route(gates, topk, cap)
        sels[gates.device.type].append(out[1].cpu())
        return out
    moe._route = recording
    try:
        lc, gc = S.loss_and_grads(cfg, params, device_batch(np_batch, "cpu"))
        on_card = tree.tree_map(lambda t: t.to(dev), state)
        batch = device_batch(np_batch, dev)
        ld, gd = S.loss_and_grads(cfg, on_card.params, batch)
    finally:
        moe._route = route
    assert len(sels["cpu"]) == len(sels["cuda"])
    for a, b in zip(sels["cuda"], sels["cpu"]):
        assert torch.equal(a, b)
    assert abs(float(ld) - float(lc)) <= 1e-5
    for a, b in zip(tree.leaves(gd), tree.leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())
    _, metrics = S.make_train_step(cfg, optim.OptConfig())(on_card, batch)
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))


@pytest.mark.parametrize("mode", ["rn_const", "sm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_whole_kernel_reads_a_transposed_head(dev, mode, dtype):
    """The tied LM head's B side, ``embed.T``: a transposed view (unit row
    stride) of a (vocab, d) table, split along its columns through its
    strides (hostile rows, ragged vocab) bitwise to the split of the
    contiguous copy, and with no PyTorch operation but the outputs' (no
    copy of the table first)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(23)
    table = _hostile_rows(g, dev, dtype, (), 1037, 96)   # (vocab, d)
    view = table.T
    assert not view.is_contiguous()
    beta = 8 if mode == "sm" else 7
    sp = ops.split_fused(view, 4, beta, mode=mode, axis=1)
    ref = ops.split_fused_ref(view.contiguous(), 4, beta, mode=mode, axis=1)
    assert torch.equal(sp.digits, ref.digits)
    assert _same(sp.scale, ref.scale) and _same(sp.base, ref.base)
    seen = _dispatched(lambda: ops.split_fused(view, 4, beta, mode=mode,
                                               axis=1))
    assert set(seen) <= _ALLOC_OR_VIEW, seen


@pytest.mark.parametrize("m", [4, 1])
def test_group_gemm_kernel_state_shapes(dev, m):
    """mamba2-780m's ``w_in`` at decode (n = 1536, p = 6448, G = 4, the
    skinny route) and a tied head's ragged vocab (p = 50432 / 4 + 3)."""
    from repro_torch.kernels.group_gemm import group_gemm, group_gemm_ref
    g = torch.Generator(device=dev).manual_seed(24)
    for n, p in ((1536, 6448), (384, 12611)):
        da = _stack_a(g, dev, 4, (), m, n)
        db = _stack_b(g, dev, 4, (), n, p)
        ia, ib = [0, 1, 2, 3], [3, 2, 1, 0]
        assert torch.equal(group_gemm(da, db, ia, ib),
                           group_gemm_ref(da, db, ia, ib))


def test_smoke_hybrid_decode_past_window_on_card_equals_cpu(dev):
    """recurrentgemma-9b ``smoke()`` (window 32, f32 activations,
    ``ozimmu_h-4:df32:fused``, the weights frozen as the runtime freezes
    them) teacher-forced over 40 positions, so the 32-row K/V ring wraps:
    the card's logits within 1e-4 of max|logit| of the CPU's at every
    position, and the runtime's greedy tokens on the card equal to its
    tokens on the CPU (whole and chunked prefill)."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime
    from repro_torch.serving import presplit
    cfg = configs.get_config("recurrentgemma_9b", smoke=True,
                             dtype="float32",
                             engine_spec="ozimmu_h-4:df32:fused")
    model = api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    params["embed"] = params["embed"] * 0.05   # the layers steer the head
    toks = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    for d in (torch.device("cpu"), dev):
        p = presplit.wrap_params({k: _to(v, d) for k, v in params.items()},
                                 cfg.engine)[0]
        cache = model.init_cache(cfg, 2, 40, device=d)
        outs = []
        with torch.no_grad():
            for t in range(40):
                lg, cache = model.decode_step(p, cfg, cache,
                                              toks[:, t:t + 1].to(d),
                                              torch.tensor(t + 1))
                outs.append(lg[:, 0].cpu())
        assert cache["k"].shape[2] == 32
        logits[d.type] = torch.stack(outs, dim=1)
    ref = logits["cpu"]
    err = (logits["cuda"] - ref).abs().amax(dim=(0, 2)) / ref.abs().max()
    assert float(err.max()) <= 1e-4, err
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=torch.Generator(
        ).manual_seed(n)).numpy().astype("int32") for n in (4, 7, 5)]
    for chunk in (None, 2):
        got = {}
        for d in ("cpu", "cuda"):
            rt = ServingRuntime(cfg, params, slots=2, max_len=48,
                                prefill_chunk=chunk, device=d)
            got[d] = [o.tolist() for o in rt.generate(
                [q.copy() for q in prompts], 12)]
        assert got["cuda"] == got["cpu"], chunk


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)


@pytest.mark.parametrize("which", ["scores", "p@v"])
def test_split_whole_kernel_reads_a_cross_key_chunk(dev, which):
    """The context families' cross-attention B operands at decode: a key
    chunk of the padded cross K/V (llama-3.2-vision-11b: 4 slots x 1600
    rows padded to 2 chunks of 1024, 8 KV heads of 128; the second chunk
    448 rows of zero padding), permuted by ``canonical_rhs`` to (4, 8,
    128, 1024) for the scores and (4, 8, 1024, 128) for p@v: split
    through its strides bitwise to the split of the contiguous copy, with
    no PyTorch operation but the outputs'."""
    from repro_torch.core.ozimmu import canonical_rhs
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(25)
    kv = torch.randn((4, 1600, 8, 128), generator=g, device=dev)
    padded = torch.cat([kv, kv.new_zeros((4, 448, 8, 128))], dim=1)
    chunk = padded.reshape(4, 2, 1024, 8, 128)[:, 1]
    dnums = ((((4,), (3,)), ((0, 2), (0, 2))) if which == "scores"
             else (((4,), (1,)), ((0, 1), (0, 2))))
    view = canonical_rhs(chunk, dnums)[0]
    assert not view.is_contiguous()
    assert tuple(view.shape) == ((4, 8, 128, 1024) if which == "scores"
                                 else (4, 8, 1024, 128))
    sp = ops.split_fused(view, 4, 7, axis=1)
    ref = ops.split_fused_ref(view.contiguous(), 4, 7, axis=1)
    assert torch.equal(sp.digits, ref.digits)
    assert _same(sp.scale, ref.scale) and _same(sp.base, ref.base)
    seen = _dispatched(lambda: ops.split_fused(view, 4, 7, axis=1))
    assert set(seen) <= _ALLOC_OR_VIEW, seen


@pytest.mark.parametrize("m", [1600, 6400])
def test_group_gemm_large_route_context_rows(dev, m):
    """The context-time cross ``wk``/``wv`` projection of
    llama-3.2-vision-11b: 1600 patch rows (the single-slot template) and
    6400 (4 slots) x 4096 -> 1024, G = 4, on the large route, bitwise."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.group_gemm import (group_gemm, group_gemm_ref,
                                                route)
    assert route(m, True) == "large"
    g = torch.Generator(device=dev).manual_seed(26)
    da = _stack_a(g, dev, 4, (), m, 4096)
    db = _stack_b(g, dev, 4, (), 4096, 1024)
    ia, ib = [0, 1, 2, 3], [3, 2, 1, 0]
    before = LAUNCHES["group_gemm_large"]
    out = group_gemm(da, db, ia, ib)
    assert LAUNCHES["group_gemm_large"] == before + 1
    assert torch.equal(out, group_gemm_ref(da, db, ia, ib))


@pytest.mark.parametrize("arch", ["llama32_vision_11b",
                                  "seamless_m4t_medium"])
def test_smoke_context_runtime_on_card_equals_cpu(dev, arch):
    """The context families' ``smoke()`` (f32 activations,
    ``ozimmu_h-4:df32:fused``, the vlm's gates drawn nonzero, a context
    drawn from a seed: patch embeddings, or the encoder over frames):
    the runtime's greedy tokens on the card equal its tokens on the CPU,
    whole and chunked prefill, and under a second context they differ."""
    from repro_torch import configs
    from repro_torch.models import api, encdec
    from repro_torch.serving import ServingRuntime
    cfg = configs.get_config(arch, smoke=True, dtype="float32",
                             engine_spec="ozimmu_h-4:df32:fused")
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(cfg, generator=gen, device="cpu")
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][name] = torch.rand(
                (cfg.n_layers // cfg.cross_every,), generator=gen) + 0.5

    def context(seed):
        g = torch.Generator().manual_seed(seed)
        if cfg.family == "vlm":
            return torch.randn((1, cfg.vision_seq, cfg.d_model), generator=g)
        with torch.no_grad():
            return encdec.encode(params, cfg, torch.randn(
                (1, 6, cfg.d_model), generator=g))

    prompts = [torch.randint(0, cfg.vocab, (n,), generator=torch.Generator(
        ).manual_seed(n)).numpy().astype("int32") for n in (4, 7, 5)]
    for chunk in (None, 3):
        got = {}
        for d in ("cpu", "cuda"):
            rt = ServingRuntime(cfg, params, slots=2, max_len=24,
                                prefill_chunk=chunk, ctx=context(1),
                                device=d)
            got[d] = [o.tolist() for o in rt.generate(
                [q.copy() for q in prompts], 10)]
        assert got["cuda"] == got["cpu"], chunk
    rt = ServingRuntime(cfg, params, slots=2, max_len=24, ctx=context(2),
                        device="cuda")
    assert [o.tolist() for o in rt.generate(
        [q.copy() for q in prompts], 10)] != got["cuda"]
