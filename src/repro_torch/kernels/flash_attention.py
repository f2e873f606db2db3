"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/flash_attention.py::
flash_attention_fwd`` and ``::flash_attention_bwd``, in their layout:
q ``(BH, Lq, D)``; k, v ``(BKV, Lk, D / Dv)`` with ``BH = BKV * group``, query
head ``bh`` reading kv head ``bh // group`` (K and V are never expanded).
Scale ``D^-1/2``; masks ``k < lk`` (input padding), causal ``k <= q +
q_offset`` and the sliding ``window`` (``k > q + q_offset - window``), all
with the reference's finite sentinel ``-1e30``, so a row whose every key is
masked averages v uniformly over the tensor's keys.

Two routes on the card, picked from the dtype before the launch
(:func:`route`): bf16 runs on ``wgmma`` (the bf16 tensor cores, f32 sums;
the scale applied to the f32 scores, P rounded to bf16 for PV and dV, dS
carried as two bf16 terms), f32 on 3xTF32 ``mma.sync`` (each operand split
into a rounded and a truncated tf32 term, three products with f32 sums).
Each launch counts once under its kernel (``LAUNCHES["flash_attention_fwd"]``
/ ``["flash_attention_bwd"]``) and once under its route
(``["flash_wgmma"]`` / ``["flash_tf32x3"]``).

The reference takes its TPU tile sizes ``qc``/``kc`` and needs lengths that
are their multiples (``ops.flash_attention`` pads); these functions take any
lengths, and the CUDA kernels pick their own tiles and mask their ragged
edge.  Forward and backward are two functions, as in the reference; the
backward recomputes p from the forward's row ``lse``.

The plain versions compute the same function in whole-matrix PyTorch ops
(f32 scores, the probabilities rounded to v's dtype before the PV product
as the reference does), independently of the kernels; on the CPU the
wrappers run them.  :func:`flash_attention_ref` is the reference's naive
oracle (``repro.kernels.ref.flash_attention_ref``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

__all__ = ["flash_attention_fwd", "flash_attention_bwd", "route",
           "resources",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30
MAX_D = 128          # the kernels' largest head dimension

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_p, _i = ctypes.c_void_p, ctypes.c_int
# pointers, then dtype, BH, group, Lq, Lk, D, Dv, lk, causal, has_window,
# window, q_offset (ints) and the scale; the backward adds which kernel
_FWD_ARGS = [_p] * 5 + [_i] * 12 + [ctypes.c_float, _p]
_BWD_ARGS = [_p] * 9 + [_i] * 12 + [ctypes.c_float, _i, _p]


def _mask(Lq: int, Lk: int, lk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: the keys each query row may attend to."""
    q_pos = torch.arange(Lq, device=device)[:, None] + q_offset
    k_pos = torch.arange(Lk, device=device)[None, :]
    m = k_pos < lk
    if causal:
        m = m & (k_pos <= q_pos)
    if window is not None:
        m = m & (k_pos > q_pos - window)
    return m


def _scores(q, k, group, causal, window, lk, q_offset) -> torch.Tensor:
    """(BH, Lq, Lk) f32 scores of the scaled f32 queries, masked with the
    sentinel (the reference kernels' ``_recompute_p`` before the exp)."""
    D = q.shape[-1]
    kg = k.repeat_interleave(group, dim=0).to(torch.float32)
    s = torch.matmul(q.to(torch.float32) * float(D) ** -0.5,
                     kg.transpose(-1, -2))
    mask = _mask(q.shape[1], k.shape[1], lk, causal, window, q_offset,
                 q.device)
    return s.masked_fill(~mask, NEG_INF)


def _lk(k: torch.Tensor, lk: Optional[int]) -> int:
    return k.shape[1] if lk is None else int(lk)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group: int = 1, causal: bool = True,
                        window: Optional[int] = None, lk: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """The reference's oracle: naive full-softmax attention in the kernel
    layout (scores scaled after the product, softmax, p in v's dtype)."""
    D = q.shape[-1]
    kg = k.repeat_interleave(group, dim=0)
    vg = v.repeat_interleave(group, dim=0)
    s = torch.matmul(q.to(torch.float32),
                     kg.to(torch.float32).transpose(-1, -2)) * D ** -0.5
    mask = _mask(q.shape[1], k.shape[1], _lk(k, lk), causal, window,
                 q_offset, q.device)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.matmul(p.to(vg.dtype), vg).to(q.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, group: int = 1,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0, lk: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(o, lse)``, o ``(BH, Lq, Dv)``
    in q's dtype, lse ``(BH, Lq, 1)`` f32 (+inf where no key was summed)."""
    s = _scores(q, k, group, causal, window, _lk(k, lk), q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vg = v.repeat_interleave(group, dim=0).to(torch.float32)
    pv = torch.matmul(p.to(v.dtype).to(torch.float32), vg)
    lc = torch.clamp(l, min=1e-30)
    o = (pv / lc).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(lc),
                      torch.full_like(l, float("inf")))
    return o, lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            group: int = 1, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0,
                            lk: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernels: ``(dq, dk, dv)`` with p
    recomputed from ``lse`` on the f32 scores the forward formed, dk/dv in
    the unexpanded ``(BKV, ...)`` layout (the group's query heads summed).
    The products and sums run in f64 and each gradient is rounded once to
    the input dtype: where a row's every key is masked, p is 1 on every key
    and its sums over thousands of keys cancel, so f32 sums would miss the
    reference's 2e-4 by themselves (the kernels sum more exactly)."""
    f64 = torch.float64
    scale = float(q.shape[-1]) ** -0.5
    p = torch.exp(_scores(q, k, group, causal, window, _lk(k, lk), q_offset)
                  .to(f64) - lse.to(f64))
    do = dout.to(f64)
    kg = k.repeat_interleave(group, dim=0).to(f64)
    vg = v.repeat_interleave(group, dim=0).to(f64)
    delta = (do * out.to(f64)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vg.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kg) * scale
    dkg = torch.matmul(ds.transpose(-1, -2), q.to(f64)) * scale
    dvg = torch.matmul(p.transpose(-1, -2), do)
    BKV = k.shape[0]
    dk = dkg.reshape((BKV, group) + dkg.shape[1:]).sum(dim=1)
    dv = dvg.reshape((BKV, group) + dvg.shape[1:]).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, group, name, *more):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, L, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, _, D = q.shape
    BKV, Lk, _ = k.shape
    Dv = v.shape[2]
    if BH != BKV * group or k.shape[2] != D or v.shape[:2] != (BKV, Lk):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not fit "
                         f"group={group}")
    for t in (k, v) + more:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and dout) must share dtype "
                             f"and device, got {t.dtype} on {t.device} "
                             f"beside {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take float32 or "
                         f"bfloat16, got {q.dtype}")
    if D > MAX_D or Dv > MAX_D or D % 4 or Dv % 4:
        raise ValueError(f"{name}: head dims must be multiples of 4 up to "
                         f"{MAX_D}, got D={D}, Dv={Dv}")


def resources(dtype: torch.dtype, D: int = MAX_D, Dv: int = MAX_D
              ) -> dict:
    """The launch resources of the route's three kernels for head dims D,
    Dv (built on first use): registers and spilled bytes a thread, shared
    memory and threads a block, as the CUDA runtime reports them."""
    fn = _build.function("flash_attention", "flash_attention_resources",
                         [_i, _i, _i, _i, ctypes.POINTER(_i)])
    res = {}
    for which, name in enumerate(("forward", "dq", "dk/dv")):
        out = (_i * 4)()
        _build.check(fn(_DTYPES[dtype], D, Dv, which, out),
                     "flash_attention_resources")
        res[name] = dict(registers=out[0], smem_bytes=out[1],
                         threads=out[2], spill_bytes=out[3])
    return res


def route(dtype: torch.dtype) -> str:
    """The kernels' route for ``dtype`` on the card: ``"wgmma"`` (bf16) or
    ``"tf32x3"`` (f32)."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash attention kernels take float32 or "
                         f"bfloat16, got {dtype}")
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(kernel: str, dtype: torch.dtype) -> None:
    LAUNCHES[kernel] += 1
    LAUNCHES["flash_" + route(dtype)] += 1


def _mask_args(q, k, v, group, causal, window, q_offset, lk):
    BH, Lq, D = q.shape
    Lk, Dv = k.shape[1], v.shape[2]
    return [_DTYPES[q.dtype], BH, group, Lq, Lk, D, Dv, _lk(k, lk),
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), int(q_offset),
            float(D) ** -0.5]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, group: int = 1, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        lk: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused flash-attention forward: ``(o, lse)`` as
    :func:`flash_attention_fwd_ref`.  q, k, v share one dtype (f32 or bf16
    on CUDA, each on its :func:`route`); head dims are multiples of 4 up
    to 128."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, group=group, causal=causal,
                                       window=window, q_offset=q_offset,
                                       lk=lk)
    _build.require_cuda(q, "flash_attention_fwd")
    _check(q, k, v, group, "flash_attention_fwd")
    q, k, v = _ready(q), _ready(k), _ready(v)
    BH, Lq, _ = q.shape
    o = torch.empty((BH, Lq, v.shape[2]), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Lq, 1), dtype=torch.float32, device=q.device)
    if Lq == 0:
        return o, lse
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         _FWD_ARGS)
    _count("flash_attention_fwd", q.dtype)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(),
                    *_mask_args(q, k, v, group, causal, window, q_offset,
                                lk),
                    _build.stream(q)), "flash_attention_fwd")
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, group: int = 1,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, lk: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute-p flash backward: ``(dq, dk, dv)`` as
    :func:`flash_attention_bwd_ref`, through two kernels (dq per query tile;
    dk and dv per key tile, the group summed in registers, no atomics).
    ``delta = rowsum(dout * out)`` is one PyTorch op, as the reference
    computes it outside its kernels.  Each kernel adds one to
    ``LAUNCHES["flash_attention_bwd"]`` and to its route's count (two per
    call)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, group=group,
                                       causal=causal, window=window,
                                       q_offset=q_offset, lk=lk)
    _build.require_cuda(q, "flash_attention_bwd")
    _check(q, k, v, group, "flash_attention_bwd", dout)
    BH, Lq, _ = q.shape
    if lse.shape != (BH, Lq, 1) or out.shape != dout.shape or \
            dout.shape != (BH, Lq, v.shape[2]):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"lse {tuple(lse.shape)}, dout "
                         f"{tuple(dout.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    q, k, v, dout = (_ready(t) for t in (q, k, v, dout))
    lse = lse.to(torch.float32).contiguous()
    # out converts to f32 inside the product (exactly), as the reference's
    # out.astype(f32) does
    delta = (dout.to(torch.float32) * out).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fn = _build.function("flash_attention", "flash_attention_bwd",
                         _BWD_ARGS)
    args = _mask_args(q, k, v, group, causal, window, q_offset, lk)
    for which in (0, 1):
        _count("flash_attention_bwd", q.dtype)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args,
                        which, _build.stream(q)), "flash_attention_bwd")
    return dq, dk, dv
