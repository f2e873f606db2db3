"""Hand-written Hopper (sm_90a) CUDA kernels for the scheme's hot spots,
each beside its plain PyTorch version:

  * split_fused  — steps (i)/(ii): all k int8 slices in one read
  * group_gemm   — steps (iii)+(iv) merged: int8 GEMM with an int32
                   accumulator over a whole anti-diagonal group (Alg. 6/7),
                   on signed digits or on the sign-magnitude family's
                   stored digits (unsigned trailing slices)
  * scale_accum  — step (iv) epilogue: fused convert + scale + add, df32
                   compensated (``scale_accum``) or plain f32/f64
                   (``scale_accum_plain``); the Ozaki-II ladder windows
                   with one scalar scale (``scale_accum_const``,
                   ``scale_accum_const_plain``) and the fast2 unscale
                   (``unscale``)
  * flash_attention — the standalone fused attention forward and its
                   recompute-p backward (``ops.flash_attention``); no model
                   calls them, as in the reference

A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.  :data:`LAUNCHES` counts kernel launches
(one per launch, nowhere else), so a run can show which kernels it went
through.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"split_fused": 0, "group_gemm": 0,
                            "scale_accum": 0, "scale_accum_plain": 0,
                            "scale_accum_const": 0,
                            "scale_accum_const_plain": 0, "unscale": 0,
                            "flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
