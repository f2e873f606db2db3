"""The plain PyTorch versions of the kernels, under the names of the
reference's oracles (``repro.kernels.ref``).  Each lives beside its kernel;
this module only gathers them.  ``flash_attention_ref`` is the reference's
naive oracle; ``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref`` are
the plain versions the two flash kernels are held to."""
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.group_gemm import group_gemm_ref
from repro_torch.kernels.scale_accum import (scale_accum_const_plain_ref,
                                             scale_accum_const_ref,
                                             scale_accum_plain_ref,
                                             scale_accum_ref, unscale_ref)
from repro_torch.kernels.split_fused import split_fused_ref

__all__ = ["split_fused_ref", "group_gemm_ref", "scale_accum_ref",
           "scale_accum_plain_ref", "scale_accum_const_ref",
           "scale_accum_const_plain_ref", "unscale_ref",
           "flash_attention_ref", "flash_attention_fwd_ref",
           "flash_attention_bwd_ref"]
