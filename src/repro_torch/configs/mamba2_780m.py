"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060; unverified]

expand=2 -> d_inner=3072, head_dim=64 -> 48 SSD heads.  The cache is
constant-size a slot: a bf16 conv window and an f32 SSM state a layer."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2_780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        d_state=128, d_conv=4, expand=2, ssm_headdim=64, chunk=256,
        subquadratic=True,
        remat_block=4,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, d_state=16, ssm_headdim=16,
                        chunk=32, vocab=256, remat_block=1)
