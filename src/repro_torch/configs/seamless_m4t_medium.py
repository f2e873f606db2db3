"""seamless-m4t-medium [audio] — enc-dec, 12L (each side) d_model=1024
16H d_ff=4096 vocab=256206; multimodal.  [arXiv:2308.11596; hf]

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, frames, d_model).  GELU MLPs.  The
reference's mesh rule (``RULES_OVERRIDES``) and shape skips have no
counterpart until the distributed slice of the port."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_medium", family="encdec",
        n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=256206, rope_theta=1e4, mlp_type="gelu",
        remat_block=4,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=4, d_ff=96, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
