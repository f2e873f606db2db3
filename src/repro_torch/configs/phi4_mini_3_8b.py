"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]

The reference's mesh key (``RULES_OVERRIDES``) rides along for
``launch.mesh.mesh_rules``; its benchmark ``SKIP_SHAPES`` come with the
port's benchmark."""
from repro_torch.models.common import ModelConfig

RULES_OVERRIDES = {"cache_hd": "model"}


def full() -> ModelConfig:
    return ModelConfig(
        name="phi4_mini_3_8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064, rope_theta=1e4,
        remat_block=4,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
