"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE.  [arXiv:2402.19173; hf]

The reference's mesh key (``RULES_OVERRIDES``) and benchmark
``SKIP_SHAPES`` come with the distributed slice of the port."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, rope_theta=1e5,
        remat_block=5,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
