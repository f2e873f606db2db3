"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008
vocab=102400; llama-arch.  [arXiv:2401.02954; hf]

The reference's mesh key (``RULES_OVERRIDES``) and benchmark
``SKIP_SHAPES`` come with the distributed slice of the port."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek_7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102400, rope_theta=1e4,
        remat_block=5,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=96, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
