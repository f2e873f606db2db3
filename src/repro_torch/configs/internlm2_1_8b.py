"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544; GQA.  [arXiv:2403.17297; hf]"""
from repro_torch.models.common import ModelConfig

RULES_OVERRIDES = {"cache_hd": "model"}


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2_1_8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544, rope_theta=1e6,
        remat_block=4,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
