"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1 = MQA)
d_ff=12288 vocab=256000; RG-LRU + local attention, pattern (R, R, A).
[arXiv:2402.19427; unverified]

38 layers = 12 x (R, R, A) pattern blocks + 2 tail R layers.  Local window
2048 (a ring buffer of min(max_len, 2048) K/V rows).  The reference's mesh
rule (``RULES_OVERRIDES``: the decode cache sharded on its head dim) has
no counterpart until the distributed slice of the port."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        head_dim=256, d_ff=12288, vocab=256000, rope_theta=1e4,
        mlp_type="gelu", window=2048, lru_width=4096,
        pattern=("R", "R", "A"), n_pattern_blocks=12, n_tail_layers=2,
        subquadratic=True,
        remat_block=2,          # pattern blocks per remat unit (12 blocks)
    )


def smoke() -> ModelConfig:
    return full().with_(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
                        d_ff=96, vocab=256, lru_width=64, window=32,
                        n_pattern_blocks=2, n_tail_layers=1, n_layers=7,
                        remat_block=1, q_chunk=64, kv_chunk=64)
