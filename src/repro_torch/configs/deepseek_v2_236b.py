"""deepseek-v2-236b [mla_moe] — 60L d_model=5120 128H per-expert d_ff=1536
vocab=102400; MLA kv_lora=512, 2 shared + 160 routed experts top-6.
[arXiv:2405.04434; hf]

MLA: per-head nope dim 128, shared rope key dim 64, v head dim 128; the
decode cache stores only the 512-dim latent + 64-dim rope key per position.
(The published config also low-ranks Q with q_lora=1536; the reference
keeps a full Q projection, and so does the port: it does not change cache
or FFN shapes.)

The reference's mesh keys (``RULES_OVERRIDES``: experts on the data axis,
the expert MLP, the latent and the rope key on the model axis) and its
benchmark's ``SKIP_SHAPES`` have no counterpart until the distributed
slice of the port.
``moe_dispatch="a2a"`` without a mesh takes the reference's own no-mesh
branch, the scatter dispatch."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_236b", family="mla_moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=128, kv_lora=512, rope_head_dim=64, v_head_dim=128,
        d_ff=3072,              # shared-expert ffn (2 x 1536)
        d_ff_expert=1536, n_experts=160, n_shared_experts=2, topk=6,
        vocab=102400, rope_theta=1e4,
        moe_dispatch="a2a",
        remat_block=6,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, kv_lora=32, rope_head_dim=8,
                        v_head_dim=16, d_ff=64, d_ff_expert=32, n_experts=8,
                        topk=2, n_shared_experts=1, vocab=256,
                        remat_block=1, q_chunk=64, kv_chunk=64)
