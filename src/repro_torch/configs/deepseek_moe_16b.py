"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) per-expert
d_ff=1408 vocab=102400; 2 shared + 64 routed experts, top-6, fine-grained.
[arXiv:2401.06066; hf]

The reference's mesh keys (``RULES_OVERRIDES``: experts on the data axis,
the expert MLP on the model axis) ride along for
``launch.mesh.mesh_rules``.  ``moe_dispatch="a2a"`` without a data axis
takes the reference's own no-mesh branch, the scatter dispatch; under
a data axis that divides the 64 experts the tokens are exchanged by
all-to-all (``models.moe.moe_ffn_a2a``)."""
from repro_torch.models.common import ModelConfig

RULES_OVERRIDES = {"experts": ("data",), "expert_mlp": "model",
                   "cache_heads": "model"}  # kv=16


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek_moe_16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=2816,              # shared-expert ffn (2 x 1408)
        d_ff_expert=1408, n_experts=64, n_shared_experts=2, topk=6,
        vocab=102400, rope_theta=1e4,
        moe_dispatch="a2a",
        remat_block=4,
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=64, d_ff_expert=32, n_experts=8, topk=2,
                        n_shared_experts=1, vocab=256, remat_block=1,
                        q_chunk=64, kv_chunk=64)
