"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; gated cross-attn image layers every 5th layer (8 total).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40 layers = 8 groups x (4 self + 1 gated cross).  The vision frontend is a
stub, as in the reference: the model takes precomputed patch embeddings
(B, vision_seq=1600, d_model) as its cross-attention memory.  The
reference's mesh rule (``RULES_OVERRIDES``) rides along for
``launch.mesh.mesh_rules``; its shape skips come with the port's
benchmark."""
from repro_torch.models.common import ModelConfig

RULES_OVERRIDES = {"cache_hd": "model"}


def full() -> ModelConfig:
    return ModelConfig(
        name="llama32_vision_11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, rope_theta=5e5,
        cross_every=5, vision_seq=1600,
        remat_block=2,          # blocks of pattern groups (8 groups total)
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=256, cross_every=2, vision_seq=16,
                        remat_block=1, q_chunk=64, kv_chunk=64)
