"""Shared model machinery: config dataclass and param builder — PyTorch
port of ``repro.models.common``.

Models are functional: ``init(cfg, generator=..., device=...) -> params``
with params a nested dict of tensors, and ``forward(params, cfg, ...)`` a
plain function.  Every random draw takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.core.engine import MatmulEngine, make_engine

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, cut to the fields the port's families
    read (the reference's ``frames``, read by its training pipeline for
    the encdec family, and ``expand_kv``, a sharding switch, are not
    carried)."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    mlp_type: str = "swiglu"          # swiglu | gelu
    window: Optional[int] = None      # sliding-window (local) attention
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"     # scatter | a2a (no mesh: scatter)
    # MLA (deepseek-v2)
    kv_lora: int = 0
    q_lora: int = 0                   # carried, unused (a full Q projection)
    rope_head_dim: int = 64
    v_head_dim: int = 0
    # SSM (mamba2)
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64
    chunk: int = 256
    # hybrid (recurrentgemma)
    pattern: Tuple[str, ...] = ()     # e.g. ("R", "R", "A")
    n_pattern_blocks: int = 0
    n_tail_layers: int = 0
    lru_width: int = 0
    # VLM (llama-3.2-vision)
    cross_every: int = 0              # 1 cross-attn layer per N layers
    vision_seq: int = 0
    # enc-dec (seamless)
    enc_layers: int = 0
    dtype: str = "bfloat16"           # activation dtype
    norm_eps: float = 1e-5
    remat_block: int = 1              # layers per remat unit (training)
    engine_spec: str = "bf16"         # MatmulEngine spec
    q_chunk: int = 1024               # attention chunking (flash-style)
    kv_chunk: int = 1024
    # skips long-context cells (pure full-attention archs) in the reference
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        embedding/LM head shard evenly; kept for layout parity)."""
        return -(-self.vocab // 256) * 256

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def engine(self) -> MatmulEngine:
        return make_engine(self.engine_spec)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_param(generator: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1) * scale, ``scale`` defaulting to ``shape[0] ** -0.5``
    (the reference's rule: fan-in of a projection ``(n, p)``).  Callers
    drawing a layer stack ``(L, n, p)`` in one call pass the per-layer
    fan-in scale explicitly."""
    scale = scale if scale is not None else shape[0] ** -0.5
    out = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                      device=device)
    return out.mul_(scale)


def init_stacked(generator: torch.Generator, n: Union[int, Tuple[int, ...]],
                 layer_init: Callable[..., Any], device=None) -> Any:
    """The parameters of ``n`` stacked layers, every leaf ``(n, ...)``; a
    tuple ``n`` stacks on several leading axes (the reference's nested
    vmaps: the hybrid's pattern blocks of R layers).

    The reference vmaps a one-layer init over n seeds; here the one-layer
    init runs once and draws each leaf's whole stack in one call:
    ``layer_init(normal, zeros)`` builds the layer's tree, where
    ``normal(shape, scale=None)`` is :func:`dense_param` of ``(n, *shape)``
    with the per-layer scale rule (``shape[0] ** -0.5`` by default) and
    ``zeros(shape)`` a zero stack."""
    lead = (n,) if isinstance(n, int) else tuple(n)

    def normal(shape, scale=None):
        scale = shape[0] ** -0.5 if scale is None else scale
        return dense_param(generator, lead + tuple(shape), scale=scale,
                           device=device)

    def zeros(shape):
        return torch.zeros(lead + tuple(shape), dtype=torch.float32,
                           device=device)

    return layer_init(normal, zeros)


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(e is None or isinstance(e, str)
                                        for e in t)


def stack_axes(axes_tree):
    """Prepend the ``"layers"`` axis to every logical-axes tuple in a
    tree (nested dicts)."""
    if _is_axes(axes_tree):
        return ("layers",) + axes_tree
    return {k: stack_axes(v) for k, v in axes_tree.items()}


def param_count(params) -> int:
    """Elements over every tensor leaf of a parameter tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
