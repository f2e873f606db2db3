"""Shared model machinery: config dataclass and param builder — PyTorch
port of ``repro.models.common``.

Models are functional: ``init(cfg, generator=..., device=...) -> params``
with params a nested dict of tensors, and ``forward(params, cfg, ...)`` a
plain function.  Every random draw takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.engine import MatmulEngine, make_engine

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, cut to the fields the dense family reads;
    the other families' fields come with them."""

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
    mlp_type: str = "swiglu"          # swiglu (gelu: with its configs)
    window: Optional[int] = None      # sliding-window (local) attention
    dtype: str = "bfloat16"           # activation dtype
    norm_eps: float = 1e-5
    engine_spec: str = "bf16"         # MatmulEngine spec
    q_chunk: int = 1024               # attention chunking (flash-style)
    kv_chunk: int = 1024

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

