"""Freeze static model weights into their spec-resolved Ozaki splits —
PyTorch port of ``repro.serving.presplit``.

``wrap_params`` walks a parameter tree and replaces every projection
weight the layers consume as ``engine(x, w)`` with a
:class:`repro_torch.core.engine.PresplitWeight`: the tensor bundled with
its frozen int8 digit slices and scales from a
:class:`repro_torch.core.split_cache.SplitCache`.  The engine then skips
the B-side splitter on every decode step (bit-identical).  Layer-stacked
leaves ``(n_layers, n, p)`` are split per layer in one batched call and
stored with the stack axis leading, so slicing one layer of the tree
yields that layer's wrapper.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import split_cache as sc
from repro_torch.core.engine import MatmulEngine, PresplitWeight

__all__ = ["WRAP_KEYS", "wrap_params", "wrappable_paths",
           "wrapped_weight_bytes", "freeze_weight"]

# projection weights consumed as engine(x, w) — contract w's axis 0
WRAP_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                    # GQA attention
    "w_gate", "w_up", "w_down",                # MLPs (dense + shared expert)
    "w_dkv", "w_krope", "w_q", "w_uk", "w_uv", "w_o",   # MLA
    "w_in", "w_x", "w_out",                    # SSM / recurrent blocks
    "lm_head",
})


def _wrappable(path: Tuple[str, ...], leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point() or path[-1] not in WRAP_KEYS:
        return False
    # expert-batched MoE weights contract expert-batched (other dnums)
    return not ("moe" in path[:-1] and "shared" not in path[:-1])


def _walk(tree, path, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in tree.items()}
    return fn(path, tree)


def wrappable_paths(params) -> list:
    """The parameter paths ``wrap_params`` would freeze."""
    found = []
    _walk(params, (), lambda path, leaf: found.append(path)
          if _wrappable(path, leaf) else None)
    return found


def _stacked_rhs_dnums(ndim: int):
    """dnums describing a stacked weight (*stack, n, p) as the rhs of a
    stack-batched projection (only the rhs half matters)."""
    stack = tuple(range(ndim - 2))
    return (((len(stack),), (ndim - 2,)), (stack, stack))


def freeze_weight(w: torch.Tensor, engine: MatmulEngine,
                  cache: sc.SplitCache) -> PresplitWeight:
    """One leaf (*stack, n, p) -> PresplitWeight with stack-leading splits."""
    cfg = engine.ozimmu_config
    nstack = w.ndim - 2
    sp = cache.get(w, _stacked_rhs_dnums(w.ndim), cfg,
                   dtype=engine.compute_dtype, layout="stack_leading")
    k = int(sp.digits.shape[nstack])
    return PresplitWeight(w, sp.digits, sp.scale, sp.base, sp.gbase,
                          int(sp.beta), cfg.split, k)


def wrapped_weight_bytes(wrapped_params, engine: MatmulEngine) -> int:
    """Compute-dtype bytes of the weights whose splits are frozen — the
    splitter-input volume every step skips."""
    if not engine.is_ozimmu:
        return 0
    itemsize = torch.empty((), dtype=engine.compute_dtype).element_size()
    total = []
    _walk(wrapped_params, (), lambda path, leaf: total.append(
        math.prod(leaf.array.shape) * itemsize)
        if isinstance(leaf, PresplitWeight) else None)
    return sum(total)


def wrap_params(params, engine: MatmulEngine,
                cache: Optional[sc.SplitCache] = None):
    """``(wrapped_params, cache)``: a copy of the tree with every wrappable
    projection weight frozen through ``cache`` (created when None).
    Non-ozimmu engines return the tree untouched."""
    if cache is None:
        cache = sc.SplitCache()
    if not engine.is_ozimmu:
        return params, cache
    return _walk(params, (), lambda path, leaf: freeze_weight(
        leaf, engine, cache) if _wrappable(path, leaf) else leaf), cache
