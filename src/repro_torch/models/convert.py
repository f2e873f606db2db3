"""Carry parameters across from the JAX reference.

The two frameworks' random generators differ, so equal seeds cannot give
equal weights: a test initializes the reference model, converts its
parameter tree to numpy (``jax.tree.map(np.asarray, params)``) and hands
it here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's parameters from a reference parameter tree of numpy
    arrays (nested dicts).  Layouts are the reference's and the stacked
    ``"layers"`` leaves STAY stacked ``(n_layers, ...)``: the port's
    transformer keeps that layout and slices one layer per loop step.
    The same holds for every family's tree: the hybrid's blocks and the
    vlm's ``groups/selfs`` on two leading axes, the encdec's
    ``enc_layers`` and ``dec_layers``, and 0-d leaves (the vlm's gates)
    stay 0-d.  Dtypes are kept; every leaf is copied onto ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
