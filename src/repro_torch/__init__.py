"""PyTorch/CUDA port of the ``repro`` package (Ozaki-scheme GEMM emulation on
integer matrix units), for NVIDIA Hopper.

The layout mirrors ``src/repro/`` module for module.  The port imports
``torch`` and nothing of JAX or of the ``repro`` package: it keeps its own
copy of whatever it needs.  Every Pallas kernel of the reference on this
slice's path is a hand-written CUDA kernel under ``kernels/csrc``; each has
a plain PyTorch version beside it, used only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card.  Raises when none is given and no card is present —
    the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch versions on the "
                           "CPU")
    return torch.device("cuda")
