"""Checkpointing: step-addressed, async — PyTorch port of
``repro.checkpoint.store``, with the reference's on-disk layout:

    <dir>/step_00000123/
        manifest.json        # tree structure, shapes, dtypes, step
        arrays/<idx>.npy     # one file per leaf

Leaves are numbered in JAX's flatten order (``repro_torch.tree``: dict
keys sorted, NamedTuple fields in order), and the manifest's ``treedef``
is the same text the reference writes, so a checkpoint written by either
package restores into the other: the state bridge between them, beside
``models/convert.py``.

* **Async save** — leaves are copied to host memory synchronously and
  written by a background thread; ``wait()`` joins it.
* **Atomicity** — writes go to ``step_XXXXXXXX.tmp`` and are renamed when
  complete; a crash mid-save never corrupts the latest checkpoint.
* **Retention** — the ``keep`` most recent checkpoints are kept.
* **Elastic restore** — the files hold whole arrays.  Under a mesh that
  splits the optimizer state (ZeRO-1), ``shardings`` names each leaf's
  split dim (None for a whole leaf; ``launch.steps.state_shardings``):
  ``save`` gathers each split leaf whole (``optim.zero_gather``), rank 0
  writes, every rank waits on a barrier; ``restore`` keeps this rank's
  slice on the current mesh (``optim.zero_slice``).  So a checkpoint
  written on two ranks restores on one process and the reverse, bit for
  bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.distributed import compat
from repro_torch.optim import zero_gather, zero_slice

__all__ = ["Checkpointer"]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             shardings: Optional[list] = None):
        """Write ``tree`` as step ``step``.  With ``shardings`` (the split
        dim of each leaf, None for a whole one) every rank gathers the
        split leaves; in a process group rank 0 alone writes and every
        rank leaves through a barrier (after the write when
        ``blocking``)."""
        self.wait()
        leaves, treedef = _tree.flatten(tree)
        rank, world = compat.world()
        dims = shardings if shardings is not None else [None] * len(leaves)
        # snapshot to host memory now, a leaf at a time; write in the
        # background
        host = []
        for x, dim in zip(leaves, dims):
            x = zero_gather(x.detach(), dim)
            if rank == 0:
                host.append(x.detach().to("cpu", copy=True).numpy())
        if rank != 0:
            dist.barrier()
            return
        manifest = {
            "step": step,
            "treedef": repr(_tree.unflatten(treedef,
                                            list(range(len(leaves))))),
            "n_leaves": len(leaves),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
        }

        def write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "arrays"))
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, "arrays", f"{i}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if not os.path.exists(final):
                os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        if world > 1:
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def list_steps(self):
        return sorted(int(name[5:]) for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Optional[list] = None):
        """``(tree, step)``: the checkpoint of ``step`` (default the
        latest) in the structure of ``tree_like``, a tree of tensors; each
        leaf comes back on its ``tree_like`` leaf's device, whose shape it
        must have.  With ``shardings`` (as :meth:`save`'s) a split leaf
        comes back as this rank's slice on the current mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        base = os.path.join(self.directory, f"step_{step:08d}")
        leaves, treedef = _tree.flatten(tree_like)
        dims = shardings if shardings is not None else [None] * len(leaves)
        out = []
        for i, (ref, dim) in enumerate(zip(leaves, dims)):
            a = torch.from_numpy(np.load(os.path.join(base, "arrays",
                                                      f"{i}.npy")))
            if dim is not None:                # a view of the whole array
                a = zero_slice(a, dim).clone()
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {i} has shape "
                                 f"{tuple(a.shape)}, the tree wants "
                                 f"{tuple(ref.shape)}")
            out.append(a.to(ref.device))
        return _tree.unflatten(treedef, out), step
