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

The reference's reshard-on-restore (``shardings``) comes with the second
distributed slice of the port (2b: the port's mesh so far replicates
every parameter on every rank).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as _tree

__all__ = ["Checkpointer"]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = False):
        self.wait()
        leaves, treedef = _tree.flatten(tree)
        # snapshot to host memory now; write in the background
        host = [x.detach().to("cpu", copy=True).numpy() for x in leaves]
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

    def restore(self, tree_like: Any, step: Optional[int] = None):
        """``(tree, step)``: the checkpoint of ``step`` (default the
        latest) in the structure of ``tree_like``, a tree of tensors; each
        leaf comes back on its ``tree_like`` leaf's device, whose shape it
        must have."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        base = os.path.join(self.directory, f"step_{step:08d}")
        leaves, treedef = _tree.flatten(tree_like)
        out = []
        for i, ref in enumerate(leaves):
            a = np.load(os.path.join(base, "arrays", f"{i}.npy"))
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {i} has shape {a.shape}, "
                                 f"the tree wants {tuple(ref.shape)}")
            out.append(torch.from_numpy(a).to(ref.device))
        return _tree.unflatten(treedef, out), step
