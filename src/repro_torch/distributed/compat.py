"""The mesh the sharded contractions run over — PyTorch counterpart of
``repro.distributed.compat``.

The reference's mesh is a ``jax.sharding.Mesh`` of devices driven by one
controller, and its sharded bodies run under ``shard_map``.  The port runs
one process a rank over ``torch.distributed`` (SPMD: every rank runs the
same program).  A :class:`Mesh` names the axes and their sizes, holds this
rank's coordinate and one process group per axis of size > 1
(``dist.new_group``), with the ranks laid out row-major over the axes, as
``jax.make_mesh`` lays out devices.  There is no ``shard_map``
counterpart: every rank runs the body on its own range, and the
collectives of :mod:`repro_torch.distributed.collectives` join the ranks
of one axis.

:func:`set_mesh` installs a mesh for a ``with`` block and
:func:`get_abstract_mesh` reads it: always an object with ``.empty`` /
``.axis_names`` / ``.shape`` (:data:`EMPTY_MESH` outside any mesh), so
call sites never branch on ``None``.  The installed mesh is the
process's, not a thread's: a rank is a process, and autograd runs a CUDA
backward (and the remat recompute inside it) on a device thread of its
own, which must see the mesh its forward ran under.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import types
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["EMPTY_MESH", "Mesh", "get_abstract_mesh", "set_mesh",
           "world"]


class _EmptyMesh:
    """Stand-in with the mesh surface the port reads."""

    empty = True
    axis_names: Tuple[str, ...] = ()
    shape: Dict[str, int] = {}

    def __repr__(self):
        return "EmptyMesh()"


EMPTY_MESH = _EmptyMesh()


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over the first ``prod(sizes)`` ranks of the default
    process group, row-major.

    Every rank of the world must build the same meshes in the same order
    (``dist.new_group`` is collective); a rank beyond the mesh's ranks has
    no coordinate and cannot install it.  Axes of size 1 need no group and
    no collective."""

    empty = False

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names) or \
                any(s < 1 for s in sizes):
            raise ValueError(f"a mesh needs unique axis names, one size >= 1 "
                             f"each; got {names} x {sizes}")
        rank, size = world()
        total = math.prod(sizes)
        if total > size:
            raise ValueError(f"a mesh of shape {sizes} needs {total} ranks, "
                             f"the world has {size}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.rank = rank
        self.coord: Optional[Dict[str, int]] = None
        if rank < total:
            self.coord = dict(zip(names, _unravel(rank, sizes)))
        self._groups: Dict[str, object] = {}
        for ax, name in enumerate(names):
            if sizes[ax] == 1:
                continue
            rest = [range(s) for i, s in enumerate(sizes) if i != ax]
            for other in itertools.product(*rest):
                ranks = [_ravel(other[:ax] + (j,) + other[ax:], sizes)
                         for j in range(sizes[ax])]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.coord is None:
            raise ValueError(f"rank {self.rank} lies outside the mesh "
                             f"{self.shape}")
        return self.coord[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for
        an axis of size 1)."""
        self.index(axis)
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coord={self.coord})"


def _unravel(flat: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        flat, r = divmod(flat, s)
        out.append(r)
    return tuple(reversed(out))


def _ravel(coord: Sequence[int], sizes: Sequence[int]) -> int:
    flat = 0
    for c, s in zip(coord, sizes):
        flat = flat * s + c
    return flat


_state = types.SimpleNamespace(mesh=EMPTY_MESH)


def get_abstract_mesh():
    """The mesh installed by :func:`set_mesh`, else :data:`EMPTY_MESH`."""
    return _state.mesh


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Install ``mesh`` for the enclosed block (this process: every
    thread sees it, autograd's device threads too)."""
    if mesh.coord is None:
        raise ValueError(f"rank {mesh.rank} lies outside the mesh "
                         f"{mesh.shape}")
    prev = get_abstract_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
