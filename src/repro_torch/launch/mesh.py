"""Meshes and the process group under them — PyTorch port of
``repro.launch.mesh``.

The reference's meshes are ``jax.make_mesh`` over the devices one
controller sees.  The port's are :class:`repro_torch.distributed.compat.
Mesh` over the ranks of the default ``torch.distributed`` process group,
one process a rank; "devices" in the grammar and its errors is the world
size.  :func:`init_distributed` starts that process group: from torchrun's
environment (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``)
or from an explicit store (``init_method="file:///path"`` with ``rank`` and
``world_size``), which is what tests and spawned workers use.  Meshes are
built by functions, never at import: building one is collective.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Iterator, Optional, Union

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.distributed.compat import Mesh, world

__all__ = ["make_production_mesh", "make_test_mesh", "parse_mesh_spec",
           "spec_axes", "mesh_rules", "init_distributed", "process_group"]

_PRESETS = {"single_pod": {"data": 16, "model": 16},
            "multi_pod": {"pod": 2, "data": 16, "model": 16}}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``."""
    axes = _PRESETS["multi_pod" if multi_pod else "single_pod"]
    return Mesh(tuple(axes.values()), tuple(axes))


def make_test_mesh(data: int = 2, model: int = 2,
                   pod: Optional[int] = None) -> Mesh:
    """A small mesh over the ranks a test started."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))


def parse_mesh_spec(spec: Optional[str]) -> Optional[Mesh]:
    """CLI mesh grammar: ``"data=2,model=4"`` (ordered ``axis=size`` pairs)
    or the named presets ``"single_pod"`` / ``"multi_pod"``; ``None`` / ""
    -> no mesh (single device).

    Axis names must be mesh-rule axes the rest of the stack knows ("pod",
    "data", "model"); sizes must multiply to at most the world size.
    Returns a Mesh or None.  Collective when it builds a mesh: every rank
    calls it with the same spec."""
    if not spec:
        return None
    if spec in _PRESETS:
        return make_production_mesh(multi_pod=spec == "multi_pod")
    axes = spec_axes(spec)
    ndev = world()[1]
    total = 1
    for s in axes.values():
        total *= s
    if total > ndev:
        raise ValueError(f"mesh spec {spec!r} needs {total} devices, "
                         f"only {ndev} available")
    return Mesh(tuple(axes.values()), tuple(axes))


def spec_axes(spec: str) -> Dict[str, int]:
    """The ordered ``{axis: size}`` a mesh spec (or preset) names, checked
    against the grammar, without building a mesh."""
    if spec in _PRESETS:
        return dict(_PRESETS[spec])
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name, size = name.strip(), size.strip()
        if name not in ("pod", "data", "model") or not size.isdigit() \
                or int(size) < 1 or name in axes:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected unique 'axis=size' pairs "
                f"with axes from pod/data/model and size >= 1, got {part!r}")
        axes[name] = int(size)
    return axes


def mesh_rules(mesh, arch: Optional[str] = None):
    """Pick the logical->mesh rule table for a mesh (+ per-arch overrides)."""
    from repro_torch.distributed.sharding import (MULTI_POD_RULES,
                                                  SINGLE_POD_RULES)
    rules = dict(MULTI_POD_RULES if "pod" in mesh.axis_names
                 else SINGLE_POD_RULES)
    if arch is not None:
        from repro_torch import configs
        rules.update(configs.rules_overrides(arch))
    return rules


def init_distributed(device: Optional[Union[str, torch.device]] = None, *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start the default process group, once, and return this rank's
    device.

    The group comes from ``init_method`` with ``rank`` / ``world_size``
    when given, else from torchrun's environment; with neither (a plain
    single process) no group starts and the world is one rank.  The
    backend is NCCL when every rank on this host has a CUDA card of its
    own (``cuda:<local rank>``), and gloo when ranks share one card (all
    on ``cuda:0``; NCCL refuses two ranks on one device) or run on the
    CPU.  The NCCL route has not yet run on any host: the tests and the
    one-card chip run take gloo.  The choice is logged on stderr.  An
    initialized group is reused as it is."""
    device = resolve_device(device)
    env = os.environ
    if not dist.is_initialized():
        if init_method is None and "WORLD_SIZE" not in env:
            return device
        if init_method is None:
            init_method = "env://"
            rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        local = int(env.get("LOCAL_WORLD_SIZE", world_size))
        own = device.type == "cuda" and local <= torch.cuda.device_count()
        backend = "nccl" if own else "gloo"
        if own:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        why = ("a card a rank" if own else
               f"{local} ranks share {device}" if device.type == "cuda"
               else "ranks on the CPU")
        print(f"[mesh] rank {rank} of {world_size}: backend {backend} "
              f"({why}) on {device}", file=sys.stderr, flush=True)
    elif device.type == "cuda" and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def process_group(spec: Optional[str],
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Iterator[torch.device]:
    """A launcher's rank device for the block: with a mesh ``spec``, the
    default process group too (:func:`init_distributed`), destroyed on
    exit if this block started it; without one, :func:`resolve_device`."""
    if not spec:
        yield resolve_device(device)
        return
    started = not dist.is_initialized()
    device = init_distributed(device)
    started = started and dist.is_initialized()
    try:
        yield device
    finally:
        if started:
            dist.destroy_process_group()
