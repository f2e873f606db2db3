"""Logical-axis sharding rules (MaxText-style) — PyTorch port of
``repro.distributed.sharding``.

A rules table, chosen by the launcher per mesh, maps the logical axis
names of parameters and activations ("embed", "mlp", "heads", "batch",
...) to mesh axes.  The tables, :func:`use_rules` / :func:`get_rules`,
:func:`logical_to_pspec` and :func:`spec_tree` are the reference's;
a partition spec is a plain tuple of mesh-axis entries (``None``, an axis
name or a tuple of names), equal to ``tuple(PartitionSpec(...))``.

The reference's ``shard()`` layout hint (a ``with_sharding_constraint``
on an activation) has no counterpart: the port's models carry no layout
hints (``models/layers.py``), and its mesh shards the emulated
contractions (``@axis`` engine specs), every rank holding whole operands,
and the training data axis.  :func:`rule_axes` reads which mesh axes a
rule spans on the live mesh: ``batch`` the ranks a training batch is split
over, ``zero`` those the ZeRO-1 optimizer state is split over.  The
active rules are the process's, as the installed mesh is
(:mod:`repro_torch.distributed.compat`).
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional, Sequence, Tuple

__all__ = ["SINGLE_POD_RULES", "MULTI_POD_RULES", "use_rules", "get_rules",
           "logical_to_pspec", "spec_tree", "rule_axes"]

Rules = dict  # logical axis name -> mesh axis | tuple | None

# Default rules for the production meshes.  "batch" spans the pure-DP axes
# (pod + data); tensor-parallel dims map to "model"; ZeRO-1 optimizer-state
# sharding additionally uses "data".
SINGLE_POD_RULES: Rules = {
    "batch": ("data",),
    "seq": None,
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": None,
    "state": None,
    "conv": None,
    "layers": None,
    "cache_batch": ("data",),
    "cache_heads": None,
    "cache_hd": None,
    "zero": ("data",),
}

MULTI_POD_RULES: Rules = dict(SINGLE_POD_RULES)
MULTI_POD_RULES.update({
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "zero": ("pod", "data"),
})

_state = types.SimpleNamespace(rules=None)


def get_rules() -> Optional[Rules]:
    return _state.rules


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = get_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_to_pspec(axes: Sequence[Optional[str]],
                     rules: Optional[Rules] = None) -> Tuple:
    """The partition spec of logical ``axes`` under ``rules`` (the active
    rules when None; ``()`` without any): one entry per axis, a mesh axis
    appearing at most once."""
    rules = rules if rules is not None else get_rules()
    if rules is None:
        return ()
    out, used = [], set()
    for ax in axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        mesh_axes = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        # a mesh axis may appear at most once in a partition spec
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        used.update(mesh_axes)
        if not mesh_axes:
            out.append(None)
        elif len(mesh_axes) == 1:
            out.append(mesh_axes[0])
        else:
            out.append(mesh_axes)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def spec_tree(axes_tree, rules: Optional[Rules] = None):
    """Map a tree of logical-axes tuples (dicts, lists and tuples of them)
    to the same tree of partition specs."""
    if _is_axes(axes_tree):
        return logical_to_pspec(axes_tree, rules)
    if isinstance(axes_tree, dict):
        return {k: spec_tree(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(spec_tree(v, rules) for v in axes_tree)
    return axes_tree


def rule_axes(name: str) -> Tuple[Tuple[str, ...], int, int]:
    """``(axes, size, index)``: the installed mesh's axes of more than one
    rank that the active rule ``name`` maps to, in mesh order as the rule
    names them, their product, and this rank's row-major index over them
    (the first axis outermost).  ``((), 1, 0)`` without a mesh, without
    rules, or when no such axis has more than one rank."""
    from repro_torch.distributed import compat
    mesh = compat.get_abstract_mesh()
    entry = (get_rules() or {}).get(name)
    if mesh.empty or not entry:
        return (), 1, 0
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in names
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    size, index = 1, 0
    for a in axes:
        size *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.index(a)
    return axes, size, index
