"""Persistent weight split-cache for emulated GEMMs — PyTorch port of
``repro.core.split_cache``.

At inference the B operand of almost every emulated contraction is a
static weight matrix.  :class:`SplitCache` freezes it into its
spec-resolved :class:`~repro_torch.core.splitting.Split` ONCE, keyed by
``(tensor identity, spec, dimension_numbers, mesh, layout)``, and the
``rhs_presplit=`` path of :func:`repro_torch.core.ozimmu.
ozimmu_dot_general` then skips the B-side splitter — bit-identical to the
uncached path (the splitters are deterministic and rounding-exact).

Identity is ``id(tensor)`` guarded by a ``weakref``: when the weight
tensor dies, its entries drop out, so a recycled ``id`` never aliases a
stale split.  Under a ``:fused`` spec the freeze runs through the split
kernel (axis 1), so on the card the B side of every projection is split
by the kernel exactly once.

Auto k (``...-auto`` specs) is resolved at freeze time by
:func:`resolved_k`: the static mantissa-coverage plan, which is what the
reference's jitted serving step resolves to.  A call that gets the frozen
split adopts its k (``ozimmu._bmm_impl``), so the serving path of both
packages agrees on k.  Constant-scaling (oz2, fast2) splits carry their
``gbase`` through the cache and :func:`stack_leading`.  Under a mesh the
entry is still the full-matrix split (the grid the ranks agree on); a
sharded contraction reads its rank's range of the digits as a view.

Every stats transition (hit, miss, invalidation) is mirrored into the
process-global metrics registry (``split_cache.*`` counters and the
``split_cache.cached_bytes`` gauge), and a miss's freeze runs in the
``ozimmu/split_cache/freeze`` host scope, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import splitting
from repro_torch.core.splitting import Split
from repro_torch.distributed import compat
from repro_torch.obs import registry as _obs
from repro_torch.obs import tracing as _tracing

__all__ = ["SplitCache", "CacheStats", "resolved_k", "presplit_rhs",
           "stack_leading", "split_nbytes"]


def resolved_k(cfg, n: int, dtype) -> int:
    """The slice count a frozen split uses for contraction length ``n`` in
    compute dtype ``dtype``.  Fixed-k configs return ``cfg.k``; ``auto``
    configs the static plan of ``plan.choose_k_bits`` (no probed gaps),
    with ``target_eps_mode`` riding along (a ``:prob`` config freezes the
    probabilistic plan's smaller k; the k is part of :func:`_cfg_key`)."""
    if not getattr(cfg, "auto_k", False):
        return cfg.k
    from repro_torch.core import plan
    beta = splitting.beta_for(cfg.split, n)
    k, needed = plan.choose_k_bits(
        n, beta,
        cfg.target_eps if cfg.target_eps is not None
        else plan.DEFAULT_TARGET_EPS,
        split=cfg.split, mantissa=plan._MANTISSA.get(dtype, 24),
        fast=getattr(cfg, "fast", False),
        mode=getattr(cfg, "target_eps_mode", "deterministic"),
        delta=getattr(cfg, "target_delta", None))
    # m=p=0: the freeze-time resolution sees only the contraction length
    plan.record_decision(cfg, m=0, n=n, p=0, k=k, beta=beta,
                         needed=needed, probed=False, source="split_cache")
    return k


def presplit_rhs(b: torch.Tensor, dimension_numbers, cfg) -> Split:
    """Freeze the rhs of ``dot_general(a, b, dimension_numbers)`` under
    ``cfg`` into its canonical column-scale Split.  ``b`` must already be in
    the emulation's compute dtype."""
    from repro_torch.core import ozimmu
    cfg = ozimmu.canonical_fast2(cfg)
    b3, n = ozimmu.canonical_rhs(b, ozimmu._canonicalize_dnums(
        dimension_numbers))
    k = resolved_k(cfg, n, b3.dtype)
    return ozimmu.splitter_for(cfg.with_(k=k), n)(b3, 1)


def stack_leading(sp: Split, nstack: int) -> Split:
    """Re-layout a batched Split so the ``nstack`` leading batch (layer
    stack) axes come before the k axis — ``digits (*stack, k, n, p)``,
    ``scale (*stack, k, p)`` — so indexing the stack yields one layer's
    split.  A storage layout for wrappers, not an operand for the
    accumulate routines.  Column-scale digits keep the split's K-major
    storage (``(*stack, k, p, n)``, seen transposed): one copy, in the
    layout the card's group GEMM reads."""
    if nstack == 0:
        return sp
    flip = (lambda d: d.transpose(-1, -2)) if sp.axis == 1 else \
        (lambda d: d)
    return Split(flip(torch.movedim(flip(sp.digits), 0, nstack).contiguous()),
                 torch.movedim(sp.scale, 0, nstack).contiguous(),
                 sp.base, sp.beta, sp.axis, gbase=sp.gbase,
                 signmag=sp.signmag)


def split_nbytes(sp: Split) -> int:
    """Device bytes a cached Split occupies (digits + scales + bases)."""
    total = 0
    for t in (sp.digits, sp.scale, sp.base, sp.gbase):
        if t is not None:
            total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    cached_bytes: int = 0
    hit_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "cached_bytes": self.cached_bytes,
                "hit_bytes": self.hit_bytes,
                "hit_rate": round(self.hit_rate, 6)}


def _cfg_key(cfg, k: int, dtype) -> Tuple:
    return (cfg.split, int(k), str(dtype), bool(getattr(cfg, "fast", False)))


def _mesh_key() -> Tuple:
    """The installed mesh's ``(axis, size)`` pairs, sorted; ``()`` without
    a mesh — the mesh half of the split-cache and prefix-cache keys."""
    mesh = compat.get_abstract_mesh()
    if mesh.empty:
        return ()
    return tuple(sorted(mesh.shape.items()))


class SplitCache:
    """Freeze-once cache of spec-resolved weight splits (thread-safe,
    weakref-invalidated)."""

    def __init__(self):
        self._entries: Dict[Tuple, Tuple[Split, int, Any]] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, b: torch.Tensor, dimension_numbers, cfg, dtype=None,
            layout: str = "k_leading") -> Split:
        """The frozen Split for ``b`` as the rhs of ``dot_general(., b,
        dimension_numbers)`` under ``cfg``.  ``dtype`` is the compute dtype
        when it differs from ``b.dtype`` (cast inside; the entry stays
        anchored on ``b``).  ``layout="stack_leading"`` stores the
        :func:`stack_leading` layout.

        The key's mesh half (:func:`_mesh_key`) keeps the reference's key.
        The entry is the full-matrix split under any mesh today (a rank
        reads its contraction range of the digits as a view), so one cache
        used with and without a mesh freezes the same split twice; serving
        never does, since it freezes its weights once when the runtime is
        built.  The half keeps apart entries that a mesh-laid-out split,
        holding only a rank's range, would make different."""
        from repro_torch.core import ozimmu
        if layout not in ("k_leading", "stack_leading"):
            raise ValueError(f"unknown split layout {layout!r}")
        dtype = b.dtype if dtype is None else dtype
        dnums = ozimmu._canonicalize_dnums(dimension_numbers)
        (_, bc), (_, bb) = dnums
        k = resolved_k(cfg, math.prod(b.shape[i] for i in bc), dtype)
        key = (id(b), _cfg_key(cfg, k, dtype), dnums, _mesh_key(), layout)
        in_bytes = math.prod(b.shape) * torch.empty((), dtype=dtype
                                                    ).element_size()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.hits += 1
                self.stats.hit_bytes += in_bytes
                self._obs_event("hits", hit_bytes=in_bytes)
                return entry[0]
        with _tracing.host_scope("split_cache/freeze"):
            sp = presplit_rhs(b.to(dtype), dnums, cfg)
            if layout == "stack_leading":
                sp = stack_leading(sp, len(bb))
        nbytes = split_nbytes(sp)
        anchor = self._anchor(b, key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.stats.hits += 1
                self.stats.hit_bytes += in_bytes
                self._obs_event("hits", hit_bytes=in_bytes)
                return entry[0]
            self._entries[key] = (sp, nbytes, anchor)
            self.stats.misses += 1
            self.stats.cached_bytes += nbytes
            self._obs_event("misses")
        return sp

    def _obs_event(self, kind: str, hit_bytes: int = 0):
        """Mirror one stats transition into the process-global registry
        (cached_bytes rides along as a gauge).  The registry lock is a
        leaf — safe under ``self._lock``."""
        if not _obs.enabled():
            return
        reg = _obs.get_registry()
        reg.inc(f"split_cache.{kind}", 1)
        if hit_bytes:
            reg.inc("split_cache.hit_bytes", hit_bytes)
        reg.gauge("split_cache.cached_bytes", self.stats.cached_bytes)

    def _anchor(self, b, key):
        def _on_dead(_ref, cache=weakref.ref(self), key=key):
            c = cache()
            if c is not None:
                c._drop(key, invalidated=True)
        return weakref.ref(b, _on_dead)

    def _drop(self, key, invalidated: bool = False):
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self.stats.cached_bytes -= entry[1]
                if invalidated:
                    self.stats.invalidations += 1
                    self._obs_event("invalidations")
