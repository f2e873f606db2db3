"""MatmulEngine — the pluggable GEMM backend every model layer contracts
through.  PyTorch port of ``repro.core.engine``.

Specs: ``bf16`` / ``f32`` / ``f64`` (a native contraction in that compute
dtype) or any ozimmu spec of :func:`repro_torch.core.ozimmu.parse_spec`
(``ozimmu_h-4:df32:fused`` etc.).  Two entry points:

  * ``engine(x, w)`` — contract the last axis of ``x`` with the first axis
    of ``w`` (the shape every model projection reduces to);
  * ``engine.dot_general(lhs, rhs, dimension_numbers)`` — an arbitrary
    batched contraction under lax dimension numbers (attention scores and
    outputs).

For ozimmu specs the compute dtype is f64 for ``:f64`` and f32 for
``:f32``/``:df32``; PyTorch always has f64, so the reference's
x64-off downgrade has no counterpart.  Both entry points differentiate:
the casts to the compute dtype and back are autograd's, and the emulated
contraction between them is ``ozimmu``'s autograd Function, whose
cotangents run the same emulation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import ozimmu, splitting

__all__ = ["MatmulEngine", "make_engine", "PresplitWeight", "dot_general",
           "presplit_trace_counts"]

_NATIVE = {"bf16": torch.bfloat16, "f32": torch.float32,
           "f64": torch.float64}


def dot_general(lhs: torch.Tensor, rhs: torch.Tensor,
                dimension_numbers) -> torch.Tensor:
    """A plain ``lax.dot_general`` on tensors (one batched ``matmul`` on
    the canonical layouts), in the operands' common dtype."""
    dnums = ozimmu._canonicalize_dnums(dimension_numbers)
    ozimmu.check_dnums(lhs.shape, rhs.shape, dnums)
    a3, m_shape = ozimmu.canonical_lhs(lhs, dnums)
    b3, _ = ozimmu.canonical_rhs(rhs, dnums)
    out = torch.matmul(a3, b3)
    return out.reshape(tuple(a3.shape[:-2]) + m_shape
                       + ozimmu.rhs_free_shape(rhs.shape, dnums))


class PresplitWeight:
    """A weight tensor bundled with its frozen Ozaki Split (serving).

    ``digits`` carry any layer-stack axes LEADING, ``(*stack, k, n, p)``;
    :meth:`layer` slices one stack element, as the transformer's layer
    loop slices every parameter.  The engine consumes the frozen split when
    the contraction is the plain projection ``x[..., n] @ w[n, p]`` and
    falls back to ``array`` otherwise, so wrapping is always safe.
    Built by :func:`repro_torch.serving.presplit.wrap_params`.
    """

    __slots__ = ("array", "digits", "scale", "base", "gbase", "beta",
                 "split", "k")

    def __init__(self, array, digits, scale, base, gbase, beta: int,
                 split: str, k: int):
        self.array, self.digits, self.scale = array, digits, scale
        self.base, self.gbase = base, gbase
        self.beta, self.split, self.k = beta, split, k

    @property
    def shape(self):
        return self.array.shape

    def layer(self, i: int) -> "PresplitWeight":
        """Stack element ``i`` (every field indexed on its leading axis)."""
        pick = lambda t: None if t is None else t[i]
        return PresplitWeight(self.array[i], self.digits[i], self.scale[i],
                              pick(self.base), pick(self.gbase), self.beta,
                              self.split, self.k)

    def usable_split(self, lhs, dimension_numbers, compute_dtype,
                     cfg) -> Optional[splitting.Split]:
        """The frozen Split iff it applies to this contraction, else None."""
        (ac, bc), (ab, bb) = dimension_numbers
        simple = (tuple(ac) == (lhs.ndim - 1,) and tuple(bc) == (0,)
                  and not ab and not bb)
        if not (simple and self.array.ndim == 2 and self.digits.ndim == 3):
            return None
        if self.split != cfg.split or self.scale.dtype != compute_dtype:
            return None
        if not cfg.auto_k and self.k != cfg.k:
            return None
        if self.beta != splitting.beta_for(self.split, self.array.shape[0]):
            return None
        return splitting.Split(self.digits, self.scale, self.base,
                               self.beta, 1, gbase=self.gbase,
                               signmag=splitting.is_signmag(self.split))


# Consumption counters: every engine contraction that received a
# PresplitWeight records whether the frozen split applied or fell back to
# re-splitting; the serving runtime turns the delta into the measured
# weight-split hit rate.
_PRESPLIT_COUNTS = {"used": 0, "fallback": 0}


def presplit_trace_counts() -> dict:
    return dict(_PRESPLIT_COUNTS)


@dataclasses.dataclass(frozen=True)
class MatmulEngine:
    spec: str = "bf16"

    @property
    def is_ozimmu(self) -> bool:
        return self.spec.split("@")[0].split("-")[0].split(":")[0] \
            not in _NATIVE

    @property
    def ozimmu_config(self) -> Optional[ozimmu.OzimmuConfig]:
        return ozimmu.parse_spec(self.spec) if self.is_ozimmu else None

    @property
    def compute_dtype(self) -> torch.dtype:
        if not self.is_ozimmu:
            return _NATIVE[self.spec]
        return torch.float64 if self.ozimmu_config.accum_dtype == "f64" \
            else torch.float32

    def local(self) -> "MatmulEngine":
        """This engine without the ``@mesh_axis`` suffix: single-device
        semantics, for a body that already owns its rank's share of the
        mesh (the MoE all-to-all's resident experts)."""
        return MatmulEngine(self.spec.split("@")[0]) if "@" in self.spec \
            else self

    def dot_general(self, lhs: torch.Tensor, rhs, dimension_numbers,
                    out_dtype=None) -> torch.Tensor:
        """Contract ``lhs`` with ``rhs`` under lax dimension numbers;
        returns ``lhs.dtype`` unless ``out_dtype`` is given.  ``rhs`` may be
        a :class:`PresplitWeight`."""
        if isinstance(lhs, PresplitWeight):
            lhs = lhs.array
        presplit = None
        if isinstance(rhs, PresplitWeight):
            rhs, presplit = rhs.array, rhs
        out_dtype = out_dtype or lhs.dtype
        if not self.is_ozimmu:
            dt = _NATIVE[self.spec]
            # accumulate in f32, except for the f64 reference spec
            acc = torch.float64 if dt == torch.float64 else torch.float32
            out = dot_general(lhs.to(dt).to(acc), rhs.to(dt).to(acc),
                              dimension_numbers)
            return out.to(out_dtype)
        cfg = self.ozimmu_config
        compute = self.compute_dtype
        sp = None
        if presplit is not None:
            sp = presplit.usable_split(lhs, dimension_numbers, compute, cfg)
            _PRESPLIT_COUNTS["used" if sp is not None else "fallback"] += 1
        out = ozimmu.ozimmu_dot_general(
            lhs.to(compute), rhs.to(compute), dimension_numbers, cfg,
            rhs_presplit=sp)
        return out.to(out_dtype)

    def __call__(self, x: torch.Tensor, w) -> torch.Tensor:
        """Contract x[..., n] with w[n, ...] -> out[..., ...]."""
        assert w.shape[0] == x.shape[-1], (x.shape, w.shape)
        return self.dot_general(x, w, (((x.ndim - 1,), (0,)), ((), ())))


def make_engine(spec: str) -> MatmulEngine:
    eng = MatmulEngine(spec)
    if eng.is_ozimmu:
        ozimmu.parse_spec(spec)  # validate eagerly
    elif spec not in _NATIVE:
        raise ValueError(f"native engine specs take no suffixes: {spec!r}")
    return eng
