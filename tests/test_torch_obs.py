"""The port's observability layer against the reference's (``repro.obs``).

* the emulation counters: one eager call of every spec of
  ``tests/test_obs.py``'s ``FIXED_SPECS`` and ``AUTO_SPECS`` leaves the
  same counter rows (labels included) in the port's registry as the
  reference's call on the same numpy operands leaves in its own, and those
  rows are the port's ``Plan`` accounting; batched and presplit calls
  likewise;
* outputs bitwise equal with obs on and off (``BITWISE_SPECS``), also on
  a frozen rhs and with a profiler recording the phase ranges;
* the split cache's counter rows after the same sequence of ``get`` calls
  (hits, a miss, an invalidation) equal the reference's;
* the exporters: the same increments give the reference's JSON and
  Prometheus texts byte for byte; the Prometheus round trip and lint;
* the phase scopes: the shared null context while no profiler records
  (obs enabled or not), ``ozimmu/*`` ranges in a trace while one does.
"""
import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ozimmu as R_oz
from repro.core import plan as R_plan
from repro.core import split_cache as R_sc
from repro.obs import export as R_export
from repro.obs import registry as R_reg
from repro_torch.core import ozimmu as P_oz
from repro_torch.core import plan as P_plan
from repro_torch.core import split_cache as P_sc
from repro_torch.obs import export as P_export
from repro_torch.obs import registry as P_reg
from repro_torch.obs import tracing as P_tracing

torch.set_num_threads(1)

DN = (((1,), (0,)), ((), ()))

# tests/test_obs.py's spec lists
FIXED_SPECS = [
    "ozimmu-3:f32", "ozimmu_rn-3:f32", "ozimmu_ef-3:df32",
    "ozimmu_h-4:df32", "ozimmu_sm_b-3:f32", "ozimmu_sm_h-4:df32",
    "oz2_b-4:df32", "oz2_h-4:df32:fast", "oz2_b-4:df32:fast2",
]
AUTO_SPECS = ["ozimmu_h-auto:df32", "oz2_h-auto:df32:fast",
              "ozimmu_sm_h-auto:df32:prob"]
BITWISE_SPECS = ["ozimmu_h-4:df32", "ozimmu_sm_h-4:df32",
                 "oz2_h-4:df32:fast", "oz2_b-4:df32:fast2",
                 "ozimmu_h-4:df32:fused", "oz2_h-auto:df32:fast:fused"]


@pytest.fixture()
def registries():
    """Fresh process-global registries in both packages (restored after);
    both planner ledgers cleared; one fixed clock."""
    r_new = R_reg.MetricsRegistry(now=lambda: 12.5)
    p_new = P_reg.MetricsRegistry(now=lambda: 12.5)
    r_old, p_old = R_reg.set_registry(r_new), P_reg.set_registry(p_new)
    R_reg.set_enabled(True)
    P_reg.set_enabled(True)
    R_plan.get_ledger().clear()
    P_plan.get_ledger().clear()
    try:
        yield r_new, p_new
    finally:
        R_reg.set_registry(r_old)
        P_reg.set_registry(p_old)
        R_reg.set_enabled(True)
        P_reg.set_enabled(True)


def _operands(seed=7, shape_a=(6, 96), shape_b=(96, 10)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_a).astype(np.float32),
            rng.standard_normal(shape_b).astype(np.float32))


def _rows(reg):
    """A registry's counters and gauges, for comparison across packages."""
    snap = reg.snapshot()
    return snap.counters, snap.gauges


@pytest.mark.parametrize("spec", FIXED_SPECS + AUTO_SPECS)
def test_counter_rows_match_reference(spec, registries):
    r_reg, p_reg = registries
    a, b = _operands()
    R_oz.ozimmu_dot_general(jnp.asarray(a), jnp.asarray(b), DN,
                            R_oz.parse_spec(spec))
    cfg = P_oz.parse_spec(spec)
    P_oz.ozimmu_dot_general(torch.from_numpy(a), torch.from_numpy(b), DN,
                            cfg)
    assert _rows(p_reg) == _rows(r_reg)
    # and the rows are the port's Plan accounting at the probed k
    pl = P_plan.plan_contraction(cfg, 6, 96, 10, a=torch.from_numpy(a),
                                 b=torch.from_numpy(b), _record=False)
    snap = p_reg.snapshot()
    path = "fused" if cfg.use_pallas == "fused" else "xla"
    labels = dict(variant=P_oz.variant_name(cfg), k=pl.k, path=path,
                  mesh="none", presplit=0)
    assert snap.value("emulation.calls", **labels) == 1
    assert snap.value("emulation.int8_gemms", **labels) == pl.int8_gemms
    assert snap.value("emulation.highprec_adds", **labels) == \
        pl.highprec_adds
    assert snap.value("emulation.split_bytes", **labels) == \
        4 * (a.size + b.size)
    assert snap.total("emulation.calls") == 1


@pytest.mark.parametrize("spec", ["ozimmu_h-4:df32", "oz2_h-4:df32:fast2",
                                  "ozimmu_h-4:df32:fused"])
def test_counter_rows_batched_and_presplit_match_reference(spec,
                                                           registries):
    """A batched call, a split-cache freeze and a call on the frozen rhs:
    the same counter rows (batch x Plan counts; presplit=1 and only the A
    bytes on the frozen call; the split cache's rows) as the reference's,
    and every row the Plan's."""
    r_reg, p_reg = registries
    a, b = _operands(3, (3, 5, 64), (3, 64, 7))
    dn = (((2,), (1,)), ((0,), (0,)))
    r_cfg, cfg = R_oz.parse_spec(spec), P_oz.parse_spec(spec)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    R_oz.ozimmu_dot_general(ja, jb, dn, r_cfg)
    R_oz.ozimmu_dot_general(ja, jb, dn, r_cfg,
                            rhs_presplit=R_sc.SplitCache().get(jb, dn, r_cfg))
    pl = P_plan.plan_contraction(cfg, 5, 64, 7, _record=False)
    P_oz.ozimmu_dot_general(ta, tb, dn, cfg)
    snap = p_reg.snapshot()
    assert snap.total("emulation.int8_gemms") == 3 * pl.int8_gemms
    sp = P_sc.SplitCache().get(tb, dn, cfg)
    before = p_reg.snapshot()
    P_oz.ozimmu_dot_general(ta, tb, dn, cfg, rhs_presplit=sp)
    d = p_reg.snapshot().diff(before)
    assert d.total("emulation.int8_gemms", presplit=1) == 3 * pl.int8_gemms
    assert d.total("emulation.split_bytes") == 4 * a.size
    assert _rows(p_reg) == _rows(r_reg)


@pytest.mark.parametrize("spec", BITWISE_SPECS)
def test_outputs_bitwise_obs_on_off(spec, registries):
    _, p_reg = registries
    a, b = (torch.from_numpy(x) for x in _operands())
    cfg = P_oz.parse_spec(spec)
    sp = P_sc.SplitCache().get(b, DN, cfg)
    on = P_oz.ozimmu_dot_general(a, b, DN, cfg)
    on_pre = P_oz.ozimmu_dot_general(a, b, DN, cfg, rhs_presplit=sp)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = P_oz.ozimmu_dot_general(a, b, DN, cfg)
    assert not p_reg.is_empty()
    with P_reg.disabled():
        off = P_oz.ozimmu_dot_general(a, b, DN, cfg)
        off_pre = P_oz.ozimmu_dot_general(a, b, DN, cfg, rhs_presplit=sp)
    for x, y in ((on, off), (on_pre, off_pre), (traced, off)):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))


def test_split_cache_counter_rows_match_reference(registries):
    """hit, miss, a second weight, that weight dropped (invalidation):
    ``split_cache.{hits,misses,invalidations,hit_bytes}`` and the
    ``cached_bytes`` gauge after every call as the reference's."""
    r_reg, p_reg = registries
    cfg_spec = "ozimmu_h-4:df32"
    r_cfg, cfg = R_oz.parse_spec(cfg_spec), P_oz.parse_spec(cfg_spec)
    _, b1 = _operands()
    _, b2 = _operands(8, (6, 64), (64, 24))
    r_cache, p_cache = R_sc.SplitCache(), P_sc.SplitCache()
    r_w = [jnp.asarray(b1), jnp.asarray(b2)]
    p_w = [torch.from_numpy(b1), torch.from_numpy(b2)]
    for i in (0, 0, 1, 1):
        r_cache.get(r_w[i], DN, r_cfg)
        p_cache.get(p_w[i], DN, cfg)
        assert _rows(p_reg) == _rows(r_reg)
    del r_w[1], p_w[1]
    gc.collect()
    assert len(r_cache) == len(p_cache) == 1
    assert _rows(p_reg) == _rows(r_reg)
    snap = p_reg.snapshot()
    assert (snap.total("split_cache.hits"), snap.total("split_cache.misses"),
            snap.total("split_cache.invalidations")) == (2, 2, 1)
    assert snap.total("split_cache.hit_bytes") == 4 * (b1.size + b2.size)
    assert snap.gauge("split_cache.cached_bytes") == \
        p_cache.stats.cached_bytes > 0


def _fill(reg):
    """The same increments on either package's registry."""
    reg.inc("emulation.int8_gemms", 45, variant="oz2_h", k=9)
    reg.inc("emulation.int8_gemms", 10, variant="ozimmu_h", k=4)
    reg.inc("emulation.calls", 3, variant="ozimmu_h", k=4, path="fused",
            mesh="none", presplit=1)
    reg.inc("serving.tokens_generated", 12)
    reg.gauge("split_cache.cached_bytes", 1024)
    reg.gauge("weird name-with.chars", 0.25, label='q"uote\\back')
    for v in (0.1, 0.2, 0.4, 1.5):
        reg.observe("serving.decode_step_s", v)
    reg.observe("serving.ttft_s", 0.3, slot=1)
    return reg


def test_exports_match_reference_byte_for_byte(registries):
    r_snap = _fill(R_reg.MetricsRegistry(now=lambda: 12.5)).snapshot()
    p_snap = _fill(P_reg.MetricsRegistry(now=lambda: 12.5)).snapshot()
    extra = {"serving_summary": {"tokens": 12, "ttft_s": {"p50": 0.3}},
             "decode_observed": {"contractions": 217.0}}
    for kw in (dict(ledger=False), dict(ledger=True, extra=extra),
               dict(ledger=False, extra=extra, indent=None)):
        assert P_export.to_json(p_snap, **kw) == R_export.to_json(r_snap,
                                                                  **kw)
    for prefix in ("repro", ""):
        assert P_export.to_prometheus(p_snap, prefix) == \
            R_export.to_prometheus(r_snap, prefix)
    # merged with the global registries (empty here): still equal
    assert P_export.to_json(P_export.unified_snapshot(p_snap),
                            ledger=False) == \
        R_export.to_json(R_export.unified_snapshot(r_snap), ledger=False)


def test_prometheus_roundtrip_and_lint():
    reg = P_reg.MetricsRegistry()
    reg.inc("emulation.int8_gemms", 45, variant="oz2_h", k=9)
    reg.inc("emulation.int8_gemms", 10, variant="ozimmu_h", k=4)
    reg.gauge("split_cache.cached_bytes", 1024)
    for v in (0.1, 0.2, 0.4):
        reg.observe("serving.decode_step_s", v)
    text = P_export.to_prometheus(reg.snapshot(), prefix="repro")
    P_export.lint_prometheus(text)
    parsed = P_export.parse_prometheus(text)
    assert parsed[
        'repro_emulation_int8_gemms_total{k="9",variant="oz2_h"}'] == 45
    assert parsed["repro_split_cache_cached_bytes"] == 1024
    assert parsed["repro_serving_decode_step_s_count"] == 3
    assert parsed['repro_serving_decode_step_s{quantile="0.5"}'] == 0.2
    with pytest.raises(ValueError):
        P_export.lint_prometheus("no_type_line 1")
    with pytest.raises(ValueError):
        P_export.lint_prometheus("# TYPE x counter\nx{bad-label=\"1\"} 1")
    with pytest.raises(ValueError):
        P_export.lint_prometheus("# TYPE x counter\n# TYPE x gauge\nx 1")


def test_json_document_totals_and_ledger(registries):
    _, p_reg = registries
    a, b = (torch.from_numpy(x) for x in _operands())
    P_oz.ozimmu_dot_general(a, b, DN, P_oz.parse_spec("ozimmu_h-auto:df32"))
    extra_reg = P_reg.MetricsRegistry()
    extra_reg.inc("serving.tokens_generated", 12)
    snap = P_export.unified_snapshot(extra_reg)
    doc = json.loads(P_export.to_json(snap, extra={"serving_summary": {}}))
    assert doc["totals"]["emulation.int8_gemms"] > 0
    assert doc["totals"]["serving.tokens_generated"] == 12
    assert doc["plan_ledger"]["decisions"] == 1
    assert doc["plan_ledger"] == P_plan.get_ledger().summary() | \
        {"k_hist": {str(k): v for k, v in
                    P_plan.get_ledger().summary()["k_hist"].items()}}
    assert "serving_summary" in doc


def test_package_exports_mirror_the_reference():
    import repro.obs as R_obs
    import repro_torch.obs as P_obs
    names = [n for n in dir(R_obs) if not n.startswith("_")
             and n not in ("registry", "export", "tracing")]
    assert names and all(hasattr(P_obs, n) for n in names)
    assert P_tracing.PHASES == ("split", "group_gemm", "ladder",
                                "scale_accum")


def test_phase_scope_is_the_shared_null_context_untraced(registries):
    """Obs enabled, no profiler: every scope is the one shared null
    context (no range is opened, nothing is dispatched); obs disabled:
    the same, also under a profiler."""
    assert P_reg.enabled() and not torch.autograd._profiler_enabled()
    scopes = {id(P_tracing.phase_scope(p)) for p in P_tracing.PHASES}
    scopes.add(id(P_tracing.phase_scope("kernel/group_gemm")))
    scopes.add(id(P_tracing.host_scope("split_cache/freeze")))
    assert scopes == {id(P_tracing._NULL)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert P_tracing.phase_scope("split") is not P_tracing._NULL
        with P_reg.disabled():
            assert P_tracing.phase_scope("split") is P_tracing._NULL
            assert P_tracing.host_scope("x") is P_tracing._NULL


def _range_names(prof):
    return {e.name for e in prof.events() if e.name.startswith("ozimmu/")}


@pytest.mark.parametrize("spec,want", [
    ("ozimmu_h-4:df32:fused",
     {"split", "group_gemm", "scale_accum", "kernel/split_fused",
      "kernel/group_gemm", "kernel/scale_accum"}),
    ("oz2_h-4:f64:fast2:fused",
     {"split", "group_gemm", "ladder", "scale_accum", "kernel/split_fused",
      "kernel/group_gemm", "kernel/scale_accum", "kernel/unscale"}),
    ("ozimmu-3:f32", {"split", "group_gemm", "scale_accum"}),
])
def test_phase_ranges_in_a_trace(spec, want, registries):
    """Under a profiler, a contraction's phases and kernel calls appear as
    ``ozimmu/*`` ranges (the plain path has no kernel ranges, as the
    reference's XLA path has none); a freeze on a miss as
    ``ozimmu/split_cache/freeze``; with obs disabled, none."""
    a, b = (torch.from_numpy(x) for x in _operands())
    cfg = P_oz.parse_spec(spec)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        P_oz.ozimmu_dot_general(a, b, DN, cfg)
        P_sc.SplitCache().get(b, DN, cfg)
    assert _range_names(prof) == {f"ozimmu/{n}" for n in want} | \
        {"ozimmu/split_cache/freeze"}
    with P_reg.disabled():
        with torch.profiler.profile(activities=acts) as prof:
            P_oz.ozimmu_dot_general(a, b, DN, cfg)
    assert not _range_names(prof)
