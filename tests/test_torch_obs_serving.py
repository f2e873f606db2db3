"""The port's observability layer in serving: the runtime's
``decode_observed`` against the reference's, and the launcher's
``--metrics-json`` / ``--metrics-every`` / ``--profile-dir``.

The reference records its emulation counters at jit trace time and runs
its layers in a ``lax.scan`` traced once, so its ``decode_observed`` of a
jitted step counts one layer's contractions and the head.  The port runs
eagerly and counts every executed contraction.  Like is compared with
like: the reference runtime's first decode step is traced once more
under ``jax.disable_jit()``, where its scans loop in Python and every
contraction records (at one layer its jitted count is already per
execution).
"""
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import api as R_api
from repro.obs import registry as R_reg
from repro.serving import ServingRuntime as RRuntime
from repro_torch import configs as P_configs
from repro_torch.core import ozimmu as P_oz
from repro_torch.core import plan as P_plan
from repro_torch.launch import serve
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import registry as P_reg
from repro_torch.serving import ServingRuntime

torch.set_num_threads(1)

SPEC = "ozimmu_h-4:df32"
KEYS = ("contractions", "int8_gemms", "int8_gemms_presplit",
        "highprec_adds")
# the CI's observability smoke (.github/workflows/ci.yml), on the CPU
CI_FLAGS = ["--arch", "internlm2_1_8b", "--slots", "2", "--requests", "3",
            "--prompt-len", "8", "--gen", "4", "--max-len", "32",
            "--engine", SPEC, "--page-block", "8", "--prefill-chunk", "4",
            "--prefix-cache"]


def _prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in (6, 5)]


@pytest.fixture(scope="module")
def reference_observed():
    """The reference runtime's ``decode_observed`` on the smoke config (2
    layers) with the scans unrolled: its first decode step is traced once
    more under ``jax.disable_jit()`` (the scans loop in Python, remat
    passed through, as ``tests/torch_parity.py`` traces), and the jitted
    call runs with obs disabled, so the step's counters are the unrolled
    trace's.  Returns (decode_observed, the numpy parameters served)."""
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=SPEC, dtype="float32")
    rparams, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    rrt = RRuntime(rcfg, rparams, slots=2, max_len=16)
    decode = rrt._decode

    def unrolled(*args):
        rrt._decode = decode
        checkpoint = jax.checkpoint
        jax.checkpoint = lambda fun=None, **kw: (
            fun if fun is not None else (lambda f: f))
        try:
            with jax.disable_jit():
                jax.eval_shape(rrt._decode_impl, *args)
        finally:
            jax.checkpoint = checkpoint
        with R_reg.disabled():
            return decode(*args)
    rrt._decode = unrolled
    rrt.generate(_prompts(rcfg.vocab), 3)
    return rrt.decode_observed, jax.tree.map(np.asarray, rparams)


@pytest.mark.parametrize("page_block", [None, 4],
                         ids=["monolithic", "paged"])
def test_decode_observed_matches_reference(page_block, reference_observed):
    """The port's first decode step's counters, monolithic and paged,
    equal the reference's per-execution count; ``contractions`` is every
    layer's 9 and the head, ``int8_gemms`` the Plan's count summed over
    the step's contractions (recorded call by call), and
    ``int8_gemms_presplit`` every weight contraction's."""
    want, nparams = reference_observed
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=SPEC, dtype="float32")
    n_layers = pcfg.n_layers
    rt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                        slots=2, max_len=16, page_block=page_block,
                        device="cpu")
    calls = []
    bmm, decode = P_oz._bmm_impl, rt._decode

    def recorded(a, b, cfg, rhs_presplit=None):
        calls.append((tuple(a.shape), b.shape[-1], rhs_presplit is not None))
        return bmm(a, b, cfg, rhs_presplit=rhs_presplit)

    def first_decode(*args):
        P_oz._bmm_impl = recorded
        try:
            return decode(*args)
        finally:
            P_oz._bmm_impl = bmm
            rt._decode = decode
    rt._decode = first_decode
    rt.generate(_prompts(pcfg.vocab), 3)
    got = rt.decode_observed
    assert got == want and set(got) == set(KEYS)
    assert got["contractions"] == len(calls) == 9 * n_layers + 1
    cfg = P_oz.parse_spec(SPEC)

    def gemms(shape, p):
        return math.prod(shape[:-2]) * P_plan.plan_contraction(
            cfg, shape[-2], shape[-1], p, _record=False).int8_gemms
    assert got["int8_gemms"] == sum(gemms(s, p) for s, p, _ in calls)
    presplit = [(s, p) for s, p, pre in calls if pre]
    assert len(presplit) == 7 * n_layers + 1
    assert got["int8_gemms_presplit"] == sum(gemms(s, p)
                                             for s, p in presplit)


def test_decode_observed_unset_while_obs_disabled():
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=SPEC).with_(n_layers=1)
    params = P_api.get_model(pcfg).init(
        pcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rt = ServingRuntime(pcfg, params, slots=2, max_len=16, device="cpu")
    with P_reg.disabled():
        rt.generate(_prompts(pcfg.vocab), 2)
    assert rt.decode_observed is None
    rt.generate(_prompts(pcfg.vocab), 2)
    assert rt.decode_observed["contractions"] == 10


def test_launcher_observability_smoke(tmp_path, monkeypatch, capsys):
    """``serve.main`` with the CI's observability flags and ``--device
    cpu``: the periodic dumps happen every 2 rounds, the final document
    passes the CI snippet's assertions and holds ``decode_observed`` (the
    smoke config's 2 layers: 19 contractions), the dump is atomic (no
    ``.tmp`` left), and ``--profile-dir`` writes a trace with the
    emulation's phase ranges."""
    dumps = []
    dump = serve.dump_metrics

    def counted(path, runtime, final=False):
        dumps.append(final)
        dump(path, runtime, final=final)
    monkeypatch.setattr(serve, "dump_metrics", counted)
    rounds = []
    step = ServingRuntime.step

    def stepped(self):
        busy = step(self)
        rounds.append(busy)
        return busy
    monkeypatch.setattr(ServingRuntime, "step", stepped)
    # a fresh process-global registry, as the CI's process starts with
    monkeypatch.setattr(P_reg, "_REGISTRY", P_reg.MetricsRegistry())
    path, prof = tmp_path / "obs_metrics.json", tmp_path / "obs_profile"
    serve.main(CI_FLAGS + ["--metrics-json", str(path), "--metrics-every",
                           "2", "--profile-dir", str(prof), "--device",
                           "cpu"])
    n_rounds = rounds.index(False)
    assert dumps == [False] * (n_rounds // 2) + [True] and n_rounds >= 4
    assert not Path(str(path) + ".tmp").exists()
    # the CI snippet's assertions
    d = json.loads(path.read_text())
    totals = d["totals"]
    assert totals["emulation.int8_gemms"] > 0, totals
    assert totals["emulation.calls"] > 0, totals
    assert d["plan_ledger"] is not None
    assert "serving_summary" in d, sorted(d)
    assert d["decode_observed"]["contractions"] == 19
    assert d["serving_summary"]["requests"]["finished"] == 3
    assert totals["split_cache.misses"] == 8
    assert "[serve] observed per decode step: 19 contractions" in \
        capsys.readouterr().out
    trace = prof / "trace.json"
    found = set()
    names = [b'"ozimmu/split"', b'"ozimmu/group_gemm"',
             b'"ozimmu/scale_accum"']
    with open(trace, "rb") as f:       # hundreds of MB: scanned, not parsed
        tail = b""
        while len(found) < len(names):
            chunk = f.read(1 << 24)
            if not chunk:
                break
            found.update(n for n in names if n in tail + chunk)
            tail = chunk[-64:]
    trace.unlink()
    assert found == set(names)
