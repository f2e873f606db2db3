"""The port's mesh launcher and serving under a mesh:

* ``parse_mesh_spec``'s grammar and errors, ``mesh_rules(mesh, arch)`` for
  every arch, ``logical_to_pspec`` / ``spec_tree`` and the mesh half of
  the split-cache and prefix-cache keys, held to the reference's (a mesh
  of one device on each side);
* on 2 gloo ranks on the CPU (one spawn;
  ``tests/torch_mesh_worker.py`` runs the ranks): ``serve.main([...,
  "--mesh", "model=2", "--device", "cpu"])`` at the smoke config under an
  ``@model`` engine gives the single-device run's tokens on both ranks,
  and the paged + chunked + prefix-cached runtime under the mesh gives the
  monolithic mesh runtime's over a cold and a hit wave (the reference's
  ``test_serving_prefix_chunked_paged_mesh_bitwise``); the batch split,
  ``--mesh data=2`` and ``--mesh pod=2``, and the MoE arch under
  ``data=2`` (its experts' tokens exchanged by all-to-all inside every
  model call) give the single-device tokens on both ranks, with one
  gather of the greedy tokens a model call; the paged pool under
  ``data=2`` raises, naming what is left;
* on 4 gloo ranks (one spawn): ``--mesh data=2,model=2`` under an
  ``@model`` engine gives the single-device tokens on every rank (the
  reference's ``test_serving_runtime_mesh_smoke`` shape);
* ``compress_pod_grads`` raises, saying that the reference declares it and
  never reads it; ``train --mesh`` in one process fails as the
  reference's does (the sharded trainer is
  ``tests/test_torch_train_mesh.py``'s).
"""
import types

import numpy as np
import pytest

import jax
import torch

from repro import configs as R_configs
from repro.core import split_cache as R_split_cache
from repro.distributed import compat as R_compat
from repro.distributed import sharding as R_sharding
from repro.launch import mesh as R_mesh
from repro.launch import train as R_train
from repro.models import api as R_api
from repro.serving import prefix_cache as R_prefix
from repro_torch import configs as P_configs
from repro_torch.core import split_cache as P_split_cache
from repro_torch.distributed import compat as P_compat
from repro_torch.distributed import sharding as P_sharding
from repro_torch.launch import mesh as P_mesh
from repro_torch.launch import steps as P_steps
from repro_torch.launch import train as P_train
from repro_torch.serving import prefix_cache as P_prefix
from tests.torch_mesh_worker import served_run, start

SPEC = "ozimmu_h-4:df32:fused@model"
DATA_SPEC = "ozimmu_h-4:df32:fused"
ARGV = ["--arch", "internlm2_1_8b", "--slots", "2", "--requests", "3",
        "--prompt-len", "8", "--gen", "4", "--max-len", "32", "--engine",
        SPEC, "--device", "cpu"]
DATA_ARGV = ARGV[:-3] + [DATA_SPEC, "--device", "cpu"]
MOE_ARGV = ["--arch", "deepseek_moe_16b"] + DATA_ARGV[2:]
# the reference's test_serving_runtime_mesh_smoke shape: 2 requests of 3
# tokens
DM_ARGV = ARGV[:2] + ["--slots", "2", "--requests", "2", "--prompt-len",
                      "6", "--gen", "3", "--max-len", "32", "--engine",
                      SPEC, "--device", "cpu"]


# ---------------------------------------------------------------------------
# the launcher's grammar, rules and keys against the reference's
# ---------------------------------------------------------------------------

def _outcome(parse, spec):
    try:
        mesh = parse(spec)
    except ValueError as e:
        return "error", str(e)
    if mesh is None:
        return None
    return tuple(mesh.axis_names), dict(mesh.shape)


@pytest.mark.parametrize("spec", [
    None, "", "model=1", "data=1,model=1", "pod=1, data=1, model=1",
    "model=2", "data=1,model=2", "model", "model=0", "model=-1",
    "model=x", "foo=1", "model=1,model=1", "data=1,,model=1"])
def test_parse_mesh_spec_matches_reference(spec):
    """The same meshes and the same error texts, "devices" being the
    world size (one rank here, one CPU device there)."""
    assert len(jax.devices()) == 1
    assert _outcome(P_mesh.parse_mesh_spec, spec) == \
        _outcome(R_mesh.parse_mesh_spec, spec)


def test_production_presets_need_their_ranks():
    for spec in ("single_pod", "multi_pod"):
        with pytest.raises(ValueError):
            R_mesh.parse_mesh_spec(spec)
        with pytest.raises(ValueError, match="ranks"):
            P_mesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("arch", P_configs.ARCH_IDS)
def test_mesh_rules_match_reference(arch):
    """The rule table of a single-pod and a multi-pod mesh, each arch's
    overrides merged over it."""
    for axes in (("model",), ("data", "model"), ("pod", "data", "model")):
        shape = (1,) * len(axes)
        want = R_mesh.mesh_rules(jax.make_mesh(shape, axes), arch)
        got = P_mesh.mesh_rules(P_compat.Mesh(shape, axes), arch)
        assert got == want, (arch, axes)
    assert P_configs.rules_overrides(arch) == R_configs.rules_overrides(arch)


def test_logical_to_pspec_matches_reference():
    cases = [("batch", "seq", "embed"), ("embed", "mlp"), ("vocab", "embed"),
             ("heads", "kv_heads"), ("batch", "cache_batch", None),
             ("zero", "batch"), (None, None), ()]
    for rules in (R_sharding.SINGLE_POD_RULES, R_sharding.MULTI_POD_RULES,
                  None):
        for axes in cases:
            want = tuple(R_sharding.logical_to_pspec(axes, rules))
            assert P_sharding.logical_to_pspec(axes, rules) == want
    with P_sharding.use_rules(P_sharding.MULTI_POD_RULES):
        assert P_sharding.get_rules() is P_sharding.MULTI_POD_RULES
        assert P_sharding.logical_to_pspec(("batch",)) == (("pod", "data"),)
    assert P_sharding.get_rules() is None


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_moe_16b",
                                  "deepseek_v2_236b", "mamba2_780m"])
def test_spec_tree_matches_reference(arch):
    """Every parameter's partition spec under an arch's rules and
    overrides, from the reference's own logical-axes tree."""
    cfg = R_configs.get_config(arch, smoke=True)
    box = {}

    def init(key):      # traced abstractly: the axes tree, no weights
        params, box["axes"] = R_api.get_model(cfg).init(key, cfg)
        return params
    jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = box["axes"]
    rules = R_mesh.mesh_rules(jax.make_mesh((1, 1), ("data", "model")),
                              arch)
    want = jax.tree.map(tuple, R_sharding.spec_tree(axes, rules),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert P_sharding.spec_tree(axes, rules) == want


def test_cache_keys_mesh_half_matches_reference():
    """``()`` without a mesh, the sorted (axis, size) pairs under one:
    in the split cache's entry key and the prefix cache's config key."""
    cfg_p = P_configs.get_config("internlm2_1_8b", smoke=True,
                                 engine_spec=SPEC)
    cfg_r = R_configs.get_config("internlm2_1_8b", smoke=True,
                                 engine_spec=SPEC)
    assert P_split_cache._mesh_key() == R_split_cache._mesh_key() == ()
    assert P_prefix.config_key(cfg_p) == R_prefix.config_key(cfg_r)
    axes = ("data", "model")
    with P_compat.set_mesh(P_compat.Mesh((1, 1), axes)), \
            R_compat.set_mesh(jax.make_mesh((1, 1), axes)):
        assert P_split_cache._mesh_key() == R_split_cache._mesh_key() == \
            (("data", 1), ("model", 1))
        assert P_prefix.config_key(cfg_p) == R_prefix.config_key(cfg_r)
        b = torch.ones(64, 32)
        cache = P_split_cache.SplitCache()
        cache.get(b, (((1,), (0,)), ((), ())), cfg_p.engine.ozimmu_config)
        (key,) = cache._entries
        assert key[3] == (("data", 1), ("model", 1))
    assert P_compat.get_abstract_mesh() is P_compat.EMPTY_MESH


def test_runtime_slot_split_over_the_batch_ranks():
    """Under multi-pod rules ``cache_batch`` spans pod and data: on a mesh
    of pod=2 x data=2 the rank at pod 1, data 0 is batch rank 2 of 4 and
    serves slot 2 of 4 (a cache of one slot); slots that do not divide
    over the 4 ranks, and the paged pool or the prefix cache, raise.  A
    stand-in mesh of one process: the constructor runs no collective."""
    from repro_torch.models import api as P_api
    from repro_torch.serving import ServingRuntime
    coord = {"pod": 1, "data": 0}
    mesh = types.SimpleNamespace(
        empty=False, axis_names=("pod", "data"), shape={"pod": 2, "data": 2},
        coord=coord, rank=2, index=coord.__getitem__)
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    params = P_api.get_model(cfg).init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with P_compat.set_mesh(mesh), \
            P_sharding.use_rules(P_sharding.MULTI_POD_RULES):
        rt = ServingRuntime(cfg, params, slots=4, max_len=16, device="cpu")
        assert rt._rows == slice(2, 3)
        assert len(rt.sched.slots) == 4
        with pytest.raises(ValueError, match="do not split"):
            ServingRuntime(cfg, params, slots=6, max_len=16, device="cpu")
        for kw in ({"page_block": 4}, {"page_block": 4, "prefix_cache": True}):
            with pytest.raises(NotImplementedError,
                               match="paged pool and the prefix cache"):
                ServingRuntime(cfg, params, slots=4, max_len=16,
                               device="cpu", **kw)


def test_second_slice_raises_naming_it():
    """``train --mesh`` runs now: in one process ``train(mesh="model=2")``
    fails as the reference's ``train`` does, on a mesh larger than the
    world, with the same text.  ``compress_pod_grads`` raises: the
    reference declares it and its step never reads it."""
    with pytest.raises(ValueError) as r_err:
        R_train.main(["--mesh", "model=2"])
    with pytest.raises(ValueError) as p_err:
        P_train.train("internlm2_1_8b", mesh="model=2", device="cpu")
    assert str(p_err.value) == str(r_err.value)
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    with pytest.raises(NotImplementedError, match="never reads it"):
        P_steps.make_train_step(cfg, None, P_steps.TrainConfig(
            compress_pod_grads=True))


# ---------------------------------------------------------------------------
# serving on 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns, started together: 2 ranks of the ``serving`` job and 4
    of ``--mesh data=2,model=2``; while they run, the single-device runs
    of the MoE arch and of the 4-rank requests in this process."""
    wait2 = start("serving", 2, tmp_path_factory.mktemp("mesh_serve"),
                  {"argv": ARGV, "spec": SPEC, "data_argv": DATA_ARGV,
                   "moe_argv": MOE_ARGV})
    wait4 = start("serving_data_model", 4,
                  tmp_path_factory.mktemp("mesh_serve4"), {"argv": DM_ARGV})
    moe_single, dm_single = served_run(MOE_ARGV), served_run(DM_ARGV)
    return {"served": wait2(), "moe_single": moe_single,
            "data_model": (wait4(), dm_single)}


@pytest.fixture(scope="module")
def served(spawned):
    return spawned["served"]


def test_serve_mesh_gives_single_device_tokens(served):
    """``serve.main`` with ``--mesh model=2``: every request's tokens equal
    the single-device run's, on both ranks; every weight split frozen."""
    for out in served:
        assert len(out["single"]) == 3
        assert all(len(t) == 4 for t in out["single"])
        assert out["mesh"] == out["single"]
        assert out["mesh_summary"] == {"finished": 3, "hit_rate": 1.0}
    assert served[0]["mesh"] == served[1]["mesh"]


def test_serve_mesh_paged_chunked_prefix_equals_monolithic(served):
    """Paged (blocks of 4), chunked (3) and prefix-cached under the mesh
    == the monolithic mesh runtime, cold wave and hit wave; the second
    wave hits the 9-token prefix's aligned 8 tokens."""
    for out in served:
        assert out["paged"] == out["mono"]
        hits = out["prefix"]["hits"]
        assert hits >= 3
        assert out["prefix"]["hit_tokens"] == hits * 8
        assert out["paged_counts"]["psum_exact_int32"] > 0
        assert out["prefix"]["key_mesh"] == (("model", 2),)
        assert out["split_key_mesh"] == (("model", 2),)
    assert served[0]["paged"] == served[1]["paged"]


def test_serve_mesh_other_axes_raise_naming_slice_2b(served):
    """What the batch split does not serve yet raises on every rank,
    naming it: the paged pool (and the prefix cache over it) under
    ``--mesh data=2``."""
    for out in served:
        msg = out["paged_data"]
        assert "paged pool" in msg and "prefix cache" in msg
        assert "data" in msg


@pytest.mark.parametrize("axis", ["data", "pod"])
def test_serve_batch_axis_gives_single_device_tokens(served, axis):
    """``serve.main`` with ``--mesh data=2`` (single-pod rules) and
    ``--mesh pod=2`` (multi-pod rules: ``cache_batch`` spans pod and
    data) under ``ozimmu_h-4:df32:fused``: one slot a rank, every
    request's tokens equal to the single-device run's (under the same
    spec with an ``@model`` suffix and no mesh, which contracts alike) on
    both ranks; one gather of the greedy tokens a model call and no
    all-to-all."""
    for out in served:
        run = out[axis]
        assert run["finished"] == 3
        assert run["tokens"] == out["single"]
        assert run["data_counts"] == {
            "pmean": 0, "all_gather_cat": 0, "all_to_all": 0,
            "all_gather_rows": run["model_calls"]}
        assert run["model_calls"] > 0


def test_serve_moe_data_axis_runs_the_all_to_all(served, spawned):
    """deepseek-moe-16b's smoke config (2 layers of 8 experts,
    ``moe_dispatch="a2a"``) under ``--mesh data=2``: the single-device
    tokens on both ranks; two all-to-alls a layer in every model step
    (each rank runs every step, its slot idle or not) and one gather of
    the tokens a model call."""
    single = spawned["moe_single"]
    assert single["finished"] == 3
    for out in served:
        run = out["moe"]
        assert run["tokens"] == single["tokens"]
        assert run["model_steps"] == single["model_steps"]
        assert run["data_counts"] == {
            "pmean": 0, "all_gather_cat": 0,
            "all_to_all": 2 * 2 * run["model_steps"],
            "all_gather_rows": run["model_calls"]}
        assert single["data_counts"]["all_to_all"] == 0


def test_serve_data_and_model_axes_give_single_device_tokens(spawned):
    """``--mesh data=2,model=2`` under ``ozimmu_h-4:df32:fused@model``:
    2 requests of 3 tokens, equal to the single-device run's on all 4
    ranks; the contractions summed over ``model`` within each data line,
    one gather of the tokens a model call."""
    ranks, single = spawned["data_model"]
    assert len(single["tokens"]) == 2
    assert all(len(t) == 3 for t in single["tokens"])
    for out in ranks:
        assert out["finished"] == 2
        assert out["tokens"] == single["tokens"]
        assert out["data_counts"]["all_gather_rows"] == out["model_calls"]
        assert out["counts"]["psum_exact_int32"] > 0
