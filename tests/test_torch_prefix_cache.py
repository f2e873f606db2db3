"""The port's prefix KV cache (``serving/prefix_cache.py`` and the
runtime's prefix path) against the reference's.

What is held, and how:

* ``config_key`` equal to the reference's for the same configs (the port
  has no mesh: both hold ``()`` there);
* the bookkeeping: a seeded soup of ``publish`` / ``lookup`` / ``adopt`` /
  ``release_one`` / ``clear`` / ``reset_stats`` (with ``ensure`` /
  ``free_slot`` churning the pools, and a cap of 4 entries) on the
  reference's ``PrefixCache`` over its ``PagedKV`` and on the port's over
  its own: after every operation the entries in LRU order (key, length,
  blocks, hits), ``stats.as_dict()``, ``summary()``, the pools' tables,
  reference counts and free lists are equal, and so are the snapshots a
  state family's entries hold;
* the reference's unit cases (``tests/test_prefix_cache.py``) on the
  port's runtime: hit / miss / partial overlap, a chunked hit, the
  steady-state window of all hits, LRU entries released before a slot is
  preempted, det vs ``:prob`` key isolation, a foreign pool rejected,
  ``page_block`` required, an empty instance not switched off; every
  output against the port's monolithic, unchunked runtime;
* the ``prefix_cache.*`` counters through the port's obs registry.

The dense runtime against the reference's prefix runtime and the
poisoning controls are in ``tests/test_torch_prefix_runtime.py`` (a file
of their own, so that a test run spread over workers by file runs the
two side by side).
"""
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.serving import prefix_cache as R_pc
from repro_torch import configs as P_configs
from repro_torch.models import api as P_api
from repro_torch.obs import registry as P_obs
from repro_torch.serving import PagedKV, PrefixCache, ServingRuntime
from repro_torch.serving import prefix_cache as P_pc
from tests.test_torch_paged import _bookkeeping_equal, _fill, _np, _pools
from tests.torch_parity import FUSED

torch.set_num_threads(1)

GEN = 3
PREFIX_LEN = 19        # the shared prefix (m_pub = 16 at block 8)
SUFFIX_LEN = 3
MAX_LEN = 32


@pytest.fixture(scope="module")
def dense():
    """The dense smoke model under ``:fused`` (presplit on: the prefix
    cache composes with the weight split-cache)."""
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                               engine_spec=FUSED)
    model = P_api.get_model(cfg)
    params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    return cfg, model, params


def _prompts(rng, vocab, n, prefix):
    return [np.concatenate([prefix, rng.integers(0, vocab, size=SUFFIX_LEN,
                                                 dtype=np.int32)])
            for _ in range(n)]


def _runtime(cfg, params, **kw):
    kw.setdefault("slots", 3)
    return ServingRuntime(cfg, params, max_len=MAX_LEN, device="cpu", **kw)


def _cold(cfg, params, prompts, slots=3):
    """The monolithic, unchunked, uncached runtime's outputs."""
    return _runtime(cfg, params, slots=slots).generate(
        [p.copy() for p in prompts], GEN)


def _same_outputs(outs, refs):
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)


# ---------------------------------------------------------------------------
# the key and the bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,spec", [
    ("internlm2_1_8b", "ozimmu_h-4:df32"),
    ("internlm2_1_8b", "ozimmu_h-auto:df32:prob"),
    ("mamba2_780m", FUSED),
    ("seamless_m4t_medium", "bf16")])
def test_config_key_equals_reference(arch, spec):
    rcfg = R_configs.get_config(arch, smoke=True, engine_spec=spec)
    pcfg = P_configs.get_config(arch, smoke=True, engine_spec=spec)
    assert P_pc.config_key(pcfg) == R_pc.config_key(rcfg)
    assert P_pc.config_key(pcfg)[-1] == ()


def _entries(cache):
    return [(k, e.length, list(e.blocks), e.hits)
            for k, e in cache.entries.items()]


def _caches_equal(rc, pc):
    assert _entries(pc) == _entries(rc)
    assert pc.stats.as_dict() == rc.stats.as_dict()
    assert pc.summary() == rc.summary()
    assert len(pc) == len(rc)
    for key, re_ in rc.entries.items():
        pe = pc.entries[key]
        assert set(pe.state) == set(re_.state)
        for name in re_.state:
            np.testing.assert_array_equal(_np(pe.state[name]),
                                          _np(re_.state[name]))
    _bookkeeping_equal(rc.paged, pc.paged)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "recurrentgemma_9b"])
@pytest.mark.parametrize("seed", range(4))
def test_bookkeeping_soup_matches_reference(arch, seed):
    """The same seeded operations on the reference's cache and pool and on
    the port's; both sides compared after every one (return values too),
    then everything released: every block free again."""
    ref_pool, port_pool = _pools(arch, n_slots=3, max_len=32, block=8)
    rng = np.random.default_rng(seed)
    _fill(ref_pool, port_pool, rng)
    rcfg = R_configs.get_config(arch, smoke=True)
    pcfg = P_configs.get_config(arch, smoke=True)
    rc = R_pc.PrefixCache(ref_pool, rcfg, max_entries=4)
    pc = P_pc.PrefixCache(port_pool, pcfg, max_entries=4)
    # prompts over two shared stems, so that lookups hit and overlap
    stems = [rng.integers(0, 50, size=30, dtype=np.int32) for _ in range(2)]

    def tokens():
        t = stems[int(rng.integers(0, 2))].copy()
        cut = int(rng.integers(0, 30))
        t[cut:] = rng.integers(0, 50, size=30 - cut)
        return t[:int(rng.integers(9, 31))]

    foreign = R_pc.config_key(rcfg.with_(engine_spec="f32"))
    done = {"inserted": 0, "hits": 0, "adopted": 0, "released": 0}
    for _ in range(120):
        op = int(rng.choice(8, p=[.2, .1, .25, .25, .05, .05, .05, .05]))
        slot = int(rng.integers(0, 3))
        if op == 0:
            length = int(rng.integers(1, 33))
            assert port_pool.ensure(slot, length) == \
                ref_pool.ensure(slot, length)
        elif op == 1:
            ref_pool.free_slot(slot)
            port_pool.free_slot(slot)
        elif op == 2 and int(ref_pool.allocated[slot]):
            t = tokens()
            top = min(int(ref_pool.allocated[slot]) * 8, len(t) - 1)
            if top >= 8:
                m = 8 * int(rng.integers(1, top // 8 + 1))
                n = rc.publish(t, m, slot)
                assert pc.publish(t, m, slot) == n
                done["inserted"] += n
        elif op in (3, 4):
            t = tokens()
            key0 = foreign if op == 4 else None      # op 4 always misses
            re_, pe = rc.lookup(t, key0=key0), pc.lookup(t, key0=key0)
            assert (pe is None) == (re_ is None)
            if re_ is not None:
                done["hits"] += 1
                assert (pe.key, pe.length, pe.blocks) == \
                    (re_.key, re_.length, re_.blocks)
                if rng.random() < 0.5:     # into an emptied slot
                    ref_pool.free_slot(slot)
                    port_pool.free_slot(slot)
                    assert pc.adopt(slot, pe) == rc.adopt(slot, re_)
                    done["adopted"] += 1
                    for name in ref_pool.state:
                        np.testing.assert_array_equal(
                            _np(port_pool.state[name]),
                            _np(ref_pool.state[name]))
        elif op == 5:
            released = rc.release_one()
            assert pc.release_one() == released
            done["released"] += released
        elif op == 6 and rng.random() < 0.2:
            rc.clear()
            pc.clear()
        elif op == 7 and rng.random() < 0.2:
            rc.reset_stats()
            pc.reset_stats()
        _caches_equal(rc, pc)
    assert min(done.values()) > 0, done
    for s in range(3):
        ref_pool.free_slot(s)
        port_pool.free_slot(s)
    rc.clear()
    pc.clear()
    _caches_equal(rc, pc)
    assert port_pool.free_block_count == port_pool.n_blocks


# ---------------------------------------------------------------------------
# the reference's unit cases, on the port's runtime
# ---------------------------------------------------------------------------

def test_prefix_hit_miss_partial_overlap(dense):
    cfg, _, params = dense
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    wave1 = _prompts(rng, cfg.vocab, 3, prefix)
    wave2 = _prompts(rng, cfg.vocab, 3, prefix)
    # diverges after 10 tokens: only the 8-token aligned sub-prefix hits
    part = wave2[0].copy()
    part[10] = (part[10] + 1) % cfg.vocab

    rt = _runtime(cfg, params, page_block=8, prefix_cache=True)
    out1 = rt.generate([p.copy() for p in wave1], GEN)
    st = rt.prefix.stats
    # one wave admitted cold; published at 16 and at 8 (a stateless
    # family), once across the slots
    assert (st.hits, st.misses) == (0, 3)
    assert st.inserted == 2 and len(rt.prefix) == 2
    out2 = rt.generate([p.copy() for p in wave2], GEN)
    assert (st.hits, st.misses) == (3, 3)
    assert st.hit_tokens == 3 * 16
    out3 = rt.generate([part.copy()], GEN)
    # longest first: 16 misses (the bytes differ at index 10), 8 hits
    assert (st.hits, st.misses) == (4, 3)
    assert st.hit_tokens == 3 * 16 + 8
    # the diverged prompt publishes its own 16-token entry
    assert st.inserted == 3 and len(rt.prefix) == 3
    _same_outputs(out1 + out2 + out3,
                  _cold(cfg, params, wave1 + wave2 + [part]))
    s = rt.metrics.summary()
    assert s["prefix_cache"]["hit_rate"] == pytest.approx(4 / 7)
    assert s["prefix_cache"]["entries"] == 3
    total = sum(len(p) for p in wave1 + wave2 + [part])
    assert s["prefill_tokens"] == total - st.hit_tokens


def test_prefix_chunked_hit_bitwise(dense):
    """Chunked prefill + prefix cache: chunk boundaries land on the
    publication length, hits resume mid-prompt, outputs stay bitwise."""
    cfg, _, params = dense
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    waves = [_prompts(rng, cfg.vocab, 3, prefix) for _ in range(2)]
    rt = _runtime(cfg, params, page_block=8, prefill_chunk=5,
                  prefix_cache=True)
    outs = [rt.generate([p.copy() for p in w], GEN) for w in waves]
    assert rt.prefix.stats.hits == 3
    assert rt.prefix.stats.hit_tokens == 3 * 16
    _same_outputs(outs[0] + outs[1], _cold(cfg, params, waves[0] + waves[1]))


def test_steady_state_prefix_measured_window_all_hits(dense):
    """The reference bench's steady-state helper on the port's prefix
    runtime: after two warm passes every request of the measured window
    hits, each adopting 16 tokens."""
    from benchmarks.bench_serving import (make_shared_prefix_trace,
                                          steady_state)
    cfg, _, params = dense
    rng = np.random.default_rng(5)
    trace = make_shared_prefix_trace(rng, 4, cfg.vocab, prefix_len=19,
                                     suffix_len=3, gen=3)
    rt = _runtime(cfg, params, slots=4, page_block=8, prefix_cache=True)
    s = steady_state(rt, trace, warm_passes=2)
    assert s["requests"]["finished"] == len(trace)
    assert s["prefix_cache"]["hit_rate"] == 1.0
    assert s["prefix_cache"]["hit_tokens"] == 16 * len(trace)
    assert len(rt.prefix) > 0     # reset_metrics kept the entries


def test_prefix_eviction_under_block_pressure(dense):
    """A pool too small for the working set drops LRU entries first;
    requests still finish with the cold outputs, blocks are conserved,
    and at drain only entries hold blocks."""
    cfg, _, params = dense
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    prompts = _prompts(rng, cfg.vocab, 4, prefix)
    rt = _runtime(cfg, params, slots=2, page_block=8, page_blocks=5,
                  prefix_cache=True)
    released = []
    pressure = rt._pool_pressure

    def watched(protect):
        # a slot is preempted only once no entry is left to release
        released.append(len(rt.prefix))
        return pressure(protect)
    rt._pool_pressure = watched
    outs = rt.generate([p.copy() for p in prompts], GEN)
    _same_outputs(outs, _cold(cfg, params, prompts, slots=2))
    s = rt.metrics.summary()
    assert s["requests"]["finished"] == len(prompts)
    assert rt.prefix.stats.evicted > 0 and released
    assert s["evictions"] == released.count(0)
    paged = rt.paged
    assert paged.live_blocks + paged.free_block_count == paged.n_blocks
    held = {b for e in rt.prefix.entries.values() for b in e.blocks}
    assert paged.live_blocks == len(held)


def test_prefix_key_isolation_det_vs_prob(dense):
    _, model, _ = dense
    det = P_configs.get_config("internlm2_1_8b", smoke=True,
                               engine_spec="ozimmu_h-auto:df32")
    prob = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec="ozimmu_h-auto:df32:prob")
    assert P_pc.config_key(det) != P_pc.config_key(prob)
    # entries published under the det key are invisible to a lookup
    # carrying the prob key
    paged = PagedKV(det, model, 2, 32, block=8, device="cpu")
    cache = PrefixCache(paged, det)
    tokens = np.arange(17, dtype=np.int32)
    assert paged.ensure(0, 16)
    assert cache.publish(tokens, 16, 0) == 2
    assert cache.lookup(tokens) is not None
    assert cache.lookup(tokens, key0=P_pc.config_key(prob)) is None
    assert (cache.stats.hits, cache.stats.misses) == (1, 1)


def test_prefix_cache_rejects_foreign_pool(dense):
    cfg, model, params = dense
    foreign = PrefixCache(PagedKV(cfg, model, 2, 32, block=8,
                                  device="cpu"), cfg)
    with pytest.raises(ValueError, match="another pool"):
        _runtime(cfg, params, slots=2, page_block=8, prefix_cache=foreign)


def test_prefix_cache_requires_paged(dense):
    cfg, _, params = dense
    with pytest.raises(ValueError, match="page_block"):
        _runtime(cfg, params, slots=2, prefix_cache=True)


def test_empty_prefix_cache_instance_is_not_switched_off(dense,
                                                        monkeypatch):
    """An empty ``PrefixCache`` has ``len() == 0``; handed to the runtime
    it is taken (bound to another pool, it raises), and bound to the
    runtime's own pool it publishes and hits."""
    from repro_torch.serving import runtime as runtime_mod
    cfg, model, params = dense
    other = PrefixCache(PagedKV(cfg, model, 2, MAX_LEN, block=8,
                                device="cpu"), cfg)
    assert len(other) == 0 and not other
    with pytest.raises(ValueError, match="another pool"):
        _runtime(cfg, params, slots=2, page_block=8, prefix_cache=other)

    pool = PagedKV(cfg, model, 2, MAX_LEN, block=8, device="cpu")
    cache = PrefixCache(pool, cfg)

    class Prebuilt(PagedKV):
        def __new__(cls, *args, **kw):
            return pool           # not a Prebuilt: __init__ is skipped
    monkeypatch.setattr(runtime_mod, "PagedKV", Prebuilt)
    rt = _runtime(cfg, params, slots=2, page_block=8, prefix_cache=cache)
    assert rt.paged is pool and rt.prefix is cache
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    waves = [_prompts(rng, cfg.vocab, 2, prefix) for _ in range(2)]
    outs = [rt.generate([p.copy() for p in w], GEN) for w in waves]
    assert cache.stats.hits == 2 and len(cache) == 2
    monkeypatch.undo()
    _same_outputs(outs[0] + outs[1],
                  _cold(cfg, params, waves[0] + waves[1], slots=2))


# ---------------------------------------------------------------------------
# the obs counters
# ---------------------------------------------------------------------------

def test_prefix_counters_through_the_obs_registry(dense):
    """``prefix_cache.hits`` / ``.hit_tokens`` / ``.misses`` /
    ``.inserted`` / ``.evicted`` count what the stats count, and nothing
    while the registry is disabled."""
    cfg, model, _ = dense
    reg = P_obs.MetricsRegistry()
    old = P_obs.set_registry(reg)
    try:
        paged = PagedKV(cfg, model, 2, 32, block=8, device="cpu")
        cache = PrefixCache(paged, cfg)
        tokens = np.arange(20, dtype=np.int32)
        assert paged.ensure(0, 16)
        cache.publish(tokens, 16, 0)
        assert cache.lookup(tokens).length == 16
        assert cache.lookup(tokens[::-1].copy()) is None
        cache.clear()
        want = {"prefix_cache.hits": 1, "prefix_cache.hit_tokens": 16,
                "prefix_cache.misses": 1, "prefix_cache.inserted": 2,
                "prefix_cache.evicted": 2}
        snap = reg.snapshot()
        assert {k: snap.total(k) for k in want} == want
        st = cache.stats
        assert (st.hits, st.hit_tokens, st.misses, st.inserted,
                st.evicted) == tuple(want.values())
        with P_obs.disabled():
            assert paged.ensure(0, 16)
            cache.publish(tokens, 16, 0)
            cache.lookup(tokens)
        assert reg.snapshot().total("prefix_cache.hits") == 1
        assert cache.stats.hits == 2
    finally:
        P_obs.set_registry(old)
