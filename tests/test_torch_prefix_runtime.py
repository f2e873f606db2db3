"""The port's prefix-cached runtime held to the reference's, and the
controls that show its hits read what they adopted (the runtime half of
``tests/test_torch_prefix_cache.py``, in a file of its own so that a test
run spread over workers by file runs the two side by side):

* the dense runtime against the reference's prefix runtime (internlm2
  ``smoke()`` in f32 activations; the port under ``:fused``, the reference
  under ``ozimmu_h-4:df32``): two waves sharing a 19-token prefix on a
  short pool give the same tokens, hits, hit tokens, insertions, entry
  releases and preemptions;
* poisoning controls: values written over an entry's shared blocks (dense)
  or its state snapshot (ssm) after the cold wave change the hit wave's
  tokens, so the equalities of the prefix tests read what a hit adopted.
"""
import numpy as np
import pytest

import jax
import torch

from repro import configs as R_configs
from repro.models import api as R_api
from repro_torch import configs as P_configs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServingRuntime
from tests.test_torch_prefix_cache import (GEN, MAX_LEN, PREFIX_LEN, _cold,
                                           _prompts, _runtime,
                                           _same_outputs)
from tests.torch_parity import FUSED, family_model

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the dense runtime against the reference's prefix runtime
# ---------------------------------------------------------------------------

def test_dense_prefix_runtime_matches_reference_prefix_runtime():
    """internlm2-1.8b ``smoke()`` in f32 activations, 2 slots, blocks of
    8, a pool of 4 (the two slots' prompts need 6), chunks of 4; two waves
    of 3
    share a 19-token prefix: the port's runtime (``:fused``) gives the
    reference's prefix runtime's tokens (``ozimmu_h-4:df32``), prefix
    statistics and preemptions, and its blocks are all free once the
    entries are cleared."""
    from repro.serving import ServingRuntime as RRuntime
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec="ozimmu_h-4:df32",
                                dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=FUSED, dtype="float32")
    rparams, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    nparams = jax.tree.map(np.asarray, rparams)
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, rcfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    waves = [_prompts(rng, rcfg.vocab, 3, prefix) for _ in range(2)]
    kw = dict(slots=2, max_len=MAX_LEN, page_block=8, page_blocks=4,
              prefill_chunk=4, prefix_cache=True)
    rrt = RRuntime(rcfg, rparams, **kw)
    refs = [rrt.generate([p.copy() for p in w], GEN) for w in waves]
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         device="cpu", **kw)
    outs = [prt.generate([p.copy() for p in w], GEN) for w in waves]
    _same_outputs(outs[0] + outs[1], refs[0] + refs[1])
    assert len({int(t) for w in outs for o in w for t in o[-GEN:]}) > GEN
    got, want = prt.metrics.summary(), rrt.metrics.summary()
    keys = ("hits", "misses", "hit_tokens", "inserted", "evicted",
            "entries")
    assert {k: got["prefix_cache"][k] for k in keys} == \
        {k: want["prefix_cache"][k] for k in keys}
    st = prt.prefix.stats
    assert st.hits >= 3 and st.hit_tokens == 16 * st.hits
    assert st.evicted > 0 and got["evictions"] > 0
    assert got["evictions"] == want["evictions"]
    assert got["prefill_tokens"] == want["prefill_tokens"]
    held = {b for e in prt.prefix.entries.values() for b in e.blocks}
    assert prt.paged.live_blocks == len(held)
    prt.prefix.clear()
    assert prt.paged.free_block_count == prt.paged.n_blocks == 4


# ---------------------------------------------------------------------------
# poisoning controls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_780m"])
def test_poisoned_entry_changes_the_hit(arch):
    """After the cold wave, other values written over the longest entry's
    shared blocks (dense) or its state snapshot (ssm) must change the hit
    wave's tokens; untouched, the hit wave gives the monolithic tokens."""
    cfg, params = family_model(arch)
    rng = np.random.default_rng(13)
    prefix = rng.integers(0, cfg.vocab, size=PREFIX_LEN, dtype=np.int32)
    waves = [_prompts(rng, cfg.vocab, 2, prefix) for _ in range(2)]

    def served(poison):
        rt = _runtime(cfg, params, slots=2, page_block=8, prefill_chunk=4,
                      prefix_cache=True)
        cold = rt.generate([p.copy() for p in waves[0]], GEN)
        entry = max(rt.prefix.entries.values(), key=lambda e: e.length)
        assert entry.length == 16
        if poison:
            gen = torch.Generator().manual_seed(14)
            if rt.paged.paged_names:
                ids = torch.tensor(entry.blocks)
                for name in rt.paged.paged_names:
                    leaf = rt.paged.pool[name]
                    ax = rt.paged._slot_ax[name]
                    rows = leaf.index_select(ax, ids)
                    leaf.index_copy_(ax, ids, torch.randn(
                        rows.shape, generator=gen).to(leaf.dtype))
            else:
                for snap in entry.state.values():
                    snap.copy_(torch.randn(snap.shape, generator=gen
                                           ).to(snap.dtype))
        hit = rt.generate([p.copy() for p in waves[1]], GEN)
        st = rt.prefix.stats
        assert st.hits == 2 and st.hit_tokens == 2 * 16
        return cold, hit

    cold, hit = served(False)
    refs = _cold(cfg, params, waves[0] + waves[1], slots=2)
    _same_outputs(cold + hit, refs)
    cold_p, hit_p = served(True)
    _same_outputs(cold_p, cold)
    assert any(not np.array_equal(a, b) for a, b in zip(hit_p, hit))
