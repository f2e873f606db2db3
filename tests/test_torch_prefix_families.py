"""Every serving family of the port served paged, chunked and
prefix-cached gives the tokens of the port's monolithic, unchunked runtime,
across a cold wave and a hit wave — the port's counterpart of the
reference's
``tests/test_prefix_cache.py::test_family_prefix_chunked_paged_matches_monolithic``.

Each arch's ``smoke()`` config under ``ozimmu_h-4:df32:fused`` (the
kernels' plain versions), the seeded model and context of
``tests/torch_parity.py``, 2 slots, two waves of 3 requests that share
one prefix and end in their own suffix.  Against vacuous checks: every
case must hit at least 3 times, each hit adopting the whole published
length (``hit_tokens == hits * m``); where nothing was evicted the prefill
fed exactly the prompts' tokens less the adopted ones; the continuations
vary; the context families' tokens move with a second context.

* dense: a pool short enough that LRU entries are released under pressure
  (``evicted > 0``);
* hybrid: the shared prefix is longer than the window of 32, so the entry
  holds the whole wrapped K/V ring and a hit's first span write goes
  through the copy-on-write (``cow_copies > 0``; the pool holds a third
  ring for the copies);
* ssm: no paged leaves, so a hit is a state restore alone.

After the waves every block held is an entry's, and every block is free
once the entries are cleared.

The archs run in two files, this one and
``tests/test_torch_prefix_families2.py`` (:data:`SECOND`), so that a
test run spread over workers by file runs the halves side by side.
"""
import numpy as np
import pytest
import torch

from repro_torch.serving import ServingRuntime
from tests.torch_parity import family_context, family_model

torch.set_num_threads(1)

# arch -> (max_len, shared prefix, suffix, new tokens, prefill chunk,
# block, pool blocks or None for the slots' full capacity)
CASES = {
    "internlm2_1_8b": (32, 9, 2, 3, 3, 4, 7),
    "deepseek_moe_16b": (32, 9, 2, 3, 3, 4, None),
    "deepseek_v2_236b": (32, 9, 2, 3, 3, 4, None),
    "llama32_vision_11b": (32, 9, 2, 3, 3, 4, None),
    "seamless_m4t_medium": (32, 9, 2, 3, 3, 4, None),
    "mamba2_780m": (32, 9, 2, 3, 3, 4, None),
    "recurrentgemma_9b": (48, 36, 1, 3, 8, 4, 24),
}
# the archs of tests/test_torch_prefix_families2.py
SECOND = ("seamless_m4t_medium", "recurrentgemma_9b")


def _waves(cfg, prefix_len, suffix_len):
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab, size=prefix_len, dtype=np.int32)
    return [[np.concatenate([prefix, rng.integers(
        0, cfg.vocab, size=suffix_len, dtype=np.int32)]) for _ in range(3)]
        for _ in range(2)]


def check_family(arch):
    """The cold and hit waves of ``arch``, prefix-cached against the
    monolithic runtime (see the module docstring)."""
    max_len, plen, slen, gen, chunk, block, pool = CASES[arch]
    cfg, params = family_model(arch)
    ctx = family_context(cfg, params, 6, seed=2)
    waves = _waves(cfg, plen, slen)

    def run(ctx, **kw):
        rt = ServingRuntime(cfg, params, slots=2, max_len=max_len, ctx=ctx,
                            device="cpu", **kw)
        return rt, [rt.generate([p.copy() for p in w], gen) for w in waves]

    paged_kw = dict(page_block=block, page_blocks=pool,
                    prefill_chunk=chunk, prefix_cache=True)
    _, refs = run(ctx)
    rt, outs = run(ctx, **paged_kw)
    for o, r in zip(outs[0] + outs[1], refs[0] + refs[1]):
        np.testing.assert_array_equal(o, r)
    assert len({int(t) for w in outs for o in w for t in o[-gen:]}) > gen
    s = rt.metrics.summary()
    assert s["requests"]["finished"] == 6
    st = rt.prefix.stats
    m = rt.prefix.max_publish_len(plen + slen)
    assert m == (plen // block) * block
    assert st.hits >= 3 and st.hit_tokens == st.hits * m
    assert s["prefix_cache"]["hits"] == st.hits
    if s["evictions"] == 0:
        total = sum(len(p) for w in waves for p in w)
        assert s["prefill_tokens"] == total - st.hit_tokens
    paged = rt.paged
    held = {b for e in rt.prefix.entries.values() for b in e.blocks}
    assert paged.live_blocks == len(held)
    rt.prefix.clear()
    assert paged.free_block_count == paged.n_blocks and len(rt.prefix) == 0
    if cfg.family == "dense":
        assert st.evicted > 0
    if cfg.family == "ssm":
        assert paged.n_blocks == 0 and not held
    if cfg.family == "hybrid":
        assert m > paged.seq_len == cfg.window == 32
        assert paged.cow_copies > 0
    if ctx is not None:
        # control: a second context changes the prefix-cached tokens
        _, other = run(family_context(cfg, params, 6, seed=9), **paged_kw)
        assert any(not np.array_equal(a, b)
                   for a, b in zip(other[0] + other[1], outs[0] + outs[1]))


@pytest.mark.parametrize("arch", [a for a in CASES if a not in SECOND])
def test_family_prefix_chunked_paged_matches_monolithic(arch):
    check_family(arch)
