"""Every serving family of the port served from the block-paged KV pool
with chunked prefill gives the tokens of the port's monolithic,
unchunked runtime — the port's counterpart of the reference's
``tests/test_prefix_cache.py::test_family_prefix_chunked_paged_matches_monolithic``
without the prefix cache (a later slice).

Each arch's ``smoke()`` config under ``ozimmu_h-4:df32:fused`` (the
kernels' plain versions), weights from the port's seeded init, 2 slots, 3
requests.  Against vacuous checks: the tied heads (mamba2,
recurrentgemma) scale ``embed`` by 0.05 (at the init's scale greedy
decoding echoes the last token); the context families (vlm, encdec) take
a context drawn from a seed in the place of ``launch.serve.slot_context``'s
zeros (the reference's), the vlm its gates drawn too (the reference's init
makes them zero, and a cross layer the identity), and a second context
must change the paged run's tokens; every run's continuations must vary.

The dense and hybrid cases give the pool fewer blocks than the slots could
hold, so that requests are evicted and re-prefilled (``evictions > 0``);
the hybrid's requests run past its window of 32, so its K/V ring wraps,
in the prefill (a chunk's span rewrites the whole ring) and in decode.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, encdec
from repro_torch.serving import ServingRuntime

torch.set_num_threads(1)

FUSED = "ozimmu_h-4:df32:fused"
EMBED_SCALE = 0.05

# arch -> (max_len, prompt lengths, new tokens, prefill chunk, pool
# blocks of 8 positions or None for the slots' full capacity)
CASES = {
    "internlm2_1_8b": (24, (10, 9, 11), 6, 4, 3),
    "deepseek_moe_16b": (16, (5, 7, 6), 4, 3, None),
    "deepseek_v2_236b": (16, (5, 7, 6), 4, 3, None),
    "llama32_vision_11b": (16, (5, 7, 6), 4, 3, None),
    "seamless_m4t_medium": (16, (5, 7, 6), 4, 3, None),
    "mamba2_780m": (16, (5, 7, 6), 4, 3, None),
    "recurrentgemma_9b": (48, (27, 27, 27), 6, 8, 6),
}


def _model(arch):
    cfg = configs.get_config(arch, smoke=True, engine_spec=FUSED)
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(cfg, generator=gen, device="cpu")
    if cfg.family in ("ssm", "hybrid"):
        params["embed"].mul_(EMBED_SCALE)
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            g = params["groups"]["cross"][name]
            sign = torch.where(torch.rand(g.shape, generator=gen) < 0.5,
                               -1.0, 1.0)
            g.copy_((torch.rand(g.shape, generator=gen) + 0.5) * sign)
    return cfg, params


def _context(cfg, params, rows, seed):
    """``slot_context``'s context with its zero patch embeddings / frames
    drawn N(0, 1) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        return torch.randn((1, cfg.vision_seq, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        with torch.no_grad():
            return encdec.encode(params, cfg, torch.randn(
                (1, rows, cfg.d_model), generator=gen))
    assert serve.slot_context(cfg, params, rows) is None
    return None


@pytest.mark.parametrize("arch", list(CASES))
def test_family_paged_chunked_matches_monolithic(arch):
    max_len, lens, gen, chunk, blocks = CASES[arch]
    cfg, params = _model(arch)
    ctx = _context(cfg, params, 6, seed=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in lens]

    def run(ctx, **kw):
        rt = ServingRuntime(cfg, params, slots=2, max_len=max_len, ctx=ctx,
                            device="cpu", **kw)
        return rt, rt.generate([p.copy() for p in prompts], gen)

    _, refs = run(ctx)
    rt, outs = run(ctx, page_block=8, page_blocks=blocks,
                   prefill_chunk=chunk)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert len({int(t) for o in outs for t in o[-gen:]}) > gen  # not echoes
    s = rt.metrics.summary()
    assert s["requests"]["finished"] == len(prompts)
    assert s["prefill_chunks"] > 0
    paged = rt.paged
    assert rt.cache is None and not rt._decode_select
    assert paged.free_block_count == paged.n_blocks      # all freed
    if blocks is not None:
        assert s["evictions"] > 0
    if cfg.family == "ssm":
        assert paged.n_blocks == 0 and not paged.pool
    if cfg.family == "hybrid":
        assert paged.seq_len == cfg.window == 32
        assert max(lens) + gen > paged.seq_len           # the ring wraps
    if ctx is not None:
        # control: a second context changes the paged run's tokens
        _, other = run(_context(cfg, params, 6, seed=9), page_block=8,
                       page_blocks=blocks, prefill_chunk=chunk)
        assert any(not np.array_equal(a, b) for a, b in zip(other, outs))
