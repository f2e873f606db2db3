"""The port's block-paged KV pool (``serving/kvcache.py`` ``PagedKV``)
against the reference's.

What is held, and how tightly:

* ``STATE_DESCRIPTORS`` / ``state_descriptor`` equal to the reference's,
  ``PagedKV.supported`` and the pool's layout (pool leaves ``lead +
  (n_blocks + 1, block) + tail``, resident state leaves) equal for all
  seven smoke archs;
* the host bookkeeping: a seeded soup of ``ensure`` / ``free_slot`` /
  ``share_blocks`` / ``adopt_blocks`` / ``release_blocks`` /
  ``cow_for_write`` on both pools (``PagedKV(cfg, model, 3, 32,
  block=8)``, as ``tests/test_serving.py`` builds it) leaves identical
  tables, allocations, free lists, reference counts and copy counts after
  every operation, returns what the reference returns, and conserves
  blocks;
* the device operations bit for bit on the same pool, tables and cache
  view: ``gather`` (and with ``lengths``: the reference's view with the
  rows at or past each slot's written length zeroed), ``scatter_rows``
  (the trash-block redirect of inactive slots, the per-active-slot state
  merge), ``write_slot_prefix`` (a straight span, a span from a later
  block, a whole wrapped ring) and the copy-on-write block copy, on
  families with the slot at axis 1 (dense, MLA latent), 2 (the vlm's self
  K/V) and both (the hybrid's K/V and conv / LRU states);
* the dense family's paged runtime (a short pool: evictions) against the
  reference's paged runtime, token for token and eviction for eviction;
  the pool's view equal to the monolithic cache after every round of a
  run stepped beside it; the launcher serves ``--page-block 8
  --prefill-chunk 4``, with and without ``--prefix-cache`` (the CI's
  serving smokes' flags), for the three archs those smokes run; the prefix
  cache without ``page_block`` raises, and so does the launcher's
  ``--mesh`` over a data axis, naming its slice.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro.models import api as R_api
from repro.serving import kvcache as R_kv
from repro_torch import configs as P_configs
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kvcache as P_kv

torch.set_num_threads(1)

ARCHS = ("internlm2_1_8b", "deepseek_moe_16b", "deepseek_v2_236b",
         "llama32_vision_11b", "seamless_m4t_medium", "mamba2_780m",
         "recurrentgemma_9b")
FUSED = "ozimmu_h-4:df32:fused"


def _models(arch, **kw):
    rcfg = R_configs.get_config(arch, smoke=True, **kw)
    pcfg = P_configs.get_config(arch, smoke=True, **kw)
    return rcfg, R_api.get_model(rcfg), pcfg, P_api.get_model(pcfg)


def _pools(arch, n_slots=3, max_len=32, block=8, n_blocks=None):
    """The reference's and the port's pool over the same config; state
    leaves from each package's zero single-slot template."""
    rcfg, rm, pcfg, pm = _models(arch)
    rtpl = pm_tpl = None
    if "state" in R_kv.state_descriptor(rcfg).values():
        rtpl = rm.init_cache(rcfg, 1, max_len)
        pm_tpl = pm.init_cache(pcfg, 1, max_len, device="cpu")
    ref = R_kv.PagedKV(rcfg, rm, n_slots, max_len, block=block,
                       n_blocks=n_blocks, template=rtpl)
    port = P_kv.PagedKV(pcfg, pm, n_slots, max_len, block=block,
                        n_blocks=n_blocks, template=pm_tpl, device="cpu")
    return ref, port


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _same(port, ref, what):
    a, b = _np(port), _np(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _fill(ref, port, rng):
    """The same random values in both pools and both state dicts (each
    leaf's values exact in its dtype)."""
    for side in ("pool", "state"):
        rd, pd = getattr(ref, side), getattr(port, side)
        for name in list(rd):
            x = rng.standard_normal(rd[name].shape).astype(np.float32)
            r = jnp.asarray(x).astype(rd[name].dtype)
            rd[name] = r
            pd[name] = torch.from_numpy(_np(r).copy()).to(pd[name].dtype)


def _bookkeeping_equal(ref, port):
    np.testing.assert_array_equal(port.tables, ref.tables)
    np.testing.assert_array_equal(port.allocated, ref.allocated)
    np.testing.assert_array_equal(port.refcount, ref.refcount)
    assert port.free_blocks == ref.free_blocks
    assert port.cow_copies == ref.cow_copies
    assert port.live_blocks + port.free_block_count == port.n_blocks


# ---------------------------------------------------------------------------
# descriptors, support, layout
# ---------------------------------------------------------------------------

def test_state_descriptors_equal_reference():
    assert P_kv.STATE_DESCRIPTORS == R_kv.STATE_DESCRIPTORS
    from repro_torch import serving
    assert serving.STATE_DESCRIPTORS is P_kv.STATE_DESCRIPTORS
    assert serving.state_descriptor is P_kv.state_descriptor
    for arch in ARCHS:
        cfg = P_configs.get_config(arch, smoke=True)
        assert P_kv.state_descriptor(cfg) == R_kv.state_descriptor(
            R_configs.get_config(arch, smoke=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_supported_and_layout_match_reference(arch):
    """``supported`` agrees at two cache lengths (the hybrid's window of
    32 caps its ring at 48), and the pools have the reference's paged and
    state leaves, shapes, dtypes, sequence length and block count."""
    rcfg, rm, pcfg, pm = _models(arch)
    for max_len in (32, 48):
        assert P_kv.PagedKV.supported(pcfg, pm, max_len) == \
            R_kv.PagedKV.supported(rcfg, rm, max_len) is True
    ref, port = _pools(arch, max_len=48, block=8)
    assert (port.paged_names, port.state_names) == \
        (ref.paged_names, ref.state_names)
    assert (port.seq_len, port.blocks_per_slot, port.n_blocks) == \
        (ref.seq_len, ref.blocks_per_slot, ref.n_blocks)
    assert port._slot_ax == ref._slot_ax
    for side in ("pool", "state"):
        rd, pd = getattr(ref, side), getattr(port, side)
        assert set(pd) == set(rd)
        for name in rd:
            assert tuple(pd[name].shape) == rd[name].shape, (side, name)
            assert str(pd[name].dtype)[6:] == str(rd[name].dtype), name
    if arch == "mamba2_780m":
        assert port.n_blocks == 0 and not port.pool
        assert port.ensure(0, 40) and port.free_block_count == 0
    if arch == "recurrentgemma_9b":
        assert port.seq_len == 32            # min(max_len, window)


def test_unsupported_family_and_bad_block():
    _, _, pcfg, pm = _models("internlm2_1_8b")
    assert not P_kv.PagedKV.supported(pcfg.with_(family="nope"), pm, 32)
    with pytest.raises(ValueError, match="must divide"):
        P_kv.PagedKV(pcfg, pm, 2, 30, block=8, device="cpu")
    with pytest.raises(ValueError, match="template"):
        _, _, hcfg, hm = _models("recurrentgemma_9b")
        P_kv.PagedKV(hcfg, hm, 2, 32, block=8, device="cpu")


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_bookkeeping_soup_matches_reference(seed):
    """The same seeded operations on both pools; both sides are compared
    after every one (including the raises and the return values), then
    everything is released and every block must be free again."""
    ref, port = _pools("internlm2_1_8b", n_slots=3, max_len=32, block=8)
    rng = np.random.default_rng(seed)
    _fill(ref, port, rng)
    entries = []
    for _ in range(60):
        op = int(rng.integers(0, 6))
        slot = int(rng.integers(0, 3))
        if op == 0:
            length = int(rng.integers(1, 40))
            outs = []
            for p in (ref, port):
                try:
                    outs.append(p.ensure(slot, length))
                except ValueError as e:
                    outs.append(type(e))
            assert outs[0] == outs[1]
        elif op == 1:
            ref.free_slot(slot)
            port.free_slot(slot)
        elif op == 2 and int(ref.allocated[slot]):
            n = int(rng.integers(1, int(ref.allocated[slot]) + 1))
            got = port.share_blocks(slot, n)
            assert got == ref.share_blocks(slot, n)
            entries.append(got)
        elif op == 3 and entries:
            e = entries.pop(int(rng.integers(0, len(entries))))
            ref.release_blocks(e)
            port.release_blocks(e)
        elif op == 4 and entries and int(ref.allocated[slot]) == 0:
            e = entries[int(rng.integers(0, len(entries)))]
            ref.adopt_blocks(slot, e)
            port.adopt_blocks(slot, e)
        elif op == 5 and int(ref.allocated[slot]):
            idxs = sorted({int(i) for i in rng.integers(
                0, int(ref.allocated[slot]), size=2)})
            assert port.cow_for_write(slot, idxs) == \
                ref.cow_for_write(slot, idxs)
        _bookkeeping_equal(ref, port)
    for name in ref.pool:              # the copy-on-write copies too
        _same(port.pool[name], ref.pool[name], name)
    for s in range(3):
        ref.free_slot(s)
        port.free_slot(s)
    for e in entries:
        ref.release_blocks(e)
        port.release_blocks(e)
    _bookkeeping_equal(ref, port)
    assert port.free_block_count == port.n_blocks and port.live_blocks == 0


# ---------------------------------------------------------------------------
# device operations, bitwise
# ---------------------------------------------------------------------------

DEVICE_ARCHS = ("internlm2_1_8b", "deepseek_v2_236b", "llama32_vision_11b",
                "recurrentgemma_9b")


@pytest.mark.parametrize("arch", DEVICE_ARCHS)
def test_device_ops_bitwise(arch):
    """gather, scatter_rows, write_slot_prefix and the copy-on-write copy
    on the same pool, tables and cache view: the port's results equal the
    reference's bit for bit."""
    max_len = 48 if arch == "recurrentgemma_9b" else 32   # a 32-row ring
    ref, port = _pools(arch, n_slots=3, max_len=max_len, block=8,
                       n_blocks=9)
    rng = np.random.default_rng(5)
    _fill(ref, port, rng)
    for slot, length in ((0, 20), (1, 9), (2, 32)):
        assert port.ensure(slot, length) == ref.ensure(slot, length)
    port.free_slot(1)          # a freed block keeps its rows
    ref.free_slot(1)
    assert port.ensure(1, 3) == ref.ensure(1, 3)
    _bookkeeping_equal(ref, port)
    rt_tables = ref.device_tables()
    pt_tables = port.device_tables()

    # gather, and the zeroed rows past each slot's written length
    rview, pview = ref.gather(rt_tables), port.gather(pt_tables)
    for name in rview:
        _same(pview[name], rview[name], f"gather {name}")
    lengths = np.array([17, 0, 40], np.int32)      # 40: the whole ring
    pmasked = port.gather(pt_tables, lengths=torch.from_numpy(lengths))
    seq = np.arange(ref.seq_len)
    for name in ref.paged_names:
        ax = ref._slot_ax[name]
        want = _np(rview[name]).copy()
        keep = seq[None, :] < lengths[:, None]
        shape = (1,) * ax + keep.shape + (1,) * (want.ndim - ax - 2)
        want = np.where(keep.reshape(shape), want, 0)
        _same(pmasked[name], want, f"gather lengths {name}")

    # scatter_rows: a random step's view, one inactive slot (trash)
    step = {}
    for name, leaf in rview.items():
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        step[name] = jnp.asarray(x).astype(leaf.dtype)
    cur = np.array([21, 4, 37], np.int32)          # 37: wraps a 32-row ring
    active = np.array([True, False, True])
    ref.scatter_rows(rt_tables, step, jnp.asarray(cur), jnp.asarray(active))
    port.scatter_rows(pt_tables, {n: torch.from_numpy(_np(v).copy()).to(
        port.gather(pt_tables)[n].dtype) for n, v in step.items()},
        torch.from_numpy(cur), torch.from_numpy(active))
    for side in ("pool", "state"):
        for name in getattr(ref, side):
            _same(getattr(port, side)[name], getattr(ref, side)[name],
                  f"scatter_rows {side} {name}")
    if ref.paged_names:       # the inactive slot's row went to the trash
        name = ref.paged_names[0]
        trash = _np(port.pool[name]).take(port.n_blocks,
                                          axis=port._slot_ax[name])
        assert trash.any()

    # write_slot_prefix: straight, from a later block, a whole ring
    pstep = {n: torch.from_numpy(_np(v).copy()).to(
        port.gather(pt_tables)[n].dtype) for n, v in step.items()}
    for slot, length, start in ((0, 20, 0), (0, 20, 9), (2, 32, 0)):
        ref.write_slot_prefix(slot, step, length, start=start)
        port.write_slot_prefix(slot, pstep, length, start=start)
        for name in ref.pool:
            _same(port.pool[name], ref.pool[name],
                  f"write_slot_prefix {slot} {length} {start} {name}")

    # the copy-on-write copy of a shared block
    shared = port.share_blocks(0, 2)
    assert shared == ref.share_blocks(0, 2)
    assert port.cow_for_write(0, [1]) and ref.cow_for_write(0, [1])
    _bookkeeping_equal(ref, port)
    assert port.cow_copies == 1
    for name in ref.pool:
        _same(port.pool[name], ref.pool[name], f"cow {name}")


def test_state_reset_snapshot_restore():
    """The state leaves' admission reset (from the template), snapshot and
    restore touch one slot on its own axis, as the reference's do."""
    ref, port = _pools("recurrentgemma_9b", n_slots=3, max_len=32)
    _fill(ref, port, np.random.default_rng(3))
    snap_r, snap_p = ref.snapshot_state(1), port.snapshot_state(1)
    for name in snap_r:
        _same(snap_p[name], snap_r[name], f"snapshot {name}")
    ref.reset_state_slot(1)
    port.reset_state_slot(1)
    for name in ref.state:
        _same(port.state[name], ref.state[name], f"reset {name}")
        assert not _np(port.state[name]).take(
            1, axis=port._slot_ax[name]).any()
    ref.restore_state(1, snap_r)
    port.restore_state(1, snap_p)
    for name in ref.state:
        _same(port.state[name], ref.state[name], f"restore {name}")


# ---------------------------------------------------------------------------
# the dense runtime against the reference's paged runtime
# ---------------------------------------------------------------------------

def test_dense_paged_runtime_matches_reference_paged_runtime():
    """internlm2-1.8b ``smoke()`` in f32 activations, 2 slots, max_len 32,
    blocks of 8, a pool of 4 blocks (6 would hold both slots), chunks of
    3: the port's runtime (``:fused``) gives the reference's paged
    runtime's tokens (``ozimmu_h-4:df32``) and the same evictions, and its
    blocks are all free at the end."""
    from repro.serving import ServingRuntime as RRuntime
    from repro_torch.serving import ServingRuntime
    rcfg = R_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec="ozimmu_h-4:df32",
                                dtype="float32")
    pcfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                                engine_spec=FUSED, dtype="float32")
    rparams, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    nparams = jax.tree.map(np.asarray, rparams)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, size=n, dtype=np.int32)
               for n in (14, 13, 15)]
    kw = dict(slots=2, max_len=32, page_block=8, page_blocks=4,
              prefill_chunk=3)
    rrt = RRuntime(rcfg, rparams, **kw)
    refs = rrt.generate([p.copy() for p in prompts], 8)
    prt = ServingRuntime(pcfg, params_from_numpy(nparams, device="cpu"),
                         device="cpu", **kw)
    outs = prt.generate([p.copy() for p in prompts], 8)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert len({int(t) for o in outs for t in o[-8:]}) > 6   # not an echo
    got, want = prt.metrics.summary(), rrt.metrics.summary()
    assert got["evictions"] == want["evictions"] > 0
    assert got["prefill_chunks"] == want["prefill_chunks"]
    assert prt.paged.free_block_count == prt.paged.n_blocks == 4
    assert prt.cache is None


def test_prefix_cache_raises_naming_its_slice():
    """The prefix cache is ported (``--prefix-cache`` serves, see
    ``test_launcher_serves_paged``) and raises only without a pool; the
    launcher's paged pool and prefix cache under a ``--mesh`` data axis
    (the batch split serves monolithic, ``tests/test_torch_mesh.py``)
    raise, naming what is left, before any process group or model is
    built.  ``--metrics-json`` and
    ``--profile-dir`` serve (``tests/test_torch_obs_serving.py``)."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingRuntime
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True)
    params = P_api.get_model(cfg).init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="requires page_block"):
        ServingRuntime(cfg, params, slots=2, max_len=16, prefix_cache=True,
                       device="cpu")
    with pytest.raises(NotImplementedError,
                       match="paged pool and the prefix cache are not "
                             "split over the data batch ranks"):
        serve.main(["--page-block", "8", "--prefix-cache", "--mesh",
                    "data=2", "--device", "cpu"])


def test_paged_view_is_the_monolithic_cache():
    """Stepped side by side with the same chunking and a full pool (so the
    same schedule), the pool's view of every occupied slot (``gather``
    with the slot's written length) equals the monolithic runtime's cache
    rows after every scheduler round, bit for bit: the rows not yet
    written zeros in both."""
    from repro_torch.serving import ServingRuntime
    cfg = P_configs.get_config("internlm2_1_8b", smoke=True,
                               engine_spec=FUSED)
    params = P_api.get_model(cfg).init(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(6)
    kw = dict(slots=2, max_len=16, prefill_chunk=3, device="cpu")
    mono = ServingRuntime(cfg, params, **kw)
    paged = ServingRuntime(cfg, params, page_block=4, **kw)
    for n in (5, 7, 6):
        p = rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
        mono.submit(p.copy(), 4)
        paged.submit(p.copy(), 4)
    rounds = 0
    while mono.step():
        assert paged.step()
        rounds += 1
        slots = [(i, s.pos if s.prefill_done else s.prefilled)
                 for i, s in enumerate(paged.sched.slots) if not s.free]
        assert slots == [(i, s.pos if s.prefill_done else s.prefilled)
                         for i, s in enumerate(mono.sched.slots)
                         if not s.free]
        written = np.zeros((2,), np.int32)
        for i, n in slots:
            written[i] = n
        view = paged.paged.gather(paged.paged.device_tables(),
                                  lengths=torch.from_numpy(written))
        for i, n in slots:
            for name in ("k", "v"):
                got, want = view[name][:, i], mono.cache[name][:, i]
                assert torch.equal(got, want), (rounds, i, name)
                assert want[:, n:].abs().sum() == 0 < want[:, :n].abs().sum()
    assert not paged.step() and rounds > 5
    assert [r.generated for r in paged.sched.finished] == \
        [r.generated for r in mono.sched.finished]


LAUNCH_ARCHS = ("internlm2_1_8b", "mamba2_780m", "seamless_m4t_medium")


@pytest.mark.parametrize(
    "arch,prefix",
    [pytest.param(a, False, id=a) for a in LAUNCH_ARCHS]
    + [pytest.param(a, True, id=f"{a}-prefix-cache") for a in LAUNCH_ARCHS])
def test_launcher_serves_paged(arch, prefix, capsys):
    """``python -m repro_torch.launch.serve --page-block 8
    --prefill-chunk 4`` serves each arch on the CPU, and with
    ``--prefix-cache`` too (the CI's serving smokes' exact flags; prompts
    of 10 publish 8 tokens, but the launcher's random prompts share no
    prefix, so nothing hits)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--slots", "2", "--requests", "3",
            "--prompt-len", "10" if prefix else "6", "--gen", "3",
            "--max-len", "16", "--engine", FUSED, "--page-block", "8",
            "--prefill-chunk", "4", "--device", "cpu"]
    s = serve.main(argv + ["--prefix-cache"] if prefix else argv)
    assert s["requests"]["finished"] == 3 and s["tokens_generated"] == 9
    assert s["prefill_chunks"] > 0 and s["evictions"] == 0
    assert s["split_cache"]["weight_split_hit_rate"] == 1.0
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out
    if prefix:
        pc = s["prefix_cache"]
        assert (pc["hits"], pc["misses"], pc["inserted"]) == (0, 3, 3)
        assert "[serve] prefix-cache: hit rate 0.00 (0 prefill tokens " \
            "aliased, 3 entries)" in out
    else:
        assert s["prefix_cache"] is None
