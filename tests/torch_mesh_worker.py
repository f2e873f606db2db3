"""Rank bodies of the port's mesh tests (``tests/test_torch_distributed.py``,
``tests/test_torch_mesh.py`` and ``tests/test_torch_train_mesh.py``).

:func:`spawn` starts one process a rank over a gloo group from a file
store under the test's temporary directory, runs a job on every rank and
returns each rank's results.  This module imports torch and
``repro_torch`` only: a spawned child re-imports it, and JAX must not load
there.  Inputs and results travel as ``torch.save`` files of tensors and
plain Python values.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import configs, tree
from repro_torch.core import ozimmu, split_cache
from repro_torch.core.accumulate import DF32
from repro_torch.distributed import collectives, compat
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving import ServingRuntime

DN = (((1,), (0,)), ((), ()))
TIMEOUT_S = 240


def spawn(job: str, world: int, tmp: Path, inputs=None):
    """Run ``JOBS[job]`` on ``world`` ranks; returns the ranks' results in
    rank order.  A rank that raises fails the call with its traceback; a
    run past :data:`TIMEOUT_S` is killed."""
    return start(job, world, tmp, inputs)()


def start(job: str, world: int, tmp: Path, inputs=None):
    """:func:`spawn` without waiting: starts the ranks and returns the
    function that waits for them and returns their results."""
    tmp = Path(tmp)
    torch.save(inputs or {}, tmp / "inputs.pt")
    ctx = torch.multiprocessing.start_processes(
        _main, args=(job, world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S

    def wait():
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"mesh job {job!r} ran past "
                                   f"{TIMEOUT_S} s")
        return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    return wait


def _main(rank: int, job: str, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{tmp}/store",
                              rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        out = JOBS[job](rank, inputs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _counted(fn):
    """``fn()`` and the collectives it ran, by function."""
    collectives.reset_counts()
    out = fn()
    return out, dict(collectives.COUNTS)


def _mm(a, b, spec, **kw):
    return ozimmu.ozimmu_dot_general(a, b, DN, ozimmu.parse_spec(spec), **kw)


def contractions(rank: int, x):
    """Every case of ``tests/test_torch_distributed.py`` on a mesh of the
    world along ``model``: the int32 sweep (with and without a frozen B
    split, f64, the VJP), the df32 bodies, the compensated folds and the
    2^25 cancellation case.  Rank 0 also runs each int32 case unsharded
    (no mesh installed)."""
    mesh = mesh_lib.parse_mesh_spec(f"model={dist.get_world_size()}")
    out = {"int32": {}, "int32_counts": {}, "presplit": {},
           "presplit_counts": {}, "df32": {}, "ref": {}}
    cache = split_cache.SplitCache()
    for spec in x["int32_specs"]:
        a, b = x["a"], x["b"]
        sp_ref = split_cache.presplit_rhs(b, DN, ozimmu.parse_spec(spec))
        if rank == 0:
            out["ref"][spec] = _mm(a, b, spec)
            out["ref"]["presplit " + spec] = _mm(a, b, spec,
                                                 rhs_presplit=sp_ref)
        with compat.set_mesh(mesh):
            out["int32"][spec], out["int32_counts"][spec] = _counted(
                lambda: _mm(a, b, spec))
            sp = cache.get(b, DN, ozimmu.parse_spec(spec))
            out["presplit"][spec], out["presplit_counts"][spec] = _counted(
                lambda: _mm(a, b, spec, rhs_presplit=sp))
    spec = x["f64_spec"]
    if rank == 0:
        out["ref"]["f64"] = _mm(x["a64"], x["b64"], spec)
    with compat.set_mesh(mesh):
        out["f64"] = _mm(x["a64"], x["b64"], spec)
    spec = x["vjp_spec"]

    def grads(with_mesh: bool):
        a = x["a"].clone().requires_grad_()
        b = x["b"].clone().requires_grad_()
        with compat.set_mesh(mesh) if with_mesh else \
                contextlib.nullcontext():
            ozimmu.ozimmu_matmul(a, b, ozimmu.parse_spec(spec)).backward(
                x["g"])
        return a.grad, b.grad
    if rank == 0:
        out["ref"]["vjp"] = grads(False)
    (out["vjp"], out["vjp_counts"]) = _counted(lambda: grads(True))
    for spec in x["df32_specs"]:
        with compat.set_mesh(mesh):
            out["df32"][spec] = _mm(x["a"], x["b"], spec)
    with compat.set_mesh(mesh):
        out["comp32"] = collectives.psum_compensated(x["part32"][rank],
                                                     "model")
        out["comp64"] = collectives.psum_compensated(x["part64"][rank],
                                                     "model")
        # hi = (-1)^r 2^25, lo = 1: a plain f32 sum of hi + lo rounds every
        # partial back to +-2^25 and returns 0; the df32 fold keeps the 4
        hi = torch.tensor([(-1.0) ** rank * 2.0 ** 25])
        lo = torch.ones(1)
        plain = hi + lo
        dist.all_reduce(plain)
        acc = collectives.psum_df32(DF32(hi, lo), "model")
        out["cancel"] = (float(plain[0]), float(acc.hi[0] + acc.lo[0]))
    return out


def _capture_serve(argv):
    """``serve.main(argv)`` and the runtime it served with; the runtime's
    ``fed`` lists the positions each prefill call fed."""
    seen = {}
    make = serve.make_runtime

    def captured(*args, **kw):
        rt = seen["rt"] = make(*args, **kw)
        rt.fed, prefill = [], rt._prefill

        def counted(toks, *rest):
            rt.fed.append(toks.shape[1])
            return prefill(toks, *rest)
        rt._prefill = counted
        return rt
    serve.make_runtime = captured
    try:
        s = serve.main(argv)
    finally:
        serve.make_runtime = make
    return s, seen["rt"]


def _tokens(rt):
    return [list(r.generated) for r in
            sorted(rt.sched.finished, key=lambda r: r.rid)]


def served_run(argv):
    """``serve.main(argv)``: its tokens, its model calls (prefill calls
    and decode steps) and model steps (a position a prefill call feeds, or
    a decode step), its data-axis collectives."""
    collectives.reset_counts()
    s, rt = _capture_serve(argv)
    return {"tokens": _tokens(rt), "finished": s["requests"]["finished"],
            "model_calls": s["prefill_calls"] + s["decode_steps"],
            "model_steps": sum(rt.fed) + s["decode_steps"],
            "data_counts": dict(collectives.DATA_COUNTS)}


def serving(rank: int, x):
    """``serve.main`` single-device and with ``--mesh model=2``; the
    paged + chunked + prefix-cached runtime against the monolithic one
    under the mesh; the batch split: ``--mesh data=2`` and ``pod=2`` on
    ``x["data_argv"]``, the MoE arch under ``data=2`` (its experts'
    tokens exchanged by all-to-all), and what the batch split does not
    serve yet (the paged pool)."""
    out = {}
    s, rt = _capture_serve(x["argv"])
    out["single"] = _tokens(rt)
    s, rt = _capture_serve(x["argv"] + ["--mesh", "model=2"])
    out["mesh"] = _tokens(rt)
    out["mesh_summary"] = {"finished": s["requests"]["finished"],
                           "hit_rate":
                           s["split_cache"]["weight_split_hit_rate"]}
    data_argv = x["data_argv"]
    for axis in ("data", "pod"):
        out[axis] = served_run(data_argv + ["--mesh", f"{axis}=2"])
    moe_argv = x["moe_argv"]
    out["moe"] = served_run(moe_argv + ["--mesh", "data=2"])
    try:
        serve.main(data_argv + ["--page-block", "4", "--mesh", "data=2"])
    except NotImplementedError as e:
        out["paged_data"] = str(e)

    arch, spec = "internlm2_1_8b", x["spec"]
    cfg = configs.get_config(arch, smoke=True, engine_spec=spec)
    mesh = mesh_lib.parse_mesh_spec("model=2")
    gen = torch.Generator().manual_seed(0)
    params = api.get_model(cfg).init(cfg, generator=gen, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, size=9, dtype=np.int32)
    waves = [[np.concatenate([prefix, rng.integers(0, cfg.vocab, size=2,
                                                   dtype=np.int32)])
              for _ in range(3)] for _ in range(2)]
    with compat.set_mesh(mesh), use_rules(mesh_lib.mesh_rules(mesh, arch)):
        cold = ServingRuntime(cfg, params, slots=2, max_len=32,
                              device="cpu")
        out["mono"] = [[o.tolist() for o in cold.generate(
            [p.copy() for p in w], 3)] for w in waves]
        collectives.reset_counts()
        rt = ServingRuntime(cfg, params, slots=2, max_len=32, page_block=4,
                            prefill_chunk=3, prefix_cache=True,
                            device="cpu")
        out["paged"] = [[o.tolist() for o in rt.generate(
            [p.copy() for p in w], 3)] for w in waves]
        out["paged_counts"] = dict(collectives.COUNTS)
        out["prefix"] = {"hits": rt.prefix.stats.hits,
                         "hit_tokens": rt.prefix.stats.hit_tokens,
                         "key_mesh": rt.prefix.key0[-1]}
        out["split_key_mesh"] = split_cache._mesh_key()
    return out


def serving_data_model(rank: int, x):
    """``serve.main`` with ``--mesh data=2,model=2`` under an ``@model``
    engine: the slots split over ``data``, each line's contractions
    sharded over ``model``."""
    return served_run(x["argv"] + ["--mesh", "data=2,model=2"]) | {
        "counts": dict(collectives.COUNTS)}


def moe_a2a(rank: int, x):
    """``moe_ffn_a2a`` on a ``data=2`` mesh, this rank's rows of each
    case (``x["cases"]``: a name -> arch, capacity factor, layer
    parameters, the ranks' inputs): the output and the all-to-alls of the
    forward; for ``x["grad_case"]`` the loss ``sum(y ** 2)`` of this
    rank's rows, its gradients averaged by ``steps.batch_mean`` (and
    before), the all-to-alls of the forward and of the backward, and the
    same loss under non-reentrant ``torch.utils.checkpoint`` with its
    backward (the recompute inside it) on a thread of its own, as
    autograd runs a CUDA backward on a device thread (the CPU's runs on
    the caller's); ``x["fallback"]``'s case with experts the axis does
    not divide, against ``moe_ffn``."""
    from repro_torch.launch import steps as S
    from repro_torch.models import moe as moe_mod
    mesh = mesh_lib.parse_mesh_spec("data=2")
    out = {}

    def cfg_of(case):
        return configs.get_config(case["arch"], smoke=True,
                                  engine_spec=x["spec"], dtype="float32",
                                  capacity_factor=case["cf"],
                                  **case.get("with", {}))
    with compat.set_mesh(mesh), use_rules(mesh_lib.mesh_rules(
            mesh, "deepseek_moe_16b")):
        for name, case in x["cases"].items():
            collectives.reset_counts()
            y = moe_mod.moe_ffn_a2a(case["params"], cfg_of(case),
                                    case["x"][rank])
            out[name] = (y, dict(collectives.DATA_COUNTS))
        case = x["cases"][x["grad_case"]]
        params = tree.tree_map(lambda t: t.clone().requires_grad_(),
                               case["params"])
        # x is an activation: its cotangent takes the dispatch back too
        xr = case["x"][rank].clone().requires_grad_()
        collectives.reset_counts()
        loss = (moe_mod.moe_ffn_a2a(params, cfg_of(case), xr) ** 2).sum()
        fwd = dict(collectives.DATA_COUNTS)
        collectives.reset_counts()
        loss.backward()
        bwd = dict(collectives.DATA_COUNTS)
        own = tree.tree_map(lambda t: t.grad.clone(), params)
        # the mean overwrites the f32 gradients in place
        loss, grads = S.batch_mean(loss.detach(), tree.tree_map(
            lambda t: t.grad, params))
        out["grad"] = {"loss": loss, "grads": grads, "own": own,
                       "fwd": fwd, "bwd": bwd}
        params = tree.tree_map(lambda t: t.clone().requires_grad_(),
                               case["params"])
        collectives.reset_counts()
        loss = (checkpoint(moe_mod.moe_ffn_a2a, params, cfg_of(case),
                           case["x"][rank].clone().requires_grad_(),
                           use_reentrant=False) ** 2).sum()
        raised = []

        def backward():
            try:
                loss.backward()
            except Exception as e:      # reported through the result
                raised.append(f"{type(e).__name__}: {e}")
        thread = threading.Thread(target=backward)
        thread.start()
        thread.join(TIMEOUT_S)
        out["remat_thread"] = {
            "raised": raised, "counts": dict(collectives.DATA_COUNTS),
            "grads": None if raised else tree.tree_map(lambda t: t.grad,
                                                       params)}
        case = x["fallback"]
        cfg = cfg_of(case)
        collectives.reset_counts()
        y = moe_mod.moe_ffn_a2a(case["params"], cfg, case["x"][rank])
        out["fallback"] = (torch.equal(y, moe_mod.moe_ffn(
            case["params"], cfg, case["x"][rank])),
            dict(collectives.DATA_COUNTS))
    return out


def _steps_recorded(fn):
    """``fn()`` with every train step's new parameters recorded (the
    trainer's ``make_train_step`` wrapped): ``(fn(), [params, ...], the
    last step's moments)``."""
    from repro_torch.launch import steps as S
    seen, last = [], []
    make = S.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            seen.append([p.clone() for p in tree.leaves(state.params)])
            last[:] = tree.leaves((state.opt.mu, state.opt.nu))
            return state, metrics
        return recorded
    S.make_train_step = recording
    try:
        return fn(), seen, last
    finally:
        S.make_train_step = make


def training(rank: int, x):
    """The data axis of training on a ``data=2`` mesh: step 0's averaged
    loss and gradients (f32 activations, this rank's rows), the ZeRO-1
    update against the unsharded one on the same gradients, ``train.main``
    with ``--mesh data=2`` (every step's parameters recorded, a
    checkpoint written), the one-process checkpoint restored onto the
    mesh, ``compressed_psum`` on this rank's shards; then ``train.main``
    with ``--mesh model=2`` under an ``@model`` engine, and on rank 0 the
    same runs without a mesh; last the MoE arch on ``data=2``
    (:func:`_moe_training`)."""
    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.optim import compress
    out = {}
    arch = "internlm2_1_8b"
    mesh = mesh_lib.parse_mesh_spec("data=2")
    rules = mesh_lib.mesh_rules(mesh, arch)
    cfg = configs.get_config(arch, smoke=True, engine_spec=x["spec"],
                             dtype="float32")
    params = x["params"]
    rows = len(x["tokens"]) // 2
    mine = {"tokens": x["tokens"][rank * rows:(rank + 1) * rows]}
    with compat.set_mesh(mesh), use_rules(rules):
        own_loss, own_grads = S.loss_and_grads(cfg, params, mine)
        collectives.reset_counts()
        loss, grads = S.batch_mean(own_loss, own_grads)
        out["mean_counts"] = dict(collectives.DATA_COUNTS)
        out["loss"], out["grads"] = float(loss), tree.leaves(grads)

        # ZeRO-1 against the unsharded update, two steps on the same
        # gradients (the second halved)
        ocfg = optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                               master_f32=True)
        axes = S.state_axes(params, 2)
        whole = optim.init(params, ocfg)
        zero = optim.init(params, ocfg, axes)
        out["zero_axes"] = axes
        pw = pz = params
        for scale in (1.0, 0.5):
            g = tree.tree_map(lambda t: t * scale, grads)
            pw, whole, _ = optim.step(g, pw, whole, ocfg)
            collectives.reset_counts()
            pz, zero, _ = optim.step(g, pz, zero, ocfg, axes)
        out["zero_counts"] = dict(collectives.DATA_COUNTS)
        out["zero"] = {"params": (tree.leaves(pw), tree.leaves(pz)),
                       "state": ([optim.zero_slice(t, d) for t, d in zip(
                           tree.leaves((whole.mu, whole.nu, whole.master)),
                           axes * 3)],
                           tree.leaves((zero.mu, zero.nu, zero.master)))}

    # the one-process checkpoint restored onto the mesh
        like = S.TrainState(params, optim.init(params, optim.OptConfig(),
                                               axes),
                            torch.zeros((), dtype=torch.int32))
        restored, step = Checkpointer(x["one_ckpt"]).restore(
            like, shardings=S.state_shardings(like, axes))
        out["restored"] = (step, tree.leaves(restored))

        # compressed_psum on this rank's shards, with error feedback
        err = compress.init_state(x["shards"][rank])
        out["psum"] = []
        collectives.reset_counts()
        for _ in range(3):
            mean, err = compress.compressed_psum(x["shards"][rank], err,
                                                 "data")
            out["psum"].append((mean, err))
        out["psum_counts"] = dict(collectives.COUNTS)

    argv = ["--arch", arch, "--device", "cpu", "--batch", "4", "--seq",
            "16", "--log-every", "0", "--engine", x["spec"]]
    out["train"], out["train_params"], out["train_state"] = \
        _steps_recorded(lambda: train.main(
        argv + ["--steps", "3", "--mesh", "data=2", "--ckpt-dir",
                x["mesh_ckpt"]]))
    out["model"] = train.main(argv[:-1] + [x["spec"] + "@model", "--steps",
                                           "3", "--mesh", "model=2"])
    if rank == 0:
        out["single"] = train.main(argv + ["--steps", "3"])
    out["moe"] = _moe_training(rank, x["moe"])
    return out


def _moe_training(rank: int, x):
    """deepseek-moe-16b's smoke config at ``x["cf"]`` on ``data=2``, its
    experts' tokens exchanged by all-to-all: step 0's averaged loss and
    gradients (f32 activations, this rank's rows) and the all-to-alls of
    the rank's loss and gradients; then ``train.main --mesh data=2`` at
    the same capacity factor, every step's parameters recorded."""
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    arch = "deepseek_moe_16b"
    out = {}
    mesh = mesh_lib.parse_mesh_spec("data=2")
    cfg = configs.get_config(arch, smoke=True, engine_spec=x["spec"],
                             dtype="float32", capacity_factor=x["cf"])
    rows = len(x["tokens"]) // 2
    mine = {"tokens": x["tokens"][rank * rows:(rank + 1) * rows]}
    with compat.set_mesh(mesh), use_rules(mesh_lib.mesh_rules(mesh, arch)):
        collectives.reset_counts()
        loss, grads = S.loss_and_grads(cfg, x["params"], mine)
        out["counts"] = dict(collectives.DATA_COUNTS)
        loss, grads = S.batch_mean(loss, grads)
    out["loss"], out["grads"] = float(loss), tree.leaves(grads)
    get = configs.get_config
    configs.get_config = lambda *a, **kw: get(*a, **kw).with_(
        capacity_factor=x["cf"])
    try:
        out["train"], out["train_params"], _ = _steps_recorded(
            lambda: train.main(["--arch", arch, "--device", "cpu", "--batch",
                                "4", "--seq", "16", "--log-every", "0",
                                "--engine", x["spec"], "--steps", "2",
                                "--mesh", "data=2"]))
    finally:
        configs.get_config = get
    return out


JOBS = {"contractions": contractions, "serving": serving,
        "serving_data_model": serving_data_model, "training": training,
        "moe_a2a": moe_a2a}
