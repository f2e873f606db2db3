"""End-to-end trainer — PyTorch port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --full --steps 20 --batch 8 --seq 256 \
        --engine ozimmu_h-4:df32:fused --ckpt-dir ckpt

Every arch trains (all seven families).  Runs on the CUDA card unless
``--device cpu`` is given (the kernels' plain versions).  Like the
reference it trains the arch's smoke config unless ``--full`` asks for the
published one, from random weights drawn from ``--seed``, on the
deterministic synthetic pipeline: the vlm family's batches carry
``vision_seq`` rows of patch embeddings, the encdec family's ``seq`` rows
of frame embeddings (:func:`data_config`), fed to the device as f32.  With
``--ckpt-dir`` it resumes from the latest checkpoint there (one the
reference wrote restores as well) and checkpoints every ``--ckpt-every``
steps and at the end.  Under an ozimmu engine every contraction of the
forward, of the remat recompute and of the backward runs emulated
(``:fused``: through the split, group-GEMM and epilogue kernels).

``--mesh data=2`` (or ``model=N``, or both) trains on one process a rank,
started by torchrun (``torch.distributed``; gloo when the ranks share a
card or run on the CPU):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --steps 4 --batch 4 --seq 16 --mesh data=2 --device cpu

Each ``data`` rank reads its rows of the global batch, the loss and the
gradients are averaged over ``data``, the AdamW state is split over it
(ZeRO-1) and the checkpoint gathers it whole (rank 0 writes, and a
checkpoint restores onto another mesh); the ranks of a ``model`` line
shard the contractions of an ``@model`` engine.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import plan
from repro_torch.data import DataConfig, Pipeline
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import rule_axes, use_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models.common import ModelConfig
from repro_torch.obs import tracing


def data_config(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                seed: int) -> DataConfig:
    """The pipeline's config for ``cfg``, as the reference's launcher
    builds it: ``vision_seq`` patch rows for the vlm family, ``seq_len``
    frames for encdec, none otherwise."""
    return DataConfig(seq_len=seq_len, global_batch=global_batch,
                      vocab=cfg.vocab, seed=seed,
                      vision_seq=cfg.vision_seq if cfg.family == "vlm"
                      else 0,
                      frames=seq_len if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)


def device_batch(batch, device) -> dict:
    """A pipeline batch on ``device``: the tokens int32, the modality
    inputs f32 (the reference feeds them as ``jnp.asarray`` does)."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.int32 if k == "tokens"
                                      else torch.float32)
            for k, v in batch.items()}


def train(arch: str, *, smoke: bool = True, n_steps: int = 100,
          global_batch: int = 8, seq_len: int = 256,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          microbatches: int = 1, engine: str = "bf16", mesh=None,
          seed: int = 0, log_every: int = 10, lr: float = 3e-3,
          profile_dir: Optional[str] = None, device=None,
          print_fn: Callable = print,
          on_step: Optional[Callable] = None):
    """Train ``arch`` for steps ``[start, n_steps)``; returns ``(state,
    losses)``.  ``on_step(step, metrics, seconds)`` sees every step's
    metrics (floats) and wall seconds (the loss read back included).
    ``mesh``, a mesh spec (``"data=2"``), trains on the ranks of the
    default process group, which it starts (and ends) from torchrun's
    environment unless one is running; the state it returns holds this
    rank's ZeRO-1 slices."""
    with mesh_lib.process_group(mesh, device) as device, \
            contextlib.ExitStack() as stack:
        mesh = mesh_lib.parse_mesh_spec(mesh)
        if mesh is not None:
            stack.enter_context(compat.set_mesh(mesh))
            stack.enter_context(use_rules(mesh_lib.mesh_rules(mesh, arch)))
        return _train(arch, smoke=smoke, n_steps=n_steps,
                      global_batch=global_batch, seq_len=seq_len,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      microbatches=microbatches, engine=engine, mesh=mesh,
                      seed=seed, log_every=log_every, lr=lr,
                      profile_dir=profile_dir, device=device,
                      print_fn=print_fn, on_step=on_step)


def _train(arch, *, smoke, n_steps, global_batch, seq_len, ckpt_dir,
           ckpt_every, microbatches, engine, mesh, seed, log_every, lr,
           profile_dir, device, print_fn, on_step):
    """:func:`train` on ``device`` under the installed ``mesh`` (or
    none).  Only rank 0 prints."""
    if mesh is not None and mesh.rank != 0:
        print_fn = lambda *a, **kw: None
    cfg = configs.get_config(arch, smoke=smoke, engine_spec=engine)
    oz_cfg = cfg.engine.ozimmu_config
    if oz_cfg is not None:
        d = cfg.d_model
        print_fn(f"[train] engine {engine}: "
                 f"{plan.describe_config(oz_cfg, d, d, d)}")
    opt_cfg = optim.OptConfig(lr=lr, warmup_steps=min(20, n_steps // 5 + 1),
                              total_steps=n_steps)
    tcfg = S.TrainConfig(microbatches=microbatches)
    _, hosts, host = rule_axes("batch")
    pipe = Pipeline(data_config(cfg, seq_len=seq_len,
                                global_batch=global_batch, seed=seed),
                    host_id=host, num_hosts=hosts)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if mesh is not None:
        backend = dist.get_backend() if dist.is_initialized() \
            else "one process"
        print_fn(f"[train] mesh {mesh.shape} over {compat.world()[1]} "
                 f"ranks ({backend}, {device}): {global_batch // hosts} "
                 f"rows of a batch a rank; rank 0 prints")

    gen = torch.Generator(device=device).manual_seed(seed)
    zero = mesh.shape.get("data", 1) if mesh is not None else 1
    state = S.init_state(cfg, opt_cfg, gen, device, zero_divisor=zero)
    opt_axes = S.state_axes(state.params, zero)
    shardings = S.state_shardings(state, opt_axes)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state, shardings=shardings)
        print_fn(f"[train] resumed from step {start_step}")
    train_step = S.make_train_step(cfg, opt_cfg, tcfg, opt_axes=opt_axes)

    losses = []
    t0 = time.time()
    with tracing.profile(profile_dir):
        for step in range(start_step, n_steps):
            t_step = time.perf_counter()
            batch = device_batch(pipe.batch_at(step), device)
            state, metrics = train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            losses.append(metrics["loss"])
            if on_step is not None:
                on_step(step, metrics, time.perf_counter() - t_step)
            if step == start_step and len(plan.get_ledger()):
                # the first step ran every contraction: the ledger holds
                # one row per auto-k decision of the step
                print_fn(f"[train] planner: {plan.get_ledger().describe()}")
            if log_every and (step + 1) % log_every == 0:
                dt = (time.time() - t0) / log_every
                print_fn(f"[train] step {step + 1:5d}  "
                         f"loss {losses[-1]:.4f}  "
                         f"gnorm {metrics['grad_norm']:.3f}  "
                         f"lr {metrics['lr']:.2e}  "
                         f"{dt * 1e3:.0f} ms/step")
                t0 = time.time()
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state, shardings=shardings)
    if ckpt:
        ckpt.save(n_steps, state, blocking=True, shardings=shardings)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--engine", "--matmul_engine", dest="engine",
                    default="bf16",
                    help="matmul engine spec, e.g. bf16, f32 or "
                         "ozimmu_h-4:df32:fused")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. 'data=2' (the batch split, the "
                         "gradient mean and ZeRO-1 over that many ranks), "
                         "'model=2' (an '@model' engine's contractions) "
                         "or 'data=2,model=2'; one process a rank "
                         "(torchrun); default no mesh (single device)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the training "
                         "loop to DIR/trace.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with mesh_lib.process_group(args.mesh, args.device) as device:
        _, losses = train(args.arch, smoke=args.smoke, n_steps=args.steps,
                          global_batch=args.batch, seq_len=args.seq,
                          ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          microbatches=args.microbatches,
                          engine=args.engine, mesh=args.mesh,
                          seed=args.seed, log_every=args.log_every,
                          lr=args.lr, profile_dir=args.profile_dir,
                          device=device)
        if compat.world()[0] == 0:
            k = max(1, len(losses) // 10)
            print(f"[train] first-{k} mean loss {np.mean(losses[:k]):.4f}  "
                  f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
