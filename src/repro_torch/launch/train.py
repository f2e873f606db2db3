"""End-to-end trainer — PyTorch port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --full --steps 20 --batch 8 --seq 256 \
        --engine ozimmu_h-4:df32:fused --ckpt-dir ckpt

Runs on the CUDA card unless ``--device cpu`` is given (the kernels' plain
versions).  Like the reference it trains the arch's smoke config unless
``--full`` asks for the published one, from random weights drawn from
``--seed``, on the deterministic synthetic pipeline; with ``--ckpt-dir``
it resumes from the latest checkpoint there (one the reference wrote
restores as well) and checkpoints every ``--ckpt-every`` steps and at the
end.  Under an ozimmu engine every contraction of the forward, of the
remat recompute and of the backward runs emulated (``:fused``: through
the split, group-GEMM and epilogue kernels).  ``--mesh`` keeps the
reference's flag and raises until the distributed slice.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs, optim, resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import plan
from repro_torch.data import DataConfig, Pipeline
from repro_torch.launch import steps as S
from repro_torch.obs import tracing


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
    metrics (floats) and wall seconds (the loss read back included)."""
    if mesh is not None:
        raise NotImplementedError("--mesh comes with the distributed slice "
                                  "of the port")
    device = resolve_device(device)
    cfg = configs.get_config(arch, smoke=smoke, engine_spec=engine)
    oz_cfg = cfg.engine.ozimmu_config
    if oz_cfg is not None:
        d = cfg.d_model
        print_fn(f"[train] engine {engine}: "
                 f"{plan.describe_config(oz_cfg, d, d, d)}")
    opt_cfg = optim.OptConfig(lr=lr, warmup_steps=min(20, n_steps // 5 + 1),
                              total_steps=n_steps)
    tcfg = S.TrainConfig(microbatches=microbatches)
    pipe = Pipeline(DataConfig(seq_len=seq_len, global_batch=global_batch,
                               vocab=cfg.vocab, seed=seed))
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None

    gen = torch.Generator(device=device).manual_seed(seed)
    state = S.init_state(cfg, opt_cfg, gen, device)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        print_fn(f"[train] resumed from step {start_step}")
    train_step = S.make_train_step(cfg, opt_cfg, tcfg)

    losses = []
    t0 = time.time()
    with tracing.profile(profile_dir):
        for step in range(start_step, n_steps):
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     pipe.batch_at(step).items()}
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
                ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(n_steps, state, blocking=True)
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
                    help="(comes with the distributed slice)")
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
    _, losses = train(args.arch, smoke=args.smoke, n_steps=args.steps,
                      global_batch=args.batch, seq_len=args.seq,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      microbatches=args.microbatches, engine=args.engine,
                      mesh=args.mesh, seed=args.seed,
                      log_every=args.log_every, lr=args.lr,
                      profile_dir=args.profile_dir, device=args.device)
    k = max(1, len(losses) // 10)
    print(f"[train] first-{k} mean loss {np.mean(losses[:k]):.4f}  "
          f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
