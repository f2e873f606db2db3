#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. Build every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the card's name and
   power limit.
2. Each kernel at the main paths' shapes (internlm2-1.8b full width,
   k = 4; decode m = slots, prefill m = slots x prompt length; plus the
   DGEMM shapes) against its plain PyTorch version on the same CUDA
   tensors: bitwise equal, with kernel, plain-version, bound and library
   times.  The group GEMM runs at every main-path shape (the DGEMM's
   4096^3, the decode projections and LM head, batched decode attention
   contractions, a middle m) on the route the wrapper picks, plus both
   routes forced at m = 4..32 (the crossover).  The one-launch split
   (``ops.split_fused``: row maxima, grids, scales and digits) runs on
   decode A rows, the batched attention B operands, the w_gate freeze and
   both DGEMM operands; the one-launch df32 epilogue
   (``scale_accum.scale_accum_chunks``) on the decode contractions' four
   chunk products, and the one-launch Ozaki-II df32 epilogue
   (``scale_accum.scale_accum_const_windows``: ladder fold, windows, fast2
   unscale) on the same decode shapes (one-group windows) and the
   attention's (two-group windows).  deepseek-moe-16b's expert
   contractions at decode add their shapes: the split of the E-batched A
   sides (64 x 8 rows, only the 24 a step fills nonzero) and of the
   bf16-valued expert weight stacks (64 x 2048 x 1408 and back, split
   every step), the skinny group GEMM over a batch of 64, and the df32
   epilogue on their real chunk products.  deepseek-v2-236b's add the
   up-projection of the whole latent cache (96 x 512 x 16384, the large
   route, with ``torch._int_mm`` beside it), the G = 1 attention over
   4 x 128 (slot, head) batches (D 192, Dv 128) and the 160-expert
   contractions (stacks of 160 x 5120 x 1536, their plain versions run in
   expert chunks).  mamba2-780m and recurrentgemma-9b add the tied LM
   heads' B side (the transposed view ``embed.T``, 1536 x 50432 and 4096
   x 256000) and their group GEMM (4 x 4096 x 256000) and epilogue,
   mamba2's ``w_in`` (1536 x 6448: the freeze, the decode A side, the
   group GEMM) and recurrentgemma's MQA contractions (16 query heads of
   256 on a 48-row cache, the large route).  llama-3.2-vision-11b and
   seamless-m4t-medium add theirs: the context-time split and group GEMM
   of the vlm's cross ``wk``/``wv`` (1600 patch rows, and 6400 at 4
   slots, x 4096 -> 1024, the large route, beside ``torch._int_mm``), the
   B split of a cross-attention key chunk (a (1024 x 128) view of the
   padded cross K/V, read through its strides) and its skinny group GEMMs,
   the encoder's contractions at 32 frames (the large route), and the
   df32 epilogue at both LM heads' widths (4 x 128256, 4 x 256256).  The
   six other families' train steps (phase 6b) add theirs
   (:func:`train_family_cases`, built after the other cases are freed):
   the E-batched expert weight cotangents (64 x 2048 x 240 x 1408; 16 x
   5120 x 960 x 1536), the tied heads' input cotangents over the padded
   vocab (2048 x 50432 x 1536, 2048 x 256000 x 4096: two-pair chunks,
   ``torch._int_mm`` beside) and the vlm's cross ``wk``/``wv`` cotangents
   over 8 x 1600 patch rows, each with its splits and df32 epilogue.  The
   group GEMM's, the split's
   and the epilogues' times are device times (CUDA-graph replay; the
   group GEMM's
   B operands rotated past the L2 cache), with the eager per-call time
   beside them.  Near-underflow rows (every split mode) and scales run
   through the split and epilogue kernels, bitwise.  Neither the split's
   nor the epilogues' wrappers may run a PyTorch operation on the card
   besides their output allocations and views (checked under a dispatch
   mode, with the obs layer enabled and no profiler recording).  The
   functional epilogues of ``ops`` (``scale_accum``, ``scale_accum_plain``,
   ``oz2_scale_accum``, ``oz2_scale_accum_plain``, ``oz2_unscale``) equal
   their ``*_update`` hooks bitwise and leave their accumulators as they
   were.  A ``[host]`` line gives the group GEMM wrapper's host us a call
   and the obs layer's: ``ozimmu._record_emulation`` (at most 5 us) and an
   untraced phase scope.
3. DGEMM: ``ozimmu_matmul`` under ``ozimmu_h-8:f64:fused`` at n = 4096,
   error against ``torch.matmul`` in f64, plus a small input that must
   equal the CPU plain-version pipeline bit for bit.
3b. Ozaki-II DGEMM: the same under ``oz2_h-8:f64:fast2:fused`` on the same
   inputs, then once under ``oz2_h-auto:f64:fast2:prob:fused`` (the k the
   planner resolves, and its error).
3c. Sign-magnitude DGEMM: the same as phase 3 under
   ``ozimmu_sm_h-8:f64:fused`` (the group GEMM on the stored digits), with
   the small input bitwise against the CPU for it and for the pairwise
   ``ozimmu_sm_b-4:fused``.
4. Serve: ``ServingRuntime`` on the published internlm2-1.8b config
   (24 layers, random weights from a seed) under ``ozimmu_h-4:df32:fused``
   with the weight split-cache on; the first request's tokens must equal a
   monolithic greedy loop, and the full-width prefill logits must agree
   with the native f32 engine.  Then the same requests again from the
   block-paged KV pool (``serve_paged``: blocks of 16 positions, a pool of
   8 against the 12 the slots could hold, so that requests are evicted and
   re-prefilled, prefill chunks of 8), after the monolithic runtime was
   freed: every request's tokens must equal the monolithic run's, every
   kernel's launches a model step the monolithic run's, and the short pool
   must evict.  Then (``serve_prefix``) 8 requests of 32 tokens whose
   first 24 are one system prompt from the seed, served by a monolithic
   runtime (the reference) and then through the prefix cache over the
   full pool (blocks of 16, chunks of 8): the first wave publishes its
   aligned 16 tokens, the second adopts them.  Every request's tokens and
   the launches a model step must equal the reference run's; the hits,
   hit tokens, positions fed and decode steps must equal a CPU dry run of
   the same schedule (``prefix_dry_run``); the blocks held at the end must
   be the entries', and every block free once they are cleared.
4b. Ozaki-II serve: the same under ``oz2_h-4:df32:fast2:fused``, traced
   as phase 4 is.
4c. Sign-magnitude serve: phase 4 under ``ozimmu_sm_h-4:df32:fused``.
4d. Observability serve (``serve_obs``): ``launch.serve.main`` with the
   CI's observability flags (2 slots, 3 requests of 8 tokens, 4 new,
   blocks of 8, chunks of 4, the prefix cache, ``--metrics-json`` every 2
   rounds, ``--profile-dir``) at the published width (``--full``) under
   ``ozimmu_h-4:df32:fused``: the CI snippet's assertions on the
   document, the periodic dumps, ``decode_observed`` (217 contractions;
   int8 GEMMs the Plan's over the first decode step's contractions, those
   on frozen weights every weight contraction's), the final snapshot's
   Prometheus text lint-clean, every split, group GEMM and epilogue kernel
   launched under its ``ozimmu/split``, ``ozimmu/group_gemm``,
   ``ozimmu/scale_accum`` range of the trace, the exact launches a model
   step; then the same requests with obs off and on in turns (off, on,
   on, off): the same tokens and launches a model step, and ms a model
   step on against off.
5. Flash: the reference's flash entry point ``ops.flash_attention`` at
   internlm2-1.8b's attention width (B 1, L 4096, H 16, KV 8, D 128,
   causal) against the port's ``layers.attention_flash`` (3e-5), and the
   kernel-level forward -> backward chain against autograd of the naive
   oracle (2e-4), both in f32 (the 3xTF32 route); then the same in bf16
   (the wgmma route), held to the bf16 bound against the f32 route's
   results on the same (bf16-rounded) inputs.
6. Train (``train``): internlm2-1.8b as published (24 layers, remat
   blocks of 4, random weights from a seed) trained under
   ``ozimmu_h-4:df32:fused`` at the reference launcher's global batch 8 x
   seq 256 from the synthetic pipeline.  Step 0 in f32 activations
   against the native f32 engine (TF32 off) and the native f64 engine in
   f64 activations (the witness) on the same parameters and batch: the
   loss within 1e-5, every gradient leaf within 1e-3 of its max|g|; the
   native bf16 engine in the emulation's place must not pass these
   limits.  Then ``launch.train.train`` (the published bf16 activations)
   for 4 steps: every loss and grad norm finite, the exact launches a
   step, ms a step, tokens/s and the peak device memory; one more step
   traced by kernel class; on its parameters the emulation within the
   same limits of the f64 witness.
6b. Train the six other families (``train_families``: ``train_moe``,
   ``train_mla_moe``, ``train_ssm``, ``train_hybrid``, ``train_vlm``,
   ``train_encdec``): mamba2-780m, seamless-m4t-medium, deepseek-moe-16b,
   recurrentgemma-9b, llama-3.2-vision-11b and deepseek-v2-236b at their
   published widths, cut in depth only as far as ``train_depth``'s
   predicted peak (``TRAIN_BYTES_A_PARAM`` a parameter, more for a tied
   embedding) and the allocator's reserve force, the cut printed (deepseek-v2's routed experts cut to 16 of 160 as well: one of
   its layers holds 5.1 B parameters); random weights from the seed (the
   tied heads' ``embed`` scaled by 0.05, the vlm's gates drawn); the
   pipeline's batch 8 x seq 256 with the vlm's 1600 patch rows and the
   encdec's 256 frames.  Step 0 in f32 activations under
   ``ozimmu_h-4:df32:fused`` against the native f32 engine (TF32 off):
   the loss within 1e-5, every gradient leaf within 1e-3 of its max|g|,
   the bf16 engine in the emulation's place failing them; for the MoE
   families both runs' expert selections first (flipped (token, choice)
   pairs at most 0.1%, the experts whose routed set differs named and
   left out of the expert leaves); an f64 witness logged for the families
   under 1.5 B parameters.  Then 3 steps through
   ``launch.steps.make_train_step`` in bf16 activations: exact launches
   a step by kernel and route, finite losses and grad norms, ms a step,
   tokens/s and peak memory beside the card's name and power limit, and
   one more step traced by kernel class; the hybrid's RG-LRU sequential
   scan timed alone with its host operations.
7. MoE serve (``serve_moe``): ``ServingRuntime`` on the published
   deepseek-moe-16b config (28 layers, 64 experts top-6 plus 2 shared,
   random weights from a seed) under ``ozimmu_h-4:df32:fused``, after
   every earlier phase freed its model; the depth is cut, and the cut
   logged, only if the predicted peak does not fit the card.  Request 0
   must equal a monolithic greedy loop, the prefill logits agree with the
   native f32 engine (isolated routing flips allowed), and the device
   memory and its peak are logged with a trace by kernel class.
8. MLA serve (``serve_mla``): phase 7 on the published deepseek-v2-236b
   config (d_model 5120, 128 heads of multi-head latent attention over a
   512-wide latent / 64-wide rope-key cache, 160 experts top-6 plus 2
   shared, vocab 102400) after phase 7 freed its model, at the most layers
   ``moe_depth``'s reckoned peak allows (at least 2; the published 60
   hold ~970 GB of f32 weights), the cut logged with its reason.
9. SSM serve (``serve_ssm``): ``ServingRuntime`` on the published
   mamba2-780m config (48 layers, d_model 1536, 48 SSD heads of 64, state
   128, tied head over vocab 50280) under ``ozimmu_h-4:df32:fused``: 8
   requests of 24 / 32 prompt tokens (two exact-length buckets) in
   prefill chunks of 8, so decode steps run beside mid-prefill slots
   (frozen by the runtime's per-slot select).
10. Hybrid serve (``serve_hybrid``): the published recurrentgemma-9b
   (12 (R, R, A) blocks + 2 tail R layers, d_model 4096, MQA 16 heads of
   256 on one KV head, window 2048, GELU d_ff 12288, tied head over vocab
   256000), whole 32-token prompts; its depth is cut, and the cut logged,
   only if ``serve_depth``'s predicted peak does not fit.  Phases 9-10
   check request 0 against the monolithic loop, the f32 prefill logits
   against the native f32 engine (1e-3, every token), that the tied
   head's ``embed.T`` reaches the split uncopied, and log tok/s, TTFT, ms
   a model step, the peak against its prediction and a trace by kernel
   class with the tied head apart.  serve_ssm's requests are served again
   paged (``serve_ssm_paged``, no pool: only the per-slot state
   machinery), checked as ``serve_paged``, and prompts of its lengths
   sharing their first 16 tokens through the prefix cache
   (``serve_ssm_prefix``: a hit restores the state snapshot), checked as
   ``serve_prefix``.
11. Context serves (``serve_encdec``, then ``serve_vlm``): the published
   seamless-m4t-medium (12 encoder + 12 decoder layers, d_model 1024, 16
   heads, GELU d_ff 4096, vocab 256206) and llama-3.2-vision-11b (8 groups
   of 4 self + 1 gated cross layer, d_model 4096, 32/8 heads, d_ff 14336,
   vocab 128256, 1600 patch rows; cut in whole groups, and the cut logged,
   only if ``serve_depth``'s predicted peak does not fit), served through
   ``ServingRuntime`` with a per-slot context drawn from the seed (the
   encoder's output over 32 frames; the patch embeddings) and, for the
   vlm, gates drawn from the seed (the reference's zero gates make every
   cross layer the identity).  Checks as phases 9-10, plus: every group
   GEMM at context time (the runtime's construction, and the encoder) on
   the large route, every one in a step on the skinny route, and a second
   context that must move the prefill logits past the 1e-3 tolerance.
   serve_encdec's requests are served again paged as phase 4's
   (``serve_encdec_paged``: the decoder's self K/V in the pool, the cross
   K/V resident per slot); the vlm's peak leaves no room for it.
12. Mesh (``mesh``, :func:`phase_mesh`), last: two ranks, one process
   each, on ``cuda:0`` over gloo (NCCL refuses two ranks on one device;
   every kernel still runs on the card, gloo stages each collective
   through host memory), started with ``torch.multiprocessing`` (spawn)
   over a file store after the single-device serve of the same requests
   freed its model.  gloo's MAX, int32 SUM and all_gather on CUDA tensors,
   checked and timed; the decode contractions at internlm2-1.8b's width
   (A 4x2048 against the frozen ``w_up`` 2048x8192 and LM head
   2048x92672) under ``ozimmu_h-4:df32:fused@model`` and
   ``oz2_h-4:df32:fast2:fused@model`` bitwise to the single-device result
   (frozen and unfrozen), under ``@model/df32`` bitwise to the plain
   versions on the CPU under the same collectives, the n = 4096 DGEMM
   under ``ozimmu_h-8:f64:fused@model`` bitwise to the single-device one
   and within 1e-8; then ``launch.serve.main`` with ``--mesh model=2`` at
   the published 24 layers (2 slots, 2 requests, prompt 8, 8 new tokens):
   both ranks' tokens equal the single-device run's, the launches a model
   step the single-device run's (265 splits, 868 skinny group GEMMs, 217
   epilogues) and the collectives a model step exact (265 maxima, 217
   int32 sums); ms a model step untraced and the collectives' host share
   from rank 0's trace; then (c) ``launch.serve.main`` with ``--mesh
   data=2`` under ``ozimmu_h-4:df32:fused`` on the same requests (one
   slot a rank, every rank running every model call on its own rows):
   both ranks' tokens equal the single-device run's, the launches a model
   step the single-device run's, no contraction collective and exactly one
   ``all_gather_rows`` of the greedy tokens a model call; each rank's
   first prefill logits against the single-device run's rows (bitwise, or
   within 1e-3 of max|logit|, reported); ms a model step, the peak and
   the host ms a gather a rank.
13. Train mesh (``train_mesh``, :func:`phase_train_mesh`), last: the data
   axis of training.  internlm2-1.8b at its published width, cut in depth
   so that two ranks fit the card (``train_depth`` with ``ranks=2``); the
   single-device step on the whole batch of 8 in this process (the
   witness), freed; then two ranks on ``cuda:0`` over gloo run
   ``launch.train.main`` with ``--mesh data=2`` (4 rows a rank, 3 steps):
   step 0's loss within 1e-5 and the averaged gradients of ``embed``,
   ``lm_head`` and the first and last layers' ``wq`` and ``w_down``
   within 1e-3 of max|g| of the witness's, bitwise equal on both ranks;
   the parameters bitwise equal on both ranks after every step; a rank's
   launches a step exactly ``train_step_launches`` at 4 rows; its
   collectives a step one f32 SUM a gradient leaf and one for the loss,
   one ZeRO-1 ``all_gather`` a leaf; ms a step, the gradient mean's and
   the gathers' host ms and the peak a rank logged.  Then (b) the same
   for deepseek-moe-16b at its published widths (64 experts of 2048 x
   1408, top-6), cut in depth likewise, for 2 steps, its experts' tokens
   exchanged by all-to-all over ``data``: the witness is the one-device
   step 0 on each rank's rows with the scatter path, averaged (the
   per-rank capacity); no expert flips against it; the all-to-alls a step
   exact (six a layer), each one's bytes and host ms logged.

The launch counts of phases 3-8 are zeroed just before each path runs and
read just after; every kernel of a path must have launched, and the group
GEMM must have taken the route assigned to the path (large for the DGEMM
and the MLA up-projections, skinny for the rest of serving). A serve run
must count exactly one split launch per split operand (24 layers x 11 + the
LM head a model step), four group GEMMs per contraction (24 x 9 + 1 a step)
and one df32 epilogue launch per contraction (``scale_accum`` under
group-EF, ``scale_accum_const`` under Ozaki-II, with no ``unscale``); the
MoE serve run 28 x 17 + 1 splits, (28 x 12 + 1) x 4 group GEMMs, all
skinny, and 28 x 12 + 1 epilogues a model step (the expert weights split
every step; the f32 router launches none); the MLA serve run 19 splits, 14
x 4 group GEMMs (the 8 of the latent up-projections on the large route, the
rest skinny) and 14 epilogues a layer, plus the LM head's, a model step;
the SSM serve run 98 splits, 388 group GEMMs (skinny) and 97 epilogues,
the hybrid one 252 splits, 908 group GEMMs (the 96 of the MQA scores and
p@v, 16 A rows, large) and 227 epilogues a model step
(:func:`state_step_launches`; a model step is a position a prefill call
feeds or a decode step); the encdec serve run 193 splits, 580 group GEMMs
and 145 epilogues, the vlm one 457, 1444 and 361 a model step
(:func:`ctx_step_launches`), all skinny;
the train run 1782 splits, 3570 group GEMMs, all large (4 a contraction,
10 for the LM head's input cotangent, whose contraction over the padded
vocab leaves one pair a chunk) and 891 epilogues a step
(:func:`train_step_launches`, which also reckons each train_families
step: mamba2 774 / 1550 / 387, seamless 2190 / 4382 / 1095,
deepseek-moe at 3 layers 300 / 606 / 150, recurrentgemma at 1 pattern
block 152 / 306 / 76, llama-vision at one group 466 / 938 / 233,
deepseek-v2 at 1 layer of 16 experts 120 / 246 / 60, all large); a
serve trace splits the device operations of a step by kernel into split,
group GEMM, epilogue and other.  Phase 2 holds
the flash kernels to their plain versions within the reference's
tolerances in f32 (forward 2e-5, backward 2e-4; lse always f32 and held to
these), a bf16 output within ``2e-2 |y| + min(2e-2, 4e-3 max|y|)`` (the
reference's relative 2e-2, the absolute term scaled to the tensor), and
every other kernel bitwise; every flash case prints its route and must
take its dtype's (bf16 ``wgmma``, f32 ``tf32x3``), and the f32 cases'
bound is at the 3xTF32 rate (495 / 3 TFLOP/s).
The last three lines are the card (``nvidia-smi``), the per-kernel JSON
record and the result JSON.  Exits non-zero without a CUDA card, and when
run outside the repository.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from typing import Optional
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS = 67e12          # outside the tensor cores
F64_FLOPS = 34e12          # outside the tensor cores
BF16_FLOPS = 989e12        # tensor cores, dense
TF32X3_FLOPS = 495e12 / 3  # f32 products as three TF32 tensor-core products

MODEL_SPEC = "ozimmu_h-4:df32:fused"
DGEMM_SPEC = "ozimmu_h-8:f64:fused"
OZ2_MODEL_SPEC = "oz2_h-4:df32:fast2:fused"
OZ2_DGEMM_SPEC = "oz2_h-8:f64:fast2:fused"
OZ2_AUTO_SPEC = "oz2_h-auto:f64:fast2:prob:fused"
SM_MODEL_SPEC = "ozimmu_sm_h-4:df32:fused"
SM_DGEMM_SPEC = "ozimmu_sm_h-8:f64:fused"
SM_PAIRWISE_SPEC = "ozimmu_sm_b-4:fused"
ATTN = dict(B=1, L=4096, H=16, KV=8, D=128)   # internlm2-1.8b attention
# bf16 flash outputs: the reference's relative 2e-2, and an absolute term
# of one bf16 unit roundoff (2^-8) of the tensor's largest value
BF16_RTOL, BF16_ATOL = 2e-2, 4e-3
SLOTS, REQUESTS, PROMPT, GEN = 4, 8, 32, 16
# deepseek-moe-16b at decode: 64 experts, capacity max(8, ...) = 8 a
# step for 4 slots x top-6 (24 of the 64 x 8 buffer rows hold a token)
MOE = dict(E=64, cap=8, d=2048, fe=1408, K=6)
MOE_SLOTS, MOE_REQUESTS, MOE_PROMPT, MOE_GEN = 4, 4, 16, 8
# deepseek-v2-236b at decode (serve_mla, served as serve_moe is): 160
# experts, capacity 8; 128 heads of q/k dim 128 + 64 (nope + rope) and v
# dim 128 over a 512-wide latent
MLA = dict(E=160, cap=8, d=5120, fe=1536, K=6, H=128, dl=512, hd=128, dr=64,
           vd=128)
# the state families' published widths (serve_ssm, serve_hybrid):
# mamba2-780m's d_model, w_in output (2 x 3072 + 2 x 128 + 48) and padded
# vocab; recurrentgemma-9b's d_model, padded vocab and MQA (16 query heads
# of 256 on one KV head)
SSM = dict(d=1536, p_in=6448, V=50432)
HYB = dict(d=4096, V=256000, H=16, hd=256)
# the context families' published widths (serve_vlm, serve_encdec):
# llama-3.2-vision-11b's d_model, cross K/V width (8 KV heads of 128),
# patch rows, key chunk and padded vocab; seamless-m4t-medium's d_model,
# GELU d_ff, heads of 64, padded vocab and encoder frames (the prompt
# length)
VLM = dict(d=4096, kv=1024, Lv=1600, chunk=1024, V=128256, KV=8, hd=128)
ENC = dict(d=1024, f=4096, H=16, hd=64, V=256256, F=32)
# the paged passes (serve, serve_ssm, serve_encdec): the phase's requests
# served again from the block-paged KV pool in blocks of PAGE_BLOCK
# positions, prefill chunks of PAGE_CHUNK, the attention families' pool
# cut to PAGE_POOL blocks of the 12 their 4 slots of max_len 48 could hold
PAGE_BLOCK, PAGE_CHUNK, PAGE_POOL = 16, 8, 8
# the prefix passes (serve_prefix, serve_ssm_prefix): the phase's request
# count and lengths again, their first PREFIX_SHARED[tag] tokens one
# "system prompt" drawn from SEED, served monolithic (the reference) and
# then paged in blocks of PAGE_BLOCK with chunks of PAGE_CHUNK, the slots'
# full pool and the prefix cache: the first wave of SLOTS publishes the
# aligned 16 tokens, the second adopts them
PREFIX_SHARED = {"serve": 24, "serve_ssm": 16}
# internlm2-1.8b training (train): the reference launcher's defaults of
# global batch 8 and seq 256; step 0 and three more
TRAIN = dict(batch=8, seq=256, steps=4)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SIDE = {}


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` without the host's launch cost:
    ``reps`` calls captured into one CUDA graph, replayed between CUDA
    events (after warm-up calls that build the launch plans)."""
    import torch
    # one side stream for every capture: cuBLAS keeps a workspace per
    # stream, so a fresh stream per call would pile them up
    side = _SIDE.setdefault("stream", torch.cuda.Stream())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def same(x, y) -> bool:
    """Bitwise equality (NaN patterns included) of two tensors or tuples."""
    import torch
    if isinstance(x, tuple):
        return all(same(a, b) for a, b in zip(x, y))
    if x.dtype.is_floating_point:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(x.view(bits[x.dtype]), y.view(bits[y.dtype]))
    return torch.equal(x, y)


def close(x, y, tol: float):
    """``(ok, max_abs_err, need)`` of two tensors or tuples.  f32 outputs:
    ``|x - y| <= tol + tol * |y|`` everywhere (equal infinities agree), as
    numpy's ``assert_allclose(rtol=tol, atol=tol)``.  bf16 outputs:
    ``|x - y| <= BF16_RTOL * |y| + min(BF16_RTOL, BF16_ATOL * max|y|)``,
    the absolute term following the tensor's own scale (never looser than
    the reference's 2e-2).  ``need`` is the least ``BF16_ATOL`` that the
    bf16 outputs pass with (None without one)."""
    import torch
    if isinstance(x, tuple):
        res = [close(a, b, tol) for a, b in zip(x, y)]
        needs = [r[2] for r in res if r[2] is not None]
        return (all(r[0] for r in res), max(r[1] for r in res),
                max(needs) if needs else None)
    bf16 = x.dtype == torch.bfloat16
    x, y = x.float(), y.float()
    err = torch.where(x == y, torch.zeros_like(x), (x - y).abs())
    if not bf16:
        return bool((err <= tol + tol * y.abs()).all()), float(err.max()), \
            None
    top = float(y.abs().max())
    ok = bool((err <= BF16_RTOL * y.abs()
               + min(BF16_RTOL, BF16_ATOL * top)).all())
    need = float((err - BF16_RTOL * y.abs()).clamp(min=0).max()) / top
    return ok, float(err.max()), need


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_cases(dev, part="main"):
    """One dict per (kernel, shape) on seeded inputs at the path's shapes:
    ``run``/``plain`` (fresh outputs, for the bitwise check), ``bench``
    (the timed kernel call), ``library`` (a one-call PyTorch yardstick or
    None), and the bytes/operations the function must move/do.  ``part``
    ``"train_families"``: the train_families phase's new shapes alone (a
    second list, built once the first is freed)."""
    import torch
    from repro_torch.core.ozimmu import canonical_lhs, canonical_rhs
    from repro_torch.core.splitting import compute_beta, compute_beta_sm
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.kernels import scale_accum as sa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    d, f, vocab = 2048, 8192, 92672          # padded vocab (multiple of 256)
    f32, f64 = torch.float32, torch.float64
    cases = []

    def add(kernel, label, run, plain, moved, ops_, peak, reps, bench=None,
            library=None, tol=None, no_library=None, graph=False,
            library_exact=False, flash_route=None):
        cases.append(dict(kernel=kernel, label=label, run=run, plain=plain,
                          bench=bench or run, library=library, bytes=moved,
                          ops=ops_, peak=peak, reps=reps, tol=tol,
                          no_library=no_library, graph=graph,
                          library_exact=library_exact,
                          flash_route=flash_route))

    def whole_split(x, k, beta, mode, axis, plain_chunks=1):
        """``(run, plain, bytes)`` of the one-launch split of ``x``: the
        Split's fields as a tuple; bytes read x once and write the digits,
        bases, scales (and gbase).  ``plain_chunks``: the plain version
        runs on that many slices of the leading batch axis, concatenated
        (the split is independent per batch element; a whole 160-expert
        stack's plain temporaries would not fit beside the stack)."""
        def fields(sp):
            return tuple(t for t in (sp.digits, sp.scale, sp.base, sp.gbase)
                         if t is not None)

        def plain():
            if plain_chunks == 1:
                return fields(ops.split_fused_ref(x, k, beta, mode=mode,
                                                  axis=axis))
            parts = [fields(ops.split_fused_ref(xc, k, beta, mode=mode,
                                                axis=axis))
                     for xc in x.chunk(plain_chunks)]
            # digits and scales carry the slice axis first, then the batch
            return tuple(torch.cat(f, dim=1 if i < 2 else 0)
                         for i, f in enumerate(zip(*parts)))
        r = x.shape[-2] if axis == 0 else x.shape[-1]
        rows = math.prod(x.shape[:-2]) * r
        moved = nbytes(x) + k * x.numel() + \
            (k + 1) * rows * x.element_size()
        return (lambda: fields(ops.split_fused(x, k, beta, mode=mode,
                                               axis=axis)),
                plain, moved)

    def split_case(label, shape, dtype, k, axis, reps, dnums=None,
                   live=None, bf16_values=False, plain_chunks=1,
                   lhs_dnums=None, transposed=False, take=None):
        """``dnums``: ``x`` is the attention's KV cache (slots, L, KV, D),
        split as the B operand ``canonical_rhs`` makes of it under these
        dimension numbers: a permuted view, read through its strides.
        ``transposed``: ``x`` is the transposed view of a ``shape[::-1]``
        tensor, as the tied LM head hands ``embed.T`` (vocab, d) -> (d,
        vocab) to the engine, read through its strides.
        ``lhs_dnums``: ``x`` is split as the A operand ``canonical_lhs``
        makes of it (a cotangent contracted over its token axes: a
        transposed view, which the split's wrapper copies to rows).
        ``live``: a (*batch, rows) mask; the other rows are zero, as in
        the MoE dispatch buffer.  ``bf16_values``: bf16 weights cast to
        the compute dtype, as the MoE step splits its expert weights.
        ``take``: ``x`` is ``take`` of the drawn tensor (a view of it),
        before ``dnums`` apply."""
        x = torch.randn(shape[::-1] if transposed else shape, generator=gen,
                        dtype=dtype, device=dev)
        if transposed:
            x = x.T
        if take is not None:
            x = take(x)
        if dnums is not None:
            x = canonical_rhs(x, dnums)[0]
        if lhs_dnums is not None:
            x = canonical_lhs(x, lhs_dnums)[0]
        if live is not None:
            x = x * live[..., None]
        if bf16_values:
            x = x.to(torch.bfloat16).to(dtype)
        beta = compute_beta(x.shape[-1] if axis == 0 else x.shape[-2])
        run, plain, moved = whole_split(x, k, beta, "rn_const", axis,
                                        plain_chunks)
        add("split_fused", label, run, plain, moved, 0.0, F32_FLOPS, reps,
            graph=True)

    def gemm_case(label, m, n, p, k, reps, batch=(), sm=False, route=None,
                  live=None, plain_chunks=1, plain_cols=1, pairs=None):
        """The group g = k + 1 (all k pairs) of split digits, signed or the
        sign-magnitude split's stored digits (slice 0 signed, the others
        unsigned bytes), B K-major as the axis=1 split stores it.  Timed
        with B rotated over copies that exceed the L2 cache, as a serve
        step finds its weights; the library yardstick at m <= 16 is
        torch._int_mm on A padded with zero rows to 32 (outside the timed
        call), which computes the same first m rows.  ``live``: a (*batch,
        m) mask of A's nonzero rows (the MoE dispatch buffer); the bound
        then counts the B bytes of the batch elements with a nonzero row
        and the operations of the nonzero rows, what this data needs.
        ``plain_chunks``: the plain version runs on that many slices of
        the batch, concatenated (its f64 copy of a 160-expert stack's
        digits alone would take 40 GB); ``plain_cols`` on that many
        column blocks of B (a 256000-column LM head's: 33 GB).
        ``pairs``: the (A slice, B slice) pairs of one chunk instead, as a
        contraction whose group-EF limit r is below k runs them."""
        dtype = f64 if k == 8 else f32
        a = torch.randn(batch + (m, n), generator=gen, device=dev,
                        dtype=dtype)
        if live is not None:
            a = a * live[..., None]
        w = torch.randn(batch + (n, p), generator=gen, device=dev,
                        dtype=dtype)
        beta = compute_beta_sm(n) if sm else compute_beta(n)
        mode = "sm" if sm else "rn_const"
        da = ops.split_fused(a, k, beta, mode=mode, axis=0).digits
        db = ops.split_fused(w, k, beta, mode=mode, axis=1).digits
        ia, ib = list(range(k)), list(range(k - 1, -1, -1))  # group g=k+1
        if pairs is not None:
            ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
        ua, ub = [sm and i > 0 for i in ia], [sm and j > 0 for j in ib]
        B, G = math.prod(batch), len(ia)
        copies = [db] + [db.clone() for _ in range(
            math.ceil(128e6 / db.numel()) - 1)]
        turn = iter(range(1 << 62))
        kw = dict(a_unsigned=ua, b_unsigned=ub)
        # the crossover cases name their route (the wrapper's private
        # launch); every other case goes through the public entry point
        call = gg.group_gemm if route is None else \
            functools.partial(gg._launch, which=route)
        library = no_library = None
        if sm:
            no_library = ("torch._int_mm multiplies signed int8 only; the "
                          "unsigned trailing digits have no library call")
        elif batch:
            no_library = "torch._int_mm takes one 2-D product, no batch"
        else:
            a_cat = torch.cat([da[i] for i in ia], dim=-1)
            if m <= 16:   # _int_mm needs m > 16: zero rows, same first m
                a_cat = torch.cat([a_cat, a_cat.new_zeros(
                    (32 - m, a_cat.shape[1]))])
            # B column-major (K-major, as the kernel reads it): the TN form
            # on which cuBLASLt runs its int8 tensor-core kernels
            b_cats = [torch.cat([c[j].transpose(-1, -2) for j in ib],
                                dim=-1).t() for c in copies]
            library = lambda: torch._int_mm(
                a_cat, b_cats[next(turn) % len(b_cats)])[:m]
        live_b = B if live is None else int(live.reshape(B, m).any(-1).sum())
        rows = B * m if live is None else int(live.sum())

        def plain():
            return torch.cat([torch.cat([
                gg.group_gemm_ref(ac, bcc, ia, ib, a_unsigned=ua,
                                  b_unsigned=ub)
                for bcc in bc.chunk(plain_cols, -1)], dim=-1)
                for ac, bc in zip(da.chunk(plain_chunks, 1),
                                  db.chunk(plain_chunks, 1))])
        add("group_gemm", label,
            lambda: call(da, db, ia, ib, **kw), plain,
            G * (B * m * n + live_b * n * p) + 4 * B * m * p,
            2.0 * G * rows * n * p,
            INT8_OPS_PER_S, reps, library=library, no_library=no_library,
            bench=lambda: call(da, copies[next(turn) % len(copies)], ia, ib,
                               **kw),
            graph=True, library_exact=True)

    def underflow_rows(dtype, m, n, g):
        """Rows whose maxima sit near the bottom of the normal range (f32
        1e-36, 4e-37, 1e-37; f64 1e-305, 1e-307) and a subnormal row,
        among ordinary rows: their grids and scale products underflow."""
        maxima = [1e-36, 4e-37, 1e-37] if dtype == f32 else [1e-305, 1e-307]
        x = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
        for i, mx in enumerate(maxima):
            x[i] = x[i] / x[i].abs().max() * mx
        x[len(maxima)] = torch.finfo(dtype).tiny * torch.rand(
            (n,), generator=g, device=dev, dtype=dtype)
        return x

    def underflow_split_case(dtype, mode, axis):
        x = underflow_rows(dtype, 64, 2048,
                           gen)
        x = x if axis == 0 else x.T.contiguous()
        n = x.shape[-1] if axis == 0 else x.shape[-2]
        beta = compute_beta_sm(n) if mode == "sm" else compute_beta(n)
        run, plain, moved = whole_split(x, 6, beta, mode, axis)
        add("split_fused", f"near-underflow rows {str(dtype)[6:]} {mode} "
            f"axis={axis} k=6", run, plain, moved, 0.0, F32_FLOPS, 5)

    def underflow_accum_case(dtype):
        """Scales whose products with the int32 sums fall below the normal
        range, and an accumulator just above it."""
        itype, mant, bias = (torch.int32, 23, 127) if dtype == f32 else \
            (torch.int64, 52, 1023)
        emin = -150 if dtype == f32 else -1050

        def pow2(lo, hi, shape):   # exact normal powers of two 2^[lo, hi)
            e = torch.randint(lo, hi, shape, generator=gen, device=dev)
            return ((e + bias).to(itype) << mant).view(dtype)

        m, p = SLOTS, 8192
        p32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, p), generator=gen,
                            device=dev, dtype=torch.int32)
        srow = pow2(emin // 2, emin // 2 + 20, (m,))
        scol = pow2(emin // 2 - 20, emin // 2 + 2, (p,))
        c = torch.randn((m, p), generator=gen, device=dev, dtype=dtype) * \
            torch.finfo(dtype).tiny * 4
        peak = F64_FLOPS if dtype == f64 else F32_FLOPS
        add("scale_accum_plain", f"near-underflow scales (4x8192) "
            f"{str(dtype)[6:]}",
            lambda: sa.scale_accum_plain(p32, srow, scol, c.clone()),
            lambda: sa.scale_accum_plain_ref(p32, srow, scol, c),
            nbytes(p32, srow, scol) + 2 * nbytes(c), 3.0 * c.numel(), peak,
            20)
        if dtype == f32:
            lo = c * 2.0 ** -20
            add("scale_accum", "near-underflow scales (4x8192) one chunk",
                lambda: sa.scale_accum(p32, srow, scol, c.clone(),
                                       lo.clone()),
                lambda: sa.scale_accum_ref(p32, srow, scol, c, lo),
                nbytes(p32, srow, scol) + 4 * nbytes(c), 24.0 * c.numel(),
                peak, 20)
            prods = [p32] + [torch.randint(
                -2 ** 31, 2 ** 31 - 1, (m, p), generator=gen,
                device=dev, dtype=torch.int32) for _ in range(3)]
            chunks_case("near-underflow scales (4x8192) C=4", prods, srow,
                        scol, 20)

    def flash_cases(label, dtype, *, L=None, window=None, q_offset=0,
                    reps=5):
        """Forward and backward at internlm2-1.8b's attention width on one
        input; the library yardstick is SDPA (K/V expanded to H heads
        beforehand, outside the timed call)."""
        import torch.nn.functional as F
        B, H, KV, D = ATTN["B"], ATTN["H"], ATTN["KV"], ATTN["D"]
        L = L or ATTN["L"]
        group = H // KV
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                       for sh in ((B * H, L, D), (B * KV, L, D),
                                  (B * KV, L, D), (B * H, L, D)))
        kw = dict(group=group, causal=True, window=window,
                  q_offset=q_offset)
        o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
        mask = fa._mask(L, L, L, True, window, q_offset, dev)
        seen = mask.sum(dim=1)
        pairs = B * H * int(torch.where(seen > 0, seen, L).sum())
        fwd_ops = 2.0 * pairs * (2 * D)
        # the route's tensor-core rate: bf16 wgmma, or f32 as 3xTF32
        peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
        q4, ke, ve, do4 = (t.reshape(B, -1, L, D) for t in (
            q, k.repeat_interleave(group, 0), v.repeat_interleave(group, 0),
            do))
        plain_causal = window is None and q_offset == 0
        sdpa_kw = dict(is_causal=True) if plain_causal else \
            dict(attn_mask=mask)
        add("flash_attention_fwd", label,
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            lambda: fa.flash_attention_fwd_ref(q, k, v, **kw),
            nbytes(q, k, v, o, lse), fwd_ops, peak, reps,
            library=lambda: F.scaled_dot_product_attention(q4, ke, ve,
                                                           **sdpa_kw),
            tol=2e-5, flash_route=fa.route(dtype))
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q4, ke, ve))
        out_g = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
        add("flash_attention_bwd", label,
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
            lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
            2 * nbytes(q, k, v) + nbytes(o, lse, do), 2.5 * fwd_ops, peak,
            max(1, reps // 2),
            library=lambda: torch.autograd.grad(out_g, (qg, kg, vg), do4,
                                                retain_graph=True),
            tol=2e-4, flash_route=fa.route(dtype))

    def chunks_case(label, prods, base_a, base_b, reps, beta=7,
                    groups=None):
        """The whole df32 epilogue of a contraction over its chunk
        products (by default groups 2..C+1, one chunk a group, as k = C at
        decode): bytes read the products and write the f32 result once."""
        groups = groups or list(range(2, len(prods) + 2))
        out_bytes = prods[0].numel() * 4
        add("scale_accum", label,
            lambda: sa.scale_accum_chunks(prods, groups, base_a, base_b,
                                          beta),
            lambda: sa.scale_accum_chunks_ref(prods, groups, base_a, base_b,
                                              beta),
            nbytes(*prods, base_a, base_b) + out_bytes,
            24.0 * len(prods) * prods[0].numel(), F32_FLOPS, reps,
            graph=True)

    def decode_chunks_case(m, p, reps, batch=(), what="decode",
                           groups=None):
        g = gen
        n_chunks = len(groups) if groups else 4
        prods = [torch.randint(-2 ** 30, 2 ** 30, batch + (m, p),
                               generator=g, device=dev, dtype=torch.int32)
                 for _ in range(n_chunks)]
        base_a = torch.pow(2.0, torch.randint(-20, 0, batch + (m,),
                                              generator=g, device=dev)).to(f32)
        base_b = torch.pow(2.0, torch.randint(-6, 2, batch + (p,),
                                              generator=g, device=dev)).to(f32)
        lead = f"{batch[0]} x " if batch else ""
        chunks_case(f"{what} ({lead}{m}x{p}) C={n_chunks}", prods, base_a,
                    base_b, reps, groups=groups)

    def windows_case(label, prods, c, bases, reps, beta=7):
        """The whole Ozaki-II df32 epilogue of a contraction over its
        chunk products (groups 2..C+1, one chunk a group, as k = C under
        fast2), ladder windows of ``c`` groups, the fast2 unscale: bytes
        read the products, gbases and bases and write the f32 result
        once."""
        groups = list(range(2, len(prods) + 2))
        out_bytes = prods[0].numel() * 4
        add("scale_accum_const", label,
            lambda: sa.scale_accum_const_windows(prods, groups, c, beta,
                                                 *bases),
            lambda: sa.scale_accum_const_windows_ref(prods, groups, c, beta,
                                                     *bases),
            nbytes(*prods, *bases) + out_bytes,
            24.0 * len(prods) * prods[0].numel(), F32_FLOPS, reps,
            graph=True)

    def decode_windows_case(batch, m, p, c, reps, what):
        """Products of the main path's range (|P| < 2^30), fast2's gbase 2
        and power-of-two bases."""
        g = gen
        prods = [torch.randint(-2 ** 30, 2 ** 30, batch + (m, p),
                               generator=g, device=dev, dtype=torch.int32)
                 for _ in range(4)]
        gbase = torch.full(batch, 2.0, device=dev)
        base_a = torch.pow(2.0, torch.randint(-20, 0, batch + (m,),
                                              generator=g, device=dev)).to(f32)
        base_b = torch.pow(2.0, torch.randint(-6, 2, batch + (p,),
                                              generator=g, device=dev)).to(f32)
        windows_case(f"{what} C=4 c={c} fast2", prods, c,
                     (gbase, gbase.clone(), base_a, base_b), reps)

    def accum_case(kernel, label, m, p, dtype, reps):
        p32 = torch.randint(-2 ** 30, 2 ** 30, (m, p), generator=gen,
                            device=dev, dtype=torch.int32)
        srow = torch.pow(2.0, torch.randint(-40, -20, (m,), generator=gen,
                                            device=dev)).to(dtype)
        scol = torch.pow(2.0, torch.randint(-4, 4, (p,), generator=gen,
                                            device=dev)).to(dtype)
        c = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
        peak = F64_FLOPS if dtype == f64 else F32_FLOPS
        if kernel == "scale_accum":
            lo = c * 2.0 ** -30
            hi_b, lo_b = c.clone(), lo.clone()
            add(kernel, label,
                lambda: sa.scale_accum(p32, srow, scol, c.clone(),
                                       lo.clone()),
                lambda: sa.scale_accum_ref(p32, srow, scol, c, lo),
                nbytes(p32, srow, scol) + 4 * nbytes(c), 24.0 * c.numel(),
                peak, reps,
                bench=lambda: sa.scale_accum(p32, srow, scol, hi_b, lo_b))
        else:
            c_b = c.clone()
            add(kernel, label,
                lambda: sa.scale_accum_plain(p32, srow, scol, c.clone()),
                lambda: sa.scale_accum_plain_ref(p32, srow, scol, c),
                nbytes(p32, srow, scol) + 2 * nbytes(c), 3.0 * c.numel(),
                peak, reps,
                bench=lambda: sa.scale_accum_plain(p32, srow, scol, c_b))

    def const_case(kernel, label, m, p, word, dtype, reps):
        hi = 2 ** 52 if word == torch.int64 else 2 ** 30
        w = torch.randint(-hi, hi, (1, m, p), generator=gen, device=dev,
                          dtype=word)
        s = torch.pow(2.0, torch.randint(-60, -30, (1,), generator=gen,
                                         device=dev)).to(dtype)
        c = torch.randn((1, m, p), generator=gen, device=dev, dtype=dtype)
        peak = F64_FLOPS if dtype == f64 else F32_FLOPS
        if kernel == "scale_accum_const":
            lo = c * 2.0 ** -30
            hi_b, lo_b = c.clone(), lo.clone()
            add(kernel, label,
                lambda: sa.scale_accum_const(w, s, c.clone(), lo.clone()),
                lambda: sa.scale_accum_const_ref(w, s, c, lo),
                nbytes(w, s) + 4 * nbytes(c), 22.0 * c.numel(), peak, reps,
                bench=lambda: sa.scale_accum_const(w, s, hi_b, lo_b))
        else:
            c_b = c.clone()
            add(kernel, label,
                lambda: sa.scale_accum_const_plain(w, s, c.clone()),
                lambda: sa.scale_accum_const_plain_ref(w, s, c),
                nbytes(w, s) + 2 * nbytes(c), 3.0 * c.numel(), peak, reps,
                bench=lambda: sa.scale_accum_const_plain(w, s, c_b))

    def unscale_case(label, m, p, dtype, reps):
        x = torch.randn((1, m, p), generator=gen, device=dev, dtype=dtype)
        ra = torch.pow(2.0, torch.randint(-20, 20, (1, m), generator=gen,
                                          device=dev)).to(dtype)
        rb = torch.pow(2.0, torch.randint(-20, 20, (1, p), generator=gen,
                                          device=dev)).to(dtype)
        add("unscale", label, lambda: sa.unscale(x, ra, rb),
            lambda: sa.unscale_ref(x, ra, rb), nbytes(ra, rb) + 2 * nbytes(x),
            2.0 * x.numel(), F64_FLOPS if dtype == f64 else F32_FLOPS, reps)

    def moe_live_rows(shape=MOE):
        """The (E, cap) rows of the MoE dispatch buffer that a decode step
        fills: each of the slots' tokens picks K distinct experts and
        takes the next free row of each expert's queue."""
        E, cap = shape["E"], shape["cap"]
        live = torch.zeros((E, cap), dtype=torch.bool, device=dev)
        fill = [0] * E
        for _ in range(MOE_SLOTS):
            for e in torch.randperm(E, generator=gen,
                                    device=dev)[:shape["K"]].tolist():
                live[e, fill[e]] = True
                fill[e] += 1
        return live

    def moe_chunks_case(label, live, n, p, reps, shape=MOE):
        """The df32 epilogue of one expert contraction on its real chunk
        products: A (E, cap, n) with the dispatch buffer's zero rows and B
        (E, n, p) bf16-valued weights, split and multiplied group by group
        (k = 4: groups 2..5) as the pipeline does."""
        E, cap = shape["E"], shape["cap"]
        a = torch.randn((E, cap, n), generator=gen, device=dev) * \
            live[..., None]
        w = torch.randn((E, n, p), generator=gen, device=dev).to(
            torch.bfloat16).to(f32)
        beta = compute_beta(n)
        sa_ = ops.split_fused(a, 4, beta, axis=0)
        sb_ = ops.split_fused(w, 4, beta, axis=1)
        prods = [ops.group_gemm(sa_, sb_, [(i, g - i) for i in range(1, g)
                                           if i <= 4 and g - i <= 4])
                 for g in range(2, 6)]
        base_b = sb_.base
        del w, sb_                    # the B digits: 0.74 GB (MLA: 5 GB)
        chunks_case(label, prods, sa_.base, base_b, reps, beta=beta)

    if part == "train_families":
        train_family_cases(split_case, gemm_case, decode_chunks_case)
        return cases
    ctx = PROMPT + GEN                        # the decode cache length
    split_case("decode A (4x2048) f32 k=4", (SLOTS, d), f32, 4, 0, 50)
    split_case("decode A (4x8192) f32 k=4", (SLOTS, f), f32, 4, 0, 50)
    split_case("prefill A (128x2048) f32 k=4", (SLOTS * PROMPT, d), f32, 4,
               0, 50)
    # the attention's einsums "bkgd,bskd->bkgs" and "bkgs,bskd->bkgd"
    split_case(f"decode scores B (4x8 x 128x{ctx} cache view) f32 k=4 "
               f"axis=1", (SLOTS, ctx, 8, 128), f32, 4, 1, 50,
               dnums=(((3,), (3,)), ((0, 1), (0, 2))))
    split_case(f"decode p@v B (4x8 x {ctx}x128 cache view) f32 k=4 axis=1",
               (SLOTS, ctx, 8, 128), f32, 4, 1, 50,
               dnums=(((3,), (1,)), ((0, 1), (0, 2))))
    split_case("freeze w_gate B (2048x8192) f32 k=4 axis=1", (d, f), f32, 4,
               1, 10)
    split_case("DGEMM A (4096x4096) f64 k=8", (4096, 4096), f64, 8, 0, 5)
    split_case("DGEMM B (4096x4096) f64 k=8 axis=1", (4096, 4096), f64, 8,
               1, 5)
    kv = 1024                                 # 8 KV heads x head_dim 128
    gemm_case("decode lm_head (4x2048x92672) G=4", SLOTS, d, vocab, 4, 10)
    gemm_case("decode wq/wo (4x2048x2048) G=4", SLOTS, d, d, 4, 50)
    gemm_case("decode wk/wv (4x2048x1024) G=4", SLOTS, d, kv, 4, 50)
    gemm_case("decode w_gate/w_up (4x2048x8192) G=4", SLOTS, d, f, 4, 50)
    gemm_case("decode w_down (4x8192x2048) G=4", SLOTS, f, d, 4, 50)
    gemm_case("decode scores (32 x 2x128x48) G=4", 2, 128, PROMPT + GEN, 4,
              50, batch=(SLOTS * 8,))
    gemm_case("decode p@v (32 x 2x48x128) G=4", 2, PROMPT + GEN, 128, 4,
              50, batch=(SLOTS * 8,))
    gemm_case("DGEMM (4096^3) G=8", 4096, 4096, 4096, 8, 5)
    gemm_case("sign-magnitude decode lm_head (4x2048x92672) G=4", SLOTS,
              d, vocab, 4, 10, sm=True)
    gemm_case("sign-magnitude DGEMM (4096^3) G=8", 4096, 4096, 4096, 8, 5,
              sm=True)
    gemm_case("middle m (32x2048x8192) G=4", 32, d, f, 4, 20)
    gemm_case("prefill-sized (128x2048x8192) G=4", SLOTS * PROMPT, d, f, 4,
              20)
    # deepseek-moe-16b's expert contractions at decode (serve_moe): the
    # E-batched A sides with the dispatch buffer's zero rows, the expert
    # weights' B sides split every step, the skinny group GEMMs over a
    # batch of 64 and the df32 epilogue of each contraction
    E, cap, dm, fe = MOE["E"], MOE["cap"], MOE["d"], MOE["fe"]
    live = moe_live_rows()
    nlive = int(live.sum())
    split_case(f"MoE A w_gate/w_up ({E}x{cap}x{dm}, {nlive} rows live) f32 "
               f"k=4", (E, cap, dm), f32, 4, 0, 50, live=live)
    split_case(f"MoE A w_down ({E}x{cap}x{fe}, {nlive} rows live) f32 k=4",
               (E, cap, fe), f32, 4, 0, 50, live=live)
    split_case(f"MoE B w_gate/w_up ({E}x{dm}x{fe}) bf16-valued f32 k=4 "
               f"axis=1", (E, dm, fe), f32, 4, 1, 10, bf16_values=True)
    split_case(f"MoE B w_down ({E}x{fe}x{dm}) bf16-valued f32 k=4 axis=1",
               (E, fe, dm), f32, 4, 1, 10, bf16_values=True)
    gemm_case(f"MoE w_gate/w_up ({E} x {cap}x{dm}x{fe}, {nlive} rows live) "
              f"G=4", cap, dm, fe, 4, 10, batch=(E,), live=live)
    gemm_case(f"MoE w_down ({E} x {cap}x{fe}x{dm}, {nlive} rows live) G=4",
              cap, fe, dm, 4, 10, batch=(E,), live=live)
    moe_chunks_case(f"MoE w_gate/w_up ({E}x{cap}x{fe}) C=4", live, dm, fe, 50)
    moe_chunks_case(f"MoE w_down ({E}x{cap}x{dm}) C=4", live, fe, dm, 50)
    for mm in (4, 8, 16, 32):                 # the crossover, both routes
        for rt in ("skinny", "large"):
            gemm_case(f"crossover {rt} ({mm}x2048x8192) G=4", mm, d, f, 4,
                      20, route=rt)
    for dt in (f32, f64):
        for md in ("bitmask", "rn_const", "sm", "oz2_bitmask_fast2",
                   "oz2_rn_fast2", "oz2_bitmask", "oz2_rn"):
            for ax in (0, 1):
                underflow_split_case(dt, md, ax)
        underflow_accum_case(dt)
    accum_case("scale_accum", "decode lm_head (4x92672) one chunk", SLOTS,
               vocab, f32, 50)
    accum_case("scale_accum", "prefill w_gate (128x8192) one chunk",
               SLOTS * PROMPT, f, f32, 50)
    for width in (vocab, d, f):
        decode_chunks_case(SLOTS, width, 50)
    for width in (vocab, d, f):
        decode_windows_case((), SLOTS, width, 1, 50,
                            f"decode contraction ({SLOTS}x{width})")
    # the attention's contractions (n = 128 and 48): two groups a window
    decode_windows_case((SLOTS * 8,), 2, PROMPT + GEN, 2, 50,
                        f"decode scores (32 x 2x{PROMPT + GEN})")
    decode_windows_case((SLOTS * 8,), 2, 128, 2, 50,
                        "decode p@v (32 x 2x128)")
    accum_case("scale_accum_plain", "DGEMM (4096x4096) f64", 4096, 4096, f64,
               20)
    accum_case("scale_accum_plain", "decode w_gate (4x8192) f32", SLOTS, f,
               f32, 50)
    i32, i64 = torch.int32, torch.int64
    const_case("scale_accum_const", "decode lm_head (4x92672)", SLOTS, vocab,
               i32, f32, 50)
    const_case("scale_accum_const", "(4096x4096)", 4096, 4096, i32, f32, 20)
    const_case("scale_accum_const_plain", "DGEMM (4096x4096) int64 word f64",
               4096, 4096, i64, f64, 20)
    const_case("scale_accum_const_plain",
               "decode lm_head (4x92672) int32 word f32", SLOTS, vocab, i32,
               f32, 50)
    unscale_case("DGEMM (4096x4096) f64", 4096, 4096, f64, 20)
    unscale_case("decode lm_head (4x92672) f32", SLOTS, vocab, f32, 50)
    bf16 = torch.bfloat16
    for dt, name, reps in ((f32, "f32", 5), (bf16, "bf16", 20)):
        flash_cases(f"B1 L4096 H16 KV8 D128 causal {name}", dt, reps=reps)
        flash_cases(f"B1 L4096 H16 KV8 D128 causal window 1024 {name}", dt,
                    window=1024, reps=reps)
        flash_cases(f"B1 L4000 H16 KV8 D128 causal {name} (ragged tiles)",
                    dt, L=4000, reps=reps)
        flash_cases(f"B1 L4096 H16 KV8 D128 causal q_offset -100 {name} "
                    f"(100 fully masked rows)", dt, q_offset=-100, reps=reps)
    # deepseek-v2-236b at decode (serve_mla): the up-projections' A side is
    # the whole latent cache (slots x max_len rows, bf16 values; a step 4
    # positions before the end leaves the last 4 rows of each slot zero),
    # on the large route inside a serve step; the G = 1 attention over
    # 4 x 128 (slot, head) batches, its B sides the fresh 192-wide k and
    # the 128-wide v; and the 160-expert contractions, whose B splits and
    # group GEMMs are held to their plain versions run in 8 expert chunks
    S, Lm = MOE_SLOTS, MOE_PROMPT + MOE_GEN
    H, dl, hd, dr, vd = MLA["H"], MLA["dl"], MLA["hd"], MLA["dr"], MLA["vd"]
    live_lat = (torch.arange(Lm, device=dev) < Lm - 4).expand(S, Lm)
    split_case(f"MLA up-projection A ({S}x{Lm}x{dl} latent cache, "
               f"{int(live_lat.sum())} rows live) bf16-valued f32 k=4",
               (S, Lm, dl), f32, 4, 0, 50, live=live_lat, bf16_values=True)
    gemm_case(f"MLA w_uk/w_uv up-projection ({S * Lm}x{dl}x{H * hd}) G=4",
              S * Lm, dl, H * hd, 4, 20)
    decode_chunks_case(S * Lm, H * hd, 50, what="MLA up-projection")
    split_case(f"MLA decode scores B ({S}x{H} x {hd + dr}x{Lm}, fresh k) "
               f"f32 k=4 axis=1", (S, Lm, H, hd + dr), f32, 4, 1, 50,
               dnums=(((3,), (3,)), ((0, 1), (0, 2))))
    split_case(f"MLA decode p@v B ({S}x{H} x {Lm}x{vd}) f32 k=4 axis=1",
               (S, Lm, H, vd), f32, 4, 1, 50,
               dnums=(((3,), (1,)), ((0, 1), (0, 2))))
    gemm_case(f"MLA decode scores ({S * H} x 1x{hd + dr}x{Lm}) G=4", 1,
              hd + dr, Lm, 4, 50, batch=(S * H,))
    gemm_case(f"MLA decode p@v ({S * H} x 1x{Lm}x{vd}) G=4", 1, Lm, vd, 4,
              50, batch=(S * H,))
    decode_chunks_case(1, Lm, 50, batch=(S * H,), what="MLA decode scores")
    decode_chunks_case(1, vd, 50, batch=(S * H,), what="MLA decode p@v")
    E, cap, dm, fe = MLA["E"], MLA["cap"], MLA["d"], MLA["fe"]
    live = moe_live_rows(MLA)
    nlive = int(live.sum())
    split_case(f"MLA MoE A w_gate/w_up ({E}x{cap}x{dm}, {nlive} rows live) "
               f"f32 k=4", (E, cap, dm), f32, 4, 0, 50, live=live)
    split_case(f"MLA MoE A w_down ({E}x{cap}x{fe}, {nlive} rows live) f32 "
               f"k=4", (E, cap, fe), f32, 4, 0, 50, live=live)
    for n, p, what in ((dm, fe, "w_gate/w_up"), (fe, dm, "w_down")):
        split_case(f"MLA MoE B {what} ({E}x{n}x{p}) bf16-valued f32 k=4 "
                   f"axis=1", (E, n, p), f32, 4, 1, 3, bf16_values=True,
                   plain_chunks=8)
        gemm_case(f"MLA MoE {what} ({E} x {cap}x{n}x{p}, {nlive} rows "
                  f"live) G=4", cap, n, p, 4, 5, batch=(E,), live=live,
                  plain_chunks=8)
        moe_chunks_case(f"MLA MoE {what} ({E}x{cap}x{p}) C=4", live, n, p,
                        50, shape=MLA)
    # internlm2-1.8b's train step (train: global batch 8 x seq 256, T =
    # 2048 tokens, one attention chunk): the A side of a weight cotangent
    # (w_gate's output cotangent contracted over its token axes: a
    # transposed view the wrapper copies to rows) and the B side of an
    # input cotangent (the weight contracted over its output axis: a
    # transposed view read through its strides); the large-route group
    # GEMM at that weight cotangent's shape (8192 x 2048 tokens x 2048)
    # and at the 64-batched (B x KV) attention scores of one chunk; the
    # df32 epilogue at the weight cotangent's output, and at the LM head's
    # input cotangent, whose contraction over the padded vocab (92672)
    # leaves r = 1: ten one-pair chunks
    Bt, Lt = TRAIN["batch"], TRAIN["seq"]
    T, G = Bt * Lt, 16 // 8
    split_case(f"train dW A: w_gate cotangent ({Bt}x{Lt}x{f} -> {f}x{T} "
               f"view) f32 k=4", (Bt, Lt, f), f32, 4, 0, 10,
               lhs_dnums=(((0, 1), (0, 1)), ((), ())))
    split_case(f"train dx B: w_gate ({d}x{f} -> {f}x{d} view) f32 k=4 "
               f"axis=1", (d, f), f32, 4, 1, 10,
               dnums=(((2,), (1,)), ((), ())))
    gemm_case(f"train dW w_gate ({f}x{T}x{d}) G=4", f, T, d, 4, 5)
    gemm_case(f"train scores ({Bt * 8} x {G * Lt}x128x{Lt}) G=4", G * Lt,
              128, Lt, 4, 10, batch=(Bt * 8,))
    decode_chunks_case(f, d, 10, what="train dW w_gate")
    decode_chunks_case(T, d, 10, what="train LM-head dx r=1",
                       groups=[2, 3, 3, 4, 4, 4, 5, 5, 5, 5])
    # the state families at decode (serve_ssm, serve_hybrid): mamba2's
    # w_in (1536 -> 6448) frozen and its decode A side; the tied LM heads'
    # B side, the transposed view embed.T split every step (mamba2 1536 x
    # 50432, recurrentgemma 4096 x 256000), its group GEMM and epilogue;
    # recurrentgemma's MQA (16 query heads on one KV head of 256) against
    # a 48-row cache: 16 A rows, the large route
    for dm, V in ((SSM["d"], SSM["V"]), (HYB["d"], HYB["V"])):
        split_case(f"tied head B (embed.T view {dm}x{V}) f32 k=4 axis=1",
                   (dm, V), f32, 4, 1, 5 if V > 100000 else 20,
                   transposed=True)
    split_case(f"freeze mamba2 w_in B ({SSM['d']}x{SSM['p_in']}) f32 k=4 "
               f"axis=1", (SSM["d"], SSM["p_in"]), f32, 4, 1, 10)
    split_case(f"decode A ({SLOTS}x{SSM['d']}) f32 k=4", (SLOTS, SSM["d"]),
               f32, 4, 0, 50)
    gemm_case(f"decode mamba2 w_in ({SLOTS}x{SSM['d']}x{SSM['p_in']}) G=4",
              SLOTS, SSM["d"], SSM["p_in"], 4, 50)
    gemm_case(f"decode tied head ({SLOTS}x{HYB['d']}x{HYB['V']}) G=4", SLOTS,
              HYB["d"], HYB["V"], 4, 5, plain_cols=16)
    decode_chunks_case(SLOTS, HYB["V"], 50, what="decode tied head")
    hk, G, Lh = HYB["hd"], HYB["H"], PROMPT + GEN
    split_case(f"MQA decode scores B ({SLOTS}x1 x {hk}x{Lh} cache view) f32 "
               f"k=4 axis=1", (SLOTS, Lh, 1, hk), f32, 4, 1, 50,
               dnums=(((3,), (3,)), ((0, 1), (0, 2))))
    split_case(f"MQA decode p@v B ({SLOTS}x1 x {Lh}x{hk} cache view) f32 "
               f"k=4 axis=1", (SLOTS, Lh, 1, hk), f32, 4, 1, 50,
               dnums=(((3,), (1,)), ((0, 1), (0, 2))))
    gemm_case(f"MQA decode scores ({SLOTS} x {G}x{hk}x{Lh}) G=4", G, hk, Lh,
              4, 50, batch=(SLOTS,))
    gemm_case(f"MQA decode p@v ({SLOTS} x {G}x{Lh}x{hk}) G=4", G, Lh, hk, 4,
              50, batch=(SLOTS,))
    decode_chunks_case(G, Lh, 50, batch=(SLOTS,), what="MQA decode scores")
    decode_chunks_case(G, hk, 50, batch=(SLOTS,), what="MQA decode p@v")
    # the context families (serve_vlm, serve_encdec): the vlm's
    # context-time cross wk/wv (the A side of 1600 patch rows; 1600 and,
    # for the 4-slot cache, 6400 rows x 4096 -> 1024 on the large route);
    # at decode the B side of a cross-attention key chunk (the second of
    # 2 chunks of 1024 of the padded 1600-row cross K/V: rows 1600-2047
    # zero; a permuted view read through its strides) and its skinny
    # group GEMMs (4 query heads a KV head); the encoder's contractions
    # at 32 frames (large); the df32 epilogue at both LM heads' widths
    dv, kvw, Lv, kc = VLM["d"], VLM["kv"], VLM["Lv"], VLM["chunk"]
    nk = -(-Lv // kc)
    split_case(f"vlm context A ({Lv}x{dv}) f32 k=4", (Lv, dv), f32, 4, 0,
               20)
    for rows in (Lv, SLOTS * Lv):
        gemm_case(f"vlm context cross wk/wv ({rows}x{dv}x{kvw}) G=4", rows,
                  dv, kvw, 4, 10)
    pad_chunk = (lambda x: torch.cat([x, x.new_zeros(
        (SLOTS, nk * kc - Lv, VLM["KV"], VLM["hd"]))], dim=1).reshape(
        SLOTS, nk, kc, VLM["KV"], VLM["hd"])[:, nk - 1])
    for what, dn, np_ in (
            ("scores", (((3,), (3,)), ((0, 1), (0, 2))),
             f"{VLM['hd']}x{kc}"),
            ("p@v", (((3,), (1,)), ((0, 1), (0, 2))), f"{kc}x{VLM['hd']}")):
        split_case(f"vlm decode cross {what} B ({SLOTS}x{VLM['KV']} x "
                   f"{np_} view of the padded cross K/V) f32 k=4 axis=1",
                   (SLOTS, Lv, VLM["KV"], VLM["hd"]), f32, 4, 1, 50,
                   dnums=dn, take=pad_chunk)
    Gv, bv = 32 // VLM["KV"], SLOTS * VLM["KV"]
    gemm_case(f"vlm decode cross scores ({bv} x {Gv}x{VLM['hd']}x{kc}) G=4",
              Gv, VLM["hd"], kc, 4, 50, batch=(bv,))
    gemm_case(f"vlm decode cross p@v ({bv} x {Gv}x{kc}x{VLM['hd']}) G=4",
              Gv, kc, VLM["hd"], 4, 50, batch=(bv,))
    de, F_ = ENC["d"], ENC["F"]
    split_case(f"encoder A ({F_}x{de}) f32 k=4", (F_, de), f32, 4, 0, 50)
    gemm_case(f"encoder wq ({F_}x{de}x{de}) G=4", F_, de, de, 4, 20)
    gemm_case(f"encoder w_up ({F_}x{de}x{ENC['f']}) G=4", F_, de, ENC["f"],
              4, 20)
    gemm_case(f"encoder scores ({ENC['H']} x {F_}x{ENC['hd']}x{F_}) G=4",
              F_, ENC["hd"], F_, 4, 50, batch=(ENC["H"],))
    for V, what in ((VLM["V"], "vlm"), (ENC["V"], "encdec")):
        decode_chunks_case(SLOTS, V, 50, what=f"decode {what} lm_head")
    return cases


# the case of each kernel that its top-level record reports
MAIN_CASE = {"split_fused": "decode A (4x2048) f32 k=4",
             "group_gemm": "decode lm_head (4x2048x92672) G=4",
             "scale_accum": "decode (4x92672) C=4",
             "scale_accum_plain": "DGEMM (4096x4096) f64",
             "scale_accum_const": "decode contraction (4x92672) C=4 c=1 "
                                  "fast2",
             "scale_accum_const_plain": "DGEMM (4096x4096) int64 word f64",
             "unscale": "DGEMM (4096x4096) f64",
             "flash_attention_fwd": "B1 L4096 H16 KV8 D128 causal f32",
             "flash_attention_bwd": "B1 L4096 H16 KV8 D128 causal f32"}

# the path whose launch count a kernel's record reports
MAIN_PATH = {"split_fused": "serve", "group_gemm": "serve",
             "scale_accum": "serve", "scale_accum_plain": "dgemm",
             "scale_accum_const": "serve_oz2",
             "scale_accum_const_plain": "dgemm_oz2", "unscale": "dgemm_oz2",
             "flash_attention_fwd": "flash", "flash_attention_bwd": "flash"}

# why no single PyTorch call is a library yardstick for a kernel
NO_LIBRARY = {
    "split_fused": "no one PyTorch call extracts k digits",
    "group_gemm": "torch._int_mm takes one signed 2-D product",
    "scale_accum": "no one PyTorch call does the int32 split and TwoSum",
    "scale_accum_plain": "convert and two scalings are separate calls",
    "scale_accum_const": "no one PyTorch call does the int32 split and "
                         "TwoSum",
    "scale_accum_const_plain": "the convert is a call of its own; "
                               "torch.add(c, word, alpha=s) takes s from "
                               "the host and may contract into an FMA",
    "unscale": "a two-sided scaling is two calls (or an outer product "
               "first)",
}

KERNELS = {
    "split_fused": ("src/repro_torch/kernels/csrc/split_fused.cu",
                    "src/repro/kernels/split_fused.py:102"),
    "group_gemm": ("src/repro_torch/kernels/csrc/group_gemm.cu",
                   "src/repro/kernels/group_gemm.py:58"),
    "scale_accum": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                    "src/repro/kernels/scale_accum.py:139"),
    "scale_accum_plain": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                          "src/repro/kernels/scale_accum.py:171"),
    "scale_accum_const": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                          "src/repro/kernels/scale_accum.py:222"),
    "scale_accum_const_plain": ("src/repro_torch/kernels/csrc/"
                                "scale_accum.cu",
                                "src/repro/kernels/scale_accum.py:246"),
    "unscale": ("src/repro_torch/kernels/csrc/scale_accum.cu",
                "src/repro/kernels/scale_accum.py:197"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:86"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:215"),
}


def _drain(cases):
    """Yield and drop the cases one by one, so that each case's tensors
    are freed once it has run."""
    import torch
    while cases:
        yield cases.pop(0)
    torch.cuda.empty_cache()


def train_family_cases(split_case, gemm_case, chunks_case):
    """The train_families phase's kernel shapes that no serve or dense
    train case covers (global batch 8 x seq 256, T = 2048 tokens): the
    E-batched expert weight cotangents (deepseek-moe-16b's 64 experts x
    2048 x 240 capacity rows x 1408, and deepseek-v2-236b's cut to 16
    experts: 16 x 5120 x 960 x 1536): their A side (the output cotangent
    contracted over the capacity rows, a transposed view the wrapper
    copies to rows), B side (the expert hidden rows), group GEMM and df32
    epilogue; the tied heads' input cotangents (the logits' cotangent
    contracted over the padded vocab: r = 2, two-pair chunks; mamba2 2048
    x 50432 x 1536, recurrentgemma 2048 x 256000 x 4096): the cotangent's
    A split, ``embed``'s B split, a two-pair group GEMM and the six-chunk
    epilogue; and the vlm's cross ``wk``/``wv`` cotangents over the
    batch's 8 x 1600 patch rows (input: 12800 x 1024 x 4096; weight: 1024
    x 12800 x 4096, its A side the transposed view of the output
    cotangent)."""
    import torch
    f32 = torch.float32
    Bt, Lt = TRAIN["batch"], TRAIN["seq"]
    T = Bt * Lt
    for E, dm, cap, fe, what in ((MOE["E"], MOE["d"], 240, MOE["fe"], "MoE"),
                                 (16, MLA["d"], 960, MLA["fe"], "MLA MoE")):
        split_case(f"train {what} dW A: w_down cotangent ({E}x{cap}x{dm} -> "
                   f"{E}x{dm}x{cap} view) f32 k=4", (E, cap, dm), f32, 4, 0,
                   5, lhs_dnums=(((1,), (1,)), ((0,), (0,))))
        split_case(f"train {what} dW B: expert hidden ({E}x{cap}x{fe}) f32 "
                   f"k=4 axis=1", (E, cap, fe), f32, 4, 1, 5)
        gemm_case(f"train {what} dW w_down ({E} x {dm}x{cap}x{fe}) G=4", dm,
                  cap, fe, 4, 5, batch=(E,))
        chunks_case(dm, fe, 5, batch=(E,), what=f"train {what} dW w_down")
    for dm, V, what, cols in ((SSM["d"], SSM["V"], "mamba2", 1),
                              (HYB["d"], HYB["V"], "recurrentgemma", 16)):
        split_case(f"train {what} tied head dx A: logits cotangent "
                   f"({T}x{V}) f32 k=4", (T, V), f32, 4, 0, 5)
        split_case(f"train {what} tied head dx B: embed ({V}x{dm}) f32 k=4 "
                   f"axis=1", (V, dm), f32, 4, 1, 5)
        gemm_case(f"train {what} tied head dx ({T}x{V}x{dm}) 2 pairs", T, V,
                  dm, 4, 5, pairs=[(0, 1), (1, 0)], plain_cols=cols)
        chunks_case(T, dm, 5, what=f"train {what} tied head dx r=2",
                    groups=[2, 3, 4, 4, 5, 5])
    dv, kvw, rows = VLM["d"], VLM["kv"], Bt * VLM["Lv"]
    split_case(f"train vlm cross dW A: wk cotangent ({Bt}x{VLM['Lv']}x{kvw} "
               f"-> {kvw}x{rows} view) f32 k=4", (Bt, VLM["Lv"], kvw), f32,
               4, 0, 5, lhs_dnums=(((0, 1), (0, 1)), ((), ())))
    gemm_case(f"train vlm cross dW wk/wv ({kvw}x{rows}x{dv}) G=4", kvw, rows,
              dv, 4, 5)
    gemm_case(f"train vlm cross dx wk/wv ({rows}x{kvw}x{dv}) G=4", rows, kvw,
              dv, 4, 5)
    chunks_case(rows, dv, 5, what="train vlm cross dx")


def phase_kernels(dev):
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    results = {}
    for c in (c for part in ("main", "train_families")
              for c in _drain(kernel_cases(dev, part))):
        before = dict(LAUNCHES)
        out_k, out_p = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        routes = [r for r in ("large", "skinny")
                  if LAUNCHES[f"group_gemm_{r}"] > before[f"group_gemm_{r}"]]
        flash_routes = [r for r in ("wgmma", "tf32x3")
                        if LAUNCHES[f"flash_{r}"] > before[f"flash_{r}"]]
        if c["flash_route"] is not None and \
                flash_routes != [c["flash_route"]]:
            raise AssertionError(f"{c['kernel']} [{c['label']}]: launched on "
                                 f"route(s) {flash_routes}, not "
                                 f"{c['flash_route']}")
        if c["tol"] is None:
            ok, err = same(out_k, out_p), 0.0
            check = "bitwise ok"
        else:
            ok, err, need = close(out_k, out_p, c["tol"])
            check = f"max|diff| {err:.2e} (rtol=atol={c['tol']:.0e}) ok" \
                if need is None else \
                f"max|diff| {err:.2e} (bf16: needs atol {need:.2e}*max|y| " \
                f"<= {BF16_ATOL:.0e}; f32 lse rtol=atol={c['tol']:.0e}) ok"
        if not ok:
            raise AssertionError(f"{c['kernel']} [{c['label']}]: kernel "
                                 f"output differs from the plain version "
                                 f"({'bitwise' if c['tol'] is None else err})")
        if c["library"] is not None and c["library_exact"] and \
                not same(c["library"](), out_p):
            raise AssertionError(f"{c['kernel']} [{c['label']}]: the library "
                                 f"yardstick computes another function")
        del out_k, out_p
        # group GEMM: device times from CUDA-graph replay (its decode calls
        # take less device time than the host needs to launch them), with
        # the eager per-call time beside them
        timer = graph_ms if c["graph"] else time_ms
        ms = timer(c["bench"], c["reps"])
        plain_ms = timer(c["plain"], max(1, c["reps"] // 5))
        lib = c["library"]
        lib_ms = None if lib is None else timer(lib, c["reps"])
        b_ms, b_by = bound_ms(c["bytes"], c["ops"], c["peak"])
        rec = {"label": c["label"], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "bound_share": b_ms / ms}
        extra = ""
        if c["graph"]:
            rec["timing"] = "cuda graph replay"
            rec["eager_ms"] = time_ms(c["bench"], c["reps"])
            extra = (f"  {100 * b_ms / ms:.0f}% of bound, eager "
                     f"{rec['eager_ms']:.4f} ms")
            if routes:
                rec["route"] = routes[0]
                extra = f"  route {routes[0]}," + extra
        if c["flash_route"] is not None:
            rec["route"] = c["flash_route"]
            extra = (f"  route {c['flash_route']}, {100 * b_ms / ms:.1f}% "
                     f"of bound")
        if c["no_library"]:
            rec["library_none_reason"] = c["no_library"]
        if c["tol"] is not None and need is not None:
            rec["bf16_atol_needed"] = need
        results.setdefault(c["kernel"], []).append(rec)
        log(f"[kernels] {c['kernel']:17s} {c['label']:46s} {check}  "
            f"{ms:9.4f} ms  plain {plain_ms:9.4f} ms  bound {b_ms:8.4f} ms "
            f"({b_by})  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}{extra}")
    no_torch_ops(dev)
    functional_epilogues(dev)
    reset_launches()     # comparison launches do not count
    return results


def functional_epilogues(dev):
    """The reference's functional epilogues in ``ops`` (``scale_accum``,
    ``scale_accum_plain``, ``oz2_scale_accum``, ``oz2_scale_accum_plain``,
    ``oz2_unscale``: new outputs, the accumulators left as they are) at
    main-path shapes, bitwise to the ``*_update`` hooks on copies (the
    same kernels, in place), their inputs untouched."""
    import torch
    from repro_torch.core.accumulate import DF32
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    f32, f64 = torch.float32, torch.float64

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def pow2(shape, lo, hi, dtype):
        return torch.pow(2.0, torch.randint(lo, hi, shape, generator=gen,
                                            device=dev)).to(dtype)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    m, vocab = SLOTS, 92672
    p32, word = ints((m, vocab), 2 ** 30), ints((1, m, vocab), 2 ** 30)
    srow, scol = pow2((m,), -40, -20, f32), pow2((vocab,), -4, 4, f32)
    hi, s = randn((m, vocab), f32), pow2((1,), -60, -30, f32)
    lo = hi * 2.0 ** -30
    big = 4096
    p64, w64 = ints((big, big), 2 ** 30), ints((1, big, big), 2 ** 52,
                                                 torch.int64)
    r64, c64 = pow2((big,), -40, -20, f64), pow2((big,), -4, 4, f64)
    c, s64 = randn((big, big), f64), pow2((1,), -60, -30, f64)
    x = randn((1, big, big), f64)
    ra, rb = pow2((1, big), -20, 20, f64), pow2((1, big), -20, 20, f64)
    cases = [
        ("scale_accum decode (4x92672) df32",
         lambda: ops.scale_accum(p32, srow, scol, hi, lo),
         lambda: tuple(ops.scale_accum_update(
             p32, srow, scol, DF32(hi.clone(), lo.clone()))), (hi, lo)),
        ("scale_accum_plain DGEMM (4096x4096) f64",
         lambda: ops.scale_accum_plain(p64, r64, c64, c),
         lambda: ops.scale_accum_update(p64, r64, c64, c.clone()), (c,)),
        ("oz2_scale_accum decode (4x92672) df32",
         lambda: ops.oz2_scale_accum(word, s, hi[None], lo[None]),
         lambda: tuple(ops.oz2_scale_accum_update(
             word, s, DF32(hi[None].clone(), lo[None].clone()))), (hi, lo)),
        ("oz2_scale_accum_plain DGEMM (4096x4096) int64 word f64",
         lambda: ops.oz2_scale_accum_plain(w64, s64, c[None]),
         lambda: ops.oz2_scale_accum_update(w64, s64, c[None].clone()),
         (c,)),
        ("oz2_unscale DGEMM (4096x4096) f64",
         lambda: ops.oz2_unscale(x, ra, rb),
         lambda: ops.oz2_unscale_update(x, ra, rb), (x,)),
    ]
    for label, functional, update, accs in cases:
        keep = tuple(t.clone() for t in accs)
        got, want = functional(), update()
        torch.cuda.synchronize()
        if not same(tuple(got) if isinstance(got, tuple) else got, want):
            raise AssertionError(f"functional {label}: differs from the "
                                 f"*_update hook")
        if not same(keep, accs):
            raise AssertionError(f"functional {label}: changed its "
                                 f"accumulator")
    log(f"[kernels] functional epilogues bitwise to the *_update hooks, "
        f"their accumulators untouched: " + "; ".join(c[0] for c in cases))


# what a one-launch wrapper may dispatch: its output allocations and views
ALLOC_OR_VIEW = {"aten.empty.memory_format", "aten.transpose.int"}


def no_torch_ops(dev):
    """The split and the df32 epilogues run on the card as their kernels
    alone: under a dispatch mode, ``ops.split_fused`` (A and B sides, the
    main path's modes; the attention's B operands as the permuted KV-cache
    views serving passes), ``ops.scale_accum_contraction`` and
    ``ops.oz2_scale_accum_contraction`` (fast2; one- and two-group
    windows) dispatch no PyTorch operation but their output allocations
    and views.  The obs layer is enabled (its default) and no profiler
    records: the wrappers' phase scopes are then null contexts."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core.ozimmu import canonical_rhs
    from repro_torch.kernels import ops
    from repro_torch.obs import registry
    if not registry.enabled() or torch.autograd._profiler_enabled():
        raise AssertionError("the dispatch check runs with obs enabled and "
                             "no profiler recording")

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    a = torch.randn((SLOTS, 2048), device=dev)
    prods = [torch.zeros((SLOTS, 2048), dtype=torch.int32, device=dev)
             for _ in range(4)]
    ones = torch.ones((SLOTS,), device=dev), torch.ones((2048,), device=dev)
    calls = [(f"split {mode} axis={axis}",
              lambda mode=mode, axis=axis: ops.split_fused(
                  a, 4, 7, mode=mode, axis=axis))
             for mode in ("rn_const", "sm", "oz2_rn_fast2")
             for axis in (0, 1)]
    cache = torch.randn((SLOTS, PROMPT + GEN, 8, 128), device=dev)
    for name, dn in (("scores", (((3,), (3,)), ((0, 1), (0, 2)))),
                     ("p@v", (((3,), (1,)), ((0, 1), (0, 2))))):
        view = canonical_rhs(cache, dn)[0]
        assert not view.is_contiguous()
        calls += [(f"split {mode} {name} B (KV-cache view)",
                   lambda mode=mode, view=view: ops.split_fused(
                       view, 4, 7, mode=mode, axis=1))
                  for mode in ("rn_const", "sm")]
    calls.append(("df32 epilogue C=4", lambda: ops.scale_accum_contraction(
        prods, [2, 3, 4, 5], *ones, 7)))
    # the MoE step's operands: the dispatch buffer as the engine passes it
    # (its f32 copy of the bf16 buffer), the expert weight stack and the
    # E-batched chunk products
    E, cap, dm, fe = MOE["E"], MOE["cap"], MOE["d"], MOE["fe"]
    buf = torch.randn((E, cap, dm), device=dev)
    w_e = torch.randn((E, dm, fe), device=dev)
    prods_e = [torch.zeros((E, cap, fe), dtype=torch.int32, device=dev)
               for _ in range(4)]
    ones_e = (torch.ones((E, cap), device=dev),
              torch.ones((E, fe), device=dev))
    calls += [("split rn_const MoE A (dispatch buffer view)",
               lambda: ops.split_fused(buf, 4, 7, axis=0)),
              ("split rn_const MoE B (expert stack) axis=1",
               lambda: ops.split_fused(w_e, 4, 7, axis=1)),
              ("df32 epilogue MoE (E-batched) C=4",
               lambda: ops.scale_accum_contraction(prods_e, [2, 3, 4, 5],
                                                   *ones_e, 7))]
    gbase = torch.full((), 2.0, device=dev)
    calls += [(f"Ozaki-II df32 epilogue C=4 c={c} fast2",
               lambda c=c: ops.oz2_scale_accum_contraction(
                   prods, [2, 3, 4, 5], c, 7, gbase, gbase, *ones))
              for c in (1, 2)]
    for name, fn in calls:
        fn()
        with Record() as rec:
            fn()
        extra = set(rec.ops) - ALLOC_OR_VIEW
        if extra:
            raise AssertionError(f"{name}: the wrapper ran PyTorch "
                                 f"operations on the card: {sorted(extra)}")
    log(f"[kernels] no PyTorch operation besides allocations and views "
        f"around the split (rn_const, sm, oz2_rn_fast2; both axes; the "
        f"attention's B operands as KV-cache views; the MoE dispatch "
        f"buffer and expert stack) or the df32 epilogues (group-EF, "
        f"also E-batched; Ozaki-II with fast2) on the card, obs enabled")


def wrapper_host_us(dev, reps=2000, turns=3):
    """Host microseconds per group GEMM call at a decode shape (wk/wv: m 4,
    n 2048, p 1024, G 4), with the launch plans cached per layout (the
    wrapper as it runs) and with the cache emptied before every call (the
    checks, route and C arguments rebuilt each time), in turns.  No sync
    inside a loop: the call's device time (~0.008 ms) is below its host
    time, so the launch queue never fills.  Beside them the obs layer's
    cost a contraction: ``ozimmu._record_emulation`` on the same decode
    operand (a scratch registry) and a ``phase_scope`` with obs enabled
    and no profiler recording (the shared null context); the counter call
    must stay within 5 us.  Medians over ``turns``."""
    import statistics
    import torch
    from repro_torch.core import ozimmu
    from repro_torch.core.splitting import compute_beta
    from repro_torch.kernels import ops, reset_launches
    from repro_torch.kernels import group_gemm as gg
    from repro_torch.obs import registry, tracing
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    a = torch.randn((SLOTS, 2048), generator=gen, device=dev)
    w = torch.randn((2048, 1024), generator=gen, device=dev)
    beta = compute_beta(2048)
    da = ops.split_fused(a, 4, beta, axis=0).digits
    db = ops.split_fused(w, 4, beta, axis=1).digits
    ia, ib = [0, 1, 2, 3], [3, 2, 1, 0]

    def per_call(clear, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if clear:
                gg._PLANS.clear()
            gg.group_gemm(da, db, ia, ib)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    cfg = ozimmu.parse_spec(MODEL_SPEC)

    def obs_call(what, n):
        t0 = time.perf_counter()
        if what == "record_emulation":
            for _ in range(n):
                ozimmu._record_emulation(cfg, a, 1024, True)
        else:
            for _ in range(n):
                with tracing.phase_scope("group_gemm"):
                    pass
        return (time.perf_counter() - t0) / n * 1e6

    per_call(False, 50)
    got = {"cached_plan": [], "plan_per_call": [], "record_emulation": [],
           "phase_scope_untraced": []}
    old = registry.set_registry(registry.MetricsRegistry())
    try:
        if not registry.enabled() or \
                tracing.phase_scope("split") is not tracing._NULL:
            raise AssertionError("obs disabled, or a profiler recording")
        obs_call("record_emulation", 50)
        for _ in range(turns):
            got["cached_plan"].append(per_call(False, reps))
            got["plan_per_call"].append(per_call(True, reps))
            for what in ("record_emulation", "phase_scope_untraced"):
                got[what].append(obs_call(what, 10 * reps))
    finally:
        registry.set_registry(old)
    reset_launches()
    res = {k: statistics.median(v) for k, v in got.items()}
    log(f"[host] group GEMM wrapper, decode wk/wv G=4, {reps} calls x "
        f"{turns} turns: {res['cached_plan']:.2f} us a call with the launch "
        f"plans cached, {res['plan_per_call']:.2f} us rebuilding the plan "
        f"every call; obs a contraction: _record_emulation "
        f"{res['record_emulation']:.2f} us a call (x 217 contractions: "
        f"{217 * res['record_emulation'] / 1e3:.3f} ms a dense step), an "
        f"untraced phase_scope {res['phase_scope_untraced']:.2f} us "
        f"(each turn: {got})")
    if res["record_emulation"] > 5.0:
        raise AssertionError(f"_record_emulation costs "
                             f"{res['record_emulation']:.2f} us a call")
    return res


# ---------------------------------------------------------------------------
# phase 3: DGEMM
# ---------------------------------------------------------------------------

def dgemm_inputs(dev):
    """The small input and the paper's phi = 0.5 inputs at n = 4096, the
    same for every DGEMM phase (one seed)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    f64 = torch.float64
    a = torch.randn((48, 200), generator=gen, device=dev, dtype=f64)
    b = torch.randn((200, 40), generator=gen, device=dev, dtype=f64)
    n = 4096
    mats = []
    for _ in range(2):
        u = torch.rand((n, n), generator=gen, device=dev, dtype=f64)
        z = torch.randn((n, n), generator=gen, device=dev, dtype=f64)
        mats.append((u - 0.5) * torch.exp(0.5 * z))
    return (a, b), tuple(mats)


def phase_dgemm(dev, spec, kernels, tag="dgemm", small_too=()):
    """``ozimmu_matmul`` under ``spec`` at n = 4096 against ``torch.matmul``
    in f64 (error <= 1e-8), after a small input that must equal the CPU
    plain-version pipeline (under ``spec`` and each of ``small_too``);
    every kernel in ``kernels`` must launch."""
    import torch
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = parse_spec(spec)
    (a, b), (A, B) = dgemm_inputs(dev)
    for s in (spec,) + tuple(small_too):
        small = ozimmu_matmul(a, b, parse_spec(s))
        small_cpu = ozimmu_matmul(a.cpu(), b.cpu(), parse_spec(s))
        if not same(small.cpu(), small_cpu):
            raise AssertionError(f"{tag}: the card's pipeline under {s} "
                                 f"differs from the CPU plain-version "
                                 f"pipeline")
    n = A.shape[0]
    ozimmu_matmul(A, B, cfg)                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    C = ozimmu_matmul(A, B, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    ref = torch.matmul(A, B)
    err = float((C - ref).abs().max() / ref.abs().max())
    ref_ms = time_ms(lambda: torch.matmul(A, B), 3)
    log(f"[{tag}] {spec} n={n}: {dt * 1e3:.1f} ms (torch.matmul f64 "
        f"{ref_ms:.2f} ms); max|C - A@B| / max|A@B| = {err:.3e}; small "
        f"input bitwise equal to the CPU pipeline under "
        f"{', '.join((spec,) + tuple(small_too))}; launches {counts}")
    if not math.isfinite(err) or err > 1e-8:
        raise AssertionError(f"{tag} error {err:.3e} above 1e-8")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    check_route(tag, counts, "large")
    return counts, ref


def check_route(tag, counts, route):
    """Every group GEMM of the path took ``route``; print the split."""
    log(f"[{tag}] group GEMM launches by route: large "
        f"{counts['group_gemm_large']}, skinny "
        f"{counts['group_gemm_skinny']} of {counts['group_gemm']}")
    if counts[f"group_gemm_{route}"] != counts["group_gemm"]:
        raise AssertionError(f"{tag}: not every group GEMM took the {route} "
                             f"route")


def phase_dgemm_auto(dev, spec, ref):
    """One eager auto-k DGEMM: the planner probes the operands on the card;
    print the k it resolved and the error against ``ref``."""
    import torch
    from repro_torch.core import plan
    from repro_torch.core.ozimmu import ozimmu_matmul, parse_spec
    _, (A, B) = dgemm_inputs(dev)
    plan.get_ledger().clear()
    t0 = time.perf_counter()
    C = ozimmu_matmul(A, B, parse_spec(spec))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d = plan.get_ledger().entries()[-1]
    err = float((C - ref).abs().max() / ref.abs().max())
    log(f"[dgemm_oz2] {spec} n={A.shape[0]}: resolved k={d.k} "
        f"({'probed' if d.probed else 'static'}, gaps {d.gap_a}/{d.gap_b}, "
        f"needs {d.needed_bits} bits, {d.int8_gemms} int8 GEMMs), "
        f"{dt * 1e3:.1f} ms with the probe; max|C - A@B| / max|A@B| = "
        f"{err:.3e}")
    if not math.isfinite(err) or err > 1e-8:
        raise AssertionError(f"{spec} error {err:.3e} above 1e-8")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def phase_serve(dev, spec, kernels, tag="serve", trace=False, absent=(),
                paged=False, card=""):
    """Serve full-width internlm2-1.8b under ``spec``; every kernel in
    ``kernels`` must launch, and none in ``absent``.  ``trace``: then
    measure the device's idle share with a profiler trace
    (:func:`serve_trace`).  ``paged``: then serve the same requests from a
    short block-paged pool (:func:`paged_pass`), then requests that share
    a system prompt through the prefix cache (:func:`prefix_pass`).
    Returns (launch counts, summary, {extra path: launch counts})."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime

    cfg = configs.get_config("internlm2_1_8b", engine_spec=spec)
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers (depth not cut), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; engine {spec}")
    model = api.get_model(cfg)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(cfg, generator=gen, device=dev)
    rt = ServingRuntime(cfg, params, slots=SLOTS, max_len=PROMPT + GEN,
                        device=dev)
    torch.cuda.synchronize()
    st = rt.split_cache.stats
    log(f"[{tag}] init + weight freeze {time.perf_counter() - t0:.1f} s: "
        f"{st.misses} weight splits, {st.cached_bytes / 1e9:.2f} GB resident"
        f"; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB of it "
        f"this phase's: weights, frozen digits, caches)")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT, dtype=np.int32)
               for _ in range(REQUESTS)]
    reset_launches()
    reqs = [rt.submit(p, GEN) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    sc = s["split_cache"]
    log(f"[{tag}] {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s p95 {s['ttft_s']['p95']:.3f} s; decode steps "
        f"{s['decode_steps']}, prefill calls {s['prefill_calls']}; "
        f"weight-split hit rate {sc['weight_split_hit_rate']:.3f}")
    log(f"[{tag}] kernel launches {counts}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    check_route(tag, counts, "skinny")
    # per model step: one split launch per split operand (the A side of 7
    # projections a layer and the LM head's, both sides of the two
    # attention products), 4 group GEMMs per contraction (k = 4: one chunk
    # a group), and one df32 epilogue launch a contraction
    steps = s["prefill_calls"] * PROMPT + s["decode_steps"]
    contractions = cfg.n_layers * 9 + 1
    want = {"split_fused": steps * (cfg.n_layers * 11 + 1),
            "group_gemm": steps * contractions * 4}
    for name in ("scale_accum", "scale_accum_const"):
        if name in kernels:
            want[name] = steps * contractions
    want.update({name: 0 for name in absent})
    got = {name: counts[name] for name in want}
    log(f"[{tag}] {steps} model steps: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")
    if s["requests"]["finished"] != REQUESTS or \
            s["tokens_generated"] != REQUESTS * GEN:
        raise AssertionError(f"{tag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    if sc["weight_split_hit_rate"] != 1.0:
        raise AssertionError(f"weight-split hit rate "
                             f"{sc['weight_split_hit_rate']}")

    # the runtime's contract: request 0 equals a monolithic greedy loop.
    # The loop keeps the runtime's slot width (request 0 in slot 0, the
    # other slots idle at cur = 0): PyTorch's CUDA reductions (the norm's
    # mean, the softmax sum) choose their summation order from the
    # tensor's shape, and every row is computed independently of the
    # others only at equal shapes.
    check_monolithic(tag, model, cfg, rt, reqs[0], SLOTS, GEN, dev)

    # full-width prefill logits in f32 activations: the emulated engine
    # (presplit weights) against the native f32 engine on the same weights
    with torch.no_grad():
        tk = torch.from_numpy(prompts[1][None, :16]).to(dev)
        emu = model.forward(rt.params, cfg.with_(dtype="float32"),
                            {"tokens": tk})
        nat = model.forward(params, cfg.with_(dtype="float32",
                                              engine_spec="f32"),
                            {"tokens": tk})
    if not bool(torch.isfinite(emu).all()) or emu.shape != nat.shape:
        raise AssertionError("prefill logits not finite or misshapen")
    rel = float((emu - nat).abs().max() / nat.abs().max())
    log(f"[{tag}] prefill logits (1x16, f32 activations) vs the f32 engine: "
        f"max|diff| / max|logit| = {rel:.3e}")
    if rel > 1e-3:
        raise AssertionError(f"{tag}: emulated prefill logits off by "
                             f"{rel:.3e}")
    mono = dict(reqs=reqs, counts=counts, steps=steps, s=s,
                cache_bytes=cache_bytes(rt.cache))
    if trace:
        serve_trace(rt, prompts, tag, s)
    del rt, emu, nat
    torch.cuda.empty_cache()
    extra = {}
    if paged:
        extra[f"{tag}_paged"], _ = paged_pass(
            tag, cfg, params, prompts, GEN, mono, card, dev, slots=SLOTS,
            max_len=PROMPT + GEN, pool=PAGE_POOL)
        extra[f"{tag}_prefix"] = prefix_pass(
            tag, "internlm2_1_8b", cfg, params, [PROMPT] * REQUESTS, GEN,
            card, dev, slots=SLOTS, max_len=PROMPT + GEN)
    del params
    torch.cuda.empty_cache()
    return counts, s, extra


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def paged_pass(tag, cfg, params, prompts, gen, mono, card, dev, *,
               slots, max_len, pool=None, ctx=None, prefix=None):
    """Serve ``prompts`` again through a paged ``ServingRuntime`` (blocks
    of ``PAGE_BLOCK`` positions, ``pool`` of them or the slots' capacity,
    prefill chunks of ``PAGE_CHUNK``) after the phase freed its
    monolithic runtime.  ``mono``: the monolithic run's requests, launch
    counts, model steps, summary and cache bytes.  Checks: every request's
    tokens equal the monolithic run's; every kernel's launches a model
    step (a position a prefill call feeds, or a decode step) exactly the
    monolithic run's, route by route; evictions where the pool is short;
    every block free at the end.  Logs the pool's bytes beside the
    monolithic cache's, tok/s, ms a model step and the peak.  ``prefix``:
    serve with the prefix cache (pass ``{tag}_prefix``) and hold its
    schedule to this prediction of :func:`prefix_dry_run` (hits, hit
    tokens, misses, insertions, positions fed, prefill tokens, decode
    steps, evictions); hits > 0, each adopting the whole published
    length, the blocks held at the end exactly the entries', every block
    free once they are cleared.  Returns (launch counts, summary)."""
    import gc
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingRuntime
    ptag = f"{tag}_paged" if prefix is None else f"{tag}_prefix"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = ServingRuntime(cfg, params, slots=slots, max_len=max_len,
                        page_block=PAGE_BLOCK, page_blocks=pool,
                        prefill_chunk=PAGE_CHUNK, ctx=ctx,
                        prefix_cache=prefix is not None, device=dev)
    paged = rt.paged
    fed = []                   # the bucket length of every prefill call
    prefill = rt._prefill

    def counted(toks, *args):
        fed.append(toks.shape[1])
        return prefill(toks, *args)
    rt._prefill = counted
    reset_launches()
    reqs = [rt.submit(p, gen) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    steps = sum(fed) + s["decode_steps"]
    peak = torch.cuda.max_memory_allocated()
    layout = (f"a pool of {paged.n_blocks} blocks of {paged.block} "
              f"positions and a trash block" if paged.paged_names
              else "no pool (no paged leaves)")
    log(f"[{ptag}] {card}: {layout} (paged leaves {paged.paged_names}, "
        f"state leaves {paged.state_names}), "
        f"{(cache_bytes(paged.pool) + cache_bytes(paged.state)) / 1e6:.2f} "
        f"MB with the resident state "
        f"against the monolithic cache's {mono['cache_bytes'] / 1e6:.2f} "
        f"MB; {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s; {steps} model steps ({s['elapsed_s'] / steps * 1e3:.1f} ms a "
        f"step; monolithic {mono['s']['elapsed_s'] / mono['steps'] * 1e3:.1f}"
        f" ms, {mono['s']['tokens_per_s']:.2f} tok/s): prefill calls "
        f"{s['prefill_calls']} ({sum(fed)} positions, {s['prefill_chunks']} "
        f"non-final chunks), decode steps {s['decode_steps']}, evictions "
        f"{s['evictions']}; peak {peak / 1e9:.2f} GB (max_memory_allocated "
        f"from the paged runtime's construction)")
    log(f"[{ptag}] kernel launches {counts}")
    bad = {k: (counts[k], mono["counts"][k] * steps / mono["steps"])
           for k in counts
           if counts[k] * mono["steps"] != mono["counts"][k] * steps}
    if bad:
        raise AssertionError(f"{ptag}: launches a model step differ from "
                             f"the monolithic run's ({steps} / "
                             f"{mono['steps']} steps): {bad}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"{ptag} path launched no {name} kernel")
    if s["requests"]["finished"] != len(prompts) or \
            s["tokens_generated"] != len(prompts) * gen:
        raise AssertionError(f"{ptag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    differ = [i for i, (a, b) in enumerate(zip(reqs, mono["reqs"]))
              if a.generated != b.generated]
    if differ:
        raise AssertionError(f"{ptag}: requests {differ} differ from the "
                             f"monolithic run's tokens")
    if pool is not None and s["evictions"] <= 0:
        raise AssertionError(f"{ptag}: a pool of {pool} blocks evicted "
                             f"nothing")
    if prefix is not None:
        check_prefix(ptag, rt, s, fed, prefix, mono)
    if paged.free_block_count != paged.n_blocks:
        raise AssertionError(f"{ptag}: {paged.live_blocks} blocks still "
                             f"live at the end")
    log(f"[{ptag}] every request's tokens equal the monolithic run's; "
        f"launches a model step equal the monolithic run's, kernel by "
        f"kernel and route by route; every block free at the end")
    rt._prefill = prefill
    del rt, paged, prefill, counted
    gc.collect()
    torch.cuda.empty_cache()
    return counts, s


def shared_prefix_prompts(vocab: int, lens, shared: int):
    """Prompts of ``lens`` tokens whose first ``shared`` are one system
    prompt, all drawn from ``SEED``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, size=shared, dtype=np.int32)
    return [np.concatenate([system, rng.integers(
        0, vocab, size=n - shared, dtype=np.int32)]) for n in lens]


def prefix_dry_run(arch, prompts, gen, *, slots, max_len):
    """The prefix pass's schedule predicted on the CPU: the same runtime
    (blocks of ``PAGE_BLOCK``, chunks of ``PAGE_CHUNK``, the full pool,
    the prefix cache) over ``arch``'s smoke config, its device steps
    replaced by stubs that return token 0.  Without an eos the schedule
    depends on the prompts' lengths and shared prefixes alone, and the
    pool's geometry (positions a block, blocks a slot) on ``max_len``, not
    on the width."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime
    cfg = configs.get_config(arch, smoke=True, engine_spec="f32")
    params = api.get_model(cfg).init(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cpu")
    rt = ServingRuntime(cfg, params, slots=slots, max_len=max_len,
                        page_block=PAGE_BLOCK, prefill_chunk=PAGE_CHUNK,
                        prefix_cache=True, device="cpu")
    fed = []

    def prefill(toks, start, base, newmask):
        fed.append(toks.shape[1])
        return np.zeros((slots,), np.int32)
    rt._prefill = prefill
    rt._decode = lambda toks, cur, active: np.zeros((slots,), np.int32)
    for p in prompts:
        rt.submit(p, gen)
    s = rt.run()
    return prefix_schedule(rt, s, fed)


def prefix_schedule(rt, s, fed):
    st = rt.prefix.stats
    return dict(hits=st.hits, hit_tokens=st.hit_tokens, misses=st.misses,
                inserted=st.inserted, positions=sum(fed),
                prefill_tokens=s["prefill_tokens"],
                decode_steps=s["decode_steps"], evictions=s["evictions"])


def check_prefix(ptag, rt, s, fed, predicted, mono):
    """The prefix pass's schedule against the CPU dry run's; hits that
    adopt the whole published length; the blocks held after the run
    exactly the entries'; every block free once they are cleared."""
    got = prefix_schedule(rt, s, fed)
    m = rt.prefix.max_publish_len(min(len(r.prompt) for r in mono["reqs"]))
    log(f"[{ptag}] prefix cache: {got} (the CPU dry run predicted "
        f"{predicted}); {got['hit_tokens']} prompt tokens adopted, "
        f"{mono['positions'] - got['positions']} fewer positions fed than "
        f"the monolithic run's {mono['positions']}; {len(rt.prefix)} "
        f"entries of {m} tokens")
    if got != predicted:
        raise AssertionError(f"{ptag}: schedule {got}, the dry run "
                             f"predicted {predicted}")
    if got["hits"] <= 0 or got["hit_tokens"] != got["hits"] * m:
        raise AssertionError(f"{ptag}: {got['hits']} hits of "
                             f"{got['hit_tokens']} tokens, not of {m} each")
    paged = rt.paged
    held = {b for e in rt.prefix.entries.values() for b in e.blocks}
    if paged.live_blocks != len(held):
        raise AssertionError(f"{ptag}: {paged.live_blocks} blocks live "
                             f"after the run, the entries hold {len(held)}")
    rt.prefix.clear()


def prefix_pass(tag, arch, cfg, params, lens, gen, card, dev, *, slots,
                max_len, chunk=None):
    """Requests of ``lens`` tokens sharing their first
    ``PREFIX_SHARED[tag]`` (:func:`shared_prefix_prompts`) served by a
    monolithic runtime (prefill chunks of ``chunk``; the reference), then
    through the prefix cache (:func:`paged_pass` with the prediction of
    :func:`prefix_dry_run`).  Returns the prefix pass's launch counts."""
    import gc
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingRuntime
    prompts = shared_prefix_prompts(cfg.vocab, lens, PREFIX_SHARED[tag])
    predicted = prefix_dry_run(arch, prompts, gen, slots=slots,
                               max_len=max_len)
    rt = ServingRuntime(cfg, params, slots=slots, max_len=max_len,
                        prefill_chunk=chunk, device=dev)
    fed = []
    prefill = rt._prefill

    def counted(toks, *args):
        fed.append(toks.shape[1])
        return prefill(toks, *args)
    rt._prefill = counted
    reset_launches()
    reqs = [rt.submit(p, gen) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    steps = sum(fed) + s["decode_steps"]
    mono = dict(reqs=reqs, counts=dict(LAUNCHES), steps=steps, s=s,
                positions=sum(fed), cache_bytes=cache_bytes(rt.cache))
    log(f"[{tag}_prefix] {card}: the monolithic reference: "
        f"{len(prompts)} prompts of {sorted(set(lens))} tokens sharing "
        f"their first {PREFIX_SHARED[tag]}, {s['tokens_generated']} tokens "
        f"in {s['elapsed_s']:.2f} s ({s['tokens_per_s']:.2f} tok/s, TTFT "
        f"mean {s['ttft_s']['mean']:.3f} s), {steps} model steps "
        f"({s['elapsed_s'] / steps * 1e3:.1f} ms a step; {sum(fed)} "
        f"positions fed)")
    if len({t for r in reqs for t in r.generated}) <= len(reqs):
        raise AssertionError(f"{tag}_prefix: the continuations barely vary")
    rt._prefill = prefill
    del rt, prefill, counted
    gc.collect()
    torch.cuda.empty_cache()
    counts, _ = paged_pass(tag, cfg, params, prompts, gen, mono, card, dev,
                           slots=slots, max_len=max_len, prefix=predicted)
    return counts


# ---------------------------------------------------------------------------
# phase 4d: the observability layer on the serving path
# ---------------------------------------------------------------------------

# the CI's observability smoke (.github/workflows/ci.yml) at the published
# width, on the card, under the fused spec
OBS_GEN = 4
OBS_FLAGS = ["--arch", "internlm2_1_8b", "--slots", "2", "--requests", "3",
             "--prompt-len", "8", "--gen", str(OBS_GEN), "--max-len", "32",
             "--engine", MODEL_SPEC, "--page-block", "8",
             "--prefill-chunk", "4", "--prefix-cache", "--full",
             "--seed", str(SEED)]
OBS_EVERY = 2
# the phase range each kernel class's launches sit in (trace_class names)
OBS_RANGES = {"split": "ozimmu/split", "group GEMM": "ozimmu/group_gemm",
              "epilogue": "ozimmu/scale_accum"}


def obs_instrument(rt, rec):
    """Record, without dispatching anything on the card, the requests
    ``rt`` is given (``rec['reqs']``), its scheduler rounds
    (``rec['rounds']``), the positions each prefill call feeds
    (``rec['fed']``) and the canonical shapes of the first decode step's
    contractions (``rec['calls']``: lhs shape, p, presplit, config)."""
    from repro_torch.core import ozimmu
    rec.update(reqs=[], rounds=0, fed=[], calls=[])
    submit, step = rt.submit, rt.step
    prefill, decode, bmm = rt._prefill, rt._decode, ozimmu._bmm_impl

    def submitted(*args, **kw):
        rec["reqs"].append(submit(*args, **kw))
        return rec["reqs"][-1]

    def stepped():
        busy = step()
        rec["rounds"] += busy
        return busy

    def counted(toks, *args):
        rec["fed"].append(toks.shape[1])
        return prefill(toks, *args)

    def recorded(a, b, cfg, rhs_presplit=None):
        rec["calls"].append((tuple(a.shape), b.shape[-1],
                             rhs_presplit is not None, cfg))
        return bmm(a, b, cfg, rhs_presplit=rhs_presplit)

    def first_decode(*args):
        ozimmu._bmm_impl = recorded
        try:
            return decode(*args)
        finally:
            ozimmu._bmm_impl = bmm
            rt._decode = decode
    rt.submit, rt.step = submitted, stepped
    rt._prefill, rt._decode = counted, first_decode


def obs_trace(tag, path, counts, steps):
    """The profiled serving loop's trace: the ``ozimmu/*`` host ranges
    (count and host ms a model step, by name), and each split, group GEMM
    and epilogue kernel attributed to its phase range (``OBS_RANGES``)
    through its launch: the runtime call carrying the kernel's correlation
    id must lie inside the range, on the same thread.  Every kernel of the
    three classes must be under its range, and their number must be the
    launches counted in the run."""
    import bisect
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    ranges, launch = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name, args = str(e.get("name", "")), e.get("args", {})
        if e.get("cat") == "user_annotation" and name.startswith("ozimmu/"):
            a = float(e["ts"])
            ranges.setdefault((name, e["pid"], e["tid"]), []).append(
                (a, a + float(e.get("dur", 0))))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launch[args["correlation"]] = (e["pid"], e["tid"],
                                           float(e["ts"]))
    per = {}
    for (name, _, _), spans in ranges.items():
        spans.sort()
        n, ms = per.get(name, (0, 0.0))
        per[name] = (n + len(spans),
                     ms + sum(b - a for a, b in spans) / 1e3)
    log(f"[{tag}] trace ranges, host ({steps} model steps): " + "; ".join(
        f"{name} {n} ({n / steps:.0f} a step, {ms / steps:.2f} ms a step)"
        for name, (n, ms) in sorted(per.items())))

    def under(name, corr):
        if corr not in launch:
            return False
        pid, tid, ts = launch[corr]
        spans = ranges.get((name, pid, tid), ())
        i = bisect.bisect_right(spans, (ts, math.inf)) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    found = {cls: [0, 0] for cls in OBS_RANGES}     # kernels, under range
    for e in events:
        cls = trace_class(e) if e.get("ph") == "X" else None
        if cls in OBS_RANGES:
            found[cls][0] += 1
            found[cls][1] += under(OBS_RANGES[cls],
                                   e.get("args", {}).get("correlation"))
    log(f"[{tag}] trace kernels launched under their phase range: "
        + "; ".join(f"{cls} {f[1]} of {f[0]} under {OBS_RANGES[cls]}"
                    for cls, f in found.items()))
    launched = {"split": counts["split_fused"],
                "group GEMM": counts["group_gemm"],
                "epilogue": counts["scale_accum"]}
    for cls, (n, inside) in found.items():
        if n != launched[cls] or n <= 0:
            raise AssertionError(f"{tag}: the trace holds {n} {cls} kernels, "
                                 f"{launched[cls]} launched")
        if inside != n:
            raise AssertionError(f"{tag}: {n - inside} of {n} {cls} kernels "
                                 f"were not launched under "
                                 f"{OBS_RANGES[cls]}")


def phase_serve_obs(dev, card):
    """The CI's observability smoke on the card: ``launch.serve.main``
    with its flags (2 slots, 3 requests of 8 tokens, 4 new, max_len 32,
    blocks of 8, chunks of 4, the prefix cache, ``--metrics-json`` every 2
    rounds, ``--profile-dir``) at the published internlm2-1.8b width
    (``--full``) under ``ozimmu_h-4:df32:fused``.  Checks: the CI
    snippet's assertions on the document, a dump every 2 rounds and a
    final one; ``decode_observed``: 217 contractions (24 x 9 + the head),
    ``int8_gemms`` the Plan's count summed over the first decode step's
    contractions, ``int8_gemms_presplit`` every weight contraction's (the
    B sides frozen); the Prometheus text of the final snapshot lint-clean;
    the trace's ``ozimmu/split``, ``ozimmu/group_gemm`` and
    ``ozimmu/scale_accum`` ranges over their kernels (:func:`obs_trace`);
    the exact launches a model step.  Then the same requests in turns of
    (obs off, on, on, off), each on a fresh runtime over the same
    parameters: tokens and launches a model step equal to the profiled
    run's, and ms a model step with obs on against off.  Returns the
    profiled run's launch counts."""
    import contextlib
    import gc
    import os
    import statistics
    import tempfile
    import torch
    from repro_torch.core import plan
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.obs import export, registry
    tag = "serve_obs"
    if not registry.enabled():
        raise AssertionError(f"{tag}: the obs layer is disabled")
    rec, dumps = {}, []
    make_runtime, dump_metrics = serve.make_runtime, serve.dump_metrics

    def captured(cfg, params, **kw):
        rt = make_runtime(cfg, params, **kw)
        rec.update(cfg=cfg, params=params, kw=kw, rt=rt)
        obs_instrument(rt, rec)
        reset_launches()        # the freeze's splits are not the run's
        return rt

    def dumped(path, runtime, final=False):
        dumps.append(final)
        dump_metrics(path, runtime, final=final)

    with tempfile.TemporaryDirectory() as tmp:
        doc_path = os.path.join(tmp, "obs_metrics.json")
        prof = os.path.join(tmp, "obs_profile")
        serve.make_runtime, serve.dump_metrics = captured, dumped
        try:
            s = serve.main(OBS_FLAGS + [
                "--metrics-json", doc_path, "--metrics-every",
                str(OBS_EVERY), "--profile-dir", prof, "--device", "cuda"])
        finally:
            serve.make_runtime, serve.dump_metrics = make_runtime, \
                dump_metrics
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        cfg, rt = rec["cfg"], rec["rt"]
        steps = sum(rec["fed"]) + s["decode_steps"]
        doc = json.loads(Path(doc_path).read_text())
        # the CI snippet's assertions
        totals = doc["totals"]
        assert totals["emulation.int8_gemms"] > 0, totals
        assert totals["emulation.calls"] > 0, totals
        assert doc["plan_ledger"] is not None
        assert "serving_summary" in doc, sorted(doc)
        log(f"[{tag}] {card}: {cfg.name} {cfg.n_layers} layers (depth not "
            f"cut), {MODEL_SPEC}; the CI's flags: {s['tokens_generated']} "
            f"tokens from {s['requests']['finished']} requests in "
            f"{rec['rounds']} rounds, {steps} model steps "
            f"({sum(rec['fed'])} positions fed, {s['decode_steps']} decode "
            f"steps); observability smoke ok: "
            + str({k: totals[k] for k in sorted(totals)
                   if k.startswith("emulation.")}))
        want_dumps = [False] * (rec["rounds"] // OBS_EVERY) + [True]
        if dumps != want_dumps:
            raise AssertionError(f"{tag}: dumps {dumps}, expected "
                                 f"{want_dumps}")
        obs = doc["decode_observed"]
        if obs != rt.decode_observed:
            raise AssertionError(f"{tag}: the document's decode_observed "
                                 f"{obs} is not the runtime's")
        calls = rec["calls"]

        def gemms(shape, p, cfg_c):
            return math.prod(shape[:-2]) * plan.plan_contraction(
                cfg_c, shape[-2], shape[-1], p, _record=False).int8_gemms
        want = {"contractions": cfg.n_layers * 9 + 1,
                "int8_gemms": sum(gemms(sh, p, c) for sh, p, _, c in calls),
                "int8_gemms_presplit": sum(gemms(sh, p, c)
                                           for sh, p, pre, c in calls
                                           if pre)}
        presplit = sum(pre for _, _, pre, _ in calls)
        log(f"[{tag}] decode_observed {obs}; the first decode step's "
            f"{len(calls)} contractions ({presplit} on frozen weights) "
            f"priced by the Plan: {want}")
        if "--full" in OBS_FLAGS and want["contractions"] != 217:
            raise AssertionError(f"{tag}: {cfg.n_layers} layers, not the "
                                 f"published 24")
        if {k: obs[k] for k in want} != want or \
                len(calls) != want["contractions"] or \
                presplit != cfg.n_layers * 7 + 1:
            raise AssertionError(f"{tag}: decode_observed {obs}, expected "
                                 f"{want} over {len(calls)} contractions, "
                                 f"{presplit} presplit")
        snap = export.unified_snapshot(rt.metrics.registry)
        text = export.to_prometheus(snap)
        export.lint_prometheus(text)
        parsed = export.parse_prometheus(text)
        log(f"[{tag}] Prometheus text of the final snapshot: "
            f"{len(text.splitlines())} lines, {len(parsed)} samples, "
            f"lint-clean")
        want_counts = {"split_fused": steps * (cfg.n_layers * 11 + 1),
                       "group_gemm": steps * want["contractions"] * 4,
                       "scale_accum": steps * want["contractions"]}
        got = {k: counts[k] for k in want_counts}
        if got != want_counts:
            raise AssertionError(f"{tag}: launches {got}, expected "
                                 f"{want_counts}")
        check_route(tag, counts, "skinny")
        obs_trace(tag, os.path.join(prof, "trace.json"), counts, steps)
    main_run = dict(tokens=[r.generated for r in rec["reqs"]],
                    counts=counts, steps=steps, s=s)
    params, kw = rec["params"], rec["kw"]
    prompts = [r.prompt for r in rec["reqs"]]
    del rec, rt, snap
    gc.collect()
    torch.cuda.empty_cache()

    ms = {"on": [], "off": []}
    for on in (False, True, True, False):
        run = {}
        rt = make_runtime(cfg, params, **kw)
        obs_instrument(rt, run)
        torch.cuda.synchronize()
        reset_launches()
        with contextlib.nullcontext() if on else registry.disabled():
            for p in prompts:
                rt.submit(p, OBS_GEN)
            s = rt.run()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        steps = sum(run["fed"]) + s["decode_steps"]
        mode = "on" if on else "off"
        ms[mode].append(s["elapsed_s"] / steps * 1e3)
        if [r.generated for r in run["reqs"]] != main_run["tokens"]:
            raise AssertionError(f"{tag}: obs {mode}: tokens differ from "
                                 f"the profiled run's")
        bad = {k: (counts[k], main_run["counts"][k]) for k in counts
               if counts[k] * main_run["steps"]
               != main_run["counts"][k] * steps}
        if bad:
            raise AssertionError(f"{tag}: obs {mode}: launches a model step "
                                 f"differ from the profiled run's: {bad}")
        if (rt.decode_observed is None) == on:
            raise AssertionError(f"{tag}: obs {mode}: decode_observed "
                                 f"{rt.decode_observed}")
        del rt, run
        gc.collect()
        torch.cuda.empty_cache()
    on_ms, off_ms = statistics.median(ms["on"]), statistics.median(ms["off"])
    log(f"[{tag}] {card}: ms a model step with obs on {ms['on']} against "
        f"off {ms['off']} (turns off, on, on, off; fresh runtimes, the "
        f"same requests): median {on_ms:.2f} against {off_ms:.2f} "
        f"({100 * (on_ms / off_ms - 1):+.1f}%); tokens and launches a "
        f"model step equal to the profiled run's")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return main_run["counts"]


# what moe_depth keeps free beyond its reckoning: the activations, the
# caches, the attention's operands and the allocator's rounding
DEPTH_HEADROOM = 2e9


def moe_depth(cfg, free_bytes: int):
    """``(layers, bytes a layer, bytes besides the layers)``: the published
    depth of a MoE config if the serve phase's predicted peak fits in
    ``free_bytes``, else the most layers that fit.  A layer holds its f32
    weights (attention: GQA, or MLA's six projections; router, experts,
    shared experts, norms) and the k = 4 int8 frozen digits of its
    attention and shared-expert weights.  Besides the layers: the
    embedding and LM head (f32, plus the LM head's digits), one expert
    contraction's transient (the bf16 cast of an expert weight stack, its
    f32 copy for the engine and its 4 int8 digit slices: 10 bytes an
    element, as serve_moe measured, 1.92 GB above the frozen state at 184.5
    M elements) and ``DEPTH_HEADROOM``."""
    d, E, fe, V, H, hd = (cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                          cfg.padded_vocab, cfg.n_heads, cfg.hd)
    if cfg.family == "mla_moe":
        dl, dr, vd = cfg.kv_lora, cfg.rope_head_dim, cfg.v_head_dim or hd
        attn = d * (dl + dr + H * (hd + dr)) + dl * H * (hd + vd) + \
            H * vd * d
    else:
        attn = d * (H + 2 * cfg.n_kv_heads) * hd + H * hd * d
    shared = 3 * d * fe * cfg.n_shared_experts
    layer = 4 * (attn + d * E + 3 * E * d * fe + shared + 2 * d) + \
        4 * (attn + shared)
    fixed = 4 * 2 * V * d + 4 * d * V + (2 + 4 + 4) * E * d * fe + \
        DEPTH_HEADROOM
    return int(min(cfg.n_layers, (free_bytes - fixed) // layer)), layer, \
        int(fixed)


# per layer of a MoE model step under MODEL_SPEC with the weight splits
# frozen: (split launches, contractions, of them on the large route)
MOE_STEP = {
    # 7 projection A sides (wq, wk, wv, wo, the shared expert's 3), both
    # sides of the 2 attention and the 3 expert products; 12 contractions
    "deepseek_moe_16b": (17, 12, 0),
    # 9 projection A sides (w_dkv, w_krope, w_q, w_uk, w_uv, w_o, the
    # shared expert's 3), both sides of the 2 attention and the 3 expert
    # products; 14 contractions, of which w_uk and w_uv take the whole
    # cache (slots x max_len rows) as A: the large route
    "deepseek_v2_236b": (19, 14, 2),
}


def phase_serve_moe(dev, arch="deepseek_moe_16b", tag="serve_moe"):
    """Serve a MoE config's ``full()`` (random weights from the seed)
    under ``MODEL_SPEC``: MOE_SLOTS slots, MOE_REQUESTS requests of prompt
    MOE_PROMPT and MOE_GEN new tokens, at the published depth unless the
    predicted peak (:func:`moe_depth`) does not fit the card after the
    earlier phases freed theirs; a cut is logged with its reason.  Every
    model step must count exactly the launches of ``MOE_STEP[arch]`` a
    layer plus the LM head's (one split, 4 skinny group GEMMs, one
    epilogue), 4 group GEMMs and one df32 epilogue a contraction (the
    expert weights are split every step, as in the reference; the f32
    router launches none), with the large route taken exactly by the
    contractions ``MOE_STEP`` puts there.  Request 0 must equal the
    monolithic loop, the weight-split hit rate be 1.0, and the 1x16
    prefill logits in f32 activations agree with the native f32 engine
    within 1e-3 of max|logit| per token, routing flips allowed only where
    isolated (the reference's rule, ``tests/test_models.py``)."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    from repro_torch.serving import ServingRuntime
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = configs.get_config(arch, engine_spec=MODEL_SPEC)
    free, total = torch.cuda.mem_get_info()
    layers, per_layer, fixed = moe_depth(cfg, free)
    predicted = fixed + layers * per_layer
    if layers < cfg.n_layers:
        why = (f"depth cut {cfg.n_layers} -> {layers} layers: the "
               f"published depth's predicted peak "
               f"{(fixed + cfg.n_layers * per_layer) / 1e9:.1f} GB exceeds "
               f"the {free / 1e9:.1f} GB free; "
               f"{(layers + 1)} layers would need "
               f"{(fixed + (layers + 1) * per_layer) / 1e9:.1f} GB")
        cfg = cfg.with_(n_layers=layers)
    else:
        why = "depth not cut"
    if layers < 2:
        raise AssertionError(f"{tag}: fewer than two layers fit ({why})")
    attn = (f"MLA: {cfg.n_heads} heads, q/k dim {cfg.hd}+"
            f"{cfg.rope_head_dim}, v dim {cfg.v_head_dim}, latent "
            f"{cfg.kv_lora}" if cfg.family == "mla_moe" else
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers ({why}; predicted peak "
        f"{predicted / 1e9:.1f} GB, {per_layer / 1e9:.2f} GB a layer, "
        f"{fixed / 1e9:.2f} GB besides them of which "
        f"{DEPTH_HEADROOM / 1e9:.1f} GB headroom, of {free / 1e9:.1f} GB "
        f"free, card {total / 1e9:.1f} GB), d_model {cfg.d_model}, {attn}, "
        f"{cfg.n_experts} experts of d_ff {cfg.d_ff_expert} top-{cfg.topk} "
        f"+ {cfg.n_shared_experts} shared, vocab {cfg.vocab}, dispatch "
        f"{cfg.moe_dispatch} (no mesh: scatter); engine {MODEL_SPEC}")
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(cfg, generator=gen, device=dev)
    rt = ServingRuntime(cfg, params, slots=MOE_SLOTS,
                        max_len=MOE_PROMPT + MOE_GEN, device=dev)
    torch.cuda.synchronize()
    st = rt.split_cache.stats
    log(f"[{tag}] init + weight freeze {time.perf_counter() - t0:.1f} s: "
        f"{param_count(params) / 1e9:.2f} B f32 parameters, {st.misses} "
        f"weight splits, {st.cached_bytes / 1e9:.2f} GB resident; device "
        f"memory {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB of it this "
        f"phase's)")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=MOE_PROMPT, dtype=np.int32)
               for _ in range(MOE_REQUESTS)]
    reset_launches()
    reqs = [rt.submit(p, MOE_GEN) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    sc = s["split_cache"]
    steps = s["prefill_calls"] * MOE_PROMPT + s["decode_steps"]
    log(f"[{tag}] {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s p95 {s['ttft_s']['p95']:.3f} s; {steps} model steps "
        f"({s['elapsed_s'] / steps * 1e3:.1f} ms a step), decode steps "
        f"{s['decode_steps']}, prefill calls {s['prefill_calls']}; "
        f"weight-split hit rate {sc['weight_split_hit_rate']:.3f}")
    log(f"[{tag}] kernel launches {counts}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    splits, per_layer_c, large = MOE_STEP[arch]
    contractions = cfg.n_layers * per_layer_c + 1
    want = {"split_fused": steps * (cfg.n_layers * splits + 1),
            "group_gemm": steps * contractions * 4,
            "group_gemm_large": steps * cfg.n_layers * large * 4,
            "scale_accum": steps * contractions}
    want["group_gemm_skinny"] = want["group_gemm"] - want["group_gemm_large"]
    got = {name: counts[name] for name in want}
    log(f"[{tag}] launches {got}, expected {want} ({steps} steps x "
        f"{cfg.n_layers * splits + 1} splits, {contractions * 4} group GEMMs "
        f"of which {cfg.n_layers * large * 4} large, {contractions} "
        f"epilogues)")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")
    if s["requests"]["finished"] != MOE_REQUESTS or \
            s["tokens_generated"] != MOE_REQUESTS * MOE_GEN:
        raise AssertionError(f"{tag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    if sc["weight_split_hit_rate"] != 1.0:
        raise AssertionError(f"{tag}: weight-split hit rate "
                             f"{sc['weight_split_hit_rate']}")
    check_monolithic(tag, model, cfg, rt, reqs[0], MOE_SLOTS, MOE_GEN, dev)

    with torch.no_grad():
        tk = torch.from_numpy(prompts[1][None, :16]).to(dev)
        emu = model.forward(rt.params, cfg.with_(dtype="float32"),
                            {"tokens": tk})
        nat = model.forward(params, cfg.with_(dtype="float32",
                                              engine_spec="f32"),
                            {"tokens": tk})
    if not bool(torch.isfinite(emu).all()) or emu.shape != nat.shape:
        raise AssertionError(f"{tag}: prefill logits not finite or "
                             f"misshapen")
    err_tok = ((emu - nat).abs().amax(dim=-1) / nat.abs().max())[0]
    bad = err_tok >= 1e-3
    flips = int(bad.sum())
    rest = float(err_tok[~bad].max()) if flips < len(bad) else float("nan")
    log(f"[{tag}] prefill logits (1x16, f32 activations) vs the f32 engine: "
        f"{flips} of 16 tokens flipped (per-token max|diff| / max|logit| "
        f">= 1e-3), the others within {rest:.3e}; per token "
        f"{[float(f'{e:.2e}') for e in err_tok.tolist()]}")
    if flips > 1:
        raise AssertionError(f"{tag}: {flips} tokens off the f32 engine by "
                             f"1e-3 or more; at most one isolated routing "
                             f"flip is allowed")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB"
        f", peak {peak / 1e9:.2f} GB (max_memory_allocated since the phase "
        f"began; predicted {predicted / 1e9:.1f} GB) of {total / 1e9:.1f} GB")
    serve_trace(rt, prompts, tag, s, prompt_len=MOE_PROMPT, trace_prompt=8,
                trace_gen=2)
    del rt, params, emu, nat
    gc.collect()
    torch.cuda.empty_cache()
    return counts, s


def check_monolithic(tag, model, cfg, rt, req, slots, gen, dev, ctx=None):
    """The runtime's contract: ``req`` (served in slot 0) equals a
    monolithic greedy loop on the runtime's parameters.  The loop keeps
    the runtime's slot width (the request in slot 0, the other slots idle
    at cur = 0): PyTorch's CUDA reductions (the norm's mean, the softmax
    sum) choose their summation order from the tensor's shape, and every
    row is computed independently of the others only at equal shapes.
    ``ctx``: one slot's context; the loop's cache is built as the
    runtime builds its own (the context repeated across the slots) and
    slot 0 reset from the single-slot cache, as at admission."""
    import numpy as np
    import torch
    plen = len(req.prompt)
    with torch.no_grad():
        if ctx is None:
            cache = model.init_cache(cfg, slots, plen + gen, device=dev)
        else:
            cache = model.init_cache(cfg, slots, plen + gen,
                                     params=rt.params,
                                     ctx=torch.cat([ctx] * slots))
            rt.ops.reset_slot(cache, 0, model.init_cache(
                cfg, 1, plen + gen, params=rt.params, ctx=ctx))
        toks = list(req.prompt)
        for t in range(plen + gen - 1):
            step_toks = torch.zeros((slots, 1), dtype=torch.int32,
                                    device=dev)
            step_toks[0, 0] = int(toks[t])
            cur = torch.zeros((slots,), dtype=torch.int32, device=dev)
            cur[0] = t + 1
            logits, cache = model.decode_step(rt.params, cfg, cache,
                                              step_toks, cur)
            if t + 1 >= plen:
                toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
    got = np.concatenate([req.prompt, np.asarray(req.generated)])
    if not np.array_equal(got, np.asarray(toks)):
        raise AssertionError(f"{tag}: request 0 differs from the monolithic "
                             f"greedy loop:\n{got.tolist()}\n{toks}")
    log(f"[{tag}] request 0 equals the monolithic greedy loop: "
        f"{got[plen:].tolist()}")


# the state families served (serve_ssm, serve_hybrid): STATE_SLOTS slots,
# STATE_REQUESTS requests of STATE_GEN new tokens, max_len 48.  mamba2's
# prompts alternate 24 / 32 tokens (two exact-length buckets) fed in
# prefill chunks of 8, so decode steps run beside mid-prefill slots;
# recurrentgemma's are 32 tokens, prefilled whole
STATE_SLOTS, STATE_REQUESTS, STATE_GEN, STATE_MAX_LEN = 4, 8, 16, 48
# the tied head reads the residual stream against the embedding: at the
# init's embedding scale of 1 the token's own embedding dominates the
# stream and greedy decoding echoes the last prompt token whatever the
# layers compute, so the phases scale the random embedding down (as
# tests/test_torch_{ssm,hybrid}.py do) and the monolithic check sees them
STATE_EMBED_SCALE = 0.05
STATE_SERVE = {"mamba2_780m": dict(tag="serve_ssm", prompts=(24, 32),
                                   chunk=8, paged=True),
               "recurrentgemma_9b": dict(tag="serve_hybrid", prompts=(32,),
                                         chunk=None)}


def state_step_launches(cfg):
    """``(contractions, split launches, large-route contractions)`` of one
    model step under ``MODEL_SPEC`` with the weight splits frozen.  ssm: 2
    a layer (``w_in``, ``w_out``) and the tied head.  hybrid: 5 a
    recurrent layer (``w_x``, ``w_gate``, ``w_out``, ``w_up``, ``w_down``),
    8 an attention layer (4 projections, the scores, p@v, 2 MLP), 18 a
    pattern block, and the head.  One split per A side, per attention B
    side (the K/V cache) and for the head's unfrozen ``embed.T``.  The
    MQA contractions have G = H / KV A rows, on the large route past
    ``group_gemm.SKINNY_MAX_M``; ``lru_a`` (plain f32) launches none."""
    from repro_torch.kernels import group_gemm as gg
    if cfg.family == "ssm":
        c = 2 * cfg.n_layers + 1
        return c, c + 1, 0
    nb = cfg.n_pattern_blocks
    c = 18 * nb + 5 * cfg.n_tail_layers + 1
    large = gg.route(cfg.n_heads // cfg.n_kv_heads, True) == "large"
    return c, c + 2 * nb + 1, 2 * nb * large


def serve_memory(cfg):
    """``(predicted peak bytes, f32 parameters, wrapped parameters)`` of a
    state or context serve phase, from the parameter tree built on the
    meta device: the f32 weights (4 B an element), the k = 4 int8 frozen
    digits of the wrapped ones (4 B an element), a tied head's digits
    split every step (4 B an element of ``embed``; none with an
    ``lm_head``), three copies of the slot cache (the runtime's, the
    step's new one, the prefill's ``before``; the context families' cross
    K/V at their zero-context length: ``vision_seq`` rows, or ``max_len``
    for encdec, at least the prompt's) and ``DEPTH_HEADROOM``."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    from repro_torch.serving import presplit
    model = api.get_model(cfg)
    tree = model.init(cfg, generator=torch.Generator(), device="meta")

    def leaf(path):
        t = tree
        for k in path:
            t = t[k]
        return t
    n = param_count(tree)
    wrapped = sum(leaf(p).numel() for p in presplit.wrappable_paths(tree))
    cache = sum(t.numel() * t.element_size() for t in model.init_cache(
        cfg, STATE_SLOTS, STATE_MAX_LEN, device="meta").values())
    tied = 0 if "lm_head" in tree else 4 * tree["embed"].numel()
    peak = 4 * n + 4 * wrapped + tied + 3 * cache + DEPTH_HEADROOM
    return int(peak), n, wrapped


def serve_depth(cfg, free_bytes: int):
    """``(cfg, predicted peak, why)``: the published depth if its
    predicted peak (:func:`serve_memory`) fits ``free_bytes``, else the
    most whole depth units that fit: the hybrid's pattern blocks (the
    tail kept), the vlm's groups of ``cross_every`` layers."""
    peak = serve_memory(cfg)[0]
    if peak <= free_bytes:
        return cfg, peak, "depth not cut"
    if cfg.family == "hybrid":
        n, what = cfg.n_pattern_blocks, "pattern blocks"

        def cut(k):
            return cfg.with_(n_pattern_blocks=k, n_layers=k * len(
                cfg.pattern) + cfg.n_tail_layers)
    elif cfg.family == "vlm":
        n = cfg.n_layers // cfg.cross_every
        what = f"groups of {cfg.cross_every} layers"

        def cut(k):
            return cfg.with_(n_layers=k * cfg.cross_every)
    else:
        raise AssertionError(f"{cfg.name}: predicted peak {peak / 1e9:.1f} "
                             f"GB exceeds the {free_bytes / 1e9:.1f} GB free")
    per_unit = peak - serve_memory(cut(n - 1))[0]
    keep = int((free_bytes - (peak - n * per_unit)) // per_unit)
    if keep < 2:
        raise AssertionError(f"{cfg.name}: fewer than two {what} fit "
                             f"{free_bytes / 1e9:.1f} GB")
    why = (f"depth cut {n} -> {keep} {what}: the published depth's "
           f"predicted peak {peak / 1e9:.1f} GB exceeds the "
           f"{free_bytes / 1e9:.1f} GB free ({per_unit / 1e9:.2f} GB a "
           f"unit)")
    cfg = cut(keep)
    return cfg, serve_memory(cfg)[0], why


def tied_head_copies(tag, cfg, params, dev):
    """The tied head's B side is the transposed view ``embed.T``: under a
    dispatch mode, one engine contraction of the decode step's shape must
    create no f32 tensor of ``embed``'s size besides views of it (no
    contiguous copy; the split's kernel reads the view through its
    strides).  A check of the card: on the CPU the split's plain version
    makes such temporaries."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    size = params["embed"].numel()
    home = params["embed"].untyped_storage().data_ptr()
    big = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and \
                        t.dtype == torch.float32 and t.numel() >= size and \
                        t.untyped_storage().data_ptr() != home:
                    big.append(str(func))
            return out

    x = torch.randn((STATE_SLOTS, 1, cfg.d_model), device=dev)
    with torch.no_grad(), Record():
        cfg.engine(x, params["embed"].T)
    if big:
        raise AssertionError(f"{tag}: the tied head's contraction made "
                             f"{len(big)} f32 tensors of embed's size "
                             f"({sorted(set(big))})")
    log(f"[{tag}] the tied head's B side (embed.T, {cfg.d_model} x "
        f"{cfg.padded_vocab} f32, {size * 4 / 1e9:.2f} GB) is split through "
        f"its strides: no f32 tensor of its size made on the way")


def phase_serve_state(dev, arch, card):
    """Serve a state family's ``full()`` (random weights from the seed)
    under ``MODEL_SPEC`` through ``ServingRuntime`` (``STATE_SERVE[arch]``:
    mamba2-780m at all 48 layers with chunked prefill, recurrentgemma-9b
    at its 12 pattern blocks + 2 tail layers unless :func:`serve_depth`'s
    predicted peak does not fit, the cut logged).  A model step is a
    position a prefill call feeds (the sum of its calls' bucket lengths)
    or a decode step; every one must count exactly
    :func:`state_step_launches` (4 group GEMMs and one df32 epilogue a
    contraction).  Request 0 must equal the monolithic loop, the
    weight-split hit rate be 1.0, and the 1x16 prefill logits of
    ``forward`` in f32 activations lie within 1e-3 of max|logit| of the
    native f32 engine at every token (no routing: no flip allowed).
    Logs tok/s, TTFT, ms a model step and the peak against its
    prediction beside ``card``, and traces a few steps."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import api
    from repro_torch.serving import ServingRuntime
    spec = STATE_SERVE[arch]
    tag = spec["tag"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    cfg, predicted, why = serve_depth(
        configs.get_config(arch, engine_spec=MODEL_SPEC), free)
    _, n_params, n_wrapped = serve_memory(cfg)
    if cfg.family == "ssm":
        shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
                 f"{cfg.expand * cfg.d_model} in "
                 f"{cfg.expand * cfg.d_model // cfg.ssm_headdim} heads of "
                 f"{cfg.ssm_headdim}, state {cfg.d_state}, conv "
                 f"{cfg.d_conv}")
    else:
        shape = (f"{cfg.n_layers} layers ({cfg.n_pattern_blocks} x "
                 f"{''.join(cfg.pattern)} + {cfg.n_tail_layers} R), d_model "
                 f"{cfg.d_model}, LRU width {cfg.lru_width}, MQA "
                 f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, window "
                 f"{cfg.window}, GELU d_ff {cfg.d_ff}")
    log(f"[{tag}] {cfg.name}: {shape}, vocab {cfg.vocab} (tied head); "
        f"{why}; {n_params / 1e9:.3f} B f32 parameters, "
        f"{n_wrapped / 1e9:.3f} B of them frozen; predicted peak "
        f"{predicted / 1e9:.1f} GB of {free / 1e9:.1f} GB free (card "
        f"{total / 1e9:.1f} GB); engine {MODEL_SPEC}")
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(cfg, generator=gen, device=dev)
    params["embed"].mul_(STATE_EMBED_SCALE)
    rt = ServingRuntime(cfg, params, slots=STATE_SLOTS,
                        max_len=STATE_MAX_LEN,
                        prefill_chunk=spec["chunk"], device=dev)
    torch.cuda.synchronize()
    st = rt.split_cache.stats
    log(f"[{tag}] init (embedding scaled by {STATE_EMBED_SCALE}: at 1 "
        f"the tied head echoes the last token) + weight freeze "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{st.misses} weight splits, {st.cached_bytes / 1e9:.2f} GB "
        f"resident; device memory {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB ({(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB of it "
        f"this phase's)")

    fed = []                   # the bucket length of every prefill call
    prefill = rt._prefill

    def counted(toks, *args):
        fed.append(toks.shape[1])
        return prefill(toks, *args)
    rt._prefill = counted
    rng = np.random.default_rng(SEED)
    lens = spec["prompts"]
    prompts = [rng.integers(0, cfg.vocab, size=lens[i % len(lens)],
                            dtype=np.int32) for i in range(STATE_REQUESTS)]
    reset_launches()
    reqs = [rt.submit(p, STATE_GEN) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    sc = s["split_cache"]
    steps = sum(fed) + s["decode_steps"]
    log(f"[{tag}] {card}: {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s p95 {s['ttft_s']['p95']:.3f} s; {steps} model steps "
        f"({s['elapsed_s'] / steps * 1e3:.1f} ms a step): prefill calls "
        f"{s['prefill_calls']} of bucket lengths {sorted(set(fed))} "
        f"({sum(fed)} positions, {s['prefill_chunks']} non-final chunks), "
        f"decode steps {s['decode_steps']}; weight-split hit rate "
        f"{sc['weight_split_hit_rate']:.3f}")
    log(f"[{tag}] kernel launches {counts}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    c, splits, large = state_step_launches(cfg)
    want = {"split_fused": steps * splits, "group_gemm": steps * c * 4,
            "group_gemm_large": steps * large * 4,
            "scale_accum": steps * c}
    want["group_gemm_skinny"] = want["group_gemm"] - want["group_gemm_large"]
    got = {name: counts[name] for name in want}
    log(f"[{tag}] launches {got}, expected {want} ({steps} steps x {splits} "
        f"splits, {c * 4} group GEMMs of which {large * 4} large, {c} "
        f"epilogues)")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")
    if spec["chunk"] is not None and not (rt._decode_select and
                                          s["prefill_chunks"]):
        raise AssertionError(f"{tag}: chunked prefill did not interleave")
    if s["requests"]["finished"] != STATE_REQUESTS or \
            s["tokens_generated"] != STATE_REQUESTS * STATE_GEN:
        raise AssertionError(f"{tag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    if sc["weight_split_hit_rate"] != 1.0:
        raise AssertionError(f"{tag}: weight-split hit rate "
                             f"{sc['weight_split_hit_rate']}")
    check_monolithic(tag, model, cfg, rt, reqs[0], STATE_SLOTS, STATE_GEN,
                     dev)
    if len({t for r in reqs for t in r.generated}) <= STATE_REQUESTS:
        raise AssertionError(f"{tag}: the continuations barely vary; the "
                             f"monolithic check would not see the layers")
    tied_head_copies(tag, cfg, params, dev)

    with torch.no_grad():
        tk = torch.from_numpy(prompts[1][None, :16]).to(dev)
        emu = model.forward(rt.params, cfg.with_(dtype="float32"),
                            {"tokens": tk})
        nat = model.forward(params, cfg.with_(dtype="float32",
                                              engine_spec="f32"),
                            {"tokens": tk})
    if not bool(torch.isfinite(emu).all()) or emu.shape != nat.shape:
        raise AssertionError(f"{tag}: prefill logits not finite or "
                             f"misshapen")
    err_tok = ((emu - nat).abs().amax(dim=-1) / nat.abs().max())[0]
    log(f"[{tag}] prefill logits (1x16, f32 activations) vs the f32 engine: "
        f"max|diff| / max|logit| {float(err_tok.max()):.3e}; per token "
        f"{[float(f'{e:.2e}') for e in err_tok.tolist()]}")
    if float(err_tok.max()) >= 1e-3:
        raise AssertionError(f"{tag}: emulated prefill logits off by "
                             f"{float(err_tok.max()):.3e}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {card}: device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB (max_memory_allocated since the phase began; "
        f"predicted {predicted / 1e9:.1f} GB) of {total / 1e9:.1f} GB")
    del emu, nat
    rt._prefill = prefill
    mono = dict(reqs=reqs, counts=counts, steps=steps, s=s,
                cache_bytes=cache_bytes(rt.cache))
    serve_trace(rt, prompts, tag, s, trace_prompt=8, trace_gen=2,
                untraced_steps=steps, head=True)
    del rt, prefill, counted      # the bound method holds the runtime
    extra = {}
    if spec.get("paged"):
        extra[f"{tag}_paged"], _ = paged_pass(
            tag, cfg, params, prompts, STATE_GEN, mono, card, dev,
            slots=STATE_SLOTS, max_len=STATE_MAX_LEN)
        extra[f"{tag}_prefix"] = prefix_pass(
            tag, arch, cfg, params, [len(p) for p in prompts], STATE_GEN,
            card, dev, slots=STATE_SLOTS, max_len=STATE_MAX_LEN,
            chunk=spec["chunk"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, s, extra


# the context families served (serve_encdec, serve_vlm): SLOTS slots,
# REQUESTS requests of PROMPT tokens and GEN new ones, max_len PROMPT +
# GEN, whole prompts (pow2 buckets), after every earlier phase freed its
# model (the vlm last: its predicted peak is the script's largest)
CTX_SERVE = {"seamless_m4t_medium": "serve_encdec",
             "llama32_vision_11b": "serve_vlm"}
# the context archs served again paged (the vlm's peak leaves no room for
# a second runtime's frozen digits beside its weights)
CTX_PAGED = ("seamless_m4t_medium",)
# the context's scale: N(0, CTX_SCALE^2) patch embeddings (vlm) or frames
# (encdec); the vlm's gates drawn as +-U(0.5, 1.5) (tanh 0.46-0.91)
CTX_SCALE = 1.0


def ctx_step_launches(cfg, cross_len: int):
    """``(contractions, split launches, large-route contractions)`` of one
    model step of a context family under ``MODEL_SPEC`` with the weight
    splits frozen, the cross K/V of ``cross_len`` rows taken in key chunks
    of ``kv_chunk``: each chunk adds a scores and a p@v contraction (both
    sides split).  vlm: 9 contractions and 11 splits a self layer (7
    projection A sides, both sides of the 2 attention products); a cross
    layer 5 projections (``wq``, ``wo``, the MLP's 3) and the chunks'.
    encdec: a decoder layer's 4 self projections and 2 attention
    contractions, the cross ``wq``/``wo`` and the chunks', the GELU MLP's
    2.  Plus the LM head.  Decode attention has at most 4 query rows a KV
    head: the skinny route throughout."""
    nk = -(-cross_len // cfg.kv_chunk)
    if cfg.family == "vlm":
        ng, n_self = cfg.n_layers // cfg.cross_every, cfg.cross_every - 1
        c = ng * (n_self * 9 + 5 + 2 * nk) + 1
        return c, ng * (n_self * 11 + 5 + 4 * nk) + 1, 0
    c = cfg.n_layers * (10 + 2 * nk) + 1
    return c, cfg.n_layers * (12 + 4 * nk) + 1, 0


def ctx_context_gemms(cfg) -> int:
    """Group GEMMs of the context (all on the large route): the cross
    ``wk``/``wv`` of every cross layer, for the runtime's single-slot
    template and again for its slot cache; for encdec first the encoder
    over the frames (8 contractions a layer).  4 a contraction."""
    if cfg.family == "vlm":
        return 4 * 2 * 2 * (cfg.n_layers // cfg.cross_every)
    return 4 * (8 * cfg.enc_layers + 2 * 2 * cfg.n_layers)


def phase_serve_ctx(dev, arch, card):
    """Serve a context family's ``full()`` (random weights from the seed)
    under ``MODEL_SPEC`` through ``ServingRuntime`` with a per-slot
    context drawn from the seed (``CTX_SERVE``: seamless-m4t-medium at its
    12 + 12 layers, the context the encoder's output over PROMPT frames;
    llama-3.2-vision-11b at its 8 groups unless :func:`serve_depth`'s
    predicted peak does not fit, the context its 1600 patch rows, the
    gates drawn nonzero).  Checks: every group GEMM of the context on the
    large route (:func:`ctx_context_gemms`), every model step exactly
    :func:`ctx_step_launches` on the skinny route, request 0 equal to the
    monolithic loop, the weight-split hit rate 1.0, the 1x16 prefill
    logits in f32 activations within 1e-3 of max|logit| of the native f32
    engine at every token, and a second context moving them by more than
    that.  Logs tok/s, TTFT, ms a model step, the peak against its
    prediction beside ``card``, and traces a few steps."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import api, encdec
    from repro_torch.serving import ServingRuntime
    tag = CTX_SERVE[arch]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    cfg, predicted, why = serve_depth(
        configs.get_config(arch, engine_spec=MODEL_SPEC), free)
    _, n_params, n_wrapped = serve_memory(cfg)
    vlm = cfg.family == "vlm"
    if vlm:
        shape = (f"{cfg.n_layers} layers ({cfg.n_layers // cfg.cross_every}"
                 f" groups of {cfg.cross_every - 1} self + 1 gated cross), "
                 f"d_model {cfg.d_model}, heads {cfg.n_heads}/"
                 f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, {cfg.vision_seq} "
                 f"patch rows in key chunks of {cfg.kv_chunk}")
    else:
        shape = (f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder "
                 f"layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
                 f"{cfg.n_kv_heads} of {cfg.hd}, GELU d_ff {cfg.d_ff}, "
                 f"{PROMPT} encoder frames")
    log(f"[{tag}] {cfg.name}: {shape}, vocab {cfg.vocab}; {why}; "
        f"{n_params / 1e9:.3f} B f32 parameters, {n_wrapped / 1e9:.3f} B of "
        f"them frozen; predicted peak {predicted / 1e9:.1f} GB of "
        f"{free / 1e9:.1f} GB free (card {total / 1e9:.1f} GB); engine "
        f"{MODEL_SPEC}")
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(cfg, generator=gen, device=dev)
    gates = ""
    if vlm:
        for name in ("gate_attn", "gate_mlp"):
            g = params["groups"]["cross"][name]
            sign = torch.where(torch.rand(g.shape, generator=gen, device=dev)
                               < 0.5, -1.0, 1.0)
            g.copy_((torch.rand(g.shape, generator=gen, device=dev) + 0.5)
                    * sign)
        gates = (f"; gates drawn (the reference's are zero), tanh "
                 + ", ".join(f"{n} " + str([round(float(v), 2) for v in
                                            torch.tanh(params['groups'][
                                                'cross'][n]).tolist()])
                             for n in ("gate_attn", "gate_mlp")))
    rows = cfg.vision_seq if vlm else PROMPT

    def draw():
        return torch.randn((1, rows, cfg.d_model), generator=gen,
                           device=dev) * CTX_SCALE
    raw, raw2 = draw(), draw()        # patch embeddings, or frames

    def context(x):
        if vlm:
            return x
        with torch.no_grad():
            return encdec.encode(params, cfg, x)
    reset_launches()
    ctx = context(raw)
    rt = ServingRuntime(cfg, params, slots=SLOTS, max_len=PROMPT + GEN,
                        ctx=ctx, device=dev)
    torch.cuda.synchronize()
    ctx_counts = dict(LAUNCHES)
    st = rt.split_cache.stats
    want_ctx = ctx_context_gemms(cfg)
    log(f"[{tag}] init{gates} + context (N(0, {CTX_SCALE}^2) "
        f"{'patch embeddings' if vlm else 'frames through the encoder'}, "
        f"1 x {rows} x {cfg.d_model}) + weight freeze + cross K/V "
        f"{time.perf_counter() - t0:.1f} s: {st.misses} weight splits, "
        f"{st.cached_bytes / 1e9:.2f} GB resident; context group GEMMs "
        f"large {ctx_counts['group_gemm_large']}, skinny "
        f"{ctx_counts['group_gemm_skinny']} (expected {want_ctx} large); "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({(torch.cuda.memory_allocated() - held) / 1e9:.2f} GB of it this "
        f"phase's)")
    if (ctx_counts["group_gemm_large"], ctx_counts["group_gemm_skinny"]) \
            != (want_ctx, 0):
        raise AssertionError(f"{tag}: context group GEMMs {ctx_counts}, "
                             f"expected {want_ctx}, all large")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT, dtype=np.int32)
               for _ in range(REQUESTS)]
    reset_launches()
    reqs = [rt.submit(p, GEN) for p in prompts]
    s = rt.run()
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    sc = s["split_cache"]
    bucket = rt.sched.bucket_fn(PROMPT)
    steps = s["prefill_calls"] * bucket + s["decode_steps"]
    log(f"[{tag}] {card}: {s['tokens_generated']} tokens from "
        f"{s['requests']['finished']} requests in {s['elapsed_s']:.2f} s: "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT mean {s['ttft_s']['mean']:.3f}"
        f" s p95 {s['ttft_s']['p95']:.3f} s; {steps} model steps "
        f"({s['elapsed_s'] / steps * 1e3:.1f} ms a step): prefill calls "
        f"{s['prefill_calls']} of bucket {bucket}, decode steps "
        f"{s['decode_steps']}; weight-split hit rate "
        f"{sc['weight_split_hit_rate']:.3f}")
    log(f"[{tag}] kernel launches {counts}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    c, splits, large = ctx_step_launches(cfg, rows)
    want = {"split_fused": steps * splits, "group_gemm": steps * c * 4,
            "group_gemm_large": steps * large * 4,
            "scale_accum": steps * c}
    want["group_gemm_skinny"] = want["group_gemm"] - want["group_gemm_large"]
    got = {name: counts[name] for name in want}
    log(f"[{tag}] launches {got}, expected {want} ({steps} steps x {splits} "
        f"splits, {c * 4} group GEMMs, all skinny, {c} epilogues)")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")
    if s["requests"]["finished"] != REQUESTS or \
            s["tokens_generated"] != REQUESTS * GEN:
        raise AssertionError(f"{tag} finished {s['requests']} with "
                             f"{s['tokens_generated']} tokens")
    if sc["weight_split_hit_rate"] != 1.0:
        raise AssertionError(f"{tag}: weight-split hit rate "
                             f"{sc['weight_split_hit_rate']}")
    check_monolithic(tag, model, cfg, rt, reqs[0], SLOTS, GEN, dev, ctx=ctx)
    if len({t for r in reqs for t in r.generated}) <= REQUESTS:
        raise AssertionError(f"{tag}: the continuations barely vary; the "
                             f"monolithic check would not see the layers")

    key = "image_embeds" if vlm else "frames"
    f32 = cfg.with_(dtype="float32")
    with torch.no_grad():
        tk = torch.from_numpy(prompts[1][None, :16]).to(dev)
        emu, emu2 = (model.forward(rt.params, f32, {"tokens": tk, key: x})
                     for x in (raw, raw2))
        nat = model.forward(params, f32.with_(engine_spec="f32"),
                            {"tokens": tk, key: raw})
    if not bool(torch.isfinite(emu).all()) or emu.shape != nat.shape:
        raise AssertionError(f"{tag}: prefill logits not finite or "
                             f"misshapen")
    scale = nat.abs().max()
    err_tok = ((emu - nat).abs().amax(dim=-1) / scale)[0]
    moved = float((emu2 - emu).abs().max() / scale)
    log(f"[{tag}] prefill logits (1x16, f32 activations) vs the f32 engine: "
        f"max|diff| / max|logit| {float(err_tok.max()):.3e}; per token "
        f"{[float(f'{e:.2e}') for e in err_tok.tolist()]}; a second context "
        f"moves them by {moved:.3e} of max|logit| (must exceed 1e-3)")
    if float(err_tok.max()) >= 1e-3:
        raise AssertionError(f"{tag}: emulated prefill logits off by "
                             f"{float(err_tok.max()):.3e}")
    if moved <= 1e-3:
        raise AssertionError(f"{tag}: a second context moves the logits by "
                             f"only {moved:.3e}: the cross path is vacuous")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {card}: device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB (max_memory_allocated since the phase began; "
        f"predicted {predicted / 1e9:.1f} GB) of {total / 1e9:.1f} GB")
    del emu, emu2, nat
    mono = dict(reqs=reqs, counts=counts, steps=steps, s=s,
                cache_bytes=cache_bytes(rt.cache))
    serve_trace(rt, prompts, tag, s, trace_prompt=8, trace_gen=2,
                untraced_steps=steps)
    del rt
    extra = {}
    if arch in CTX_PAGED:
        extra[f"{tag}_paged"], _ = paged_pass(
            tag, cfg, params, prompts, GEN, mono, card, dev, slots=SLOTS,
            max_len=PROMPT + GEN, pool=PAGE_POOL, ctx=ctx)
    del params, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return counts, s, extra


def serve_trace(rt, prompts, tag, untraced, *, prompt_len=PROMPT,
                trace_prompt=8, trace_gen=4, untraced_steps=None,
                head=False):
    """The device's idle share while serving: one more request a slot
    (prompt ``trace_prompt``, ``trace_gen`` new tokens) through the same
    runtime under torch.profiler, tracing the card only (CUPTI).  Busy
    time is the union of the kernel, copy and set intervals, over the span
    from the first one's start to the last one's end.  A model step is one
    decode step of the model: every prefill call here and in ``untraced``
    (prompts of ``prompt_len``) feeds whole prompts of one length
    position by position over the scheduler's bucket length (serve: 11
    steps here, 94 in ``untraced``); ``untraced_steps`` overrides the
    count of ``untraced``'s (chunked or mixed-length prefills).  The five
    largest kernels of the "other" class are listed by name; ``head``: the
    tied LM head's split and group GEMMs apart (:func:`trace_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rt.reset_metrics()
    for p in prompts[:rt.n_slots]:
        rt.submit(p[:trace_prompt], trace_gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = rt.run()
        torch.cuda.synchronize()
    # a prefill call runs the decode step over its prompt's bucket length
    bucket = rt.sched.bucket_fn
    steps = s["prefill_calls"] * bucket(trace_prompt) + s["decode_steps"]
    step_ms = s["elapsed_s"] / steps * 1e3
    if untraced_steps is None:
        untraced_steps = untraced["prefill_calls"] * bucket(prompt_len) + \
            untraced["decode_steps"]
    base_ms = untraced["elapsed_s"] / untraced_steps * 1e3
    trace_summary(prof, tag, steps, step_ms, base_ms, head=head)


def trace_summary(prof, tag, steps, step_ms, base_ms, what="model steps",
                  head=False):
    """Log a CUDA profiler trace of ``steps`` steps: the device's busy
    time and idle share (the union of the kernel, copy and set intervals,
    over the span from the first one's start to the last one's end), the
    operations and device ms a step by kernel class (:func:`trace_class`)
    and the five largest kernels of the "other" class by name, beside the
    traced (``step_ms``) and untraced (``base_ms``) wall ms a step.
    ``head``: the tied LM head's share of the split and group GEMM classes
    apart, told by its launch grid (its B split and its group GEMMs have
    the largest grids of their classes: a block per 32 vocab columns, a
    tile per vocab columns)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:     # tens of MB: not kept
        out = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(out))
        events = json.loads(out.read_text()).get("traceEvents", [])
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ops)
    if not spans:
        log(f"[{tag}] trace: no device events recorded; the device's idle "
            f"share is not measured")
        return
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    log(f"[{tag}] trace ({steps} {what}, {len(spans)} device "
        f"operations, {len(spans) / steps:.0f} a step): device busy "
        f"{busy / 1e3:.2f} of {span / 1e3:.2f} ms, idle share "
        f"{1 - busy / span:.4f}; {busy / steps / 1e3:.3f} ms of device time "
        f"and {step_ms:.2f} ms of wall time a step traced ({base_ms:.2f} ms "
        f"a step in the untraced run)")
    by, other = {}, {}
    for e in ops:
        cls = trace_class(e)
        n, us = by.get(cls, (0, 0.0))
        by[cls] = (n + 1, us + float(e["dur"]))
        if cls == "other (PyTorch)":
            name = e.get("name", "")[:110]
            n, us = other.get(name, (0, 0.0))
            other[name] = (n + 1, us + float(e["dur"]))
    log(f"[{tag}] trace by kernel, a {what[:-1]}: " + "; ".join(
        f"{cls} {by.get(cls, (0, 0.0))[0] / steps:.1f} operations, "
        f"{by.get(cls, (0, 0.0))[1] / steps / 1e3:.3f} ms"
        for cls in TRACE_CLASSES))
    top = sorted(other.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"[{tag}] trace, the largest other PyTorch kernels a {what[:-1]}: "
        + "; ".join(f"{name} x{n / steps:.1f} {us / steps / 1e3:.3f} ms"
                    for name, (n, us) in top))
    if head:
        parts = []
        for cls in ("split", "group GEMM"):
            grid = {id(e): math.prod(e.get("args", {}).get("grid", [0]))
                    for e in ops if trace_class(e) == cls}
            top = max(grid.values(), default=0)
            if not top:
                parts.append(f"{cls} not measured (no launch grid traced)")
                continue
            evs = [e for e in ops if grid.get(id(e)) == top]
            ms = sum(float(e["dur"]) for e in evs) / steps / 1e3
            parts.append(f"{cls} {len(evs) / steps:.1f} operations, "
                         f"{ms:.3f} ms ({top} blocks a launch)")
        log(f"[{tag}] trace, the tied LM head a {what[:-1]}: "
            + "; ".join(parts))


TRACE_CLASSES = ("split", "group GEMM", "epilogue", "other (PyTorch)",
                 "memset/memcpy")


def trace_class(event) -> str:
    """The port's kernel a traced device operation belongs to, by its
    name (the kernels' names in ``kernels/csrc``), else PyTorch's own
    kernels, or a memset/memcpy (the skinny group GEMM zeroes its output
    with one)."""
    if event.get("cat") != "kernel":
        return "memset/memcpy"
    name = event.get("name", "")
    if "split_rows" in name or "split_cols" in name:
        return "split"
    if "skinny::" in name or "large::" in name:
        return "group GEMM"
    if "scale_accum" in name or "unscale_kernel" in name:
        return "epilogue"
    return "other (PyTorch)"


# ---------------------------------------------------------------------------
# phase 5: flash attention through the reference's entry point
# ---------------------------------------------------------------------------

def phase_flash(dev):
    """``ops.flash_attention`` and the kernel-level forward -> backward
    chain at internlm2-1.8b's attention width (causal, GQA 16/8).  In f32
    (the 3xTF32 route) they are held to the port's model attention and to
    autograd of the naive oracle; in bf16 (the wgmma route) to the bf16
    bound against the f32 route on the same bf16-rounded inputs.  Both
    routes must have launched both kernels."""
    import torch
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention_flash
    B, L, H, KV, D = (ATTN[x] for x in ("B", "L", "H", "KV", "D"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q, k, v = (torch.randn(sh, generator=gen, device=dev)
               for sh in ((B, L, H, D), (B, L, KV, D), (B, L, KV, D)))
    dout = torch.randn((B * H, L, D), generator=gen, device=dev)
    group = H // KV

    def chain(q, k, v, dout):
        qt, kt, vt = (x.transpose(1, 2).reshape(-1, L, D) for x in (q, k, v))
        o = ops.flash_attention(q, k, v, causal=True)
        o_t, lse = fa.flash_attention_fwd(qt, kt, vt, group=group)
        grads = fa.flash_attention_bwd(qt, kt, vt, o_t, lse, dout,
                                       group=group)
        return o, (qt, kt, vt), grads

    bf16 = torch.bfloat16
    q16, k16, v16, do16 = (x.to(bf16) for x in (q, k, v, dout))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    o, leaves, grads = chain(q, k, v, dout)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    o16, _, grads16 = chain(q16, k16, v16, do16)
    torch.cuda.synchronize()
    dt16 = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    for name in ("flash_attention_fwd", "flash_attention_bwd", "flash_wgmma",
                 "flash_tf32x3"):
        if counts[name] <= 0:
            raise AssertionError(f"flash path launched no {name} kernel")
    for x in (o, o16) + tuple(grads) + tuple(grads16):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("flash outputs not finite")
    if o.shape != q.shape or o16.shape != q.shape or o16.dtype != bf16:
        raise AssertionError("flash outputs misshapen")
    with torch.no_grad():
        want = attention_flash(q, k, v, causal=True)
    ok, err_model, _ = close(o, want, 3e-5)
    if not ok:
        raise AssertionError(f"ops.flash_attention differs from "
                             f"layers.attention_flash by {err_model:.3e}")
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    ref = fa.flash_attention_ref(*leaves, group=group)
    auto = torch.autograd.grad((ref * dout).sum(), leaves)
    ok, err_grad, _ = close(tuple(grads), tuple(auto), 2e-4)
    if not ok:
        raise AssertionError(f"flash backward differs from autograd of the "
                             f"naive oracle by {err_grad:.3e}")
    del ref, auto, leaves, grads
    # the f32 route on the same bf16-rounded inputs is what the bf16 route
    # is held to (these launches come after the path's counts were read)
    o32, _, grads32 = chain(*(x.float() for x in (q16, k16, v16, do16)))
    ok, err16, need = close((o16,) + tuple(grads16), (o32,) + tuple(grads32),
                            None)
    if not ok:
        raise AssertionError(f"bf16 flash differs from the f32 route by "
                             f"{err16:.3e} (needs atol {need:.2e} max|y|)")
    log(f"[flash] B{B} L{L} H{H} KV{KV} D{D} causal: f32 (3xTF32) "
        f"ops.flash_attention + forward + backward {dt * 1e3:.1f} ms, vs "
        f"layers.attention_flash max|diff| {err_model:.3e} (<= 3e-5), "
        f"(dq, dk, dv) vs autograd of the naive oracle max|diff| "
        f"{err_grad:.3e} (<= 2e-4); bf16 (wgmma) the same {dt16 * 1e3:.1f} "
        f"ms, vs the f32 route max|diff| {err16:.3e} (needs atol "
        f"{need:.2e} max|y| <= {BF16_ATOL:.0e}); launches {counts}")
    del o32, grads32, grads16
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

def _proj(n: int, m: int, p: int):
    """A contraction of ``m`` rows of length ``n`` into ``p`` columns (a
    projection, or an E-batched expert product, one launch set for the
    batch): ``(forward, backward)`` as ``(n, m)`` pairs.  The backward's
    input cotangent contracts the ``p`` columns over the same rows, its
    weight cotangent the ``m`` rows into ``p`` rows (``_OzDotGeneral``)."""
    return [(n, m)], [(p, m), (m, p)]


def _flash(D: int, Dv: int, G: int, Lq: int, Lk: int, q_chunk: int,
           kv_chunk: int):
    """``layers.attention_flash`` through the engine: a (q chunk, key
    chunk) block's scores (contract D over G qc rows) and p@v (contract
    kc); its recompute backward's s, dv, dp, dq and dk.  Every block runs,
    masked or not."""
    qc, kc = min(q_chunk, Lq), min(kv_chunk, Lk)
    blocks = -(-Lq // qc) * -(-Lk // kc)
    gq = G * qc
    return [(D, gq), (kc, gq)] * blocks, \
        [(D, gq), (gq, kc), (Dv, gq), (kc, gq), (gq, kc)] * blocks


def _unit(*parts):
    """The forward and backward contractions of several parts in one."""
    return ([c for f, _ in parts for c in f],
            [c for _, b in parts for c in b])


def _attn(cfg, B: int, Lq: int, Lk: Optional[int] = None,
          kv_rows: Optional[int] = None):
    """GQA attention (``transformer.attn_block``, a cross layer's when
    ``Lk`` / ``kv_rows`` name the memory): q, k, v, the flash blocks and
    the output projection."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T, Lk = B * Lq, Lk or Lq
    kv_rows = kv_rows or T
    return _unit(_proj(d, T, H * hd), _proj(d, kv_rows, KV * hd),
                 _proj(d, kv_rows, KV * hd),
                 _flash(hd, hd, H // KV, Lq, Lk, cfg.q_chunk, cfg.kv_chunk),
                 _proj(H * hd, T, d))


def _mlp(cfg, T: int, f: Optional[int] = None):
    d, f = cfg.d_model, f or cfg.d_ff
    if cfg.mlp_type == "gelu":
        return _unit(_proj(d, T, f), _proj(f, T, d))
    return _unit(_proj(d, T, f), _proj(d, T, f), _proj(f, T, d))


def _moe_layer(cfg, B: int, L: int, expert_ranks: int = 1):
    """A MoE layer: GQA or MLA attention; the three E-batched expert
    products over the capacity's rows (under the all-to-all over
    ``expert_ranks`` data ranks, over every rank's capacity rows); the
    shared experts (the f32 router is no emulated contraction)."""
    from repro_torch.models import moe
    d, T, fe = cfg.d_model, B * L, cfg.d_ff_expert
    if cfg.family == "mla_moe":
        H, hd, dr, dl = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora
        vd = cfg.v_head_dim or hd
        attn = _unit(_proj(d, T, dl), _proj(d, T, dr),
                     _proj(d, T, H * (hd + dr)), _proj(dl, T, H * hd),
                     _proj(dl, T, H * vd),
                     _flash(hd + dr, vd, 1, L, L, cfg.q_chunk,
                            cfg.kv_chunk), _proj(H * vd, T, d))
    else:
        attn = _attn(cfg, B, L)
    cap = moe._capacity(cfg, T) * expert_ranks
    parts = [attn, _proj(d, cap, fe), _proj(d, cap, fe), _proj(fe, cap, d)]
    if cfg.n_shared_experts:
        parts.append(_mlp(cfg, T, fe * cfg.n_shared_experts))
    return _unit(*parts)


def train_step_contractions(cfg, B: int, L: int, expert_ranks: int = 1):
    """``(n, m)`` of every emulated contraction of one train step of
    ``cfg`` at batch ``B`` x seq ``L`` (an encdec batch's ``L`` frames):
    its contraction length and rows.  A unit of the layer stack runs its
    forward once, once more in the remat recompute (every contraction of
    a remat block saves its operands, so the recompute reaches them all)
    and its backward once; the vlm's self layers, remat blocks nested in
    their group's, run a third forward in their own recompute; the
    hybrid's tail layers sit outside the remat blocks (one forward).  The
    LM head (or the tied ``embed.T``) runs forward and backward once.
    dense: 9 a layer (7 projections, the scores and p@v); moe: 12 (+ the
    3 expert products and 3 shared ones, attention's 7 with 2 flash);
    mla_moe: 14; ssm: 2 (``w_in``, ``w_out``); hybrid: 18 a pattern block
    and 5 a tail layer; vlm: 9 a self layer and 9 (+ 2 a further key
    chunk) a cross layer, whose ``wk``/``wv`` read the patch rows; encdec:
    8 an encoder layer over the frames, 15 a decoder layer.
    ``expert_ranks``: the data ranks a MoE's all-to-all exchanges the
    experts' tokens over (``B`` is then a rank's rows)."""
    d, T, fam = cfg.d_model, B * L, cfg.family
    head = _proj(d, T, cfg.padded_vocab)
    units = []                                   # (unit, forward runs)
    if fam == "dense":
        units = [(_unit(_attn(cfg, B, L), _mlp(cfg, T)), 2)] * cfg.n_layers
    elif fam in ("moe", "mla_moe"):
        units = [(_moe_layer(cfg, B, L, expert_ranks), 2)] * cfg.n_layers
    elif fam == "ssm":
        d_inner = cfg.expand * d
        p_in = 2 * d_inner + 2 * cfg.d_state + d_inner // cfg.ssm_headdim
        units = [(_unit(_proj(d, T, p_in), _proj(d_inner, T, d)), 2)] * \
            cfg.n_layers
    elif fam == "hybrid":
        w = cfg.lru_width or d
        rec = _unit(_proj(d, T, w), _proj(d, T, w), _proj(w, T, d),
                    _mlp(cfg, T))
        n_r = sum(1 for c in cfg.pattern if c == "R")
        block = _unit(*[rec] * n_r, _attn(cfg, B, L), _mlp(cfg, T))
        units = [(block, 2)] * cfg.n_pattern_blocks + \
            [(rec, 1)] * cfg.n_tail_layers
    elif fam == "vlm":
        KV, hd, Lv = cfg.n_kv_heads, cfg.hd, cfg.vision_seq
        cross = _unit(_attn(cfg, B, L, Lk=Lv, kv_rows=B * Lv), _mlp(cfg, T))
        self_layer = _unit(_attn(cfg, B, L), _mlp(cfg, T))
        per_group = [(self_layer, 3)] * (cfg.cross_every - 1) + [(cross, 2)]
        units = per_group * (cfg.n_layers // cfg.cross_every)
    elif fam == "encdec":
        enc = _unit(_attn(cfg, B, L), _mlp(cfg, T))
        dec = _unit(_attn(cfg, B, L), _attn(cfg, B, L, Lk=L, kv_rows=T),
                    _mlp(cfg, T))
        units = [(enc, 2)] * cfg.enc_layers + [(dec, 2)] * cfg.n_layers
    else:
        raise ValueError(f"no train-step construction for {fam!r}")
    out = [c for (fwd, _), runs in units for c in fwd * runs]
    out += head[0] + [c for (_, bwd), _ in units for c in bwd] + head[1]
    return out


def train_step_launches(cfg, B: int, L: int, expert_ranks: int = 1):
    """Kernel launches of one train step under ``MODEL_SPEC`` by
    construction (:func:`train_step_contractions`): two splits and one
    df32 epilogue a contraction, and a group GEMM for each chunk of the
    anti-diagonal groups 2..5 at the group-EF limit r of its contraction
    length (r >= 4 gives one chunk a group; an LM head's input cotangent,
    n = 92672 and wider, has r = 1 and ten one-pair chunks); a group GEMM
    takes the large route above ``SKINNY_MAX_M`` rows (every stack here is
    TMA-aligned)."""
    from repro_torch.core.accumulate import _group_chunks
    from repro_torch.core.splitting import compute_beta, compute_r
    from repro_torch.kernels.group_gemm import SKINNY_MAX_M
    cs = train_step_contractions(cfg, B, L, expert_ranks)
    chunks = [len(list(_group_chunks(4, compute_r(n, compute_beta(n)))))
              for n, _ in cs]
    large = sum(c for c, (_, m) in zip(chunks, cs) if m > SKINNY_MAX_M)
    return {"split_fused": 2 * len(cs), "group_gemm": sum(chunks),
            "group_gemm_large": large,
            "group_gemm_skinny": sum(chunks) - large,
            "scale_accum": len(cs)}, len(cs)


def phase_train(dev):
    """Train full-width internlm2-1.8b (24 layers, remat blocks of 4;
    random weights from the seed; the synthetic pipeline at global batch 8
    x seq 256; the launcher's AdamW warmup rule) under ``MODEL_SPEC``.

    1. Step 0 against the native f32 engine (TF32 off) on the same
       parameters and batch, both with f32 activations so that the
       comparison sees the GEMMs and not bf16 rounding: the loss within
       1e-5, every gradient leaf within 1e-3 of its max|g|; the same
       against the native f64 engine in f64 activations (the witness);
       the native bf16 engine in the emulation's place must not pass
       these limits (the control); forward + backward timed for both f32
       engines.
    2. ``repro_torch.launch.train.train`` (the user's entry point, the
       published bf16 activations) for 4 steps: exact kernel launches a
       step (:func:`train_step_launches`, routes included), every loss and
       grad norm finite, ms a step (step 0 apart), tokens/s and the peak
       device memory.
    3. One more step under torch.profiler: device time by kernel class;
       then the comparison of 1 on the trained parameters, the emulation
       held to the f64 witness within the same limits.
    4. The run of 2 under the native f32 engine: its ms a step.
    """
    import gc
    import torch
    from repro_torch import configs, optim, tree
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    B, L, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    cfg = configs.get_config("internlm2_1_8b", engine_spec=MODEL_SPEC)
    per_step, n_contr = train_step_launches(cfg, B, L)
    log(f"[train] {cfg.name}: {cfg.n_layers} layers (depth not cut), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat blocks of "
        f"{cfg.remat_block}; global batch {B} x seq {L}; engine "
        f"{MODEL_SPEC}; {n_contr} emulated contractions a step")
    pipe = Pipeline(DataConfig(seq_len=L, global_batch=B, vocab=cfg.vocab,
                               seed=SEED))

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(step).items()}

    def grads_under(params, batch, spec, dtype="float32", timed=False):
        """``(loss, gradients, forward + backward ms)`` of ``params`` on
        ``batch`` under ``spec`` in ``dtype`` activations (timed after a
        warm-up call when ``timed``)."""
        c = cfg.with_(dtype=dtype, engine_spec=spec)
        if timed:
            S.loss_and_grads(c, params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = S.loss_and_grads(c, params, batch)
        torch.cuda.synchronize()
        return float(loss), g, (time.perf_counter() - t0) * 1e3

    def parted(runs, a, b, what):
        """``runs[a]`` against ``runs[b]``: ``(|loss difference|, worst
        leaf's max|diff| / max|g of b|, its name)``, logged with every
        leaf's reading."""
        (la, ga, _), (lb, gb, _) = runs[a], runs[b]
        per = {name: float((x - y).abs().max() / y.abs().max())
               for name, x, y in zip(_leaf_paths(gb), tree.leaves(ga),
                                     tree.leaves(gb))}
        worst_name = max(per, key=lambda k: (not math.isfinite(per[k]),
                                             per[k]))
        dloss = abs(la - lb)
        log(f"[train] {what}, {a} vs {b}: loss {la:.6f} vs {lb:.6f}, "
            f"|diff| {dloss:.3e}; max|diff| / max|g| by leaf: "
            + ", ".join(f"{k} {v:.3e}" for k, v in per.items())
            + f"; worst {worst_name}")
        return dloss, per[worst_name], worst_name

    def against_native(params, batch, what, control=False):
        """Loss and gradients of ``params`` on ``batch`` under the
        emulation and the native f32 engine (f32 activations, each timed),
        the native f64 engine in f64 activations as the witness of both,
        and with ``control`` the native bf16 engine (f32 activations) in
        the emulation's place.  Logs each pair; returns the emulated-vs-f32
        reading, the emulated-vs-f64 one and (``control``) bf16-vs-f32."""
        runs = {spec: grads_under(params, batch, spec, timed=True)
                for spec in ("f32", MODEL_SPEC)}
        runs["f64"] = grads_under(params, batch, "f64", "float64")
        if control:
            runs["bf16"] = grads_under(params, batch, "bf16")
        emu_ms, f32_ms = runs[MODEL_SPEC][2], runs["f32"][2]
        log(f"[train] {what} in f32 activations (the f64 witness in f64 "
            f"activations; norms, softmax statistics and the loss stay "
            f"f32 as the model defines them): forward + backward "
            f"{emu_ms:.1f} ms emulated, {f32_ms:.1f} ms native f32, TF32 "
            f"off ({emu_ms / f32_ms:.2f}x)")
        out = [parted(runs, MODEL_SPEC, "f32", what),
               parted(runs, MODEL_SPEC, "f64", what)]
        parted(runs, "f32", "f64", what)
        if control:
            out.append(parted(runs, "bf16", "f32", what))
            parted(runs, "bf16", "f64", what)
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def within(reading, what):
        dloss, worst, worst_name = reading
        if not math.isfinite(dloss) or dloss > 1e-5:
            raise AssertionError(f"train: loss off {what} by {dloss:.3e} "
                                 f"(> 1e-5)")
        if not math.isfinite(worst) or worst > 1e-3:
            raise AssertionError(f"train: gradient {worst_name} off {what} "
                                 f"by {worst:.3e} of its max|g| (> 1e-3)")

    # 1. step 0 against the native f32 engine and the f64 witness, f32
    # activations; the bf16 engine in the emulation's place must fail the
    # same limits, or they could not tell a lower-precision engine apart
    params = api.get_model(cfg).init(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    vs_f32, vs_f64, bf16_vs_f32 = against_native(params, batch_at(0),
                                                 "step 0", control=True)
    within(vs_f32, "the native f32 engine at step 0")
    within(vs_f64, "the f64 witness at step 0")
    b_loss, b_worst, b_name = bf16_vs_f32
    if b_loss <= 1e-5 and b_worst <= 1e-3:
        raise AssertionError(f"train: the bf16 engine passes the step-0 "
                             f"limits too (loss {b_loss:.3e}, {b_name} "
                             f"{b_worst:.3e}): they do not tell the "
                             f"emulation from bf16")
    log(f"[train] step 0 within its limits against the f32 engine and the "
        f"f64 witness: |loss diff| <= 1e-5, every gradient leaf within 1e-3 "
        f"of its max|g|; the bf16 control does not pass them (loss "
        f"{b_loss:.3e}, worst leaf {b_name} {b_worst:.3e})")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the trainer, the user's entry point
    def run(engine, tag):
        """``train()`` under ``engine``: (state, per-step (metrics,
        seconds), peak bytes); logs the steps' losses, times and peak."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        seen = []
        state, _ = train(
            "internlm2_1_8b", smoke=False, n_steps=n_steps, global_batch=B,
            seq_len=L, engine=engine, seed=SEED, log_every=1, device=dev,
            print_fn=log, on_step=lambda step, m, sec: seen.append((m, sec)))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        bad = [m for m, _ in seen if not (math.isfinite(m["loss"]) and
                                          math.isfinite(m["grad_norm"]))]
        if len(seen) != n_steps or bad:
            raise AssertionError(f"train ({tag}): {len(seen)} steps, "
                                 f"non-finite metrics {bad}")
        step_s = [sec for _, sec in seen[1:]]
        mean_s = sum(step_s) / len(step_s)
        log(f"[train] {tag}: {param_count(state.params) / 1e9:.3f} B f32 "
            f"parameters; losses {[round(m['loss'], 6) for m, _ in seen]}, "
            f"grad norms {[round(m['grad_norm'], 4) for m, _ in seen]}; "
            f"step 0 {seen[0][1] * 1e3:.1f} ms, steps 1-{n_steps - 1} "
            f"{[round(x * 1e3, 1) for x in step_s]} ms: {mean_s * 1e3:.1f} "
            f"ms a step, {B * L / mean_s:.0f} tokens/s; peak device memory "
            f"{peak / 1e9:.2f} GB (max_memory_allocated; "
            f"{held / 1e9:.2f} GB held before)")
        return state, mean_s

    reset_launches()
    state, mean_s = run(MODEL_SPEC, MODEL_SPEC)
    counts = dict(LAUNCHES)
    want = {k: v * n_steps for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    log(f"[train] kernel launches {counts}")
    log(f"[train] {n_steps} steps: launches {got}, expected {want} (a step: "
        f"{per_step['split_fused']} splits, {per_step['group_gemm']} group "
        f"GEMMs of which {per_step['group_gemm_large']} large, "
        f"{per_step['scale_accum']} df32 epilogues)")
    if got != want:
        raise AssertionError(f"train: launch counts {got}, expected {want}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"train path launched no {name} kernel")

    # 3. one more step traced by kernel class
    step_fn = S.make_train_step(cfg, optim.OptConfig(  # the launcher's
        lr=3e-3, warmup_steps=min(20, n_steps // 5 + 1),
        total_steps=n_steps))
    batch = batch_at(n_steps)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    trace_summary(prof, "train", 1, traced_ms, mean_s * 1e3,
                  what="train steps")
    # the comparison of 1 again on the trained parameters (past the loss
    # spike): held to the f64 witness, since there the native f32 engine
    # parts from it by ~1.2e-3 of max|g| and the emulation by ~1.6e-4
    params = state.params
    del state, metrics, prof
    gc.collect()
    torch.cuda.empty_cache()
    what = f"after {n_steps + 1} steps"
    within(against_native(params, batch, what)[1], f"the f64 witness {what}")
    log(f"[train] {what} within its limits against the f64 witness")
    del params, batch

    # 4. the same run under the native f32 engine (TF32 off), for its time
    state, native_s = run("f32", "native f32 engine")
    log(f"[train] a step: {mean_s * 1e3:.1f} ms under {MODEL_SPEC}, "
        f"{native_s * 1e3:.1f} ms under the native f32 engine "
        f"({mean_s / native_s:.2f}x)")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6b: train_families
# ---------------------------------------------------------------------------

# the six families besides the dense one, the smallest first
TRAIN_FAMILIES = ("mamba2_780m", "seamless_m4t_medium", "deepseek_moe_16b",
                  "recurrentgemma_9b", "llama32_vision_11b",
                  "deepseek_v2_236b")
TRAIN_FAMILY_STEPS = 3
# one deepseek-v2-236b layer holds 5.1 B parameters at its 160 routed
# experts (~158 GB of training state at TRAIN_BYTES_A_PARAM): the routed
# experts are cut to 16 (top-6 and the 2 shared kept), every width as
# published
TRAIN_WIDTH_CUT = {"deepseek_v2_236b": dict(n_experts=16)}
# a train phase's peak over its f32 parameters at batch 8 x seq 256
# (parameters, gradients, AdamW's moments with the functional update's
# new copies, the activations), measured on an H100 80GB: 31.1 for the
# dense internlm2-1.8b, 32.0-33.2 for the cut deepseek-moe-16b,
# deepseek-v2-236b and llama-3.2-vision-11b, 34.2 / 36.9 for the uncut
# seamless-m4t-medium and mamba2-780m; the largest of the cut ones
TRAIN_BYTES_A_PARAM = 33.2
# and besides, an element of a tied head's ``embed``: its B side split at
# every head contraction (int8 digits and scales beside the f32 view) and
# its gradient gathered from the head and from the lookup.  mamba2 (77 M
# elements) peaked 2.9 GB above 33.2 B a parameter; recurrentgemma-9b at
# 2 pattern blocks (2.16 B parameters, 1.05 B of them its embedding) ran
# out of the 85.0 GB card in the AdamW update
TRAIN_TIED_BYTES = 12.0
# what the allocator holds reserved but cannot place beside a train
# phase's peak: recurrentgemma-9b at 2 pattern blocks and deepseek-v2 at
# 2 layers (76.62 GB peak) ran out with 7.7 / 7.6 GiB of it
TRAIN_ALLOCATOR_RESERVE = 8.3e9
# the families small enough for an f64 witness beside step 0's runs
TRAIN_WITNESS_MAX = 1.5e9


# ZeRO-1 over the data ranks splits AdamW's two moments and their
# functional update's new copies: 4 f32 tensors, 16 bytes a parameter
TRAIN_ZERO_BYTES = 16.0


def train_memory(cfg, ranks: int = 1) -> tuple:
    """``(predicted peak bytes, f32 parameters)`` of a train phase on
    ``cfg`` at ``TRAIN`` batch and seq: :data:`TRAIN_BYTES_A_PARAM` a
    parameter of the tree built on the meta device, less the share of
    :data:`TRAIN_ZERO_BYTES` that ZeRO-1 over ``ranks`` data ranks moves
    to the other ranks, :data:`TRAIN_TIED_BYTES` an element of a tied
    head's ``embed``, and ``DEPTH_HEADROOM``: a rank's peak.  The
    activations are counted at the whole batch even when a rank holds a
    share of it."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    tree = api.get_model(cfg).init(cfg, generator=torch.Generator(),
                                   device="meta")
    n = param_count(tree)
    tied = 0 if "lm_head" in tree else tree["embed"].numel()
    per = TRAIN_BYTES_A_PARAM - TRAIN_ZERO_BYTES * (1 - 1 / ranks)
    return int(per * n + TRAIN_TIED_BYTES * tied + DEPTH_HEADROOM), n


def train_depth(cfg, free_bytes: int, ranks: int = 1):
    """``(cfg, predicted peak, why)``: the published depth if its
    predicted peak (:func:`train_memory`) and
    :data:`TRAIN_ALLOCATOR_RESERVE` fit ``free_bytes`` (its share
    ``free_bytes / ranks`` when ``ranks`` data ranks share the card, each
    with ZeRO-1), else the most whole units that fit, each cut with remat
    blocks that divide it: layers (moe, mla_moe, ssm), both stacks
    together (encdec), the vlm's groups of ``cross_every`` layers, the
    hybrid's pattern blocks with the tail cut first."""
    import math
    fam = cfg.family

    def rb(k):
        return math.gcd(cfg.remat_block, k)
    if fam == "hybrid":
        nb, what = cfg.n_pattern_blocks, "(R, R, A) pattern blocks, no tail"
        cands = [cfg.with_(n_pattern_blocks=k, n_tail_layers=0,
                           n_layers=k * len(cfg.pattern), remat_block=rb(k))
                 for k in range(nb, 0, -1)]
    elif fam == "vlm":
        nb, what = cfg.n_layers // cfg.cross_every, \
            f"groups of {cfg.cross_every - 1} self + 1 cross layer"
        cands = [cfg.with_(n_layers=k * cfg.cross_every, remat_block=rb(k))
                 for k in range(nb, 0, -1)]
    elif fam == "encdec":
        nb, what = cfg.n_layers, "encoder + decoder layers"
        cands = [cfg.with_(n_layers=k, enc_layers=k, remat_block=rb(k))
                 for k in range(nb, 0, -1)]
    else:
        nb, what = cfg.n_layers, "layers"
        cands = [cfg.with_(n_layers=k, remat_block=rb(k))
                 for k in range(nb, 0, -1)]
    share = free_bytes / ranks
    room = share - TRAIN_ALLOCATOR_RESERVE
    peak = train_memory(cfg, ranks)[0]
    if peak <= room:
        return cfg, peak, "depth not cut"
    where = (f"the {free_bytes / 1e9:.1f} GB free" if ranks == 1 else
             f"a rank's {share / 1e9:.1f} GB of the {free_bytes / 1e9:.1f} "
             f"GB free ({ranks} ranks on the card)")
    per = TRAIN_BYTES_A_PARAM - TRAIN_ZERO_BYTES * (1 - 1 / ranks)
    zero = "" if ranks == 1 else (f", ZeRO-1 over {ranks} ranks sparing "
                                  f"{TRAIN_BYTES_A_PARAM - per:g}")
    for k, c in zip(range(nb, 0, -1), cands):
        pk, n = train_memory(c, ranks)
        if pk <= room:
            return c, pk, (f"depth cut {nb} -> {k} {what}: the published "
                           f"depth's predicted peak {peak / 1e9:.1f} GB "
                           f"exceeds {where} less the allocator's "
                           f"{TRAIN_ALLOCATOR_RESERVE / 1e9:.1f} GB; "
                           f"{n / 1e9:.3f} B parameters at {per:g} B a "
                           f"parameter{zero} (+ {TRAIN_TIED_BYTES:g} an "
                           f"element of a tied embedding)")
    raise AssertionError(f"{cfg.name}: not one unit of {what} fits "
                         f"{room / 1e9:.1f} GB")


def expert_flips(sel_a, sel_b, E: int):
    """Per layer, ``(flipped pairs, experts whose routed set differs)``
    between two runs' (T, K) selections: a (token, choice) pair of run a
    whose expert run b did not pick for that token, and both experts of
    every such pair."""
    import torch.nn.functional as F
    out = []
    for a, b in zip(sel_a, sel_b):
        oa = F.one_hot(a.long(), E).sum(dim=1) > 0
        ob = F.one_hot(b.long(), E).sum(dim=1) > 0
        out.append((int((oa & ~ob).sum()),
                    sorted(int(e) for e in
                           (oa != ob).any(dim=0).nonzero().flatten())))
    return out


def family_reading(ga, gb, paths, excluded=None):
    """``{leaf: max|a - b| / max|b|}`` of two gradient trees (0 where both
    are zero); ``excluded`` maps an expert leaf's path to the (layer,
    expert) slices left out of both maxima."""
    import torch
    from repro_torch import tree
    per = {}
    for name, a, b in zip(paths, tree.leaves(ga), tree.leaves(gb)):
        d, r = (a - b).abs(), b.abs()
        for layer, e in (excluded or {}).get(name, ()):
            d[layer, e] = 0
            r[layer, e] = 0
        dm, rm = float(d.max()), float(r.max())
        per[name] = dm / rm if rm > 0 else (0.0 if dm == 0 else math.inf)
        del d, r
    torch.cuda.empty_cache()
    return per


def lru_host_cost(dev, cfg, params, B: int, L: int, card: str):
    """The RG-LRU's sequential scan over one recurrent layer's input at the
    train shape (B x L x lru_width, bf16): its forward and backward,
    synchronized, with the PyTorch operations it dispatches counted."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import hybrid
    lp = {k: v[0, 0].detach().requires_grad_()
          for k, v in params["blocks"]["r_layers"].items()}
    w = cfg.lru_width or cfg.d_model
    x = torch.randn((B, L, w), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev).to(cfg.compute_dtype)
    x.requires_grad_()

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def run():
        y, h = hybrid.rg_lru(lp, x)
        (y.float().sum() + h.sum()).backward()
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with Count():
        run()
    torch.cuda.synchronize()
    log(f"[train_hybrid] RG-LRU sequential scan, one recurrent layer at B "
        f"{B} x L {L} x {w}: forward + backward {ms:.2f} ms wall, "
        f"{Count.n} PyTorch operations ({ms * 1e3 / Count.n:.1f} us an "
        f"operation; ms wall, synchronized); {card}")
    del lp, x


def train_family(dev, arch: str, card: str):
    """Train ``arch``'s ``full()`` config at its published width, cut in
    depth only as far as :func:`train_depth` predicts the card forces
    (deepseek-v2's experts cut by :data:`TRAIN_WIDTH_CUT`), random weights
    from the seed (the tied heads' ``embed`` scaled by
    ``STATE_EMBED_SCALE``, the vlm's zero gates drawn as +-U(0.5, 1.5):
    a zero gate shuts every cross layer's gradient), under ``MODEL_SPEC``
    at ``TRAIN`` batch x seq from the synthetic pipeline (the vlm's patch
    rows, the encdec's frames).

    1. Step 0 in f32 activations against the native f32 engine (TF32 off)
       on the same parameters and batch: the loss within 1e-5, every
       gradient leaf within 1e-3 of its max|g|; the native bf16 engine in
       the emulation's place must fail these limits.  For the MoE
       families both runs' expert selections are read first: flipped
       (token, choice) pairs at most 0.1% of all, the experts whose routed
       set differs named and left out of the expert leaves' comparison.
    2. ``TRAIN_FAMILY_STEPS`` steps through ``launch.steps.
       make_train_step`` (the published bf16 activations, the launcher's
       AdamW rule): exact launches a step by kernel and route
       (:func:`train_step_launches`), finite losses and grad norms, ms a
       step (step 0 apart), tokens/s and the peak device memory against
       its prediction; then one more step traced by kernel class.

    Returns the kernel launches of 2."""
    import gc
    import torch
    from repro_torch import configs, optim, tree
    from repro_torch.data import Pipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import data_config, device_batch
    from repro_torch.models import api
    from repro_torch.models.common import param_count
    B, L, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN_FAMILY_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    full = configs.get_config(arch, engine_spec=MODEL_SPEC)
    cut = TRAIN_WIDTH_CUT.get(arch, {})
    cfg, predicted, why = train_depth(full.with_(**cut), free)
    fam = cfg.family
    tag = f"train_{fam}"
    per_step, n_contr = train_step_launches(cfg, B, L)
    log(f"[{tag}] {cfg.name}: {why}"
        + (f"; width cut: {cut} (published {full.n_experts} routed "
           f"experts)" if cut else "")
        + f"; {cfg.n_layers} layers"
        + (f" + {cfg.enc_layers} encoder layers" if fam == "encdec" else "")
        + f", d_model {cfg.d_model}, vocab {cfg.vocab}, remat blocks of "
        f"{cfg.remat_block}; global batch {B} x seq {L}; predicted peak "
        f"{predicted / 1e9:.1f} GB of {free / 1e9:.1f} GB free; "
        f"{n_contr} emulated contractions a step")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = api.get_model(cfg).init(cfg, generator=gen, device=dev)
    if fam in ("ssm", "hybrid"):
        params["embed"].mul_(STATE_EMBED_SCALE)
    if fam == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            g = params["groups"]["cross"][name]
            sign = torch.where(torch.rand(g.shape, generator=gen,
                                          device=dev) < 0.5, -1.0, 1.0)
            g.copy_((torch.rand(g.shape, generator=gen, device=dev) + 0.5)
                    * sign)
        log(f"[{tag}] gates drawn from the seed: "
            f"{params['groups']['cross']['gate_attn'].tolist()} / "
            f"{params['groups']['cross']['gate_mlp'].tolist()}")
    pipe = Pipeline(data_config(cfg, seq_len=L, global_batch=B, seed=SEED))
    paths = _leaf_paths(params)
    is_moe = fam in ("moe", "mla_moe")

    # 1. step 0 in f32 activations
    def grads_under(spec, batch, dtype="float32"):
        """(loss, gradients, each MoE layer's forward selections, ms)."""
        install, uninstall, sels = _routing_recorder(cfg.n_layers)
        install()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = S.loss_and_grads(
                cfg.with_(dtype=dtype, engine_spec=spec), params, batch)
            loss = float(loss)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            uninstall()
        return loss, g, sels, ms

    def compare(a, b, what):
        """``(|loss diff|, worst leaf reading, its name, flip fraction)``
        of run a against run b, logged leaf by leaf."""
        (la, ga, sa, _), (lb, gb, sb, _) = a, b
        excluded, frac = {}, 0.0
        if is_moe:
            flips = expert_flips(sa, sb, cfg.n_experts)
            n_flip = sum(f for f, _ in flips)
            frac = n_flip / (B * L * cfg.topk * cfg.n_layers)
            for leaf in ("w_gate", "w_up", "w_down"):
                excluded[f"layers/moe/{leaf}"] = [
                    (i, e) for i, (_, es) in enumerate(flips) for e in es]
            log(f"[{tag}] {what}: expert selections, flipped (token, "
                f"choice) pairs {n_flip} of {B * L * cfg.topk * cfg.n_layers}"
                f" ({frac:.3e}); experts whose routed set differs, by layer "
                f"(left out of the expert leaves' comparison): "
                f"{[es for _, es in flips]}")
        per = family_reading(ga, gb, paths, excluded)
        worst = max(per, key=lambda k: (not math.isfinite(per[k]), per[k]))
        dloss = abs(la - lb)
        log(f"[{tag}] {what}: loss {la:.6f} vs {lb:.6f}, |diff| "
            f"{dloss:.3e}; max|diff| / max|g| by leaf: "
            + ", ".join(f"{k} {v:.3e}" for k, v in per.items())
            + f"; worst {worst}")
        return dloss, per[worst], worst, frac

    batch0 = device_batch(pipe.batch_at(0), dev)
    runs = {spec: grads_under(spec, batch0) for spec in ("f32", MODEL_SPEC)}
    dloss, worst, worst_name, frac = compare(
        runs[MODEL_SPEC], runs["f32"], f"step 0, {MODEL_SPEC} vs f32")
    if not dloss <= 1e-5:
        raise AssertionError(f"{tag}: loss off the native f32 engine by "
                             f"{dloss:.3e} (> 1e-5)")
    if not worst <= 1e-3:
        raise AssertionError(f"{tag}: gradient {worst_name} off the native "
                             f"f32 engine by {worst:.3e} of its max|g| "
                             f"(> 1e-3)")
    if not frac <= 1e-3:
        raise AssertionError(f"{tag}: {frac:.3e} of the expert choices "
                             f"flipped (> 0.1%)")
    emu_ms, f32_ms = runs[MODEL_SPEC][3], runs["f32"][3]
    if param_count(params) <= TRAIN_WITNESS_MAX:
        # logged, not held: which of the two parts from the f64 witness
        runs["f64"] = grads_under("f64", batch0, "float64")
        for spec in (MODEL_SPEC, "f32"):
            compare(runs[spec], runs["f64"], f"step 0, {spec} vs the f64 "
                    f"witness (f64 activations)")
        del runs["f64"]
    del runs[MODEL_SPEC]
    gc.collect()
    torch.cuda.empty_cache()
    runs["bf16"] = grads_under("bf16", batch0)
    b_loss, b_worst, b_name, b_frac = compare(runs["bf16"], runs["f32"],
                                              "step 0, bf16 control vs f32")
    if b_loss <= 1e-5 and b_worst <= 1e-3:
        raise AssertionError(f"{tag}: the bf16 engine passes the step-0 "
                             f"limits too (loss {b_loss:.3e}, {b_name} "
                             f"{b_worst:.3e}): they do not tell the "
                             f"emulation from bf16")
    log(f"[{tag}] step 0 within its limits against the native f32 engine "
        f"(|loss diff| {dloss:.3e} <= 1e-5, worst leaf {worst_name} "
        f"{worst:.3e} <= 1e-3 of max|g|); the bf16 control does not pass "
        f"them (loss {b_loss:.3e}, worst leaf {b_name} {b_worst:.3e}); "
        f"forward + backward in f32 activations {emu_ms:.1f} ms emulated, "
        f"{f32_ms:.1f} ms native f32 (first calls, untimed warm-up)")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    if fam == "hybrid":
        lru_host_cost(dev, cfg, params, B, L, card)

    # 2. the train steps, published bf16 activations
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=min(20,
                                                        n_steps // 5 + 1),
                              total_steps=n_steps)
    state = S.TrainState(params, optim.init(params, opt_cfg),
                         torch.zeros((), dtype=torch.int32, device=dev))
    del params
    train_step = S.make_train_step(cfg, opt_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    seen = []
    reset_launches()
    for step in range(n_steps):
        batch = device_batch(pipe.batch_at(step), dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        seen.append((metrics, time.perf_counter() - t0))
    counts = dict(LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * n_steps for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    log(f"[{tag}] {n_steps} steps: launches {got}, expected {want} (a step:"
        f" {per_step['split_fused']} splits, {per_step['group_gemm']} group "
        f"GEMMs of which {per_step['group_gemm_large']} large, "
        f"{per_step['scale_accum']} df32 epilogues)")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")
    for name in ("split_fused", "group_gemm", "scale_accum"):
        if counts[name] <= 0:
            raise AssertionError(f"{tag} path launched no {name} kernel")
    bad = [m for m, _ in seen if not (math.isfinite(m["loss"]) and
                                      math.isfinite(m["grad_norm"]))]
    if bad:
        raise AssertionError(f"{tag}: non-finite metrics {bad}")
    step_s = [sec for _, sec in seen[1:]]
    mean_s = sum(step_s) / len(step_s)
    log(f"[{tag}] {cfg.name} ({param_count(state.params) / 1e9:.3f} B f32 "
        f"parameters): losses {[round(m['loss'], 6) for m, _ in seen]}, "
        f"grad norms {[round(m['grad_norm'], 4) for m, _ in seen]}; step 0 "
        f"{seen[0][1] * 1e3:.1f} ms, steps 1-{n_steps - 1} "
        f"{[round(x * 1e3, 1) for x in step_s]} ms: {mean_s * 1e3:.1f} ms a "
        f"step, {B * L / mean_s:.0f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB (predicted {predicted / 1e9:.1f}; "
        f"{held / 1e9:.2f} GB held before; {peak / param_count(state.params):.1f}"
        f" B a parameter); {card}")
    # one more step traced by kernel class (its launches are not counted)
    from torch.profiler import ProfilerActivity, profile
    batch = device_batch(pipe.batch_at(n_steps), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    trace_summary(prof, tag, 1, traced_ms, mean_s * 1e3, what="train steps")
    del state, metrics, train_step, prof
    gc.collect()
    torch.cuda.empty_cache()
    return tag, counts


def phase_train_families(dev, card: str):
    """:func:`train_family` for each of :data:`TRAIN_FAMILIES`; returns
    ``{"train_<family>": launches}``."""
    t0 = time.perf_counter()
    out = {}
    for arch in TRAIN_FAMILIES:
        t1 = time.perf_counter()
        tag, counts = train_family(dev, arch, card)
        out[tag] = counts
        log(f"[{tag}] {time.perf_counter() - t1:.1f} s")
    log(f"[train_families] {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the mesh (two ranks on the one card)
# ---------------------------------------------------------------------------

# two ranks, one process each, on cuda:0 over gloo (NCCL refuses two ranks
# on one device); launch.serve's flags at the published width
MESH_WORLD = 2
MESH_DEVICE = "cuda"
MESH_GEN = 8
MESH_FLAGS = ["--arch", "internlm2_1_8b", "--full", "--slots", "2",
              "--requests", "2", "--prompt-len", "8", "--gen",
              str(MESH_GEN), "--max-len", "16", "--device", MESH_DEVICE]
MESH_SPEC = "ozimmu_h-4:df32:fused@model"
# phase (a): the decode contractions (A 4x2048 against w_up and the LM
# head, both frozen, as serving freezes them) under each spec; the
# df32-strategy ones also against the plain versions on the CPU under the
# same collectives; the DGEMM at n = 4096
MESH_INT32 = ("ozimmu_h-4:df32:fused@model", "oz2_h-4:df32:fast2:fused@model")
MESH_DF32 = "ozimmu_h-4:df32:fused@model/df32"
MESH_DGEMM = "ozimmu_h-8:f64:fused@model"
# d_model and the two frozen widths of phase (a): w_up, the padded LM head
MESH_SHAPES = dict(d=2048, w_up=8192, head=92672)
MESH_TIMEOUT_S = 600


def _host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()`` ended by a device sync."""
    import statistics
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def mesh_probe(dev, rank: int) -> dict:
    """gloo's collectives on CUDA tensors, one by one: MAX on f32 (the
    splits' maxima), SUM on int32 (the stacked products) and all_gather
    (the df32 fold), each checked and timed at a decode contraction's
    sizes (host ms a call, the device synchronized)."""
    import torch
    import torch.distributed as dist
    out = {}
    world = dist.get_world_size()
    for name in ("max_f32", "sum_int32", "all_gather_f32"):
        try:
            if name == "max_f32":
                x = torch.tensor([1.0 + rank, -3.0], device=dev)
                dist.all_reduce(x, op=dist.ReduceOp.MAX)
                ok = x.tolist() == [float(world), -3.0]
                big = torch.ones(4, device=dev)
                fn = lambda: dist.all_reduce(big, op=dist.ReduceOp.MAX)
            elif name == "sum_int32":
                x = torch.tensor([rank + 1, 7], dtype=torch.int32, device=dev)
                dist.all_reduce(x)
                ok = x.tolist() == [world * (world + 1) // 2, 7 * world]
                big = torch.ones((4, 4, 8192), dtype=torch.int32, device=dev)
                fn = lambda: dist.all_reduce(big)
            else:
                x = torch.tensor([float(rank)], device=dev)
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = [float(p) for p in parts] == [float(r) for r in
                                                   range(world)]
                big = torch.ones((2, 4, 8192), device=dev)
                bigs = [torch.empty_like(big) for _ in range(world)]
                fn = lambda: dist.all_gather(bigs, big)
            out[name] = {"ok": ok, "ms": _host_ms(fn, 20)}
        except Exception as e:   # recorded, then raised by the phase
            out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return out


def mesh_contractions(dev, mesh) -> list:
    """Phase (a) on this rank: each case's sharded result against the
    single-device one (or the CPU's plain versions), its launches and
    collectives, and host ms sharded and single (the frozen split built
    beforehand, as serving builds it)."""
    import contextlib
    import torch
    from repro_torch.core import ozimmu, split_cache
    from repro_torch.distributed import collectives, compat
    from repro_torch.kernels import LAUNCHES, reset_launches
    dn = (((1,), (0,)), ((), ()))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    d = MESH_SHAPES["d"]
    a = torch.randn((SLOTS, d), generator=gen, device=dev)
    ws = {f"{name} ({d}x{MESH_SHAPES[name]})": torch.randn(
        (d, MESH_SHAPES[name]), generator=gen, device=dev) * 0.02
        for name in ("w_up", "head")}

    def runner(spec, a_, b_, presplit=True):
        """``(sharded, single)`` calls of one case."""
        cfg = ozimmu.parse_spec(spec)
        sp = split_cache.presplit_rhs(b_, dn, cfg) if presplit else None

        def call(sharded):
            with compat.set_mesh(mesh) if sharded else \
                    contextlib.nullcontext():
                return ozimmu.ozimmu_dot_general(a_, b_, dn, cfg,
                                                 rhs_presplit=sp)
        return (lambda: call(True)), (lambda: call(False))

    def counted(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        collectives.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in LAUNCHES.items() if v}, \
            dict(collectives.COUNTS)

    def case(tag, sharded, single, want, against, reps=5, **extra):
        got, launches, colls = counted(sharded)
        return dict(tag=tag, bitwise=same(got.to(want.device), want),
                    against=against, launches=launches, collectives=colls,
                    ms=_host_ms(sharded, reps),
                    single_ms=_host_ms(single, reps),
                    **{k: f(got) for k, f in extra.items()})

    cases = []
    for spec in MESH_INT32:
        for wname, w in ws.items():
            sharded, single = runner(spec, a, w)
            unfrozen, _ = runner(spec, a, w, presplit=False)
            want = single()
            c = case(f"{spec} decode A {tuple(a.shape)} @ {wname}, frozen",
                     sharded, single, want,
                     "the single-device result (frozen and unfrozen)")
            c["bitwise"] = c["bitwise"] and same(unfrozen(), want)
            cases.append(c)
    plain = MESH_DF32.replace(":fused", "")
    for wname, w in ws.items():
        sharded, single = runner(MESH_DF32, a, w)
        cpu, _ = runner(plain, a.cpu(), w.cpu())
        cases.append(case(
            f"{MESH_DF32} decode A {tuple(a.shape)} @ {wname}, frozen",
            sharded,
            single, cpu(), f"the plain versions on the CPU ({plain}) "
                           f"under the same collectives"))
    _, (A, B) = dgemm_inputs(dev)
    sharded, single = runner(MESH_DGEMM, A, B, presplit=False)
    ref = torch.matmul(A, B)
    cases.append(case(
        f"{MESH_DGEMM} DGEMM n={A.shape[0]}", sharded, single, single(),
        "the single-device result", reps=3,
        err=lambda got: float((got - ref).abs().max() / ref.abs().max())))
    return cases


def mesh_serve(dev, mesh, tmp: str, rank: int) -> dict:
    """Phase (b) on this rank: ``launch.serve.main`` with ``--mesh
    model=2`` (rank 0 traced with ``--profile-dir``), its tokens, model
    steps, launches and collectives; then the same requests on a fresh
    runtime over the same parameters, timed untraced."""
    import os
    import torch
    from repro_torch.distributed import collectives, compat
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    rec = {}
    make_runtime = serve.make_runtime

    def captured(cfg, params, **kw):
        rt = make_runtime(cfg, params, **kw)
        rec.update(cfg=cfg, params=params, kw=kw)
        obs_instrument(rt, rec)
        torch.cuda.synchronize()
        reset_launches()            # the freeze's splits are not the run's
        collectives.reset_counts()
        return rt

    prof = os.path.join(tmp, "profile")
    argv = MESH_FLAGS + ["--engine", MESH_SPEC, "--mesh",
                         f"model={MESH_WORLD}", "--profile-dir", prof]
    serve.make_runtime = captured
    try:
        s = serve.main(argv)
    finally:
        serve.make_runtime = make_runtime
    torch.cuda.synchronize()
    out = dict(tokens=[list(r.generated) for r in rec["reqs"]],
               steps=sum(rec["fed"]) + s["decode_steps"],
               layers=rec["cfg"].n_layers,
               launches={k: v for k, v in LAUNCHES.items() if v},
               collectives=dict(collectives.COUNTS),
               traced_ms=s["elapsed_s"] * 1e3,
               peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else 0.0))
    if rank == 0:
        out["ranges"] = _mesh_ranges(os.path.join(prof, "trace.json"))
    import torch.distributed as dist
    dist.barrier()              # rank 0 has written its trace
    run = {}
    rt = make_runtime(rec["cfg"], rec["params"], **rec["kw"])
    obs_instrument(rt, run)
    with compat.set_mesh(mesh):
        torch.cuda.synchronize()
        for p in rec["reqs"]:
            rt.submit(p.prompt, MESH_GEN)
        s2 = rt.run()
        torch.cuda.synchronize()
    out["rerun_tokens"] = [list(r.generated) for r in run["reqs"]]
    out["ms_step"] = s2["elapsed_s"] * 1e3 / (sum(run["fed"])
                                              + s2["decode_steps"])
    return out


def keep_prefill_logits(rt, rec) -> None:
    """Keep in ``rec['logits']``, on the CPU, the last position's logits of
    ``rt``'s first model call (its first prefill): the rows of its slots
    on this rank."""
    argmax, vocab = rt._argmax, rt.cfg.vocab

    def kept(logits):
        if "logits" not in rec:
            rec["logits"] = logits[:, -1, :vocab].float().cpu()
        return argmax(logits)
    rt._argmax = kept


def mesh_serve_data(dev, tmp: str, rank: int) -> dict:
    """Phase (c) on this rank: ``launch.serve.main`` with ``--mesh
    data=2`` under ``MODEL_SPEC`` on ``MESH_FLAGS``' requests, the slots
    split over the ranks: its tokens, model steps and calls, launches,
    collectives, ms a model step, peak, the host ms of each gather of the
    greedy tokens (device synchronized around it) and its first prefill
    logits (to ``logits<rank>.pt``)."""
    import gc
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    rec, gather_ms = {}, []
    make_runtime, gather = serve.make_runtime, collectives.all_gather_rows

    def captured(cfg, params, **kw):
        rt = make_runtime(cfg, params, **kw)
        obs_instrument(rt, rec)
        keep_prefill_logits(rt, rec)
        torch.cuda.synchronize()
        reset_launches()            # the freeze's splits are not the run's
        collectives.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        return rt

    def timed(x, axes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(x, axes)
        torch.cuda.synchronize()
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    serve.make_runtime, collectives.all_gather_rows = captured, timed
    try:
        s = serve.main(MESH_FLAGS + ["--engine", MODEL_SPEC, "--mesh",
                                     f"data={MESH_WORLD}"])
    finally:
        serve.make_runtime, collectives.all_gather_rows = make_runtime, gather
    torch.cuda.synchronize()
    torch.save(rec["logits"], Path(tmp, f"logits{rank}.pt"))
    steps = sum(rec["fed"]) + s["decode_steps"]
    return dict(tokens=[list(r.generated) for r in rec["reqs"]],
                steps=steps, calls=s["prefill_calls"] + s["decode_steps"],
                launches={k: v for k, v in LAUNCHES.items() if v},
                collectives=dict(collectives.COUNTS),
                data=dict(collectives.DATA_COUNTS),
                ms_step=s["elapsed_s"] * 1e3 / steps,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                gather_ms=gather_ms)


def _mesh_ranges(path) -> dict:
    """Host ms and count of the trace's ``ozimmu/mesh/*`` ranges (one a
    collective), by name."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    per = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                name.startswith("ozimmu/mesh/"):
            n, ms = per.get(name, (0, 0.0))
            per[name] = (n + 1, ms + float(e.get("dur", 0)) / 1e3)
    return per


def _mesh_rank(rank: int, tmp: str) -> None:
    """One rank of the mesh phase: the gloo group from the file store,
    the probe, phase (a), phase (b); the results to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(4)
    dev = mesh_lib.init_distributed(MESH_DEVICE,
                                    init_method=f"file://{tmp}/store",
                                    rank=rank, world_size=MESH_WORLD)
    try:
        out = {"device": str(dev), "probe": mesh_probe(dev, rank)}
        if not all(p["ok"] for p in out["probe"].values()):
            raise AssertionError(f"gloo on {dev}: {out['probe']}")
        mesh = mesh_lib.parse_mesh_spec(f"model={MESH_WORLD}")
        out["contractions"] = mesh_contractions(dev, mesh)
        out["serve"] = mesh_serve(dev, mesh, tmp, rank)
        out["serve_data"] = mesh_serve_data(dev, tmp, rank)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_mesh(dev, card):
    """Phase 12 (``mesh``): two ranks, one process each, on ``cuda:0``
    over gloo (NCCL refuses two ranks on one device; every kernel still
    runs on the card, gloo stages each collective through host memory).
    First the single-device serve of the same requests in this process
    (``launch.serve.main``, ``MESH_FLAGS``, ``ozimmu_h-4:df32:fused@model``
    with no mesh), freed before the ranks start.  Then on each rank: gloo's
    MAX / int32 SUM / all_gather on CUDA tensors; (a) the decode
    contractions at internlm2-1.8b's width (A 4x2048 against the frozen
    ``w_up`` and LM head) under ``@model`` for group-EF and Ozaki-II
    fast2, bitwise to the single-device result, ``@model/df32`` bitwise to
    the plain versions on the CPU under the same collectives, and the
    n = 4096 DGEMM under ``ozimmu_h-8:f64:fused@model`` bitwise to the
    single-device one and within 1e-8 of ``torch.matmul``; (b)
    ``serve.main`` with ``--mesh model=2``: every request's tokens equal
    to the single-device run's on both ranks, exact launches (265 splits,
    868 group GEMMs, all skinny, 217 epilogues) and collectives (265
    maxima, 217 int32 sums) a model step, ms a step untraced and the
    collectives' host share from rank 0's trace; (c) ``serve.main`` with
    ``--mesh data=2`` under ``MODEL_SPEC`` (:func:`mesh_serve_data`,
    :func:`mesh_data_check`): one slot a rank, the tokens, launches a
    model step and first prefill logits against the single-device run's,
    one gather of the greedy tokens a model call.  Returns rank 0's
    launches of (b) and (c), as paths ``mesh`` and ``mesh_data``."""
    import gc
    import tempfile
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    tag = "mesh"
    rec = {}
    make_runtime = serve.make_runtime

    def captured(cfg, params, **kw):
        rt = make_runtime(cfg, params, **kw)
        obs_instrument(rt, rec)
        keep_prefill_logits(rt, rec)
        torch.cuda.synchronize()
        reset_launches()
        return rt
    serve.make_runtime = captured
    try:
        s = serve.main(MESH_FLAGS + ["--engine", MESH_SPEC])
    finally:
        serve.make_runtime = make_runtime
    torch.cuda.synchronize()
    single = dict(tokens=[list(r.generated) for r in rec["reqs"]],
                  steps=sum(rec["fed"]) + s["decode_steps"],
                  launches={k: v for k, v in LAUNCHES.items() if v},
                  ms_step=s["elapsed_s"] * 1e3, logits=rec["logits"])
    single["ms_step"] /= single["steps"]
    del rec, s
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] {card}: single-device serve ({MESH_SPEC}, no mesh): "
        f"{single['steps']} model steps, {single['ms_step']:.1f} ms a "
        f"step, launches {single['launches']}; this process keeps "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved for the "
        f"ranks' start")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _mesh_rank, args=(tmp,), nprocs=MESH_WORLD, join=False,
            start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{tag}: the ranks ran past "
                                     f"{MESH_TIMEOUT_S} s")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        data_logits = [torch.load(Path(tmp, f"logits{r}.pt"))
                       for r in range(MESH_WORLD)]
    log(f"[{tag}] {MESH_WORLD} ranks on {ranks[0]['device']} over gloo, "
        f"{time.perf_counter() - t0:.1f} s with their start")
    for r, out in enumerate(ranks):
        log(f"[{tag}] rank {r} gloo on CUDA tensors: " + "; ".join(
            f"{k} ok, {v['ms']:.3f} ms a call" for k, v in
            out["probe"].items()))
    bad = []
    for r, out in enumerate(ranks):
        for c in out["contractions"]:
            extra = f", error {c['err']:.3e}" if "err" in c else ""
            log(f"[{tag}] rank {r} {c['tag']}: "
                f"{'bitwise' if c['bitwise'] else 'DIFFERS from'} "
                f"{c['against']}{extra}; {c['ms']:.2f} ms (single device "
                f"{c['single_ms']:.2f}); launches {c['launches']}; "
                f"collectives {c['collectives']}")
            if not c["bitwise"] or c.get("err", 0.0) > 1e-8 or \
                    not math.isfinite(c.get("err", 0.0)):
                bad.append((r, c["tag"]))
    if bad:
        raise AssertionError(f"{tag}: contractions off: {bad}")

    mesh_serve_check(tag, card, ranks, single)
    mesh_data_check(tag, card, ranks, single, data_logits)
    return {p: {k: ranks[0][key]["launches"].get(k, 0) for k in LAUNCHES}
            for p, key in (("mesh", "serve"), ("mesh_data", "serve_data"))}


def mesh_serve_check(tag, card, ranks, single):
    """Part (b)'s readings against the single-device run: tokens (traced
    run and untraced rerun), model steps and launches equal, launches and
    collectives a model step exact; logs ms a model step and the
    collectives' share of rank 0's trace."""
    for r, out in enumerate(ranks):
        sv = out["serve"]
        steps = sv["steps"]
        want = dense_serve_launches(steps, sv["layers"])
        want_coll = {"pmax_scales": want["split_fused"],
                     "psum_exact_int32": want["scale_accum"],
                     "psum_df32": 0, "psum_compensated": 0}
        got = {k: sv["launches"].get(k, 0) for k in want}
        log(f"[{tag}] rank {r}: {steps} model steps, launches {got}, "
            f"collectives {sv['collectives']} (expected {want}, "
            f"{want_coll}); peak {sv['peak_gb']:.2f} GB")
        if got != want or sv["collectives"] != want_coll or \
                steps != single["steps"] or \
                sv["launches"] != single["launches"]:
            raise AssertionError(f"{tag}: rank {r}'s launches or "
                                 f"collectives are off")
        if sv["tokens"] != single["tokens"] or \
                sv["rerun_tokens"] != single["tokens"]:
            raise AssertionError(f"{tag}: rank {r}'s tokens "
                                 f"{sv['tokens']} differ from the "
                                 f"single-device run's {single['tokens']}")
    sv = ranks[0]["serve"]
    coll_ms = sum(ms for _, ms in sv["ranges"].values())
    log(f"[{tag}] {card}: tokens of both ranks equal the single-device "
        f"run's ({len(single['tokens'])} requests x {MESH_GEN}); ms a "
        f"model step untraced: rank 0 {sv['ms_step']:.1f}, rank 1 "
        f"{ranks[1]['serve']['ms_step']:.1f} against single-device "
        f"{single['ms_step']:.1f}; rank 0's trace: {sv['traced_ms']:.0f} "
        f"ms for {sv['steps']} steps, collectives {coll_ms:.0f} ms of it "
        f"({100 * coll_ms / sv['traced_ms']:.1f}%): " + "; ".join(
            f"{name[len('ozimmu/mesh/'):]} {n} calls {ms:.1f} ms "
            f"({1e3 * ms / n:.0f} us a call)"
            for name, (n, ms) in sorted(sv["ranges"].items())))


def dense_serve_launches(steps: int, layers: int) -> dict:
    """The launches of ``steps`` model steps of the dense internlm2 serve
    at ``layers`` layers and 2 slots: a split per operand (11 a layer and
    the LM head's), four skinny group GEMMs and one df32 epilogue per
    contraction (9 a layer and the LM head)."""
    contractions = layers * 9 + 1
    return {"split_fused": steps * (layers * 11 + 1),
            "group_gemm": steps * contractions * 4,
            "group_gemm_skinny": steps * contractions * 4,
            "scale_accum": steps * contractions}


def mesh_data_check(tag, card, ranks, single, data_logits):
    """Part (c)'s readings against the single-device run: tokens, launches
    a model step and steps equal, no contraction collective, one gather a
    model call; the first prefill logits bitwise or within 1e-3 of
    max|logit| of the single-device run's rows of the rank's slots."""
    import statistics
    per = len(single["tokens"]) // MESH_WORLD    # slots a rank
    bad, reading = [], []
    for r, out in enumerate(ranks):
        sd = out["serve_data"]
        steps = sd["steps"]
        want = dense_serve_launches(steps, out["serve"]["layers"])
        got = {k: sd["launches"].get(k, 0) for k in want}
        want_data = {"pmean": 0, "all_gather_cat": 0, "all_to_all": 0,
                     "all_gather_rows": sd["calls"]}
        coll = {k: v for k, v in sd["collectives"].items() if v}
        log(f"[{tag}] (c) rank {r}: {steps} model steps in {sd['calls']} "
            f"model calls, launches {got} (expected {want}), data-axis "
            f"collectives {sd['data']}, contraction collectives {coll}")
        if got != want or sd["launches"] != single["launches"] or \
                steps != single["steps"] or sd["data"] != want_data or coll:
            bad.append(f"rank {r}'s launches or collectives are off")
        if sd["tokens"] != single["tokens"]:
            bad.append(f"rank {r}'s tokens {sd['tokens']} differ from the "
                       f"single-device run's {single['tokens']}")
        mine = single["logits"][r * per:(r + 1) * per]
        got_l = data_logits[r]
        bitwise = same(got_l, mine)
        err = float((got_l - mine).abs().max() / mine.abs().max())
        reading.append((bitwise, err))
        if not bitwise and not err <= 1e-3:
            bad.append(f"rank {r}'s prefill logits off the single-device "
                       f"run's by {err:.3e} of max|logit|")
    if bad:
        raise AssertionError(f"{tag} (c): " + "; ".join(bad))
    log(f"[{tag}] (c) {card}: --mesh data={MESH_WORLD} under {MODEL_SPEC}: "
        f"tokens of both ranks equal the single-device run's; launches a "
        f"model step equal its; one gather of the greedy tokens a model "
        f"call; first prefill logits against the single-device run's rows: "
        + "; ".join(f"rank {r} {'bitwise' if b else 'not bitwise'}, "
                    f"max|diff| / max|logit| {e:.3e}"
                    for r, (b, e) in enumerate(reading)))
    for r, out in enumerate(ranks):
        sd = out["serve_data"]
        g = sd["gather_ms"]
        log(f"[{tag}] (c) {card}: rank {r}: {sd['ms_step']:.1f} ms a model "
            f"step (single device {single['ms_step']:.1f}, the model=2 "
            f"mesh {out['serve']['ms_step']:.1f}); peak "
            f"{sd['peak_gb']:.2f} GB; {len(g)} gathers, host ms a gather "
            f"median {statistics.median(g):.3f}, mean "
            f"{sum(g) / len(g):.3f}, max {max(g):.3f}")


# ---------------------------------------------------------------------------
# phase 13: train_mesh (the data axis of training, two ranks on the one card)
# ---------------------------------------------------------------------------

TRAIN_MESH_STEPS = 3
# launch.train's flags: internlm2-1.8b at its published width (the depth
# cut by patching the rank's config registry), global batch 8 x seq 256
# split over data=2
TRAIN_MESH_FLAGS = ["--arch", "internlm2_1_8b", "--full", "--mesh",
                    f"data={MESH_WORLD}", "--engine", MODEL_SPEC, "--batch",
                    str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
                    "--steps", str(TRAIN_MESH_STEPS), "--log-every", "1",
                    "--device", MESH_DEVICE]
# the leaves whose averaged step-0 gradients are held to the witness's
# (the stacked layer leaves at their first and last layer)
TRAIN_MESH_LEAVES = ("embed", "layers/attn/wq", "layers/mlp/w_down",
                     "lm_head")
# part (b): deepseek-moe-16b at its published widths (64 routed experts of
# 2048 x 1408, top-6, 2 shared), its experts' tokens exchanged by
# all-to-all over data (``moe_dispatch="a2a"``), 2 steps
TRAIN_MESH_MOE_STEPS = 2
TRAIN_MESH_MOE_FLAGS = ["--arch", "deepseek_moe_16b", "--full", "--mesh",
                        f"data={MESH_WORLD}", "--engine", MODEL_SPEC,
                        "--batch", str(TRAIN["batch"]), "--seq",
                        str(TRAIN["seq"]), "--steps",
                        str(TRAIN_MESH_MOE_STEPS), "--log-every", "1",
                        "--device", MESH_DEVICE]
TRAIN_MESH_MOE_LEAVES = ("layers/attn/wq", "layers/moe/router",
                         "layers/moe/w_gate", "layers/moe/w_down",
                         "layers/moe/shared/w_down", "lm_head")


def _mesh_grads(grads, leaves) -> dict:
    """The named gradients of ``leaves``, stacked layer leaves split into
    their first and last layer."""
    from repro_torch import tree
    named = dict(zip(_leaf_paths(grads), tree.leaves(grads)))
    out = {}
    for name in leaves:
        g = named[name]
        if not name.startswith("layers/"):
            out[name] = g
        else:
            out[f"{name}[0]"] = g[0]
            if g.shape[0] > 1:
                out[f"{name}[-1]"] = g[-1]
    return out


def _bit_sums(tensors) -> list:
    """Two checksums of each f32 tensor's bit patterns (the int32 words
    summed whole and at odd positions, in int64): equal bits give equal
    sums."""
    import torch
    out = []
    for t in tensors:
        w = t.detach().reshape(-1).view(torch.int32)
        out.append([int(w.sum()), int(w[1::2].sum())])
    return out


def _routing_recorder(n_layers: int):
    """``(install, uninstall, sels)``: while installed, ``moe._route``
    keeps the (T, K) expert selections of its first ``n_layers`` calls
    (a forward's, not the remat recompute's)."""
    from repro_torch.models import moe
    route, sels = moe._route, []

    def recording(gates, topk, cap):
        out = route(gates, topk, cap)
        if len(sels) < n_layers:
            sels.append(out[1].cpu())
        return out

    def install():
        moe._route = recording

    def uninstall():
        moe._route = route
    return install, uninstall, sels


def _train_mesh_rank(rank: int, tmp: str, flags, overrides: dict,
                     leaves) -> None:
    """One rank of the train_mesh phase: the gloo group from the file
    store, ``launch.train.main(flags)`` with the config registry patched
    by ``overrides`` (the cut depth and its remat blocks; the activation
    dtype), each step recorded
    (ms, launches, collectives, the gradient mean's and the gathers' host
    ms, each all-to-all's bytes and host ms, the parameters' bit sums),
    rank 0's averaged step-0 gradients of ``leaves`` saved, and this
    rank's step-0 expert selections when the arch routes; the record to
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs, tree
    from repro_torch.distributed import collectives
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    torch.set_num_threads(4)
    dev = mesh_lib.init_distributed(MESH_DEVICE,
                                    init_method=f"file://{tmp}/store",
                                    rank=rank, world_size=MESH_WORLD)
    get, make = configs.get_config, S.make_train_step
    mean, gather = S.batch_mean, collectives.all_gather_cat
    exchange = collectives._exchange
    steps, cur = [], {}
    install, uninstall, sels = _routing_recorder(overrides["n_layers"])

    def cut(*args, **kw):
        return get(*args, **kw).with_(**overrides)

    def sync_ms(fn, key):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            cur[key] = cur.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return timed

    timed_mean = sync_ms(mean, "mean_ms")

    def timed_exchange(x, axis):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(x, axis)
        torch.cuda.synchronize()
        cur.setdefault("a2a", []).append(
            [x.numel() * x.element_size(), (time.perf_counter() - t0) * 1e3])
        return out

    def mean_recorded(loss, grads):
        loss, grads = timed_mean(loss, grads)
        if not steps:
            uninstall()
            named = _mesh_grads(grads, leaves)
            cur["grad_sums"] = _bit_sums(named.values())
            if rank == 0:
                torch.save({k: g.cpu() for k, g in named.items()},
                           Path(tmp, "grads0.pt"))
        return loss, grads

    def recording(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch):
            cur.clear()
            launches0, counts0 = dict(LAUNCHES), dict(collectives.COUNTS)
            data0 = dict(collectives.DATA_COUNTS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            leaves_ = tree.leaves(state.params)
            steps.append(dict(
                cur, ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                rows=int(batch["tokens"].shape[0]),
                launches={k: LAUNCHES[k] - launches0.get(k, 0)
                          for k in LAUNCHES},
                collectives={k: collectives.COUNTS[k] - counts0[k]
                             for k in counts0},
                data={k: collectives.DATA_COUNTS[k] - data0[k]
                      for k in data0},
                devices=sorted({str(p.device) for p in leaves_} |
                               {str(batch["tokens"].device)}),
                param_sums=_bit_sums(leaves_)))
            return state, metrics
        return recorded

    configs.get_config = cut
    S.make_train_step, S.batch_mean = recording, mean_recorded
    collectives.all_gather_cat = sync_ms(gather, "gather_ms")
    collectives._exchange = timed_exchange
    install()
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        collectives.reset_counts()
        losses = train.main(flags)
        torch.cuda.synchronize()
        torch.save(sels, Path(tmp, f"sels{rank}.pt"))
        out = dict(device=str(dev), backend=dist.get_backend(),
                   losses=losses, steps=steps,
                   launches={k: v for k, v in LAUNCHES.items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        uninstall()
        configs.get_config, S.make_train_step = get, make
        S.batch_mean, collectives.all_gather_cat = mean, gather
        collectives._exchange = exchange
        dist.destroy_process_group()


def _train_mesh_spawn(tag, flags, cfg, leaves):
    """The two ranks of :func:`_train_mesh_rank` on ``flags`` at ``cfg``'s
    depth and activation dtype: ``(their records, rank 0's step-0
    gradients, their step-0 expert selections)``."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _train_mesh_rank, args=(tmp, flags, dict(
                n_layers=cfg.n_layers, remat_block=cfg.remat_block,
                dtype=cfg.dtype), leaves),
            nprocs=MESH_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{tag}: the ranks ran past "
                                     f"{MESH_TIMEOUT_S} s")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        mine = torch.load(Path(tmp, "grads0.pt"))
        sels = [torch.load(Path(tmp, f"sels{r}.pt"))
                for r in range(MESH_WORLD)]
    log(f"[{tag}] {MESH_WORLD} ranks on {ranks[0]['device']} over "
        f"{ranks[0]['backend']}, {time.perf_counter() - t0:.1f} s with "
        f"their start")
    return ranks, mine, sels


def _train_mesh_check(tag, card, dev, ranks, mine, witness, w_loss, w_ms,
                      n_steps, rows, per_step, want_data, predicted):
    """The ranks' records against the witness and each other: step 0's
    loss within 1e-5 and the named gradients within 1e-3 of max|g|,
    bitwise equal on both ranks; the parameters bitwise equal after every
    step; launches and data-axis collectives a step exact, no contraction
    collective; finite losses; every parameter and batch on the card.
    Logs the readings and each rank's ms a step, mean and gathers."""
    import torch
    want_dev = "cuda:0" if MESH_DEVICE == "cuda" else MESH_DEVICE
    bad = []
    for r, out in enumerate(ranks):
        st = out["steps"]
        if len(st) != n_steps or len(out["losses"]) != n_steps:
            bad.append(f"rank {r} ran {len(st)} steps")
            continue
        devs = {d for s_ in st for d in s_["devices"]}
        if devs != {want_dev} or not want_dev.startswith(out["device"]):
            bad.append(f"rank {r} ran on {out['device']} / {sorted(devs)}")
        if not all(math.isfinite(x) for x in out["losses"]) or \
                out["losses"] != ranks[0]["losses"]:
            bad.append(f"rank {r} losses {out['losses']}")
        dloss = abs(out["losses"][0] - w_loss)
        if not dloss <= 1e-5:
            bad.append(f"rank {r} step-0 loss off the witness's by "
                       f"{dloss:.3e}")
        for i, s_ in enumerate(st):
            got = {k: s_["launches"].get(k, 0) for k in per_step}
            coll = {k: v for k, v in s_["collectives"].items() if v}
            if s_["rows"] != rows or got != per_step or coll or \
                    s_["data"] != want_data:
                bad.append(f"rank {r} step {i}: {s_['rows']} rows, "
                           f"launches {got} (expected {per_step}), "
                           f"data-axis collectives {s_['data']} (expected "
                           f"{want_data}), contraction collectives {coll}")
            if s_["param_sums"] != ranks[0]["steps"][i]["param_sums"]:
                bad.append(f"rank {r} step {i}: parameters differ from "
                           f"rank 0's")
        if st[0]["grad_sums"] != ranks[0]["steps"][0]["grad_sums"]:
            bad.append(f"rank {r}: averaged gradients differ from rank 0's")
    per_leaf = {}
    for name, w in witness.items():
        g = mine[name].to(dev)
        w = w.to(dev)
        per_leaf[name] = float((g - w).abs().max() / w.abs().max())
        del g, w
        if not per_leaf[name] <= 1e-3:
            bad.append(f"gradient {name} off the witness's by "
                       f"{per_leaf[name]:.3e} of its max|g|")
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    log(f"[{tag}] both ranks: losses {ranks[0]['losses']} (step 0 within "
        f"{abs(ranks[0]['losses'][0] - w_loss):.3e} of the witness's); "
        f"averaged step-0 gradients bitwise equal on both ranks, "
        f"max|diff| / max|g| against the witness's: " + ", ".join(
            f"{k} {v:.3e}" for k, v in per_leaf.items())
        + f"; parameters bitwise equal on both ranks after each of "
        f"{n_steps} steps (bit-pattern checksums); launches a step "
        f"{per_step}; collectives a step {want_data}")
    for r, out in enumerate(ranks):
        st = out["steps"]
        later = st[1:]
        mean_ms = sum(s_["ms"] for s_ in later) / len(later)
        log(f"[{tag}] {card}: rank {r}: ms a step "
            f"{[round(s_['ms'], 1) for s_ in st]} (steps 1-{n_steps - 1} "
            f"{mean_ms:.1f} ms against the witness's {w_ms:.1f}); the "
            f"gradient mean (host, synchronized) "
            f"{[round(s_['mean_ms'], 1) for s_ in st]} ms, the ZeRO-1 "
            f"gathers {[round(s_['gather_ms'], 1) for s_ in st]} ms a "
            f"step; peak device memory {out['peak_gb']:.2f} GB "
            f"(predicted {predicted / 1e9:.1f})")


def phase_train_mesh(dev, card):
    """Phase 13 (``train_mesh``): the data axis of training, two ranks,
    one process each, on ``cuda:0`` over gloo, each part's depth cut so
    that two ranks fit the card (:func:`train_depth` with ``ranks=2``:
    half the free memory a rank, ZeRO-1 sparing half of AdamW's moments
    and their new copies), under ``MODEL_SPEC``, random weights from the
    seed, the synthetic pipeline at global batch 8 x seq 256 (4 rows a
    rank).

    (a) internlm2-1.8b at its published width.  The witness, in this
        process: the single-device step on the whole batch of 8 at the
        same depth from the same seed (its loss and gradients, then two
        steps of ``make_train_step``, the second timed); freed before the
        ranks start.  Then ``launch.train.main`` with ``--mesh data=2``
        for :data:`TRAIN_MESH_STEPS` steps.  Held: step 0's loss on both
        ranks within 1e-5 of the witness's; the averaged gradients of
        :data:`TRAIN_MESH_LEAVES` within 1e-3 of the witness's max|g|
        (not bitwise: a weight cotangent contracts over the tokens, and
        its split scales follow the rows a rank holds), bitwise equal on
        both ranks; the parameters bitwise equal on both ranks after every
        step (two checksums of the bit patterns a leaf); a rank's launches
        a step exactly :func:`train_step_launches` at 4 rows; its
        collectives a step exactly one f32 SUM a gradient leaf and one for
        the loss and one ``all_gather`` a ZeRO-1 leaf, no contraction
        collective; finite losses, equal on both ranks; every parameter
        and batch on ``cuda:0``.
    (b) deepseek-moe-16b at its published widths (:func:`part_moe`), its
        experts' tokens exchanged by all-to-all over ``data``.

    Logged: ms a step against the witness's, the gradient mean's and the
    gathers' host ms a step, the peak device memory a rank.  Returns rank
    0's launches of (a) and of (b), as paths ``train_mesh`` and
    ``train_mesh_moe``."""
    import gc
    import torch
    from repro_torch import configs, optim
    from repro_torch.data import Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import data_config, device_batch
    from repro_torch.models import api
    tag = "train_mesh"
    B, L, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN_MESH_STEPS
    rows = B // MESH_WORLD
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    full = configs.get_config("internlm2_1_8b", engine_spec=MODEL_SPEC)
    cfg, predicted, why = train_depth(full, free, ranks=MESH_WORLD)
    per_step, n_contr = train_step_launches(cfg, rows, L)
    log(f"[{tag}] {card}: {cfg.name}: {why}; {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, remat blocks of "
        f"{cfg.remat_block}; global batch {B} x seq {L}, {rows} rows a "
        f"rank on {MESH_WORLD} ranks; predicted peak "
        f"{predicted / 1e9:.1f} GB a rank; {n_contr} emulated "
        f"contractions a rank a step")

    # 1. the witness on one device
    opt_cfg = optim.OptConfig(lr=3e-3,            # the launcher's rule
                              warmup_steps=min(20, n_steps // 5 + 1),
                              total_steps=n_steps)
    state = S.init_state(cfg, opt_cfg,
                         torch.Generator(device=dev).manual_seed(SEED), dev)
    pipe = Pipeline(data_config(cfg, seq_len=L, global_batch=B, seed=SEED))
    batch = device_batch(pipe.batch_at(0), dev)
    loss, grads = S.loss_and_grads(cfg, state.params, batch)
    w_loss = float(loss)
    witness = {k: g.cpu() for k, g in
               _mesh_grads(grads, TRAIN_MESH_LEAVES).items()}
    del loss, grads
    step_fn = S.make_train_step(cfg, opt_cfg)
    state, _ = step_fn(state, batch)
    batch = device_batch(pipe.batch_at(1), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    w_ms = (time.perf_counter() - t0) * 1e3
    del state, metrics, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] witness (one device, batch {B}): step-0 loss "
        f"{w_loss:.6f}; a step {w_ms:.1f} ms (step 1); this process keeps "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")

    # 2. the ranks
    ranks, mine, _ = _train_mesh_spawn(tag, TRAIN_MESH_FLAGS, cfg,
                                       TRAIN_MESH_LEAVES)
    dims = optim.zero_axes(api.get_model(cfg).init(
        cfg, generator=torch.Generator(), device="meta"), MESH_WORLD)
    want_data = {"pmean": len(dims) + 1,
                 "all_gather_cat": sum(d is not None for d in dims),
                 "all_to_all": 0, "all_gather_rows": 0}
    _train_mesh_check(tag, card, dev, ranks, mine, witness, w_loss, w_ms,
                      n_steps, rows, per_step, want_data, predicted)
    del mine, witness
    return {"train_mesh": dict(ranks[0]["launches"]),
            "train_mesh_moe": part_moe(dev, card)}


def part_moe(dev, card):
    """Phase 13 (b): ``launch.train.main --arch deepseek_moe_16b --full
    --mesh data=2`` at the published widths, cut in depth by
    :func:`train_depth` with ``ranks=2``, in f32 activations (in bf16 an
    expert's weight cotangent is rounded to bf16: summed over both ranks'
    tokens in one contraction and then rounded, against the witness's two
    roundings, it parts from it by up to a bf16 ulp, ~4e-3 of max|g|), for
    :data:`TRAIN_MESH_MOE_STEPS` steps; every layer's expert products run
    on the rank's 32 resident experts over both ranks' dispatched tokens
    (two all-to-alls a layer in the forward, two in the remat recompute,
    two in the backward).

    The witness, in this process before the ranks start: the one-device
    step 0 on each rank's rows (the pipeline's host slice) with the
    scatter path (no mesh), the two losses and gradients averaged: the
    per-rank capacity as the ranks have it.  Held: both ranks' step-0
    loss within 1e-5 of the witness's; the averaged gradients of
    :data:`TRAIN_MESH_MOE_LEAVES` within 1e-3 of its max|g|, bitwise equal
    on both ranks; no expert flips (each row's expert selection the
    witness's); the parameters bitwise equal on both ranks after each
    step; launches a step exactly :func:`train_step_launches` with the
    expert products over both ranks' capacity rows; data-axis
    collectives a step exact (``6 x layers`` all-to-alls, one f32 SUM a
    gradient leaf and one for the loss, one ZeRO-1 gather a split leaf).
    Logged: each all-to-all's bytes and host ms, ms a step, the mean's
    and the gathers' host ms, the peak a rank.  Returns rank 0's
    launches."""
    import gc
    import torch
    from repro_torch import configs, optim, tree
    from repro_torch.data import Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import data_config, device_batch
    from repro_torch.models import api
    tag = "train_mesh (b)"
    B, L, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN_MESH_MOE_STEPS
    rows = B // MESH_WORLD
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    full = configs.get_config("deepseek_moe_16b", engine_spec=MODEL_SPEC,
                              dtype="float32")
    cfg, predicted, why = train_depth(full, free, ranks=MESH_WORLD)
    per_step, n_contr = train_step_launches(cfg, rows, L,
                                            expert_ranks=MESH_WORLD)
    log(f"[{tag}] {card}: {cfg.name}: {why}; {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_experts} experts of "
        f"{cfg.d_model}x{cfg.d_ff_expert} (top-{cfg.topk}, "
        f"{cfg.n_shared_experts} shared), vocab {cfg.vocab}, remat blocks "
        f"of {cfg.remat_block}, dispatch {cfg.moe_dispatch}, "
        f"{cfg.dtype} activations; global batch "
        f"{B} x seq {L}, {rows} rows a rank; predicted peak "
        f"{predicted / 1e9:.1f} GB a rank; {n_contr} emulated contractions "
        f"a rank a step")

    # the witness: each rank's rows on one device, scatter path, averaged
    params = api.get_model(cfg).init(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    losses, w_sels, witness = [], [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(MESH_WORLD):
        pipe = Pipeline(data_config(cfg, seq_len=L, global_batch=B,
                                    seed=SEED), host_id=r,
                        num_hosts=MESH_WORLD)
        install, uninstall, sels = _routing_recorder(cfg.n_layers)
        install()
        try:
            loss, grads = S.loss_and_grads(
                cfg, params, device_batch(pipe.batch_at(0), dev))
        finally:
            uninstall()
        losses.append(float(loss))
        w_sels.append(sels)
        for k, g in _mesh_grads(grads, TRAIN_MESH_MOE_LEAVES).items():
            g = g.cpu() / MESH_WORLD
            witness[k] = g if k not in witness else witness[k] + g
        del loss, grads
    torch.cuda.synchronize()
    w_ms = (time.perf_counter() - t0) * 1e3 / MESH_WORLD
    w_loss = sum(losses) / MESH_WORLD
    n_params = sum(t.numel() for t in tree.leaves(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] witness (one device, each rank's {rows} rows, scatter "
        f"path, averaged): step-0 losses {losses}, mean {w_loss:.6f}; "
        f"{w_ms:.1f} ms a rank's forward + backward; {n_params / 1e9:.3f} "
        f"B parameters; this process keeps "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")

    ranks, mine, sels = _train_mesh_spawn(tag, TRAIN_MESH_MOE_FLAGS, cfg,
                                          TRAIN_MESH_MOE_LEAVES)
    flips = [expert_flips(a, b, cfg.n_experts)
             for a, b in zip(sels, w_sels)]
    n_flip = sum(f for per in flips for f, _ in per)
    log(f"[{tag}] expert selections of step 0's forward against the "
        f"witness's, by rank and layer: flipped (token, choice) pairs "
        f"{[[f for f, _ in per] for per in flips]} of {rows * L * cfg.topk}"
        f" a layer")
    if n_flip or any(len(a) != cfg.n_layers for a in sels):
        raise AssertionError(f"{tag}: expert flips against the witness: "
                             f"{flips}")
    dims = optim.zero_axes(api.get_model(cfg).init(
        cfg, generator=torch.Generator(), device="meta"), MESH_WORLD)
    want_data = {"pmean": len(dims) + 1,
                 "all_gather_cat": sum(d is not None for d in dims),
                 "all_to_all": 6 * cfg.n_layers, "all_gather_rows": 0}
    _train_mesh_check(tag, card, dev, ranks, mine, witness, w_loss, w_ms,
                      n_steps, rows, per_step, want_data, predicted)
    for r, out in enumerate(ranks):
        for i, s_ in enumerate(out["steps"]):
            a2a = s_["a2a"]
            log(f"[{tag}] {card}: rank {r} step {i}: {len(a2a)} "
                f"all-to-alls, MB / host ms each: " + ", ".join(
                    f"{b / 1e6:.1f} / {ms:.1f}" for b, ms in a2a)
                + f"; {sum(ms for _, ms in a2a):.1f} ms in all")
    return {k: v for k, v in ranks[0]["launches"].items()}


def _leaf_paths(tree, prefix=""):
    """The paths of a nested dict's leaves, in flatten order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import _build
    t_start = t0 = time.perf_counter()
    seconds = _build.build(verbose=True)
    log(f"[build] {len(seconds)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in seconds.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    from repro_torch.kernels import flash_attention as fa
    for dt in (torch.bfloat16, torch.float32):
        log(f"[flash] route {fa.route(dt)} ({str(dt)[6:]}) at D = Dv = "
            f"{ATTN['D']}: " + "; ".join(
                f"{name} {r['registers']} registers, {r['spill_bytes']} "
                f"spilled bytes a thread, {r['smem_bytes']} bytes of shared "
                f"memory and {r['threads']} threads a block"
                for name, r in fa.resources(dt, ATTN["D"], ATTN["D"]).items()))
    def lap(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    kern = phase_kernels(dev)
    host_us = wrapper_host_us(dev)
    lap("kernels")
    paths = {}
    paths["dgemm"], _ = phase_dgemm(
        dev, DGEMM_SPEC, ("split_fused", "group_gemm", "scale_accum_plain"))
    paths["dgemm_oz2"], ref = phase_dgemm(
        dev, OZ2_DGEMM_SPEC, ("split_fused", "group_gemm",
                              "scale_accum_const_plain", "unscale"),
        tag="dgemm_oz2")
    phase_dgemm_auto(dev, OZ2_AUTO_SPEC, ref)
    del ref
    paths["dgemm_sm"], _ = phase_dgemm(
        dev, SM_DGEMM_SPEC, ("split_fused", "group_gemm", "scale_accum_plain"),
        tag="dgemm_sm", small_too=(SM_PAIRWISE_SPEC,))
    paths["serve"], _, extra = phase_serve(
        dev, MODEL_SPEC, ("split_fused", "group_gemm", "scale_accum"),
        trace=True, paged=True, card=card)
    paths.update(extra)
    paths["serve_oz2"], _, _ = phase_serve(
        dev, OZ2_MODEL_SPEC, ("split_fused", "group_gemm",
                              "scale_accum_const"),
        tag="serve_oz2", trace=True, absent=("unscale",))
    paths["serve_sm"], _, _ = phase_serve(
        dev, SM_MODEL_SPEC, ("split_fused", "group_gemm", "scale_accum"),
        tag="serve_sm")
    lap("dgemm, serve, serve_oz2, serve_sm")
    paths["serve_obs"] = phase_serve_obs(dev, card)
    paths["flash"] = phase_flash(dev)
    lap("serve_obs, flash")
    paths["train"] = phase_train(dev)
    paths.update(phase_train_families(dev, card))
    lap("train, train_families")
    paths["serve_moe"], _ = phase_serve_moe(dev)
    paths["serve_mla"], _ = phase_serve_moe(dev, "deepseek_v2_236b",
                                            "serve_mla")
    lap("serve_moe, serve_mla")
    for arch in STATE_SERVE:
        tag = STATE_SERVE[arch]["tag"]
        paths[tag], _, extra = phase_serve_state(dev, arch, card)
        paths.update(extra)
    for arch, tag in CTX_SERVE.items():
        paths[tag], _, extra = phase_serve_ctx(dev, arch, card)
        paths.update(extra)
    lap("serve_ssm, serve_hybrid, serve_encdec, serve_vlm")
    paths.update(phase_mesh(dev, card))
    lap("mesh")
    paths.update(phase_train_mesh(dev, card))
    lap("train_mesh")

    records = []
    for name, (source, replaces) in KERNELS.items():
        main_rec = next(r for r in kern[name] if r["label"] == MAIN_CASE[name])
        rec = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[MAIN_PATH[name]][name],
            "main_path": MAIN_PATH[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            **({"launches_by_route": {
                p: {r: c[f"group_gemm_{r}"] for r in ("large", "skinny")}
                for p, c in paths.items()}} if name == "group_gemm" else {}),
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "case": main_rec["label"], "cases": kern[name],
            **({"wrapper_host_us": host_us} if name == "group_gemm" else {})}
        if rec["library_ms"] is None:
            rec["library_none_reason"] = NO_LIBRARY[name]
        records.append(rec)
    log(f"[total] wall time {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
