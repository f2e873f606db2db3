"""Accuracy of the f32 flash-attention backward against f64 sums, on the card.

At internlm2-1.8b's attention width (B 1, L 4096, 16 query and 8 KV heads,
D 128, causal) with ``q_offset`` -100, the first 100 query rows see no key:
the finite sentinel gives them p = 1 on every key, and the gradients' sums
over 4096 keys cancel.  For each seed this prints, per gradient, the least
``tol`` with ``|x - y| <= tol (1 + |y|)`` for

  * ``kernel``: the 3xTF32 kernels (``flash_attention_bwd`` on the card);
  * ``f32 sums``: the same formula with every product and sum in f32, the
    key order of an ordinary f32 matmul;

and the same at ``q_offset`` 0 for comparison, against ``y`` from f64 sums of
the same formula on the same f32 scores.  The reference's tolerance is
2e-4.  The script reads the package beside it (``../src``), so a copy
placed in another checkout measures that checkout's kernels.

    python3 tools/flash_bwd_accuracy.py [SEED ...]      # default 0 1 2 3
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402

B, H, KV, D, L = 1, 16, 8, 128, 4096


def bwd(q, k, v, out, lse, do, dt, **kw):
    """The backward's formula on the f32 scores, every product and sum in
    ``dt`` (f32 in key order, as a plain f32 matmul sums, or f64)."""
    group = kw["group"]
    s = fa._scores(q, k, group, kw["causal"], None, k.shape[1],
                   kw["q_offset"])
    p = torch.exp(s.to(dt) - lse.to(dt))
    q, do = q.to(dt), do.to(dt)
    kg, vg = (t.repeat_interleave(group, dim=0).to(dt) for t in (k, v))
    delta = (do * out.to(dt)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vg.transpose(-1, -2)) - delta)
    scale = D ** -0.5
    dq = torch.matmul(ds, kg) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    return (dq, dk.reshape(KV, group, L, D).sum(1),
            dv.reshape(KV, group, L, D).sum(1))


def need(x, y):
    return float(((x - y).abs() / (1 + y.abs())).max())


def main(seeds):
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_accuracy: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    print(f"{'seed':>4} {'q_offset':>8} {'grad':>4} {'kernel':>10} "
          f"{'f32 sums':>10}")
    for seed in seeds:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn(s, generator=g, device=dev)
                       for s in ((B * H, L, D), (B * KV, L, D),
                                 (B * KV, L, D), (B * H, L, D)))
        for q_offset in (-100, 0):
            kw = dict(group=H // KV, causal=True, q_offset=q_offset)
            o, lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
            exact = bwd(q, k, v, o, lse, do, torch.float64, **kw)
            kern = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            plain = bwd(q, k, v, o, lse, do, torch.float32, **kw)
            for name, y, a, b in zip(("dq", "dk", "dv"), exact, kern, plain):
                print(f"{seed:>4} {q_offset:>8} {name:>4} {need(a, y):>10.3e} "
                      f"{need(b, y):>10.3e}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [0, 1, 2, 3])
