"""Training of the context families (llama-3.2-vision-11b ``vlm``,
seamless-m4t-medium ``encdec``) against the reference.

The reference's ``smoke()`` parameters are carried across (the vlm's zero
gates drawn as +-U(0.5, 1.5): with the init's zero gates no gradient
reaches a cross layer's weights) and one numpy batch of the pipeline --
the tokens with the vlm's 16 patch rows or the encdec's 16 frames, drawn
from their own streams -- goes through both, in f32 activations:

* the loss within 1e-6 of its value, relative, and every gradient leaf
  within ``1e-5 * max|g|`` (``f32``) and ``1e-4 * max|g|``
  (``ozimmu_h-4:df32``) against ``jax.value_and_grad``: the gated
  cross-attention (the ``cross_kv`` projections of the normed patch rows,
  the stacked tanh gates), the vlm's nested remat (a group's self layers
  in remat blocks of their own inside the group's), the encoder's stack
  and the decoder's cross-attention to its output;
* gradients bitwise equal across remat blocks of 1 and 2 units (the vlm's
  groups, both encdec stacks) under ``:fused``;
* the kernel launches of one smoke train step under ``:fused``, counted at
  the wrappers, equal to ``chip_smoke.train_step_launches`` (the vlm's
  self layers run three forwards: their own recompute nests in their
  group's).
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as P_tree
from tests.torch_parity import (ref_train_params, remat_gradients,
                                train_batch, train_launches, train_parity)

torch.set_num_threads(1)

ARCHS = ["llama32_vision_11b", "seamless_m4t_medium"]


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    return arch, ref_train_params(arch), train_batch(arch)


@pytest.mark.parametrize("spec,tol", [("f32", 1e-5),
                                      ("ozimmu_h-4:df32", 1e-4)])
def test_gradients_match_reference(arch_params, spec, tol):
    arch, params, batch = arch_params
    assert ({"llama32_vision_11b": "image_embeds",
             "seamless_m4t_medium": "frames"}[arch]) in batch
    rloss, ploss, leaves = train_parity(arch, spec, params, batch)
    assert abs(ploss - rloss) <= 1e-6 * abs(rloss)
    bad = [(path, rel) for path, rel in leaves if not rel <= tol]
    assert not bad, bad
    if arch == "llama32_vision_11b":
        gates = [path for path, _ in leaves if "gate_" in path]
        assert len(gates) == 2


def test_remat_blocks_give_equal_gradients(arch_params):
    arch, params, batch = arch_params
    (l1, g1), (l2, g2) = remat_gradients(arch, params, batch)
    assert float(l1) == float(l2)
    for a, b in zip(P_tree.leaves(g1), P_tree.leaves(g2)):
        assert torch.equal(a, b)
    assert any(bool(g.any()) for g in P_tree.leaves(g1))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launch_counts(monkeypatch, arch):
    """llama-3.2-vision-11b ``smoke()``: 2 groups of a self layer (9
    contractions, three forwards, 19 backward) and a cross layer (9, two
    forwards, 19 backward) and the head's 3 (169 a step);
    seamless-m4t-medium: 2 encoder layers (8) and 2 decoder layers (15),
    forward, recompute and backward, and the head's 3 (185)."""
    counts, want, n = train_launches(monkeypatch, arch)
    assert n == {"llama32_vision_11b": 169, "seamless_m4t_medium": 185}[arch]
    assert counts == want


def test_modality_inputs_reach_the_gradients():
    """A second draw of the patch rows / frames (the pipeline's next step)
    moves the context path's gradients: the context is no constant of the
    check."""
    from repro_torch.data import Pipeline
    from repro_torch.launch import steps as P_steps
    from repro_torch.launch import train as P_train
    from repro_torch import configs as P_configs
    from repro_torch.models.convert import params_from_numpy
    for arch, leaf in (("llama32_vision_11b", ("groups", "cross", "ln_kv")),
                       ("seamless_m4t_medium", ("enc_layers", "ln1"))):
        cfg = P_configs.get_config(arch, smoke=True, dtype="float32")
        params = params_from_numpy(ref_train_params(arch), device="cpu")
        pipe = Pipeline(P_train.data_config(cfg, seq_len=16, global_batch=2,
                                            seed=3))
        b0, b1 = pipe.batch_at(0), pipe.batch_at(1)
        b1["tokens"] = b0["tokens"]
        outs = []
        for b in (b0, b1):
            _, g = P_steps.loss_and_grads(
                cfg, params, {k: torch.from_numpy(v) for k, v in b.items()})
            for k in leaf:
                g = g[k]
            outs.append(g)
        assert float((outs[0] - outs[1]).abs().max()) > \
            1e-3 * float(outs[0].abs().max())
        assert np.isfinite(outs[0].numpy()).all()
