"""The port's dense configs beyond internlm2-1.8b (starcoder2-3b,
phi4-mini-3.8b, deepseek-7b: SwiGLU, GQA or MHA) against the reference.

Each arch's ``smoke()`` config, with weights initialized by the JAX model
and carried across with ``params_from_numpy``, gives the reference's
forward logits under ``ozimmu_h-4:df32:fused`` in f32 activations within
``1e-4 * max|logit|`` (every contraction is bitwise; RoPE's sin/cos, the
norm's rsqrt and the softmax's exp differ by an ulp between XLA and
PyTorch), and the registry takes the arch's hyphenated public name.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as R_configs
from repro.models import api as R_api
from repro_torch import configs as P_configs
from repro_torch.models import api as P_api
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "phi4_mini_3_8b",
                                  "deepseek_7b"])
def test_dense_config_matches_reference(arch):
    rcfg = R_configs.get_config(arch, smoke=True,
                                engine_spec="ozimmu_h-4:df32",
                                dtype="float32")
    pcfg = P_configs.get_config(arch.replace("_", "-"), smoke=True,
                                engine_spec="ozimmu_h-4:df32:fused",
                                dtype="float32")
    assert pcfg == P_configs.get_config(arch, smoke=True,
                                        engine_spec="ozimmu_h-4:df32:fused",
                                        dtype="float32")
    full_r, full_p = R_configs.get_config(arch), P_configs.get_config(arch)
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "rope_theta", "mlp_type", "hd"):
        assert getattr(full_p, field) == getattr(full_r, field), field
    params, _ = R_api.get_model(rcfg).init(jax.random.PRNGKey(0), rcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 8),
                                             dtype=np.int32)
    ref = np.asarray(R_api.get_model(rcfg).forward(
        params, rcfg, {"tokens": jnp.asarray(toks)}))
    out = P_api.get_model(pcfg).forward(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        pcfg, {"tokens": torch.from_numpy(toks)}).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", P_configs.ARCH_IDS)
def test_every_config_field_matches_reference(arch, smoke):
    """Every field of the port's config (the reference's fields the port
    carries, ``remat_block`` among them) has the reference's value, in the
    published config and in the smoke one."""
    import dataclasses
    ref = R_configs.get_config(arch, smoke=smoke)
    port = P_configs.get_config(arch, smoke=smoke)
    fields = [f.name for f in dataclasses.fields(port)]
    assert "remat_block" in fields
    for name in fields:
        assert getattr(port, name) == getattr(ref, name), name
