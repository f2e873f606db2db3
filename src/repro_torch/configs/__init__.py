"""Architecture registry — PyTorch port of ``repro.configs``.  One module
per arch, each exposing ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests).

The port carries every arch of the reference: the dense family's
internlm2-1.8b (the serving model), starcoder2-3b, phi4-mini-3.8b and
deepseek-7b, the MoE family's deepseek-moe-16b, the MLA family's
deepseek-v2-236b, the vlm family's llama-3.2-vision-11b, the encdec
family's seamless-m4t-medium, the SSM family's mamba2-780m and the
hybrid family's recurrentgemma-9b.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = ("internlm2_1_8b", "starcoder2_3b", "phi4_mini_3_8b",
            "deepseek_7b", "deepseek_moe_16b", "deepseek_v2_236b",
            "llama32_vision_11b", "seamless_m4t_medium", "mamba2_780m",
            "recurrentgemma_9b")

# accept hyphenated public names too
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_arch_module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; options: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, *, smoke: bool = False, **overrides) -> ModelConfig:
    mod = get_arch_module(name)
    cfg = mod.smoke() if smoke else mod.full()
    return cfg.with_(**overrides) if overrides else cfg


def rules_overrides(name: str) -> dict:
    """Per-arch logical->mesh overrides merged over the base rule table."""
    return getattr(get_arch_module(name), "RULES_OVERRIDES", {})
