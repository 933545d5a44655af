"""Config registry of the port: ``get_config("<arch-id>")``.

It holds only the architectures the port runs so far; the JAX package's
other configs raise `KeyError` until their slice lands (see ROADMAP.md).
"""
from . import (chatglm3_6b, deepseek_v2_lite_16b, deepseek_v3_671b, jamba_1_5_large_398b,
               mamba2_130m, stablelm_3b)
from .base import HybridConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (chatglm3_6b, deepseek_v2_lite_16b, deepseek_v3_671b, jamba_1_5_large_398b,
                      mamba2_130m, stablelm_3b)}

ARCH_IDS = tuple(sorted(REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{', '.join(ARCH_IDS)}")
    return REGISTRY[name]


__all__ = ["ARCH_IDS", "HybridConfig", "MLAConfig", "ModelConfig", "MoEConfig",
           "REGISTRY", "SSMConfig", "get_config"]
