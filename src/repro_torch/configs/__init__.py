"""Config registry of the port: ``get_config("<arch-id>")``.

It holds the JAX package's ten architectures, each copied from
`repro/configs/`; `ARCH_IDS` equals the JAX package's.
"""
from . import (chatglm3_6b, command_r_35b, deepseek_v2_lite_16b, deepseek_v3_671b,
               jamba_1_5_large_398b, mamba2_130m, musicgen_large, pixtral_12b, stablelm_3b,
               starcoder2_15b)
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K, HybridConfig, InputShape,
                   MLAConfig, ModelConfig, MoEConfig, SSMConfig)

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (chatglm3_6b, command_r_35b, deepseek_v2_lite_16b, deepseek_v3_671b,
                      jamba_1_5_large_398b, mamba2_130m, musicgen_large, pixtral_12b,
                      stablelm_3b, starcoder2_15b)}

ARCH_IDS = tuple(sorted(REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_IDS)}")
    return REGISTRY[name]


__all__ = ["ARCH_IDS", "DECODE_32K", "HybridConfig", "InputShape", "LONG_500K", "MLAConfig",
           "ModelConfig", "MoEConfig", "PREFILL_32K", "REGISTRY", "SSMConfig", "TRAIN_4K",
           "get_config"]
