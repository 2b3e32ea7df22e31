"""Architecture registry: ``--arch <id>`` -> ``ModelConfig`` (port of
``repro.configs.registry``): all ten architectures of the reference, in
its order, each with its reduced smoke variant.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (command_r_35b, command_r_plus_104b, hymba_1_5b, qwen2_5_32b,
               qwen2_72b, qwen2_moe_a2_7b, qwen2_vl_72b, qwen3_moe_30b_a3b,
               rwkv6_1_6b, whisper_medium)

# JAX's order (``repro.configs.registry._MODULES``): ARCH_IDS[0] is the LM
# entry point's default
_MODULES = {
    m.ARCH_ID: m for m in (
        qwen2_5_32b, command_r_plus_104b, qwen2_72b, command_r_35b,
        hymba_1_5b, rwkv6_1_6b, whisper_medium, qwen2_moe_a2_7b,
        qwen3_moe_30b_a3b, qwen2_vl_72b)
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r} (known: "
                       f"{', '.join(ARCH_IDS)})")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()
