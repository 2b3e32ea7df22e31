"""Architecture registry: ``--arch <id>`` -> ``ModelConfig`` (port of
``repro.configs.registry``).

Only the architectures whose family the port runs (dense, rwkv, hybrid)
are registered; asking for any other (the VLM, the two MoE configs,
Whisper) raises ``NotImplementedError`` rather than handing back a
different model.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (command_r_35b, command_r_plus_104b, hymba_1_5b, qwen2_5_32b,
               qwen2_72b, rwkv6_1_6b)

# JAX's order (``repro.configs.registry._MODULES``) with the unported
# architectures left out: ARCH_IDS[0] is the LM entry point's default
_MODULES = {
    m.ARCH_ID: m for m in (
        qwen2_5_32b, command_r_plus_104b, qwen2_72b, command_r_35b,
        hymba_1_5b, rwkv6_1_6b)
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported to repro_torch yet "
            f"(ported: {ARCH_IDS}; the order of the rest is in ROADMAP.md)")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()
