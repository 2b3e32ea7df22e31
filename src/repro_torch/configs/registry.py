"""Architecture registry: ``--arch <id>`` -> ``ModelConfig`` (port of
``repro.configs.registry``).

Only the architectures whose family the port runs are registered; asking
for any other raises ``NotImplementedError`` rather than handing back a
different model.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import hymba_1_5b

_MODULES = {m.ARCH_ID: m for m in (hymba_1_5b,)}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported to repro_torch yet "
            f"(ported: {ARCH_IDS}; the order of the rest is in ROADMAP.md)")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()
