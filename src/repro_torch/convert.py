"""Carry parameters across from the JAX package.

``params_from_jax`` flattens a nested dict of arrays (for example
``jax.device_get(policy_params)``) into tensors keyed by the ``/``-joined
leaf names the JAX checkpoint manager writes
(``checkpoint/manager.py:45-52``): ``decoder/layer_0/q/w``, ``readout/b``,
``log_z``.  :meth:`repro_torch.core.policies.TransformerPolicy.load_params`
takes that dict.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for key in sorted(tree):
        name = f"{prefix}{key}"
        leaf = tree[key]
        if isinstance(leaf, Mapping):
            flat.update(params_from_jax(leaf, prefix=f"{name}/"))
        else:
            flat[name] = torch.from_numpy(np.array(leaf, copy=True))
    return flat
