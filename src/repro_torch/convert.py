"""Carry parameters across from the JAX package.

``params_from_jax`` flattens a nested dict of arrays (for example
``jax.device_get(policy_params)``) into tensors keyed by the ``/``-joined
leaf names the JAX checkpoint manager writes
(``checkpoint/manager.py:45-52``): ``decoder/layer_0/q/w``, ``readout/b``,
``log_z``, or an LM's stacked ``layers/attn/wq``.
:meth:`repro_torch.core.policies.TransformerPolicy.load_params` and
:func:`repro_torch.models.lm.load_params` take that dict; a JAX EB-GFN
state's ``ebm_params`` gives ``{"J": ...}``, the coupling matrix of
:class:`repro_torch.core.ebgfn.EBGFNState`.  Leaves keep their dtype,
bfloat16 included.  Nothing here imports JAX.
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
            flat[name] = _to_tensor(np.array(leaf, copy=True))
    return flat


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype.  numpy has no bfloat16;
    JAX's bf16 leaves come as ``ml_dtypes.bfloat16`` arrays, which torch
    cannot read, so their bits cross as uint16 and are viewed as
    ``torch.bfloat16`` (exact)."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
