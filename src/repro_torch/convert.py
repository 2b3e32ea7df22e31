"""Carry parameters across from the JAX package.

``params_from_jax`` flattens a nested dict of arrays (for example
``jax.device_get(policy_params)``) into tensors keyed by the ``/``-joined
leaf names the JAX checkpoint manager writes
(``checkpoint/manager.py:45-52``): ``decoder/layer_0/q/w``, ``readout/b``,
``log_z``, or an LM's stacked ``layers/attn/wq``.
``train_state_from_jax`` carries an LM training state across: JAX's
``(params, opt_state)`` of ``repro.launch.steps`` (the chain's tuple with
``AdamState(count, mu, nu)`` inside) becomes the port's (``{"model":
ParamTree, "log_z"}``, the same tuple of ``repro_torch.optim.adamw``
states), so a JAX-initialized state trains in the port.
:meth:`repro_torch.core.policies.TransformerPolicy.load_params` and
:func:`repro_torch.models.lm.load_params` take that dict; a JAX EB-GFN
state's ``ebm_params`` gives ``{"J": ...}``, the coupling matrix of
:class:`repro_torch.core.ebgfn.EBGFNState`.  Leaves keep their dtype,
bfloat16 included.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .nn.core import ParamTree
from .optim.adamw import AdamState


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


def _nested(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: (_nested(v) if isinstance(v, Mapping)
                else _to_tensor(np.array(v, copy=True)))
            for k, v in tree.items()}


def opt_state_from_jax(state: Any) -> Any:
    """A JAX optimizer state (``repro.optim.adamw``'s: tuples, ``()``,
    0-dim counts, ``AdamState`` with nested ``mu`` / ``nu``) as the port's:
    the same tuples, ``AdamState`` with flat ``mu`` / ``nu`` dicts keyed by
    leaf name, 0-dim tensors of the same dtypes.  Any named tuple with
    the fields ``count``, ``mu``, ``nu`` is read as an Adam state."""
    if getattr(state, "_fields", None) == ("count", "mu", "nu"):
        return AdamState(_to_tensor(np.array(state.count, copy=True)),
                         params_from_jax(state.mu), params_from_jax(state.nu))
    if isinstance(state, tuple):
        return tuple(opt_state_from_jax(s) for s in state)
    return _to_tensor(np.array(state, copy=True))


def train_state_from_jax(params: Mapping[str, Any],
                         opt_state: Optional[Any] = None,
                         device=None) -> Tuple[Dict[str, Any], Any]:
    """JAX's LM ``(params, opt_state)`` (``jax.device_get`` of
    ``repro.launch.steps.init_lm_params`` and ``tx.init``) as the port's,
    on ``device``: ``({"model": ParamTree (leaves require grad), "log_z":
    0-dim tensor requiring grad}, opt_state or None)``."""
    model = ParamTree(_nested(params["model"]), requires_grad=True)
    model.to(device)
    log_z = _to_tensor(np.array(params["log_z"], copy=True)).to(device)
    port = {"model": model, "log_z": log_z.requires_grad_(True)}
    if opt_state is None:
        return port, None
    state = opt_state_from_jax(opt_state)
    return port, opt_state_to(state, device)


def opt_state_to(state: Any, device) -> Any:
    """A port optimizer state (tuples, 0-dim counts, ``AdamState``) with
    every tensor moved to ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, AdamState):
        return AdamState(state.count.to(device),
                         {n: t.to(device) for n, t in state.mu.items()},
                         {n: t.to(device) for n, t in state.nu.items()})
    return tuple(opt_state_to(s, device) for s in state)
