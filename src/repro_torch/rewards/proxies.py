"""The proxy models of the QM9 and AMP rewards, carried across from JAX.

The JAX package draws both proxies from ``jax.random.PRNGKey(seed)``
(``repro/rewards/qm9.py``, ``repro/rewards/amp.py``).  The port imports no
JAX and cannot redraw them, so the seed-0 draws are kept in
``proxies.npz`` beside this module, under the leaf names of
:func:`repro_torch.convert.params_from_jax` prefixed ``qm9/`` and
``amp/``.  JAX draws AMP's positional table for each ``max_len`` (the
same key, another shape: other values), so the tables of the shorter
lengths in :data:`AMP_LENGTHS` are kept beside it, under ``amp_len<n>/``.
``python tests/test_torch_seqs.py --write-proxies`` writes the file from
the JAX package in this repository, and a test there holds every leaf to
JAX's draw bit for bit.  No other seed or length is available: a proxy
drawn by torch would be another reward landscape.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

PROXIES = Path(__file__).with_name("proxies.npz")
WRITER = "python tests/test_torch_seqs.py --write-proxies"
#: the AMP max_len values whose positional table the file holds: the
#: recipe's 60, the 10 of the CPU commands and tests, and the 12 of the
#: registry's smoke instance (the serving tests)
AMP_LENGTHS = (60, 10, 12)


def as_tensors(tree: Dict[str, Any], device: torch.device
               ) -> Dict[str, Any]:
    """A nested dict of arrays (a proxy handed over as params) as float32
    tensors on ``device``."""
    return {k: as_tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.array(v, dtype=np.float32),
                                 device=device)
            for k, v in tree.items()}


def load_proxy(name: str, seed: int, device: torch.device
               ) -> Dict[str, Any]:
    """The nested parameter dict of proxy ``name`` ("qm9" or "amp") at
    ``seed``, as float32 tensors on ``device``.  Only seed 0 exists."""
    if int(seed) != 0:
        raise ValueError(
            f"the {name} proxy exists for seed 0 only (JAX's draw, carried "
            f"across by `{WRITER}`); got seed {seed}")
    tree: Dict[str, Any] = {}
    with np.load(PROXIES) as data:
        for key in data.files:
            top, *path = key.split("/")
            if top != name:
                continue
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = torch.as_tensor(data[key], device=device)
    if not tree:
        raise KeyError(f"{PROXIES.name} holds no {name!r} proxy")
    return tree
