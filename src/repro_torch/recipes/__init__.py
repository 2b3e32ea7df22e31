"""Servable recipes of the port: an env factory and a policy factory per
environment name (port of the serving half of ``repro.recipes`` and the
``repro.envs.registry`` entries the scheduler reads)."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from . import seqs


class Recipe(NamedTuple):
    name: str
    make_env: Callable          # (**overrides) -> Environment
    make_policy: Callable       # (env, *, seed, device) -> policy
    smoke_overrides: Dict       # a seconds-scale instance


_RECIPES = {
    "bitseq": Recipe("bitseq", seqs.bitseq_env, seqs.bitseq_policy,
                     {"n": 16, "k": 4}),
}


def names():
    return sorted(_RECIPES)


def get(name: str) -> Recipe:
    if name not in _RECIPES:
        raise KeyError(f"env {name!r} is not servable by the port; "
                       f"servable: {names()}")
    return _RECIPES[name]
