"""Recipes of the port.

Servable recipes: an env factory and a policy factory per environment name
(port of the serving half of ``repro.recipes`` and the
``repro.envs.registry`` entries the scheduler reads).  Training recipes:
env, policy and config factories per recipe name (port of the training
half of ``repro.recipes``), run by :mod:`repro_torch.run`."""
from __future__ import annotations

import ast
from typing import Callable, Dict, Iterable, NamedTuple

from . import hypergrid, seqs


class Recipe(NamedTuple):
    name: str
    make_env: Callable          # (**overrides) -> Environment
    make_policy: Callable       # (env, *, seed, device) -> policy
    smoke_overrides: Dict       # a seconds-scale instance


_RECIPES = {
    "bitseq": Recipe("bitseq", seqs.bitseq_env, seqs.bitseq_policy,
                     {"n": 16, "k": 4}),
}


class TrainRecipe(NamedTuple):
    name: str
    description: str
    make_env: Callable          # (**overrides) -> Environment
    make_policy: Callable       # (env, *, seed, device, requires_grad)
    make_config: Callable       # (env, num_envs, iterations) -> GFNConfig
    iterations: int
    num_envs: int
    #: (env, env_params, policy, *, seed, eval_batch) -> evaluators
    make_evals: Callable
    eval_every: int


_TRAIN_RECIPES = {
    "bitseq_tb": TrainRecipe(
        "bitseq_tb", "TB on 120-bit sequences (8-bit words), reward/log-prob "
        "correlation on held-out modes (paper §B.2)",
        seqs.bitseq_env, seqs.bitseq_policy, seqs.bitseq_config,
        iterations=50000, num_envs=16, make_evals=seqs.bitseq_evals,
        eval_every=1000),
    "tfbind8_tb": TrainRecipe(
        "tfbind8_tb", "TB on TFBind8 DNA sequences (4^8 states), TV vs "
        "proxy-reward target (paper §B.2.1)",
        seqs.tfbind8_env, seqs.tfbind8_policy, seqs.seq_tb_config,
        iterations=100000, num_envs=16, make_evals=seqs.enumerable_evals,
        eval_every=2000),
    "qm9_tb": TrainRecipe(
        "qm9_tb", "TB on QM9 small molecules (prepend/append, 11^5 "
        "states), TV vs proxy-reward target (paper §B.2.1)",
        seqs.qm9_env, seqs.qm9_policy, seqs.seq_tb_config,
        iterations=100000, num_envs=16, make_evals=seqs.enumerable_evals,
        eval_every=2000),
    "amp_tb": TrainRecipe(
        "amp_tb", "TB on antimicrobial-peptide design (variable length "
        "<= 60, vocab 20), reward correlation and log Z bounds (paper "
        "§B.2.2)",
        seqs.amp_env, seqs.amp_policy, seqs.amp_config,
        iterations=20000, num_envs=16, make_evals=seqs.amp_evals,
        eval_every=500),
}
for _obj in ("tb", "db", "subtb"):
    _TRAIN_RECIPES[f"hypergrid_{_obj}"] = TrainRecipe(
        f"hypergrid_{_obj}",
        f"{_obj.upper()} on the 4x8^4 hypergrid, exact-DP TV/JSD and log Z "
        "bounds against the closed-form target (paper §B.1; --set side=20 "
        "for the paper grid)",
        hypergrid.hypergrid_env, hypergrid.hypergrid_policy,
        hypergrid.hypergrid_config(_obj), iterations=20000, num_envs=16,
        make_evals=hypergrid.hypergrid_evals, eval_every=1000)


def names():
    return sorted(_RECIPES)


def train_names():
    return sorted(_TRAIN_RECIPES)


def get_train(name: str) -> TrainRecipe:
    if name not in _TRAIN_RECIPES:
        raise KeyError(f"recipe {name!r} is not trainable by the port; "
                       f"trainable: {train_names()}")
    return _TRAIN_RECIPES[name]


def get(name: str) -> Recipe:
    if name not in _RECIPES:
        raise KeyError(f"env {name!r} is not servable by the port; "
                       f"servable: {names()}")
    return _RECIPES[name]


def parse_overrides(pairs: Iterable[str], error: Callable[[str], None]
                    ) -> Dict:
    """``KEY=VALUE`` strings (the CLIs' ``--set``) as a dict, each value
    read as a Python literal where it is one, else kept as a string;
    ``error`` is called on a pair without ``=``."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            error(f"expected key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out
