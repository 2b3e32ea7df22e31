"""Recipes of the port.

Servable envs: :func:`get` reads a :class:`Recipe` (env factory, policy
factory, smoke overrides) off the env registry
(:mod:`repro_torch.envs.registry`), for every entry whose ``serving``
column is not ``"none"``: the entry's factory and its default recipe's
policy factory, as the JAX scheduler builds them.  Training recipes:
env, policy and config factories per recipe name (port of the training
half of ``repro.recipes``), run by :mod:`repro_torch.run`; a recipe that
is not a sample -> loss -> update loop (EB-GFN's ``ising_ebgfn``) has a
``run_override`` that drives its own loop, as in the JAX package.
:func:`register` adds a third-party training recipe (JAX's
``repro.recipes.register``); JAX's ``get`` / ``names`` are
:func:`get_train` / :func:`train_names` here, since :func:`get` /
:func:`names` name the servable envs."""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

from . import box, dag, hypergrid, ising, phylo, seqs


class Recipe(NamedTuple):
    """A servable env: the registry entry's factory, its default recipe's
    policy factory and the entry's smoke overrides."""
    name: str
    make_env: Callable          # (**overrides) -> Environment
    make_policy: Callable       # (env, *, seed, device) -> policy
    smoke_overrides: Dict       # a seconds-scale instance


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
    #: (*, seed, iterations, num_envs, env, device, eval_every, log) ->
    #: run_recipe's dict: a run function of the recipe's own (JAX's
    #: ``run_override``); then make_config and make_evals are None
    run_override: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """A run's settings, resolved from the caller and the recipe's
    defaults (port of ``repro.recipes.base.RunOptions``; the execution
    plan, which no recipe reads, is ``run_recipe``'s own argument).
    ``num_envs`` is the global batch, which a data-parallel plan shards;
    ``eval_batch`` is the sample count of the sampling evals;
    ``transforms`` the env transform stack, innermost first
    (:func:`repro_torch.envs.transforms.parse_transform` specs);
    ``eval_every == 0`` turns evals off."""
    seed: int = 0
    iterations: int = 20000
    num_envs: int = 16
    eval_every: int = 1000
    eval_batch: int = 2000
    transforms: Tuple[str, ...] = ()


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
    "dag_mdb": TrainRecipe(
        "dag_mdb", "Modified DB on Bayesian-network structure learning "
        "(d=5, BGe score), reward correlation and log Z bounds; JSD against "
        "the exact posterior through recipes.dag.PosteriorJSDEval (paper "
        "§B.4)",
        dag.dag_env, dag.dag_policy, dag.dag_config, iterations=100000,
        num_envs=128, make_evals=dag.dag_evals, eval_every=2000),
    "phylo_fldb": TrainRecipe(
        "phylo_fldb", "Forward-looking DB on phylogenetic tree generation "
        "(dataset DS1 by default; --set reduced=True for a small synthetic "
        "alignment) (paper §B.3)",
        phylo.phylo_env, phylo.phylo_policy, phylo.phylo_config,
        iterations=100000, num_envs=32, make_evals=phylo.phylo_evals,
        eval_every=500),
    "ising_ebgfn": TrainRecipe(
        "ising_ebgfn", "EB-GFN joint EBM+GFN training on the 9x9 Ising "
        "model, -log RMSE of learned couplings (paper §B.5); --set "
        "n=.../sigma=.../num_data=...",
        ising.ising_env, ising.ising_policy, None, iterations=20000,
        num_envs=256, make_evals=None, eval_every=500,
        run_override=ising.run),
}
for _obj in ("tb", "db"):
    _TRAIN_RECIPES[f"box_{_obj}"] = TrainRecipe(
        f"box_{_obj}",
        f"{_obj.upper()} on the continuous 2-D Box with a squashed-mixture "
        "flow policy; quadrature-grid TV/JSD against the normalised mixture "
        "reward",
        box.box_env, box.box_policy, box.box_config(_obj), iterations=30000,
        num_envs=64, make_evals=box.box_evals, eval_every=1500)
for _obj in ("tb", "db", "subtb"):
    _TRAIN_RECIPES[f"hypergrid_{_obj}"] = TrainRecipe(
        f"hypergrid_{_obj}",
        f"{_obj.upper()} on the 4x8^4 hypergrid, exact-DP TV/JSD and log Z "
        "bounds against the closed-form target (paper §B.1; --set side=20 "
        "for the paper grid)",
        hypergrid.hypergrid_env, hypergrid.hypergrid_policy,
        hypergrid.hypergrid_config(_obj), iterations=20000, num_envs=16,
        make_evals=hypergrid.hypergrid_evals, eval_every=1000)


def register(recipe: TrainRecipe) -> TrainRecipe:
    """Add a training recipe to the registry (idempotent by name); it is
    then runnable as ``python -m repro_torch.run --recipe <name>``."""
    _TRAIN_RECIPES[recipe.name] = recipe
    return recipe


def names():
    """The servable env names (registry entries whose ``serving`` column
    is not ``"none"``)."""
    from ..envs.registry import ENVS
    return sorted(n for n, e in ENVS.items() if e.serving != "none")


def train_names():
    return sorted(_TRAIN_RECIPES)


def get_train(name: str) -> TrainRecipe:
    if name not in _TRAIN_RECIPES:
        raise KeyError(f"recipe {name!r} is not trainable by the port; "
                       f"trainable: {train_names()}")
    return _TRAIN_RECIPES[name]


def get(name: str) -> Recipe:
    """The servable env ``name``: the one lookup the scheduler and the
    command line serve through.  KeyError for an unknown env and for an
    entry whose ``serving`` column is ``"none"``."""
    from ..envs.registry import get_env
    entry = get_env(name)
    if entry.serving == "none":
        raise KeyError(
            f"env {name!r} is not servable: its recipe ({entry.recipe!r}) "
            "has no standalone policy (see the serving column of "
            f"--list-envs); servable: {names()}")
    return Recipe(name, entry.make, get_train(entry.recipe).make_policy,
                  dict(entry.smoke_overrides))


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
