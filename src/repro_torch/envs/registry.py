"""Environment registry (port of ``repro.envs.registry``).

An :class:`EnvEntry` names a factory, a default recipe (the policy and
objective that drive the env from the CLI), the small-instance overrides of
smoke runs, and the transforms that can be built on it, so any registered
env, transform stack and objective can be launched as::

    python -m repro_torch.run --env hypergrid --transform beta=2.0
    python -m repro_torch.run --list-envs

``--set key=value`` overrides go to the factory as they do to a recipe's
``make_env``.  The catalog has the JAX package's nine entries, with its
factories' defaults, smoke overrides, transform lists and columns;
``serving`` is the serving tier's column: the port's scheduler serves
every entry whose column is not ``"none"``, through the KV cache or by
observing the full state at each step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

ENVS: Dict[str, "EnvEntry"] = {}


@dataclasses.dataclass(frozen=True)
class EnvEntry:
    """One registered environment.

    make(**overrides)  -> Environment (bare; transforms wrap on top)
    recipe             the default recipe driving this env from the CLI
    smoke_overrides    factory overrides of a seconds-scale instance
    transforms         transform specs that can be built on it
    serving            serving tier: "kv-cache", "full-obs" or "none"
    action_space       "discrete" or "continuous" (``--list-envs``'s
                       ``actions`` column)
    """
    name: str
    description: str
    make: Callable[..., Any]
    recipe: str
    smoke_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    transforms: Tuple[str, ...] = ("identity", "reward_exponent")
    serving: str = "full-obs"
    action_space: str = "discrete"


def register_env(entry: EnvEntry) -> EnvEntry:
    """Add an env to the registry (idempotent by name)."""
    ENVS[entry.name] = entry
    return entry


def get_env(name: str) -> EnvEntry:
    if name not in ENVS:
        raise KeyError(f"unknown env {name!r}; available: {env_names()}")
    return ENVS[name]


def env_names() -> list:
    return sorted(ENVS)


def make_env(name: str, transforms: Tuple[str, ...] = (), **overrides):
    """Build a registered env, wrapped in a transform stack."""
    from .transforms import apply_transforms
    return apply_transforms(get_env(name).make(**overrides), transforms)


# ---------------------------------------------------------------------------
# The catalog (paper §3): the recipes' env factories
# ---------------------------------------------------------------------------

def _hypergrid(dim: int = 4, side: int = 8):
    from ..recipes.hypergrid import hypergrid_env
    return hypergrid_env(dim=dim, side=side)


def _bitseq(n: int = 120, k: int = 8, beta: float = 3.0, seed: int = 0):
    from ..recipes.seqs import bitseq_env
    return bitseq_env(n=n, k=k, beta=beta, seed=seed)


def _tfbind8():
    from ..recipes.seqs import tfbind8_env
    return tfbind8_env()


def _qm9():
    from ..recipes.seqs import qm9_env
    return qm9_env()


def _amp(max_len: int = 60):
    from ..recipes.seqs import amp_env
    return amp_env(max_len=max_len)


def _dag(d: int = 5, score: str = "bge", num_samples: int = 100,
         seed: int = 0):
    from ..recipes.dag import dag_env
    return dag_env(d=d, score=score, num_samples=num_samples, seed=seed)


def _phylo(ds: int = 1, reduced: bool = False, seed: int = 0):
    from ..recipes.phylo import phylo_env
    return phylo_env(ds=ds, reduced=reduced, seed=seed)


def _ising(n: int = 9, sigma: float = -0.1):
    from ..recipes.ising import ising_env
    return ising_env(n=n, sigma=sigma)


def _box(delta_min: float = 0.1, delta_max: float = 0.25):
    from ..recipes.box import box_env
    return box_env(delta_min=delta_min, delta_max=delta_max)


register_env(EnvEntry(
    name="hypergrid",
    description="d-dim hypergrid with the Bengio et al. 2021 mode reward "
                "(paper §3.1)",
    make=_hypergrid, recipe="hypergrid_tb",
    smoke_overrides={"dim": 2, "side": 6},
    transforms=("identity", "reward_exponent", "reward_cache",
                "time_limit:limit=8")))

register_env(EnvEntry(
    name="bitseq",
    description="non-autoregressive n-bit sequences, min-Hamming mode "
                "reward (paper §3.2)",
    make=_bitseq, recipe="bitseq_tb",
    smoke_overrides={"n": 16, "k": 4},
    transforms=("identity", "reward_exponent", "reward_cache"),
    serving="kv-cache"))

register_env(EnvEntry(
    name="tfbind8",
    description="DNA binding-activity sequences, length 8, vocab 4 "
                "(paper §3.3)",
    make=_tfbind8, recipe="tfbind8_tb",
    transforms=("identity", "reward_exponent", "reward_cache"),
    serving="kv-cache"))

register_env(EnvEntry(
    name="qm9",
    description="prepend/append small molecules, 5 blocks from 11 words, "
                "proxy HOMO-LUMO reward (paper §3.4)",
    make=_qm9, recipe="qm9_tb",
    transforms=("identity", "reward_exponent", "reward_cache")))

register_env(EnvEntry(
    name="amp",
    description="variable-length antimicrobial peptides <= 60 tokens, "
                "proxy classifier reward (paper §3.5)",
    make=_amp, recipe="amp_tb",
    smoke_overrides={"max_len": 12},
    transforms=("identity", "reward_exponent", "time_limit:limit=8"),
    serving="kv-cache"))

register_env(EnvEntry(
    name="phylo",
    description="phylogenetic tree generation, Fitch parsimony Gibbs "
                "reward (paper §3.6)",
    make=_phylo, recipe="phylo_fldb",
    smoke_overrides={"reduced": True},
    transforms=("identity", "reward_exponent")))

register_env(EnvEntry(
    name="dag",
    description="Bayesian-network structure learning, BGe/linear-Gaussian "
                "modular score (paper §3.7)",
    make=_dag, recipe="dag_mdb",
    smoke_overrides={"d": 4},
    transforms=("identity", "reward_exponent")))

register_env(EnvEntry(
    name="ising",
    description="Ising lattice with Gibbs coupling reward; EB-GFN learns J "
                "jointly (paper §3.8)",
    make=_ising, recipe="ising_ebgfn",
    smoke_overrides={"n": 4, "sigma": 0.2},
    # the EB-GFN loop owns the reward params (the learned J): only
    # param-free wrappers compose with it
    transforms=("identity",),
    serving="none"))

register_env(EnvEntry(
    name="box",
    description="continuous 2-D Box in [0,1]^2: bounded increments + exit, "
                "mixture-of-Gaussians reward (Lahlou et al. / torchgfn)",
    make=_box, recipe="box_tb",
    # a continuum has no flat terminal index, so no reward_cache
    transforms=("identity", "reward_exponent"),
    serving="none",
    action_space="continuous"))
