"""EB-GFN on the Ising model (port of ``repro.recipes.ising``; paper
§B.5): joint energy-model + GFlowNet training on the 9 x 9 lattice at
sigma = -0.1 from 2,000 MCMC samples, graded by -log RMSE of the learned
couplings.  Not a sample -> loss -> update loop, so the recipe drives
:class:`repro_torch.core.ebgfn.EBGFNLoop` itself (JAX's ``run_override``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.ebgfn import EBGFNLoop, neg_log_rmse
from ..core.policies import MLPPolicy
from ..device import DeviceLike, resolve_device
from ..envs.ising import IsingEnvironment, generate_ising_dataset

#: the recipe's dataset size (``--set num_data=``)
NUM_DATA = 2000


def ising_env(n: int = 9, sigma: float = -0.1) -> IsingEnvironment:
    return IsingEnvironment(n=n, sigma=sigma)


@functools.lru_cache(maxsize=4)
def _dataset(seed: int, n: int, sigma: float, num_data: int) -> np.ndarray:
    return generate_ising_dataset(seed, n, sigma, num_samples=num_data)


def ising_dataset(seed: int, n: int, sigma: float,
                  num_data: int = NUM_DATA) -> np.ndarray:
    """:func:`generate_ising_dataset`, made once per process for each
    argument tuple (the heat-bath chains take seconds at n = 9); a copy
    to each caller."""
    return _dataset(int(seed), int(n), float(sigma), int(num_data)).copy()


def ising_policy(env: IsingEnvironment, *, seed: int = 0,
                 device: DeviceLike = None,
                 requires_grad: bool = False) -> MLPPolicy:
    """MLP 4x256 over the spins: 2D forward logits, a learned P_B (D
    logits) and a flow head."""
    return MLPPolicy(env.D, env.action_dim, env.backward_action_dim,
                     hidden=(256, 256, 256, 256), learn_backward=True,
                     seed=seed, device=device, requires_grad=requires_grad)


def ising_loop(env: IsingEnvironment, policy, *, seed: int, iterations: int,
               num_envs: int = 256, num_data: int = NUM_DATA,
               **step_kwargs) -> EBGFNLoop:
    """The recipe's loop around ``policy``: ``num_data`` MCMC samples drawn
    from ``seed`` (as JAX's recipe draws them), on the policy's device."""
    data = ising_dataset(seed, env.n, env.sigma, num_data)
    dev = next(policy.params.parameters()).device
    return EBGFNLoop(env, policy, torch.as_tensor(data, device=dev),
                     iterations=iterations, num_envs=num_envs, **step_kwargs)


def run(*, seed: int, iterations: int, num_envs: int, env: Dict,
        device: DeviceLike, eval_every: int,
        log: Callable[[str], None], config: Optional[Dict] = None,
        transforms: Sequence = ()) -> dict:
    """The recipe's run function (JAX's ``_run``): the dataset (``--set
    num_data=``, default 2,000, drawn from ``seed``), then ``iterations``
    EB-GFN iterations, captured on CUDA.  History rows as JAX's, ``{it,
    gfn_loss, neg_log_rmse, mh_accept}`` (plus ``wall_s``), at every
    ``eval_every``-th iteration and the last (0: none).  ``config`` may
    set ``gfn_lr``, ``ebm_lr`` and ``alpha`` (other keys are warned about
    and dropped, as in JAX); ``transforms`` must add no params layer (the
    loop owns the reward params, the learned J)."""
    from ..envs.transforms import EnvTransform, apply_transforms
    overrides = dict(env)
    num_data = overrides.pop("num_data", NUM_DATA)
    environment = apply_transforms(ising_env(**overrides), transforms)
    layer = environment
    while isinstance(layer, EnvTransform):
        if layer.wraps_params:
            raise ValueError(
                f"transform {layer.name!r} adds a params layer, but "
                "EB-GFN owns the reward params (the learned J); only "
                "param-free transforms compose with ising_ebgfn")
        layer = layer.env
    config = dict(config or {})
    step_kwargs = {k: config[k] for k in ("gfn_lr", "ebm_lr", "alpha")
                   if k in config}
    dropped = sorted(set(config) - set(step_kwargs))
    if dropped:
        log(f"warning: ising_ebgfn ignores config overrides {dropped}; "
            "supported: gfn_lr, ebm_lr, alpha")
    dev = resolve_device(device)
    log("generating MCMC dataset (Wolff / heat-bath PT)...")
    t0 = time.perf_counter()
    ising_dataset(seed, environment.n, environment.sigma, num_data)
    dataset_s = time.perf_counter() - t0
    policy = ising_policy(environment, seed=seed, device=dev,
                          requires_grad=True)
    loop = ising_loop(environment, policy, seed=seed, iterations=iterations,
                      num_envs=num_envs, num_data=num_data, **step_kwargs)
    J_true = environment.init(dev).reward_params["J"]
    t0 = time.perf_counter()

    def callback(it, state, metrics, batch):
        if eval_every <= 0 or (it % eval_every and it != iterations - 1):
            return None
        row = {"it": it, "gfn_loss": float(metrics["gfn_loss"]),
               "neg_log_rmse": float(neg_log_rmse(state.J.detach(),
                                                  J_true)),
               "mh_accept": float(metrics["mh_accept"]),
               "wall_s": time.perf_counter() - t0}
        log(f"it {it:6d} gfn_loss {row['gfn_loss']:9.3f} -logRMSE "
            f"{row['neg_log_rmse']:.3f} mh_accept {row['mh_accept']:.2f} "
            f"({it / max(row['wall_s'], 1e-9):.1f} it/s)")
        return row

    state, history = loop.run(seed, iterations, callback=callback)
    history = [row for row in history if row is not None]
    return {"recipe": "ising_ebgfn", "state": state, "history": history,
            "rows": [{"step": r["it"], "neg_log_rmse": r["neg_log_rmse"]}
                     for r in history],
            "device": dev, "policy": policy, "loop": loop,
            "dataset_seconds": dataset_s}
