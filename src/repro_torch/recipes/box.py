"""Box recipes of the port (port of ``repro.recipes.box``): continuous-state
GFlowNets on the 2-D Box env with squashed-mixture flow policies (Lahlou
et al.), trained with TB (``box_tb``) or DB (``box_db``, through the
policy's flow head) and graded by :class:`QuadratureDistributionEval`, TV
and JSD of sampled terminals against the quadrature-binned mixture reward.
"""
from __future__ import annotations

from ..core.trainer import GFNConfig
from ..device import DeviceLike
from ..envs.box import BoxEnvironment
from ..evals import QuadratureDistributionEval
from ..nn.flows import BoxFlowPolicy

#: quadrature grid resolution of the eval metrics
GRID = 16
#: fewest rollouts an eval takes: below it the binning noise dominates the
#: metric, so ``eval_batch`` is raised to it
MIN_EVAL_SAMPLES = 8192


def box_env(delta_min: float = 0.1,
            delta_max: float = 0.25) -> BoxEnvironment:
    return BoxEnvironment(delta_min=delta_min, delta_max=delta_max)


def box_policy(env: BoxEnvironment, *, seed: int = 0,
               device: DeviceLike = None,
               requires_grad: bool = False) -> BoxFlowPolicy:
    """MLP torso 4 -> 128 -> 128 -> 50, K = 4 components."""
    return BoxFlowPolicy(env, hidden=(128, 128), num_components=4, seed=seed,
                         device=device, requires_grad=requires_grad)


def box_config(objective: str):
    def make_config(env: BoxEnvironment, num_envs: int = 64,
                    iterations: int = 30000) -> GFNConfig:
        """lr 1e-3, log Z lr 0.1, a constant epsilon of 0.1 (on-policy TB
        collapses on this env without standing coverage of early exits),
        no stop action: exit is a density-head decision."""
        return GFNConfig(objective=objective, num_envs=num_envs, lr=1e-3,
                         log_z_lr=1e-1, stop_action=None,
                         exploration_eps=0.1)
    return make_config


def box_evals(env: BoxEnvironment, env_params, policy, *, seed: int = 0,
              eval_batch: int = 2000):
    """The quadrature eval on the 16 x 16 grid over ``max(eval_batch,
    MIN_EVAL_SAMPLES)`` non-exploring rollouts."""
    return [QuadratureDistributionEval(
        env, env_params, policy, grid_size=GRID,
        num_samples=max(eval_batch, MIN_EVAL_SAMPLES))]
