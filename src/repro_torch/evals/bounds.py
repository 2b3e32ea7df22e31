"""Log-partition-function bounds (port of ``repro.evals.bounds``; paper
§B.2): ELBO, EUBO and the forward importance-sampling estimate of log Z.

With trajectory weight ``w(tau) = log R(x) + log P_B(tau|x) - log P_F(tau)``:

  ELBO      E_{tau ~ P_F}[w]                  <= log Z
  log_z_is  logsumexp_i(w_i) - log N  over tau_i ~ P_F
  EUBO      E_{x ~ R/Z, tau ~ P_B(.|x)}[w]    >= log Z

EUBO needs target samples, so it is given only when a probe of
reward-distributed terminal states is supplied.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.objectives import evaluate_trajectory
from ..core.rollout import backward_rollout, forward_rollout


class LogZBoundsEval:
    """``elbo`` / ``log_z_is`` from forward rollouts, and ``eubo`` from
    backward rollouts over target-distributed probe terminals when given.

    A sampled stop is an ordinary action, so ``evaluate_trajectory`` runs
    without a stop action, as in the JAX package: on CUDA its two
    log-probability sums go through the ``traj_logprob`` kernel.  The
    forward and backward rollouts draw from ``noise`` / ``backward_noise``
    (defaults: the rollouts' own streams), both keyed on the eval's seed."""

    def __init__(self, env, env_params, policy, num_samples: int = 256,
                 target_states=None,
                 target_log_r: Optional[torch.Tensor] = None,
                 noise=None, backward_noise=None):
        self.env, self.env_params, self.policy = env, env_params, policy
        self.num_samples = int(num_samples)
        self.target_states = target_states
        self.target_log_r = (None if target_log_r is None
                             else target_log_r.to(torch.float32))
        self.noise, self.backward_noise = noise, backward_noise
        names: Tuple[str, ...] = ("elbo", "log_z_is")
        if target_states is not None:
            names += ("eubo",)
        self.metric_names = names

    @torch.no_grad()
    def __call__(self, seed: int) -> Dict[str, torch.Tensor]:
        batch = forward_rollout(seed, self.env, self.env_params, self.policy,
                                self.num_samples, noise=self.noise)
        ev = evaluate_trajectory(self.policy, batch)
        w = batch.log_reward + ev.log_pb.sum(0) - ev.log_pf.sum(0)
        out = {"elbo": w.mean(),
               "log_z_is": (torch.logsumexp(w, 0)
                            - math.log(float(self.num_samples)))}
        if self.target_states is not None:
            # uncached, as JAX's eval (it passes the bare policy.apply)
            br = backward_rollout(seed, self.env, self.env_params,
                                  self.policy, self.target_states,
                                  noise=self.backward_noise,
                                  use_cache=False)
            out["eubo"] = (self.target_log_r + br.log_pb - br.log_pf).mean()
        return out
