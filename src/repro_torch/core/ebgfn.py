"""EB-GFN: joint energy-model + GFlowNet training (port of
``repro.core.ebgfn``; paper §B.5, after Zhang et al. 2022) on the Ising
environment.

Each iteration (JAX's ``step_fn``):

1. a GFlowNet update with TB against the current learned energy reward
   R(x) = exp(x^T J_phi x), on trajectories taken per row from the forward
   policy with probability alpha, else sampled back under the learned P_B
   from a data terminal (a collecting backward rollout);
2. an energy update with the contrastive-divergence gradient (Eq. 19)
   against the updated policy: the negative sample x' comes from a fresh
   forward rollout (K = D, full regeneration) and is accepted by the MH
   ratio of Eq. 20, whose P_T(x) is the data rows' one-sample
   backward-rollout estimate.

J_phi is symmetric with a zero diagonal (:func:`symmetrize`) and graded by
:func:`neg_log_rmse` against the true J (paper Table 8).

The iteration reads nothing on the host, so it captures in a CUDA graph
(:class:`repro_torch.algo.loop.CapturedIteration`), as the on-policy
loop's does: the run's data rows are drawn on the host before the first
iteration (the JAX recipe's ``RandomState(seed).randint`` stream) into a
device table that iteration i reads at row i, and each of the iteration's
six draws comes from a noise source of its own (:class:`EBGFNNoise`),
keyed on ``train_seed(seed, i)``.  JAX hands one key to both the MH test's
backward rollout and its uniforms (``ebgfn.py:110-116``); the port draws
the two from separate streams.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..algo.loop import CapturableLoop, ScanLog, loss_and_grads
from ..envs.ising import IsingEnvironment, IsingParams
from .objectives import evaluate_trajectory, tb_parts
from .rollout import (BackwardRollout, RolloutBatch, backward_rollout,
                      forward_rollout)
from .types import (NoiseSource, TrainState, hash_backward_gumbel,
                    hash_gumbel, hash_stream_gumbel, hash_uniform, train_seed)

#: ``coin(seed, index) -> (B,)`` uniforms in (0, 1) over (B,) int64 seeds
#: and row indices
CoinSource = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def symmetrize(J: torch.Tensor) -> torch.Tensor:
    J = 0.5 * (J + J.T)
    return J - torch.diag(torch.diag(J))


def neg_log_rmse(J_learned: torch.Tensor,
                 J_true: torch.Tensor) -> torch.Tensor:
    """Paper Table 8's metric, -log RMSE(J_phi, J) (higher is better)."""
    return -torch.log(torch.sqrt(
        (symmetrize(J_learned) - J_true).square().mean()))


def _coin(stream: int) -> CoinSource:
    return lambda seed, index: hash_uniform(seed, index, stream)


class EBGFNNoise(NamedTuple):
    """The sources of an iteration's six draws, each called with the
    iteration's seed:

    fwd     the GFN update's forward rollout (Gumbel, (B, A))
    bwd     its collecting backward rollout from data (Gumbel, (B, Ab))
    take    the per-row mix coin: the forward trajectory where < alpha
    neg     the negatives' forward rollout
    mh_bwd  the MH test's backward rollout from data
    mh_u    the MH test's uniforms

    :data:`EBGFN_NOISE` is the default; parity tests replay JAX's draws."""
    fwd: NoiseSource
    bwd: NoiseSource
    take: CoinSource
    neg: NoiseSource
    mh_bwd: NoiseSource
    mh_u: CoinSource


#: counter-hash draws, each on a stream of its own
EBGFN_NOISE = EBGFNNoise(
    fwd=hash_gumbel, bwd=hash_backward_gumbel, take=_coin(0x243F6A88),
    neg=hash_stream_gumbel(0x9E3779B9), mh_bwd=hash_stream_gumbel(0x7F4A7C15),
    mh_u=_coin(0x85A308D3))


@dataclasses.dataclass
class EBGFNState(TrainState):
    """The joint carry: the GFlowNet's :class:`TrainState` (its optimizer
    a plain Adam over every leaf at ``gfn_lr``, ``log_z`` included, as
    JAX's ``adam(gfn_lr)``), the energy model's ``J`` (D, D) and its Adam,
    and ``rows`` (iterations, B) int64, the data rows of each iteration on
    the device."""
    J: torch.nn.Parameter
    ebm_optimizer: torch.optim.Optimizer
    rows: torch.Tensor


class MHTest(NamedTuple):
    """The MH test of an iteration's energy update (Eq. 20), per row: the
    negatives' forward rollout, the MH backward rollout from the data rows
    (its totals; with ``collect``, its trajectories too), log A, log u and
    the outcome ``log u < log A``."""
    neg: RolloutBatch
    mh: BackwardRollout
    log_a: torch.Tensor
    log_u: torch.Tensor
    accept: torch.Tensor


class EBGFNTrace(NamedTuple):
    """What one iteration computed on the way (the parity checks' view):
    the reward params every rollout read (the symmetrised J before the
    update), the data rows, the mix coin's outcome, the GFN update's two
    rollouts and the :class:`MHTest`."""
    reward: IsingParams
    data: torch.Tensor
    take_fwd: torch.Tensor
    fwd: RolloutBatch
    bwd: RolloutBatch
    test: MHTest


def data_rows(seed: int, num_data: int, num_envs: int,
              iterations: int) -> np.ndarray:
    """(iterations, num_envs) int64: the data rows JAX's recipe draws,
    ``RandomState(seed).randint(0, num_data, num_envs)`` once per
    iteration; one call draws the same stream."""
    return np.random.RandomState(seed).randint(0, num_data,
                                               (iterations, num_envs))


def _adam(params, lr: float) -> torch.optim.Adam:
    """JAX's ``optim.adam(lr)``: Adam (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root), ``capturable`` on CUDA, as the on-policy loop's."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params[0].is_cuda)


def _energy(x: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """(B,) E_J(x) = -x^T J x of float (B, D) spins."""
    return -((x @ J) * x).sum(-1)


def _mix(take: torch.Tensor, a: RolloutBatch, b: RolloutBatch
         ) -> RolloutBatch:
    """Per row, ``a``'s trajectory where ``take``, else ``b``'s."""
    def sel(x, y):
        t = take if x.dim() == 1 else take.reshape(
            (1, -1) + (1,) * (x.dim() - 2))
        return torch.where(t, x, y)

    return RolloutBatch(**{f.name: sel(getattr(a, f.name),
                                       getattr(b, f.name))
                           for f in dataclasses.fields(a)})


class EBGFNLoop(CapturableLoop):
    """EB-GFN on the Ising env (JAX's ``make_ebgfn_step``): ``policy`` an
    :class:`repro_torch.core.policies.MLPPolicy` with a learned P_B whose
    parameters require grad, ``data`` the (N, D) int8 dataset on the
    policy's device, ``iterations`` the rows of the data table
    :meth:`init` draws (a run's length; iteration i reads row i modulo
    it).  :meth:`iteration` is the body that :meth:`step` runs and
    :meth:`capture` captures; iteration i draws its noise from
    ``train_seed(seed, i)``."""

    METRICS = ("gfn_loss", "mh_accept")

    def __init__(self, env: IsingEnvironment, policy, data: torch.Tensor, *,
                 iterations: int, num_envs: int = 256, gfn_lr: float = 1e-3,
                 ebm_lr: float = 1e-2, alpha: float = 0.5,
                 noise: EBGFNNoise = EBGFN_NOISE):
        if not all(p.requires_grad for p in policy.params.parameters()):
            raise ValueError("EBGFNLoop needs a policy whose parameters "
                             "require grad (requires_grad=True)")
        self.env, self.policy, self.data = env, policy, data
        self.iterations, self._num_envs = int(iterations), int(num_envs)
        self.gfn_lr, self.ebm_lr, self.alpha = gfn_lr, ebm_lr, alpha
        self.noise = noise
        self._ids = torch.arange(self._num_envs, dtype=torch.int64,
                                 device=data.device)

    @property
    def num_envs(self) -> int:
        return self._num_envs

    def init(self, seed: int) -> EBGFNState:
        train_seed(seed, 0)                   # the seed's range check
        params = self.policy.params
        dev = self.data.device
        D = self.env.D
        J = torch.nn.Parameter(torch.zeros((D, D), dtype=torch.float32,
                                           device=dev))
        rows = data_rows(seed, self.data.shape[0], self._num_envs,
                         self.iterations)
        return EBGFNState(
            params=params, optimizer=_adam(params.parameters(), self.gfn_lr),
            seed=int(seed),
            counter=torch.zeros((), dtype=torch.int64, device=dev),
            J=J, ebm_optimizer=_adam([J], self.ebm_lr),
            rows=torch.from_numpy(rows).to(dev))

    def trained(self, state: EBGFNState) -> Dict[str, torch.Tensor]:
        """The policy's parameters and ``J``."""
        return {**self.policy.params.flat(), "J": state.J}

    @torch.no_grad()
    def mh_test(self, seed: torch.Tensor, reward: IsingParams,
                data: torch.Tensor, collect: bool = False) -> MHTest:
        """The MH test (Eq. 20) with the policy as it stands (the energy
        update runs it after the GFN update): negatives x' by a fresh
        forward rollout, log P_T of the data rows x by a one-sample
        backward-rollout estimate (log P_F - log P_B, two policy applies a
        step), log P_T(x') by the negatives' log P_F, and

            log A = (E(x) - E(x')) + (log P_T(x) - log P_T(x')),

        the energies under ``reward``'s J; accepted where log u < log A.
        ``collect=True`` also keeps the MH backward rollout's
        trajectories, on the same draws."""
        env, pol, n, B = self.env, self.policy, self.noise, self._num_envs
        neg = forward_rollout(seed, env, reward, pol, B, noise=n.neg)
        mh = backward_rollout(seed, env, reward, pol,
                              env.terminal_state_from_spins(data),
                              noise=n.mh_bwd, collect=collect,
                              use_cache=False)
        J = reward.reward_params["J"]
        x_neg = neg.obs[-1]
        log_pt_neg = torch.where(neg.valid, neg.log_pf_beh, 0.0).sum(0)
        log_a = (_energy(data.to(torch.float32), J) - _energy(x_neg, J)) \
            + ((mh.log_pf - mh.log_pb) - log_pt_neg)
        log_u = torch.log(n.mh_u(seed.expand(B), self._ids))
        return MHTest(neg, mh, log_a, log_u, log_u < log_a)

    @staticmethod
    def cd_step(state: EBGFNState, x_pos: torch.Tensor, x_neg: torch.Tensor,
                accept: torch.Tensor) -> None:
        """The energy update: the contrastive-divergence gradient (Eq. 19)
        of J between the data rows ``x_pos`` and the samples (``x_neg``
        where ``accept``, else the data row), both (B, D) float spins, left
        in ``state.J.grad``, then Adam on J."""
        x_prime = torch.where(accept[:, None], x_neg, x_pos)
        state.J.grad = None
        Jp = symmetrize(state.J)
        (_energy(x_pos, Jp).mean() - _energy(x_prime, Jp).mean()).backward()
        state.ebm_optimizer.step()

    def iteration_trace(self, state: EBGFNState,
                        log: Optional[ScanLog] = None
                        ) -> Tuple[Dict[str, torch.Tensor], RolloutBatch,
                                   EBGFNTrace]:
        """One iteration on the state's tensors, with no host read;
        returns ``(metrics, batch, trace)``: ``gfn_loss`` and
        ``mh_accept`` (0-dim device tensors), the mixed batch and the
        :class:`EBGFNTrace`."""
        env, pol, n, B = self.env, self.policy, self.noise, self._num_envs
        seed = state.noise_seed()
        seeds = seed.expand(B)
        row = torch.remainder(state.counter, state.rows.shape[0]).view(1)
        data = torch.index_select(
            self.data, 0, torch.index_select(state.rows, 0, row)[0])
        terminal = env.terminal_state_from_spins(data)
        reward = IsingParams({"J": symmetrize(state.J.detach())})
        # 1) the GFlowNet update, on a per-row mix of forward trajectories
        # and trajectories sampled back from the data
        fwd = forward_rollout(seed, env, reward, pol, B, noise=n.fwd)
        bwd = backward_rollout(seed, env, reward, pol, terminal,
                               noise=n.bwd, collect=True,
                               with_log_pf=False, use_cache=False).batch
        take = n.take(seeds, self._ids) < self.alpha
        batch = _mix(take, fwd, bwd)
        loss = loss_and_grads(pol.params, *tb_parts(
            evaluate_trajectory(pol, batch), batch, pol.params["log_z"]))
        state.optimizer.step()
        # 2) the energy update against the updated policy: negatives by a
        # fresh forward rollout, accepted by the MH test
        test = self.mh_test(seed, reward, data)
        self.cd_step(state, data.to(torch.float32), test.neg.obs[-1],
                     test.accept)
        metrics = {"gfn_loss": loss,
                   "mh_accept": test.accept.to(torch.float32).mean()}
        self.log_row(state, log, metrics, batch)
        state.counter.add_(1)
        return metrics, batch, EBGFNTrace(reward, data, take, fwd, bwd, test)

    def iteration(self, state: EBGFNState, log: Optional[ScanLog] = None
                  ) -> Tuple[Dict[str, torch.Tensor], RolloutBatch]:
        """:meth:`iteration_trace` without the trace: ``(metrics,
        batch)``."""
        metrics, batch, _ = self.iteration_trace(state, log)
        return metrics, batch

    def run(self, seed: int, num_iterations: int, **kwargs):
        """:meth:`CapturableLoop.run`, for at most :attr:`iterations`
        iterations (the data table's rows)."""
        if num_iterations > self.iterations:
            raise ValueError(f"EBGFNLoop drew data rows for {self.iterations}"
                             f" iterations; asked for {num_iterations}")
        return super().run(seed, num_iterations, **kwargs)
