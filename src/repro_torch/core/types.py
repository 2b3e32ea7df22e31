"""Sampling primitives of the port (port of ``repro.core.types``).

Torch cannot reproduce JAX's threefry key stream, so sampling here takes an
explicit Gumbel operand ``(B, A)`` instead of a key: the categorical draw
``jax.random.categorical(k, logp)`` is ``argmax(logp + gumbel(k))``, and a
caller that feeds the same Gumbel noise gets the same actions.

Where the noise comes from is a *noise source*: a callable
``noise(seed, index, t, num_actions) -> (B, A) float32`` over (B,) int64
tensors naming, per row, the request seed, the sample index within the
request, and the trajectory step.  The default, :func:`hash_gumbel`, is a
counter-based hash of ``(seed, index, t, action)``; it is the port's
counterpart of JAX's ``fold_in(split(key, T)[t], index)``: a sample's noise
depends on nothing but those four numbers, so it is independent of lane
placement, co-tenants and lane count.

Training rollouts explore (``eps > 0``) and so draw three operands per
row and step, as ``repro.core.types.sample_masked`` splits its key into
``(key_u, key_c, key_m)``: a :class:`StepNoise` from a *step-noise
source* of the same signature.  :func:`hash_step_noise` is the default;
the trainer keys it on ``train_seed(seed, iteration)``, so no two
iterations share noise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

NoiseSource = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                       torch.Tensor]


class StepNoise(NamedTuple):
    """The noise operands of one exploring sampling step (JAX's
    ``split(key, 3)``): ``gumbel`` (B, A) the categorical draw (``key_c``),
    ``gumbel_u`` (B, A) the uniform-over-legal draw (``key_u``) and
    ``explore_u`` (B,) the explore coin in (0, 1) (``key_m``)."""
    gumbel: torch.Tensor
    gumbel_u: torch.Tensor
    explore_u: torch.Tensor


StepNoiseSource = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                           StepNoise]

_MASK32 = 0xFFFFFFFF


def masked_logprobs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Log-softmax restricted to legal actions (mask True = legal).
    Illegal logits become ``finfo.min``, not ``-inf``, as in the JAX
    package."""
    neg = torch.tensor(torch.finfo(logits.dtype).min, dtype=logits.dtype,
                       device=logits.device)
    return torch.log_softmax(torch.where(mask, logits, neg), dim=-1)


def sample_masked(logits: torch.Tensor, mask: torch.Tensor,
                  gumbel: torch.Tensor, *,
                  eps: Union[float, torch.Tensor, None] = None,
                  gumbel_u: Optional[torch.Tensor] = None,
                  explore_u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-max sample from the masked policy with epsilon-uniform
    exploration (port of ``repro.core.types.sample_masked``).

    ``eps=None`` is the statically-zero branch: ``argmax(logp + gumbel)``.
    Otherwise a row whose ``explore_u < eps`` (compared in fp32) takes
    ``argmax(where(mask, 0, -inf) + gumbel_u)``, a uniform legal action.
    Ties go to the lowest index, as in ``jnp.argmax``.  Returns
    ``(actions int64, log_prob_of_action)``: the log-prob is the policy's,
    not the behaviour distribution's."""
    logp = masked_logprobs(logits, mask)
    actions = torch.argmax(logp + gumbel, dim=-1)
    if eps is not None:
        if gumbel_u is None or explore_u is None:
            raise ValueError("sample_masked with eps needs gumbel_u and "
                             "explore_u")
        unif = torch.where(mask, 0.0, float("-inf"))
        uniform = torch.argmax(unif + gumbel_u, dim=-1)
        eps_t = torch.as_tensor(eps, dtype=torch.float32,
                                device=explore_u.device)
        actions = torch.where(explore_u < eps_t, uniform, actions)
    return actions, torch.gather(logp, -1, actions[..., None])[..., 0]


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix on int64 tensors holding values < 2**32.
    Multipliers stay below 2**31, so no product leaves int64 and every
    device computes the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _MASK32
    return x ^ (x >> 16)


def _row_key(seed: torch.Tensor, index: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """(B,) 32-bit key of (seed, index, t), each as int64."""
    seed = seed.long()
    h = _mix32(seed & _MASK32)
    h = _mix32(h ^ ((seed >> 32) & _MASK32) ^ 0x68E31DA4)
    h = _mix32(h ^ (index.long() & _MASK32) ^ 0x1B56C4E9)
    return _mix32(h ^ (t.long() & _MASK32) ^ 0x2C8F3A71)


def hash_gumbel(seed: torch.Tensor, index: torch.Tensor, t: torch.Tensor,
                num_actions: int) -> torch.Tensor:
    """Default noise source: standard Gumbel noise ``(B, num_actions)`` from
    a counter-based hash of ``(seed[b], index[b], t[b], a)``.

    The integer hash is plain int64 tensor arithmetic, so it gives the same
    bits on every device; the top 24 bits become a uniform in (0, 1), and
    ``-log(-log(u))`` the Gumbel variate.  Every step is elementwise, so a
    row's noise does not depend on the rows beside it."""
    return _gumbel_of_key(_row_key(seed, index, t), num_actions)


def _uniform_of_bits(h: torch.Tensor) -> torch.Tensor:
    """The top 24 of 32 hash bits as a float32 uniform in (0, 1)."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _gumbel_of_key(key: torch.Tensor, num_actions: int) -> torch.Tensor:
    """(B, A) standard Gumbel noise from (B,) 32-bit row keys."""
    a = torch.arange(num_actions, dtype=torch.int64, device=key.device)
    u = _uniform_of_bits(_mix32(key[:, None] ^ _mix32(a ^ 0x5BD1E995)))
    return -torch.log(-torch.log(u))


def hash_step_noise(seed: torch.Tensor, index: torch.Tensor,
                    t: torch.Tensor, num_actions: int) -> StepNoise:
    """Default step-noise source: the three operands of an exploring step
    from the counter hash of ``(seed[b], index[b], t[b])``, one stream
    each.  The categorical stream is :func:`hash_gumbel`'s, so at
    ``eps = 0`` an exploring rollout samples what a serving one does."""
    key = _row_key(seed, index, t)
    return StepNoise(
        gumbel=_gumbel_of_key(key, num_actions),
        gumbel_u=_gumbel_of_key(_mix32(key ^ 0x3C6EF372), num_actions),
        explore_u=_uniform_of_bits(_mix32(key ^ 0xA54FF53A)))


def hash_backward_gumbel(seed: torch.Tensor, index: torch.Tensor,
                         t: torch.Tensor, num_actions: int) -> torch.Tensor:
    """Default noise source of backward rollouts: Gumbel noise from the
    counter hash of ``(seed[b], index[b], t[b])`` on a stream of its own,
    so a backward rollout never reuses a forward rollout's draws."""
    return _gumbel_of_key(_mix32(_row_key(seed, index, t) ^ 0x510E527F),
                          num_actions)


def train_seed(seed: int, iteration: int) -> int:
    """The 64-bit noise seed of training iteration ``iteration`` of a run
    seeded ``seed``: ``seed * 2**32 + iteration``, one-to-one for
    ``0 <= seed < 2**31`` and ``0 <= iteration < 2**32``.  Rollouts hash
    all 64 bits, so the draws are keyed on (seed, iteration, env index,
    step, stream)."""
    seed, iteration = int(seed), int(iteration)
    if not (0 <= seed < 2 ** 31 and 0 <= iteration < 2 ** 32):
        raise ValueError(f"train_seed: seed {seed} or iteration "
                         f"{iteration} out of range")
    return (seed << 32) | iteration


def eval_seed(seed: int, iteration: int, index: int) -> int:
    """The 64-bit noise seed of evaluator ``index`` at iteration
    ``iteration`` of an eval suite seeded ``seed``.  Bit 63 is set, which no
    :func:`train_seed` has, so evals never draw a training iteration's
    noise; as an int64 the value is negative.  One-to-one for
    ``0 <= seed < 2**23``, ``0 <= index < 2**8`` and
    ``0 <= iteration < 2**32``."""
    seed, iteration, index = int(seed), int(iteration), int(index)
    if not (0 <= seed < 2 ** 23 and 0 <= index < 2 ** 8
            and 0 <= iteration < 2 ** 32):
        raise ValueError(f"eval_seed: seed {seed}, iteration {iteration} "
                         f"or index {index} out of range")
    return (seed << 40 | index << 32 | iteration) - 2 ** 63


def sample_seeds(seed: int, num_samples: int) -> list:
    """The 64-bit noise seeds of ``num_samples`` independent draws keyed on
    one seed (the port's counterpart of ``jax.random.split(key, n)``):
    sample i's is ``seed + (i + 1) * 0x9E3779B97F4A7C15`` modulo 2**64,
    read as a signed int64.  Distinct for every i < 2**64, and a function
    of (seed, i) alone."""
    out = []
    for i in range(int(num_samples)):
        u = (int(seed) + (i + 1) * 0x9E3779B97F4A7C15) % 2 ** 64
        out.append(u - 2 ** 64 if u >= 2 ** 63 else u)
    return out


@dataclasses.dataclass
class TrainState:
    """Training carry (port of ``repro.core.types.TrainState``).

    Unlike JAX's it is mutable: the optimizer updates ``params`` (the
    policy's :class:`repro_torch.nn.core.ParamTree`) and its own state in
    place, and ``step`` counts the iterations done.  Iteration ``step``
    draws its noise from ``train_seed(seed, step)``."""
    params: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
