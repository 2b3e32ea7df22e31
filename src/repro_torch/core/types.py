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

A continuous environment's flow policy draws a :class:`FlowNoise` per row
and step instead (exit coin, component Gumbels, normals, exploration
uniforms) from a *flow-noise source* ``noise(seed, index, t, (D, K))``;
:func:`hash_flow_noise` and :func:`hash_flow_backward_noise` are the
defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

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


class FlowNoise(NamedTuple):
    """The noise operands of one continuous (flow-policy) sampling step,
    per row, as JAX's ``repro.nn.flows`` splits an env's key: forward,
    ``split(key, 4)`` gives ``k_exit`` (``exit_u`` (B,), the exit coin),
    ``k_mix``, ``k_eps`` (``explore_u`` (B, 2): the explore coin and the
    fair exit coin of an exploring row) and ``k_unif`` (``unif`` (B, D),
    the uniform increment); ``k_mix`` splits into ``kc`` (``gumbel``
    (B, D, K): the categorical over the K components of each coordinate)
    and ``kn`` (``normal`` (B, D)).  A backward step splits its env key into
    ``kc`` and ``kn`` alone: ``exit_u``, ``explore_u`` and ``unif`` are
    None."""
    gumbel: torch.Tensor
    normal: torch.Tensor
    exit_u: Optional[torch.Tensor] = None
    explore_u: Optional[torch.Tensor] = None
    unif: Optional[torch.Tensor] = None


#: ``noise(seed, index, t, (D, K)) -> FlowNoise``
FlowNoiseSource = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                            Tuple[int, int]], FlowNoise]

_MASK32 = 0xFFFFFFFF


def masked_logprobs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Log-softmax restricted to legal actions (mask True = legal).
    Illegal logits become ``finfo.min``, not ``-inf``, as in the JAX
    package."""
    return torch.log_softmax(
        torch.where(mask, logits, torch.finfo(logits.dtype).min), dim=-1)


def sample_masked(logits: torch.Tensor, mask: torch.Tensor,
                  gumbel: torch.Tensor, *,
                  eps: Union[float, torch.Tensor, None] = None,
                  gumbel_u: Optional[torch.Tensor] = None,
                  explore_u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-max sample from the masked policy with epsilon-uniform
    exploration (port of ``repro.core.types.sample_masked``).

    ``eps=None`` is the statically-zero branch: ``argmax(logp + gumbel)``.
    Otherwise (a number, or a 0-dim float32 tensor on the rows' device,
    which a captured training iteration reads without a host copy) a row
    whose ``explore_u < eps`` (compared in fp32) takes
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
        actions = torch.where(explore_u < eps, uniform, actions)
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
    bits on every device; the top 23 bits become a uniform in (0, 1), and
    ``-log(-log(u))`` the Gumbel variate.  Every step is elementwise, so a
    row's noise does not depend on the rows beside it."""
    return _gumbel_of_key(_row_key(seed, index, t), num_actions)


def _uniform_of_bits(h: torch.Tensor) -> torch.Tensor:
    """The top 23 of 32 hash bits as a float32 uniform strictly inside
    (0, 1): ``(k + 0.5) / 2**23`` is exact in float32 for every k.  (From
    24 bits, ``k + 0.5`` needs 25 significant bits: the top code rounded
    to 1.0, a Gumbel of +inf that won the argmax whatever the action's
    mask, once in 2**24 draws.)"""
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _uniforms_of_key(key: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) uniforms strictly inside (0, 1) from (B,) 32-bit row keys,
    one hash of the row key per column."""
    a = torch.arange(n, dtype=torch.int64, device=key.device)
    return _uniform_of_bits(_mix32(key[:, None] ^ _mix32(a ^ 0x5BD1E995)))


def _gumbel_of_key(key: torch.Tensor, num_actions: int) -> torch.Tensor:
    """(B, A) standard Gumbel noise from (B,) 32-bit row keys."""
    return -torch.log(-torch.log(_uniforms_of_key(key, num_actions)))


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


def hash_stream_gumbel(stream: int) -> NoiseSource:
    """A noise source of Gumbel noise from the counter hash of ``(seed[b],
    index[b], t[b])`` on the stream named by the 32-bit constant
    ``stream``: a rollout whose draws no rollout on another stream
    shares, at the same seed (EB-GFN's second forward and backward
    rollouts of an iteration)."""
    def noise(seed: torch.Tensor, index: torch.Tensor, t: torch.Tensor,
              num_actions: int) -> torch.Tensor:
        return _gumbel_of_key(_mix32(_row_key(seed, index, t) ^ stream),
                              num_actions)
    return noise


def hash_select_noise(seed: torch.Tensor, index: torch.Tensor,
                      capacity: int, prioritized: bool) -> torch.Tensor:
    """Default selection-noise source of the replay samplers (JAX's
    ``k_sel``): per replayed item ``index[r]``, from the counter hash of
    ``(seed[r], index[r])`` on a stream no other draw uses, either one
    uniform in (0, 1) (``prioritized`` False: the uniform slot draw,
    ``jax.random.randint``), giving (R,), or a row of ``capacity``
    Gumbels (``prioritized`` True: the Gumbel-max draw of
    ``jax.random.categorical`` over the buffer's slots), giving
    (R, capacity)."""
    key = _mix32(_row_key(seed, index, torch.zeros_like(index))
                 ^ 0x6A09E667)
    if prioritized:
        return _gumbel_of_key(key, capacity)
    return _uniform_of_bits(key)


def hash_uniform(seed: torch.Tensor, index: torch.Tensor,
                 stream: int) -> torch.Tensor:
    """(B,) uniforms strictly inside (0, 1), one per row, from the counter
    hash of ``(seed[b], index[b])`` on the stream named by the 32-bit
    constant ``stream``: a per-row coin (EB-GFN's trajectory mix and its
    MH test)."""
    return _uniform_of_bits(_mix32(
        _row_key(seed, index, torch.zeros_like(index)) ^ stream))


def _flow_noise(key: torch.Tensor, dims: Tuple[int, int],
                forward: bool) -> FlowNoise:
    """A :class:`FlowNoise` from (B,) 32-bit row keys.  The row's
    uniforms are hashed as one (B, n) tensor and cut into the fields:
    ``-log(-log(u))`` gives the Gumbel draws, ``ndtri(u)`` the normals
    (finite, as u lies strictly inside (0, 1))."""
    D, K = dims
    u = _uniforms_of_key(key, D * K + D + (3 + D if forward else 0))
    gumbel = -torch.log(-torch.log(u[:, :D * K])).view(-1, D, K)
    normal = torch.special.ndtri(u[:, D * K:D * K + D])
    if not forward:
        return FlowNoise(gumbel, normal)
    o = D * K + D
    return FlowNoise(gumbel, normal, exit_u=u[:, o],
                     explore_u=u[:, o + 1:o + 3], unif=u[:, o + 3:o + 3 + D])


def hash_flow_noise(seed: torch.Tensor, index: torch.Tensor,
                    t: torch.Tensor, dims: Tuple[int, int]) -> FlowNoise:
    """Default noise source of continuous forward rollouts: every field of
    a forward :class:`FlowNoise` from the counter hash of ``(seed[b],
    index[b], t[b])`` on a stream no other source uses."""
    return _flow_noise(_mix32(_row_key(seed, index, t) ^ 0x9B05688C), dims,
                       forward=True)


def hash_flow_backward_noise(seed: torch.Tensor, index: torch.Tensor,
                             t: torch.Tensor,
                             dims: Tuple[int, int]) -> FlowNoise:
    """Default noise source of continuous backward rollouts: the Gumbel
    and normal draws of a backward :class:`FlowNoise` on a stream of its
    own."""
    return _flow_noise(_mix32(_row_key(seed, index, t) ^ 0x1F83D9AB), dims,
                       forward=False)


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
    place, and ``counter``, a 0-dim int64 tensor on the parameters'
    device, counts the iterations done.  Iteration i draws its noise from
    ``train_seed(seed, i)``, which :meth:`noise_seed` computes on the
    device: a captured iteration reads and advances both without the
    host.  ``sampler`` carries the sampler's state across iterations."""
    params: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int
    counter: torch.Tensor
    #: the sampler's carried state (JAX's ``LoopState.sampler``): a replay
    #: sampler's :class:`repro_torch.buffer.fifo.BufferState`, whose
    #: device tensors an iteration updates in place; None for stateless
    #: samplers
    sampler: Any = dataclasses.field(default=None, kw_only=True)

    def noise_seed(self) -> torch.Tensor:
        """``train_seed(seed, counter)`` as a 0-dim int64 tensor on the
        counter's device."""
        return self.counter + (self.seed << 32)

    @property
    def step(self) -> int:
        """The iterations done, read on the host (a device sync on CUDA);
        assigning it sets the counter."""
        return int(self.counter)

    @step.setter
    def step(self, value: int) -> None:
        self.counter.fill_(int(value))
