"""Composable environment transforms (port of ``repro.envs.transforms``).

An :class:`EnvTransform` wraps an :class:`~repro_torch.envs.base.Environment`
and keeps its whole contract (dynamics, masks, action correspondences, the
incremental-observation protocol, ``energy`` and the enumeration surface),
so a wrapped env drops into every rollout, objective, sampler and evaluator
unchanged.  A transform's own tensors (a reward exponent, a memo table)
live in a :class:`TransformedParams` layer of the env params, never on the
Python object, so a captured training iteration reads them like any other
env param.

Four transforms and the identity base, as in JAX:

- :class:`RewardExponent`: log R -> beta * log R, beta fixed or annealed
  linearly to ``final_beta`` over ``anneal_steps`` iterations through
  :meth:`Environment.update_params`, which every sampler applies once per
  batch.  beta may also be a (B,) tensor, one value per row: the serving
  engine serves requests at different reward temperatures in one batch.
- :class:`RewardCache`: the terminal rewards of an enumerable env, made
  once at ``init`` into a flat table on the device; ``log_reward`` is one
  gather.
- :class:`TimeLimit`: caps trajectories; below the env's horizon it forces
  the stop action.
- :class:`ObservationTransform`: the base of observation rewrites.

Stacks compose innermost first: ``apply_transforms(env, ["reward_cache",
"reward_exponent:beta=0.5"])`` caches raw rewards and exponentiates the
cached values.  From the CLI every registered env takes ``--transform``
specs (:func:`parse_transform`)::

    python -m repro_torch.run --env hypergrid --transform beta=2.0
    python -m repro_torch.run --env tfbind8 --transform reward_cache \\
        --transform "reward_exponent:beta=0.5"
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .base import Environment


@dataclasses.dataclass
class TransformedParams:
    """One params layer added by a transform that carries tensors: the
    wrapped env's params plus the transform's own (``beta``, ``table``).
    Attribute reads fall through to ``inner``, so code reading
    env-specific param fields (``params.device``, ``params.reward_params``)
    works on transformed params."""
    inner: Any
    extra: Dict[str, torch.Tensor]

    def __getattr__(self, name):
        try:
            inner = self.__dict__["inner"]
        except KeyError:          # during construction / copy protocols
            raise AttributeError(name)
        return getattr(inner, name)


class EnvTransform(Environment):
    """Identity wrapper: delegates the whole Environment contract.

    Subclasses override what they transform; everything else, including
    env-specific helpers (``flatten_index``, ``vocab_size``,
    ``terminal_state_from_*``) reached through ``__getattr__``, falls
    through to the wrapped env.  A subclass that carries tensors sets
    ``wraps_params = True``, adds one :class:`TransformedParams` layer in
    ``init`` and hands the wrapped env its own params
    (:meth:`inner_params`) in every delegated call."""

    #: registry key / CLI name, set on subclasses
    name = "identity"
    #: True when init() adds a TransformedParams layer
    wraps_params = False

    def __init__(self, env: Environment):
        self.env = env
        self.action_dim = env.action_dim
        self.backward_action_dim = env.backward_action_dim
        self.max_steps = env.max_steps
        self.supports_incremental_obs = env.supports_incremental_obs
        self.incremental_pop_only = env.incremental_pop_only
        # rollouts look `energy` up with getattr, so the wrapper has it
        # only when the wrapped env has it
        if hasattr(env, "energy"):
            self.energy = self._energy

    def __getattr__(self, name):
        try:
            env = self.__dict__["env"]
        except KeyError:
            raise AttributeError(name)
        return getattr(env, name)

    # -- params plumbing -----------------------------------------------------
    def inner_params(self, params):
        """The wrapped env's part of ``params``."""
        return params.inner if self.wraps_params else params

    def _init_extra(self, device, inner_params) -> Dict[str, torch.Tensor]:
        """The transform's own tensors (``wraps_params`` subclasses)."""
        return {}

    def _update_extra(self, extra: Dict[str, torch.Tensor],
                      iteration: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-iteration refresh of the transform's own tensors."""
        del iteration
        return extra

    def init(self, device=None):
        inner = self.env.init(device)
        if not self.wraps_params:
            return inner
        return TransformedParams(inner=inner,
                                 extra=self._init_extra(device, inner))

    def update_params(self, params, iteration: torch.Tensor):
        inner = self.env.update_params(self.inner_params(params), iteration)
        if not self.wraps_params:
            return inner
        return TransformedParams(
            inner=inner, extra=self._update_extra(params.extra, iteration))

    # -- delegated contract --------------------------------------------------
    def reset(self, num_envs: int, params):
        _, state = self.env.reset(num_envs, self.inner_params(params))
        return self.observe(state, params), state

    def _forward(self, state, action, params):
        return self.env._forward(state, action, self.inner_params(params))

    def _backward(self, state, action, params):
        return self.env._backward(state, action, self.inner_params(params))

    def is_terminal(self, state, params):
        return self.env.is_terminal(state, self.inner_params(params))

    def is_initial(self, state, params):
        return self.env.is_initial(state, self.inner_params(params))

    def terminal_repr(self, state, params):
        return self.env.terminal_repr(state, self.inner_params(params))

    def log_reward(self, state, params):
        return self.env.log_reward(state, self.inner_params(params))

    def true_log_rewards(self, params):
        return self.env.true_log_rewards(self.inner_params(params))

    def true_distribution(self, params):
        return self.env.true_distribution(self.inner_params(params))

    def _energy(self, state, params):
        return self.env.energy(state, self.inner_params(params))

    def observe(self, state, params):
        return self.env.observe(state, self.inner_params(params))

    def observe_last(self, state, params, last_action=None):
        return self.env.observe_last(state, self.inner_params(params),
                                     last_action)

    def forward_mask(self, state, params):
        return self.env.forward_mask(state, self.inner_params(params))

    def backward_mask(self, state, params):
        return self.env.backward_mask(state, self.inner_params(params))

    def get_backward_action(self, state, action, next_state, params):
        return self.env.get_backward_action(state, action, next_state,
                                            self.inner_params(params))

    def get_forward_action(self, state, bwd_action, prev_state, params):
        return self.env.get_forward_action(state, bwd_action, prev_state,
                                           self.inner_params(params))

    def flat_terminal_index(self, state, params):
        return self.env.flat_terminal_index(state, self.inner_params(params))

    def __repr__(self):
        return f"{type(self).__name__}({self.env!r})"


class ObservationTransform(EnvTransform):
    """Base of observation rewrites: subclass and override
    :meth:`transform_obs`.  A rewrite turns the incremental-observation
    protocol off (the KV cache appends one token at a time and cannot
    follow a whole-observation map)."""

    name = "observation"

    def __init__(self, env: Environment):
        super().__init__(env)
        if type(self).transform_obs is not ObservationTransform.transform_obs:
            self.supports_incremental_obs = False
            self.incremental_pop_only = False

    def transform_obs(self, obs: torch.Tensor) -> torch.Tensor:
        return obs

    def observe(self, state, params):
        return self.transform_obs(
            self.env.observe(state, self.inner_params(params)))


class RewardExponent(EnvTransform):
    """log R -> beta * log R, i.e. R -> R^beta (reward temperature
    1/beta).

    beta is a tensor of the params layer (``params.extra["beta"]``): a
    0-dim float32 ``beta`` by default, or annealed linearly from ``beta`` to
    ``final_beta`` over ``anneal_steps`` iterations by
    :meth:`update_params`, which every sampler applies once per batch, on
    the device (JAX's float32 formula; the iteration is divided by a
    tensor, since CUDA turns a division by a Python number into a product
    with its reciprocal).  The serving engine builds the layer itself with
    a (B,) beta, one per row.  Evaluators read the env params they were
    built with, so under a schedule their rows use the initial beta while
    training uses the annealed one, as in JAX."""

    name = "reward_exponent"
    wraps_params = True

    def __init__(self, env: Environment, beta: float = 1.0,
                 final_beta: Optional[float] = None,
                 anneal_steps: int = 0):
        super().__init__(env)
        if (final_beta is None) != (anneal_steps == 0):
            raise ValueError(
                "scheduled beta needs both final_beta and anneal_steps "
                f"(got final_beta={final_beta}, anneal_steps={anneal_steps})")
        self.beta = float(beta)
        self.final_beta = None if final_beta is None else float(final_beta)
        self.anneal_steps = int(anneal_steps)

    @property
    def scheduled(self) -> bool:
        return self.final_beta is not None

    def _init_extra(self, device, inner_params):
        return {"beta": torch.full((), float(np.float32(self.beta)),
                                   dtype=torch.float32,
                                   device=resolve_device(device))}

    def _update_extra(self, extra, iteration):
        if not self.scheduled:
            return extra
        f32 = dict(dtype=torch.float32, device=iteration.device)
        steps = torch.full((), float(self.anneal_steps), **f32)
        frac = torch.clamp(iteration.to(torch.float32) / steps, 0.0, 1.0)
        beta = torch.full((), float(np.float32(self.beta)), **f32)
        span = torch.full((), float(np.float32(self.final_beta - self.beta)),
                          **f32)
        return {"beta": beta + frac * span}

    def log_reward(self, state, params):
        return params.extra["beta"] * self.env.log_reward(state, params.inner)

    def _energy(self, state, params):
        # E = -log R at terminals, so FLDB's shaping scales with beta too
        return params.extra["beta"] * self.env.energy(state, params.inner)

    def true_log_rewards(self, params):
        return params.extra["beta"] * self.env.true_log_rewards(params.inner)

    def true_distribution(self, params):
        """The exact transformed target R^beta / Z_beta."""
        return torch.softmax(self.true_log_rewards(params), dim=-1)


class RewardCache(EnvTransform):
    """The terminal rewards of an enumerable env, memoized in a flat table.

    Made once at ``init``, on the device, from the wrapped env's
    ``true_log_rewards``; ``log_reward`` becomes one gather keyed on
    ``flat_terminal_index``.  That trades O(num_states) reward evaluations
    up front for one lookup per terminal on every rollout, replay and
    eval path.  Refuses envs without the enumeration surface
    (``flat_terminal_index`` and ``true_log_rewards``), scheduled-beta
    stacks inside it (the memo of a moving reward would go stale) and
    tables over ``max_states`` entries."""

    name = "reward_cache"
    wraps_params = True

    def __init__(self, env: Environment, max_states: int = 1 << 22):
        super().__init__(env)
        # EnvTransform defines a delegating flat_terminal_index, so the
        # capability is read on the bare env
        if not hasattr(base_env(env), "flat_terminal_index"):
            raise TypeError(
                f"RewardCache needs the enumeration surface "
                f"(flat_terminal_index / true_log_rewards); "
                f"{type(env).__name__} does not provide it")
        if has_scheduled_reward(env):
            raise TypeError(
                "RewardCache cannot memoize a scheduled reward (stack the "
                "cache *inside* the scheduled RewardExponent instead)")
        self.max_states = int(max_states)

    def _init_extra(self, device, inner_params):
        table = self.env.true_log_rewards(inner_params)
        if table.shape[0] > self.max_states:
            raise ValueError(
                f"{type(self.env).__name__} enumerates {table.shape[0]} "
                f"terminal states > max_states={self.max_states}")
        return {"table": table.to(torch.float32).contiguous()}

    def log_reward(self, state, params):
        table = params.extra["table"]
        idx = self.env.flat_terminal_index(state, params.inner)
        return table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]

    def true_log_rewards(self, params):
        return params.extra["table"]

    def true_distribution(self, params):
        return torch.softmax(params.extra["table"], dim=-1)


class TimeLimit(EnvTransform):
    """Cap trajectories at ``limit`` forward steps.

    At or above the env's horizon it only shortens the rollout
    (``max_steps``).  Below it, a state about to use up the budget has
    every action but stop masked, so episodes still end on a real
    terminal; that needs a ``stop_action`` that is legal at the forced
    step (hypergrid, variable-length sequences with ``min_len < limit``).
    As in JAX, backward masks are not narrowed and exact targets still
    enumerate the untruncated terminals."""

    name = "time_limit"

    def __init__(self, env: Environment, limit: int):
        super().__init__(env)
        limit = int(limit)
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        if limit < env.max_steps:
            if getattr(env, "stop_action", None) is None:
                raise TypeError(
                    f"TimeLimit({limit}) below "
                    f"{type(env).__name__}.max_steps={env.max_steps} needs "
                    "a stop action to force termination")
            # a forced stop must be legal: a forced all-illegal mask would
            # sample illegal transitions into training batches
            min_len = int(getattr(env, "min_len", 0))
            if limit - 1 < min_len:
                raise ValueError(
                    f"TimeLimit({limit}) forces stop after {limit - 1} "
                    f"content steps, but {type(env).__name__} only allows "
                    f"stop from length >= {min_len}")
        self.limit = limit
        self.max_steps = min(env.max_steps, limit)

    def forward_mask(self, state, params):
        mask = self.env.forward_mask(state, self.inner_params(params))
        if self.limit >= self.env.max_steps:
            return mask
        force = state.steps >= self.limit - 1
        only_stop = torch.arange(mask.shape[-1],
                                 device=mask.device) == self.env.stop_action
        return torch.where(force[:, None], mask & only_stop[None], mask)


# ---------------------------------------------------------------------------
# Registry and CLI specs
# ---------------------------------------------------------------------------

#: name -> transform class
TRANSFORMS: Dict[str, type] = {
    cls.name: cls
    for cls in (EnvTransform, ObservationTransform, RewardExponent,
                RewardCache, TimeLimit)
}

TransformSpec = Union[str, Callable[[Environment], Environment]]


def parse_transform(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``"name[:k=v,k=v]"`` -> ``(name, kwargs)``.  A bare ``"beta=2.0"``
    is short for ``"reward_exponent:beta=2.0"``.  An unknown name raises
    KeyError, a pair without ``=`` ValueError."""
    spec = spec.strip()
    if ":" in spec:
        name, _, argstr = spec.partition(":")
    elif "=" in spec:
        name, argstr = "reward_exponent", spec
    else:
        name, argstr = spec, ""
    name = name.strip()
    if name not in TRANSFORMS:
        raise KeyError(f"unknown transform {name!r}; "
                       f"available: {sorted(TRANSFORMS)}")
    kwargs: Dict[str, Any] = {}
    for pair in filter(None, (p.strip() for p in argstr.split(","))):
        if "=" not in pair:
            raise ValueError(f"expected key=value in transform spec, "
                             f"got {pair!r} (full spec: {spec!r})")
        k, v = pair.split("=", 1)
        try:
            kwargs[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            kwargs[k.strip()] = v.strip()
    return name, kwargs


def apply_transforms(env: Environment,
                     specs: Sequence[TransformSpec]) -> Environment:
    """Wrap ``env`` in a transform stack, the first spec innermost; each
    spec is a string for :func:`parse_transform` or a callable
    ``env -> env``."""
    for spec in specs:
        if callable(spec):
            env = spec(env)
        else:
            name, kwargs = parse_transform(spec)
            env = TRANSFORMS[name](env, **kwargs)
    return env


def base_env(env: Environment) -> Environment:
    """The innermost (bare) environment of a transform stack."""
    while isinstance(env, EnvTransform):
        env = env.env
    return env


def transform_stack(env: Environment) -> Tuple[str, ...]:
    """The names of the transforms wrapping ``env``, outermost first."""
    names = []
    while isinstance(env, EnvTransform):
        names.append(env.name)
        env = env.env
    return tuple(names)


def has_scheduled_reward(env: Environment) -> bool:
    """True when any layer of the stack anneals its reward over training:
    a replay sampler then re-evaluates replayed terminals' rewards instead
    of reusing the stored ones."""
    while isinstance(env, EnvTransform):
        if getattr(env, "scheduled", False):
            return True
        env = env.env
    return False
