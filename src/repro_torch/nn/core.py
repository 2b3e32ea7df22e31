"""Minimal functional layers over dicts of tensors (port of ``repro.nn.core``).

Every layer is a pair ``*_init(...) -> params`` / ``*_apply(params, x)``
over plain dicts, with the JAX package's layouts: dense weights are
``(in, out)`` and ``y = x @ w + b``.  Initialisers draw from an explicit
``torch.Generator`` on its own device and move the result to ``device``, so
one CPU generator's seed gives the same parameters on every device.  :class:`ParamTree` holds such a nested
dict as an ``nn.Module`` whose parameter names, with ``.`` read as ``/``,
are the JAX checkpoint's leaf names.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Params = Mapping[str, Any]


def lecun_normal(shape: Sequence[int], *, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Normal with std 1/sqrt(fan_in), fan_in = shape[0]."""
    std = 1.0 / math.sqrt(max(shape[0], 1))
    return (std * torch.randn(tuple(shape), generator=generator)).to(device)


def normal_init(shape: Sequence[int], *, generator: torch.Generator,
                device: torch.device, std: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``std`` times a standard normal draw, made in float32 on the
    generator's own device (a CUDA generator draws a full-width model's
    weights on the card), then cast to ``dtype`` and moved to ``device``."""
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device)
    return (std * x).to(device=device, dtype=dtype)


#: elements of one float32 draw of :func:`normal_init_sliced` (512 MiB)
SLICE_ELEMENTS = 1 << 27


def normal_init_sliced(shape: Sequence[int], *, generator: torch.Generator,
                       device: torch.device, std: float = 0.02,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``std`` times standard normal draws, as :func:`normal_init`, into a
    leaf of ``dtype`` allocated up front and filled a few leading-axis
    slices at a time (one layer of a stacked leaf, or rows of an
    embedding, at most :data:`SLICE_ELEMENTS` elements a draw): the float32
    draw never holds more than one slice, so a 64-layer leaf of 9e9
    elements costs its own bytes and one slice's.  Other values than
    :func:`normal_init`'s from the same seed on a CUDA generator."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, SLICE_ELEMENTS // max(1, math.prod(shape[1:])))
    for s in range(0, shape[0], step):
        x = torch.randn((min(step, shape[0] - s),) + shape[1:],
                        generator=generator, device=generator.device)
        out[s:s + x.shape[0]].copy_(x.mul_(std))
    return out


def dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
               device: torch.device) -> Dict[str, Any]:
    return {"w": lecun_normal((in_dim, out_dim), generator=generator,
                              device=device),
            "b": torch.zeros(out_dim, device=device)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def layernorm_init(dim: int, device: torch.device) -> Dict[str, Any]:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Population variance and ``rsqrt(var + eps)``, as ``jnp.var``."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def embedding_init(vocab: int, dim: int, *, generator: torch.Generator,
                   device: torch.device) -> Dict[str, Any]:
    return {"table": normal_init((vocab, dim), generator=generator,
                                 device=device)}


def embedding_apply(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def mlp_init(in_dim: int, hidden: Sequence[int], out_dim: int, *,
             generator: torch.Generator,
             device: torch.device) -> Dict[str, Any]:
    """``layer_{i}`` dense layers ``in_dim -> *hidden -> out_dim``:
    LeCun-normal weights, zero biases."""
    dims = [in_dim, *hidden, out_dim]
    return {f"layer_{i}": dense_init(dims[i], dims[i + 1],
                                     generator=generator, device=device)
            for i in range(len(dims) - 1)}


def mlp_apply(p: Params, x: torch.Tensor,
              activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu
              ) -> torch.Tensor:
    """Dense layers with ``activation`` (default ReLU, as the JAX
    package's) between them, none after the last."""
    n = len(list(p))
    for i in range(n):
        x = dense_apply(p[f"layer_{i}"], x)
        if i < n - 1:
            x = activation(x)
    return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``.

    Subtrees become submodules and tensors become parameters under the same
    keys, so ``tree["layer_0"]["q"]["w"]`` reads like the dict it was built
    from and the functional layers above accept either.  Parameters require
    grad only when ``requires_grad`` is True (a policy being trained); a
    served policy's do not.
    """

    def __init__(self, tree: Mapping[str, Any], requires_grad: bool = False):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v, requires_grad))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v),
                                    requires_grad=requires_grad))

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: object) -> bool:
        return key in self._keys

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def forward(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``: with
        ``torch.func.functional_call(tree, params, (fn, *args))`` it runs
        on ``params`` in place of the tree's own leaves (a seed plan's
        per-seed parameters under ``torch.func.vmap``)."""
        return fn(*args, **kwargs)

    def flat(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by ``/``-joined path (the checkpoint names)."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}


def load_flat(params: ParamTree, flat: Mapping[str, torch.Tensor]) -> None:
    """Copy ``/``-keyed tensors into ``params`` in place: every leaf, same
    names and shapes."""
    own = params.flat()
    if set(flat) != set(own):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(own) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            src = torch.as_tensor(flat[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(src)
