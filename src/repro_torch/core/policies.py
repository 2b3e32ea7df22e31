"""Policies of the port: the MLP policy (port of
``repro.core.policies.make_mlp_policy``) and the transformer policy (port
of ``make_transformer_policy``), in its two architectures.

``arch="decode"``: per-layer K/V come from frozen token + position
embeddings, and a learned latent query reads the state out (see
:mod:`repro_torch.nn.transformer`); it has the KV-cache entry points.  Its
parameter tree is the JAX package's: ``embed/table``, ``pos/pos``,
``bos``, ``decoder/layer_{i}/...``, ``readout/{w,b}``, ``log_z``.
``arch="pooled"``: the bidirectional encoder over the padded sequence,
then a mean over positions, with no pad mask and no cache entry points,
as in the JAX package; its tree is ``embed``, ``pos``,
``encoder/layer_{i}/...``, ``readout``, ``log_z``.  The pad (empty) token
is ``vocab_size - 1``.  The readout has A forward logits and one
state-flow head (the JAX factory's defaults; its learned backward head is
not ported yet).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from ..device import DeviceLike, cpu_generator, resolve_device
from ..kernels.ops import decode_step
from ..nn.core import (ParamTree, dense_apply, dense_init, embedding_apply,
                       embedding_init, load_flat, mlp_apply, mlp_init,
                       normal_init)
from ..nn.transformer import (Cache, cache_init, decode_encoder_init,
                              decoder_stacked_weights, encoder_apply,
                              encoder_apply_bank, encoder_apply_cached,
                              encoder_init, positional_embedding_init)


class MLPPolicy(nn.Module):
    """MLP policy (port of ``repro.core.policies.make_mlp_policy``; the
    paper's hypergrid setup is 2x256).

    One torso ``torso/layer_{i}/{w,b}`` maps float observations to the
    heads, in this order: A forward ``logits``, then ``logits_b`` (Ab
    backward logits) when ``learn_backward``, then ``log_flow`` when
    ``flow_head``; plus the scalar ``log_z``.  Weights are LeCun-normal
    from a CPU ``torch.Generator`` seeded with ``seed``; :meth:`load_params`
    takes parameters carried across from JAX.  It has no KV-cache entry
    points, so rollouts take the uncached branch."""

    def __init__(self, obs_dim: int, action_dim: int,
                 backward_action_dim: Optional[int] = None,
                 hidden: Sequence[int] = (256, 256), *,
                 learn_backward: bool = False, flow_head: bool = True,
                 init_log_z: float = 0.0, seed: int = 0,
                 device: DeviceLike = None, requires_grad: bool = False):
        super().__init__()
        if learn_backward and backward_action_dim is None:
            raise ValueError("learn_backward needs backward_action_dim")
        dev = resolve_device(device)
        self.action_dim = action_dim
        self.backward_action_dim = backward_action_dim
        self.learn_backward, self.flow_head = learn_backward, flow_head
        heads = action_dim + (backward_action_dim if learn_backward else 0) \
            + (1 if flow_head else 0)
        self.params = ParamTree({
            "torso": mlp_init(obs_dim, list(hidden), heads,
                              generator=cpu_generator(seed), device=dev),
            "log_z": torch.full((), float(init_log_z), device=dev),
        }, requires_grad=requires_grad)

    def load_params(self, flat: Mapping[str, torch.Tensor]) -> None:
        """Copy ``/``-keyed parameters (every leaf, same shapes) in."""
        load_flat(self.params, flat)

    def apply(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = mlp_apply(self.params["torso"], obs.to(torch.float32))
        res = {"logits": out[..., :self.action_dim]}
        off = self.action_dim
        if self.learn_backward:
            res["logits_b"] = out[..., off:off + self.backward_action_dim]
            off += self.backward_action_dim
        if self.flow_head:
            res["log_flow"] = out[..., off]
        return res


class TransformerPolicy(nn.Module):
    """The transformer policy; ``arch="decode"`` (the latent-query policy
    with KV-cache entry points) or ``"pooled"`` (the encoder, mean-pooled).

    Weights are drawn from ``torch.Generator`` seeded with ``seed`` on the
    CPU and moved to ``device``; :meth:`load_params` replaces them with
    parameters carried across from JAX (:mod:`repro_torch.convert`).
    ``requires_grad=True`` makes them trainable (the training recipes);
    a served policy's are not.  ``log_z`` starts at ``init_log_z``.

    One class with an ``arch`` switch, as in the JAX package, so that a
    policy is built the same way in both and the parity tests pair them by
    their arguments; the pooled arch refuses the cache entry points and
    reports ``supports_cache`` False, which the rollout reads.
    """

    def __init__(self, vocab_size: int, max_len: int, action_dim: int, *,
                 num_layers: int = 3, dim: int = 64, num_heads: int = 8,
                 init_log_z: float = 0.0, arch: str = "decode",
                 seed: int = 0, device: DeviceLike = None,
                 requires_grad: bool = False):
        super().__init__()
        if arch not in ("decode", "pooled"):
            raise ValueError(f"unknown transformer arch {arch!r}")
        dev = resolve_device(device)
        self.arch = arch
        self.vocab_size, self.max_len = vocab_size, max_len
        self.action_dim, self.dim, self.num_heads = action_dim, dim, num_heads
        self.pad_id = vocab_size - 1
        g = cpu_generator(seed)
        kw = dict(generator=g, device=dev)
        tree = {"embed": embedding_init(vocab_size, dim, **kw),
                "pos": positional_embedding_init(max_len, dim, **kw)}
        if arch == "decode":
            tree["bos"] = normal_init((dim,), std=0.02, **kw)
            tree["decoder"] = decode_encoder_init(
                num_layers=num_layers, dim=dim, num_heads=num_heads, **kw)
        else:
            tree["encoder"] = encoder_init(num_layers=num_layers, dim=dim,
                                           num_heads=num_heads, **kw)
        tree["readout"] = dense_init(dim, action_dim + 1, **kw)
        tree["log_z"] = torch.full((), float(init_log_z), device=dev)
        self.params = ParamTree(tree, requires_grad=requires_grad)
        self._kernel_weights: Optional[Dict[str, torch.Tensor]] = None
        self._kernel_weights_key: Optional[tuple] = None
        self._param_seq = tuple(self.params.parameters())

    @property
    def supports_cache(self) -> bool:
        """True when the policy has the KV-cache entry points (the decode
        arch), which the cached rollout branches need."""
        return self.arch == "decode"

    def _need_cache(self, what: str) -> None:
        if not self.supports_cache:
            raise ValueError(f"{what}: the pooled transformer has no "
                             "KV-cache entry points (arch='decode' has)")

    # -- parameters ------------------------------------------------------------
    def load_params(self, flat: Mapping[str, torch.Tensor]) -> None:
        """Copy ``/``-keyed parameters (every leaf, same shapes) in."""
        load_flat(self.params, flat)

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        # .to(device) moves (or may replace) the parameters
        self._param_seq = tuple(self.params.parameters())
        self._kernel_weights = None
        return out

    def kernel_weights(self) -> Dict[str, torch.Tensor]:
        """The fused step's operands: the stacked decoder weights and the
        contiguous forward-logit slice ``w_out = readout.w[:, :A]``,
        ``b_out = readout.b[:A]``.  They are copies, so they are kept only
        while no parameter's in-place version counter has moved (an
        optimizer step, ``load_params`` or any other in-place write bumps
        it) and the module has not been moved with ``.to()``: the fused
        step never runs weights that differ from ``self.params``."""
        self._need_cache("kernel_weights")
        key = tuple(p._version for p in self._param_seq)
        if self._kernel_weights is None or key != self._kernel_weights_key:
            r = self.params["readout"]
            with torch.no_grad():
                self._kernel_weights = {
                    "stacked": decoder_stacked_weights(
                        self.params["decoder"]),
                    "w_out": r["w"][:, :self.action_dim].contiguous(),
                    "b_out": r["b"][:self.action_dim].contiguous()}
            self._kernel_weights_key = key
        return self._kernel_weights

    # -- heads -----------------------------------------------------------------
    def heads(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Readout of the decoder output y (B, D) into the heads dict:
        ``logits`` (B, A) and ``log_flow`` (B,)."""
        out = dense_apply(self.params["readout"], y)
        return {"logits": out[..., :self.action_dim],
                "log_flow": out[..., self.action_dim]}

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return (embedding_apply(self.params["embed"], tokens.long())
                + embedding_apply({"table": self.params["pos"]["pos"]},
                                  pos.long().clamp(0, self.max_len - 1)))

    # -- full pass ---------------------------------------------------------------
    def apply(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Uncached pass over (B, S) token observations."""
        B, S = tokens.shape
        if self.arch == "pooled":
            x = (embedding_apply(self.params["embed"], tokens.long())
                 + self.params["pos"]["pos"][None, :S])
            h = encoder_apply(self.params["encoder"], x,
                              num_heads=self.num_heads)
            return self.heads(h.mean(1))
        pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
        xs = self._embed(tokens, pos)
        bos = self.params["bos"][None, None, :].expand(B, 1, self.dim)
        xs = torch.cat([bos, xs], dim=1)
        mask = torch.cat([torch.ones(B, 1, dtype=torch.bool,
                                     device=tokens.device),
                          tokens != self.pad_id], dim=1)
        return self.heads(encoder_apply_bank(self.params["decoder"], xs, mask,
                                             num_heads=self.num_heads))

    # -- KV-cache protocol --------------------------------------------------------
    def cache_init(self, batch_size: int) -> Cache:
        """Stacked (num_layers, B, max_len + 1, H, hd) cache, BOS at slot 0."""
        self._need_cache("cache_init")
        x0 = self.params["bos"][None, :].expand(batch_size, self.dim)
        return cache_init(self.params["decoder"], x0, self.max_len + 1,
                          num_heads=self.num_heads)

    def _slot(self, step: Union[int, torch.Tensor]):
        """The token added at step t-1 lives in slot t; ``step`` is a scalar
        (lockstep rollouts) or (B,) (serve lanes).  Clipped to
        [1, max_len]: at t = 0 a throwaway K/V lands in slot 1, masked out
        and overwritten by the next step."""
        if isinstance(step, torch.Tensor):
            return step.clamp(1, self.max_len).to(torch.int32)
        return min(max(int(step), 1), self.max_len)

    def apply_cached(self, cache: Cache, token: torch.Tensor,
                     pos: torch.Tensor, length: torch.Tensor,
                     step: Union[int, torch.Tensor]):
        """Append the newest token's K/V (in place) and query the cache;
        the plain path.  Returns ``(heads dict, cache)``."""
        self._need_cache("apply_cached")
        y, cache = encoder_apply_cached(
            self.params["decoder"], self._embed(token, pos), cache, length,
            num_heads=self.num_heads, slot=self._slot(step))
        return self.heads(y), cache

    def sample_cached(self, cache: Cache, token: torch.Tensor,
                      pos: torch.Tensor, length: torch.Tensor,
                      gumbel: torch.Tensor, fwd_mask: torch.Tensor,
                      step: Union[int, torch.Tensor],
                      logit_temp: Optional[torch.Tensor] = None):
        """Fused step (append + query + masked Gumbel-max sampling) through
        :func:`repro_torch.kernels.ops.decode_step`: the CUDA kernel on a
        CUDA tensor, its plain version on a CPU tensor.

        ``gumbel``: (B, A) noise; ``fwd_mask``: (B, A) bool legal actions
        (callers pass their already-safe mask); ``logit_temp``: optional
        (B,) logit scale.  Returns ``(actions int32, log_pf, y, cache)``;
        ``self.heads(y)`` gives the heads dict."""
        kw = self.kernel_weights()
        return decode_step(
            kw["stacked"], self._embed(token, pos).contiguous(), cache,
            length.to(torch.int32), self._slot(step), gumbel,
            fwd_mask, kw["w_out"], kw["b_out"], logit_temp,
            num_heads=self.num_heads)
