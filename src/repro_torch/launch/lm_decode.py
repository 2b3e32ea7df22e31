"""LM decode entry point: batched token generation with a KV cache over the
:mod:`repro_torch.models.lm` stack (port of ``repro.launch.lm_decode``).

    PYTHONPATH=src python -m repro_torch.launch.lm_decode --arch hymba-1.5b \
        --smoke --device cpu --batch 2 --prompt-len 8 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.lm_decode --arch qwen2.5-32b \
        --batch 8 --prompt-len 32 --gen 32          # full width, on cuda

``--arch`` takes every architecture of the registry but the VLM and
defaults to JAX's default, qwen2.5-32b.  qwen2-72b, command-r-plus-104b and
qwen2-vl-72b do not fit one 80 GB card in bf16 at full depth.  Whisper
(encdec) decodes over a cross-attention cache built from seeded stub
frames, ``prompt_len`` of them, as JAX's ``serve`` draws them.  The VLM
reads embeddings and M-RoPE position ids, which this entry point does not
make (JAX's ``serve`` hands its ``decode_step`` none and fails there): it
raises; serve it through ``launch.steps.make_serve_step`` with ``extra``.

Runs on ``cuda`` unless ``--device cpu`` is given, and fails on a machine
without a GPU otherwise.  The model and the prompt are drawn from a seeded
``torch.Generator`` on the target device, so a seed gives other weights on
the CPU than on the card.  Sampling takes the argmax of the logits plus
Gumbel noise, added in the logits' dtype as ``jax.random.categorical``
adds it: by default drawn from a seeded generator of its own, or given as
an operand (``serve(noise=...)``), so a test can replay JAX's draws and
hold the sampled tokens to JAX's; ``--greedy`` takes the argmax.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Union

import torch

from ..configs.registry import ARCH_IDS, get_config
from ..device import DeviceLike, resolve_device
from ..models import lm as LM


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


Noise = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def _seeded_gumbel(dev: torch.device, seed: int,
                   shape) -> Callable[[int], torch.Tensor]:
    """A noise source: Gumbel draws of ``shape`` from a generator seeded
    with ``seed``, one per generated token."""
    g = _generator(dev, seed)

    def draw(t: int) -> torch.Tensor:
        u = torch.rand(shape, generator=g, device=dev)
        return -torch.log(-torch.log(u.clamp_(1e-20, 1.0)))
    return draw


@torch.no_grad()
def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          greedy: bool = False, device: DeviceLike = None,
          params=None, prompt: Optional[torch.Tensor] = None,
          noise: Optional[Noise] = None,
          frames: Optional[torch.Tensor] = None):
    """Prefill ``prompt_len`` tokens one decode step at a time, then
    generate ``gen`` tokens.  Returns ``(tokens (batch, gen) int64, tokens
    per second over the generation)``.  ``params`` (LM params, for example
    JAX's carried across) and ``prompt`` ((batch, prompt_len) integer)
    replace the seeded draws.  Token t is ``argmax(logits + noise_t)``,
    the noise cast to the logits' dtype and added there; ``noise`` is
    the (gen, batch, vocab) Gumbel draws, or a source ``noise(t) ->
    (batch, vocab)``, or None: draws from a generator seeded with
    ``seed + 1``.  ``greedy`` ignores it.  Whisper: ``frames`` (batch, Se,
    d_model), the stub frame embeddings the cross cache is built from
    (default: ``prompt_len`` bfloat16 standard normal frames drawn after
    the prompt, bfloat16 as JAX draws them).  The VLM raises
    (module docstring)."""
    if cfg.family == "vlm":
        raise ValueError("lm_decode.serve: the VLM reads embeddings and "
                         "M-RoPE position ids, not tokens; serve it through "
                         "launch.steps.make_serve_step with extra")
    dev = resolve_device(device)
    g = _generator(dev, seed)
    if params is None:
        params = LM.init_params(cfg, generator=g, device=dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=g, device=dev)
    prompt = prompt.to(dev)
    max_len = prompt_len + gen + 1
    cache = LM.init_cache(cfg, batch, max_len, device=dev)
    if cfg.family == "encdec":
        if frames is None:
            frames = torch.randn((batch, prompt_len, cfg.d_model),
                                 generator=g, device=dev).to(torch.bfloat16)
        cache["cross"] = LM.build_cross_cache(params, cfg, frames.to(dev))
    if noise is None:
        noise = _seeded_gumbel(dev, seed + 1, (batch, cfg.vocab_size))
    elif isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != (gen, batch, cfg.vocab_size):
            raise ValueError(f"serve: noise has shape {tuple(noise.shape)}, "
                             f"expected {(gen, batch, cfg.vocab_size)}")
        noise = noise.__getitem__

    logits = None
    for t in range(prompt_len):
        logits, cache = LM.decode_step(params, cfg, prompt[:, t:t + 1], cache)
    out_tokens = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(gen):
        if greedy:
            tok = torch.argmax(logits, dim=-1)[:, None]
        else:
            gumbel = noise(t).to(dev, logits.dtype)
            tok = torch.argmax(logits + gumbel, dim=-1)[:, None]
        out_tokens.append(tok)
        logits, cache = LM.decode_step(params, cfg, tok, cache)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    gen_toks = torch.cat(out_tokens, dim=1) if out_tokens else \
        torch.zeros(batch, 0, dtype=torch.int64, device=dev)
    return gen_toks, batch * gen / dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lm_decode",
        description="Generate tokens with the PyTorch port's LM tier.")
    ap.add_argument("--arch", default=ARCH_IDS[0],
                    help=f"architecture id ({', '.join(ARCH_IDS)}; the VLM "
                         "is served through launch.steps)")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    toks, tps = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, seed=args.seed, greedy=args.greedy,
                      device=args.device)
    print(f"generated {tuple(toks.shape)} tokens at {tps:.1f} tok/s")
    print("first sequence:", toks[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
