#!/usr/bin/env python3
"""Time one checkout's ``lm_decode.serve`` at full width on the card.

    python3 scripts/lm_decode_ab.py --checkout DIR [--arch hymba-1.5b]
        [--reps 3]

Puts ``DIR/src`` first on the path, builds that checkout's kernels, draws
the architecture's full-width weights on the card from seed 0 and serves
batch 8, 32 prompt tokens (prefilled a decode step at a time) and 32
generated, as ``chip_smoke.py``'s decode phases do: one warm call, then
``--reps`` timed calls.  Prints one JSON line per timed call, with the
checkout, the steps per second over the call's wall time (prompt and
generated steps) and the card's name and power limit.

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists (``git archive``) and run the checkouts in turn, one
process each, in the order A, B, B, A.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH, PROMPT, GEN = 8, 32, 32


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, required=True)
    parser.add_argument("--arch", default="hymba-1.5b")
    parser.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("lm_decode_ab: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.checkout.resolve() / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import lm_decode
    from repro_torch.models import lm as LM

    build.build()
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    cfg = get_config(opts.arch)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    params = LM.init_params(cfg, generator=g, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(0))
    lm_decode.serve(cfg, batch=BATCH, prompt_len=2, gen=2, seed=1,
                    device=device, params=params)
    torch.cuda.synchronize()
    for rep in range(opts.reps):
        t0 = time.perf_counter()
        lm_decode.serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0,
                        device=device, params=params, prompt=prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"checkout": str(opts.checkout), "arch": cfg.name,
                          "rep": rep, "batch": BATCH, "prompt_len": PROMPT,
                          "gen": GEN, "wall_s": wall,
                          "steps_per_s": (PROMPT + GEN) / wall,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
