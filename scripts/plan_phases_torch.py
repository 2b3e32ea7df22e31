#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s execution-plan phases alone on one card.

    python3 scripts/plan_phases_torch.py

Builds the kernels, checks them at the shapes the seed plans fold to
(``traj_logprob`` (64, 15, 3840 / 15), ``decode_attention`` (64, 16, 8,
8), ``subtb_loss`` (128, 30)), runs ``plan_vmap_seeds`` and holds every
shape it launched against those rows, then runs ``plan_data_parallel``
and ``plan_serve`` (whose shapes are the single plan's, which the whole
script holds).  Each line printed is the phase's own ``chip_smoke.py``
line.  Needs a CUDA GPU; about a minute and a half.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_phases_torch: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build()
    build.library()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    floor = cs.launch_floor_us(device)
    traj = [cs.check_traj_logprob(64, 15, A, seed=60 + A, device=device,
                                  floor_us=floor) for A in (3840, 15)]
    attn = [cs.check_decode_attention(
        64, 16, 8, 8, [(5 * i) % 16 + 1 for i in range(64)], seed=24,
        device=device, floor_us=floor)]
    subtb = [cs.check_subtb(128, 30, 0.9, seed=12, device=device,
                            floor_us=floor)]
    cs.plan_vmap_seeds_phase(device)
    # what the seed plans launched, against this script's rows
    checked = {"decode_attention": {(r["B"], r["S"], r["H"], r["hd"])
                                    for r in attn},
               "traj_logprob": {(f["B"], f["T"], f["A"]) for f, _ in traj},
               "subtb_loss": {(f["B"], f["T1"]) for f, _ in subtb}}
    folded = {k: set(v) for k, v in cs.PATH_SHAPES.items() if v}
    cs.emit("path_shapes", folded={k: sorted(v) for k, v in folded.items()})
    if folded.keys() != checked.keys() or any(
            folded[k] - checked[k] for k in folded):
        raise AssertionError(f"folded shapes {folded} beside the rows "
                             f"{checked}")
    cs.plan_data_parallel_phase(device)
    cs.plan_serve_phase(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
