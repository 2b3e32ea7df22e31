#!/usr/bin/env python3
"""Run one checkout's ``graph_train`` phase of ``chip_smoke.py`` alone.

    python3 scripts/graph_train_ab.py --checkout DIR [--recipes a,b,...]

Loads ``DIR/chip_smoke.py`` as a module, puts ``DIR/src`` first on the
path, builds that checkout's kernels and runs its ``graph_train_phase``
(eager and captured training, each recipe held, timed and profiled) over
the named recipes, or over all of that checkout's.  Each line printed is
that script's own ``graph_train`` / ``graph_profile`` line with a
``checkout`` key added.

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists (``git archive``) and run the checkouts in turn, one
process each, in the order A, B, B, A.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, required=True)
    parser.add_argument("--recipes", default=None,
                        help="comma-separated recipe names (default: every "
                             "recipe of the checkout's graph_train)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("graph_train_ab: no CUDA GPU", file=sys.stderr)
        return 2
    root = opts.checkout.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_checkout", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if opts.recipes:
        names = opts.recipes.split(",")
        smoke.GRAPH_LAUNCHES_PER_ITER = {
            k: smoke.GRAPH_LAUNCHES_PER_ITER[k] for k in names}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    build.build()
    build.library()
    emit = smoke.emit

    def tagged(phase, **fields):
        emit(phase, checkout=str(opts.checkout), **fields)

    smoke.emit = tagged
    smoke.graph_train_phase(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
