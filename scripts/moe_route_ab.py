#!/usr/bin/env python3
"""Time two forms of the MoE's queue positions on the card.

    python3 scripts/moe_route_ab.py [--arch qwen3-moe-30b-a3b] [--reps 5]

``models/moe.py`` ranks each (token, slot) pair in its expert's queue by a
stable sort on (group, expert) and combines the experts' outputs with one
batched product.  The other form, kept here, is the reference's
(``src/repro/models/moe.py:84-97``) written in torch: a cumsum over the
(G, Tg k, E) one-hot tensor along its middle axis, and a float32 combine
of the gathered outputs.  Both give the same positions and kept masks.
Draws the architecture's full-width weights on the card from seed 5 and,
in one process, runs the variants in the order cumsum, sort, sort, cumsum:
each time a 2 x 2,048 scoring pass (a warm pass, ``--reps`` timed ones, a
profiled one: device busy and its top kernels) and one profiled decode
step at batch 8.  Prints one JSON line per turn, then the largest
log-prob difference between the two forms and the card's name and power
limit.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent


def cumsum_route(p, x, cfg, group_size):
    """``moe.moe_route`` with the queue positions and the aux loss's load
    counted through the (T, k, E) one-hot tensor, as the reference does."""
    from repro_torch.models import moe

    T = x.shape[0]
    k, E = cfg.num_experts_per_tok, moe.padded_num_experts(cfg)
    Tg = min(group_size, T)
    G = T // Tg
    C = max(int(k * Tg / E * cfg.capacity_factor), 1)
    probs = moe._router_probs(p, x, cfg)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    onehot = F.one_hot(experts, E)
    ce = onehot.sum(1).to(torch.float32).mean(0) / k
    aux = cfg.router_aux_loss * E * torch.sum(probs.mean(0) * ce)
    gates = torch.gather(probs, 1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = onehot.reshape(G, Tg * k, E)
    before = torch.cumsum(flat, dim=1) - flat
    position = (before.reshape(T, k, E) * onehot).sum(-1)
    return {"aux": aux, "experts": experts, "gates": gates,
            "position": position, "keep": position < C, "groups": G,
            "group_tokens": Tg, "capacity": C}


def cumsum_mlp(p, x, cfg, group_size=512):
    """``moe.moe_mlp`` over :func:`cumsum_route`, its combine summed in
    float32."""
    from repro_torch.models import moe
    from repro_torch.models.layers import gated_mlp

    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = cumsum_route(p, xt, cfg, group_size)
    E, G, Tg, C = (moe.padded_num_experts(cfg), r["groups"],
                   r["group_tokens"], r["capacity"])
    T, k = r["experts"].shape
    token = torch.arange(T, device=x.device)
    group = (token // Tg)[:, None].expand(T, k)
    slot = torch.where(r["keep"], (r["experts"] * G + group) * C
                       + r["position"], E * G * C)
    src = torch.full((E * G * C + 1,), T, dtype=torch.int64, device=x.device)
    src[slot.reshape(-1)] = token[:, None].expand(T, k).reshape(-1)
    xe = torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]].reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
    eo = torch.bmm(h, p["we_down"]).reshape(E * G * C, d)
    picked = torch.cat([eo, eo.new_zeros(1, d)])[slot]
    w = r["gates"].to(x.dtype).to(torch.float32)
    out = torch.einsum("tk,tkd->td", w, picked.to(torch.float32))
    out = out.to(x.dtype).reshape(B, S, d)
    if "shared" in p:
        sg = torch.sigmoid((x @ p["shared_gate"]).to(torch.float32))
        out = out + gated_mlp(p["shared"], x) * sg.to(x.dtype)
    return out, r["aux"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", default="qwen3-moe-30b-a3b")
    parser.add_argument("--reps", type=int, default=5)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("moe_route_ab: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.lm_config(opts.arch)
    params = cs.lm_params(cfg, device, seed=5)
    batch = cs.prefill_batch(cfg, device, 2, 2048)
    step = make_prefill_step(cfg)
    variants = {"cumsum": cumsum_mlp, "sort": moe.moe_mlp}
    sort_mlp = moe.moe_mlp
    logprobs = {}
    for name in ("cumsum", "sort", "sort", "cumsum"):
        moe.moe_mlp = variants[name]
        try:
            step({"model": params}, batch)
            torch.cuda.synchronize()
            walls = []
            for _ in range(opts.reps):
                t0 = time.perf_counter()
                logprobs[name] = step({"model": params}, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            _, scored = cs.scored(cfg, params, device, 2, 2048)
            decode = cs.profiled_step(cs.decoding(cfg, params, device)[0])
        finally:
            moe.moe_mlp = sort_mlp
        print(json.dumps({
            "variant": name, "model": cfg.name, "pass_s": walls,
            "median_pass_s": statistics.median(walls),
            "tokens_per_s": 4096 / statistics.median(walls),
            "pass_busy_us": scored["device_busy_us"],
            "pass_top": scored["device_top"][:4],
            "decode_step_wall_us": decode["wall_us"],
            "decode_step_busy_us": decode["device_busy_us"],
            "decode_step_kernels": decode["device_kernels"]}), flush=True)
    diff = (logprobs["cumsum"] - logprobs["sort"]).abs().max()
    print(json.dumps({"max_abs_logprob_diff": float(diff),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
