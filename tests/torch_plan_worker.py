"""One rank of the port's data-parallel training, for
``tests/test_torch_plan_dp.py`` (a helper process, not a test module).

    python tests/torch_plan_worker.py RANK WORLD STORE CASE.npz OUT.npz

``CASE.npz`` holds the run's settings and JAX's draws and initial
parameters; the rank joins a gloo group of WORLD on the ``FileStore`` at
STORE, trains the case's hypergrid TB run under ``data_parallel(WORLD)``
on the CPU in scan mode, and rank 0 writes the metrics to ``OUT.npz``
(every rank its buffer's size beside it).  It imports no JAX.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.algo import OnPolicySampler, ReplaySampler, TrainLoop  # noqa: E402
from repro_torch.algo.plan import DataParallelPlan  # noqa: E402
from repro_torch.core.policies import MLPPolicy  # noqa: E402
from repro_torch.core.trainer import GFNConfig  # noqa: E402
from repro_torch.core.types import StepNoise  # noqa: E402
from repro_torch.envs.hypergrid import HypergridEnvironment  # noqa: E402
from repro_torch.launch.mesh import destroy_group, init_group  # noqa: E402
from repro_torch.rewards.hypergrid import HypergridRewardModule  # noqa: E402


def run(rank: int, world: int, store: str, case: str, out: str) -> None:
    torch.set_num_threads(1)
    z = dict(np.load(case))
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    dim, side, B, iters = (int(z[k]) for k in ("dim", "side", "num_envs",
                                               "iterations"))
    cpu = torch.device("cpu")
    init_group(world, rank, cpu, store_path=store)
    try:
        env = HypergridEnvironment(HypergridRewardModule(), dim=dim,
                                   side=side)
        pol = MLPPolicy(env.obs_dim, env.action_dim,
                        env.backward_action_dim,
                        hidden=tuple(int(h) for h in z["hidden"]),
                        device=cpu, requires_grad=True)
        pol.load_params({k[6:].replace("|", "/"): v for k, v in t.items()
                         if k.startswith("param:")})
        cfg = GFNConfig(objective="tb", num_envs=B, stop_action=dim,
                        exploration_eps=float(z["eps"]))

        def step_noise(seed, index, ts, num_actions):
            i = seed & 0xFFFFFFFF
            return StepNoise(t["g"][i, ts, index], t["gu"][i, ts, index],
                             t["u"][i, ts, index])

        if "cap" in z:
            def select(seed, index, capacity, prioritized):
                return t["sel"][rank, int(seed[0]) & 0xFFFFFFFF][index]

            def backward(seed, index, ts, num_actions):
                return t["gb"][rank, int(seed[0]) & 0xFFFFFFFF, ts, index]

            sampler = ReplaySampler(capacity=int(z["cap"]),
                                    replay_batch=int(z["replay"]),
                                    noise=step_noise, select_noise=select,
                                    backward_noise=backward)
        else:
            sampler = OnPolicySampler(noise=step_noise)
        loop = TrainLoop(env, env.init(cpu), pol, cfg, sampler=sampler,
                         plan=DataParallelPlan(world))
        state, (m, _) = loop.run(0, iters, mode="scan")
        size = torch.zeros(world, dtype=torch.int64)
        if state.sampler is not None:
            size = loop._gathered(state.sampler.size)
        if rank == 0:
            np.savez(out, size=size.numpy(),
                     **{k: v.numpy() for k, v in m.items()})
    finally:
        destroy_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
