"""Chaos run of the port's serving front (counterpart of
``scripts/serve_chaos.py``).

Stands up the threaded HTTP server that ``repro_torch.launch.serve --http``
runs, under a seeded :class:`FaultPlan` firing at every injection point
(transient step failures, latency spikes, lane poisoning, restore
failures), while HTTP client threads send mixed requests: some with tight
deadlines, some without, one env served from a checkpoint directory that
advances mid-run (engine refresh under load).  Then it delivers a real
``SIGTERM`` and drains.  It asserts:

- **no hung request**: every request ends with a 200 or a typed
  :mod:`repro_torch.serve.errors` status (400/408/429/500/503/504 with a
  ``kind``) before its timeout;
- **correct successes**: every 200 body is bitwise its solo
  ``forward_rollout`` reference, whatever faults fired, however often its
  engine was quarantined and replayed, or whether the checkpoint refreshed
  under it (both checkpoint steps carry the same parameters, so the
  reference holds while the eviction and rebuild run for real);
- **a clean SIGTERM drain**: admission stops, in-flight lanes finish,
  every response is flushed, every runner joins.

``--seed`` fixes the fault schedule and the request mix, so a failing run
replays.  Runs on ``cuda`` unless ``--device cpu``::

    PYTHONPATH=src python scripts/serve_chaos_torch.py --duration 30
    PYTHONPATH=src python scripts/serve_chaos_torch.py --device cpu \\
        --duration 10
"""
from __future__ import annotations

import argparse
import json
import random
import shutil
import signal
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of chaos load (after the warm-up)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the fault schedule and the request mix")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import recipes
    from repro_torch.checkpoint.manager import (POLICY_PARAMS_PREFIX,
                                                CheckpointManager)
    from repro_torch.core.rollout import forward_rollout
    from repro_torch.envs.registry import make_env
    from repro_torch.serve import (FaultPlan, FaultSpec, SampleRequest,
                                   Scheduler, ServeFront, make_server)

    ckpt_dir = tempfile.mkdtemp(prefix="serve_chaos_ckpt_")
    envspecs = [("bitseq", {"n": 16, "k": 4}, None),
                ("hypergrid", {"dim": 2, "side": 6}, ckpt_dir)]
    # a small closed seed set, so each reference is computed once
    seeds = [200 + i for i in range(8)]
    typed = {400, 408, 429, 500, 503, 504}

    plan = FaultPlan([
        FaultSpec("engine_step", rate=0.04, detail="chaos"),
        FaultSpec("latency", rate=0.10, latency_s=0.05),
        FaultSpec("lane_state", rate=0.02),
        FaultSpec("restore", rate=0.15),
    ], seed=args.seed)
    sched = Scheduler(num_lanes=args.lanes, device=args.device,
                      fault_plan=plan, max_step_retries=2,
                      retry_backoff_s=0.005)
    front = ServeFront(sched, max_queue=16, checkpoint_poll_s=0.2,
                       hard_timeout_s=120.0)

    # solo references; the hypergrid env is served from ckpt_dir, which
    # holds the policy's fresh parameters at step 1 and (published mid-run)
    # step 2
    refs, grid_tree = {}, None
    for env_name, ov, ckpt in envspecs:
        env = make_env(env_name, **ov)
        ep = env.init(sched.device)
        pol = recipes.get(env_name).make_policy(env, device=sched.device)
        if ckpt is not None:
            grid_tree = {f"{POLICY_PARAMS_PREFIX}/{k}": v.detach()
                         for k, v in pol.params.flat().items()}
            CheckpointManager(ckpt).save(1, grid_tree)
        for seed in seeds:
            for ns in (1, 2, 3):
                b = forward_rollout(seed, env, ep, pol, ns)
                refs[(env_name, seed, ns)] = (b.obs[-1].cpu().numpy(),
                                              b.log_reward.cpu().numpy())

    # build the engines without faults, then arm the plan
    warm_plan, sched.fault_plan = sched.fault_plan, None
    for env_name, ov, ckpt in envspecs:
        front.request(SampleRequest(env=env_name, num_samples=2,
                                    seed=seeds[0], overrides=ov,
                                    checkpoint=ckpt))
    sched.fault_plan = warm_plan
    for eng in sched._engines.values():
        eng._faults = warm_plan

    # the live threaded server, drained by a real SIGTERM (the handler
    # shape repro_torch.launch.serve --http installs)
    server = make_server(front, host="127.0.0.1", port=0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    drain_report = {}
    drained = threading.Event()

    def on_sigterm(signum, frame):
        def stop():
            drain_report.update(front.shutdown(drain=True, timeout=60.0))
            server.shutdown()
            drained.set()
        threading.Thread(target=stop, daemon=True).start()

    signal.signal(signal.SIGTERM, on_sigterm)

    stop = threading.Event()
    lock = threading.Lock()
    tally = {"ok": 0, "typed_error": 0, "hung": 0, "mismatch": 0,
             "untyped": 0}
    kinds: dict = {}

    def client(tid: int) -> None:
        rng = random.Random(args.seed * 1000 + tid)
        conn = HTTPConnection("127.0.0.1", port, timeout=130.0)
        while not stop.is_set():
            env_name, ov, ckpt = envspecs[rng.randrange(len(envspecs))]
            seed = rng.choice(seeds)
            ns = rng.choice((1, 2, 3))
            deadline = rng.choice((None, None, None, 0.4, 1.5))
            body = {"env": env_name, "num_samples": ns, "seed": seed,
                    "overrides": ov}
            if ckpt is not None:
                body["checkpoint"] = ckpt
            if deadline is not None:
                body["deadline_s"] = deadline
            try:
                conn.request("POST", "/sample", json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
            except Exception:        # a timeout or refusal: hung or dropped
                if stop.is_set():    # the server went down in the drain
                    return
                with lock:
                    tally["hung"] += 1
                conn = HTTPConnection("127.0.0.1", port, timeout=130.0)
                continue
            if resp.status == 200:
                obs, lr = refs[(env_name, seed, ns)]
                good = (np.array_equal(np.asarray(doc["samples"]), obs)
                        and np.array_equal(
                            np.asarray(doc["log_rewards"], np.float32), lr))
                with lock:
                    tally["ok" if good else "mismatch"] += 1
            elif resp.status in typed and "kind" in doc:
                with lock:
                    tally["typed_error"] += 1
                    kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
            else:
                with lock:
                    tally["untyped"] += 1
                    kinds[f"http_{resp.status}"] = \
                        kinds.get(f"http_{resp.status}", 0) + 1
        conn.close()

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(args.clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    # mid-run, training publishes a newer complete checkpoint (the same
    # parameters): the hypergrid engine must refresh under load
    time.sleep(args.duration / 2)
    CheckpointManager(ckpt_dir).save(2, grid_tree)
    time.sleep(args.duration / 2)
    stop.set()
    for t in threads:
        t.join(timeout=150.0)
        if t.is_alive():             # a hung client is the failure mode
            tally["hung"] += 1

    signal.raise_signal(signal.SIGTERM)     # the real drain path
    if not drained.wait(timeout=90.0):
        drain_report["drained"] = False
    serving.join(timeout=30.0)
    server.server_close()
    refreshes = front.stats()["counters"].get("checkpoint_refreshes", 0)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    elapsed = time.monotonic() - t0
    total = tally["ok"] + tally["typed_error"]
    print(f"chaos on {sched.device}: {elapsed:.1f}s, {total} requests "
          f"terminated ({tally['ok']} ok, {tally['typed_error']} typed "
          f"errors {dict(sorted(kinds.items()))})")
    print(f"fault points fired: "
          f"{ {p: s['fired'] for p, s in warm_plan.stats().items()} }")
    print(f"front counters: {front.stats()['counters']}")
    print(f"checkpoint refreshes under load: {refreshes}")
    print(f"drain report: {drain_report}")

    failures = []
    if tally["hung"]:
        failures.append(f"{tally['hung']} hung request(s)/client(s)")
    if tally["mismatch"]:
        failures.append(f"{tally['mismatch']} bitwise mismatches")
    if tally["untyped"]:
        failures.append(f"{tally['untyped']} untyped error responses")
    if not drain_report.get("drained"):
        failures.append(f"unclean SIGTERM drain: {drain_report}")
    if refreshes < 1:
        failures.append("mid-flight checkpoint refresh never happened")
    if tally["ok"] == 0:
        failures.append("no request ever succeeded under chaos")
    if failures:
        print("CHAOS FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("CHAOS OK: every request terminated with a correct result or a "
          "typed error; checkpoint refreshed under load; SIGTERM drain "
          "was clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
