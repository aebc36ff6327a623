"""Where one decided view change spends its time on the GPU.

    python -m rapid_tpu_torch.sim.profile_decision [--members 100000] [--seed 42]
        [--fd-policy cumulative|windowed]

For each dispatch branch of ``Simulator.run_until_decision`` (the closed form
under a crash of 1% of members, the scan path under ingress loss 1.0 on 1%),
after one warm-up decision, it prints one JSON line with:

- ``wall_ms``: one decision on each of five fresh simulators, host clock,
  ending in a device synchronize;
- ``enqueue_ms`` / ``fetch_wait_ms`` / ``view_change_ms``: the same decision
  split into the host issuing the dispatch, the host waiting for the packed
  decision words, and the view change (config-id fold, fresh state);
- ``device_busy_ms``, ``kernels``, ``idle_share``: from a torch.profiler trace
  of a third decision, the summed duration of the GPU activity (kernels and
  copies), their count, and 1 - busy / profiled wall;
- ``top_device_ops``: the operators with the most GPU time in that trace;
- ``syncs``: synchronizing CUDA calls (torch's sync debug mode), by source
  line.

Needs an NVIDIA GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import warnings

import numpy as np
import torch

from .driver import Simulator
from .engine import SimConfig, pack_decision, run_rounds_const, run_until_decided_const, unpack_decision


def _fault(branch: str, sim: Simulator, victims: np.ndarray) -> None:
    if branch == "closed_form":
        sim.crash(victims)
    else:
        sim.ingress_loss(victims, 1.0)


def _split(sim: Simulator, branch: str) -> dict:
    """One decision through the driver's own steps, timed per phase."""
    t0 = time.perf_counter()
    inputs = sim._const_inputs(sim._arm_pending_joins())
    if branch == "closed_form":
        state = run_until_decided_const(sim.config, sim.state, inputs, 16, True)
    else:
        state = run_rounds_const(sim.config, sim.state, inputs, 16, True, sim._generator)
    t1 = time.perf_counter()
    words = pack_decision(sim.config, state).cpu().numpy()
    t2 = time.perf_counter()
    decided, _, _, proposal, group, decided_round, _ = unpack_decision(sim.config, words)
    assert decided
    sim.state = state
    sim._apply_view_change(t0, (proposal, group, decided_round))
    sim.ready()
    t3 = time.perf_counter()
    return {"enqueue_ms": (t1 - t0) * 1e3, "fetch_wait_ms": (t2 - t1) * 1e3,
            "view_change_ms": (t3 - t2) * 1e3}


def _syncs(sim: Simulator) -> dict:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run_until_decision(max_rounds=16, batch=16)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = collections.Counter(
        f"{w.filename.rsplit('rapid_tpu_torch/', 1)[-1]}:{w.lineno}"
        for w in caught if "synchronizing" in str(w.message)
    )
    return dict(sorted(lines.items()))


def _profile(sim: Simulator) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = sim.run_until_decision(max_rounds=16, batch=16)
        sim.ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert rec is not None
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_op = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0),
        key=lambda row: -row[1],
    )[:8]
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "kernels": len(device),
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ops": [{"op": k, "device_ms": ms, "calls": n} for k, ms, n in by_op],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--members", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--fd-policy", choices=("cumulative", "windowed"), default="cumulative")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decision: no CUDA device", file=sys.stderr)
        return 2
    n, rng = args.members, np.random.default_rng(args.seed)
    n_fail = max(1, n // 100)
    config = SimConfig(capacity=n, fd_policy=args.fd_policy)

    def fresh(branch: str, offset: int) -> Simulator:
        sim = Simulator(n, config=config, seed=args.seed + offset, device="cuda")
        _fault(branch, sim, rng.choice(n, n_fail, replace=False))
        return sim.ready()

    for branch in ("closed_form", "scan"):
        warm = fresh(branch, 0)
        assert warm.run_until_decision(max_rounds=16, batch=16) is not None
        walls = []
        for i in range(5):
            sim = fresh(branch, 10 + i)
            t0 = time.perf_counter()
            rec = sim.run_until_decision(max_rounds=16, batch=16)
            sim.ready()
            walls.append((time.perf_counter() - t0) * 1e3)
            assert rec is not None and rec.virtual_time_ms == 11_100
        out = {"branch": branch, "fd_policy": args.fd_policy, "members": n, "wall_ms": walls}
        out.update(_split(fresh(branch, 2), branch))
        out["syncs"] = _syncs(fresh(branch, 3))
        out.update(_profile(fresh(branch, 4)))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
