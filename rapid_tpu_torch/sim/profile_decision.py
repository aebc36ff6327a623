"""Where one decided view change spends its time on the GPU.

    python -m rapid_tpu_torch.sim.profile_decision [--members 100000] [--seed 42]
        [--fd-policy cumulative|windowed] [--no-speculate]

For each branch (``closed_form``: the closed form under a crash of 1% of
members; ``scan``: the scan path under ingress loss 1.0 on 1% of members,
random loss having no closed form; ``scan_crash``: the scan path under a
crash of 1% with ingress loss 1.0 on the same members, the scan decision
that speculation predicts), after one warm-up decision, it prints one JSON
line with:

- ``wall_ms``: one decision on each of five fresh simulators, host clock,
  ending in a device synchronize;
- ``enqueue_ms`` / ``fetch_wait_ms`` / ``view_change_ms``: the same decision
  split into the host issuing the dispatch and packing the decision words,
  the host waiting for them and for the speculation worker, which builds
  the predicted view change meanwhile (``fetch_ms`` and ``worker_wait_ms``,
  its two parts: a worker that overlapped the fetch leaves little to wait
  for), and the view change (config-id fold, fresh state, each taken from
  the worker on a hit); ``speculation_hits``;
- ``device_busy_ms``, ``kernels``, ``idle_share``: from a torch.profiler trace
  of a third decision, the summed duration of the GPU activity (kernels and
  copies), their count, and 1 - busy / profiled wall; ``annotations``, the
  ranges the trace names around the hand-written kernels, counted apart;
- ``top_device_ops``: the operators with the most GPU time in that trace;
- ``syncs``: synchronizing CUDA calls (torch's sync debug mode), by source
  line.

Every simulator runs with ``speculate=True`` (the driver's default on the
card is off), or with ``speculate=False`` under ``--no-speculate``. Needs an
NVIDIA GPU; exits non-zero without one.
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

from ..runtime import jitwatch
from .driver import Simulator
from .engine import SimConfig, pack_decision, run_rounds_const, run_until_decided_const, unpack_decision


BRANCHES = ("closed_form", "scan", "scan_crash")


def _fault(branch: str, sim: Simulator, victims: np.ndarray) -> None:
    if branch != "scan":
        sim.crash(victims)
    if branch != "closed_form":
        sim.ingress_loss(victims, 1.0)


def _split(sim: Simulator, branch: str) -> dict:
    """One decision through the driver's own steps, timed per phase."""
    t0 = time.perf_counter()
    inputs = sim._const_inputs(sim._arm_pending_joins())
    if branch == "closed_form":
        state = run_until_decided_const(sim.config, sim.state, inputs, 16, True)
    else:
        state = run_rounds_const(sim.config, sim.state, inputs, 16, True)
    sim.state = state
    packed = pack_decision(sim.config, state)
    t1 = time.perf_counter()
    worker = sim._speculate_view_change()
    words = jitwatch.fetch("sim.decision_words", packed)
    t_fetched = time.perf_counter()
    if worker is not None:
        worker.join()
    t2 = time.perf_counter()
    decided, _, _, proposal, group, decided_round, _ = unpack_decision(sim.config, words)
    assert decided
    sim._apply_view_change(t0, (proposal, group, decided_round))
    sim.ready()
    t3 = time.perf_counter()
    hits = sim.metrics.get("speculation_hits_config_id") + sim.metrics.get(
        "speculation_hits_fresh_state")
    return {"enqueue_ms": (t1 - t0) * 1e3, "fetch_wait_ms": (t2 - t1) * 1e3,
            "fetch_ms": (t_fetched - t1) * 1e3, "worker_wait_ms": (t2 - t_fetched) * 1e3,
            "view_change_ms": (t3 - t2) * 1e3, "speculation_hits": hits}


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
        for w in caught if "synchronizing CUDA operation" in str(w.message)
    )
    return dict(sorted(lines.items()))


def profile_gpu(fn, passes=()) -> dict:
    """The GPU activity of ``fn()`` under torch.profiler, ending in a device
    synchronize: ``kernels`` (kernels and copies), ``device_busy_ms``, the
    host-clock ``profiled_wall_ms``, ``idle_share``, the operators with the
    most GPU time, the ``copies`` and their ``copy_us``, and the device µs
    of each name in ``passes`` (summed over the kernels whose name holds
    it). The ranges that ``kernels._traced`` names around a hand-written
    kernel's launch show on the GPU's timeline too; they are neither a
    kernel nor a copy and overlap the kernel they name, so they are counted
    apart, as ``annotations``, and not in the busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = [e for e in on_gpu if not e.is_user_annotation]

    def us(name):
        return sum(e.time_range.elapsed_us() for e in device if name in e.name)
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
        "annotations": len(on_gpu) - len(device),
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ops": [{"op": k, "device_ms": ms, "calls": n} for k, ms, n in by_op],
        "copies": sum("emcpy" in e.name for e in device),  # Memcpy DtoD/HtoD/DtoH
        "copy_us": us("emcpy"),
        **{f"{name}_us": us(name) for name in passes},
    }


def _profile(sim: Simulator) -> dict:
    recs = []
    prof = profile_gpu(lambda: recs.append(sim.run_until_decision(max_rounds=16, batch=16)))
    assert recs[0] is not None
    return prof


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--members", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--fd-policy", choices=("cumulative", "windowed"), default="cumulative")
    parser.add_argument("--no-speculate", action="store_true",
                        help="build each view change after the fetch, not during it")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decision: no CUDA device", file=sys.stderr)
        return 2
    n, rng = args.members, np.random.default_rng(args.seed)
    n_fail = max(1, n // 100)
    config = SimConfig(capacity=n, fd_policy=args.fd_policy)

    def fresh(branch: str, offset: int) -> Simulator:
        sim = Simulator(n, config=config, seed=args.seed + offset,
                        speculate=not args.no_speculate, device="cuda")
        _fault(branch, sim, rng.choice(n, n_fail, replace=False))
        return sim.ready()

    for branch in BRANCHES:
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
        out = {"branch": branch, "fd_policy": args.fd_policy, "members": n,
               "speculate": not args.no_speculate, "wall_ms": walls}
        out.update(_split(fresh(branch, 2), branch))
        out["syncs"] = _syncs(fresh(branch, 3))
        out.update(_profile(fresh(branch, 4)))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
