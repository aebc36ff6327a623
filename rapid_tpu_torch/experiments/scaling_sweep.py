"""Warmed-wall scaling sweep on the port: time-to-stable-view against
cluster size; the counterpart of ``experiments/scaling_sweep.py``.

BASELINE.md's main table reports wall time including each scenario's
first-time work; this sweep isolates the *warmed* decision cost -- what a
long-running deployment pays per view change -- across the scale axis
(SURVEY.md section 5.7: cluster size N is this framework's scale
dimension). One warm-up run per size, then a fresh same-shape simulator is
timed from fault injection to the decided view, through ``warmed_run``:
the port's single definition of the warmed decision, as ``bench.py``'s
``warmed_run`` is the JAX package's.

Run: python -m rapid_tpu_torch.experiments.scaling_sweep         (on the card)
     python -m rapid_tpu_torch.experiments.scaling_sweep --sizes 1000,10000
     python -m rapid_tpu_torch.experiments.scaling_sweep --sizes 1000 --device cpu

Prints a line with the device's name and power limit, then one JSON line
per size:
  {"n", "fail_fraction", "warmed_wall_ms", "virtual_ms", "cut_ok"}
"""

import argparse
import json
import subprocess
import time
from typing import Optional

import numpy as np

FAIL_FRACTION = 0.01
DEFAULT_SIZES = (1_000, 10_000, 100_000, 1_000_000)
_BUILD_KINDS = ("nvcc", "g++")


def _builds(events) -> dict:
    """Kernel builds and library loads among jitwatch compile events."""
    builds = [e for e in events if e.kind in _BUILD_KINDS]
    return {"builds": len(builds), "loads": sum(e.kind == "load" for e in events),
            "build_ms": round(sum(e.wall_s for e in builds) * 1000.0, 1)}


def _launch_diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def warmed_run(n_nodes: int, seed: int, fail_fraction: float = FAIL_FRACTION,
               placement_partitions: int = 0, handoff_partitions: int = 0,
               device=None, details: Optional[dict] = None):
    """The warmed measurement (``bench.py``'s ``warmed_run`` on the port):
    a warm-up simulator of the same shape decides a crash of
    ``fail_fraction`` of the members, then a fresh simulator is timed from
    fault injection to the decided view, ending in a device synchronize
    (``Simulator.ready``), its cut asserted equal to the victims. The
    victims of both runs come from one ``np.random.default_rng(seed)``, the
    warm-up's first. ``placement_partitions`` > 0 enables the placement
    plane on the timed simulator (the map built before the clock starts; the
    timed decision then includes the in-view-change rebalance);
    ``handoff_partitions`` > 0 enables the handoff plane too (placement at
    that partition count if not set), and the run asserts that every
    session completed. Without a plane the timed decision runs inside
    ``jitwatch.timed_window("bench.steady_state")``, where a kernel build or
    an unaudited host sync fails the run.

    ``details``, when given, is filled with the kernel builds, loads, build
    ms (as ``jitwatch`` records them under ``RAPID_JITWATCH=1``) and
    ``kernels.LAUNCHES`` of the warm-up and of the timed window apart, and
    the timed simulator under ``"sim"``.

    Returns (wall_ms, record, build_s, warmup_wall_s)."""
    from ..runtime import jitwatch
    from ..sim import kernels
    from ..sim.driver import Simulator

    rng = np.random.default_rng(seed)
    n_fail = max(1, int(n_nodes * fail_fraction))

    events0, launches0 = len(jitwatch.compile_events()), dict(kernels.LAUNCHES)
    t_build0 = time.perf_counter()
    sim = Simulator(n_nodes, seed=seed, device=device)
    build_s = time.perf_counter() - t_build0

    victims = rng.choice(n_nodes, size=n_fail, replace=False)
    sim.crash(victims)
    warm = sim.run_until_decision(max_rounds=16, batch=16)
    assert warm is not None and set(warm.cut) == set(victims), "warmup parity failed"
    warm_wall = warm.wall_time_s

    sim2 = Simulator(n_nodes, seed=seed + 4444, device=device)
    sim2.ready()  # drain construction from the device queue
    partitions = placement_partitions or handoff_partitions
    if partitions:
        sim2.enable_placement(partitions=partitions)
    if handoff_partitions:
        sim2.enable_handoff()
    victims2 = rng.choice(n_nodes, size=n_fail, replace=False)
    sim2.crash(victims2)
    events1, launches1 = len(jitwatch.compile_events()), dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    if partitions:
        # the rebalance's kernel is built at enable_placement; the handoff
        # plane's host work is not audited, so these points have no window
        record = sim2.run_until_decision(max_rounds=16, batch=16)
        sim2.ready()
    else:
        with jitwatch.timed_window("bench.steady_state"):
            record = sim2.run_until_decision(max_rounds=16, batch=16)
            sim2.ready()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    if details is not None:
        events = jitwatch.compile_events()
        launches2 = dict(kernels.LAUNCHES)
        details.update({
            **{f"kernel_{k}_warmup": v for k, v in _builds(events[events0:events1]).items()},
            **{f"kernel_{k}_steady": v for k, v in _builds(events[events1:]).items()},
            "launches_warmup": _launch_diff(launches1, launches0),
            "launches_steady": _launch_diff(launches2, launches1),
            "sim": sim2,
        })

    assert record is not None, "no decision reached"
    assert set(record.cut) == set(victims2), "cut-set parity violated"
    assert record.membership_size == n_nodes - len(victims2)
    if partitions:
        diffs = sim2.placement_diffs
        assert diffs, "placement enabled but no rebalance happened"
        # minimal motion: every moved partition lost a replica to the cut
        assert all(d.moved <= partitions for d in diffs)
    if handoff_partitions:
        assert sim2.handoff_transfers, "handoff enabled but nothing moved"
        started = sim2.metrics.get("handoff.sessions_started")
        completed = sim2.metrics.get("handoff.sessions_completed")
        assert started > 0 and completed == started, (
            f"handoff sessions incomplete: {completed}/{started}"
        )
    return wall_ms, record, build_s, warm_wall


def run_size(n: int, seed: int, device=None, details: Optional[dict] = None) -> dict:
    """One measurement through ``warmed_run``, which asserts the cut (an
    inexact cut raises rather than printing cut_ok: false). ``details`` gets
    ``warmed_run``'s, and its ``build_s`` and ``warmup_wall_s``."""
    wall_ms, record, build_s, warm_wall = warmed_run(n, seed=seed, device=device,
                                                     details=details)
    if details is not None:
        details.update(build_s=build_s, warmup_wall_s=warm_wall)
    return {
        "n": n,
        "fail_fraction": FAIL_FRACTION,
        "warmed_wall_ms": round(wall_ms, 1),
        "virtual_ms": record.virtual_time_ms,
        "cut_ok": True,  # asserted by warmed_run before returning
    }


def device_line(device) -> str:
    """The device's name and, for a card, its power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    if device.type != "cuda":
        return f"device: {device.type}"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[device.index or 0]
    return f"device: {card}"


def main(argv=None) -> None:
    from ..sim.engine import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--sizes", default=",".join(str(s) for s in DEFAULT_SIZES),
        help="comma-separated cluster sizes",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default=None,
                        help="where the simulators run (default: the CUDA "
                             "device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    for n in (int(s) for s in args.sizes.split(",")):
        print(json.dumps(run_size(n, args.seed, device)), flush=True)


if __name__ == "__main__":
    main()
