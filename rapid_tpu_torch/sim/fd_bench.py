"""Inputs, byte counts and a per-pass device profile of the fused FD phase.

    python -m rapid_tpu_torch.sim.fd_bench [--sizes 100000 1000000] [--calls 24]

For each size, ``kernels.fd_phase_fused`` is run on input sets rotated
through more than the 50 MB L2 (cold, as ``chip_smoke.py`` times it), under
``torch.profiler``; one JSON line per size gives each of its CUDA passes'
device time per call (``node_pass``, ``observer_pass``, ``gather_pass``),
beside the bytes the phase must move, for a round in which edges raise
alerts and for a quiet round, in which none does.
Needs an NVIDIA GPU; exits non-zero without one. ``chip_smoke.py`` builds
its inputs with ``fused_case`` and its bound with ``fused_bytes``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys

import torch

from . import engine, kernels

L2_BYTES = 50e6  # H100 L2 cache


def fused_bytes(c: int, k: int, gray: bool, random: bool, alerts: bool = True) -> int:
    """Bytes the fused phase must move: each input read once and each output
    written once. Per edge: subjects, observers (4 B each), probe_drop,
    fd_fail, alerted, down_reports in and fd_fail, alerted, down_arrivals out
    (1 B each), the draw (4 B) with random loss, fd_streak and fd_ok in and
    out (4 B) with the gray path. Per node: active, alive in and alive out,
    and drop_prob (4 B) with random loss. A round in which no edge raises an
    alert (``alerts`` false) need not read the observers. The kernel's own
    node table and new_down bits do not count."""
    edge = 4 + 1 + 1 + 1 + 1 + 3 + (4 if alerts else 0) + (4 if random else 0) + (4 if gray else 0)
    node = 3 + (4 if random else 0)
    return c * k * edge + c * node + 4  # + the round counter


def fused_case(c: int, seed: int, device, random: bool, k: int = 10):
    """One scan round's inputs to ``fd_phase_fused`` at [c, k] on ``device``:
    the adjacency from ``engine.device_initial_state`` over random ring
    orders, 1% of rows inactive, counters around the threshold of 10, 5% of
    nodes lossy."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def counters(hi):
        return torch.randint(0, hi, (c, k), generator=gen, device=device,
                             dtype=torch.uint8)

    active = rand(c) < 0.99
    ranks = torch.stack([torch.randperm(c, generator=gen, device=device)
                         for _ in range(k)]).to(torch.int32)
    state = engine.device_initial_state(
        engine.SimConfig(capacity=c, k=k), ranks, active, active.clone(),
        torch.zeros(c, dtype=torch.int32, device=device),
        torch.ones(c, dtype=torch.bool, device=device),
    )
    return (
        active, rand(c) < 0.99, rand(c) * (rand(c) < 0.05), state.subjects,
        state.observers, rand(c, k) < 0.01, rand(c, k) < 0.001,
        rand(c, k) if random else None, counters(12), rand(c, k) < 0.05,
        counters(8), counters(8),
        torch.full((), seed % 9, dtype=torch.int32, device=device),
    )


def cold_sets(c: int, random: bool, device, k: int = 10):
    """Enough input sets (at least 4) that rotating through them exceeds the
    L2 twice."""
    n_sets = max(4, math.ceil(2 * L2_BYTES / fused_bytes(c, k, False, random)))
    return [fused_case(c, 7000 + i, device, random, k) for i in range(n_sets)]


def quiet(sets):
    """The same input sets with every failure counter at 0, so that no edge
    reaches the threshold of 10 this round (as in most rounds of a scan)."""
    return [a[:8] + (torch.zeros_like(a[8]),) + a[9:] for a in sets]


def profile_passes(sets, calls: int) -> dict:
    """Device time per call of each CUDA pass of ``fd_phase_fused``, over
    ``calls`` calls rotating through ``sets``."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(threshold=10)
    for a in sets:
        kernels.fd_phase_fused(*a, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            kernels.fd_phase_fused(*sets[i % len(sets)], **kw)
        torch.cuda.synchronize()
    us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in ("node_pass", "observer_pass", "gather_pass"):
                if name in e.name:
                    us[name] += e.time_range.elapsed_us() / calls
    return dict(us)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[100_000, 1_000_000])
    parser.add_argument("--calls", type=int, default=24)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fd_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    for c in args.sizes:
        sets = cold_sets(c, True, "cuda")
        out = {"card": card, "size": [c, 10], "input_sets": len(sets),
               "bound_bytes": fused_bytes(c, 10, False, True),
               "quiet_bound_bytes": fused_bytes(c, 10, False, True, alerts=False),
               "us_per_call": profile_passes(sets, args.calls),
               "quiet_us_per_call": profile_passes(quiet(sets), args.calls)}
        print(json.dumps(out), flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
