"""Inputs, byte counts and a per-pass device profile of the fused FD phase.

    python -m rapid_tpu_torch.sim.fd_bench [--sizes 100000 1000000] [--calls 24]

For each size, ``kernels.fd_phase_fused`` is run on input sets rotated
through more than the 50 MB L2 (cold, as ``chip_smoke.py`` times it), under
``torch.profiler``; one JSON line per size gives each of its CUDA passes'
device time per call (``node_pass``, ``observer_pass``, ``gather_pass``),
beside the bytes the phase must move, for a round in which edges raise
alerts and for a quiet round, in which none does, under the cumulative
policy and (``windowed_*`` keys) under the windowed one (W 10, t 4).
Needs an NVIDIA GPU; exits non-zero without one. ``chip_smoke.py`` builds
its inputs with ``fused_case`` (and, for the windowed policy,
``window_planes``) and its bound with ``fused_bytes``; for the phase split
around the multi-device exchange, ``split_case`` and ``run_split`` cut a
fused case into shards (``device_call`` merges them into one per-device
call), and ``rows_bytes`` and ``gather_bytes`` bound its two kernels.
``graph_ms`` times a call on the card (CUDA graph replays, CUDA events);
``split_us`` times the mesh's kernels with it.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import statistics
import subprocess
import sys

import torch

from . import engine, kernels, threefry

L2_BYTES = 50e6  # H100 L2 cache


def fused_bytes(c: int, k: int, gray: bool, random: bool, alerts: bool = True,
                window: bool = False) -> int:
    """Bytes the fused phase must move: each input read once and each output
    written once. Per edge: subjects, observers (4 B each), probe_drop,
    alerted, down_reports in and alerted, down_arrivals out (1 B each), the
    policy's planes -- fd_fail in and out (2 B), or with the ``window`` the
    int32 fd_hist and the uint8 fd_seen in and out (10 B) -- the draw (4 B)
    with random loss, fd_streak and fd_ok in and out (4 B) with the gray
    path. Per node: active, alive in and alive out, and drop_prob (4 B) with
    random loss. A round in which no edge raises an alert (``alerts`` false)
    need not read the observers. The kernel's own node table and new_down
    bits do not count."""
    edge = (4 + 1 + 1 + 1 + 2 + (10 if window else 2) + (4 if alerts else 0)
            + (4 if random else 0) + (4 if gray else 0))
    node = 3 + (4 if random else 0)
    return c * k * edge + c * node + 4  # + the round counter


def rows_bytes(c: int, rows: int, k: int, gray: bool, random: bool,
               window: bool = False, shards: int = 1) -> int:
    """Bytes one ``fd_phase_rows`` call must move over ``shards`` shards of
    ``rows`` rows: per edge, subjects (4 B), probe_drop and alerted in and
    alerted out (1 B each), the policy's planes in and out (2 B, or 10 B for
    the window), the draw (4 B) with random loss and the gray planes (4 B)
    with the gray path; each shard's bitset segment out; per node of all C,
    once a call, active and alive, and drop_prob (4 B) with random loss."""
    edge = 4 + 3 + (10 if window else 2) + (4 if random else 0) + (4 if gray else 0)
    return (shards * (rows * k * edge + 4 * kernels.segment_words(rows, k))
            + c * (2 + (4 if random else 0)) + 4 + 1)  # + the round and the halt flag


def gather_bytes(c: int, shards: int, k: int, alerts: bool = True) -> int:
    """Bytes ``fd_gather`` must move: per edge, down_reports in and
    down_arrivals out (1 B each), and, when some bit is set, the observers
    (4 B) and every shard's bitset segment; per node, active; each shard's
    flag."""
    words = kernels.segment_words(c // shards, k)
    return c * k * (2 + (4 if alerts else 0)) + c + 4 * shards * (words if alerts else 1)


def split_case(args, kw: dict, shards: int):
    """One fused case (``fused_case``'s positional inputs, ``kw`` its
    keywords) cut into ``shards`` row blocks, each a fresh tensor as a shard
    holds it. Returns ``(calls, bits)``: for each shard the positional
    arguments and keywords of ``fd_phase_rows``, writing into its segment of
    ``bits``, a bitset filled with -1 so that a word left unwritten shows."""
    (active, alive, drop_prob, subjects, _, probe_drop, _, draw, fd_fail, alerted,
     fd_streak, fd_ok, round_) = args
    c, k = subjects.shape
    rows = c // shards
    words = kernels.segment_words(rows, k)
    bits = torch.full((shards * words,), -1, dtype=torch.int32, device=active.device)
    calls = []
    for s in range(shards):
        def block(t):
            return None if t is None else t[s * rows:(s + 1) * rows].clone()
        calls.append((
            (active, alive, drop_prob, block(subjects), block(probe_drop), block(draw),
             block(fd_fail), block(alerted), block(fd_streak), block(fd_ok), round_,
             bits[s * words:(s + 1) * words]),
            dict(kw, row0=s * rows, fd_hist=block(kw.get("fd_hist")),
                 fd_seen=block(kw.get("fd_seen"))),
        ))
    return calls, bits


def device_call(calls):
    """The calls of ``split_case`` as one ``fd_phase_rows`` call over every
    shard, as a device that holds them all makes it: each per-shard argument
    a list, one value a shard (None where no shard has it). Returns its
    positional arguments and keywords."""
    columns = list(zip(*(a for a, _ in calls)))
    args = tuple(column[0] if i in (0, 1, 2, 10) or column[0] is None else list(column)
                 for i, column in enumerate(columns))  # active, alive, drop_prob, round_ shared
    kws = [kw for _, kw in calls]
    kw = dict(kws[0], **{name: None if kws[0][name] is None else [w[name] for w in kws]
                         for name in ("row0", "fd_hist", "fd_seen")})
    return args, kw


def run_split(calls, bits, args, kernel: bool = True, per_device: bool = True, **extra):
    """``fd_phase_rows`` over the shards of ``split_case``, one call over all
    of them (``device_call``) or, without ``per_device``, one a shard, then
    ``fd_gather`` from the bitset (the kernels, or with ``kernel`` false
    their plain versions); ``extra`` goes to every ``fd_phase_rows`` call
    (``halt``). Returns ``fd_phase_fused``'s eight outputs, ``alive`` as
    None."""
    rows_fn = kernels.fd_phase_rows if kernel else kernels.fd_phase_rows_plain
    if per_device:
        merged, kw = device_call(calls)
        outs = rows_fn(*merged, **kw, **extra)
    else:
        outs = [rows_fn(*a, **kw, **extra) for a, kw in calls]
    gather_fn = kernels.fd_gather if kernel else kernels.fd_gather_plain
    rows = args[3].shape[0] // len(calls)
    down = gather_fn(args[0], args[4], args[6], bits, rows)
    planes = [None if outs[0][i] is None else torch.cat([o[i] for o in outs])
              for i in range(6)]  # fd_fail, alerted, streak, ok, hist, seen
    return (None, planes[0], planes[1], planes[2], planes[3], down, planes[4], planes[5])


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
        torch.ones(c, dtype=torch.bool, device=device), threefry.prng_key(seed, device),
    )
    return (
        active, rand(c) < 0.99, rand(c) * (rand(c) < 0.05), state.subjects,
        state.observers, rand(c, k) < 0.01, rand(c, k) < 0.001,
        rand(c, k) if random else None, counters(12), rand(c, k) < 0.05,
        counters(8), counters(8),
        torch.full((), seed % 9, dtype=torch.int32, device=device),
    )


def window_planes(c: int, window: int, seed: int, device, k: int = 10):
    """``fd_hist``/``fd_seen`` of a windowed round at [c, k]: partly filled
    windows (half of them full, the rest counted in [0, W)), each
    recorded probe failed with probability 0.5, so that some edges cross
    a threshold of 0.4 or 0.7 this round and others do not."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.rand((c, k, window), generator=gen, device=device) < 0.5
    weights = 1 << torch.arange(window, device=device, dtype=torch.int32)
    hist = (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)
    seen = torch.randint(0, window, (c, k), generator=gen, device=device, dtype=torch.uint8)
    seen = torch.where(torch.rand((c, k), generator=gen, device=device) < 0.5,
                       window, seen).to(torch.uint8)
    return hist, seen


def cold_sets(c: int, random: bool, device, k: int = 10):
    """Enough input sets (at least 4) that rotating through them exceeds the
    L2 twice."""
    n_sets = max(4, math.ceil(2 * L2_BYTES / fused_bytes(c, k, False, random)))
    return [fused_case(c, 7000 + i, device, random, k) for i in range(n_sets)]


def quiet(sets):
    """The same input sets with every failure counter at 0, so that no edge
    reaches the threshold of 10 this round (as in most rounds of a scan)."""
    return [a[:8] + (torch.zeros_like(a[8]),) + a[9:] for a in sets]


def graph_ms(fn, reps: int = 24, iters: int = 11) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the replay timed with CUDA events, median over ``iters`` replays
    divided by ``reps``. The graph keeps the Python wrapper's launch overhead
    out of the measurement, which at these sizes would otherwise swamp it.
    ``fn`` may be a list of calls, taken in turn (to rotate input sets)."""
    fns = fn if isinstance(fn, list) else [fn]
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with kernels.no_collection(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / reps
    del graph
    return ms


def split_us(sets, shards: int) -> dict:
    """Device µs of the mesh's FD kernels on ``sets`` (``cold_sets``) cut
    into ``shards`` shards, cold (``graph_ms`` over the sets in turn): one
    ``fd_phase_rows`` call over every shard (``device_call``), one shard's
    call alone, and ``fd_gather``."""
    halt = torch.zeros((), dtype=torch.bool, device=sets[0][0].device)
    cases = [split_case(a, dict(threshold=10), shards) for a in sets]
    merged = [device_call(calls) for calls, _ in cases]
    for a, (calls, bits) in zip(sets, cases):
        run_split(calls, bits, a, halt=halt)  # the bitsets of a round with alerts
    rows = sets[0][3].shape[0] // shards
    return {
        "device_call": 1e3 * graph_ms(
            [lambda m=m: kernels.fd_phase_rows(*m[0], **m[1], halt=halt) for m in merged]),
        "one_shard": 1e3 * graph_ms(
            [lambda a=a, kw=kw: kernels.fd_phase_rows(*a, **kw, halt=halt)
             for calls, _ in cases for a, kw in calls], reps=len(sets) * shards),
        "gather": 1e3 * graph_ms(
            [lambda a=a, b=b: kernels.fd_gather(a[0], a[4], a[6], b, rows)
             for a, (_, b) in zip(sets, cases)]),
    }


def profile_passes(sets, calls: int, planes=None) -> dict:
    """Device time per call of each CUDA pass of ``fd_phase_fused``, over
    ``calls`` calls rotating through ``sets``; with ``planes`` (one
    ``(fd_hist, fd_seen)`` a set) its windowed instantiation, W 10, t 4."""
    from torch.profiler import ProfilerActivity, profile

    def kw(i):
        if planes is None:
            return dict(threshold=10)
        hist, seen = planes[i % len(planes)]
        return dict(threshold=10, window=10, window_fire=4, fd_hist=hist, fd_seen=seen)

    for i, a in enumerate(sets):
        kernels.fd_phase_fused(*a, **kw(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            kernels.fd_phase_fused(*sets[i % len(sets)], **kw(i))
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
        planes = [window_planes(c, 10, 9000 + i, "cuda") for i in range(len(sets))]
        no_full_window = [(h, torch.zeros_like(n)) for h, n in planes]
        out = {"card": card, "size": [c, 10], "input_sets": len(sets),
               "bound_bytes": fused_bytes(c, 10, False, True),
               "quiet_bound_bytes": fused_bytes(c, 10, False, True, alerts=False),
               "us_per_call": profile_passes(sets, args.calls),
               "quiet_us_per_call": profile_passes(quiet(sets), args.calls),
               "windowed_bound_bytes": fused_bytes(c, 10, False, True, window=True),
               "windowed_us_per_call": profile_passes(sets, args.calls, planes),
               "windowed_quiet_us_per_call": profile_passes(sets, args.calls, no_full_window)}
        print(json.dumps(out), flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
