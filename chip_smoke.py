"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU, and hold
every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU (sm_90a:
H100/H200) and the CUDA toolkit. The first run builds the kernels with nvcc
into build/kernels/. Phases, each of which must pass:

1. the card, the torch and CUDA versions, and the kernel build time;
2. each CUDA kernel against its plain version at [100_000, 10] and
   [1_000_000, 10], bit for bit, with CUDA-event timings of both; the fused
   FD phase (``fd_phase_fused``) with the gray path off and on and with 1 and
   4 rounds per interval, timed cold (inputs rotated through more than the
   50 MB L2) and hot, in a round with alerts and in a quiet one, beside the
   unfused sequence it replaces (plain ops, ``fd_phase_u8``, the gather);
3. the headline: a 100k-member simulator, 1% of members crashed, one
   ``run_until_decision(16, 16)`` to warm, then the same timed on
   ``TIMED_RUNS`` fresh simulators (the closed-form branch); each cut must
   equal the crashed set;
4. the scan path: fresh 100k simulators under ingress loss 1.0 on 1% of
   members, which must decide that set through ``fd_phase_fused`` (and
   launch ``fd_phase_u8`` no time), at no more host syncs than before;
5. the windowed FD policy's kernel: ``fd_phase_fused`` windowed against its
   plain version, bit for bit, at [100_000, 10] and [1_000_000, 10], for
   W in {10, 16}, threshold fractions 0.4 and 0.7, 1 and 4 rounds per
   interval, random loss on and off, from partly filled windows; the
   windowed scan's variant timed cold and hot, in a round with alerts and in
   a quiet one;
6. windowed decisions at full width: 100k members, ``fd_policy="windowed"``,
   1% crashed (closed form) or under ingress loss 1.0 (the scan, which must
   launch the windowed kernel every round it executes), each deciding that
   set at 11 100 ms virtual;
7. the classic fallback at full width: 100k members in two delivery groups,
   a blind group of 26 000 that hears no broadcast (more than F = 24 999),
   1000 members of the other group crashed; the fast round stalls and
   ``run_until_decision(64, 16, classic_fallback_after_rounds=8)`` must
   decide the crashed set through the classic round, with the record the
   JAX package gives for it (``CLASSIC_RECORD``);
8. the port on the card against the port on the CPU at 1000 members, every
   state field and record: both branches under both FD policies, the
   classic fallback, and bridged extern votes.

Prints a JSON line of kernel results, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result.
"""

import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_NODES = 100_000
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# non-tensor-core float32 peak of the H100 SXM (NVIDIA data sheet), the
# closest published rate for these integer and boolean operations
PEAK_OPS_PER_S = 67e12
KERNEL_SIZES = (100_000, 1_000_000)
TIMED_RUNS = 5
# bytes each edge must move: four bool inputs + counter in, counter + two
# bools out. The fused phase at the headline (random loss on, gray off,
# K=10): subjects, observers and the draw (4 B each), probe_drop, fd_fail,
# alerted and down_reports in, fd_fail, alerted and down_arrivals out (1 B
# each), plus per node active, alive and drop_prob in and alive out (7 B,
# 0.7 B per edge); fd_bench.fused_bytes counts the other variants, among
# them the windowed policy's 27 + 0.7 B (fd_fail's 2 B swapped for the int32
# fd_hist and the uint8 fd_seen, in and out).
BYTES_PER_EDGE = {"fd_phase_i32": 5 + 4 + 5, "fd_phase_u8": 5 + 1 + 2,
                  "fd_phase_fused": 19 + 7 / 10}
# operations per edge: 2 ANDs and a NOT for the failure, the counter test
# and add, the threshold compare, 2 ANDs and a NOT for new_down, the OR. The
# fused phase adds the node flag tests, the draw compare, the gray path's
# tests and the gather's OR and AND.
# The windowed policy: the node flag tests and the draw compare, the shift,
# OR and mask of the window, the count's add, compare and clamp, the
# population count and the two compares that fire, new_down, the latch and
# the gather's OR and AND.
OPS_PER_EDGE = {"fd_phase_i32": 10, "fd_phase_u8": 10, "fd_phase_fused": 24,
                "fd_phase_fused_windowed": 26}
# (gray_confirm, rounds_per_interval, random loss): the headline variant
# first, the only one timed
FUSED_VARIANTS = ((0, 1, True), (3, 4, True), (0, 4, False))
# (window W, threshold fraction, rounds_per_interval, random loss): the
# windowed scan's variant first, the only one timed
WINDOW_CASES = tuple(itertools.product((10, 16), (0.4, 0.7), (1, 4), (True, False)))
WINDOWED_RUNS = 3
# the classic fallback scenario: a blind delivery group of CLASSIC_BLIND
# members (the last slots) and CLASSIC_CRASHED crashed members of the other
# group, drawn with numpy from CLASSIC_SEED, which also seeds the simulator.
# With seed 10 the first recovery attempt's coordinator (slot 76160) sits in
# the blind group and collects no promise; the second attempt is a race of
# three coordinators in the other group (slots 42606, 42104, 44042), which
# the highest rank wins.
CLASSIC_SEED = 10
CLASSIC_BLIND = 26_000
CLASSIC_CRASHED = 1_000
# the JAX package's record for that scenario at 100k members (its Simulator
# beside the port's on the CPU, one run, equal in cut, configuration id,
# virtual time and members): cut = the crashed set, decided at round 48 (the
# third batch) plus the exchange's four hops, plus the batching window
CLASSIC_RECORD = {"virtual_time_ms": 52_100, "configuration_id": 4651904502688146028,
                  "membership_size": 99_000, "via_classic_round": True}


def _time_ms(fn, reps=24, iters=11):
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
    with torch.cuda.graph(graph):
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


def _kernel_phase(kernels, device):
    """Each kernel against its plain version, bit for bit, and timed."""
    results = {}
    for name, dtype, hi in (("fd_phase_i32", np.int32, 12), ("fd_phase_u8", np.uint8, 256)):
        plain = getattr(kernels, name.replace("fd_phase", "fd_phase_plain"))
        kernel = getattr(kernels, name)
        sizes = {}
        for c in KERNEL_SIZES:
            rng = np.random.default_rng(c)
            args = [
                torch.from_numpy(a).to(device) for a in (
                    rng.random((c, 10)) < 0.99,
                    rng.random((c, 10)) < 0.98,
                    rng.random((c, 10)) < 0.9,
                    rng.integers(0, hi, size=(c, 10)).astype(dtype),
                    rng.random((c, 10)) < 0.05,
                )
            ]
            got = kernel(*args, 10)
            want = plain(*args, 10)
            torch.cuda.synchronize()
            err = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want)
            )
            assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), (
                f"{name} at [{c}, 10] disagrees with its plain version"
            )
            kernel_ms = _time_ms(lambda: kernel(*args, 10))
            plain_ms = _time_ms(lambda: plain(*args, 10))
            bytes_ms = BYTES_PER_EDGE[name] * c * 10 / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_EDGE[name] * c * 10 / PEAK_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            sizes[f"{c}x10"] = {
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            }
            print(f"kernel {name} [{c}, 10]: bit-identical to plain (tolerance 0), "
                  f"kernel {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us", flush=True)
        results[name] = sizes
    return results


def _unfused_sequence(kernels, args, subj, obs, threshold):
    """The scan-round FD phase that ``fd_phase_fused`` replaces, after the
    draw: plain ops around ``fd_phase_u8``, then the destination gather
    (random loss on, gray off, one round per interval). ``subj``/``obs`` are
    int64 copies of the adjacency, made once per dispatch."""
    (active, alive, drop_prob, _, _, probe_drop, down_reports, draw, fd_fail,
     alerted) = args[:10]
    c, k = subj.shape
    alive = alive & active
    edge_live = active[:, None] & active[subj]
    probe_ok = alive[subj] & ~probe_drop & ~(draw < drop_prob[subj])
    observer_up = alive[:, None].expand(c, k).contiguous()
    fd, alerted, new_down = kernels.fd_phase_u8(
        edge_live, observer_up, probe_ok, fd_fail, alerted, threshold)
    down = (new_down.gather(0, obs) | down_reports) & active[:, None]
    return alive, fd, alerted, down


def _fused_phase(kernels, fd_bench, device):
    """``fd_phase_fused`` against its plain version, bit for bit, in each
    variant, then the headline variant timed cold and hot beside its plain
    version and the unfused sequence, in a round with alerts and in a quiet
    one."""
    results = {}
    for c in KERNEL_SIZES:
        worst = 0
        for gray, rpi, random in FUSED_VARIANTS:
            args = fd_bench.fused_case(c, c + gray + rpi, device, random)
            kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi)
            # the six planes of the cumulative policy (no window planes)
            got = kernels.fd_phase_fused(*args, **kw)[:6]
            want = kernels.fd_phase_fused_plain(*args, **kw)[:6]
            torch.cuda.synchronize()
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                      for g, w in zip(got, want))
            assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), (
                f"fd_phase_fused at [{c}, 10], gray {gray}, rpi {rpi}, random {random} "
                f"disagrees with its plain version")
            assert (got[2] & ~args[9]).any(), "the case should raise alerts"
            worst = max(worst, err)
            print(f"kernel fd_phase_fused [{c}, 10] gray {gray} rpi {rpi} random {random}: "
                  f"bit-identical to plain (tolerance 0)", flush=True)

        gray, rpi, random = FUSED_VARIANTS[0]
        kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi)
        # cold: rotate more input sets than the L2 holds (their int64 copies
        # for the unfused sequence on top)
        sets = fd_bench.cold_sets(c, random, device)
        quiet = fd_bench.quiet(sets)
        wide = [(a[3].long(), a[4].long()) for a in sets]
        for case in (sets[0], quiet[0]):
            want = kernels.fd_phase_fused_plain(*case, **kw)[:6]
            got = kernels.fd_phase_fused(*case, **kw)[:6]
            assert all(torch.equal(g, w) for g, w in zip(got, want)), "timed case disagrees"
            got = _unfused_sequence(kernels, case, *wide[0], 10)
            assert all(torch.equal(g, want[i]) for g, i in zip(got, (0, 1, 2, 5))), (
                "the unfused sequence disagrees with the fused plain version")
        assert not (want[2] & ~quiet[0][9]).any(), "the quiet round raised an alert"

        def fused(a):
            return lambda: kernels.fd_phase_fused(*a, **kw)

        def plain(a):
            return lambda: kernels.fd_phase_fused_plain(*a, **kw)

        def unfused(a, w):
            return lambda: _unfused_sequence(kernels, a, *w, 10)

        t = {}
        for label, cases in (("", sets), ("quiet_", quiet)):
            t[f"{label}cold_ms"] = _time_ms([fused(a) for a in cases])
            t[f"{label}hot_ms"] = _time_ms(fused(cases[0]))
            t[f"{label}unfused_cold_ms"] = _time_ms(
                [unfused(a, w) for a, w in zip(cases, wide)])
            t[f"{label}unfused_hot_ms"] = _time_ms(unfused(cases[0], wide[0]))
            t[f"{label}plain_cold_ms"] = _time_ms([plain(a) for a in cases])
            t[f"{label}plain_hot_ms"] = _time_ms(plain(cases[0]))
        nbytes = fd_bench.fused_bytes(c, 10, gray, random)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        quiet_bound_ms = (fd_bench.fused_bytes(c, 10, gray, random, alerts=False)
                          / HBM_BYTES_PER_S * 1e3)
        ops_ms = OPS_PER_EDGE["fd_phase_fused"] * c * 10 / PEAK_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        results[f"{c}x10"] = dict(
            t, max_abs_err=worst, ms=t["cold_ms"], plain_ms=t["plain_cold_ms"],
            bound_ms=bound_ms, bound_us=bound_ms * 1e3,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes_per_edge=nbytes / (c * 10), input_sets=len(sets),
            share_of_bound=bound_ms / t["cold_ms"], quiet_bound_ms=quiet_bound_ms,
            quiet_share_of_bound=quiet_bound_ms / t["quiet_cold_ms"],
        )
        print(f"kernel fd_phase_fused [{c}, 10] timed: "
              + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in t.items())
              + f"; bound {bound_ms * 1e3:.2f} us ({nbytes / (c * 10):.2f} B/edge), "
              f"quiet bound {quiet_bound_ms * 1e3:.2f} us, {len(sets)} input sets for cold",
              flush=True)
        del sets, quiet, wide
        torch.cuda.empty_cache()
    return results


def _window_kw(engine, c, w, frac, rpi):
    """The windowed policy's kernel arguments; t from the engine's own
    float64 rounding (``engine.window_params``)."""
    config = engine.SimConfig(capacity=c, fd_policy="windowed", fd_window=w,
                              fd_window_threshold=frac, rounds_per_interval=rpi)
    w, fire, _ = engine.window_params(config)
    return dict(threshold=10, rounds_per_interval=rpi, window=w, window_fire=fire)


def _windowed_phase(kernels, fd_bench, engine, device):
    """``fd_phase_fused`` windowed against its plain version, bit for bit, in
    every case of WINDOW_CASES, from partly filled windows; then the windowed
    scan's variant timed cold and hot beside its plain version, in a round
    with alerts and in a quiet one (no window full)."""
    results = {}
    for c in KERNEL_SIZES:
        worst = 0
        for w, frac, rpi, random in WINDOW_CASES:
            args = fd_bench.fused_case(c, c + w + rpi, device, random)
            hist, seen = fd_bench.window_planes(c, w, c + 2 * w + rpi, device)
            kw = dict(_window_kw(engine, c, w, frac, rpi), fd_hist=hist, fd_seen=seen)
            got = kernels.fd_phase_fused(*args, **kw)
            want = kernels.fd_phase_fused_plain(*args, **kw)
            torch.cuda.synchronize()
            err = max(int((g.to(torch.int64) - x.to(torch.int64)).abs().max())
                      for g, x in zip(got, want))
            assert err == 0 and all(torch.equal(g, x) for g, x in zip(got, want)), (
                f"windowed fd_phase_fused at [{c}, 10], W {w}, threshold {frac}, rpi {rpi}, "
                f"random {random} disagrees with its plain version")
            assert (got[2] & ~args[9]).any(), "the case should raise alerts"
            assert got[1] is args[8], "the windowed policy must leave fd_fail as it came"
            worst = max(worst, err)
            print(f"kernel fd_phase_fused windowed [{c}, 10] W {w} threshold {frac} "
                  f"(t {kw['window_fire']}) rpi {rpi} random {random}: bit-identical to "
                  f"plain (tolerance 0)", flush=True)

        w, frac, rpi, random = WINDOW_CASES[0]
        base = _window_kw(engine, c, w, frac, rpi)
        sets = fd_bench.cold_sets(c, random, device)
        planes = [fd_bench.window_planes(c, w, 9000 + i, device) for i in range(len(sets))]
        # a quiet round: no window full, so no edge can cross
        quiet = [(h, torch.zeros_like(n)) for h, n in planes]
        for case, (h, n) in ((sets[0], planes[0]), (sets[0], quiet[0])):
            want = kernels.fd_phase_fused_plain(*case, fd_hist=h, fd_seen=n, **base)
            got = kernels.fd_phase_fused(*case, fd_hist=h, fd_seen=n, **base)
            assert all(torch.equal(g, x) for g, x in zip(got, want)), "timed case disagrees"
        assert not (want[2] & ~sets[0][9]).any(), "the quiet round raised an alert"

        def call(fn, a, plane):
            return lambda: fn(*a, fd_hist=plane[0], fd_seen=plane[1], **base)

        t = {}
        for label, pl in (("", planes), ("quiet_", quiet)):
            for name, fn in (("", kernels.fd_phase_fused), ("plain_", kernels.fd_phase_fused_plain)):
                t[f"{label}{name}cold_ms"] = _time_ms([call(fn, a, p) for a, p in zip(sets, pl)])
                t[f"{label}{name}hot_ms"] = _time_ms(call(fn, sets[0], pl[0]))
        nbytes = fd_bench.fused_bytes(c, 10, False, random, window=True)
        quiet_bytes = fd_bench.fused_bytes(c, 10, False, random, alerts=False, window=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_EDGE["fd_phase_fused_windowed"] * c * 10 / PEAK_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        quiet_bound_ms = quiet_bytes / HBM_BYTES_PER_S * 1e3
        results[f"{c}x10"] = dict(
            t, max_abs_err=worst, ms=t["cold_ms"], plain_ms=t["plain_cold_ms"],
            bound_ms=bound_ms, bound_us=bound_ms * 1e3,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes_per_edge=nbytes / (c * 10), input_sets=len(sets),
            share_of_bound=bound_ms / t["cold_ms"], quiet_bound_ms=quiet_bound_ms,
            quiet_share_of_bound=quiet_bound_ms / t["quiet_cold_ms"],
        )
        print(f"kernel fd_phase_fused windowed [{c}, 10] timed (W {w}, t {base['window_fire']}, "
              f"random loss): " + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in t.items())
              + f"; bound {bound_ms * 1e3:.2f} us ({nbytes / (c * 10):.2f} B/edge), share "
              f"{bound_ms / t['cold_ms']:.0%} cold; quiet bound {quiet_bound_ms * 1e3:.2f} us, "
              f"share {quiet_bound_ms / t['quiet_cold_ms']:.0%}; {len(sets)} input sets for cold",
              flush=True)
        del sets, planes, quiet
        torch.cuda.empty_cache()
    return results


def _decide(sim, victims, fault):
    fault(victims)
    t0 = time.perf_counter()
    rec = sim.run_until_decision(max_rounds=16, batch=16)
    sim.ready()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    assert rec is not None, "no decision reached"
    assert sorted(rec.cut.tolist()) == sorted(victims.tolist()), "cut != victims"
    assert rec.membership_size == N_NODES - len(victims)
    assert rec.virtual_time_ms == 11_100, rec.virtual_time_ms
    return rec, wall_ms


def classic_scenario(Simulator, SimConfig, device, n=N_NODES, blind=CLASSIC_BLIND,
                     crashed=CLASSIC_CRASHED, seed=CLASSIC_SEED):
    """A stalled fast round (tests/test_classic_paxos_sim.py at any width):
    the last ``blind`` members form a delivery group that hears no
    broadcast, so it never votes, and live voters stay below the fast
    quorum; ``crashed`` members of the other group are the cut. Returns the
    simulator and the crashed set."""
    sim = Simulator(n, config=SimConfig(capacity=n, groups=2), seed=seed, device=device)
    group_of = np.zeros(n, dtype=np.int32)
    group_of[n - blind:] = 1
    sim.set_delivery_groups(group_of)
    victims = np.sort(np.random.default_rng(seed).choice(n - blind, crashed, replace=False))
    sim.crash(victims)
    sim.drop_broadcasts(1, np.arange(n))
    return sim, victims


def _count_syncs(fn, out=None):
    """Synchronizing CUDA calls made by ``fn`` (torch's sync debug mode:
    device->host fetches and blocking host->device copies); ``fn``'s result
    is appended to ``out`` when given."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if out is not None:
        out.append(result)
    return sum("synchronizing" in str(w.message) for w in caught)


def _windowed_decisions(Simulator, engine, kernels, rng, device):
    """100k members under the windowed policy, 1% faulted: crashed (the
    closed form, no kernel) and under ingress loss 1.0 (the scan, the
    windowed kernel every round). Counts are reset just before each decision
    and read just after."""
    config = engine.SimConfig(capacity=N_NODES, fd_policy="windowed")
    n_fail = N_NODES // 100
    out = {}
    for name in ("crash", "ingress_loss"):
        walls = []
        for i in range(WINDOWED_RUNS):
            sim = Simulator(N_NODES, config=config, seed=SEED + 7000 + i, device=device).ready()
            fault = sim.crash if name == "crash" else (
                lambda v, sim=sim: sim.ingress_loss(v, 1.0))
            victims = rng.choice(N_NODES, n_fail, replace=False)
            kernels.reset_launches()
            rec, ms = _decide(sim, victims, fault)
            launches = dict(kernels.LAUNCHES)
            walls.append(ms)
            # the scan executes its whole budget (16 rounds, masked after the
            # decision), one launch a round; the closed form launches nothing
            want = {key: 0 for key in launches}
            if name == "ingress_loss":
                want["fd_phase_fused_windowed"] = 16
            assert launches == want, (name, launches)
        out[name] = {"walls_ms": walls, "launches": launches}
        print(f"windowed decision ({'closed form, crash' if name == 'crash' else 'scan, ingress loss 1.0'}): "
              f"{N_NODES} members, {n_fail} faulted, cut ok, virtual {rec.virtual_time_ms} ms, "
              f"walls {[round(w, 3) for w in walls]} ms (the first on a fresh process state), "
              f"kernel launches {launches}", flush=True)
    return out


def _classic_fallback(Simulator, engine, classic, kernels, device):
    """The classic fallback at 100k members (CLASSIC_* above): the fast round
    stalls, the fallback decides. Times each coordinator phase (each ends in
    its one fetch, so the host clock covers the device work) and counts the
    synchronizing calls of each exchange."""
    sim, victims = classic_scenario(Simulator, engine.SimConfig, device)
    sim.ready()
    phases, exchanges = [], []
    coordinator = classic.ClassicCoordinator
    originals = {name: getattr(coordinator, name) for name in ("phase1", "phase2")}

    def timed(name, fn):
        def run(self, *args):
            t0 = time.perf_counter()
            result = fn(self, *args)
            phases.append((name, self.slot, (time.perf_counter() - t0) * 1e3, result))
            return result
        return run

    run_exchange = sim._run_classic_round

    def counted_exchange():
        out = []
        t0 = time.perf_counter()
        syncs = _count_syncs(run_exchange, out)
        exchanges.append({"syncs": syncs, "ms": (time.perf_counter() - t0) * 1e3,
                          "result": out[0]})
        return out[0]

    sim._run_classic_round = counted_exchange
    for name, fn in originals.items():
        setattr(coordinator, name, timed(name, fn))
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        rec = sim.run_until_decision(max_rounds=64, batch=16, classic_fallback_after_rounds=8)
        sim.ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(coordinator, name, fn)
    launches = dict(kernels.LAUNCHES)
    assert rec is not None and rec.via_classic_round, "no decision through the classic round"
    assert rec.cut.tolist() == victims.tolist(), "cut != crashed set"
    got = {key: getattr(rec, key) for key in CLASSIC_RECORD}
    assert got == CLASSIC_RECORD, (got, CLASSIC_RECORD)
    assert [e["result"][0] for e in exchanges] == [None, 0], exchanges
    print(f"classic fallback: {N_NODES} members, blind group {CLASSIC_BLIND}, "
          f"{CLASSIC_CRASHED} crashed; decided via the classic round, cut ok, "
          f"{rec.membership_size} members, virtual {rec.virtual_time_ms} ms, configuration id "
          f"{rec.configuration_id} (the JAX package's); wall {wall_ms:.3f} ms; exchanges "
          f"(attempt: syncs, ms): {[(i + 1, e['syncs'], round(e['ms'], 3)) for i, e in enumerate(exchanges)]}; "
          f"phases (phase, coordinator slot, ms, result): "
          f"{[(p, s, round(ms, 3), r) for p, s, ms, r in phases]}; kernel launches {launches}",
          flush=True)
    return {"wall_ms": wall_ms, "exchanges": [{k: v for k, v in e.items() if k != "result"}
                                              for e in exchanges],
            "phases": [(p, s, ms) for p, s, ms, _ in phases], "launches": launches}


def _extern_votes(Simulator, SimConfig, device):
    """A stalled fast round (a blind group of 260) that 20 bridged votes of
    blind members, registered as extern votes for the crashed pair, carry
    past the quorum: the extern row pools with group 0's proposal."""
    sim, victims = classic_scenario(Simulator, lambda **kw: SimConfig(extern_proposals=2, **kw),
                                    device, n=1000, blind=260, crashed=2, seed=SEED)
    assert sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=None) is None

    def register():
        for slot in range(1000 - 260, 1000 - 240):
            sim.set_auto_vote(slot, False)
            assert sim.register_extern_vote(slot, victims)
        assert not sim.register_extern_vote(1000 - 260, victims)  # one vote a sender

    # before any classic round the registrations read nothing back and upload
    # without blocking: no synchronizing call on the card
    syncs = _count_syncs(register) if torch.device(device).type == "cuda" else register()
    assert not syncs, f"extern vote registration made {syncs} synchronizing calls"
    rec = sim.run_until_decision(max_rounds=8, classic_fallback_after_rounds=None)
    return sim, rec, victims


def _cross_check(Simulator, engine, device):
    """The port on the card against the port on the CPU at 1000 members."""
    windowed = engine.SimConfig(capacity=1000, fd_policy="windowed")

    def plain(fault, config=None):
        def run(dev):
            sim = Simulator(1000, config=config, seed=SEED, device=dev)
            fault(sim)
            return sim, sim.run_until_decision(max_rounds=16, batch=16)
        return run

    def classic(dev):
        sim, _ = classic_scenario(Simulator, engine.SimConfig, dev, n=1000, blind=260,
                                  crashed=10)
        return sim, sim.run_until_decision(max_rounds=64, batch=16,
                                           classic_fallback_after_rounds=8)

    def extern(dev):
        sim, rec, _ = _extern_votes(Simulator, engine.SimConfig, dev)
        return sim, rec

    scenarios = {
        "crash": plain(lambda s: s.crash(np.arange(0, 1000, 97))),
        "ingress_loss_1.0": plain(lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0)),
        "windowed_crash": plain(lambda s: s.crash(np.arange(0, 1000, 97)), windowed),
        "windowed_ingress_loss_1.0": plain(
            lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0), windowed),
        "classic_fallback": classic,
        "extern_votes": extern,
    }
    for name, run in scenarios.items():
        outs = []
        for dev in ("cpu", device):
            sim, rec = run(dev)
            assert rec is not None, f"cross-check {name}: no decision on {dev}"
            outs.append(((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms,
                          rec.via_classic_round), engine.state_to_numpy(sim.state)))
        assert outs[0][0] == outs[1][0], f"cross-check {name}: records differ"
        for field, value in outs[0][1].items():
            assert np.array_equal(outs[1][1][field], value), f"cross-check {name}: {field}"
        assert outs[0][0][3] == (name == "classic_fallback"), name
        print(f"cross-check {name}: card == cpu at 1000 members (cut {len(outs[0][0][0])} "
              f"members, virtual {outs[0][0][2]} ms)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch.sim import classic, engine, fd_bench, kernels
    from rapid_tpu_torch.sim.driver import Simulator

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs.values())})", flush=True)

    kernel_results = _kernel_phase(kernels, device)
    kernel_results["fd_phase_fused"] = _fused_phase(kernels, fd_bench, device)
    kernel_results["fd_phase_fused_windowed"] = _windowed_phase(kernels, fd_bench, engine, device)

    # --- headline: closed-form branch --------------------------------------
    rng = np.random.default_rng(SEED)
    n_fail = N_NODES // 100

    def timed(fault_name, seed):
        """Warmed decision walls over TIMED_RUNS fresh simulators; kernel
        launch counts from the last run (reset just before it)."""
        walls = []
        for i in range(TIMED_RUNS):
            sim = Simulator(N_NODES, seed=seed + i, device=device).ready()
            fault = sim.crash if fault_name == "crash" else (
                lambda v, sim=sim: sim.ingress_loss(v, 1.0))
            victims = rng.choice(N_NODES, n_fail, replace=False)
            kernels.reset_launches()
            rec, ms = _decide(sim, victims, fault)
            launches = dict(kernels.LAUNCHES)
            walls.append(ms)
        return rec, walls, launches

    warm = Simulator(N_NODES, seed=SEED, device=device)
    _, warm_ms = _decide(warm, rng.choice(N_NODES, n_fail, replace=False), warm.crash)
    rec, head_walls, headline_launches = timed("crash", SEED + 4444)
    counted = Simulator(N_NODES, seed=SEED + 1, device=device).ready()
    counted.crash(rng.choice(N_NODES, n_fail, replace=False))
    syncs = _count_syncs(lambda: counted.run_until_decision(max_rounds=16, batch=16))
    print(f"headline (closed form): {N_NODES} members, {n_fail} crashed, cut ok, "
          f"virtual {rec.virtual_time_ms} ms, warmed wall median "
          f"{statistics.median(head_walls):.3f} ms max {max(head_walls):.3f} ms over "
          f"{TIMED_RUNS} runs {[round(w, 3) for w in head_walls]} (first run "
          f"{warm_ms:.3f} ms), kernel launches {headline_launches}, "
          f"synchronizing CUDA calls per decision: {syncs}", flush=True)

    # --- scan path: random ingress loss, FD phase in the CUDA kernel --------
    counted = Simulator(N_NODES, seed=SEED + 2, device=device).ready()
    counted.ingress_loss(rng.choice(N_NODES, n_fail, replace=False), 1.0)
    scan_syncs = _count_syncs(lambda: counted.run_until_decision(max_rounds=16, batch=16))
    rec, scan_walls, scan_launches = timed("ingress_loss", SEED + 5555)
    assert scan_launches["fd_phase_fused"] >= 11, scan_launches
    assert scan_launches["fd_phase_u8"] == 0, scan_launches
    assert scan_launches["fd_phase_fused_windowed"] == 0, scan_launches
    # a decision syncs once per dispatch for the decision words; host uploads
    # are queued from pinned memory and do not block. At most 6 in the closed
    # form and 7 on the scan path, the counts when uploads blocked.
    assert syncs <= 6 and scan_syncs <= 7, (syncs, scan_syncs)
    print(f"scan path (ingress loss 1.0): cut ok, virtual {rec.virtual_time_ms} ms, "
          f"warmed wall median {statistics.median(scan_walls):.3f} ms max "
          f"{max(scan_walls):.3f} ms over {TIMED_RUNS} runs "
          f"{[round(w, 3) for w in scan_walls]}, kernel launches {scan_launches}, "
          f"synchronizing CUDA calls per decision: {scan_syncs}", flush=True)

    # --- the windowed policy's decisions, and the classic fallback ----------
    windowed = _windowed_decisions(Simulator, engine, kernels, rng, device)
    fallback = _classic_fallback(Simulator, engine, classic, kernels, device)

    _cross_check(Simulator, engine, device)

    # each kernel's launches are those of its own path's run: the scan path
    # (ingress loss 1.0) under the policy the kernel serves
    path_launches = dict(scan_launches)
    path_launches["fd_phase_fused_windowed"] = (
        windowed["ingress_loss"]["launches"]["fd_phase_fused_windowed"])
    line = {"kernels": []}
    for name, sizes in kernel_results.items():
        main_shape = sizes[f"{KERNEL_SIZES[0]}x10"]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "rapid_tpu_torch/csrc/" + (
                "fd_phase_fused.cu" if name.startswith("fd_phase_fused") else "fd_phase.cu"),
            "replaces": "rapid_tpu/sim/pallas_kernels.py:54",
            "on_main_path": name == "fd_phase_fused",
            "path": ("windowed scan (ingress loss 1.0)" if name == "fd_phase_fused_windowed"
                     else "scan (ingress loss 1.0)"),
            "launches": path_launches[name],
            "launches_headline": headline_launches[name],
            "match": True,
            "max_abs_err": max(s["max_abs_err"] for s in sizes.values()),
            "ms": main_shape["ms"],
            "kernel_ms": main_shape["ms"],
            "hot_ms": main_shape.get("hot_ms", main_shape["ms"]),
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_us": main_shape["bound_us"],
            "bound_by": main_shape["bound_by"],
            "tolerance": 0,
            "library_ms": None,  # no single PyTorch call computes this fused phase
            "sizes": sizes,
        })
    print(json.dumps(line))
    print(json.dumps({"headline_wall_ms": head_walls, "scan_wall_ms": scan_walls,
                      "headline_syncs": syncs, "scan_syncs": scan_syncs,
                      "windowed": windowed, "classic_fallback": fallback, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
