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
   classic fallback, and bridged extern votes;
9. the multi-device round loop (``rapid_tpu_torch/shard/engine.py``), every
   shard on this one card: one ``fd_phase_rows`` call over every shard's
   rows, the exchange into one bitset and ``fd_gather``, against
   ``fd_phase_fused_plain`` over the whole array and each kernel against its
   plain version, bit for bit, at [100_000, 10] over 4 and 8 shards and
   [1_000_000, 10] over 8, under the cumulative, gray and windowed policies,
   random loss on and off, and halted; the split timed cold beside
   ``fd_phase_fused``: the per-device call, one shard alone and one call a
   shard; then the headline fault through ``Simulator(mesh=...)`` on meshes
   of 4 and 8 shards and a (2, 2) ("dcn", "ici") mesh, each deciding the
   crashed set at 11 100 ms virtual with the single-device configuration
   id, one sync per dispatch and one ``fd_phase_rows`` and one
   ``fd_gather`` launch a round, beside the single-device closed form and
   scan path of the same fault;
10. telemetry, speculation, profiling: the headline decision and a crash
   under ingress loss 1.0 (the scan) with ``speculate`` on and off in
   alternating pairs (asked for explicitly: the default leaves it off on
   the card; identical records, speculation hits only when on, one sync
   either way), walls and the host view change beside each other; the
   speculation worker alone, and a decision of each branch with metrics,
   tracer, speculation and profiling on, inside ``jitwatch.timed_window``
   (sync debug mode "error": they must raise and record nothing, and both
   speculation hits must land) and every sync counted in the same decision
   audited by ``jitwatch``; ``enable_profiling`` on the
   scan path sampling every dispatch (four phases above 0, ``fd_phase_fused``
   launched by each prefix); the GPU ops of one step and of its prefixes;
   and ``observability.device_trace`` around one decision, whose Chrome
   trace must name ``fd_phase_fused``;
11. the simulator bridge (``rapid_tpu_torch/sim/bridge.py``), run first after
   the build: ``TpuSimMessaging`` at 100k virtual members on the port's
   default protocol, ``warm_compile`` timed, and a scripted real member
   (``ScriptedMember`` over ``ScriptNetwork``, both defined here) that joins
   (one full configuration of 100 001 endpoints), votes in a crash of 1% in
   the closed form (that pump inside a ``jitwatch`` timed window) and in one
   under ingress loss 1.0 (the scan, launching ``fd_phase_fused``), leaves,
   and joins and votes in the crash again on a mesh of 4 shards on the card
   (``fd_phase_rows`` and ``fd_gather``); each decision's configuration id
   equal to a plain simulator's driven alike, each pump's wall split into
   dispatch, bridge host work and delivery, with its syncs by label and its
   kernel launches (``bridge_sequence``);
12. the wire: the port's codec (``rapid_tpu_torch/messaging/codec.py`` on
   its pure-Python MessagePack subset, no C library in the process) gives
   every frame of ``tests/golden/torch_wire_frames.json``, which
   ``rapid_tpu``'s codec wrote, byte for byte and decodes each back to an
   equal message; each frame class's encode and decode time, and a
   100k-member ``JoinResponse``'s and a 75 001-sender vote batch's
   (``wire_phase``);
13. the socket gateway (``rapid_tpu_torch/messaging/gateway.py``), after the
   bridge phase: ``SwarmGateway`` at 100k virtual members on the card,
   ``warm()`` timed, and a real member in a child OS process
   (``chip_smoke.py --gateway-member``, the ``ScriptedMember`` on the port's
   TCP transport, routed client and swarm broadcaster) that joins over TCP
   (one full configuration of 100 001 endpoints), votes in a crash of 1% run
   on the gateway's protocol thread (the closed form) and in one under
   ingress loss 1.0 (the scan, launching ``fd_phase_fused``), and leaves;
   every configuration id equal on the gateway, in the member's own view and
   on a plain simulator driven alike, and every sync of the protocol thread
   accounted for by a ``jitwatch`` label (``gateway_sequence``).

Prints a JSON line of kernel results, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result.
"""

import collections
import itertools
import json
import os
import queue
import socket
import statistics
import subprocess
import sys
import threading
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
# the split of the fused phase: the rows take all but the gather's OR and
# AND, plus the bit a slot packs; the gather its OR and AND and the shard
# lookup (a shift, a multiply-high and a shift, a multiply and a subtract)
OPS_PER_EDGE.update({"fd_phase_rows": 23, "fd_phase_rows_windowed": 25, "fd_gather": 7})
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
# the phase split around the mesh's alert exchange, checked at (C, shards)
SPLIT_CASES = ((100_000, 4), (100_000, 8), (1_000_000, 8))
SPLIT_TIMED_SHARDS = 8  # the timed split: [100_000, 10] over 8 shards
# the meshes of the sharded decisions, every shard on the one card:
# (label, make_mesh keywords, shards)
MESHES = (("4 shards", {"n_devices": 4}, 4), ("8 shards", {"n_devices": 8}, 8),
          ("(2, 2) dcn x ici", {"shape": (2, 2)}, 4))
SHARDED_RUNS = 3  # decisions timed on each mesh, the first warming it
SHARD_SEED = SEED + 8000
SPEC_PAIRS = 3  # speculate on/off pairs of decisions timed per branch
PLANES_SEED = SEED + 9000
# the gateway phase: tests/test_gateway.py's GatewayHarness settings, the
# member's identity of the bridge phase, a bound on every wait
GATEWAY_SETTINGS = {"failure_detector_interval_ms": 100, "batching_window_ms": 50,
                    "consensus_fallback_base_delay_ms": 1000}
GATEWAY_PUMP_MS = 50
MEMBER_NODE_ID = (0x1234_5678_9ABC, -0x0FED_CBA9_8765)
GATEWAY_WAIT_S = 180.0
LARGE_FRAME = 64 * 1024  # frames listed one by one: (class, bytes, encode or decode ms)
WIRE_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "torch_wire_frames.json")


def _time_ms(fn, reps=24, iters=11):
    """Device time of one call of ``fn`` (``fd_bench.graph_ms``): ``reps``
    calls captured in a CUDA graph, the replay timed with CUDA events, median
    over ``iters`` replays divided by ``reps``; ``fn`` may be a list of calls,
    taken in turn (to rotate input sets)."""
    from rapid_tpu_torch.sim.fd_bench import graph_ms

    return graph_ms(fn, reps, iters)


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
    is appended to ``out`` when given. Only the mode's per-call warning
    counts, not its one-time notice that the mode is a prototype."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if out is not None:
        out.append(result)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


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


def _split_kw(engine, fd_bench, policy, c, seed, device):
    """``fd_phase_rows``' policy keywords: the cumulative counter, the gray
    path with 4 rounds per interval, or the window (W 10, 40%) from partly
    filled windows."""
    if policy == "cumulative":
        return dict(threshold=10)
    if policy == "gray":
        return dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=4)
    hist, seen = fd_bench.window_planes(c, 10, seed, device)
    return dict(_window_kw(engine, c, 10, 0.4, 1), fd_hist=hist, fd_seen=seen)


def _max_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want) if w is not None)


def _split_round(kernels, calls, bits, args, rows, halt):
    """One round of the sharded FD phase: the ``fd_phase_rows`` calls of
    ``calls`` into the segments of ``bits`` (one call over every shard, as a
    device that holds them all makes it, or one call a shard), then
    ``fd_gather`` on home."""
    for a, kw in calls:
        kernels.fd_phase_rows(*a, **kw, halt=halt)
    return kernels.fd_gather(args[0], args[4], args[6], bits, rows)


def _assert_halted(kernels, fd_bench, args, kw, shards, halt, where):
    """The per-device call halted: every plane as it came in, every segment
    zero, and equal to its plain version halted."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    merged, merged_kw = fd_bench.device_call(calls)
    got = kernels.fd_phase_rows(*merged, **merged_kw, halt=halt)
    plain_calls, plain_bits = fd_bench.split_case(args, kw, shards)
    plain_merged, plain_kw = fd_bench.device_call(plain_calls)
    plain = kernels.fd_phase_rows_plain(*plain_merged, **plain_kw, halt=halt)
    torch.cuda.synchronize()
    assert torch.equal(bits, plain_bits) and not bits.any(), f"halted bitset not zero at {where}"
    for (a, a_kw), g, p in zip(calls, got, plain):
        planes_in = (a[6], a[7], a[8], a[9], a_kw["fd_hist"], a_kw["fd_seen"])
        for i, x, y in zip(planes_in, g, p):
            assert (i is None and x is None and y is None) or (
                torch.equal(x, i) and torch.equal(y, i)), f"a halted plane moved at {where}"


def _split_phase(kernels, fd_bench, engine, device):
    """The per-device ``fd_phase_rows`` over every shard, the exchange into
    one bitset and ``fd_gather``, against ``fd_phase_fused_plain`` over the
    whole array and each kernel against its plain version, bit for bit, in
    every case of SPLIT_CASES x {cumulative, gray, windowed} x {random loss,
    none}, and halted (every plane as it came in, no bit) with random loss;
    then at [100_000, 10] over 8 shards, timed cold (input sets rotated past
    the L2): the per-device call, one shard's call alone, and 8 one-shard
    calls, each round with ``fd_gather``, beside
    ``fd_phase_fused`` on the same inputs."""
    worst = {"fd_phase_rows": 0, "fd_phase_rows_windowed": 0, "fd_gather": 0}
    running = torch.zeros((), dtype=torch.bool, device=device)
    halted = torch.ones((), dtype=torch.bool, device=device)
    for c, shards in SPLIT_CASES:
        for policy in ("cumulative", "gray", "windowed"):
            for random in (True, False):
                args = fd_bench.fused_case(c, c + shards + len(policy), device, random)
                kw = _split_kw(engine, fd_bench, policy, c, c + shards, device)
                calls, bits = fd_bench.split_case(args, kw, shards)
                got = fd_bench.run_split(calls, bits, args, halt=running)
                plain_calls, plain_bits = fd_bench.split_case(args, kw, shards)
                plain = fd_bench.run_split(plain_calls, plain_bits, args, kernel=False,
                                           halt=running)
                fused = kernels.fd_phase_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                where = f"[{c}, 10] over {shards} shards, {policy}, random {random}"
                for i, name in enumerate(("alive", "fd_fail", "alerted", "fd_streak", "fd_ok",
                                          "down_arrivals", "fd_hist", "fd_seen")):
                    if i == 0 or fused[i] is None:
                        continue
                    assert torch.equal(got[i], fused[i]), f"split {name} != fused plain at {where}"
                    assert torch.equal(got[i], plain[i]), f"split {name} != its plain at {where}"
                assert torch.equal(bits, plain_bits), f"bitset != plain at {where}"
                assert (got[2] & ~args[9]).any(), "the case should raise alerts"
                rows_err = max(_max_err(got[1:5] + got[6:], plain[1:5] + plain[6:]),
                               _max_err([bits], [plain_bits]))
                rows_name = "fd_phase_rows_windowed" if policy == "windowed" else "fd_phase_rows"
                worst[rows_name] = max(worst[rows_name], rows_err)
                worst["fd_gather"] = max(worst["fd_gather"], _max_err([got[5]], [plain[5]]))
                print(f"split {where}: one fd_phase_rows call over {shards} shards + exchange "
                      f"+ fd_gather bit-identical to fd_phase_fused_plain and to their plain "
                      f"versions (tolerance 0)", flush=True)
                if random:
                    _assert_halted(kernels, fd_bench, args, kw, shards, halted, where)
                    print(f"split {where}, halted: every plane as it came in, no bit, "
                          f"bit-identical to the plain version (tolerance 0)", flush=True)
                del args, calls, bits, plain_calls, plain_bits, got, plain, fused
        torch.cuda.empty_cache()

    c, shards = KERNEL_SIZES[0], SPLIT_TIMED_SHARDS
    rows = c // shards
    sets = fd_bench.cold_sets(c, True, device)
    timed = {}
    for policy in ("cumulative", "windowed"):
        kws = [_split_kw(engine, fd_bench, policy, c, 9000 + i, device) for i in range(len(sets))]
        cases = [fd_bench.split_case(a, kw, shards) for a, kw in zip(sets, kws)]
        merged = [fd_bench.device_call(calls) for calls, _ in cases]
        for a, (calls, bits) in zip(sets, cases):
            # the bitsets of a round with alerts; one call a shard gives the same
            one_by_one = fd_bench.run_split(calls, bits, a, per_device=False, halt=running)
            per_shard_bits = bits.clone()
            together = fd_bench.run_split(calls, bits, a, halt=running)
            torch.cuda.synchronize()
            assert torch.equal(bits, per_shard_bits) and all(
                (x is None and y is None) or torch.equal(x, y)
                for x, y in zip(one_by_one[1:], together[1:])), "one call a shard disagrees"
        every_shard = [(a, kw) for calls, _ in cases for a, kw in calls]
        name = "fd_phase_rows_windowed" if policy == "windowed" else "fd_phase_rows"

        def device_call(m, fn=kernels.fd_phase_rows):
            return lambda: fn(*m[0], **m[1], halt=running)

        def shard_call(a, kw, fn=kernels.fd_phase_rows):
            return lambda: fn(*a, **kw, halt=running)

        def shard_calls(calls):
            return lambda: [kernels.fd_phase_rows(*a, **kw, halt=running) for a, kw in calls]

        def round_(a, calls, bits):
            return lambda: _split_round(kernels, calls, bits, a, rows, running)

        # cold: every set in turn, more than the L2 holds
        t = {"ms": _time_ms([device_call(m) for m in merged]),
             "hot_ms": _time_ms(device_call(merged[0])),
             "plain_ms": _time_ms([device_call(m, kernels.fd_phase_rows_plain) for m in merged]),
             "one_shard_ms": _time_ms([shard_call(a, kw) for a, kw in every_shard],
                                      reps=len(every_shard)),
             "per_shard_calls_ms": _time_ms([shard_calls(calls) for calls, _ in cases]),
             "round_ms": _time_ms([round_(a, [m], bits)
                                   for a, m, (_, bits) in zip(sets, merged, cases)]),
             "per_shard_round_ms": _time_ms([round_(a, calls, bits)
                                             for a, (calls, bits) in zip(sets, cases)]),
             "fused_ms": _time_ms([lambda a=a, kw=kw: kernels.fd_phase_fused(*a, **kw)
                                   for a, kw in zip(sets, kws)])}
        windowed = policy == "windowed"
        nbytes = fd_bench.rows_bytes(c, rows, 10, False, True, window=windowed, shards=shards)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_EDGE[name] * c * 10 / PEAK_OPS_PER_S * 1e3
        one_bytes_ms = (fd_bench.rows_bytes(c, rows, 10, False, True, window=windowed)
                        / HBM_BYTES_PER_S * 1e3)
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 one_shard_bound_ms=max(one_bytes_ms, ops_ms / shards),
                 max_abs_err=worst[name], shape=[c, 10], shards=shards)
        timed[name] = t
        if policy == "cumulative":
            gather = {"ms": _time_ms([lambda a=a, b=b: kernels.fd_gather(a[0], a[4], a[6], b, rows)
                                      for a, (_, b) in zip(sets, cases)]),
                      "plain_ms": _time_ms([lambda a=a, b=b: kernels.fd_gather_plain(
                          a[0], a[4], a[6], b, rows) for a, (_, b) in zip(sets, cases)])}
            nbytes = fd_bench.gather_bytes(c, shards, 10)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_EDGE["fd_gather"] * c * 10 / PEAK_OPS_PER_S * 1e3
            gather.update(bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=worst["fd_gather"], shape=[c, 10], shards=shards)
            timed["fd_gather"] = gather
        print(f"split timed, {policy}, [{c}, 10] over {shards} shards, random loss, cold over "
              f"{len(sets)} input sets: fd_phase_rows over all {shards} shards in one call "
              f"{t['ms'] * 1e3:.2f} us (hot {t['hot_ms'] * 1e3:.2f}, plain "
              f"{t['plain_ms'] * 1e3:.2f}, bound {t['bound_ms'] * 1e3:.2f}); one shard alone "
              f"{t['one_shard_ms'] * 1e3:.2f} us (bound {t['one_shard_bound_ms'] * 1e3:.2f}); "
              f"{shards} one-shard calls {t['per_shard_calls_ms'] * 1e3:.2f} us; a whole round "
              f"(+ fd_gather) {t['round_ms'] * 1e3:.2f} us, with {shards} one-shard calls "
              f"{t['per_shard_round_ms'] * 1e3:.2f} us, against fd_phase_fused "
              f"{t['fused_ms'] * 1e3:.2f} us", flush=True)
        del cases, merged, every_shard, kws
    g = timed["fd_gather"]
    print(f"split timed: fd_gather over {shards} segments {g['ms'] * 1e3:.2f} us (plain "
          f"{g['plain_ms'] * 1e3:.2f}, bound {g['bound_ms'] * 1e3:.2f})", flush=True)
    del sets
    torch.cuda.empty_cache()
    return timed


def _record(rec):
    return (rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms, rec.membership_size)


def _planes_fault(sim, branch):
    """The fault of a branch: a crash (closed form), or a crash under
    ingress loss 1.0 on the same members (the scan, whose random loss has no
    closed form). Speculation predicts crashed and leaving members, so both
    give it a prediction."""
    if branch == "closed form":
        return sim.crash

    def crash_and_loss(victims):
        sim.crash(victims)
        sim.ingress_loss(victims, 1.0)
    return crash_and_loss


def _speculation_pairs(Simulator, rng, device):
    """Each branch's decision with ``speculate`` on and off on the same
    fresh members and victims, SPEC_PAIRS alternating pairs (on-off,
    off-on, ...): identical records, hits only when on, the decision's wall
    and its host view change (``_apply_view_change``, whose device work runs
    on after it returns) side by side, and the syncs of one decision each
    way."""
    out = {}
    for branch in ("closed form", "scan"):
        rows = {True: [], False: []}
        for i in range(SPEC_PAIRS):
            victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
            records = {}
            for speculate in ((True, False) if i % 2 == 0 else (False, True)):
                sim = Simulator(N_NODES, seed=PLANES_SEED + i, speculate=speculate,
                                device=device).ready()
                view_ms = []
                apply = sim._apply_view_change

                def timed_apply(*args, apply=apply, view_ms=view_ms):
                    t0 = time.perf_counter()
                    rec = apply(*args)
                    view_ms.append((time.perf_counter() - t0) * 1e3)
                    return rec

                sim._apply_view_change = timed_apply
                _planes_fault(sim, branch)(victims)
                t0 = time.perf_counter()
                rec = sim.run_until_decision(max_rounds=16, batch=16)
                sim.ready()
                wall = (time.perf_counter() - t0) * 1e3
                assert rec is not None and sorted(rec.cut.tolist()) == sorted(victims.tolist())
                hits = (sim.metrics.get("speculation_hits_config_id"),
                        sim.metrics.get("speculation_hits_fresh_state"))
                assert (hits == (1, 1)) if speculate else (hits == (0, 0)), (branch, hits)
                records[speculate] = _record(rec)
                rows[speculate].append({"wall_ms": wall, "view_change_ms": view_ms[0]})
            assert records[True] == records[False], (branch, records)
        syncs = {}
        for speculate in (True, False):
            sim = Simulator(N_NODES, seed=PLANES_SEED + 99, speculate=speculate,
                            device=device).ready()
            _planes_fault(sim, branch)(rng.choice(N_NODES, N_NODES // 100, replace=False))
            syncs[speculate] = _count_syncs(
                lambda: sim.run_until_decision(max_rounds=16, batch=16))
        assert syncs == {True: 1, False: 1}, (branch, syncs)
        out[branch] = {"on": rows[True], "off": rows[False], "syncs": syncs}
        print(f"speculation, {branch}: {SPEC_PAIRS} alternating pairs on the same members and "
              f"victims, records identical, hits (config id, fresh state) 1 and 1 when on, 0 "
              f"when off; walls on {[round(r['wall_ms'], 3) for r in rows[True]]} ms, off "
              f"{[round(r['wall_ms'], 3) for r in rows[False]]} ms; host view change on "
              f"{[round(r['view_change_ms'], 3) for r in rows[True]]} ms, off "
              f"{[round(r['view_change_ms'], 3) for r in rows[False]]} ms; syncs per decision "
              f"on {syncs[True]}, off {syncs[False]}", flush=True)
    return out


def _everything_on(Simulator, observability, ProfilingSettings, seed, device):
    sim = Simulator(N_NODES, seed=seed, speculate=True, metrics=observability.Metrics(),
                    tracer=observability.Tracer(plane="sim", track="sim"), device=device).ready()
    return sim, sim.enable_profiling(ProfilingSettings(enabled=True))


def _timed_windows(Simulator, observability, jitwatch, ProfilingSettings, rng, device):
    """A decision of each branch with speculation, metrics, tracer and
    profiling (1 dispatch in 16 sampled) on, inside ``jitwatch.timed_window``
    (sync debug mode "error"): nothing may raise, no violation is recorded,
    and both speculation hits land. The speculation worker alone inside a
    timed window, with no audited seam lifting the mode while it runs. The
    same decision on a twin simulator counted under "warn": every counted
    sync is audited. Then a second decision on the twin, whose dispatch is
    not sampled."""
    out = {}
    for branch in ("closed form", "scan"):
        victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
        solo = Simulator(N_NODES, seed=PLANES_SEED + 51, speculate=True, device=device).ready()
        _planes_fault(solo, branch)(victims)
        with jitwatch.timed_window(f"{branch} speculation worker"):
            solo._speculate_view_change().join()
        assert solo._spec is not None and not jitwatch.violations(), jitwatch.violations()

        sim, prof = _everything_on(Simulator, observability, ProfilingSettings,
                                   PLANES_SEED + 50, device)
        _planes_fault(sim, branch)(victims)
        before = jitwatch.sync_counts()
        with jitwatch.timed_window(f"{branch} decision"):
            rec = sim.run_until_decision(max_rounds=16, batch=16)
        audited = _diff(jitwatch.sync_counts(), before)
        hits = (sim.metrics.get("speculation_hits_config_id"),
                sim.metrics.get("speculation_hits_fresh_state"))
        assert rec is not None and prof.samples == 1 and hits == (1, 1), (prof.samples, hits)
        assert not jitwatch.violations(), jitwatch.violations()

        twin, twin_prof = _everything_on(Simulator, observability, ProfilingSettings,
                                         PLANES_SEED + 50, device)
        _planes_fault(twin, branch)(victims)
        before = jitwatch.sync_counts()
        counted = _count_syncs(lambda: twin.run_until_decision(max_rounds=16, batch=16))
        twin_audited = _diff(jitwatch.sync_counts(), before)
        # an explicit device synchronize (a drain) may escape the debug mode;
        # what it counts must be audited either way
        drains = sum(v for k, v in audited.items() if k != "sim.decision_words")
        assert twin_audited == audited and counted in (
            audited["sim.decision_words"], audited["sim.decision_words"] + drains), (
            branch, counted, audited, twin_audited)
        _planes_fault(twin, branch)(rng.choice(twin.members(), 10, replace=False))
        before = jitwatch.sync_counts()
        unsampled = _count_syncs(lambda: twin.run_until_decision(max_rounds=16, batch=16))
        unsampled_audited = _diff(jitwatch.sync_counts(), before)
        assert twin_prof.samples == 1 and unsampled == 1 and unsampled_audited == {
            "sim.decision_words": 1}, (unsampled, unsampled_audited)
        out[branch] = {"audited": audited, "counted": counted, "unsampled_syncs": unsampled,
                       "metrics": sim.metrics.snapshot()}
        print(f"timed window, {branch}: the speculation worker alone and a decision with "
              f"speculation (hits {hits}), metrics, tracer and profiling on, sync "
              f"debug mode error, nothing raised, no violation; syncs in the sampled decision counted "
              f"{counted}, audited {audited}; in the next, unsampled decision counted "
              f"{unsampled}, audited {unsampled_audited}; counters {sim.metrics.snapshot()}",
              flush=True)
    return out


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _profiling(Simulator, engine, kernels, ProfilingSettings, rng, device):
    """``enable_profiling`` sampling every dispatch on the 100k scan path:
    samples, the four phases, and the prefixes' own ``fd_phase_fused``
    launches; then the GPU ops of one step and of each prefix on the
    simulator's state (``profile_decision.profile_gpu``)."""
    from rapid_tpu_torch.profiling.phases import _copy
    from rapid_tpu_torch.sim.profile_decision import profile_gpu

    sim = Simulator(N_NODES, seed=PLANES_SEED + 70, device=device).ready()
    prof = sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    _planes_fault(sim, "scan")(rng.choice(N_NODES, N_NODES // 100, replace=False))
    inputs = sim._const_inputs(None)
    state, generator = sim.state, _copy(sim._generator)
    ops = {name: profile_gpu(lambda fn=fn: fn(sim.config, state, inputs, True,
                                              _copy(generator)))["kernels"]
           for name, fn in (("step", engine.step), ("step_cut_detector", engine.step_cut_detector),
                            ("step_fd_scan", engine.step_fd_scan))}
    kernels.reset_launches()
    rec = sim.run_until_decision(max_rounds=16, batch=16)
    sim.ready()
    launches = dict(kernels.LAUNCHES)
    totals = prof.attribution()
    assert rec is not None and prof.samples >= 1, prof.samples
    assert all(totals[p] > 0 for p in ("fd_scan", "cut_detector", "consensus_count",
                                       "host_transfer")), totals
    assert launches["fd_phase_fused"] == 16 + 3 * prof.samples, launches
    per_sample = {p: totals[p] / prof.samples for p in ("fd_scan", "cut_detector",
                                                        "consensus_count")}
    print(f"profiling, scan path, every dispatch sampled: {prof.samples} sample(s), phase ms a "
          f"sample {({p: round(v, 3) for p, v in per_sample.items()})}, host transfer "
          f"{totals['host_transfer']:.3f} ms over {sim.metrics.get('device_dispatches')} "
          f"dispatch(es); fd_phase_fused launches {launches['fd_phase_fused']} (16 in the "
          f"dispatch + 3 a sample, one a prefix); GPU ops of one round: {ops}", flush=True)
    return {"samples": prof.samples, "attribution": totals, "per_sample": per_sample,
            "launches": launches, "gpu_ops": ops}


def _device_trace(Simulator, observability, rng, device):
    """``observability.device_trace`` around one scan-path decision: the
    Chrome trace must name ``fd_phase_fused``."""
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace")
    sim = Simulator(N_NODES, seed=PLANES_SEED + 80, device=device).ready()
    _planes_fault(sim, "scan")(rng.choice(N_NODES, N_NODES // 100, replace=False))
    with observability.device_trace(trace_dir):
        rec = sim.run_until_decision(max_rounds=16, batch=16)
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = sum(e.get("name") == "fd_phase_fused" for e in events)
    passes = sum(e.get("cat") == "kernel" and "observer_pass" in e.get("name", "")
                 for e in events)
    assert rec is not None and ranges >= 16, (ranges, passes)
    print(f"device trace: {len(events)} events in {trace_dir}/trace.json, {ranges} "
          f"fd_phase_fused ranges, {passes} observer_pass kernels", flush=True)
    return {"events": len(events), "fd_phase_fused_ranges": ranges}


def _profile(fn):
    """``profile_decision.profile_gpu`` with the device µs of the FD passes:
    ``rows_us`` (the node pass and the observer pass, ``rows_pass`` in
    ``fd_phase_rows``, ``observer_pass`` in ``fd_phase_fused``) and
    ``gather_us``."""
    from rapid_tpu_torch.sim.profile_decision import profile_gpu

    prof = profile_gpu(fn, ("node_pass", "observer_pass", "rows_pass", "gather_pass"))
    prof["rows_us"] = (prof.pop("node_pass_us") + prof.pop("observer_pass_us")
                       + prof.pop("rows_pass_us"))
    prof["gather_us"] = prof.pop("gather_pass_us")
    return prof


def _sharded_decisions(Simulator, engine, shard, kernels, rng, device):
    """The headline fault (100k members, 1% crashed, ``run_until_decision(16,
    16)``) through ``Simulator(mesh=...)`` on each mesh of MESHES, every shard
    on this card, beside the single-device closed form and scan path (ingress
    loss 1.0) of the same members; and the windowed policy on 4 shards.
    Counts are reset just before each decision and read just after."""
    victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
    card = torch.device(device.type, torch.cuda.current_device())

    def fresh(**kw):
        return Simulator(N_NODES, seed=SHARD_SEED, **kw).ready()

    def decide(sim, fault="crash"):
        kernels.reset_launches()
        rec, ms = _decide(sim, victims, sim.crash if fault == "crash" else
                          (lambda v: sim.ingress_loss(v, 1.0)))
        return rec, ms, dict(kernels.LAUNCHES)

    out = {"single": {}}
    for branch, fault in (("closed form", "crash"), ("scan", "ingress_loss")):
        rec, ms, launches = decide(fresh(device=device), fault)
        sim = fresh(device=device)
        (sim.crash if fault == "crash" else (lambda v: sim.ingress_loss(v, 1.0)))(victims)
        prof = _profile(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        out["single"][branch] = {"wall_ms": ms, "launches": launches, **prof}
        if branch == "closed form":
            reference_id = rec.configuration_id
        else:
            # the scan dispatch alone, to set the mesh dispatch's copies beside
            sim = fresh(device=device)
            sim.ingress_loss(victims, 1.0)
            inputs = sim._const_inputs(None)
            sim.ready()
            scan_dispatch = _profile(lambda: engine.run_rounds_const(
                sim.config, sim.state, inputs, 16, True, sim._generator))
            out["single"][branch]["dispatch"] = scan_dispatch
        print(f"single device, {branch}: cut ok, virtual {rec.virtual_time_ms} ms, wall "
              f"{ms:.3f} ms, GPU ops {prof['kernels']}, device busy "
              f"{prof['device_busy_ms']:.3f} ms, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    for label, spec, size in MESHES:
        mesh = shard.make_mesh(devices=[card] * size, **spec)
        assert set(mesh.device_list) == {card} and mesh.size == size
        walls = []
        for _ in range(SHARDED_RUNS):
            rec, ms, launches = decide(fresh(mesh=mesh))
            walls.append(ms)
            assert rec.configuration_id == reference_id, (label, rec.configuration_id)
            want = {name: 0 for name in launches}
            # one fd_phase_rows call a round covers every shard of the card
            want.update(fd_phase_rows=16, fd_gather=16)
            assert launches == want, (label, launches)
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        syncs = _count_syncs(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        assert syncs == 1, f"{label}: {syncs} synchronizing calls in one dispatch"
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        prof = _profile(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        # the dispatch alone (the 16 rounds, no upload, no view change): its
        # copies beyond the single-device scan dispatch's are the exchange's
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        inputs = sim._const_inputs(None)
        sim.ready()
        dispatch = _profile(lambda: sim._sharded_run_until(False)(
            sim.state, inputs, 16, sim._generators))
        words = kernels.segment_words(N_NODES // size, 10)
        out[label] = {"walls_ms": walls, "launches": launches, "syncs": syncs, **prof,
                      "dispatch": dispatch, "exchange_bytes_per_round": size * words * 4,
                      "exchange_copies_per_round":
                          (dispatch["copies"] - scan_dispatch["copies"]) / 16,
                      "split_us_per_round": (dispatch["rows_us"] + dispatch["gather_us"]) / 16}
        print(f"sharded decision, {label} ({mesh}): {N_NODES} members, "
              f"{len(victims)} crashed, cut ok, {rec.membership_size} members, virtual "
              f"{rec.virtual_time_ms} ms, configuration id {rec.configuration_id} (the "
              f"single-device one), walls {[round(w, 3) for w in walls]} ms (the first "
              f"warms the mesh), syncs per dispatch {syncs}, launches "
              f"{ {k: v for k, v in launches.items() if v} }; profiled decision: GPU ops "
              f"{prof['kernels']}, device busy {prof['device_busy_ms']:.3f} ms, idle "
              f"{prof['idle_share']:.1%}, copies {prof['copies']} (uploads, the view "
              f"change's placement); the dispatch alone: GPU ops {dispatch['kernels']}, "
              f"copies a round {dispatch['copies'] / 16:g} ({dispatch['copy_us'] / 16:.2f} us) "
              f"against {scan_dispatch['copies'] / 16:g} in the single-device scan dispatch; "
              f"exchange {size * words * 4} B a round into home's bitset with "
              f"{(dispatch['copies'] - scan_dispatch['copies']) / 16:g} copies a round; "
              f"split device us a round: rows {dispatch['rows_us'] / 16:.2f}, gather "
              f"{dispatch['gather_us'] / 16:.2f}", flush=True)

    config = engine.SimConfig(capacity=N_NODES, fd_policy="windowed")
    mesh = shard.make_mesh(devices=[card] * 4)
    rec, ms, launches = decide(fresh(mesh=mesh, config=config))
    want = {name: 0 for name in launches}
    want.update(fd_phase_rows_windowed=16, fd_gather=16)
    assert launches == want, launches
    out["windowed 4 shards"] = {"wall_ms": ms, "launches": launches}
    print(f"sharded decision, windowed, 4 shards: cut ok, virtual {rec.virtual_time_ms} ms, "
          f"wall {ms:.3f} ms (first on this config), launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return out


class ScriptNetwork:
    """The smallest network the bridge runs on: the bridge as the one
    multi-endpoint handler, scripted members by address, and a queue that
    ``scheduler.run_for`` drains, with what each delivery sends in turn.
    ``dst=None`` is the wildcard broadcast (``handle_broadcast``)."""

    def __init__(self, protocol):
        self.protocol = protocol
        self.scheduler = self
        self.handlers = []
        self.members = {}
        self.queue = collections.deque()
        self.deliver_s = 0.0  # host time spent delivering

    def attach_handler(self, handler):
        self.handlers.append(handler)

    def is_listening(self, address):
        return address in self.members

    def deliver(self, src, dst, msg, timeout_ms):
        promise = self.protocol.Promise()
        self.queue.append((src, dst, msg, promise))
        return promise

    def run_for(self, ms):
        t0 = time.perf_counter()
        response = self.protocol.Response()
        while self.queue:
            src, dst, msg, promise = self.queue.popleft()
            if dst in self.members:
                self.members[dst].receive(src, msg)
                promise.set_result(response)
                continue
            (handler,) = self.handlers
            reply = handler.handle_broadcast(msg) if dst is None else handler.handle(dst, msg)
            reply.add_callback(lambda r, p=promise: p.set_exception(r.exception())
                               if r.exception() is not None else p.set_result(r.peek()))
        self.deliver_s += time.perf_counter() - t0


class ScriptedMember:
    """A real member scripted after ``Cluster``: the two-phase join (one
    JoinMessage per distinct expected observer, with its ring numbers), a
    fast-round vote for each announced proposal (alerts on all K rings,
    stamped with the configuration they were raised in), the view change
    applied from a decision's alert batch and vote batch, and a graceful
    leave. It keeps the member list it learns."""

    def __init__(self, network, endpoint, node_id, k):
        self.net, self.endpoint, self.node_id, self.k = network, endpoint, node_id, k
        self.p = network.protocol
        network.members[endpoint] = self
        self.view = None  # endpoints of the configuration, once admitted
        self.join_replies = []
        self.announcements, self.votes, self.decisions = [], [], []
        self.registered = []  # (slot, taken) of each vote the swarm registered
        self._decision_alerts = None

    def send(self, dst, msg):
        promise = self.net.deliver(self.endpoint, dst, msg, 5000)
        self.net.run_for(0)
        return promise

    def join(self, seed_endpoint):
        p = self.p
        reply = self.send(seed_endpoint, p.PreJoinMessage(self.endpoint, self.node_id)).result(60)
        assert reply.status_code == p.JoinStatusCode.SAFE_TO_JOIN, reply.status_code
        rings = {}
        for ring, observer in enumerate(reply.endpoints):
            rings.setdefault(observer, []).append(ring)
        for observer, numbers in rings.items():
            self.send(observer, p.JoinMessage(self.endpoint, self.node_id, tuple(numbers),
                                              reply.configuration_id)
                      ).add_callback(lambda r: self.join_replies.append(r.peek()))
        return len(rings)

    def admitted(self):
        """The join's one full configuration (the siblings answer
        CONFIG_CHANGED), adopted as the member list."""
        full = [r for r in self.join_replies if r.status_code == self.p.JoinStatusCode.SAFE_TO_JOIN]
        assert len(full) == 1 and all(
            r.status_code == self.p.JoinStatusCode.CONFIG_CHANGED
            for r in self.join_replies if r is not full[0]), self.join_replies
        self.view = set(full[0].endpoints)
        assert len(self.view) == len(full[0].endpoints)
        return full[0]

    def leave(self):
        self.send(None, self.p.LeaveMessage(self.endpoint))

    def receive(self, src, msg):
        from rapid_tpu_torch.hashing import address_comparator_key

        p = self.p
        if isinstance(msg, p.BatchedAlertMessage):
            if all(len(a.ring_numbers) == self.k for a in msg.messages):
                # an announced proposal: vote for its cut
                cut = tuple(sorted((a.edge_dst for a in msg.messages), key=address_comparator_key))
                self.announcements.append(msg)
                vote = p.FastRoundPhase2bMessage(self.endpoint, msg.messages[0].configuration_id,
                                                 cut)
                self.votes.append(vote)
                self.net.deliver(self.endpoint, None, vote, 5000)
            else:
                self._decision_alerts = msg
        elif isinstance(msg, p.FastRoundVoteBatch):
            alerts = self._decision_alerts.messages
            assert {a.edge_dst for a in alerts} == set(msg.endpoints), "alerts != voted cut"
            quorum = len(self.view) - (len(self.view) - 1) // 4
            assert len(set(msg.senders)) >= quorum, (len(msg.senders), quorum)
            self.decisions.append((self._decision_alerts, msg, quorum))
            for a in alerts:
                (self.view.add if a.edge_status == p.EdgeStatus.UP else self.view.discard)(
                    a.edge_dst)
            if self.endpoint not in self.view:
                del self.net.members[self.endpoint]  # removed: the member shuts down


def bridge_sequence(n, device, mesh_devices, seed=SEED):
    """The bridge phase: ``TpuSimMessaging(ScriptNetwork, n)`` on the port's
    default protocol, ``warm_compile`` timed, then a scripted member's join,
    a crash of 1% of the virtual members (the closed form, this pump inside
    a ``jitwatch`` timed window), a crash of 1% more under ingress loss 1.0
    (the scan), its leave, and the join and first crash again on a bridge
    over ``make_mesh(devices=mesh_devices)``. Each pump's wall is split into
    the simulator's dispatches, delivery and the bridge's host work, with its
    syncs by label and kernel launches. After each decision the swarm's
    configuration id must equal that of a plain ``Simulator`` driven through
    the same identity, joins, crashes and leave with no bridge, and the
    member's list the swarm's members."""
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.shard.engine import make_mesh
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.bridge import TpuSimMessaging, default_protocol
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig

    protocol = default_protocol()
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 10_000)
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    node_id = protocol.NodeId(0x1234_5678_9ABC, -0x0FED_CBA9_8765)
    member_ep = protocol.Endpoint.from_parts("10.77.0.1", 7000)
    pumps = []

    def new_bridge(mesh=None):
        net = ScriptNetwork(protocol)
        bridge = TpuSimMessaging(net, n, seed=seed, mesh=mesh,
                                 device=None if mesh is not None else device)
        member = ScriptedMember(net, member_ep, node_id, bridge.sim.config.k)
        sim = bridge.sim
        timers = [0.0, 0.0]  # the simulator's dispatches, the full configuration's build
        run, register = sim.run_until_decision, sim.register_extern_vote
        full_config = bridge._full_config_response

        def timed(fn, i):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    timers[i] += time.perf_counter() - t0
            return call

        def counted_register(slot, cut):
            ok = register(slot, cut)
            member.registered.append((slot, ok))
            return ok

        sim.run_until_decision, sim.register_extern_vote = timed(run, 0), counted_register
        bridge._full_config_response = timed(full_config, 1)
        return net, bridge, member, timers

    def pump(name, net, bridge, member, timers, window=False):
        sim = bridge.sim
        n_before = sim.membership_size
        kernels.reset_launches()
        before, timers[:], net.deliver_s = jitwatch.sync_counts(), [0.0, 0.0], 0.0
        out = []
        t0 = time.perf_counter()
        if window:
            with jitwatch.timed_window(f"bridged pump, {name}"):
                out.append(bridge.pump())
            counted = None
        elif on_card:
            counted = _count_syncs(bridge.pump, out)
        else:
            out.append(bridge.pump())
            counted = None
        pump_s = time.perf_counter() - t0
        in_pump_delivery = net.deliver_s
        net.run_for(0)  # the decision's packets to the member
        rec = out[0]
        assert rec is not None, f"bridged {name}: no decision"
        row = {"name": name, "wall_ms": (pump_s + net.deliver_s - in_pump_delivery) * 1e3,
               "dispatch_ms": timers[0] * 1e3, "delivery_ms": net.deliver_s * 1e3,
               "host_ms": (pump_s - timers[0] - in_pump_delivery) * 1e3,
               "full_configuration_ms": timers[1] * 1e3,
               "syncs": _diff(jitwatch.sync_counts(), before), "counted_syncs": counted,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "cut": rec.cut.tolist(), "members_before": n_before,
               "configuration_id": rec.configuration_id,
               "virtual_time_ms": rec.virtual_time_ms}
        if member.view is not None:
            assert member.view == {bridge.endpoint(int(s)) for s in sim.members()}, name
        pumps.append(row)
        return rec, row

    def expect_vote_and_decision(name, bridge, member, cut_slots, n_before):
        """The member got the announced proposal, voted it, the bridge took
        the vote, and the decision reached it as one alert batch and one vote
        batch naming exactly the cut, with at least the quorum of senders."""
        slot = bridge._slot_of[member_ep]
        cut = {bridge.endpoint(int(s)) for s in cut_slots}
        assert len(member.announcements) == 1 and len(member.votes) == 1, name
        assert set(member.votes[0].endpoints) == cut, name
        assert member.registered == [(slot, True)], (name, member.registered)
        assert len(member.decisions) == 1, name
        alerts, votes, quorum = member.decisions[0]
        assert {a.edge_dst for a in alerts.messages} == set(votes.endpoints) == cut, name
        assert quorum == n_before - (n_before - 1) // 4 and len(votes.senders) >= quorum, name
        member.announcements, member.votes, member.decisions, member.registered = [], [], [], []
        return {"vote_registered": True, "alert_batch": len(alerts.messages),
                "vote_senders": len(votes.senders), "quorum": quorum}

    net, bridge, member, timers = new_bridge()
    sim = bridge.sim
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    bridge.warm_compile()
    warm_ms = (time.perf_counter() - t0) * 1e3
    twin_bytes = (torch.cuda.max_memory_allocated() - resident) if on_card else None

    observers = member.join(bridge.endpoint(0))
    rec, row = pump("join", net, bridge, member, timers)
    full = member.admitted()
    assert rec.added.tolist() == [bridge._slot_of[member_ep]] and len(full.endpoints) == n + 1
    assert full.configuration_id == sim.configuration_id() == rec.configuration_id
    row.update(full_configuration=len(full.endpoints), distinct_observers=observers)
    assert row["full_configuration_ms"] > 0

    sim.crash(victims[0])
    rec, row = pump("crash, closed form", net, bridge, member, timers, window=True)
    assert rec.cut.tolist() == victims[0].tolist()
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[0], n + 1))

    sim.crash(victims[1])
    sim.ingress_loss(victims[1], 1.0)
    rec, row = pump("crash, scan", net, bridge, member, timers)
    assert rec.cut.tolist() == victims[1].tolist()
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[1],
                                        n + 1 - len(victims[0])))
    if on_card:
        assert row["launches"].get("fd_phase_fused", 0) > 0, row["launches"]

    before = rec.virtual_time_ms
    slot = bridge._slot_of[member_ep]
    member.leave()
    rec, row = pump("leave", net, bridge, member, timers)
    assert rec.cut.tolist() == [slot] and member_ep not in net.members
    assert member_ep not in bridge._real and slot in bridge._free_slots
    row["decided_in_ms"] = rec.virtual_time_ms - before
    assert row["decided_in_ms"] == 2 * sim.config.fd_interval_ms + sim.config.batching_window_ms

    del net, bridge, member, sim
    mesh = make_mesh(devices=mesh_devices)
    net, bridge, member, timers = new_bridge(mesh)
    member.join(bridge.endpoint(0))
    pump("mesh join", net, bridge, member, timers)
    member.admitted()
    bridge.sim.crash(victims[0])
    rec, row = pump("mesh crash", net, bridge, member, timers)
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[0], n + 1))
    if on_card:
        assert row["launches"].get("fd_phase_rows", 0) > 0, row["launches"]
        assert row["launches"].get("fd_gather", 0) > 0, row["launches"]
    del net, bridge, member

    # the cross-check: a plain simulator driven alike, with no bridge
    capacity = -(-(n + 16) // mesh.size) * mesh.size
    plain = Simulator(n, capacity=capacity, config=SimConfig(capacity=capacity, extern_proposals=4),
                      seed=seed, device=device)
    plain.assign_identity(n, member_ep.hostname, member_ep.port, node_id.high, node_id.low)
    steps = (lambda: plain.request_joins(np.array([n])),
             lambda: plain.crash(victims[0]),
             lambda: (plain.crash(victims[1]), plain.ingress_loss(victims[1], 1.0)),
             lambda: plain.leave(np.array([n])))
    ids = []
    for step in steps:
        step()
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        assert prec is not None
        ids.append(prec.configuration_id)
    for row, want in zip(pumps, ids + ids[:2]):
        row["plain_configuration_id"] = want
        assert row["configuration_id"] == want, (row["name"], row["configuration_id"], want)
    for row in pumps:
        print(f"bridged pump, {row['name']}: {row['members_before']} members, cut "
              f"{len(row['cut'])}, configuration id {row['configuration_id']} (== the plain "
              f"simulator's), virtual {row['virtual_time_ms']} ms; wall {row['wall_ms']:.3f} ms "
              f"= dispatch {row['dispatch_ms']:.3f} + bridge host {row['host_ms']:.3f} + "
              f"delivery {row['delivery_ms']:.3f}; syncs by label {row['syncs']}"
              + ("" if row["counted_syncs"] is None else
                 f" (debug mode counted {row['counted_syncs']})")
              + f"; kernel launches {row['launches']}"
              + "".join(f"; {k} {row[k]}" for k in (
                  "full_configuration", "full_configuration_ms", "distinct_observers",
                  "vote_registered", "alert_batch",
                  "vote_senders", "quorum", "decided_in_ms") if row.get(k)), flush=True)
    steady = [row["wall_ms"] for row in pumps[1:4]]
    print(f"bridge warm_compile: {warm_ms:.3f} ms"
          + ("" if twin_bytes is None else f" (peak {twin_bytes / 2**20:.1f} MiB above the "
             "swarm's own state: the twin simulator and its decisions)")
          + f"; first pump after it {pumps[0]['wall_ms']:.3f} ms, median of the next three "
          f"{statistics.median(steady):.3f} ms", flush=True)
    return {"protocol": protocol.Endpoint.__module__, "warm_compile_ms": warm_ms,
            "twin_peak_bytes": twin_bytes, "first_pump_ms": pumps[0]["wall_ms"],
            "steady_median_ms": statistics.median(steady), "pumps": pumps}



def view_configuration_id(endpoints, identifiers) -> int:
    """The configuration id a member computes from its own view
    (MembershipView.java:535-547): identifiers in NodeId order, endpoints in
    ring-0 order, with the port's vectorized hashing."""
    from rapid_tpu_torch.hashing import endpoint_hash_batch
    from rapid_tpu_torch.sim.topology import configuration_id_vectorized

    eps = list(endpoints)
    width = max(len(e.hostname) for e in eps)
    hosts = np.frombuffer(b"".join(e.hostname.ljust(width, b"\0") for e in eps),
                          dtype=np.uint8).reshape(len(eps), width)
    lengths = np.array([len(e.hostname) for e in eps], dtype=np.int64)
    ports = np.array([e.port for e in eps], dtype=np.int64)
    order = np.argsort(endpoint_hash_batch(hosts, lengths, ports, 0).view(np.int64),
                       kind="stable")
    ids = sorted(identifiers)
    return configuration_id_vectorized(
        np.array([i.high for i in ids], dtype=np.int64),
        np.array([i.low for i in ids], dtype=np.int64), hosts[order], lengths[order],
        ports[order])


class GatewayMemberNet:
    """``ScriptedMember``'s network over the port's wire: sends ride the
    member's ``GatewayRoutedClient`` to the gateway, a broadcast (``dst``
    None) its ``GatewaySwarmBroadcaster``'s one wildcard frame."""

    def __init__(self, protocol, routed, broadcaster):
        self.protocol, self.routed, self.broadcaster = protocol, routed, broadcaster
        self.members = {}

    def deliver(self, src, dst, msg, timeout_ms):
        if dst is None:
            (promise,) = self.broadcaster.broadcast(msg)
            return promise
        return self.routed.send_message(dst, msg)

    def run_for(self, ms):
        pass  # the sockets run on their own threads


def gateway_member(gateway_address: str, port: int) -> int:
    """``chip_smoke.py --gateway-member <host:port> <port>``: a real member
    in its own OS process that speaks only through the port's wire. Its
    ``TcpClientServer`` listens at 127.0.0.1:<port> with ``ScriptedMember``
    as its membership service; a ``GatewayRoutedClient`` and a
    ``GatewaySwarmBroadcaster`` carry its sends. It reads commands on its
    standard input (``join <seed> <k>``, ``leave``, ``quit``) and prints one
    JSON line per event it sees, each with its wall-clock time ``t``: its
    configuration id is computed from its own view."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch.messaging import codec, gateway, tcp
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.sim.bridge import default_protocol

    protocol = default_protocol()
    settings = Settings(**GATEWAY_SETTINGS)
    lock = threading.Lock()
    decoded = {"ms": 0.0, "bytes": 0, "largest": 0, "largest_ms": 0.0, "large": []}

    def emit(event, t=None, **fields):
        """One event line; ``t`` is when it happened (default: now)."""
        with lock:
            print(json.dumps(dict(event=event, t=time.time() if t is None else t, **fields),
                             default=str), flush=True)

    def timed_decode(frame):
        t0 = time.perf_counter()
        out = codec.decode(frame)
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            decoded["ms"] += ms
            decoded["bytes"] += len(frame)
            if len(frame) > decoded["largest"]:
                decoded["largest"], decoded["largest_ms"] = len(frame), ms
            if len(frame) >= LARGE_FRAME:
                decoded["large"].append((type(out[1]).__name__, len(frame), round(ms, 3)))
        return out

    tcp.decode = timed_decode  # every frame this process reads

    def decode_stats():
        """What this process decoded since the last event that reported it."""
        with lock:
            out = {"decoded_ms": decoded["ms"], "decoded_bytes": decoded["bytes"],
                   "largest_frame": decoded["largest"], "largest_decode_ms": decoded["largest_ms"],
                   "large_decodes": decoded["large"]}
            decoded.update(ms=0.0, bytes=0, largest=0, largest_ms=0.0, large=[])
        return out

    me = protocol.Endpoint.from_parts("127.0.0.1", port)
    transport = tcp.TcpClientServer(me, settings)
    routed = gateway.GatewayRoutedClient(me, protocol.Endpoint.from_string(gateway_address),
                                         transport, settings)
    broadcaster = gateway.GatewaySwarmBroadcaster(routed)
    net = GatewayMemberNet(protocol, routed, broadcaster)
    member = ScriptedMember(net, me, protocol.NodeId(*MEMBER_NODE_ID), 0)
    state = {"identifiers": set()}

    def view_fields():
        return {"members": len(member.view),
                "configuration_id": view_configuration_id(member.view, state["identifiers"])}

    class Service:
        def handle_message(self, msg):
            counts = (len(member.announcements), len(member.decisions))
            member.receive(None, msg)
            seen = time.time()
            if len(member.announcements) > counts[0]:
                emit("announcement", alerts=len(msg.messages),
                     configuration_id=msg.messages[0].configuration_id)
                emit("vote", cut=len(member.votes[-1].endpoints))
            if len(member.decisions) > counts[1]:
                alerts, votes, quorum = member.decisions[-1]
                for a in alerts.messages:
                    if a.edge_status == protocol.EdgeStatus.UP and a.node_id is not None:
                        state["identifiers"].add(a.node_id)
                removed = me not in member.view
                emit("removed" if removed else "decision", t=seen, alerts=len(alerts.messages),
                     vote_senders=len(set(votes.senders)), quorum=quorum,
                     **({} if removed else view_fields()), **decode_stats())
            return protocol.Promise.completed(protocol.Response())

    transport.set_membership_service(Service())
    transport.start()
    broadcaster.set_membership([protocol.Endpoint(b"10.0.0.0", 0)])  # the swarm is a peer
    emit("ready", endpoint=str(me))
    try:
        for line in sys.stdin:
            cmd = line.split()
            if not cmd:
                continue
            if cmd[0] == "join":
                member.k = int(cmd[2])
                t0 = time.time()
                observers = member.join(protocol.Endpoint.from_string(cmd[1]))
                deadline = time.time() + GATEWAY_WAIT_S
                while len(member.join_replies) < observers and time.time() < deadline:
                    time.sleep(0.005)
                full = member.admitted()
                admitted = time.time()
                state["identifiers"] = set(full.identifiers)
                broadcaster.set_membership(sorted(member.view - {me}))
                emit("joined", t=admitted, started=t0, observers=observers, endpoints=len(full.endpoints),
                     response_configuration_id=full.configuration_id, **view_fields(),
                     **decode_stats())
            elif cmd[0] == "leave":
                member.leave()
                emit("leave_sent")
            elif cmd[0] == "quit":
                break
    finally:
        routed.shutdown()
        transport.shutdown()
    return 0


def _free_ports(k):
    """``k`` ports free on 127.0.0.1 just now."""
    socks = []
    try:
        for _ in range(k):
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            socks.append(sock)
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


class _ChildMember:
    """The parent's handle on the ``--gateway-member`` process: commands on
    its standard input, its JSON events read off its standard output by a
    thread, every wait bounded."""

    def __init__(self, gateway_address, port):
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--gateway-member",
             gateway_address, str(port)],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.events = queue.Queue()
        self.seen = []
        self.stderr = []
        threading.Thread(target=self._read, args=(self.proc.stdout, True), daemon=True).start()
        threading.Thread(target=self._read, args=(self.proc.stderr, False), daemon=True).start()

    def _read(self, stream, events):
        for line in stream:
            if events and line.startswith("{"):
                self.events.put(json.loads(line))
            else:
                self.stderr.append(line)

    def send(self, command):
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def wait(self, name, timeout=GATEWAY_WAIT_S):
        deadline = time.time() + timeout
        while True:
            try:
                event = self.events.get(timeout=max(0.01, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(
                    f"gateway member: no '{name}' event in {timeout} s; events so far "
                    f"{[e['event'] for e in self.seen]}; stderr tail "
                    f"{''.join(self.stderr[-20:])}") from None
            self.seen.append(event)
            if event["event"] == name:
                return event

    def close(self):
        try:
            if self.proc.poll() is None:
                self.send("quit")
                self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


class _CodecClock:
    """Encode and decode time, frames and bytes on every thread of this
    process, through the codec names that ``messaging/tcp.py`` and
    ``messaging/gateway.py`` call; the names are restored on exit."""

    def __init__(self):
        from rapid_tpu_torch.messaging import codec, gateway, tcp

        self._modules = (tcp, gateway)
        self._codec = codec
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.totals = {"encode_ms": 0.0, "encodes": 0, "encoded_bytes": 0,
                           "decode_ms": 0.0, "decodes": 0, "decoded_bytes": 0,
                           "largest_frame": 0, "largest_frame_encode_ms": 0.0,
                           "large_encodes": []}

    def snapshot(self):
        with self._lock:
            return dict(self.totals, large_encodes=list(self.totals["large_encodes"]))

    def _encode(self, request_no, msg):
        t0 = time.perf_counter()
        out = self._codec.encode(request_no, msg)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            t = self.totals
            t["encode_ms"] += ms
            t["encodes"] += 1
            t["encoded_bytes"] += len(out)
            if len(out) > t["largest_frame"]:
                t["largest_frame"], t["largest_frame_encode_ms"] = len(out), ms
            if len(out) >= LARGE_FRAME:
                t["large_encodes"].append((type(msg).__name__, len(out), round(ms, 3)))
        return out

    def _decode(self, frame):
        t0 = time.perf_counter()
        out = self._codec.decode(frame)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.totals["decode_ms"] += ms
            self.totals["decodes"] += 1
            self.totals["decoded_bytes"] += len(frame)
        return out

    def __enter__(self):
        for module in self._modules:
            module.encode, module.decode = self._encode, self._decode
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.encode, module.decode = self._codec.encode, self._codec.decode


def gateway_sequence(n, device, seed=SEED):
    """The gateway phase: the port's ``SwarmGateway`` on 127.0.0.1 hosting
    ``n`` virtual members (seed ``seed``, ``GATEWAY_SETTINGS``), warmed,
    and a real member in a child OS process (``--gateway-member``) that
    joins over TCP (one full configuration of n + 1 endpoints), votes in a
    crash of 1% of the virtual members (the closed form) and in one of 1%
    more under ingress loss 1.0 (the scan), and leaves. The crashes run as
    tasks on the gateway's protocol thread. Each step: the wall as the
    member sees it, each decision pump's wall split into the simulator's
    dispatches, the phase-B vote window and the bridge's host work, the
    codec's encode and decode across the process, the largest frame, syncs
    by ``jitwatch`` label (on a card also counted by torch's sync debug
    mode on the protocol thread) and kernel launches. Every configuration
    id must be equal on three sides: the gateway's, the member's own view,
    and a plain ``Simulator`` driven alike."""
    from rapid_tpu_torch.messaging.gateway import SwarmGateway
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.bridge import default_protocol
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig

    protocol = default_protocol()
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 20_000)
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    gw_port, member_port = _free_ports(2)
    member_ep = protocol.Endpoint.from_parts("127.0.0.1", member_port)
    gateway = SwarmGateway(protocol.Endpoint.from_parts("127.0.0.1", gw_port), n_virtual=n,
                           seed=seed, settings=Settings(**GATEWAY_SETTINGS),
                           pump_interval_ms=GATEWAY_PUMP_MS, device=device)
    bridge, sim = gateway.bridge, gateway.bridge.sim
    lock = threading.Lock()
    pumps, registered, task_syncs, task_labels = [], [], [0], {}
    timers = {"dispatch": 0.0, "window": 0.0}
    run, register, pump = sim.run_until_decision, sim.register_extern_vote, bridge.pump
    window = gateway.network.scheduler.run_for
    run_task = gateway._run_task  # noqa: SLF001

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                timers[key] += time.perf_counter() - t0
        return call

    window_marks = []

    def marked_window(ms):
        start = time.time()
        try:
            return window(ms)
        finally:
            window_marks.append((start, time.time()))

    def counted_register(slot, cut):
        ok = register(slot, cut)
        with lock:
            registered.append((slot, ok))
        return ok

    def recorded_pump(*args, **kw):
        timers["dispatch"] = timers["window"] = 0.0
        syncs, launches = jitwatch.sync_counts(), dict(kernels.LAUNCHES)
        t0, start = time.perf_counter(), time.time()
        rec = pump(*args, **kw)
        wall = time.perf_counter() - t0
        if rec is not None or timers["dispatch"] > 0:
            with lock:
                pumps.append({"start": start, "wall_ms": wall * 1e3, "rec": rec,
                              "dispatch_ms": timers["dispatch"] * 1e3,
                              "vote_window_ms": timers["window"] * 1e3,
                              "syncs": _diff(jitwatch.sync_counts(), syncs),
                              "launches": {k: v - launches.get(k, 0)
                                           for k, v in kernels.LAUNCHES.items()
                                           if v - launches.get(k, 0)}})
        return rec

    def counted_task(fn, label):
        """Every protocol task's syncs by ``jitwatch`` label and, on a card,
        under torch's sync debug mode "warn": both counts cover the same
        tasks, whichever step a task straddles."""
        before = jitwatch.sync_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                previous = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                return run_task(fn, label)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(previous)
                with lock:
                    task_syncs[0] += sum("synchronizing CUDA operation" in str(w.message)
                                         for w in caught)
                    for key, n in _diff(jitwatch.sync_counts(), before).items():
                        task_labels[key] = task_labels.get(key, 0) + n

    sim.run_until_decision = timed(run, "dispatch")
    sim.register_extern_vote = counted_register
    bridge.pump = recorded_pump
    gateway.network.scheduler.run_for = timed(marked_window, "window")
    gateway._run_task = counted_task  # noqa: SLF001
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if on_card else 0
    child = None
    steps = []
    clock = _CodecClock()
    try:
        with clock:
            gateway.start()
            t0 = time.perf_counter()
            gateway.warm()
            warm_s = time.perf_counter() - t0
            warm_bytes = (torch.cuda.max_memory_allocated() - resident) if on_card else None
            child = _ChildMember(f"127.0.0.1:{gw_port}", member_port)
            child.wait("ready", timeout=120)

            def step(name, act, event, cut_slots):
                n_before = sim.membership_size
                with lock:
                    del pumps[:]
                    del registered[:]
                    task_syncs[0] = 0
                    task_labels.clear()
                clock.reset()
                kernels.reset_launches()
                start = time.time()
                act()
                seen = child.wait(event)
                deadline = time.time() + GATEWAY_WAIT_S
                while time.time() < deadline:
                    with lock:
                        decided = [p for p in pumps if p["rec"] is not None]
                    if decided:
                        break
                    time.sleep(0.01)
                assert len(decided) == 1, (name, len(decided))
                decision = decided[0]
                rec = decision["rec"]
                time.sleep(3 * GATEWAY_PUMP_MS / 1e3)  # the next pumps see nothing to do
                with lock:
                    work = list(pumps)
                    votes = list(registered)
                    syncs, counted = dict(task_labels), task_syncs[0]
                assert sorted(rec.cut.tolist()) == sorted(int(s) for s in cut_slots), name
                row = {"name": name, "members_before": n_before, "cut": len(rec.cut),
                       "configuration_id": rec.configuration_id,
                       "virtual_time_ms": rec.virtual_time_ms,
                       "member_wall_ms": (seen["t"] - start) * 1e3,
                       "pumps_with_work": len(work),
                       "pump_wall_ms": decision["wall_ms"],
                       "dispatch_ms": decision["dispatch_ms"],
                       "vote_window_ms": decision["vote_window_ms"],
                       "host_ms": decision["wall_ms"] - decision["dispatch_ms"]
                       - decision["vote_window_ms"],
                       "codec": clock.snapshot(),
                       "member_decode_ms": seen.get("decoded_ms"),
                       "member_largest_frame": seen.get("largest_frame"),
                       "member_largest_decode_ms": seen.get("largest_decode_ms"),
                       "member_large_decodes": seen.get("large_decodes"),
                       "pump_syncs": decision["syncs"],
                       "pump_launches": decision["launches"],
                       "syncs": syncs,
                       "counted_syncs": counted if on_card else None,
                       "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                       "registered": votes, "event": seen}
                steps.append(row)
                return row, seen

            slot = n  # the first spare slot seats the joiner
            row, seen = step("join", lambda: child.send(
                f"join {gateway.seed_endpoint()} {sim.config.k}"), "joined", [slot])
            assert seen["endpoints"] == n + 1 == seen["members"], seen
            assert seen["configuration_id"] == seen["response_configuration_id"] \
                == gateway.configuration_id() == row["configuration_id"], seen
            assert bridge._slot_of[member_ep] == slot and member_ep in bridge._real  # noqa: SLF001
            row["member_configuration_id"] = seen["configuration_id"]

            quorum_of = {}
            for name, fault, cut in (
                    ("crash, closed form", lambda v=victims[0]: sim.crash(v), victims[0]),
                    ("crash, scan", lambda v=victims[1]: (sim.crash(v), sim.ingress_loss(v, 1.0)),
                     victims[1])):
                n_before = sim.membership_size
                row, seen = step(name, lambda f=fault: _on_protocol_thread(gateway, f),
                                 "decision", cut)
                quorum = n_before - (n_before - 1) // 4
                quorum_of[name] = quorum
                assert row["registered"] == [(slot, True)], (
                    name, row["registered"], "vote window (start, end) s:", window_marks,
                    "member events (name, t):", [(e["event"], e["t"]) for e in child.seen[-4:]])
                assert seen["alerts"] == len(cut) and seen["quorum"] == quorum, (name, seen)
                assert seen["vote_senders"] >= quorum, (name, seen)
                assert seen["configuration_id"] == gateway.configuration_id() \
                    == row["configuration_id"], (name, seen)
                assert seen["members"] == sim.membership_size, (name, seen)
                votes = [e for e in child.seen if e["event"] == "vote"]
                assert votes and votes[-1]["cut"] == len(cut), name
                row.update(vote_registered=True, alert_batch=seen["alerts"],
                           vote_senders=seen["vote_senders"], quorum=quorum,
                           member_configuration_id=seen["configuration_id"])
                if on_card and name == "crash, scan":
                    assert row["pump_launches"].get("fd_phase_fused", 0) > 0, row["pump_launches"]

            row, seen = step("leave", lambda: child.send("leave"), "removed", [slot])
            assert member_ep not in bridge._real  # noqa: SLF001
            row["member_removed"] = True
    finally:
        if child is not None:
            child.close()
        gateway.shutdown()
        for thread in gateway._threads:  # noqa: SLF001 -- a pump in flight ends first
            thread.join(timeout=GATEWAY_WAIT_S)
    if on_card:
        for row in steps:
            assert row["counted_syncs"] == sum(row["syncs"].values()), (
                row["name"], row["counted_syncs"], row["syncs"])

    # the cross-check: a plain simulator driven alike, with no gateway
    capacity = n + 16
    plain = Simulator(n, capacity=capacity,
                      config=SimConfig(capacity=capacity, extern_proposals=4), seed=seed,
                      device=device)
    plain.assign_identity(n, member_ep.hostname, member_ep.port, *MEMBER_NODE_ID)
    actions = (lambda: plain.request_joins(np.array([n])),
               lambda: plain.crash(victims[0]),
               lambda: (plain.crash(victims[1]), plain.ingress_loss(victims[1], 1.0)),
               lambda: plain.leave(np.array([n])))
    for row, act in zip(steps, actions):
        act()
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        assert prec is not None
        row["plain_configuration_id"] = prec.configuration_id
        assert row["configuration_id"] == prec.configuration_id, (row["name"], prec)
    del gateway, bridge, sim
    return {"warm_s": warm_s, "warm_peak_bytes": warm_bytes, "steps": steps}


def _on_protocol_thread(gateway, fn, timeout=GATEWAY_WAIT_S):
    """Run ``fn`` as a task on the gateway's protocol thread, the one thread
    that touches the swarm, and wait for it."""
    done, error = threading.Event(), []

    def task():
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 -- re-raised on this thread
            error.append(exc)
        finally:
            done.set()

    gateway._put_task(task, gateway.PRIO_FRAME, "fault")  # noqa: SLF001
    assert done.wait(timeout), "protocol task did not run"
    if error:
        raise error[0]


def _print_gateway(result, card):
    for row in result["steps"]:
        c = row["codec"]
        print(f"gateway, {row['name']} ({card}): {row['members_before']} members, cut "
              f"{row['cut']}, configuration id {row['configuration_id']} (== the member's own "
              f"view == the plain simulator's), virtual {row['virtual_time_ms']} ms; wall as "
              f"the member sees it {row['member_wall_ms']:.3f} ms; decision pump "
              f"{row['pump_wall_ms']:.3f} ms = dispatch {row['dispatch_ms']:.3f} + vote window "
              f"(the announcement answered, then 100 ms) {row['vote_window_ms']:.3f} + bridge "
              f"host {row['host_ms']:.3f}; codec in the "
              f"gateway process: encode {c['encode_ms']:.3f} ms over {c['encodes']} frames "
              f"({c['encoded_bytes']} B), decode {c['decode_ms']:.3f} ms over {c['decodes']} "
              f"frames ({c['decoded_bytes']} B); largest frame {c['largest_frame']} B "
              f"(encoded in {c['largest_frame_encode_ms']:.3f} ms); member decode "
              f"{row['member_decode_ms']:.3f} ms, largest frame {row['member_largest_frame']} B "
              f"in {row['member_largest_decode_ms']:.3f} ms; frames of 64 KiB and more, "
              f"(class, bytes, ms): encoded {c['large_encodes']}, decoded by the member "
              f"{row['member_large_decodes']}; the decision pump's syncs by label "
              f"{row['pump_syncs']} and kernel launches {row['pump_launches']}; the step's "
              f"{row['pumps_with_work']} pumps with device work and every other protocol task: "
              f"syncs by label {row['syncs']}"
              + ("" if row["counted_syncs"] is None else
                 f" (debug mode counted {row['counted_syncs']})")
              + f", kernel launches {row['launches']}"
              + "".join(f"; {k} {row[k]}" for k in (
                  "vote_registered", "alert_batch", "vote_senders", "quorum") if row.get(k)),
              flush=True)
    print(f"gateway warm(): {result['warm_s']:.3f} s"
          + ("" if result["warm_peak_bytes"] is None else
             f", peak {result['warm_peak_bytes'] / 2**20:.1f} MiB of device memory above the "
             "swarm's own state") + f" ({card})", flush=True)


def wire_phase(card, reps=5):
    """The port's codec replays ``tests/golden/torch_wire_frames.json``
    (frames ``rapid_tpu``'s codec wrote) byte for byte and decodes each
    back to an equal message, with no C MessagePack library in the process;
    then each frame class's encode and decode time (median of ``reps``,
    fresh message objects, so no memo hits), and one run each of a
    100k-member ``JoinResponse``, a 75 001-sender ``FastRoundVoteBatch`` and
    an announcement of 1000 alerts."""
    sys.path.insert(0, os.path.dirname(WIRE_FRAMES))
    import torch_wire_fixtures as fx

    assert "msgpack" not in sys.modules, "a C MessagePack library is loaded"
    wire = fx.port_wire()
    with open(WIRE_FRAMES) as f:
        frames = json.load(f)["frames"]
    classes = {}
    for frame in frames:
        data = bytes.fromhex(frame["hex"])
        assert fx.frame_bytes(frame, wire) == data, frame["name"]
        want = fx.message(frame, wire)
        if frame["routed"] is not None:
            got = wire.decode_routed(data)[2]
        else:
            got = wire.decode(memoryview(data))[1]
        assert got == want and type(got) is type(want), frame["name"]
        enc, dec = [], []
        for _ in range(reps):
            msg = fx.message(frame, wire)
            t0 = time.perf_counter()
            fx.encode_frame(frame, msg, wire)
            enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            wire.decode_routed(data) if frame["routed"] is not None else wire.decode(data)
            dec.append(time.perf_counter() - t0)
        cls = type(want).__name__
        entry = classes.setdefault(cls, {"frames": 0, "bytes": 0, "encode_ms": 0.0,
                                         "decode_ms": 0.0})
        entry["frames"] += 1
        entry["bytes"] = max(entry["bytes"], len(data))
        entry["encode_ms"] = max(entry["encode_ms"], statistics.median(enc) * 1e3)
        entry["decode_ms"] = max(entry["decode_ms"], statistics.median(dec) * 1e3)
    T = wire.types
    big = {}
    for name, make in (
            ("JoinResponse, 100 001 endpoints and identifiers", lambda: T.JoinResponse(
                T.Endpoint(b"10.0.0.1", 5000), T.JoinStatusCode.SAFE_TO_JOIN,
                -4651904502688146028, fx.endpoints(T, 100_001, 5000), fx.node_ids(T, 100_001, 1))),
            ("FastRoundVoteBatch, 75 001 senders, a 1000-member cut", lambda: T.FastRoundVoteBatch(
                fx.endpoints(T, 75_001, 5000), -4651904502688146028,
                fx.endpoints(T, 1000, 6000))),
            ("BatchedAlertMessage, an announcement of 1000 alerts on 10 rings",
             lambda: T.BatchedAlertMessage(T.Endpoint(b"10.0.0.1", 5000), tuple(
                 T.AlertMessage(T.Endpoint(b"10.0.0.1", 5000), e, T.EdgeStatus.DOWN,
                                -4651904502688146028, tuple(range(10)))
                 for e in fx.endpoints(T, 1000, 6000))))):
        msg = make()
        t0 = time.perf_counter()
        data = wire.encode(7, msg)
        t1 = time.perf_counter()
        back = wire.decode(data)[1]
        t2 = time.perf_counter()
        assert back == msg
        big[name] = {"bytes": len(data), "encode_ms": (t1 - t0) * 1e3,
                     "decode_ms": (t2 - t1) * 1e3}
    print(f"wire: the port's codec gives all {len(frames)} golden frames byte for byte and "
          f"decodes each back to an equal message ({len(classes)} classes, no C MessagePack "
          f"library in the process) ({card})", flush=True)
    for cls, e in sorted(classes.items()):
        print(f"wire, {cls}: {e['frames']} frames, largest {e['bytes']} B, encode "
              f"{e['encode_ms']:.4f} ms, decode {e['decode_ms']:.4f} ms (median of {reps}, the "
              f"slowest frame of the class)", flush=True)
    for name, e in big.items():
        print(f"wire, {name}: {e['bytes']} B, encode {e['encode_ms']:.3f} ms, decode "
              f"{e['decode_ms']:.3f} ms (one run, no memo) ({card})", flush=True)
    return {"frames": len(frames), "classes": classes, "large": big}


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch import observability
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import ProfilingSettings
    from rapid_tpu_torch.shard import engine as shard
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

    # --- the simulator bridge, first in the process: warm_compile does the
    # process's first-time work, the pumps after it show what is left -------
    os.environ["RAPID_JITWATCH"] = "1"
    card_device = torch.device("cuda", torch.cuda.current_device())
    bridge = bridge_sequence(N_NODES, device, [card_device] * 4)
    bridged_launches = {}
    for row in bridge["pumps"]:
        for name, count in row["launches"].items():
            bridged_launches.setdefault(name, []).append((row["name"], count))

    # --- the wire, then the socket gateway with a member in its own process
    t0 = time.perf_counter()
    wire = wire_phase(card)
    t1 = time.perf_counter()
    gateway = gateway_sequence(N_NODES, card_device)
    _print_gateway(gateway, card)
    print(f"wire phase {t1 - t0:.1f} s, gateway phase {time.perf_counter() - t1:.1f} s, "
          f"the script so far {time.perf_counter() - started:.1f} s", flush=True)
    gateway_launches = {}
    for row in gateway["steps"]:
        for name, count in row["pump_launches"].items():
            gateway_launches.setdefault(name, []).append((row["name"], count))

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

    # --- telemetry, speculation, profiling ---------------------------------
    planes = {"speculation": _speculation_pairs(Simulator, rng, device),
              "timed_window": _timed_windows(Simulator, observability, jitwatch,
                                             ProfilingSettings, rng, device),
              "profiling": _profiling(Simulator, engine, kernels, ProfilingSettings, rng,
                                      device),
              "device_trace": _device_trace(Simulator, observability, rng, device)}

    # --- the multi-device round loop, every shard on this card -------------
    split = _split_phase(kernels, fd_bench, engine, device)
    sharded = _sharded_decisions(Simulator, engine, shard, kernels, rng, device)

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
            # (bridged pump, launches) of each pump of the bridge phase that ran it
            "launches_bridged": bridged_launches.get(name, []),
            # (gateway step, launches) of each decision pump of the gateway phase that ran it
            "launches_gateway": gateway_launches.get(name, []),
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
    # the split's kernels: launches from the sharded decisions (8 shards; the
    # windowed instantiation from the windowed one on 4 shards)
    split_launches = {
        "fd_phase_rows": sharded["8 shards"]["launches"]["fd_phase_rows"],
        "fd_phase_rows_windowed":
            sharded["windowed 4 shards"]["launches"]["fd_phase_rows_windowed"],
        "fd_gather": sharded["8 shards"]["launches"]["fd_gather"],
    }
    for name, t in split.items():
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "rapid_tpu_torch/csrc/fd_phase_fused.cu",
            "replaces": "rapid_tpu/sim/pallas_kernels.py:54",
            "on_main_path": True,
            "path": ("sharded decision, windowed, 4 shards" if name.endswith("windowed")
                     else "sharded decision, 8 shards"),
            "launches": split_launches[name],
            "launches_bridged": bridged_launches.get(name, []),
            "launches_gateway": gateway_launches.get(name, []),
            "match": True,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "hot_ms": t.get("hot_ms", t["ms"]),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_us": t["bound_ms"] * 1e3,
            "bound_by": t["bound_by"],
            "tolerance": 0,
            "library_ms": None,  # no single PyTorch call computes either half
            "sizes": {f"{t['shape'][0]}x10": t},
        })
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps(line))
    print(json.dumps({"headline_wall_ms": head_walls, "scan_wall_ms": scan_walls,
                      "headline_syncs": syncs, "scan_syncs": scan_syncs,
                      "windowed": windowed, "classic_fallback": fallback,
                      "sharded": sharded, "planes": planes, "card": card,
                      "bridge": dict(bridge, pumps=[dict(p, cut=len(p["cut"]))
                                                    for p in bridge["pumps"]]),
                      "wire": wire, "gateway": gateway},
                     default=str))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--gateway-member":
        sys.exit(gateway_member(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
