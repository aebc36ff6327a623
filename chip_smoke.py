"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU, and hold
every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU (sm_90a:
H100/H200) and the CUDA toolkit. The first run builds the kernels with nvcc
into build/kernels/. Phases, each of which must pass:

1. the card, the torch and CUDA versions, and the kernel build time;
2. each CUDA kernel against its plain version at [100_000, 10] and
   [1_000_000, 10], bit for bit, with CUDA-event timings of both;
3. the headline: a 100k-member simulator, 1% of members crashed, one
   ``run_until_decision(16, 16)`` to warm, then the same timed on
   ``TIMED_RUNS`` fresh simulators (the closed-form branch); each cut must
   equal the crashed set;
4. the scan path: fresh 100k simulators under ingress loss 1.0 on 1% of
   members, which must decide that set through the FD-phase kernel;
5. the port on the card against the port on the CPU at 1000 members, for
   both branches, every state field.

Prints a JSON line of kernel results, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result.
"""

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
# bools out
BYTES_PER_EDGE = {"fd_phase_i32": 5 + 4 + 5, "fd_phase_u8": 5 + 1 + 2}
# operations per edge: 2 ANDs and a NOT for the failure, the counter test
# and add, the threshold compare, 2 ANDs and a NOT for new_down, the OR
OPS_PER_EDGE = 10


def _time_ms(fn, reps=20, iters=11):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the replay timed with CUDA events, median over ``iters`` replays
    divided by ``reps``. The graph keeps the Python wrapper's launch overhead
    out of the measurement, which at these sizes would otherwise swamp it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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
            ops_ms = OPS_PER_EDGE * c * 10 / PEAK_OPS_PER_S * 1e3
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


def _count_syncs(fn):
    """Synchronizing CUDA calls made by ``fn`` (torch's sync debug mode:
    device->host fetches and blocking host->device copies)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def _cross_check(Simulator, engine, device):
    """The port on the card against the port on the CPU at 1000 members."""
    for name, fault in (
        ("crash", lambda s: s.crash(np.arange(0, 1000, 97))),
        ("ingress_loss_1.0", lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0)),
    ):
        outs = []
        for dev in ("cpu", device):
            sim = Simulator(1000, seed=SEED, device=dev)
            fault(sim)
            rec = sim.run_until_decision(max_rounds=16, batch=16)
            assert rec is not None, f"cross-check {name}: no decision on {dev}"
            outs.append(((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms),
                         engine.state_to_numpy(sim.state)))
        assert outs[0][0] == outs[1][0], f"cross-check {name}: records differ"
        for field, value in outs[0][1].items():
            assert np.array_equal(outs[1][1][field], value), f"cross-check {name}: {field}"
        print(f"cross-check {name}: card == cpu at 1000 members", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch.sim import engine, kernels
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
    lib = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({lib.name})", flush=True)

    kernel_results = _kernel_phase(kernels, device)

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
    assert scan_launches["fd_phase_u8"] >= 11, scan_launches
    print(f"scan path (ingress loss 1.0): cut ok, virtual {rec.virtual_time_ms} ms, "
          f"warmed wall median {statistics.median(scan_walls):.3f} ms max "
          f"{max(scan_walls):.3f} ms over {TIMED_RUNS} runs "
          f"{[round(w, 3) for w in scan_walls]}, kernel launches {scan_launches}, "
          f"synchronizing CUDA calls per decision: {scan_syncs}", flush=True)

    _cross_check(Simulator, engine, device)

    source = "rapid_tpu_torch/csrc/fd_phase.cu"
    line = {"kernels": []}
    for name, sizes in kernel_results.items():
        main_shape = sizes[f"{KERNEL_SIZES[0]}x10"]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "rapid_tpu/sim/pallas_kernels.py:54",
            "on_main_path": name == "fd_phase_u8",
            "launches": scan_launches[name],
            "launches_headline": headline_launches[name],
            "match": True,
            "max_abs_err": max(s["max_abs_err"] for s in sizes.values()),
            "ms": main_shape["ms"],
            "kernel_ms": main_shape["ms"],
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
                      "headline_syncs": syncs, "scan_syncs": scan_syncs, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
