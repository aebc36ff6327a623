"""Run the membership simulator over a ("dcn", "ici") mesh of processes.

The port's counterpart of ``examples/multihost_sim.py``, with its output.
Launch one copy a host (or several on one machine), each naming the
coordinator (process 0's ``host:port``) and its own rank:

    python -m rapid_tpu_torch.cli.multihost_sim --coordinator 127.0.0.1:8476 \\
        --num-processes 2 --process-id $RANK --devices-per-host 2 --n 100000

The processes meet over ``torch.distributed`` (gloo), each holds the rows of
its own ``--devices-per-host`` shards, and every round one all-gather swaps
the alert bitset (``rapid_tpu_torch/shard/engine.py``). Without
``--coordinator`` the same program runs in one process on a one-host mesh.

It runs on the CUDA device unless ``--device cpu`` is given (each process on
card ``process-id mod count``, its shards repeating that card), and never
falls back to the CPU. ``--ingress-loss P`` faults the victims with ingress
loss ``P`` instead of crashing them (the scan round). One decision on a
simulator of another seed warms the process first. Prints the JAX script's
two lines, ``mesh {...}; ...`` and ``cut N nodes in T ms protocol time (W ms
wall); config ID``, then ``stats {...}``: this process's index, the
decision's wall and the rounds it ran, its collectives and the bytes each gathered, its syncs by
``jitwatch`` label and its kernel launches.
"""

import argparse
import json
import os
import time


def main() -> None:
    parser = argparse.ArgumentParser(description="rapid-tpu multi-process mesh (PyTorch/CUDA)")
    parser.add_argument("--coordinator", help="host:port of process 0")
    parser.add_argument("--num-processes", type=int)
    parser.add_argument("--process-id", type=int)
    parser.add_argument("--n", type=int, default=10_000)
    parser.add_argument("--fail-fraction", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--devices-per-host", type=int, default=None,
                        help="shards of this process (default: every visible card; 1 on cpu)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the shards live (default cuda)")
    parser.add_argument("--ingress-loss", type=float, default=0.0,
                        help="fault the victims with this ingress loss instead of a crash")
    args = parser.parse_args()
    os.environ["RAPID_JITWATCH"] = "1"  # the stats line's syncs by label

    import numpy as np
    import torch

    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.shard.engine import make_multihost_mesh
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.driver import Simulator

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass --device cpu to leave the card")
        card = torch.device("cuda", (args.process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(card)
        devices = None if args.devices_per_host is None else [card] * args.devices_per_host
    else:
        devices = [torch.device("cpu")] * (args.devices_per_host or 1)
    try:
        if args.coordinator:
            mesh = make_multihost_mesh(coordinator_address=args.coordinator,
                                       num_processes=args.num_processes,
                                       process_id=args.process_id, devices=devices)
        else:
            mesh = make_multihost_mesh(hosts=None if devices is None else [devices])
        n_dev = mesh.size
        capacity = ((args.n + n_dev - 1) // n_dev) * n_dev  # divisible over mesh
        print(f"mesh {dict(mesh.shape)}; {args.n} members in capacity {capacity}", flush=True)

        max_rounds = 64 if args.ingress_loss else 16

        def decide(seed):
            sim = Simulator(args.n, capacity=capacity, seed=seed, mesh=mesh).ready()
            rng = np.random.default_rng(seed)
            victims = rng.choice(args.n, max(1, int(args.n * args.fail_fraction)),
                                 replace=False)
            if args.ingress_loss:
                sim.ingress_loss(victims, args.ingress_loss)
            else:
                sim.crash(victims)
            return sim, victims

        # one decision of another seed first, so the reported one is warm
        sim, _ = decide(args.seed + 1)
        sim.run_until_decision(max_rounds=max_rounds, batch=16)
        sim, victims = decide(args.seed)
        jitwatch.reset()
        kernels.reset_launches()
        collectives, gathered = mesh.collectives, mesh.collective_bytes
        t0 = time.perf_counter()
        record = sim.run_until_decision(max_rounds=max_rounds, batch=16)
        sim.ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
        assert record is not None and set(record.cut) == set(victims), "cut parity"
        print(
            f"cut {len(record.cut)} nodes in {record.virtual_time_ms} ms protocol "
            f"time ({record.wall_time_s * 1e3:.1f} ms wall); "
            f"config {record.configuration_id}", flush=True
        )
        count = mesh.collectives - collectives
        print("stats " + json.dumps({
            "process": mesh.process_index, "processes": mesh.process_count,
            "device": str(mesh.home), "shards": list(mesh.local_shards),
            "wall_ms": wall_ms, "rounds": sim.metrics.get("rounds"), "collectives": count,
            "bytes_a_collective": (mesh.collective_bytes - gathered) // count if count else 0,
            "syncs": jitwatch.sync_counts(), "launches": dict(kernels.LAUNCHES),
        }), flush=True)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
