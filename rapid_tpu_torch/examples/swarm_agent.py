"""A real membership node inside a virtual swarm on the card.

The port's counterpart of ``examples/swarm_agent.py``. Demonstrates the
``TpuSimMessaging`` bridge (``rapid_tpu_torch/sim/bridge.py``): a node built
on the port's Cluster API joins a swarm of N simulated virtual peers, watches
a correlated crash burst get cut by the simulated protocol, then leaves
gracefully. Everything crosses the same two plugin seams a real deployment
would use (messaging + failure detection); configuration ids stay
bit-identical between the real node and the swarm's simulator, which runs on
the CUDA device unless ``--device cpu`` is given.

    python -m rapid_tpu_torch.examples.swarm_agent --virtual-nodes 1000 --crash-percent 1

Exit status 0 when the node's id equals the swarm's after the join and the
crash and the swarm is back to N - crashed members after the leave, 1
otherwise, 2 without a card unless ``--device cpu`` (it never falls back).
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from rapid_tpu_torch import ClusterBuilder, Endpoint, Settings
from rapid_tpu_torch.events import ClusterEvents
from rapid_tpu_torch.messaging.inprocess import (
    InProcessClient,
    InProcessNetwork,
    InProcessServer,
)
from rapid_tpu_torch.runtime.scheduler import VirtualScheduler
from rapid_tpu_torch.sim.bridge import TpuSimMessaging


def run(virtual_nodes: int = 1000, crash_percent: float = 1.0, seed: int = 42,
        device: Optional[str] = "cuda", quiet: bool = False) -> Dict[str, object]:
    """Join, crash, leave; the node's and the swarm's ids and sizes after
    each step (``steps``) and whether each step holds (``ok``)."""

    def say(msg: str) -> None:
        if not quiet:
            print(msg)

    scheduler = VirtualScheduler()
    network = InProcessNetwork(scheduler)
    say(f"hosting {virtual_nodes} virtual nodes on {device} ...")
    swarm = TpuSimMessaging(
        network,
        n_virtual=virtual_nodes,
        capacity=virtual_nodes + 16,
        seed=seed,
        device=device,
    )
    sim = swarm.sim

    address = Endpoint.from_parts("real-node", 9000)
    settings = Settings()
    builder = (
        ClusterBuilder(address)
        .set_messaging_client_and_server(
            InProcessClient(address, network, settings),
            InProcessServer(address, network),
        )
        .use_scheduler(scheduler)
        .use_settings(settings)
        .use_rng(random.Random(seed))
        .add_subscription(
            ClusterEvents.VIEW_CHANGE,
            lambda cid, changes: say(
                f"  VIEW_CHANGE config={cid} changes={len(changes)}"
            ),
        )
    )
    steps = []

    def step(name: str, cluster, **extra) -> None:
        row = dict(name=name, member_id=cluster.get_current_configuration_id(),
                   swarm_id=sim.configuration_id(), member_size=cluster.get_membership_size(),
                   swarm_size=sim.membership_size, **extra)
        row["ok"] = (row["member_id"], row["member_size"]) == (row["swarm_id"], row["swarm_size"])
        steps.append(row)
        say(f"{name}: member id {row['member_id']}, swarm id {row['swarm_id']}, "
            f"member size {row['member_size']}, swarm size {row['swarm_size']} "
            f"(parity: {row['ok']})")

    promise = builder.join_async(swarm.endpoint(0))
    scheduler.run_for(50)
    record = swarm.pump()
    joined = scheduler.run_until(promise.done, 10_000)
    if record is None or not joined:
        raise RuntimeError(f"the real node did not join: record {record}, joined {joined}")
    cluster = promise.result(0)
    step("join", cluster)

    n_crash = max(1, int(virtual_nodes * crash_percent / 100))
    victims = np.random.default_rng(seed).choice(virtual_nodes, size=n_crash, replace=False)
    say(f"crashing {n_crash} virtual nodes ...")
    sim.crash(victims)
    record = swarm.pump(max_rounds=16, batch=16)
    if record is None or set(record.cut.tolist()) != set(victims.tolist()):
        raise RuntimeError(f"unexpected cut: {record}")
    scheduler.run_for(500)  # the real node tallies the swarm's votes
    step("crash", cluster, cut=len(record.cut), virtual_time_ms=record.virtual_time_ms)

    member_id = cluster.get_current_configuration_id()
    slot = swarm._slot_of.get(address)  # noqa: SLF001 -- the member's seat
    if slot is None:
        raise RuntimeError(f"the swarm seats no {address}")
    done = cluster.leave_gracefully_async()
    scheduler.run_for(50)
    swarm.pump(max_rounds=8)
    scheduler.run_until(done.done, 30_000)
    left = dict(name="leave", member_id=member_id, swarm_id=sim.configuration_id(),
                swarm_size=sim.membership_size, member_size=None,
                seated=bool(sim.active[slot]))
    left["ok"] = left["swarm_size"] == virtual_nodes - n_crash and not left["seated"]
    steps.append(left)
    say(f"left gracefully; swarm is back to {sim.membership_size} members "
        f"(swarm id {left['swarm_id']}; the member's last id {member_id})")
    return {"steps": steps, "ok": all(s["ok"] for s in steps), "crashed": n_crash}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--virtual-nodes", type=int, default=1000)
    parser.add_argument("--crash-percent", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the swarm (default cuda; cpu to leave the card)",
    )
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"swarm_agent: no CUDA device is available for --device {args.device}; "
              "pass --device cpu to run the swarm on the CPU", file=sys.stderr)
        return 2
    out = run(args.virtual_nodes, args.crash_percent, args.seed, args.device)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
