"""Per-process message load during a crash experiment on the port: unicast
vs gossip; the counterpart of ``experiments/message_load.py``.

The paper's Table 2 reports per-process network utilization for a
1000-process crash experiment (Rapid's headline there: mean AND p99 stay
low, unlike ZooKeeper's coordinator-skewed p99). This experiment reproduces
the shape of that measurement on the port's in-process virtual-time
cluster (``rapid_tpu_torch.harness``): run an N-node cluster, crash a few
members, converge, and report the distribution of protocol messages
RECEIVED per process (the service's per-type counters) under each
dissemination strategy. It is host code: no simulator, no device.

What it shows, concretely: with unicast-to-all every node receives each
broadcast exactly once (the origin pays the whole O(N) send burst); with
gossip every node receives ~fanout x relay_budget copies (the epidemic
redundancy factor) while any process's sends per broadcast are bounded by
fanout+1 initial sends at the origin plus relay_budget x fanout relays
(13 at the defaults) -- constant in N, where unicast's origin burst grows
linearly. The per-type totals pin that the PROTOCOL work (alert batches
delivered, votes tallied) is identical under both strategies -- only the
dissemination fabric differs. Run:

    python -m rapid_tpu_torch.experiments.message_load       (defaults: N=32, crash 2)
    python -m rapid_tpu_torch.experiments.message_load --n 50 --crash 3

Prints one JSON line per strategy:
  {"strategy", "n", "crashed", "mean_msgs", "p50", "p99", "max",
   "per_type_totals"}
"""

import argparse
import json

import numpy as np


def run_strategy(strategy: str, n: int, crash: int, seed: int,
                 failure_mode: str = "crash") -> dict:
    from ..harness import ClusterHarness

    # crash mode uses the instant static FDs (the paper's Table 2 shape:
    # dissemination cost of one clean cut). one-way mode uses the REAL
    # cumulative PingPong detectors -- detection must flow through actual
    # probe loss across the asymmetric fault, so the column measures the
    # dissemination fabric under the noisier probe-driven alert pattern
    h = ClusterHarness(seed=seed, use_static_fd=(failure_mode == "crash"))
    if strategy.startswith("gossip"):
        from ..messaging.gossip import GossipBroadcaster

        mode = "pushpull" if strategy == "gossip-pushpull" else "eager"
        h.broadcaster_factory = lambda client, rng: GossipBroadcaster(
            client, client.address, fanout=4, rng=rng, mode=mode
        )
    try:
        return _measure(h, strategy, n, crash, failure_mode)
    finally:
        h.shutdown()


def _measure(h, strategy: str, n: int, crash: int,
             failure_mode: str = "crash") -> dict:
    h.create_cluster(n, parallel=False)
    h.wait_and_verify_agreement(n)
    # zero the counters after bootstrap so the measurement is the failure
    # experiment itself, like the paper's steady-state window
    for inst in h.instances.values():
        inst._membership_service.metrics.reset()  # noqa: SLF001
    victims = [h.addr(i) for i in range(2, 2 + crash)]
    if failure_mode == "crash":
        h.fail_nodes(victims)
    elif failure_mode == "one-way":
        # paper Fig. 9's iptables INPUT shape: victims receive nothing,
        # their egress still flows; the survivors' PingPong detectors
        # accumulate real probe losses until the alert threshold
        victim_set = set(victims)
        h.network.add_filter(lambda s, d, m: d not in victim_set)
    else:
        raise ValueError(f"unknown failure mode {failure_mode}")
    survivors = [
        c for ep, c in h.instances.items() if ep not in set(victims)
    ]
    ok = h.scheduler.run_until(
        lambda: all(
            len(c.get_memberlist()) == n - crash for c in survivors
        ),
        timeout_ms=600_000,
    )
    assert ok, "survivors did not converge"
    for v in victims:
        c = h.instances.pop(v, None)
        if c is not None and failure_mode != "crash":
            c.shutdown()

    per_process = []
    per_process_control = []  # payload-free IHAVE/PULL frames (pushpull)
    per_type: dict = {}
    for inst in h.instances.values():
        snap = inst._membership_service.metrics.snapshot()  # noqa: SLF001
        total = sum(
            v for k, v in snap.items()
            if k.startswith("messages.") and not k.endswith(".control")
        )
        per_process.append(total)
        per_process_control.append(
            sum(v for k, v in snap.items() if k.endswith(".control"))
        )
        for k, v in snap.items():
            if k.startswith("messages."):
                per_type[k[len("messages."):]] = per_type.get(k[len("messages."):], 0) + v
    arr = np.array(per_process)
    ctl = np.array(per_process_control)
    return {
        "strategy": strategy,
        "failure_mode": failure_mode,
        "n": n,
        "crashed": crash,
        "mean_msgs": round(float(arr.mean()), 1),
        "p50": int(np.percentile(arr, 50)),
        "p99": int(np.percentile(arr, 99)),
        "max": int(arr.max()),
        "mean_control": round(float(ctl.mean()), 1),
        "per_type_totals": dict(sorted(per_type.items())),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=32)
    parser.add_argument("--crash", type=int, default=2)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--failure-mode", default="crash",
                        choices=("crash", "one-way", "all"))
    args = parser.parse_args(argv)
    modes = (
        ("crash", "one-way")
        if args.failure_mode == "all"
        else (args.failure_mode,)
    )
    for failure_mode in modes:
        for strategy in ("unicast", "gossip", "gossip-pushpull"):
            print(
                json.dumps(run_strategy(
                    strategy, args.n, args.crash, args.seed,
                    failure_mode=failure_mode,
                )),
                flush=True,
            )


if __name__ == "__main__":
    main()
