"""End-to-end application scenario: a workload router on live membership.

The port's counterpart of ``examples/load_balancer.py``. The paper's closing
evaluation (docs/atc-2018-camera-ready.pdf §7 Fig. 13) runs nginx in front
of 50 backends, fails 10 of them at once, and shows Rapid removing the whole
set in a SINGLE view change -- the application reroutes immediately instead
of bleeding errors through ten separate reconfigurations. This example is
that scenario with the swarm on the card:

- a ``SwarmGateway`` hosts N virtual backends (the simulated fleet) in the
  port's simulator, on the CUDA device unless ``--device cpu`` is given,
- the router is a real member: the port's ClusterBuilder stack joined
  through the gateway, its backend pool maintained ONLY by VIEW_CHANGE
  subscriptions (ClusterEvents.java:19-24 -- no health checks of its own,
  membership IS the health signal),
- requests are routed through the serving plane's client-side router
  (``rapid_tpu_torch.serving.RendezvousRouter`` -- rendezvous hashing over
  the live pool; its parity with ``placement.rendezvous_route`` is asserted
  below), so a view change moves only the failed backends' keys,
- a correlated burst kills 10 backends; the membership protocol cuts all
  of them in one view change and the router's very next routes are clean.

    python -m rapid_tpu_torch.examples.load_balancer --backends 50 --fail 10

Without a card and without ``--device cpu`` it exits with status 2; it never
falls back to the CPU. Exit status 1 when a Fig. 13 property fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

import numpy as np

from rapid_tpu_torch import ClusterBuilder, Endpoint, Settings
from rapid_tpu_torch.messaging.gateway import (
    GatewayRoutedClient,
    GatewaySwarmBroadcaster,
    SwarmGateway,
)
from rapid_tpu_torch.messaging.ports import free_port_base
from rapid_tpu_torch.messaging.tcp import TcpClientServer
from rapid_tpu_torch.placement import rendezvous_route, weight_seed
from rapid_tpu_torch.serving import RendezvousRouter


def run_scenario(
    backends: int = 50,
    fail: int = 10,
    seed: int = 23,
    requests_per_check: int = 200,
    quiet: bool = False,
    device: Optional[str] = "cuda",
) -> Dict[str, object]:
    """The Fig.-13 shape; returns the measurements the caller asserts on
    (the JAX example's dict). ``device``: where the swarm runs."""

    def say(msg: str) -> None:
        if not quiet:
            print(msg)

    base = free_port_base(4)
    settings = Settings(
        failure_detector_interval_ms=100,
        batching_window_ms=50,
    )
    gateway = SwarmGateway(
        Endpoint.from_parts("127.0.0.1", base),
        n_virtual=backends,
        seed=seed,
        settings=settings,
        pump_interval_ms=50,
        device=device,
    )
    gateway.start()
    router_cluster = None
    try:
        gateway.warm()
        router_addr = Endpoint.from_parts("127.0.0.1", base + 1)
        transport = TcpClientServer(router_addr, settings)
        client = GatewayRoutedClient(
            router_addr, gateway.address, transport, settings
        )
        router_cluster = (
            ClusterBuilder(router_addr)
            .use_settings(settings)
            .set_messaging_client_and_server(client, transport)
            .set_broadcaster_factory(
                lambda c, rng, routed=client: GatewaySwarmBroadcaster(routed)
            )
            .join(gateway.seed_endpoint(), timeout=90)
        )
        router = RendezvousRouter(router_cluster, router_addr)
        say(f"router joined: {len(router.backends())} backends live")
        assert len(router.backends()) == backends

        # steady-state traffic before the failure
        keys = [b"req-%d" % i for i in range(requests_per_check)]
        before = {k: router.route(k) for k in keys}
        assert all(v is not None for v in before.values())

        # routing parity: the serving plane's router routes every key as
        # rendezvous hashing over the same pool does
        pool = router.backends()
        seeds = {b: weight_seed(b) for b in pool}
        assert all(
            before[k] == rendezvous_route(k, pool, seeds) for k in keys
        ), "serving-plane router diverged from direct rendezvous routing"

        # the correlated burst: fail `fail` backends at once, on the
        # gateway's protocol thread (the one thread that touches the swarm)
        victims = np.arange(2, 2 + fail)
        victim_eps = {gateway.bridge.endpoint(int(v)) for v in victims}
        changes_before = router.view_changes
        gateway.on_protocol_thread(lambda: gateway.bridge.sim.crash(victims))
        say(f"crashed {fail} backends; waiting for the cut...")
        deadline = time.time() + 120
        while (
            time.time() < deadline
            and router_cluster.get_membership_size() != backends + 1 - fail
        ):
            time.sleep(0.05)
        assert router_cluster.get_membership_size() == backends + 1 - fail

        # Fig. 13's claim: ONE view change removed the whole failed set
        view_changes = router.view_changes - changes_before
        cut = {c.endpoint for c in router.last_down}
        say(f"view changes: {view_changes}; cut size: {len(cut)}")

        # and the router's next routes never touch a dead backend
        after = {k: router.route(k) for k in keys}
        dead_routes = [k for k, b in after.items() if b in victim_eps]
        moved = [k for k in keys if before[k] != after[k]]
        say(
            f"routes to dead backends after the change: {len(dead_routes)}; "
            f"keys remapped: {len(moved)}/{len(keys)}"
        )
        return {
            "view_changes": view_changes,
            "cut": cut,
            "victims": victim_eps,
            "dead_routes": dead_routes,
            "moved": len(moved),
            "keys": len(keys),
            "config_id_router": router_cluster.get_current_configuration_id(),
            "config_id_swarm": gateway.configuration_id(),
        }
    finally:
        if router_cluster is not None:
            router_cluster.shutdown()
        gateway.shutdown()


def holds(out: Dict[str, object]) -> Dict[str, bool]:
    """Fig. 13's four properties of a run."""
    return {
        "single view change": out["view_changes"] == 1,
        "exact cut": out["cut"] == out["victims"],
        "clean routes": not out["dead_routes"],
        "config ids match": out["config_id_router"] == out["config_id_swarm"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backends", type=int, default=50)
    parser.add_argument("--fail", type=int, default=10)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the swarm (default cuda; cpu to leave the card)",
    )
    args = parser.parse_args(argv)
    try:
        out = run_scenario(args.backends, args.fail, args.seed, device=args.device)
    except RuntimeError as exc:
        if "no CUDA device" not in str(exc):
            raise
        print(f"load_balancer: {exc}", file=sys.stderr)
        return 2
    checks = holds(out)
    print("; ".join(f"{name}: {ok}" for name, ok in checks.items()))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
