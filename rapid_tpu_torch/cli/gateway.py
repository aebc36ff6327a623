"""Socket-hosted swarm gateway on the port: the swarm on the card.

The port's counterpart of ``rapid_tpu/cli/gateway.py``, with the same flags
and output. Hosts N virtual nodes (their rings, failure detectors, cut
detection and fast-round tallies living as tensors in the port's
simulator) behind one real TCP socket. External agent processes join
through the printed seed endpoint with a gateway-routed client: a
``rapid_tpu`` agent (``rapid_tpu/cli/agent.py --gateway-address``) or the
port's own ``messaging.gateway.GatewayRoutedClient``.

    python -m rapid_tpu_torch.cli.gateway --listen-address 127.0.0.1:4000 \\
        --n-virtual 1000

It runs on the CUDA device unless ``--device cpu`` is given; without a card
and without ``--device cpu`` it fails, and never falls back to the CPU.
Prints ``SEED <endpoint>`` on startup and one status line per second:
``swarm size=N config=C`` plus a line per decided view change. On Ctrl-C
(SIGINT) with ``--snapshot PATH`` it checkpoints the swarm there first.
"""

import argparse
import logging
import time


def main() -> None:
    parser = argparse.ArgumentParser(description="rapid-tpu swarm gateway (PyTorch/CUDA)")
    parser.add_argument("--listen-address", required=True, help="host:port to bind")
    parser.add_argument("--n-virtual", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0, help="simulator RNG seed")
    parser.add_argument("--pump-interval-ms", type=int, default=100)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the swarm (default cuda; cpu to leave the card)",
    )
    parser.add_argument(
        "--restore-from", help="resume from a swarm snapshot (same config id)"
    )
    parser.add_argument(
        "--snapshot", help="checkpoint the swarm to this path on Ctrl-C"
    )
    parser.add_argument(
        "--native-server", action="store_true",
        help="accept routed frames on the C++ epoll reactor "
        "(rapid_tpu_torch/csrc/host/rapid_io.cpp) instead of the Python accept loop",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("gateway")

    from rapid_tpu_torch.messaging.gateway import SwarmGateway
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.types import Endpoint

    listen = Endpoint.from_string(args.listen_address)
    if args.restore_from:
        # identity/config come from the snapshot; n_virtual/seed must not be
        # passed alongside (SwarmGateway rejects the combination)
        gateway = SwarmGateway(
            listen,
            settings=Settings(),
            pump_interval_ms=args.pump_interval_ms,
            restore_from=args.restore_from,
            native_server=args.native_server,
            device=args.device,
        )
    else:
        gateway = SwarmGateway(
            listen,
            n_virtual=args.n_virtual,
            seed=args.seed,
            settings=Settings(),
            pump_interval_ms=args.pump_interval_ms,
            native_server=args.native_server,
            device=args.device,
        )
    gateway.start()
    log.info("warming the swarm engine (first kernel build and decisions)...")
    gateway.warm()
    seed_ep = gateway.seed_endpoint()
    log.info(
        "gateway up at %s hosting %d members (%s) on %s; seed endpoint %s",
        listen,
        gateway.membership_size(),
        f"restored from {args.restore_from}" if args.restore_from else "fresh",
        gateway.device,
        seed_ep,
    )
    print(f"SEED {seed_ep}", flush=True)  # noqa: print-in-lib

    seen_decisions = 0
    try:
        while True:
            time.sleep(1)
            decisions = gateway.decisions()
            for rec in decisions[seen_decisions:]:
                log.info(
                    "view change: cut=%d added=%d removed=%d",
                    len(rec.cut),
                    len(rec.added),
                    len(rec.removed),
                )
            seen_decisions = len(decisions)
            log.info(
                "swarm size=%d config=%d",
                gateway.membership_size(),
                gateway.configuration_id(),
            )
    except KeyboardInterrupt:
        if args.snapshot:
            gateway.save(args.snapshot)
            log.info("snapshot written to %s", args.snapshot)
        gateway.shutdown()


if __name__ == "__main__":
    main()
