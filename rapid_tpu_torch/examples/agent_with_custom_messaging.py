"""Agent demonstrating the messaging plugin seam with a custom transport.

The port's counterpart of ``examples/agent_with_custom_messaging.py``, the
equivalent of the reference's AgentWithNettyMessaging
(examples/.../AgentWithNettyMessaging.java:58-67): the default agent uses the
wire-compatible gRPC transport; this one injects the port's framed-TCP
transport via set_messaging_client_and_server -- the same seam any user
transport plugs into (IMessagingClient/IMessagingServer, messaging/base.py).
It runs no device work.

    python -m rapid_tpu_torch.examples.agent_with_custom_messaging \\
        --listen-address 127.0.0.1:1234
    python -m rapid_tpu_torch.examples.agent_with_custom_messaging \\
        --listen-address 127.0.0.1:1235 --seed-address 127.0.0.1:1234

Runs until interrupted (Ctrl-C: it shuts down and exits 0), unless
``--run-for-s`` (then it leaves and exits 0) or ``--until-size`` (it exits 0
once the membership reaches that size, 1 if 60 s pass first) bounds it.
"""

import argparse
import logging
import time

from rapid_tpu_torch import ClusterBuilder, Endpoint, Settings
from rapid_tpu_torch.messaging.tcp import TcpClientServer

UNTIL_SIZE_TIMEOUT_S = 60.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--listen-address", required=True)
    parser.add_argument("--seed-address")
    parser.add_argument("--run-for-s", type=float, default=None,
                        help="leave and exit 0 after this many seconds")
    parser.add_argument("--until-size", type=int, default=None,
                        help="exit 0 once the membership reaches this size "
                             f"(1 after {UNTIL_SIZE_TIMEOUT_S:.0f} s)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    listen = Endpoint.from_string(args.listen_address)
    settings = Settings()
    transport = TcpClientServer(listen, settings)  # the custom transport
    builder = (
        ClusterBuilder(listen)
        .use_settings(settings)
        .set_messaging_client_and_server(transport, transport)
    )
    cluster = (
        builder.join(Endpoint.from_string(args.seed_address))
        if args.seed_address
        else builder.start()
    )
    logging.info("started %s over custom TCP messaging", cluster)
    started = time.monotonic()
    poll_s = 1.0 if args.until_size is None else 0.1
    try:
        while True:
            size = cluster.get_membership_size()
            if args.until_size is not None and size >= args.until_size:
                logging.info("membership size=%d reached", size)
                return 0
            elapsed = time.monotonic() - started
            if args.run_for_s is not None and elapsed >= args.run_for_s:
                cluster.leave_gracefully()
                return 0
            if args.until_size is not None and elapsed >= UNTIL_SIZE_TIMEOUT_S:
                logging.error("membership size=%d after %.0f s", size, elapsed)
                return 1
            time.sleep(poll_s)
            if args.until_size is None:
                logging.info("membership size=%d", cluster.get_membership_size())
    except KeyboardInterrupt:
        return 0
    finally:
        cluster.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
