"""Standalone cluster agent over the real TCP transport.

The port's own copy of ``rapid_tpu/cli/agent.py``, on the port's framed-TCP
transport (``messaging/tcp.py``). Equivalent of the reference's CLI agent
(StandaloneAgent.java:94-116): start a seed with --listen-address only, or
join via --seed-address; subscribes to the cluster events and prints the
membership once per second; SIGINT leaves gracefully.

    python -m rapid_tpu_torch.cli.agent --listen-address 127.0.0.1:1234
    python -m rapid_tpu_torch.cli.agent --listen-address 127.0.0.1:1235 \
        --seed-address 127.0.0.1:1234
    python -m rapid_tpu_torch.cli.agent --status 127.0.0.1:1235

A member of a swarm hosted by ``python -m rapid_tpu_torch.cli.gateway``
joins with ``--gateway-address <gateway host:port> --seed-address <a swarm
endpoint>`` (the gateway prints its seed endpoint). ``--serving`` turns on
the serving demo (placement, handoff and serving on an in-memory store; each
tick writes and reads back a demo key). ``--transport native-tcp`` puts the
server half on the port's C++ epoll reactor (``messaging/native_tcp.py``);
``--transport grpc`` speaks the reference's gRPC wire
(``messaging/grpc_transport.py`` over the port's own HTTP/2,
``messaging/http2.py``), with JVM Rapid peers and the JAX package's grpcio
agents alike.
"""

import argparse
import json
import logging
import os
import sys
import tempfile
import time

from rapid_tpu_torch import ClusterBuilder, ClusterEvents, Endpoint, Settings
from rapid_tpu_torch.messaging.tcp import TcpClientServer


def _write_prometheus_atomic(path: str) -> None:
    """Rewrite the exposition file atomically: a scraper that reads during a
    tick sees either the previous complete file or the new complete file,
    never a truncated one."""
    from rapid_tpu_torch.observability import prometheus_text

    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".prom-", dir=directory)
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(prometheus_text())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def query_status(target_raw: str, timeout_s: float):
    """One ClusterStatusRequest to the agent at ``target_raw`` (host:port),
    through ``cli.statusz.fetch_status``: its ClusterStatusResponse (a
    reply of another class raises RuntimeError)."""
    from rapid_tpu_torch.cli.statusz import fetch_status

    client = TcpClientServer(Endpoint(b"127.0.0.1", 0), Settings())
    try:
        return fetch_status(client, Endpoint.from_string(target_raw), timeout_s)
    finally:
        client.shutdown()


def _print_status(target_raw: str, timeout_s: float) -> int:
    """--status mode: one-shot ClusterStatusRequest against a live agent."""
    try:
        reply = query_status(target_raw, timeout_s)
    except RuntimeError as exc:  # a reply of another class
        sys.stdout.write(f"{exc}\n")
        return 1
    lines = [
        f"{reply.sender}  config={reply.configuration_id}"
        f"  members={reply.membership_size}",
        f"  cut-detector: tracked={reply.reports_tracked}"
        f" pre-proposal={reply.pre_proposal_size}"
        f" proposal={reply.proposal_size}"
        f" in-progress={reply.updates_in_progress}",
        f"  consensus: decided={reply.consensus_decided}"
        f" votes={reply.consensus_votes}",
    ]
    for name, value in zip(reply.metric_names, reply.metric_values):
        lines.append(f"  metric {name} = {value}")
    for raw in reply.journal:
        try:
            entry = json.loads(raw)
            lines.append(
                f"  journal [{entry.get('seq')}] {entry.get('kind')}"
                f" @{entry.get('virtual_ms')}ms {entry.get('detail', {})}"
            )
        except (ValueError, TypeError):
            lines.append(f"  journal {raw}")
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


def main() -> None:
    parser = argparse.ArgumentParser(description="rapid-tpu standalone agent")
    parser.add_argument(
        "--status", metavar="ADDR",
        help="client-only mode: query ADDR's cluster-status RPC (config id, "
        "view size, cut-detector occupancy, consensus state, metrics digest, "
        "journal tail), print it, and exit",
    )
    parser.add_argument("--listen-address", help="host:port to listen on")
    parser.add_argument("--seed-address", help="host:port of a seed to join")
    parser.add_argument(
        "--gateway-address",
        help="host:port of a SwarmGateway; destinations whose hostname is not "
        "in the direct set (the swarm's virtual endpoints) ride this connection",
    )
    parser.add_argument(
        "--direct-host",
        action="append",
        default=[],
        help="additional hostname reached directly rather than via the "
        "gateway (repeatable; loopback and this agent's own hostname are "
        "always direct). Required for multi-host deployments so peer agents "
        "on other machines are not misrouted to the gateway",
    )
    parser.add_argument("--fd-interval-ms", type=int, default=1000)
    parser.add_argument(
        "--fd-policy", choices=("cumulative", "windowed"), default="cumulative",
        help="cumulative = reference parity (never-reset counter); "
        "windowed = the paper's '40%% of last N probes' policy",
    )
    parser.add_argument("--fd-window", type=int, default=10)
    parser.add_argument("--fd-window-threshold", type=float, default=0.4)
    parser.add_argument(
        "--transport", choices=("tcp", "native-tcp", "grpc"), default="tcp",
        help="tcp = framed-TCP transport; native-tcp = the same wire with the "
        "server half on the C++ epoll reactor; grpc = wire-compatible with JVM "
        "Rapid",
    )
    parser.add_argument(
        "--broadcaster", choices=("unicast", "gossip"), default="unicast",
        help="unicast = reference-parity unicast-to-all; gossip = epidemic "
        "relay (needs a native-codec transport, not grpc)",
    )
    parser.add_argument("--gossip-fanout", type=int, default=4)
    parser.add_argument(
        "--join-timeout", type=float, default=60.0,
        help="seconds to wait for the two-phase join (bootstrapping into a "
        "very large view takes longer: the full configuration must be "
        "shipped and the member's rings built)",
    )
    parser.add_argument(
        "--metrics-out",
        help="path rewritten once per status tick with the Prometheus text "
        "exposition of this agent's metrics (point node_exporter's textfile "
        "collector or a file-based scraper at it)",
    )
    parser.add_argument(
        "--trace-out",
        help="path written on shutdown with a Chrome trace_event JSON of the "
        "agent's spans (load in Perfetto / chrome://tracing)",
    )
    parser.add_argument(
        "--journal-out",
        help="path written on shutdown with the flight-recorder journal "
        "(JSON lines, newest last): the last N membership-relevant events "
        "this node saw",
    )
    parser.add_argument(
        "--forensics", action="store_true",
        help="enable the forensics plane: HLC stamps on every message and "
        "journal entry, burn-alert evidence capture, and crash/exit "
        "journal hooks (with --journal-out, the dump also happens via "
        "atexit + a faulthandler traceback file for hard crashes)",
    )
    parser.add_argument(
        "--bundle-out",
        help="path written on shutdown with a cluster-wide incident "
        "evidence bundle (implies --forensics): this agent's evidence plus "
        "a status sweep of every reachable member; feed the file to "
        "tools/forensics.py report",
    )
    parser.add_argument(
        "--serving", action="store_true",
        help="demo mode: enable the serving plane (replicated Get/Put KV "
        "over placement + handoff) on this agent; every status tick writes "
        "a per-agent demo key through the quorum path, reads it back, and "
        "logs the serving counters",
    )
    parser.add_argument(
        "--serving-partitions", type=int, default=64,
        help="placement partition count for --serving mode",
    )
    parser.add_argument("--status-timeout", type=float, default=5.0,
                        help="seconds to wait in --status mode")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    if args.status:
        raise SystemExit(_print_status(args.status, args.status_timeout))
    if not args.listen_address:
        parser.error("--listen-address is required (except in --status mode)")

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("agent")

    listen = Endpoint.from_string(args.listen_address)
    settings = Settings(
        failure_detector_interval_ms=args.fd_interval_ms,
        fd_policy=args.fd_policy,
        fd_window=args.fd_window,
        fd_window_threshold=args.fd_window_threshold,
    )
    if args.forensics or args.bundle_out:
        import dataclasses

        from rapid_tpu_torch.settings import ForensicsSettings

        settings = dataclasses.replace(
            settings, forensics=ForensicsSettings(enabled=True)
        )
    if args.transport == "grpc":
        if args.gateway_address:
            parser.error(
                "--gateway-address requires the tcp transport: the gateway "
                "delivers swarm traffic over framed TCP to the agent's server"
            )
        from rapid_tpu_torch.messaging.grpc_transport import GrpcClient, GrpcServer

        client, server = GrpcClient(listen, settings), GrpcServer(listen)
    elif args.transport == "native-tcp":
        from rapid_tpu_torch.messaging.native_tcp import NativeTcpClientServer

        client = server = NativeTcpClientServer(listen, settings)
    else:
        client = server = TcpClientServer(listen, settings)
    if args.gateway_address:
        if args.broadcaster == "gossip":
            parser.error(
                "--broadcaster gossip cannot ride a gateway (the swarm has "
                "no gossip relay); gateway mode uses the swarm broadcaster"
            )
        from rapid_tpu_torch.messaging.gateway import (
            DEFAULT_DIRECT_HOSTS,
            GatewayRoutedClient,
        )

        direct = set(DEFAULT_DIRECT_HOSTS)
        direct.update(h.encode() for h in args.direct_host)
        client = GatewayRoutedClient(
            listen, Endpoint.from_string(args.gateway_address), client, settings,
            direct_hosts=direct,
        )

    def on_event(name):
        def callback(configuration_id, changes):
            log.info("%s config=%d changes=%s", name, configuration_id,
                     [str(c) for c in changes])

        return callback

    builder = (
        ClusterBuilder(listen)
        .use_settings(settings)
        .set_messaging_client_and_server(client, server)
        .add_subscription(ClusterEvents.VIEW_CHANGE_PROPOSAL, on_event("VIEW_CHANGE_PROPOSAL"))
        .add_subscription(ClusterEvents.VIEW_CHANGE, on_event("VIEW_CHANGE"))
        .add_subscription(ClusterEvents.KICKED, on_event("KICKED"))
    )
    if settings.forensics.enabled and args.journal_out:
        # crash/exit evidence: atexit journal dump + faulthandler traceback
        # file beside it, in addition to the explicit dump on shutdown below
        builder.use_forensics_dump(args.journal_out)
    if args.serving:
        from rapid_tpu_torch.handoff.store import InMemoryPartitionStore

        builder.use_placement(partitions=args.serving_partitions)
        builder.use_serving(InMemoryPartitionStore())
    if args.broadcaster == "gossip":
        if args.gossip_fanout < 1:
            parser.error("--gossip-fanout must be >= 1")
        from rapid_tpu_torch.messaging.gossip import GossipBroadcaster

        builder.set_broadcaster_factory(
            lambda c, rng: GossipBroadcaster(
                c, listen, fanout=args.gossip_fanout, rng=rng
            )
        )
    elif args.gateway_address:
        # swarm-bound broadcast fan-out collapses to one wildcard frame;
        # unicast-to-all through one socket does not scale to large swarms
        from rapid_tpu_torch.messaging.gateway import GatewaySwarmBroadcaster

        builder.set_broadcaster_factory(
            lambda c, rng, routed=client: GatewaySwarmBroadcaster(routed)
        )
    if args.seed_address:
        cluster = builder.join(
            Endpoint.from_string(args.seed_address), timeout=args.join_timeout
        )
    else:
        cluster = builder.start()
    log.info("agent started at %s", listen)

    demo_key = b"agent-demo:" + args.listen_address.encode()

    try:
        while True:
            time.sleep(1)
            members = cluster.get_memberlist()
            log.info(
                "membership size=%d config=%d members=%s",
                len(members),
                cluster.get_current_configuration_id(),
                [str(m) for m in members] if len(members) <= 32 else "...",
            )
            if args.serving:
                # the demo loop: one quorum write + one routed read per
                # tick, so a multi-agent deployment visibly replicates
                try:
                    value = b"tick-%d" % int(time.time())
                    cluster.serving_put(demo_key, value).result(5.0)
                    back = cluster.serving_get(demo_key).result(5.0)
                    gets, puts, put_acks = cluster.get_serving_status()
                    log.info(
                        "serving key=%s value=%s gets=%d puts=%d acks=%d",
                        demo_key.decode(), back.value.decode(),
                        gets, puts, put_acks,
                    )
                except Exception as exc:  # noqa: BLE001 -- demo, keep ticking
                    log.warning("serving demo op failed: %s", exc)
            if args.metrics_out:
                _write_prometheus_atomic(args.metrics_out)
    except KeyboardInterrupt:
        if args.bundle_out:
            # capture while the cluster is still a member: the sweep needs
            # live peers, so it runs before the graceful leave
            try:
                cluster.capture_bundle(args.bundle_out)
                log.info("wrote evidence bundle to %s", args.bundle_out)
            except Exception as exc:  # noqa: BLE001 -- still leave cleanly
                log.warning("bundle capture failed: %s", exc)
        cluster.leave_gracefully()
    finally:
        if args.trace_out:
            from rapid_tpu_torch.observability import write_chrome_trace

            write_chrome_trace(args.trace_out)
            log.info("wrote Chrome trace to %s", args.trace_out)
        if args.journal_out:
            cluster.flight_recorder.dump(args.journal_out)
            log.info("wrote flight-recorder journal to %s", args.journal_out)


if __name__ == "__main__":
    main()
