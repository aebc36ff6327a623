"""rapid-top: poll the cluster-status introspection RPC of live agents.

The port's counterpart of ``tools/statusz.py``, over the port's own
framed-TCP transport and modules: the same functions, flags, output and exit
codes. Sends a ``ClusterStatusRequest`` to one or more members and renders
each answer: configuration id, view size, cut-detector watermark occupancy,
consensus round state, a compact metrics digest, and the tail of the node's
flight-recorder journal. Because the request is answered on the protocol
executor, the numbers are a consistent snapshot of that node's protocol
state, and disagreement in ``config`` across members is itself the finding.

    python -m rapid_tpu_torch.cli.statusz 127.0.0.1:1234 127.0.0.1:1235
    python -m rapid_tpu_torch.cli.statusz --json --journal 10 127.0.0.1:1234
    python -m rapid_tpu_torch.cli.statusz --history 32 127.0.0.1:1234 127.0.0.1:1235

Exit code 0 when every member answered and they agree, 1 on an unreachable
member, 2 when members disagree on the configuration id within a cell, the
composed global view, the placement version, partition fingerprints or the
serving leader. It needs no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from rapid_tpu_torch import Endpoint, Settings
from rapid_tpu_torch.messaging.tcp import TcpClientServer
from rapid_tpu_torch.profiling import cluster_timeseries, merge_by_series
from rapid_tpu_torch.types import ClusterStatusRequest, ClusterStatusResponse


def fetch_status(
    client: TcpClientServer, target: Endpoint, timeout_s: float = 5.0,
    include_history: int = 0,
) -> ClusterStatusResponse:
    reply = client.send_message(
        target,
        ClusterStatusRequest(
            sender=client.address, include_history=include_history
        ),
    ).result(timeout_s)
    if not isinstance(reply, ClusterStatusResponse):
        raise RuntimeError(
            f"{target}: unexpected reply {type(reply).__name__}"
        )
    return reply


def render(status: ClusterStatusResponse, journal_lines: int = 5) -> str:
    lines = [
        f"{status.sender}  config={status.configuration_id}"
        f"  members={status.membership_size}",
        f"  cut-detector: tracked={status.reports_tracked}"
        f" pre-proposal={status.pre_proposal_size}"
        f" proposal={status.proposal_size}"
        f" in-progress={status.updates_in_progress}",
        f"  consensus: decided={status.consensus_decided}"
        f" votes={status.consensus_votes}",
    ]
    # hierarchy digest: which cell this member sits in, its parent
    # configuration, and the composed global view it has adopted
    # (hierarchy on <=> global_cells is non-empty)
    if status.global_cells:
        lines.append(
            f"  hierarchy: cell={status.cell_id}"
            f" cell-size={status.cell_size}"
            f" parent-config={status.parent_configuration_id}"
            f" cells={len(status.global_cells)}"
            f" members={sum(status.global_sizes)}"
            f" fingerprint={status.global_fingerprint}"
        )
    if status.placement_partitions:
        lines.append(
            f"  placement: version={status.placement_version}"
            f" partitions={status.placement_partitions}"
            f" owned={status.placement_owned}"
        )
    if (
        status.handoff_in_flight
        or status.handoff_completed
        or status.handoff_failed
        or status.handoff_partitions
    ):
        lines.append(
            f"  handoff: in-flight={status.handoff_in_flight}"
            f" completed={status.handoff_completed}"
            f" failed={status.handoff_failed}"
            f" stored={len(status.handoff_partitions)}"
        )
    if status.serving_gets or status.serving_puts or status.serving_partitions:
        lines.append(
            f"  serving: gets={status.serving_gets}"
            f" puts={status.serving_puts}"
            f" acks={status.serving_put_acks}"
            f" leads={sum(1 for lead in status.serving_leaders if lead == str(status.sender))}"
            f"/{len(status.serving_partitions)}"
        )
    # durability digest: restart health -- how much log a crash would
    # replay (zero right after a checkpoint) and which snapshot anchors it
    if status.durability_segments or status.durability_snapshot_version:
        lines.append(
            f"  durability: segments={status.durability_segments}"
            f" snapshot={status.durability_snapshot_version}"
            f" replayed={status.durability_replayed}"
        )
    # SLO digest: one line per (SLO, window pair) alert -- burn rate in
    # budget multiples, FIRING flag, and the attributed churn episode's
    # trace id when the plane correlated one against the journal
    if status.slo_names:
        alerts = " ".join(
            "{name}={burn:.2f}x{firing}{trace}".format(
                name=name, burn=burn_milli / 1000.0,
                firing=" FIRING" if firing else "",
                trace=f"(episode {trace})" if trace else "",
            )
            for name, burn_milli, firing, trace in zip(
                status.slo_names, status.slo_burn_milli,
                status.slo_firing, status.slo_attributed_trace,
            )
        )
        lines.append(f"  slo: {alerts}")
    # failure-detector digest: the node's worst monitored edges (already
    # sorted suspicion desc, RTT desc by the service), the gray-failure
    # signature an operator checks before any eviction shows up
    if status.fd_subjects:
        worst = list(
            zip(status.fd_subjects, status.fd_rtt_micros,
                status.fd_suspicion_milli)
        )[:3]
        edges = " ".join(
            f"{subject}(rtt={rtt_us / 1000.0:.1f}ms"
            f" susp={susp / 1000.0:.2f})"
            for subject, rtt_us, susp in worst
        )
        lines.append(f"  fd-edges: monitored={len(status.fd_subjects)} {edges}")
    if status.fd_tiers:
        tiers = " ".join(
            f"{tier}(interval={interval}ms threshold={threshold}"
            f" flush={flush}ms)"
            for tier, interval, threshold, flush in zip(
                status.fd_tiers, status.fd_tier_interval_ms,
                status.fd_tier_threshold, status.fd_tier_flush_ms,
            )
        )
        lines.append(f"  fd-tiers: {tiers}")
    # transport summary: per-peer outbound queue depths (the backpressure
    # signature of a slow-reading peer) get a first-class line above the
    # raw metric digest they also appear in
    depths = [
        (name[len("msg.queue_depth{peer="):-1], value)
        for name, value in zip(status.metric_names, status.metric_values)
        if name.startswith("msg.queue_depth{peer=")
    ]
    if depths:
        total = sum(v for _, v in depths)
        deepest = max(depths, key=lambda kv: kv[1])
        lines.append(
            f"  transport: peers={len(depths)}"
            f" queued-bytes={total:.0f}"
            f" deepest={deepest[0]}:{deepest[1]:.0f}"
        )
    for name, value in zip(status.metric_names, status.metric_values):
        lines.append(f"  metric {name} = {value}")
    tail = status.journal[-journal_lines:] if journal_lines else ()
    for raw in tail:
        try:
            entry = json.loads(raw)
            lines.append(
                "  journal [{seq}] {kind} @{virtual_ms}ms {detail}".format(
                    seq=entry.get("seq"), kind=entry.get("kind"),
                    virtual_ms=entry.get("virtual_ms"),
                    detail=entry.get("detail", {}),
                )
            )
        except (ValueError, TypeError):
            lines.append(f"  journal {raw}")
    return "\n".join(lines)


def to_json(status: ClusterStatusResponse) -> dict:
    return {
        "node": str(status.sender),
        "configuration_id": status.configuration_id,
        "membership_size": status.membership_size,
        "reports_tracked": status.reports_tracked,
        "pre_proposal_size": status.pre_proposal_size,
        "proposal_size": status.proposal_size,
        "updates_in_progress": status.updates_in_progress,
        "consensus_decided": status.consensus_decided,
        "consensus_votes": status.consensus_votes,
        "hierarchy": {
            "cell_id": status.cell_id,
            "cell_size": status.cell_size,
            "parent_configuration_id": status.parent_configuration_id,
            "global_fingerprint": status.global_fingerprint,
            "cells": {
                str(cell): {"epoch": epoch, "size": size, "leader": leader}
                for cell, epoch, size, leader in zip(
                    status.global_cells, status.global_epochs,
                    status.global_sizes, status.global_leaders,
                )
            },
        } if status.global_cells else None,
        "placement_version": status.placement_version,
        "placement_partitions": status.placement_partitions,
        "placement_owned": status.placement_owned,
        "handoff_in_flight": status.handoff_in_flight,
        "handoff_completed": status.handoff_completed,
        "handoff_failed": status.handoff_failed,
        "handoff_partitions": {
            str(p): fp
            for p, fp in zip(
                status.handoff_partitions, status.handoff_fingerprints
            )
        },
        "durability_segments": status.durability_segments,
        "durability_snapshot_version": status.durability_snapshot_version,
        "durability_replayed": status.durability_replayed,
        "serving_gets": status.serving_gets,
        "serving_puts": status.serving_puts,
        "serving_put_acks": status.serving_put_acks,
        "serving_leaders": {
            str(p): leader
            for p, leader in zip(
                status.serving_partitions, status.serving_leaders
            )
        },
        "fd_edges": {
            subject: {
                "rtt_ms": rtt_us / 1000.0,
                "suspicion": susp / 1000.0,
            }
            for subject, rtt_us, susp in zip(
                status.fd_subjects, status.fd_rtt_micros,
                status.fd_suspicion_milli,
            )
        },
        "fd_tiers": {
            tier: {
                "interval_ms": interval,
                "threshold": threshold,
                "flush_ms": flush,
            }
            for tier, interval, threshold, flush in zip(
                status.fd_tiers, status.fd_tier_interval_ms,
                status.fd_tier_threshold, status.fd_tier_flush_ms,
            )
        },
        "slo_alerts": {
            name: {
                "burn": burn_milli / 1000.0,
                "firing": bool(firing),
                "attributed_trace": trace,
            }
            for name, burn_milli, firing, trace in zip(
                status.slo_names, status.slo_burn_milli,
                status.slo_firing, status.slo_attributed_trace,
            )
        },
        "metrics": dict(zip(status.metric_names, status.metric_values)),
        "journal": [json.loads(line) for line in status.journal],
        "history": [json.loads(line) for line in status.history],
    }


def render_timeseries(statuses: List[ClusterStatusResponse],
                      max_series: int = 12) -> str:
    """The cluster-wide timeseries view assembled from every scraped
    member's history ring: one line per (series, node) with span, point
    count and last value -- the operator's "what moved, where" summary."""
    by_series = merge_by_series(cluster_timeseries(statuses))
    lines = ["cluster timeseries:"]
    if not by_series:
        lines.append("  (no history scraped -- profiling off or old peers)")
        return "\n".join(lines)
    for name in sorted(by_series)[:max_series]:
        for node, points in sorted(by_series[name].items()):
            first_ts, _ = points[0]
            last_ts, last = points[-1]
            lines.append(
                f"  {name} @{node}: n={len(points)}"
                f" span={last_ts - first_ts:.1f}s last={last:g}"
            )
    if len(by_series) > max_series:
        lines.append(f"  ... and {len(by_series) - max_series} more series")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="poll rapid-tpu agents' cluster-status RPC"
    )
    parser.add_argument("targets", nargs="+", help="host:port of live agents")
    parser.add_argument("--timeout", type=float, default=5.0)
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit one JSON object per target")
    parser.add_argument("--journal", type=int, default=5,
                        help="journal tail lines to show (text mode)")
    parser.add_argument("--history", type=int, default=0,
                        help="metric history snapshots to scrape per node; "
                        "also renders the assembled cluster timeseries")
    args = parser.parse_args(argv)
    # client half only: no start() means no listening socket is ever bound
    client = TcpClientServer(Endpoint(b"127.0.0.1", 0), Settings())
    rc = 0
    # cell id (None = flat member) -> configuration ids seen there. In
    # hierarchical mode each cell is its own Rapid cluster, so members of
    # *different* cells legitimately carry different (cell-local) config
    # ids -- disagreement only means trouble within one cell.
    configs: dict = {}
    placements = set()
    # composed global-view fingerprints from hierarchy-enabled members
    hier_fps = set()
    # partition id -> set of content fingerprints reported by its holders
    fingerprints: dict = {}
    # partition id -> set of serving leaders reported by its replicas
    leaders: dict = {}
    statuses: List[ClusterStatusResponse] = []
    try:
        for raw in args.targets:
            target = Endpoint.from_string(raw)
            try:
                # only the history-bearing form passes the extra argument:
                # the plain poll keeps the pre-profiling 3-arg call shape
                # (monkeypatched in the handoff/serving statusz tests)
                if args.history:
                    status = fetch_status(
                        client, target, args.timeout,
                        include_history=args.history,
                    )
                else:
                    status = fetch_status(client, target, args.timeout)
            except Exception as exc:  # noqa: BLE001 -- report and keep polling
                print(f"{raw}: unreachable ({exc})", file=sys.stderr)
                rc = 1
                continue
            statuses.append(status)
            cell_key = status.cell_id if status.global_cells else None
            configs.setdefault(cell_key, set()).add(status.configuration_id)
            if status.placement_partitions:
                placements.add(status.placement_version)
            if status.global_cells:
                hier_fps.add(status.global_fingerprint)
            for part, fp in zip(
                status.handoff_partitions, status.handoff_fingerprints
            ):
                fingerprints.setdefault(part, set()).add(fp)
            for part, leader in zip(
                status.serving_partitions, status.serving_leaders
            ):
                leaders.setdefault(part, set()).add(leader)
            if args.as_json:
                print(json.dumps(to_json(status), sort_keys=True))
            else:
                print(render(status, journal_lines=args.journal))
        if args.history and not args.as_json and statuses:
            print(render_timeseries(statuses))
    finally:
        client.shutdown()
    for cell_key in sorted(configs, key=lambda k: (k is not None, k or 0)):
        ids = configs[cell_key]
        if len(ids) <= 1:
            continue
        scope = ("configuration id" if cell_key is None
                 else f"cell {cell_key} configuration id")
        print(
            f"WARNING: members disagree on {scope}: {sorted(ids)}",
            file=sys.stderr,
        )
        rc = max(rc, 2)
    # the composed global view folds every cell's (epoch, size, leader,
    # membership) into one integer, so fingerprint disagreement among
    # hierarchy-enabled members is the cross-cell analogue of config-id
    # disagreement: somebody has not adopted the parent decision
    if len(hier_fps) > 1:
        print(
            "WARNING: members disagree on the composed global view "
            f"fingerprint: {sorted(hier_fps)}",
            file=sys.stderr,
        )
        rc = max(rc, 2)
    # the placement map is a pure function of the configuration, so version
    # disagreement among placement-enabled members is the same class of
    # finding as config-id disagreement (split-brain / drifted map function)
    if len(placements) > 1:
        print(
            "WARNING: members disagree on placement map version: "
            f"{sorted(placements)}",
            file=sys.stderr,
        )
        rc = max(rc, 2)
    # replicas of a partition must hold byte-identical content once handoff
    # has drained; divergent fingerprints mean a corrupt or torn transfer
    # survived verification somewhere, which is the same severity of finding
    # as a split-brain configuration
    torn = sorted(p for p, fps in fingerprints.items() if len(fps) > 1)
    if torn:
        print(
            "WARNING: replicas disagree on partition content fingerprints: "
            f"partitions {torn}",
            file=sys.stderr,
        )
        rc = max(rc, 2)
    # the serving leader is a pure function of the placement row (first
    # live replica in placement order), so two replicas of one partition
    # naming different leaders is a split-brain write path: both would
    # accept quorum writes for the same keys
    split = sorted(p for p, who in leaders.items() if len(who) > 1)
    if split:
        print(
            "WARNING: replicas disagree on the serving leader: "
            f"partitions {split}",
            file=sys.stderr,
        )
        rc = max(rc, 2)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
