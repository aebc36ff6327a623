"""rapid-slo: the SLO plane's alert view over the cluster-status RPC.

The port's counterpart of ``tools/slo.py``, over the port's own framed-TCP
transport and modules: the same functions, flags, output and exit codes.
Polls one or more members and renders each node's burn-rate alerts with
their churn-episode attribution, correlated against the same journal tail
the status response carries -- the operator's one-liner for "are we
burning budget, and which membership event did it":

    SLO burning: p99 latency (serving.latency:fast, burn 42.1x),
      attributed to view-change episode 7 (3 nodes evicted, 41 partitions moved)

    python -m rapid_tpu_torch.cli.slo 127.0.0.1:1234 127.0.0.1:1235
    python -m rapid_tpu_torch.cli.slo --json 127.0.0.1:1234

Exit code 0 when no alert is firing anywhere, 1 on unreachable targets,
3 when any member reports a firing burn alert (greppable for probes). It
needs no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from rapid_tpu_torch import Endpoint, Settings
from rapid_tpu_torch.cli.statusz import fetch_status
from rapid_tpu_torch.messaging.tcp import TcpClientServer
from rapid_tpu_torch.slo import describe, episodes_from_journal
from rapid_tpu_torch.types import ClusterStatusResponse

# human labels for the declared SLOs (fallback: the catalog name itself)
SLO_LABELS = {
    "serving.latency": "p99 latency",
    "serving.availability": "availability",
}


def render_slo(status: ClusterStatusResponse) -> str:
    """Pure renderer: one line per (SLO, window-pair) alert, firing alerts
    first, each attributed against the episodes parsed from the journal
    tail the same response carries."""
    lines = [f"{status.sender}  config={status.configuration_id}"]
    if not status.slo_names:
        lines.append("  (no SLO plane -- settings.slo.enabled is off)")
        return "\n".join(lines)
    episodes = episodes_from_journal(status.journal)
    by_trace = {int(e.trace_id): e for e in episodes if e.trace_id}
    rows = sorted(
        zip(status.slo_names, status.slo_burn_milli, status.slo_firing,
            status.slo_attributed_trace),
        key=lambda row: (-row[2], row[0]),
    )
    for name, burn_milli, firing, trace in rows:
        slo, _, window = name.partition(":")
        label = SLO_LABELS.get(slo, slo)
        burn = burn_milli / 1000.0
        if firing:
            episode = by_trace.get(int(trace))
            attributed = (
                describe(episode) if episode is not None
                else f"episode trace {trace}" if trace
                else "unattributed (no overlapping membership episode)"
            )
            lines.append(
                f"  SLO burning: {label} ({name}, burn {burn:.1f}x), "
                f"attributed to {attributed}"
            )
        else:
            lines.append(f"  SLO ok: {label} ({name}) burn={burn:.2f}x")
    return "\n".join(lines)


def to_json(status: ClusterStatusResponse) -> dict:
    episodes = episodes_from_journal(status.journal)
    by_trace = {int(e.trace_id): e for e in episodes if e.trace_id}
    alerts = {}
    for name, burn_milli, firing, trace in zip(
        status.slo_names, status.slo_burn_milli, status.slo_firing,
        status.slo_attributed_trace,
    ):
        episode = by_trace.get(int(trace)) if trace else None
        alerts[name] = {
            "burn": burn_milli / 1000.0,
            "firing": bool(firing),
            "attributed_trace": int(trace),
            "attributed": describe(episode) if episode is not None else None,
        }
    return {
        "node": str(status.sender),
        "configuration_id": status.configuration_id,
        "alerts": alerts,
        "firing": sum(1 for a in alerts.values() if a["firing"]),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="poll rapid-tpu agents' SLO burn-rate alerts"
    )
    parser.add_argument("targets", nargs="+", help="host:port of live agents")
    parser.add_argument("--timeout", type=float, default=5.0)
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit one JSON object per target")
    args = parser.parse_args(argv)
    # client half only: no start() means no listening socket is ever bound
    client = TcpClientServer(Endpoint(b"127.0.0.1", 0), Settings())
    rc = 0
    firing_total = 0
    try:
        for raw in args.targets:
            target = Endpoint.from_string(raw)
            try:
                status = fetch_status(client, target, args.timeout)
            except Exception as exc:  # noqa: BLE001 -- report, keep polling
                print(f"{raw}: unreachable ({exc})", file=sys.stderr)
                rc = 1
                continue
            firing_total += sum(status.slo_firing)
            if args.as_json:
                print(json.dumps(to_json(status), sort_keys=True))
            else:
                print(render_slo(status))
    finally:
        client.shutdown()
    if firing_total:
        print(
            f"WARNING: {firing_total} burn alert(s) firing", file=sys.stderr
        )
        rc = max(rc, 3)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
