"""forensics: merge evidence bundles into a causal timeline and judge it.

The port's counterpart of ``tools/forensics.py``: the same subcommands,
flags, output and exit codes, on ``rapid_tpu_torch.forensics``.

Two subcommands over the forensics plane's artifacts (the bundle files
``Cluster.capture_bundle()`` / ``agent --bundle-out`` write, and the
``.bundle.json`` sidecars ``rapid_tpu_torch.cli.hunt --forensics --pin``
writes):

``report`` -- merge one or more bundles into a single HLC-ordered cluster
timeline, run the anomaly-signature detectors over it
(SIGNATURE_CATALOG: view divergence, stuck handoff, deposed-leader
writes, alert-storm -> burn chains), and render the operator report.
``--json`` emits the machine form instead; ``--trace-out`` additionally
writes a Chrome-trace (chrome://tracing / Perfetto) file with every
journal event as an instant on the HLC axis, one track per node. Exit 3
when any signature is detected, 0 on a clean timeline, 2 when a bundle
cannot be read or holds no journal event.

``verify`` -- recompute a bundle's manifest fingerprint (rc 3 on
mismatch), so a bundle quoted in an incident review can be authenticated.

    python -m rapid_tpu_torch.cli.forensics report bundle.json
    python -m rapid_tpu_torch.cli.forensics report n1.json n2.json --json --trace-out t.json
    python -m rapid_tpu_torch.cli.forensics verify bundle.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..forensics.bundle import load_bundle, verify_bundle
from ..forensics.timeline import (
    DEFAULT_DIVERGENCE_GRACE_MS,
    DEFAULT_STORM_MIN_EVENTS,
    detect_signatures,
    merge_timeline,
    report_text,
    timeline_chrome_trace,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="merge forensic evidence bundles and detect anomaly "
        "signatures on the HLC-ordered cluster timeline"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_report = sub.add_parser(
        "report", help="HLC-ordered timeline + signature verdicts "
        "(rc 3 when any signature is detected)"
    )
    p_report.add_argument("bundles", nargs="+",
                          help="evidence bundle JSON file(s)")
    p_report.add_argument("--json", action="store_true", dest="as_json",
                          help="emit the machine-readable report")
    p_report.add_argument("--trace-out", default=None,
                          help="also write a Chrome trace on the HLC axis")
    p_report.add_argument("--grace-ms", type=int,
                          default=DEFAULT_DIVERGENCE_GRACE_MS,
                          help="view-divergence propagation grace window "
                          f"(default {DEFAULT_DIVERGENCE_GRACE_MS})")
    p_report.add_argument("--storm-min", type=int,
                          default=DEFAULT_STORM_MIN_EVENTS,
                          help="alert events inside an episode that count "
                          f"as a storm (default {DEFAULT_STORM_MIN_EVENTS})")

    p_verify = sub.add_parser(
        "verify", help="recompute a bundle's manifest fingerprint"
    )
    p_verify.add_argument("bundle")

    args = parser.parse_args(argv)

    if args.cmd == "verify":
        try:
            bundle = load_bundle(args.bundle)
        except (OSError, ValueError) as exc:
            print(f"{args.bundle}: {exc}", file=sys.stderr)
            return 2
        if verify_bundle(bundle):
            print(f"{args.bundle}: fingerprint ok "
                  f"({bundle['manifest']['fingerprint'][:12]})")
            return 0
        print(f"{args.bundle}: FINGERPRINT MISMATCH", file=sys.stderr)
        return 3

    # report
    bundles = []
    for path in args.bundles:
        try:
            bundles.append(load_bundle(path))
        except (OSError, ValueError) as exc:
            print(f"{path}: {exc}", file=sys.stderr)
            return 2
    events = merge_timeline(bundles)
    if not events:
        print("no journal events in the given bundle(s)", file=sys.stderr)
        return 2
    findings = detect_signatures(
        events, grace_ms=args.grace_ms, storm_min_events=args.storm_min,
    )
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump(timeline_chrome_trace(events), fh)
        print(f"wrote Chrome trace to {args.trace_out}", file=sys.stderr)
    if args.as_json:
        print(json.dumps({
            "events": [e.to_journal_entry() for e in events],
            "findings": findings,
            "bundles": [
                {"trigger": b.get("trigger"),
                 "captured_by": b.get("captured_by"),
                 "manifest": b.get("manifest")}
                for b in bundles
            ],
        }, sort_keys=True, default=str))
    else:
        print(report_text(events, findings, bundles))
    for finding in findings:
        print(f"SIGNATURE: {finding['signature']}", file=sys.stderr)
    return 3 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
