"""The port's own copy of ``rapid_tpu/forensics/timeline.py``.

Causal cluster timelines and anomaly-signature detection.

``merge_timeline`` folds the member journals of one or more evidence
bundles into a single event stream ordered by hybrid logical clock -- the
order that survives ``clock_skew`` faults, where wall-clock merge provably
does not (tests/test_forensics.py pins a run whose wall order is wrong).
Events that predate the forensics plane (no ``hlc`` coordinate) fall back
to wall milliseconds, so mixed bundles still merge.

``detect_signatures`` runs every cataloged anomaly detector over the
merged timeline. Detectors are pure functions -- timeline in, finding
dicts out -- so the same code judges a live capture, a bundle file, or a
hand-built test fixture. SIGNATURE_CATALOG is the closed set of signature
names (linted two-sidedly, the METRIC_CATALOG discipline; the port's
lint is in ``tests/test_torch_timeline.py``): every catalog row has a
detector, every finding a detector emits is cataloged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..slo.attrib import attribute_burn, describe, episodes_from_journal

# Signature name -> documentation (a pure module literal, so a lint can
# load it standalone, like RULE_CATALOG)
SIGNATURE_CATALOG = {
    "view_divergence": {
        "doc": "two members held different configuration ids for longer "
               "than the propagation grace window (HLC-overlapping view "
               "intervals with different ids)",
    },
    "stuck_handoff": {
        "doc": "a member launched handoff sessions that never reached "
               "handoff_complete or handoff_failed before the capture",
    },
    "deposed_leader_write": {
        "doc": "a member kept acting on a stale placement-map version "
               "causally after another member announced a newer one, and "
               "never caught up before the capture",
    },
    "alert_storm_burn": {
        "doc": "a burn alert fired inside a membership episode that also "
               "carried an alert storm (the churn -> alert flood -> burn "
               "chain, attributed via slo/attrib.py episodes)",
    },
}

# events counted as "alert traffic" by the alert_storm_burn detector
_STORM_KINDS = ("fd_signal", "alert_enqueued", "alert_in", "alert_out")

# grace windows (physical-ms on the HLC axis): normal propagation after a
# churn wave must not read as divergence or deposal
DEFAULT_DIVERGENCE_GRACE_MS = 2000
DEFAULT_STORM_MIN_EVENTS = 5


@dataclass(frozen=True)
class TimelineEvent:
    """One journal entry on the merged cluster timeline."""

    node: str
    kind: str
    seq: int
    wall_s: float
    virtual_ms: Optional[int]
    hlc: Optional[Tuple[int, int, int]]  # (physical_ms, logical, incarnation)
    detail: Dict[str, object] = field(default_factory=dict)

    @property
    def hlc_key(self) -> Tuple[int, int, str, int]:
        """The merge key: HLC coordinate when stamped, wall-ms fallback
        otherwise; node + seq break exact ties deterministically."""
        if self.hlc is not None:
            return (int(self.hlc[0]), int(self.hlc[1]), self.node, self.seq)
        return (int(self.wall_s * 1000), 0, self.node, self.seq)

    @property
    def wall_key(self) -> Tuple[int, int, str, int]:
        """The naive wall-clock merge key -- kept so tests (and the report)
        can show exactly where wall order betrays causality under skew."""
        return (int(self.wall_s * 1000), 0, self.node, self.seq)

    def to_journal_entry(self) -> Dict[str, object]:
        """Back to the FlightRecorder entry dict shape (what
        slo/attrib.py's episode folding consumes)."""
        entry: Dict[str, object] = {
            "seq": self.seq, "kind": self.kind, "wall_s": self.wall_s,
            "virtual_ms": self.virtual_ms, "node": self.node,
            "detail": dict(self.detail),
        }
        if self.hlc is not None:
            entry["hlc"] = list(self.hlc)
        return entry


def _event_from_entry(node: str, entry: Dict[str, object]
                      ) -> Optional[TimelineEvent]:
    kind = entry.get("kind")
    if not isinstance(kind, str):
        return None
    hlc = entry.get("hlc")
    stamp: Optional[Tuple[int, int, int]] = None
    if isinstance(hlc, (list, tuple)) and len(hlc) >= 2:
        try:
            stamp = (
                int(hlc[0]), int(hlc[1]),
                int(hlc[2]) if len(hlc) > 2 else 1,
            )
        except (TypeError, ValueError):
            stamp = None
    try:
        wall_s = float(entry.get("wall_s", 0.0))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        wall_s = 0.0
    virtual = entry.get("virtual_ms")
    try:
        virtual_ms = int(virtual) if virtual is not None else None  # type: ignore[arg-type]
    except (TypeError, ValueError):
        virtual_ms = None
    try:
        seq = int(entry.get("seq", 0))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        seq = 0
    detail = entry.get("detail")
    return TimelineEvent(
        node=str(entry.get("node") or node),
        kind=kind, seq=seq, wall_s=wall_s, virtual_ms=virtual_ms,
        hlc=stamp, detail=dict(detail) if isinstance(detail, dict) else {},
    )


def merge_timeline(bundles: Sequence[Dict[str, object]]
                   ) -> List[TimelineEvent]:
    """One HLC-ordered stream from every member journal of every bundle.

    The same node's journal may appear in several records (its own local
    capture plus other members' status fan-outs): entries dedupe on
    ``(node, incarnation, seq)``, the per-recorder identity the
    incarnation-seq pattern guarantees unique."""
    events: List[TimelineEvent] = []
    seen = set()
    for bundle in bundles:
        members = bundle.get("members", [])
        if not isinstance(members, list):
            continue
        for member in members:
            if not isinstance(member, dict):
                continue
            node = str(member.get("node", ""))
            journal = member.get("journal", [])
            if not isinstance(journal, list):
                continue
            for entry in journal:
                if not isinstance(entry, dict):
                    continue
                event = _event_from_entry(node, entry)
                if event is None:
                    continue
                incarnation = event.hlc[2] if event.hlc is not None else 0
                key = (event.node, incarnation, event.seq, event.kind)
                if key in seen:
                    continue
                seen.add(key)
                events.append(event)
    events.sort(key=lambda e: e.hlc_key)
    return events


# --------------------------------------------------------------------------- #
# Anomaly signatures (pure functions: timeline in, finding dicts out)
# --------------------------------------------------------------------------- #


def _finding(signature: str, **fields: object) -> Dict[str, object]:
    assert signature in SIGNATURE_CATALOG, signature
    return {"signature": signature, **fields}


def _detail_int(event: TimelineEvent, key: str) -> int:
    try:
        return int(event.detail.get(key, 0))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return 0


def _axis_ms(event: TimelineEvent) -> int:
    """The event's position on the merge axis in milliseconds."""
    return event.hlc_key[0]


def detect_view_divergence(
    events: Sequence[TimelineEvent],
    grace_ms: int = DEFAULT_DIVERGENCE_GRACE_MS,
) -> List[Dict[str, object]]:
    """Overlapping per-node view intervals with different configuration
    ids, lasting longer than the propagation grace window. Each node's
    interval for a config runs from its install to its next install (or to
    its last journal entry -- a kicked node's stale view stops counting
    when its journal does)."""
    last_event_ms: Dict[str, int] = {}
    installs: Dict[str, List[Tuple[int, int]]] = {}  # node -> [(ms, config)]
    for event in events:
        ms = _axis_ms(event)
        last_event_ms[event.node] = max(last_event_ms.get(event.node, 0), ms)
        if event.kind == "view_install":
            installs.setdefault(event.node, []).append(
                (ms, _detail_int(event, "configuration_id"))
            )
    intervals: Dict[str, List[Tuple[int, int, int]]] = {}
    for node, items in installs.items():
        rows: List[Tuple[int, int, int]] = []
        for i, (start, config) in enumerate(items):
            end = (
                items[i + 1][0] if i + 1 < len(items)
                else last_event_ms.get(node, start)
            )
            rows.append((start, max(end, start), config))
        intervals[node] = rows
    findings: List[Dict[str, object]] = []
    nodes = sorted(intervals)
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            for a_start, a_end, a_cfg in intervals[a]:
                for b_start, b_end, b_cfg in intervals[b]:
                    if a_cfg == b_cfg:
                        continue
                    lo, hi = max(a_start, b_start), min(a_end, b_end)
                    if hi - lo > grace_ms:
                        findings.append(_finding(
                            "view_divergence",
                            nodes=[a, b], configs=[a_cfg, b_cfg],
                            window_ms=hi - lo, start_ms=lo, end_ms=hi,
                        ))
    return findings


def detect_stuck_handoff(
    events: Sequence[TimelineEvent],
) -> List[Dict[str, object]]:
    """Per node: sessions launched (``handoff_started`` carries the count)
    minus sessions that reached a terminal event. A positive balance at
    capture time is a transfer the cluster is still waiting on."""
    started: Dict[str, int] = {}
    resolved: Dict[str, int] = {}
    last_start: Dict[str, TimelineEvent] = {}
    for event in events:
        if event.kind == "handoff_started":
            launched = _detail_int(event, "sessions") or 1
            started[event.node] = started.get(event.node, 0) + launched
            last_start[event.node] = event
        elif event.kind in ("handoff_complete", "handoff_failed"):
            resolved[event.node] = resolved.get(event.node, 0) + 1
    findings: List[Dict[str, object]] = []
    for node in sorted(started):
        stuck = started[node] - resolved.get(node, 0)
        if stuck > 0:
            anchor = last_start[node]
            findings.append(_finding(
                "stuck_handoff",
                node=node, stuck=stuck, started=started[node],
                resolved=resolved.get(node, 0),
                since_ms=_axis_ms(anchor),
                version=_detail_int(anchor, "version"),
            ))
    return findings


def detect_deposed_leader_writes(
    events: Sequence[TimelineEvent],
) -> List[Dict[str, object]]:
    """A member that kept acting on a stale placement-map version causally
    *after* another member announced a newer one, and never announced the
    newer version itself before the capture. Transient staleness during
    propagation does not trip this: the stale member must end the timeline
    still behind."""
    versioned = [
        e for e in events
        if e.kind in ("serving_leader_change", "serving_sync")
        and _detail_int(e, "version") > 0
    ]
    if not versioned:
        return []
    last_version: Dict[str, int] = {}
    first_announce: Dict[int, TimelineEvent] = {}
    for event in versioned:
        version = _detail_int(event, "version")
        last_version[event.node] = version
        if version not in first_announce:
            first_announce[version] = event
    vmax = max(last_version.values())
    findings: List[Dict[str, object]] = []
    for node in sorted(last_version):
        stale = last_version[node]
        if stale >= vmax:
            continue
        newer = [
            v for v, e in first_announce.items()
            if v > stale and e.node != node
        ]
        if not newer:
            continue
        deposed_at = min(first_announce[v].hlc_key for v in newer)
        stale_after = [
            e for e in versioned
            if e.node == node and _detail_int(e, "version") <= stale
            and e.hlc_key > deposed_at
        ]
        if stale_after:
            findings.append(_finding(
                "deposed_leader_write",
                node=node, stale_version=stale, newer_version=vmax,
                write_attempts=len(stale_after),
                first_stale_ms=_axis_ms(stale_after[0]),
            ))
    return findings


def detect_alert_storm_burn(
    events: Sequence[TimelineEvent],
    storm_min_events: int = DEFAULT_STORM_MIN_EVENTS,
) -> List[Dict[str, object]]:
    """The churn -> alert storm -> burn chain: a ``slo_alert_fired`` whose
    attributed membership episode (slo/attrib.py, over the merged journal)
    also carried at least ``storm_min_events`` of alert traffic."""
    entries = [e.to_journal_entry() for e in events]
    episodes = episodes_from_journal(entries)
    findings: List[Dict[str, object]] = []
    for event in events:
        if event.kind != "slo_alert_fired":
            continue
        fired_ms = (
            event.virtual_ms if event.virtual_ms is not None
            else _axis_ms(event)
        )
        episode = attribute_burn(episodes, fired_ms - 1, fired_ms)
        if episode is None:
            continue
        storm = [
            e for e in events
            if e.kind in _STORM_KINDS
            and e.virtual_ms is not None
            and episode.start_ms <= e.virtual_ms <= max(
                episode.end_ms, fired_ms
            )
        ]
        if len(storm) >= storm_min_events:
            findings.append(_finding(
                "alert_storm_burn",
                node=event.node,
                slo=str(event.detail.get("slo", "")),
                window=str(event.detail.get("window", "")),
                storm_events=len(storm),
                episode=describe(episode),
                episode_start_ms=episode.start_ms,
                fired_ms=fired_ms,
            ))
    return findings


def detect_signatures(
    events: Sequence[TimelineEvent],
    grace_ms: int = DEFAULT_DIVERGENCE_GRACE_MS,
    storm_min_events: int = DEFAULT_STORM_MIN_EVENTS,
) -> List[Dict[str, object]]:
    """Every cataloged detector over one merged timeline."""
    findings: List[Dict[str, object]] = []
    findings.extend(detect_view_divergence(events, grace_ms=grace_ms))
    findings.extend(detect_stuck_handoff(events))
    findings.extend(detect_deposed_leader_writes(events))
    findings.extend(
        detect_alert_storm_burn(events, storm_min_events=storm_min_events)
    )
    return findings


# --------------------------------------------------------------------------- #
# Rendering
# --------------------------------------------------------------------------- #


def timeline_chrome_trace(events: Sequence[TimelineEvent]) -> Dict[str, object]:
    """Chrome-trace instants on the HLC axis: ``ts`` is the HLC physical
    half in microseconds plus the logical half as sub-microsecond ticks,
    one track per node -- load in Perfetto next to any device trace."""
    trace_events: List[Dict[str, object]] = []
    tids = {node: i for i, node in enumerate(
        sorted({e.node for e in events})
    )}
    for event in events:
        physical, logical = event.hlc_key[0], event.hlc_key[1]
        trace_events.append({
            "name": event.kind, "ph": "i", "s": "g",
            "pid": 0, "tid": tids[event.node],
            "ts": physical * 1000 + logical,
            "cat": "forensics",
            "args": {"node": event.node, "seq": event.seq,
                     "hlc": list(event.hlc) if event.hlc else None,
                     **event.detail},
        })
    trace_events.extend(
        {
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": node},
        }
        for node, tid in tids.items()
    )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def report_text(events: Sequence[TimelineEvent],
                findings: Sequence[Dict[str, object]],
                bundles: Sequence[Dict[str, object]] = ()) -> str:
    """The operator report: bundle manifests, the merged timeline, and the
    signature verdicts."""
    lines: List[str] = []
    for bundle in bundles:
        manifest = bundle.get("manifest", {})
        if isinstance(manifest, dict):
            unreachable = manifest.get("unreachable") or []
            suffix = (
                f", unreachable: {', '.join(map(str, unreachable))}"
                if unreachable else ""
            )
            lines.append(
                f"bundle[{bundle.get('trigger', '?')}] by "
                f"{bundle.get('captured_by', '?')}: "
                f"{manifest.get('members', 0)} members, "
                f"{manifest.get('events', 0)} events, fingerprint "
                f"{str(manifest.get('fingerprint', ''))[:12]}{suffix}"
            )
    nodes = sorted({e.node for e in events})
    lines.append(
        f"merged timeline: {len(events)} events across {len(nodes)} nodes"
    )
    dropped = sum(
        int(m.get("journal_dropped", 0) or 0)  # type: ignore[arg-type]
        for bundle in bundles
        for m in bundle.get("members", [])  # type: ignore[union-attr]
        if isinstance(m, dict)
    )
    if dropped:
        lines.append(
            f"  (journals truncated: {dropped} events dropped before "
            f"capture -- raise forensics.journal_capacity)"
        )
    for event in events:
        physical, logical = event.hlc_key[0], event.hlc_key[1]
        hlc_txt = (
            f"{physical}.{logical:03d}" if event.hlc is not None
            else f"~{physical} (wall)"
        )
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(event.detail.items())
        )
        lines.append(
            f"  {hlc_txt:>18}  {event.node:<18} {event.kind}"
            + (f"  [{detail}]" if detail else "")
        )
    if findings:
        lines.append(f"signatures detected: {len(findings)}")
        for finding in findings:
            fields = ", ".join(
                f"{k}={v}" for k, v in sorted(finding.items())
                if k != "signature"
            )
            lines.append(f"  {finding['signature']}: {fields}")
    else:
        lines.append("signatures detected: none")
    return "\n".join(lines)
