"""Incident evidence bundles: everything a post-mortem needs, in one file.

The port's own copy of ``rapid_tpu/forensics/bundle.py``.

A bundle is a JSON document with one record per cluster member: journal
tail (HLC-stamped entries), metric digest, metric-history ring tail, SLO
digest, durability stats, trace spans, and the config/view coordinates --
plus a manifest whose fingerprint covers the member records, so a bundle
quoted in an incident review can be checked against the original bytes.

Capture never blocks and never throws into the triggering path: members
that miss the per-member status deadline are recorded as unreachable (with
the error string) and the capture proceeds. Writes are atomic (tmp +
``os.replace``, the agent's Prometheus-rewrite pattern) so a crash mid-
capture never leaves a torn bundle on disk.

Triggers (the ``trigger`` field): ``slo_burn`` (a burn alert fired),
``invariant_violation`` (search-plane checker tripped), ``crash`` (exit
hook), ``dump`` (operator journal dump), ``explicit``
(``Cluster.capture_bundle()`` / ``agent --bundle-out``), ``hunt_witness``
(a shrunken hunt witness was pinned).
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

BUNDLE_SCHEMA_VERSION = 1

TRIGGERS = (
    "explicit", "slo_burn", "invariant_violation", "crash", "dump",
    "hunt_witness",
)


def _canonical(doc: object) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def bundle_fingerprint(members: Sequence[Dict[str, object]]) -> str:
    """sha256 over the canonical JSON of the member records -- the manifest
    fingerprint a review can recompute to authenticate a quoted bundle."""
    return hashlib.sha256(_canonical(list(members)).encode()).hexdigest()


def member_record(node: str, *, reachable: bool = True,
                  hlc: Optional[list] = None,
                  journal: Sequence[Dict[str, object]] = (),
                  journal_dropped: int = 0, journal_capacity: int = 0,
                  configuration_id: int = 0, membership_size: int = 0,
                  metrics: Optional[Dict[str, int]] = None,
                  history: Sequence[str] = (),
                  spans: Sequence[Dict[str, object]] = (),
                  slo: Optional[Dict[str, object]] = None,
                  durability: Optional[Dict[str, int]] = None,
                  error: str = "") -> Dict[str, object]:
    """One member's evidence, normalized. Unreachable members carry only
    ``node``/``reachable``/``error`` -- the bundle says who was missing."""
    record: Dict[str, object] = {
        "node": str(node),
        "reachable": bool(reachable),
        "hlc": list(hlc) if hlc else None,
        "journal": list(journal),
        "journal_dropped": int(journal_dropped),
        "journal_capacity": int(journal_capacity),
        "configuration_id": int(configuration_id),
        "membership_size": int(membership_size),
        "metrics": dict(metrics or {}),
        "history": list(history),
        "spans": list(spans),
        "slo": dict(slo or {}),
        "durability": dict(durability or {}),
    }
    if error:
        record["error"] = str(error)
    return record


def _parse_journal_lines(lines: Sequence[str]) -> List[Dict[str, object]]:
    entries: List[Dict[str, object]] = []
    for line in lines:
        try:
            entry = json.loads(line)
        except (TypeError, ValueError):
            continue
        if isinstance(entry, dict) and "kind" in entry:
            entries.append(entry)
    return entries


def status_to_record(status) -> Dict[str, object]:
    """A member record from a ``ClusterStatusResponse`` (duck-typed: any
    object carrying the status fields works, including old-dialect
    responses whose forensics fields default to zero)."""
    hlc = None
    if int(getattr(status, "hlc_incarnation", 0) or 0) > 0:
        hlc = [
            int(status.hlc_physical_ms), int(status.hlc_logical),
            int(status.hlc_incarnation),
        ]
    slo: Dict[str, object] = {}
    names = tuple(getattr(status, "slo_names", ()) or ())
    if names:
        slo = {
            "names": list(names),
            "burn_milli": list(getattr(status, "slo_burn_milli", ()) or ()),
            "firing": list(getattr(status, "slo_firing", ()) or ()),
            "attributed_trace": list(
                getattr(status, "slo_attributed_trace", ()) or ()
            ),
        }
    return member_record(
        str(getattr(status, "sender", "")),
        hlc=hlc,
        journal=_parse_journal_lines(getattr(status, "journal", ()) or ()),
        journal_dropped=int(getattr(status, "journal_dropped", 0) or 0),
        journal_capacity=int(getattr(status, "journal_capacity", 0) or 0),
        configuration_id=int(getattr(status, "configuration_id", 0) or 0),
        membership_size=int(getattr(status, "membership_size", 0) or 0),
        metrics=dict(zip(
            getattr(status, "metric_names", ()) or (),
            (int(v) for v in getattr(status, "metric_values", ()) or ()),
        )),
        history=tuple(getattr(status, "history", ()) or ()),
        slo=slo,
        durability={
            "segments": int(getattr(status, "durability_segments", 0) or 0),
            "snapshot_version": int(
                getattr(status, "durability_snapshot_version", 0) or 0
            ),
            "replayed": int(getattr(status, "durability_replayed", 0) or 0),
        },
    )


def unreachable_record(node: str, error: str) -> Dict[str, object]:
    return member_record(str(node), reachable=False, error=error)


def _span_dict(span) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key in ("name", "span_id", "parent_id", "start_ms", "end_ms",
                "virtual_start_ms", "virtual_end_ms", "plane", "track"):
        value = getattr(span, key, None)
        if value is not None:
            out[key] = value
    attrs = getattr(span, "attrs", None)
    if attrs:
        out["attrs"] = dict(attrs)
    return out


def capture_local_evidence(*, node: str, recorder=None, metrics=None,
                           tracer=None, slo=None, hlc=None,
                           configuration_id: int = 0,
                           membership_size: int = 0,
                           durability: Optional[Dict[str, int]] = None,
                           history=None,
                           journal_tail: int = 128,
                           history_tail: int = 32) -> Dict[str, object]:
    """The local node's full evidence record, assembled straight from the
    plane objects (NOT via the status RPC, so a capture triggered from
    inside the status/SLO path cannot recurse). Every accessor degrades
    independently: a dying subsystem costs its own section, never the
    bundle."""
    journal: Sequence[Dict[str, object]] = ()
    dropped = capacity = 0
    if recorder is not None:
        try:
            journal = recorder.tail(journal_tail)
            dropped = recorder.dropped
            capacity = recorder.capacity
        except Exception:  # noqa: BLE001
            journal = ()
    stamp = None
    if hlc is not None:
        try:
            stamp = hlc.peek().to_wire()
        except Exception:  # noqa: BLE001
            stamp = None
    snapshot: Dict[str, int] = {}
    if metrics is not None:
        try:
            snapshot = dict(metrics.snapshot())
        except Exception:  # noqa: BLE001
            snapshot = {}
    spans: List[Dict[str, object]] = []
    if tracer is not None:
        try:
            spans = [_span_dict(s) for s in tracer.collect_spans()]
        except Exception:  # noqa: BLE001
            spans = []
    digest: Dict[str, object] = {}
    if slo is not None:
        try:
            names, burn, firing, attributed = slo.status_digest()
            digest = {
                "names": [str(n) for n in names],
                "burn_milli": [int(v) for v in burn],
                "firing": [int(v) for v in firing],
                "attributed_trace": [int(v) for v in attributed],
            }
        except Exception:  # noqa: BLE001
            digest = {}
    lines: Sequence[str] = ()
    if history is not None and history_tail > 0:
        try:
            lines = history.to_wire(history_tail)
        except Exception:  # noqa: BLE001
            lines = ()
    return member_record(
        node, hlc=stamp, journal=journal, journal_dropped=dropped,
        journal_capacity=capacity, configuration_id=configuration_id,
        membership_size=membership_size, metrics=snapshot, history=lines,
        spans=spans, slo=digest, durability=durability,
    )


def build_bundle(trigger: str, local: Dict[str, object],
                 members: Sequence[Dict[str, object]] = (),
                 detail: Optional[Dict[str, object]] = None
                 ) -> Dict[str, object]:
    """Assemble the bundle document. ``local`` is the capturing node's
    record (always first); ``members`` are the fan-out records (reachable
    or not). The manifest fingerprint covers every member record."""
    records = [local] + [
        m for m in members if m.get("node") != local.get("node")
    ]
    events = sum(
        len(m.get("journal", ())) for m in records  # type: ignore[arg-type]
    )
    unreachable = sorted(
        str(m["node"]) for m in records if not m.get("reachable", True)
    )
    return {
        "schema": BUNDLE_SCHEMA_VERSION,
        "trigger": str(trigger),
        "captured_by": str(local.get("node", "")),
        "captured_wall_s": time.time(),
        "detail": dict(detail or {}),
        "members": records,
        "manifest": {
            "fingerprint": bundle_fingerprint(records),
            "members": len(records),
            "unreachable": unreachable,
            "events": events,
        },
    }


def write_bundle(bundle: Dict[str, object], path: str) -> str:
    """Atomic write (tmp + ``os.replace``): readers never see a torn
    bundle, and a crash mid-write leaves the previous file intact."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".bundle-", dir=directory)
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(bundle, fh, sort_keys=True, default=str)
            fh.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_bundle(path: str) -> Dict[str, object]:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "members" not in doc:
        raise ValueError(f"{path}: not an evidence bundle")
    return doc


def verify_bundle(bundle: Dict[str, object]) -> bool:
    """Recompute the manifest fingerprint over the member records."""
    manifest = bundle.get("manifest")
    if not isinstance(manifest, dict):
        return False
    members = bundle.get("members", [])
    return manifest.get("fingerprint") == bundle_fingerprint(members)  # type: ignore[arg-type]


# --------------------------------------------------------------------------- #
# Crash/exit hooks (behind the forensics kill switch; see ClusterBuilder)
# --------------------------------------------------------------------------- #

_EXIT_HOOKS: Dict[int, str] = {}  # id(recorder) -> path (idempotence guard)


def install_exit_hooks(recorder, journal_path: str) -> bool:
    """Register an atexit journal dump (atomic, via FlightRecorder.dump)
    and enable faulthandler tracebacks next to it, so even an uncaught
    crash leaves evidence on disk. Idempotent per (recorder, path); only
    ever called when ``settings.forensics.enabled``."""
    key = id(recorder)
    if _EXIT_HOOKS.get(key) == journal_path:
        return False
    _EXIT_HOOKS[key] = journal_path

    def _dump() -> None:
        try:
            recorder.dump(journal_path)
        except Exception:  # noqa: BLE001 -- exiting anyway; never mask the exit
            pass

    atexit.register(_dump)
    try:
        import faulthandler

        if not faulthandler.is_enabled():
            # hard crashes (segfault/abort) cannot run Python atexit hooks;
            # the faulthandler traceback file is the evidence of last resort
            crash_file = open(journal_path + ".crash", "w")  # noqa: SIM115
            faulthandler.enable(file=crash_file)
    except Exception:  # noqa: BLE001 -- faulthandler is best-effort
        pass
    return True
