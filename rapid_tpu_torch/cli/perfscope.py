#!/usr/bin/env python
"""perfscope: render, diff, and regression-gate rapid-tpu profiling data.

The port's counterpart of ``tools/perfscope.py``: for the same input, the
same stdout, stderr and exit code. ``render`` reads the port profiler's
``json_snapshot`` as the JAX package's (the phase names and histograms are
the same); ``DIMENSION_BUDGETS`` is a contract of bounds, copied as it is.

Four subcommands over the profiling plane's artifacts:

``render`` -- per-phase device attribution as a flamegraph-style breakdown.
Input is any JSON file carrying ``profile.phase_ms{phase=...}`` histograms:
an ``observability.json_snapshot()`` dump, a ``cli/statusz.py --json``
line (the last scraped history snapshot is used), or raw
``MetricsHistory.to_wire`` lines. ``--trace-out`` additionally writes a
Chrome-trace (chrome://tracing / Perfetto) file with one slice per phase,
scaled to the measured mean, so the breakdown is inspectable next to any
device trace.

``diff`` -- compare two bench JSON artifacts (the single line bench.py
prints): headline wall, per-size sweep walls, and compile counts, with a
regression threshold (rc 3 when the new artifact is slower beyond it).

``check`` -- gate one bench artifact against BASELINE.json's north-star
budget plus the per-dimension budget table (DIMENSION_BUDGETS: serving
tail latency, lost acked writes, SLO availability/goodput and firing burn
alerts, messaging throughput, gray-detection speedup), rc 3 on any
breach -- the CI-shaped form of the same comparison.

``trend`` -- the headline + per-dimension trajectory across a SERIES of
bench runs (the repo's BENCH_rNN.json wrappers or raw bench lines), so
the perf history stops being hand-maintained prose. Runs whose wrapper
carries rc 17 (bench.py's accelerator-unreachable watchdog exit) or no
parseable artifact are rendered as OUTAGE markers -- an unreachable
device is an environment fact, never plotted as a regression; rc 3 only
when two *measured* neighbours drift beyond the threshold.

    python -m rapid_tpu_torch.cli.perfscope render metrics.json
    python -m rapid_tpu_torch.cli.perfscope diff old_bench.json new_bench.json
    python -m rapid_tpu_torch.cli.perfscope check bench.json
    python -m rapid_tpu_torch.cli.perfscope trend BENCH_r*.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

# phase order matches the pipeline: profiling/phases.py PHASES
PHASE_ORDER = ("fd_scan", "cut_detector", "consensus_count", "host_transfer")
BAR_WIDTH = 24
DEFAULT_THRESHOLD = 0.10  # 10% slower = regression
NORTH_STAR_BUDGET_MS = 5000.0  # BASELINE.json: "converging ... in <5s"


def parse_rendered(name: str) -> Tuple[str, Dict[str, str]]:
    """``name{k=v,...}`` -> (base name, labels). The inverse of
    observability._render for the label values profiling emits."""
    if "{" not in name or not name.endswith("}"):
        return name, {}
    base, raw = name[:-1].split("{", 1)
    labels: Dict[str, str] = {}
    for part in raw.split(","):
        if "=" in part:
            key, value = part.split("=", 1)
            labels[key] = value
    return base, labels


def _hist_count_sum(value: object) -> Optional[Tuple[float, float]]:
    """(count, sum) from either exporter dialect: json_snapshot's
    {"count","sum",...} dict or the history ring's [count, sum] pair."""
    if isinstance(value, dict) and "count" in value and "sum" in value:
        return float(value["count"]), float(value["sum"])
    if isinstance(value, (list, tuple)) and len(value) == 2:
        return float(value[0]), float(value[1])
    return None


def extract_phases(doc: object) -> Tuple[Dict[str, Tuple[float, float]], Optional[Tuple[float, float]]]:
    """Pull ``profile.phase_ms`` per-phase (count, sum) and the
    ``profile.step_ms`` (count, sum) out of whatever profiling artifact the
    caller loaded (see module docstring for the accepted shapes)."""
    hists: Dict[str, object] = {}
    if isinstance(doc, dict):
        if isinstance(doc.get("histograms"), dict):  # json_snapshot dump
            hists = doc["histograms"]
        elif isinstance(doc.get("history"), list) and doc["history"]:
            last = doc["history"][-1]  # statusz --json: newest snapshot
            if isinstance(last, dict) and isinstance(
                last.get("histograms"), dict
            ):
                hists = last["histograms"]
    elif isinstance(doc, list) and doc:  # raw history snapshot list
        last = doc[-1]
        if isinstance(last, dict) and isinstance(last.get("histograms"), dict):
            hists = last["histograms"]
    phases: Dict[str, Tuple[float, float]] = {}
    step: Optional[Tuple[float, float]] = None
    for rendered, value in hists.items():
        base, labels = parse_rendered(str(rendered))
        pair = _hist_count_sum(value)
        if pair is None:
            continue
        if base == "profile.phase_ms" and "phase" in labels:
            prev = phases.get(labels["phase"], (0.0, 0.0))
            phases[labels["phase"]] = (prev[0] + pair[0], prev[1] + pair[1])
        elif base == "profile.step_ms":
            prev = step if step is not None else (0.0, 0.0)
            step = (prev[0] + pair[0], prev[1] + pair[1])
    return phases, step


def load_profile_doc(path: str) -> object:
    """A profiling artifact: one JSON document, or JSON lines (a scraped
    history carriage / several statusz lines -- the last parseable line
    wins, matching 'newest snapshot')."""
    text = open(path).read()
    try:
        return json.loads(text)
    except ValueError:
        docs = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                docs.append(json.loads(line))
            except ValueError:
                continue
        return docs


def render_breakdown(phases: Dict[str, Tuple[float, float]],
                     step: Optional[Tuple[float, float]]) -> str:
    """The flamegraph-style per-phase breakdown: one bar per phase, widths
    proportional to total attributed wall time."""
    rows = [
        (phase, phases[phase])
        for phase in PHASE_ORDER
        if phase in phases
    ] + sorted(
        (phase, pair) for phase, pair in phases.items()
        if phase not in PHASE_ORDER
    )
    total_ms = sum(pair[1] for _, pair in rows)
    lines = ["per-phase device attribution:"]
    if not rows or total_ms <= 0:
        lines.append("  (no profile.phase_ms samples -- profiling off?)")
        return "\n".join(lines)
    width = max(len(name) for name, _ in rows)
    for name, (count, total) in rows:
        frac = total / total_ms
        bar = "#" * max(1, round(frac * BAR_WIDTH))
        mean = total / count if count else 0.0
        lines.append(
            f"  {name:<{width}}  {bar:<{BAR_WIDTH}}  {frac * 100:5.1f}%"
            f"  mean {mean:.3f}ms  n={int(count)}"
        )
    if step is not None and step[0] > 0:
        step_mean = step[1] / step[0]
        device_ms = sum(
            pair[1] for name, pair in rows if name != "host_transfer"
        )
        device_n = max(
            (pair[0] for name, pair in rows if name != "host_transfer"),
            default=0.0,
        )
        device_mean = device_ms / device_n if device_n else 0.0
        coverage = (device_mean / step_mean * 100.0) if step_mean else 0.0
        lines.append(
            f"  device step: mean {step_mean:.3f}ms (profile.step_ms,"
            f" n={int(step[0])}); device phases cover {coverage:.1f}%"
        )
    return "\n".join(lines)


def chrome_trace_events(phases: Dict[str, Tuple[float, float]]) -> Dict[str, object]:
    """One synthetic 'mean dispatch' frame as Chrome-trace complete events:
    the device phases stacked sequentially (they really are sequential
    prefixes of one step), host_transfer after them."""
    events: List[Dict[str, object]] = []
    cursor_us = 0.0
    for phase in PHASE_ORDER:
        pair = phases.get(phase)
        if pair is None or pair[0] <= 0:
            continue
        mean_us = pair[1] / pair[0] * 1000.0
        events.append({
            "name": phase, "ph": "X", "pid": 0, "tid": 0,
            "ts": cursor_us, "dur": mean_us,
            "cat": "profile", "args": {"samples": int(pair[0])},
        })
        cursor_us += mean_us
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------------------- #
# bench artifact diffing
# --------------------------------------------------------------------------- #


def _bench_line(text: str) -> Optional[dict]:
    """The first line of ``text`` that parses as a bench artifact (a dict
    with a 'metric' key), or None -- shared by the file and wrapper-tail
    loaders."""
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and "metric" in doc:
            return doc
    return None


def load_bench_artifact(path: str) -> dict:
    """The bench's single JSON line (tolerating surrounding log lines: the
    first line that parses as a dict with a 'metric' key wins). Also
    accepts the repo's BENCH_rNN.json run wrapper, unwrapping its
    "parsed" artifact (or re-scanning its "tail" for older wrappers)."""
    text = open(path).read()
    try:
        whole = json.loads(text)
    except ValueError:
        whole = None
    if isinstance(whole, dict) and "rc" in whole and "tail" in whole:
        doc = whole.get("parsed")
        if not isinstance(doc, dict):
            doc = _bench_line(str(whole.get("tail", "")))
    else:
        doc = _bench_line(text)
    if doc is None:
        raise ValueError(f"{path}: no bench JSON artifact line found")
    return doc


# rc 17 is bench.py's watchdog exit: the accelerator never answered, so
# the run measured the environment, not the code (BENCH_r03-r05 carry it)
OUTAGE_RC = 17


def load_trend_entry(path: str) -> dict:
    """One point on the perf-history trajectory. Accepts the repo's
    BENCH_rNN.json run wrapper ({"n", "rc", "tail", "parsed"}) or a raw
    bench artifact file; returns {path, n, rc, artifact} where artifact is
    None for an outage (watchdog rc, or nothing parseable)."""
    text = open(path).read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "rc" in doc and "tail" in doc:
        artifact = doc.get("parsed")
        if not isinstance(artifact, dict):  # older wrappers: re-scan tail
            artifact = _bench_line(str(doc.get("tail", "")))
        rc = int(doc.get("rc", 0))
        if rc != 0:
            artifact = None  # a failed run's partial line proves nothing
        return {"path": path, "n": doc.get("n"), "rc": rc,
                "artifact": artifact}
    artifact = _bench_line(text)
    return {"path": path, "n": None, "rc": 0 if artifact else None,
            "artifact": artifact}


def trend_report(entries: List[dict],
                 threshold: float = DEFAULT_THRESHOLD) -> Tuple[str, List[str]]:
    """The trajectory report plus regression descriptions. Entries sort by
    run number (wrapper "n") with path as tiebreaker; outage entries are
    rendered in place but never compared -- each measured run diffs
    against the previous *measured* run, skipping outages between them."""
    entries = sorted(
        entries,
        key=lambda e: (e["n"] if isinstance(e["n"], int) else 1 << 30,
                       e["path"]),
    )
    measured = [e for e in entries if e["artifact"] is not None]
    lines: List[str] = [
        f"bench trend across {len(entries)} runs "
        f"({len(measured)} measured, {len(entries) - len(measured)} outage):"
    ]
    regressions: List[str] = []

    def run_label(entry: dict) -> str:
        if isinstance(entry["n"], int):
            return f"r{entry['n']:02d}"
        name = entry["path"].rsplit("/", 1)[-1]
        return name[:-5] if name.endswith(".json") else name

    width = max((len(run_label(e)) for e in entries), default=3)
    headline_max = max(
        (float(e["artifact"].get("value") or 0.0) for e in measured),
        default=0.0,
    )
    prev: Optional[dict] = None
    for entry in entries:
        label = run_label(entry)
        artifact = entry["artifact"]
        if artifact is None or artifact.get("value") is None:
            why = (
                f"rc {entry['rc']}" if entry["rc"] not in (0, None)
                else "no artifact"
            )
            lines.append(
                f"  {label:<{width}}  {'OUTAGE':<{BAR_WIDTH}}  ({why}: "
                "accelerator/environment, not a perf point)"
            )
            continue
        value = float(artifact["value"])
        bar = "#" * max(
            1, round(value / headline_max * BAR_WIDTH)
        ) if headline_max > 0 else ""
        suffix = ""
        if prev is not None:
            old_v = float(prev["artifact"]["value"])
            pct = (value - old_v) / old_v * 100.0 if old_v else 0.0
            suffix = f"  ({pct:+.1f}% vs {run_label(prev)})"
            if old_v > 0 and value > old_v * (1.0 + threshold):
                regressions.append(
                    f"headline {run_label(prev)} -> {label}: "
                    f"{old_v:.1f} -> {value:.1f} ms"
                )
        lines.append(
            f"  {label:<{width}}  {bar:<{BAR_WIDTH}}  {value:8.1f} ms"
            f"{suffix}"
        )
        prev = entry
    # per-dimension trajectories: every budget-table path any measured
    # artifact carries, one row per dimension leaf
    seen_paths: List[Tuple[str, Tuple[str, ...]]] = []
    for dimension, path, _, _ in DIMENSION_BUDGETS:
        if (dimension, path) in seen_paths:
            continue
        if any(_walk(e["artifact"], path) is not None for e in measured):
            seen_paths.append((dimension, path))
    for dimension, path in seen_paths:
        label = ".".join(path)
        points = []
        for entry in entries:
            if entry["artifact"] is None:
                points.append(f"{run_label(entry)}=outage")
                continue
            got = _walk(entry["artifact"], path)
            points.append(
                f"{run_label(entry)}={got:g}" if got is not None
                else f"{run_label(entry)}=--"
            )
        lines.append(f"  {dimension:<9} {label}: {' '.join(points)}")
    return "\n".join(lines), regressions


# Per-dimension budgets for the ``check`` subcommand, beyond the headline
# north-star gate. Each row is (dimension, path, op, limit): ``path`` walks
# the bench artifact dict; a row whose path is absent is skipped (partial
# or outage artifacts gate only on what they carry), a present leaf must
# satisfy ``op limit`` or check exits 3. Limits are deliberately loose
# floors/ceilings -- they catch order-of-magnitude regressions and
# invariant breaks (lost acked writes, an SLO burn alert still firing at
# end of run), not machine-to-machine jitter; ``diff`` is the tool for
# relative drift.
DIMENSION_BUDGETS: Tuple[Tuple[str, Tuple[str, ...], str, float], ...] = (
    ("serving", ("serving_qps", "steady", "p99_ms"), "<=", 25.0),
    ("serving", ("serving_qps", "lost_acked_writes"), "<=", 0.0),
    ("serving", ("serving_qps", "throughput_qps"), ">=", 100.0),
    ("slo", ("serving_qps", "slo", "serving.availability", "availability"),
     ">=", 0.99),
    ("slo", ("serving_qps", "slo", "serving.availability", "goodput_ratio"),
     ">=", 0.95),
    ("slo", ("serving_qps", "slo", "serving.latency", "alerts", "fast",
             "firing"), "<=", 0.0),
    ("messaging", ("messaging_throughput", "broadcast_storm",
                   "messages_per_s"), ">=", 1.0),
    ("gray", ("gray_detection_ms", "gray_slow_node", "speedup"), ">=", 2.0),
    ("gray", ("gray_detection_ms", "gray_flapping", "speedup"), ">=", 2.0),
    # hierarchy dimension: the flat-vs-hierarchical A/B must seat >= 10x
    # the flat anchor's members, reach composed agreement within a loose
    # protocol-time ceiling (FD detection dominates at ~10-11s virtual;
    # the ceiling catches a detection/agreement blowup, not jitter), and
    # bill at least one parent round doing it
    ("hierarchy", ("hierarchy_scale", "member_ceiling_ratio"), ">=", 10.0),
    ("hierarchy", ("hierarchy_scale", "agreement_virtual_ms"), "<=", 15000.0),
    ("hierarchy", ("hierarchy_scale", "hierarchical", "parent_rounds"),
     ">=", 1.0),
)

_BUDGET_OPS = {
    "<=": lambda got, limit: got <= limit,
    ">=": lambda got, limit: got >= limit,
}


def _walk(doc: object, path: Tuple[str, ...]) -> Optional[float]:
    """Dict-walk ``path`` into a bench artifact; numeric leaf (bools count
    as 0/1) or None when any step is missing."""
    node = doc
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    if isinstance(node, (bool, int, float)):
        return float(node)
    return None


def check_budgets(doc: dict, budget_ms: float = NORTH_STAR_BUDGET_MS
                  ) -> Tuple[List[str], List[str]]:
    """The headline north-star gate plus every DIMENSION_BUDGETS row whose
    path the artifact carries; (report lines, breach descriptions)."""
    lines: List[str] = []
    breaches: List[str] = []
    value = doc.get("value")
    if value is not None:
        verdict = "within" if value <= budget_ms else "OVER"
        lines.append(
            f"headline {value:.1f} ms vs budget {budget_ms:.0f} ms "
            f"({value / budget_ms * 100.0:.1f}%): {verdict}"
        )
        if value > budget_ms:
            breaches.append(f"headline {value:.1f} ms > {budget_ms:.0f} ms")
    for dimension, path, op, limit in DIMENSION_BUDGETS:
        got = _walk(doc, path)
        if got is None:
            continue  # dimension absent from this artifact: nothing to gate
        label = ".".join(path)
        ok = _BUDGET_OPS[op](got, limit)
        lines.append(
            f"{dimension:<9} {label} = {got:g} (budget {op} {limit:g}): "
            f"{'within' if ok else 'OVER'}"
        )
        if not ok:
            breaches.append(
                f"{dimension}: {label} = {got:g}, budget {op} {limit:g}"
            )
    return lines, breaches


def diff_artifacts(old: dict, new: dict,
                   threshold: float = DEFAULT_THRESHOLD) -> Tuple[str, List[str]]:
    """Human-readable diff of two bench artifacts plus the list of
    regression descriptions (new slower than old beyond ``threshold``)."""
    lines: List[str] = []
    regressions: List[str] = []

    def compare(label: str, old_v, new_v) -> None:
        if old_v is None or new_v is None:
            lines.append(f"  {label}: {old_v} -> {new_v}")
            return
        delta = new_v - old_v
        pct = (delta / old_v * 100.0) if old_v else 0.0
        lines.append(
            f"  {label}: {old_v:.1f} -> {new_v:.1f} ms"
            f" ({delta:+.1f}, {pct:+.1f}%)"
        )
        if old_v > 0 and new_v > old_v * (1.0 + threshold):
            regressions.append(f"{label}: {old_v:.1f} -> {new_v:.1f} ms")

    lines.append(
        f"bench diff ({old.get('backend')}/"
        f"{old.get('device_kind')} -> {new.get('backend')}/"
        f"{new.get('device_kind')}):"
    )
    compare("headline", old.get("value"), new.get("value"))
    old_sweep = {
        e["n"]: e for e in old.get("sweep", ())
        if isinstance(e, dict) and "n" in e
    }
    new_sweep = {
        e["n"]: e for e in new.get("sweep", ())
        if isinstance(e, dict) and "n" in e
    }
    for n in sorted(set(old_sweep) | set(new_sweep)):
        a, b = old_sweep.get(n), new_sweep.get(n)
        compare(
            f"sweep n={n}",
            a.get("warmed_wall_ms") if a else None,
            b.get("warmed_wall_ms") if b else None,
        )
        compiles_a = a.get("jit_compiles_steady") if a else None
        compiles_b = b.get("jit_compiles_steady") if b else None
        if compiles_b not in (None, 0) and compiles_b != compiles_a:
            regressions.append(
                f"sweep n={n}: jit_compiles_steady {compiles_a} -> "
                f"{compiles_b} (steady-state recompile)"
            )
    return "\n".join(lines), regressions


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="render/diff/gate rapid-tpu profiling artifacts"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="per-phase attribution breakdown")
    p_render.add_argument("artifact", help="json_snapshot / statusz --json / "
                          "history-lines file")
    p_render.add_argument("--trace-out", default=None,
                          help="also write a Chrome-trace JSON of the phases")

    p_diff = sub.add_parser("diff", help="diff two bench JSON artifacts")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    p_diff.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                        help="regression threshold as a fraction "
                        f"(default {DEFAULT_THRESHOLD})")

    p_check = sub.add_parser(
        "check", help="gate one bench artifact against the north-star "
        "budget and the per-dimension budget table"
    )
    p_check.add_argument("artifact")
    p_check.add_argument("--budget-ms", type=float, default=NORTH_STAR_BUDGET_MS,
                         help="headline budget (default: the BASELINE.json "
                         "north-star 5000ms)")

    p_trend = sub.add_parser(
        "trend", help="headline + per-dimension trajectory across a series "
        "of bench runs (BENCH_rNN.json wrappers or raw artifacts); outage "
        "runs are marked, never counted as regressions"
    )
    p_trend.add_argument("artifacts", nargs="+",
                         help="bench run files, e.g. BENCH_r*.json")
    p_trend.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                         help="regression threshold between consecutive "
                         f"measured runs (default {DEFAULT_THRESHOLD})")

    args = parser.parse_args(argv)

    if args.cmd == "render":
        phases, step = extract_phases(load_profile_doc(args.artifact))
        print(render_breakdown(phases, step))
        if args.trace_out:
            with open(args.trace_out, "w") as fh:
                json.dump(chrome_trace_events(phases), fh)
            print(f"wrote Chrome trace to {args.trace_out}", file=sys.stderr)
        return 0 if phases else 2

    if args.cmd == "diff":
        text, regressions = diff_artifacts(
            load_bench_artifact(args.old), load_bench_artifact(args.new),
            threshold=args.threshold,
        )
        print(text)
        for reg in regressions:
            print(f"REGRESSION: {reg}", file=sys.stderr)
        return 3 if regressions else 0

    if args.cmd == "trend":
        entries = [load_trend_entry(path) for path in args.artifacts]
        text, regressions = trend_report(entries, threshold=args.threshold)
        print(text)
        for reg in regressions:
            print(f"REGRESSION: {reg}", file=sys.stderr)
        if regressions:
            return 3
        return 0 if any(e["artifact"] for e in entries) else 2

    # check
    doc = load_bench_artifact(args.artifact)
    if doc.get("value") is None:
        print(f"{args.artifact}: no headline value (outage artifact?)",
              file=sys.stderr)
        return 2
    lines, breaches = check_budgets(doc, args.budget_ms)
    for line in lines:
        print(line)
    for breach in breaches:
        print(f"BUDGET BREACH: {breach}", file=sys.stderr)
    return 3 if breaches else 0


if __name__ == "__main__":
    raise SystemExit(main())
