"""Cluster-wide timeseries assembly from scraped status history lines.

The port's own copy of ``rapid_tpu/profiling/scrape.py``, over the port's
``MetricsHistory.from_wire``. Any member answers a ``ClusterStatusRequest``
with its history ring's tail (``ClusterStatusResponse.history``, JSON
lines -- the same carriage as the flight-recorder journal). These helpers
fold a set of such responses into queryable views: per-node series maps
(``cluster_timeseries``) and the transposed per-series node map
(``merge_by_series``), the forms that tools/statusz.py and
tools/perfscope.py render."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from ..observability import MetricsHistory

# node -> series name -> [(ts_s, value)]
ClusterSeries = Dict[str, Dict[str, List[Tuple[float, float]]]]


def node_segments(
    history_lines: Iterable[str],
) -> List[Dict[str, List[Tuple[float, float]]]]:
    """One node's scraped history lines -> one series map per process
    incarnation. A restart hands the node a fresh ring whose ``seq`` stamp
    restarts at 1 (and, under virtual time, whose clock may restart too);
    a seq -- or, for seq-less old lines, timestamp -- regression therefore
    marks a segment boundary. Points are sorted within a segment only:
    sorting across segments would interleave the incarnations into one
    zig-zag series."""
    segments: List[Dict[str, List[Tuple[float, float]]]] = []
    series: Dict[str, List[Tuple[float, float]]] = {}
    prev_seq: float = float("-inf")
    prev_ts: float = float("-inf")
    for snap in MetricsHistory.from_wire(tuple(history_lines)):
        try:
            ts = float(snap.get("ts_s", 0.0))
        except (TypeError, ValueError):
            continue
        raw_seq = snap.get("seq")
        try:
            seq = float(raw_seq) if raw_seq is not None else None
        except (TypeError, ValueError):
            seq = None
        reset = (seq is not None and seq <= prev_seq) or (
            seq is None and ts < prev_ts
        )
        if reset and series:
            segments.append(
                {name: sorted(points) for name, points in series.items()}
            )
            series = {}
        prev_seq = seq if seq is not None else float("-inf")
        prev_ts = ts
        for table in ("counters", "gauges"):
            rows = snap.get(table)
            if not isinstance(rows, dict):
                continue
            for name, value in rows.items():
                try:
                    series.setdefault(str(name), []).append((ts, float(value)))
                except (TypeError, ValueError):
                    continue
        hists = snap.get("histograms")
        if isinstance(hists, dict):
            for name, pair in hists.items():
                try:
                    count, total = pair
                    series.setdefault(f"{name}.count", []).append(
                        (ts, float(count))
                    )
                    series.setdefault(f"{name}.sum", []).append(
                        (ts, float(total))
                    )
                except (TypeError, ValueError):
                    continue
    if series:
        segments.append(
            {name: sorted(points) for name, points in series.items()}
        )
    return segments


def node_series(history_lines: Iterable[str]) -> Dict[str, List[Tuple[float, float]]]:
    """One node's scraped history lines -> series name -> points, segments
    concatenated in incarnation order (see ``node_segments``). Counters and
    gauges map to their values; each histogram contributes ``<name>.count``
    and ``<name>.sum`` series."""
    series: Dict[str, List[Tuple[float, float]]] = {}
    for segment in node_segments(history_lines):
        for name, points in segment.items():
            series.setdefault(name, []).extend(points)
    return series


def cluster_timeseries(statuses: Iterable[object]) -> ClusterSeries:
    """A set of ``ClusterStatusResponse``s -> node -> series -> points.
    Responses without history (old peers, profiling off) contribute an
    empty map; duplicate responses from one node keep the larger scrape."""
    out: ClusterSeries = {}
    for status in statuses:
        node = str(getattr(status, "sender", ""))
        lines = tuple(getattr(status, "history", ()) or ())
        series = node_series(lines)
        prev = out.get(node)
        if prev is None or sum(map(len, series.values())) > sum(
            map(len, prev.values())
        ):
            out[node] = series
    return out


def merge_by_series(cluster: ClusterSeries) -> Dict[str, Dict[str, List[Tuple[float, float]]]]:
    """Transpose: series name -> node -> points (the cross-node comparison
    view -- e.g. one ``rounds`` panel with a line per member)."""
    out: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for node, series in cluster.items():
        for name, points in series.items():
            out.setdefault(name, {})[node] = points
    return out
