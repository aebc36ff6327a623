"""Churn-episode attribution: name the membership event a burn is paying
for. The port of ``rapid_tpu/slo/attrib.py``.

* :func:`episodes_from_journal` folds a flight-recorder journal tail
  (entry dicts, or their JSON-line form) into :class:`Episode` values -- a
  ``view-change`` episode opens at the first ``fd_signal`` carrying a churn
  trace id and closes at the ``view_install`` stamped with the same id,
  with the eviction count from the install and the moved-partition count
  from the matching ``placement_rebalance``; a ``recovery`` episode wraps a
  ``durability_recovered`` replay.
* :func:`attribute_burn` picks the episode overlapping a burn window
  (largest overlap wins, later start breaking ties).
* :func:`describe` renders the operator line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union


@dataclass(frozen=True)
class Episode:
    """One membership episode reconstructed from the journal."""

    kind: str            # "view-change" | "recovery"
    trace_id: int        # churn trace id (0 when the journal predates ids)
    start_ms: int
    end_ms: int
    nodes_evicted: int = 0
    nodes_added: int = 0
    partitions_moved: int = 0
    configuration_id: int = 0
    node: str = ""

    def overlap_ms(self, window_start_ms: int, window_end_ms: int) -> int:
        """Closed-interval overlap with a burn window (an instantaneous
        episode inside the window still counts as 1 ms)."""
        lo = max(self.start_ms, int(window_start_ms))
        hi = min(self.end_ms, int(window_end_ms))
        if lo > hi:
            return 0
        return max(hi - lo, 1)


def _parse_entries(
    journal: Sequence[Union[str, Dict[str, object]]],
) -> List[Dict[str, object]]:
    out: List[Dict[str, object]] = []
    for raw in journal:
        if isinstance(raw, str):
            try:
                entry = json.loads(raw)
            except (ValueError, TypeError):
                continue
        else:
            entry = raw
        if isinstance(entry, dict) and "kind" in entry:
            out.append(entry)
    return out


def _ms(entry: Dict[str, object]) -> int:
    value = entry.get("virtual_ms")
    try:
        return int(value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return 0


def _detail_int(entry: Dict[str, object], key: str) -> int:
    detail = entry.get("detail")
    if not isinstance(detail, dict):
        return 0
    try:
        return int(detail.get(key, 0))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return 0


def episodes_from_journal(
    journal: Sequence[Union[str, Dict[str, object]]],
) -> List[Episode]:
    """Fold a journal tail into episodes, ordered by start time.

    Works across the journal dialects of both planes: entries may be JSON
    lines (the status-RPC wire form) or live entry dicts. An ``fd_signal``
    with a trace id opens (or extends) an episode; the ``view_install``
    carrying the same trace id closes it. An install with no matching
    signal in the tail (the ring evicted it) still yields an episode whose
    start is the install itself. A still-open signal with no install yet
    yields an in-flight episode (end = its own start)."""
    entries = sorted(_parse_entries(journal), key=_ms)
    open_signals: Dict[int, int] = {}   # trace_id -> first fd_signal ms
    moved_by_config: Dict[int, int] = {}
    episodes: List[Episode] = []
    for entry in entries:
        kind = entry.get("kind")
        if kind == "fd_signal":
            trace = _detail_int(entry, "trace_id")
            open_signals.setdefault(trace, _ms(entry))
        elif kind == "placement_rebalance":
            config = _detail_int(entry, "configuration_id")
            moved_by_config[config] = (
                moved_by_config.get(config, 0) + _detail_int(entry, "moved")
            )
        elif kind == "view_install":
            trace = _detail_int(entry, "trace_id")
            start = open_signals.pop(trace, _ms(entry)) if trace else _ms(entry)
            config = _detail_int(entry, "configuration_id")
            episodes.append(Episode(
                kind="view-change",
                trace_id=trace,
                start_ms=start,
                end_ms=_ms(entry),
                nodes_evicted=_detail_int(entry, "removed"),
                nodes_added=_detail_int(entry, "added"),
                partitions_moved=moved_by_config.get(config, 0),
                configuration_id=config,
                node=str(entry.get("node", "")),
            ))
        elif kind == "durability_recovered":
            episodes.append(Episode(
                kind="recovery",
                trace_id=0,
                start_ms=_ms(entry),
                end_ms=_ms(entry),
                partitions_moved=0,
                nodes_evicted=0,
                configuration_id=0,
                node=str(
                    (entry.get("detail") or {}).get("node", "")  # type: ignore[union-attr]
                    or entry.get("node", "")
                ),
            ))
    # signals whose install has not landed yet: in-flight episodes
    for trace, start in sorted(open_signals.items()):
        if trace:
            episodes.append(Episode(
                kind="view-change", trace_id=trace,
                start_ms=start, end_ms=start,
            ))
    episodes.sort(key=lambda e: (e.start_ms, e.end_ms, e.trace_id))
    return episodes


def attribute_burn(
    episodes: Sequence[Episode],
    window_start_ms: int, window_end_ms: int,
) -> Optional[Episode]:
    """The episode a burn window is attributed to: the one overlapping
    ``[window_start_ms, window_end_ms]`` the longest, later start winning
    ties. None when nothing overlaps (the burn is load-born, not
    churn-born -- the honest answer)."""
    best: Optional[Episode] = None
    best_key = (-1, -1)
    for episode in episodes:
        overlap = episode.overlap_ms(window_start_ms, window_end_ms)
        if overlap <= 0:
            continue
        key = (overlap, episode.start_ms)
        if key > best_key:
            best, best_key = episode, key
    return best


def describe(episode: Optional[Episode]) -> str:
    """The operator rendering of an attribution (tools/slo.py, statusz)."""
    if episode is None:
        return "unattributed (no overlapping membership episode)"
    if episode.kind == "recovery":
        where = f" on {episode.node}" if episode.node else ""
        return f"recovery replay{where}"
    bits = []
    if episode.nodes_evicted:
        bits.append(f"{episode.nodes_evicted} nodes evicted")
    if episode.nodes_added:
        bits.append(f"{episode.nodes_added} nodes added")
    if episode.partitions_moved:
        bits.append(f"{episode.partitions_moved} partitions moved")
    suffix = f" ({', '.join(bits)})" if bits else ""
    return (
        f"view-change episode {episode.trace_id or episode.configuration_id}"
        f"{suffix}"
    )
