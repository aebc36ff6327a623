"""The port's own copy of ``rapid_tpu/search/coverage.py``.

Coverage fingerprints for nemesis-search probes.

A probe's coverage is a frozenset of hashable signals extracted from its
flight-recorder journal and metrics snapshot:

* ``("kind", k)``            -- an EVENT_CATALOG kind fired at least once;
* ``("edge", a, b)``         -- kinds a, b fired back-to-back in journal
                                sequence order (the "transition" signal the
                                guided search optimizes for);
* ``("metric", name)``       -- a counter from COVERAGE_METRICS went
                                nonzero (fast vs classic consensus paths,
                                handoff failover chains, serving churn);
* ``("fault", rendered)``    -- a labeled nemesis counter went nonzero
                                (``nemesis_dropped{at=egress,msg=Put}``);
                                the action x message-kind cross product is
                                what makes compound plans score higher
                                than any single rule.

The hunter unions these across probes; a plan that contributes any new
signal enters the mutation corpus.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Mapping, Sequence, Tuple

from ..observability import EVENT_CATALOG

Signal = Tuple[str, ...]

# behavior-path counters worth distinguishing probes by (all in
# METRIC_CATALOG); names, not values: coverage is "did this path fire",
# not "how often"
COVERAGE_METRICS = (
    "classic_coordinator_races",
    "consensus.classic_decisions",
    "consensus.classic_rounds_started",
    "consensus.fast_decisions",
    "handoff.failovers",
    "handoff.retries",
    "handoff.sessions_failed",
    "serving.not_leader_redirects",
    "serving.put_retries",
    "serving.quorum_reads",
    "serving.reconciled_replicas",
    "view_changes",
)


def coverage_from_journal(entries: Sequence[Mapping]) -> FrozenSet[Signal]:
    """Kind singletons + adjacent-pair transitions over the journal's kind
    sequence (entries as FlightRecorder.tail returns them)."""
    kinds = [e["kind"] for e in sorted(entries, key=lambda e: e["seq"])]
    signals = {("kind", k) for k in kinds}
    signals.update(("edge", a, b) for a, b in zip(kinds, kinds[1:]))
    return frozenset(signals)


def coverage_from_metrics(snapshot: Mapping[str, float]) -> FrozenSet[Signal]:
    return frozenset(
        ("metric", name) for name in COVERAGE_METRICS if snapshot.get(name)
    )


def coverage_from_fault_actions(
    rendered: Mapping[str, float],
) -> FrozenSet[Signal]:
    """Per-label nemesis-action signals from a Metrics.snapshot() flat view
    (labeled counters render as ``name{k=v,...}``). Only the nemesis_*
    family counts: which fault actions hit which message kinds."""
    return frozenset(
        ("fault", name) for name, value in rendered.items()
        if value and name.startswith("nemesis_")
    )


def transitions(signals: Iterable[Signal]) -> FrozenSet[Signal]:
    """The distinct EVENT_CATALOG transitions in a coverage set: edges
    whose endpoints are both catalog kinds (the guided-vs-unguided report
    metric)."""
    return frozenset(
        s for s in signals
        if s[0] == "edge" and s[1] in EVENT_CATALOG and s[2] in EVENT_CATALOG
    )
