"""The port's own copy of ``rapid_tpu/search/checkers.py``.

Invariant checkers for nemesis-search probes: pure data in, one typed
violation out.

Every checker takes run artifacts (operation histories, view tokens,
store fingerprints) as plain values and raises
:class:`InvariantViolation` on the first witness it finds, tagged with
which invariant fired -- the search keys its corpus and the shrinker
keys its "still reproduces?" predicate on that tag, never on message
text. A checker that passes returns ``None``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

from ..types import PutAck

# the closed set of invariant tags (violations are keyed on these)
INVARIANTS = (
    "linearizability",
    "view-agreement",
    "config-parity",
    "fingerprint-agreement",
    "gray-collateral",
    "durability",
    "metastable-recovery",
    "hierarchy-agreement",
)


class InvariantViolation(AssertionError):
    """One invariant, one witness. ``invariant`` is the INVARIANTS tag
    that fired; ``detail`` is the human-readable witness."""

    def __init__(self, invariant: str, detail: str) -> None:
        assert invariant in INVARIANTS, invariant
        super().__init__(f"{invariant}: {detail}")
        self.invariant = invariant
        self.detail = detail

    def to_json(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail}


@dataclass(frozen=True)
class ClientOp:
    """One completed client operation in a multi-client history. ``status``
    is a PutAck status; ops that never completed (sender timeout) carry no
    linearizability obligation and should not appear here."""

    client: str
    op: str                 # "put" | "get"
    key: bytes
    value: bytes
    version: int
    status: int
    invoke_ms: int
    complete_ms: int


def check_linearizable_single_client(history) -> None:
    """Per-key linearizability for a single sequential client: acked-put
    versions strictly increase, and every successful read returns either
    the latest acked write or a newer version whose value matches a write
    the client attempted (a RETRY'd put that partially replicated is
    allowed to surface -- it is a concurrent write, not a corruption)."""
    acked: dict = {}
    attempted: dict = {}
    for op, key, value, version, status in history:
        if op == "put":
            attempted.setdefault(key, set()).add(value)
            if status == PutAck.STATUS_OK:
                prev = acked.get(key)
                assert prev is None or version > prev[0], (
                    f"acked version regressed on {key!r}"
                )
                acked[key] = (version, value)
        elif op == "get" and status == PutAck.STATUS_OK:
            prev = acked.get(key)
            if prev is None:
                assert value in attempted.get(key, set()), (
                    f"read of {key!r} returned a value never written"
                )
                continue
            assert version >= prev[0], (
                f"stale read on {key!r}: {version} < acked {prev[0]}"
            )
            if version == prev[0]:
                assert value == prev[1], f"torn read on {key!r}"
            else:
                assert value in attempted[key], (
                    f"read of {key!r} returned a value never written"
                )


def check_linearizable_history(history: Sequence[ClientOp]) -> None:
    """Multi-client per-key linearizability over a completed-op history,
    generalizing :func:`check_linearizable_single_client` to concurrent
    clients via real-time (invoke/complete) order:

    * acked-put versions on one key are unique (two OK acks for the same
      version is a double-leader / split-brain write);
    * acked puts respect real time (a put that completed before another
      began must carry the lower version);
    * a successful read invoked after an acked put completed sees at least
      that version (NOT_FOUND there is a lost acked write; a lower OK
      version is a stale read);
    * a read matching an acked version returns that write's bytes (torn
      read), and any unmatched value must be one some client attempted;
    * reads of one key do not travel backwards in real time.
    """
    by_key: Dict[bytes, List[ClientOp]] = {}
    for entry in history:
        by_key.setdefault(entry.key, []).append(entry)
    for key in sorted(by_key):
        ops = sorted(by_key[key], key=lambda o: (o.invoke_ms, o.complete_ms))
        _check_key_linearizable(key, ops)


def _check_key_linearizable(key: bytes, ops: Sequence[ClientOp]) -> None:
    acked = [o for o in ops if o.op == "put" and o.status == PutAck.STATUS_OK]
    attempted = {o.value for o in ops if o.op == "put"}
    by_version: Dict[int, ClientOp] = {}
    for put in acked:
        prior = by_version.get(put.version)
        if prior is not None:
            raise InvariantViolation(
                "linearizability",
                f"double-leader write on {key!r}: version {put.version} "
                f"acked for {prior.client} ({prior.value!r}) and "
                f"{put.client} ({put.value!r})",
            )
        by_version[put.version] = put
    for a in acked:
        for b in acked:
            if a is b:
                continue  # a 0-ms local-apply ack must not conflict with itself
            if a.complete_ms <= b.invoke_ms and a.version >= b.version:
                raise InvariantViolation(
                    "linearizability",
                    f"acked writes on {key!r} out of real-time order: "
                    f"version {a.version} completed at {a.complete_ms}ms "
                    f"but version {b.version} began at {b.invoke_ms}ms",
                )
    reads = [
        o for o in ops
        if o.op == "get" and o.status in (PutAck.STATUS_OK, PutAck.STATUS_NOT_FOUND)
    ]
    for read in reads:
        floor = max(
            (w.version for w in acked if w.complete_ms <= read.invoke_ms),
            default=0,
        )
        seen = read.version if read.status == PutAck.STATUS_OK else 0
        if seen < floor:
            kind = (
                "lost acked write" if read.status == PutAck.STATUS_NOT_FOUND
                else "stale read"
            )
            raise InvariantViolation(
                "linearizability",
                f"{kind} on {key!r}: client {read.client} saw version "
                f"{seen} after version {floor} was acked",
            )
        if read.status == PutAck.STATUS_OK:
            write = by_version.get(read.version)
            if write is not None and read.value != write.value:
                raise InvariantViolation(
                    "linearizability",
                    f"torn read on {key!r}: version {read.version} returned "
                    f"{read.value!r}, acked write was {write.value!r}",
                )
            if write is None and read.value not in attempted:
                raise InvariantViolation(
                    "linearizability",
                    f"read of {key!r} returned {read.value!r}, a value "
                    f"never written by any client",
                )
    for r1 in reads:
        for r2 in reads:
            if r1.complete_ms <= r2.invoke_ms:
                v1 = r1.version if r1.status == PutAck.STATUS_OK else 0
                v2 = r2.version if r2.status == PutAck.STATUS_OK else 0
                if v2 < v1:
                    raise InvariantViolation(
                        "linearizability",
                        f"non-monotonic reads on {key!r}: version {v1} then "
                        f"version {v2} later in real time",
                    )


def check_gray_collateral(
    faulted: Iterable[object], evicted: Iterable[object],
) -> None:
    """Pure gray plans (slow_node / lossy_link only) injure performance,
    never liveness, so the only defensible eviction is of a node the plan
    faulted. ``faulted`` is the label set of every gray rule's dst,
    ``evicted`` the labels of every node a view change removed; an evicted
    label outside ``faulted`` is a collateral eviction -- a healthy node
    paying for someone else's grayness, the failure mode the adaptive FD's
    tier-relative scoring exists to prevent. Callers must skip the check
    (vacuous) when any gray rule carries ``dst=None``: an unscoped rule
    faults every link, so every member is legitimately suspect."""
    faulted_set = {str(f) for f in faulted}
    collateral = sorted(
        {str(e) for e in evicted if str(e) not in faulted_set}
    )
    if collateral:
        raise InvariantViolation(
            "gray-collateral",
            f"healthy nodes evicted under a pure gray plan: "
            f"{', '.join(collateral)} (faulted: {sorted(faulted_set)})",
        )


def check_durability(
    acked: Mapping[bytes, int],
    durable: Mapping[bytes, int],
    recovery_replicas: Iterable[Tuple[int, str, object]] = (),
) -> None:
    """Restart-survival invariant: every acked write outlives every
    restart, and a recovered node converges with its replica row.

    ``acked`` maps key -> highest version any client received an OK ack
    for; ``durable`` maps key -> highest version found in stable storage
    across the live replicas after the run quiesces. A key whose durable
    version trails its acked version is a lost acked write. Optional
    ``recovery_replicas`` is ``(partition, node, fingerprint)`` restricted
    to rows holding a recovered node; any fingerprint split there means
    recovery replayed to a state the row does not agree with."""
    for key in sorted(acked):
        floor = int(acked[key])
        held = int(durable.get(key, 0))
        if held < floor:
            raise InvariantViolation(
                "durability",
                f"lost acked write on {key!r}: version {floor} was acked "
                f"but stable storage holds {held if held else 'nothing'}",
            )
    by_partition: Dict[int, Dict[object, List[str]]] = {}
    for partition, node, fingerprint in recovery_replicas:
        by_partition.setdefault(int(partition), {}).setdefault(
            fingerprint, []
        ).append(node)
    for partition in sorted(by_partition):
        holders = by_partition[partition]
        if len(holders) > 1:
            detail = "; ".join(
                f"{fp!r} on {', '.join(sorted(nodes))}"
                for fp, nodes in sorted(holders.items(), key=lambda kv: repr(kv[0]))
            )
            raise InvariantViolation(
                "durability",
                f"recovered replica row diverged on partition {partition}: "
                f"{detail}",
            )


def goodput_samples(
    history: Sequence[ClientOp], bucket_ms: int = 256,
) -> List[Tuple[int, int, int]]:
    """Fold a completed-op history into ``(bucket_start_ms, offered, good)``
    samples on a fixed-width time grid -- the goodput SLI derived from the
    probe's own client history (invoke time counts the op as offered; an
    OK completion, or NOT_FOUND for a read, counts it as good)."""
    buckets: Dict[int, List[int]] = {}
    for o in history:
        start = (int(o.invoke_ms) // int(bucket_ms)) * int(bucket_ms)
        row = buckets.setdefault(start, [0, 0])
        row[0] += 1
        if o.status == PutAck.STATUS_OK or (
            o.op == "get" and o.status == PutAck.STATUS_NOT_FOUND
        ):
            row[1] += 1
    return sorted((b, row[0], row[1]) for b, row in buckets.items())


def check_metastable_recovery(
    history: Sequence[ClientOp],
    *,
    faulted_from_ms: int,
    healed_at_ms: int,
    min_ops: int = 8,
    margin: float = 0.25,
    baseline_floor: float = 0.9,
) -> None:
    """Metastability invariant: once the injected faults have cleared and
    offered load is back to its baseline shape, the goodput SLI must
    return to (near) its pre-fault baseline. A system that stays degraded
    after the trigger is gone -- retry storms, stuck redirect loops, a
    leader map that never repoints -- is in a metastable failure state,
    the class of outage the SLO plane's burn alerts exist to catch.

    ``faulted_from_ms`` is when the first fault window opened (ops invoked
    strictly before it form the baseline); ``healed_at_ms`` is when the
    caller knows every fault had cleared AND recovery had a settle period
    (ops invoked at/after it form the tail). Conservative by design: with
    fewer than ``min_ops`` in either segment, or a baseline already below
    ``baseline_floor`` goodput, the check is vacuous -- it judges
    *recovery*, not the outage itself."""

    def ratio(ops: List[ClientOp]) -> float:
        good = sum(
            1 for o in ops
            if o.status == PutAck.STATUS_OK
            or (o.op == "get" and o.status == PutAck.STATUS_NOT_FOUND)
        )
        return good / len(ops)

    baseline = [o for o in history if o.invoke_ms < faulted_from_ms]
    tail = [o for o in history if o.invoke_ms >= healed_at_ms]
    if len(baseline) < min_ops or len(tail) < min_ops:
        return
    base_ratio = ratio(baseline)
    if base_ratio < baseline_floor:
        return
    tail_ratio = ratio(tail)
    if tail_ratio < base_ratio - margin:
        raise InvariantViolation(
            "metastable-recovery",
            f"goodput stuck at {tail_ratio:.3f} after faults cleared at "
            f"{healed_at_ms}ms (baseline {base_ratio:.3f} before "
            f"{faulted_from_ms}ms, margin {margin}): the system did not "
            f"recover once offered load returned to baseline",
        )


def check_view_agreement(views: Mapping[str, object]) -> None:
    """Every node must report the same view token (configuration id, map
    version, membership digest -- any comparable value)."""
    groups: Dict[str, List[str]] = {}
    for node in sorted(views):
        groups.setdefault(repr(views[node]), []).append(node)
    if len(groups) > 1:
        parts = "; ".join(
            f"{token} on {', '.join(nodes)}"
            for token, nodes in sorted(groups.items())
        )
        raise InvariantViolation(
            "view-agreement",
            f"{len(groups)} distinct views across {len(views)} nodes: "
            f"{parts}",
        )


def check_leader_agreement(
    digests: Mapping[str, Tuple[Sequence[int], Sequence[str]]],
) -> None:
    """``leader_digest()`` per node: any two members replicating the same
    partition must name the same leader (split-brain check)."""
    claims: Dict[int, Dict[str, str]] = {}
    for node in sorted(digests):
        partitions, leaders = digests[node]
        for p, leader in zip(partitions, leaders):
            claims.setdefault(int(p), {})[node] = leader
    for p in sorted(claims):
        named = sorted(set(claims[p].values()))
        if len(named) > 1:
            raise InvariantViolation(
                "view-agreement",
                f"split-brain on partition {p}: leaders {named} claimed "
                f"by {sorted(claims[p])}",
            )


def check_hierarchy_agreement(
    digests: Mapping[str, Tuple[Sequence[int], Sequence[str], int]],
) -> None:
    """``(global_cells, global_leaders, global_fingerprint)`` per node --
    the hierarchy plane's status digest (ClusterStatusResponse fields, or
    HierarchyPlane.status_fields in-process). Two invariants:

    * **composed-view convergence**: once quiesced, every member's
      composed global view folds to the same fingerprint over the same
      cell set (everyone adopted the parent decision);
    * **single live leader per cell**: no two members name different
      leaders for one cell -- a cell partition may stall the composition
      but must never split a cell's leadership (leader order is a pure
      function of the cell view, so disagreement means the views split).
    """
    fingerprints: Dict[int, List[str]] = {}
    claims: Dict[int, Dict[str, str]] = {}
    for node in sorted(digests):
        cells, leaders, fingerprint = digests[node]
        fingerprints.setdefault(int(fingerprint), []).append(node)
        for cell, leader in zip(cells, leaders):
            claims.setdefault(int(cell), {})[node] = leader
    for cell in sorted(claims):
        named = sorted(set(claims[cell].values()))
        if len(named) > 1:
            raise InvariantViolation(
                "hierarchy-agreement",
                f"two live leaders for cell {cell}: {named} claimed by "
                f"{sorted(claims[cell])}",
            )
    if len(fingerprints) > 1:
        parts = "; ".join(
            f"{fp} on {', '.join(nodes)}"
            for fp, nodes in sorted(fingerprints.items())
        )
        raise InvariantViolation(
            "hierarchy-agreement",
            f"composed global views diverged across "
            f"{len(digests)} members: {parts}",
        )


def check_config_parity(stamped: int, recomputed: int) -> None:
    """The configuration id a decision stamped must equal the id
    recomputed from the decided membership."""
    if int(stamped) != int(recomputed):
        raise InvariantViolation(
            "config-parity",
            f"decided configuration id {stamped} != recomputed "
            f"{recomputed}",
        )


def check_fingerprint_agreement(
    replicas: Iterable[Tuple[int, str, object]],
) -> None:
    """``(partition, node, fingerprint)`` triples: every replica of one
    partition must hold byte-identical content once the system quiesces."""
    by_partition: Dict[int, Dict[object, List[str]]] = {}
    for partition, node, fingerprint in replicas:
        by_partition.setdefault(int(partition), {}).setdefault(
            fingerprint, []
        ).append(node)
    for partition in sorted(by_partition):
        holders = by_partition[partition]
        if len(holders) > 1:
            detail = "; ".join(
                f"{fp!r} on {', '.join(sorted(nodes))}"
                for fp, nodes in sorted(holders.items(), key=lambda kv: repr(kv[0]))
            )
            raise InvariantViolation(
                "fingerprint-agreement",
                f"partition {partition} diverged across replicas: {detail}",
            )
