"""One configuration of Rapid's protocol, round by round, in NumPy.

Written from the paper (Rapid, USENIX ATC'18, sections 4-5) and the Java
reference it cites, for the faults the benchmark injects: crash-stop
members, members behind random ingress loss, and joiners. Every member
probes its subject on each of the K rings once a round; the observer's
failure counter on an edge counts failed probes and raises one DOWN alert
when it reaches the threshold (PingPongFailureDetector.java:40,69-77). A
joiner's expected observers raise one UP alert each. Every alert reaches
every member. The cut detector's watermarks: a subject with H or more
reports is stable, one with L to H-1 is in flux, and an edge whose
observer is itself in flux or stable counts as a report for a subject in
flux, once a DOWN alert has been seen (MultiNodeCutDetector.java:76-164).
A member proposes the stable set in the first round with a stable subject
and none in flux; every live member votes in that round; the votes arrive
one round later, where a 3/4 quorum of the membership decides
(FastPaxos.java:125-156). A random loss draw is threefry's uniform at the
edge's flat index ``observer * K + ring`` under the round's probe key, the
configuration's key ``(0, seed mod 2**32)`` split once a round.

Only subjects that can be reported are tracked: the members that are
crashed or lossy, and the joiners. Everything else has no report.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hashes
from .cluster import Cluster


@dataclass(frozen=True)
class Protocol:
    k: int
    h: int
    l: int
    fd_threshold: int
    fd_interval_ms: int
    batching_window_ms: int


@dataclass
class Decision:
    cut: np.ndarray  # sorted slots
    decided_round: int


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), held in
    float32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def decide(
    cluster: Cluster, proto: Protocol, active: np.ndarray, alive: np.ndarray,
    drop: np.ndarray, key_seed: int, joiners: Sequence[int], max_rounds: int,
    join_obs: Optional[Dict[int, List[int]]] = None, bfloat16: bool = False,
) -> Optional[Decision]:
    """The decision of one configuration from its first round, or None if
    none comes within ``max_rounds`` rounds. ``join_obs``: each joiner's
    expected observers (worked out here when not given). ``bfloat16``: the
    loss draw and its probability compared in bfloat16, the control's
    lower precision."""
    k = proto.k
    down = np.flatnonzero(active & (~alive | (drop > 0)))
    joiners = [int(j) for j in joiners]
    if join_obs is None:
        join_obs = {j: cluster.join_observers(j, active) for j in joiners}
    tracked = [int(d) for d in down] + joiners
    t = len(tracked)
    if t == 0:
        return None
    sender = np.array([cluster.observers(d, active) for d in down]
                      + [join_obs[j] for j in joiners], dtype=np.int64).reshape(t, k)
    nd = len(down)
    # the DOWN edges: (observer sender[d, r]) -> (subject d)
    obs = sender[:nd]
    observer_up = alive[obs] & active[obs]
    subj_alive = alive[down][:, None]
    p = drop[down][:, None].astype(np.float32)
    always = observer_up & (~subj_alive | (p >= 1))
    drawn = observer_up & subj_alive & (p > 0) & (p < 1)
    counters = obs * k + np.arange(k)[None, :]
    prob = np.broadcast_to(p, drawn.shape)
    if bfloat16:
        prob = to_bfloat16(prob)
    fails = np.zeros((nd, k), dtype=np.int64)
    alerted = np.zeros((nd, k), dtype=bool)
    reports = np.zeros((t, k), dtype=bool)
    if joiners:
        reports[nd:] = np.array([alive[join_obs[j]] & active[join_obs[j]]
                                 for j in joiners]).reshape(len(joiners), k)
    seen_down = False
    n = int(active.sum())
    quorum = n - (n - 1) // 4
    live = int((active & alive).sum())
    key = (0, key_seed & 0xFFFFFFFF)
    any_drawn = drawn.any()
    tracked_slots = np.array(tracked, dtype=np.int64)
    marked_slot = np.zeros(cluster.capacity, dtype=bool)  # by slot, for the senders
    for r in range(max_rounds):
        key, probe = hashes.split(key)
        fail = always.copy()
        if any_drawn:
            u = hashes.uniform_at(probe, counters[drawn])
            if bfloat16:
                u = to_bfloat16(u)
            fail[drawn] = u < prob[drawn]
        fails += fail
        fire = (fails >= proto.fd_threshold) & ~alerted
        alerted |= fire
        if fire.any():
            seen_down = True
            reports[:nd] |= fire
        counts = reports.sum(axis=1)
        flux = (counts >= proto.l) & (counts < proto.h)
        stable = counts >= proto.h
        if seen_down and flux.any():
            marked_slot[tracked_slots] = flux | stable
            sender_marked = marked_slot[sender]
            reports = reports | (flux[:, None] & sender_marked)
            counts = reports.sum(axis=1)
            flux = (counts >= proto.l) & (counts < proto.h)
            stable = counts >= proto.h
        if stable.any() and not flux.any():
            if live < quorum or r + 1 >= max_rounds:
                return None
            cut = np.sort(np.array(tracked, dtype=np.int64)[stable])
            return Decision(cut=cut, decided_round=r + 2)
    return None


@dataclass
class Expected:
    """What one view change of the run should be."""

    cut: np.ndarray
    configuration_id: int
    membership_size: int
    virtual_time_ms: int


class Replay:
    """The run's membership from its first configuration, episode by
    episode, with the view changes each should bring."""

    def __init__(self, cluster: Cluster, proto: Protocol, sim_seed: int,
                 round_budget: int, bfloat16: bool = False, seen_all: bool = True) -> None:
        c = cluster.capacity
        self.cluster, self.proto, self.sim_seed = cluster, proto, sim_seed
        self.round_budget, self.bfloat16, self.seen_all = round_budget, bfloat16, seen_all
        self.active = np.ones(c, dtype=bool)
        self.alive = np.ones(c, dtype=bool)
        self.drop = np.zeros(c, dtype=np.float32)
        self.virtual_ms = 0
        self.changes: List[Expected] = []
        self.join_observers: Dict[Tuple[int, int], List[int]] = {}  # (wave, slot)
        self.unfinished = 0

    def _view_change(self, decision: Decision) -> None:
        cut = decision.cut
        added = cut[~self.active[cut]]
        self.active[cut] = ~self.active[cut]
        self.alive[added] = True
        self.cluster.admit(added)
        self.virtual_ms += (decision.decided_round * self.proto.fd_interval_ms
                            + self.proto.batching_window_ms)
        self.changes.append(Expected(
            cut=cut, configuration_id=self.cluster.configuration_id(self.active, self.seen_all),
            membership_size=int(self.active.sum()), virtual_time_ms=self.virtual_ms))

    def failure(self, fault: str, victims: np.ndarray, loss: float) -> None:
        if fault == "crash":
            self.alive[victims] = False
        else:
            self.drop[victims] = np.float32(loss)
        while self.active[victims].any():
            decision = decide(self.cluster, self.proto, self.active, self.alive, self.drop,
                              self.sim_seed + len(self.changes), (), self.round_budget,
                              bfloat16=self.bfloat16)
            if decision is None:
                self.unfinished += 1
                return
            self._view_change(decision)

    def wave(self, number: int, slots: np.ndarray, ids: np.ndarray) -> None:
        for slot, (high, low) in zip(slots, ids):
            self.cluster.reseat(int(slot), int(high), int(low))
        self.drop[slots] = 0.0
        pending = [int(s) for s in slots]
        while pending:
            obs = {j: self.cluster.join_observers(j, self.active) for j in pending}
            for j, o in obs.items():
                self.join_observers.setdefault((number, j), o)
            decision = decide(self.cluster, self.proto, self.active, self.alive, self.drop,
                              self.sim_seed + len(self.changes), pending, self.round_budget,
                              join_obs=obs, bfloat16=self.bfloat16)
            if decision is None:
                self.unfinished += 1
                return
            self._view_change(decision)
            pending = [j for j in pending if not self.active[j]]
