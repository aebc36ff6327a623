"""The port's own copy of ``rapid_tpu/search/fabric.py``.

A virtual-time serving-plane fabric for nemesis-search probes.

Why not the simulator: the sim plane's serving mirror reconciles by
max-merging across every live old-row replica, so quorum-counting bugs
in the real :class:`~..serving.engine.ServingEngine` promote path are
structurally invisible there. This fabric runs N real engines over one
``VirtualScheduler`` with every request routed through
``Nemesis.decide`` (drops, delays, duplicates, gray slowness, skewed
clocks, WAN topology latency), so a probe exercises the actual quorum
arithmetic in milliseconds of wall time.

The membership/placement plane is compiled, not simulated: long-lived
partitions, flappy links and heavily-slowed nodes against a member are
treated as what the failure detector would eventually conclude --
eviction -- scheduled ``DETECT_MS`` after the fault window opens. An
eviction rebuilds the placement map, replays the diff's handoff copies
store-to-store (donor first, then live old-row survivors: the failover
chain), and installs the new map on every engine *including the victim*
(the "kicked" signal; read fencing on a deposed leader is a lease
protocol the engine does not implement, so the fabric does not probe
that window).

Every delivery costs ``DELIVERY_MS`` so map installs, which are
synchronous, always complete before the first promote-sync probe lands;
a dropped or too-slow message surfaces to the sender as a TimeoutError
at ``DROP_TIMEOUT_MS``, feeding the engine's own retry loop.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from ..faults import (
    EGRESS,
    CellPartitionRule,
    FaultPlan,
    FlipFlopRule,
    Nemesis,
    PartitionRule,
    RestartNodeRule,
    SlowNodeRule,
    TornWriteRule,
)
from ..handoff.store import InMemoryPartitionStore
from ..observability import FlightRecorder, Metrics
from ..placement.engine import PlacementConfig, build_map, diff_maps
from ..runtime.futures import Promise
from ..runtime.scheduler import VirtualScheduler
from ..serving.engine import ServingEngine
from ..serving.kv import encode_kv
from ..types import Endpoint, Get, PutAck
from .checkers import ClientOp

DELIVERY_MS = 1        # per-hop latency: installs land before sync probes
DROP_TIMEOUT_MS = 60   # sender-side deadline for dropped/slow messages
DETECT_MS = 400        # fault window opens -> eviction decision
SETTLE_MS = 1500       # post-horizon drain for retries and syncs


def fabric_endpoints(n: int) -> List[Endpoint]:
    return [Endpoint.from_parts("node", 7000 + i) for i in range(n)]


class _FabricClient:
    """The engine-facing transport half: requests go through the fabric's
    nemesis-routed send."""

    def __init__(self, fabric: "ServingFabric", address: Endpoint) -> None:
        self._fabric = fabric
        self.address = address

    def send_message(self, remote: Endpoint, msg) -> Promise:
        return self._fabric._send(self.address, remote, msg)


class ServingFabric:
    """One probe's worth of cluster: N engines, one plan, one clock."""

    def __init__(self, plan: FaultPlan, n: int = 5, partitions: int = 16,
                 replicas: int = 3, config_seed: int = 0,
                 forensics: bool = False) -> None:
        self.plan = plan
        self.scheduler = VirtualScheduler()
        self.metrics = Metrics()
        # forensics mirror: HLC on the fabric's virtual clock stamps every
        # journal entry, so a violating probe's journal pins into the same
        # causal-timeline tooling as real members' bundles (off = exact
        # pre-forensics entries)
        self.hlc = None
        if forensics:
            from ..forensics.hlc import HlcClock

            self.hlc = HlcClock(clock=self.scheduler.now_ms)
        self.recorder = FlightRecorder(
            capacity=4096, node="fabric", clock=self.scheduler.now_ms,
            hlc=self.hlc, metrics=self.metrics,
        )
        self.nemesis = Nemesis(plan, self.scheduler, metrics=self.metrics)
        self.nemesis.arm(epoch_ms=0)
        self.endpoints = fabric_endpoints(n)
        self.live: Set[Endpoint] = set(self.endpoints)
        self.down: Set[Endpoint] = set()
        self.recovered: List[Endpoint] = []
        self.config = PlacementConfig(
            partitions=partitions, replicas=replicas, seed=config_seed
        )
        self.stores: Dict[Endpoint, InMemoryPartitionStore] = {}
        self.engines: Dict[Endpoint, ServingEngine] = {}
        for ep in self.endpoints:
            store = InMemoryPartitionStore()
            self.stores[ep] = store
            self.engines[ep] = ServingEngine(
                store, ep, _FabricClient(self, ep),
                self.nemesis.scheduler_for(ep),
                metrics=self.metrics, recorder=self.recorder,
            )
        self.epoch = 1
        self.map = build_map(
            tuple(self.endpoints), {}, self.config, self.epoch
        )
        # seed every owned partition with an empty blob (what a real
        # bootstrap's handoff plane leaves behind): a store holding nothing
        # abstains from sync/quorum answers, so an unseeded fabric would
        # churn forever on its very first map
        for p, row in enumerate(self.map.assignments):
            for ep in row:
                self.stores[ep].put(p, encode_kv({}))
        for ep in self.endpoints:
            self.engines[ep].update_map(self.map)
        self.history: List[ClientOp] = []
        # restart plane: a RestartNodeRule window is a crash-and-recover, not
        # an eviction -- the store survives, the identity is retained, and
        # recovery catches the node up through the replica row (the fabric
        # analogue of WAL replay + verified handoff pull). TornWriteRule
        # marks the victim's local copies untrustworthy past the last
        # snapshot, forcing the catch-up pull.
        self.torn: Set[Endpoint] = {
            r.match.dst for r in plan.rules
            if isinstance(r, TornWriteRule) and r.match.dst in self.stores
        }
        for rule in plan.rules:
            if not isinstance(rule, RestartNodeRule):
                continue
            victim = rule.match.dst
            if victim not in self.stores:
                continue
            for start, end in rule.windows:
                if end is None:
                    continue  # builder enforces closed; tolerate mutations
                self.scheduler.schedule(
                    start, lambda ep=victim: self._crash(ep)
                )
                self.scheduler.schedule(
                    end, lambda ep=victim: self._recover(ep)
                )
        for when_ms, ep in self._eviction_schedule(plan):
            self.scheduler.schedule(
                when_ms, lambda victim=ep: self._evict(victim)
            )

    # -- compiled membership plane --------------------------------------- #

    def _eviction_schedule(
        self, plan: FaultPlan
    ) -> List[Tuple[int, Endpoint]]:
        """What the FD would eventually decide: a member behind a lasting
        partition, flappy link, or timeout-scale slowness gets evicted
        DETECT_MS after the fault window opens."""
        out: List[Tuple[int, Endpoint]] = []
        victims: Set[Endpoint] = set()
        for rule in plan.rules:
            if isinstance(rule, CellPartitionRule):
                # a lasting cell partition isolates the named cell from the
                # rest of the fabric: outside the boundary every member of
                # that cell is probe-dead, so the FD evicts the whole cell
                # (the same externally visible outcome apply_plan_at
                # compiles for the device plane)
                from ..hierarchy.cells import cell_of

                for start, end in rule.windows:
                    if end is not None and end - start < DETECT_MS:
                        continue
                    for ep in self.endpoints:
                        if ep in victims or cell_of(
                            ep, rule.cells,
                            topology=plan.topology,
                            slots=plan.topology_slots or None,
                        ) != rule.cell:
                            continue
                        out.append((start + DETECT_MS, ep))
                        victims.add(ep)
                    break
                continue
            dst = rule.match.dst
            if dst is None or dst not in self.stores or dst in victims:
                continue
            if isinstance(rule, SlowNodeRule):
                if rule.response_delay_ms < DROP_TIMEOUT_MS:
                    continue  # slow but under timeouts: gray, not evicted
            elif not isinstance(rule, (PartitionRule, FlipFlopRule)):
                continue
            for start, end in rule.windows:
                if end is not None and end - start < DETECT_MS:
                    continue  # heals before the detector concludes
                out.append((start + DETECT_MS, dst))
                victims.add(dst)
                break
        return sorted(out, key=lambda pair: (pair[0], str(pair[1])))

    def _evict(self, victim: Endpoint) -> None:
        if victim not in self.live or len(self.live) <= 1:
            return
        self.live.discard(victim)
        # the detector's verdict, then the membership consequence: the
        # fd_signal/kicked pair brackets each eviction in the journal, so
        # multi-eviction plans produce edge vocabulary single-fault plans
        # cannot (that tail is what guided search climbs toward)
        self.recorder.record(
            "fd_signal", node=str(victim), verdict="evict",
        )
        self.epoch += 1
        self.metrics.incr("view_changes")
        old = self.map
        new = build_map(
            tuple(sorted(self.live)), {}, self.config, self.epoch
        )
        diff = diff_maps(old, new)
        self.recorder.record(
            "view_install", epoch=self.epoch, evicted=str(victim),
            members=len(self.live),
        )
        self.recorder.record(
            "placement_rebalance", version=new.version, moved=diff.moved,
        )
        for p, donor, recipient in diff.handoffs:
            if recipient not in self.stores:
                continue
            self.recorder.record(
                "handoff_started", partition=p,
                donor=None if donor is None else str(donor),
                recipient=str(recipient),
            )
            old_row = old.assignments[p] if p < len(old.assignments) else ()
            sources = [donor] if donor is not None else []
            sources.extend(n for n in old_row if n not in sources)
            blob = None
            used: Optional[Endpoint] = None
            for source in sources:
                if source not in self.live or source == recipient:
                    continue
                held = self.stores[source].get(p)
                if held is not None:
                    blob, used = held, source
                    break
            if blob is None:
                self.metrics.incr("handoff.sessions_failed")
                self.recorder.record(
                    "handoff_failed", partition=p, recipient=str(recipient),
                )
                continue
            if donor is not None and used != donor:
                self.metrics.incr("handoff.failovers")
            self.stores[recipient].put(p, blob)
            self.recorder.record(
                "handoff_complete", partition=p, source=str(used),
                recipient=str(recipient),
            )
        # victim included: the kicked signal (see module docstring)
        for ep in sorted(self.engines):
            self.engines[ep].update_map(new)
        self.recorder.record("kicked", node=str(victim), epoch=self.epoch)
        self.map = new

    # -- restart plane ----------------------------------------------------- #

    def _crash(self, ep: Endpoint) -> None:
        if ep not in self.live:
            return  # already evicted: nothing left to restart
        self.down.add(ep)
        self.recorder.record("fd_signal", node=str(ep), verdict="restart")

    def _recover(self, ep: Endpoint) -> None:
        if ep not in self.down:
            return
        self.down.discard(ep)
        from ..serving.kv import decode_kv, encode_kv

        torn = ep in self.torn
        if torn:
            self.metrics.incr("durability.torn_truncations")
        replayed = 0
        for p, row in enumerate(self.map.assignments):
            if ep not in row:
                continue
            # max-merge across the live row plus the survivor's own copy
            # (unless torn): any acked write reached a majority, so at least
            # one live replica still holds it, and the merged blob written
            # back everywhere is what fingerprint convergence asserts
            merged: dict = {}
            holders = [
                peer for peer in row
                if peer in self.live and peer not in self.down
            ]
            for holder in holders:
                blob = self.stores[holder].get(p)
                if holder == ep and torn:
                    continue  # torn tail: local copy is not trustworthy
                for key, (version, value) in decode_kv(blob).items():
                    cur = merged.get(key)
                    if cur is None or version > cur[0]:
                        merged[key] = (version, value)
            blob = encode_kv(merged)
            for holder in holders:
                if self.stores[holder].get(p) != blob:
                    self.stores[holder].put(p, blob)
                    if holder == ep:
                        replayed += 1
        self.engines[ep].update_map(self.map)  # may have moved while down
        self.recovered.append(ep)
        if replayed:
            self.metrics.incr("durability.replayed_records", replayed)
        self.recorder.record(
            "durability_recovered", node=str(ep), replayed=replayed,
        )

    # -- nemesis-routed transport ----------------------------------------- #

    def _send(self, src: Endpoint, dst: Endpoint, msg) -> Promise:
        kind = type(msg).__name__
        if src in self.down or dst in self.down:
            # a restarting process neither sends nor answers: the sender
            # sees the same deadline a dropped message produces
            out: Promise = Promise()
            self.scheduler.schedule(
                DROP_TIMEOUT_MS,
                lambda: out.try_set_exception(
                    TimeoutError(f"{dst} is restarting")
                ),
            )
            return out
        d = self.nemesis.decide(src, dst, msg, EGRESS)
        if d.drop:
            self.metrics.incr("nemesis_dropped", at="egress", msg=kind)
            out: Promise = Promise()
            self.scheduler.schedule(
                DROP_TIMEOUT_MS,
                lambda: out.try_set_exception(
                    TimeoutError(f"nemesis dropped {kind} to {dst}")
                ),
            )
            return out
        for _ in range(d.duplicates):
            self.metrics.incr("nemesis_duplicated", at="egress", msg=kind)
            self._deliver(dst, msg, DELIVERY_MS + d.delay_ms, Promise())
        out = Promise()
        total = DELIVERY_MS + d.delay_ms + d.slow_ms
        if d.slow_ms > 0:
            self.metrics.incr("nemesis_slowed", at="egress", msg=kind)
            if total >= DROP_TIMEOUT_MS:
                # gray node: delivered and applied, but the sender's
                # deadline fires first -- indistinguishable from a drop
                self.scheduler.schedule(
                    DROP_TIMEOUT_MS,
                    lambda: out.try_set_exception(TimeoutError(
                        f"{dst} answered {total} ms late"
                    )),
                )
        elif d.delay_ms > 0:
            self.metrics.incr(
                "nemesis_reordered" if d.reordered else "nemesis_delayed",
                at="egress", msg=kind,
            )
        else:
            self.metrics.incr("nemesis_passed", at="egress", msg=kind)
        self._deliver(dst, msg, total, out)
        return out

    def _deliver(self, dst: Endpoint, msg, after_ms: int,
                 out: Promise) -> None:
        def dispatch() -> None:
            engine = self.engines.get(dst)
            if engine is None or dst in self.down:
                out.try_set_exception(TimeoutError(f"no such node {dst}"))
                return
            reply = (
                engine.handle_get(msg) if isinstance(msg, Get)
                else engine.handle_put(msg)
            )
            reply.add_callback(
                lambda p: self.scheduler.schedule(
                    DELIVERY_MS, lambda: _settle(p, out)
                )
            )

        self.scheduler.schedule(after_ms, dispatch)

    # -- workload ---------------------------------------------------------- #

    def run(self, horizon_ms: int, ops: int, keys: int = 6) -> List[ClientOp]:
        """Seeded closed-ish workload: ops spread evenly over the horizon,
        puts and gets from every node's co-located client, then a settle
        drain. Returns the completed-op history."""
        rnd = random.Random(self.plan.seed * 2_000_003 + 17)
        gap = max(1, horizon_ms // (ops + 1))
        for i in range(ops):
            client = self.endpoints[rnd.randrange(len(self.endpoints))]
            key = b"k%02d" % rnd.randrange(keys)
            if rnd.random() < 0.55:
                self._schedule_op(
                    (i + 1) * gap, "put", client, key, b"v-%d" % i
                )
            else:
                self._schedule_op((i + 1) * gap, "get", client, key)
        self.scheduler.run_until_time(horizon_ms + SETTLE_MS)
        return self.history

    def _schedule_op(self, at_ms: int, op: str, client: Endpoint,
                     key: bytes, value: bytes = b"") -> None:
        self.scheduler.schedule(
            at_ms, lambda: self._start_op(op, client, key, value)
        )

    def _start_op(self, op: str, client: Endpoint, key: bytes,
               value: bytes) -> None:
        if client in self.down:
            return  # co-located client restarts with its node: no op is sent
        engine = self.engines[client]
        invoke_ms = self.scheduler.now_ms()
        promise = (
            engine.client_put(key, value) if op == "put"
            else engine.client_get(key)
        )

        def finish(p: Promise) -> None:
            ack = None if p.exception() is not None else p._result  # noqa: SLF001
            if not isinstance(ack, PutAck):
                return  # never completed: no linearizability obligation
            self.history.append(ClientOp(
                client=str(client), op=op, key=key,
                value=value if op == "put" else ack.value,
                version=ack.version, status=ack.status,
                invoke_ms=invoke_ms, complete_ms=self.scheduler.now_ms(),
            ))

        promise.add_callback(finish)

    # -- probe outputs ----------------------------------------------------- #

    def journal(self) -> List[dict]:
        return self.recorder.tail(4096)

    def live_digests(self) -> Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]]:
        return {
            str(ep): self.engines[ep].leader_digest()
            for ep in sorted(self.live)
        }

    def map_versions(self) -> Dict[str, int]:
        return {
            str(ep): getattr(self.engines[ep]._map, "version", None)  # noqa: SLF001
            for ep in sorted(self.live)
        }

    def hierarchy_digests(
        self, cells: int
    ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...], int]]:
        """Each live node's composed hierarchy digest, derived from that
        node's OWN map (not shared fabric state): cells, per-cell leaders,
        and composed global fingerprint -- the triple
        ``check_hierarchy_agreement`` consumes. Nodes whose maps diverged
        mid-probe produce divergent fingerprints."""
        from ..hierarchy.cells import cell_members
        from ..hierarchy.parent import (
            CellState, cell_fingerprint, cell_leaders, compose_fingerprint,
        )

        out: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...], int]] = {}
        for ep in sorted(self.live):
            held = self.engines[ep]._map  # noqa: SLF001
            members = sorted(
                {n for row in held.assignments for n in row},
                key=lambda e: (e.hostname, e.port),
            )
            grouped = cell_members(members, cells)
            rows = []
            for cell in sorted(grouped):
                group = grouped[cell]
                rows.append(CellState(
                    cell=cell,
                    epoch=cell_fingerprint(group),
                    size=len(group),
                    leader=str(cell_leaders(group, 1)[0]),
                    fingerprint=cell_fingerprint(group),
                ))
            out[str(ep)] = (
                tuple(r.cell for r in rows),
                tuple(r.leader for r in rows),
                compose_fingerprint(rows),
            )
        return out

    def durable_versions(self) -> Dict[bytes, int]:
        """Ground truth for the durability invariant: per key, the highest
        version any live, up replica holds in stable storage."""
        from ..serving.kv import decode_kv

        out: Dict[bytes, int] = {}
        for p, row in enumerate(self.map.assignments):
            for ep in row:
                if ep not in self.live or ep in self.down:
                    continue
                blob = self.stores[ep].get(p)
                if blob is None:
                    continue
                for key, (version, _value) in decode_kv(blob).items():
                    if version > out.get(key, 0):
                        out[key] = version
        return out

    def recovery_fingerprints(self) -> List[Tuple[int, str, object]]:
        """``(partition, node, fingerprint)`` over every row that contains a
        recovered node -- the durability checker's convergence witness."""
        recovered = set(self.recovered)
        out: List[Tuple[int, str, object]] = []
        for p, row in enumerate(self.map.assignments):
            if not any(ep in recovered for ep in row):
                continue
            for ep in row:
                if ep not in self.live or ep in self.down:
                    continue
                out.append((p, str(ep), self.stores[ep].fingerprint(p)))
        return out


def _settle(src: Promise, dst: Promise) -> None:
    exc = src.exception()
    if exc is not None:
        dst.try_set_exception(exc)
    else:
        dst.try_set_result(src._result)  # noqa: SLF001