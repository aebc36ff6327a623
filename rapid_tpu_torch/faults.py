"""Deterministic fault plans and their decisions: the plan half of
``rapid_tpu/faults.py``.

- :class:`FaultPlan`: a seeded, declarative schedule of per-link faults --
  probabilistic drops, one-way partitions with open/heal windows,
  flip-flop schedules, delay distributions, duplication, reordering, and
  the gray and storage rules (slow node, lossy link, clock skew, wire
  version, restart, torn write, disk stall) -- with ``to_json`` /
  ``from_json``. A plan is pure data, so one plan replays across runs and
  across the two packages: a ``rapid_tpu.faults.FaultPlan`` crosses into
  the port through its JSON form, and message types resolve by name in the
  port's ``types``.
- :class:`Nemesis`: one *armed* instance of a plan for one run. It takes
  time from a clock seam (``now_ms()``; the simulator passes its virtual
  clock) and derives every probabilistic decision from ``(plan seed, rule,
  link, per-link sequence number)`` through a keyed hash -- never from
  shared RNG state -- so both packages draw alike for every rule kind.
- The transport half: :class:`NemesisClient` / :class:`NemesisServer`
  (minted by ``Nemesis.client`` / ``Nemesis.server``) wrap any protocol-plane
  transport's ``IMessagingClient`` / ``IMessagingServer`` and apply the
  plan at egress and ingress, and :class:`SkewedScheduler` (from
  ``Nemesis.scheduler_for``) is a ``ClockSkewRule``'d node's drifted clock.

The simulator's handoff and serving planes consult ``Nemesis.decide`` per
chunk pull and per replication write.

The simulator half: ``replay_on_simulator`` replays a plan on the port's
``Simulator`` through every schedule boundary, ``apply_plan_at`` sets its
fault arrays to a plan's state at one plan time and ``apply_topology``
compiles a ``LatencyTopology`` onto its delivery groups and delays; rules the
round model cannot express raise ``UnsupportedDeviceFault``. They call only
the methods the port's ``Simulator`` shares with JAX's, so a plan replays
alike on both. A cell partition finds its cells for every slot at once
(``_slot_cells``), and a replay looks its rules' endpoints up in the
simulator's identities (``_SlotIndex``) instead of building
``endpoint_slots``' ``Endpoint`` for every slot.
"""

from __future__ import annotations

import hashlib
import math
import random
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .hashing import endpoint_hash_batch
from .hierarchy.cells import _CELL_SEED_BASE
from .hierarchy.cells import cell_of as _hier_cell_of
from .messaging.base import IMessagingClient, IMessagingServer
from .messaging.retries import call_with_retries
from .observability import Metrics, global_metrics
from .runtime.futures import Promise
from .runtime.lockdep import make_lock
from .runtime.scheduler import Scheduler
from .settings import Settings
from .types import Endpoint, ProbeMessage, RapidMessage

EGRESS = "egress"
INGRESS = "ingress"

# (start_ms, end_ms) relative to the nemesis arm epoch; end None = forever
Window = Tuple[int, Optional[int]]
_ALWAYS: Tuple[Window, ...] = ((0, None),)


def _u01(seed: int, *parts) -> float:
    """Deterministic uniform in [0, 1) keyed on ``(seed, parts)``.

    blake2b, not ``hash()``: decisions must not depend on per-process hash
    salting, and must not depend on draw interleaving across links -- each
    (rule, link, sequence-number) tuple owns its value outright.
    """
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", seed))
    for part in parts:
        h.update(str(part).encode())
        h.update(b"\x1f")
    return int.from_bytes(h.digest(), "little") / 2.0**64


@dataclass(frozen=True)
class LinkMatch:
    """Which (src, dst, message type) triples a rule applies to; None = any."""

    src: Optional[Endpoint] = None
    dst: Optional[Endpoint] = None
    msg_types: Optional[Tuple[type, ...]] = None

    def matches(self, src: Optional[Endpoint], dst: Optional[Endpoint],
                msg: RapidMessage) -> bool:
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.msg_types is not None and not isinstance(msg, self.msg_types):
            return False
        return True


@dataclass(frozen=True)
class Rule:
    """Base: a link selector, an application side, and open/heal windows."""

    match: LinkMatch = LinkMatch()
    at: str = EGRESS
    windows: Tuple[Window, ...] = _ALWAYS

    def active_at(self, t_ms: int) -> bool:
        return any(
            start <= t_ms and (end is None or t_ms < end)
            for start, end in self.windows
        )


@dataclass(frozen=True)
class DropRule(Rule):
    """Drop each matching message independently with ``probability``."""

    probability: float = 1.0


@dataclass(frozen=True)
class PartitionRule(Rule):
    """Deterministic one-way cut while a window is open (iptables INPUT)."""


@dataclass(frozen=True)
class CellPartitionRule(Rule):
    """Hierarchy-plane fault: cut every link CROSSING cell ``cell``'s
    boundary while a window is open, leaving intra-cell traffic alone --
    the cell keeps running Rapid internally but its leader can no longer
    reach peer leaders (and vice versa). ``cells`` is the rendezvous cell
    count (hierarchy/cells.py); with a plan topology the zone is the cell,
    matching the engine's assignment discipline."""

    cell: int = 0
    cells: int = 2


@dataclass(frozen=True)
class FlipFlopRule(Rule):
    """The paper's flip-flop failure: the link alternates cut/healed every
    half ``period_ms``, starting cut at ``start_ms`` (within the windows)."""

    period_ms: int = 2000
    start_ms: int = 0

    def active_at(self, t_ms: int) -> bool:
        if t_ms < self.start_ms or not super().active_at(t_ms):
            return False
        half = max(1, self.period_ms // 2)
        return ((t_ms - self.start_ms) // half) % 2 == 0


@dataclass(frozen=True)
class DelayRule(Rule):
    """Extra one-way latency: ``base_ms`` plus uniform [0, jitter_ms]."""

    base_ms: int = 0
    jitter_ms: int = 0


@dataclass(frozen=True)
class DuplicateRule(Rule):
    """Deliver a second copy of each matching message with ``probability``."""

    probability: float = 0.0


@dataclass(frozen=True)
class ReorderRule(Rule):
    """Hold back each matching message with ``probability`` by a uniform
    [1, max_extra_ms] extra delay, letting later traffic overtake it."""

    probability: float = 0.0
    max_extra_ms: int = 100


@dataclass(frozen=True)
class LossyLinkRule(DropRule):
    """Gray failure: the link stays *connected* but drops a sustained
    ``probability`` of traffic -- below the one-way-cut threshold a
    PartitionRule models. A distinct class (not just a DropRule with small
    p) so plans, telemetry and the device catalog name the failure mode the
    paper's flip-flop battery gestures at but never isolates."""


@dataclass(frozen=True)
class SlowNodeRule(Rule):
    """Gray failure: the matched destination answers *every* message, just
    ``response_delay_ms`` late. When that exceeds the sender's per-message
    timeout the sender observes a timeout -- exactly what a gray node looks
    like from an FD's perspective -- while the node itself keeps receiving
    and processing traffic (it is alive, voting, and will answer probes it
    receives; only its answers come back too late to matter)."""

    response_delay_ms: int = 0


@dataclass(frozen=True)
class ClockSkewRule(Rule):
    """Gray failure: the matched *source* node's clock runs at ``rate``×
    real time, offset by ``offset_ms``. Consulted through
    :meth:`Nemesis.scheduler_for`, not the message path: the skewed node's
    timers (FD probe intervals, retry backoff, message deadlines) all fire
    early or late by the drift while every other node keeps true time."""

    offset_ms: int = 0
    rate: float = 1.0


@dataclass(frozen=True)
class WireVersionRule(Rule):
    """Rolling upgrade: the matched *source* node encodes every egress
    message at wire ``version`` -- round-tripped through the real codec with
    that version's reserved ``__``-prefixed extension keys injected (newer
    peer) or optional defaulted fields thinned (older peer) -- proving the
    mixed-version cluster converges on bytes a same-version cluster never
    exercises. See messaging/codec.py:wire_roundtrip."""

    version: int = 2


@dataclass(frozen=True)
class RestartNodeRule(Rule):
    """Process restart: the matched destination is dead for the span of
    each window (killed at its start, restarted -- with WAL recovery --
    at its end). The windows ARE the down periods, so they must all be
    closed: an open-ended window is a crash-stop, which PartitionRule and
    the fabric's eviction machinery already model. While down the node
    neither answers nor sends; at the window's end the harness recovers
    its durable store (log-over-snapshot) and re-pulls whatever it missed
    through verified handoff catch-up."""


@dataclass(frozen=True)
class TornWriteRule(Rule):
    """Storage fault: the matched destination's WAL tail is torn while it
    is down -- ``drop_bytes`` truncated off the last segment, or
    (``corrupt``) a byte inside the final record flipped so its CRC fails
    -- modeling a crash mid-append or a half-flushed page. Applied by the
    recovery harness at restart (the message plane is untouched): recovery
    must truncate at the first bad record and converge via catch-up."""

    drop_bytes: int = 3
    corrupt: bool = False


@dataclass(frozen=True)
class DiskStallRule(Rule):
    """Gray storage failure: every fsync on the matched destination takes
    ``stall_ms`` extra -- a dying disk, a saturated EBS volume. The rule
    matches the ``Put`` wire (builder-enforced) so the serving plane's
    quorum writes feel it while probes stay unaffected: the node looks
    healthy to every FD while its write path quietly drags."""

    stall_ms: int = 0


# Device-plane behavior of every Rule subclass, as the JAX package's
# catalog states it:
#   compiled  -- mapped onto the Simulator's fault arrays by apply_plan_at
#   absorbed  -- invisible to the round model within a documented bound
RULE_CATALOG = {
    "DropRule": "compiled",        # -> Simulator.ingress_loss
    "PartitionRule": "compiled",   # -> Simulator.one_way_ingress_partition
    "CellPartitionRule": "compiled",  # cell slots -> ingress partition
    "FlipFlopRule": "compiled",    # -> partition toggled at phase edges
    "LossyLinkRule": "compiled",   # -> Simulator.ingress_loss
    "SlowNodeRule": "compiled",    # >= one round -> partition-equivalent
    "DelayRule": "absorbed",       # sub-round latency only
    "DuplicateRule": "absorbed",   # probe exchanges are idempotent
    "ReorderRule": "absorbed",     # intra-round reordering only
    "ClockSkewRule": "absorbed",   # bounded drift never flips a round
    "WireVersionRule": "absorbed", # wire bytes are not modeled on device
    "RestartNodeRule": "compiled", # down window -> partition-equivalent cut
    "TornWriteRule": "absorbed",   # storage-level; no device storage model
    "DiskStallRule": "absorbed",   # Put-path latency; probes unaffected
}


class FaultPlan:
    """A seeded, declarative fault schedule (pure data, reusable across runs).

    Builder methods append immutable rules and return ``self``::

        plan = (FaultPlan(seed=7)
                .partition_one_way(dst=victim)                  # from t=0 on
                .flip_flop(period_ms=4000, dst=other)
                .drop(0.2, msg_types=(ProbeMessage,))
                .delay(base_ms=10, jitter_ms=5, src=a, dst=b))
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self.rules: List[Rule] = []
        # optional WAN latency structure (sim/topology.py LatencyTopology):
        # every egress decision adds the topology's one-way latency for the
        # (src, dst) pair; topology_slots maps protocol-plane endpoints to
        # topology indices (device-plane slots ARE indices)
        self.topology = None
        self.topology_slots: Dict[Endpoint, int] = {}

    def with_topology(self, topology,
                      slots: Optional[Dict[Endpoint, int]] = None) -> "FaultPlan":
        """Attach a :class:`~.sim.topology.LatencyTopology`. ``slots`` maps
        each protocol-plane endpoint to its topology index (omit on the
        device plane, where slot == index)."""
        self.topology = topology
        self.topology_slots = dict(slots) if slots else {}
        return self

    @staticmethod
    def _check_windows(windows: Tuple[Window, ...]) -> None:
        """Reject windows that could never fire (a silent no-op fault plan
        is a test that asserts nothing)."""
        for start, end in windows:
            if start < 0:
                raise ValueError(f"window start {start} < 0")
            if end is not None and end <= start:
                raise ValueError(
                    f"window ({start}, {end}) can never fire: end <= start"
                )

    @staticmethod
    def _overlap(a: Tuple[Window, ...], b: Tuple[Window, ...]) -> bool:
        return any(
            (e2 is None or s1 < e2) and (e1 is None or s2 < e1)
            for s1, e1 in a
            for s2, e2 in b
        )

    def _check_partition_conflicts(self, rule: Rule) -> None:
        """A PartitionRule and a FlipFlopRule (or two schedule-bearing
        partition rules) on the SAME link with overlapping windows
        contradict each other -- the plain cut masks the flip-flop's healed
        phases, so the plan silently tests less than it claims."""
        if not isinstance(rule, (PartitionRule, FlipFlopRule)):
            return
        for prior in self.rules:
            if not isinstance(prior, (PartitionRule, FlipFlopRule)):
                continue
            if (prior.match.src, prior.match.dst, prior.at) != (
                rule.match.src, rule.match.dst, rule.at
            ):
                continue
            if self._overlap(prior.windows, rule.windows):
                raise ValueError(
                    f"contradictory partition rules on the same link "
                    f"{rule.match.src} -> {rule.match.dst}: "
                    f"{type(prior).__name__}{prior.windows} overlaps "
                    f"{type(rule).__name__}{rule.windows}"
                )

    def _add(self, rule: Rule) -> "FaultPlan":
        assert rule.at in (EGRESS, INGRESS), rule.at
        self._check_windows(rule.windows)
        self._check_partition_conflicts(rule)
        self.rules.append(rule)
        return self

    @staticmethod
    def _match(src, dst, msg_types) -> LinkMatch:
        return LinkMatch(
            src=src, dst=dst,
            msg_types=tuple(msg_types) if msg_types is not None else None,
        )

    def drop(self, probability: float, src: Optional[Endpoint] = None,
             dst: Optional[Endpoint] = None, msg_types=None,
             windows: Tuple[Window, ...] = _ALWAYS,
             at: str = EGRESS) -> "FaultPlan":
        assert 0.0 <= probability <= 1.0, probability
        return self._add(DropRule(
            match=self._match(src, dst, msg_types), at=at, windows=windows,
            probability=probability,
        ))

    def partition_one_way(self, src: Optional[Endpoint] = None,
                          dst: Optional[Endpoint] = None,
                          windows: Tuple[Window, ...] = _ALWAYS,
                          at: str = EGRESS) -> "FaultPlan":
        return self._add(PartitionRule(
            match=self._match(src, dst, None), at=at, windows=windows,
        ))

    def cell_partition(self, cell: int, cells: int,
                       windows: Tuple[Window, ...] = _ALWAYS,
                       at: str = EGRESS) -> "FaultPlan":
        """Isolate hierarchy cell ``cell`` (of ``cells``) from every other
        cell while a window is open: cross-boundary messages drop in both
        directions, intra-cell traffic is untouched."""
        if cells < 2:
            raise ValueError(
                f"a cell partition needs >= 2 cells, got {cells}"
            )
        if not 0 <= cell < cells:
            raise ValueError(f"cell {cell} outside [0, {cells})")
        return self._add(CellPartitionRule(
            match=self._match(None, None, None), at=at, windows=windows,
            cell=cell, cells=cells,
        ))

    def flip_flop(self, period_ms: int, src: Optional[Endpoint] = None,
                  dst: Optional[Endpoint] = None, start_ms: int = 0,
                  windows: Tuple[Window, ...] = _ALWAYS,
                  at: str = EGRESS) -> "FaultPlan":
        assert period_ms >= 2, period_ms
        return self._add(FlipFlopRule(
            match=self._match(src, dst, None), at=at, windows=windows,
            period_ms=period_ms, start_ms=start_ms,
        ))

    def delay(self, base_ms: int, jitter_ms: int = 0,
              src: Optional[Endpoint] = None, dst: Optional[Endpoint] = None,
              msg_types=None, windows: Tuple[Window, ...] = _ALWAYS,
              at: str = EGRESS) -> "FaultPlan":
        assert base_ms >= 0 and jitter_ms >= 0
        return self._add(DelayRule(
            match=self._match(src, dst, msg_types), at=at, windows=windows,
            base_ms=base_ms, jitter_ms=jitter_ms,
        ))

    def duplicate(self, probability: float, src: Optional[Endpoint] = None,
                  dst: Optional[Endpoint] = None, msg_types=None,
                  windows: Tuple[Window, ...] = _ALWAYS,
                  at: str = EGRESS) -> "FaultPlan":
        assert 0.0 <= probability <= 1.0, probability
        return self._add(DuplicateRule(
            match=self._match(src, dst, msg_types), at=at, windows=windows,
            probability=probability,
        ))

    def reorder(self, probability: float, max_extra_ms: int = 100,
                src: Optional[Endpoint] = None,
                dst: Optional[Endpoint] = None, msg_types=None,
                windows: Tuple[Window, ...] = _ALWAYS,
                at: str = EGRESS) -> "FaultPlan":
        assert 0.0 <= probability <= 1.0, probability
        assert max_extra_ms >= 1
        return self._add(ReorderRule(
            match=self._match(src, dst, msg_types), at=at, windows=windows,
            probability=probability, max_extra_ms=max_extra_ms,
        ))

    def lossy_link(self, probability: float, src: Optional[Endpoint] = None,
                   dst: Optional[Endpoint] = None, msg_types=None,
                   windows: Tuple[Window, ...] = _ALWAYS,
                   at: str = EGRESS) -> "FaultPlan":
        if not 0.0 < probability < 1.0:
            raise ValueError(
                f"a lossy link drops some but not all traffic; p="
                f"{probability} is a {'partition' if probability == 1.0 else 'no-op'}"
            )
        return self._add(LossyLinkRule(
            match=self._match(src, dst, msg_types), at=at, windows=windows,
            probability=probability,
        ))

    def slow_node(self, node: Endpoint, response_delay_ms: int,
                  windows: Tuple[Window, ...] = _ALWAYS) -> "FaultPlan":
        assert response_delay_ms >= 1, response_delay_ms
        return self._add(SlowNodeRule(
            match=self._match(None, node, None), at=EGRESS, windows=windows,
            response_delay_ms=response_delay_ms,
        ))

    def clock_skew(self, node: Endpoint, offset_ms: int = 0,
                   rate: float = 1.0) -> "FaultPlan":
        if rate <= 0.0:
            raise ValueError(f"clock rate must be positive, got {rate}")
        # no windows: a clock that jumps mid-run would retroactively reorder
        # already-scheduled timers, which no real skewed clock does
        return self._add(ClockSkewRule(
            match=self._match(node, None, None), at=EGRESS, windows=_ALWAYS,
            offset_ms=offset_ms, rate=rate,
        ))

    def wire_version(self, node: Endpoint, version: int,
                     windows: Tuple[Window, ...] = _ALWAYS) -> "FaultPlan":
        return self._add(WireVersionRule(
            match=self._match(node, None, None), at=EGRESS, windows=windows,
            version=version,
        ))

    def restart_node(self, node: Endpoint,
                     windows: Tuple[Window, ...]) -> "FaultPlan":
        """Kill ``node`` at each window's start and restart it (with
        recovery) at its end. Windows must be closed -- an open-ended one
        is a crash-stop, which partition_one_way already models."""
        if not windows:
            raise ValueError("restart_node needs at least one down window")
        if any(end is None for _start, end in windows):
            raise ValueError(
                "restart_node windows must be closed (a restart implies a "
                "return); use partition_one_way for a crash-stop"
            )
        return self._add(RestartNodeRule(
            match=self._match(None, node, None), at=EGRESS, windows=windows,
        ))

    def torn_write(self, node: Endpoint,
                   windows: Tuple[Window, ...] = _ALWAYS,
                   drop_bytes: int = 3, corrupt: bool = False) -> "FaultPlan":
        """Tear ``node``'s WAL tail during recovery from any restart that
        overlaps a window: truncate ``drop_bytes`` off the last segment,
        or flip a byte in its final record when ``corrupt``."""
        if drop_bytes < 1:
            raise ValueError(f"drop_bytes must be >= 1, got {drop_bytes}")
        return self._add(TornWriteRule(
            match=self._match(None, node, None), at=EGRESS, windows=windows,
            drop_bytes=drop_bytes, corrupt=bool(corrupt),
        ))

    def disk_stall(self, node: Endpoint, stall_ms: int,
                   windows: Tuple[Window, ...] = _ALWAYS) -> "FaultPlan":
        """Every fsync on ``node`` takes ``stall_ms`` extra; surfaces on
        the Put wire (quorum writes drag) while probes stay healthy."""
        from .types import Put

        if stall_ms < 1:
            raise ValueError(f"stall_ms must be >= 1, got {stall_ms}")
        return self._add(DiskStallRule(
            match=self._match(None, node, (Put,)), at=EGRESS,
            windows=windows, stall_ms=stall_ms,
        ))

    def to_json(self) -> dict:
        """JSON-able dict of the whole plan: rules (with windows and link
        matches), seed, topology + endpoint slots. ``from_json`` is the
        inverse; the pair is what lets the nemesis search pin shrunk plans
        as corpus files (scenarios/corpus/)."""
        data: dict = {
            "seed": self.seed,
            "rules": [_rule_to_json(rule) for rule in self.rules],
        }
        if self.topology is not None:
            data["topology"] = {
                name: int(getattr(self.topology, name))
                for name in _TOPOLOGY_FIELDS
            }
        if self.topology_slots:
            data["topology_slots"] = {
                str(ep): int(slot)
                for ep, slot in sorted(self.topology_slots.items())
            }
        return data

    @staticmethod
    def from_json(data: dict) -> "FaultPlan":
        """Rebuild a plan from ``to_json`` output by re-invoking the builder
        methods, so every construction-time check (window sanity, partition
        conflicts, parameter ranges) re-runs on load -- a corpus file cannot
        smuggle in a plan the builders would have rejected. Raises
        ValueError on unknown rule/message/topology fields and whatever the
        builders raise on invalid parameters."""
        if not isinstance(data, dict):
            raise ValueError(
                f"fault plan must be a JSON object, got {type(data).__name__}"
            )
        plan = FaultPlan(seed=int(data.get("seed", 0)))
        for spec in data.get("rules", ()):
            _build_rule(plan, spec)
        topo = data.get("topology")
        slots_raw = data.get("topology_slots") or {}
        if topo is not None:
            from .sim.topology import LatencyTopology

            unknown = set(topo) - set(_TOPOLOGY_FIELDS)
            if unknown:
                raise ValueError(f"unknown topology fields {sorted(unknown)}")
            slots = {
                Endpoint.from_string(ep): int(slot)
                for ep, slot in slots_raw.items()
            }
            plan.with_topology(
                LatencyTopology(**{k: int(v) for k, v in topo.items()}),
                slots or None,
            )
        elif slots_raw:
            raise ValueError("topology_slots without a topology")
        return plan


# LatencyTopology's full constructor surface, in declaration order
_TOPOLOGY_FIELDS = (
    "racks", "zones", "regions", "rack_rtt_ms", "zone_rtt_ms",
    "region_rtt_ms", "inter_region_rtt_ms",
)


def _msg_type(name: str) -> type:
    from . import types as _types

    cls = getattr(_types, name, None)
    if not isinstance(cls, type):
        raise ValueError(f"unknown message type {name!r} in rapid_tpu_torch.types")
    return cls


def _rule_to_json(rule: Rule) -> dict:
    msg_types = None
    if rule.match.msg_types is not None:
        for cls in rule.match.msg_types:
            if _msg_type(cls.__name__) is not cls:
                raise ValueError(
                    f"message type {cls!r} is not addressable by name "
                    f"in rapid_tpu_torch.types; the plan cannot round-trip"
                )
        msg_types = [cls.__name__ for cls in rule.match.msg_types]
    spec: dict = {
        "type": type(rule).__name__,
        "at": rule.at,
        "windows": [[start, end] for start, end in rule.windows],
        "src": None if rule.match.src is None else str(rule.match.src),
        "dst": None if rule.match.dst is None else str(rule.match.dst),
        "msg_types": msg_types,
    }
    if isinstance(rule, FlipFlopRule):
        spec["period_ms"] = rule.period_ms
        spec["start_ms"] = rule.start_ms
    elif isinstance(rule, CellPartitionRule):
        spec["cell"] = rule.cell
        spec["cells"] = rule.cells
    elif isinstance(rule, DropRule):  # includes LossyLinkRule
        spec["probability"] = rule.probability
    elif isinstance(rule, DelayRule):
        spec["base_ms"] = rule.base_ms
        spec["jitter_ms"] = rule.jitter_ms
    elif isinstance(rule, DuplicateRule):
        spec["probability"] = rule.probability
    elif isinstance(rule, ReorderRule):
        spec["probability"] = rule.probability
        spec["max_extra_ms"] = rule.max_extra_ms
    elif isinstance(rule, SlowNodeRule):
        spec["response_delay_ms"] = rule.response_delay_ms
    elif isinstance(rule, ClockSkewRule):
        spec["offset_ms"] = rule.offset_ms
        spec["rate"] = rule.rate
    elif isinstance(rule, WireVersionRule):
        spec["version"] = rule.version
    elif isinstance(rule, TornWriteRule):
        spec["drop_bytes"] = rule.drop_bytes
        spec["corrupt"] = rule.corrupt
    elif isinstance(rule, DiskStallRule):
        spec["stall_ms"] = rule.stall_ms
    return spec


def _build_rule(plan: FaultPlan, spec: dict) -> None:
    if not isinstance(spec, dict):
        raise ValueError(
            f"rule spec must be a JSON object, got {type(spec).__name__}"
        )
    kind = spec.get("type")
    windows = tuple(
        (int(start), None if end is None else int(end))
        for start, end in (spec.get("windows") or _ALWAYS)
    )
    src = spec.get("src")
    src = None if src is None else Endpoint.from_string(src)
    dst = spec.get("dst")
    dst = None if dst is None else Endpoint.from_string(dst)
    raw_types = spec.get("msg_types")
    msg_types = (
        None if raw_types is None
        else tuple(_msg_type(name) for name in raw_types)
    )
    at = spec.get("at", EGRESS)
    common = dict(src=src, dst=dst, msg_types=msg_types, windows=windows,
                  at=at)
    if kind == "DropRule":
        plan.drop(float(spec["probability"]), **common)
    elif kind == "PartitionRule":
        plan.partition_one_way(src=src, dst=dst, windows=windows, at=at)
    elif kind == "CellPartitionRule":
        plan.cell_partition(int(spec["cell"]), int(spec["cells"]),
                            windows=windows, at=at)
    elif kind == "FlipFlopRule":
        plan.flip_flop(int(spec["period_ms"]), src=src, dst=dst,
                       start_ms=int(spec.get("start_ms", 0)),
                       windows=windows, at=at)
    elif kind == "DelayRule":
        plan.delay(int(spec["base_ms"]), int(spec.get("jitter_ms", 0)),
                   **common)
    elif kind == "DuplicateRule":
        plan.duplicate(float(spec["probability"]), **common)
    elif kind == "ReorderRule":
        plan.reorder(float(spec["probability"]),
                     int(spec.get("max_extra_ms", 100)), **common)
    elif kind == "LossyLinkRule":
        plan.lossy_link(float(spec["probability"]), **common)
    elif kind == "SlowNodeRule":
        if dst is None:
            raise ValueError("SlowNodeRule needs a dst node")
        plan.slow_node(dst, int(spec["response_delay_ms"]), windows=windows)
    elif kind == "ClockSkewRule":
        if src is None:
            raise ValueError("ClockSkewRule needs a src node")
        plan.clock_skew(src, offset_ms=int(spec.get("offset_ms", 0)),
                        rate=float(spec.get("rate", 1.0)))
    elif kind == "WireVersionRule":
        if src is None:
            raise ValueError("WireVersionRule needs a src node")
        plan.wire_version(src, int(spec["version"]), windows=windows)
    elif kind == "RestartNodeRule":
        if dst is None:
            raise ValueError("RestartNodeRule needs a dst node")
        plan.restart_node(dst, windows=windows)
    elif kind == "TornWriteRule":
        if dst is None:
            raise ValueError("TornWriteRule needs a dst node")
        plan.torn_write(dst, windows=windows,
                        drop_bytes=int(spec.get("drop_bytes", 3)),
                        corrupt=bool(spec.get("corrupt", False)))
    elif kind == "DiskStallRule":
        if dst is None:
            raise ValueError("DiskStallRule needs a dst node")
        plan.disk_stall(dst, int(spec["stall_ms"]), windows=windows)
    else:
        raise ValueError(f"unknown rule type {kind!r}")


@dataclass
class Decision:
    """What the plane does to one message."""

    drop: bool = False
    delay_ms: int = 0
    duplicates: int = 0
    reordered: bool = False
    # gray-failure extensions: slow_ms is the destination's response latency
    # (sender sees a timeout when it exceeds the message deadline, but the
    # message is still delivered); wire_version re-encodes the message
    # through the versioned codec round-trip
    slow_ms: int = 0
    wire_version: Optional[int] = None


class SkewedScheduler(Scheduler):
    """A node's drifted view of the shared clock (ClockSkewRule).

    ``now_ms`` reads ``rate * true + offset_ms``; a delay the node asks for
    in its own time costs ``delay / rate`` of true time (a fast clock fires
    its timers early). Purely arithmetic over the wrapped scheduler, so
    virtual-time determinism is untouched -- the skewed node's events still
    land at exact integer virtual times."""

    def __init__(self, inner: Scheduler, offset_ms: int = 0,
                 rate: float = 1.0) -> None:
        assert rate > 0.0, rate
        self.inner = inner
        self.offset_ms = int(offset_ms)
        self.rate = float(rate)

    def now_ms(self) -> int:
        return int(self.inner.now_ms() * self.rate) + self.offset_ms

    def _true_delay(self, delay_ms: int) -> int:
        return max(0, int(round(delay_ms / self.rate)))

    def schedule(self, delay_ms, fn):
        return self.inner.schedule(self._true_delay(delay_ms), fn)

    def schedule_at_fixed_rate(self, initial_delay_ms, period_ms, fn):
        return self.inner.schedule_at_fixed_rate(
            self._true_delay(initial_delay_ms),
            max(1, self._true_delay(period_ms)), fn,
        )

    def execute(self, fn) -> None:
        self.inner.execute(fn)

    def shutdown(self) -> None:
        pass  # the true scheduler is shared; its owner shuts it down


class Nemesis:
    """One armed instance of a plan for one run: epoch, decision streams,
    counters. Create one per cluster run; mint decorators from it.
    ``scheduler`` is the run's ``Scheduler`` (or, for a replay on the
    simulator, anything with ``now_ms()``: its virtual clock)."""

    def __init__(self, plan: FaultPlan, scheduler,
                 metrics: Optional[Metrics] = None) -> None:
        self.plan = plan
        self.scheduler = scheduler
        self.metrics = metrics if metrics is not None else global_metrics()
        self._epoch: Optional[int] = None
        # (rule index, src str, dst str) -> decisions drawn so far
        self._seq: Dict[Tuple[int, str, str], int] = {}
        self._lock = make_lock("Nemesis._lock")
        # one skewed clock per ClockSkewRule'd node, cached so every consumer
        # of a node's clock (client deadlines, FD intervals, retry backoff)
        # shares the same drifted view
        self._skewed: Dict[Endpoint, Scheduler] = {}

    # -- clock ---------------------------------------------------------------

    def arm(self, epoch_ms: Optional[int] = None) -> "Nemesis":
        """Pin plan-time zero (default: now). Windows are relative to this;
        re-arming after bootstrap starts the schedule from a healthy view."""
        self._epoch = (
            epoch_ms if epoch_ms is not None else self.scheduler.now_ms()
        )
        return self

    def plan_now_ms(self) -> int:
        if self._epoch is None:
            self.arm()
        return self.scheduler.now_ms() - self._epoch

    # -- decorators ----------------------------------------------------------

    def client(self, inner: IMessagingClient, address: Optional[Endpoint] = None,
               settings: Optional[Settings] = None) -> "NemesisClient":
        return NemesisClient(inner, self, address=address, settings=settings)

    def server(self, inner: IMessagingServer,
               address: Endpoint) -> "NemesisServer":
        return NemesisServer(inner, self, address)

    # -- decisions -----------------------------------------------------------

    def _draw(self, rule_idx: int, src: str, dst: str) -> float:
        key = (rule_idx, src, dst)
        with self._lock:
            n = self._seq.get(key, 0)
            self._seq[key] = n + 1
        return _u01(self.plan.seed, rule_idx, src, dst, n)

    def retry_rng(self, address: Optional[Endpoint]) -> random.Random:
        """Per-sender seeded rng for backoff jitter draws."""
        tag = str(address).encode() if address is not None else b"?"
        return random.Random(self.plan.seed ^ zlib.crc32(tag))

    def scheduler_for(self, address: Optional[Endpoint]) -> Scheduler:
        """The clock ``address`` lives by: the shared scheduler, or its
        drifted wrapper when a ClockSkewRule names the node. Harnesses build
        each node's timers against this seam, so one skewed node perturbs
        its own FD deadlines and retry backoff while the rest of the cluster
        keeps true time."""
        if address is None:
            return self.scheduler
        cached = self._skewed.get(address)
        if cached is not None:
            return cached
        for rule in self.plan.rules:
            if isinstance(rule, ClockSkewRule) and rule.match.src == address:
                skewed = SkewedScheduler(
                    self.scheduler, offset_ms=rule.offset_ms, rate=rule.rate
                )
                self._skewed[address] = skewed
                return skewed
        self._skewed[address] = self.scheduler
        return self.scheduler

    def decide(self, src: Optional[Endpoint], dst: Optional[Endpoint],
               msg: RapidMessage, at: str) -> Decision:
        t = self.plan_now_ms()
        out = Decision()
        src_s, dst_s = str(src), str(dst)
        for idx, rule in enumerate(self.plan.rules):
            if rule.at != at or not rule.match.matches(src, dst, msg):
                continue
            if not rule.active_at(t):
                continue
            if isinstance(rule, CellPartitionRule):
                # cross-boundary cut: drop iff exactly one end is inside
                # the partitioned cell (intra-cell traffic untouched)
                if src is not None and dst is not None:
                    in_src = _hier_cell_of(
                        src, rule.cells, topology=self.plan.topology,
                        slots=self.plan.topology_slots or None,
                    ) == rule.cell
                    in_dst = _hier_cell_of(
                        dst, rule.cells, topology=self.plan.topology,
                        slots=self.plan.topology_slots or None,
                    ) == rule.cell
                    if in_src != in_dst:
                        out.drop = True
            elif isinstance(rule, (PartitionRule, FlipFlopRule,
                                   RestartNodeRule)):
                # a down-window restart victim is, to the message plane, a
                # one-way cut; its recovery semantics live in the harness
                out.drop = True
            elif isinstance(rule, DropRule):
                if self._draw(idx, src_s, dst_s) < rule.probability:
                    out.drop = True
            elif isinstance(rule, DelayRule):
                jitter = (
                    int(self._draw(idx, src_s, dst_s) * (rule.jitter_ms + 1))
                    if rule.jitter_ms > 0 else 0
                )
                out.delay_ms += rule.base_ms + jitter
            elif isinstance(rule, DuplicateRule):
                if self._draw(idx, src_s, dst_s) < rule.probability:
                    out.duplicates += 1
            elif isinstance(rule, ReorderRule):
                if self._draw(idx, src_s, dst_s) < rule.probability:
                    held = 1 + int(
                        self._draw(idx, src_s, dst_s) * rule.max_extra_ms
                    )
                    out.delay_ms += min(held, rule.max_extra_ms)
                    out.reordered = True
            elif isinstance(rule, SlowNodeRule):
                out.slow_ms = max(out.slow_ms, rule.response_delay_ms)
            elif isinstance(rule, DiskStallRule):
                # the match restricts this to the Put wire: the stalled
                # fsync surfaces as a late quorum-write answer
                out.slow_ms = max(out.slow_ms, rule.stall_ms)
            elif isinstance(rule, WireVersionRule):
                out.wire_version = rule.version
            # ClockSkewRule is consulted via scheduler_for, not per message
        topo = self.plan.topology
        if topo is not None and at == EGRESS:
            # WAN latency structure: the topology's one-way delay applies to
            # every message whose endpoints are placed (egress only, so
            # wrapping both halves of a node never doubles the RTT)
            si = self.plan.topology_slots.get(src)
            di = self.plan.topology_slots.get(dst)
            if si is not None and di is not None:
                out.delay_ms += topo.one_way_ms(si, di)
        return out


def _pipe(src: Promise, dst: Promise) -> None:
    if dst.done():
        return
    exc = src.exception()
    if exc is not None:
        dst.try_set_exception(exc)
    else:
        dst.try_set_result(src._result)  # noqa: SLF001 -- promise-internal copy


class NemesisClient(IMessagingClient):
    """Egress fault application + uniformly hardened send_message.

    ``send_message`` re-homes the retry loop at this layer: every attempt
    traverses the fault plane once, attempts are spaced by the settings
    backoff policy, and the whole exchange is bounded by the per-message-type
    deadline (``Settings.deadline_for``) on the scheduler's clock --
    identical semantics over every wrapped transport.
    """

    def __init__(self, inner: IMessagingClient, nemesis: Nemesis,
                 address: Optional[Endpoint] = None,
                 settings: Optional[Settings] = None) -> None:
        self.inner = inner
        self.address = (
            address if address is not None else getattr(inner, "address", None)
        )
        self._nem = nemesis
        inherited = getattr(inner, "_settings", None)
        self._settings = (
            settings if settings is not None
            else inherited if inherited is not None else Settings()
        )
        # the clock this node lives by: drifted when a ClockSkewRule names
        # it, so its timeouts/backoff/deadlines all skew together
        self._sched = nemesis.scheduler_for(self.address)

    def send_message(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        return call_with_retries(
            lambda: self._attempt(remote, msg),
            self._settings.message_retries,
            scheduler=self._sched,
            policy=self._settings.retry_policy(),
            deadline_ms=self._settings.deadline_for(msg),
            rng=self._nem.retry_rng(self.address),
            metrics=self._nem.metrics,
        )

    def send_message_best_effort(self, remote: Endpoint,
                                 msg: RapidMessage) -> Promise:
        return self._attempt(remote, msg)

    def _attempt(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        d = self._nem.decide(self.address, remote, msg, EGRESS)
        metrics = self._nem.metrics
        # labeled by fault application point and message type; unlabeled
        # reads (metrics.get("nemesis_dropped")) sum across the label sets
        kind = type(msg).__name__
        if d.wire_version is not None:
            from .messaging.codec import wire_roundtrip

            metrics.incr("nemesis_wire_versioned", at="egress", msg=kind)
            msg = wire_roundtrip(msg, d.wire_version)
        if d.drop:
            metrics.incr("nemesis_dropped", at="egress", msg=kind)
            # dropped on the wire: the sender only ever sees its per-message
            # deadline expire, exactly like the in-process fabric's filters
            out: Promise = Promise()
            timeout = self._settings.timeout_for(msg)
            self._sched.schedule(
                timeout,
                lambda: out.try_set_exception(TimeoutError(
                    f"nemesis dropped {type(msg).__name__} to {remote}"
                )),
            )
            return out
        for _ in range(d.duplicates):
            metrics.incr("nemesis_duplicated", at="egress", msg=kind)
            self.inner.send_message_best_effort(remote, msg)
        if d.slow_ms > 0:
            # gray node: the message IS delivered (and answered) slow_ms
            # late; the sender's own deadline decides whether that answer
            # still counts. Past the timeout this is indistinguishable from
            # a drop at the sender -- which is the whole failure mode.
            metrics.incr("nemesis_slowed", at="egress", msg=kind)
            out = Promise()
            total = d.slow_ms + d.delay_ms
            self._nem.scheduler.schedule(
                total,
                lambda: self.inner.send_message_best_effort(
                    remote, msg
                ).add_callback(lambda p: _pipe(p, out)),
            )
            timeout = self._settings.timeout_for(msg)
            if total >= timeout:
                self._sched.schedule(
                    timeout,
                    lambda: out.try_set_exception(TimeoutError(
                        f"{remote} answered {total} ms late "
                        f"(> {timeout} ms timeout)"
                    )),
                )
            return out
        if d.delay_ms > 0:
            metrics.incr(
                "nemesis_reordered" if d.reordered else "nemesis_delayed",
                at="egress", msg=kind,
            )
            out = Promise()
            self._nem.scheduler.schedule(
                d.delay_ms,
                lambda: self.inner.send_message_best_effort(
                    remote, msg
                ).add_callback(lambda p: _pipe(p, out)),
            )
            return out
        metrics.incr("nemesis_passed", at="egress", msg=kind)
        return self.inner.send_message_best_effort(remote, msg)

    def shutdown(self) -> None:
        self.inner.shutdown()


class _NemesisServiceFilter:
    """Ingress fault application, inserted between the real server and its
    MembershipService: ``handle_message`` is the one dispatch seam every
    transport shares, so wrapping the service faults them all identically."""

    def __init__(self, service, nemesis: Nemesis, address: Endpoint) -> None:
        self._service = service
        self._nem = nemesis
        self._address = address

    def handle_message(self, msg: RapidMessage) -> Promise:
        src = getattr(msg, "sender", None)
        d = self._nem.decide(src, self._address, msg, INGRESS)
        metrics = self._nem.metrics
        kind = type(msg).__name__
        if d.drop:
            metrics.incr("nemesis_dropped", at="ingress", msg=kind)
            return Promise()  # never completes -> the sender times out
        for _ in range(d.duplicates):
            metrics.incr("nemesis_duplicated", at="ingress", msg=kind)
            self._service.handle_message(msg)
        if d.delay_ms > 0:
            metrics.incr(
                "nemesis_reordered" if d.reordered else "nemesis_delayed",
                at="ingress", msg=kind,
            )
            out: Promise = Promise()
            self._nem.scheduler.schedule(
                d.delay_ms,
                lambda: self._service.handle_message(msg).add_callback(
                    lambda p: _pipe(p, out)
                ),
            )
            return out
        metrics.incr("nemesis_passed", at="ingress", msg=kind)
        return self._service.handle_message(msg)

    def __getattr__(self, name):
        return getattr(self._service, name)


class NemesisServer(IMessagingServer):
    """Server-side decorator: passes lifecycle through and interposes the
    ingress fault filter in front of the MembershipService."""

    def __init__(self, inner: IMessagingServer, nemesis: Nemesis,
                 address: Endpoint) -> None:
        self.inner = inner
        self.address = address
        self._nem = nemesis

    def start(self) -> None:
        self.inner.start()

    def shutdown(self) -> None:
        self.inner.shutdown()

    def set_membership_service(self, service) -> None:
        self.inner.set_membership_service(
            _NemesisServiceFilter(service, self._nem, self.address)
        )


# --------------------------------------------------------------------------
# Device-plane compilation
# --------------------------------------------------------------------------


class UnsupportedDeviceFault(ValueError):
    """The rule has no device-plane analogue (see replay_on_simulator)."""


def _device_rules(plan: FaultPlan, round_ms: int) -> List[Tuple[int, Rule]]:
    """The device-compilable subset, validated.

    The device plane models the FD probe fabric: one-way ingress cuts
    (``one_way_ingress_partition``), lossy ingress (``ingress_loss``) and
    their schedules. Delays shorter than one round, duplicates and
    reorderings are absorbed by the round abstraction (a probe exchange is
    idempotent and completes within its round), so those compile to no-ops;
    anything the round model cannot absorb raises, loudly, instead of
    silently diverging from the protocol plane.
    """
    out: List[Tuple[int, Rule]] = []
    for idx, rule in enumerate(plan.rules):
        if isinstance(rule, (DuplicateRule, ReorderRule, WireVersionRule)):
            # idempotent / intra-round / byte-level: invisible to the round
            # model (the device plane never serializes wire frames)
            continue
        if isinstance(rule, (TornWriteRule, DiskStallRule)):
            # storage-level faults: the device plane models the probe
            # fabric, not stable storage
            continue
        if isinstance(rule, ClockSkewRule):
            if not 0.5 <= rule.rate <= 2.0:
                raise UnsupportedDeviceFault(
                    f"clock-skew rule {idx}: rate {rule.rate} outside "
                    "[0.5, 2.0] -- drift that extreme can flip round "
                    "outcomes, which the global-clock round model cannot "
                    "express"
                )
            continue  # bounded drift shifts timings, never round outcomes
        if isinstance(rule, DelayRule):
            if rule.base_ms + rule.jitter_ms >= round_ms:
                raise UnsupportedDeviceFault(
                    f"delay rule {idx} exceeds one device round ({round_ms} "
                    "ms); use Simulator.delay_broadcasts for round-scale "
                    "latency"
                )
            continue  # sub-round latency is absorbed by the round model
        if isinstance(rule, SlowNodeRule) and rule.response_delay_ms < round_ms:
            continue  # answers within the round: the probe still succeeds
        if rule.match.src is not None:
            raise UnsupportedDeviceFault(
                f"rule {idx}: per-source link faults have no device "
                "analogue (the probe mask is per destination)"
            )
        if rule.match.msg_types is not None and not any(
            issubclass(ProbeMessage, t) for t in rule.match.msg_types
        ):
            raise UnsupportedDeviceFault(
                f"rule {idx}: only probe-affecting faults compile to the "
                "device probe mask (dissemination loss is "
                "Simulator.drop_broadcasts)"
            )
        out.append((idx, rule))
    return out


def _boundaries(rules: List[Tuple[int, Rule]], horizon_ms: int,
                round_ms: int) -> List[int]:
    """Plan times (relative, within the horizon) where the active fault set
    can change: window edges plus flip-flop phase edges."""
    edges = {0, horizon_ms}
    for _, rule in rules:
        for start, end in rule.windows:
            if start < horizon_ms:
                edges.add(max(0, start))
            if end is not None and end < horizon_ms:
                edges.add(end)
        if isinstance(rule, FlipFlopRule):
            half = max(1, rule.period_ms // 2)
            t = rule.start_ms
            while t < horizon_ms:
                if t >= 0:
                    edges.add(t)
                t += half
    return sorted(edges)


def endpoint_slots(sim) -> Dict[Endpoint, int]:
    """Endpoint -> slot for every seated identity of a Simulator."""
    cluster = sim.cluster
    return {
        Endpoint(
            bytes(cluster.hostnames[i, : cluster.host_lengths[i]]),
            int(cluster.ports[i]),
        ): i
        for i in range(sim.config.capacity)
    }


class _SlotIndex:
    """``endpoint_slots(sim)[endpoint]`` without building an ``Endpoint``
    for every slot (at 100k slots those take most of a replay): the slots
    seated on the endpoint's port, searched in a sorted copy of the ports,
    then matched by hostname. Like the dict, a snapshot of the identities
    when made; of equal endpoints the highest slot wins; a missing one
    raises ``KeyError``."""

    def __init__(self, sim) -> None:
        cl, capacity = sim.cluster, sim.config.capacity
        self._hosts = cl.hostnames[:capacity].copy()
        self._lengths = cl.host_lengths[:capacity].copy()
        ports = cl.ports[:capacity]
        self._order = np.argsort(ports, kind="stable")
        self._ports = ports[self._order]

    def __getitem__(self, endpoint: Endpoint) -> int:
        lo = np.searchsorted(self._ports, endpoint.port, side="left")
        hi = np.searchsorted(self._ports, endpoint.port, side="right")
        host = np.frombuffer(endpoint.hostname, dtype=np.uint8)
        if lo < hi and len(host) <= self._hosts.shape[1]:
            cand = self._order[lo:hi]
            same = (self._lengths[cand] == len(host)) & (
                self._hosts[cand, : len(host)] == host).all(axis=1)
            if same.any():
                return int(cand[same].max())
        raise KeyError(endpoint)


def _slot_cell(sim, plan: FaultPlan, slot: int, cells: int) -> int:
    """Hierarchy cell of a device slot: topology zone when the plan carries
    one (slots ARE topology indices), rendezvous over the slot's seated
    endpoint otherwise -- the same precedence hierarchy/cells.py applies."""
    if plan.topology is not None:
        return plan.topology.zone_of(slot)
    host, port = sim.endpoint_of(slot)
    return _hier_cell_of(Endpoint(hostname=host, port=port), cells)


def _slot_cells(sim, plan: FaultPlan, cells: int) -> np.ndarray:
    """``_slot_cell`` of every slot at once (int64 [C]): the zones, or the
    rendezvous argmax over one batched endpoint hash a cell, the first
    highest cell on a tie as ``cells.cell_of_endpoint`` takes it."""
    capacity = sim.config.capacity
    if plan.topology is not None:
        return np.array([plan.topology.zone_of(s) for s in range(capacity)], dtype=np.int64)
    if cells <= 1:
        return np.zeros(capacity, dtype=np.int64)
    cl = sim.cluster
    scores = np.stack([endpoint_hash_batch(cl.hostnames, cl.host_lengths, cl.ports,
                                           _CELL_SEED_BASE + cell)
                       for cell in range(cells)])
    return np.argmax(scores, axis=0).astype(np.int64)


def apply_plan_at(sim, plan: FaultPlan, t_ms: int,
                  slots: Optional[Dict[Endpoint, int]] = None) -> None:
    """Set the simulator's fault arrays to the plan's state at plan-time
    ``t_ms``: partitions/flip-flops -> probe-drop targets, probabilistic
    drops -> per-destination ingress loss. ``slots``: ``endpoint_slots``
    (or any mapping from endpoint to slot), looked up in the simulator's
    identities when not given."""
    slots = slots if slots is not None else _SlotIndex(sim)
    round_ms = sim.config.fd_interval_ms // sim.config.rounds_per_interval
    sim.clear_link_faults()
    if plan.topology is not None:
        _apply_topology_delays(sim, plan.topology)
    cut: List[int] = []
    for idx, rule in _device_rules(plan, round_ms):
        if not rule.active_at(t_ms):
            continue
        if isinstance(rule, CellPartitionRule):
            # cell -> slot expansion: to the probe fabric outside the
            # boundary, every member of the isolated cell is probe-dead
            # (one-way ingress cut); the cell's internal traffic is not
            # modeled per link on the device, so the compilation captures
            # the externally visible outcome (the cell ages out of the
            # composed view)
            in_cell = _slot_cells(sim, plan, rule.cells) == rule.cell
            cut.extend(np.flatnonzero(sim.active & in_cell).tolist())
            continue
        if rule.match.dst is not None:
            targets = [slots[rule.match.dst]]
        else:
            targets = np.flatnonzero(sim.active).tolist()
        if isinstance(rule, (PartitionRule, FlipFlopRule, SlowNodeRule,
                             RestartNodeRule)):
            # a node answering slower than the probe deadline is, to every
            # observer, a node whose probes all fail: partition-equivalent
            # (a restart victim's down window reads the same way)
            cut.extend(targets)
        elif isinstance(rule, DropRule):  # incl. LossyLinkRule
            sim.ingress_loss(np.asarray(targets), rule.probability)
    if cut:
        sim.one_way_ingress_partition(np.asarray(sorted(set(cut))))


def apply_topology(sim, topology) -> None:
    """Compile a ``sim.topology.LatencyTopology`` onto a Simulator: zones
    become delivery groups, and inter-zone one-way latency >= one round
    becomes ``delay_broadcasts`` rounds (sub-round latency is absorbed by
    the round model, the same rule DelayRule compilation follows).
    Requires ``sim.config.groups >= zones`` and ``max_delivery_delay`` large
    enough for the widest tier."""
    groups = topology.group_assignment(sim.config.capacity)
    n_zones = int(groups.max()) + 1
    if sim.config.groups < n_zones:
        raise UnsupportedDeviceFault(
            f"topology has {n_zones} zones but sim.config.groups="
            f"{sim.config.groups}"
        )
    sim.set_delivery_groups(groups)
    _apply_topology_delays(sim, topology)


def _apply_topology_delays(sim, topology) -> None:
    """Re-arm the inter-zone broadcast delays (clear_link_faults wipes the
    delay arrays, so apply_plan_at re-applies these each schedule segment)."""
    round_ms = sim.config.fd_interval_ms // sim.config.rounds_per_interval
    groups = topology.group_assignment(sim.config.capacity)
    n_zones = int(groups.max()) + 1
    slots = np.arange(sim.config.capacity)
    for receiver in range(n_zones):
        for sender in range(n_zones):
            if receiver == sender:
                continue
            rounds = topology.delay_rounds(sender, receiver, round_ms)
            if rounds > 0:
                sim.delay_broadcasts(receiver, slots[groups == sender], rounds)


def replay_on_simulator(sim, plan: FaultPlan, duration_ms: int,
                        decision_batch: int = 8) -> list:
    """Replay ``plan`` on the device plane for ``duration_ms`` of protocol
    time (plan-time zero = the simulator's current ``virtual_ms``), driving
    the fault arrays through every schedule boundary. Returns the
    ViewChangeRecords decided within the horizon."""
    slots = _SlotIndex(sim)
    round_ms = sim.config.fd_interval_ms // sim.config.rounds_per_interval
    rules = _device_rules(plan, round_ms)
    if plan.topology is not None:
        apply_topology(sim, plan.topology)
    epoch = sim.virtual_ms
    prior_changes = len(sim.view_changes)
    times = _boundaries(rules, duration_ms, round_ms)
    for seg_start, seg_end in zip(times, times[1:]):
        apply_plan_at(sim, plan, seg_start, slots)
        target = epoch + seg_end
        while sim.virtual_ms < target:
            remaining = math.ceil((target - sim.virtual_ms) / round_ms)
            rec = sim.run_until_decision(
                max_rounds=remaining, batch=min(decision_batch, remaining)
            )
            if rec is None:
                break  # budget burned with no decision; next segment
    return sim.view_changes[prior_changes:]
