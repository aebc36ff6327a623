"""TpuSimMessaging: real protocol-plane members against a swarm on the port.

The port of ``rapid_tpu/sim/bridge.py``. An untouched
``Cluster``/``MembershipService`` stack runs against a swarm of N *virtual*
members whose rings, failure detection, cut detection and fast-round vote
tallies live as tensors in the port's ``Simulator`` (on a CUDA device, or on
a ``shard.engine.Mesh``). The bridge crosses exactly the two seams the
reference defines -- messaging (IMessagingClient/Server,
IMessagingClient.java:25-48) and edge failure detection -- and nothing else:
real members join through the standard two-phase protocol
(Cluster.java:303-474), probe their virtual subjects, broadcast alerts, vote
in the fast round, and apply view changes through their own consensus path.

How each protocol interaction crosses the bridge:

- **Join** (real member -> swarm): phase 1 seats the joiner's identity in a
  spare virtual slot (so ring order and configuration identity include it
  bit-exactly); phase 2 parks the per-observer responses and registers the
  join with the simulator; when the simulated cut decides, the parked
  responses complete with the full configuration (MembershipService.java:229-286).
- **Probes** (real member -> virtual subject): answered from the simulator's
  host liveness mirrors; a crashed virtual member fails the probe promise.
- **Alerts** (real member -> all): DOWN alerts about virtual members are
  injected into the simulated report tables (``Simulator.inject_down_report``).
- **Votes** (real member -> swarm): a real member's slot does not auto-vote.
  When a proposal is announced but undecided, the bridge broadcasts the
  proposed cut to real members *before* the decision (``pump`` phase B);
  the FastRoundPhase2bMessages they send back are registered into the device
  tally (``Simulator.register_extern_vote``), so a real member can complete a
  quorum the virtual members alone cannot reach, or block it.
- **Decisions** (swarm -> real members): every real member of the
  pre-decision configuration receives one batched alert carrying the
  joiners' identities and one batch of fast-round votes from live virtual
  members; its own FastPaxos then reaches the 3/4 supermajority and applies
  the view change itself.
- **Leave** (real member -> observers): the simulator's proactive leave,
  deciding in ~2 rounds (alert hop + vote hop).
- **Real-member liveness**: a real member is alive while its server listens
  on the network; when it disappears, its slot dies and the simulated
  failure detectors remove it.

**The protocol seam.** The bridge builds and dispatches on the protocol
plane's message classes, and members in the same process dispatch on theirs,
so copies would not interoperate. A ``Protocol`` names the classes and the
``Promise`` the bridge uses; every ``isinstance``, every message it builds
and every promise it returns goes through it. ``default_protocol()`` is the
port's own copy (``rapid_tpu_torch.types``, ``runtime.futures``); a caller
whose members run on ``rapid_tpu`` passes
``Protocol.from_modules(rapid_tpu.types, rapid_tpu.runtime.futures.Promise)``.

The bridge reads only host mirrors of the simulator (``active``, ``alive``,
the fault plane, ``last_announcement``): the device syncs of a pump are the
driver's own audited fetches.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import pickle
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as _types
from ..hashing import address_comparator_key
from ..runtime.futures import Promise as _Promise
from ..shard.engine import require_single_process
from . import classic
from .driver import Simulator, ViewChangeRecord
from .engine import SimConfig
from .topology import ring_order

LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class Protocol:
    """The protocol plane the bridge speaks: its message classes, by their
    ``rapid_tpu.types`` names, and its ``Promise``."""

    EdgeStatus: type
    JoinStatusCode: type
    Endpoint: type
    NodeId: type
    PreJoinMessage: type
    JoinMessage: type
    JoinResponse: type
    AlertMessage: type
    BatchedAlertMessage: type
    ProbeMessage: type
    ProbeResponse: type
    FastRoundPhase2bMessage: type
    Phase1aMessage: type
    Phase1bMessage: type
    Phase2aMessage: type
    Phase2bMessage: type
    LeaveMessage: type
    Response: type
    ConsensusResponse: type
    FastRoundVoteBatch: type
    Promise: type

    @classmethod
    def from_modules(cls, types, promise: type) -> "Protocol":
        """The classes of a types module (anything with the names above as
        attributes) and a promise class."""
        names = [f.name for f in dataclasses.fields(cls) if f.name != "Promise"]
        return cls(Promise=promise, **{name: getattr(types, name) for name in names})

    @property
    def consensus_types(self) -> tuple:
        return (self.FastRoundPhase2bMessage, self.Phase1aMessage, self.Phase1bMessage,
                self.Phase2aMessage, self.Phase2bMessage)


def default_protocol() -> Protocol:
    """The port's own copy of the protocol classes."""
    return Protocol.from_modules(_types, _Promise)


# the Endpoint class of either package, as a snapshot blob names it
_BLOB_ENDPOINTS = {("rapid_tpu.types", "Endpoint"), ("rapid_tpu_torch.types", "Endpoint")}
_BLOB_BUILTINS = frozenset(
    {"bool", "bytes", "dict", "frozenset", "int", "list", "set", "str", "tuple"})


class _BlobUnpickler(pickle.Unpickler):
    """Reads a bridge snapshot's blob (``{"metadata": {Endpoint: tuple}}``)
    written by either package's bridge: the Endpoint class of either maps to
    ``endpoint``, builtin containers are allowed, and every other class is
    refused, so reading a blob imports nothing and runs no other code."""

    def __init__(self, data: bytes, endpoint: type) -> None:
        super().__init__(io.BytesIO(data))
        self._endpoint = endpoint

    def find_class(self, module: str, name: str):
        if (module, name) in _BLOB_ENDPOINTS:
            return self._endpoint
        if module == "builtins" and name in _BLOB_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"bridge snapshot names {module}.{name}; only Endpoint and builtin "
            "containers may appear")


def load_blob(data: bytes, endpoint: type) -> dict:
    """A snapshot blob read with ``_BlobUnpickler``."""
    return _BlobUnpickler(data, endpoint).load()


class TpuSimMessaging:  # guarded-by: sim-loop
    """A multi-endpoint handler on an in-process network hosting N virtual
    members in the port's simulator. The network must offer
    ``attach_handler``, ``deliver(src, dst, msg, timeout_ms)`` (returning a
    promise), ``is_listening`` and a ``scheduler`` (``run_for`` when it runs
    on a virtual clock)."""

    _MAX_REPLAYS = 3
    _STALE_STRIKES_TO_CUT = 3  # repeated sightings of one stale config

    def __init__(
        self,
        network,
        n_virtual: int,
        capacity: Optional[int] = None,
        config: Optional[SimConfig] = None,
        seed: int = 0,
        mesh=None,
        protocol: Optional[Protocol] = None,
        device=None,
    ) -> None:
        """JAX's parameters in JAX's order, then ``protocol`` and ``device``.

        ``mesh``: a ``shard.engine.Mesh`` to host the swarm row-sharded over
        several devices (or several shards of one); the capacity is rounded
        up to divide over its shards. ``protocol``: the classes to speak
        (``Protocol``); by default the port's own. ``device``: as for
        ``Simulator``: CUDA unless the caller names another, and raises
        without a card."""
        require_single_process(mesh, "the bridge")
        if capacity is None:
            capacity = config.capacity if config is not None else n_virtual + 16
        if mesh is not None:
            # row-sharded state must divide evenly over the mesh's shards
            capacity = -(-capacity // mesh.size) * mesh.size
        if config is None:
            config = SimConfig(capacity=capacity)
        elif config.capacity != capacity:
            config = dataclasses.replace(config, capacity=capacity)
        if config.extern_proposals == 0:
            # extern rows so real members' votes can be interned as proposal
            # values (register_extern_vote); 4 covers the common regimes --
            # real members agreeing with the swarm pool into one row
            config = dataclasses.replace(config, extern_proposals=4)
        self.protocol = protocol if protocol is not None else default_protocol()
        self.sim = Simulator(
            n_virtual, capacity=capacity, config=config, seed=seed, mesh=mesh,
            device=device,
        )
        self.network = network
        network.attach_handler(self)
        self._init_caches()
        self._slot_of: Dict[object, int] = {}
        for slot in range(n_virtual):
            self._slot_of[self._endpoint(slot)] = slot
        self._free_slots: Deque[int] = deque(range(n_virtual, capacity))
        self._real: Dict[object, int] = {}
        # joiner endpoint -> [(observer endpoint, parked promise)]
        self._parked: Dict[object, List[Tuple[object, object]]] = {}
        self._metadata: Dict[object, tuple] = {}
        self._init_decision_state()

    def _init_decision_state(self) -> None:
        """Per-decision bookkeeping (shared by __init__ and restore)."""
        # configuration id whose announced proposal was already broadcast to
        # real members (pump phase B runs once per configuration)
        self._informed_config: Optional[int] = None
        # last decision packet, for catching up members whose delivery was
        # lost (they reveal themselves by sending traffic stamped with the
        # pre-decision configuration id); _replay_counts bounds replays per
        # member per decision; _prior_configs identifies members stale beyond
        # what a replay can fix (they get cut, like any faulty member)
        self._last_decision: Optional[tuple] = None
        self._replay_counts: Dict[object, int] = {}
        self._prior_configs: Deque[int] = deque(maxlen=8)
        # stale-cut tolerance: repeated sightings of one stale config before
        # a member is declared beyond repair (a single occurrence can be an
        # in-flight frame racing a pair of quick decisions)
        self._stale_counts: Dict[Tuple[object, int], int] = {}

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        """Persist the swarm configuration plus the real-member plane (which
        slots external processes own, and their metadata), under the JAX
        bridge's keys (``extra_real_slots``, ``extra_bridge_blob``), so either
        package's bridge restores it. The blob names the protocol's Endpoint
        class: one written with ``rapid_tpu``'s classes restores in the JAX
        bridge. Parked join responses are not persisted: a restarted gateway
        makes in-flight joiners retry (Cluster.java:313-344)."""
        real_slots = np.array(sorted(self._real.values()), dtype=np.int64)
        blob = pickle.dumps({"metadata": dict(self._metadata)})
        self.sim.save_configuration(
            path,
            extra={
                "real_slots": real_slots,
                "bridge_blob": np.frombuffer(blob, dtype=np.uint8),
            },
        )

    @classmethod
    def restore(
        cls,
        network,
        path: str,
        config_overrides: Optional[dict] = None,
        mesh=None,
        protocol: Optional[Protocol] = None,
        device=None,
    ) -> "TpuSimMessaging":
        """Rebuild a bridge swarm from a snapshot of either package's bridge:
        same configuration id, same real-member slot ownership, the metadata
        keyed by this protocol's Endpoint. Live real members keep their
        seats; dead ones are detected and cut by the restored simulated FDs.

        SimConfig fields the snapshot does not persist reset to defaults;
        pass ``config_overrides`` to re-apply them. extern_proposals defaults
        to 4 (the bridge needs extern rows for real members' votes)."""
        require_single_process(mesh, "the bridge")
        overrides = {"extern_proposals": 4}
        overrides.update(config_overrides or {})
        sim = Simulator.from_configuration(
            path, mesh=mesh, config_overrides=overrides, device=device,
        )
        bridge = cls.__new__(cls)
        bridge.protocol = protocol if protocol is not None else default_protocol()
        with np.load(path) as data:
            real_slots = [int(s) for s in data["extra_real_slots"]]
            blob = load_blob(data["extra_bridge_blob"].tobytes(), bridge.protocol.Endpoint)

        bridge.sim = sim
        bridge.network = network
        network.attach_handler(bridge)
        bridge._init_caches()
        capacity = sim.config.capacity
        # map ONLY currently-seated endpoints: active slots plus real
        # members' seats. Mapping every capacity slot would resurrect stale
        # endpoint->slot entries for previously-cut members and never-seated
        # spares (a rejoining agent would be found "already seated" while
        # its slot sat in the free list)
        real_set = set(real_slots)
        bridge._slot_of = {}
        for slot in range(capacity):
            if sim.active[slot] or slot in real_set:
                bridge._slot_of[bridge._endpoint(slot)] = slot
        bridge._real = {bridge._endpoint(slot): slot for slot in real_slots}
        for slot in real_slots:
            sim.set_auto_vote(slot, False)
        bridge._free_slots = deque(
            s for s in range(capacity) if not sim.active[s] and s not in real_set
        )
        bridge._parked = {}
        bridge._metadata = dict(blob["metadata"])
        bridge._init_decision_state()
        return bridge

    # ------------------------------------------------------------------ #
    # identity helpers
    # ------------------------------------------------------------------ #

    def _init_caches(self) -> None:
        """Identity/configuration caches (shared by __init__ and restore).

        At 100k virtual members a join otherwise rebuilds ~1M Endpoint
        objects (K observers each stream the full configuration,
        Cluster.java:442-474). Slot endpoints are immutable between identity
        re-seatings, and the configuration content is immutable within a
        configuration id, so both cache exactly."""
        self._ep_cache: Dict[int, object] = {}
        # (config id, endpoints, identifiers, metadata) of the full JoinResponse
        self._config_content: Optional[Tuple[int, tuple, tuple, tuple]] = None
        self._config_responses: Dict[object, object] = {}
        # joiners already streamed the full configuration this join attempt
        # (sender -> configuration id): the sibling phase-2 responses of the
        # SAME attempt answer CONFIG_CHANGED instead of re-streaming it K
        # times; a fresh PreJoin clears the mark, so a lost full-config
        # response heals via retry
        self._streamed: Dict[object, int] = {}
        # the decision's two messages, built ONCE: (config id, alert batch,
        # vote batch, src endpoint, post-decision config id)
        self._decision_packet: Optional[tuple] = None
        # pre-decision config id -> packet, newest last: lets a lagging
        # member be walked FORWARD packet by packet
        self._packet_history: "OrderedDict[int, tuple]" = OrderedDict()
        # members whose decision chain failed (member -> missed config id):
        # the pump re-drives these. Mutated from delivery-callback threads,
        # which touch host dicts and sets only, never the device.
        self._undelivered: Dict[object, int] = {}
        self._chain_inflight: set = set()
        self._undelivered_lock = threading.Lock()

    def _endpoint(self, slot: int):
        ep = self._ep_cache.get(slot)
        if ep is None:
            host, port = self.sim.endpoint_of(slot)
            ep = self._ep_cache[slot] = self.protocol.Endpoint(host, port)
        return ep

    def _node_id(self, slot: int):
        return self.protocol.NodeId(
            int(self.sim.cluster.id_high[slot]), int(self.sim.cluster.id_low[slot])
        )

    def _failed(self, exc: BaseException):
        p = self.protocol.Promise()
        p.set_exception(exc)
        return p

    def endpoint(self, slot: int):
        """A virtual member's address (e.g. a join seed for real members)."""
        return self._endpoint(slot)

    def virtual_members(self) -> list:
        return [
            self._endpoint(s)
            for s in self.sim.members()
            if self._endpoint(s) not in self._real
        ]

    # ------------------------------------------------------------------ #
    # network handler interface
    # ------------------------------------------------------------------ #

    def owns(self, address) -> bool:
        return address in self._slot_of and address not in self._real

    def handle(self, dst, msg):
        broadcastable = self._handle_broadcastable(msg)
        if broadcastable is not None:
            return broadcastable
        P = self.protocol
        slot = self._slot_of[dst]
        if isinstance(msg, P.ProbeMessage):
            if self.sim.active[slot] and self.sim.alive[slot]:
                return P.Promise.completed(P.ProbeResponse())
            return self._failed(ConnectionError(f"virtual node {dst} is down"))
        if isinstance(msg, P.PreJoinMessage):
            return P.Promise.completed(self._handle_pre_join(dst, msg))
        if isinstance(msg, P.JoinMessage):
            return self._handle_join(dst, msg)
        return self._failed(TypeError(f"unexpected message {type(msg).__name__}"))

    def handle_broadcast(self, msg):
        """A real member's broadcast collapsed to one frame (a gateway's
        wildcard destination): ingest the destination-independent traffic
        exactly once. Alert batches and votes are absorbed per *sender*, so
        the N unicast copies were redundant. Unicast-only messages (probes,
        joins) are refused."""
        broadcastable = self._handle_broadcastable(msg)
        if broadcastable is not None:
            return broadcastable
        return self._failed(TypeError(f"{type(msg).__name__} cannot be swarm-broadcast"))

    def _handle_broadcastable(self, msg):
        """The destination-independent message types (None = not one)."""
        P = self.protocol
        if isinstance(msg, P.BatchedAlertMessage):
            if msg.messages:
                self._maybe_catch_up(msg.sender, msg.messages[0].configuration_id)
            self._absorb_alerts(msg)
            return P.Promise.completed(P.Response())
        if isinstance(msg, P.FastRoundPhase2bMessage):
            self._maybe_catch_up(msg.sender, msg.configuration_id)
            self._register_real_vote(msg)
            return P.Promise.completed(P.ConsensusResponse())
        if isinstance(msg, P.consensus_types):
            # classic-round traffic from real members is acknowledged; the
            # swarm's recovery exchange (Simulator._run_classic_round over
            # sim/classic.py's device acceptor state) represents their slots
            # as acceptors, with their registered fast votes as vvals
            return P.Promise.completed(P.ConsensusResponse())
        if isinstance(msg, P.LeaveMessage):
            sender_slot = self._slot_of.get(msg.sender)
            if (
                sender_slot is not None
                and self.sim.active[sender_slot]
                and self.sim.alive[sender_slot]
                and sender_slot not in self.sim.pending_leavers
            ):
                self.sim.leave(np.array([sender_slot]))
            return P.Promise.completed(P.Response())
        return None

    def warm_compile(self) -> None:
        """Do, before members arrive, the first-time work the steady-state
        pump would otherwise pay mid-join-wave: on a card, the load of the
        hand kernels' libraries and of the CUDA modules of every op, and the
        caching allocator's first blocks; elsewhere little. Covers the no-op
        probe variants (plain + announcement-stop) on the swarm itself, as
        the JAX bridge does; the full decision path (view change, ring
        rebuild) of both dispatch branches -- the closed form and the scan,
        whose FD phase is the hand kernel -- and the classic-fallback
        phases run on a throwaway twin simulator, which holds a second full
        state while it lives; the swarm's protocol state (membership,
        configuration id) is untouched."""
        sim = self.sim
        sim.run_until_decision(max_rounds=1, batch=1)
        sim.run_until_decision(max_rounds=1, batch=1, stop_when_announced=True)
        spare = Simulator(
            sim.config.capacity, config=sim.config, seed=104729, mesh=sim.mesh,
            device=sim.device,
        )
        spare.crash(np.array([0]))
        rec = spare.run_until_decision(max_rounds=32, batch=8)
        assert rec is not None, "warm twin failed to decide"
        # the scan branch: random loss, whose FD phase is the hand kernel
        spare.ingress_loss(np.array([1]), 1.0)
        rec = spare.run_until_decision(max_rounds=32, batch=8)
        assert rec is not None, "warm twin failed to decide under loss"
        deliver = spare._deliver  # noqa: SLF001
        group_of = spare.group_of
        hears = spare._tensor(deliver[group_of, 0])  # noqa: SLF001
        coord_hears = spare._tensor(deliver[group_of[0], :])  # noqa: SLF001
        resp = torch.full((sim.config.capacity,), 2, dtype=torch.int32, device=spare.device)
        rank = classic.make_rank(2, 0)
        state1, _ = classic.phase1(spare.config, spare.state, rank, hears, coord_hears, resp)
        classic.phase2(spare.config, state1, rank, 0, hears, coord_hears, resp)
        spare.ready()
        sim.ready()

    # ------------------------------------------------------------------ #
    # join protocol (swarm side)
    # ------------------------------------------------------------------ #

    def _handle_pre_join(self, dst, msg):
        """Phase-1 gatekeeping at a virtual seed (MembershipService.java:200-221)."""
        P = self.protocol
        # a new attempt begins: its phase 2 may stream the full config once
        self._streamed.pop(msg.sender, None)
        slot = self._slot_of.get(msg.sender)
        if slot is not None and self.sim.active[slot]:
            status = P.JoinStatusCode.HOSTNAME_ALREADY_IN_RING
        elif self.sim.is_identifier_seen(msg.node_id.high, msg.node_id.low):
            return P.JoinResponse(
                sender=dst,
                status_code=P.JoinStatusCode.UUID_ALREADY_IN_RING,
                configuration_id=self.sim.configuration_id(),
            )
        else:
            status = P.JoinStatusCode.SAFE_TO_JOIN
            if slot is None:
                if not self._free_slots:
                    return P.JoinResponse(
                        sender=dst,
                        status_code=P.JoinStatusCode.MEMBERSHIP_REJECTED,
                        configuration_id=self.sim.configuration_id(),
                    )
                slot = self._free_slots.popleft()
                self._slot_of[msg.sender] = slot
                self._real[msg.sender] = slot
            # a retry -- or a rejoin after removal -- re-seats the same slot
            # with the fresh UUID; the identifier history is value-based, so
            # the slot's past identities stay in the configuration-id fold.
            # While a phase-2 join is pending the identity is already seated.
            if slot not in self.sim.pending_joiners:
                self._ep_cache.pop(slot, None)  # slot re-seated: new identity
                self.sim.assign_identity(
                    slot,
                    msg.sender.hostname,
                    msg.sender.port,
                    msg.node_id.high,
                    msg.node_id.low,
                )
                # the engine must not cast votes for a real member's slot:
                # only its actually-received votes count (_register_real_vote)
                self.sim.set_auto_vote(slot, False)
        # expected observers = ring predecessors, for present members too
        # (MembershipView.java:293-304)
        observer_slots, _ = self.sim.expected_observers(slot)
        return P.JoinResponse(
            sender=dst,
            status_code=status,
            configuration_id=self.sim.configuration_id(),
            endpoints=tuple(self._endpoint(int(s)) for s in observer_slots),
        )

    def _config_changed(self, sender, configuration_id: int):
        return self.protocol.Promise.completed(
            self.protocol.JoinResponse(
                sender=sender,
                status_code=self.protocol.JoinStatusCode.CONFIG_CHANGED,
                configuration_id=configuration_id,
            )
        )

    def _handle_join(self, dst, msg):
        """Phase-2 at a virtual observer: park until the simulated view change
        commits (MembershipService.java:229-286)."""
        slot = self._slot_of.get(msg.sender)
        current = self.sim.configuration_id()
        if slot is None:
            return self._config_changed(dst, current)
        if msg.configuration_id != current:
            if self.sim.active[slot] and self._streamed.get(msg.sender) != current:
                # the cut already admitted this joiner: stream the config to
                # the FIRST of this attempt's K observer messages only;
                # siblings answer CONFIG_CHANGED, which the join client
                # ignores when a valid response exists
                self._streamed[msg.sender] = current
                return self.protocol.Promise.completed(self._full_config_response(dst))
            return self._config_changed(dst, current)
        parked = self.protocol.Promise()
        self._parked.setdefault(msg.sender, []).append((dst, parked))
        if msg.metadata:
            self._metadata[msg.sender] = msg.metadata
        if slot not in self.sim.pending_joiners:
            self.sim.request_joins(np.array([slot]))
        return parked

    def _full_config_response(self, sender):
        """The SAFE_TO_JOIN response streaming the full configuration. The
        content (endpoints in ring-0 order, identifier history, metadata) is
        a pure function of the configuration id and every observer streams
        the same one (Cluster.java:442-474), so it is built once per
        configuration; only the per-observer ``sender`` field varies."""
        P = self.protocol
        sim = self.sim
        config_id = sim.configuration_id()
        cached = self._config_content
        if cached is None or cached[0] != config_id:
            order0 = ring_order(sim.cluster, sim.active, 0)
            endpoints = tuple(self._endpoint(int(s)) for s in order0)
            # Python ints first: iterating the [M, 2] array row by row made
            # NodeIds at ~8 us each, the bulk of a 100k join's host time
            identifiers = tuple(
                P.NodeId(h, l) for h, l in sim.sorted_identifiers().tolist()
            )
            metadata = tuple(
                (ep, md)
                for ep, md in self._metadata.items()
                if sim.active[self._slot_of[ep]]
            )
            cached = self._config_content = (config_id, endpoints, identifiers, metadata)
            self._config_responses = {}
        # one response OBJECT per (configuration, sender), so a codec that
        # memoizes by identity encodes it once per configuration
        response = self._config_responses.get(sender)
        if response is None:
            response = P.JoinResponse(
                sender=sender,
                status_code=P.JoinStatusCode.SAFE_TO_JOIN,
                configuration_id=config_id,
                endpoints=cached[1],
                identifiers=cached[2],
                metadata=cached[3],
            )
            self._config_responses[sender] = response
        return response

    # ------------------------------------------------------------------ #
    # votes from real members
    # ------------------------------------------------------------------ #

    def _register_real_vote(self, msg) -> None:
        """Count a real member's fast-round vote in the device tally. The
        message's endpoint list is its proposed cut; unknown endpoints (not
        hosted by this swarm) make the value unrepresentable and the vote is
        dropped, like any best-effort loss."""
        sender_slot = self._slot_of.get(msg.sender)
        if (
            sender_slot is None
            or msg.sender not in self._real
            or not self.sim.active[sender_slot]
            or msg.configuration_id != self.sim.configuration_id()
        ):
            return
        cut_slots = [self._slot_of[ep] for ep in msg.endpoints if ep in self._slot_of]
        if len(cut_slots) != len(msg.endpoints):
            LOG.warning("vote from %s names endpoints outside the swarm; dropped", msg.sender)
            return
        self.sim.register_extern_vote(sender_slot, np.array(cut_slots))

    def _maybe_catch_up(self, sender, config_id: int) -> None:
        """Keep lagging members from being stranded. A member stuck exactly
        one decision behind (its delivery was lost) gets the decision packet
        replayed -- up to _MAX_REPLAYS times per decision; the replay is
        idempotent on the member's side (FastPaxos.java:134-141). A member
        stale beyond the last decision cannot be repaired by votes, so it is
        cut like any faulty member, for rejoin."""
        if self._last_decision is None or sender not in self._real:
            return
        if config_id in self._packet_history:
            count = self._replay_counts.get(sender, 0)
            if count >= self._MAX_REPLAYS:
                return
            self._replay_counts[sender] = count + 1
            LOG.info(
                "replaying decision %d to lagging member %s (attempt %d)",
                config_id, sender, count + 1,
            )
            self._deliver_decision_chain(sender, self._packet_history[config_id])
        elif config_id in self._prior_configs:
            # a single old-config frame can be an in-flight race against two
            # quick decisions; only REPEATED sightings of the same stale
            # configuration mean the member is truly stranded
            strikes = self._stale_counts.get((sender, config_id), 0) + 1
            self._stale_counts[(sender, config_id)] = strikes
            if strikes < self._STALE_STRIKES_TO_CUT:
                return
            slot = self._real[sender]
            if self.sim.active[slot] and self.sim.alive[slot]:
                LOG.warning(
                    "member %s is stale beyond the last decision; cutting it "
                    "(rejoin required)",
                    sender,
                )
                self.sim.crash(np.array([slot]))

    def _deliver_decision_chain(self, member, packet: Optional[tuple] = None) -> None:
        """Deliver one decision to one member: the identity-carrying alert
        batch first, the quorum-completing vote batch ONLY after the alerts
        succeed (votes without the joiners' identities would hit
        MembershipService.java:396's disabled assert).

        On success, if newer decisions committed meanwhile, the member is
        walked FORWARD through the packet history one decision at a time
        (FastPaxos is per-configuration). On failure the member is recorded
        in ``_undelivered`` and the pump re-drives the chain. The callbacks
        run on delivery threads and touch host dicts and sets only."""
        if packet is None:
            packet = self._decision_packet
        if packet is None:
            return
        config_id, alert_msg, votes_msg, src, after_id = packet
        with self._undelivered_lock:
            if member in self._chain_inflight:
                # a chain for an earlier decision is still in flight; its
                # settle() walks forward from the then-current history, so
                # this newer decision is NOT lost
                return
            self._chain_inflight.add(member)

        def settle(ok: bool) -> None:
            with self._undelivered_lock:
                self._chain_inflight.discard(member)
                if ok:
                    self._undelivered.pop(member, None)
                else:
                    self._undelivered[member] = config_id
            if not ok:
                return
            nxt = self._packet_history.get(after_id)
            if nxt is not None:
                # the member now sits at after_id and the decision taken
                # FROM there is in history: keep walking
                self._deliver_decision_chain(member, nxt)

        def after_votes(p) -> None:
            settle(p.exception() is None)

        def after_alerts(p) -> None:
            if p.exception() is None:
                self._deliver(src, member, votes_msg).add_callback(after_votes)
            else:
                LOG.warning(
                    "alert delivery to %s failed (%s); withholding votes -- "
                    "the pump will re-drive the chain",
                    member, p.exception(),
                )
                settle(False)

        self._deliver(src, member, alert_msg).add_callback(after_alerts)

    def _reconcile_lagging(self) -> None:
        """Active repair of members whose decision chain failed (runs at the
        top of every pump): re-drive the missed packet from history. Only a
        member whose needed packet has aged OUT of the history (>= 8
        decisions behind) is cut for rejoin."""
        if self._decision_packet is None:
            return
        with self._undelivered_lock:
            lagging = dict(self._undelivered)
        for member, missed in lagging.items():
            slot = self._real.get(member)
            if slot is None or not self.sim.active[slot]:
                with self._undelivered_lock:
                    self._undelivered.pop(member, None)
                continue
            packet = self._packet_history.get(missed)
            if packet is not None:
                self._deliver_decision_chain(member, packet)
            else:
                LOG.warning(
                    "member %s missed decision %d and its packet has aged "
                    "out of the replay history; cutting it (rejoin required)",
                    member, missed,
                )
                with self._undelivered_lock:
                    self._undelivered.pop(member, None)
                if self.sim.alive[slot]:
                    self.sim.crash(np.array([slot]))

    # ------------------------------------------------------------------ #
    # alerts from real members
    # ------------------------------------------------------------------ #

    def _absorb_alerts(self, batch) -> None:
        """A real member's broadcast: DOWN evidence joins the simulated report
        tables; UP metadata is stashed for the joiner's admission."""
        status = self.protocol.EdgeStatus
        current = self.sim.configuration_id()
        for alert in batch.messages:
            if alert.configuration_id != current:
                continue
            slot = self._slot_of.get(alert.edge_dst)
            if slot is None:
                continue
            if alert.edge_status == status.DOWN and self.sim.active[slot]:
                self.sim.inject_down_report(slot, alert.ring_numbers)
            elif alert.edge_status == status.UP and alert.metadata:
                self._metadata[alert.edge_dst] = alert.metadata

    # ------------------------------------------------------------------ #
    # the pump: device rounds + decision delivery
    # ------------------------------------------------------------------ #

    def _alerts(self, src, cut_eps, config_id: int, rings: tuple, joining) -> tuple:
        """One alert a cut endpoint, UP with its identity for a joiner
        (``joining(slot)``), DOWN otherwise."""
        P = self.protocol
        alerts = []
        for ep in cut_eps:
            slot = self._slot_of[ep]
            up = joining(slot)
            alerts.append(P.AlertMessage(
                edge_src=src,
                edge_dst=ep,
                edge_status=P.EdgeStatus.UP if up else P.EdgeStatus.DOWN,
                configuration_id=config_id,
                ring_numbers=rings,
                node_id=self._node_id(slot) if up else None,
                metadata=self._metadata.get(ep, ()),
            ))
        return tuple(alerts)

    def pump(
        self, max_rounds: int = 32, batch: int = 8,
        classic_fallback_after_rounds: Optional[int] = 8,
    ) -> Optional[ViewChangeRecord]:
        """Sense real-member liveness, run simulated rounds until a decision,
        then make that decision real: alerts + votes to every real member of
        the pre-decision configuration, full configurations to admitted
        joiners.

        When live real members exist, the run pauses at the first proposal
        announcement of each configuration (phase A): the proposed cut is
        broadcast to the real members *before* the decision, the virtual
        clock advances so their FastRoundPhase2bMessages flow back into the
        device tally (phase B), and only then does the fast round resume."""
        P = self.protocol
        self._sense_real_liveness()
        self._reconcile_lagging()
        sim = self.sim
        if self._quiescent():
            # nothing can decide: skip the device dispatches entirely. A
            # member death re-arms real work for the next pump.
            return None
        config_before = sim.configuration_id()
        n_before = sim.membership_size
        members_before = [
            ep
            for ep, slot in self._real.items()
            if sim.active[slot] and self.network.is_listening(ep)
        ]
        # fast-round votes are cast by the pre-decision configuration's live
        # members; the cut-set members that are *leaving* voted too
        voters = [
            ep
            for ep in (self._endpoint(int(s)) for s in np.flatnonzero(sim.active & sim.alive))
            if ep not in self._real
        ]
        rec = None
        rounds_before = sim.metrics.get("rounds")
        if members_before and self._informed_config != config_before:
            # phase A: run only to the announcement, so real members can
            # vote. The closed form and the mesh runner pause at the
            # announcement round in ONE dispatch; batch=1 covers the scan
            # path, where the announcement must be observed the round it
            # happens (a wider batch could run announcement and decision
            # inside one dispatch and skip the pre-decision broadcast)
            rec = sim.run_until_decision(
                max_rounds=max_rounds, batch=1,
                classic_fallback_after_rounds=classic_fallback_after_rounds,
                stop_when_announced=True,
            )
            announced = sim.last_announcement
            if (
                rec is None
                and announced is not None
                and announced[0][: sim.config.groups].any()
                and voters
            ):
                # phase B: pre-decision broadcast of the proposed cut; the
                # clock advance lets the real members process it and send
                # their votes back to the swarm
                self._informed_config = config_before
                self._broadcast_announced_proposal(config_before, members_before, voters[0])
                self._advance_clock(100)
        # phases A and resume share one round budget per pump call
        remaining = max_rounds - (sim.metrics.get("rounds") - rounds_before)
        if rec is None and remaining > 0:
            rec = sim.run_until_decision(
                max_rounds=remaining, batch=batch,
                classic_fallback_after_rounds=classic_fallback_after_rounds,
            )
        if rec is None:
            return None
        cut_eps = sorted((self._endpoint(int(s)) for s in rec.cut), key=address_comparator_key)
        added = {int(s) for s in rec.added}
        if members_before and not voters:
            LOG.warning("no live virtual voters; real members cannot learn this decision")
        if members_before and voters:
            alerts = self._alerts(voters[0], cut_eps, config_before, (0,), added.__contains__)
            quorum = n_before - (n_before - 1) // 4
            if len(voters) + 1 < quorum:  # each member also tallies its own vote
                LOG.warning(
                    "only %d live virtual voters for quorum %d; real members "
                    "may need the classic fallback to learn this decision",
                    len(voters),
                    quorum,
                )
            # one alert batch + ONE vote-batch frame per member: the quorum
            # of identical-value votes (~3N/4 protocol messages) is
            # transport-batched (FastRoundVoteBatch)
            votes_msg = P.FastRoundVoteBatch(
                senders=tuple(voters[:quorum]),
                configuration_id=config_before,
                endpoints=tuple(cut_eps),
            )
            # keep the packet BEFORE delivering: a failed chain records the
            # member in _undelivered against this decision
            self._last_decision = (config_before, alerts, tuple(cut_eps), tuple(voters[:quorum]))
            self._decision_packet = (
                config_before,
                P.BatchedAlertMessage(voters[0], alerts),
                votes_msg,
                voters[0],
                # post-decision id: a later packet applies to a member only
                # if that member is exactly here (chains walk off this)
                sim.configuration_id(),
            )
            self._packet_history[config_before] = self._decision_packet
            while len(self._packet_history) > 8:
                self._packet_history.popitem(last=False)
            with self._undelivered_lock:
                lagging_now = set(self._undelivered)
            for member in members_before:
                if member in lagging_now:
                    # it provably missed the PREVIOUS decision and is beyond
                    # vote repair; the next pump's reconciliation cuts it
                    continue
                self._deliver_decision_chain(member)
            self._replay_counts = {}
            self._prior_configs.append(config_before)
            # prune strikes whose config fell out of the stale window; keep
            # live ones, so a member stranded many configs behind under
            # sustained churn still reaches the cut threshold
            self._stale_counts = {
                key: strikes
                for key, strikes in self._stale_counts.items()
                if key[1] in self._prior_configs
            }
        # unblock admitted joiners (respondToJoiners, MembershipService.java:708-733);
        # the full configuration streams once per joiner, to its newest
        # parked request (the earlier attempts' requests have expired
        # client-side); siblings answer CONFIG_CHANGED
        config_now = sim.configuration_id()
        for joiner in list(self._parked):
            slot = self._slot_of.get(joiner)
            if slot is not None and sim.active[slot]:
                first = self._streamed.get(joiner) != config_now
                for observer_ep, parked in reversed(self._parked.pop(joiner)):
                    if first:
                        self._streamed[joiner] = config_now
                        first = False
                        parked.set_result(self._full_config_response(observer_ep))
                    else:
                        parked.set_result(P.JoinResponse(
                            sender=observer_ep,
                            status_code=P.JoinStatusCode.CONFIG_CHANGED,
                            configuration_id=config_now,
                        ))
        # recycle removed real members' slots: the identifier history is
        # value-based, so a slot can be re-seated for a future joiner
        for slot in (int(s) for s in rec.removed):
            ep = self._endpoint(slot)
            if self._real.get(ep) == slot:
                self._release(ep, slot)
                self._streamed.pop(ep, None)
        return rec

    def _release(self, ep, slot: int) -> None:
        """Return a real member's slot to the engine and the free list."""
        del self._real[ep]
        del self._slot_of[ep]
        self._metadata.pop(ep, None)
        self.sim.set_auto_vote(slot, True)
        self._free_slots.append(slot)

    def _broadcast_announced_proposal(self, config_id: int, members: list, src) -> None:
        """Send real members the alert evidence behind the announced (still
        undecided) proposal, so their own cut detectors cross H and they cast
        genuine fast-round votes. Ring numbers 0..K-1 stand for the K
        observers whose reports the swarm aggregated -- one report per
        (dst, ring), what the cut detector dedups on
        (MultiNodeCutDetector.java:97-101)."""
        announced, proposals = self.sim.last_announcement
        # group rows only: extern rows are real members' own votes
        row = int(np.flatnonzero(announced[: self.sim.config.groups])[0])
        cut_eps = sorted(
            (self._endpoint(int(s)) for s in np.flatnonzero(proposals[row])),
            key=address_comparator_key,
        )
        active = self.sim.active
        alerts = self._alerts(src, cut_eps, config_id, tuple(range(self.sim.config.k)),
                              lambda slot: not active[slot])
        for member in members:
            self._deliver(src, member, self.protocol.BatchedAlertMessage(src, alerts))

    def _advance_clock(self, ms: int) -> None:
        """Let the protocol plane process in-flight messages: drive the shared
        virtual clock when there is one, otherwise wait out wall time."""
        run_for = getattr(self.network.scheduler, "run_for", None)
        if run_for is not None:
            run_for(ms)
        else:  # pragma: no cover - real-scheduler deployments
            time.sleep(ms / 1000.0)

    def _deliver(self, src, dst, msg):
        # join-class deadline, not the 1 s default: decision packets straddle
        # a view change, and the receiving member may be mid-bootstrap of its
        # new view when the packet lands (GrpcClient.java:55-59)
        return self.network.deliver(src, dst, msg, timeout_ms=5000)

    def _quiescent(self) -> bool:
        """True when no protocol progress is possible: no membership work
        pending (joins/leaves/crashes/injected evidence/extern votes), no
        announcement awaiting a decision, and no fault knob armed that could
        make a probe of a live member fail. Host mirrors only: no sync."""
        sim = self.sim
        return (
            not sim.pending_joiners
            and not sim.pending_leavers
            and not sim._extern_voted  # noqa: SLF001
            and sim.last_announcement is None
            and not sim._injected_down.any()  # noqa: SLF001
            and bool((sim.alive | ~sim.active).all())
            and not sim._ingress_partitioned  # noqa: SLF001
            and not (sim._drop_prob > 0).any()  # noqa: SLF001
            and bool(sim._deliver.all())  # noqa: SLF001
        )

    def _sense_real_liveness(self) -> None:
        """A real member is alive while its server listens on the network;
        when it disappears, its slot dies and the simulated FDs take over. A
        member that dies *before* admission has its pending join withdrawn
        and its spare slot reclaimed."""
        for ep, slot in list(self._real.items()):
            if self.network.is_listening(ep):
                continue
            if self.sim.active[slot]:
                if self.sim.alive[slot]:
                    self.sim.crash(np.array([slot]))
            else:
                self.sim.cancel_join(slot)
                self._parked.pop(ep, None)  # the dead joiner can't hear replies
                self._release(ep, slot)
