"""Host driver: runs the device round loop and applies view changes.

The port of ``rapid_tpu/sim/driver.py``'s ``Simulator``, restricted to the
protocol: ring/adjacency construction at configuration changes
(MembershipView ringAdd/ringDelete), configuration identity (the chained
xxHash64, bit-compatible with the JVM), the append-only identifiersSeen set
(MembershipView.java:51,155), the fault API (crash bursts, one-way ingress
partitions, lossy ingress, flip-flop, leaves, join waves, delivery groups and
delays), identities seated ahead of joins, bridged external voters, both
dispatch branches of ``run_until_decision`` with the classic-Paxos fallback
round (``classic.py``), the configuration snapshot, and the multi-device
round loop over a mesh (``mesh=``, ``rapid_tpu_torch/shard/engine.py``).
Method names and signatures follow the JAX driver, plus a ``device``
argument.

Not in this port yet (ROADMAP.md, Queue 1): the speculative view-change
worker, and the placement, handoff, serving, SLO, durability, hierarchy,
forensics, profiling, metrics and tracing planes.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..hashing import xxh64_batch_auto
from ..shard.engine import (
    Mesh,
    make_sharded_run,
    make_sharded_run_until,
    place_inputs,
    place_state,
    row_field,
    shard_generators,
)
from .classic import ClassicCoordinator
from .engine import (
    FAST_RANK,
    RANK_BITS,
    RoundInputs,
    SimConfig,
    SimState,
    device_initial_state,
    pack_decision,
    resolve_device,
    run_rounds_const,
    run_until_decided_const,
    unpack_decision,
)
from .topology import VirtualCluster, _int64_le_bytes, config_fold, ring_order

# rounds a classic recovery exchange bills with no latency skew: phase1a,
# phase1b, phase2a, phase2b, one delivery hop each (the JAX driver's
# _CLASSIC_ROUND_HOPS); under skew the winning coordinator's cutoffs are
# billed instead
_CLASSIC_ROUND_HOPS = 4


def _pow2_chunks(n: int, batch: int) -> List[int]:
    """Split ``n`` rounds into scan lengths drawn from {batch} and powers of
    two -- the JAX driver's dispatch sequence for the scan path (where each
    length is a compiled executable), kept so both drivers issue the same
    dispatches and execute exactly ``n`` rounds."""
    chunks: List[int] = []
    while n > 0:
        step = batch if n >= batch else 1 << (n.bit_length() - 1)
        chunks.append(step)
        n -= step
    return chunks


@dataclass
class ViewChangeRecord:
    """One decided configuration change."""

    cut: np.ndarray  # node ids added/removed
    added: np.ndarray
    removed: np.ndarray
    configuration_id: int
    virtual_time_ms: int  # protocol-time of the decision
    wall_time_s: float  # host+device time spent simulating to it
    membership_size: int
    via_classic_round: bool = False  # decided by the Paxos fallback


class Simulator:
    def __init__(
        self,
        n_nodes: int,
        capacity: Optional[int] = None,
        config: Optional[SimConfig] = None,
        seed: int = 0,
        identities=None,
        device=None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """``identities``: optional [(hostname bytes, port, id_high, id_low)]
        seated into slots 0.. before any state is built, replacing the
        synthesized identities.

        ``device``: where the round loop runs; CUDA unless the caller names
        another (``"cpu"`` for the tests). Without a GPU and without an
        explicit device, construction raises.

        ``mesh``: a ``shard.engine.Mesh`` (``make_mesh``) to run the round
        loop over several devices, or several shards of one: per-edge state
        row-sharded over every mesh axis, the rest on the mesh's home device,
        which is then the simulator's ``device``; capacity must divide over
        it. The fault, join, leave and view-change API is the same in both
        modes; a mesh dispatch runs the rounds one by one (the closed form
        is single-device)."""
        self.device = mesh.home if mesh is not None else resolve_device(device)
        capacity = capacity if capacity is not None else n_nodes
        assert n_nodes <= capacity
        self.config = config if config is not None else SimConfig(capacity=capacity)
        assert self.config.capacity == capacity
        assert self.config.fd_interval_ms % self.config.rounds_per_interval == 0, (
            "fd_interval_ms must divide evenly into sub-interval rounds"
        )
        self.mesh = mesh
        self.cluster = VirtualCluster.synthesize(capacity, self.config.k, seed=seed)
        if identities is not None:
            assert len(identities) <= capacity
            for slot, (host, port, id_high, id_low) in enumerate(identities):
                self.cluster.assign_identity(slot, host, port, id_high, id_low)
        self.active = np.zeros(capacity, dtype=bool)
        self.active[:n_nodes] = True
        self.alive = self.active.copy()
        self.group_of = np.zeros(capacity, dtype=np.int32)
        self.auto_vote = np.ones(capacity, dtype=bool)
        # identifiersSeen: the append-only *value* history of every NodeId
        # ever admitted (MembershipView.java:51,155), in admission order
        slots = np.flatnonzero(self.active)
        self._seen_ids = np.stack(
            [self.cluster.id_high[slots], self.cluster.id_low[slots]], axis=1
        )  # [M, 2] int64
        self._seen_set: Optional[Set[Tuple[int, int]]] = None
        self._seen_hashes: Optional[np.ndarray] = None  # [M, 2] uint64
        self.seed = seed
        self.virtual_ms = 0
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        """Everything past identity/membership: device caches, fresh device
        state, the all-clear fault plane, and the hash pre-warms. Shared by
        __init__ and from_configuration."""
        capacity, k, g = self.config.capacity, self.config.k, self.config.groups
        dev = self.device
        self._config_id: Optional[int] = None
        self._sharded_runs: dict = {}
        # device-resident constants: the ring ranks (adjacency rebuilds never
        # re-upload them) and the all-clear fault-plane tensors
        self._ring_rank_dev = torch.as_tensor(self.cluster.ring_rank(), device=dev)
        self._ring_rank_dirty = False
        self._zero_ck = torch.zeros((capacity, k), dtype=torch.bool, device=dev)
        self._zero_drop_prob = torch.zeros(capacity, dtype=torch.float32, device=dev)
        self._ones_deliver = torch.ones((g, capacity), dtype=torch.bool, device=dev)
        self._zero_delay = torch.zeros((g, capacity), dtype=torch.int32, device=dev)
        self._deliver_delay = np.zeros((g, capacity), dtype=np.int32)
        self._deliver_delay_dev: Optional[torch.Tensor] = None
        self._alive_dev: Optional[torch.Tensor] = None
        self._probe_drop_dev: Optional[torch.Tensor] = None
        self._down_reports_dev: Optional[torch.Tensor] = None
        self._subjects_host: Optional[np.ndarray] = None
        self._observers_host: Optional[np.ndarray] = None
        self._ring_nodes: Optional[List[np.ndarray]] = None
        self._ids_sorted: Optional[np.ndarray] = None
        self.state = self._fresh_state(self.seed)
        self._billed_rounds = 0  # rounds of this configuration already billed
        self.view_changes: List[ViewChangeRecord] = []
        # fault plane
        self._ingress_partitioned: Set[int] = set()
        self._drop_prob = np.zeros(capacity, dtype=np.float32)
        self._deliver = np.ones((g, capacity), dtype=bool)
        self._pending_joiners: Set[int] = set()
        self._join_reports_armed = False
        self._pending_leavers: Set[int] = set()
        self._injected_down = np.zeros((capacity, k), dtype=bool)
        # host-side randomness for the classic-fallback coordinator race
        # (which nodes' expovariate timers fire first, FastPaxos.java:200-203),
        # seeded as the JAX driver seeds it so runs replay alike
        self._host_rng = np.random.default_rng(self.seed ^ 0x5EED_C1A5)
        # membership-invariant element hashes: construction cost, not
        # protocol time (they feed every configuration_id fold)
        self.cluster.node_hashes()
        self._sorted_identifiers()
        self._seen_id_hashes()

    def _fresh_state(self, seed: int) -> SimState:
        """Fresh-configuration state, built on the device
        (engine.device_initial_state) and placed on the mesh if there is
        one, and this configuration's random-loss generator, seeded as the
        JAX driver seeds its PRNG key (on a mesh, one a shard,
        ``shard.engine.shard_generators``)."""
        # extern proposal rows, the per-sender vote dedup, and the classic
        # round counter are per-configuration, like every consensus latch
        self._extern_rows: dict = {}  # proposal-mask bytes -> extern row
        self._extern_voted: Set[int] = set()
        self._last_announcement: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._classic_attempts = 0
        dev = self.device
        if self._ring_rank_dirty:
            self._ring_rank_dev = torch.as_tensor(self.cluster.ring_rank(), device=dev)
            self._ring_rank_dirty = False
        self._subjects_host = None
        self._observers_host = None
        self._ring_nodes = None
        self._alive_dev = None
        self._probe_drop_dev = None  # partition set maps onto new adjacency
        self._down_reports_dev = None  # leave alerts map onto new adjacency
        state = device_initial_state(
            self.config,
            self._ring_rank_dev,
            self._tensor(self.active),
            self._tensor(self.alive & self.active),
            self._tensor(self.group_of),
            self._tensor(self.auto_vote),
        )
        if self.mesh is None:
            self._generator = torch.Generator(device=dev).manual_seed(seed)
            return state
        self._generators = shard_generators(self.mesh, seed)
        return place_state(state, self.mesh)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the device: never a view of the array,
        which the host goes on mutating, and on CUDA queued from pinned
        memory, so the host does not wait for it."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------ #
    # Fault injection (BASELINE.json configs)
    # ------------------------------------------------------------------ #

    def crash(self, node_ids: np.ndarray) -> None:
        """Crash-stop burst: nodes stop responding to probes and stop voting."""
        self.alive[np.atleast_1d(node_ids)] = False
        self._alive_dev = self._tensor(self.alive)

    def revive(self, node_ids: np.ndarray) -> None:
        """Flip-flop support: nodes become reachable again (cumulative FD
        counters are deliberately NOT reset -- PingPongFailureDetector.java:116-118)."""
        node_ids = np.atleast_1d(node_ids)
        self.alive[node_ids] = self.active[node_ids]
        self._alive_dev = self._tensor(self.alive)

    def leave(self, node_ids: np.ndarray) -> None:
        """Graceful leave: each leaver proactively notifies its K observers,
        which broadcast DOWN alerts immediately (MembershipService.java:366-371,
        534-554). Leavers keep responding to probes until the view change
        removes them."""
        for node in np.atleast_1d(node_ids):
            node = int(node)
            assert self.active[node], f"node {node} is not a member"
            # a crashed process cannot send a leave notification; its removal
            # must go through failure detection
            assert self.alive[node], f"node {node} is crashed, cannot leave"
            self._pending_leavers.add(node)
        self._down_reports_dev = None

    def inject_down_report(self, dst: int, rings) -> None:
        """Externally sourced DOWN reports for ``dst`` on the given rings.
        One-shot per configuration, like any other alert."""
        self._injected_down[dst, list(rings)] = True
        self._down_reports_dev = None

    def assign_identity(
        self, slot: int, hostname: bytes, port: int, id_high: int, id_low: int
    ) -> None:
        """Seat a process identity in an inactive slot ahead of its join; see
        VirtualCluster.assign_identity. Re-seating a slot whose previous
        identity was admitted in some past configuration is legal (the
        identifier history is stored by value), but identifier reuse is not
        (MembershipView.java:101-116)."""
        assert not self.active[slot] and slot not in self._pending_joiners
        assert (id_high, id_low) not in self._seen_identifier_set(), (
            "identifier reuse"
        )
        self.cluster.assign_identity(slot, hostname, port, id_high, id_low)
        # the device rank table is consumed at the next configuration rebuild
        # (_fresh_state), so a burst of seatings uploads it once
        self._ring_rank_dirty = True
        self._ring_nodes = None

    def _seen_identifier_set(self) -> Set[Tuple[int, int]]:
        """Membership test over the identifier history, built on first use."""
        if self._seen_set is None:
            self._seen_set = {(int(h), int(l)) for h, l in self._seen_ids}
        return self._seen_set

    def is_identifier_seen(self, id_high: int, id_low: int) -> bool:
        return (id_high, id_low) in self._seen_identifier_set()

    @property
    def identifiers_seen(self) -> Set[Tuple[int, int]]:
        """The append-only identifier history, as (high, low) values."""
        return set(self._seen_identifier_set())

    @property
    def pending_joiners(self) -> Set[int]:
        return set(self._pending_joiners)

    @property
    def pending_leavers(self) -> Set[int]:
        return set(self._pending_leavers)

    def endpoint_of(self, slot: int) -> Tuple[bytes, int]:
        host = bytes(self.cluster.hostnames[slot, : self.cluster.host_lengths[slot]])
        return host, int(self.cluster.ports[slot])

    def one_way_ingress_partition(self, node_ids: np.ndarray) -> None:
        """Asymmetric failure: probes TO these nodes are lost, their own
        traffic still flows (paper §7, iptables INPUT partitions). Persists
        across view changes until lifted."""
        self._ingress_partitioned.update(int(i) for i in np.atleast_1d(node_ids))
        self._probe_drop_dev = None

    def ingress_loss(self, node_ids: np.ndarray, probability: float) -> None:
        """Lossy ingress (e.g. 80% loss): probes to these nodes fail with
        the given probability each round."""
        self._drop_prob[np.atleast_1d(node_ids)] = probability

    def clear_link_faults(self) -> None:
        self._ingress_partitioned.clear()
        self._drop_prob[:] = 0.0
        self._deliver[:] = True
        self._deliver_delay[:] = 0
        self._deliver_delay_dev = None
        self._probe_drop_dev = None

    # ------------------------------------------------------------------ #
    # Heterogeneous broadcast delivery (almost-everywhere agreement)
    # ------------------------------------------------------------------ #

    def set_delivery_groups(self, group_of: np.ndarray) -> None:
        """Partition nodes into delivery classes (config.groups must cover
        the assignment)."""
        group_of = np.asarray(group_of, dtype=np.int32)
        assert group_of.shape == (self.config.capacity,)
        assert group_of.max(initial=0) < self.config.groups
        self.group_of = group_of
        self.state = dataclasses.replace(self.state, group_of=self._tensor(group_of))

    def drop_broadcasts(self, receiver_group: int, sender_nodes: np.ndarray) -> None:
        """Group ``receiver_group`` stops hearing broadcasts originating from
        ``sender_nodes``."""
        self._deliver[receiver_group, np.atleast_1d(sender_nodes)] = False

    def delay_broadcasts(
        self, receiver_group: int, sender_nodes: np.ndarray, rounds: int
    ) -> None:
        """Broadcasts from ``sender_nodes`` reach ``receiver_group``
        ``rounds`` rounds late (requires config.max_delivery_delay >= rounds)."""
        assert 0 <= rounds <= self.config.max_delivery_delay, (
            f"delay {rounds} exceeds config.max_delivery_delay="
            f"{self.config.max_delivery_delay}"
        )
        self._deliver_delay[receiver_group, np.atleast_1d(sender_nodes)] = rounds
        self._deliver_delay_dev = None

    # ------------------------------------------------------------------ #
    # Bridged (external) voters
    # ------------------------------------------------------------------ #

    def set_auto_vote(self, slot: int, enabled: bool) -> None:
        """Transfer fast-round vote ownership of a slot between the engine
        and an external voter (a bridged real member). With auto_vote off,
        the slot's vote counts only when the host registers the node's
        actually-received vote. Clear it before the slot's first
        configuration as a member: an already-cast vote is not retracted."""
        self.auto_vote[slot] = bool(enabled)
        self.state = dataclasses.replace(self.state, auto_vote=self._tensor(self.auto_vote))

    def register_extern_vote(self, slot: int, cut: np.ndarray) -> bool:
        """Count an external member's fast-round vote in the device tally
        (FastPaxos.java:134-150): intern the voted cut as a proposal row
        (identical values pool with group proposals in the tally), mark the
        sender's per-node vote state, and put the vote in flight so it
        arrives one delivery round later. Only the first vote of a sender in
        a configuration counts. Returns True iff the vote was registered.

        Until a classic round has run in this configuration no rank can
        exceed the fast rank, so the call reads nothing back from the device;
        its writes are device ops and, for a new row, one upload."""
        if slot in self._extern_voted:
            return False  # dedup by sender (FastPaxos.java:134-141)
        if self._classic_attempts > 0 and self._classic_rank(slot) >= FAST_RANK:
            # the slot already joined a classic round: its fast vote must not
            # count toward a fast quorum (registerFastRoundVote refuses once
            # rnd.round > 1, Paxos.java:246-248), the engine's gate too
            return False
        mask = np.zeros(self.config.capacity, dtype=bool)
        mask[np.atleast_1d(cut)] = True
        key = mask.tobytes()
        row = self._extern_rows.get(key)
        st = self.state
        if row is None:
            if len(self._extern_rows) >= self.config.extern_proposals:
                logging.getLogger(__name__).warning(
                    "no free extern proposal row (extern_proposals=%d); "
                    "dropping external vote from slot %d",
                    self.config.extern_proposals, slot,
                )
                return False
            row = self.config.groups + len(self._extern_rows)
            self._extern_rows[key] = row
            st = dataclasses.replace(
                st,
                proposal=_with(st.proposal, row, self._tensor(mask)),
                announced=_with(st.announced, row, True),
            )
        # out of place: an earlier state may still reference these tensors
        self.state = dataclasses.replace(
            st,
            voted=_with(st.voted, slot, True),
            vote_prop=_with(st.vote_prop, slot, row),
            vote_new=_with(st.vote_new, slot, True),
        )
        self._extern_voted.add(slot)
        return True

    def _classic_rank(self, slot: int) -> int:
        """The highest classic rank ``slot`` has promised (one host sync)."""
        return int(self.state.classic_rnd[slot])

    def _probe_drop_mask(self) -> np.ndarray:
        """Map the partitioned-destination set onto the current adjacency."""
        mask = np.zeros(self.config.capacity, dtype=bool)
        if self._ingress_partitioned:
            mask[list(self._ingress_partitioned)] = True
        if self._subjects_host is None:
            # one device->host copy per adjacency rebuild
            subjects = (self.state.subjects if self.mesh is None
                        else row_field(self.state, "subjects"))
            self._subjects_host = subjects.cpu().numpy()
        return mask[self._subjects_host]

    def _has_down_reports(self) -> bool:
        return bool(self._pending_leavers) or bool(self._injected_down.any())

    def _down_reports(self) -> torch.Tensor:
        """dst-indexed proactive DOWN reports: pending leavers (the ring-k
        report for a leaver arrives iff its ring-k observer is alive to
        broadcast it, MembershipService.java:366-371) plus injected reports."""
        if self._down_reports_dev is None:
            mask = self._injected_down.copy()
            if self._pending_leavers:
                if self._observers_host is None:
                    # one device->host copy per adjacency rebuild
                    self._observers_host = self.state.observers.cpu().numpy()
                leavers = sorted(self._pending_leavers)
                obs = self._observers_host[leavers]  # [L, K]
                mask[leavers] |= self.alive[obs] & self.active[obs]
            self._down_reports_dev = self._tensor(mask)
        return self._down_reports_dev

    def _const_inputs(self, join_reports: Optional[np.ndarray]) -> RoundInputs:
        """This dispatch's fault plane, reusing the device-resident all-clear
        tensors whenever a fault class is inactive; on a mesh, placed
        (``probe_drop`` in row blocks on the shards' devices)."""
        if self._alive_dev is None:
            self._alive_dev = self._tensor(self.alive)
        if self._ingress_partitioned and self._probe_drop_dev is None:
            self._probe_drop_dev = self._tensor(self._probe_drop_mask())
        if not self._deliver_delay.any():
            deliver_delay = self._zero_delay
        else:
            if self._deliver_delay_dev is None:
                self._deliver_delay_dev = self._tensor(self._deliver_delay)
            deliver_delay = self._deliver_delay_dev
        inputs = RoundInputs(
            alive=self._alive_dev,
            probe_drop=(
                self._probe_drop_dev if self._ingress_partitioned else self._zero_ck
            ),
            drop_prob=(
                self._tensor(self._drop_prob)
                if (self._drop_prob > 0).any()
                else self._zero_drop_prob
            ),
            join_reports=(
                self._zero_ck if join_reports is None else self._tensor(join_reports)
            ),
            down_reports=(
                self._down_reports() if self._has_down_reports() else self._zero_ck
            ),
            deliver=(
                self._ones_deliver if self._deliver.all() else self._tensor(self._deliver)
            ),
            deliver_delay=deliver_delay,
        )
        return inputs if self.mesh is None else place_inputs(inputs, self.mesh)

    # ------------------------------------------------------------------ #
    # Joins
    # ------------------------------------------------------------------ #

    def request_joins(self, node_ids: np.ndarray) -> None:
        """A join wave: each joining slot's K expected observers emit UP
        alerts with the ring numbers the joiner assigned
        (MembershipService.java:229-251). Pending joiners re-attempt in every
        new configuration until admitted."""
        for node in np.atleast_1d(node_ids):
            node = int(node)
            assert not self.active[node], f"node {node} already a member"
            nid = (int(self.cluster.id_high[node]), int(self.cluster.id_low[node]))
            assert nid not in self._seen_identifier_set(), (
                f"identifier reuse at {node}"
            )
            self._pending_joiners.add(node)
        self._join_reports_armed = False

    def cancel_join(self, slot: int) -> None:
        """Withdraw a pending join; its UP reports stop being armed from the
        next dispatch."""
        self._pending_joiners.discard(slot)
        self._join_reports_armed = False

    def _arm_pending_joins(self) -> Optional[np.ndarray]:
        """Build this configuration's join reports and write each joiner's
        expected observers into its (otherwise unused) observers row so the
        implicit-invalidation pass covers joins (MultiNodeCutDetector.java:146-158)."""
        if not self._pending_joiners or self._join_reports_armed:
            return None
        self._join_reports_armed = True
        k = self.config.k
        join_reports = np.zeros((self.config.capacity, k), dtype=bool)
        # once per join wave, not per dispatch
        observers = self.state.observers.cpu().numpy().copy()
        for node in sorted(self._pending_joiners):
            obs_ids, obs_alive = self._expected_observers(node)
            join_reports[node, :] = obs_alive
            observers[node, :] = obs_ids
        self.state = dataclasses.replace(self.state, observers=self._tensor(observers))
        return join_reports

    def _expected_observers(self, node: int) -> Tuple[np.ndarray, np.ndarray]:
        """The node's ring predecessors (MembershipView.java:293-304 for
        joiners) and whether each is alive to vouch."""
        k = self.config.k
        ids = np.zeros(k, dtype=np.int32)
        alive = np.zeros(k, dtype=bool)
        if self._ring_nodes is None:
            full_order = self.cluster.full_ring_order()
            self._ring_nodes = [
                full_order[ring][self.active[full_order[ring]]] for ring in range(k)
            ]
        signed = self.cluster.ring_hashes.view(np.int64)
        for ring in range(k):
            ring_nodes = self._ring_nodes[ring]
            me = signed[ring, node]
            pos = np.searchsorted(signed[ring, ring_nodes], me)
            pred = ring_nodes[pos - 1] if pos > 0 else ring_nodes[-1]
            ids[ring] = pred
            alive[ring] = self.alive[pred]
        return ids, alive

    # ------------------------------------------------------------------ #
    # Round loop
    # ------------------------------------------------------------------ #

    def run_until_decision(
        self, max_rounds: int = 64, batch: int = 8,
        classic_fallback_after_rounds: Optional[int] = 8,
        stop_when_announced: bool = False,
    ) -> Optional[ViewChangeRecord]:
        """Run device batches until consensus decides a cut, then apply the
        view change. Returns the record, or None if no decision in budget.

        Under a deterministic fault plane each batch is one closed-form
        dispatch (engine.run_until_decided_const); under random ingress loss
        it is a scan of ``step`` (engine.run_rounds_const), whose FD phase is
        the CUDA kernel. On a mesh each batch is one dispatch of the sharded
        runner (``shard.engine.make_sharded_run_until``), whose FD phase is
        the CUDA kernels ``fd_phase_rows`` on every shard and ``fd_gather`` on
        home. Either way the host syncs once per batch, fetching the packed
        decision words.

        If the fast round stalls for ``classic_fallback_after_rounds``
        rounds, a classic Paxos recovery round runs (``_run_classic_round``,
        at most one per batch); a decision there bills the exchange's hops
        and sets ``via_classic_round`` on the record.

        ``stop_when_announced``: return (None) as soon as a proposal is
        announced but undecided, leaving the announcement snapshot in
        ``last_announcement``."""
        t0 = time.perf_counter()
        rounds_done = 0
        while rounds_done < max_rounds:
            join_reports = self._arm_pending_joins()
            inputs = self._const_inputs(join_reports)
            n = min(batch, max_rounds - rounds_done)
            random_loss = bool((self._drop_prob > 0).any())
            if stop_when_announced and not random_loss:
                # the closed form pauses at the announcement round itself,
                # so the whole remaining budget rides one dispatch
                n = max_rounds - rounds_done
            if self.mesh is not None:
                # rounds after the decision (and, for stop_when_announced,
                # the announcement) run as masked no-ops; the budget is an
                # argument, so every batch size shares one cached runner
                self.state = self._sharded_run_until(random_loss, stop_when_announced)(
                    self.state, inputs, n, self._generators)
            elif random_loss:
                for chunk in _pow2_chunks(n, batch):
                    self.state = run_rounds_const(
                        self.config, self.state, inputs, chunk, True, self._generator
                    )
            else:
                self.state = run_until_decided_const(
                    self.config, self.state, inputs, n,
                    bool(self._deliver.all()), stop_when_announced,
                )
            # ONE device->host copy syncs the batch and fetches everything a
            # decision needs
            words = pack_decision(self.config, self.state).cpu().numpy()
            (decided, announced_np, announced_round_np, proposal_np,
             decided_group, decided_round, round_np) = unpack_decision(
                self.config, words
            )
            rounds_done += n
            if decided:
                return self._apply_view_change(
                    t0, (proposal_np, decided_group, decided_round)
                )
            if announced_np.any():
                self._last_announcement = (announced_np, proposal_np)
                if stop_when_announced and announced_np[: self.config.groups].any():
                    # bill exactly the rounds this configuration has executed
                    self.virtual_ms += (round_np - self._billed_rounds) * self._round_ms
                    self._billed_rounds = round_np
                    return None
                # the fallback timer runs from propose() (FastPaxos.java:105-107)
                stalled_rounds = round_np - announced_round_np
                if (
                    classic_fallback_after_rounds is not None
                    and stalled_rounds >= classic_fallback_after_rounds
                ):
                    winner, exchange_rounds = self._run_classic_round()
                    if winner is not None:
                        # the fetched words hold every proposal row, so the
                        # decision needs no write back to the device
                        record = self._apply_view_change(
                            t0, (proposal_np, winner, round_np + exchange_rounds)
                        )
                        record.via_classic_round = True
                        return record
        self.virtual_ms += rounds_done * self._round_ms
        self._billed_rounds += rounds_done
        return None

    @property
    def last_announcement(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(announced[P], proposal[P, C]) snapshot from the most recent
        dispatch that saw an undecided announcement; None in a fresh
        configuration."""
        return self._last_announcement

    @property
    def _round_ms(self) -> int:
        """Protocol time per engine round (a whole FD interval, or a fraction
        of one under the staggered-phase asynchrony model)."""
        return self.config.fd_interval_ms // self.config.rounds_per_interval

    def _sharded_run(self, rounds: int, random_loss: bool):
        """The mesh round loop of ``rounds`` rounds, cached per (length,
        loss model). Kept for differential testing against the runner the
        driver dispatches."""
        key = (rounds, random_loss)
        if key not in self._sharded_runs:
            self._sharded_runs[key] = make_sharded_run(
                self.config, self.mesh, rounds, random_loss)
        return self._sharded_runs[key]

    def _sharded_run_until(self, random_loss: bool, stop_when_announced: bool = False):
        """The mesh decision runner, cached per (loss model, announcement
        stop): the round budget is an argument, so every batch size shares
        one runner."""
        key = ("until", random_loss, stop_when_announced)
        if key not in self._sharded_runs:
            self._sharded_runs[key] = make_sharded_run_until(
                self.config, self.mesh, random_loss, stop_when_announced)
        return self._sharded_runs[key]

    def _run_classic_round(self) -> Tuple[Optional[int], int]:
        """One classic recovery attempt with per-node acceptor state on the
        device (``classic.py``). Every live node's expovariate fallback timer
        races (FastPaxos.java:200-203: delay ~ Exp(1/N)); the nodes whose
        timers fire within one round of the first coordinate concurrently (at
        most 3), their promises contending on the shared acceptor state. The
        attempt's round number grows with each attempt, so retries outrank
        earlier rounds.

        Returns (decided proposal row or None, the winning coordinator's
        exchange rounds to bill -- _CLASSIC_ROUND_HOPS when the attempt
        failed or no latency skew is active)."""
        live = self.active & self.alive
        n = int(self.active.sum())
        if int(live.sum()) <= n // 2:
            return None, _CLASSIC_ROUND_HOPS
        if 2 + self._classic_attempts >= (1 << (31 - RANK_BITS)):
            return None, _CLASSIC_ROUND_HOPS  # rank space exhausted: stay stalled
        self._classic_attempts += 1
        live_slots = np.flatnonzero(live)
        times = self._host_rng.exponential(scale=max(n, 1), size=len(live_slots))
        order = np.argsort(times)
        sorted_times = times[order]
        racing = min(1 + int((sorted_times[1:] - sorted_times[0] < 1.0).sum()), 3)
        coordinators = [
            ClassicCoordinator(
                self, round_no=1 + self._classic_attempts, slot=int(live_slots[order[i]])
            )
            for i in range(racing)
        ]
        # phase1 wave in arrival order; the higher slot outranks within the
        # shared round, and the acceptors' rank checks arbitrate
        promised = [c.phase1() for c in coordinators]
        decided = None
        exchange_rounds = _CLASSIC_ROUND_HOPS
        for coordinator, ok in zip(coordinators, promised):
            if not ok:
                continue
            row = coordinator.pick_value()
            if row is None:
                continue
            won = coordinator.phase2(row)
            if won is not None and decided is None:
                decided = won
                exchange_rounds = coordinator.elapsed_rounds
        # the JAX driver counts racing > 1 as "classic_coordinator_races" in
        # its metrics plane, which the port gains with the host planes
        # (ROADMAP.md, Queue 1 item 5)
        return decided, exchange_rounds

    def _apply_view_change(
        self,
        t0: float,
        fetched: Tuple[np.ndarray, int, int],  # (proposal[P,C], group, round)
    ) -> ViewChangeRecord:
        self._config_id = None  # membership / identifier history change below
        proposal_np, decided_group, decided_round = fetched
        # the winning proposal row's value is the decided cut
        cut = proposal_np[int(decided_group)]
        decided_round = int(decided_round)
        removed = np.flatnonzero(cut & self.active)
        added = np.flatnonzero(cut & ~self.active)
        self.active[removed] = False
        self.active[added] = True
        self.alive[added] = True
        if len(added):
            new_ids = np.stack(
                [self.cluster.id_high[added], self.cluster.id_low[added]], axis=1
            )
            self._seen_ids = np.concatenate([self._seen_ids, new_ids])
            if self._seen_set is not None:
                self._seen_set.update((int(h), int(l)) for h, l in new_ids)
            if self._seen_hashes is not None:
                high_h, low_h, _, _ = self.cluster.node_hashes()
                self._seen_hashes = np.concatenate(
                    [
                        self._seen_hashes,
                        np.stack([high_h[added], low_h[added]], axis=1),
                    ]
                )
            self._ids_sorted = None
        self._pending_joiners.difference_update(int(i) for i in added)
        self._ingress_partitioned.difference_update(int(i) for i in removed)
        self._join_reports_armed = False  # still-pending joiners re-attempt
        # removed leavers shut down for good; still-pending leavers re-notify
        # their observers in the new configuration
        left = self._pending_leavers.intersection(int(i) for i in removed)
        self._pending_leavers.difference_update(left)
        self.alive[list(left)] = False
        self._injected_down[:] = False  # alerts are per-configuration

        # protocol-time: only the rounds of this configuration not yet billed
        # (decided_round includes the vote-delivery round between announcement
        # and decision), plus the batching window before the alert broadcast
        unbilled = decided_round - self._billed_rounds
        self.virtual_ms += unbilled * self._round_ms + self.config.batching_window_ms
        self._billed_rounds = 0
        record = ViewChangeRecord(
            cut=np.flatnonzero(cut),
            added=added,
            removed=removed,
            configuration_id=self.configuration_id(),
            virtual_time_ms=self.virtual_ms,
            wall_time_s=time.perf_counter() - t0,
            membership_size=int(self.active.sum()),
        )
        self.view_changes.append(record)
        # new configuration: rebuild adjacency, reset per-config state;
        # crashes persist across configurations
        self.state = self._fresh_state(self.seed + len(self.view_changes))
        return record

    # ------------------------------------------------------------------ #

    def configuration_id(self) -> int:
        """Bit-exact configuration identity of the current membership,
        memoized until the next view change."""
        if self._config_id is not None:
            return self._config_id
        _, _, host_h, port_h = self.cluster.node_hashes()
        order = self._sorted_identifiers()
        seen_h = self._seen_id_hashes()
        order0 = ring_order(self.cluster, self.active, 0)
        self._config_id = config_fold(
            seen_h[order, 0], seen_h[order, 1], host_h[order0], port_h[order0]
        )
        return self._config_id

    def _sorted_identifiers(self) -> np.ndarray:
        """Indices into the seen-identifier history in NodeId (high, low)
        signed-lexicographic order, cached until a new identifier is admitted."""
        if self._ids_sorted is None:
            self._ids_sorted = np.lexsort(
                (self._seen_ids[:, 1], self._seen_ids[:, 0])
            )
        return self._ids_sorted

    def _seen_id_hashes(self) -> np.ndarray:
        """xxHash64 of each seen identifier's high/low values ([M, 2] uint64),
        maintained incrementally at admissions."""
        if self._seen_hashes is None or len(self._seen_hashes) != len(self._seen_ids):
            m = len(self._seen_ids)
            eight = np.full(m, 8, dtype=np.int64)
            self._seen_hashes = np.stack(
                [
                    xxh64_batch_auto(_int64_le_bytes(self._seen_ids[:, 0]), eight, 0),
                    xxh64_batch_auto(_int64_le_bytes(self._seen_ids[:, 1]), eight, 0),
                ],
                axis=1,
            )
        return self._seen_hashes

    def ready(self) -> "Simulator":
        """Block until construction/rebuild work has drained from the device
        queue -- separates setup cost from measured protocol time."""
        devices = self.mesh.device_list if self.mesh is not None else (self.device,)
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    @property
    def membership_size(self) -> int:
        return int(self.active.sum())

    def members(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    # ------------------------------------------------------------------ #
    # Configuration snapshot
    # ------------------------------------------------------------------ #

    def save_configuration(self, path: str, extra: Optional[dict] = None) -> None:
        """Persist the configuration snapshot, with the JAX driver's keys, so
        either package's ``from_configuration`` restores it: node identities,
        the membership, the append-only identifier history, and the clock
        (MembershipView Configuration, MembershipView.java:517-548).
        Per-round device state is not persisted; a restarted simulator starts
        a fresh configuration. ``extra``: more arrays, stored under
        ``extra_``-prefixed keys and ignored by ``from_configuration``."""
        np.savez_compressed(
            path,
            **{f"extra_{k}": v for k, v in (extra or {}).items()},
            hostnames=self.cluster.hostnames,
            host_lengths=self.cluster.host_lengths,
            ports=self.cluster.ports,
            id_high=self.cluster.id_high,
            id_low=self.cluster.id_low,
            ring_hashes=self.cluster.ring_hashes,
            active=self.active,
            alive=self.alive,
            identifiers_seen=self._seen_ids,  # [M, 2] (high, low) values
            virtual_ms=np.int64(self.virtual_ms),
            group_of=self.group_of,
            params=np.array(
                [self.config.capacity, self.config.k, self.config.h, self.config.l,
                 self.config.fd_threshold, self.config.fd_interval_ms,
                 self.config.batching_window_ms, self.seed, self.config.groups],
                dtype=np.int64,
            ),
        )

    @staticmethod
    def from_configuration(
        path: str, config_overrides: Optional[dict] = None, device=None,
        mesh: Optional[Mesh] = None,
    ) -> "Simulator":
        """Rebuild a simulator from a configuration snapshot written by
        either package's ``save_configuration``; the configuration id of the
        restored instance equals the saved one. ``config_overrides``:
        SimConfig fields to replace on top of the saved parameters.
        ``device`` and ``mesh`` as for the constructor."""
        with np.load(path) as data:
            params = [int(x) for x in data["params"]]
            (capacity, k, h, l, fd_threshold, fd_interval_ms,
             batching_window_ms, seed) = params[:8]
            groups = params[8] if len(params) > 8 else 1  # pre-groups snapshots
            config = SimConfig(
                capacity=capacity, k=k, h=h, l=l, fd_threshold=fd_threshold,
                fd_interval_ms=fd_interval_ms, batching_window_ms=batching_window_ms,
                groups=groups,
            )
            if config_overrides:
                config = dataclasses.replace(config, **config_overrides)
            sim = Simulator.__new__(Simulator)
            sim.device = mesh.home if mesh is not None else resolve_device(device)
            sim.mesh = mesh
            sim.config = config
            sim.cluster = VirtualCluster(
                hostnames=data["hostnames"],
                host_lengths=data["host_lengths"],
                ports=data["ports"],
                id_high=data["id_high"],
                id_low=data["id_low"],
                ring_hashes=data["ring_hashes"],
            )
            sim.active = data["active"].copy()
            sim.alive = data["alive"].copy()
            seen = data["identifiers_seen"]
            if seen.ndim == 1:
                # pre-value-history snapshots stored slot indices
                slots = seen.astype(np.int64)
                seen = np.stack(
                    [sim.cluster.id_high[slots], sim.cluster.id_low[slots]],
                    axis=1,
                )
            sim._seen_ids = seen.copy()
            sim._seen_set = None
            sim._seen_hashes = None
            sim.seed = seed
            sim.virtual_ms = int(data["virtual_ms"])
            sim.group_of = (
                data["group_of"].copy()
                if "group_of" in data
                else np.zeros(capacity, dtype=np.int32)
            )
            sim.auto_vote = np.ones(capacity, dtype=bool)
        sim._init_runtime_state()
        return sim


def _with(t: torch.Tensor, index: int, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value``, and ``t`` left as it was.
    Device ops only: a scalar is written by ``fill_``, which takes it as a
    kernel argument (``out[index] = scalar`` blocks on a host copy)."""
    out = t.clone()
    target = out.select(0, index)
    if isinstance(value, torch.Tensor):
        target.copy_(value)
    else:
        target.fill_(value)
    return out
