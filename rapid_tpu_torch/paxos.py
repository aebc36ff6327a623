"""Single-decree classic Paxos with the Fast Paxos coordinator value-pick rule.

The port's own copy of ``rapid_tpu/paxos.py``.

Reference: Paxos.java. This is the fallback path when the fast round
(FastPaxos) cannot reach the 3/4 supermajority on identical cut proposals.
State per instance: acceptor (rnd, vrnd, vval) and coordinator (crnd, cval)
(Paxos.java:63-70). Ranks are (round, node_index) ordered lexicographically
(Paxos.java:331-337).

Divergence note: the reference derives a coordinator's node_index from the
protobuf Endpoint.hashCode() (Paxos.java:101) -- a JVM-internal value. We use
the low 32 signed bits of the endpoint's seed-0 xxHash instead; any
deterministic, (practically) unique per-node value preserves the protocol
(rank uniqueness + total order), and this one is reproducible across runs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

from .hashing import endpoint_hash
from .messaging.base import IBroadcaster, IMessagingClient

if TYPE_CHECKING:  # pragma: no cover
    from .observability import Metrics, Tracer
from .types import (
    Endpoint,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    Rank,
)

Proposal = Tuple[Endpoint, ...]


def paxos_node_index(addr: Endpoint) -> int:
    """Deterministic 32-bit signed coordinator index for rank tie-breaking."""
    h = endpoint_hash(addr.hostname, addr.port, 0) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


class Paxos:  # guarded-by: protocol-executor
    def __init__(
        self,
        my_addr: Endpoint,
        configuration_id: int,
        membership_size: int,
        client: IMessagingClient,
        broadcaster: IBroadcaster,
        on_decide: Callable[[List[Endpoint]], None],
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
    ) -> None:
        self._metrics = metrics
        self._tracer = tracer
        self._my_addr = my_addr
        self._configuration_id = configuration_id
        self._n = membership_size
        self._client = client
        self._broadcaster = broadcaster
        self._on_decide = on_decide

        self._crnd = Rank(0, 0)
        self._rnd = Rank(0, 0)
        self._vrnd = Rank(0, 0)
        self._vval: Proposal = ()
        self._cval: Proposal = ()
        # keyed by sender: a retried/duplicated promise must not double-count
        # toward the majority (the retrying IMessagingClient makes this real)
        self._phase1b_messages: Dict[Endpoint, Phase1bMessage] = {}
        self._accept_responses: Dict[Rank, Dict[Endpoint, Phase2bMessage]] = {}
        self._decided = False

    # -- coordinator --------------------------------------------------------

    def start_phase1a(self, round_: int) -> None:
        """Initiate a classic round as coordinator (Paxos.java:97-110)."""
        if self._crnd.round > round_:
            return
        self._crnd = Rank(round_, paxos_node_index(self._my_addr))
        self._broadcaster.broadcast(
            Phase1aMessage(
                sender=self._my_addr,
                configuration_id=self._configuration_id,
                rank=self._crnd,
            )
        )

    def handle_phase1a(self, msg: Phase1aMessage) -> None:
        """Acceptor: promise the highest rank seen (Paxos.java:117-146)."""
        if msg.configuration_id != self._configuration_id:
            return
        if self._rnd < msg.rank:
            self._rnd = msg.rank
        else:
            return  # reject prepare from lower rank
        self._client.send_message(
            msg.sender,
            Phase1bMessage(
                sender=self._my_addr,
                configuration_id=self._configuration_id,
                rnd=self._rnd,
                vrnd=self._vrnd,
                vval=self._vval,
            ),
        )

    def handle_phase1b(self, msg: Phase1bMessage) -> None:
        """Coordinator: collect promises; on majority, pick a value by the
        Fast-Paxos coordinator rule and send phase2a (Paxos.java:154-186)."""
        if msg.configuration_id != self._configuration_id:
            return
        if msg.rnd != self._crnd:
            return  # only handle responses for our current round
        self._phase1b_messages[msg.sender] = msg
        if len(self._phase1b_messages) > self._n // 2:
            chosen = self.select_proposal_using_coordinator_rule(
                list(self._phase1b_messages.values())
            )
            if msg.rnd == self._crnd and not self._cval and chosen:
                self._cval = chosen
                self._broadcaster.broadcast(
                    Phase2aMessage(
                        sender=self._my_addr,
                        configuration_id=self._configuration_id,
                        rnd=self._crnd,
                        vval=chosen,
                    )
                )

    # -- acceptor -----------------------------------------------------------

    def handle_phase2a(self, msg: Phase2aMessage) -> None:
        """Acceptor: accept the value unless promised higher (Paxos.java:193-214)."""
        if msg.configuration_id != self._configuration_id:
            return
        if self._rnd <= msg.rnd and self._vrnd != msg.rnd:
            self._rnd = msg.rnd
            self._vrnd = msg.rnd
            self._vval = msg.vval
            self._broadcaster.broadcast(
                Phase2bMessage(
                    sender=self._my_addr,
                    configuration_id=self._configuration_id,
                    rnd=msg.rnd,
                    endpoints=msg.vval,
                )
            )

    def handle_phase2b(self, msg: Phase2bMessage) -> None:
        """Learner: decide once a majority voted in a rank (Paxos.java:221-236)."""
        if msg.configuration_id != self._configuration_id:
            return
        in_rnd = self._accept_responses.setdefault(msg.rnd, {})
        in_rnd[msg.sender] = msg
        if len(in_rnd) > self._n // 2 and not self._decided:
            self._decided = True
            if self._metrics is not None:
                self._metrics.incr("consensus.classic_decisions")
            if self._tracer is not None:
                self._tracer.event(
                    "classic_decision", round=msg.rnd.round,
                    votes=len(in_rnd),
                )
            self._on_decide(list(msg.endpoints))

    def register_fast_round_vote(self, vote: Proposal) -> None:
        """Record our fast-round (round 1) vote so phase1b responses reflect it
        (Paxos.java:244-258). No-op if already in a classic round."""
        if self._rnd.round > 1:
            return
        self._rnd = Rank(1, 1)
        self._vrnd = self._rnd
        self._vval = tuple(vote)

    # -- the coordinator value-pick rule ------------------------------------

    def select_proposal_using_coordinator_rule(
        self, phase1b_messages: List[Phase1bMessage]
    ) -> Proposal:
        """Fig. 2 of the Fast Paxos paper (Paxos.java:269-326).

        Let k = max vrnd over the quorum; V = the non-empty vvals voted at k.
        - if V has a single distinct value, choose it;
        - else if some value in V has more than N/4 votes, choose it;
        - else choose any reported non-empty vval (may be empty => wait).
        """
        if not phase1b_messages:
            raise ValueError("phase1b_messages was empty")
        max_vrnd = max(m.vrnd for m in phase1b_messages)
        collected_vvals: List[Proposal] = [
            m.vval for m in phase1b_messages if m.vrnd == max_vrnd and len(m.vval) > 0
        ]
        chosen: Optional[Proposal] = None
        if len(set(collected_vvals)) == 1:
            chosen = collected_vvals[0]
        elif len(collected_vvals) > 1:
            counters: Dict[Proposal, int] = {}
            for value in collected_vvals:
                count = counters.setdefault(value, 0)
                if count + 1 > self._n // 4:
                    chosen = value
                    break
                counters[value] = count + 1
        if chosen is None:
            chosen = next((m.vval for m in phase1b_messages if len(m.vval) > 0), ())
        return chosen
