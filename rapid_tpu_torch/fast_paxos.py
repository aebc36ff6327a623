"""Leaderless Fast Paxos: one-step consensus by counting identical proposals.

The port's own copy of ``rapid_tpu/fast_paxos.py``, with one addition:
``handle_vote_batch`` tallies a transport's batch of identical votes at once.

Reference: FastPaxos.java. Every node broadcasts its cut proposal as a
fast-round phase2b vote; any node that observes >= N - F identical votes
(F = floor((N-1)/4), FastPaxos.java:145-150) decides in one step. A classic
Paxos round (round >= 2) is scheduled as fallback after a base delay plus an
exponentially distributed jitter with mean N seconds, so that cluster-wide
roughly one node per second starts a recovery round (FastPaxos.java:72-76,
200-203).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Set

from .messaging.base import IBroadcaster, IMessagingClient
from .observability import Metrics, Tracer
from .paxos import Paxos, Proposal
from .runtime.scheduler import ScheduledTask, Scheduler
from .types import (
    ConsensusResponse,
    Endpoint,
    FastRoundPhase2bMessage,
    FastRoundVoteBatch,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
)

BASE_DELAY_MS = 1000


class FastPaxos:  # guarded-by: protocol-executor
    def __init__(
        self,
        my_addr: Endpoint,
        configuration_id: int,
        membership_size: int,
        client: IMessagingClient,
        broadcaster: IBroadcaster,
        scheduler: Scheduler,
        on_decide: Callable[[List[Endpoint]], None],
        consensus_fallback_base_delay_ms: int = BASE_DELAY_MS,
        rng: Optional[random.Random] = None,
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        serialize: Optional[Callable[[Callable[[], None]], None]] = None,
    ) -> None:
        self._metrics = metrics
        self._tracer = tracer
        self._my_addr = my_addr
        self._configuration_id = configuration_id
        self._n = membership_size
        self._broadcaster = broadcaster
        self._scheduler = scheduler
        # Consensus state is protocol-executor confined; the classic-round
        # fallback timer fires on the scheduler thread in real deployments,
        # so it re-enters through this serializer (the service injects
        # protocol_executor.execute). Default: direct call, for the
        # single-threaded virtual plane and standalone tests.
        self._serialize = serialize if serialize is not None else (lambda fn: fn())
        self._base_delay_ms = consensus_fallback_base_delay_ms
        self._rng = rng if rng is not None else random.Random()
        # Mean of the expovariate jitter is N seconds => ~one classic-round
        # start per second cluster-wide (FastPaxos.java:72-76).
        self._jitter_rate = 1.0 / membership_size
        self._votes_per_proposal: Dict[Proposal, int] = {}
        self._votes_received: Set[Endpoint] = set()
        self._decided = False
        self._scheduled_classic_round: Optional[ScheduledTask] = None

        def on_decided_wrapped(hosts: List[Endpoint]) -> None:
            # A classic-round decision can arrive after a fast-round one (the
            # inner Paxos tracks its own decided flag); deliver only the first.
            if self._decided:
                return
            self._decided = True
            if self._scheduled_classic_round is not None:
                self._scheduled_classic_round.cancel()
            on_decide(hosts)

        self._on_decided_wrapped = on_decided_wrapped
        self._paxos = Paxos(
            my_addr, configuration_id, membership_size, client, broadcaster,
            on_decided_wrapped, metrics=metrics, tracer=tracer,
        )

    @property
    def decided(self) -> bool:
        return self._decided

    @property
    def votes_received(self) -> int:
        """Distinct fast-round voters tallied so far (introspection RPC)."""
        return len(self._votes_received)

    def propose(self, proposal: List[Endpoint], recovery_delay_ms: Optional[int] = None) -> None:
        """Vote for ``proposal`` in the fast round and schedule the classic-round
        fallback (FastPaxos.java:94-117)."""
        self._paxos.register_fast_round_vote(tuple(proposal))
        self._broadcaster.broadcast(
            FastRoundPhase2bMessage(
                sender=self._my_addr,
                configuration_id=self._configuration_id,
                endpoints=tuple(proposal),
            )
        )
        if recovery_delay_ms is None:
            recovery_delay_ms = self._random_delay_ms()
        self._scheduled_classic_round = self._scheduler.schedule(
            recovery_delay_ms, self._classic_round_fallback
        )

    def _handle_fast_round_proposal(self, msg: FastRoundPhase2bMessage) -> None:
        """Tally a fast-round vote; decide at the 3/4 supermajority
        (FastPaxos.java:125-156)."""
        if msg.configuration_id != self._configuration_id:
            return
        if msg.sender in self._votes_received:
            return
        if self._decided:
            return
        self._votes_received.add(msg.sender)
        if self._metrics is not None:
            self._metrics.incr("consensus.fast_round_votes")
        count = self._votes_per_proposal.get(msg.endpoints, 0) + 1
        self._votes_per_proposal[msg.endpoints] = count
        f = (self._n - 1) // 4  # Fast Paxos resiliency
        if len(self._votes_received) >= self._n - f:
            if count >= self._n - f:
                if self._metrics is not None:
                    self._metrics.incr("consensus.fast_decisions")
                if self._tracer is not None:
                    self._tracer.event("fast_decision", votes=count)
                self._on_decided_wrapped(list(msg.endpoints))
            # else: fast round may not succeed; fallback will recover

    def handle_vote_batch(self, batch: FastRoundVoteBatch) -> None:
        """Tally a batch of identical-value fast-round votes. The outcome
        equals one ``_handle_fast_round_proposal`` per sender in order (what
        ``rapid_tpu``'s service does): the same per-sender dedup, counter,
        decision point and ignored remainder. The proposal's tally is read
        and written once a batch instead of once a vote, since hashing the
        cut costs a Python ``__hash__`` per endpoint: a 100k swarm's quorum
        is ~75k votes of a ~1000-endpoint cut, minutes of hashing a vote at a
        time."""
        if batch.configuration_id != self._configuration_id or self._decided:
            return
        f = (self._n - 1) // 4  # Fast Paxos resiliency
        count = self._votes_per_proposal.get(batch.endpoints, 0)
        tallied = 0
        decided = False
        for sender in batch.senders:
            if sender in self._votes_received:
                continue
            self._votes_received.add(sender)
            tallied += 1
            count += 1
            if len(self._votes_received) >= self._n - f and count >= self._n - f:
                decided = True
                break
        if tallied:
            self._votes_per_proposal[batch.endpoints] = count
            if self._metrics is not None:
                self._metrics.incr("consensus.fast_round_votes", tallied)
        if decided:
            if self._metrics is not None:
                self._metrics.incr("consensus.fast_decisions")
            if self._tracer is not None:
                self._tracer.event("fast_decision", votes=count)
            self._on_decided_wrapped(list(batch.endpoints))

    def handle_messages(self, msg) -> ConsensusResponse:
        """Demux consensus messages (FastPaxos.java:163-184)."""
        if isinstance(msg, FastRoundPhase2bMessage):
            self._handle_fast_round_proposal(msg)
        elif isinstance(msg, Phase1aMessage):
            self._paxos.handle_phase1a(msg)
        elif isinstance(msg, Phase1bMessage):
            self._paxos.handle_phase1b(msg)
        elif isinstance(msg, Phase2aMessage):
            self._paxos.handle_phase2a(msg)
        elif isinstance(msg, Phase2bMessage):
            self._paxos.handle_phase2b(msg)
        else:
            raise TypeError(f"unexpected consensus message: {type(msg).__name__}")
        return ConsensusResponse()

    def _classic_round_fallback(self) -> None:
        # runs on the timer thread; hop back onto the protocol serializer
        # before touching consensus state
        self._serialize(self.start_classic_paxos_round)

    def start_classic_paxos_round(self) -> None:
        """Fallback entry: classic rounds start at round 2 (FastPaxos.java:189-195)."""
        if not self._decided:
            if self._metrics is not None:
                self._metrics.incr("consensus.classic_rounds_started")
            self._paxos.start_phase1a(2)

    def _random_delay_ms(self) -> int:
        """Base delay + Exp(jitter_rate) jitter in ms (FastPaxos.java:200-203)."""
        jitter = int(-1000 * math.log(1 - self._rng.random()) / self._jitter_rate)
        return jitter + self._base_delay_ms
