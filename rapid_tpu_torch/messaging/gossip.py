"""Gossip (epidemic) broadcaster: the IBroadcaster alternative the
reference anticipates but never ships. The port's own copy of
``rapid_tpu/messaging/gossip.py``.

``IBroadcaster.java:24-26`` names "gossip-based dissemination" as the
intended alternative to unicast-to-all; this is that implementation for the
native-codec transports. ``broadcast`` wraps the message in a
``GossipEnvelope`` (fresh 128-bit id, TTL ~ log2(N) + margin) and sends it
to the origin itself plus ``fanout`` random members; receivers relay with
TTL-1 and deliver the payload locally exactly once, deduping by envelope
id. Two relay disciplines:

- ``mode="eager"`` (default): blind-counter rumor mongering -- a node
  relays the full envelope on each of its first ``relay_budget`` sightings
  (not only the first), which lifts per-node delivery probability from
  ~1-e^-fanout to ~1-e^-(fanout*relay_budget) for a few extra relays, at
  ~fanout*relay_budget duplicate payload receptions per node.
- ``mode="pushpull"`` (anti-entropy): the full payload is relayed eagerly
  only on the FIRST sighting; later sightings (up to ``relay_budget``) send
  a tiny IHAVE advertisement instead. A node that sees an IHAVE for an id
  it has not received PULLs the payload from the advertiser, which answers
  from its recent-envelope store. Payload redundancy drops toward ~fanout
  receptions per node while the IHAVE/PULL legs recover the reliability the
  withheld duplicates provided -- the classic push-pull epidemic repair
  (the lazy-push/graft shape of Plumtree). Measured by
  experiments/message_load.py (table in BASELINE.md).

Per-broadcast cost at the origin drops from O(N) sends to O(fanout), traded
for relay traffic spread across the membership -- the standard epidemic
trade. The reference's own evaluation keeps unicast-to-all, so parity
defaults stay unchanged; this is opt-in via
``ClusterBuilder.set_broadcaster_factory``.

Delivery is probabilistic-complete, and the membership protocol tolerates
residual loss by design (the cut detector aggregates K independent
observers; consensus needs 3/4, not all, votes); the convergence tests
drive full cut/join cycles over both modes to pin that end-to-end.
"""

from __future__ import annotations

import math
import random
import time
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

from ..observability import (
    current_trace_context,
    stamp_trace_context,
    trace_context_of,
)
from ..runtime.futures import Promise
from ..settings import Settings
from ..types import Endpoint, GossipEnvelope, NodeId, RapidMessage
from .base import IBroadcaster, IMessagingClient
from .unicast import make_batching_sink

# Dedup memory is bounded by BOTH a size floor and an age floor: an entry is
# only evicted once the table exceeds the cap AND the entry is older than
# _SEEN_MIN_AGE_S (a generous bound on how long an envelope can still be
# circulating: TTL relay hops at network latency). Evicting a still-live
# envelope would make it look first-seen again -- duplicate local delivery
# plus a fresh relay budget (traffic amplification). Under sustained load the
# table therefore grows to (broadcast rate x age window), the correct bound,
# instead of silently re-admitting live envelopes. The cap also scales with
# membership so big clusters (more concurrent broadcasts) get more room.
_SEEN_CAP = 8192
_SEEN_MIN_AGE_S = 30.0
_PULL_RETRY_S = 1.0  # re-pull an unanswered id on a fresh IHAVE after this


class GossipBroadcaster(IBroadcaster):
    def __init__(
        self,
        client: IMessagingClient,
        my_addr: Endpoint,
        fanout: int = 4,
        relay_budget: int = 2,
        ttl: Optional[int] = None,
        rng: Optional[random.Random] = None,
        mode: str = "eager",
        settings: Optional[Settings] = None,
        scheduler=None,
    ) -> None:
        assert mode in ("eager", "pushpull"), mode
        self._client = client
        self._my_addr = my_addr
        # flush-window coalescing of outbound envelopes (one MessageBatch
        # per peer per window) when Settings.broadcast_flush_window_ms > 0;
        # None keeps the legacy send-per-envelope path
        self._sink = make_batching_sink(client, my_addr, scheduler, settings)
        self._fanout = fanout
        self._relay_budget = relay_budget
        self._ttl_override = ttl
        self._rng = rng if rng is not None else random.Random()
        self._mode = mode
        self._members: List[Endpoint] = []
        self._others: List[Endpoint] = []  # cached non-self peer pool
        # envelope id -> (sightings so far, first-seen monotonic time,
        # stored relay envelope for answering pulls -- pushpull mode only);
        # insertion order == age order, so eviction pops from the front
        self._seen: "OrderedDict[Tuple[int, int], Tuple[int, float, Optional[GossipEnvelope]]]" = (
            OrderedDict()
        )
        # ids pulled but not yet received (id -> request monotonic time);
        # bounds repeat pulls while an answer is in flight
        self._pending_pulls: dict = {}
        # pushpull payload store keys, oldest first: the age-guarded _seen
        # eviction lets the TABLE grow under sustained load, but full
        # payloads must not grow with it (rate x 30 s of envelopes is a
        # large amplification over the int-per-id table). The hard payload
        # ceiling drops stored envelopes oldest-first (entry payload ->
        # None) while KEEPING the dedup key, so dedup safety is unaffected
        # and pulls for dropped payloads stay best-effort (unanswered, the
        # puller retries against a fresher advertiser).
        # (key, store generation) in store order. A key may appear more than
        # once (stored, nulled, re-stored): the generation stamps which
        # store a deque slot refers to, so only the LIVE generation's slot
        # can evict a payload -- re-seen ids evict oldest-first instead of
        # a stale slot nulling the fresh payload.
        self._payload_keys: "deque[Tuple[Tuple[int, int], int]]" = deque()
        self._payload_gen: dict = {}  # key -> generation of its live payload
        self._gen = 0
        self._stored_payloads = 0  # LIVE stored envelopes

    # -- IBroadcaster --------------------------------------------------------

    def set_membership(self, recipients: List[Endpoint]) -> None:
        self._members = list(recipients)
        # membership changes only at view changes; relays are per-message --
        # cache the non-self peer pool so each send is O(fanout), not O(N)
        self._others = [m for m in self._members if m != self._my_addr]

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        """Send to self + ``fanout`` random members; relays do the rest. The
        origin's own copy arrives through the transport like everyone
        else's (UnicastToAllBroadcaster's self-delivery semantics)."""
        # trace injection mirrors the unicast broadcaster, but the codec only
        # carries the TOP-LEVEL message's context -- so the wrapping envelope
        # (not just the payload) must wear the stamp to survive serialization
        if trace_context_of(msg) is None:
            stamp_trace_context(msg, current_trace_context())
        env = GossipEnvelope(
            sender=self._my_addr,
            gossip_id=NodeId(
                self._rng.getrandbits(64) - (1 << 63),
                self._rng.getrandbits(64) - (1 << 63),
            ),
            ttl=self._ttl(),
            payload=msg,
        )
        stamp_trace_context(env, trace_context_of(msg))
        return self._send(env, include_self=True)

    # -- relay plane ---------------------------------------------------------

    def receive(self, env: GossipEnvelope) -> Optional[RapidMessage]:
        """Called by the membership service for every inbound envelope.

        PAYLOAD frames: relays on each of the first ``relay_budget``
        sightings (TTL-1 to ``fanout`` random members) -- the full envelope
        every time in eager mode, the full envelope on the first sighting
        and tiny IHAVE advertisements afterwards in pushpull mode; returns
        the payload for local delivery on the FIRST sighting only, None
        afterwards. IHAVE/PULL frames run the anti-entropy repair and never
        deliver locally."""
        if env.kind == GossipEnvelope.KIND_IHAVE:
            self._on_ihave(env)
            return None
        if env.kind == GossipEnvelope.KIND_PULL:
            self._on_pull(env)
            return None
        key = (env.gossip_id.high, env.gossip_id.low)
        now = time.monotonic()
        self._pending_pulls.pop(key, None)
        prior = self._seen.get(key)
        sightings, first_seen = (prior[0], prior[1]) if prior else (0, now)
        # the inbound envelope carried the trace over the wire; put it back on
        # the payload so local delivery sees it, and keep it on every derived
        # envelope (relay, stored pull-answer) so downstream hops inherit it
        ctx = trace_context_of(env)
        if ctx is not None and trace_context_of(env.payload) is None:
            stamp_trace_context(env.payload, ctx)
        relay: Optional[GossipEnvelope] = None
        if sightings < self._relay_budget and env.ttl > 0:
            relay = GossipEnvelope(
                sender=self._my_addr,
                gossip_id=env.gossip_id,
                ttl=env.ttl - 1,
                payload=env.payload,
            )
            stamp_trace_context(relay, ctx)
        # pushpull answers later pulls from this store; eager never pulls
        stored = None
        if self._mode == "pushpull":
            stored = prior[2] if prior else None
            if stored is None:
                if relay is not None:
                    stored = relay
                else:
                    stored = GossipEnvelope(
                        sender=self._my_addr, gossip_id=env.gossip_id, ttl=0,
                        payload=env.payload,
                    )
                    stamp_trace_context(stored, ctx)
        if key in self._seen:  # preserve age order: do not move to the end
            self._seen[key] = (sightings + 1, first_seen, stored)
        else:
            self._seen[key] = (1, first_seen, stored)
        if stored is not None and (prior is None or prior[2] is None):
            self._gen += 1
            self._payload_gen[key] = self._gen
            self._payload_keys.append((key, self._gen))
            self._stored_payloads += 1
        cap = max(_SEEN_CAP, 4 * len(self._members))
        while len(self._seen) > cap:
            _, entry = next(iter(self._seen.items()))
            if now - entry[1] < _SEEN_MIN_AGE_S:
                break  # everything old enough is gone; let the table grow
            evicted_key, evicted = self._seen.popitem(last=False)
            if evicted[2] is not None:
                self._stored_payloads -= 1
                self._payload_gen.pop(evicted_key, None)
        # compact the deque head: slots whose generation is no longer live
        # (entry left _seen via age eviction, or was re-stored under a newer
        # generation) are dead weight -- without this the deque grows without
        # bound under sustained age-based turnover
        while self._payload_keys and (
            self._payload_gen.get(self._payload_keys[0][0])
            != self._payload_keys[0][1]
        ):
            self._payload_keys.popleft()
        # hard payload ceiling, counted over LIVE stored envelopes: only the
        # slot carrying a key's live generation may null its payload, so a
        # re-stored id keeps its fresh payload until its own turn comes up
        # oldest-first
        while self._stored_payloads > cap and self._payload_keys:
            stale_key, gen = self._payload_keys.popleft()
            if self._payload_gen.get(stale_key) != gen:
                continue  # superseded or already evicted
            entry = self._seen.get(stale_key)
            del self._payload_gen[stale_key]
            if entry is not None and entry[2] is not None:
                self._seen[stale_key] = (entry[0], entry[1], None)
                self._stored_payloads -= 1
        if relay is not None:
            if self._mode == "pushpull" and sightings > 0:
                # anti-entropy: advertise instead of re-pushing the payload
                ihave = GossipEnvelope(
                    sender=self._my_addr,
                    gossip_id=env.gossip_id,
                    ttl=env.ttl - 1,
                    kind=GossipEnvelope.KIND_IHAVE,
                )
                self._send(ihave, include_self=False)
            else:
                self._send(relay, include_self=False)
        return env.payload if sightings == 0 else None

    def _on_ihave(self, env: GossipEnvelope) -> None:
        """An advertisement: pull the payload from the advertiser iff the id
        is unseen and no pull is already in flight (re-pull after a timeout,
        so a lost answer is repaired by the next advertisement)."""
        key = (env.gossip_id.high, env.gossip_id.low)
        if key in self._seen:
            return
        now = time.monotonic()
        asked = self._pending_pulls.get(key)
        if asked is not None and now - asked < _PULL_RETRY_S:
            return
        if len(self._pending_pulls) > _SEEN_CAP:
            self._pending_pulls.clear()  # stale flood; repairs re-request
        self._pending_pulls[key] = now
        pull = GossipEnvelope(
            sender=self._my_addr,
            gossip_id=env.gossip_id,
            ttl=0,
            kind=GossipEnvelope.KIND_PULL,
        )
        self._client.send_message_best_effort(env.sender, pull)

    def _on_pull(self, env: GossipEnvelope) -> None:
        """Answer a pull from the recent-envelope store (best effort: an
        evicted or never-stored id is simply not answered; the puller
        retries on the next advertisement)."""
        key = (env.gossip_id.high, env.gossip_id.low)
        entry = self._seen.get(key)
        if entry is None or entry[2] is None:
            return
        self._client.send_message_best_effort(env.sender, entry[2])

    # -- internals -----------------------------------------------------------

    def _ttl(self) -> int:
        if self._ttl_override is not None:
            return self._ttl_override
        n = max(len(self._members), 2)
        return int(math.ceil(math.log2(n))) + 2

    def _peers(self) -> List[Endpoint]:
        if len(self._others) <= self._fanout:
            return self._others
        return self._rng.sample(self._others, self._fanout)

    def _send(self, env: GossipEnvelope, include_self: bool) -> List[Promise]:
        targets = self._peers()
        if include_self:
            targets = [self._my_addr] + targets
        if self._sink is not None:
            for t in targets:
                self._sink.offer(t, env)
            return []  # fire-and-forget; flushed after the window
        return [
            self._client.send_message_best_effort(t, env) for t in targets
        ]
