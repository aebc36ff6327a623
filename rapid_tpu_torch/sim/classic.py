"""Classic Paxos recovery round with per-node acceptor state on the device.

The port of ``rapid_tpu/sim/classic.py``, whose module docstring maps it to
the reference (Paxos.java): the simulation plane's fallback when the fast
round stalls. The coordinator exchange is host-driven (phase1a broadcast,
phase1b responses, phase2a broadcast, phase2b tally), while every acceptor's
(rnd, vrnd, vval) lives in device tensors, so rank contention between
concurrent coordinators is resolved by the acceptors themselves.

Ranks are (round, node) pairs packed into int32 as ``round << RANK_BITS |
node``; the fast round is rank (1, 1), so every classic rank outranks it.
Recovery traffic rides the delivery-group fault plane and the latency plane
as alerts and votes do: an acceptor hears the coordinator's 1a/2a only over
an up delivery edge, and its response counts only if the coordinator's group
hears it by the majority cutoff.

Translation notes. ``.at[rows].add`` is an int32 ``index_add_``. The [P, P]
value-pooling products are elementwise sums (P is a handful of rows, and CUDA
has no integer matrix product). ``argmax`` runs on int32 and returns the
first maximum, as ``jnp.argmax`` does on bools. Each phase fetches its whole
summary in one device->host copy (``Phase1Summary.words``), so each phase
makes one host sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .engine import FAST_RANK, RANK_BITS, SimConfig, SimState


def make_rank(round_no: int, node: int) -> int:
    assert 2 <= round_no < (1 << (31 - RANK_BITS)), round_no
    assert 0 <= node < (1 << RANK_BITS), node
    return (round_no << RANK_BITS) | node


def _effective(state: SimState) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Acceptor state with the fast round folded in: a node that cast a fast
    vote holds rnd = vrnd = FAST_RANK, vval = its fast vote, unless a classic
    round already moved it further."""
    fast = state.voted.to(torch.int32) * FAST_RANK
    rnd = torch.maximum(state.classic_rnd, fast)
    vrnd = torch.maximum(state.classic_vrnd, fast)
    vval = torch.where(
        state.classic_vrnd >= fast, state.classic_vval,
        torch.where(state.voted, state.vote_prop, -1),
    )
    return rnd, vrnd, vval


class Phase1Summary(NamedTuple):
    """What the coordinator's phase1b inbox holds, on the host."""

    promised: int  # responders in the inbox (> N/2 needed)
    max_vrnd: int  # highest vrnd among voted responders (0 = none)
    at_max: np.ndarray  # int64[P] per-VALUE votes at max_vrnd (row-pooled)
    any_vval: np.ndarray  # int64[P] per-VALUE votes at any vrnd (row-pooled)
    rep: np.ndarray  # int64[P] canonical (lowest) row holding each row's value
    cutoff: int  # rounds until the quorum-closing response

    @staticmethod
    def words(promised, max_vrnd, cutoff, at_max, any_vval, rep) -> torch.Tensor:
        """The summary as one int64 word stream on the device: the three
        scalars, then the three [P] rows."""
        head = torch.stack([promised.long(), max_vrnd.long(), cutoff.long()])
        return torch.cat([head, at_max.long(), any_vval.long(), rep.long()])

    @classmethod
    def from_words(cls, words: np.ndarray, p: int) -> "Phase1Summary":
        return cls(
            promised=int(words[0]), max_vrnd=int(words[1]), cutoff=int(words[2]),
            at_max=words[3:3 + p], any_vval=words[3 + p:3 + 2 * p],
            rep=words[3 + 2 * p:3 + 3 * p],
        )


def _inbox_cutoff(
    config: SimConfig,
    responders: torch.Tensor,  # bool[C] responses that will eventually arrive
    resp_time: torch.Tensor,  # int32[C] per-acceptor response round-trip rounds
    n: torch.Tensor,  # membership size
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in_inbox, cutoff): the coordinator proceeds the round its (> N/2)-th
    response arrives (Paxos.java:160-190), so its inbox holds exactly the
    responses whose arrival time is <= that cutoff. With no quorum the
    cutoff is the last response's arrival (the phase fails on count). With
    zero delays every response takes 2 rounds: the flat four-hop exchange."""
    max_t = 2 + 2 * config.max_delivery_delay
    tvals = torch.arange(2, max_t + 1, dtype=torch.int32, device=responders.device)
    by_t = (responders[None, :] & (resp_time[None, :] <= tvals[:, None])).sum(dim=1)
    reached = by_t > n // 2
    # tvals[i] is 2 + i: computed, not indexed (a tensor index would be read
    # back to the host)
    first = reached.to(torch.int32).argmax().to(torch.int32)
    cutoff = torch.where(reached.any(), 2 + first, max_t)
    return responders & (resp_time <= cutoff), cutoff


def _pool(eq: torch.Tensor, per_row: torch.Tensor) -> torch.Tensor:
    """``eq @ per_row`` for the [P, P] 0/1 equality matrix: each row's count
    summed over the rows holding the same value."""
    return (eq * per_row[None, :]).sum(dim=1)


def phase1(
    config: SimConfig,
    state: SimState,
    rank: int,
    hears_coord: torch.Tensor,  # bool[C] acceptor hears the coordinator's 1a/2a
    coord_hears: torch.Tensor,  # bool[C] coordinator hears the acceptor's 1b/2b
    resp_time: torch.Tensor,  # int32[C] response round-trip (2 + both hop delays)
) -> Tuple[SimState, torch.Tensor]:
    """Phase1a broadcast + the aggregate of the phase1b responses.

    Every live acceptor that hears the broadcast and has ``rnd < rank``
    promises (bumps rnd) and reports its (vrnd, vval); only responses the
    coordinator's delivery group hears, arriving by the majority cutoff,
    enter the summary (Paxos.java:135-145,160-190). Votes are counted per
    value: proposal rows holding identical cut masks pool their counts, with
    ``rep`` naming each value's canonical row. Returns the state and the
    summary's words (``Phase1Summary.words``) on the device."""
    live = state.active & state.alive
    rnd, vrnd, vval = _effective(state)
    promise = live & hears_coord & (rank > rnd)
    classic_rnd = torch.where(promise, rank, state.classic_rnd)

    n = state.active.sum()
    heard, cutoff = _inbox_cutoff(config, promise & coord_hears, resp_time, n)
    has_vote = heard & (vrnd > 0) & (vval >= 0)
    max_vrnd = torch.where(has_vote, vrnd, 0).max()
    p = config.proposal_rows
    rows = vval.clamp(0, p - 1).long()
    zeros = torch.zeros(p, dtype=torch.int32, device=rows.device)
    at_max_row = zeros.index_add(0, rows, (has_vote & (vrnd == max_vrnd)).to(torch.int32))
    any_row = zeros.index_add(0, rows, has_vote.to(torch.int32))
    eq = (state.proposal[:, None, :] == state.proposal[None, :, :]).all(dim=2).to(torch.int32)
    words = Phase1Summary.words(
        heard.sum(), max_vrnd, cutoff, _pool(eq, at_max_row), _pool(eq, any_row),
        eq.argmax(dim=1),
    )
    return dataclasses.replace(state, classic_rnd=classic_rnd), words


def phase2(
    config: SimConfig,
    state: SimState,
    rank: int,
    row: int,
    hears_coord: torch.Tensor,
    coord_hears: torch.Tensor,
    resp_time: torch.Tensor,
) -> Tuple[SimState, torch.Tensor]:
    """Phase2a broadcast + the phase2b acceptance count.

    An acceptor that hears the broadcast accepts iff ``rnd <= rank`` and
    ``vrnd != rank`` (Paxos.java:205-213); more than N/2 acceptances decide
    (Paxos.java:229-236), counted from the coordinator's vantage. Returns the
    state and the words ``[acceptances in the inbox, cutoff rounds]`` on the
    device."""
    live = state.active & state.alive
    rnd, vrnd, _ = _effective(state)
    accept = live & hears_coord & (rank >= rnd) & (vrnd != rank)
    state = dataclasses.replace(
        state,
        classic_rnd=torch.where(accept, rank, state.classic_rnd),
        classic_vrnd=torch.where(accept, rank, state.classic_vrnd),
        classic_vval=torch.where(accept, row, state.classic_vval),
    )
    n = state.active.sum()
    in_inbox, cutoff = _inbox_cutoff(config, accept & coord_hears, resp_time, n)
    return state, torch.stack([in_inbox.sum(), cutoff.long()])


class ClassicCoordinator:
    """One coordinator's view of one classic round (host side of
    Paxos.java:97-132,160-236). Several may run concurrently against the same
    simulator; the shared device acceptor state arbitrates their rank
    contention."""

    def __init__(self, sim, round_no: int, slot: int) -> None:
        self.sim = sim
        self.slot = slot
        self.rank = make_rank(round_no, slot)
        self._summary: Optional[Phase1Summary] = None
        # recovery traffic rides the delivery-group fault plane: which
        # acceptors hear THIS coordinator's broadcasts, and whose responses
        # its own group hears
        deliver = sim._deliver  # noqa: SLF001 -- [G, C] host fault plane
        group_of = sim.group_of
        self._hears_coord = sim._tensor(deliver[group_of, slot])
        self._coord_hears = sim._tensor(deliver[group_of[slot], :])
        # ... and the latency plane: acceptor a's phase response arrives
        # 2 + delay[group(a), coord] + delay[group(coord), a] rounds after
        # the phase broadcast
        delay = sim._deliver_delay  # noqa: SLF001 -- [G, C] host fault plane
        self._resp_time = sim._tensor(
            (2 + delay[group_of, slot] + delay[group_of[slot], :]).astype(np.int32)
        )
        # rounds the exchange has billed so far (phase cutoffs; 4 with no
        # delays -- the flat 1a/1b/2a/2b hops)
        self.elapsed_rounds = 0

    def phase1(self) -> bool:
        """Run phase1a/1b; True iff a majority of the membership promised."""
        sim = self.sim
        sim.state, words = phase1(
            sim.config, sim.state, self.rank, self._hears_coord, self._coord_hears,
            self._resp_time,
        )
        # the phase's one sync  # devlint: sync-point
        self._summary = Phase1Summary.from_words(
            words.cpu().numpy(), sim.config.proposal_rows
        )
        self.elapsed_rounds += self._summary.cutoff
        return self._summary.promised > int(sim.active.sum()) // 2

    def pick_value(self) -> Optional[int]:
        """The Fig.-2 coordinator rule over the phase1b aggregate
        (Paxos.java:269-326), on value-pooled counts (canonical rows via
        ``rep``). Returns the chosen proposal row, or None when no responder
        reported a valid vote (the coordinator must not proceed)."""
        s = self._summary
        assert s is not None, "phase1 must run first"
        n = int(self.sim.active.sum())
        # distinct VALUES at the max vrnd, each named by its canonical row
        candidates = np.unique(s.rep[s.at_max > 0])
        if len(candidates) == 1:
            return int(candidates[0])
        if len(candidates) > 1:
            over = candidates[s.at_max[candidates] > n // 4]
            if len(over):
                return int(over[0])
        reported = np.unique(s.rep[s.any_vval > 0])
        if len(reported):
            return int(reported[0])
        return None

    def phase2(self, row: int) -> Optional[int]:
        """Run phase2a/2b for ``row``; returns the row iff a majority
        accepted (the decision), else None (outranked by a concurrent
        coordinator)."""
        sim = self.sim
        sim.state, words = phase2(
            sim.config, sim.state, self.rank, row, self._hears_coord,
            self._coord_hears, self._resp_time,
        )
        # the phase's one sync  # devlint: sync-point
        accepted, cutoff = (int(x) for x in words.cpu().numpy())
        self.elapsed_rounds += cutoff
        return row if accepted > int(sim.active.sum()) // 2 else None
