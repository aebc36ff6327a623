"""Device-side data plane: the protocol round step, in PyTorch.

The port of ``rapid_tpu/sim/engine.py``. Each simulated round
1. evaluates every monitoring edge's probe under one of two FD policies: the
   reference code's cumulative failure counter, threshold 10
   (PingPongFailureDetector.java:40,69-77), or the paper's window, an edge
   faulty once at least a fraction of its last W probes failed (atc-2018
   section 6), and
2. routes newly-crossed edges as DOWN alerts along the observer->subject
   adjacency (MembershipService.java:602-626), both in the hand-written CUDA
   kernel ``kernels.fd_phase_fused`` on the scan path,
3. updates per-destination H/L watermark report tables and applies one
   implicit-invalidation pass (MultiNodeCutDetector.java:76-164),
4. tallies fast-round votes and decides at the 3/4 supermajority
   (FastPaxos.java:145-150).

Delivery groups, heterogeneous delivery delay and the per-node vote hop are
as in the JAX engine, whose module docstring describes them.

All state lives in capacity-padded tensors, in frozen dataclasses, with the
JAX engine's dtypes except ``fd_hist`` (int32 here: PyTorch lacks shifts and
comparisons on uint16). ``subjects`` and ``observers`` stay int32 for parity;
the FD kernel reads them as they are, and the torch gathers use int64 copies
made once per dispatch.

Where JAX exits a ``while_loop`` on the device, eager PyTorch cannot without a
host sync. So a dispatch runs its whole round budget, and a round after the
decision (or, in the closed form, before the fast-forward start) is a masked
no-op, exactly as ``step`` masks after a decision. The host syncs once per
dispatch, on the packed decision words.

Random ingress loss draws from the state's key as JAX's engine does:
threefry-2x32, split every round that is not masked, then a uniform
``[C, K]`` block from the probe half, in the hand-written CUDA kernel
``kernels.threefry_draw`` (``sim/threefry.py`` is its plain version). The
bits are JAX's, so lossy runs match the JAX engine round for round.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import kernels, threefry
from .topology import VirtualCluster, build_adjacency


@dataclass(frozen=True)
class SimConfig:
    """Static protocol parameters: the fields and checks of the JAX engine's
    ``SimConfig`` (``rapid_tpu/sim/engine.py``, where each is documented)."""

    capacity: int
    k: int = 10
    h: int = 9
    l: int = 4
    fd_threshold: int = 10  # PingPongFailureDetector.FAILURE_THRESHOLD
    fd_interval_ms: int = 1000  # MembershipService.java:77
    batching_window_ms: int = 100  # MembershipService.java:75
    rounds_per_interval: int = 1
    groups: int = 1  # delivery classes (heterogeneous broadcast delivery)
    fd_policy: str = "cumulative"
    fd_window: int = 10
    fd_window_threshold: float = 0.4
    fd_gray_confirm: int = 0
    fd_gray_warmup: int = 3
    extern_proposals: int = 0
    forensics: bool = False
    max_delivery_delay: int = 0

    def __post_init__(self) -> None:
        assert self.fd_policy in ("cumulative", "windowed"), (
            f"fd_policy must be 'cumulative' or 'windowed', got "
            f"{self.fd_policy!r}"
        )
        assert 1 <= self.fd_window <= 16, (
            f"fd_window must be in [1, 16] (window bitmask is uint16), got "
            f"{self.fd_window}"
        )
        assert 1 <= self.fd_threshold <= 255, (
            f"fd_threshold must be in [1, 255] (the per-edge failure counter "
            f"is uint8 and saturates at 255, so a larger threshold would "
            f"never fire), got {self.fd_threshold}"
        )
        assert 0 <= self.fd_gray_confirm <= 255, (
            f"fd_gray_confirm must be in [0, 255] (uint8 streak counter; "
            f"0 disables), got {self.fd_gray_confirm}"
        )
        assert 1 <= self.fd_gray_warmup <= 255, (
            f"fd_gray_warmup must be in [1, 255] (uint8 success counter), "
            f"got {self.fd_gray_warmup}"
        )
        assert self.fd_gray_confirm == 0 or self.fd_policy == "cumulative", (
            "the gray streak path mirrors the adaptive detector on top of "
            "the cumulative policy only"
        )

    @property
    def proposal_rows(self) -> int:
        return self.groups + self.extern_proposals


# Classic-Paxos rank packing: rank = round << RANK_BITS | node; the fast round
# is rank (1, 1) (registerFastRoundVote, Paxos.java:244-258), so every classic
# rank outranks it.
RANK_BITS = 21
FAST_RANK = (1 << RANK_BITS) | 1

_NEVER = 0x7FFFFFFF  # int32 "no such round"
_U32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a GPU, a caller that did not ask for the CPU gets an
    error, never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class SimState:
    """Per-round protocol state (tensors on one device): the JAX
    ``SimState``, field for field."""

    active: torch.Tensor  # bool[C] current membership
    alive: torch.Tensor  # bool[C] fault-model liveness (crashed => False)
    group_of: torch.Tensor  # int32[C] delivery group of each node
    subjects: torch.Tensor  # int32[C, K] monitored node per ring
    observers: torch.Tensor  # int32[C, K] monitoring node per ring
    fd_fail: torch.Tensor  # uint8[C, K] cumulative failed probes, saturating
    fd_hist: torch.Tensor  # int32[C, K] last-W probe outcomes (JAX: uint16)
    fd_seen: torch.Tensor  # uint8[C, K] probes recorded, saturating at W
    fd_streak: torch.Tensor  # uint8[C, K] consecutive failed probes (gray)
    fd_ok: torch.Tensor  # uint8[C, K] successful probes, saturating at 255
    alerted: torch.Tensor  # bool[C, K] edge already reported DOWN
    reports: torch.Tensor  # bool[G, C, K] per-group report tables (dst, ring)
    arrival_hist: torch.Tensor  # bool[Dmax, C, K] DOWN alerts aged 1..Dmax
    seen_down: torch.Tensor  # bool[G] group saw a DOWN alert this configuration
    announced: torch.Tensor  # bool[P] proposal row holds an announced value
    announced_round: torch.Tensor  # int32[] round of the first announcement
    proposal: torch.Tensor  # bool[P, C] latched proposal masks
    auto_vote: torch.Tensor  # bool[C] slot casts its own votes
    voted: torch.Tensor  # bool[C] fast-round per-sender dedup latch
    vote_prop: torch.Tensor  # int32[C] proposal row each voter voted for
    vote_new: torch.Tensor  # bool[C] votes cast this round, arriving next round
    vote_hist: torch.Tensor  # bool[Dmax, C] votes in flight, cast 2+d rounds ago
    votes_recv: torch.Tensor  # bool[G, C] votes received per (group, sender)
    classic_rnd: torch.Tensor  # int32[C] highest rank promised (phase1a)
    classic_vrnd: torch.Tensor  # int32[C] rank last accepted at (phase2a)
    classic_vval: torch.Tensor  # int32[C] accepted proposal row (-1 = none)
    decided: torch.Tensor  # bool[] consensus reached
    decided_group: torch.Tensor  # int32[] proposal row whose value won
    decided_round: torch.Tensor  # int32[] round at which decision happened
    round: torch.Tensor  # int32[] rounds elapsed in this configuration
    rng_key: torch.Tensor  # int64[2] JAX's uint32 key words (threefry.prng_key)


@dataclass(frozen=True)
class RoundInputs:
    """Per-round fault-plane inputs (constant over a dispatch)."""

    alive: torch.Tensor  # bool[C] liveness this round
    probe_drop: torch.Tensor  # bool[C, K] deterministic probe drops (one-way loss)
    drop_prob: torch.Tensor  # float32[C] random ingress-loss probability per dst
    join_reports: torch.Tensor  # bool[C, K] UP-alert reports for joining slots
    down_reports: torch.Tensor  # bool[C, K] proactive DOWN reports (graceful leave)
    deliver: torch.Tensor  # bool[G, C] does group g hear broadcasts from node i
    deliver_delay: torch.Tensor  # int32[G, C] broadcast latency (rounds) per edge


_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def state_from_numpy(
    config: SimConfig, arrays: Dict[str, np.ndarray], device=None
) -> SimState:
    """A JAX ``SimState``, given as numpy arrays keyed by field name, as the
    port's ``SimState`` on ``device``. ``fd_hist`` is widened from uint16 to
    int32 and ``rng_key``'s uint32 words to int64."""
    dev = resolve_device(device)
    fields = {}
    for name in _FIELDS:
        arr = np.asarray(arrays[name])
        if name == "fd_hist":
            arr = arr.astype(np.int32)
        elif name == "rng_key":
            arr = arr.astype(np.int64)
        fields[name] = torch.from_numpy(np.array(arr)).to(dev)
    state = SimState(**fields)
    c, k, g, p = config.capacity, config.k, config.groups, config.proposal_rows
    want = {"fd_fail": (c, k), "reports": (g, c, k), "proposal": (p, c),
            "arrival_hist": (config.max_delivery_delay, c, k), "rng_key": (2,)}
    for name, shape in want.items():
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"{name} has shape {tuple(getattr(state, name).shape)}, "
                             f"the config needs {shape}")
    return state


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``, in the JAX engine's dtypes."""
    # a snapshot's copy, off the round loop  # devlint: sync-point
    out = {name: getattr(state, name).cpu().numpy() for name in _FIELDS}
    out["fd_hist"] = out["fd_hist"].astype(np.uint16)
    out["rng_key"] = out["rng_key"].astype(np.uint32)
    return out


def _fresh_fields(config: SimConfig, dev: torch.device) -> dict:
    """Every field of a fresh configuration's state that does not depend on
    the membership: counters, latches and tallies at zero."""
    c, k, g, d = config.capacity, config.k, config.groups, config.max_delivery_delay
    p = config.proposal_rows

    def zeros(shape, dtype=torch.bool):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scalar():  # filled on the device: no host->device copy
        return torch.zeros((), dtype=torch.int32, device=dev)

    return dict(
        fd_fail=zeros((c, k), torch.uint8),
        fd_hist=zeros((c, k), torch.int32),
        fd_seen=zeros((c, k), torch.uint8),
        fd_streak=zeros((c, k), torch.uint8),
        fd_ok=zeros((c, k), torch.uint8),
        alerted=zeros((c, k)),
        reports=zeros((g, c, k)),
        arrival_hist=zeros((d, c, k)),
        seen_down=zeros(g),
        announced=zeros(p),
        announced_round=scalar(),
        proposal=zeros((p, c)),
        voted=zeros(c),
        vote_prop=zeros(c, torch.int32),
        vote_new=zeros(c),
        vote_hist=zeros((d, c)),
        votes_recv=zeros((g, c)),
        classic_rnd=zeros(c, torch.int32),
        classic_vrnd=zeros(c, torch.int32),
        classic_vval=torch.full((c,), -1, dtype=torch.int32, device=dev),
        decided=zeros(()),
        decided_group=scalar(),
        decided_round=scalar(),
        round=scalar(),
    )


def initial_state(
    config: SimConfig,
    cluster: VirtualCluster,
    active: np.ndarray,
    seed: int = 0,
    group_of: Optional[np.ndarray] = None,
    device=None,
) -> SimState:
    """Fresh-configuration state from the host adjacency build, its key
    ``PRNGKey(seed)``."""
    dev = resolve_device(device)
    subjects, observers = build_adjacency(cluster, active)
    c = config.capacity
    if group_of is None:
        group_of = np.zeros(c, dtype=np.int32)
    active_t = torch.as_tensor(np.asarray(active, dtype=bool), device=dev)
    return SimState(
        active=active_t,
        alive=active_t.clone(),
        group_of=torch.as_tensor(np.asarray(group_of, dtype=np.int32), device=dev),
        subjects=torch.as_tensor(subjects, device=dev),
        observers=torch.as_tensor(observers, device=dev),
        auto_vote=torch.ones(c, dtype=torch.bool, device=dev),
        rng_key=threefry.prng_key(seed, dev),
        **_fresh_fields(config, dev),
    )


def _select(cond: torch.Tensor, if_true: SimState, if_false: SimState) -> SimState:
    """``where(cond, if_true, if_false)`` field by field; a field both states
    share is passed through without a copy."""
    out = {}
    for name in _FIELDS:
        a, b = getattr(if_true, name), getattr(if_false, name)
        out[name] = a if a is b else torch.where(cond, a, b)
    return SimState(**out)


def route_and_tally(
    config: SimConfig,
    state: SimState,
    down_arrivals: torch.Tensor,  # bool[C, K] dst-indexed DOWN alert arrivals
    inputs: RoundInputs,
    active: torch.Tensor,
    alive: torch.Tensor,
    *,
    uniform_delivery: bool = False,
    observers_idx: Optional[torch.Tensor] = None,
    stop_after_cut: bool = False,
) -> SimState:
    """Alert delivery, per-group cut detection, per-node vote casting, the
    vote delivery hop, and the fast-round tally.

    ``down_arrivals[d, k]`` is the (dst, ring)-indexed view of this round's
    DOWN alerts; the sender of the (d, k) alert is ``observers[d, k]``. Each
    delivery group receives an alert iff its ``deliver[g, sender]`` entry is
    set. ``uniform_delivery`` skips the [G, C, K] deliver gather when every
    broadcast reaches every group. ``observers_idx`` is ``state.observers``
    as int64, when the caller already holds it.

    The JAX version's ``gate_implicit`` skips the implicit-invalidation pass
    with a ``lax.cond`` in rounds where the pass is the identity. Eager
    PyTorch cannot branch on device data without a host sync, so here the
    pass always runs; the result is the same.

    ``stop_after_cut`` returns right after proposal emission with the
    vote/tally fields untouched: the cut-detector phase boundary that the
    profiling plane's shadow attribution times against
    (``profiling/phases.py``); no dispatch path uses it.

    Returns ``state`` with the tally-owned fields replaced; the caller layers
    the FD fields and the round increment on top.
    """
    c, k, g = config.capacity, config.k, config.groups
    p_rows, dmax = config.proposal_rows, config.max_delivery_delay
    dev = down_arrivals.device
    sender = state.observers.long() if observers_idx is None else observers_idx
    arrival_hist = state.arrival_hist
    if dmax > 0:
        # an alert fired d rounds ago sits in hist[d]; group g reads the slot
        # its (group, sender) delay names, so each alert reaches each group
        # exactly once, at fire + delay. Join reports stay delay-0.
        hist = torch.cat([down_arrivals[None], arrival_hist], dim=0)
        arrival_hist = hist[:dmax]
        delay_gck = inputs.deliver_delay[:, sender].long()  # [G, C, K]
        c_idx = torch.arange(c, dtype=torch.int64, device=dev)[None, :, None]
        k_idx = torch.arange(k, dtype=torch.int64, device=dev)[None, None, :]
        arrived = hist[delay_gck, c_idx, k_idx]  # [G, C, K]
        joins = inputs.join_reports[None, :, :]
        if not uniform_delivery:
            deliver = inputs.deliver[:, sender]  # [G, C, K]
            arrived = arrived & deliver
            joins = joins & deliver
        reports = state.reports | arrived | joins
        seen_down = state.seen_down | arrived.flatten(1).any(dim=1)
    elif uniform_delivery:
        arrivals = down_arrivals | inputs.join_reports
        reports = state.reports | arrivals[None, :, :]
        seen_down = state.seen_down | down_arrivals.any()
    else:
        arrivals = down_arrivals | inputs.join_reports
        deliver = inputs.deliver[:, sender]  # [G, C, K]
        reports = state.reports | (arrivals[None, :, :] & deliver)
        seen_down = state.seen_down | (
            down_arrivals[None, :, :] & deliver
        ).flatten(1).any(dim=1)

    # --- per-group cut detection: H/L watermarks ---------------------------
    counts = reports.sum(dim=2)  # [G, C]
    in_flux = (counts >= config.l) & (counts < config.h)
    stable = counts >= config.h
    # one implicit-invalidation pass (MultiNodeCutDetector.java:137-164):
    # edges from observers that are themselves in flux or stable count as
    # implicit reports
    obs_fs = (in_flux | stable)[:, sender]  # [G, C, K]
    implicit = seen_down[:, None, None] & in_flux[:, :, None] & obs_fs & ~reports
    reports = reports | implicit
    counts = reports.sum(dim=2)
    in_flux = (counts >= config.l) & (counts < config.h)
    stable = counts >= config.h

    # --- proposal emission per group ---------------------------------------
    announced_g = state.announced[:g]
    emit = stable.any(dim=1) & ~in_flux.any(dim=1) & ~announced_g
    announced = torch.cat([announced_g | emit, state.announced[g:]])
    proposal = torch.cat(
        [torch.where(emit[:, None], stable, state.proposal[:g]), state.proposal[g:]]
    )
    announced_round = torch.where(
        (state.announced_round == 0) & announced.any(),
        state.round + 1,
        state.announced_round,
    )
    if stop_after_cut:
        return dataclasses.replace(
            state,
            reports=reports,
            arrival_hist=arrival_hist,
            seen_down=seen_down,
            announced=announced,
            announced_round=announced_round,
            proposal=proposal,
        )

    # --- per-node fast-round votes (FastPaxos.java:125-156) ----------------
    live = active & alive
    new_voters = (
        live & state.auto_vote & announced[state.group_of.long()] & ~state.voted
        & (state.classic_rnd < FAST_RANK)
    )
    voted = state.voted | new_voters
    vote_prop = torch.where(new_voters, state.group_of, state.vote_prop)

    # the vote broadcast is a delivery hop: votes cast last round arrive now
    vote_hist = state.vote_hist
    if dmax > 0:
        vhist = torch.cat([state.vote_new[None], vote_hist], dim=0)
        vote_hist = vhist[:dmax]
        c_idx = torch.arange(c, dtype=torch.int64, device=dev)[None, :]
        arrived_votes = vhist[inputs.deliver_delay.long(), c_idx]  # [G, C]
        if not uniform_delivery:
            arrived_votes = arrived_votes & inputs.deliver
        votes_recv = state.votes_recv | arrived_votes
    elif uniform_delivery:
        votes_recv = state.votes_recv | state.vote_new[None, :]
    else:
        votes_recv = state.votes_recv | (state.vote_new[None, :] & inputs.deliver)

    # --- tally, per receiving group ----------------------------------------
    # counts[g, q] = votes group g has received for proposal row q, as an
    # explicit [G, C] x [C, P] product. In float32 because CUDA has no
    # integer matmul; it is exact: the operands are 0/1 (exact even in TF32
    # or bf16) and every partial sum is an integer <= C < 2^24.
    onehot = (
        (vote_prop[:, None] == torch.arange(p_rows, dtype=torch.int32, device=dev)[None, :])
        & voted[:, None]
    )  # [C, P]
    counts = (votes_recv.float() @ onehot.float()).long()  # [G, P]
    eq = (proposal[:, None, :] == proposal[None, :, :]).all(dim=2)  # [P, P]
    pool = (eq & announced[:, None]).long()
    pooled = (counts[:, :, None] * pool[None, :, :]).sum(dim=1)  # [G, P]
    n = active.sum()
    quorum = n - (n - 1) // 4
    qualifies = announced[None, :] & (pooled >= quorum)
    decide_now = qualifies.any() & ~state.decided
    best = torch.where(qualifies, pooled, -1).amax(dim=0)  # [P]
    winner = best.argmax().to(torch.int32)
    return dataclasses.replace(
        state,
        reports=reports,
        arrival_hist=arrival_hist,
        seen_down=seen_down,
        announced=announced,
        announced_round=announced_round,
        proposal=proposal,
        voted=voted,
        vote_prop=vote_prop,
        vote_new=new_voters,
        vote_hist=vote_hist,
        votes_recv=votes_recv,
        decided=state.decided | decide_now,
        decided_group=torch.where(decide_now, winner, state.decided_group),
        decided_round=torch.where(decide_now, state.round + 1, state.decided_round),
    )


def probe_phases(config: SimConfig, device=None) -> torch.Tensor:
    """Each node's fixed probe phase within the FD interval ([C] int32 in
    [0, rounds_per_interval)): the JAX engine's uint32 Knuth multiplicative
    hash of the node index."""
    return kernels.probe_phases(
        config.capacity, config.rounds_per_interval, resolve_device(device)
    )


def window_params(config: SimConfig) -> Tuple[int, int, int]:
    """(window size W, firing threshold t, bitmask) of the windowed policy --
    the JAX engine's ``_window_params``, with its float64 rounding of t,
    computed once on the host; the kernel receives t as an integer."""
    w = config.fd_window
    t = int(np.ceil(config.fd_window_threshold * w))
    return w, t, (1 << w) - 1


def window_step(
    config: SimConfig,
    hist: torch.Tensor,  # int32[., K] last-W probe outcomes (JAX: uint16)
    seen: torch.Tensor,  # uint8[., K] probes recorded, saturating at W
    probed: torch.Tensor,  # bool[., K] a probe was recorded on this edge
    fail_event: torch.Tensor,  # bool[., K] the recorded probe failed
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One recorded-probe update of the sliding window, returning ``(hist,
    seen, crossed)``: the paper policy's firing rule (an edge is faulty when
    at least ``fd_window_threshold`` of its last ``fd_window`` recorded
    probes failed, once a full window has been recorded), shared by the scan
    step's plain version and the closed form. The population count is a
    SWAR count (``kernels.popcount16``)."""
    w, t, _ = window_params(config)
    return kernels.window_update(hist, seen, probed, fail_event, w, t)


def windowed_fd_phase(
    config: SimConfig,
    state: SimState,
    probed: torch.Tensor,
    fail_event: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-round windowed FD phase over ``SimState``: ``window_step``
    plus the one-shot alert latch. ``fd_fail`` is not touched. Returns
    ``(fd_hist, fd_seen, new_down)``."""
    fd_hist, fd_seen, crossed = window_step(
        config, state.fd_hist, state.fd_seen, probed, fail_event
    )
    return fd_hist, fd_seen, crossed & ~state.alerted


def fd_kernel_policy(config: SimConfig) -> dict:
    """The FD kernels' policy keywords for ``config``: the counter's
    threshold and gray path, the probe phases, and the window (0 under the
    cumulative policy)."""
    window, fire = 0, 0
    if config.fd_policy == "windowed":
        window, fire, _ = window_params(config)
    return dict(threshold=config.fd_threshold, gray_confirm=config.fd_gray_confirm,
                gray_warmup=config.fd_gray_warmup,
                rounds_per_interval=config.rounds_per_interval,
                window=window, window_fire=fire)


def _fd_phase(
    config: SimConfig,
    state: SimState,
    inputs: RoundInputs,
    random_loss: bool,
    halt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Probe evaluation + alert routing, the leading phase of ``step``: the
    round's key split and, with ``random_loss``, its uniform ``[C, K]`` draw
    (the CUDA kernel ``threefry_draw``; as in JAX the key advances with or
    without a draw, and where ``halt`` holds it is kept), then the CUDA kernel
    ``fd_phase_fused`` (plain versions for CPU tensors), which reads the
    state's int32 adjacency and its round counter directly, under the
    config's FD policy. Returns ``(rng_key, alive, fd_fail, alerted,
    fd_streak, fd_ok, down_arrivals, fd_hist, fd_seen)``."""
    rows = config.capacity if random_loss else 0
    rng_key, draw = kernels.threefry_draw(state.rng_key, rows, config.k, halt=halt)
    return (rng_key,) + kernels.fd_phase_fused(
        state.active, inputs.alive, inputs.drop_prob, state.subjects,
        state.observers, inputs.probe_drop, inputs.down_reports,
        draw if random_loss else None,
        state.fd_fail, state.alerted, state.fd_streak, state.fd_ok, state.round,
        fd_hist=state.fd_hist, fd_seen=state.fd_seen, **fd_kernel_policy(config),
    )


def _step(
    config: SimConfig, state: SimState, inputs: RoundInputs, random_loss: bool,
    obs: torch.Tensor,  # int64[C, K] state.observers, for route_and_tally
) -> SimState:
    halt = state.decided
    (rng_key, alive, fd_fail, alerted, fd_streak, fd_ok, down_arrivals, fd_hist,
     fd_seen) = _fd_phase(config, state, inputs, random_loss, halt)
    tallied = route_and_tally(
        config, state, down_arrivals, inputs, state.active, alive,
        observers_idx=obs,
    )
    new_state = dataclasses.replace(
        tallied,
        alive=inputs.alive,
        fd_fail=fd_fail,
        fd_hist=fd_hist,
        fd_seen=fd_seen,
        fd_streak=fd_streak,
        fd_ok=fd_ok,
        alerted=alerted,
        round=state.round + 1,
        rng_key=rng_key,
    )
    # after a decision the configuration is frozen until the host applies the
    # view change: all updates become no-ops (the draw kernel has already
    # kept the key, so it passes through)
    return _select(halt, dataclasses.replace(state, rng_key=rng_key), new_state)


def step(
    config: SimConfig, state: SimState, inputs: RoundInputs, random_loss: bool = True,
) -> SimState:
    """One protocol round. The state's key is split; with ``random_loss``
    the per-edge ingress loss is drawn from its probe half, without it no
    number is drawn."""
    return _step(config, state, inputs, random_loss, state.observers.long())


# --------------------------------------------------------------------- #
# Profiling phase prefixes (profiling/phases.py)
# --------------------------------------------------------------------- #
# Each entry point executes only the leading phases of one round, so the
# shadow profiler can time consecutive prefixes and difference them:
# per-phase wall time then sums to the full step by construction. No
# dispatch path calls them. They leave their arguments as they came (the
# kernels write fresh outputs, the key's split included), so a prefix draws
# what the round would.


def step_fd_scan(
    config: SimConfig, state: SimState, inputs: RoundInputs, random_loss: bool = True,
) -> Tuple[SimState, torch.Tensor]:
    """FD-scan prefix: probe evaluation and alert routing only, through the
    same ``_fd_phase`` as ``step`` (on a CUDA state, the kernels
    ``threefry_draw`` and ``fd_phase_fused``). Returns the partially updated
    state (the round not advanced, the key split) and the ``down_arrivals``
    gather."""
    (rng_key, _alive, fd_fail, alerted, fd_streak, fd_ok, down_arrivals, fd_hist,
     fd_seen) = _fd_phase(config, state, inputs, random_loss)
    partial = dataclasses.replace(
        state,
        alive=inputs.alive,
        fd_fail=fd_fail,
        fd_hist=fd_hist,
        fd_seen=fd_seen,
        fd_streak=fd_streak,
        fd_ok=fd_ok,
        alerted=alerted,
        rng_key=rng_key,
    )
    return partial, down_arrivals


def step_cut_detector(
    config: SimConfig, state: SimState, inputs: RoundInputs, random_loss: bool = True,
) -> SimState:
    """FD-scan + cut-detector prefix: everything in ``step`` through
    proposal emission; vote casting and the fast-round tally are skipped
    (``route_and_tally(stop_after_cut=True)``)."""
    (rng_key, alive, fd_fail, alerted, fd_streak, fd_ok, down_arrivals, fd_hist,
     fd_seen) = _fd_phase(config, state, inputs, random_loss)
    tallied = route_and_tally(config, state, down_arrivals, inputs, state.active, alive,
                              stop_after_cut=True)
    return dataclasses.replace(
        tallied,
        alive=inputs.alive,
        fd_fail=fd_fail,
        fd_hist=fd_hist,
        fd_seen=fd_seen,
        fd_streak=fd_streak,
        fd_ok=fd_ok,
        alerted=alerted,
        round=state.round + 1,
        rng_key=rng_key,
    )


def run_rounds(
    config: SimConfig, state: SimState, inputs: RoundInputs, random_loss: bool = True,
) -> SimState:
    """``step`` over stacked per-round inputs (each field's leading axis is
    the round), one round per slice; rounds after a decision are masked
    no-ops. JAX's ``run_rounds`` always draws (``random_loss`` on); without
    loss (drop probability 0) the draw cannot matter, so the port may skip
    it: the key advances alike."""
    rounds = inputs.alive.shape[0]
    obs = state.observers.long()
    for r in range(rounds):
        per_round = RoundInputs(
            **{f.name: getattr(inputs, f.name)[r] for f in dataclasses.fields(RoundInputs)})
        state = _step(config, state, per_round, random_loss, obs)
    return state


def run_rounds_const(
    config: SimConfig, state: SimState, inputs: RoundInputs, rounds: int,
    random_loss: bool = True,
) -> SimState:
    """``rounds`` rounds of ``step`` under a constant fault plane; rounds
    after a decision are masked no-ops. The input state is not modified."""
    obs = state.observers.long()
    for _ in range(rounds):
        state = _step(config, state, inputs, random_loss, obs)
    return state


def run_until_decided_const(
    config: SimConfig,
    state: SimState,
    inputs: RoundInputs,
    max_rounds: int,
    uniform_delivery: bool = True,
    stop_when_announced: bool = False,
) -> SimState:
    """Up to ``max_rounds`` rounds of a *constant, deterministic* fault plane
    in one dispatch, with the probe phase in closed form: each edge's probe
    outcome is the same every probing round, so the round at which it fires
    is computed up front -- for the cumulative policy when the counter crosses
    the threshold, for the windowed policy by stepping the window recurrence
    W <= 16 times (after W probes of a constant outcome the window is in
    steady state) -- and each round only tests ``fire_dst == r``.

    As in JAX, from a fresh configuration the dispatch fast-forwards to the
    first alert arrival (skipped rounds still count toward the budget and the
    round counter), and stops after the decision (or, with
    ``stop_when_announced``, at the first group announcement). Here the
    rounds outside that window run as masked no-ops: the dispatch always
    evaluates ``max_rounds`` rounds and needs no host sync. The result equals
    the JAX function's field for field; it draws no random numbers and
    leaves the key as it came.
    """
    subj, obs = state.subjects.long(), state.observers.long()
    active = state.active
    alive = inputs.alive & active
    edge_live = active[:, None] & active[subj]
    observer_up = alive[:, None]
    probe_ok = alive[subj] & ~inputs.probe_drop
    fail_event = edge_live & observer_up & ~probe_ok  # constant per round

    # probe index (1-based) at which each observer-indexed edge fires; an
    # edge already at/over threshold but unalerted fires on its next probe.
    # With staggered phases an observer probes at relative rounds p_rel+1,
    # p_rel+1+rpi, ... where p_rel re-bases its phase onto this dispatch.
    rpi = config.rounds_per_interval
    if rpi > 1:
        p_rel = (probe_phases(config, active.device) - state.round) % rpi  # [C]
    windowed = config.fd_policy == "windowed"
    if windowed:
        # step the window recurrence W times (once per dispatch) and record
        # the first probe index at which it reports a crossing: by probe W
        # the window holds only new bits, so no later probe fires first
        probed = edge_live & observer_up
        fail = probed & ~probe_ok
        w, _, mask_w = window_params(config)
        hist, seen = state.fd_hist, state.fd_seen
        fire_probe = torch.full_like(state.fd_hist, _NEVER)
        for j in range(1, w + 1):
            hist, seen, crossed = window_step(config, hist, seen, probed, fail)
            fire_probe = torch.where(crossed & (fire_probe == _NEVER), j, fire_probe)
        fires = (fire_probe != _NEVER) & ~state.alerted
    else:
        fire_probe = (config.fd_threshold - state.fd_fail.to(torch.int32)).clamp(min=1)
        if config.fd_gray_confirm > 0:
            # the streak alert fires at probe confirm - streak0 (>= 1) on
            # edges whose healthy history was established before this dispatch
            qualified = state.fd_ok >= config.fd_gray_warmup
            gray_probe = (
                config.fd_gray_confirm - state.fd_streak.to(torch.int32)
            ).clamp(min=1)
            fire_probe = torch.where(
                qualified, torch.minimum(fire_probe, gray_probe), fire_probe
            )
        fires = fail_event & ~state.alerted
    fire_round = p_rel[:, None] + 1 + (fire_probe - 1) * rpi if rpi > 1 else fire_probe
    fire = torch.where(fires, fire_round, _NEVER)
    # dst-indexed arrival round; proactive DOWN reports arrive in round 1
    fire_dst = torch.where(active[:, None], fire.gather(0, obs), _NEVER)
    fire_dst = torch.where(inputs.down_reports & active[:, None], 1, fire_dst)

    state = dataclasses.replace(
        state, alive=torch.where(state.decided, state.alive, inputs.alive)
    )

    # fast-forward over provably-inert rounds of a fresh configuration
    fresh = ~(
        state.decided
        | state.reports.any()
        | state.announced.any()
        | state.seen_down.any()
        | state.voted.any()
        | state.vote_new.any()
        | state.vote_hist.any()
        | state.arrival_hist.any()
        | inputs.join_reports.any()
    )
    start = torch.where(
        fresh, (fire_dst.min() - 1).clamp(max=max_rounds).clamp(min=0), 0
    )
    state = dataclasses.replace(state, round=state.round + start)

    final, r_exec = state, start
    for r in range(1, max_rounds + 1):
        run = (start < r) & ~final.decided
        if stop_when_announced:
            # pause at the round a group proposal is announced (extern rows
            # excluded) so the caller can act before votes tally
            run = run & ~final.announced[: config.groups].any()
        st = route_and_tally(
            config, final, fire_dst == r, inputs, active, alive,
            uniform_delivery=uniform_delivery, observers_idx=obs,
        )
        st = dataclasses.replace(st, round=final.round + 1)
        final = _select(run, st, final)
        r_exec = torch.where(run, r, r_exec)

    # reconstruct the per-edge FD state the executed rounds produced (number
    # of scheduled probes within [1, r_exec] per observer)
    if rpi > 1:
        probes = ((r_exec - 1 - p_rel) // rpi + 1).clamp(min=0)[:, None]
    else:
        probes = r_exec
    alerted = state.alerted | (fire <= r_exec)
    if windowed:
        # hist after p probes of constant outcome f: (hist0 << p | f * (2^p -
        # 1)) masked; only min(p, W) <= 16 matters. Shifted in int64, where a
        # shift by 16 of a 16-bit value cannot overflow.
        p_eff = probes.clamp(max=w).long()
        shifted = state.fd_hist.long() << p_eff
        fills = torch.where(fail, (torch.ones_like(p_eff) << p_eff) - 1, 0)
        hist_new = ((shifted | fills) & mask_w).to(torch.int32)
        fd_hist = torch.where(probed, hist_new, state.fd_hist)
        fd_seen = torch.where(
            probed,
            (state.fd_seen.to(torch.int32) + probes).clamp(max=w).to(torch.uint8),
            state.fd_seen,
        )
        return dataclasses.replace(final, fd_hist=fd_hist, fd_seen=fd_seen, alerted=alerted)
    fd_fail = (
        state.fd_fail.to(torch.int32) + probes * fail_event.to(torch.int32)
    ).clamp(max=255).to(torch.uint8)
    if config.fd_gray_confirm == 0:
        return dataclasses.replace(final, fd_fail=fd_fail, alerted=alerted)
    ok_event = edge_live & observer_up & probe_ok
    fd_streak = (
        state.fd_streak.to(torch.int32) + probes * fail_event.to(torch.int32)
    ).clamp(max=255)
    fd_streak = torch.where(ok_event & (probes >= 1), 0, fd_streak).to(torch.uint8)
    fd_ok = torch.where(
        ok_event,
        (state.fd_ok.to(torch.int32) + probes).clamp(max=255),
        state.fd_ok.to(torch.int32),
    ).to(torch.uint8)
    return dataclasses.replace(
        final, fd_fail=fd_fail, fd_streak=fd_streak, fd_ok=fd_ok, alerted=alerted
    )


def device_initial_state(
    config: SimConfig,
    ring_rank: torch.Tensor,  # int32[K, C] rank of each node in the full ring order
    active: torch.Tensor,  # bool[C]
    alive: torch.Tensor,  # bool[C]
    group_of: torch.Tensor,  # int32[C]
    auto_vote: torch.Tensor,  # bool[C]
    rng_key: torch.Tensor,  # int64[2] the configuration's key (threefry.prng_key)
) -> SimState:
    """Fresh-configuration state built on the device: a masked stable sort
    of the resident per-ring ranks (inactive entries sort to the end), then
    predecessor/successor by index arithmetic mod n, scattered into
    ``subjects``/``observers`` (the scatter's indices are a permutation).
    Equal to the host ``build_adjacency`` order."""
    c, k = config.capacity, config.k
    dev = active.device
    keys = torch.where(active[None, :], ring_rank, _NEVER)
    order = torch.argsort(keys, dim=1, stable=True)  # int64 [K, C]
    n = active.sum()
    n1 = n.clamp(min=1)
    p = torch.arange(c, dtype=torch.int64, device=dev)[None, :]
    pred_idx = torch.where(p < n, (p - 1) % n1, p).expand(k, c)
    succ_idx = torch.where(p < n, (p + 1) % n1, p).expand(k, c)
    preds = order.gather(1, pred_idx).to(torch.int32)
    succs = order.gather(1, succ_idx).to(torch.int32)

    base = torch.arange(c, dtype=torch.int32, device=dev)[:, None].repeat(1, k)
    ring_ids = torch.arange(k, dtype=torch.int64, device=dev)[:, None].expand(k, c).reshape(-1)
    nodes_flat = order.reshape(-1)
    subjects = base.clone().index_put_((nodes_flat, ring_ids), preds.reshape(-1))
    observers = base.index_put_((nodes_flat, ring_ids), succs.reshape(-1))
    return SimState(
        active=active,
        alive=alive,
        group_of=group_of,
        subjects=subjects,
        observers=observers,
        auto_vote=auto_vote,
        rng_key=rng_key,
        **_fresh_fields(config, dev),
    )


# --------------------------------------------------------------------- #
# Packed decision summary
# --------------------------------------------------------------------- #
# The driver's post-dispatch sync fetches everything a decision needs as ONE
# word stream. Layout: 5 header words (decided, decided_group, decided_round,
# round, announced_round), then ceil(P/32) words of announced bits, then
# P * ceil(C/32) words of proposal bits (row-major, LSB-first within each
# word) -- the JAX engine's layout, word for word.

_SUMMARY_HEADER = 5


def _words_per(n: int) -> int:
    return (n + 31) // 32


def pack_decision(config: SimConfig, state: SimState) -> torch.Tensor:
    """Bit-pack the decision-relevant slice of ``state`` (see the layout
    note above). The words are the JAX function's uint32 words, held in
    int64 (PyTorch lacks shifts and sums on uint32): every value lies in
    [0, 2^32)."""
    dev = state.announced.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)

    def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
        pad = (-bits.shape[-1]) % 32
        if pad:
            bits = torch.cat(
                [bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1
            )
        w = bits.reshape(bits.shape[:-1] + (-1, 32)).long() << shifts
        return w.sum(dim=-1)

    header = torch.stack(
        [
            state.decided.long(),
            state.decided_group.long(),
            state.decided_round.long(),
            state.round.long(),
            state.announced_round.long(),
        ]
    ) & _U32
    return torch.cat(
        [header, bits_to_words(state.announced), bits_to_words(state.proposal).reshape(-1)]
    )


def unpack_decision(
    config: SimConfig, words: np.ndarray
) -> Tuple[bool, np.ndarray, int, np.ndarray, int, int, int]:
    """Host-side inverse of ``pack_decision``. Returns ``(decided,
    announced[P], announced_round, proposal[P, C], decided_group,
    decided_round, round)``."""
    p, c = config.proposal_rows, config.capacity
    words = np.asarray(words, dtype=np.uint32)
    pw, cw = _words_per(p), _words_per(c)

    def words_to_bits(w: np.ndarray, n: int) -> np.ndarray:
        bits = ((w[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
        return bits.reshape(w.shape[:-1] + (-1,))[..., :n]

    off = _SUMMARY_HEADER
    announced = words_to_bits(words[off : off + pw], p)
    proposal = words_to_bits(
        words[off + pw : off + pw + p * cw].reshape(p, cw), c
    )
    return (
        bool(words[0]),
        announced,
        int(np.int32(words[4])),
        proposal,
        int(np.int32(words[1])),
        int(np.int32(words[2])),
        int(np.int32(words[3])),
    )


def const_inputs(
    config: SimConfig,
    alive: np.ndarray,
    probe_drop: Optional[np.ndarray] = None,
    drop_prob: Optional[np.ndarray] = None,
    join_reports: Optional[np.ndarray] = None,
    deliver: Optional[np.ndarray] = None,
    down_reports: Optional[np.ndarray] = None,
    deliver_delay: Optional[np.ndarray] = None,
    device=None,
) -> RoundInputs:
    """A single-round fault plane on ``device`` (for run_rounds_const)."""
    dev = resolve_device(device)
    c, k, g = config.capacity, config.k, config.groups

    def put(arr, shape, dtype, fill=0):
        if arr is None:
            return torch.full(shape, fill, dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=dev)

    return RoundInputs(
        alive=put(alive, (c,), torch.bool),
        probe_drop=put(probe_drop, (c, k), torch.bool),
        drop_prob=put(drop_prob, (c,), torch.float32),
        join_reports=put(join_reports, (c, k), torch.bool),
        down_reports=put(down_reports, (c, k), torch.bool),
        deliver=put(deliver, (g, c), torch.bool, fill=1),
        deliver_delay=put(deliver_delay, (g, c), torch.int32),
    )
