"""The classic Paxos fallback, bridged extern votes, identities and the
configuration snapshot of the PyTorch port against the JAX package: twins of
tests/test_classic_paxos_sim.py and of the classic decision in
tests/test_sim_engine.py. Both simulators are seeded alike (and, where a test
rigs the coordinator race, rigged alike); every coordinator result, phase1b
summary, acceptor plane (classic_rnd/vrnd/vval) and view-change record must be
equal. Integer and boolean only, so the tolerance is zero. The JAX tests'
metrics-counter assertions have no twin: the port has no metrics plane yet."""

import numpy as np
import pytest

from rapid_tpu.sim import classic as jclassic
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxConfig
from rapid_tpu_torch.sim import classic as tclassic
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

ACCEPTOR = ("classic_rnd", "classic_vrnd", "classic_vval")


def _pair(n, seed, **config):
    return (JaxSimulator(n, config=JaxConfig(capacity=n, **config), seed=seed),
            Simulator(n, config=teng.SimConfig(capacity=n, **config), seed=seed,
                      device="cpu"))


def _assert_acceptors_equal(jax_sim, port_sim):
    for name in ACCEPTOR:
        np.testing.assert_array_equal(getattr(port_sim.state, name).numpy(),
                                      np.asarray(getattr(jax_sim.state, name)), err_msg=name)


def _assert_summaries_equal(jax_coord, port_coord):
    want, got = jax_coord._summary, port_coord._summary
    for name in ("promised", "max_vrnd", "cutoff"):
        assert getattr(got, name) == int(getattr(want, name)), name
    for name in ("at_max", "any_vval", "rep"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _record(rec):
    if rec is None:
        return None
    return (rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms,
            rec.membership_size, rec.via_classic_round)


def _stalled_pair(n=1000, n_blind=260, seed=7, **config):
    """Twin of _stalled_sim: a blind delivery class of more than F members
    never hears the alerts, so the fast round stalls on the crashed pair."""
    pair = _pair(n, seed, groups=2, **config)
    group_of = np.zeros(n, dtype=np.int32)
    group_of[n - n_blind:] = 1
    victims = np.array([5, 6])
    for sim in pair:
        sim.set_delivery_groups(group_of)
        sim.crash(victims)
        sim.drop_broadcasts(1, np.arange(n))
        assert sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=None) is None
    for a, b in zip(pair[1].last_announcement, pair[0].last_announcement):
        np.testing.assert_array_equal(a, b)
    announced, proposals = pair[1].last_announcement
    assert announced[0] and not announced[1]
    np.testing.assert_array_equal(np.flatnonzero(proposals[0]), victims)
    return pair, victims


def _coordinators(pair, round_no, slot):
    return (jclassic.ClassicCoordinator(pair[0], round_no=round_no, slot=slot),
            tclassic.ClassicCoordinator(pair[1], round_no=round_no, slot=slot))


def _phase1(coords):
    out = [c.phase1() for c in coords]
    assert out[0] == out[1]
    _assert_summaries_equal(*coords)
    _assert_acceptors_equal(coords[0].sim, coords[1].sim)
    assert coords[0].elapsed_rounds == coords[1].elapsed_rounds
    return out[1]


def _pick(coords):
    out = [c.pick_value() for c in coords]
    assert out[0] == out[1]
    return out[1]


def _phase2(coords, row):
    out = [c.phase2(row) for c in coords]
    assert out[0] == out[1]
    _assert_acceptors_equal(coords[0].sim, coords[1].sim)
    assert coords[0].elapsed_rounds == coords[1].elapsed_rounds
    return out[1]


def test_rank_packing_matches():
    for round_no, node in [(2, 0), (2, 5), (2, 6), (3, 0), (1023, (1 << 21) - 1)]:
        assert tclassic.make_rank(round_no, node) == jclassic.make_rank(round_no, node)
    assert tclassic.make_rank(2, 0) > teng.FAST_RANK
    with pytest.raises(AssertionError):
        tclassic.make_rank(1, 0)


def test_single_coordinator_recovers_stalled_round_at_1k():
    pair, victims = _stalled_pair()
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    coords = _coordinators(pair, 2, int(live[0]))
    assert _phase1(coords)
    row = _pick(coords)
    assert row == 0 and _phase2(coords, row) == 0
    np.testing.assert_array_equal(np.flatnonzero(pair[1].state.proposal[row].numpy()), victims)


def test_dueling_coordinators_interleaved_phase1_at_1k():
    pair, _ = _stalled_pair(seed=8)
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    low = _coordinators(pair, 2, int(live[0]))
    high = _coordinators(pair, 2, int(live[1]))
    assert low[1].rank < high[1].rank
    assert _phase1(low) and _phase1(high)
    row_low = _pick(low)
    assert _phase2(low, row_low) is None  # outranked
    row_high = _pick(high)
    assert row_high == row_low == 0 and _phase2(high, row_high) == 0


def test_late_coordinator_must_choose_the_decided_value_at_1k():
    pair, _ = _stalled_pair(seed=9)
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    first = _coordinators(pair, 2, int(live[0]))
    assert _phase1(first)
    assert _phase2(first, _pick(first)) == 0
    late = _coordinators(pair, 3, int(live[5]))
    assert _phase1(late)
    assert late[1]._summary.max_vrnd == first[1].rank
    assert _pick(late) == 0 and _phase2(late, 0) == 0


def test_no_valid_vote_means_no_phase2():
    pair = _pair(40, seed=11)
    coords = _coordinators(pair, 2, 0)
    assert _phase1(coords)
    assert _pick(coords) is None


def test_conflicting_fast_votes_pick_the_quarter_majority_value_at_1k():
    n = 1000
    pair = _pair(n, seed=12, groups=2)
    group_of = np.zeros(n, dtype=np.int32)
    group_of[700:] = 1
    victims = np.array([10, 11])
    recs = []
    for sim in pair:
        sim.set_delivery_groups(group_of)
        sim.crash(victims)
        sim.drop_broadcasts(1, np.asarray(sim.state.observers)[11])
        recs.append(_record(sim.run_until_decision(max_rounds=20,
                                                   classic_fallback_after_rounds=None)))
    assert recs[0] == recs[1]
    if recs[1] is not None:
        return  # both decided alike: no divergence for this seed, in either
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    coords = _coordinators(pair, 2, int(live[0]))
    assert _phase1(coords)
    row = _pick(coords)
    np.testing.assert_array_equal(np.flatnonzero(pair[1].state.proposal[row].numpy()), victims)
    assert _phase2(coords, row) == row


def test_driver_fallback_uses_device_exchange_at_1k():
    pair, victims = _stalled_pair(seed=13)
    recs = [_record(sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=2))
            for sim in pair]
    assert recs[0] == recs[1]
    assert recs[1][0] == victims.tolist() and recs[1][4] and pair[1].membership_size == 998
    assert int(pair[1].state.classic_rnd.max()) == 0  # reset with the new configuration


def test_phase1_pools_identical_values_across_rows():
    n = 1000
    pair, victims = _stalled_pair(n, seed=21, extern_proposals=2)
    group_of = pair[1].group_of
    blind = np.flatnonzero((group_of == 1) & pair[1].active & pair[1].alive)[:10]
    for sim in pair:
        for slot in blind:
            sim.auto_vote[int(slot)] = False
            assert sim.register_extern_vote(int(slot), victims)
        sim.clear_link_faults()
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    coords = _coordinators(pair, 2, int(live[0]))
    assert _phase1(coords)
    at_max, rep = coords[1]._summary.at_max, coords[1]._summary.rep
    assert at_max[0] == at_max[2] == 748 and rep[2] == 0
    assert _pick(coords) == 0 and _phase2(coords, 0) == 0


class _RiggedRng:
    """Expovariate timers with two chosen slots firing first."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def exponential(self, scale, size):
        t = np.full(size, 1_000_000.0)
        t[self.first] = 0.2
        t[self.second] = 0.6
        return t


@pytest.mark.parametrize("first, second", [(0, 1), (9, 0)])
def test_driver_races_concurrent_coordinators(first, second):
    """Twins of test_driver_races_concurrent_coordinators (a later, higher
    slot steals the quorum) and test_driver_race_later_arrival_outranked
    (the first timer belongs to the higher slot)."""
    pair, victims = _stalled_pair(seed=17 if first == 0 else 19)
    n_live = int((pair[1].active & pair[1].alive).sum())
    for sim in pair:
        sim._host_rng = _RiggedRng(first, second)
    recs = [_record(sim.run_until_decision(max_rounds=8, classic_fallback_after_rounds=2))
            for sim in pair]
    assert recs[0] == recs[1]
    assert recs[1][0] == victims.tolist() and recs[1][4]
    assert pair[1].membership_size == n_live


@pytest.mark.parametrize("skew", [1, 2])
def test_skewed_exchange_bills_the_majority_cutoffs_alike(skew):
    """With latency skew a response arrives 2 + both hops' delays after its
    phase broadcast, and the coordinator proceeds at the majority's cutoff:
    summaries, cutoffs and the billed exchange rounds agree."""
    pair, victims = _stalled_pair(seed=27, max_delivery_delay=2)
    slow = np.arange(0, 1000, 3)  # a third of senders, delayed to both groups
    for sim in pair:
        sim.delay_broadcasts(0, slow, skew)
        sim.delay_broadcasts(1, slow[:100], 2)
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    coords = _coordinators(pair, 2, int(live[1]))
    assert _phase1(coords)
    # the unskewed two thirds of group 0 fall short of a majority, so the
    # inbox closes when the skewed third arrives
    assert coords[1]._summary.cutoff == 2 + skew
    assert _phase2(coords, _pick(coords)) == 0
    assert coords[1].elapsed_rounds > 4  # the skewed hops are billed
    late = _stalled_pair(seed=29, max_delivery_delay=2)[0]
    for sim in late:
        sim.delay_broadcasts(0, slow, skew)
    recs = [_record(sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=2))
            for sim in late]
    assert recs[0] == recs[1] and recs[1][4]


def test_recovery_traffic_rides_delivery_fault_plane():
    n = 400
    pair = _pair(n, seed=23, groups=2)
    group_of = np.zeros(n, dtype=np.int32)
    group_of[0] = 1
    for sim in pair:
        sim.set_delivery_groups(group_of)
        sim.crash(np.array([7]))
        sim.run_until_decision(max_rounds=4, classic_fallback_after_rounds=None)
        sim.drop_broadcasts(1, np.arange(n))
    deaf = _coordinators(pair, 2, 0)
    assert not _phase1(deaf)
    assert (pair[1].state.classic_rnd.numpy() >= tclassic.make_rank(2, 0)).sum() > n // 2


def test_extern_vote_refused_after_classic_participation():
    pair, victims = _stalled_pair(seed=22)
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    coords = _coordinators(pair, 2, int(live[0]))
    assert _phase1(coords)
    promised = int(live[3])
    outs = []
    for sim in pair:
        sim.auto_vote[promised] = False
        outs.append(sim.register_extern_vote(promised, victims))
    assert outs == [False, False]


def test_sim_crash_beyond_fast_quorum_decides_via_classic_alike():
    """Twin of tests/test_sim_engine.py's 16/50 boundary: survivors (34) are
    below the fast quorum (38), so only the classic round decides."""
    pair = _pair(50, seed=44)
    recs = []
    for sim in pair:
        sim.crash(np.arange(34, 50))
        recs.append(_record(sim.run_until_decision(max_rounds=64, batch=8,
                                                   classic_fallback_after_rounds=8)))
    assert recs[0] == recs[1]
    assert recs[1][0] == list(range(34, 50)) and recs[1][4]


# --------------------------------------------------------------------- #
# Bridged extern votes
# --------------------------------------------------------------------- #

VOTE_FIELDS = ("proposal", "announced", "voted", "vote_prop", "vote_new", "auto_vote")


def _assert_vote_state_equal(pair):
    for name in VOTE_FIELDS:
        np.testing.assert_array_equal(getattr(pair[1].state, name).numpy(),
                                      np.asarray(getattr(pair[0].state, name)), err_msg=name)


def test_extern_votes_dedup_pool_and_exhaust_rows_alike():
    pair = _pair(16, seed=3, extern_proposals=2)
    calls = [
        ("auto", 5, False), ("vote", 5, [2]), ("vote", 5, [2, 3]),  # dedup by sender
        ("vote", 6, [2]),  # the same cut pools into the same row
        ("auto", 7, False), ("vote", 7, [2, 3]),  # a second row
        ("vote", 8, [4]),  # no free row left
        ("auto", 5, True),
    ]
    for kind, slot, arg in calls:
        outs = []
        for sim in pair:
            if kind == "auto":
                sim.set_auto_vote(slot, arg)
            else:
                outs.append(sim.register_extern_vote(slot, np.array(arg)))
        assert len(set(outs)) <= 1, (kind, slot, outs)
        _assert_vote_state_equal(pair)
    assert pair[1]._extern_rows == pair[0]._extern_rows
    assert pair[1]._extern_voted == pair[0]._extern_voted == {5, 6, 7}


def test_extern_vote_reads_nothing_back_until_a_classic_round_ran(monkeypatch):
    """Twin of test_extern_vote_fast_path_does_not_sync_host: the slot's
    classic rank is read (one host sync) only once a classic round has run
    in this configuration."""
    sim = Simulator(16, config=teng.SimConfig(capacity=16, extern_proposals=1), seed=3,
                    device="cpu")

    def no_fetch(slot):
        raise AssertionError("register_extern_vote read the classic rank")

    monkeypatch.setattr(sim, "_classic_rank", no_fetch)
    assert sim._classic_attempts == 0
    assert sim.register_extern_vote(5, np.array([2]))


def test_extern_vote_gate_after_a_driver_classic_round_alike():
    """A failed classic attempt (its coordinator sits in the blind group and
    hears no response) leaves group-0 acceptors promised: their extern votes
    are refused, a blind slot's still counts; the next attempt decides, and
    rows and dedup reset with the next configuration."""
    pair, victims = _stalled_pair(seed=25, extern_proposals=1)
    blind = int(np.flatnonzero(pair[1].group_of == 1)[0])
    live = np.flatnonzero(pair[1].active & pair[1].alive)
    first = int(np.flatnonzero(live == blind)[0])
    for sim in pair:
        sim._host_rng = _RiggedRng(first, first)
        assert sim._run_classic_round() == (None, 4)
    _assert_acceptors_equal(*pair)
    promised = int(live[0])
    for slot, counted in ((promised, False), (blind + 1, True)):
        assert [sim.register_extern_vote(slot, victims) for sim in pair] == [counted] * 2
    _assert_vote_state_equal(pair)
    for sim in pair:
        sim.clear_link_faults()
    # the promised acceptors cannot vote fast any more: the fallback decides
    recs = [_record(sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=2))
            for sim in pair]
    assert recs[0] == recs[1] and recs[1][4]
    assert pair[1]._extern_rows == {} and pair[1]._extern_voted == set()


# --------------------------------------------------------------------- #
# Identities and the configuration snapshot
# --------------------------------------------------------------------- #


def test_identities_joins_and_snapshot_restore_alike(tmp_path):
    """Seat identities in spare slots, admit them, then save the port's
    snapshot: the JAX from_configuration and the port's restore it with the
    same configuration id, members and clock."""
    pair = (JaxSimulator(20, capacity=24, seed=6),
            Simulator(20, capacity=24, seed=6, device="cpu"))
    seats = [(21, b"10.1.0.7", 7000, 11, 12), (22, b"real-host.example", 7001, -5, 99)]
    for sim in pair:
        for slot, host, port, high, low in seats:
            sim.assign_identity(slot, host, port, high, low)
        sim.request_joins(np.array([21, 22]))
        sim.leave(np.array([3]))
    for slot, host, port, _, _ in seats:
        assert pair[1].endpoint_of(slot) == pair[0].endpoint_of(slot) == (host, port)
    assert pair[1].pending_joiners == pair[0].pending_joiners == {21, 22}
    assert pair[1].pending_leavers == pair[0].pending_leavers == {3}
    recs = [_record(sim.run_until_decision(max_rounds=12)) for sim in pair]
    assert recs[0] == recs[1] and recs[1] is not None
    assert pair[1].identifiers_seen == pair[0].identifiers_seen
    assert pair[1].is_identifier_seen(-5, 99) and not pair[1].is_identifier_seen(-5, 98)
    with pytest.raises(AssertionError, match="reuse"):
        pair[1].assign_identity(23, b"h", 1, 11, 12)

    path = str(tmp_path / "port.npz")
    pair[1].save_configuration(path, extra={"note": np.arange(3)})
    jax_path = str(tmp_path / "jax.npz")
    pair[0].save_configuration(jax_path, extra={"note": np.arange(3)})
    with np.load(path) as got, np.load(jax_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    restored = (JaxSimulator.from_configuration(path),
                Simulator.from_configuration(path, device="cpu"))
    for sim in restored:
        assert sim.configuration_id() == pair[0].configuration_id()
        assert sim.virtual_ms == pair[0].virtual_ms
        np.testing.assert_array_equal(sim.members(), pair[0].members())
    recs = [_record(sim.run_until_decision(max_rounds=40))
            for sim in restored if not sim.crash(np.array([7]))]
    assert recs[0] == recs[1] and recs[1][0] == [7]


def test_host_rng_is_seeded_as_in_jax():
    pair = _pair(8, seed=1234)
    np.testing.assert_array_equal(pair[1]._host_rng.exponential(8.0, 5),
                                  pair[0]._host_rng.exponential(8.0, 5))


def test_state_stays_a_copy_of_the_host_arrays():
    """The port's device state never aliases the driver's host arrays, so a
    host-side write (as a bridge makes to auto_vote) reaches the device only
    through the API, on the CPU as on the card."""
    sim = Simulator(8, seed=1, device="cpu")
    sim.auto_vote[2] = False
    sim.alive[3] = False
    assert bool(sim.state.auto_vote[2]) and bool(sim.state.alive[3])
