"""The port's own fault plane drives the port's Simulator: its
``apply_plan_at``, ``apply_topology`` and ``replay_on_simulator``
(``rapid_tpu_torch/faults.py``) against ``rapid_tpu.faults`` on the JAX
package's Simulator, plan for plan.

Each plan is built with the JAX package's builders and crosses into the port
as JSON (``FaultPlan.from_json``), so both replay the same plan. The plans
are those of tests/test_torch_faults.py (which drives the port's simulator
with the JAX package's functions, and stays as it is) and
tests/test_torch_fault_plans.py, and cell partitions. Records are equal
exactly for deterministic plans and for drops at probability 1.0, and by
cut and configuration id below it (torch's draws are not threefry's).
``UnsupportedDeviceFault`` is raised on the same plans with the same
message. The bench's gray-detection dimension equals
tests/golden/torch_gray.json (written from the JAX package by
tests/golden/generate_torch_gray.py), and so does the JAX package's run
today, so the file cannot go stale unseen.
"""

import json

import numpy as np
import pytest

import chip_smoke
from rapid_tpu import faults as jf
from rapid_tpu import types as jt
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxConfig
from rapid_tpu.sim.topology import LatencyTopology as JaxTopology
from rapid_tpu_torch import faults as pf
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.sim.engine import SimConfig
from rapid_tpu_torch.sim.topology import LatencyTopology


def _pair(n, seed, config=None, **kw):
    """(JAX simulator, port simulator), seeded alike."""
    return (JaxSimulator(n, config=None if config is None else JaxConfig(**config),
                         seed=seed, **kw),
            Simulator(n, config=None if config is None else SimConfig(**config), seed=seed,
                      device="cpu", **kw))


def _records(records, exact=True):
    return [(tuple(int(c) for c in r.cut), r.configuration_id)
            + ((r.virtual_time_ms, r.membership_size) if exact else ())
            for r in records]


def _by_slot(sim):
    return {s: ep for ep, s in jf.endpoint_slots(sim).items()}


def _replay_twins(n, seed, build, duration_ms, config=None, exact=True, **kw):
    """Replay ``build(endpoint of slot)`` (a JAX plan) with each package's
    fault plane on its own simulator; the records must be equal."""
    jax_sim, port_sim = _pair(n, seed, config, **kw)
    plan = build(_by_slot(jax_sim))
    crossed = pf.FaultPlan.from_json(json.loads(json.dumps(plan.to_json())))
    want = jf.replay_on_simulator(jax_sim, plan, duration_ms=duration_ms)
    got = pf.replay_on_simulator(port_sim, crossed, duration_ms=duration_ms)
    assert _records(got, exact) == _records(want, exact)
    if exact:
        assert port_sim.virtual_ms == jax_sim.virtual_ms
    assert port_sim.configuration_id() == jax_sim.configuration_id()
    return got, port_sim


def _identities(n, base, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**63), 2**63, size=(n, 2), dtype=np.int64)
    return [(b"127.0.0.1", base + i, int(hi), int(lo)) for i, (hi, lo) in enumerate(ids)]


def test_flip_flop_windows_drive_the_device_fault_arrays_alike():
    seen = []
    for sim, faults in zip(_pair(4, 2), (jf, pf)):
        slots = faults.endpoint_slots(sim)
        victim = next(ep for ep, s in slots.items() if s == 3)
        plan = faults.FaultPlan(seed=0).flip_flop(period_ms=2000, dst=victim)
        mine = []
        for t_ms in (500, 1500, 2500):
            faults.apply_plan_at(sim, plan, t_ms=t_ms, slots=slots)
            mine.append(set(sim._ingress_partitioned))
        seen.append(mine)
    assert seen[1] == seen[0] == [{3}, set(), {3}]


@pytest.mark.parametrize("rule", ["partition", "slow_node"])
def test_seated_identities_replay_alike(rule):
    n = 5
    victim = jt.Endpoint.from_parts("127.0.0.1", 7100 + n - 1)

    def build(_):
        plan = jf.FaultPlan(seed=7)
        if rule == "partition":
            return plan.partition_one_way(dst=victim)
        return plan.slow_node(victim, response_delay_ms=5000)

    records, _ = _replay_twins(n, 5, build, 40_000, identities=_identities(n, 7100, seed=3))
    assert [list(r.cut) for r in records] == [[n - 1]]


@pytest.mark.parametrize("seed", [31, 32])
def test_topology_zone_loss_replay_matches_jax(seed):
    n = 64
    topo = JaxTopology(racks=8, zones=4, regions=2, rack_rtt_ms=0, zone_rtt_ms=2,
                       region_rtt_ms=4, inter_region_rtt_ms=1000)
    victims = [i for i in range(n) if topo.zone_of(i) == 3]

    def build(by_slot):
        plan = jf.FaultPlan(seed=seed).with_topology(topo)
        for v in victims:
            plan.partition_one_way(dst=by_slot[v], windows=((2000, None),))
        return plan

    config = dict(capacity=64, groups=4, max_delivery_delay=2, rounds_per_interval=4)
    records, sim = _replay_twins(n, seed, build, 60_000, config=config)
    assert sorted({int(c) for r in records for c in r.cut}) == victims
    assert sim.group_of.tolist() == LatencyTopology(
        racks=8, zones=4, regions=2).group_assignment(64).tolist()


@pytest.mark.parametrize("rule, probability, exact", [("lossy_link", 0.7, False),
                                                       ("drop", 0.7, False),
                                                       ("drop", 1.0, True)])
def test_lossy_link_replay_decides_the_same_cut(rule, probability, exact):
    """A drop rule compiles onto ingress loss (a lossy link is one that
    drops some but not all traffic; a drop at 1.0 loses every probe)."""
    def build(by_slot):
        return getattr(jf.FaultPlan(seed=4), rule)(probability, dst=by_slot[9])

    records, sim = _replay_twins(24, 6, build, 80_000, exact=exact)
    assert [[int(c) for c in r.cut] for r in records] == [[9]]
    assert sim._drop_prob[9] == pytest.approx(probability)


def test_partition_windows_replay_alike():
    def build(by_slot):
        return (jf.FaultPlan(seed=1)
                .partition_one_way(dst=by_slot[4], windows=((0, 6000),))
                .partition_one_way(dst=by_slot[11], windows=((3000, None),)))

    records, _ = _replay_twins(20, 8, build, 40_000)
    assert [tuple(r.cut) for r in records] == [(11,)]


@pytest.mark.parametrize("cells, cell", [(3, 1), (4, 0)])
def test_cell_partition_replay_alike(cells, cell):
    """A rendezvous cell partitioned from t = 1000 ms: every member of the
    cell is cut, and nothing else."""
    def build(_):
        return jf.FaultPlan(seed=2).cell_partition(cell, cells, windows=((1000, None),))

    records, sim = _replay_twins(48, 13, build, 40_000)
    cut = sorted(int(c) for r in records for c in r.cut)
    assert cut and cut == [s for s in range(48)
                           if pf._slot_cell(sim, pf.FaultPlan(), s, cells) == cell]


def test_cell_partition_with_a_topology_cuts_the_zone():
    topo = JaxTopology(racks=4, zones=2, regions=1, rack_rtt_ms=0, zone_rtt_ms=0,
                       region_rtt_ms=0, inter_region_rtt_ms=0)

    def build(_):
        return jf.FaultPlan(seed=3).with_topology(topo).cell_partition(1, 2)

    config = dict(capacity=32, groups=2, max_delivery_delay=2)
    records, _ = _replay_twins(32, 17, build, 30_000, config=config)
    assert sorted(int(c) for r in records for c in r.cut) == [
        i for i in range(32) if topo.zone_of(i) == 1]


def test_half_slow_half_lossy_victims_with_the_gray_streak():
    """chip_smoke.py's 100k replay at 64 members: half the victims slow
    (the closed form would take them), half behind a drop rule at
    probability 1.0 (random loss on, so the scan round), with the adaptive
    gray streak on."""
    victims = [5, 17, 30, 41]

    def build(by_slot):
        plan = jf.FaultPlan(seed=9)
        for v in victims[:2]:
            plan.slow_node(by_slot[v], chip_smoke.GRAY_DELAY_MS)
        for v in victims[2:]:
            plan.drop(1.0, dst=by_slot[v])
        return plan

    config = dict(capacity=64, fd_gray_confirm=chip_smoke.GRAY_CONFIRM)
    records, _ = _replay_twins(64, 21, build, 30_000, config=config)
    assert [sorted(int(c) for c in r.cut) for r in records] == [victims]


def _unsupported_plans():
    a = jt.Endpoint.from_parts("10.0.0.1", 7001)
    return {
        "per_source": lambda: jf.FaultPlan().drop(0.5, src=a),
        "dissemination_loss": lambda: jf.FaultPlan().drop(0.5, msg_types=(jt.Put,)),
        "long_delay": lambda: jf.FaultPlan().delay(900, 200),
        "extreme_skew": lambda: jf.FaultPlan().clock_skew(a, rate=3.0),
        "full_plan": lambda: _full_plan(),
    }


def _full_plan():
    import test_torch_fault_plans

    return test_torch_fault_plans._full_plan(jf, jt, JaxTopology)


@pytest.mark.parametrize("name", sorted(_unsupported_plans()))
def test_unsupported_device_faults_raise_alike(name):
    plan = _unsupported_plans()[name]()
    crossed = pf.FaultPlan.from_json(json.loads(json.dumps(plan.to_json())))
    with pytest.raises(jf.UnsupportedDeviceFault) as want:
        jf._device_rules(plan, 1000)
    with pytest.raises(pf.UnsupportedDeviceFault) as got:
        pf._device_rules(crossed, 1000)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    jax_sim, port_sim = _pair(8, 1)
    with pytest.raises(pf.UnsupportedDeviceFault):
        pf.replay_on_simulator(port_sim, crossed, duration_ms=5000)
    assert port_sim.virtual_ms == 0


def test_absorbed_rules_compile_to_nothing_and_boundaries_match():
    a = jt.Endpoint.from_parts("10.0.0.1", 7001)
    plan = (jf.FaultPlan(seed=5)
            .duplicate(0.3).reorder(0.5, max_extra_ms=20).wire_version(a, 2)
            .torn_write(a, windows=((1000, 1200),)).disk_stall(a, 12)
            .clock_skew(a, offset_ms=30, rate=1.5).delay(5, 7)
            .slow_node(a, 40)
            .partition_one_way(dst=a, windows=((100, 300), (4000, None)))
            .flip_flop(700, dst=jt.Endpoint.from_parts("10.0.0.2", 7002), start_ms=50,
                       windows=((0, 5000),))
            .drop(0.2, windows=((250, 9000),)))
    crossed = pf.FaultPlan.from_json(json.loads(json.dumps(plan.to_json())))
    want, got = jf._device_rules(plan, 1000), pf._device_rules(crossed, 1000)
    assert [i for i, _ in got] == [i for i, _ in want] == [8, 9, 10]
    for horizon in (3000, 10_000, 45_000):
        assert pf._boundaries(got, horizon, 1000) == jf._boundaries(want, horizon, 1000)


@pytest.mark.parametrize("cells", [1, 2, 3, 5])
def test_slot_cells_equal_the_per_slot_cells(cells):
    jax_sim, port_sim = _pair(40, 23, identities=_identities(24, 9000, seed=cells))
    plan = pf.FaultPlan()
    got = pf._slot_cells(port_sim, plan, cells)
    assert got.tolist() == [pf._slot_cell(port_sim, plan, s, cells) for s in range(40)] == [
        jf._slot_cell(jax_sim, jf.FaultPlan(), s, cells) for s in range(40)]
    topo = LatencyTopology(racks=6, zones=3, regions=1)
    with_topo = pf.FaultPlan().with_topology(topo)
    assert pf._slot_cells(port_sim, with_topo, cells).tolist() == [
        topo.zone_of(s) for s in range(40)]


def test_endpoint_slots_match():
    jax_sim, port_sim = _pair(12, 4, identities=_identities(5, 7300, seed=1))
    want = {(ep.hostname, ep.port): s for ep, s in jf.endpoint_slots(jax_sim).items()}
    got = pf.endpoint_slots(port_sim)
    assert {(ep.hostname, ep.port): s for ep, s in got.items()} == want
    assert all(type(ep).__module__ == "rapid_tpu_torch.types" for ep in got)


def test_slot_index_finds_what_endpoint_slots_maps():
    """The replay's lookup equals ``endpoint_slots`` for every seated
    endpoint, duplicates included (the last slot wins, as in the dict),
    and raises KeyError for an endpoint no slot holds."""
    identities = _identities(6, 7400, seed=2)
    identities[4] = identities[1]  # slots 1 and 4 share an endpoint
    sim = Simulator(30, seed=8, identities=identities, device="cpu")
    index = pf._SlotIndex(sim)
    slots = pf.endpoint_slots(sim)
    assert all(index[ep] == s for ep, s in slots.items())
    assert index[pf.Endpoint(b"127.0.0.1", 7401)] == 4
    for missing in (pf.Endpoint(b"127.0.0.1", 7499), pf.Endpoint(b"127.0.0.2", 7400)):
        with pytest.raises(KeyError):
            index[missing]


def test_apply_topology_matches_jax_and_checks_groups():
    kw = dict(racks=6, zones=3, regions=2, rack_rtt_ms=0, zone_rtt_ms=2, region_rtt_ms=4,
              inter_region_rtt_ms=4000)
    config = dict(capacity=36, groups=3, max_delivery_delay=2)
    jax_sim, port_sim = _pair(36, 3, config)
    jf.apply_topology(jax_sim, JaxTopology(**kw))
    pf.apply_topology(port_sim, LatencyTopology(**kw))
    assert port_sim.group_of.tolist() == np.asarray(jax_sim.group_of).tolist()
    assert port_sim._deliver_delay.tolist() == np.asarray(jax_sim._deliver_delay).tolist()
    assert port_sim._deliver_delay.any()
    small = Simulator(36, config=SimConfig(capacity=36, groups=2), device="cpu")
    with pytest.raises(pf.UnsupportedDeviceFault, match="3 zones"):
        pf.apply_topology(small, LatencyTopology(**kw))


def test_port_gray_dimension_equals_the_golden_file():
    got, misses = chip_smoke.gray_golden_check("cpu")
    assert misses == []
    assert got["gray_slow_node"]["speedup"] >= 2 and got["gray_flapping"]["speedup"] >= 2


def test_jax_gray_dimension_still_equals_the_golden_file():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))
    import generate_torch_gray

    with open(chip_smoke.GRAY_GOLDEN) as f:
        want = json.load(f)["run"]
    got = json.loads(json.dumps(generate_torch_gray.jax_run()))
    assert chip_smoke._golden_misses(got, want) == []
