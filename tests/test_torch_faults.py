"""The JAX package's fault plane drives the port: ``faults.apply_plan_at``,
``apply_topology`` and ``replay_on_simulator`` call only members the port's
Simulator shares with the JAX one, so one FaultPlan replays on both. The
replays of tests/test_faults.py and tests/test_gray_failures.py must give
the same records exactly, lossy ones included, and the port's own ``LatencyTopology`` and ``configuration_id_vectorized``
equal the JAX package's."""

import numpy as np
import pytest

from rapid_tpu import Endpoint
from rapid_tpu.faults import FaultPlan, apply_plan_at, endpoint_slots, replay_on_simulator
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxConfig
from rapid_tpu.sim.topology import LatencyTopology as JaxTopology
from rapid_tpu.sim.topology import configuration_id_vectorized as jax_config_id
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.sim.engine import SimConfig
from rapid_tpu_torch.sim.topology import LatencyTopology, configuration_id_vectorized

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _pair(n, seed, config=None, **kw):
    """(JAX simulator, port simulator), seeded alike."""
    jax_config = None if config is None else JaxConfig(**config)
    port_config = None if config is None else SimConfig(**config)
    return (JaxSimulator(n, config=jax_config, seed=seed, **kw),
            Simulator(n, config=port_config, seed=seed, device="cpu", **kw))


def _records(records):
    return [(tuple(int(c) for c in r.cut), r.configuration_id, r.virtual_time_ms,
             r.membership_size) for r in records]


def _identities(n, base, seed):
    """Seated endpoints 127.0.0.1:base+i with NodeIds drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**63), 2**63, size=(n, 2), dtype=np.int64)
    return [(b"127.0.0.1", base + i, int(hi), int(lo)) for i, (hi, lo) in enumerate(ids)]


def test_flip_flop_windows_drive_the_device_fault_arrays():
    """Twin of tests/test_faults.py's: a flip-flop plan's windows set and
    clear the port's partition set exactly as the JAX simulator's."""
    for sim in _pair(4, 2):
        slots = endpoint_slots(sim)
        victim = next(ep for ep, s in slots.items() if s == 3)
        plan = FaultPlan(seed=0).flip_flop(period_ms=2000, dst=victim)
        seen = []
        for t_ms in (500, 1500, 2500):
            apply_plan_at(sim, plan, t_ms=t_ms, slots=slots)
            seen.append(set(sim._ingress_partitioned))
        assert seen == [{3}, set(), {3}]


@pytest.mark.parametrize("rule", ["partition", "slow_node"])
def test_seated_identities_replay_alike(rule):
    """The device-plane halves of tests/test_faults.py's three-plane test
    (a one-way partition) and tests/test_gray_failures.py's slow-node test:
    seated identities, one plan, one cut, the same configuration id."""
    n = 5
    identities = _identities(n, 7100, seed=3)
    victim = Endpoint.from_parts("127.0.0.1", 7100 + n - 1)
    out = []
    for sim in _pair(n, 5, identities=identities):
        plan = FaultPlan(seed=7)
        if rule == "partition":
            plan.partition_one_way(dst=victim)
        else:
            plan.slow_node(victim, response_delay_ms=5000)
        records = replay_on_simulator(sim, plan, duration_ms=40_000)
        assert [[int(c) for c in r.cut] for r in records] == [[n - 1]]
        out.append((_records(records), sim.virtual_ms, sim.configuration_id()))
    assert out[1] == out[0]


def _zone_loss_replay(make, topology, seed):
    """tests/test_gray_failures.py's zone-loss replay: 64 members on a WAN
    topology of 4 zones, zone 3 partitioned from t = 2000 ms."""
    n = 64
    topo = topology(racks=8, zones=4, regions=2, rack_rtt_ms=0, zone_rtt_ms=2,
                    region_rtt_ms=4, inter_region_rtt_ms=1000)
    sim = make(seed)
    by_slot = {slot: ep for ep, slot in endpoint_slots(sim).items()}
    victims = [i for i in range(n) if topo.zone_of(i) == 3]
    plan = FaultPlan(seed=seed).with_topology(topo)
    for v in victims:
        plan.partition_one_way(dst=by_slot[v], windows=((2000, None),))
    records = replay_on_simulator(sim, plan, duration_ms=60_000)
    assert sorted({int(c) for rec in records for c in rec.cut}) == victims
    return _records(records), sim.group_of.tolist(), sim._deliver_delay.tolist()


@pytest.mark.parametrize("seed", [31, 32])
def test_topology_zone_loss_replay_matches_jax(seed):
    config = dict(capacity=64, groups=4, max_delivery_delay=2, rounds_per_interval=4)
    want = _zone_loss_replay(
        lambda s: JaxSimulator(64, config=JaxConfig(**config), seed=s), JaxTopology, seed)
    got = _zone_loss_replay(
        lambda s: Simulator(64, config=SimConfig(**config), seed=s, device="cpu"),
        LatencyTopology, seed)
    assert got == want


def test_lossy_link_replay_decides_the_same_cut():
    """A lossy link (loss 0.7 to one member) compiles onto ingress loss: the
    port draws threefry's bits from the same key, so the twins' records,
    rounds and final keys are equal."""
    outs = []
    for sim in _pair(24, 6):
        victim = next(ep for ep, s in endpoint_slots(sim).items() if s == 9)
        plan = FaultPlan(seed=4).lossy_link(0.7, dst=victim)
        records = replay_on_simulator(sim, plan, duration_ms=80_000)
        outs.append((_records(records), sim.metrics.get("rounds"),
                     np.asarray(sim.state.rng_key).astype(np.uint32).tolist()))
        assert sim._drop_prob[9] == pytest.approx(0.7)
    assert outs[1] == outs[0]
    assert [cut for cut, *_ in outs[1][0]] == [(9,)]


def test_partition_windows_replay_alike():
    """Partition windows over two members, the first closing before its
    probes can reach the threshold: only the second is cut."""
    outs = []
    for sim in _pair(20, 8):
        by_slot = {s: ep for ep, s in endpoint_slots(sim).items()}
        plan = (FaultPlan(seed=1)
                .partition_one_way(dst=by_slot[4], windows=((0, 6000),))
                .partition_one_way(dst=by_slot[11], windows=((3000, None),)))
        outs.append(_records(replay_on_simulator(sim, plan, duration_ms=40_000)))
    assert outs[1] == outs[0]
    assert [cut for cut, *_ in outs[1]] == [(11,)]


# -- the port's topology copies ----------------------------------------------


@pytest.mark.parametrize("shape", [(4, 2, 1), (8, 4, 2), (6, 3, 3), (5, 5, 1)])
def test_latency_topology_matches_jax(shape):
    racks, zones, regions = shape
    kw = dict(racks=racks, zones=zones, regions=regions, rack_rtt_ms=1, zone_rtt_ms=4,
              region_rtt_ms=20, inter_region_rtt_ms=150)
    jax_topo, topo = JaxTopology(**kw), LatencyTopology(**kw)
    np.testing.assert_array_equal(topo.rtt_matrix(40), jax_topo.rtt_matrix(40))
    np.testing.assert_array_equal(topo.group_assignment(64), jax_topo.group_assignment(64))
    for a in range(zones):
        for b in range(zones):
            for round_ms in (1, 25, 250, 1000):
                assert topo.delay_rounds(a, b, round_ms) == jax_topo.delay_rounds(a, b, round_ms)
    for i in range(12):
        assert (topo.rack_of(i), topo.zone_of(i), topo.region_of(i), topo.one_way_ms(i, 3)) == (
            jax_topo.rack_of(i), jax_topo.zone_of(i), jax_topo.region_of(i),
            jax_topo.one_way_ms(i, 3))


def test_latency_topology_validation():
    with pytest.raises(ValueError):
        LatencyTopology(racks=2, zones=4)
    with pytest.raises(ValueError):
        LatencyTopology(zone_rtt_ms=10, region_rtt_ms=5)


@pytest.mark.parametrize("n", [1, 7, 200])
def test_configuration_id_vectorized_matches_jax(n):
    rng = np.random.default_rng(n)
    hosts = rng.integers(ord("a"), ord("z"), size=(n, 12), dtype=np.uint8)
    lengths = rng.integers(4, 13, size=n).astype(np.int64)
    args = (rng.integers(-(2**63), 2**63, size=n, dtype=np.int64),
            rng.integers(-(2**63), 2**63, size=n, dtype=np.int64),
            hosts, lengths, rng.integers(1, 65536, size=n).astype(np.int64))
    assert configuration_id_vectorized(*args) == jax_config_id(*args)


def test_configuration_id_vectorized_equals_the_simulator_fold():
    sim = Simulator(12, seed=3, device="cpu")
    order = np.lexsort((sim.cluster.id_low[:12], sim.cluster.id_high[:12]))
    from rapid_tpu_torch.sim.topology import ring_order

    ring0 = ring_order(sim.cluster, sim.active, 0)
    got = configuration_id_vectorized(
        sim.cluster.id_high[order], sim.cluster.id_low[order],
        sim.cluster.hostnames[ring0], sim.cluster.host_lengths[ring0], sim.cluster.ports[ring0])
    assert got == sim.configuration_id()
