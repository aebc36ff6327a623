"""The port's fault plans (``rapid_tpu_torch/faults.py``, the plan half of
``rapid_tpu/faults.py``) against the JAX package's: JSON round trips for
every rule kind in both directions, the builders' checks, and identical
``Nemesis.decide`` streams for every rule kind, with a topology and with
cell partitions. The decisions are pure Python keyed hashes, so equality
is exact."""

import json

import pytest

from rapid_tpu import faults as jf
from rapid_tpu import types as jt
from rapid_tpu.sim.topology import LatencyTopology as JaxTopology
from rapid_tpu_torch import faults as pf
from rapid_tpu_torch import types as pt
from rapid_tpu_torch.sim.topology import LatencyTopology

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _full_plan(faults, types, topology_cls=None, topology=True):
    """One plan holding every rule kind, with windows, links and message
    types, built with ``faults``'s builders over ``types``'s classes."""
    a = types.Endpoint.from_parts("10.0.0.1", 7001)
    b = types.Endpoint.from_parts("10.0.0.2", 7002)
    c = types.Endpoint.from_parts("10.0.0.3", 7003)
    plan = (faults.FaultPlan(seed=9)
            .drop(0.4, src=a, msg_types=(types.Put, types.HandoffRequest))
            .partition_one_way(dst=b, windows=((100, 300),))
            .cell_partition(1, 3, windows=((0, 500), (900, None)))
            .flip_flop(400, src=c, dst=a, start_ms=50)
            .delay(5, 7, dst=c)
            .duplicate(0.3, msg_types=(types.ProbeMessage,))
            .reorder(0.5, max_extra_ms=20, src=b, at="ingress")
            .lossy_link(0.25, src=c)
            .slow_node(a, 40, windows=((200, 800),))
            .clock_skew(b, offset_ms=30, rate=1.5)
            .wire_version(c, 2)
            .restart_node(b, windows=((1000, 1200),))
            .torn_write(b, windows=((1000, 1200),), drop_bytes=5, corrupt=True)
            .disk_stall(c, 12))
    if topology:
        plan.with_topology(topology_cls(racks=4, zones=2, regions=1, rack_rtt_ms=1,
                                        zone_rtt_ms=6, region_rtt_ms=20, inter_region_rtt_ms=80),
                           {a: 0, b: 1, c: 3})
    return plan


def test_every_rule_kind_is_in_the_full_plan():
    kinds = {spec["type"] for spec in _full_plan(pf, pt, LatencyTopology).to_json()["rules"]}
    assert kinds == set(pf.RULE_CATALOG) == set(jf.RULE_CATALOG)


@pytest.mark.parametrize("topology", [True, False])
def test_plans_cross_both_ways_as_json(topology):
    jax_plan = _full_plan(jf, jt, JaxTopology, topology)
    port_plan = _full_plan(pf, pt, LatencyTopology, topology)
    assert port_plan.to_json() == jax_plan.to_json()
    crossed = pf.FaultPlan.from_json(json.loads(json.dumps(jax_plan.to_json())))
    assert crossed.to_json() == jax_plan.to_json()
    assert [type(r).__name__ for r in crossed.rules] == [type(r).__name__ for r in jax_plan.rules]
    # message types resolve to the port's own classes
    assert crossed.rules[0].match.msg_types == (pt.Put, pt.HandoffRequest)
    back = jf.FaultPlan.from_json(port_plan.to_json())
    assert back.to_json() == port_plan.to_json()


@pytest.mark.parametrize("bad", [
    {"rules": [{"type": "NoSuchRule"}]},
    {"rules": [{"type": "DropRule", "probability": 0.5, "msg_types": ["NoSuchMessage"]}]},
    {"rules": [{"type": "PartitionRule", "windows": [[10, 5]]}]},
    {"rules": [{"type": "LossyLinkRule", "probability": 1.0}]},
    {"rules": [{"type": "SlowNodeRule", "response_delay_ms": 5}]},
    {"topology_slots": {"10.0.0.1:1": 0}},
    {"topology": {"racks": 2, "nope": 1}},
])
def test_from_json_rejects_what_the_builders_reject(bad):
    for faults in (jf, pf):
        with pytest.raises((ValueError, AssertionError)):
            faults.FaultPlan.from_json(bad)


def test_contradictory_partitions_and_windows_raise():
    for faults, types in ((jf, jt), (pf, pt)):
        b = types.Endpoint.from_parts("10.0.0.2", 7002)
        with pytest.raises(ValueError, match="contradictory"):
            faults.FaultPlan().partition_one_way(dst=b).flip_flop(100, dst=b)
        with pytest.raises(ValueError):
            faults.FaultPlan().drop(0.5, windows=((5, 5),))
        with pytest.raises(ValueError):
            faults.FaultPlan().restart_node(b, windows=((0, None),))


class _Clock:
    def __init__(self):
        self.t = 0

    def now_ms(self):
        return self.t


def _stream(faults, types, topology_cls):
    """Decisions of an armed Nemesis over every (src, dst, message type,
    side) at several plan times, as plain tuples."""
    plan = _full_plan(faults, types, topology_cls)
    clock = _Clock()
    nemesis = faults.Nemesis(plan, clock).arm()
    eps = [types.Endpoint.from_parts(f"10.0.0.{i}", 7000 + i) for i in range(1, 6)]
    msgs = [types.ProbeMessage(sender=eps[0]),
            types.Put(sender=eps[1], key=b"k", value=b"v"),
            types.HandoffRequest(sender=eps[2], session_id=1, partition=2, offset=0, length=9)]
    out = []
    for t in (0, 60, 150, 250, 450, 700, 950, 1100):
        clock.t = t
        for _ in range(3):
            for src in eps + [None]:
                for dst in eps:
                    for msg in msgs:
                        for at in ("egress", "ingress"):
                            d = nemesis.decide(src, dst, msg, at)
                            out.append((d.drop, d.delay_ms, d.duplicates, d.reordered,
                                        d.slow_ms, d.wire_version))
    rng = nemesis.retry_rng(eps[0])
    return out, [rng.random() for _ in range(4)], nemesis.plan_now_ms()


def test_nemesis_decisions_equal_for_every_rule_kind():
    got = _stream(pf, pt, LatencyTopology)
    want = _stream(jf, jt, JaxTopology)
    assert got == want
    decisions = got[0]
    assert any(d[0] for d in decisions) and any(d[2] for d in decisions)
    assert any(d[3] for d in decisions) and any(d[4] for d in decisions)
    assert any(d[5] == 2 for d in decisions) and any(d[1] for d in decisions)


def test_u01_and_cell_partitions_match():
    assert [pf._u01(s, "a", 3, None) for s in range(-3, 40)] == [
        jf._u01(s, "a", 3, None) for s in range(-3, 40)]
    plans = [faults.FaultPlan(seed=1).cell_partition(0, 4) for faults in (jf, pf)]
    for faults, types, plan in ((jf, jt, plans[0]), (pf, pt, plans[1])):
        nemesis = faults.Nemesis(plan, _Clock()).arm()
        eps = [types.Endpoint.from_parts("10.1.0.%d" % i, 9000 + i) for i in range(24)]
        probe = types.ProbeMessage(sender=eps[0])
        plan.decisions = [nemesis.decide(s, d, probe, "egress").drop for s in eps for d in eps]
    assert plans[0].decisions == plans[1].decisions
    assert any(plans[1].decisions) and not all(plans[1].decisions)
