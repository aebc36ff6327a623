"""The port's handoff plane against the JAX package's, on the CPU.

The planner's pieces (chunk schedule, content fingerprint, session ids,
object-plane plans, the vectorized plans over assignment arrays), the
reference store, the golden transfer plans, and twins of
tests/test_handoff.py's simulator cases: the same churn on both
simulators gives the same transfer plans, counters, stores, journal and
virtual clock, with and without a fault plan (the JAX package's own plan
crossing into the port through its JSON form, or the port's copy).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from rapid_tpu.faults import FaultPlan as JaxFaultPlan
from rapid_tpu.handoff.device import device_transfer_plans as jax_device_plans
from rapid_tpu.handoff.plan import plan_transfers as jax_plan_transfers
from rapid_tpu.placement import PlacementConfig as JaxConfig
from rapid_tpu.placement import build_map as jax_build_map
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu.types import HandoffRequest as JaxHandoffRequest
from rapid_tpu_torch.faults import FaultPlan
from rapid_tpu_torch.handoff import (
    InMemoryPartitionStore,
    chunk_spans,
    content_fingerprint,
    plan_transfers,
    session_key,
)
from rapid_tpu_torch.handoff.device import device_transfer_plans, session_keys_batch
from rapid_tpu_torch.placement import PlacementConfig, build_map, diff_maps
from rapid_tpu_torch.placement.device import DevicePlacement
from rapid_tpu_torch.placement.engine import node_key64
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.types import Endpoint, HandoffRequest

from golden import fixtures as fx

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_vectors.json").read_text())

SIM_METRICS = (
    "handoff.sessions_started", "handoff.sessions_completed",
    "handoff.sessions_failed", "handoff.chunks_sent",
    "handoff.chunks_received", "handoff.chunks_duplicate",
    "handoff.bytes_moved", "handoff.retries", "handoff.failovers",
    "handoff.releases",
)


def members(n):
    return [Endpoint.from_parts(f"10.0.0.{i + 1}", 7000 + i) for i in range(n)]


# ---------------------------------------------------------------------- #
# The planning core
# ---------------------------------------------------------------------- #

def test_chunk_spans_schedule():
    assert chunk_spans(0, 1024) == ()
    assert chunk_spans(2500, 1024) == ((0, 1024), (1024, 1024), (2048, 452))
    assert chunk_spans(70977, 1 << 16) == ((0, 65536), (65536, 5441))
    with pytest.raises(ValueError):
        chunk_spans(10, 0)


@pytest.mark.parametrize("partition,data", [(3, b"identical bytes"), (4, b"identical bytes"),
                                            (0, b""), (2**40, bytes(range(256)) * 40)])
def test_content_fingerprint_matches_jax(partition, data):
    from rapid_tpu.handoff.plan import content_fingerprint as jax_fp

    assert content_fingerprint(partition, data) == jax_fp(partition, data)


def test_session_keys_match_jax_scalar_and_batch():
    from rapid_tpu.handoff.device import session_keys_batch as jax_batch
    from rapid_tpu.handoff.plan import session_key as jax_key

    rng = np.random.default_rng(5)
    partitions = rng.integers(0, 1 << 20, size=64).astype(np.int64)
    keys = rng.integers(-(1 << 62), 1 << 62, size=64).astype(np.int64)
    for version in (7, -1234567890123, 0):
        batch = session_keys_batch(version, partitions, keys, seed=11)
        assert np.array_equal(batch, jax_batch(version, partitions, keys, seed=11))
        for i in range(64):
            assert int(batch[i]) == session_key(version, int(partitions[i]), int(keys[i]), 11)
            assert int(batch[i]) == jax_key(version, int(partitions[i]), int(keys[i]), 11)


def test_inmemory_store_roundtrip():
    store = InMemoryPartitionStore()
    assert store.get(1) is None and store.fingerprint(1) is None and store.partitions() == ()
    store.put(1, b"abc")
    store.put(9, b"")
    assert store.partitions() == (1, 9)
    assert store.fingerprint(1) == content_fingerprint(1, b"abc")
    assert store.sizes() == {1: 3, 9: 0}
    assert store.digest() == ((1, 9), (store.fingerprint(1), store.fingerprint(9)))
    store.put(1, b"abcd", fingerprint=content_fingerprint(1, b"abcd"))
    assert store.fingerprint(1) == content_fingerprint(1, b"abcd")
    store.delete(1)
    assert store.get(1) is None and store.partitions() == (9,)


def test_plan_transfers_match_jax_and_the_vectorized_plans():
    """The object-plane plans of a crash equal the JAX package's, and the
    vectorized plans over the port's device placement name the same slots."""
    eps = members(8)
    cfg = PlacementConfig(partitions=64, replicas=3, seed=2)
    jcfg = JaxConfig(partitions=64, replicas=3, seed=2)
    sizes = {p: (p * 977) % 5000 for p in range(64)}
    dead = eps[3]
    old_map = build_map(eps, {}, cfg, configuration_id=1)
    new_map = build_map([e for e in eps if e != dead], {}, cfg, configuration_id=2)
    jeps = [JaxEndpoint(e.hostname, e.port) for e in eps]
    jold = jax_build_map(jeps, {}, jcfg, 1)
    jnew = jax_build_map([e for e in jeps if e != jeps[3]], {}, jcfg, 2)
    plans = plan_transfers(old_map, new_map, sizes, chunk_size=1024)
    jplans = jax_plan_transfers(jold, jnew, sizes, chunk_size=1024)
    assert [(p.partition, str(p.recipient), [str(s) for s in p.sources], p.size, p.chunks,
             p.session_id) for p in plans] == [
        (p.partition, str(p.recipient), [str(s) for s in p.sources], p.size, p.chunks,
         p.session_id) for p in jplans]
    assert {p.partition for p in plans} == set(diff_maps(old_map, new_map).partitions_moved)
    for plan in plans:
        assert plan.session_id == session_key(
            new_map.version, plan.partition, node_key64(plan.recipient, 2), 2)
    # the vectorized planner over slot arrays (the universe is sorted like the view)
    universe = sorted(eps)
    hostnames = np.zeros((8, 8), np.uint8)
    for slot, ep in enumerate(universe):
        hostnames[slot, : len(ep.hostname)] = np.frombuffer(ep.hostname, np.uint8)
    lengths = np.array([len(e.hostname) for e in universe], np.int64)
    ports = np.array([e.port for e in universe], np.int64)
    placement = DevicePlacement(cfg, hostnames, lengths, ports, device="cpu")
    active = np.ones(8, bool)
    placement.build(active)
    old_assign = placement.assign.copy()
    active[universe.index(dead)] = False
    placement.apply_view_change(active)
    size_arr = np.array([sizes[p] for p in range(64)], np.int64)
    args = (old_assign, placement.assign, active, placement.keys64, placement.version, 2,
            size_arr, 1024)
    dplans = device_transfer_plans(*args)
    assert [dataclasses.astuple(p) for p in dplans] == [
        dataclasses.astuple(p) for p in jax_device_plans(*args)]
    assert [(p.partition, str(universe[p.recipient]), [str(universe[s]) for s in p.sources],
             p.session_id) for p in dplans] == [
        (p.partition, str(p.recipient), [str(s) for s in p.sources], p.session_id)
        for p in plans]
    with pytest.raises(ValueError):
        plan_transfers(build_map(eps, {}, PlacementConfig(8, 2, 1), 1),
                       build_map(eps, {}, PlacementConfig(8, 2, 2), 1))


def test_handoff_plans_match_golden():
    """The golden per-transition session lists from the port's vectorized
    planner over its device placement (tests/golden/parity_vectors.json)."""
    spec = GOLDEN["placement"]["config"]
    config = PlacementConfig(partitions=spec["partitions"], replicas=spec["replicas"],
                             seed=spec["seed"])
    ep = {i: Endpoint(fx.member(i)[0].hostname, fx.member(i)[0].port) for i in range(25)}
    by_name = {str(e): e for e in ep.values()}
    weights = {by_name[n]: w for n, w in GOLDEN["placement"]["weights"].items()}
    universe = sorted(ep.values())
    hostnames = np.zeros((25, max(len(e.hostname) for e in universe)), np.uint8)
    for slot, e in enumerate(universe):
        hostnames[slot, : len(e.hostname)] = np.frombuffer(e.hostname, np.uint8)
    lengths = np.array([len(e.hostname) for e in universe], np.int64)
    ports = np.array([e.port for e in universe], np.int64)
    w = np.array([weights.get(e, 1) for e in universe], np.int32)
    sizes = {int(p): s for p, s in GOLDEN["handoff"]["sizes"].items()}
    size_arr = np.array([sizes[p] for p in range(config.partitions)], np.int64)
    chunk_size = GOLDEN["handoff"]["chunk_size"]
    placement = DevicePlacement(config, hostnames, lengths, ports, w, device="cpu")
    slot_of = {e: s for s, e in enumerate(universe)}
    prev = None
    for name, live in (("initial20", set(range(20))),
                       ("after_delete3", set(range(20)) - set(fx.DELETED)),
                       ("after_add5", set(range(25)) - set(fx.DELETED))):
        active = np.zeros(25, bool)
        active[[slot_of[ep[i]] for i in live]] = True
        if prev is None:
            placement.build(active)
        else:
            placement.apply_view_change(active)
            plans = device_transfer_plans(prev, placement.assign, active, placement.keys64,
                                          placement.version, config.seed, size_arr, chunk_size)
            golden = GOLDEN["handoff"]["transitions"][name]
            assert [{"partition": p.partition, "recipient": str(universe[p.recipient]),
                     "sources": [str(universe[s]) for s in p.sources], "size": p.size,
                     "chunks": len(p.chunks), "session_id": p.session_id}
                    for p in plans] == golden, name
        prev = placement.assign.copy()


# ---------------------------------------------------------------------- #
# The simulator
# ---------------------------------------------------------------------- #

def _run_sim_churn(make, fault_plan=None):
    sim = make(3, capacity=5, seed=11).ready()
    sim.enable_placement(partitions=32, replicas=2, seed=7)
    sim.enable_handoff(chunk_size=1024, fault_plan=fault_plan)
    sim.request_joins(np.array([3]))
    assert sim.run_until_decision(max_rounds=20_000) is not None
    sim.crash(np.array([0]))
    assert sim.run_until_decision(max_rounds=20_000) is not None
    return sim


def _jax_sim(*args, **kw):
    return JaxSimulator(*args, **kw)


def _port_sim(*args, **kw):
    return Simulator(*args, device="cpu", **kw)


def _digest(sim):
    """Everything the handoff plane leaves behind, comparable across packages."""
    return {
        "metrics": {m: sim.metrics.get(m) for m in SIM_METRICS},
        "virtual_ms": sim.virtual_ms,
        "transfers": [[(p.partition, p.recipient, p.sources, p.size, p.chunks, p.session_id)
                       for p in plans] for plans in sim.handoff_transfers],
        "stores": {slot: store.digest() for slot, store in sim.handoff_stores.items()},
        # trace ids come from each package's process-wide span counter
        "journal": [(e["kind"], e["virtual_ms"],
                     {k: v for k, v in e["detail"].items() if k != "trace_id"})
                    for e in sim.recorder.tail(4096)],
        "histograms": {k: v for k, v in sim.metrics.histograms().items() if "handoff" in k},
    }


def _verify_sim_stores(sim):
    sizes = sim._handoff_sizes
    for p, row in enumerate(sim.placement.assign):
        expect = Simulator._handoff_payload(p, int(sizes[p]))
        for slot in row:
            if slot >= 0:
                assert sim.handoff_stores[int(slot)].get(p) == expect


def test_sim_handoff_churn_completes_all_transfers():
    """Twin of tests/test_handoff.py's: join + crash churn, every session
    completes, every owner holds byte-correct content -- and everything the
    plane leaves behind equals the JAX simulator's."""
    jax_sim, port_sim = _run_sim_churn(_jax_sim), _run_sim_churn(_port_sim)
    snap = {m: port_sim.metrics.get(m) for m in SIM_METRICS}
    assert snap["handoff.sessions_started"] > 0
    assert snap["handoff.sessions_completed"] == snap["handoff.sessions_started"]
    assert snap["handoff.sessions_failed"] == 0 and snap["handoff.bytes_moved"] > 0
    assert len(port_sim.handoff_transfers) == 2 and all(port_sim.handoff_transfers)
    _verify_sim_stores(port_sim)
    assert _digest(port_sim) == _digest(jax_sim)


@pytest.mark.parametrize("plan_from", ["jax", "port"])
def test_sim_handoff_deterministic_under_nemesis(plan_from):
    """Twin of tests/test_handoff.py's: a seeded plan bites (duplicates and
    retries) yet every session completes; the port replays the JAX run
    exactly, given the JAX package's plan object or the port's copy."""
    def jax_plan():
        return (JaxFaultPlan(seed=5).drop(0.3, msg_types=(JaxHandoffRequest,))
                .duplicate(0.2, msg_types=(JaxHandoffRequest,)))

    def port_plan():
        return (FaultPlan(seed=5).drop(0.3, msg_types=(HandoffRequest,))
                .duplicate(0.2, msg_types=(HandoffRequest,)))

    baseline = _run_sim_churn(_port_sim)
    reference = _run_sim_churn(_jax_sim, fault_plan=jax_plan())
    a = _run_sim_churn(_port_sim, fault_plan=jax_plan() if plan_from == "jax" else port_plan())
    b = _run_sim_churn(_port_sim, fault_plan=port_plan())
    assert _digest(a) == _digest(b) == _digest(reference)
    snap = _digest(a)["metrics"]
    assert snap["handoff.chunks_duplicate"] > 0 and snap["handoff.retries"] > 0
    assert snap["handoff.sessions_failed"] == 0
    assert snap["handoff.sessions_completed"] == snap["handoff.sessions_started"]
    assert a.virtual_ms >= baseline.virtual_ms
    _verify_sim_stores(a)


def test_sim_enable_handoff_requires_placement():
    for sim in (JaxSimulator(3, capacity=3, seed=1), Simulator(3, capacity=3, seed=1, device="cpu")):
        with pytest.raises(RuntimeError):
            sim.enable_handoff()
        sim.enable_placement(partitions=8, replicas=2)
        with pytest.raises(ValueError):
            sim.enable_handoff(sizes=np.zeros(3, np.int64))
