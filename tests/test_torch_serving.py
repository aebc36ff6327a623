"""The port's serving and durability planes against the JAX package's, on
the CPU.

``serving/kv.py``'s blobs against the C MessagePack library under
hypothesis (handoff fingerprints and the reconcile compare blobs, so the
bytes must be msgpack's), key routing, twins of tests/test_serving.py's
simulator cases (the same churn workload on both simulators: the same acks,
histories, acked sets, metrics, latencies and virtual clocks, with and
without a fault plan on the replication wire, both histories linearizable
by the JAX package's checker), and new twins of the durability mirror
(``enable_durability``, ``checkpoint_slot``, ``restart_slot``), which the
JAX package does not test.
"""

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rapid_tpu.faults import FaultPlan as JaxFaultPlan
from rapid_tpu.search.checkers import check_linearizable_single_client
from rapid_tpu.serving.kv import encode_kv as jax_encode_kv
from rapid_tpu.serving.kv import partition_of as jax_partition_of
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.types import Put as JaxPut
from rapid_tpu_torch.faults import FaultPlan
from rapid_tpu_torch.serving import SERVING_SEED, decode_kv, encode_kv, partition_of
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.types import Put, PutAck

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

SIM_METRICS = (
    "serving.gets", "serving.puts", "serving.put_acks",
    "serving.put_retries", "serving.replication_writes",
    "serving.leader_reads", "serving.quorum_reads",
    "serving.not_leader_redirects", "serving.leader_changes",
    "serving.reconciled_replicas",
)

KV = st.dictionaries(
    st.binary(max_size=40),
    st.tuples(st.integers(0, 2**63 - 1), st.binary(max_size=300)),
    max_size=12,
)


@settings(max_examples=300, deadline=None)
@given(KV)
def test_kv_blobs_are_msgpacks_bytes(kv):
    """encode_kv is ``msgpack.packb(..., use_bin_type=True)`` byte for byte
    (keys and values as bin, versions in the smallest int format), and
    decode_kv reads back what the C library wrote."""
    want = msgpack.packb([[k, v, b] for k, (v, b) in sorted(kv.items())], use_bin_type=True)
    blob = encode_kv(kv)
    assert blob == want == jax_encode_kv(kv)
    assert decode_kv(want) == kv


def test_kv_blob_codec_is_deterministic():
    kv = {b"b": (2, b"vb"), b"a": (1, b"va"), b"c": (9, b"")}
    assert encode_kv(kv) == encode_kv(dict(sorted(kv.items(), reverse=True)))
    assert decode_kv(encode_kv(kv)) == kv
    assert decode_kv(None) == {} and decode_kv(encode_kv({})) == {}


def test_partition_of_matches_jax():
    assert SERVING_SEED == 0x5E41
    for i in range(512):
        key = b"key-%d" % i
        assert partition_of(key, 16) == jax_partition_of(key, 16)
        assert partition_of(key, 8192) == jax_partition_of(key, 8192)
    with pytest.raises(ValueError):
        partition_of(b"abc", 0)


# ---------------------------------------------------------------------- #
# The simulator
# ---------------------------------------------------------------------- #

def _port_sim(*args, **kw):
    return Simulator(*args, device="cpu", **kw)


def _run_sim_serving(make, fault_plan=None, seed=11, durability=False):
    """tests/test_serving.py's churn workload: writes, a crash (reads ride
    the churn window), the view change, then a join wave with more
    traffic; with ``durability`` a checkpoint and a slot restart too."""
    sim = make(4, capacity=5, seed=seed).ready()
    sim.enable_placement(partitions=32, replicas=3, seed=7)
    sim.enable_handoff(chunk_size=1024)
    sim.enable_serving(request_ms=1, fault_plan=fault_plan)
    if durability:
        sim.enable_durability(replay_record_ms=2)
    history = []
    keys = [b"sim-%02d" % i for i in range(24)]

    def put(key, value):
        ack = sim.serving_put(key, value)
        history.append(("put", key, value, ack.version, ack.status))

    def get(key):
        ack = sim.serving_get(key)
        history.append(("get", key, ack.value, ack.version, ack.status))

    for i, key in enumerate(keys):
        put(key, b"a-%d" % i)
    if durability:
        sim.checkpoint_slot(2)
    sim.crash(np.array([1]))
    for key in keys:
        get(key)
    assert sim.run_until_decision(max_rounds=20_000) is not None
    for i, key in enumerate(keys[:12]):
        put(key, b"b-%d" % i)
    sim.request_joins(np.array([4]))
    assert sim.run_until_decision(max_rounds=20_000) is not None
    for key in keys:
        get(key)
    return sim, history


def _digest(sim):
    return {
        "metrics": {m: sim.metrics.get(m) for m in SIM_METRICS},
        "virtual_ms": sim.virtual_ms,
        "acked": sim.serving_acked,
        "request_ms": sim.metrics.histogram("serving.request_ms"),
        "stores": {slot: store.digest() for slot, store in sim.handoff_stores.items()},
        "journal": [(e["kind"], e["virtual_ms"],
                     {k: v for k, v in e["detail"].items() if k != "trace_id"})
                    for e in sim.recorder.tail(4096)],
    }


def test_sim_serving_requires_handoff():
    for make in (JaxSimulator, _port_sim):
        sim = make(3, capacity=3, seed=1)
        with pytest.raises(RuntimeError):
            sim.enable_serving()
        sim.enable_placement(partitions=8, replicas=2)
        with pytest.raises(RuntimeError):
            sim.enable_serving()
        with pytest.raises(RuntimeError):
            sim.serving_put(b"k", b"v")
        with pytest.raises(RuntimeError):
            sim.serving_get(b"k")
        with pytest.raises(RuntimeError):
            sim.serving_drive_open_loop([])


def test_sim_serving_deterministic_and_lossless():
    """Twin of tests/test_serving.py's: identical trajectories, histories
    and clocks run to run and across packages; zero acknowledged writes
    lost across the crash + join churn; the stores hold the blobs."""
    jax_sim, jax_hist = _run_sim_serving(JaxSimulator)
    sim_a, hist_a = _run_sim_serving(_port_sim)
    sim_b, hist_b = _run_sim_serving(_port_sim)
    assert hist_a == hist_b == jax_hist
    assert _digest(sim_a) == _digest(sim_b) == _digest(jax_sim)
    snap = _digest(sim_a)["metrics"]
    assert snap["serving.puts"] > 0 and snap["serving.gets"] > 0
    assert snap["serving.leader_reads"] > 0 and snap["serving.quorum_reads"] > 0
    assert snap["serving.leader_changes"] > 0
    for key, (version, value) in sim_a.serving_acked.items():
        back = sim_a.serving_get(key)
        assert back.status == PutAck.STATUS_OK and back.version >= version
        if back.version == version:
            assert back.value == value
    p = partition_of(b"sim-00", 32)
    holders = [int(s) for s in sim_a.placement.assign[p] if s >= 0]
    assert all(b"sim-00" in decode_kv(sim_a.handoff_stores[s].get(p)) for s in holders)


@pytest.mark.parametrize("plan_from", ["jax", "port"])
def test_sim_serving_nemesis_replayable(plan_from):
    """Twin of tests/test_serving.py's: a plan on the replication wire
    replays bit-identically on both packages, bites (unacked writes) and
    never loses an acknowledged write."""
    def plan():
        if plan_from == "jax":
            return JaxFaultPlan(seed=5).drop(0.5, msg_types=(JaxPut,)).duplicate(
                0.3, msg_types=(JaxPut,))
        return FaultPlan(seed=5).drop(0.5, msg_types=(Put,)).duplicate(0.3, msg_types=(Put,))

    jax_sim, jax_hist = _run_sim_serving(
        JaxSimulator, fault_plan=JaxFaultPlan(seed=5).drop(0.5, msg_types=(JaxPut,)).duplicate(
            0.3, msg_types=(JaxPut,)))
    sim_a, hist_a = _run_sim_serving(_port_sim, fault_plan=plan())
    sim_b, hist_b = _run_sim_serving(_port_sim, fault_plan=plan())
    assert hist_a == hist_b == jax_hist
    assert _digest(sim_a) == _digest(sim_b) == _digest(jax_sim)
    assert sim_a.metrics.get("serving.put_retries") > 0, "nemesis never bit a write"
    for key, (version, _value) in sim_a.serving_acked.items():
        back = sim_a.serving_get(key)
        assert back.status == PutAck.STATUS_OK and back.version >= version


def test_sim_serving_history_linearizable():
    """Twin of tests/test_serving.py's: the JAX package's checker passes
    both packages' histories, which are the same history."""
    for jax_plan, port_plan in ((None, None),
                                (JaxFaultPlan(seed=5).drop(0.5, msg_types=(JaxPut,)),
                                 FaultPlan(seed=5).drop(0.5, msg_types=(Put,)))):
        _, jax_history = _run_sim_serving(JaxSimulator, fault_plan=jax_plan)
        _, history = _run_sim_serving(_port_sim, fault_plan=port_plan)
        assert history and history == jax_history
        check_linearizable_single_client(history)
        check_linearizable_single_client(jax_history)


def test_sim_serving_disk_stall_bills_the_slow_replica():
    """A disk-stall rule on the Put wire delays quorum writes (slow_ms)
    alike on both packages."""
    jax_sim, jax_hist = _run_sim_serving(JaxSimulator, fault_plan=JaxFaultPlan(seed=2).disk_stall(
        JaxSimulator(4, capacity=5, seed=11)._serving_ep(2), 7))
    port_sim, port_hist = _run_sim_serving(_port_sim, fault_plan=FaultPlan(seed=2).disk_stall(
        _port_sim(4, capacity=5, seed=11)._serving_ep(2), 7))
    assert port_hist == jax_hist and _digest(port_sim) == _digest(jax_sim)
    assert port_sim.virtual_ms > _run_sim_serving(_port_sim)[0].virtual_ms


# ---------------------------------------------------------------------- #
# Durability mirror
# ---------------------------------------------------------------------- #

def test_durability_requires_serving_and_enabling():
    for make in (JaxSimulator, _port_sim):
        sim = make(3, capacity=3, seed=1)
        with pytest.raises(RuntimeError):
            sim.enable_durability()
        with pytest.raises(RuntimeError):
            sim.checkpoint_slot(0)
        with pytest.raises(RuntimeError):
            sim.restart_slot(0)
        assert sim.durable_pending(0) == 0


def test_durability_replays_and_checkpoints_like_jax():
    """Every persisted blob is one WAL record; a checkpoint clears a slot's
    debt; a restart replays the debt on the virtual clock, journals the
    recovery and revives the slot -- alike on both packages."""
    out = []
    for make in (JaxSimulator, _port_sim):
        sim, history = _run_sim_serving(make, durability=True)
        pending = [sim.durable_pending(s) for s in range(5)]
        assert sum(pending) > 0
        before = sim.virtual_ms
        replays = [sim.restart_slot(s, down_ms=10 * s) for s in range(4)]
        assert replays == pending[:4]
        assert sim.virtual_ms == before + sum(10 * s + 2 * r for s, r in enumerate(replays))
        assert sim.alive[:4].tolist() == [True, False, True, True]  # 1 stays evicted
        sim.checkpoint_slot(3)
        assert sim.durable_pending(3) == 0 and sim.restart_slot(3) == 0
        out.append((history, pending, replays, _digest(sim),
                    sim.metrics.get("durability.replayed_records"),
                    sim.metrics.get("durability.snapshots")))
    assert out[0] == out[1]
    assert out[1][4] == sum(out[1][2]) and out[1][5] == 2
