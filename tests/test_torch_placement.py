"""The port's placement plane against the JAX package's, on the CPU.

The plain top-R (``placement_topr_plain``, what ``placement_topr`` runs on a
CPU tensor) against JAX's numpy ``topr_full``, its added-column merge and
``build_jit``; the uint32 mix in int64 lanes against numpy's; twins of
tests/test_placement.py's engine/device, weight-change, jitted-build, mesh
and simulator cases; and the golden placement vectors. Exact throughout:
the plane is integer arithmetic.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rapid_tpu.placement import PlacementConfig as JaxConfig
from rapid_tpu.placement import build_map as jax_build_map
from rapid_tpu.placement import diff_maps as jax_diff_maps
from rapid_tpu.placement.device import DevicePlacement as JaxDevicePlacement
from rapid_tpu.placement.device import _composite, _score_matrix, _select_topr
from rapid_tpu.placement.device import build_jit as jax_build_jit
from rapid_tpu.placement.device import topr_full as jax_topr_full
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu_torch.placement import (
    MAX_WEIGHT,
    PlacementConfig,
    build_map,
    diff_maps,
    weight_of,
)
from rapid_tpu_torch.placement import device as pdev
from rapid_tpu_torch.placement.device import DevicePlacement, build_jit, topr_full
from rapid_tpu_torch.runtime import jitwatch
from rapid_tpu_torch.shard.engine import make_mesh
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.types import Endpoint

from golden import fixtures as fx

GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_vectors.json").read_text())


def members(n, base_port=9000):
    return [Endpoint.from_parts(f"10.0.{i // 200}.{i % 200}", base_port + i) for i in range(n)]


def device_universe(eps, weights=None):
    """Column arrays for a *sorted* endpoint universe (tests/test_placement.py's)."""
    eps = sorted(eps)
    max_len = max(len(ep.hostname) for ep in eps)
    hostnames = np.zeros((len(eps), max_len), dtype=np.uint8)
    host_lengths = np.zeros(len(eps), dtype=np.int64)
    ports = np.zeros(len(eps), dtype=np.int64)
    w = np.ones(len(eps), dtype=np.int32)
    for slot, ep in enumerate(eps):
        hostnames[slot, : len(ep.hostname)] = np.frombuffer(ep.hostname, np.uint8)
        host_lengths[slot] = len(ep.hostname)
        ports[slot] = ep.port
        if weights:
            w[slot] = weights.get(ep, 1)
    return eps, hostnames, host_lengths, ports, w


def rows_as_endpoints(assign, eps):
    return [tuple(eps[int(s)] for s in row if s >= 0) for row in assign]


def _jax(ep):
    return JaxEndpoint(ep.hostname, ep.port)


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


# ---------------------------------------------------------------------- #
# The arithmetic and the plain top-R
# ---------------------------------------------------------------------- #

U32 = st.integers(0, 2**32 - 1)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(U32, U32), min_size=1, max_size=64))
def test_mix32_in_int64_lanes_wraps_like_uint32(pairs):
    """The mix's multiplies leave int64's sign but keep their low 32 bits:
    the int64-lane mix equals numpy's uint32 lanes for any operands."""
    a = np.array([p[0] for p in pairs], dtype=np.uint32)
    b = np.array([p[1] for p in pairs], dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = (a ^ b) * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0xC2B2AE35)
        want = h ^ (h >> np.uint32(13))
    got = pdev._mix32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@st.composite
def topr_inputs(draw):
    rows = draw(st.integers(1, 12))
    cols = draw(st.integers(1, 24))
    n_inst = draw(st.integers(1, 4))
    replicas = draw(st.sampled_from([1, 3, 5]))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
    inst = rng.integers(0, 2**32, (n_inst, cols), dtype=np.uint64).astype(np.uint32)
    if draw(st.booleans()) and cols > 1:
        # ties: a duplicated column scores alike; the lower slot must win
        inst[:, cols - 1] = inst[:, 0]
    if draw(st.booleans()):
        # an operand equal to a partition key mixes to 0: a zero score
        inst[0, rng.integers(cols)] = part[rng.integers(rows)]
    weights = rng.integers(0, n_inst + 1, cols).astype(np.int32)
    if draw(st.booleans()):
        weights[rng.integers(cols)] = MAX_WEIGHT  # more than V: capped by the instances
    active = rng.random(cols) < draw(st.sampled_from([0.0, 0.5, 0.9, 1.0]))
    return part, inst, weights, active, replicas


@settings(max_examples=150, deadline=None)
@given(topr_inputs())
def test_plain_topr_matches_jax_topr_full(inputs):
    """Ties, inactive columns, zero scores, weights 0..64, R in {1, 3, 5},
    B < R and C < R: assign and scores bit for bit."""
    part, inst, weights, active, replicas = inputs
    want = jax_topr_full(part, inst, weights, active, replicas)
    got = topr_full(part, inst, weights, active, replicas, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.uint32


@settings(max_examples=100, deadline=None)
@given(topr_inputs(), st.integers(0, 2**31))
def test_plain_merge_matches_jax_added_column_merge(inputs, seed):
    """The added-column merge of DevicePlacement.apply_view_change: a prior
    top-R merged with explicit columns, as JAX's numpy computes it."""
    part, inst, weights, active, replicas = inputs
    prior_a, prior_s = jax_topr_full(part, inst, weights, active, replicas)
    cols = np.flatnonzero(np.random.default_rng(seed).random(inst.shape[1]) < 0.4)
    if not cols.size:
        return
    new = _composite(_score_matrix(part, inst[:, cols], weights[cols]), cols, True)
    old = _composite(prior_s, prior_a, prior_a >= 0)
    want = _select_topr(np.concatenate([old, new], axis=1), replicas)
    out = pdev.placement_topr(
        _bits(part), _bits(inst), torch.from_numpy(weights), None, replicas,
        cols=torch.from_numpy(cols.astype(np.int32)),
        prior=torch.from_numpy(np.concatenate([prior_a, prior_s.view(np.int32)], axis=1)))
    got = pdev.split_topr(out.numpy(), replicas)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@settings(max_examples=25, deadline=None)
@given(topr_inputs())
def test_build_jit_matches_jax_build_jit_on_random_inputs(inputs):
    """As below, under hypothesis: where no active candidate's best score
    is exactly 0 (the gap JAX's build_jit names), its map is the port's."""
    part, inst, weights, active, replicas = inputs
    scores = _score_matrix(part, inst, weights)
    got = build_jit(part, inst, weights, active, replicas, device="cpu")
    full = jax_topr_full(part, inst, weights, active, replicas)
    assert np.array_equal(got[0], full[0]) and np.array_equal(got[1], full[1])
    if (scores[:, active] == 0).any():
        return
    want = jax_build_jit(part, inst, weights, active, replicas)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("rows,cols,n_inst,replicas", [(16, 24, 1, 3), (8, 2, 2, 3), (2, 40, 3, 5)])
def test_build_jit_matches_jax_build_jit(rows, cols, n_inst, replicas):
    """The port's build_jit equals JAX's wherever JAX's can tell an active
    candidate from a masked one (no active candidate scoring exactly 0),
    and equals topr_full everywhere."""
    rng = np.random.default_rng(rows * 1000 + cols)
    part = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
    inst = rng.integers(0, 2**32, (n_inst, cols), dtype=np.uint64).astype(np.uint32)
    weights = rng.integers(1, n_inst + 1, cols).astype(np.int32)
    active = rng.random(cols) < 0.8
    got = build_jit(part, inst, weights, active, replicas, device="cpu")
    want = jax_build_jit(part, inst, weights, active, replicas)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    full = jax_topr_full(part, inst, weights, active, replicas)
    assert np.array_equal(got[0], full[0]) and np.array_equal(got[1], full[1])


def test_wrapper_checks_its_inputs():
    part, inst = _bits(np.arange(4)), _bits(np.arange(8).reshape(1, 8))
    w, act = torch.ones(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="cap"):
        pdev.placement_topr(part, inst, w, act, pdev.MAX_REPLICAS + 1)
    with pytest.raises(TypeError):
        pdev.placement_topr(part.long(), inst, w, act, 3)
    with pytest.raises(ValueError):
        pdev.placement_topr(part, inst, w[:4], act, 3)
    with pytest.raises(ValueError):
        pdev.placement_topr(part, inst, w, None, 3)
    with pytest.raises(ValueError):  # a prior needs explicit columns
        pdev.placement_topr(part, inst, w, act, 3, prior=torch.zeros((4, 6), dtype=torch.int32))
    out = pdev.placement_topr(part, inst, w, act, pdev.MAX_REPLICAS)
    assert out.shape == (4, 2 * pdev.MAX_REPLICAS)
    assert (out[:, 8:pdev.MAX_REPLICAS] == -1).all()  # 8 candidates, 16 places


def test_entry_points_take_the_card_unless_asked(monkeypatch):
    """Without a device argument the placement plane needs CUDA and raises
    without it; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, hostnames, host_lengths, ports, w = device_universe(members(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePlacement(PlacementConfig(partitions=8), hostnames, host_lengths, ports, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        topr_full(np.zeros(2, np.uint32), np.zeros((1, 4), np.uint32), np.ones(4, np.int32),
                  np.ones(4, bool), 2)


# ---------------------------------------------------------------------- #
# The object model and the device plane, against the JAX package's
# ---------------------------------------------------------------------- #

def test_object_model_matches_jax():
    """build_map, diff_maps and weight_of of the port's pure half."""
    eps = members(30)
    weights = {eps[2]: 4, eps[11]: 2}
    config, jconfig = PlacementConfig(partitions=64, seed=5), JaxConfig(partitions=64, seed=5)
    prev = build_map(eps[:24], weights, config, 17)
    jprev = jax_build_map([_jax(e) for e in eps[:24]], {_jax(k): v for k, v in weights.items()},
                          jconfig, 17)
    cur = build_map(eps[3:], weights, config, 18)
    jcur = jax_build_map([_jax(e) for e in eps[3:]], {_jax(k): v for k, v in weights.items()},
                         jconfig, 18)
    for mine, theirs in ((prev, jprev), (cur, jcur)):
        assert mine.version == theirs.version
        assert [[str(e) for e in row] for row in mine.assignments] == [
            [str(e) for e in row] for row in theirs.assignments]
        assert mine.imbalance() == theirs.imbalance()
    d, jd = diff_maps(prev, cur), jax_diff_maps(jprev, jcur)
    assert d.partitions_moved == jd.partitions_moved
    assert [(p, str(a), str(b)) for p, a, b in d.handoffs] == [
        (p, str(a), str(b)) for p, a, b in jd.handoffs]
    assert weight_of([("capacity", b" 9 ")]) == 9 and weight_of([("capacity", b"x")]) == 1
    assert weight_of([("capacity", b"1000")]) == MAX_WEIGHT


def test_engine_device_parity_across_churn():
    """Twin of tests/test_placement.py's: build, a removal burst, an
    addition burst -- the port's incremental device plane equals the
    engine's full rebuilds and the JAX device plane at every step."""
    all_eps = members(40)
    weights = {all_eps[1]: 3, all_eps[17]: 5, all_eps[30]: 2}
    config = PlacementConfig(partitions=256, replicas=3, seed=9)
    eps, hostnames, host_lengths, ports, w = device_universe(all_eps, weights)
    placement = DevicePlacement(config, hostnames, host_lengths, ports, w, device="cpu")
    jplacement = JaxDevicePlacement(JaxConfig(partitions=256, replicas=3, seed=9),
                                    hostnames, host_lengths, ports, w)
    active = np.zeros(len(eps), dtype=bool)
    active[:32] = True
    placement.build(active)
    jplacement.build(active)

    def check(live_mask):
        live = [eps[i] for i in np.flatnonzero(live_mask)]
        pmap = build_map(live, weights, config, configuration_id=0)
        assert rows_as_endpoints(placement.assign, eps) == list(pmap.assignments)
        assert placement.version == pmap.version == jplacement.version
        assert np.array_equal(placement.assign, jplacement.assign)
        assert np.array_equal(placement.scores, jplacement.scores)
        return pmap

    prev = check(active)
    active2 = active.copy()
    active2[[2, 9, 10, 17]] = False
    diff = placement.apply_view_change(active2)
    jdiff = jplacement.apply_view_change(active2)
    cur = check(active2)
    assert sorted(diff.partitions_moved.tolist()) == list(diff_maps(prev, cur).partitions_moved)
    assert np.array_equal(diff.partitions_moved, jdiff.partitions_moved)
    assert np.array_equal(diff.load_delta, jdiff.load_delta)
    prev = cur
    active3 = active2.copy()
    active3[[2, 9, 33, 34, 35, 36]] = True
    diff = placement.apply_view_change(active3)
    jdiff = jplacement.apply_view_change(active3)
    assert sorted(diff.partitions_moved.tolist()) == list(
        diff_maps(prev, check(active3)).partitions_moved)
    assert (diff.old_version, diff.new_version) == (jdiff.old_version, jdiff.new_version)
    fresh = DevicePlacement(config, hostnames, host_lengths, ports, w, device="cpu")
    fresh.build(active3)
    assert np.array_equal(fresh.assign, placement.assign)
    assert fresh.version == placement.version
    assert placement.imbalance() == jplacement.imbalance()


def test_apply_weight_change_matches_engine_rebuild():
    """Twin of tests/test_placement.py's: a re-weighting is a full rebuild
    equal to the engine's and to the JAX device plane's."""
    all_eps = members(12)
    config = PlacementConfig(partitions=128, replicas=3, seed=6)
    eps, hostnames, host_lengths, ports, w = device_universe(all_eps)
    placement = DevicePlacement(config, hostnames, host_lengths, ports, w, device="cpu")
    jplacement = JaxDevicePlacement(JaxConfig(partitions=128, replicas=3, seed=6),
                                    hostnames, host_lengths, ports, w)
    active = np.ones(len(eps), dtype=bool)
    active[4] = False
    placement.build(active)
    jplacement.build(active)
    live = [eps[i] for i in np.flatnonzero(active)]
    before = build_map(live, {}, config, configuration_id=0)
    assert rows_as_endpoints(placement.assign, eps) == list(before.assignments)
    new_w = w.copy()
    new_w[0] = 4
    new_w[7] = 2
    diff = placement.apply_weight_change(new_w)
    jdiff = jplacement.apply_weight_change(new_w)
    after = build_map(live, {eps[0]: 4, eps[7]: 2}, config, configuration_id=0)
    assert rows_as_endpoints(placement.assign, eps) == list(after.assignments)
    assert placement.version == after.version == jplacement.version
    assert (diff.old_version, diff.new_version) == (before.version, after.version)
    assert np.array_equal(diff.partitions_moved, jdiff.partitions_moved)
    assert sorted(diff.partitions_moved.tolist()) == list(
        diff_maps(before, after).partitions_moved)
    assert int(diff.load_delta.sum()) == 0 and not diff.load_delta[4]
    with pytest.raises(ValueError):
        placement.apply_weight_change(np.ones(3, dtype=np.int32))
    virgin = DevicePlacement(config, hostnames, host_lengths, ports, w, device="cpu")
    with pytest.raises(RuntimeError):
        virgin.apply_weight_change(new_w)
    with pytest.raises(RuntimeError):
        virgin.apply_view_change(active)


def _jit_inputs(n_eps, partitions, seed, weights_at, inactive):
    all_eps = members(n_eps)
    config = PlacementConfig(partitions=partitions, replicas=3, seed=seed)
    _, hostnames, host_lengths, ports, w = device_universe(
        all_eps, {all_eps[i]: v for i, v in weights_at.items()})
    placement = DevicePlacement(config, hostnames, host_lengths, ports, w, device="cpu")
    active = np.ones(n_eps, dtype=bool)
    active[list(inactive)] = False
    return placement, active


def test_jit_build_matches_numpy():
    """Twin of tests/test_placement.py's: the one-call build equals the JAX
    package's numpy topr_full and its jitted build."""
    placement, active = _jit_inputs(24, 128, 4, {5: 4}, (3, 11))
    args = (placement.part32, placement.inst32, placement.weights, active, placement.replicas)
    got = build_jit(*args, device="cpu")
    for want in (jax_topr_full(*args), jax_build_jit(*args)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_jit_build_sharded_over_mesh():
    """Twin of tests/test_placement.py's: the build's rows split over the
    port's 8-device CPU mesh equal the numpy path; P must divide."""
    placement, active = _jit_inputs(32, 512, 6, {0: 2}, (7,))
    args = (placement.part32, placement.inst32, placement.weights, active, placement.replicas)
    got = build_jit(*args, mesh=make_mesh(devices=["cpu"] * 8))
    want = jax_topr_full(*args)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="divide"):
        build_jit(placement.part32[:500], *args[1:], mesh=make_mesh(devices=["cpu"] * 8))


def test_each_build_and_view_change_fetches_the_map_once(monkeypatch):
    """The map comes to the host in one audited fetch per build and per
    view change, whatever the rows and columns that changed."""
    monkeypatch.setenv("RAPID_JITWATCH", "1")
    jitwatch.reset()
    placement, active = _jit_inputs(40, 256, 3, {}, range(32, 40))
    placement.build(active)
    assert jitwatch.sync_counts().get("placement.assign") == 1
    churn = active.copy()
    churn[[1, 2]] = False  # removed columns: the affected rows
    churn[[33, 34]] = True  # added columns: the merge into the others
    placement.apply_view_change(churn)
    assert jitwatch.sync_counts().get("placement.assign") == 2
    placement.apply_view_change(churn)  # nothing changed: nothing fetched
    assert jitwatch.sync_counts().get("placement.assign") == 2


# ---------------------------------------------------------------------- #
# The simulator
# ---------------------------------------------------------------------- #

def test_sim_placement_rebalance_on_crash():
    """Twin of tests/test_placement.py's, on both simulators: the moved set,
    versions, map, metrics and journal alike."""
    out = []
    for sim in (JaxSimulator(48, seed=3), Simulator(48, seed=3, device="cpu")):
        sim.enable_placement(partitions=128, replicas=3, seed=2)
        before_assign = sim.placement.assign.copy()
        before_version = sim.placement.version
        victims = np.array([5, 6, 7])
        sim.crash(victims)
        assert sim.run_until_decision(max_rounds=64) is not None
        (diff,) = sim.placement_diffs
        expected = np.flatnonzero(np.isin(before_assign, victims).any(axis=1))
        assert np.array_equal(np.sort(diff.partitions_moved), expected)
        assert diff.old_version == before_version
        assert diff.new_version == sim.placement.version != before_version
        assert not np.isin(sim.placement.assign, victims).any()
        assert sim.metrics.histogram("placement.partitions_moved")["count"] == 1
        journal = [(e["kind"], e["virtual_ms"],
                    {k: v for k, v in e["detail"].items() if k != "trace_id"})
                   for e in sim.recorder.tail()]
        assert [k for k, _, _ in journal].count("placement_rebalance") == 2
        out.append((sim.placement.assign.copy(), diff.new_version, journal,
                    sim.metrics.get("placement.rebuilds"),
                    sim.metrics.gauges().get("placement.imbalance")))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_sim_placement_never_advances_virtual_time():
    """Twin of tests/test_placement.py's: placement is derived state."""
    results = []
    for make in (lambda: JaxSimulator(32, seed=11), lambda: Simulator(32, seed=11, device="cpu")):
        a, b = make(), make()
        b.enable_placement(partitions=64)
        for sim in (a, b):
            sim.crash(np.array([3, 9]))
            assert sim.run_until_decision(max_rounds=64) is not None
        assert a.virtual_ms == b.virtual_ms
        assert a.configuration_id() == b.configuration_id()
        results.append((b.virtual_ms, b.configuration_id(), b.placement.version))
    assert results[0] == results[1]


# ---------------------------------------------------------------------- #
# Golden vectors (tests/golden/parity_vectors.json)
# ---------------------------------------------------------------------- #

def _golden_config():
    spec = GOLDEN["placement"]["config"]
    return PlacementConfig(partitions=spec["partitions"], replicas=spec["replicas"],
                           seed=spec["seed"])


def _member(i):
    ep = fx.member(i)[0]
    return Endpoint(ep.hostname, ep.port)


def _golden_universe():
    universe = sorted(_member(i) for i in range(25))
    by_name = {str(_member(i)): _member(i) for i in range(25)}
    weights = {by_name[n]: w for n, w in GOLDEN["placement"]["weights"].items()}
    return universe, weights


def _golden_stages(universe):
    slot_of = {ep: slot for slot, ep in enumerate(universe)}
    ep_of = {i: _member(i) for i in range(25)}
    for name, members_ in (("initial20", set(range(20))),
                           ("after_delete3", set(range(20)) - set(fx.DELETED)),
                           ("after_add5", set(range(25)) - set(fx.DELETED))):
        active = np.zeros(len(universe), dtype=bool)
        for i in members_:
            active[slot_of[ep_of[i]]] = True
        yield name, active


def test_placement_device_matches_golden():
    """The golden placement maps and versions, built on the port's device
    plane from scratch at each stage and incrementally across them."""
    universe, weights = _golden_universe()
    _, hostnames, host_lengths, ports, w = device_universe(universe, weights)
    incremental = DevicePlacement(_golden_config(), hostnames, host_lengths, ports, w,
                                  device="cpu")
    for i, (name, active) in enumerate(_golden_stages(universe)):
        golden = GOLDEN["placement"]["maps"][name]
        placement = DevicePlacement(_golden_config(), hostnames, host_lengths, ports, w,
                                    device="cpu")
        placement.build(active)
        if i == 0:
            incremental.build(active)
        else:
            diff = incremental.apply_view_change(active)
            assert diff.partitions_moved.tolist() == golden["moved_from_prev"], name
        for got in (placement, incremental):
            assert [[str(universe[int(s)]) for s in row if s >= 0]
                    for row in got.assign] == golden["assignments"], name
            assert got.version == golden["version"], name


def test_placement_engine_matches_golden():
    """The port's object model over the golden stages' sorted views."""
    universe, weights = _golden_universe()
    prev = None
    for name, active in _golden_stages(universe):
        golden = GOLDEN["placement"]["maps"][name]
        view = [universe[i] for i in np.flatnonzero(active)]
        pmap = build_map(view, weights, _golden_config(), golden["configuration_id"])
        assert pmap.version == golden["version"], name
        assert [[str(ep) for ep in row] for row in pmap.assignments] == golden["assignments"]
        if prev is not None:
            assert list(diff_maps(prev, pmap).partitions_moved) == golden["moved_from_prev"]
        prev = pmap
