"""The PyTorch port on an NVIDIA GPU against the same port on the CPU (which
the other test_torch_* files hold against the JAX package), every state
field. Exact equality: the engine is integer and boolean only, and its
random draw is threefry's bits on both (the kernel ``threefry_draw`` against
its plain version, held here too).

Every test here needs the card and skips without one. This file imports
neither JAX nor rapid_tpu, so it also runs where JAX is not installed; there,
skip tests/conftest.py (which sets JAX up). With the kernel tests:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_fd_phase.py tests/test_torch_fd_fused.py \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rapid_tpu_torch.shard.engine import gather_state, make_mesh
from rapid_tpu_torch.sim import engine, kernels, threefry
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scenarios():
    return {
        "crash": lambda s: s.crash(np.arange(0, 1000, 97)),
        "ingress_loss_1.0": lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0),
        "join_and_leave": lambda s: (s.request_joins(np.arange(990, 1000)),
                                     s.leave(np.array([17, 400]))),
    }


@pytest.mark.parametrize("name", list(_scenarios()))
def test_simulator_on_card_matches_cpu(cuda_device, name):
    records, states = [], []
    for device in ("cpu", cuda_device):
        sim = Simulator(990, capacity=1000, seed=5, device=device)
        _scenarios()[name](sim)
        rec = sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None
        records.append((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms))
        states.append(engine.state_to_numpy(sim.state))
    assert records[0] == records[1]
    for field, value in states[0].items():
        np.testing.assert_array_equal(states[1][field], value, err_msg=field)


@pytest.mark.parametrize("name", list(_scenarios()))
def test_sharded_simulator_on_card_matches_cpu(cuda_device, name):
    """A mesh of 8 shards, all on the card, against the same mesh on the
    CPU: a dispatch that does not decide, then the decision; every field."""
    records, states = [], []
    for device in ("cpu", cuda_device):
        sim = Simulator(990, capacity=1000, seed=5, mesh=make_mesh(devices=[device] * 8))
        _scenarios()[name](sim)
        rec = sim.run_until_decision(max_rounds=1, batch=1)
        states.append(engine.state_to_numpy(gather_state(sim.state)))
        rec = rec or sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None
        records.append((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms))
        states.append(engine.state_to_numpy(gather_state(sim.state)))
    assert records[0] == records[1]
    for field, value in states[0].items():
        np.testing.assert_array_equal(states[2][field], value, err_msg=field)
    for field, value in states[1].items():
        np.testing.assert_array_equal(states[3][field], value, err_msg=field)


def test_scan_path_state_on_card_matches_cpu(cuda_device):
    """Every field after a lossy scan (drop probabilities 1.0 and 0.5: the
    card's threefry draw is the CPU's, bit for bit) and the packed words."""
    config = engine.SimConfig(capacity=512, groups=2, fd_gray_confirm=3)
    outs = []
    for device in ("cpu", cuda_device):
        sim = Simulator(500, capacity=512, config=config, seed=2, device=device)
        sim.set_delivery_groups(np.arange(512, dtype=np.int32) % 2)
        sim.ingress_loss(np.array([3, 77]), 1.0)
        sim.ingress_loss(np.array([200, 301, 450]), 0.5)
        sim.crash(np.array([100]))
        sim.drop_broadcasts(1, np.array([9]))
        state = engine.run_rounds_const(config, sim.state, sim._const_inputs(None), 14, True)
        outs.append((engine.state_to_numpy(state),
                     engine.pack_decision(config, state).cpu().numpy()))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    for field, value in outs[0][0].items():
        np.testing.assert_array_equal(outs[1][0][field], value, err_msg=field)


def _decide_in_window(sim, name):
    from rapid_tpu_torch.runtime import jitwatch

    with jitwatch.timed_window(name):
        rec = sim.run_until_decision(max_rounds=16, batch=16)
    assert rec is not None and not jitwatch.consume_violations()
    return rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms, rec.membership_size


@pytest.mark.parametrize("branch", ["closed_form", "scan"])
def test_speculation_and_timed_window_on_card(cuda_device, monkeypatch, branch):
    """At 1000 members on the card, each decision inside a timed window
    (sync debug mode "error": only the audited seams may sync): speculation
    on and off give identical records, equal to the CPU's, with both hits
    only when on; the speculation worker alone in a timed window, which no
    seam lifts while it runs; then a decision with metrics, tracer and
    profiling (every dispatch sampled) on."""
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import ProfilingSettings

    monkeypatch.setenv("RAPID_JITWATCH", "1")
    victims = np.arange(0, 1000, 97)

    def fresh(speculate, device, profiled=False):
        sim = Simulator(1000, seed=5, speculate=speculate, device=device).ready()
        if profiled:
            sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
        sim.crash(victims)
        if branch == "scan":
            sim.ingress_loss(victims, 1.0)
        return sim

    want = fresh(True, "cpu").run_until_decision(max_rounds=16, batch=16)
    want = (want.cut.tolist(), want.configuration_id, want.virtual_time_ms,
            want.membership_size)
    jitwatch.reset()
    for speculate in (True, False):
        sim = fresh(speculate, cuda_device)
        assert _decide_in_window(sim, f"{branch} {speculate}") == want
        hits = (sim.metrics.get("speculation_hits_config_id"),
                sim.metrics.get("speculation_hits_fresh_state"))
        assert hits == ((1, 1) if speculate else (0, 0))
    sim = fresh(True, cuda_device)
    with jitwatch.timed_window(f"{branch} speculation worker"):
        sim._speculate_view_change().join()
    assert sim._spec is not None and not jitwatch.consume_violations()
    sim = fresh(True, cuda_device, profiled=True)
    assert _decide_in_window(sim, f"{branch} profiled") == want
    assert sim._profiler.samples == 1
    counts = jitwatch.sync_counts()
    # the sample drains once a replay, three a turn; a turn whose times do
    # not rise is taken again, and the profiler counts every turn it takes
    assert counts["sim.decision_words"] == 3
    assert counts["sim.profile.sample"] == 3 * sim._profiler.turns


@pytest.mark.parametrize("policy", ["cumulative", "windowed"])
def test_profiler_times_graph_replays_on_card(cuda_device, policy):
    """At 1000 members, every dispatch sampled on the scan path: every phase
    of every one-shot sample above 0, the FD kernel and ``threefry_draw``
    counted once a replay (3 a turn, and ``turns`` counts every turn taken),
    the captured full step equal to the eager one, the key included, and the
    state's key untouched by a sample."""
    from rapid_tpu_torch.profiling import phases
    from rapid_tpu_torch.settings import ProfilingSettings
    from rapid_tpu_torch.sim import kernels

    config = engine.SimConfig(capacity=1000, fd_policy=policy)
    sim = Simulator(1000, config=config, seed=6, device=cuda_device)
    prof = sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    victims = np.arange(2, 1000, 103)
    sim.crash(victims)
    sim.ingress_loss(victims, 1.0)
    inputs, state = sim._const_inputs(None), sim.state
    key = state.rng_key.clone()
    counter = "fd_phase_fused_windowed" if policy == "windowed" else "fd_phase_fused"
    replays = []
    timed_ms = prof._timed_ms

    def counted(*args):
        replays.append(timed_ms(*args))
        return replays[-1]

    prof._timed_ms = counted
    kernels.reset_launches()
    samples = []
    for _ in range(4):
        samples.append(prof.sample(sim.config, state, inputs, True))
    assert len(replays) == 3 * prof.turns >= 12 and kernels.LAUNCHES[counter] == len(replays)
    assert kernels.LAUNCHES["threefry_draw"] == len(replays)
    assert all(s[p] > 0 for s in samples for p in phases.DEVICE_PHASES), samples
    assert torch.equal(state.rng_key, key)
    captured = prof._captured[phases._class_key(sim.config, state, inputs, True)]
    eager = engine.step(sim.config, state, inputs, True)
    for field, value in phases._tensors(eager).items():
        assert torch.equal(getattr(captured.outputs[2], field), value), field
    rec = sim.run_until_decision(max_rounds=16, batch=1)
    assert rec is not None and sorted(rec.cut.tolist()) == victims.tolist()


def test_profiling_prefixes_on_card_match_cpu(cuda_device):
    """``step_fd_scan`` and ``step_cut_detector`` on the card (through
    ``threefry_draw`` and ``fd_phase_fused``) against the CPU, every field,
    mid-decision, under ingress loss 1.0 and 0.5."""
    outs = []
    for device in ("cpu", cuda_device):
        sim = Simulator(1000, seed=8, device=device)
        sim.crash(np.arange(3, 1000, 101))
        sim.ingress_loss(np.arange(5, 1000, 89), 1.0)
        sim.ingress_loss(np.arange(7, 1000, 131), 0.5)
        inputs = sim._const_inputs(None)
        state = engine.run_rounds_const(sim.config, sim.state, inputs, 9, True)
        partial, down = engine.step_fd_scan(sim.config, state, inputs, True)
        cut = engine.step_cut_detector(sim.config, state, inputs, True)
        outs.append((engine.state_to_numpy(partial), down.cpu().numpy(),
                     engine.state_to_numpy(cut)))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    for i in (0, 2):
        for field, value in outs[0][i].items():
            np.testing.assert_array_equal(outs[1][i][field], value, err_msg=field)
    assert outs[0][2]["announced"].any()


def test_bridged_join_crash_and_leave_on_card_match_cpu(cuda_device):
    """``chip_smoke.py``'s bridge phase at 1000 members (the port's default
    protocol, a scripted member's join, a crash in the closed form and one
    under ingress loss 1.0, its leave, then the join and crash on a mesh of
    4 shards) on the card and on the CPU: the same records and
    configuration ids, each equal to a plain simulator's."""
    import chip_smoke

    runs = [chip_smoke.bridge_sequence(1000, device, [device] * 4)
            for device in ("cpu", cuda_device)]
    keys = ("name", "cut", "configuration_id", "plain_configuration_id", "virtual_time_ms",
            "members_before")
    assert [[p[k] for k in keys] for p in runs[1]["pumps"]] == [
        [p[k] for k in keys] for p in runs[0]["pumps"]]
    scan = runs[1]["pumps"][2]
    assert scan["name"] == "crash, scan" and scan["launches"]["fd_phase_fused"] > 0


def test_gateway_join_crash_and_leave_on_card_match_cpu(cuda_device, monkeypatch):
    """``chip_smoke.py``'s gateway phase at 1000 virtual members (the port's
    ``SwarmGateway`` and a member in its own OS process over TCP: its join,
    a closed-form crash and one under ingress loss 1.0 run on the gateway's
    protocol thread, its leave) on the card and on the CPU: the same cuts,
    virtual times (the leave's aside) and sizes; in each run every configuration id equal to the
    member's own and to a plain simulator's (the ids differ between runs
    only by the member's port until it leaves)."""
    import chip_smoke

    monkeypatch.setenv("RAPID_JITWATCH", "1")  # the labels the debug mode's count is held to
    runs = [chip_smoke.gateway_sequence(1000, device) for device in ("cpu", cuda_device)]
    # the leave's virtual time counts the idle pumps that ran while the loss
    # stayed armed, which wall time decides; the steps before are exact
    keys = ("name", "cut", "virtual_time_ms", "members_before")
    assert [[r[k] for k in keys] for r in runs[1]["steps"][:3]] == [
        [r[k] for k in keys] for r in runs[0]["steps"][:3]]
    assert [r["cut"] for r in runs[1]["steps"]] == [r["cut"] for r in runs[0]["steps"]]
    for run in runs:
        for row in run["steps"]:
            assert row["configuration_id"] == row["plain_configuration_id"], row["name"]
            if "member_configuration_id" in row:
                assert row["member_configuration_id"] == row["configuration_id"], row["name"]
    assert runs[0]["steps"][-1]["configuration_id"] == runs[1]["steps"][-1]["configuration_id"]
    scan = runs[1]["steps"][2]
    assert scan["name"] == "crash, scan" and scan["pump_launches"]["fd_phase_fused"] > 0
    for row in runs[1]["steps"]:
        assert row["counted_syncs"] == sum(row["syncs"].values()), row["name"]


@pytest.mark.parametrize("rows,cols,replicas,max_weight,merge", [
    (1, 1, 1, 1, False), (7, 300, 3, 1, False), (64, 5000, 3, 8, False),
    (33, 2000, 16, 64, False), (5, 2, 5, 3, False), (257, 4000, 3, 1, True),
    (40, 900, 8, 4, True)])
def test_placement_topr_on_card_matches_plain(cuda_device, rows, cols, replicas, max_weight,
                                              merge):
    """The placement kernel against its plain version, bit for bit, at the
    card's shapes of interest in miniature: one row, fewer columns than
    places, weights to 64, the cap of 16 replicas, rows not a multiple of a
    block's, and the added-column merge with a prior."""
    from rapid_tpu_torch.placement import device as pdev
    from rapid_tpu_torch.sim import kernels

    rng = np.random.default_rng(rows * 31 + cols)
    part = torch.from_numpy(rng.integers(0, 2**32, rows, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    inst = torch.from_numpy(rng.integers(0, 2**32, (max_weight, cols), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    if cols > 2:
        inst[:, -1] = inst[:, 0]  # a tie between two columns
        inst[0, 1] = part[0]  # a zero score
    weights = torch.from_numpy(rng.integers(0, max_weight + 1, cols).astype(np.int32))
    active = torch.from_numpy(rng.random(cols) < 0.9)
    kw = {}
    if merge:
        kw = {"cols": torch.from_numpy(np.sort(rng.choice(cols, cols // 7, replace=False))
                                       .astype(np.int32)),
              "prior": pdev.placement_topr_plain(part, inst, weights, active, replicas)}
    mask = None if merge else active
    want = pdev.placement_topr_plain(part, inst, weights, mask, replicas, **kw)
    before = kernels.LAUNCHES["placement_topr"]
    got = pdev.placement_topr(part.to(cuda_device), inst.to(cuda_device),
                              weights.to(cuda_device),
                              None if merge else active.to(cuda_device), replicas,
                              **{k: v.to(cuda_device) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["placement_topr"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_sim_placement_at_scale_on_card(cuda_device):
    """tests/test_placement.py's ``test_sim_placement_at_scale`` (marked slow
    there, a host build of tens of seconds), on the card: 100k members, an
    8192 x 3 map built by the kernel and updated inside the view change
    over exactly the minimal-motion rows, equal to a fresh build."""
    from rapid_tpu_torch.placement.device import DevicePlacement

    sim = Simulator(100_000, seed=1, device=cuda_device)
    sim.enable_placement(partitions=8192, replicas=3)
    before_assign = sim.placement.assign.copy()
    victims = np.arange(40, 52)
    sim.crash(victims)
    assert sim.run_until_decision(max_rounds=64) is not None
    (diff,) = sim.placement_diffs
    expected = np.flatnonzero(np.isin(before_assign, victims).any(axis=1))
    assert np.array_equal(np.sort(diff.partitions_moved), expected)
    assert diff.moved <= 8192
    assert not np.isin(sim.placement.assign, victims).any()
    fresh = DevicePlacement(sim.placement.config, sim.cluster.hostnames,
                            sim.cluster.host_lengths, sim.cluster.ports, device=cuda_device)
    fresh.build(sim.active)
    assert np.array_equal(fresh.assign, sim.placement.assign)
    assert fresh.version == sim.placement.version


def test_planes_golden_runs_on_card(cuda_device):
    """The three runs of tests/golden/torch_planes.json on the card, exactly."""
    import chip_smoke

    misses = chip_smoke.planes_golden_check(cuda_device)
    assert not any(misses.values()), misses


def test_placement_topr_skips_columns_out_of_range_on_card(cuda_device):
    """An explicit column outside [0, C) is never read on the card (the
    wrapper cannot check a card tensor's values without a sync): the merge
    equals the plain version's over the columns in range."""
    from rapid_tpu_torch.placement import device as pdev

    rng = np.random.default_rng(11)
    part = torch.from_numpy(rng.integers(0, 2**32, 9, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))
    inst = torch.from_numpy(rng.integers(0, 2**32, (1, 50), dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))
    weights = torch.ones(50, dtype=torch.int32)
    prior = pdev.placement_topr_plain(part, inst, weights, torch.rand(50) < 0.5, 3)
    cols = torch.tensor([3, 17, 49], dtype=torch.int32)
    want = pdev.placement_topr_plain(part, inst, weights, None, 3, cols=cols, prior=prior)
    wild = torch.tensor([-1, 3, 50, 17, 1 << 30, 49], dtype=torch.int32)
    got = pdev.placement_topr(*(t.to(cuda_device) for t in (part, inst, weights)), None, 3,
                              cols=wild.to(cuda_device), prior=prior.to(cuda_device))
    assert torch.equal(got.cpu(), want)


def _topr_case(rng, rows, cols, replicas, n_inst, weights, active_share):
    part = torch.from_numpy(rng.integers(0, 2**32, rows, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    inst = torch.from_numpy(rng.integers(0, 2**32, (n_inst, cols), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    w = torch.from_numpy(rng.integers(weights[0], weights[1] + 1, cols).astype(np.int32))
    active = torch.from_numpy(rng.random(cols) < active_share)
    return part, inst, w, active


def _forced_plan(rows, n_cols, replicas, n_inst, col_split=None, slices=None, tile_cols=None):
    """``topr_plan``'s plan with some of its choices overridden."""
    from rapid_tpu_torch.placement import device as pdev

    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    w = col_split or plan.col_split
    t = tile_cols or plan.tile_cols
    return pdev.ToprPlan(w, -(-rows // (pdev.TOPR_THREADS // w)), slices or plan.slices, t,
                         -(-n_cols // t), pdev._topr_smem(t, n_inst, replicas))


# (rows, columns, replicas, instance rows, weights from..to, active share,
#  merge, forced plan: column split, slices, tile columns)
TOPR_REGIMES = {
    "one row": (1, 5000, 3, 1, (1, 1), 0.9, False, {}),
    "one row, one cluster of 16": (1, 20_000, 3, 1, (1, 1), 0.9, False, {"slices": 16}),
    "rows not a multiple of the tile": (300, 3000, 3, 1, (1, 1), 0.9, False,
                                        {"col_split": 1}),
    "fewer columns than slices": (70, 3, 3, 1, (1, 1), 1.0, False, {"slices": 8}),
    "one column": (40, 1, 2, 1, (1, 1), 1.0, False, {}),
    "all columns inactive": (50, 700, 3, 1, (1, 1), 0.0, False, {}),
    "R 1": (300, 4000, 1, 1, (1, 1), 0.9, False, {}),
    "R 1, weighted": (300, 4000, 1, 3, (1, 3), 0.9, False, {}),
    "R 16": (90, 4000, 16, 2, (0, 2), 0.9, False, {}),
    "R 9, no column split": (200, 3000, 9, 1, (1, 1), 0.9, False, {"col_split": 1}),
    "weights to 64": (64, 2000, 3, 64, (0, 64), 0.9, False, {}),
    "weights above the instance rows": (64, 2000, 3, 4, (2, 40), 0.9, False, {}),
    "equal weights, weighted path": (64, 3000, 3, 5, (5, 5), 0.95, False, {}),
    "no cluster": (256, 6000, 3, 1, (1, 1), 0.9, False, {"slices": 1}),
    "a cluster of 5, narrow tiles": (256, 6000, 3, 1, (1, 1), 0.9, False,
                                     {"slices": 5, "tile_cols": 32}),
    "a cluster of 16, weighted": (256, 6000, 4, 8, (1, 8), 0.9, False, {"slices": 16}),
    "columns split over 2 warps": (300, 5000, 3, 1, (1, 1), 0.9, False, {"col_split": 2}),
    "columns split over 8 warps, weighted": (70, 5000, 3, 6, (1, 6), 0.9, False,
                                             {"col_split": 8, "slices": 3}),
    "merge": (257, 4000, 3, 1, (1, 1), 0.9, True, {}),
    "merge, a cluster of 8": (100, 4000, 8, 4, (1, 4), 0.9, True, {"slices": 8}),
    "merge, no cluster": (100, 4000, 3, 1, (1, 1), 0.9, True, {"slices": 1}),
    "merge, columns split over 4 warps": (100, 4000, 3, 1, (1, 1), 0.9, True,
                                          {"col_split": 4, "slices": 2}),
}


@pytest.mark.parametrize("name", list(TOPR_REGIMES))
def test_placement_topr_plan_regimes_on_card(cuda_device, name):
    """The kernel against its plain version, bit for bit, in each regime of
    its launch plan: one row, a partial row tile, fewer columns than slices,
    one column, no candidate (assign -1), R 1 and 16, weights to 64, above
    the instance rows and all equal, each column split, the merge, and
    cluster sizes from 1 (none) to 16."""
    from rapid_tpu_torch.placement import device as pdev
    from rapid_tpu_torch.sim import kernels

    rows, cols, replicas, n_inst, weights, share, merge, forced = TOPR_REGIMES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    part, inst, w, active = _topr_case(rng, rows, cols, replicas, n_inst, weights, share)
    kw = {}
    if merge:
        kw = {"cols": torch.from_numpy(np.sort(rng.choice(cols, cols // 5, replace=False))
                                       .astype(np.int32)),
              "prior": pdev.placement_topr_plain(part, inst, w, active, replicas)}
    mask = None if merge else active
    want = pdev.placement_topr_plain(part, inst, w, mask, replicas, **kw)
    n_cols = kw["cols"].shape[0] if merge else cols
    plan = _forced_plan(rows, n_cols, replicas, n_inst, **forced)
    before = kernels.LAUNCHES["placement_topr"]
    got = pdev._placement_topr(*(t.to(cuda_device) for t in (part, inst, w)),
                               None if mask is None else mask.to(cuda_device), replicas,
                               **{k: v.to(cuda_device) for k, v in kw.items()}, plan=plan)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["placement_topr"] == before + 1
    assert torch.equal(got.cpu(), want), plan
    if share == 0.0:
        assert (want[:, :replicas] == -1).all()


def test_placement_topr_merge_skips_wild_columns_in_every_slice_on_card(cuda_device):
    """Explicit columns outside [0, C), spread over a cluster's slices and
    tiles, are never read; the prior enters once a row."""
    from rapid_tpu_torch.placement import device as pdev

    rng = np.random.default_rng(23)
    part, inst, w, active = _topr_case(rng, 70, 600, 4, 2, (1, 2), 0.5)
    prior = pdev.placement_topr_plain(part, inst, w, active, 4)
    good = np.sort(rng.choice(600, 90, replace=False)).astype(np.int32)
    wild = np.concatenate([good, [-1, 600, 1 << 30, -(1 << 31)] * 10]).astype(np.int32)
    rng.shuffle(wild)
    want = pdev.placement_topr_plain(part, inst, w, None, 4, cols=torch.from_numpy(good),
                                     prior=prior)
    plan = _forced_plan(70, wild.size, 4, 2, slices=4, tile_cols=32)
    got = pdev._placement_topr(*(t.to(cuda_device) for t in (part, inst, w)), None, 4,
                               cols=torch.from_numpy(wild).to(cuda_device),
                               prior=prior.to(cuda_device), plan=plan)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("change", [{"slices": 17}, {"smem_bytes": 1024},
                                    {"tile_cols": 48}, {"tile_cols": 1024},
                                    {"col_split": 3}])
def test_placement_topr_refused_plan_raises_on_card(cuda_device, change):
    """A plan the kernel cannot take is refused by the C entry, and the
    wrapper raises instead of returning the uninitialised output."""
    import dataclasses

    from rapid_tpu_torch.placement import device as pdev

    rng = np.random.default_rng(5)
    part, inst, w, active = _topr_case(rng, 64, 1000, 3, 1, (1, 1), 0.9)
    plan = dataclasses.replace(pdev.topr_plan(64, 1000, 3, 1), **change)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pdev._placement_topr(*(t.to(cuda_device) for t in (part, inst, w, active)), 3,
                             plan=plan)


@pytest.mark.parametrize("rows, k, shards", [
    (1, 1, None), (37, 10, None), (100_000, 10, None), (0, 10, None),
    (12_500, 10, list(range(8))), (25_000, 10, [3, 1]), (5, 3, [15]),
])
def test_threefry_draw_kernel_matches_plain(cuda_device, rows, k, shards):
    """The kernel ``threefry_draw`` against its plain version: the split key
    and every bit of the draw, one launch counted a call, the key read but
    not written."""
    for seed in (0, 3, 2**31 - 1):
        key = threefry.prng_key(seed)
        want_key, want = threefry.draw_plain(key, rows, k, shards)
        card_key = key.to(cuda_device)
        before = kernels.LAUNCHES["threefry_draw"]
        got_key, got = kernels.threefry_draw(card_key, rows, k, shards)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["threefry_draw"] == before + 1
        assert torch.equal(card_key.cpu(), key)
        assert torch.equal(got_key.cpu(), want_key)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows, shards", [(100_000, None), (0, None), (12_500, [3, 1])])
@pytest.mark.parametrize("halted", [False, True])
def test_threefry_draw_kernel_reads_the_halt_flag(cuda_device, halted, rows, shards):
    """The kernel reads the halt flag on the card: halted, the new key is the
    key as it came, else the split's; the draw is the plain version's either
    way."""
    key = threefry.prng_key(3)
    want_key, want = threefry.draw_plain(key, rows, 10, shards, halt=torch.tensor(halted))
    got_key, got = kernels.threefry_draw(key.to(cuda_device), rows, 10, shards,
                                         halt=torch.tensor(halted, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(want_key, key) == halted
    assert torch.equal(got_key.cpu(), want_key)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
