"""The port's scenario battery, the counterpart of ``scenarios.py`` at the
repository root: every configuration of ``BASELINE.json`` and the
scenarios beside them, run on the port and reported as time-to-stable-view.

Prints one JSON line per scenario, with the fields of ``scenarios.py``'s:
  {"scenario", "config", "n", "virtual_ms", "wall_s", "cut_ok", ...}

- virtual_ms: protocol time a real cluster would need (FD rounds + batching).
- wall_s: simulation wall time on this host and device.
- cut_ok: the decided cut equals the injected fault set (cut-set parity).

Every scenario is registered by name in REGISTRY with its parameters bound
once (seed, scale, label), so the battery, ``--list`` and ``--scenario NAME``
all read the same table:

  python -m rapid_tpu_torch.cli.scenarios                  # the default battery
  python -m rapid_tpu_torch.cli.scenarios --list           # names + parameters, no torch
  python -m rapid_tpu_torch.cli.scenarios --scenario gray-slow-node [--seed 9]
  python -m rapid_tpu_torch.cli.scenarios --plan scenarios/corpus/<pin>.json [--seed 9]
  python -m rapid_tpu_torch.cli.scenarios --fault-plan [seed]   # nemesis pair
  python -m rapid_tpu_torch.cli.scenarios --scale-1m [--cells N] # battery + the 1M targets

Every simulator runs on the CUDA device unless ``--device`` names another
(``--device cpu``); without a card and without ``--device`` a scenario that
builds a simulator raises. The protocol-plane scenarios (in-process
clusters on virtual time) are host code. ``scenarios.py``'s ``--tpu`` and
its CPU pin have no counterpart here: the device is ``--device``'s.

Scenario "cross-plane-10" is the cross-plane parity config: the *protocol
plane* (full object-model cluster with real message passing on the
deterministic virtual-time scheduler) and the *simulation plane* run the
same 10-node membership with the same crash; their cuts, final memberships,
and configuration behavior must agree.

The gray-failure and WAN scenarios ride the same registry:

- wan-zone-loss: a LatencyTopology (racks/zones/regions) compiled onto the
  device plane's delivery groups + broadcast-delay rounds, then one whole
  zone partitioned; reports per-zone detection->decision latency.
- gray-slow-node: a node that answers EVERY message, just slower than the
  probe deadline -- alive, processing, and evicted with zero collateral.
- gray-flapping: a node oscillating slow/healthy across three windows; the
  adaptive FD must evict inside the first slow window with zero collateral
  evictions and no view flip-flop afterwards.
- clock-skew: one node's entire timer stack runs on a drifted clock while
  the cluster churns through a join + a crash around it.
- rolling-upgrade: a mixed wire-version cluster (half the nodes encode with
  reserved ``__``-prefixed extension keys / thinned optional fields)
  converging through a join + removal wave under probe loss.

The durability plane adds rolling-restart: every node in sequence crashes
abruptly and rejoins with its WAL directory under serving load -- old
identities retained, zero lost acked writes, zero spurious evictions.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import time

import numpy as np

# the repository root: the pinned corpus plans are data under it
REPO = pathlib.Path(__file__).resolve().parents[2]


def recomputed_config_id(sim) -> int:
    """The configuration id recomputed FROM SCRATCH (fresh element hashes +
    the vectorized fold, which runs native where the host library loads),
    independent of the driver's per-configuration memo and speculative-fold
    fast paths -- a scenario-level cross-check that the incremental
    identity the protocol stamped on every message equals the ground-truth
    fold over the final membership."""
    from ..sim.topology import configuration_id_vectorized, ring_order

    ids = sim.sorted_identifiers()
    order0 = ring_order(sim.cluster, sim.active, 0)
    vc = sim.cluster
    return configuration_id_vectorized(
        ids[:, 0], ids[:, 1],
        vc.hostnames[order0], vc.host_lengths[order0], vc.ports[order0],
    )


# ---------------------------------------------------------------------------
# registry: one table binding scenario name -> (function, bound parameters);
# the battery, --list and --scenario all read it
# ---------------------------------------------------------------------------

REGISTRY: "dict[str, tuple]" = {}


def register(name: str, fn, **params) -> None:
    assert name not in REGISTRY, f"duplicate scenario name {name!r}"
    REGISTRY[name] = (fn, params)


def run_scenario(
    name: str, seed: "int | None" = None, device=None, **overrides
) -> dict:
    """Run one registered scenario; ``seed`` overrides the bound seed, and
    further keyword overrides replace bound params (the --cells knob).
    ``device`` reaches every scenario that builds a simulator (the card
    when None); the protocol-plane ones are host code and take none."""
    fn, params = REGISTRY[name]
    if seed is not None:
        params = {**params, "seed": seed}
    if overrides:
        params = {**params, **overrides}
    if "device" in inspect.signature(fn).parameters:
        params = {**params, "device": device}
    result = fn(**params)
    result["scenario"] = name
    return result


def _bootstrap(h, n: int) -> None:
    """Sequential bootstrap to n nodes with per-step agreement, the armed
    nemesis dormant (windows shifted to a far-future epoch) so fault windows
    cannot starve join alerts; callers re-arm at plan-time zero afterwards."""
    h.nemesis.arm(epoch_ms=1 << 40)
    h.start_seed(0)
    for i in range(1, n):
        h.join(i)
        h.wait_and_verify_agreement(i + 1)


def scenario_10_node_cross_plane(seed=1, device=None):
    """10-node ring, 1 crash-stop: protocol plane vs simulation plane."""
    from ..harness import ClusterHarness
    from ..membership import MembershipView
    from ..sim.driver import Simulator
    from ..types import Endpoint, NodeId

    t0 = time.perf_counter()
    # protocol plane
    h = ClusterHarness(seed=seed)
    h.create_cluster(10, parallel=False)
    h.wait_and_verify_agreement(10)
    victim = h.addr(9)
    start_virtual = h.scheduler.now_ms()
    h.fail_nodes([victim])
    h.wait_and_verify_agreement(9)
    protocol_virtual_ms = h.scheduler.now_ms() - start_virtual
    survivors_protocol = set(h.instances[h.addr(0)].get_memberlist())
    h.shutdown()

    # simulation plane: same shape of fault
    sim = Simulator(10, seed=seed, device=device)
    sim.crash(np.array([9]))
    rec = sim.run_until_decision(max_rounds=40)
    cut_ok = rec is not None and list(rec.cut) == [9]

    # cross-plane configuration-id parity on identical identities
    vc = sim.cluster
    view = MembershipView(10)
    for i in range(10):
        host = bytes(vc.hostnames[i, : vc.host_lengths[i]])
        view.ring_add(Endpoint(host, int(vc.ports[i])),
                      NodeId(int(vc.id_high[i]), int(vc.id_low[i])))
    view.ring_delete(Endpoint(
        bytes(vc.hostnames[9, : vc.host_lengths[9]]), int(vc.ports[9])))
    config_parity = view.get_current_configuration_id() == rec.configuration_id

    return {
        "config": "10-node ring, 1 crash-stop (cross-plane parity)",
        "n": 10,
        "virtual_ms": rec.virtual_time_ms,
        "protocol_plane_virtual_ms": protocol_virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(cut_ok and len(survivors_protocol) == 9),
        "config_id_parity": bool(config_parity),
    }


def _hierarchy_digest(sim) -> dict:
    """Result fields for a sim with the hierarchy mirror attached: the
    composed rows, parent-round bill, and the incremental-vs-scratch
    fingerprint cross-check (the sim analogue of every member agreeing)."""
    rows = sim.hierarchy_rows()
    incremental = sim.global_fingerprint()
    for state in list(rows):
        sim._hierarchy_recompute_cell(state.cell)  # noqa: SLF001
    return {
        "cells": {int(r.cell): int(r.size) for r in rows},
        "parent_rounds": sim.parent_rounds,
        "global_fingerprint": incremental,
        "fingerprint_ok": bool(incremental == sim.global_fingerprint()),
    }


def scenario_crash(n, n_fail, seed, label, cells=0, device=None):
    from ..sim.driver import Simulator

    rng = np.random.default_rng(seed)
    sim = Simulator(n, seed=seed, device=device)
    if cells:
        sim.enable_hierarchy(cells=cells)
    victims = rng.choice(n, size=n_fail, replace=False)
    sim.crash(victims)
    t0 = time.perf_counter()
    rec = sim.run_until_decision(max_rounds=32, batch=16)
    wall = time.perf_counter() - t0
    result = {
        "config": label,
        "n": n,
        "virtual_ms": rec.virtual_time_ms if rec else None,
        "wall_s": round(wall, 3),
        "cut_ok": bool(rec is not None and set(rec.cut) == set(victims)),
        "config_id_ok": bool(
            rec is not None
            and rec.configuration_id == recomputed_config_id(sim)
        ),
    }
    if cells:
        result["hierarchy"] = _hierarchy_digest(sim)
    return result


def scenario_one_way_loss(n, n_fail, seed, cells=0, device=None):
    from ..sim.driver import Simulator

    rng = np.random.default_rng(seed)
    sim = Simulator(n, seed=seed, device=device)
    if cells:
        sim.enable_hierarchy(cells=cells)
    victims = rng.choice(n, size=n_fail, replace=False)
    sim.one_way_ingress_partition(victims)
    t0 = time.perf_counter()
    rec = sim.run_until_decision(max_rounds=32, batch=16)
    wall = time.perf_counter() - t0
    result = {
        "config": f"{n//1000}k nodes, asymmetric one-way link loss",
        "n": n,
        "virtual_ms": rec.virtual_time_ms if rec else None,
        "wall_s": round(wall, 3),
        "cut_ok": bool(rec is not None and set(rec.cut) == set(victims)),
        "config_id_ok": bool(
            rec is not None
            and rec.configuration_id == recomputed_config_id(sim)
        ),
    }
    if cells:
        result["hierarchy"] = _hierarchy_digest(sim)
    return result


def scenario_flip_flop_with_join_wave(n, capacity, seed, cells=0, device=None):
    from ..sim.driver import Simulator

    rng = np.random.default_rng(seed)
    sim = Simulator(n, capacity=capacity, seed=seed, device=device)
    if cells:
        sim.enable_hierarchy(cells=cells)
    victims = rng.choice(n, size=n // 100, replace=False)
    joiners = np.arange(n, capacity)
    sim.request_joins(joiners)
    t0 = time.perf_counter()
    flip = True
    decided = []
    for _ in range(12):
        if flip:
            sim.crash(victims)
        else:
            sim.revive(victims)
        flip = not flip
        rec = sim.run_until_decision(max_rounds=10, batch=10)
        if rec is not None:
            decided.append(rec)
            if sim.membership_size == n - len(victims) + len(joiners):
                break
    wall = time.perf_counter() - t0
    final_ok = (
        sim.membership_size == n - len(victims) + len(joiners)
        and not sim.active[victims].any()
        and sim.active[joiners].all()
    )
    result = {
        "config": f"{n//1000}k nodes, flip-flop reachability + concurrent join wave",
        "n": n,
        "virtual_ms": decided[-1].virtual_time_ms if decided else None,
        "wall_s": round(wall, 3),
        "cut_ok": bool(final_ok),
        "view_changes": len(decided),
        "config_id_ok": bool(
            decided
            and decided[-1].configuration_id == recomputed_config_id(sim)
        ),
    }
    if cells:
        result["hierarchy"] = _hierarchy_digest(sim)
    return result


def scenario_nemesis_protocol(seed=7, n=5):
    """The protocol-plane leg of the nemesis run: the same FaultPlan class
    (one-way partition of one node) armed over an in-process virtual-time
    cluster with real ping-pong failure detectors. Rides the telemetry
    plane: every node's spans/metrics attach to the process-global registry,
    so a --trace-out/--metrics-out export carries this leg's protocol spans
    and the simulator leg's device spans on one timeline."""
    from ..faults import FaultPlan
    from ..harness import ClusterHarness
    from ..observability import global_metrics

    t0 = time.perf_counter()
    h = ClusterHarness(seed=seed, use_static_fd=False)
    victim = h.addr(n - 1)
    h.with_faults(FaultPlan(seed=seed).partition_one_way(dst=victim))
    _bootstrap(h, n)
    h.nemesis.arm()  # plan time zero = now: the partition opens
    start_virtual = h.scheduler.now_ms()
    vic = h.instances.pop(victim)
    try:
        h.wait_and_verify_agreement(n - 1)
        virtual_ms = h.scheduler.now_ms() - start_virtual
        survivors = set(h.instances[h.addr(0)].get_memberlist())
    finally:
        vic.shutdown()
        h.shutdown()
    stable_view = global_metrics().histogram(
        "time_to_stable_view_ms", plane="protocol"
    )
    return {
        "config": (
            f"nemesis protocol plane: {n} in-process nodes, windowed "
            f"one-way partition (plan seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(victim not in survivors and len(survivors) == n - 1),
        "stable_view_decisions": (
            stable_view["count"] if stable_view is not None else 0
        ),
    }


def scenario_nemesis_smoke(n=1000, seed=7, device=None):
    """One seeded FaultPlan compiled onto the device plane's fault arrays
    (``faults.py``): a 1% wave of one-way partitions whose windows open 2 s
    into the run, driven through every schedule boundary by
    replay_on_simulator. The same FaultPlan class drives the in-process and
    TCP transports."""
    from ..faults import FaultPlan, endpoint_slots, replay_on_simulator
    from ..sim.driver import Simulator

    sim = Simulator(n, seed=seed, device=device)
    by_slot = {slot: ep for ep, slot in endpoint_slots(sim).items()}
    rng = np.random.default_rng(seed)
    victims = sorted(
        int(v) for v in rng.choice(n, size=max(1, n // 100), replace=False)
    )
    plan = FaultPlan(seed=seed)
    for v in victims:
        plan.partition_one_way(dst=by_slot[v], windows=((2000, None),))
    t0 = time.perf_counter()
    records = replay_on_simulator(sim, plan, duration_ms=60_000)
    wall = time.perf_counter() - t0
    cut = sorted({int(c) for rec in records for c in rec.cut})
    return {
        "config": (
            f"nemesis smoke: {len(victims)} windowed one-way partitions "
            f"(plan seed {seed})"
        ),
        "n": n,
        "virtual_ms": records[-1].virtual_time_ms if records else None,
        "wall_s": round(wall, 3),
        "cut_ok": bool(cut == victims),
        "config_id_ok": bool(
            records
            and records[-1].configuration_id == recomputed_config_id(sim)
        ),
    }


# ---------------------------------------------------------------------------
# gray failures + WAN topology
# ---------------------------------------------------------------------------


def scenario_wan_zone_loss(seed=11, n=1024, device=None):
    """WAN device plane: a 16-rack / 8-zone / 2-region LatencyTopology with a
    1000 ms inter-region RTT compiled onto delivery groups + broadcast-delay
    rounds, then every node of one zone one-way partitioned 2 s in. Reports
    per-zone detection->decision latency (also observed into the
    nemesis_zone_detection_ms histogram, so --metrics-out / --trace-out
    exports carry it)."""
    from ..faults import FaultPlan, endpoint_slots, replay_on_simulator
    from ..observability import global_metrics
    from ..sim.driver import Simulator
    from ..sim.engine import SimConfig
    from ..sim.topology import LatencyTopology

    topo = LatencyTopology(racks=16, zones=8, regions=2,
                           rack_rtt_ms=0, zone_rtt_ms=2, region_rtt_ms=4,
                           inter_region_rtt_ms=1000)
    config = SimConfig(capacity=n, groups=8, max_delivery_delay=2,
                       rounds_per_interval=4)
    sim = Simulator(n, config=config, seed=seed, device=device)
    by_slot = {slot: ep for ep, slot in endpoint_slots(sim).items()}
    lost_zone = 7
    victims = [i for i in range(n) if topo.zone_of(i) == lost_zone]
    plan = FaultPlan(seed=seed).with_topology(topo)
    for v in victims:
        plan.partition_one_way(dst=by_slot[v], windows=((2000, None),))
    t0 = time.perf_counter()
    records = replay_on_simulator(sim, plan, duration_ms=120_000)
    wall = time.perf_counter() - t0
    cut = sorted({int(c) for rec in records for c in rec.cut})
    # detection -> decision latency per zone touched by a decision, measured
    # from the partition window opening (virtual_time_ms is absolute and the
    # simulator starts at 0, so the offset is exactly the window start)
    per_zone = {}
    for rec in records:
        for z in sorted({topo.zone_of(int(c)) for c in rec.cut}):
            if z not in per_zone:
                per_zone[z] = rec.virtual_time_ms - 2000
                global_metrics().observe(
                    "nemesis_zone_detection_ms", per_zone[z], zone=str(z)
                )
    return {
        "config": (
            f"WAN zone loss: {n} slots over 8 zones x 2 regions, 1000 ms "
            f"inter-region RTT, zone {lost_zone} partitioned (seed {seed})"
        ),
        "n": n,
        "virtual_ms": records[-1].virtual_time_ms if records else None,
        "wall_s": round(wall, 3),
        "cut_ok": bool(cut == victims),
        "config_id_ok": bool(
            records
            and records[-1].configuration_id == recomputed_config_id(sim)
        ),
        "zone_detection_ms": per_zone,
    }


def zone_churn_result(sim, *, seed, zones, per_zone, lost_zone, leader,
                      scatter, zone_victims, records, wall) -> dict:
    """hierarchy-zone-churn's record from its simulator after the two
    decisions (``records``, Nones kept) and the churn's wall seconds. Apart
    from the scenario so that a caller which drove the same sequence itself
    (``chip_smoke.py``'s ``zone_churn_run``) reports it without a second
    run."""
    records = [r for r in records if r is not None]
    cut = sorted({int(c) for rec in records for c in rec.cut})
    digest = _hierarchy_digest(sim)
    surviving = set(range(zones)) - {lost_zone}
    return {
        "config": (
            f"hierarchy zone churn: {zones} cells x {per_zone} members, "
            f"scatter crashes then whole cell {lost_zone} killed, leader "
            f"{leader} included (seed {seed})"
        ),
        "n": zones * per_zone,
        "virtual_ms": records[-1].virtual_time_ms if records else None,
        "wall_s": round(wall, 3),
        # zero collateral evictions: exactly the victims were cut
        "cut_ok": bool(cut == sorted(scatter + zone_victims)),
        "config_id_ok": bool(
            records
            and records[-1].configuration_id == recomputed_config_id(sim)
        ),
        "hierarchy": digest,
        "cell_evicted_ok": bool(
            set(digest["cells"]) == surviving
            and digest["fingerprint_ok"]
        ),
        # O(1) parent rounds: one per composition move, bounded by the
        # two churn edges -- independent of the 256-member cell size
        "parent_rounds_ok": bool(
            0 < digest["parent_rounds"] <= len(records) + 1
        ),
    }


def scenario_hierarchy_zone_churn(seed=19, zones=8, per_zone=256, device=None):
    """Hierarchy plane: ``zones`` topology cells of ``per_zone`` members
    each, ordinary churn in flight (a scatter of crashes across cells),
    then one whole cell -- its deterministic leader included -- killed.

    Oracle: the surviving cells' composed global view agrees (the
    incremental composition matches a from-scratch recompute and the dead
    cell's row is gone), the lost cell is evicted in O(1) parent rounds
    (bounded by the view changes, never by member count), and there are
    zero collateral evictions (the union of cuts is exactly the union of
    victims)."""
    from ..hierarchy.parent import cell_leaders
    from ..sim.driver import Simulator
    from ..sim.engine import SimConfig
    from ..sim.topology import LatencyTopology
    from ..types import Endpoint

    n = zones * per_zone
    topo = LatencyTopology(racks=zones * 2, zones=zones,
                           rack_rtt_ms=0, zone_rtt_ms=2, region_rtt_ms=4,
                           inter_region_rtt_ms=8)
    rng = np.random.default_rng(seed)
    sim = Simulator(n, config=SimConfig(capacity=n, groups=8), seed=seed,
                    device=device)
    sim.enable_hierarchy(topology=topo, parent_round_ms=4)
    lost_zone = int(rng.integers(zones))
    zone_victims = [i for i in range(n) if topo.zone_of(i) == lost_zone]
    # the zone kill provably includes the cell's deterministic leader
    members = [
        Endpoint(hostname=h, port=p)
        for h, p in (sim.endpoint_of(s) for s in zone_victims)
    ]
    leader = str(cell_leaders(members, 1)[0])
    assert leader in {str(m) for m in members}
    # mid-churn: a scatter of ordinary crashes lands first
    others = [i for i in range(n) if topo.zone_of(i) != lost_zone]
    scatter = [int(i) for i in rng.choice(others, size=8, replace=False)]
    t0 = time.perf_counter()
    sim.crash(np.array(scatter))
    records = [sim.run_until_decision(max_rounds=32, batch=16)]
    sim.crash(np.array(zone_victims))
    records.append(sim.run_until_decision(max_rounds=32, batch=16))
    wall = time.perf_counter() - t0
    return zone_churn_result(
        sim, seed=seed, zones=zones, per_zone=per_zone, lost_zone=lost_zone,
        leader=leader, scatter=scatter, zone_victims=zone_victims,
        records=records, wall=wall,
    )


def scenario_gray_slow_node(seed=7, n=5, response_delay_ms=5000, device=None):
    """Gray failure: node n-1 answers EVERY message, just response_delay_ms
    late -- past the probe deadline, so observers see timeouts while the
    victim stays alive, keeps processing, and never crashes. The survivors
    must evict exactly the slow node (zero collateral evictions), and the
    same plan replayed on the device plane with the protocol plane's seated
    identities must produce the same cut and configuration id."""
    from ..faults import FaultPlan, replay_on_simulator
    from ..harness import ClusterHarness
    from ..observability import global_metrics
    from ..sim.driver import Simulator

    t0 = time.perf_counter()
    h = ClusterHarness(seed=seed, use_static_fd=False)
    victim = h.addr(n - 1)

    def plan():
        return FaultPlan(seed=seed).slow_node(victim, response_delay_ms)

    h.with_faults(plan())
    _bootstrap(h, n)
    full_cfg = (
        h.instances[h.addr(0)]._membership_service._view.get_configuration()  # noqa: SLF001
    )
    hist = global_metrics().histogram("fd.rtt_ms")
    rtt_before = hist["count"] if hist is not None else 0
    h.nemesis.arm()  # the victim turns gray now
    start_virtual = h.scheduler.now_ms()
    vic = h.instances.pop(victim)  # keeps RUNNING: slow, not dead
    try:
        h.wait_and_verify_agreement(n - 1)
        virtual_ms = h.scheduler.now_ms() - start_virtual
        survivor = h.instances[h.addr(0)]
        survivors = set(survivor.get_memberlist())
        ip_config = survivor.get_current_configuration_id()
        victim_alive = vic.get_membership_size() >= 1
    finally:
        vic.shutdown()
        h.shutdown()
    expected = {h.addr(i) for i in range(n - 1)}
    hist = global_metrics().histogram("fd.rtt_ms")
    rtt_samples = (hist["count"] if hist is not None else 0) - rtt_before

    # device leg: seat the protocol plane's identities; a slower-than-round
    # response compiles to the partition-equivalent cut
    identities = [
        (ep.hostname, ep.port, nid.high, nid.low)
        for ep, nid in zip(
            (h.addr(i) for i in range(n)), full_cfg.node_ids
        )
    ]
    sim = Simulator(n, seed=seed, identities=identities, device=device)
    records = replay_on_simulator(sim, plan(), duration_ms=40_000)
    device_ok = (
        len(records) == 1
        and [int(c) for c in records[0].cut] == [n - 1]
        and records[0].configuration_id == ip_config
    )
    return {
        "config": (
            f"gray slow node: {n} nodes, victim answers "
            f"{response_delay_ms} ms late (seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(survivors == expected and victim_alive),
        "config_id_parity": bool(device_ok),
        "fd_rtt_samples": int(rtt_samples),
    }


def scenario_gray_flapping(seed=17, n=5, response_delay_ms=5000):
    """Gray flapping: node n-1 oscillates between slow (answers every message
    ``response_delay_ms`` late) and fully healthy across three 20 s slow
    windows separated by 20 s healthy gaps. The adaptive failure detector
    (Settings.adaptive_fd) must convert the miss streak into an eviction
    within the FIRST slow window's budget -- before a healthy gap can reset
    a windowed score -- with zero collateral evictions, and the view must
    not flip-flop when the later windows open and close around the already
    evicted node."""
    from ..faults import FaultPlan
    from ..harness import ClusterHarness
    from ..observability import global_metrics
    from ..settings import AdaptiveFdSettings, Settings

    t0 = time.perf_counter()
    slow_windows = ((0, 20_000), (40_000, 60_000), (80_000, 100_000))
    settings = Settings(adaptive_fd=AdaptiveFdSettings(enabled=True))
    h = ClusterHarness(seed=seed, use_static_fd=False, settings=settings)
    victim = h.addr(n - 1)
    h.with_faults(
        FaultPlan(seed=seed).slow_node(
            victim, response_delay_ms, windows=slow_windows
        )
    )
    _bootstrap(h, n)
    # soak healthy: gray scoring only activates on warmed-up edges
    # (adaptive_fd.warmup_probes successful samples), and a real gray fault
    # hits a long-running cluster, not one mid-bootstrap
    h.scheduler.run_until(lambda: False, timeout_ms=8_000)

    def gray_alert_total() -> int:
        return sum(
            value
            for kind, name, _labels, value in global_metrics().collect()
            if kind == "counter" and name == "fd.gray_alerts"
        )

    gray_before = gray_alert_total()
    h.nemesis.arm()  # window 1 opens: the victim turns gray now
    start_virtual = h.scheduler.now_ms()
    vic = h.instances.pop(victim)  # keeps RUNNING: flapping, not dead
    try:
        h.wait_and_verify_agreement(n - 1)
        detect_ms = h.scheduler.now_ms() - start_virtual
        survivor = h.instances[h.addr(0)]
        survivors = set(survivor.get_memberlist())
        config_after_cut = survivor.get_current_configuration_id()
        # ride out the healthy gap + windows 2 and 3: the evicted node
        # flapping back to healthy (and slow again) must not re-enter the
        # view or cut anyone else -- no flip-flop
        h.scheduler.run_until(
            lambda: False,
            timeout_ms=slow_windows[-1][1] + 20_000 - detect_ms,
        )
        virtual_ms = h.scheduler.now_ms() - start_virtual
        stable = (
            set(survivor.get_memberlist()) == survivors
            and survivor.get_current_configuration_id() == config_after_cut
        )
        victim_alive = vic.get_membership_size() >= 1
    finally:
        vic.shutdown()
        h.shutdown()
    expected = {h.addr(i) for i in range(n - 1)}
    gray_alerts = gray_alert_total() - gray_before
    # budget: the cut must land inside slow window 1 (20 s); a detector that
    # needs the flapping node to stay gray across windows would miss this
    window_budget_ms = slow_windows[0][1] - slow_windows[0][0]
    return {
        "config": (
            f"gray flapping: {n} nodes, victim {response_delay_ms} ms late "
            f"across {len(slow_windows)} windows (seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "detect_ms": detect_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(
            survivors == expected
            and victim_alive
            and detect_ms <= window_budget_ms
            and stable
            and gray_alerts > 0  # the adaptive path drove it, not fallback
        ),
        "gray_alerts": int(gray_alerts),
    }


def scenario_clock_skew(seed=13, n=5, offset_ms=350, rate=1.25):
    """One node's ENTIRE timer stack -- FD probe intervals, batching windows,
    retry backoff, message deadlines -- runs on a clock drifting at ``rate``x
    true time plus ``offset_ms``, while every peer keeps true time. The
    cluster must still bootstrap, admit a joiner and evict a crashed node
    with zero collateral eviction of the skewed node."""
    from ..faults import FaultPlan
    from ..harness import ClusterHarness

    t0 = time.perf_counter()
    h = ClusterHarness(seed=seed, use_static_fd=False)
    skewed = h.addr(1)
    h.with_faults(
        FaultPlan(seed=seed).clock_skew(skewed, offset_ms=offset_ms, rate=rate)
    )
    _bootstrap(h, n)
    h.nemesis.arm()
    start_virtual = h.scheduler.now_ms()
    h.join(n)  # a join wave under skew ...
    h.wait_and_verify_agreement(n + 1)
    crashed = h.addr(n - 1)
    h.fail_nodes([crashed])  # ... then a crash-stop beside the skewed node
    try:
        h.wait_and_verify_agreement(n)
        virtual_ms = h.scheduler.now_ms() - start_virtual
        members = set(h.instances[h.addr(0)].get_memberlist())
        drift_ms = (
            h.nemesis.scheduler_for(skewed).now_ms() - h.scheduler.now_ms()
        )
    finally:
        h.shutdown()
    ok = skewed in members and crashed not in members and len(members) == n
    return {
        "config": (
            f"clock skew: {n} nodes + joiner, node 1 at {rate}x "
            f"+{offset_ms} ms, one crash-stop (seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(ok),
        "skew_drift_ms": int(drift_ms),
    }


def scenario_rolling_upgrade(seed=21, n=6, version=2):
    """Rolling upgrade: the even-indexed half of the cluster (and the
    joiner) encodes every egress message at wire version ``version`` --
    reserved ``__``-prefixed extension keys a v1 peer must ignore, optional
    defaulted fields thinned -- while the rest speak v1, with a sustained 5%
    probe-lossy link riding along. The mixed-version cluster bootstraps,
    admits the upgraded joiner and evicts a v1 node, all on bytes a
    same-version cluster never exercises. Windowed FDs shed the probe
    loss, whose drops are the nemesis's seeded draws, as in the JAX
    package."""
    from ..faults import FaultPlan
    from ..harness import ClusterHarness
    from ..settings import Settings
    from ..types import ProbeMessage

    t0 = time.perf_counter()
    settings = Settings(fd_policy="windowed")
    h = ClusterHarness(seed=seed, use_static_fd=False, settings=settings)
    plan = FaultPlan(seed=seed).lossy_link(0.05, msg_types=(ProbeMessage,))
    for i in list(range(0, n, 2)) + [n]:
        plan.wire_version(h.addr(i), version)
    h.with_faults(plan)
    # armed from epoch zero: the whole bootstrap runs on mixed wire versions
    h.nemesis.arm()
    h.start_seed(0)
    for i in range(1, n):
        h.join(i)
        h.wait_and_verify_agreement(i + 1)
    start_virtual = h.scheduler.now_ms()
    h.join(n)  # the upgraded joiner arrives on v2 bytes
    h.wait_and_verify_agreement(n + 1)
    h.fail_nodes([h.addr(n - 1)])  # a v1 node leaves mid-upgrade
    try:
        h.wait_and_verify_agreement(n)
        virtual_ms = h.scheduler.now_ms() - start_virtual
        members = set(h.instances[h.addr(0)].get_memberlist())
        versioned = h.nemesis.metrics.get("nemesis_wire_versioned")
    finally:
        h.shutdown()
    expected = {h.addr(i) for i in range(n + 1)} - {h.addr(n - 1)}
    return {
        "config": (
            f"rolling upgrade: {n} nodes half at wire v{version} + v{version} "
            f"joiner, 5% probe loss, one v1 removal (seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(members == expected),
        "wire_versioned_msgs": int(versioned),
    }


def scenario_serving_sawtooth(seed=31, n=16, wave=4, waves=3, ops=80, device=None):
    """Elastic autoscaling sawtooth under sustained serving load: each wave
    joins ``wave`` fresh nodes, serves closed-loop Get/Put traffic, then
    gracefully drains the same nodes back out -- membership sawtooths
    n -> n+wave -> n while the serving plane's KV data rides every
    placement diff through verified handoff sessions. The invariant the
    scenario pins: ZERO acknowledged writes lost across the whole sawtooth
    (after every view settles, each oracle-recorded ack reads back at >=
    its acked version). Fully deterministic per seed: latencies bill on
    virtual time and the workload is seeded."""
    from ..sim.driver import Simulator

    rng = np.random.default_rng(seed)
    capacity = n + waves * wave
    sim = Simulator(n, capacity=capacity, seed=seed, device=device)
    sim.enable_placement(partitions=128, replicas=3)
    sim.enable_handoff(chunk_ms=1)
    sim.enable_serving()
    keys = [b"saw-%03d" % i for i in range(48)]

    def drive(count: int) -> int:
        served = 0
        for _ in range(count):
            key = keys[int(rng.integers(len(keys)))]
            if rng.random() < 0.25:
                ack = sim.serving_put(key, b"w-%d" % sim.virtual_ms)
            else:
                ack = sim.serving_get(key)
            if ack.status != ack.STATUS_RETRY:
                served += 1
        return served

    def settle(expected_size: int) -> int:
        changes = 0
        for _ in range(6):
            if sim.membership_size == expected_size:
                break
            rec = sim.run_until_decision(max_rounds=40, batch=10)
            if rec is not None:
                changes += 1
        assert sim.membership_size == expected_size, (
            f"sawtooth stuck at {sim.membership_size}, want {expected_size}"
        )
        return changes

    def lost_acked() -> int:
        lost = 0
        for key, (version, _) in sim.serving_acked.items():
            back = sim.serving_get(key)
            if back.status != back.STATUS_OK or back.version < version:
                lost += 1
        return lost

    t0 = time.perf_counter()
    for i, key in enumerate(keys):
        ack = sim.serving_put(key, b"seed-%d" % i)
        assert ack.status == ack.STATUS_OK
    total_served, view_changes, lost = drive(ops), 0, 0
    for w in range(waves):
        joiners = np.arange(n + w * wave, n + (w + 1) * wave)
        sim.request_joins(joiners)
        view_changes += settle(n + wave)
        lost += lost_acked()
        total_served += drive(ops)
        sim.leave(joiners)
        view_changes += settle(n)
        lost += lost_acked()
        total_served += drive(ops)
    wall = time.perf_counter() - t0
    return {
        "config": (
            f"serving sawtooth: {n} nodes ± {wave} x {waves} waves, "
            f"closed-loop Get/Put riding every view change (seed {seed})"
        ),
        "n": n,
        "virtual_ms": sim.virtual_ms,
        "wall_s": round(wall, 3),
        "cut_ok": bool(sim.membership_size == n and lost == 0),
        "view_changes": view_changes,
        "ops_served": total_served,
        "lost_acked_writes": lost,
    }


def scenario_rolling_restart(seed=37, n=4, ops_per_wave=12):
    """Rolling restart under serving load (the durability oracle): every
    node, in sequence, crashes abruptly (WAL torn mid-flight, no clean
    shutdown) and rejoins with the SAME durability directory before the
    failure detector concludes -- the persisted NodeId drives the
    HOSTNAME_ALREADY_IN_RING rejoin fast path, recovery replays
    log-over-snapshot, and the verified handoff pull catches the replica
    up. The oracle: every node keeps its original identity across its
    restart, ZERO acked writes are lost over the whole wave, and no rejoin
    leaves anyone else evicted (a restart is not a membership event)."""
    import os
    import shutil
    import tempfile

    from ..harness import ClusterHarness
    from ..settings import DurabilitySettings, Settings

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rapid-rolling-restart-")
    settings = Settings(
        durability=DurabilitySettings(enabled=True, fsync_policy=0)
    )
    h = ClusterHarness(seed=seed, settings=settings)
    placement = {"partitions": 16, "replicas": 3, "seed": 7}
    dirs = {i: os.path.join(root, f"node{i}") for i in range(n)}
    try:
        h.start_seed(0, placement=placement, serving=True,
                     durability=dirs[0])
        for i in range(1, n):
            h.join(i, placement=placement, serving=True, durability=dirs[i])
        h.wait_and_verify_agreement(n)
        identities = {
            i: h.instances[h.addr(i)].get_partition_store().node_id
            for i in range(n)
        }
        all_addrs = {h.addr(i) for i in range(n)}
        acked: dict = {}
        write_seq = 0

        def drive(client, count: int) -> None:
            nonlocal write_seq
            for _ in range(count):
                key = b"roll-%02d" % (write_seq % 24)
                value = b"w-%d" % write_seq
                write_seq += 1
                p = client.serving_put(key, value)
                ok = h.scheduler.run_until(p.done, timeout_ms=60_000)
                if ok and p.peek().status == 0:
                    acked[key] = value

        identity_ok = True
        replayed_total = 0
        spurious = 0
        drive(h.instances[h.addr(0)], ops_per_wave)
        for i in range(n):
            survivor = h.addr((i + 1) % n)
            victim = h.instances[h.addr(i)]
            victim.get_partition_store().crash()  # power loss, not clean stop
            h.fail_nodes([h.addr(i)])
            h.blacklist.discard(h.addr(i))  # back before the FD concludes
            revived = h.join(i, seed_index=(i + 1) % n, placement=placement,
                             serving=True, durability=dirs[i])
            h.wait_and_verify_agreement(n)
            store = revived.get_partition_store()
            identity_ok &= store.node_id == identities[i]
            replayed_total += store.durability_stats()["replayed_records"]
            if set(h.instances[survivor].get_memberlist()) != all_addrs:
                spurious += 1
            drive(h.instances[survivor], ops_per_wave)
        # every acked write must read back through a survivor (newer
        # versions are fine -- later writes win; NOT_FOUND is a loss)
        lost = 0
        reader = h.instances[h.addr(0)]
        for key in sorted(acked):
            p = reader.serving_get(key)
            h.scheduler.run_until(p.done, timeout_ms=60_000)
            ack = p.peek()
            if ack.status != 0 or ack.version == 0:
                lost += 1
        virtual_ms = h.scheduler.now_ms()
        h.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "config": (
            f"rolling restart: {n} nodes each crash + rejoin with their "
            f"WAL dir under serving load (seed {seed})"
        ),
        "n": n,
        "virtual_ms": virtual_ms,
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": bool(identity_ok and lost == 0 and spurious == 0),
        "identities_retained": bool(identity_ok),
        "lost_acked_writes": lost,
        "spurious_view_changes": spurious,
        "replayed_records": int(replayed_total),
    }


def scenario_overload_recover(seed=43, n=16, rate_base=400.0,
                              rate_burst=2500.0, device=None):
    """Overload-then-recover through a leader eviction (the SLO plane's
    end-to-end demonstration): an open-loop arrival stream runs at a
    sustainable baseline rate, then bursts past serving capacity while the
    busiest partition leader crashes -- queueing delay (measured from
    *scheduled* arrival, so nothing is coordinated-omitted) burns the
    latency SLO and the fast-pair burn alert fires mid-churn. The decided
    view plus the rate dropping back to baseline must (a) let the
    fast-window alerts clear, (b) leave every fired alert attributed to
    the view-change episode's trace id, and (c) pass the
    metastable-recovery checker on the scenario's own client history."""
    from ..search.checkers import (
        ClientOp,
        InvariantViolation,
        check_metastable_recovery,
    )
    from ..settings import SLOSettings
    from ..sim.driver import Simulator
    from ..slo import OpenLoopGenerator, describe

    t0 = time.perf_counter()
    sim = Simulator(n, seed=seed, device=device)
    sim.enable_placement(partitions=64, replicas=3)
    sim.enable_handoff(chunk_ms=1)
    sim.enable_serving()
    # burn windows compressed onto virtual time: fast pair 5m/1h ->
    # 300ms/3.6s, so the whole fire->attribute->clear cycle fits one run
    plane = sim.enable_slo(SLOSettings(enabled=True, window_scale=0.001))
    keys = [b"ovr-%03d" % i for i in range(32)]
    for i, key in enumerate(keys):
        ack = sim.serving_put(key, b"seed-%d" % i)
        assert ack.status == ack.STATUS_OK
    history: "list[ClientOp]" = []

    def drive(gen: OpenLoopGenerator, n_ops: int) -> None:
        gen.rebase(sim.virtual_ms)
        for a, status, lat in sim.serving_drive_open_loop(
            gen.arrivals(n_ops)
        ):
            history.append(ClientOp(
                client=f"c{a.client}", op=a.op, key=a.key, value=a.value,
                version=0, status=int(status),
                invoke_ms=int(a.at_ms), complete_ms=int(a.at_ms + lat),
            ))

    base = OpenLoopGenerator(
        rate_base, keys, put_fraction=0.2, seed=seed,
    )
    drive(base, 480)  # ~1.2s virtual of healthy baseline
    false_alerts = plane.firing_count()

    # overload + leader crash: the busiest leader slot goes down while the
    # arrival rate jumps past capacity -- redirects and quorum reads slow
    # service exactly when the queue is growing fastest
    faulted_from = sim.virtual_ms
    leaders = sim.placement.assign[:, 0].astype(int)
    victim = int(np.argmax(np.bincount(leaders[leaders > 0])))
    sim.crash(np.array([victim]))
    burst = OpenLoopGenerator(
        rate_burst, keys, put_fraction=0.2, seed=seed + 1,
    )
    drive(burst, 1200)
    fired_during_churn = plane.firing_count()
    rec = sim.run_until_decision(max_rounds=64, batch=16)
    assert rec is not None, "overload-recover: no view decision"
    assert set(int(c) for c in rec.cut) == {victim}, (
        "overload-recover: cut parity"
    )

    # recovery: baseline rate until the fast pair's long window (3.6s
    # scaled) has fully drained the churn's error mass
    healed_at = sim.virtual_ms
    drive(base, 1700)
    plane.tick(sim.virtual_ms, force=True)
    plane.attribute(sim.recorder.tail(4096))

    installs = [
        e for e in sim.recorder.tail(4096)
        if e["kind"] == "view_install" and e["detail"].get("trace_id")
    ]
    expected_trace = int(installs[-1]["detail"]["trace_id"]) if installs else 0
    fired = [a for a in plane.alerts() if a.fired_count > 0]
    attributed_ok = bool(fired) and all(
        a.attributed is not None
        and a.attributed.kind == "view-change"
        and int(a.attributed.trace_id) == expected_trace
        for a in fired
    )
    fast_cleared = all(
        not a.firing for a in plane.alerts() if a.window == "fast"
    )
    try:
        check_metastable_recovery(
            history, faulted_from_ms=faulted_from, healed_at_ms=healed_at,
        )
        recovered = True
    except InvariantViolation:
        recovered = False

    wall = time.perf_counter() - t0
    return {
        "config": (
            f"overload-recover: {n} nodes, open-loop "
            f"{rate_base:.0f}->{rate_burst:.0f}/s burst through a leader "
            f"crash (seed {seed})"
        ),
        "n": n,
        "virtual_ms": sim.virtual_ms,
        "wall_s": round(wall, 3),
        "cut_ok": bool(
            false_alerts == 0 and fired_during_churn > 0
            and fast_cleared and attributed_ok and recovered
        ),
        "alerts_fired_during_churn": fired_during_churn,
        "fast_alerts_cleared": fast_cleared,
        "attributed": [
            {"alert": a.name, "episode": describe(a.attributed)}
            for a in fired
        ],
        "metastable_recovery_ok": recovered,
    }


def scenario_pinned_plan(path, seed=None, device=None):
    """Replay one pinned nemesis-search corpus file (a probe spec JSON
    written by ``rapid_tpu_torch.cli.hunt --pin`` or ``tools/hunt.py
    --pin``): build the FaultPlan back through the validating builders, run
    it on its recorded harness, and demand ZERO invariant violations --
    each corpus file is the shrunk witness of a bug the search once found,
    kept as a regression tripwire. ``seed`` overrides the plan seed (same
    fault shape, different interleaving)."""
    from ..search.runner import run_probe

    with open(path) as fh:
        spec = json.load(fh)
    probe = {
        k: v for k, v in spec.items()
        if k not in ("name", "description", "expect")
    }
    if seed is not None:
        probe["plan"] = {**probe["plan"], "seed": seed}
    t0 = time.perf_counter()
    result = run_probe(probe, device=device)
    return {
        "config": (
            f"pinned plan {spec.get('name', path)}: "
            f"{len(probe['plan'].get('rules', []))} rule(s) on the "
            f"{probe.get('harness', 'engine')} harness"
        ),
        "n": probe.get("n", 5),
        "virtual_ms": result.info.get("virtual_ms"),
        "wall_s": round(time.perf_counter() - t0, 3),
        "cut_ok": not result.violated,
        "violations": [v["invariant"] for v in result.violations],
        "coverage_signals": len(result.coverage),
    }


# ---------------------------------------------------------------------------
# the registry table and batteries
# ---------------------------------------------------------------------------

register("cross-plane-10", scenario_10_node_cross_plane, seed=1)
register("crash-1k", scenario_crash, n=1000, n_fail=1, seed=100,
         label="1k virtual nodes, single crash-stop fault")
register("crash-10k", scenario_crash, n=10_000, n_fail=100, seed=200,
         label="10k virtual nodes, 1% correlated crash burst")
register("one-way-loss-50k", scenario_one_way_loss, n=50_000, n_fail=500,
         seed=300)
register("flip-flop-join-100k", scenario_flip_flop_with_join_wave,
         n=100_000, capacity=100_100, seed=400)
register("nemesis-protocol", scenario_nemesis_protocol, seed=7, n=5)
register("nemesis-smoke", scenario_nemesis_smoke, n=1000, seed=7)
register("wan-zone-loss", scenario_wan_zone_loss, seed=11)
register("hierarchy-zone-churn", scenario_hierarchy_zone_churn, seed=19)
register("gray-slow-node", scenario_gray_slow_node, seed=7)
register("gray-flapping", scenario_gray_flapping, seed=17)
register("clock-skew", scenario_clock_skew, seed=13)
register("rolling-upgrade", scenario_rolling_upgrade, seed=21)
register("serving-sawtooth", scenario_serving_sawtooth, seed=31)
register("rolling-restart", scenario_rolling_restart, seed=37)
register("overload-recover", scenario_overload_recover, seed=43)
# 10x the north-star scale: every failure class the paper holds stable, at
# 1M, with cut parity AND the from-scratch configuration-id cross-check
register("crash-1m", scenario_crash, n=1_000_000, n_fail=10_000, seed=500,
         label="1M virtual nodes, 1% correlated crash burst (10x north star)")
register("one-way-loss-1m", scenario_one_way_loss, n=1_000_000,
         n_fail=10_000, seed=501)
register("flip-flop-join-1m", scenario_flip_flop_with_join_wave,
         n=1_000_000, capacity=1_001_000, seed=502)

BATTERY = [
    "cross-plane-10", "crash-1k", "crash-10k", "one-way-loss-50k",
    "flip-flop-join-100k", "nemesis-smoke", "wan-zone-loss",
    "hierarchy-zone-churn",
    "gray-slow-node", "gray-flapping", "clock-skew", "rolling-upgrade",
    "serving-sawtooth", "rolling-restart", "overload-recover",
]
SCALE_1M = ["crash-1m", "one-way-loss-1m", "flip-flop-join-1m"]

# every pinned corpus plan (scenarios/corpus/*.json under the repository
# root) joins the registry AND the battery as a regression scenario: the
# shrunk witness of a violation the nemesis search once found must stay
# green forever
_CORPUS_DIR = REPO / "scenarios" / "corpus"
for _pin in sorted(_CORPUS_DIR.glob("*.json")):
    _name = f"corpus-{_pin.stem}"
    register(_name, scenario_pinned_plan, path=str(_pin))
    BATTERY.append(_name)


def _write_telemetry(trace_out: str, metrics_out: str) -> None:
    """Honor --trace-out / --metrics-out: export the process-global
    telemetry plane (every scenario's protocol nodes + simulators merged).
    The Chrome trace loads in Perfetto / chrome://tracing; the metrics file
    is Prometheus text exposition."""
    from ..observability import write_chrome_trace, write_prometheus

    if trace_out:
        write_chrome_trace(trace_out)
        print(json.dumps({"trace_out": trace_out}))
    if metrics_out:
        write_prometheus(metrics_out)
        print(json.dumps({"metrics_out": metrics_out}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=(
            "Run the port's scenario battery (scenarios.py's registry) and "
            "print one JSON line per scenario. Simulators run on the CUDA "
            "device unless --device names another; scenarios.py's --tpu and "
            "its CPU pin have no counterpart here."
        )
    )
    parser.add_argument("--list", action="store_true",
                        help="print the registry (names, functions, sets, "
                             "parameters) and exit; imports no torch")
    parser.add_argument("--scenario", metavar="NAME",
                        help="run one registered scenario")
    parser.add_argument("--seed", type=int, default=None,
                        help="override the scenario's (or plan's) seed")
    parser.add_argument("--plan", metavar="PATH",
                        help="replay one probe-spec JSON (a pinned corpus "
                             "file or a hand-written one)")
    parser.add_argument("--fault-plan", nargs="?", type=int, const=7,
                        default=None, metavar="SEED",
                        help="replay one seeded nemesis FaultPlan on the "
                             "protocol plane AND the device plane (seed 7 "
                             "when none is given)")
    parser.add_argument("--scale-1m", action="store_true",
                        help="run the 1M-member scenarios after the battery")
    parser.add_argument("--cells", type=int, default=0,
                        help="arm the hierarchy mirror with N cells on the "
                             "1M-scale simulators")
    parser.add_argument("--trace-out", default="",
                        help="write the process's spans as a Chrome trace")
    parser.add_argument("--metrics-out", default="",
                        help="write the process's metrics as Prometheus text")
    parser.add_argument("--device", default=None,
                        help="where simulators run (default: the CUDA "
                             "device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    if args.list:
        # pure registry dump: no torch import, usable on any host
        for name, (fn, params) in REGISTRY.items():
            battery = (
                "battery" if name in BATTERY
                else "scale-1m" if name in SCALE_1M else "on-demand"
            )
            print(json.dumps(
                {"scenario": name, "fn": fn.__name__, "set": battery, **params}
            ))
        return 0
    if args.fault_plan is not None:
        print(json.dumps(run_scenario("nemesis-protocol", seed=args.fault_plan)))
        print(json.dumps(run_scenario("nemesis-smoke", seed=args.fault_plan,
                                      device=args.device)))
    elif args.plan:
        print(json.dumps(scenario_pinned_plan(args.plan, seed=args.seed,
                                              device=args.device)))
    elif args.scenario:
        if args.scenario not in REGISTRY:
            known = ", ".join(REGISTRY)
            raise SystemExit(f"unknown scenario {args.scenario!r}; known: {known}")
        print(json.dumps(run_scenario(args.scenario, seed=args.seed,
                                      device=args.device)))
    else:
        names = BATTERY + (SCALE_1M if args.scale_1m else [])
        # --cells N arms the hierarchy mirror on the 1M-scale sims: same
        # seeds, same faults, plus the composed-view maintenance and its
        # parent-round bill in each result's "hierarchy" digest
        for name in names:
            overrides = (
                {"cells": args.cells} if args.cells and name in SCALE_1M else {}
            )
            print(json.dumps(run_scenario(name, device=args.device, **overrides)),
                  flush=True)
    _write_telemetry(args.trace_out, args.metrics_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
