"""The port's own copy of ``rapid_tpu/search/runner.py``.

Execute one nemesis-search probe: plan spec in, coverage + verdicts out.

Two harnesses share the probe-spec format (a JSON-able dict)::

    {"harness": "engine", "n": 5, "partitions": 16, "horizon_ms": 4000,
     "ops": 40, "keys": 6, "plan": {...FaultPlan.to_json...}}

``engine`` runs the real ServingEngine cluster on the virtual-time
fabric (:mod:`.fabric`) -- the harness that exercises the serving plane's
actual quorum arithmetic. ``sim`` replays the plan's device-compilable
rules on the Simulator via the ``apply_plan_at`` segment loop while a
seeded Get/Put workload rides the sim's serving mirror; rules matching
the Put wire are split out and handed to ``enable_serving`` (the sim's
serving nemesis), mirroring how ``_device_rules`` refuses non-probe
message matches.

Both harnesses are deterministic per (spec, plan seed): same spec, same
history, same coverage, same verdicts.

``device`` (the port's only addition; never part of a spec, so a spec or
a pinned plan is the JAX package's JSON byte for byte): where the ``sim``
harness's ``Simulator`` runs -- the card unless the caller names another
(``"cpu"`` for the tests); without a card and without a device a ``sim``
probe raises. The ``engine`` harness is host code and ignores it.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import FrozenSet, List, Tuple

from ..faults import FaultPlan
from .checkers import (
    ClientOp,
    InvariantViolation,
    check_config_parity,
    check_durability,
    check_fingerprint_agreement,
    check_gray_collateral,
    check_hierarchy_agreement,
    check_leader_agreement,
    check_linearizable_history,
    check_metastable_recovery,
    check_view_agreement,
)
from .coverage import (
    COVERAGE_METRICS,
    coverage_from_fault_actions,
    coverage_from_journal,
    coverage_from_metrics,
)

# fixed sim identity: matches tests/test_serving.py's serving-sim shape so
# probes reuse the same jit cache entries as the existing suite
SIM_SEED = 11
SIM_PLACEMENT = {"partitions": 32, "replicas": 3, "seed": 7}


@dataclass(frozen=True)
class ProbeResult:
    coverage: FrozenSet[tuple]
    violations: Tuple[dict, ...]
    info: dict = field(default_factory=dict)

    @property
    def violated(self) -> bool:
        return bool(self.violations)


def run_probe(spec: dict, device=None) -> ProbeResult:
    harness = spec.get("harness", "engine")
    if harness == "engine":
        return run_engine_probe(spec, device=device)
    if harness == "sim":
        return run_sim_probe(spec, device=device)
    raise ValueError(f"unknown harness {harness!r}")


def _gray_plan_victims(plan: FaultPlan):
    """``(is_pure_gray, victims)`` for the gray-collateral invariant:
    pure gray means every rule is a SlowNodeRule or LossyLinkRule (faults
    that degrade, never kill). ``victims`` is the set of dst endpoints
    those rules name, or None when any gray rule is unscoped (dst=None
    faults every link, making collateral attribution vacuous)."""
    from ..faults import LossyLinkRule, SlowNodeRule

    if not plan.rules:
        return False, None
    victims = set()
    for rule in plan.rules:
        if not isinstance(rule, (SlowNodeRule, LossyLinkRule)):
            return False, None
        dst = rule.match.dst
        if dst is None:
            return True, None
        victims.add(dst)
    return True, victims


def _plan_fault_span(plan: FaultPlan):
    """``(first_open_ms, last_clear_ms)`` across every rule window of the
    plan, or None when the plan has no rules or any window is open-ended
    (a fault that never heals supports no recovery claim, so the
    metastable-recovery check must stay vacuous)."""
    starts: List[int] = []
    ends: List[int] = []
    for rule in plan.rules:
        for start, end in rule.windows:
            if end is None:
                return None
            starts.append(int(start))
            ends.append(int(end))
    if not starts:
        return None
    return min(starts), max(ends)


def _collect(checks) -> List[dict]:
    violations: List[dict] = []
    for check in checks:
        try:
            check()
        except InvariantViolation as violation:
            violations.append(violation.to_json())
    return violations


def _witness_bundle(node: str, journal, metrics_snapshot, violations,
                    harness: str, hlc=None) -> dict:
    """Forensic evidence for a violating probe (spec flag ``forensics``):
    the harness journal (HLC-stamped when the mirror is on) and metric
    digest, bundled with the verdicts under the ``invariant_violation``
    trigger -- the same document ``rapid_tpu_torch.cli.forensics`` merges,
    so a hunt witness replays into a causal timeline."""
    from ..forensics.bundle import build_bundle, member_record

    stamp = None
    if hlc is not None:
        try:
            stamp = hlc.peek().to_wire()
        except Exception:  # noqa: BLE001 -- evidence degrades, never throws
            stamp = None
    local = member_record(
        node, hlc=stamp, journal=list(journal),
        metrics={k: int(v) for k, v in dict(metrics_snapshot).items()},
    )
    return build_bundle("invariant_violation", local, detail={
        "harness": harness,
        "kinds": sorted({v["invariant"] for v in violations}),
    })


# -- engine harness ------------------------------------------------------- #

def run_engine_probe(spec: dict, device=None) -> ProbeResult:
    from .fabric import ServingFabric

    plan = FaultPlan.from_json(spec["plan"])
    fabric = ServingFabric(
        plan,
        n=spec.get("n", 5),
        partitions=spec.get("partitions", 16),
        replicas=spec.get("replicas", 3),
        forensics=bool(spec.get("forensics", False)),
    )
    history = fabric.run(
        spec.get("horizon_ms", 4000), spec.get("ops", 40),
        keys=spec.get("keys", 6),
    )
    checks = [
        lambda: check_linearizable_history(history),
        lambda: check_leader_agreement(fabric.live_digests()),
        lambda: check_view_agreement(fabric.map_versions()),
    ]
    from ..faults import CellPartitionRule, RestartNodeRule, TornWriteRule

    hier_rules = [r for r in plan.rules if isinstance(r, CellPartitionRule)]
    if hier_rules:
        # cell-partition plans additionally carry the hierarchy oracle:
        # every live node's composed global view (derived from its own
        # map) must agree, and no cell may see two live leaders
        cells = max(r.cells for r in hier_rules)
        checks.append(
            lambda: check_hierarchy_agreement(fabric.hierarchy_digests(cells))
        )
    if any(isinstance(r, (RestartNodeRule, TornWriteRule)) for r in plan.rules):
        # restart-bearing plans additionally carry the durability oracle:
        # acked writes must survive every crash-and-recover, and each
        # recovered node's row must hold converged fingerprints
        acked_versions: dict = {}
        for o in history:
            if o.op == "put" and o.status == 0:  # PutAck.STATUS_OK
                if o.version > acked_versions.get(o.key, 0):
                    acked_versions[o.key] = o.version
        # a drop-class Put rule still open when the run ends legitimately
        # leaves replica rows lagging -- the sim probe's lossy-replication
        # fingerprint carve-out, applied to the recovery witness
        end_ms = spec.get("horizon_ms", 4000)
        lossy_at_end = any(
            rs.get("type") in ("DropRule", "LossyLinkRule")
            and (rs.get("msg_types") is None or "Put" in rs["msg_types"])
            and any(
                w[1] is None or w[1] >= end_ms
                for w in rs.get("windows", ())
            )
            for rs in spec["plan"].get("rules", ())
        )
        checks.append(
            lambda: check_durability(
                acked_versions,
                fabric.durable_versions(),
                () if lossy_at_end else fabric.recovery_fingerprints(),
            )
        )
    pure_gray, victims = _gray_plan_victims(plan)
    if pure_gray and victims is not None:
        evicted = [
            entry["detail"]["evicted"]
            for entry in fabric.journal()
            if entry["kind"] == "view_install"
            and "evicted" in entry["detail"]
        ]
        checks.append(
            lambda: check_gray_collateral(
                {str(v) for v in victims}, evicted
            )
        )
    span = _plan_fault_span(plan)
    horizon = spec.get("horizon_ms", 4000)
    if span is not None and span[1] < horizon:
        # every fault heals inside the horizon: the back half of the
        # post-heal window must see goodput return to the pre-fault
        # baseline (metastability check; vacuous when either segment is
        # too thin -- see checkers.check_metastable_recovery)
        faulted_from, healed_at = span[0], span[1] + (horizon - span[1]) // 2
        checks.append(
            lambda: check_metastable_recovery(
                history,
                faulted_from_ms=faulted_from,
                healed_at_ms=healed_at,
            )
        )
    violations = _collect(checks)
    snapshot = {
        name: fabric.metrics.get(name) for name in COVERAGE_METRICS
    }
    coverage = (
        coverage_from_journal(fabric.journal())
        | coverage_from_metrics(snapshot)
        | coverage_from_fault_actions(fabric.metrics.snapshot())
    )
    acked = sum(1 for o in history if o.op == "put" and o.status == 0)
    info = {
        "harness": "engine",
        "history": len(history),
        "acked_puts": acked,
        "virtual_ms": fabric.scheduler.now_ms(),
        "live": len(fabric.live),
    }
    if violations and spec.get("forensics"):
        info["bundle"] = _witness_bundle(
            "fabric", fabric.journal(), fabric.metrics.snapshot(),
            violations, "engine", hlc=fabric.hlc,
        )
    return ProbeResult(
        coverage=coverage,
        violations=tuple(violations),
        info=info,
    )


# -- sim harness ---------------------------------------------------------- #

def _is_serving_rule(rule_spec: dict) -> bool:
    # Put-wire matches and storage-plane stalls both land on the serving
    # mirror's nemesis; everything else is the device plane's problem
    return (
        rule_spec.get("msg_types") == ["Put"]
        or rule_spec.get("type") == "DiskStallRule"
    )


def run_sim_probe(spec: dict, device=None) -> ProbeResult:
    from ..faults import (
        RestartNodeRule,
        UnsupportedDeviceFault,
        _boundaries,
        _device_rules,
        apply_plan_at,
        endpoint_slots,
    )
    from ..sim.driver import Simulator
    from ..sim.engine import SimConfig
    from ..types import PutAck

    plan_spec = spec["plan"]
    rule_specs = plan_spec.get("rules", [])
    base = {k: v for k, v in plan_spec.items() if k != "rules"}
    serving_specs = [r for r in rule_specs if _is_serving_rule(r)]
    device_specs = [r for r in rule_specs if not _is_serving_rule(r)]
    serving_plan = (
        FaultPlan.from_json({**base, "rules": serving_specs})
        if serving_specs else None
    )
    device_plan = FaultPlan.from_json({**base, "rules": device_specs})

    capacity = spec.get("capacity", 5)
    # "fd_gray_confirm" > 0 runs the probe with the adaptive FD's sim-plane
    # mirror on (engine.py gray streak path) -- the seam the regression
    # suite uses to pin that adaptation does not perturb probe verdicts
    sim = Simulator(
        spec.get("n", 4), capacity=capacity,
        config=SimConfig(
            capacity=capacity,
            fd_gray_confirm=spec.get("fd_gray_confirm", 0),
            fd_gray_warmup=spec.get("fd_gray_warmup", 3),
            forensics=bool(spec.get("forensics", False)),
        ),
        seed=SIM_SEED,
        device=device,
    ).ready()
    sim.enable_placement(**SIM_PLACEMENT)
    sim.enable_handoff(chunk_size=1024)
    sim.enable_serving(request_ms=1, fault_plan=serving_plan)
    hier_cells = max(
        (int(r.get("cells", 0)) for r in rule_specs
         if r.get("type") == "CellPartitionRule"),
        default=0,
    )
    if hier_cells:
        # cell-partition plans run the hierarchy mirror so the composed
        # global view's incremental maintenance is under oracle
        sim.enable_hierarchy(cells=hier_cells)
    seated = endpoint_slots(sim)
    restart_victims = sorted({
        seated[r.match.dst] for r in device_plan.rules
        if isinstance(r, RestartNodeRule) and r.match.dst in seated
    })
    if restart_victims:
        # restart-bearing plans run the durability mirror so each victim's
        # replay debt is billed on the virtual clock at recovery
        sim.enable_durability(replay_record_ms=1)

    rnd = random.Random(int(plan_spec.get("seed", 0)) * 2_000_003 + 29)
    keys = [b"sk-%02d" % i for i in range(spec.get("keys", 8))]
    history: List[ClientOp] = []

    def do_ops(count: int) -> None:
        for _ in range(count):
            key = keys[rnd.randrange(len(keys))]
            invoke = sim.virtual_ms
            if rnd.random() < 0.55:
                value = b"sv-%d" % len(history)
                ack = sim.serving_put(key, value)
                history.append(ClientOp(
                    "sim", "put", key, value, ack.version, ack.status,
                    invoke, sim.virtual_ms,
                ))
            else:
                ack = sim.serving_get(key)
                history.append(ClientOp(
                    "sim", "get", key, ack.value, ack.version, ack.status,
                    invoke, sim.virtual_ms,
                ))

    horizon = spec.get("horizon_ms", 20_000)
    ops = spec.get("ops", 30)
    slots = endpoint_slots(sim)
    round_ms = sim.config.fd_interval_ms // sim.config.rounds_per_interval
    info: dict = {"harness": "sim"}
    try:
        rules = _device_rules(device_plan, round_ms)
    except UnsupportedDeviceFault as exc:
        # a mutated plan can drift outside the device-compilable subset;
        # report it as an empty probe rather than crashing the hunt
        return ProbeResult(
            coverage=frozenset(), violations=(),
            info={**info, "unsupported": str(exc)},
        )
    do_ops(max(1, ops // 4))
    # segment loop (replay_on_simulator's shape) with workload interleaved
    # at every fault-schedule boundary
    epoch = sim.virtual_ms
    times = _boundaries(rules, horizon, round_ms)
    per_segment = max(1, ops // (2 * max(1, len(times) - 1)))
    for seg_start, seg_end in zip(times, times[1:]):
        apply_plan_at(sim, device_plan, seg_start, slots)
        do_ops(per_segment)
        target = epoch + seg_end
        while sim.virtual_ms < target:
            remaining = math.ceil((target - sim.virtual_ms) / round_ms)
            if sim.run_until_decision(
                max_rounds=remaining, batch=min(8, remaining)
            ) is None:
                break
        do_ops(per_segment)
    # heal and settle, then read back every acked key: the oracle reads
    # become history entries the linearizability checker judges
    sim.clear_link_faults()
    sim.run_until_decision(max_rounds=40, batch=8)
    if restart_victims:
        # the compiled down-windows have closed; now take each victim
        # through an actual crash-and-replay so the recovery path (and its
        # virtual-time bill) lands in the same probe history
        info["replayed_records"] = sum(
            sim.restart_slot(slot) for slot in restart_victims
        )
        sim.run_until_decision(max_rounds=8, batch=4)
    # everything from here on is post-heal, post-restart, post-settle: the
    # tail the metastable-recovery check holds to the pre-fault baseline
    healed_ms = sim.virtual_ms
    do_ops(max(1, ops // 4))
    for key in sorted(sim.serving_acked):
        invoke = sim.virtual_ms
        ack = sim.serving_get(key)
        history.append(ClientOp(
            "sim", "get", key, ack.value, ack.version, ack.status,
            invoke, sim.virtual_ms,
        ))

    stamped = sim.configuration_id()
    sim._config_id = None  # noqa: SLF001 -- drop the memo, force the fold
    sim._spec = None  # noqa: SLF001
    checks = [
        lambda: check_linearizable_history(history),
        lambda: check_config_parity(stamped, sim.configuration_id()),
    ]
    if sim.hierarchy_enabled:
        # the incrementally maintained composition must match a
        # from-scratch recompute over the surviving slots (and every cell
        # must name exactly one live leader)
        checks.append(
            lambda: check_hierarchy_agreement(_sim_hierarchy_digests(sim))
        )
    if restart_victims:
        acked_versions = {
            key: version for key, (version, _v) in sim.serving_acked.items()
        }
        checks.append(
            lambda: check_durability(
                acked_versions, _sim_durable_versions(sim)
            )
        )
    if not serving_specs:
        # with lossy Put replication a minority replica may legitimately
        # lag until the next reconcile; fingerprints must agree only when
        # every replication write went through
        checks.append(
            lambda: check_fingerprint_agreement(_sim_fingerprints(sim))
        )
    pure_gray, victims = _gray_plan_victims(device_plan)
    if pure_gray and victims is not None:
        # the sim probe never joins, so every cut entry is an eviction;
        # rule dsts map to slots through the same seated-identity table
        # apply_plan_at compiles the rules with
        victim_labels = {
            f"slot{slots[v]}" for v in victims if v in slots
        }
        evicted_labels = [
            f"slot{int(c)}"
            for rec in sim.view_changes
            for c in rec.cut.reshape(-1)
        ]
        checks.append(
            lambda: check_gray_collateral(victim_labels, evicted_labels)
        )
    spans = [
        span for span in (
            _plan_fault_span(device_plan),
            _plan_fault_span(serving_plan) if serving_plan is not None
            else None,
        ) if span is not None
    ]
    if spans and (serving_plan is None or len(spans) == 2):
        # every window across both plan halves is bounded: the post-heal
        # tail must see goodput back at the pre-fault baseline.
        # Serving-nemesis windows run on their own arm epoch (slightly
        # before the workload epoch), so folding them onto the workload
        # epoch only widens the baseline exclusion -- conservative.
        faulted_from = epoch + min(s[0] for s in spans)
        healed_at = max(healed_ms, epoch + max(s[1] for s in spans))
        checks.append(
            lambda: check_metastable_recovery(
                history,
                faulted_from_ms=faulted_from,
                healed_at_ms=healed_at,
            )
        )
    violations = _collect(checks)
    snapshot = {name: sim.metrics.get(name) for name in COVERAGE_METRICS}
    coverage = (
        coverage_from_journal(sim.recorder.tail(4096))
        | coverage_from_metrics(snapshot)
        | coverage_from_fault_actions(sim.metrics.snapshot())
    )
    acked = sum(
        1 for o in history
        if o.op == "put" and o.status == PutAck.STATUS_OK
    )
    info = {
        **info,
        "history": len(history),
        "acked_puts": acked,
        "virtual_ms": sim.virtual_ms,
        "view_changes": len(sim.view_changes),
    }
    if violations and spec.get("forensics"):
        info["bundle"] = _witness_bundle(
            "sim", sim.recorder.tail(4096), sim.metrics.snapshot(),
            violations, "sim", hlc=sim.hlc,
        )
    return ProbeResult(
        coverage=coverage,
        violations=tuple(violations),
        info=info,
    )


def _sim_durable_versions(sim) -> dict:
    """Per key, the highest version held in any live replica's store -- the
    sim-probe ground truth for the durability invariant."""
    from ..serving.kv import decode_kv

    assign = sim.placement.assign
    out: dict = {}
    for p in range(assign.shape[0]):
        for slot in assign[p]:
            slot = int(slot)
            if slot < 0 or not sim.alive[slot]:
                continue
            for key, (version, _value) in decode_kv(
                sim.handoff_stores[slot].get(p)
            ).items():
                if version > out.get(key, 0):
                    out[key] = version
    return out


def _sim_hierarchy_digests(sim) -> dict:
    """Two composition sources the hierarchy checker must see agree: the
    sim's incrementally maintained rows, and a from-scratch recompute over
    the live slots. Divergence means the incremental path dropped or
    misattributed a churn edge."""
    def digest() -> Tuple[Tuple[int, ...], Tuple[str, ...], int]:
        rows = sim.hierarchy_rows()
        return (
            tuple(r.cell for r in rows),
            tuple(r.leader for r in rows),
            sim.global_fingerprint(),
        )

    incremental = digest()
    for cell in range(sim._hier_n_cells):  # noqa: SLF001
        sim._hierarchy_recompute_cell(cell)  # noqa: SLF001
    return {"incremental": incremental, "recomputed": digest()}


def _sim_fingerprints(sim) -> List[Tuple[int, str, object]]:
    assign = sim.placement.assign
    out: List[Tuple[int, str, object]] = []
    for p in range(assign.shape[0]):
        for slot in assign[p]:
            if slot < 0:
                continue
            out.append((p, f"slot{int(slot)}", sim.handoff_stores[int(slot)].get(p)))
    return out
