"""The port's own copy of ``rapid_tpu/search/shrinker.py``.

Delta-debugging shrinker for violating probe specs.

Greedy ddmin to a fixpoint: try removing rules one at a time, then
narrowing each rule's windows (pin the start to 0, close open ends,
halve closed spans), then dropping the topology, shrinking the cluster,
and halving the workload -- keeping any reduction under which the
original violation still reproduces (same invariant tags, judged by
re-running the probe). Every reduction attempt costs one probe; the
whole shrink is bounded by ``max_probes``.

The plan seed is never touched: a shrunk plan reproduces with the exact
decision streams that found the violation.
"""

from __future__ import annotations

import copy
from typing import Callable, FrozenSet, Optional, Tuple

from .runner import run_probe


def violation_kinds(spec: dict, device=None) -> FrozenSet[str]:
    return frozenset(
        v["invariant"] for v in run_probe(spec, device=device).violations
    )


def shrink_spec(
    spec: dict,
    target_kinds: Optional[FrozenSet[str]] = None,
    max_probes: int = 200,
    device=None,
) -> Tuple[dict, int]:
    """Minimize ``spec`` while ``target_kinds`` (default: the kinds the
    unshrunk spec violates) all still reproduce. Returns the minimized
    spec and the number of probes spent. ``device``: as ``run_probe``'s."""
    spent = [0]
    target = (
        frozenset(target_kinds) if target_kinds is not None
        else violation_kinds(spec, device=device)
    )
    if target_kinds is None:
        spent[0] += 1
    if not target:
        return copy.deepcopy(spec), spent[0]

    def reproduces(candidate: dict) -> bool:
        if spent[0] >= max_probes:
            return False
        spent[0] += 1
        return target <= violation_kinds(candidate, device=device)

    current = copy.deepcopy(spec)
    changed = True
    while changed and spent[0] < max_probes:
        changed = False
        changed |= _drop_rules(current, reproduces)
        changed |= _narrow_windows(current, reproduces)
        changed |= _drop_topology(current, reproduces)
        changed |= _shrink_cluster(current, reproduces)
        changed |= _halve_ops(current, reproduces)
    return current, spent[0]


def _plan(spec: dict) -> dict:
    return spec["plan"]


def _with_rules(spec: dict, rules: list) -> dict:
    out = copy.deepcopy(spec)
    out["plan"]["rules"] = rules
    return out


def _drop_rules(current: dict, reproduces: Callable[[dict], bool]) -> bool:
    changed = False
    i = 0
    while i < len(_plan(current)["rules"]):
        rules = _plan(current)["rules"]
        if len(rules) <= 1:
            break
        trial = _with_rules(current, rules[:i] + rules[i + 1:])
        if reproduces(trial):
            current["plan"] = trial["plan"]
            changed = True
        else:
            i += 1
    return changed


def _narrow_windows(current: dict,
                    reproduces: Callable[[dict], bool]) -> bool:
    changed = False
    for i, rule in enumerate(_plan(current)["rules"]):
        for j, (start, end) in enumerate(list(rule.get("windows", []))):
            if start > 0:
                trial = copy.deepcopy(current)
                trial["plan"]["rules"][i]["windows"][j] = [0, end]
                if reproduces(trial):
                    current["plan"] = trial["plan"]
                    rule = _plan(current)["rules"][i]
                    start = 0
                    changed = True
            if end is not None and end - start > 2:
                trial = copy.deepcopy(current)
                trial["plan"]["rules"][i]["windows"][j] = [
                    start, start + (end - start) // 2
                ]
                if reproduces(trial):
                    current["plan"] = trial["plan"]
                    rule = _plan(current)["rules"][i]
                    changed = True
    return changed


def _drop_topology(current: dict,
                   reproduces: Callable[[dict], bool]) -> bool:
    if "topology" not in _plan(current):
        return False
    trial = copy.deepcopy(current)
    trial["plan"].pop("topology", None)
    trial["plan"].pop("topology_slots", None)
    if reproduces(trial):
        current["plan"] = trial["plan"]
        return True
    return False


def _shrink_cluster(current: dict,
                    reproduces: Callable[[dict], bool]) -> bool:
    """Engine harness only: drop the highest-numbered node while no rule
    references it and a replica row still fits."""
    if current.get("harness", "engine") != "engine":
        return False
    changed = False
    while True:
        n = current.get("n", 5)
        if n <= current.get("replicas", 3) + 1:
            break
        top = f"node:{7000 + n - 1}"
        if any(
            top in (rule.get("src"), rule.get("dst"))
            for rule in _plan(current)["rules"]
        ) or top in (_plan(current).get("topology_slots") or {}):
            break
        trial = copy.deepcopy(current)
        trial["n"] = n - 1
        if not reproduces(trial):
            break
        current["n"] = n - 1
        changed = True
    return changed


def _halve_ops(current: dict, reproduces: Callable[[dict], bool]) -> bool:
    changed = False
    while True:
        ops = current.get("ops", 40)
        if ops < 16:
            break
        trial = copy.deepcopy(current)
        trial["ops"] = ops // 2
        if not reproduces(trial):
            break
        current["ops"] = ops // 2
        changed = True
    return changed
