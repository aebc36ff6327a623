"""The port's own copy of ``rapid_tpu/search/generator.py``.

Seeded FaultPlan generator + mutator for the nemesis search.

Plans are handled as their ``FaultPlan.to_json`` dicts (specs), so the
generator, shrinker, and corpus files all speak the same format. Every
candidate is validated by actually building it through
``FaultPlan.from_json`` -- a sampled rule the builders reject (window
sanity, partition conflicts, parameter ranges) is resampled, never
emitted.

All randomness is ``random.Random`` seeded from ``(seed, purpose,
index)`` mixed through crc32, so the same seed produces the same plan
stream in every process regardless of hash randomization.
"""

from __future__ import annotations

import random
import zlib
from typing import List, Sequence

from ..faults import FaultPlan

# Every Rule subclass the generator can emit. tests/test_torch_search.py
# lints this literal against the Rule subclasses defined in the port's
# faults.py (the same sync discipline RULE_CATALOG enforces), so a new
# fault rule cannot silently stay unreachable by the search.
GEN_RULES = (
    "CellPartitionRule",
    "ClockSkewRule",
    "DelayRule",
    "DiskStallRule",
    "DropRule",
    "DuplicateRule",
    "FlipFlopRule",
    "LossyLinkRule",
    "PartitionRule",
    "ReorderRule",
    "RestartNodeRule",
    "SlowNodeRule",
    "TornWriteRule",
    "WireVersionRule",
)

HARNESSES = ("engine", "sim")


def _mix(*parts: object) -> int:
    return zlib.crc32("|".join(str(p) for p in parts).encode("utf-8"))


class PlanGenerator:
    """Samples fresh plan specs and mutates corpus members.

    ``harness="engine"`` targets the serving fabric (full rule algebra,
    Put/Get wire matches, occasional latency topologies); ``harness="sim"``
    emits only rules the device plane can compile (``_device_rules``) plus
    Put-wire serving rules the sim's serving nemesis understands -- the
    runner splits those two families before replay.
    """

    def __init__(self, seed: int, endpoints: Sequence[object],
                 horizon_ms: int, harness: str = "engine") -> None:
        assert harness in HARNESSES, harness
        self.seed = int(seed)
        self.endpoints = [str(ep) for ep in endpoints]
        self.horizon_ms = int(horizon_ms)
        self.harness = harness

    def _rng(self, purpose: str, index: int) -> random.Random:
        return random.Random(
            self.seed * 1_000_003 + _mix(self.harness, purpose, index)
        )

    # -- sampling ---------------------------------------------------------

    def fresh(self, index: int) -> dict:
        # fresh plans are deliberately sparse (mostly one rule): compound
        # faults are supposed to be *composed* by corpus mutation, so the
        # guided search earns its coverage edge by stacking rules that each
        # proved interesting, rather than fresh sampling lucking into them
        rnd = self._rng("fresh", index)
        n_rules = 1
        if rnd.random() < 0.2:
            n_rules += 1
        spec: dict = {"seed": self.seed * 100_000 + index, "rules": []}
        if self.harness == "engine" and rnd.random() < 0.15:
            # named nemesis archetype (Jepsen style): a churn-split stacks
            # an eviction-grade fault on one node with message-class drops
            # on two others -- the shape that stresses promote-time sync
            # quorums. Targeting is random; guidance tunes it by mutation.
            self._churn_split(spec, rnd)
        else:
            for _ in range(n_rules):
                self._append_rule(spec, rnd)
        if self.harness == "engine" and rnd.random() < 0.2:
            self._attach_topology(spec, rnd)
        return spec

    def _churn_split(self, spec: dict, rnd: random.Random) -> None:
        nodes = list(self.endpoints)
        rnd.shuffle(nodes)
        evicted, starved, muted = nodes[0], nodes[1], nodes[2 % len(nodes)]
        split_ms = rnd.randrange(
            self.horizon_ms // 8, self.horizon_ms * 5 // 8
        )
        spec["rules"] = [
            {"type": "DropRule", "at": "egress", "windows": [[0, None]],
             "src": None, "dst": starved, "msg_types": ["Put"],
             "probability": 1.0},
            {"type": "PartitionRule", "at": "egress",
             "windows": [[split_ms, None]], "src": None, "dst": evicted,
             "msg_types": None},
            {"type": "DropRule", "at": "egress",
             "windows": [[split_ms, None]], "src": None, "dst": muted,
             "msg_types": ["Get"], "probability": 1.0},
        ]

    def mutate(self, base: dict, index: int) -> dict:
        """One mutation step on a corpus member: add a rule (the compound-
        fault driver), retarget a link, resample a window, or drop a rule.
        Falls back to a fresh plan if the mutant fails validation."""
        rnd = self._rng("mutate", index)
        spec = {
            **base,
            "rules": [dict(r) for r in base.get("rules", [])],
        }
        rules: List[dict] = spec["rules"]
        choice = rnd.random()
        if choice < 0.5 or not rules:
            self._append_rule(spec, rnd)
        elif choice < 0.7:
            rule = rules[rnd.randrange(len(rules))]
            if rule.get("dst") is not None:
                rule["dst"] = self._node(rnd)
        elif choice < 0.9:
            rule = rules[rnd.randrange(len(rules))]
            rule["windows"] = [self._window(rnd)]
        elif len(rules) > 1:
            rules.pop(rnd.randrange(len(rules)))
        if not self._valid(spec):
            return self.fresh(index)
        return spec

    def _valid(self, spec: dict) -> bool:
        try:
            FaultPlan.from_json(spec)
        except (ValueError, AssertionError, KeyError):
            return False
        return True

    def _append_rule(self, spec: dict, rnd: random.Random) -> None:
        # bounded resample: a candidate the builders reject (e.g. a
        # partition-window conflict) is replaced, not emitted
        for _ in range(8):
            rule = self._sample_rule(rnd)
            trial = {**spec, "rules": list(spec["rules"]) + [rule]}
            if self._valid(trial):
                spec["rules"].append(rule)
                return

    def _node(self, rnd: random.Random) -> str:
        return rnd.choice(self.endpoints)

    def _window(self, rnd: random.Random) -> list:
        start = rnd.randrange(0, max(1, self.horizon_ms * 3 // 4))
        if rnd.random() < 0.5:
            return [start, None]
        span = rnd.randrange(self.horizon_ms // 8 + 1, self.horizon_ms + 1)
        return [start, start + span]

    def _sample_rule(self, rnd: random.Random) -> dict:
        if self.harness == "engine":
            return self._sample_engine_rule(rnd)
        return self._sample_sim_rule(rnd)

    def _base(self, kind: str, rnd: random.Random, *, dst=None, src=None,
              msg_types=None, windows=None) -> dict:
        return {
            "type": kind,
            "at": "egress",
            "windows": windows if windows is not None else [self._window(rnd)],
            "src": src,
            "dst": dst,
            "msg_types": msg_types,
        }

    def _sample_engine_rule(self, rnd: random.Random) -> dict:
        kind = rnd.choice(GEN_RULES)
        wire = rnd.choice([["Put"], ["Get"], None])
        dst = self._node(rnd) if rnd.random() < 0.8 else None
        if kind == "DropRule":
            spec = self._base(kind, rnd, dst=dst, msg_types=wire)
            spec["probability"] = rnd.choice([0.5, 0.75, 1.0])
        elif kind == "PartitionRule":
            spec = self._base(kind, rnd, dst=self._node(rnd))
        elif kind == "CellPartitionRule":
            cells = rnd.choice([2, 3, 4, 8])
            spec = self._base(kind, rnd)
            spec["cells"] = cells
            spec["cell"] = rnd.randrange(0, cells)
        elif kind == "FlipFlopRule":
            spec = self._base(kind, rnd, dst=self._node(rnd))
            spec["period_ms"] = rnd.choice([800, 1600, 2400])
            spec["start_ms"] = rnd.randrange(0, 400)
        elif kind == "DelayRule":
            spec = self._base(kind, rnd, dst=dst, msg_types=wire)
            spec["base_ms"] = rnd.choice([5, 20, 45])
            spec["jitter_ms"] = rnd.randrange(0, 20)
        elif kind == "DuplicateRule":
            spec = self._base(kind, rnd, dst=dst,
                              msg_types=wire or ["Put"])
            spec["probability"] = round(0.3 + 0.5 * rnd.random(), 3)
        elif kind == "ReorderRule":
            spec = self._base(kind, rnd, dst=dst, msg_types=wire)
            spec["probability"] = round(0.3 + 0.5 * rnd.random(), 3)
            spec["max_extra_ms"] = rnd.choice([20, 40, 80])
        elif kind == "LossyLinkRule":
            spec = self._base(kind, rnd, dst=dst, msg_types=wire)
            spec["probability"] = rnd.choice([0.3, 0.6])
        elif kind == "SlowNodeRule":
            spec = self._base(kind, rnd, dst=self._node(rnd))
            spec["response_delay_ms"] = rnd.choice([30, 80, 200])
        elif kind == "ClockSkewRule":
            spec = self._base(kind, rnd, src=self._node(rnd),
                              windows=[[0, None]])
            spec["offset_ms"] = rnd.choice([-200, 0, 200])
            spec["rate"] = rnd.choice([0.75, 1.0, 1.25])
        elif kind == "RestartNodeRule":
            # closed down windows short enough that the fabric's recovery
            # path (not its eviction machinery) is what gets exercised
            start = rnd.randrange(0, max(1, self.horizon_ms // 2))
            down = rnd.choice([150, 300, 600])
            spec = self._base(kind, rnd, dst=self._node(rnd),
                              windows=[[start, start + down]])
        elif kind == "TornWriteRule":
            spec = self._base(kind, rnd, dst=self._node(rnd),
                              windows=[[0, None]])
            spec["drop_bytes"] = rnd.choice([1, 3, 9])
            spec["corrupt"] = rnd.random() < 0.5
        elif kind == "DiskStallRule":
            spec = self._base(kind, rnd, dst=self._node(rnd),
                              msg_types=["Put"])
            spec["stall_ms"] = rnd.choice([10, 40, 120])
        else:  # WireVersionRule
            spec = self._base(kind, rnd, src=self._node(rnd))
            spec["version"] = rnd.choice([1, 3])
        return spec

    def _sample_sim_rule(self, rnd: random.Random) -> dict:
        # serving-wire family: rules the sim's serving nemesis applies to
        # Put replication (the runner routes these to enable_serving)
        if rnd.random() < 0.4:
            kind = rnd.choice(
                ("DropRule", "DuplicateRule", "ReorderRule", "DelayRule",
                 "DiskStallRule")
            )
            spec = self._base(kind, rnd, msg_types=["Put"],
                              windows=[[0, None]])
            if kind == "DropRule":
                spec["probability"] = rnd.choice([0.25, 0.5])
            elif kind == "DuplicateRule":
                spec["probability"] = rnd.choice([0.3, 0.6])
            elif kind == "ReorderRule":
                spec["probability"] = rnd.choice([0.3, 0.6])
                spec["max_extra_ms"] = rnd.choice([20, 50])
            elif kind == "DiskStallRule":
                spec["dst"] = self._node(rnd)
                spec["stall_ms"] = rnd.choice([5, 20])
            else:
                spec["base_ms"] = rnd.choice([2, 5])
                spec["jitter_ms"] = rnd.randrange(0, 4)
            return spec
        # device family: only what _device_rules compiles (no src matches,
        # probe-wire only, skew rate in the supported band, sub-round
        # delays)
        kind = rnd.choice(
            ("DropRule", "PartitionRule", "CellPartitionRule",
             "FlipFlopRule", "LossyLinkRule", "SlowNodeRule",
             "ClockSkewRule", "DelayRule", "RestartNodeRule")
        )
        dst = self._node(rnd)
        if kind == "DropRule":
            spec = self._base(kind, rnd, dst=dst)
            spec["probability"] = rnd.choice([0.5, 1.0])
        elif kind == "PartitionRule":
            spec = self._base(kind, rnd, dst=dst)
        elif kind == "CellPartitionRule":
            cells = rnd.choice([2, 4, 8])
            spec = self._base(kind, rnd)
            spec["cells"] = cells
            spec["cell"] = rnd.randrange(0, cells)
        elif kind == "FlipFlopRule":
            spec = self._base(kind, rnd, dst=dst)
            spec["period_ms"] = rnd.choice([2000, 4000, 8000])
        elif kind == "LossyLinkRule":
            spec = self._base(kind, rnd, dst=dst)
            spec["probability"] = rnd.choice([0.3, 0.6])
        elif kind == "SlowNodeRule":
            spec = self._base(kind, rnd, dst=dst)
            spec["response_delay_ms"] = rnd.choice([300, 1000, 4000])
        elif kind == "ClockSkewRule":
            spec = self._base(kind, rnd, src=dst, windows=[[0, None]])
            spec["offset_ms"] = rnd.choice([-500, 0, 500])
            spec["rate"] = rnd.choice([0.8, 1.0, 1.25])
        elif kind == "RestartNodeRule":
            # down spans on the sim's detection timescale: long enough to
            # exercise the membership reaction, always closed
            start = rnd.randrange(0, max(1, self.horizon_ms // 2))
            down = rnd.choice([2000, 4000, 8000])
            spec = self._base(kind, rnd, dst=dst,
                              windows=[[start, start + down]])
        else:  # DelayRule: must stay under the FD round to compile
            spec = self._base(kind, rnd, dst=dst)
            spec["base_ms"] = rnd.choice([10, 40])
            spec["jitter_ms"] = rnd.randrange(0, 10)
        return spec

    def _attach_topology(self, spec: dict, rnd: random.Random) -> None:
        spec["topology"] = {
            "racks": max(4, len(self.endpoints)),
            "zones": rnd.choice([1, 2]),
            "regions": 1,
            "rack_rtt_ms": 0,
            "zone_rtt_ms": rnd.choice([1, 2]),
            "region_rtt_ms": rnd.choice([2, 4]),
            "inter_region_rtt_ms": rnd.choice([4, 8]),
        }
        spec["topology_slots"] = {
            ep: i for i, ep in enumerate(self.endpoints)
        }
