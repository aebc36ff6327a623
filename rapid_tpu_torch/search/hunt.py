"""The port's own copy of ``rapid_tpu/search/hunt.py``.

The budgeted hunter: generate -> probe -> cover -> shrink -> pin.

Each round the hunter either mutates a corpus member (guided mode, with
probability MUTATE_P once the corpus is non-empty) or samples a fresh
plan. A probe whose coverage contributes any unvisited signal joins the
mutation corpus -- that bias is the whole difference between guided and
unguided search, and the guided-beats-unguided transition-count test in
tests/test_search.py is the contract. The first probe violating each
invariant kind is handed to the shrinker; the minimized spec is what
gets pinned to the corpus directory.

Everything is deterministic per (seed, budget, harness): plan sampling,
probe execution, corpus growth, shrink order.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional

from .coverage import transitions
from .fabric import fabric_endpoints
from .generator import PlanGenerator
from .runner import run_probe
from .shrinker import shrink_spec

MUTATE_P = 0.6

# default probe shapes per harness (spread over a spec by _spec_for)
ENGINE_DEFAULTS = {
    "n": 5, "partitions": 16, "replicas": 3,
    "horizon_ms": 4000, "ops": 40, "keys": 6,
}
SIM_DEFAULTS = {
    "n": 4, "capacity": 5, "horizon_ms": 20_000, "ops": 30, "keys": 8,
}


def harness_endpoints(harness: str, probe_defaults: dict) -> List[str]:
    if harness == "engine":
        return [str(ep) for ep in fabric_endpoints(probe_defaults["n"])]
    # sim endpoints are the Simulator's synthesized identities
    # (VirtualCluster.synthesize: "10.a.b.c" hostname, port 5000 + slot);
    # they depend only on capacity, which is fixed per harness defaults
    return [
        f"10.{(i >> 16) & 0xFF}.{(i >> 8) & 0xFF}.{i & 0xFF}:{5000 + i % 1000}"
        for i in range(probe_defaults["capacity"])
    ]


@dataclass
class HuntReport:
    seed: int
    harness: str
    guided: bool
    budget: int
    probes: int = 0
    coverage: FrozenSet[tuple] = frozenset()
    corpus: List[dict] = field(default_factory=list)
    violations: List[dict] = field(default_factory=list)
    pinned: List[dict] = field(default_factory=list)

    def transition_count(self) -> int:
        return len(transitions(self.coverage))

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "harness": self.harness,
            "guided": self.guided,
            "budget": self.budget,
            "probes": self.probes,
            "coverage_signals": len(self.coverage),
            "event_transitions": self.transition_count(),
            "corpus": len(self.corpus),
            "violations": self.violations,
            "pinned": self.pinned,
        }

    def report_text(self) -> str:
        lines = [
            f"hunt: seed={self.seed} harness={self.harness} "
            f"{'guided' if self.guided else 'unguided'} "
            f"budget={self.budget}",
            f"  probes run          {self.probes}",
            f"  coverage signals    {len(self.coverage)}",
            f"  event transitions   {self.transition_count()}",
            f"  corpus plans        {len(self.corpus)}",
            f"  violations          {len(self.violations)}",
        ]
        for entry in self.violations:
            kinds = sorted({v["invariant"] for v in entry["violations"]})
            lines.append(
                f"    probe {entry['probe']}: {', '.join(kinds)}"
            )
        for pin in self.pinned:
            lines.append(
                f"  pinned: {sorted(pin['kinds'])} with "
                f"{len(pin['spec']['plan']['rules'])} rule(s) "
                f"after {pin['shrink_probes']} shrink probes"
            )
        return "\n".join(lines)


class Hunter:
    def __init__(self, seed: int = 0, budget: int = 50,
                 harness: str = "engine", guided: bool = True,
                 shrink: bool = True, shrink_budget: int = 200,
                 probe_overrides: Optional[dict] = None,
                 forensics: bool = False, device=None) -> None:
        self.seed = int(seed)
        self.budget = int(budget)
        self.harness = harness
        self.guided = guided
        self.shrink = shrink
        self.shrink_budget = shrink_budget
        # forensics flag: probes run with the harness HLC mirror on, and
        # every shrunken witness is pinned WITH its evidence bundle (the
        # violating probe's journal + metrics under invariant_violation)
        self.forensics = bool(forensics)
        # where sim probes run (runner.run_probe's device): never in a spec
        self.device = device
        self.defaults = dict(
            ENGINE_DEFAULTS if harness == "engine" else SIM_DEFAULTS
        )
        if probe_overrides:
            self.defaults.update(probe_overrides)
        self.generator = PlanGenerator(
            seed,
            harness_endpoints(harness, self.defaults),
            self.defaults["horizon_ms"],
            harness,
        )

    def _spec_for(self, plan_json: dict) -> dict:
        spec = {"harness": self.harness, **self.defaults, "plan": plan_json}
        if self.forensics:
            # only stamped when on, so flag-off specs (and the corpus
            # artifacts pinned from them) are byte-identical to before
            spec["forensics"] = True
        return spec

    def run(self) -> HuntReport:
        report = HuntReport(
            seed=self.seed, harness=self.harness, guided=self.guided,
            budget=self.budget,
        )
        rnd = random.Random(self.seed * 9_176 + 1)
        coverage: set = set()
        seen_kinds: set = set()
        for i in range(self.budget):
            if (
                self.guided and report.corpus
                and rnd.random() < MUTATE_P
            ):
                base = report.corpus[rnd.randrange(len(report.corpus))]
                plan_json = self.generator.mutate(base["plan"], i)
            else:
                rnd.random()  # keep the decision stream aligned
                plan_json = self.generator.fresh(i)
            spec = self._spec_for(plan_json)
            result = run_probe(spec, device=self.device)
            report.probes += 1
            fresh_signals = result.coverage - coverage
            coverage |= result.coverage
            if fresh_signals:
                report.corpus.append({
                    "plan": plan_json,
                    "probe": i,
                    "new_signals": len(fresh_signals),
                })
            if result.violations:
                entry = {
                    "probe": i,
                    "spec": spec,
                    "violations": list(result.violations),
                }
                report.violations.append(entry)
                kinds = frozenset(
                    v["invariant"] for v in result.violations
                )
                if self.shrink and not kinds <= seen_kinds:
                    seen_kinds |= kinds
                    shrunk, spent = shrink_spec(
                        spec, target_kinds=kinds,
                        max_probes=self.shrink_budget,
                        device=self.device,
                    )
                    pin = {
                        "kinds": sorted(kinds),
                        "spec": shrunk,
                        "shrink_probes": spent,
                    }
                    if self.forensics:
                        # one confirming replay of the minimized spec pins
                        # the witness WITH its forensic evidence bundle
                        witness = run_probe(shrunk, device=self.device)
                        bundle = witness.info.get("bundle")
                        if bundle is not None:
                            pin["bundle"] = bundle
                    report.pinned.append(pin)
        report.coverage = frozenset(coverage)
        return report


def pin_to_file(pin: dict, path: str, name: str, description: str) -> None:
    """Write one shrunk violation as a corpus artifact (the format
    scenarios/corpus/ files use). A pin carrying a forensic evidence
    bundle (forensics-flagged hunts) additionally writes the bundle as a
    ``.bundle.json`` sidecar next to the artifact, readable by
    ``rapid_tpu_torch.cli.forensics report``."""
    artifact = {
        "name": name,
        "description": description,
        "expect": {"invariants": pin["kinds"]},
        **pin["spec"],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True)
        fh.write("\n")
    bundle = pin.get("bundle")
    if bundle is not None:
        from ..forensics.bundle import write_bundle

        write_bundle(bundle, path + ".bundle.json")
