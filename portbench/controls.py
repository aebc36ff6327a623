"""The controls of the check: runs that must come out not correct.

A control is the reference put in the program's place, with one thing
changed, and judged by the reference as a run of the program is:

- ``bfloat16``: the loss draw and its probability compared in bfloat16, the
  nearest precision below the float32 the configuration's loss is stated
  in (a lossy mix's control);
- ``no_history``: the configuration id folded over the members' own
  NodeIds, not over every NodeId ever admitted; this breaks the stated
  guarantee that no identifier is reused and the id covers the history
  (any mix's control, the crash mixes' own).

The episode log is the mix's, from the seed, as a run's set-up and window
would draw it: one failure episode and a wave, then ``episodes`` more.

    python3 -m portbench.controls --workload <cell> --seeds 1,2,3 [--episodes N]

prints one JSON line a seed and control with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from . import check, spec
from .generator import Generator
from .harness import ROUND_BUDGET

CONTROLS = {"bfloat16": dict(bfloat16=True), "no_history": dict(seen_all=False)}


def episode_log(traffic: dict, members: int, seed: int, episodes: int) -> List:
    gen = Generator(traffic, members, seed)
    log = [gen.failure(), gen.wave()]
    log += [gen.next() for _ in range(episodes)]
    return log


def run_controls(config: dict, traffic: dict, seed: int, episodes: int,
                 controls: List[str]) -> Dict[str, check.Numbers]:
    """Each control's numbers against one replay of the reference."""
    members = int(config["members"])
    answers = check.Answers(records=[], join_observers={},
                            log=episode_log(traffic, members, seed, episodes),
                            seed=seed, capacity=int(config["capacity"]))
    want = check.replay(config, traffic, answers, ROUND_BUDGET)
    out = {}
    for control in controls:
        got = check.replay(config, traffic, answers, ROUND_BUDGET, **CONTROLS[control])
        out[control] = check.judge(got.changes, want.changes, got.join_observers,
                                   want.join_observers, want.unfinished)
    return out


def run_control(config: dict, traffic: dict, seed: int, episodes: int,
                control: str) -> check.Numbers:
    return run_controls(config, traffic, seed, episodes, [control])[control]


def fails(numbers: check.Numbers) -> bool:
    return any(v > limit for v, limit in numbers.values())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="run the check's controls")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--episodes", type=int, default=100)
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    ok = True
    # a crash mix draws no loss, so the precision control has nothing to change there
    names = list(CONTROLS) if cell.traffic["fault"] == "ingress_loss" else ["no_history"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        results = run_controls(cell.config, cell.traffic, seed, args.episodes, names)
        for control, numbers in results.items():
            row: Dict = {"workload": args.workload, "seed": seed, "control": control,
                         "episodes": args.episodes, "fails": fails(numbers),
                         "seconds": time.perf_counter() - t0,
                         "checks": {k: {"value": v, "limit": l} for k, (v, l) in numbers.items()}}
            ok &= row["fails"]
            print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
