"""Coverage-guided nemesis search CLI ("Jepsen in a box"), the port's
counterpart of ``tools/hunt.py``: the same flags, output and exit codes,
plus ``--device``.

Drives a budgeted :class:`rapid_tpu_torch.search.hunt.Hunter` run: sample or
mutate FaultPlans, execute each as a probe on the chosen harness, check
invariants (linearizability, view agreement, config parity, fingerprint
agreement), bias generation toward unvisited coverage signals, shrink
the first witness of each violation kind, and print a corpus/coverage
report. Everything is deterministic per --seed.

    python -m rapid_tpu_torch.cli.hunt --budget 200              # engine harness
    python -m rapid_tpu_torch.cli.hunt --harness sim --budget 20 # simulator replay
    python -m rapid_tpu_torch.cli.hunt --unguided                # coverage bias off
    python -m rapid_tpu_torch.cli.hunt --pin scenarios/corpus    # write shrunk plans
    python -m rapid_tpu_torch.cli.hunt --json                    # machine-readable

The ``sim`` harness runs its simulator on the CUDA device unless
``--device`` names another (``--device cpu``), and without a card and
without ``--device`` it raises; the ``engine`` harness is host code. A
pinned plan is the JSON ``tools/hunt.py --pin`` writes, byte for byte (its
description names that tool's equivalent command line), so
``scenarios.py`` replays it as it replays that tool's pins, and the port's
``run_probe`` replays either. Exits 1 when any probe violated an
invariant, else 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="coverage-guided nemesis search over FaultPlans"
    )
    parser.add_argument("--seed", type=int, default=0,
                        help="search seed (same seed -> same hunt)")
    parser.add_argument("--budget", type=int, default=200,
                        help="number of probes to run")
    parser.add_argument("--harness", choices=("engine", "sim"),
                        default="engine",
                        help="engine: real ServingEngines on the virtual-"
                             "time fabric; sim: device-plane replay on the "
                             "Simulator (slower, on the card unless "
                             "--device names another)")
    parser.add_argument("--unguided", action="store_true",
                        help="disable the coverage-bias corpus (baseline "
                             "random search)")
    parser.add_argument("--no-shrink", action="store_true",
                        help="report violations without minimizing them")
    parser.add_argument("--shrink-budget", type=int, default=200,
                        help="probe budget per shrink")
    parser.add_argument("--pin", metavar="DIR",
                        help="write each shrunk violation to DIR as a "
                             "corpus JSON (scenarios.py auto-registers "
                             "scenarios/corpus/*.json)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON instead of text")
    parser.add_argument("--forensics", action="store_true",
                        help="run probes with the HLC forensics mirror and "
                             "pin each shrunk witness WITH its evidence "
                             "bundle (--pin writes a .bundle.json sidecar "
                             "readable by rapid_tpu_torch.cli.forensics "
                             "report)")
    parser.add_argument("--device", default=None,
                        help="where sim probes run (default: the CUDA "
                             "device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    from ..search.hunt import Hunter, pin_to_file

    hunter = Hunter(
        seed=args.seed, budget=args.budget, harness=args.harness,
        guided=not args.unguided, shrink=not args.no_shrink,
        shrink_budget=args.shrink_budget, forensics=args.forensics,
        device=args.device,
    )
    report = hunter.run()

    written = []
    if args.pin:
        pin_dir = Path(args.pin)
        pin_dir.mkdir(parents=True, exist_ok=True)
        for i, pin in enumerate(report.pinned):
            kinds = "-".join(pin["kinds"])
            name = f"hunt-s{args.seed}-{args.harness}-{kinds}-{i}"
            path = pin_dir / f"{name}.json"
            pin_to_file(
                pin, str(path), name,
                f"shrunk by tools/hunt.py --seed {args.seed} "
                f"--budget {args.budget} --harness {args.harness}",
            )
            written.append(str(path))

    if args.json:
        out = report.to_json()
        out["pinned_files"] = written
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(report.report_text())
        for path in written:
            print(f"  wrote {path}")
    return 1 if report.violations else 0


if __name__ == "__main__":
    sys.exit(main())
