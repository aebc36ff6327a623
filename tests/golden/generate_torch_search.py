"""Generate tests/golden/torch_search.json -- what the JAX package gives for
``chip_smoke.py``'s search phase (the nemesis search and the forensics
timeline), which the port must reproduce on the CPU
(``tests/test_torch_search_golden.py``, the ``reduced`` section) and on the
card (``chip_smoke.py``, whose machine has no JAX; the ``full`` section).

The runs are ``chip_smoke.search_sequence`` on ``rapid_tpu``'s modules, with
``tools/forensics.py`` as the forensics CLI (``jax_search_modules`` of
``tests/test_torch_timeline.py``):

- (a) ``Hunter(seed=0, budget=200, harness="engine")``, ``tools/hunt.py``'s
  defaults: the report, the coverage and the transition count;
- (b) the flagged bug (``RAPID_BUG_NEWROW_SYNC=1``): ``Hunter(seed=12,
  budget=120, shrink_budget=150)`` finds it, shrinks it to 3 rules or fewer
  and pins it (the pin and the bytes ``pin_to_file`` writes); the corpus pin
  ``hunt-s11-engine-linearizability-0.json`` replayed with the flag off and on;
- (c) ``Hunter(seed=0, budget=20, harness="sim")`` at ``SIM_DEFAULTS``
  (capacity 5, the search's own size): each probe's spec, verdicts, info,
  coverage count and last configuration id;
- (d) one sim probe at capacity and members 100 000 (the bench headline's
  size): the gray streak on, a restart and an ingress drop at 1.0;
- (e) the timeline (events, findings, Chrome trace, report, CLI exit codes)
  over (b)'s witness sidecar taken with ``forensics=True``, the skewed-churn
  cluster bundle and the stuck-handoff fixtures of ``tests/test_forensics.py``.

``reduced`` is the same with (a) at 30 probes, (c) at 10 and (d) at capacity
5. Host walls are not recorded.

Run from the repo root: JAX_PLATFORMS=cpu python tests/golden/generate_torch_search.py
(about a minute on one CPU core). Regenerate only after a deliberate change of
the JAX package's search, serving or simulation planes.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import chip_smoke  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_timeline import jax_search_modules  # noqa: E402


def jax_run(section: str) -> dict:
    """``section`` ("full" or "reduced") of the file, run on ``rapid_tpu``."""
    P = jax_search_modules()
    assert P.search_hunt.SIM_DEFAULTS["capacity"] == 5
    kw = {} if section == "full" else dict(chip_smoke.SEARCH_REDUCED)
    with tempfile.TemporaryDirectory(prefix="rapid-search-golden-") as root:
        outcome, _walls = chip_smoke.search_sequence(P, root, **kw)
    return outcome


def main() -> None:
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_search.py with rapid_tpu's search "
            "and forensics planes on the CPU (chip_smoke.py's search_sequence: full at the "
            "CLI's and README's budgets and a 100 000-member sim probe, reduced at 30 and "
            "10 probes and capacity 5); the port must give every value exactly"
        ),
        "full": jax_run("full"),
        "reduced": jax_run("reduced"),
    }
    with open(os.path.join(HERE, "torch_search.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
