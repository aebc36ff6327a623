"""Generate tests/golden/torch_planes.json -- what the JAX package gives for
three runs of the driver's host planes at the bench's sizes, which the port
must reproduce exactly on the CPU (``tests/test_torch_planes_golden.py``)
and on the card (``chip_smoke.py``, whose machine has no JAX):

- the bench's serving dimension as written (64 members, 256 partitions,
  placement, handoff, serving and the SLO plane, open-loop traffic through
  a crash): every window's statuses and latencies, the acked set, the
  placement versions, the handoff counters, the SLO summary;
- the bench sweep's 10 000-member placement point (1024 partitions,
  handoff on, 1% crashed): the record, the placement versions, the moved
  partitions, the handoff counters;
- scenarios.py's hierarchy-zone-churn at its defaults (8 zones x 256): the
  records, the composed rows, the parent rounds, the global fingerprints.

The steps are ``chip_smoke.py``'s (``serving_dimension_run``,
``zone_churn_run``), run here on ``rapid_tpu``'s classes, and the sweep
point's digest (``sweep_point_digest``) of ``bench.warmed_run``'s own timed
simulator, whose port side runs through the port's ``warmed_run``; the
generator first checks that the steps give what ``bench.py`` and
``scenarios.py`` give for the same runs.

Run from the repo root: JAX_PLATFORMS=cpu python tests/golden/generate_torch_planes.py

Regenerate only after a deliberate change of the JAX package's planes.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import rapid_tpu.sim.driver as jax_driver  # noqa: E402
import scenarios  # noqa: E402
from rapid_tpu.hierarchy.parent import cell_leaders  # noqa: E402
from rapid_tpu.settings import SLOSettings  # noqa: E402
from rapid_tpu.sim.driver import Simulator  # noqa: E402
from rapid_tpu.sim.engine import SimConfig  # noqa: E402
from rapid_tpu.sim.topology import LatencyTopology  # noqa: E402
from rapid_tpu.slo import OpenLoopGenerator  # noqa: E402
from rapid_tpu.types import Endpoint  # noqa: E402


def jax_sweep_point(n=chip_smoke.SWEEP_N, partitions=chip_smoke.SWEEP_PARTITIONS,
                    seed=chip_smoke.SEED) -> dict:
    """``bench.warmed_run``'s placement point, placement and handoff at
    ``partitions``: the digest of the timed simulator it made (its second),
    recorded through a ``Simulator`` subclass; the port's side is
    ``chip_smoke.sweep_point_run``."""
    made = []

    class Recorded(Simulator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    jax_driver.Simulator = Recorded
    try:
        _, record, _, _ = bench.warmed_run(n, seed=seed, placement_partitions=partitions,
                                           handoff_partitions=partitions)
    finally:
        jax_driver.Simulator = Simulator
    return chip_smoke.sweep_point_digest(made[-1], record)


def jax_runs() -> dict:
    return {
        "serving_dimension": chip_smoke.serving_dimension_run(
            Simulator, SLOSettings, OpenLoopGenerator),
        "sweep_point": jax_sweep_point(),
        "zone_churn": chip_smoke.zone_churn_run(
            Simulator, SimConfig, LatencyTopology, Endpoint, cell_leaders,
            **chip_smoke.ZONE_CHURN),
    }


def check_against_harness(runs: dict) -> None:
    """The steps are the harness's: the same results as bench.py's and
    scenarios.py's own runs."""
    entry = bench.run_serving_dimension(chip_smoke.SEED)
    serving = runs["serving_dimension"]
    assert entry["virtual_ms"] == serving["virtual_ms"]
    assert json.loads(json.dumps(entry["slo"])) == json.loads(json.dumps(serving["slo"]))
    for name, _ops in chip_smoke.SERVING_OPS:
        assert entry[name]["p99_ms"] == bench._latency_window(
            serving["windows"][name]["latencies_ms"])["p99_ms"]
    churn = scenarios.scenario_hierarchy_zone_churn(**chip_smoke.ZONE_CHURN)
    mine = runs["zone_churn"]
    assert churn["hierarchy"]["global_fingerprint"] == mine["global_fingerprints"][-1]
    assert churn["hierarchy"]["parent_rounds"] == mine["parent_rounds"]
    assert {int(k): v for k, v in churn["hierarchy"]["cells"].items()} == {
        int(k): v for k, v in mine["cells"].items()}
    assert churn["virtual_ms"] == mine["records"][-1]["virtual_time_ms"]


def main() -> None:
    runs = json.loads(json.dumps(jax_runs()))
    check_against_harness(runs)
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_planes.py with rapid_tpu's "
            "Simulator on the CPU (chip_smoke.py's steps, checked against bench.py "
            "and scenarios.py); the port must give every value exactly"
        ),
        "runs": runs,
    }
    with open(os.path.join(HERE, "torch_planes.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
