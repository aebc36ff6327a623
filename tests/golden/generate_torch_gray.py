"""Generate tests/golden/torch_gray.json -- what the JAX package gives for
the bench's gray-detection dimension (``bench.run_gray_detection_dimension``:
64 members, a slow node gray for good or flapping, static against adaptive
detection), which the port's own fault plane must reproduce exactly on the
CPU (``tests/test_torch_fault_replay.py``) and on the card (``chip_smoke.py``,
whose machine has no JAX).

The step is ``chip_smoke.py``'s ``gray_dimension_run``, run here on
``rapid_tpu``'s fault plane and classes; the generator first checks that
its constants are the bench's and that it gives the bench's numbers.

Run from the repo root: JAX_PLATFORMS=cpu python tests/golden/generate_torch_gray.py

Regenerate only after a deliberate change of the JAX package's simulator or
fault plane.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from rapid_tpu import faults  # noqa: E402
from rapid_tpu.sim.driver import Simulator  # noqa: E402
from rapid_tpu.sim.engine import SimConfig  # noqa: E402
from rapid_tpu.sim.topology import LatencyTopology  # noqa: E402


def jax_run() -> dict:
    return chip_smoke.gray_dimension_run(faults, Simulator, SimConfig, LatencyTopology)


def check_against_bench(run: dict) -> None:
    """The step is the bench's: its constants and its numbers."""
    for name in ("GRAY_N_NODES", "GRAY_DELAY_MS", "GRAY_CONFIRM", "GRAY_WARMUP",
                 "GRAY_WINDOWS"):
        assert getattr(chip_smoke, name) == getattr(bench, name), name
    entry = bench.run_gray_detection_dimension(chip_smoke.SEED)
    for scenario in chip_smoke.GRAY_WINDOWS:
        assert entry[scenario] == {
            "static_ms": run[scenario]["static"]["detect_ms"],
            "adaptive_ms": run[scenario]["adaptive"]["detect_ms"],
            "speedup": run[scenario]["speedup"],
        }, scenario


def main() -> None:
    run = json.loads(json.dumps(jax_run()))
    check_against_bench(run)
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_gray.py with rapid_tpu's "
            "fault plane and Simulator on the CPU (chip_smoke.py's gray_dimension_run, "
            "checked against bench.run_gray_detection_dimension); the port must give "
            "every value exactly"
        ),
        "run": run,
    }
    with open(os.path.join(HERE, "torch_gray.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
