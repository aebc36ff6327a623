"""Generate tests/golden/torch_live_planes.json -- what the JAX package gives
for ``chip_smoke.py``'s live-planes phase (real members' durable stores,
handoff, serving and hierarchy planes), which the port must reproduce
exactly on the CPU (``tests/test_torch_live_planes.py``, the ``reduced``
section) and on the card (``chip_smoke.py``, whose machine has no JAX; the
``full`` section).

The runs are ``chip_smoke.live_planes_sequence`` on ``rapid_tpu``'s modules:
``full`` at the bench's serving size (64 members, placement 256 x 3, the
serving traffic of ``bench.py``; 8 hierarchy cells; the recovery points of
``bench.run_recovery_dimension``), ``reduced`` at 8 members, 2 cells and a
fifth of the traffic. The generator first checks that the phase's
constants are the bench's. Host walls are not recorded.

Run from the repo root: JAX_PLATFORMS=cpu python tests/golden/generate_torch_live_planes.py
(a few minutes on one CPU core). Regenerate only after a deliberate change of
the JAX package's protocol plane.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def check_against_bench() -> None:
    """The phase's sizes are the bench's serving, hierarchy and recovery
    dimensions'."""
    for name in ("SERVING_N_NODES", "SERVING_PARTITIONS", "SERVING_KEYS", "SERVING_PUT_FRACTION",
                 "SERVING_RATE_PER_S", "SERVING_ZIPF_S", "SERVING_CLIENTS", "HIER_CELLS",
                 "RECOVERY_LOG_RECORDS", "RECOVERY_SNAPSHOT_EVERY", "RECOVERY_PARTITIONS",
                 "RECOVERY_VALUE_BYTES"):
        assert getattr(chip_smoke, name) == getattr(bench, name), name
    assert dict(chip_smoke.SERVING_OPS) == bench.SERVING_OPS


def jax_run(section: str) -> dict:
    """``section`` ("full" or "reduced") of the file, run on ``rapid_tpu``."""
    P = chip_smoke.live_modules("rapid_tpu")
    kw = {} if section == "full" else dict(chip_smoke.LIVE_REDUCED)
    with tempfile.TemporaryDirectory(prefix="rapid-live-golden-") as root:
        outcome, _walls = chip_smoke.live_planes_sequence(P, root, **kw)
    return json.loads(json.dumps(outcome))


def main() -> None:
    check_against_bench()
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_live_planes.py with rapid_tpu's "
            "protocol plane on the CPU (chip_smoke.py's live_planes_sequence: full at the "
            "bench's serving size, reduced at 8 members); the port must give every value "
            "exactly"
        ),
        "full": jax_run("full"),
        "reduced": jax_run("reduced"),
    }
    with open(os.path.join(HERE, "torch_live_planes.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
