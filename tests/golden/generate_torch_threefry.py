"""Generate tests/golden/torch_threefry.json -- what the JAX package draws for
the port's random-loss kernel ``threefry_draw`` to reproduce, on the CPU
(``tests/test_torch_threefry.py``) and on the card (``chip_smoke.py``,
whose machine has no JAX):

- ``vectors``: for each case of ``chip_smoke.threefry_cases()`` (seeds 0, 3,
  7, 42 and 2**31 - 1 at shapes (1, 1), (37, 10) and (1000, 10), each without
  and with ``fold_in`` of shard 3; then the main path's draws from
  ``PRNGKey(42)``: [100 000, 10], [1 000 000, 10] and the 8 shards of a 100k
  mesh), ``split(PRNGKey(seed))``'s new key and the uniform draw of its
  probe key (folded with each shard's index where the case has shards),
  as ``chip_smoke.threefry_vector`` keeps them;
- ``decision``: ``chip_smoke.threefry_decision`` on the JAX package's
  Simulator: 10 000 members, seed 3, 1% of them at ingress loss 0.5,
  ``run_until_decision(64, 16)``: the cut, configuration id, virtual time
  and rounds.

Run from the repo root: JAX_PLATFORMS=cpu python tests/golden/generate_torch_threefry.py
(a few seconds). Regenerate only after a deliberate change of the JAX
package's simulation plane, or of JAX's threefry (a JAX upgrade).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def jax_draw(seed, rows, k, shards):
    """``split(PRNGKey(seed))``'s new key and the round's draw from its probe
    key: ``uniform(probe, (rows, k))``, or each shard's block from
    ``fold_in(probe, shard)``, stacked in the order given."""
    key, probe = jax.random.split(jax.random.PRNGKey(seed))
    if shards is None:
        draw = jax.random.uniform(probe, (rows, k))
    else:
        draw = jnp.concatenate([jax.random.uniform(jax.random.fold_in(probe, s), (rows, k))
                                for s in shards])
    return np.asarray(key), np.asarray(draw)


def jax_vectors():
    return [chip_smoke.threefry_vector(*jax_draw(*case)) for case in chip_smoke.threefry_cases()]


def jax_decision():
    from rapid_tpu.sim.driver import Simulator

    return chip_smoke.threefry_decision(Simulator)


def main() -> None:
    assert jax.config.jax_threefry_partitionable, "the port implements the partitionable mode"
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_threefry.py with jax.random (threefry, "
            f"jax {jax.__version__}, jax_threefry_partitionable on, 32-bit integers) and "
            "rapid_tpu's Simulator on the CPU; the port must give every value exactly"
        ),
        "vectors": jax_vectors(),
        "decision": jax_decision(),
    }
    with open(os.path.join(HERE, "torch_threefry.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
