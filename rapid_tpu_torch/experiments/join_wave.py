"""Join-wave (bootstrap/elasticity) sweep on the port: time-to-stable-view
for a burst of joiners entering an established cluster, across the scale
axis; the counterpart of ``experiments/join_wave.py``.

The paper's bootstrap headline (Fig. 5: N=2000 bootstraps 2-5.8x faster
than ZooKeeper/Memberlist because joins batch into few view changes) has
this analogue here: a wave of W joiners lands in one configuration, their
UP alerts aggregate through the same H/L cut detection as failures, and the
whole wave is admitted in a single fast-round decision (join is a cut of
adds -- MembershipService.java:229-286; the sim plane arms join reports for
every pending joiner each configuration).

One warm-up run per capacity, then a fresh same-shape simulator is timed
from wave arrival to the decided view that admits every joiner.

Run: python -m rapid_tpu_torch.experiments.join_wave            (on the card)
     python -m rapid_tpu_torch.experiments.join_wave --sizes 1000,10000 --wave 100
     python -m rapid_tpu_torch.experiments.join_wave --device cpu

Prints one JSON line per size:
  {"n", "wave", "warmed_wall_ms", "virtual_ms", "admitted_ok"}
"""

import argparse
import json
import time

import numpy as np

DEFAULT_SIZES = (1_000, 10_000, 100_000)
DEFAULT_WAVE = 0.01  # joiners as a fraction of N


def timed_wave(n: int, wave: int, seed: int, device=None):
    """(wall_ms, record) for a W-joiner wave into an N-member cluster."""
    from ..sim.driver import Simulator

    sim = Simulator(n, capacity=n + wave, seed=seed, device=device)
    sim.ready()
    joiners = np.arange(n, n + wave)
    sim.request_joins(joiners)
    t0 = time.perf_counter()
    record = sim.run_until_decision(max_rounds=16, batch=16)
    wall_ms = (time.perf_counter() - t0) * 1000.0
    assert record is not None, "wave not admitted in budget"
    assert set(record.added) == set(int(j) for j in joiners), "partial admission"
    assert record.membership_size == n + wave
    return wall_ms, record


def run_size(n: int, wave_frac_or_count, seed: int, device=None) -> dict:
    wave = (
        int(wave_frac_or_count)
        if wave_frac_or_count >= 1
        else max(1, int(n * wave_frac_or_count))
    )
    # warm the process on an identical-shape run, then measure fresh
    timed_wave(n, wave, seed, device)
    wall_ms, record = timed_wave(n, wave, seed + 4444, device)
    return {
        "n": n,
        "wave": wave,
        "warmed_wall_ms": round(wall_ms, 1),
        "virtual_ms": record.virtual_time_ms,
        "admitted_ok": True,  # asserted in timed_wave
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--sizes", default=",".join(str(s) for s in DEFAULT_SIZES),
        help="comma-separated cluster sizes",
    )
    parser.add_argument(
        "--wave", type=float, default=DEFAULT_WAVE,
        help="joiner count (>=1) or fraction of N (<1)",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default=None,
                        help="where the simulators run (default: the CUDA "
                             "device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    for n in (int(s) for s in args.sizes.split(",")):
        print(json.dumps(run_size(n, args.wave, args.seed, args.device)), flush=True)


if __name__ == "__main__":
    main()
