"""Reproduces BASELINE.md's 'Timing-induced consensus conflicts' table on
the port; the counterpart of ``experiments/fig11_conflict_sweep.py``.

Grid: N=64, rounds_per_interval=10 (100 ms sub-rounds), two delivery
classes split even/odd, two crashed victims; class 1 hears victim A's
observers' alerts ``skew`` sub-rounds late (latency only -- nothing is
dropped). 18 trials per skew: seeds 0-5 x victim pairs {5,40}, {11,52},
{3,20}. A trial conflicts when the two classes announce unequal proposals;
every conflict is then driven through the classic fallback to convergence.

``run_trial`` is the single definition of the regime on the port; the
twins of ``tests/test_timing_conflicts.py`` run it beside the JAX
package's.

Run: python -m rapid_tpu_torch.experiments.fig11_conflict_sweep        (on the card)
     python -m rapid_tpu_torch.experiments.fig11_conflict_sweep --skews 0,9
     python -m rapid_tpu_torch.experiments.fig11_conflict_sweep --device cpu
"""

import argparse

import numpy as np

SEEDS = range(6)
VICTIM_PAIRS = ([5, 40], [11, 52], [3, 20])
SKEWS = (0, 2, 5, 9)
N = 64


def run_trial(seed, victims, skew, n=N, rpi=10, fallback=None, device=None):
    """One scenario: two victims crash; delivery class 1 hears victim A's
    observers ``skew`` sub-rounds late. Returns (conflict, record, sim)."""
    from ..sim.driver import Simulator
    from ..sim.engine import SimConfig

    config = SimConfig(
        capacity=n, rounds_per_interval=rpi, groups=2,
        max_delivery_delay=max(skew, 1),
    )
    sim = Simulator(n, config=config, seed=seed, device=device)
    sim.set_delivery_groups((np.arange(n) % 2).astype(np.int32))
    victims = np.array(victims)
    sim.crash(victims)
    if skew:
        obs_a = sim.state.observers[int(victims[0])].cpu().numpy()
        sim.delay_broadcasts(1, obs_a, skew)
    rec = sim.run_until_decision(
        max_rounds=200, batch=40, classic_fallback_after_rounds=fallback
    )
    conflict = False
    if sim.last_announcement is not None:
        announced, proposals = sim.last_announcement
        conflict = bool(
            announced[:2].all()
            and not np.array_equal(proposals[0], proposals[1])
        )
    return conflict, rec, sim


def drive_to_convergence(sim, n_final, max_view_changes=3):
    """Classic-fallback recovery until membership is exactly ``n_final``;
    bounded so a protocol anomaly fails loudly instead of hanging."""
    for _ in range(max_view_changes):
        if sim.membership_size == n_final:
            return
        follow = sim.run_until_decision(
            max_rounds=300, batch=50, classic_fallback_after_rounds=20
        )
        assert follow is not None, "fallback failed to converge"
    assert sim.membership_size == n_final, (
        f"membership {sim.membership_size} != {n_final} after "
        f"{max_view_changes} view changes"
    )


def sweep_row(skew, device=None):
    """One skew's 18 trials, each driven to convergence: (conflicts,
    stalls, trials)."""
    conflicts = stalls = trials = 0
    for seed in SEEDS:
        for victims in VICTIM_PAIRS:
            conflict, rec, sim = run_trial(seed, victims, skew, device=device)
            trials += 1
            conflicts += conflict
            stalls += rec is None
            drive_to_convergence(sim, N - len(victims))
            assert not sim.active[np.array(victims)].any()
    return conflicts, stalls, trials


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--skews", default=",".join(str(s) for s in SKEWS),
                        help="comma-separated latency skews (sub-rounds)")
    parser.add_argument("--device", default=None,
                        help="where the simulators run (default: the CUDA "
                             "device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    skews = tuple(int(s) for s in args.skews.split(","))
    print(f"| latency skew (sub-rounds) | {' | '.join(map(str, skews))} |")
    rows = {"conflict rate": [], "fast round stalled": []}
    for skew in skews:
        conflicts, stalls, trials = sweep_row(skew, args.device)
        rows["conflict rate"].append(f"{conflicts}/{trials}")
        rows["fast round stalled"].append(f"{stalls}/{trials}")
        print(f"skew {skew}: conflicts {conflicts}/{trials}, "
              f"stalls {stalls}/{trials}, all converged")
    for name, cells in rows.items():
        print(f"| {name} | {' | '.join(cells)} |")


if __name__ == "__main__":
    main()
