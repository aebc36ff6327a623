"""route_and_tally.ops_per_round: the device's kernels and copies in the
traced slice that start inside one of the program's ``route_and_tally``
ranges (each round's alert routing, cut detection and vote tally, and its
masking), over the protocol rounds the program executed there, the base of
``device.ops_per_round``."""

import bisect


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0:
        return None
    ranges = sorted((s, e) for name, s, e in tr.annotations if name == "route_and_tally")
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    inside = 0
    for _, s, _ in tr.ops:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and s <= ranges[i][1]
    return inside / tr.rounds
