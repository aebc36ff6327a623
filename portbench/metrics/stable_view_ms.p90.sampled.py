"""stable_view_ms.p90.sampled: in the 1M lossy cell, where a window holds
fewer than a hundred failure episodes (so fewer than ten beyond its 90th
percentile), the 90th percentile, over the window's failure
episodes, of the host-clock time from the fault's injection to the
installed view that holds none of the burst, synchronized."""

from portbench.harness import p90


def read(run):
    return p90(run.failures_ms())
