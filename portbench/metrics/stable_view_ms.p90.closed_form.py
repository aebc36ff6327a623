"""stable_view_ms.p90.closed_form: in a crash cell, where the closed form
decides and the host alone paces the tail, the 90th percentile, over the window's failure
episodes, of the host-clock time from the fault's injection to the
installed view that holds none of the burst, synchronized."""

from portbench.harness import p90


def read(run):
    return p90(run.failures_ms())
