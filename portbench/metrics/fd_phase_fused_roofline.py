"""fd_phase_fused_roofline: the FD phase's compulsory bytes at the card's
3.35 TB/s over the device time of the kernels inside the trace's
``fd_phase_fused`` ranges, in %.

The bytes are frozen here from the kernel's contract at the cell's shape
[C, K] with random loss on and the cumulative counter: per edge the
subjects (4 B), probe_drop, alerted and down_reports in (1 B each), alerted
and down_arrivals out (1 B each), fd_fail in and out (2 B); per node active,
alive in and out (3 B) and drop_prob (4 B); the key in and out and the halt
flag (33 B) and the round counter (4 B). A round in which an edge raises an
alert must also read the observers (4 B an edge); that is not counted, so
the share is a lower bound."""

PEAK_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, HBM3


def compulsory_bytes(c: int, k: int) -> int:
    return c * k * 11 + c * 7 + 33 + 4


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches, us = tr.inside("fd_phase_fused")
    if launches == 0 or us <= 0:
        return None
    c = int(run.cell.config["capacity"])
    k = int(run.cell.config["k"])
    bound_s = launches * compulsory_bytes(c, k) / PEAK_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6)
