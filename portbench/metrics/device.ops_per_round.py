"""device.ops_per_round: the device's kernels and copies in the traced
slice (the ranges the program names around its kernels counted apart) over
the protocol rounds the program executed there."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.rounds <= 0:
        return None
    return len(tr.ops) / tr.rounds
