"""device.idle_share: in the traced slice, one less the device's busy time
(the union of its kernels and copies) over the slice's wall, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
