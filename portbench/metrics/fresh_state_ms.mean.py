"""fresh_state_ms.mean: the program's ``fresh_state`` spans in the window
(inside ``view_change``: the ring rank's upload and the new configuration's
state on the device), total ms over their count."""


def read(run):
    ms = [m for name, m in run.spans if name == "fresh_state"]
    return sum(ms) / len(ms) if ms else None
