"""view_changes_per_s: every view change the program decided in the window,
failure episodes and restart waves alike, over the window's whole wall
time. Host clock."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(e.view_changes for e in run.episodes) / run.window_s
