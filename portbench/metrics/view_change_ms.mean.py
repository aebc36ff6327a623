"""view_change_ms.mean: the program's ``view_change`` spans in the window
(``Simulator._apply_view_change``: the id fold, the fresh state), total
ms over their count. Host clock, the program's own span."""


def read(run):
    ms = [m for name, m in run.spans if name == "view_change"]
    return sum(ms) / len(ms) if ms else None
