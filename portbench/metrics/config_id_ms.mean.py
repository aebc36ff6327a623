"""config_id_ms.mean: the program's ``config_id`` spans in the window
(inside ``view_change``: the configuration id's fold over the identifier
history and ring 0), total ms over their count."""


def read(run):
    ms = [m for name, m in run.spans if name == "config_id"]
    return sum(ms) / len(ms) if ms else None
