"""decision_wait_ms.per_round: the program's ``decision_fetch`` spans in
the window (inside ``device_rounds``: the one fetch of a dispatch's
decision words, which waits for the device), total ms over the increase of
its ``rounds`` counter."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "decision_fetch")
    rounds = run.counters.get("rounds", 0)
    return ms / rounds if rounds > 0 and ms > 0 else None
