"""dispatch_ms.per_round: the program's ``device_rounds`` spans in the
window (a dispatch's enqueue and its fetch of the decision words), total ms
over the increase of its ``rounds`` counter, the rounds it executed."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "device_rounds")
    rounds = run.counters.get("rounds", 0)
    return ms / rounds if rounds > 0 and ms > 0 else None
