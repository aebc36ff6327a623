"""dispatch_inputs_ms.per_round: the program's ``dispatch_inputs`` spans in
the window (each dispatch's fault-plane inputs and their uploads, before
``device_rounds``), total ms over the increase of its ``rounds`` counter."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "dispatch_inputs")
    rounds = run.counters.get("rounds", 0)
    return ms / rounds if rounds > 0 and ms > 0 else None
