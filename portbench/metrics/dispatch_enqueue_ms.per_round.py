"""dispatch_enqueue_ms.per_round: the program's ``dispatch_enqueue`` spans
in the window (inside ``device_rounds``: the host's enqueue of a dispatch's
rounds and of ``pack_decision``), total ms over the increase of its
``rounds`` counter."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "dispatch_enqueue")
    rounds = run.counters.get("rounds", 0)
    return ms / rounds if rounds > 0 and ms > 0 else None
