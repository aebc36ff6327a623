"""join_arm_ms.per_wave: the program's ``join_arm`` spans in the window
(``Simulator._arm_pending_joins``: the observers' fetch, each joiner's
expected observers, the ring re-sort, the write-back), total ms over the
window's decided restart waves."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "join_arm")
    waves = sum(1 for e in run.episodes if e.kind == "wave" and e.decided)
    return ms / waves if waves and ms > 0 else None
