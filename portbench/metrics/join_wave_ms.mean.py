"""join_wave_ms.mean: the mean, over the window's restart waves, of the
host-clock time from the first re-seat to the installed view that admits
the last joiner, synchronized: the join path (``assign_identity``,
``request_joins``, the arming of the joins and the ring re-sort in
``run_until_decision``, the join's view change)."""


def read(run):
    waves = [e.ms for e in run.episodes if e.kind == "wave" and e.decided]
    return sum(waves) / len(waves) if waves else None
