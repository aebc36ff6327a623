"""ring_order_ms.per_wave: the program's ``ring_order`` spans in the window
(inside ``join_arm``: ``full_ring_order`` and each ring's active members,
once a configuration that arms joins), total ms over the window's decided
restart waves."""


def read(run):
    ms = sum(m for name, m in run.spans if name == "ring_order")
    waves = sum(1 for e in run.episodes if e.kind == "wave" and e.decided)
    return ms / waves if waves and ms > 0 else None
