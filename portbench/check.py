"""What decides ``correct``: every view change the program made, held
against the reference's replay of the same episodes.

The reference (``reference/``, plain NumPy, nothing of the program) makes
the cluster's identities and rings from the run's seed, replays the episode
log from the first configuration, and works out each view change: its cut,
the round it is decided in (so its virtual time), the membership's size and
configuration id, and each joiner's expected observers. Every comparison is
exact, so every limit is 0: a count of view changes that differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .reference.cluster import Cluster
from .reference.protocol import Protocol, Replay

# name -> (value, limit)
Numbers = Dict[str, Tuple[int, int]]


@dataclass
class Answers:
    """The program's answers: its view changes, and the observers it gave
    each joiner, beside the episodes that made them."""

    records: List  # the program's ViewChangeRecord list, in order
    join_observers: Dict[Tuple[int, int], List[int]]  # (wave, slot) -> observers
    log: List  # generator.Episode, in order
    seed: int
    capacity: int


def protocol(config: dict) -> Protocol:
    return Protocol(k=config["k"], h=config["h"], l=config["l"],
                    fd_threshold=config["fd_threshold"],
                    fd_interval_ms=config["fd_interval_ms"],
                    batching_window_ms=config["batching_window_ms"])


def replay(config: dict, traffic: dict, answers: Answers, round_budget: int,
           bfloat16: bool = False, seen_all: bool = True) -> Replay:
    """The reference's run of the answers' episode log. ``bfloat16`` and
    ``seen_all`` false make the controls."""
    cluster = Cluster(answers.capacity, config["k"], answers.seed)
    rep = Replay(cluster, protocol(config), answers.seed, round_budget,
                 bfloat16=bfloat16, seen_all=seen_all)
    loss = float(traffic.get("loss", 1.0))
    for ep in answers.log:
        if ep.kind == "failure":
            rep.failure(traffic["fault"], ep.slots, loss)
        else:
            rep.wave(ep.number, ep.slots, ep.ids)
    return rep


def judge(got: List, want: List, got_obs: Dict, want_obs: Dict, unfinished: int) -> Numbers:
    """Count the view changes (and joiners) on which ``got`` departs from
    ``want``. Each entry of ``got`` and ``want`` has ``cut``,
    ``configuration_id``, ``membership_size`` and ``virtual_time_ms``."""
    n = min(len(got), len(want))
    cut = sum(not np.array_equal(np.sort(np.asarray(got[i].cut)), want[i].cut) for i in range(n))
    cid = sum(int(got[i].configuration_id) != want[i].configuration_id for i in range(n))
    size = sum(int(got[i].membership_size) != want[i].membership_size for i in range(n))
    vms = sum(int(got[i].virtual_time_ms) != want[i].virtual_time_ms for i in range(n))
    obs = sum(got_obs.get(key) != want for key, want in want_obs.items())
    obs += len(set(got_obs) - set(want_obs))
    return {
        "view_change_count_diff": (abs(len(got) - len(want)), 0),
        "cut_mismatch": (cut, 0),
        "config_id_mismatch": (cid, 0),
        "size_mismatch": (size, 0),
        "virtual_ms_mismatch": (vms, 0),
        "join_observer_mismatch": (obs, 0),
        "reference_undecided": (unfinished, 0),
    }


def compare(cell, answers: Answers, round_budget: int) -> Numbers:
    rep = replay(cell.config, cell.traffic, answers, round_budget)
    return judge(answers.records, rep.changes, answers.join_observers,
                 rep.join_observers, rep.unfinished)
