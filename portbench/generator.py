"""The one traffic generator: failure episodes and restart waves, read from
a mix's data file (``traffic/<name>.json``) and drawn from the run's seed.

A mix's parameters:

- ``fault``: ``crash`` (crash-stop) or ``ingress_loss`` (random loss of the
  probes to a member, with probability ``loss``);
- ``burst_fraction``: the share of the members a failure episode hits at
  once (at least one member);
- ``wave_every``: failure episodes between two restart waves.

The generator keeps its own books: the slots that failed and wait for a
restart. A failure episode draws ``burst`` distinct slots uniformly among
the others; a restart wave gives every waiting slot a fresh NodeId (two
signed 64-bit words, distinct from every one the generator drew), in slot
order, and empties the books. The victims and identities depend on the seed
alone, never on what the program did.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np


@dataclass
class Episode:
    kind: str  # "failure" or "wave"
    slots: np.ndarray  # victims, or the slots that restart
    ids: Optional[np.ndarray] = None  # [n, 2] int64 NodeIds of a wave
    number: int = 0  # a wave's ordinal


class Generator:
    def __init__(self, params: dict, members: int, seed: int) -> None:
        self.fault = params["fault"]
        if self.fault not in ("crash", "ingress_loss"):
            raise ValueError(f"unknown fault {self.fault!r}")
        self.loss = float(params.get("loss", 1.0))
        self.burst = max(1, int(round(members * float(params["burst_fraction"]))))
        self.wave_every = int(params["wave_every"])
        self.members = members
        self.rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 0x7A11C]))
        self.waiting: List[int] = []
        self._waiting_set: Set[int] = set()
        self._ids: Set[Tuple[int, int]] = set()
        self.failures_since_wave = 0
        self.waves = 0

    @property
    def band(self) -> Tuple[int, int]:
        """The membership's lowest and highest size under this mix."""
        return self.members - self.burst * self.wave_every, self.members

    def wave_due(self) -> bool:
        return self.failures_since_wave >= self.wave_every

    def failure(self) -> Episode:
        victims: List[int] = []
        chosen: Set[int] = set()
        while len(victims) < self.burst:
            for slot in self.rng.integers(0, self.members, size=2 * self.burst):
                slot = int(slot)
                if slot in chosen or slot in self._waiting_set:
                    continue
                chosen.add(slot)
                victims.append(slot)
                if len(victims) == self.burst:
                    break
        self.waiting.extend(victims)
        self._waiting_set.update(victims)
        self.failures_since_wave += 1
        return Episode("failure", np.array(victims, dtype=np.int64))

    def wave(self) -> Episode:
        slots = np.array(sorted(self.waiting), dtype=np.int64)
        ids = np.empty((len(slots), 2), dtype=np.int64)
        for i in range(len(slots)):
            while True:
                pair = self.rng.integers(-(2**63), 2**63, size=2, dtype=np.int64)
                key = (int(pair[0]), int(pair[1]))
                if key not in self._ids:
                    self._ids.add(key)
                    ids[i] = pair
                    break
        self.waiting, self._waiting_set = [], set()
        self.failures_since_wave = 0
        self.waves += 1
        return Episode("wave", slots, ids, self.waves)

    def next(self) -> Episode:
        return self.wave() if self.wave_due() else self.failure()
