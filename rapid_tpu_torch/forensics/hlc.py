"""Hybrid logical clocks (Kulkarni et al., "Logical Physical Clocks").

The port's copy of the clock of ``rapid_tpu/forensics/hlc.py`` (``HlcStamp``,
``HlcClock``, and the message sidecar ``stamp_hlc``/``hlc_of`` that the wire
codec reads and writes under the frame's reserved ``__hlc`` key). The
simulator stamps its flight recorder with an ``HlcClock`` on its virtual
clock when ``SimConfig.forensics`` is set, so a simulated journal merges
causally with real members' journals.

An HLC stamp is a ``(physical_ms, logical)`` pair: the physical half tracks
the node's own clock, the logical half breaks ties and absorbs skew. The
update rules guarantee that if event *a* happened-before event *b* (same
node, or a message from *a*'s node received before *b*), then
``stamp(a) < stamp(b)`` -- even when the receiving node's wall clock runs
*behind* the sender's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class HlcStamp:
    """One hybrid-logical-clock reading. Totally ordered as the pair
    ``(physical_ms, logical)``; ``incarnation`` disambiguates a restarted
    node whose physical clock regressed below its pre-crash stamps (compare
    incarnation first when ordering events of ONE node, but never across
    nodes)."""

    physical_ms: int
    logical: int
    incarnation: int = 1

    def pair(self) -> Tuple[int, int]:
        return (int(self.physical_ms), int(self.logical))

    def to_wire(self) -> list:
        # list, not tuple: msgpack round-trips lists
        return [int(self.physical_ms), int(self.logical), int(self.incarnation)]

    @classmethod
    def from_wire(cls, raw: object) -> Optional["HlcStamp"]:
        """None on anything malformed -- a bad stamp from a hostile or
        half-upgraded peer must never take the receive path down."""
        if not isinstance(raw, (list, tuple)) or len(raw) < 2:
            return None
        try:
            physical = int(raw[0])
            logical = int(raw[1])
            incarnation = int(raw[2]) if len(raw) > 2 else 1
        except (TypeError, ValueError):
            return None
        if physical < 0 or logical < 0 or incarnation < 1:
            return None
        return cls(physical, logical, incarnation)


class HlcClock:
    """The per-node clock: ``now()`` for send/local events, ``merge()`` on
    receive. Thread-safe; tolerant of a dying physical clock (falls back to
    the last known physical time, logical half keeps events ordered)."""

    def __init__(self, clock: Optional[Callable[[], int]] = None,
                 incarnation: int = 1) -> None:
        # default physical source is wall milliseconds; the sim passes its
        # virtual clock so engine/sim timelines stay comparable
        self._clock = clock if clock is not None else (
            lambda: int(time.time() * 1000)
        )
        self.incarnation = max(1, int(incarnation))
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._physical_ms = 0
        self._logical = 0

    def _physical_now(self) -> int:
        try:
            return int(self._clock())
        except Exception:  # noqa: BLE001 -- clock failure never loses the stamp
            return self._physical_ms

    def now(self) -> HlcStamp:
        """Advance for a send or local event (HLC rule: l' = max(l, pt))."""
        pt = self._physical_now()
        with self._lock:
            if pt > self._physical_ms:
                self._physical_ms = pt
                self._logical = 0
            else:
                self._logical += 1
            return HlcStamp(self._physical_ms, self._logical, self.incarnation)

    def merge(self, remote: HlcStamp) -> HlcStamp:
        """Advance past a received stamp (HLC receive rule): the returned
        stamp is strictly greater than both the local clock and ``remote``,
        which is exactly the happened-before edge the timeline needs."""
        pt = self._physical_now()
        with self._lock:
            local = self._physical_ms
            physical = max(local, int(remote.physical_ms), pt)
            if physical == local and physical == remote.physical_ms:
                logical = max(self._logical, int(remote.logical)) + 1
            elif physical == local:
                logical = self._logical + 1
            elif physical == remote.physical_ms:
                logical = int(remote.logical) + 1
            else:
                logical = 0
            self._physical_ms = physical
            self._logical = logical
            return HlcStamp(physical, logical, self.incarnation)

    def peek(self) -> HlcStamp:
        """Current reading without advancing (status reporting)."""
        with self._lock:
            return HlcStamp(self._physical_ms, self._logical, self.incarnation)


# --------------------------------------------------------------------------- #
# Message sidecar (the trace-context pattern, observability.py)
# --------------------------------------------------------------------------- #

_HLC_ATTR = "hlc_stamp"


def stamp_hlc(msg: object, stamp: HlcStamp) -> None:
    """Attach a stamp to a (frozen) message out-of-band. Degrades to a
    no-op on slotted/odd message objects -- forensics never breaks send."""
    try:
        object.__setattr__(msg, _HLC_ATTR, stamp)
    except (AttributeError, TypeError):
        pass


def hlc_of(msg: object) -> Optional[HlcStamp]:
    return getattr(msg, _HLC_ATTR, None)
