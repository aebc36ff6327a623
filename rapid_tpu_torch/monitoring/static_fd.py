"""Deterministic failure detector for tests and simulations.

The port's own copy of ``rapid_tpu/monitoring/static_fd.py``.

Reference: StaticFailureDetector (test fixture, StaticFailureDetector.java:25-62)
-- consults a shared mutable blacklist, so tests fail arbitrary node sets
instantly and deterministically.
"""

from __future__ import annotations

from typing import Callable, Set

from ..types import Endpoint
from .base import IEdgeFailureDetectorFactory


class StaticFailureDetector:
    def __init__(
        self, subject: Endpoint, blacklist: Set[Endpoint], notifier: Callable[[], None]
    ) -> None:
        self._subject = subject
        self._blacklist = blacklist
        self._notifier = notifier
        self._notified = False

    def __call__(self) -> None:
        if not self._notified and self._subject in self._blacklist:
            self._notified = True
            self._notifier()


class StaticFailureDetectorFactory(IEdgeFailureDetectorFactory):
    def __init__(self, blacklist: Set[Endpoint]) -> None:
        self.blacklist = blacklist  # shared & mutable on purpose

    def create_instance(
        self, subject: Endpoint, notifier: Callable[[], None]
    ) -> Callable[[], None]:
        return StaticFailureDetector(subject, self.blacklist, notifier)

    def fail_nodes(self, nodes: Set[Endpoint]) -> None:
        self.blacklist.update(nodes)
