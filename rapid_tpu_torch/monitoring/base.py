"""The edge failure-detector plugin seam.

The port's own copy of ``rapid_tpu/monitoring/base.py``.

Reference: monitoring/IEdgeFailureDetectorFactory.java:31-33. The membership
service schedules the returned runnable once per FD interval for each of the
node's subjects (MembershipService.java:686-696); the detector invokes
``notifier`` to declare the edge to its subject faulty.
"""

from __future__ import annotations

from typing import Callable

from ..types import Endpoint


class IEdgeFailureDetectorFactory:
    def create_instance(
        self, subject: Endpoint, notifier: Callable[[], None]
    ) -> Callable[[], None]:
        """Return a runnable executed every failure_detector_interval_ms."""
        raise NotImplementedError
