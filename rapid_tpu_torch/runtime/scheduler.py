"""Pluggable clocks: a deterministic virtual-time scheduler and a real one.

The port's own copy of ``rapid_tpu/runtime/scheduler.py``. The reference
serializes all protocol logic through a single-threaded executor per node
and drives timers off one scheduled executor (SharedResources.java:48-67,
MembershipService.java:145-148,686-696); a ``Scheduler`` is that seam, with
two implementations:

- ``VirtualScheduler``: a discrete-event loop. Tasks run in deterministic
  (time, seq) order and "sleeping" is free.
- ``RealScheduler``: one worker thread + heap with wall-clock deadlines, for
  real sockets (the retry backoff of ``messaging/retries.py`` and the swarm
  gateway's protocol clock, ``messaging/gateway.py``).

Periodic jobs and cancellation mirror scheduleAtFixedRate/Future.cancel.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple

from .lockdep import make_condition


class ScheduledTask:
    """Cancellable handle, akin to java.util.concurrent.ScheduledFuture."""

    __slots__ = ("fn", "cancelled", "period_ms")

    def __init__(self, fn: Callable[[], None], period_ms: Optional[int] = None) -> None:
        self.fn = fn
        self.cancelled = False
        self.period_ms = period_ms

    def cancel(self) -> None:
        self.cancelled = True


class Scheduler:
    """Interface: current time + deferred/periodic execution."""

    def now_ms(self) -> int:
        raise NotImplementedError

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> ScheduledTask:
        raise NotImplementedError

    def schedule_at_fixed_rate(
        self, initial_delay_ms: int, period_ms: int, fn: Callable[[], None]
    ) -> ScheduledTask:
        raise NotImplementedError

    def execute(self, fn: Callable[[], None]) -> None:
        self.schedule(0, fn)

    def shutdown(self) -> None:
        pass


class VirtualScheduler(Scheduler):
    """Deterministic discrete-event scheduler; single-threaded."""

    def __init__(self) -> None:
        self._now = 0
        self._seq = itertools.count()
        self._heap: List[Tuple[int, int, ScheduledTask]] = []
        self._running = False

    def now_ms(self) -> int:
        return self._now

    def _push(self, when_ms: int, task: ScheduledTask) -> None:
        heapq.heappush(self._heap, (when_ms, next(self._seq), task))

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> ScheduledTask:
        task = ScheduledTask(fn)
        self._push(self._now + max(0, int(delay_ms)), task)
        return task

    def schedule_at_fixed_rate(
        self, initial_delay_ms: int, period_ms: int, fn: Callable[[], None]
    ) -> ScheduledTask:
        task = ScheduledTask(fn, period_ms=max(1, int(period_ms)))
        self._push(self._now + max(0, int(initial_delay_ms)), task)
        return task

    # -- driving the clock (test harness surface) ---------------------------

    def run_for(self, duration_ms: int) -> None:
        """Advance virtual time by ``duration_ms``, running every due task."""
        self.run_until_time(self._now + duration_ms)

    def run_until_time(self, deadline_ms: int) -> None:
        assert not self._running, "re-entrant scheduler drive"
        self._running = True
        try:
            while self._heap and self._heap[0][0] <= deadline_ms:
                when, _, task = heapq.heappop(self._heap)
                if task.cancelled:
                    continue
                self._now = max(self._now, when)
                if task.period_ms is not None:
                    self._push(self._now + task.period_ms, task)
                task.fn()
            self._now = max(self._now, deadline_ms)
        finally:
            self._running = False

    def run_until(
        self,
        predicate: Callable[[], bool],
        timeout_ms: int = 600_000,
        poll_ms: int = 10,
    ) -> bool:
        """Advance time until ``predicate()`` or virtual timeout. Returns success."""
        deadline = self._now + timeout_ms
        while self._now < deadline:
            if predicate():
                return True
            step_to = min(self._now + poll_ms, deadline)
            self.run_until_time(step_to)
        return predicate()


class RealScheduler(Scheduler):
    """Wall-clock scheduler: one timer thread draining a heap."""

    def __init__(self, name: str = "rapid-scheduler") -> None:
        self._heap: List[Tuple[float, int, ScheduledTask]] = []
        self._seq = itertools.count()
        self._cond = make_condition("RealScheduler._cond")
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def now_ms(self) -> int:
        return int(time.monotonic() * 1000)

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> ScheduledTask:
        task = ScheduledTask(fn)
        with self._cond:
            heapq.heappush(
                self._heap, (time.monotonic() + delay_ms / 1000.0, next(self._seq), task)
            )
            self._cond.notify()
        return task

    def schedule_at_fixed_rate(
        self, initial_delay_ms: int, period_ms: int, fn: Callable[[], None]
    ) -> ScheduledTask:
        task = ScheduledTask(fn, period_ms=max(1, int(period_ms)))
        with self._cond:
            heapq.heappush(
                self._heap,
                (time.monotonic() + initial_delay_ms / 1000.0, next(self._seq), task),
            )
            self._cond.notify()
        return task

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._shutdown and (
                    not self._heap or self._heap[0][0] > time.monotonic()
                ):
                    timeout = (
                        self._heap[0][0] - time.monotonic() if self._heap else None
                    )
                    self._cond.wait(timeout=timeout)
                if self._shutdown:
                    return
                _, _, task = heapq.heappop(self._heap)
                if task.cancelled:
                    continue
                if task.period_ms is not None:
                    heapq.heappush(
                        self._heap,
                        (time.monotonic() + task.period_ms / 1000.0, next(self._seq), task),
                    )
            try:
                task.fn()
            except Exception:  # noqa: BLE001 -- scheduler must survive task errors
                import logging

                logging.getLogger(__name__).exception("scheduled task failed")

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        self._thread.join(timeout=5)
