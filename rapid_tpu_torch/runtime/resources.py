"""Per-node shared runtime resources.

The port's own copy of ``rapid_tpu/runtime/resources.py``.

Reference: SharedResources.java:48-67 -- per instance: a single-threaded
protocol executor that serializes ALL protocol logic, a scheduled background
executor for timers, and transport event loops. rapid-tpu collapses these onto
the Scheduler seam:

- virtual mode: one VirtualScheduler shared by every in-process node; the
  protocol executor is `schedule(0, fn)` -- globally serialized and
  deterministic, which is strictly stronger than the reference's per-node
  serialization.
- real mode: a RealScheduler for timers plus a dedicated single worker thread
  per node for protocol serialization.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from .scheduler import RealScheduler, Scheduler, VirtualScheduler


class ProtocolExecutor:
    """Serialized executor for a node's protocol logic."""

    def execute(self, fn: Callable[[], None]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class _SchedulerExecutor(ProtocolExecutor):
    def __init__(self, scheduler: Scheduler) -> None:
        self._scheduler = scheduler

    def execute(self, fn: Callable[[], None]) -> None:
        self._scheduler.schedule(0, fn)


class _ThreadExecutor(ProtocolExecutor):
    def __init__(self, name: str) -> None:
        self._queue: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 -- executor must survive task errors
                import logging

                logging.getLogger(__name__).exception("protocol task failed")

    def execute(self, fn: Callable[[], None]) -> None:
        self._queue.put(fn)

    def shutdown(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)


def _is_virtual(scheduler: Scheduler) -> bool:
    """True when the scheduler is (or wraps, via an ``inner`` chain) a
    VirtualScheduler -- e.g. a nemesis SkewedScheduler around the shared
    virtual clock. Such a node must serialize protocol tasks through the
    scheduler, not a real thread: a thread races the virtual clock, which
    jumps past RPC deadlines before the thread completes the response."""
    seen = 0
    while scheduler is not None and seen < 8:
        if isinstance(scheduler, VirtualScheduler):
            return True
        scheduler = getattr(scheduler, "inner", None)
        seen += 1
    return False


class SharedResources:
    def __init__(self, scheduler: Optional[Scheduler] = None, name: str = "node") -> None:
        self.scheduler: Scheduler = scheduler if scheduler is not None else RealScheduler()
        self._owns_scheduler = scheduler is None
        if _is_virtual(self.scheduler):
            self.protocol_executor: ProtocolExecutor = _SchedulerExecutor(self.scheduler)
        else:
            self.protocol_executor = _ThreadExecutor(f"{name}-protocol")

    def shutdown(self) -> None:
        self.protocol_executor.shutdown()
        if self._owns_scheduler:
            self.scheduler.shutdown()
