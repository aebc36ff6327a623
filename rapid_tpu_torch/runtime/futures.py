"""A minimal promise usable under both real-threaded and virtual-time runtimes.

The port's own copy of ``rapid_tpu/runtime/futures.py``'s ``Promise`` (the
reference's Guava SettableFuture surface, MembershipService.java:171-193):
set_result/set_exception once, callbacks fired on completion, and a blocking
``result(timeout)`` for real-time mode. Its lock is a plain
``threading.Lock``: the lock-order checker it is instrumented with there
belongs to the protocol plane.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PromiseError(RuntimeError):
    pass


class Promise(Generic[T]):
    __slots__ = ("_event", "_result", "_exception", "_done", "_callbacks", "_lock")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[T] = None
        self._exception: Optional[BaseException] = None
        self._done = False
        self._callbacks: List[Callable[["Promise[T]"], None]] = []

    def done(self) -> bool:
        return self._done

    def set_result(self, value: T) -> None:
        self._complete(result=value)

    def set_exception(self, exc: BaseException) -> None:
        self._complete(exception=exc)

    def try_set_result(self, value: T) -> bool:
        return self._complete(result=value, strict=False)

    def try_set_exception(self, exc: BaseException) -> bool:
        """Non-strict failure: False if already completed (for deadline
        timers racing a response that arrives at the same instant)."""
        return self._complete(exception=exc, strict=False)

    def _complete(self, result: Any = None, exception: Optional[BaseException] = None,
                  strict: bool = True) -> bool:
        with self._lock:
            if self._done:
                if strict:
                    raise PromiseError("promise already completed")
                return False
            self._result = result
            self._exception = exception
            self._done = True
            callbacks = self._callbacks
            self._callbacks = []
        self._event.set()
        for cb in callbacks:
            cb(self)
        return True

    def add_callback(self, cb: Callable[["Promise[T]"], None]) -> None:
        """Invoke ``cb(self)`` when complete (immediately if already complete)."""
        run_now = False
        with self._lock:
            if self._done:
                run_now = True
            else:
                self._callbacks.append(cb)
        if run_now:
            cb(self)

    def exception(self) -> Optional[BaseException]:
        return self._exception

    def result(self, timeout: Optional[float] = None) -> T:
        """Block for the result (real-time mode only)."""
        if not self._event.wait(timeout):
            raise TimeoutError("promise not completed within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    def peek(self) -> T:
        """Non-blocking result access; raises if pending or failed."""
        if not self._done:
            raise PromiseError("promise not completed")
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    @staticmethod
    def completed(value: T) -> "Promise[T]":
        p: Promise[T] = Promise()
        p.set_result(value)
        return p

    @staticmethod
    def failed(exc: BaseException) -> "Promise[T]":
        p: Promise[T] = Promise()
        p.set_exception(exc)
        return p
