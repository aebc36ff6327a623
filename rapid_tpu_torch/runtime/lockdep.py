"""Runtime lock-order checking (lockdep) for the port's protocol plane.

The port's own copy of ``rapid_tpu/runtime/lockdep.py``, for the locks of
the port's protocol plane (``cluster``, ``messaging``, ``runtime``, the
fault plane), under JAX's class names. Linux lockdep's core
idea: locks are grouped into *classes* by creation site
(``"Reactor._lock"``, ``"codec._enc_memo_lock"``, ...), every acquisition
records *held-class -> acquired-class* edges into one process-global order
graph, and the first acquisition that would close a cycle in that graph
fails fast with the exact two chains -- at the moment the inversion is
*possible*, not the rare run where two threads actually interleave into the
deadlock.

The seam is :func:`make_lock` / :func:`make_condition` (the JAX package's
``make_rlock`` is left out: no lock of the port is reentrant).
With ``RAPID_LOCKDEP`` unset (or ``0``) they return plain ``threading``
primitives -- zero overhead, nothing imported beyond the stdlib. With
``RAPID_LOCKDEP=1`` they return instrumented wrappers that

- fail fast (``LockOrderViolation``) when acquiring a lock whose class can
  already reach a currently-held class in the order graph (a cycle);
- fail fast on same-instance re-entry of a non-reentrant lock (guaranteed
  self-deadlock);
- additionally append every violation to a process-global list
  (:func:`violations`), because protocol threads run under blanket
  exception handlers that must survive anything. The graph and the list
  are this module's own: the JAX package's checker keeps its own.

Two instances of the same class may nest (e.g. a parent registry iterating
children that share its class): same-class edges are ignored for cycle
purposes; only same-*instance* re-entry is fatal.

Conditions are deliberately returned uninstrumented: ``Condition.wait``
releases and reacquires its lock internally, and the discipline is that
condition locks are leaves -- nothing else is acquired under them.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set


class LockOrderViolation(RuntimeError):
    """A lock acquisition closed a cycle in the global order graph, or a
    non-reentrant lock was re-entered by its holder."""


def enabled() -> bool:
    """Sampled at lock *creation* time: locks made while RAPID_LOCKDEP=1 are
    instrumented for their lifetime, locks made while it is unset are plain."""
    return os.environ.get("RAPID_LOCKDEP", "") == "1"


# class name -> classes ever acquired while it was held (process-global,
# across every test in a session: lock *order* is a global invariant, so
# edges observed in different runs legitimately compose into cycles)
_graph: Dict[str, Set[str]] = {}
# guards _graph; a plain lock, never instrumented (it is always a leaf)
_graph_lock = threading.Lock()
_violations: List[str] = []
_tls = threading.local()


def _stack() -> List["_InstrumentedLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def violations() -> List[str]:
    """Violations recorded so far (survives raises swallowed by blanket
    executor handlers)."""
    return list(_violations)


def _reaches(src: str, dst: str) -> bool:
    """True if dst is reachable from src in the order graph. Caller holds
    _graph_lock."""
    seen: Set[str] = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(_graph.get(node, ()))
    return False


def _fail(msg: str) -> None:
    _violations.append(msg)
    raise LockOrderViolation(msg)


class _InstrumentedLock:
    """threading.Lock lookalike recording acquisition order."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.Lock()

    # -- ordering ----------------------------------------------------------

    def _note_acquire(self) -> None:
        stack = _stack()
        with _graph_lock:
            for held in stack:
                if held.name == self.name:
                    continue  # same-class nesting across instances: allowed
                if _reaches(self.name, held.name):
                    _fail(
                        f"lockdep: acquiring {self.name!r} while holding "
                        f"{held.name!r} closes a cycle: the order graph "
                        f"already shows {self.name!r} ... -> {held.name!r}"
                    )
                _graph.setdefault(held.name, set()).add(self.name)
        stack.append(self)

    def _note_release(self) -> None:
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                return

    # -- threading.Lock surface --------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if any(h is self for h in _stack()):
            # must fail BEFORE self._inner.acquire: the inner Lock would
            # deadlock this thread instead of reporting
            _fail(
                f"lockdep: same-instance re-entry of non-reentrant lock "
                f"{self.name!r} (guaranteed self-deadlock)"
            )
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquire()
        return got

    def release(self) -> None:
        self._note_release()
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockdep Lock {self.name!r}>"


def make_lock(name: str) -> "threading.Lock | _InstrumentedLock":
    """A non-reentrant lock, instrumented when RAPID_LOCKDEP=1."""
    if enabled():
        return _InstrumentedLock(name)
    return threading.Lock()


def make_condition(name: str, lock: Optional[threading.Lock] = None):
    """A condition variable. Never instrumented (wait() releases/reacquires
    internally); named for symmetry and future use. Condition locks must be
    leaves."""
    del name
    return threading.Condition(lock)
