"""Async retry combinator (Retries.callWithRetries, Retries.java:44-91),
hardened with exponential backoff, decorrelated jitter and an overall
deadline. The port's own copy of ``rapid_tpu/messaging/retries.py``.

The reference resubscribes immediately on failure -- under a lossy link that
is a retry storm ("The Performance of Paxos in the Cloud", PAPERS.md, shows
this class of tail behavior dominating consensus latency). The hardened form
spaces attempts by a :class:`RetryPolicy` and bounds the whole exchange by a
deadline, both driven through the :class:`~..runtime.scheduler.Scheduler`
seam so virtual-time tests pin the exact schedule deterministically.

Defaults are the reference's combinator: no policy and no deadline means
immediate resubscription, until Settings opts a transport into backoff.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Optional

from ..runtime.lockdep import make_lock
from ..runtime.futures import Promise
from ..runtime.scheduler import Scheduler


class RetryDeadlineExceeded(TimeoutError):
    """The overall retry deadline elapsed before an attempt succeeded."""


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule between attempts.

    ``base_delay_ms == 0`` reproduces the legacy immediate-resubscribe
    behavior exactly. With ``jitter="decorrelated"`` the delay follows the
    AWS decorrelated-jitter recurrence ``sleep = min(cap, uniform(base,
    prev * 3))``; ``jitter="none"`` is plain capped exponential doubling.
    """

    base_delay_ms: int = 0
    max_delay_ms: int = 30_000
    jitter: str = "decorrelated"  # "decorrelated" | "none"

    def __post_init__(self) -> None:
        assert self.jitter in ("decorrelated", "none"), self.jitter
        assert 0 <= self.base_delay_ms <= self.max_delay_ms

    def next_delay_ms(self, prev_delay_ms: int, rng: random.Random) -> int:
        if self.base_delay_ms == 0:
            return 0
        if self.jitter == "none":
            grown = prev_delay_ms * 2 if prev_delay_ms > 0 else self.base_delay_ms
            return min(self.max_delay_ms, grown)
        lo = self.base_delay_ms
        hi = max(lo, prev_delay_ms * 3)
        return min(self.max_delay_ms, int(rng.uniform(lo, hi)))


# Wall-clock scheduler shared by socket transports that have no scheduler of
# their own (TCP/gRPC clients): one timer thread lazily created on the first
# backoff/deadline actually requested, never for the 0-delay default path.
_wall_lock = make_lock("retries._wall_lock")
_wall_scheduler: Optional[Scheduler] = None


def wall_scheduler() -> Scheduler:
    from ..runtime.scheduler import RealScheduler

    global _wall_scheduler
    with _wall_lock:
        if _wall_scheduler is None:
            _wall_scheduler = RealScheduler(name="rapid-retry-backoff")
        return _wall_scheduler


def call_with_retries(
    attempt: Callable[[], Promise],
    retries: int,
    *,
    scheduler: Optional[Scheduler] = None,
    policy: Optional[RetryPolicy] = None,
    deadline_ms: Optional[int] = None,
    rng: Optional[random.Random] = None,
    metrics=None,
) -> Promise:
    """Run ``attempt`` up to ``retries + 1`` times, resubscribing on failure.

    - ``policy``: backoff between attempts; delays hop through ``scheduler``
      (required when the policy's base delay is nonzero).
    - ``deadline_ms``: overall budget across every attempt, measured on
      ``scheduler.now_ms()``. A retry that cannot start before the deadline
      fails the promise with :class:`RetryDeadlineExceeded` chaining the last
      attempt's error. Requires ``scheduler``.
    - ``metrics``: optional :class:`~..observability.Metrics`; counts
      ``retry_attempts`` / ``retry_exhausted`` / ``retry_deadline_exceeded``
      and observes each realized backoff into ``retry_backoff_ms``.
    """
    out: Promise = Promise()
    policy = policy if policy is not None else RetryPolicy()
    needs_clock = deadline_ms is not None or policy.base_delay_ms > 0
    assert scheduler is not None or not needs_clock, (
        "backoff/deadline retries need a scheduler for time"
    )
    rng = rng if rng is not None else random.Random()
    start_ms = scheduler.now_ms() if scheduler is not None else 0
    state = {"prev_delay": 0}

    def run(remaining: int) -> None:
        if metrics is not None:
            metrics.incr("retry_attempts")
        try:
            p = attempt()
        except Exception as e:  # noqa: BLE001 -- synchronous failure counts too
            _on_fail(e, remaining)
            return
        p.add_callback(lambda done: _on_done(done, remaining))

    def _on_done(done: Promise, remaining: int) -> None:
        exc = done.exception()
        if exc is None:
            if not out.done():
                out.try_set_result(done._result)  # noqa: SLF001
        else:
            _on_fail(exc, remaining)

    def _on_fail(exc: BaseException, remaining: int) -> None:
        if remaining <= 0:
            if metrics is not None:
                metrics.incr("retry_exhausted")
            if not out.done():
                out.try_set_exception(exc)
            return
        delay = policy.next_delay_ms(state["prev_delay"], rng)
        state["prev_delay"] = delay
        if deadline_ms is not None and (
            scheduler.now_ms() + delay >= start_ms + deadline_ms
        ):
            if metrics is not None:
                metrics.incr("retry_deadline_exceeded")
            if not out.done():
                dead = RetryDeadlineExceeded(
                    f"retry deadline of {deadline_ms} ms exhausted"
                )
                dead.__cause__ = exc
                out.try_set_exception(dead)
            return
        if delay > 0:
            if metrics is not None:
                # the realized jitter schedule, observable next to fd.rtt_ms:
                # under a DelayRule'd or slow link the histogram shows how
                # backoff and the per-message deadline split the budget
                metrics.observe("retry_backoff_ms", delay)
            scheduler.schedule(delay, lambda: run(remaining - 1))
        else:
            run(remaining - 1)

    run(retries)
    return out
