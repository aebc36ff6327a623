"""Streaming SLI computation for the serving path: the port of
``rapid_tpu/slo/sli.py``.

* :func:`histogram_quantile` -- latency percentiles off the mergeable
  fixed-bucket histograms the serving plane records
  (``SERVING_LATENCY_BUCKETS_MS``), Prometheus ``histogram_quantile``
  semantics.
* :class:`SliTracker` -- fixed-width time-bucket ring of SLI aggregates
  (good/total per named predicate, offered arrivals, a latency histogram
  per bucket); any trailing window is an exact sum of whole buckets.
* :class:`OpenLoopGenerator` -- arrival-rate-driven load: seeded
  exponential inter-arrivals independent of completions, zipfian keys,
  simulated client ids. It draws from ``random.Random(seed)`` in the JAX
  package's order (``expovariate``, ``random``, ``randrange``,
  ``random``), so equal seeds give both packages the same stream.
"""

from __future__ import annotations

import bisect
import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

from ..observability import SERVING_LATENCY_BUCKETS_MS


def histogram_quantile(
    buckets: Sequence[float], counts: Sequence[int], q: float,
) -> float:
    """The smallest bucket upper edge whose cumulative count reaches rank
    ``q * total`` (inclusive ``le`` edges, Prometheus convention).
    ``counts`` has one slot per edge plus the +Inf overflow slot. Returns
    0.0 on an empty histogram and ``inf`` when the rank lands in the
    overflow bucket."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cumulative = 0
    for edge, count in zip(buckets, counts):
        cumulative += count
        if cumulative >= rank:
            return float(edge)
    return float("inf")


@dataclass
class WindowStats:
    """Exact aggregate of one trailing window: per-predicate good counts,
    total scored requests, offered arrivals, and the merged latency
    histogram counts (parallel to ``latency_buckets`` plus +Inf)."""

    total: int = 0
    offered: int = 0
    good: Dict[str, int] = field(default_factory=dict)
    latency_buckets: Tuple[float, ...] = SERVING_LATENCY_BUCKETS_MS
    latency_counts: List[int] = field(default_factory=list)

    def availability(self, predicate: str) -> float:
        """good/total ratio for one named good-event predicate (1.0 on an
        empty window: no traffic consumes no error budget)."""
        if self.total <= 0:
            return 1.0
        return self.good.get(predicate, 0) / self.total

    def error_rate(self, predicate: str) -> float:
        return 1.0 - self.availability(predicate)

    def quantile(self, q: float) -> float:
        return histogram_quantile(self.latency_buckets, self.latency_counts, q)

    def goodput_ratio(self, predicate: str = "availability") -> float:
        """Completed-good over offered arrivals (1.0 when nothing was
        offered). Under overload this drops below availability: arrivals
        that never completed in the window count against it."""
        if self.offered <= 0:
            return 1.0
        return min(1.0, self.good.get(predicate, 0) / self.offered)


class _Bucket:
    __slots__ = ("start_ms", "total", "offered", "good", "latency_counts")

    def __init__(self, start_ms: int, predicates: Tuple[str, ...],
                 n_latency_slots: int) -> None:
        self.start_ms = start_ms
        self.total = 0
        self.offered = 0
        self.good = {p: 0 for p in predicates}
        self.latency_counts = [0] * n_latency_slots


class SliTracker:
    """Fixed-width time-bucket ring of SLI aggregates.

    ``predicates`` names the good-event predicates tracked per request (the
    caller evaluates them -- the tracker only counts). Buckets materialize
    lazily on first record so idle time costs nothing; the ring holds at
    most ``max_buckets`` buckets, evicting the oldest. Time must not run
    backwards across record calls (both planes feed a monotonic clock)."""

    def __init__(self, bucket_ms: int = 1000, max_buckets: int = 4096,
                 predicates: Sequence[str] = ("availability",),
                 latency_buckets: Tuple[float, ...] = SERVING_LATENCY_BUCKETS_MS,
                 ) -> None:
        assert bucket_ms >= 1
        assert max_buckets >= 2
        self.bucket_ms = int(bucket_ms)
        self.max_buckets = int(max_buckets)
        self.predicates = tuple(predicates)
        self.latency_buckets = tuple(latency_buckets)
        self._n_latency_slots = len(self.latency_buckets) + 1
        # fed from one execution context per owner (the service's protocol
        # executor, or the bench/sim driving thread) -- see SloPlane
        self._buckets: List[_Bucket] = []  # guarded-by: protocol-executor

    def _bucket_for(self, now_ms: int) -> _Bucket:
        start = (int(now_ms) // self.bucket_ms) * self.bucket_ms
        if self._buckets and self._buckets[-1].start_ms >= start:
            return self._buckets[-1]
        b = _Bucket(start, self.predicates, self._n_latency_slots)
        self._buckets.append(b)
        if len(self._buckets) > self.max_buckets:
            del self._buckets[: len(self._buckets) - self.max_buckets]
        return b

    def record(self, now_ms: int, latency_ms: float,
               good: Iterable[str] = ()) -> None:
        """Score one completed request at ``now_ms``: ``good`` is the set of
        predicate names the request satisfied."""
        b = self._bucket_for(now_ms)
        b.total += 1
        for name in good:
            if name in b.good:
                b.good[name] += 1
        i = bisect.bisect_left(self.latency_buckets, latency_ms)
        b.latency_counts[min(i, self._n_latency_slots - 1)] += 1

    def record_offered(self, now_ms: int, n: int = 1) -> None:
        """Count ``n`` open-loop arrivals offered at ``now_ms`` (whether or
        not they ever complete -- that asymmetry IS the goodput signal)."""
        self._bucket_for(now_ms).offered += n

    def window(self, now_ms: int, duration_ms: int) -> WindowStats:
        """Exact aggregate over every bucket overlapping
        ``(now_ms - duration_ms, now_ms]``."""
        cutoff = int(now_ms) - int(duration_ms)
        stats = WindowStats(
            latency_buckets=self.latency_buckets,
            latency_counts=[0] * self._n_latency_slots,
            good={p: 0 for p in self.predicates},
        )
        for b in reversed(self._buckets):
            if b.start_ms + self.bucket_ms <= cutoff:
                break
            if b.start_ms > now_ms:
                continue
            stats.total += b.total
            stats.offered += b.offered
            for name, count in b.good.items():
                stats.good[name] += count
            for i, c in enumerate(b.latency_counts):
                stats.latency_counts[i] += c
        return stats

    def span_ms(self) -> int:
        """Virtual time covered by the live ring (0 when empty)."""
        if not self._buckets:
            return 0
        return (
            self._buckets[-1].start_ms + self.bucket_ms
            - self._buckets[0].start_ms
        )


@dataclass(frozen=True)
class Arrival:
    """One open-loop client request, scheduled independently of every
    completion. ``at_ms`` is the arrival offset on the virtual clock."""

    at_ms: int
    op: str  # "get" | "put"
    key: bytes
    value: bytes
    client: int


class OpenLoopGenerator:
    """Arrival-rate-driven load: seeded exponential inter-arrivals, zipfian
    key popularity, and per-arrival simulated client ids drawn from a
    population of ``clients`` (millions by default). Deterministic per
    ``seed``: two generators with equal constructor arguments emit
    identical arrival streams.

    The zipf CDF is precomputed once over the working set (weight of key
    rank ``r`` is ``(r + 1) ** -zipf_s``), so each draw is one uniform
    variate plus a bisect -- cheap enough for millions of arrivals."""

    def __init__(self, rate_per_s: float, keys: Sequence[bytes],
                 put_fraction: float = 0.2, seed: int = 0,
                 zipf_s: float = 1.1, clients: int = 1_000_000) -> None:
        assert rate_per_s > 0
        assert keys
        assert 0.0 <= put_fraction <= 1.0
        self.rate_per_s = float(rate_per_s)
        self.keys = tuple(keys)
        self.put_fraction = float(put_fraction)
        self.clients = int(clients)
        self._rng = random.Random(seed)
        self._t_ms = 0.0
        self._seq = 0
        cdf: List[float] = []
        acc = 0.0
        for rank in range(len(self.keys)):
            acc += (rank + 1) ** -float(zipf_s)
            cdf.append(acc)
        self._cdf = [w / acc for w in cdf]

    def _pick_key(self) -> bytes:
        return self.keys[bisect.bisect_left(self._cdf, self._rng.random())]

    def next_arrival(self) -> Arrival:
        self._t_ms += self._rng.expovariate(self.rate_per_s) * 1000.0
        self._seq += 1
        op = "put" if self._rng.random() < self.put_fraction else "get"
        client = self._rng.randrange(self.clients)
        key = self._pick_key()
        value = b""
        if op == "put":
            value = b"v%d-c%d" % (self._seq, client)
        return Arrival(
            at_ms=int(self._t_ms), op=op, key=key, value=value, client=client,
        )

    def arrivals(self, n: int) -> List[Arrival]:
        return [self.next_arrival() for _ in range(n)]

    def rebase(self, at_ms: int) -> None:
        """Move the arrival clock forward to ``at_ms`` (never backward):
        the bench uses this to start a new load window after a virtual-time
        jump (e.g. a view change billed while the client was idle)."""
        self._t_ms = max(self._t_ms, float(at_ms))
