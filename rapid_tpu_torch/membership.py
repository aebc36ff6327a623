"""K-ring expander membership view.

The port's own copy of ``rapid_tpu/membership.py``.

Reference: MembershipView.java. The reference maintains K TreeSets of
endpoints, each ordered by a seeded-xxHash comparator (MembershipView.java:58-90
with Utils.AddressComparator, Utils.java:205-235). Every node *observes* its K
successors (one per ring, MembershipView.java:235-258) and is observed by its K
predecessors (its *subjects* are its predecessors, MembershipView.java:309-323).

This implementation keeps each ring as a Python list of (signed-hash, Endpoint)
kept sorted with bisect -- same ordering domain as the reference (signed int64
compare of the seeded hash, Utils.java:216-221). A hash collision between two
distinct endpoints on a ring raises, where the reference TreeSet would silently
treat them as the same element; collisions are a ~2^-64 event and failing loudly
is strictly safer.

Configuration identity is the chained xx(0) hash over (sorted identifiers,
ring-0 order endpoints) (MembershipView.java:531-547) and is bit-compatible
with the JVM.
"""

from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .hashing import configuration_id, endpoint_hash, to_signed
from .runtime.lockdep import make_lock
from .types import Endpoint, JoinStatusCode, NodeId


class NodeAlreadyInRingError(RuntimeError):
    pass


class NodeNotInRingError(RuntimeError):
    pass


class UUIDAlreadySeenError(RuntimeError):
    pass


@dataclass(frozen=True)
class Configuration:
    """Snapshot sufficient to bootstrap an identical view
    (MembershipView.Configuration, MembershipView.java:517-548)."""

    node_ids: Tuple[NodeId, ...]
    endpoints: Tuple[Endpoint, ...]

    @functools.cached_property
    def configuration_id(self) -> int:
        return configuration_id(
            ((nid.high, nid.low) for nid in self.node_ids),
            ((ep.hostname, ep.port) for ep in self.endpoints),
        )


class MembershipView:
    """K pseudo-random ring orderings of the member list."""

    def __init__(
        self,
        k: int,
        node_ids: Sequence[NodeId] = (),
        endpoints: Sequence[Endpoint] = (),
    ) -> None:
        if k <= 0:
            raise ValueError("K must be > 0")
        self.k = k
        # ring[i] is a sorted list of (signed_hash, endpoint)
        self._rings: List[List[Tuple[int, Endpoint]]] = [[] for _ in range(k)]
        self._hash_cache: List[Dict[Endpoint, int]] = [{} for _ in range(k)]
        self._all_nodes: Set[Endpoint] = set()
        # identifiersSeen, ordered by NodeId (high, low) signed compare
        self._identifiers: List[NodeId] = []
        self._identifier_set: Set[NodeId] = set()
        # The protocol thread changes the view while other threads read its
        # configuration (an agent's once-a-second status tick, a CLI): the
        # lock keeps each ring_add / ring_delete whole against a snapshot,
        # and the cache holds a configuration only for the generation it
        # was taken at (MembershipView.java guards the same state with its
        # read-write lock).
        self._lock = make_lock("MembershipView._lock")
        self._generation = 0  # ring_add / ring_delete calls so far
        self._current_config: Optional[Configuration] = None
        self._config_generation = -1
        if len(endpoints) > 256:
            # bulk bootstrap (a joiner rebuilding a large view from a
            # JoinResponse): vectorized ring keys + one sort per ring
            # instead of per-endpoint sorted-list inserts, which are
            # O(K * N^2) list memmoves -- minutes at 100k members
            self._bulk_insert(list(endpoints))
        else:
            for ep in endpoints:
                self._insert(ep)
        for nid in node_ids:
            if nid not in self._identifier_set:
                bisect.insort(self._identifiers, nid)
                self._identifier_set.add(nid)

    # -- internal ring maintenance ------------------------------------------

    def _ring_key(self, endpoint: Endpoint, ring: int) -> int:
        cache = self._hash_cache[ring]
        h = cache.get(endpoint)
        if h is None:
            h = to_signed(endpoint_hash(endpoint.hostname, endpoint.port, ring))
            cache[endpoint] = h
        return h

    def _insert(self, endpoint: Endpoint) -> None:
        for ring in range(self.k):
            entry = (self._ring_key(endpoint, ring), endpoint)
            lst = self._rings[ring]
            pos = bisect.bisect_left(lst, entry[0], key=lambda e: e[0])
            if pos < len(lst) and lst[pos][0] == entry[0] and lst[pos][1] != endpoint:
                raise RuntimeError(
                    f"ring hash collision on ring {ring}: {lst[pos][1]} vs {endpoint}"
                )
            lst.insert(pos, entry)
        self._all_nodes.add(endpoint)

    def _bulk_insert(self, endpoints: List[Endpoint]) -> None:
        """Construct all K rings at once: batched xxHash64 over the endpoint
        matrix and one stable argsort per ring. Produces bit-identical ring
        contents, hash caches, and collision errors to sequential
        ``_insert`` calls (keys are distinct signed int64s, so sorted order
        is unique)."""
        import numpy as np

        from . import native
        from .hashing import endpoint_hash_batch, pack_hostnames

        data, lengths = pack_hostnames([ep.hostname for ep in endpoints])
        ports = np.array([ep.port for ep in endpoints], dtype=np.int64)
        # all K rings in one native call where the library loads (the same
        # dispatch sim/topology.py uses for cluster synthesis)
        all_keys = native.ring_hashes(data, lengths, ports, self.k)
        for ring in range(self.k):
            keys = (
                all_keys[ring]
                if all_keys is not None
                else endpoint_hash_batch(data, lengths, ports, ring)
            ).view(np.int64)
            order = np.argsort(keys, kind="stable")
            sorted_keys = keys[order]
            for d in np.flatnonzero(sorted_keys[1:] == sorted_keys[:-1]):
                a, b = endpoints[order[d]], endpoints[order[d + 1]]
                if a != b:
                    raise RuntimeError(
                        f"ring hash collision on ring {ring}: {a} vs {b}"
                    )
            self._rings[ring] = [
                (int(sorted_keys[i]), endpoints[order[i]])
                for i in range(len(endpoints))
            ]
            self._hash_cache[ring] = {
                ep: int(key) for key, ep in self._rings[ring]
            }
        self._all_nodes.update(endpoints)

    def _remove(self, endpoint: Endpoint) -> None:
        for ring in range(self.k):
            key = self._ring_key(endpoint, ring)
            lst = self._rings[ring]
            pos = bisect.bisect_left(lst, key, key=lambda e: e[0])
            assert pos < len(lst) and lst[pos][1] == endpoint
            lst.pop(pos)
            # Reference drops the hash cache entry on delete (Utils.java:232-234)
            self._hash_cache[ring].pop(endpoint, None)
        self._all_nodes.discard(endpoint)

    # -- public protocol surface --------------------------------------------

    def is_safe_to_join(self, node: Endpoint, node_id: NodeId) -> JoinStatusCode:
        """MembershipView.java:101-116."""
        if node in self._all_nodes:
            return JoinStatusCode.HOSTNAME_ALREADY_IN_RING
        if node_id in self._identifier_set:
            return JoinStatusCode.UUID_ALREADY_IN_RING
        return JoinStatusCode.SAFE_TO_JOIN

    def ring_add(self, node: Endpoint, node_id: NodeId) -> None:
        """MembershipView.java:124-161."""
        with self._lock:
            if node_id in self._identifier_set:
                raise UUIDAlreadySeenError(f"{node} with identifier already seen {node_id}")
            if node in self._all_nodes:
                raise NodeAlreadyInRingError(str(node))
            self._insert(node)
            bisect.insort(self._identifiers, node_id)
            self._identifier_set.add(node_id)
            self._generation += 1

    def ring_delete(self, node: Endpoint) -> None:
        """MembershipView.java:168-202."""
        with self._lock:
            if node not in self._all_nodes:
                raise NodeNotInRingError(str(node))
            self._remove(node)
            self._generation += 1

    def get_observers_of(self, node: Endpoint) -> List[Endpoint]:
        """The K successors of ``node`` (MembershipView.java:211-258)."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        if len(self._rings[0]) <= 1:
            return []
        return [self._successor(ring, node) for ring in range(self.k)]

    def get_subjects_of(self, node: Endpoint) -> List[Endpoint]:
        """The K predecessors of ``node`` (MembershipView.java:268-283)."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        if len(self._rings[0]) <= 1:
            return []
        return [self._predecessor(ring, node) for ring in range(self.k)]

    def get_expected_observers_of(self, node: Endpoint) -> List[Endpoint]:
        """Observers a *joining* (absent) node would have
        (MembershipView.java:293-304): its predecessors on each ring."""
        if not self._rings[0]:
            return []
        return [self._predecessor(ring, node) for ring in range(self.k)]

    def _successor(self, ring: int, node: Endpoint) -> Endpoint:
        lst = self._rings[ring]
        key = self._ring_key(ring=ring, endpoint=node)
        pos = bisect.bisect_right(lst, key, key=lambda e: e[0])
        if pos == len(lst):
            return lst[0][1]
        return lst[pos][1]

    def _predecessor(self, ring: int, node: Endpoint) -> Endpoint:
        lst = self._rings[ring]
        key = self._ring_key(ring=ring, endpoint=node)
        pos = bisect.bisect_left(lst, key, key=lambda e: e[0])
        if pos == 0:
            return lst[-1][1]
        return lst[pos - 1][1]

    def get_ring_numbers(self, observer: Endpoint, subject: Endpoint) -> List[int]:
        """Rings on which ``subject`` is ``observer``'s subject
        (MembershipView.java:398-419)."""
        subjects = self.get_subjects_of(observer)
        return [ring for ring, node in enumerate(subjects) if node == subject]

    def is_host_present(self, address: Endpoint) -> bool:
        return address in self._all_nodes

    def is_identifier_present(self, identifier: NodeId) -> bool:
        return identifier in self._identifier_set

    def get_ring(self, ring: int) -> List[Endpoint]:
        with self._lock:
            return [ep for _, ep in self._rings[ring]]

    @property
    def membership_size(self) -> int:
        return len(self._rings[0])

    def get_current_configuration_id(self) -> int:
        return self.get_configuration().configuration_id

    def get_configuration(self) -> Configuration:
        """The current configuration, its id folded once. The snapshot is
        taken under the lock and the fold (~0.75 s at 100k members) runs
        outside it, so a reader never holds up the protocol thread; its
        result is cached only if no ring_add or ring_delete ran meanwhile. A
        reader that folded a view the protocol thread has changed since
        returns that view's id to its caller alone, and never leaves it
        cached as the current one."""
        with self._lock:
            config = self._current_config
            if config is not None and self._config_generation == self._generation:
                return config
            generation = self._generation
            config = Configuration(
                node_ids=tuple(self._identifiers),
                endpoints=tuple(ep for _, ep in self._rings[0]),
            )
        config.configuration_id  # noqa: B018 -- the fold, memoized on the snapshot
        with self._lock:
            if self._generation == generation:
                self._current_config, self._config_generation = config, generation
        return config
