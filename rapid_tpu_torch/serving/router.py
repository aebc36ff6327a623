"""Client-side routing surface of the serving plane: the port's copy of
``rapid_tpu/serving/router.py``.

The serving plane has two routing layers. Inside the cluster, the
ServingEngine maps keys to partitions (``kv.partition_of``) and partitions
to replica rows through the placement map. OUTSIDE the cluster -- a
workload router, an edge proxy -- the natural surface is membership itself:
rendezvous (highest-random-weight) hashing over the live member list, so a
view change only remaps the keys owned by the members it removed.

``RendezvousRouter`` is that surface, routing as the JAX package's does
(``examples/load_balancer.py``'s scheme): the same ``rendezvous_route`` /
``weight_seed`` helpers over the same sorted pool, rebalanced exactly at
VIEW_CHANGE events (membership IS the health signal -- no side-channel
health checks). ``cluster`` is any object with ``register_subscription``
and ``get_memberlist``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..events import ClusterEvents, NodeStatusChange
from ..placement import rendezvous_route, weight_seed
from ..types import EdgeStatus, Endpoint


class RendezvousRouter:
    """Routes request keys over the live membership, rebalancing exactly at
    VIEW_CHANGE events (the reference app surface: Cluster.java:98-140's
    getters plus registerSubscription).

    Rendezvous hashing via the placement plane's helpers
    (``placement.rendezvous_route``): key k goes to the backend with
    the highest seeded hash of k. Removing a backend only remaps the keys
    that were on it -- the property that makes a single multi-node cut a
    single rebalance."""

    def __init__(self, cluster, self_address: Endpoint) -> None:
        self._self = self_address
        self._lock = threading.Lock()
        self._backends: List[Endpoint] = []
        self._weight_seed: Dict[Endpoint, int] = {}
        self.view_changes = 0
        self.last_down: List[NodeStatusChange] = []
        cluster.register_subscription(
            ClusterEvents.VIEW_CHANGE, self._on_view_change
        )
        # the initial pool comes from the join response's configuration
        self._set_backends(cluster.get_memberlist())

    def _set_backends(self, members: List[Endpoint]) -> None:
        backends = [m for m in members if m != self._self]
        with self._lock:
            self._backends = backends
            self._weight_seed = {b: weight_seed(b) for b in backends}

    def _on_view_change(self, config_id: int, changes) -> None:
        with self._lock:
            pool = {b for b in self._backends}
        for change in changes:
            if change.status == EdgeStatus.UP:
                pool.add(change.endpoint)
            else:
                pool.discard(change.endpoint)
        self.view_changes += 1
        self.last_down = [
            c for c in changes if c.status == EdgeStatus.DOWN
        ]
        self._set_backends(sorted(pool, key=lambda e: (e.hostname, e.port)))

    def backends(self) -> List[Endpoint]:
        with self._lock:
            return list(self._backends)

    def route(self, key: bytes) -> Optional[Endpoint]:
        """The backend owning this key under rendezvous hashing."""
        with self._lock:
            if not self._backends:
                return None
            return rendezvous_route(key, self._backends, self._weight_seed)
