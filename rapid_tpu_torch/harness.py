"""In-process N-node cluster harness on virtual time: the port's own copy
of ``tests/harness.py``, over the port's classes.

The equivalent of ClusterTest's buildCluster/waitAndVerifyAgreement machinery
(ClusterTest.java:711-778): full protocol, zero sockets, injectable failure
detectors and message drop/delay interceptors -- but deterministic and fast,
because timers run on the shared VirtualScheduler instead of wall clock.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set

from .cluster import Cluster, ClusterBuilder
from .messaging.inprocess import (
    InProcessClient,
    InProcessNetwork,
    InProcessServer,
)
from .monitoring.base import IEdgeFailureDetectorFactory
from .monitoring.static_fd import StaticFailureDetectorFactory
from .runtime.futures import Promise
from .runtime.scheduler import VirtualScheduler
from .settings import Settings
from .types import Endpoint

BASE_PORT = 1234

# the probing port reservation of messaging/ports.py, re-exported as the
# JAX package's harness does
from .messaging.ports import free_port  # noqa (re-export)
from .messaging.ports import free_port_base  # noqa (re-export)


class ClusterHarness:
    def __init__(self, seed: int = 0, use_static_fd: bool = True,
                 settings: Optional[Settings] = None) -> None:
        self.scheduler = VirtualScheduler()
        self.network = InProcessNetwork(self.scheduler)
        self.rng = random.Random(seed)
        self.settings = settings if settings is not None else Settings()
        self.blacklist: Set[Endpoint] = set()
        self.use_static_fd = use_static_fd
        # written by the caller and by join callbacks, which run on the thread
        # that drives the virtual scheduler: the caller's
        self.instances: Dict[Endpoint, Cluster] = {}  # guarded-by: virtual-scheduler
        self.servers: Dict[Endpoint, InProcessServer] = {}
        # optional dissemination swap: factory(client, rng) -> IBroadcaster
        self.broadcaster_factory = None
        # optional armed fault plane (with_faults); wraps every node built
        self.nemesis = None

    def with_faults(self, plan) -> "ClusterHarness":
        """Arm a FaultPlan over this harness's virtual-time fabric: every
        node built afterwards gets its client/server pair wrapped in the
        nemesis decorators. Call ``self.nemesis.arm()`` again after bootstrap
        to restart the plan's windows from a healthy view."""
        from .faults import Nemesis

        self.nemesis = Nemesis(plan, self.scheduler)
        return self

    def addr(self, i: int) -> Endpoint:
        return Endpoint.from_parts("127.0.0.1", BASE_PORT + i)

    def _builder(self, addr: Endpoint,
                 fd: Optional[IEdgeFailureDetectorFactory] = None,
                 metadata: Optional[Dict[str, bytes]] = None,
                 subscriptions=None,
                 placement: Optional[Dict[str, int]] = None,
                 handoff=None,
                 serving: bool = False,
                 durability: Optional[str] = None) -> ClusterBuilder:
        server = InProcessServer(addr, self.network)
        self.servers[addr] = server
        client = InProcessClient(addr, self.network, self.settings)
        scheduler = self.scheduler
        if self.nemesis is not None:
            client = self.nemesis.client(client, address=addr,
                                         settings=self.settings)
            server = self.nemesis.server(server, addr)
            # a ClockSkewRule'd node runs its ENTIRE timer stack (FD probe
            # intervals, batching windows, deadlines) on its drifted clock
            scheduler = self.nemesis.scheduler_for(addr)
        builder = (
            ClusterBuilder(addr)
            .set_messaging_client_and_server(client, server)
            .use_scheduler(scheduler)
            .use_settings(self.settings)
            .use_rng(random.Random(self.rng.getrandbits(64)))
        )
        if self.broadcaster_factory is not None:
            builder.set_broadcaster_factory(self.broadcaster_factory)
        if fd is not None:
            builder.set_edge_failure_detector_factory(fd)
        elif self.use_static_fd:
            builder.set_edge_failure_detector_factory(
                StaticFailureDetectorFactory(self.blacklist)
            )
        if metadata:
            builder.set_metadata(metadata)
        if placement:
            builder.use_placement(**placement)
        if handoff is not None:
            # a PartitionStore instance, or a factory called per node
            store = handoff() if callable(handoff) else handoff
            builder.use_handoff(store)
        if serving:
            builder.use_serving()
        if durability is not None:
            # per-node WAL directory; effective only when the harness's
            # Settings enable the durability plane (the kill switch)
            builder.use_durability(durability)
        for event, cb in subscriptions or []:
            builder.add_subscription(event, cb)
        return builder

    # -- cluster construction ------------------------------------------------

    def start_seed(self, i: int = 0, **kw) -> Cluster:
        cluster = self._builder(self.addr(i), **kw).start()
        self.instances[cluster.listen_address] = cluster
        return cluster

    def join_async(self, i: int, seed_index: int = 0, **kw) -> Promise:
        promise = self._builder(self.addr(i), **kw).join_async(self.addr(seed_index))

        def record(p: Promise) -> None:
            if p.exception() is None:
                cluster = p.peek()
                self.instances[cluster.listen_address] = cluster

        promise.add_callback(record)
        return promise

    def join(self, i: int, seed_index: int = 0, timeout_ms: int = 120_000, **kw) -> Cluster:
        promise = self.join_async(i, seed_index, **kw)
        ok = self.scheduler.run_until(promise.done, timeout_ms=timeout_ms)
        assert ok, f"join of node {i} timed out (virtual)"
        return promise.peek()

    def create_cluster(self, n: int, parallel: bool = True,
                       timeout_ms: int = 300_000) -> List[Cluster]:
        """Seed + (n-1) joiners, optionally all racing through the seed at once
        (ClusterTest.java:184-191)."""
        self.start_seed(0)
        if parallel:
            promises = [self.join_async(i) for i in range(1, n)]
            ok = self.scheduler.run_until(
                lambda: all(p.done() for p in promises), timeout_ms=timeout_ms
            )
            assert ok, "parallel joins timed out (virtual)"
            for p in promises:
                assert p.exception() is None, f"join failed: {p.exception()}"
        else:
            for i in range(1, n):
                self.join(i)
        return list(self.instances.values())

    # -- failure injection ---------------------------------------------------

    def fail_nodes(self, endpoints: List[Endpoint]) -> None:
        """Crash-stop: unregister the server and blacklist for static FDs
        (ClusterTest.failSomeNodes)."""
        for endpoint in endpoints:
            self.blacklist.add(endpoint)
            cluster = self.instances.pop(endpoint, None)
            if cluster is not None:
                cluster.shutdown()

    # -- convergence ---------------------------------------------------------

    def converged(self, expected_size: int) -> bool:
        instances = list(self.instances.values())
        if not instances:
            return False
        lists = []
        for instance in instances:
            members = instance.get_memberlist()
            if len(members) != expected_size:
                return False
            lists.append(members)
        first = lists[0]
        return all(lst == first for lst in lists)

    def wait_and_verify_agreement(self, expected_size: int,
                                  timeout_ms: int = 600_000,
                                  poll_ms: int = 500) -> None:
        """All live instances report identical member lists of expected size
        (ClusterTest.waitAndVerifyAgreement, ClusterTest.java:711-731)."""
        ok = self.scheduler.run_until(
            lambda: self.converged(expected_size), timeout_ms=timeout_ms,
            poll_ms=poll_ms,
        )
        if not ok:
            sizes = {
                str(ep): inst.get_membership_size()
                for ep, inst in self.instances.items()
            }
            raise AssertionError(
                f"no agreement on size {expected_size}; sizes: {sizes}"
            )
        configs = {
            inst.get_current_configuration_id() for inst in self.instances.values()
        }
        assert len(configs) == 1, f"diverging configuration ids: {configs}"

    def shutdown(self) -> None:
        for cluster in list(self.instances.values()):
            cluster.shutdown()
        self.instances.clear()
