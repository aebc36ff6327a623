"""The port's live placement engine and router against the JAX package's:
``PlacementEngine`` and ``PlacementSubscriber``
(``rapid_tpu_torch/placement/engine.py``) fed the same view sequences give
equal maps (assignments, versions, members, weights) and equal diffs (moved
partitions, handoffs, load deltas); ``weight_seed``, ``rendezvous_route``
and ``RendezvousRouter`` (``rapid_tpu_torch/serving/router.py``) route
hypothesis-drawn keys over hypothesis-drawn backends identically; and the
``events`` copies match. Pure Python on both sides, so equality is exact.
"""

from hypothesis import given, settings
from hypothesis import strategies as st

import rapid_tpu.events as jev
import rapid_tpu.placement as jpl
import rapid_tpu.serving.router as jrouter
import rapid_tpu.types as jt
import rapid_tpu_torch.events as pev
import rapid_tpu_torch.placement as ppl
import rapid_tpu_torch.serving as pserving
import rapid_tpu_torch.types as pt

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

JAX = (jev, jpl, jt, jrouter.RendezvousRouter)
PORT = (pev, ppl, pt, pserving.RendezvousRouter)

HOSTS = st.sampled_from([b"10.0.0.1", b"10.0.0.2", b"node-a.example", b"h"])
PORTS = st.integers(1, 65535)
ADDRESSES = st.tuples(HOSTS, PORTS)
WEIGHT_TAGS = st.one_of(
    st.just(()),
    st.integers(-3, 80).map(lambda w: (("capacity", str(w).encode()),)),
    st.just((("capacity", b"bogus"),)),
    st.just((("zone", b"a"),)),
)
# a view sequence: each step adds some addresses (with weight tags) and
# removes some of the members
STEPS = st.lists(
    st.tuples(st.lists(st.tuples(ADDRESSES, WEIGHT_TAGS), max_size=4),
              st.lists(st.integers(0, 30), max_size=3)),
    min_size=1, max_size=5)


def _events(pkg, steps):
    """``steps`` as (configuration id, [NodeStatusChange]) of ``pkg``'s
    classes, the view kept so every removal names a member."""
    ev, _, types, _ = pkg
    members, out = {}, []
    for i, (adds, removes) in enumerate(steps):
        changes = []
        for (host, port), tags in adds:
            ep = types.Endpoint(host, port)
            if ep not in members:
                members[ep] = tags
                changes.append(ev.NodeStatusChange(ep, types.EdgeStatus.UP, tags))
        ordered = sorted(members)
        for r in removes:
            if ordered and r < len(ordered) and ordered[r] in members:
                del members[ordered[r]]
                changes.append(ev.NodeStatusChange(ordered[r], types.EdgeStatus.DOWN))
        out.append((1000 + i, changes))
    return out


def _ep(ep):
    return None if ep is None else (ep.hostname, ep.port)


def _map(m):
    return m and (m.configuration_id, m.version, tuple(_ep(e) for e in m.members), m.weights,
                  tuple(tuple(_ep(e) for e in row) for row in m.assignments))


def _diff(d):
    return d and (d.old_version, d.new_version, d.configuration_id, d.partitions_moved,
                  tuple((p, _ep(a), _ep(b)) for p, a, b in d.handoffs),
                  tuple((_ep(e), n) for e, n in d.load_delta))


@settings(max_examples=40, deadline=None)
@given(steps=STEPS, partitions=st.integers(1, 24), replicas=st.integers(1, 4),
       seed=st.integers(0, 2**31))
def test_subscribers_fed_the_same_events_build_the_same_maps(steps, partitions, replicas,
                                                              seed):
    subs = [pkg[1].PlacementSubscriber(pkg[1].PlacementConfig(
        partitions=partitions, replicas=replicas, seed=seed)) for pkg in (JAX, PORT)]
    for (cid, jax_changes), (_, port_changes) in zip(_events(JAX, steps), _events(PORT, steps)):
        subs[0](cid, jax_changes)
        subs[1](cid, port_changes)
        assert _map(subs[1].map) == _map(subs[0].map)
        assert _diff(subs[1].last_diff) == _diff(subs[0].last_diff)
    assert subs[1].view_changes == subs[0].view_changes == len(steps)
    assert subs[1].config.partitions == partitions


@settings(max_examples=30, deadline=None)
@given(views=st.lists(st.lists(st.tuples(ADDRESSES, st.integers(1, 9)), max_size=6),
                      min_size=1, max_size=4))
def test_engines_fed_the_same_views_give_equal_maps_and_diffs(views):
    engines = [pkg[1].PlacementEngine(pkg[1].PlacementConfig(partitions=16, replicas=2,
                                                            seed=7)) for pkg in (JAX, PORT)]
    for cid, view in enumerate(views):
        got = []
        for engine, pkg in zip(engines, (JAX, PORT)):
            members = [pkg[2].Endpoint(h, p) for (h, p), _ in view]
            weights = {pkg[2].Endpoint(h, p): w for (h, p), w in view}
            new_map, diff = engine.update(cid, members, weights)
            assert new_map is engine.map and diff is engine.last_diff
            got.append((_map(new_map), _diff(diff)))
        assert got[1] == got[0]


@settings(max_examples=60, deadline=None)
@given(keys=st.lists(st.binary(max_size=24), min_size=1, max_size=12),
       backends=st.lists(ADDRESSES, min_size=1, max_size=8, unique=True))
def test_weight_seed_and_rendezvous_route_route_alike(keys, backends):
    routes = []
    for pkg in (JAX, PORT):
        eps = [pkg[2].Endpoint(h, p) for h, p in backends]
        seeds = {ep: pkg[1].weight_seed(ep) for ep in eps}
        assert all(0 <= s <= 0x7FFFFFFF for s in seeds.values())
        routes.append(([seeds[ep] for ep in eps],
                       [_ep(pkg[1].rendezvous_route(k, eps, seeds)) for k in keys]))
    assert routes[1] == routes[0]


def test_rendezvous_route_refuses_no_backends():
    import pytest

    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="no backends"):
            pkg[1].rendezvous_route(b"k", [], {})


class _Cluster:
    """The two calls a RendezvousRouter makes on a cluster."""

    def __init__(self, members):
        self.members = list(members)
        self.subscriptions = {}

    def register_subscription(self, event, callback):
        self.subscriptions.setdefault(event, []).append(callback)

    def get_memberlist(self):
        return list(self.members)


@settings(max_examples=30, deadline=None)
@given(initial=st.lists(ADDRESSES, min_size=1, max_size=6, unique=True), steps=STEPS,
       keys=st.lists(st.binary(max_size=16), min_size=1, max_size=10))
def test_routers_route_alike_through_view_changes(initial, steps, keys):
    routers, clusters = [], []
    for pkg in (JAX, PORT):
        cluster = _Cluster(pkg[2].Endpoint(h, p) for h, p in initial)
        routers.append(pkg[3](cluster, pkg[2].Endpoint(*initial[0])))
        clusters.append(cluster)

    def snapshot(router):
        return ([_ep(b) for b in router.backends()], [_ep(router.route(k)) for k in keys],
                router.view_changes, [(_ep(c.endpoint), c.status.name) for c in router.last_down])

    assert snapshot(routers[1]) == snapshot(routers[0])
    for (cid, jax_changes), (_, port_changes) in zip(_events(JAX, steps), _events(PORT, steps)):
        for cluster, pkg, changes in ((clusters[0], JAX, jax_changes),
                                      (clusters[1], PORT, port_changes)):
            for callback in cluster.subscriptions[pkg[0].ClusterEvents.VIEW_CHANGE]:
                callback(cid, changes)
        assert snapshot(routers[1]) == snapshot(routers[0])


def test_router_with_no_backends_routes_nowhere():
    for pkg in (JAX, PORT):
        me = pkg[2].Endpoint(b"h", 1)
        assert pkg[3](_Cluster([me]), me).route(b"key") is None


def test_event_copies_match():
    assert [e.name for e in pev.ClusterEvents] == [e.name for e in jev.ClusterEvents]
    assert [e.value for e in pev.ClusterEvents] == [e.value for e in jev.ClusterEvents]
    change = pev.NodeStatusChange(pt.Endpoint(b"10.0.0.1", 5), pt.EdgeStatus.UP,
                                  (("capacity", b"3"),))
    want = jev.NodeStatusChange(jt.Endpoint(b"10.0.0.1", 5), jt.EdgeStatus.UP,
                                (("capacity", b"3"),))
    assert str(change) == str(want)


def test_placement_package_exports_what_jax_exports():
    assert sorted(ppl.__all__) == sorted(jpl.__all__)
    assert all(hasattr(ppl, name) for name in jpl.__all__)
