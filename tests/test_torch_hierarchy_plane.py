"""The port's hierarchy plane (``rapid_tpu_torch.hierarchy.plane`` and
``routing``) against the JAX package's, on the CPU.

``tests/test_hierarchy.py``'s ``TestPlane`` and ``TestCellRouter`` run on
each package with the same endpoints and messages, on a recording channel;
what the plane sends, installs and reports is equal. ``TestEngineIntegration``
runs through ``TwinHarness`` at 8 members (the JAX tests use 18-24): each
cell bootstrapped as its own Rapid cluster, parent seeds handed out, then a
member kill, a whole-cell loss and a leader failover, with the parent
channel both unbatched and behind the broadcaster's flush window. Every
view change, every member's composed view (cells, epochs, sizes, leaders,
fingerprint) and status digest is equal on both packages.
"""

from collections import defaultdict

import pytest

from test_torch_cluster import PACKAGES, package, twin
from test_torch_serving_engine import plain

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


class FakeChannel:
    def __init__(self):
        self.leader_sends = []  # (recipients, msg)
        self.cell_sends = []

    def send_to_leaders(self, leaders, msg):
        self.leader_sends.append((tuple(leaders), msg))
        return len(tuple(leaders))

    def send_to_cell(self, members, msg):
        self.cell_sends.append((tuple(members), msg))
        return len(tuple(members))

    def log(self):
        return [(kind, plain(to), plain(msg))
                for kind, sends in (("leaders", self.leader_sends), ("cell", self.cell_sends))
                for to, msg in sends]


class Names:
    """One package's names for a plane scenario."""

    def __init__(self, P):
        self.P = P
        self.T = P.types
        self.cells = P.hierarchy_cells
        self.parent = P.hierarchy_parent
        self.chan = FakeChannel()

    def ep(self, i):
        return self.T.Endpoint(hostname=b"10.0.0.%d" % (i // 256), port=5000 + i)

    def members(self, n=24):
        return [self.ep(i) for i in range(n)]

    def plane(self, me, cells=4, **kw):
        return self.P.hierarchy_plane.HierarchyPlane(me, channel=self.chan, cells=cells, **kw)

    def digest(self, sender, cell, config_id, size, leader, fingerprint, parent_round):
        return self.T.CellDigestMessage(sender=self.ep(sender), cell=cell,
                                        configuration_id=config_id, membership_size=size,
                                        leader=leader, fingerprint=fingerprint,
                                        parent_round=parent_round)

    def first_cell(self, cells=4):
        groups = self.cells.cell_members(self.members(), cells)
        return next(iter(sorted(groups.items())))

    def leading_plane(self, cells=4, **kw):
        cell, cellmates = self.first_cell(cells)
        plane = self.plane(self.parent.cell_leaders(cellmates, 1)[0], cells, **kw)
        plane.on_view_installed(cellmates, configuration_id=-100)
        return plane, cellmates

    def following_plane(self, cells=4):
        cell, cellmates = self.first_cell(cells)
        leader = self.parent.cell_leaders(cellmates, 1)[0]
        follower = [ep for ep in cellmates if ep != leader][0]
        plane = self.plane(follower, cells)
        plane.on_view_installed(cellmates, configuration_id=-100)
        return plane, cell, cellmates, leader


def view_of(plane):
    gv = plane.global_view
    return (sorted((c, r.epoch, r.size, r.leader, r.fingerprint) for c, r in gv.cells.items()),
            gv.fingerprint(), gv.member_count(), plane.parent_round, plane.is_leader,
            sorted(plane.status_fields().items()))


def view_install_refreshes_own_row(n):
    plane, cellmates = n.leading_plane()
    own = plane.global_view.cells[plane.my_cell]
    assert own.epoch == -100 and own.size == len(cellmates)
    assert own.leader == str(plane._my_addr) and plane.is_leader  # noqa: SLF001
    return view_of(plane)


def follower_does_not_advance_rounds(n):
    plane, *_ = n.following_plane()
    assert not plane.is_leader and plane.parent_round == 0
    return view_of(plane)


def stale_digest_from_same_leader_is_gated(n):
    plane, _ = n.leading_plane()
    other = next(c for c in range(4) if c != plane.my_cell)
    plane.handle_digest(n.digest(400, other, -1, 6, "l:1", 111, 5))
    plane.handle_digest(n.digest(400, other, -2, 9, "l:1", 222, 3))
    assert plane.global_view.cells[other].fingerprint == 111
    plane.handle_digest(n.digest(401, other, -3, 5, "l2:1", 333, 0))
    assert plane.global_view.cells[other].fingerprint == 333
    return view_of(plane)


def own_cell_row_is_never_adopted_from_the_wire(n):
    plane, cellmates = n.leading_plane()
    plane.handle_digest(n.digest(400, plane.my_cell, -999, 1, "evil:1", 666, 50))
    assert plane.global_view.cells[plane.my_cell].size == len(cellmates)
    return view_of(plane)


def follower_relays_digests_to_its_leader(n):
    plane, cell, _, leader = n.following_plane()
    other = next(c for c in range(4) if c != cell)
    msg = n.digest(400, other, -1, 6, "l:1", 1, 1)
    plane.handle_digest(msg)
    assert n.chan.leader_sends == [((leader,), msg)]
    return view_of(plane)


def tick_evicts_idle_cells_and_fans_the_removal(n):
    plane, _ = n.leading_plane(eviction_rounds=3)
    other = next(c for c in range(4) if c != plane.my_cell)
    plane.handle_digest(n.digest(400, other, -1, 6, "l:1", 1, 1))
    assert other in plane.global_view.cells
    n.chan.cell_sends.clear()
    rounds = []
    for _ in range(3):
        plane.tick()
        rounds.append(view_of(plane))
    assert other not in plane.global_view.cells
    fanned = n.chan.cell_sends[-1][1]
    assert isinstance(fanned, n.T.GlobalViewMessage) and other not in fanned.cells
    return rounds


def followers_adopt_evictions_via_absent_row_diff(n):
    plane, cell, cellmates, leader = n.following_plane()
    other = next(c for c in range(4) if c != cell)
    plane.handle_digest(n.digest(400, other, -1, 6, "l:1", 1, 1))
    assert other in plane.global_view.cells
    plane.handle_global_view(n.T.GlobalViewMessage(
        sender=leader, parent_configuration_id=1, global_fingerprint=2, cells=(cell,),
        epochs=(-100,), sizes=(len(cellmates),), leaders=(str(leader),), fingerprints=(0,),
        parent_round=4))
    assert other not in plane.global_view.cells
    return view_of(plane)


def status_fields_shape(n):
    plane, cellmates = n.leading_plane()
    fields = plane.status_fields()
    assert fields["cell_id"] == plane.my_cell and fields["cell_size"] == len(cellmates)
    assert fields["global_cells"] == (plane.my_cell,)
    assert set(fields) == {"cell_id", "cell_size", "parent_configuration_id",
                           "global_fingerprint", "global_cells", "global_epochs",
                           "global_sizes", "global_leaders"}
    return sorted(fields.items())


class RecordingBroadcaster:
    def __init__(self):
        self.recipients = None

    def broadcast(self, msg):
        return []

    def set_membership(self, recipients):
        self.recipients = list(recipients)


def set_membership_confines_to_own_cell(n):
    members = n.members(40)
    inner = RecordingBroadcaster()
    me = members[0]
    router = n.P.hierarchy_routing.CellRouter(inner, me, 4)
    router.set_membership(members)
    mine = n.cells.cell_of(me, 4)
    assert inner.recipients == [ep for ep in members if n.cells.cell_of(ep, 4) == mine]
    assert me in inner.recipients and router.my_cell == mine
    assert router.broadcast(n.T.ProbeMessage(sender=me)) == []
    return plain(inner.recipients), plain(router.cell_recipients)


UNIT_CASES = [view_install_refreshes_own_row, follower_does_not_advance_rounds,
              stale_digest_from_same_leader_is_gated, own_cell_row_is_never_adopted_from_the_wire,
              follower_relays_digests_to_its_leader, tick_evicts_idle_cells_and_fans_the_removal,
              followers_adopt_evictions_via_absent_row_diff, status_fields_shape,
              set_membership_confines_to_own_cell]


@pytest.mark.parametrize("scenario", UNIT_CASES, ids=[f.__name__ for f in UNIT_CASES])
def test_plane_unit_twin(scenario):
    outs = []
    for name in PACKAGES:
        n = Names(package(name))
        outs.append((plain(scenario(n)), n.chan.log()))
    assert outs[1] == outs[0]


# --------------------------------------------------------------------- #
# TestEngineIntegration, at 8 members
# --------------------------------------------------------------------- #


def hier_settings(cells, parent_flush_ms):
    return lambda P: P.settings.Settings(hierarchy=P.settings.HierarchySettings(
        enabled=True, cells=cells, parent_flush_ms=parent_flush_ms))


def boot_cells(h, n, cells):
    """Bootstrap each cell as its own Rapid cluster; cell -> indices."""
    by_cell = defaultdict(list)
    for i in range(n):
        by_cell[h.P.hierarchy_cells.cell_of_endpoint(h.addr(i), cells)].append(i)
    for idxs in by_cell.values():
        h.start_seed(idxs[0])
        for i in idxs[1:]:
            h.join(i, seed_index=idxs[0])
    seeds = [h.addr(idxs[0]) for idxs in by_cell.values()]
    for inst in h.instances.values():
        inst.hierarchy.seed_parent(seeds)
    return dict(by_cell)


def agreed(h, expected_cells):
    fingerprints = set()
    for inst in h.instances.values():
        gv = inst.hierarchy.global_view
        if set(gv.cells) != set(expected_cells):
            return False
        fingerprints.add(gv.fingerprint())
    return len(fingerprints) == 1


def composed(h):
    return sorted((str(ep), view_of(inst.hierarchy)) for ep, inst in h.instances.items())


def member_kill_and_whole_cell_loss(h, cells):
    by_cell = boot_cells(h, 8, cells)
    assert h.scheduler.run_until(lambda: agreed(h, by_cell), timeout_ms=600_000)
    any_plane = next(iter(h.instances.values())).hierarchy
    assert any_plane.global_view.member_count() == 8
    booted = composed(h)
    big = max(by_cell, key=lambda c: len(by_cell[c]))
    assert len(by_cell[big]) >= 3
    h.fail_nodes([h.addr(by_cell[big][-1])])
    assert h.scheduler.run_until(
        lambda: agreed(h, by_cell)
        and next(iter(h.instances.values())).hierarchy.global_view.member_count() == 7,
        timeout_ms=1_200_000), "agreement lost after a single-member kill"
    killed = composed(h)
    small = min(by_cell, key=lambda c: len(by_cell[c]))
    h.fail_nodes([h.addr(i) for i in by_cell[small]])
    remaining = set(by_cell) - {small}
    assert h.scheduler.run_until(lambda: agreed(h, remaining), timeout_ms=2_400_000)
    for c in remaining:
        alive = [i for i in by_cell[c] if h.addr(i) in h.instances]
        for i in alive:
            assert len(h.instances[h.addr(i)].get_memberlist()) == len(alive)
    statuses = sorted((str(ep), sorted((k, getattr(inst.get_cluster_status(), k))
                                       for k in ("cell_id", "cell_size", "global_fingerprint",
                                                 "global_cells", "global_sizes")))
                      for ep, inst in h.instances.items())
    return {"by_cell": sorted(by_cell.items()), "booted": booted, "killed": killed,
            "lost_cell": composed(h), "statuses": statuses}


@pytest.mark.parametrize("flush_ms", [0, 50], ids=["unbatched", "flush_window"])
def test_composed_view_member_kill_and_whole_cell_loss_twin(flush_ms):
    twin(lambda h: member_kill_and_whole_cell_loss(h, 4), seed=7,
         settings=hier_settings(4, flush_ms))


def leader_failover_is_a_non_event(h):
    by_cell = boot_cells(h, 8, 3)
    assert h.scheduler.run_until(lambda: agreed(h, by_cell), timeout_ms=600_000)
    big = max(by_cell, key=lambda c: len(by_cell[c]))
    cellmates = [h.addr(i) for i in by_cell[big]]
    leaders = h.P.hierarchy_parent.cell_leaders
    old_leader = leaders(cellmates, 1)[0]
    survivors = [ep for ep in cellmates if ep != old_leader]
    new_leader = leaders(survivors, 1)[0]
    h.fail_nodes([old_leader])

    def failed_over():
        if not agreed(h, by_cell):
            return False
        for inst in h.instances.values():
            row = inst.hierarchy.global_view.cells[big]
            if row.leader != str(new_leader) or row.size != len(survivors):
                return False
        return True

    assert h.scheduler.run_until(failed_over, timeout_ms=1_200_000)
    for c, idxs in by_cell.items():
        if c != big:
            for i in idxs:
                assert len(h.instances[h.addr(i)].get_memberlist()) == len(idxs)
    return {"old": str(old_leader), "new": str(new_leader), "composed": composed(h)}


def test_leader_failover_is_a_non_event_twin():
    twin(leader_failover_is_a_non_event, seed=11, settings=hier_settings(3, 0))


def test_kill_switch_off_has_no_plane_twin():
    def scenario(h):
        h.start_seed(0)
        inst = h.instances[h.addr(0)]
        assert inst.hierarchy is None
        status = inst.get_cluster_status()
        assert status.cell_id == 0 and status.global_cells == ()
        return status.cell_id, status.global_cells

    twin(scenario, seed=3)


def every_plane_on_each_member(h, root):
    """Every plane at once: 6 members in 2 cells, each on placement, a
    durable store (``use_durability``), serving and the hierarchy; each cell
    boots as its own cluster, serves writes, and both agree on the composed
    view."""
    placement = {"partitions": 16, "replicas": 2, "seed": 5}
    by_cell = defaultdict(list)
    for i in range(6):
        by_cell[h.P.hierarchy_cells.cell_of_endpoint(h.addr(i), 2)].append(i)

    def kw(i):
        return {"placement": placement, "serving": True,
                "durability": str(root / h.P.name / str(i))}

    for idxs in by_cell.values():
        h.start_seed(idxs[0], **kw(idxs[0]))
        for i in idxs[1:]:
            h.join(i, seed_index=idxs[0], **kw(i))
    for inst in h.instances.values():
        inst.hierarchy.seed_parent([h.addr(idxs[0]) for idxs in by_cell.values()])
    assert h.scheduler.run_until(lambda: agreed(h, by_cell), timeout_ms=600_000)
    acks = []
    for idxs in by_cell.values():
        cluster = h.instances[h.addr(idxs[0])]
        for k in range(4):
            promise = cluster.serving_put(b"k-%d" % k, b"v-%d" % k)
            assert h.scheduler.run_until(promise.done)
            got = cluster.serving_get(b"k-%d" % k)
            assert h.scheduler.run_until(got.done)
            acks.append((promise.peek().status, got.peek().status, got.peek().value))
    assert all(ack == (0, 0, b"v-%d" % (i % 4)) for i, ack in enumerate(acks)), acks
    return sorted(by_cell.items()), acks, composed(h), [
        inst.get_partition_store().durability_stats()["appends"]
        for _ep, inst in sorted(h.instances.items(), key=lambda kv: str(kv[0]))]


def test_every_plane_on_each_member_twin(tmp_path):
    def settings(P):
        return P.settings.Settings(
            hierarchy=P.settings.HierarchySettings(enabled=True, cells=2, parent_flush_ms=0),
            durability=P.settings.DurabilitySettings(enabled=True, fsync_policy=0))
    twin(lambda h: every_plane_on_each_member(h, tmp_path), seed=9, settings=settings)
