"""The traffic generator: the same seed gives the same episodes, victims
are distinct and outside the waiting slots, and fresh NodeIds never repeat
one already seen."""

import numpy as np

from portbench import spec
from portbench.generator import Generator
from portbench.reference.cluster import Cluster


def _episodes(mix, seed, n=25, members=2000):
    gen = Generator(spec.traffic_by_name(mix), members, seed)
    return [gen.next() for _ in range(n)], gen


def test_same_seed_same_episodes(mix):
    a, _ = _episodes(mix, 2**31 + 7)
    b, _ = _episodes(mix, 2**31 + 7)
    c, _ = _episodes(mix, 2**31 + 8)
    assert [e.kind for e in a] == [e.kind for e in b]
    for x, y in zip(a, b):
        assert np.array_equal(x.slots, y.slots)
        assert (x.ids is None) == (y.ids is None)
        if x.ids is not None:
            assert np.array_equal(x.ids, y.ids)
    assert any(not np.array_equal(x.slots, y.slots) for x, y in zip(a, c))


def test_waves_follow_the_mix(mix):
    episodes, gen = _episodes(mix, 5, n=33)
    kinds = [e.kind for e in episodes]
    every = spec.traffic_by_name(mix)["wave_every"]
    assert kinds[:every + 1] == ["failure"] * every + ["wave"]
    waiting = set()
    for ep in episodes:
        if ep.kind == "failure":
            assert len(set(ep.slots.tolist())) == len(ep.slots) == gen.burst
            assert not waiting & set(ep.slots.tolist())
            waiting |= set(ep.slots.tolist())
        else:
            assert sorted(waiting) == ep.slots.tolist()
            waiting = set()
        assert len(waiting) <= gen.burst * gen.wave_every


def test_fresh_ids_never_collide(mix):
    members = 2000
    episodes, _ = _episodes(mix, 11, n=60, members=members)
    cluster = Cluster(members, 10, 11)
    seen = set(map(tuple, cluster.seen.tolist()))
    for ep in episodes:
        if ep.kind == "wave":
            for pair in map(tuple, ep.ids.tolist()):
                assert pair not in seen
                seen.add(pair)
