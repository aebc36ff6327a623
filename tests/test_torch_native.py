"""The port's native host library (``rapid_tpu_torch/native.py`` over
``rapid_tpu_torch/csrc/host/rapid_native.cpp``) against ``rapid_tpu.native``
and against the port's own numpy paths, bit for bit: the batched xxHash64,
the K ring hashes, the adjacency, the configuration-id fold, a
``MembershipView`` built through ``_bulk_insert`` and
``VirtualCluster.synthesize``. Then the failure path: a build that fails
warns once with the compiler's output, records it in ``native.ERRORS`` and
leaves every wrapper returning None (the callers' numpy paths run), and
``native.CALLS`` counts the calls that reached the library. Last,
``chip_smoke.py``'s native phase on the CPU at a small size: the hashes
(``native_hashes``) and a real port member's join on each path
(``native_member_join``)."""

import random
import warnings

import numpy as np
import pytest

import chip_smoke
import rapid_tpu.native as jax_native
from rapid_tpu.membership import MembershipView as JaxView
from rapid_tpu.sim.topology import VirtualCluster as JaxCluster
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu.types import NodeId as JaxNodeId
from rapid_tpu_torch import hashing, native
from rapid_tpu_torch.membership import MembershipView
from rapid_tpu_torch.runtime import jitwatch, native_io
from rapid_tpu_torch.sim import topology
from rapid_tpu_torch.types import Endpoint, NodeId

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="g++ cannot build the host libraries here",
)

SEEDS = (0, 5, 2**31 - 1, 2**64 - 3)


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's wrappers answer None, as they do when the library is
    unavailable: every caller takes its numpy path."""
    for name in ("xxh64_batch", "ring_hashes", "build_adjacency", "config_fold"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)


def _hosts(n, seed):
    rng = random.Random(seed)
    hosts = [f"host-{i}.{rng.randrange(10**6)}.example".encode() for i in range(n)]
    ports = np.array([rng.randrange(1, 65536) for _ in range(n)], dtype=np.int64)
    return hosts, ports


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh64_batch_equals_jax_and_numpy(seed):
    rng = random.Random(3)
    samples = [bytes(rng.randrange(256) for _ in range(n)) for n in range(0, 80)]
    data, lengths = hashing.pack_hostnames(samples)
    got = native.xxh64_batch(data, lengths, seed)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jax_native.xxh64_batch(data, lengths, seed))
    assert np.array_equal(got, hashing.xxh64_batch(data, lengths, seed))
    assert got.tolist() == [hashing.xxh64(s, seed) for s in samples]


@pytest.mark.parametrize("n", [500, 1000])
def test_ring_hashes_and_adjacency_equal_jax_and_numpy(n):
    hosts, ports = _hosts(n, seed=n)
    data, lengths = hashing.pack_hostnames(hosts)
    rings = native.ring_hashes(data, lengths, ports, 10)
    assert np.array_equal(rings, jax_native.ring_hashes(data, lengths, ports, 10))
    assert np.array_equal(rings, np.stack(
        [hashing.endpoint_hash_batch(data, lengths, ports, k) for k in range(10)]))
    active = np.random.default_rng(n).random(n) < 0.8
    subjects, observers = native.build_adjacency(rings, active)
    jax_subjects, jax_observers = jax_native.build_adjacency(rings, active)
    assert np.array_equal(subjects, jax_subjects) and np.array_equal(observers, jax_observers)
    cluster = topology.VirtualCluster(
        hostnames=data, host_lengths=lengths, ports=ports,
        id_high=np.zeros(n, np.int64), id_low=np.zeros(n, np.int64), ring_hashes=rings)
    np_subjects, np_observers = topology.build_adjacency(cluster, active)
    assert np.array_equal(subjects, np_subjects) and np.array_equal(observers, np_observers)


@pytest.mark.parametrize("m", [0, 1, 7, 1000])
def test_config_fold_equals_jax_and_numpy(m, monkeypatch):
    xs = np.random.default_rng(m).integers(0, 2**64, size=m, dtype=np.uint64)
    got = native.config_fold(xs)
    assert got == jax_native.config_fold(xs)
    h = 1
    for x in xs.tolist():
        h = (h * 37 + x) & (2**64 - 1)
    assert got == hashing.to_signed(h)
    # the port's numpy fold, through topology.config_fold's fallback
    halves = [xs[i::4] for i in range(4)] if m % 4 == 0 else None
    if halves is not None:
        via_native = topology.config_fold(*halves)
        monkeypatch.setattr(native, "config_fold", lambda *a: None)
        assert topology.config_fold(*halves) == via_native


def _endpoints(n, seed):
    hosts, ports = _hosts(n, seed)
    rng = random.Random(seed + 1)
    ids = [(rng.randrange(-(2**63), 2**63), rng.randrange(-(2**63), 2**63)) for _ in range(n)]
    return list(zip(hosts, ports.tolist())), ids


@pytest.mark.parametrize("seed", [1, 2])
def test_bulk_inserted_view_equals_jax_and_numpy(seed, monkeypatch):
    """More than 256 endpoints take ``_bulk_insert``: every ring, every hash
    cache and the configuration id equal JAX's view and the port's numpy
    path's."""
    eps, ids = _endpoints(600, seed)
    before = native.CALLS["ring_hashes"]
    view = MembershipView(10, [NodeId(*i) for i in ids], [Endpoint(h, p) for h, p in eps])
    assert native.CALLS["ring_hashes"] == before + 1  # all K rings in one call
    jax_view = JaxView(10, [JaxNodeId(*i) for i in ids], [JaxEndpoint(h, p) for h, p in eps])
    monkeypatch.setattr(native, "ring_hashes", lambda *a: None)
    numpy_view = MembershipView(10, [NodeId(*i) for i in ids], [Endpoint(h, p) for h, p in eps])

    def flat(v):
        rings = [[(key, bytes(ep.hostname), ep.port) for key, ep in ring] for ring in v._rings]  # noqa: SLF001
        caches = [{(bytes(ep.hostname), ep.port): key for ep, key in c.items()}
                  for c in v._hash_cache]  # noqa: SLF001
        return rings, caches, v.get_current_configuration_id()

    assert flat(view) == flat(jax_view) == flat(numpy_view)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthesize_equals_jax_and_numpy(seed, numpy_only):
    ours = topology.VirtualCluster.synthesize(1000, 10, seed)
    theirs = JaxCluster.synthesize(1000, 10, seed)
    for field in ("hostnames", "host_lengths", "ports", "id_high", "id_low", "ring_hashes"):
        assert np.array_equal(getattr(ours, field), getattr(theirs, field)), field
    # the fold's element hashes, through xxh64_batch_auto
    assert np.array_equal(np.stack(ours.node_hashes()), np.stack(theirs.node_hashes()))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthesize_on_the_library_equals_jax(seed):
    before = dict(native.CALLS)
    ours = topology.VirtualCluster.synthesize(1000, 10, seed)
    assert native.CALLS["ring_hashes"] == before["ring_hashes"] + 1
    theirs = JaxCluster.synthesize(1000, 10, seed)
    assert np.array_equal(ours.ring_hashes, theirs.ring_hashes)
    assert np.array_equal(np.stack(ours.node_hashes()), np.stack(theirs.node_hashes()))
    assert native.CALLS["xxh64_batch"] >= before["xxh64_batch"] + 4


def test_calls_count_each_entry_point():
    before = dict(native.CALLS)
    data, lengths = hashing.pack_hostnames([b"a", b"bc"])
    hashing.xxh64_batch_auto(data, lengths)
    rings = native.ring_hashes(data, lengths, np.array([1, 2]), 3)
    native.ring_hashes(data, lengths, np.array([1, 2]), 3)
    native.build_adjacency(rings, np.ones(2, bool))
    topology.config_fold(*(np.arange(2, dtype=np.uint64),) * 4)
    assert {k: v - before[k] for k, v in native.CALLS.items()} == {
        "xxh64_batch": 1, "ring_hashes": 2, "build_adjacency": 1, "config_fold": 1}


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """A process state in which neither library was built or loaded yet,
    building into an empty directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "ERRORS", {})
    monkeypatch.setattr(native, "BUILD_WALLS", {})
    for mod in (native, native_io):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    return tmp_path


@pytest.mark.parametrize("compiler", ["false", "noisy"])
def test_failed_build_warns_with_compiler_output_and_falls_back(compiler, fresh_build,
                                                               monkeypatch):
    if compiler == "noisy":
        script = fresh_build / "cxx"
        script.write_text("#!/bin/sh\necho 'cxx: error: no toolchain here' >&2\nexit 3\n")
        script.chmod(0o755)
        compiler, said = str(script), "cxx: error: no toolchain here"
    else:
        said = "exited 1"
    monkeypatch.setenv("CXX", compiler)
    data, lengths = hashing.pack_hostnames([b"10.0.0.1", b"10.0.0.2"])
    with pytest.warns(RuntimeWarning, match="rapid_native.cpp") as caught:
        assert native.xxh64_batch(data, lengths, 0) is None
    assert len(caught) == 1 and said in str(caught[0].message)
    assert said in native.ERRORS["rapid_native"] and compiler in native.ERRORS["rapid_native"]
    before = dict(native.CALLS)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once: no second warning
        assert native.ring_hashes(data, lengths, np.array([1, 2]), 3) is None
        assert native.build_adjacency(np.zeros((3, 2), np.uint64), np.ones(2, bool)) is None
        assert native.config_fold(np.arange(3, dtype=np.uint64)) is None
        assert not native.available()
        # the callers' numpy paths give the library's answers
        want = hashing.xxh64_batch(data, lengths, 0)
        assert np.array_equal(hashing.xxh64_batch_auto(data, lengths), want)
    assert native.CALLS == before
    assert not (fresh_build / "native").exists() or not any((fresh_build / "native").glob("*.so"))
    with pytest.warns(RuntimeWarning, match="rapid_io.cpp"):
        assert not native_io.available()
    assert said in native.ERRORS["rapid_io"]
    with pytest.raises(RuntimeError, match="native reactor unavailable"):
        native_io.NativeReactor("127.0.0.1", 0)


def test_build_is_keyed_recorded_and_reused(fresh_build):
    events = len(jitwatch.compile_events())
    path = native.build()
    assert path.startswith(str(fresh_build / "native" / "rapid_native-"))
    assert native.BUILD_WALLS["rapid_native"] > 0
    if jitwatch.enabled():
        assert [(e.name, e.kind) for e in jitwatch.compile_events()[events:]] == [
            ("rapid_native.cpp", "g++")]
    assert native.build() == path  # this exact build exists: reused
    assert len(list((fresh_build / "native").iterdir())) == 1  # no temporary left
    out, cmd = native.library_path("rapid_native.cpp", ("-DUNUSED=1",))
    assert str(out) != path and "-DUNUSED=1" in cmd  # the flags key the build
    assert native.load() is not None and native.ERRORS == {}


def test_chip_smoke_native_hashes_at_a_small_size():
    """``chip_smoke.native_hashes``: every entry point equal to the numpy
    path at 2000 endpoints, and at 20 000 on a seeded sample of 1000 rows."""
    out = chip_smoke.native_hashes("cpu", n=2000, big=20_000, sample=1000, reps=1)
    assert set(out) == {f"{name} {size}" for size in (2000, 20_000) for name in (
        "synthesize", "ring_hashes", "xxh64_batch", "config_fold")}
    assert all(r["numpy_ms"] is not None for label, r in out.items() if label.endswith(" 2000"))
    assert out["ring_hashes 20000"]["checked_rows"] == 1000
    with chip_smoke.numpy_paths():
        assert native.ring_hashes(np.zeros((1, 1), np.uint8), np.ones(1), np.ones(1), 1) is None
    assert native.ring_hashes(np.zeros((1, 1), np.uint8), np.ones(1), np.ones(1), 1) is not None


def test_chip_smoke_member_join_on_each_path():
    """``chip_smoke.native_member_join`` at 1000 members on the CPU: a real
    port member's join on the native path (``native.CALLS["ring_hashes"]``
    grew) and with the native entry points patched to None reach one
    configuration id, the plain simulator's; each build split by phase."""
    native_join = chip_smoke.member_sequence(1000, "cpu", join_only=True)["pumps"][0]
    out = chip_smoke.native_member_join(1000, "cpu", "cpu", native_join,
                                        turns=("numpy", "native"))
    numpy_row, native_row = out["joins"]
    assert native_row["native_calls"]["ring_hashes"] >= 1
    assert numpy_row["native_calls"] == {}
    for row in out["joins"]:
        split = row["member_build_split"]
        assert list(split) == [label for label, *_ in chip_smoke.BUILD_PHASES]
        assert all(ms > 0 for ms in split.values()), split
        assert sum(split.values()) <= row["member_build_ms"] * 1.05 + 1.0
        assert row["configuration_id"] == native_join["plain_configuration_id"]
    views = out["views"]
    assert [r["path"] for r in views["turns"]] == list(chip_smoke.NATIVE_VIEW_TURNS)
    assert set(views["medians"]) == {"native", "numpy"}
    assert all(r["bulk_insert"] > 0 and r["configuration_id"] > 0 for r in views["turns"])
