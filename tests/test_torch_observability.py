"""The port's telemetry plane against the JAX package's.

The unit calls of tests/test_observability.py run on both packages' classes
(each case parametrised by package), the exporters reproduce the JAX
package's golden files byte for byte, and the two simulators, driven
through a crash, a leave and a join alike, record the same counters,
gauges, stable-view histograms (buckets and sums), span names with their
virtual extents, and flight-recorder kinds with their configuration ids.
"""

import gc
import json
import pathlib
import threading

import numpy as np
import pytest

import rapid_tpu.observability as jax_obs
import rapid_tpu_torch.observability as port_obs
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxConfig
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.sim.engine import SimConfig

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

GOLDEN = pathlib.Path(__file__).parent / "golden"

both = pytest.mark.parametrize("obs", [jax_obs, port_obs], ids=["jax", "port"])


@both
def test_metrics_counters(obs):
    m = obs.Metrics()
    m.incr("a")
    m.incr("a", 2)
    assert m.get("a") == 3
    assert m.get("missing") == 0
    assert m.snapshot() == {"a": 3}
    m.reset()
    assert m.snapshot() == {}


@both
def test_labeled_counters_and_summed_get(obs):
    m = obs.Metrics()
    m.incr("x", at="egress")
    m.incr("x", 2, at="ingress")
    assert m.get("x", at="egress") == 1
    assert m.get("x", at="ingress") == 2
    assert m.get("x") == 3
    assert m.snapshot() == {"x{at=egress}": 1, "x{at=ingress}": 2}


@both
def test_metrics_thread_safety(obs):
    m = obs.Metrics()
    n_threads, n_iters = 8, 500

    def worker():
        for _ in range(n_iters):
            m.incr("a")
            m.observe("h", 1.0)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert m.get("a") == n_threads * n_iters
    assert m.histograms()["h"]["count"] == n_threads * n_iters


@both
def test_histogram_bucket_edges_are_le_inclusive(obs):
    h = obs.Histogram((1, 2, 10_000))
    for v in (1, 1.0, 2, 2.5, 10_000, 10_001):
        h.observe(v)
    assert h.counts == [2, 1, 2, 1]
    assert h.count == 6
    assert h.sum == 1 + 1.0 + 2 + 2.5 + 10_000 + 10_001
    assert h.snapshot()["buckets"] == [1, 2, 10_000]


@both
def test_registry_attach_collect_and_absorb(obs):
    parent = obs.Metrics()
    child = obs.Metrics(parent=parent, node="n1")
    child.incr("proposals")
    child.observe("h", 5.0)
    samples = {
        (kind, name, tuple(sorted(labels.items())))
        for kind, name, labels, _ in parent.collect()
    }
    assert ("counter", "proposals", (("node", "n1"),)) in samples
    assert parent.get("proposals") == 0
    del child
    gc.collect()
    assert parent.get("proposals") == 1
    text = obs.prometheus_text(parent)
    assert 'rapid_proposals_total{node="n1"} 1' in text
    assert 'rapid_h_count{node="n1"} 1' in text


@both
def test_tracer_spans_summary_ring_and_tree(obs):
    t = obs.Tracer()
    with t.span("phase", virtual_ms=5, rounds=2):
        pass
    with t.span("phase"):
        pass
    assert t.summary()["phase"]["count"] == 2
    assert t.spans[0].attrs == {"rounds": 2}

    ring = obs.Tracer(max_spans=5)
    for i in range(8):
        ring.event(f"e{i}")
    assert [s.name for s in ring.spans] == ["e3", "e4", "e5", "e6", "e7"]
    assert ring.dropped == 3
    ring.reset()
    assert ring.spans == [] and ring.dropped == 0

    tree = obs.Tracer()
    with tree.span("outer") as outer:
        with tree.span("inner") as inner:
            leaf = tree.event("leaf")
    assert inner.parent_id == outer.span_id and leaf.parent_id == inner.span_id
    by_parent = tree.span_tree()
    assert [s.name for s in by_parent[None]] == ["outer"]
    assert [s.name for s in by_parent[inner.span_id]] == ["leaf"]


@both
def test_child_tracer_spans_absorbed_on_gc(obs):
    root = obs.Tracer(plane="global", track="global")
    child = obs.Tracer(parent=root, plane="protocol", track="n1")
    child.event("cut_detected")
    assert [s.name for s in root.collect_spans()] == ["cut_detected"]
    del child
    gc.collect()
    assert [s.name for s in root.collect_spans()] == ["cut_detected"]
    # the read path drained the dead child's spans into the root's own ring
    assert [s.name for s in root.spans] == ["cut_detected"]


@both
def test_stable_view_timer_phases(obs):
    m = obs.Metrics()
    timer = obs.StableViewTimer(m, "protocol", clock=lambda: 0)
    timer.view_installed(5)  # nothing detected: no-op
    assert m.histograms() == {}
    timer.detection(10)
    timer.detection(99)  # first detection sticks
    timer.decision(40)
    timer.decision(60)  # last decision wins
    timer.view_installed(70)
    hists = m.histograms()
    assert hists["latency.detection_to_decision_ms{plane=protocol}"]["sum"] == 50
    assert hists["latency.decision_to_view_ms{plane=protocol}"]["sum"] == 10
    assert hists["time_to_stable_view_ms{plane=protocol}"]["sum"] == 60
    assert hists["time_to_stable_view_ms{plane=protocol}"]["buckets"] == list(
        obs.STABLE_VIEW_BUCKETS_MS)


@both
def test_flight_recorder_ring_and_hlc(obs, tmp_path):
    from rapid_tpu_torch.forensics.hlc import HlcClock

    clock = [100]
    m = obs.Metrics()
    rec = obs.FlightRecorder(capacity=3, node="sim", clock=lambda: clock[0],
                             hlc=HlcClock(clock=lambda: clock[0]), metrics=m)
    for kind in ("fd_signal", "decision", "view_install", "fd_signal"):
        rec.record(kind, configuration_id=7)
        clock[0] += 10
    assert [e["kind"] for e in rec.tail()] == ["decision", "view_install", "fd_signal"]
    assert rec.dropped == 1 and m.get("journal.dropped_events") == 1
    assert [e["hlc"] for e in rec.tail()] == [[110, 0, 1], [120, 0, 1], [130, 0, 1]]
    path = tmp_path / "journal.jsonl"
    rec.dump(str(path))
    assert [json.loads(line)["virtual_ms"] for line in path.read_text().splitlines()] == [
        110, 120, 130]


def test_hlc_clock_matches_jax():
    from rapid_tpu.forensics.hlc import HlcClock as JaxClock
    from rapid_tpu.forensics.hlc import HlcStamp as JaxStamp
    from rapid_tpu_torch.forensics.hlc import HlcClock, HlcStamp

    now = [5]
    clocks = ((JaxClock(clock=lambda: now[0]), JaxStamp),
              (HlcClock(clock=lambda: now[0]), HlcStamp))
    for step, remote in ((0, None), (0, None), (3, (20, 4)), (0, (1, 0)), (30, None)):
        now[0] += step
        got = [(clock.now() if remote is None else clock.merge(stamp(*remote))).to_wire()
               for clock, stamp in clocks]
        assert got[0] == got[1]
    assert HlcStamp.from_wire([1, 2]) == HlcStamp(1, 2, 1)
    assert HlcStamp.from_wire("bad") is None


# -- exporter golden files ----------------------------------------------------


def _golden_metrics(obs):
    m = obs.Metrics()
    m.incr("proposals", 3)
    m.incr("nemesis_dropped", 2, at="egress", msg="ProbeMessage")
    m.set_gauge("sim.membership_size", 99, plane="sim")
    m.observe("time_to_stable_view_ms", 120, buckets=obs.STABLE_VIEW_BUCKETS_MS, plane="sim")
    m.observe("time_to_stable_view_ms", 4000, buckets=obs.STABLE_VIEW_BUCKETS_MS, plane="sim")
    return m


def _golden_tracers(obs):
    root = obs.Tracer(plane="protocol", track="node-1")
    root.spans.append(obs.Span(
        name="view_change", wall_start_s=1.0, wall_end_s=1.002,
        virtual_start_ms=100, virtual_end_ms=150, attrs={"size": 3},
        span_id=1, parent_id=None, plane="protocol", track="node-1",
    ))
    root.spans.append(obs.Span(
        name="cut_detected", wall_start_s=1.0005, wall_end_s=1.0005,
        virtual_start_ms=110, virtual_end_ms=110, attrs={},
        span_id=2, parent_id=1, plane="protocol", track="node-1",
    ))
    sim = obs.Tracer(parent=root, plane="sim", track="sim")
    sim.spans.append(obs.Span(
        name="device_rounds", wall_start_s=1.001, wall_end_s=1.01,
        virtual_start_ms=0, virtual_end_ms=500, attrs={"rounds": 5},
        span_id=3, parent_id=None, plane="sim", track="sim",
    ))
    return root, sim  # sim returned too: the attach is a weakref


def test_prometheus_export_matches_golden():
    assert port_obs.prometheus_text(_golden_metrics(port_obs)) == (
        GOLDEN / "telemetry_prometheus.txt").read_text()


def test_chrome_trace_matches_golden():
    root, _sim = _golden_tracers(port_obs)
    assert port_obs.chrome_trace(root) == json.loads(
        (GOLDEN / "telemetry_chrome_trace.json").read_text())


def test_json_snapshot_and_writers_match_jax(tmp_path):
    outs = []
    for obs in (jax_obs, port_obs):
        m = _golden_metrics(obs)
        root, _sim = _golden_tracers(obs)
        snap = obs.json_snapshot(m, root)
        obs.write_prometheus(str(tmp_path / f"{obs.__name__}.prom"), m)
        obs.write_chrome_trace(str(tmp_path / f"{obs.__name__}.json"), root)
        outs.append((json.dumps(snap, sort_keys=True),
                     (tmp_path / f"{obs.__name__}.prom").read_text(),
                     json.loads((tmp_path / f"{obs.__name__}.json").read_text())))
    # span wall times differ run to run only in the summary's totals
    assert outs[0][1:] == outs[1][1:]
    assert json.loads(outs[0][0])["counters"] == json.loads(outs[1][0])["counters"]


def test_catalogs_and_buckets_match_jax():
    for name in ("METRIC_CATALOG", "SPAN_CATALOG", "EVENT_CATALOG", "METRIC_PREFIXES",
                 "DEFAULT_LATENCY_BUCKETS_MS", "STABLE_VIEW_BUCKETS_MS",
                 "PROFILE_PHASE_BUCKETS_MS", "PARTITIONS_MOVED_BUCKETS"):
        assert getattr(port_obs, name) == getattr(jax_obs, name), name


def test_port_registry_is_its_own():
    assert port_obs.global_metrics() is not jax_obs.global_metrics()
    sim = Simulator(8, seed=1, device="cpu")
    assert any(child() is sim.metrics for child in port_obs.global_metrics()._children)
    assert any(child() is sim.tracer for child in port_obs.global_tracer()._children)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with port_obs.device_trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert prof is not None


# -- the two simulators, telemetry for telemetry -------------------------------


def _churn(sim):
    """A crash, a leave and a join, one view change each, then a two-member
    crash decided over several short dispatches."""
    sim.crash(np.array([3]))
    records = [sim.run_until_decision(max_rounds=40)]
    sim.leave(np.array([9, 21]))
    records.append(sim.run_until_decision(max_rounds=40))
    sim.request_joins(np.array([30, 31]))
    records.append(sim.run_until_decision(max_rounds=40))
    sim.crash(np.array([5, 12]))
    records.append(sim.run_until_decision(max_rounds=40, batch=4))
    return records


def _telemetry(sim):
    spans = [(s.name, s.virtual_start_ms, s.virtual_end_ms,
              {k: v for k, v in s.attrs.items() if k != "origin"})
             for s in sim.tracer.spans]
    journal = [(e["kind"], e["virtual_ms"],
                {k: v for k, v in e["detail"].items() if k != "trace_id"})
               for e in sim.recorder.tail()]
    hists = {name: (h["buckets"], h["counts"], h["sum"], h["count"])
             for name, h in sim.metrics.histograms().items()}
    return sim.metrics.snapshot(), sim.metrics.gauges(), hists, spans, journal


@pytest.mark.parametrize("speculate", [True, False])
@pytest.mark.parametrize("forensics", [False, True])
def test_simulators_record_the_same_telemetry(speculate, forensics):
    pair = (
        JaxSimulator(30, capacity=32, config=JaxConfig(capacity=32, forensics=forensics),
                     seed=4, speculate=speculate, metrics=jax_obs.Metrics()),
        Simulator(30, capacity=32, config=SimConfig(capacity=32, forensics=forensics),
                  seed=4, speculate=speculate, metrics=port_obs.Metrics(), device="cpu"),
    )
    records = [_churn(sim) for sim in pair]
    cuts = [[r.cut.tolist() for r in recs] for recs in records]
    assert cuts[1] == cuts[0] and len(cuts[1]) == 4
    jax_t, port_t = (_telemetry(sim) for sim in pair)
    assert port_t == jax_t
    counters = port_t[0]
    assert counters["view_changes"] == 4 and counters["device_dispatches"] >= 5
    assert counters["rounds"] == pair[0].metrics.get("rounds")
    hits = counters.get("speculation_hits_config_id", 0)
    assert (hits > 0) == speculate
    kinds = [kind for kind, _, _ in port_t[4]]
    assert kinds.count("view_install") == 4 and kinds.count("fd_signal") == 3
    ids = [d["configuration_id"] for kind, _, d in port_t[4] if kind == "view_install"]
    assert ids == [r.configuration_id for r in records[1]]
    for sim in pair:
        stamped = ["hlc" in e for e in sim.recorder.tail()]
        assert all(stamped) if forensics else not any(stamped)
    if forensics:
        assert ([e["hlc"] for e in pair[1].recorder.tail()]
                == [e["hlc"] for e in pair[0].recorder.tail()])
        assert pair[1].hlc.peek().to_wire() == pair[0].hlc.peek().to_wire()


def test_view_change_span_parents_onto_the_churn_episode():
    sim = Simulator(16, seed=2, device="cpu")
    sim.crash(np.array([4]))
    sim.crash(np.array([7]))
    assert sim.run_until_decision(max_rounds=40) is not None
    signals = [s for s in sim.tracer.spans if s.name == "fd_signal"]
    change = next(s for s in sim.tracer.spans if s.name == "view_change")
    assert change.parent_id == signals[0].span_id
    assert change.trace_id == signals[0].trace_id
    assert change.attrs["origin"] == "sim" and change.attrs["removed"] == 2
    installs = [e for e in sim.recorder.tail() if e["kind"] == "view_install"]
    assert installs[0]["detail"]["trace_id"] == change.trace_id
    assert sim._churn_ctx is None


def test_classic_coordinator_races_counted_alike():
    """The classic fallback's coordinator race bills one counter on both
    simulators (a blind group of 13 of 50 stalls the fast round)."""
    counts = []
    for make, config in ((JaxSimulator, JaxConfig), (Simulator, SimConfig)):
        kw = {} if make is JaxSimulator else {"device": "cpu"}
        sim = make(50, config=config(capacity=50, groups=2), seed=10, **kw)
        group_of = np.zeros(50, dtype=np.int32)
        group_of[37:] = 1
        sim.set_delivery_groups(group_of)
        sim.crash(np.array([2, 5]))
        sim.drop_broadcasts(1, np.arange(50))
        rec = sim.run_until_decision(max_rounds=64, batch=16, classic_fallback_after_rounds=8)
        counts.append((rec.via_classic_round, sim.metrics.get("classic_coordinator_races"),
                       sim.metrics.snapshot()))
    assert counts[0] == counts[1]


# -- the names the port lacked until the API drift was closed -----------------


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def _defined_here(module):
    """The public names ``module`` defines itself (its imports left out)."""
    import inspect

    return {n for n in _public(module)
            if not inspect.ismodule(getattr(module, n))
            and getattr(getattr(module, n), "__module__", module.__name__) == module.__name__}


def test_every_public_name_of_the_jax_module_exists_in_the_port():
    """The drift guard: every public name ``rapid_tpu.observability``
    defines, and every public member of its registries, tracer and
    recorder, exists in the port's copy."""
    assert sorted(_defined_here(jax_obs) - _public(port_obs)) == []
    for cls in ("Metrics", "NullMetrics", "MetricsHistory", "Tracer", "FlightRecorder",
                "Span", "TraceContext", "Histogram", "StableViewTimer"):
        missing = _public(getattr(jax_obs, cls)) - _public(getattr(port_obs, cls))
        assert sorted(missing) == [], cls


@both
def test_detach_and_get_gauge(obs):
    parent, child = obs.Metrics(), obs.Metrics()
    parent.attach(child)
    child.incr("hits", 2)
    child.set_gauge("depth", 4.5, lane="a")
    assert child.get_gauge("depth", lane="a") == 4.5
    assert child.get_gauge("depth") is None and child.get_gauge("missing") is None
    assert sum(v for kind, n, _, v in parent.collect() if n == "hits") == 2
    parent.detach(child)
    parent.detach(obs.Metrics())  # detaching a stranger is a no-op
    assert [n for _, n, _, _ in parent.collect()] == []
    assert child.get("hits") == 2


def _history_steps(obs):
    m = obs.Metrics()
    h = obs.MetricsHistory(m, interval_s=1.0, capacity=8)
    m.incr("rounds", 3)
    h.maybe_snapshot(10.0)
    m.incr("rounds", 2)
    m.set_gauge("depth", 7.0)
    h.maybe_snapshot(10.5)
    h.maybe_snapshot(11.0)
    m.observe("profile.step_ms", 2.5, plane="sim")
    h.snapshot(12.0)
    for t in range(13, 30):
        m.incr("rounds")
        h.snapshot(float(t))
    return h


def test_history_series_and_wire_match_jax():
    jax_h, port_h = _history_steps(jax_obs), _history_steps(port_obs)
    for name in ("rounds", "depth", "profile.step_ms{plane=sim}", "missing"):
        assert port_h.series(name) == jax_h.series(name), name
    assert port_h.series("rounds")[0] == (10.0, 3.0)
    lines = port_h.to_wire(5)
    assert len(lines) == 5
    assert [{k: v for k, v in s.items() if k != "seq"} for s in lines_to(port_obs, lines)] == [
        {k: v for k, v in s.items() if k != "seq"} for s in lines_to(jax_obs, jax_h.to_wire(5))]
    assert port_obs.MetricsHistory.from_wire(("not json", '{"x": 1}', lines[0])) == [
        json.loads(lines[0])]


def lines_to(obs, lines):
    return obs.MetricsHistory.from_wire(lines)


@both
def test_current_trace_context_and_inject(obs):
    tracer = obs.Tracer(track="10.0.0.1:7000")
    assert obs.current_trace_context() is None and tracer.inject() is None
    with tracer.span("outer") as outer:
        ctx = tracer.inject()
        assert ctx == obs.TraceContext(trace_id=outer.trace_id or outer.span_id,
                                       parent_span_id=outer.span_id, origin="10.0.0.1:7000")
        assert obs.current_trace_context("peer").origin == "peer"
        assert obs.current_trace_context().origin == "10.0.0.1:7000"
    assert obs.current_trace_context() is None


@both
def test_extract_and_remote_span(obs):
    sender, receiver = obs.Tracer(track="a"), obs.Tracer(track="b")

    class Msg:
        pass

    msg = Msg()
    with sender.span("send") as sent:
        obs.stamp_trace_context(msg, sender.inject())
    ctx = receiver.extract(msg)
    assert ctx is not None and ctx.parent_span_id == sent.span_id
    assert receiver.extract(Msg()) is None
    with receiver.remote_span("recv", ctx, virtual_ms=5, step=1) as got:
        assert obs.current_trace_context().parent_span_id == got.span_id
    assert got.parent_id == sent.span_id and got.trace_id == ctx.trace_id
    assert got.attrs == {"origin": "a", "step": 1} and got.virtual_start_ms == 5
    # without a context it is a plain span, parented under the ambient one
    with receiver.span("outer") as outer:
        with receiver.remote_span("local") as local:
            pass
    assert local.parent_id == outer.span_id and "origin" not in local.attrs
    assert {s.name for s in receiver.collect_spans()} == {"recv", "outer", "local"}


@pytest.mark.parametrize("forensics", [False, True])
def test_flight_recorder_hlc_now_matches_jax(forensics):
    """``hlc_now`` is None with the forensics plane off, else the clock's
    unadvanced stamp, on both simulators alike after the same churn."""
    sims = [JaxSimulator(64, config=JaxConfig(capacity=64, forensics=forensics), seed=4),
            Simulator(64, config=SimConfig(capacity=64, forensics=forensics), seed=4,
                      device="cpu")]
    stamps = []
    for sim in sims:
        sim.crash(np.array([5, 9]))
        sim.run_until_decision(max_rounds=32)
        first, again = sim.recorder.hlc_now(), sim.recorder.hlc_now()
        assert first == again  # a peek does not advance the clock
        stamps.append(None if first is None else first.to_wire())
    assert stamps[0] == stamps[1]
    assert (stamps[1] is None) == (not forensics)


@both
def test_hlc_now_survives_a_failing_clock(obs):
    class Broken:
        def peek(self):
            raise RuntimeError("clock gone")

    assert obs.FlightRecorder(hlc=Broken()).hlc_now() is None
