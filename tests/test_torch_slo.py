"""The port's SLO plane (``rapid_tpu_torch/slo``, ``settings.SLOSettings``)
against the JAX package's, on the CPU.

A twin of scenarios.py's overload-recover at its size, stepped on both
simulators: the open-loop results, ``plane.summary``, every alert's state
and its attributed episode (trace ids compared within each run: each
package numbers its spans itself), the metastable-recovery check by the
JAX package's checker; then the pieces: the SLI tracker, histogram
quantiles, the open-loop generator's stream, the burn engine on a
synthetic stream, episode folding, the settings' bounds and the kill
switch.
"""

import dataclasses

import numpy as np
import pytest

from rapid_tpu import slo as jslo
from rapid_tpu.search.checkers import ClientOp, check_metastable_recovery
from rapid_tpu.settings import SLOSettings as JaxSLOSettings
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch import slo as pslo
from rapid_tpu_torch.settings import SETTINGS_CATALOG, SLOSettings
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _port_sim(*args, **kw):
    return Simulator(*args, device="cpu", **kw)


def _overload_recover(make, SLOSettingsCls, slo, seed=43, n=16, rate_base=400.0,
                      rate_burst=2500.0):
    """scenarios.py's scenario_overload_recover, step for step."""
    sim = make(n, seed=seed)
    sim.enable_placement(partitions=64, replicas=3)
    sim.enable_handoff(chunk_ms=1)
    sim.enable_serving()
    plane = sim.enable_slo(SLOSettingsCls(enabled=True, window_scale=0.001))
    keys = [b"ovr-%03d" % i for i in range(32)]
    for i, key in enumerate(keys):
        assert sim.serving_put(key, b"seed-%d" % i).status == 0
    results, history = [], []

    def drive(gen, n_ops):
        gen.rebase(sim.virtual_ms)
        for a, status, lat in sim.serving_drive_open_loop(gen.arrivals(n_ops)):
            results.append((a.at_ms, a.op, a.key, a.value, a.client, status, lat))
            history.append(ClientOp(
                client=f"c{a.client}", op=a.op, key=a.key, value=a.value, version=0,
                status=int(status), invoke_ms=int(a.at_ms), complete_ms=int(a.at_ms + lat)))

    base = slo.OpenLoopGenerator(rate_base, keys, put_fraction=0.2, seed=seed)
    drive(base, 480)
    false_alerts = plane.firing_count()
    faulted_from = sim.virtual_ms
    leaders = sim.placement.assign[:, 0].astype(int)
    victim = int(np.argmax(np.bincount(leaders[leaders > 0])))
    sim.crash(np.array([victim]))
    drive(slo.OpenLoopGenerator(rate_burst, keys, put_fraction=0.2, seed=seed + 1), 1200)
    fired_during_churn = plane.firing_count()
    rec = sim.run_until_decision(max_rounds=64, batch=16)
    assert rec is not None and set(int(c) for c in rec.cut) == {victim}
    healed_at = sim.virtual_ms
    drive(base, 1700)
    plane.tick(sim.virtual_ms, force=True)
    journal = sim.recorder.tail(4096)
    plane.attribute(journal)
    installs = [e for e in journal if e["kind"] == "view_install" and e["detail"].get("trace_id")]
    install_trace = int(installs[-1]["detail"]["trace_id"])
    alerts = []
    for a in plane.alerts():
        state = dataclasses.asdict(a)
        episode = state.pop("attributed")
        if episode is not None:
            assert episode["trace_id"] == install_trace  # the run's own episode
            episode["trace_id"] = "the install's"
        alerts.append((state, episode, a.name))
    check_metastable_recovery(history, faulted_from_ms=faulted_from, healed_at_ms=healed_at)
    return {
        "results": results, "summary": plane.summary(sim.virtual_ms), "alerts": alerts,
        "false_alerts": false_alerts, "fired_during_churn": fired_during_churn,
        "status_digest": plane.status_digest()[:3], "virtual_ms": sim.virtual_ms,
        "record": (rec.configuration_id, rec.virtual_time_ms),
        "metrics": {k: v for k, v in sim.metrics.snapshot().items() if k.startswith("slo.")},
        "gauges": {k: v for k, v in sim.metrics.gauges().items() if k.startswith("slo.")},
        "described": [slo.describe(a.attributed).replace(str(install_trace), "<trace>")
                      for a in plane.alerts() if a.fired_count],
    }


def test_overload_recover_twin():
    """scenarios.py's overload-recover at its size: the same results, SLO
    summary, alerts, attributions and clocks on both packages, and the
    scenario's own oracle holds on the port's run."""
    got = _overload_recover(_port_sim, SLOSettings, pslo)
    want = _overload_recover(JaxSimulator, JaxSLOSettings, jslo)
    assert got == want
    assert got["false_alerts"] == 0 and got["fired_during_churn"] > 0
    fired = [(state, episode) for state, episode, _ in got["alerts"] if state["fired_count"]]
    assert fired and all(ep is not None and ep["kind"] == "view-change" for _, ep in fired)
    assert all(not state["firing"] for state, _, name in got["alerts"] if name.endswith(":fast"))
    assert all(d.startswith("view-change episode <trace>") for d in got["described"])


def test_slo_kill_switch_and_settings_bounds():
    for make, settings_cls in ((JaxSimulator, JaxSLOSettings), (_port_sim, SLOSettings)):
        sim = make(4, seed=1)
        assert sim.enable_slo(settings_cls(enabled=False)) is None and sim.slo_plane() is None
        assert sim.enable_slo() is sim.slo_plane() is not None
    assert dataclasses.asdict(SLOSettings()) == dataclasses.asdict(JaxSLOSettings())
    for key in ("enabled", "bucket_ms", "window_scale", "max_buckets", "clear_fraction"):
        assert f"slo.{key}" in SETTINGS_CATALOG
    for bad in ({"bucket_ms": 0}, {"window_scale": 1e-9}, {"max_buckets": 8},
                {"clear_fraction": 0.05}):
        with pytest.raises(AssertionError):
            SLOSettings(**bad)


def test_catalogs_equal_jax():
    assert pslo.SLI_CATALOG == jslo.SLI_CATALOG
    assert pslo.SLO_CATALOG == jslo.SLO_CATALOG
    assert pslo.BURN_WINDOWS == jslo.BURN_WINDOWS


def test_open_loop_generator_stream_matches_jax():
    """Equal seeds give equal streams: the port draws from random.Random in
    the JAX package's order."""
    keys = [b"k%03d" % i for i in range(50)]
    for seed, rate, frac, zipf in ((0, 600.0, 0.2, 1.1), (7, 2500.0, 0.5, 0.8)):
        mine = pslo.OpenLoopGenerator(rate, keys, put_fraction=frac, seed=seed, zipf_s=zipf,
                                      clients=1000)
        theirs = jslo.OpenLoopGenerator(rate, keys, put_fraction=frac, seed=seed, zipf_s=zipf,
                                        clients=1000)
        a, b = mine.arrivals(300), theirs.arrivals(300)
        mine.rebase(10**6)
        theirs.rebase(10**6)
        a += mine.arrivals(50)
        b += theirs.arrivals(50)
        assert [dataclasses.astuple(x) for x in a] == [dataclasses.astuple(x) for x in b]


def _feed(slo, settings_cls):
    """A synthetic stream through a bare SloPlane: healthy, a burst of slow
    failures, recovery; the transitions and every window's stats."""
    plane = slo.SloPlane(settings_cls(enabled=True, window_scale=0.001, bucket_ms=50))
    rng = np.random.default_rng(3)
    transitions = []
    plane.on_transition = lambda moved: transitions.extend(
        (kind, a.name, a.fired_at_ms, a.cleared_at_ms) for kind, a in moved)
    for t in range(0, 12000, 7):
        plane.record_offered(t)
        bad = 3000 <= t < 4500 and rng.random() < 0.6
        latency = float(rng.integers(30, 200) if bad else rng.integers(0, 20))
        plane.record(t, not bad, latency)
        if t % 700 == 0:
            plane.tick(t, force=True)
    stats = plane.tracker.window(12000, 3600)
    return (transitions, plane.summary(12000), dataclasses.astuple(stats),
            stats.quantile(0.5), stats.goodput_ratio(), plane.tracker.span_ms(),
            plane.status_digest())


def test_burn_engine_and_tracker_match_jax():
    got, want = _feed(pslo, SLOSettings), _feed(jslo, JaxSLOSettings)
    assert got == want
    assert any(kind == "fired" for kind, *_ in got[0])
    assert any(kind == "cleared" for kind, *_ in got[0])


def test_histogram_quantile_and_episodes_match_jax():
    buckets = (1.0, 5.0, 25.0, 100.0)
    for counts in ([0, 0, 0, 0, 0], [5, 0, 3, 1, 0], [0, 0, 0, 0, 9], [1, 1, 1, 1, 1]):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert pslo.histogram_quantile(buckets, counts, q) == jslo.histogram_quantile(
                buckets, counts, q)
    journal = [
        {"kind": "fd_signal", "virtual_ms": 10, "detail": {"trace_id": 7}},
        {"kind": "placement_rebalance", "virtual_ms": 40,
         "detail": {"configuration_id": 99, "moved": 12}},
        {"kind": "view_install", "virtual_ms": 41,
         "detail": {"trace_id": 7, "configuration_id": 99, "removed": 2, "added": 1}},
        '{"kind": "durability_recovered", "virtual_ms": 60, "detail": {"node": "slot3"}}',
        "not json",
        {"kind": "fd_signal", "virtual_ms": 80, "detail": {"trace_id": 8}},
    ]
    mine, theirs = pslo.episodes_from_journal(journal), jslo.episodes_from_journal(journal)
    assert [dataclasses.astuple(e) for e in mine] == [dataclasses.astuple(e) for e in theirs]
    for lo, hi in ((0, 100), (45, 70), (200, 300), (10, 41)):
        a = pslo.attribute_burn(mine, lo, hi)
        b = jslo.attribute_burn(theirs, lo, hi)
        assert (a is None) == (b is None)
        assert a is None or dataclasses.astuple(a) == dataclasses.astuple(b)
        assert pslo.describe(a) == jslo.describe(b)
