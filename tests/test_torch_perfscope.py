"""Twins of ``tests/test_profiling.py``'s perfscope contract for the port's
``rapid_tpu_torch.cli.perfscope``: the same input goes to both tools, and
their stdout, stderr, exit code and written files must be byte-equal.
``render`` reads the port's own ``json_snapshot`` of a profiled
``Simulator(512, seed=3)`` on the CPU, ``check`` synthetic bench lines
(rc 0, 3 and 2), ``diff`` a regression (rc 3) and ``trend`` the repo's
``BENCH_r*.json`` (read only)."""

import json
import pathlib

import numpy as np
import pytest

from rapid_tpu_torch.cli import perfscope as port_perfscope
from rapid_tpu_torch.observability import Metrics, json_snapshot
from rapid_tpu_torch.profiling import DEVICE_PHASES
from rapid_tpu_torch.settings import ProfilingSettings
from rapid_tpu_torch.sim.driver import Simulator
from tools import perfscope as jax_perfscope

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = pathlib.Path(__file__).resolve().parents[1]


def both(capsys, argv):
    """(rc, stdout, stderr) of each tool on ``argv``: JAX's, then the port's."""
    out = []
    for tool in (jax_perfscope, port_perfscope):
        rc = tool.main(list(argv))
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


@pytest.fixture(scope="module")
def snapshot_file(tmp_path_factory):
    """The port's ``json_snapshot`` of a profiled decision: 512 members,
    seed 3, a crash of 5, every dispatch sampled."""
    sim = Simulator(512, seed=3, metrics=Metrics(), device="cpu").ready()
    prof = sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    sim.crash(np.random.default_rng(3).choice(512, 5, replace=False))
    assert sim.run_until_decision() is not None
    assert prof.attribution()["host_transfer"] > 0
    path = tmp_path_factory.mktemp("perfscope") / "metrics.json"
    path.write_text(json.dumps(json_snapshot(sim.metrics)))
    return path


def test_render_of_the_ports_snapshot_is_byte_equal(snapshot_file, tmp_path, capsys):
    traces = [tmp_path / "jax_trace.json", tmp_path / "port_trace.json"]
    out = []
    for tool, trace in zip((jax_perfscope, port_perfscope), traces):
        rc = tool.main(["render", str(snapshot_file), "--trace-out", str(trace)])
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err.replace(str(trace), "<trace>")))
    assert out[0] == out[1]
    rc, text, _ = out[1]
    assert rc == 0
    for phase in (*DEVICE_PHASES, "host_transfer"):
        assert phase in text
    assert "device step" in text
    assert traces[0].read_bytes() == traces[1].read_bytes()
    events = json.loads(traces[1].read_text())["traceEvents"]
    assert [e["name"] for e in events] == [*DEVICE_PHASES, "host_transfer"]


def test_render_of_an_empty_snapshot_is_byte_equal(tmp_path, capsys):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(json_snapshot(Metrics())))
    jax_out, port_out = both(capsys, ["render", str(empty)])
    assert jax_out == port_out and port_out[0] == 2


def _check_artifact() -> dict:
    """``tests/test_profiling.py``'s healthy bench artifact: every
    DIMENSION_BUDGETS path present."""
    return {
        "metric": "decision_wall_ms", "value": 1200.0,
        "serving_qps": {
            "steady": {"p99_ms": 4.0},
            "lost_acked_writes": 0,
            "throughput_qps": 550.0,
            "slo": {
                "serving.availability": {"availability": 1.0, "goodput_ratio": 1.0},
                "serving.latency": {"alerts": {"fast": {"firing": False}}},
            },
        },
        "messaging_throughput": {"broadcast_storm": {"messages_per_s": 9000.0}},
        "gray_detection_ms": {
            "gray_slow_node": {"speedup": 4.2},
            "gray_flapping": {"speedup": 2.4},
        },
        "hierarchy_scale": {
            "member_ceiling_ratio": 10.0,
            "agreement_virtual_ms": 2200.0,
            "hierarchical": {"parent_rounds": 3},
        },
    }


def _breached() -> dict:
    doc = _check_artifact()
    doc["serving_qps"]["lost_acked_writes"] = 3
    doc["serving_qps"]["steady"]["p99_ms"] = 80.0
    doc["gray_detection_ms"]["gray_flapping"]["speedup"] = 1.1
    return doc


@pytest.mark.parametrize("name,doc,rc", [
    ("good", _check_artifact(), 0),
    ("breached", _breached(), 3),
    ("outage", {"metric": "m", "error": "boom"}, 2),
])
def test_check_is_byte_equal(name, doc, rc, tmp_path, capsys):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(doc))
    jax_out, port_out = both(capsys, ["check", str(path)])
    assert jax_out == port_out
    assert port_out[0] == rc


def test_check_headline_budget_is_byte_equal(tmp_path, capsys):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(_check_artifact()))
    jax_out, port_out = both(capsys, ["check", str(path), "--budget-ms", "1000"])
    assert jax_out == port_out and port_out[0] == 3


def test_budget_table_is_the_same_contract():
    assert port_perfscope.DIMENSION_BUDGETS == jax_perfscope.DIMENSION_BUDGETS
    assert port_perfscope.NORTH_STAR_BUDGET_MS == jax_perfscope.NORTH_STAR_BUDGET_MS
    assert port_perfscope.check_budgets(_breached()) == jax_perfscope.check_budgets(_breached())


@pytest.mark.parametrize("new_value,rc", [(125.0, 3), (104.0, 0)])
def test_diff_is_byte_equal(new_value, rc, tmp_path, capsys):
    old = {"metric": "m", "value": 100.0, "backend": "cpu",
           "sweep": [{"n": 64, "warmed_wall_ms": 10.0, "jit_compiles_steady": 0}]}
    new = dict(old, value=new_value,
               sweep=[{"n": 64, "warmed_wall_ms": 10.2,
                       "jit_compiles_steady": 2 if rc else 0}])
    paths = [tmp_path / "old.json", tmp_path / "new.json"]
    for path, doc in zip(paths, (old, new)):
        path.write_text(json.dumps(doc))
    jax_out, port_out = both(capsys, ["diff", *map(str, paths)])
    assert jax_out == port_out
    assert port_out[0] == rc


def test_trend_over_the_repos_bench_runs_is_byte_equal(capsys):
    runs = sorted(str(p) for p in REPO.glob("BENCH_r*.json"))
    assert runs
    jax_out, port_out = both(capsys, ["trend", *runs])
    assert jax_out == port_out
    assert port_out[0] in (0, 3)
    assert port_out[1].strip()
