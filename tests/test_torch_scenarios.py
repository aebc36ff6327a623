"""The port's scenario battery (``rapid_tpu_torch.cli.scenarios``) against
``scenarios.py``'s: the simulation-plane scenarios.

The same scenario functions run on both packages with the same seeds, at
parity sizes of at most 1k members, the port's simulators on
``device="cpu"``. Each record, as the CLI prints it (JSON), equals the JAX
package's in every field but ``wall_s``, exactly. No record is held by cut
and configuration id alone: the crashes, revivals and joins are set
outright, a one-way partition is a fixed probe-drop mask, the WAN and
nemesis plans compile to such masks and delivery delays, the serving
workloads draw from seeded numpy generators, and random ingress loss, where
a scenario set it, would draw JAX's own threefry bits from the state's key
(``tests/test_torch_threefry.py``).

Beside them: ``--list`` line for line against ``python scenarios.py
--list`` and without torch, the registry's functions and parameters, the
CLI's own output and telemetry files, the smoke's zone-churn run reporting
the registry's record, the device contract, and an AST check that no
module of the port, and not ``chip_smoke.py``, imports JAX or the JAX
package. The protocol-plane scenarios and the corpus plans are in
``tests/test_torch_scenarios_protocol.py``.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import scenarios as jax_scenarios
from rapid_tpu_torch.cli import scenarios as port_scenarios

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path runs these scenarios as thousands of small ops;
    beside other test workers, intra-op threads wait on each other (the WAN
    replay took 58 s against 2.4 s on one thread on a loaded 8-core host),
    so the module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = pathlib.Path(__file__).resolve().parents[1]


def record(result):
    """A scenario's record as the CLI prints it, without ``wall_s``."""
    doc = json.loads(json.dumps(result))
    doc.pop("wall_s")
    return doc


def twins(fn_name, **params):
    """``fn_name(**params)`` on both packages: (JAX's record, the port's)."""
    jax_rec = getattr(jax_scenarios, fn_name)(**params)
    port_rec = getattr(port_scenarios, fn_name)(**params, device="cpu")
    return record(jax_rec), record(port_rec)


# (scenario function, parameters): the simulation-plane scenarios at parity
# sizes; the registry's own where they are at most 1k members
SIM_CASES = {
    "crash": ("scenario_crash", dict(n=1000, n_fail=10, seed=100,
                                     label="1k virtual nodes, 1% crash burst")),
    "crash-cells-4": ("scenario_crash", dict(n=1000, n_fail=10, seed=200, cells=4,
                                             label="1k virtual nodes, 4 cells")),
    "one-way-loss": ("scenario_one_way_loss", dict(n=1000, n_fail=10, seed=300)),
    "flip-flop-join": ("scenario_flip_flop_with_join_wave",
                       dict(n=1000, capacity=1010, seed=400)),
    "nemesis-smoke": ("scenario_nemesis_smoke", dict(n=1000, seed=7)),
    "wan-zone-loss": ("scenario_wan_zone_loss", dict(seed=11)),
    "hierarchy-zone-churn": ("scenario_hierarchy_zone_churn",
                             dict(seed=19, zones=8, per_zone=128)),
    "cross-plane-10": ("scenario_10_node_cross_plane", dict(seed=1)),
    "serving-sawtooth": ("scenario_serving_sawtooth", dict(seed=31)),
    "overload-recover": ("scenario_overload_recover", dict(seed=43)),
}

# the checks each record carries; a twin that passed with one false would
# hold the port to a failing scenario
CHECKS = ("cut_ok", "config_id_ok", "config_id_parity", "fingerprint_ok",
          "cell_evicted_ok", "parent_rounds_ok", "metastable_recovery_ok")


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_scenario_record_equals_jax(case):
    fn_name, params = SIM_CASES[case]
    want, got = twins(fn_name, **params)
    assert got == want
    for check in CHECKS:
        assert got.get(check, True) is True, (check, got)
    assert got.get("hierarchy", {}).get("fingerprint_ok", True) is True
    assert got.get("lost_acked_writes", 0) == 0


def test_registry_scenario_crash_1k_through_run_scenario():
    want = record(jax_scenarios.run_scenario("crash-1k"))
    got = record(port_scenarios.run_scenario("crash-1k", device="cpu"))
    assert got == want
    assert got["scenario"] == "crash-1k" and got["cut_ok"] and got["config_id_ok"]


def test_cli_prints_the_record(capsys):
    assert port_scenarios.main(["--scenario", "crash-1k", "--seed", "101",
                                "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    want = record(jax_scenarios.run_scenario("crash-1k", seed=101))
    assert record(json.loads(lines[0])) == want


def test_cli_writes_telemetry(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    assert port_scenarios.main(["--scenario", "cross-plane-10", "--device", "cpu",
                                "--trace-out", str(trace),
                                "--metrics-out", str(metrics)]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [sorted(line) for line in lines[1:]] == [["trace_out"], ["metrics_out"]]
    assert json.loads(trace.read_text())["traceEvents"]
    assert "# TYPE" in metrics.read_text()


def test_unknown_scenario_names_the_known_ones():
    with pytest.raises(SystemExit, match="unknown scenario 'no-such'; known: cross-plane-10"):
        port_scenarios.main(["--scenario", "no-such", "--device", "cpu"])


def test_simulator_scenarios_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is that card")
    with pytest.raises(RuntimeError):
        port_scenarios.run_scenario("crash-1k")


# --------------------------------------------------------------------- #
# The registry and --list
# --------------------------------------------------------------------- #

def _list(argv):
    out = subprocess.run([sys.executable, *argv, "--list"], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    return [json.loads(line) for line in out.splitlines()]


def test_list_equals_jax_line_for_line():
    want = _list(["scenarios.py"])
    got = _list(["-m", "rapid_tpu_torch.cli.scenarios"])
    assert len(got) == len(want) == len(jax_scenarios.REGISTRY)
    for g, w in zip(got, want):
        if "path" in w:  # a corpus plan: the same file, however it is named
            assert pathlib.Path(g.pop("path")).resolve() == \
                (REPO / w.pop("path")).resolve()
        assert g == w


def test_list_imports_neither_torch_nor_jax():
    code = ("import sys; from rapid_tpu_torch.cli.scenarios import main; main(['--list']); "
            "print(json.dumps(sorted(m for m in ('torch', 'jax', 'rapid_tpu') "
            "if m in sys.modules)))")
    out = subprocess.run([sys.executable, "-c", "import json; " + code], cwd=REPO,
                         check=True, capture_output=True, text=True).stdout
    assert json.loads(out.splitlines()[-1]) == []


def test_registry_battery_and_scale_sets_equal_jax():
    assert list(port_scenarios.REGISTRY) == list(jax_scenarios.REGISTRY)
    assert port_scenarios.BATTERY == jax_scenarios.BATTERY
    assert port_scenarios.SCALE_1M == jax_scenarios.SCALE_1M
    for name, (fn, params) in jax_scenarios.REGISTRY.items():
        port_fn, port_params = port_scenarios.REGISTRY[name]
        assert port_fn.__name__ == fn.__name__
        if "path" in params:
            assert pathlib.Path(port_params["path"]).resolve() == \
                pathlib.Path(params["path"]).resolve()
        else:
            assert port_params == params


SCENARIO_FUNCTIONS = sorted(
    name for name in dir(jax_scenarios) if name.startswith("scenario_"))


@pytest.mark.parametrize("name", SCENARIO_FUNCTIONS)
def test_scenario_function_keeps_jax_parameters(name):
    """Each scenario function under JAX's name, with JAX's parameters and
    defaults; those that build a simulator add ``device=None`` last."""
    import inspect

    want = inspect.signature(getattr(jax_scenarios, name)).parameters
    got = dict(inspect.signature(getattr(port_scenarios, name)).parameters)
    device = got.pop("device", None)
    assert [(p.name, p.default) for p in got.values()] == \
        [(p.name, p.default) for p in want.values()]
    host_only = {"scenario_nemesis_protocol", "scenario_gray_flapping",
                 "scenario_clock_skew", "scenario_rolling_upgrade",
                 "scenario_rolling_restart"}
    assert (device is None) == (name in host_only)
    if device is not None:
        assert device.default is None


# --------------------------------------------------------------------- #
# chip_smoke.py's zone churn reports the registry's record
# --------------------------------------------------------------------- #

def test_smoke_zone_churn_run_reports_the_scenario_record():
    """The smoke's planes phase drives hierarchy-zone-churn once, through
    ``zone_churn_run``; with ``result=`` it hands back the registry
    scenario's record, so the scenarios phase does not run it again."""
    import chip_smoke
    from rapid_tpu_torch.hierarchy.parent import cell_leaders
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig
    from rapid_tpu_torch.sim.topology import LatencyTopology
    from rapid_tpu_torch.types import Endpoint

    run = chip_smoke.zone_churn_run(
        Simulator, SimConfig, LatencyTopology, Endpoint, cell_leaders,
        seed=19, zones=8, per_zone=128, device="cpu",
        result=port_scenarios.zone_churn_result)
    want = record(port_scenarios.run_scenario("hierarchy-zone-churn", device="cpu",
                                              per_zone=128))
    assert record(run["scenario"]) == want


# --------------------------------------------------------------------- #
# The port stands alone: no JAX, nothing of the JAX package
# --------------------------------------------------------------------- #

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


PORT_FILES = sorted((REPO / "rapid_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "rapid_tpu")]
    assert bad == []
