"""``python -m rapid_tpu_torch.cli.coverage`` (the port's counterpart of
``tools/coverage.py``): it measures ``rapid_tpu_torch`` over the tests it is
given, writes its report only where ``-o`` says, and never touches
``COVERAGE.md``, the JAX package's report."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = "tests/test_torch_gateway_reads.py::test_reads_run_in_place_when_the_loop_is_not_running"


def test_coverage_measures_the_port_where_o_says(tmp_path):
    if importlib.util.find_spec("pytest_cov") is not None:
        pytest.skip("pytest-cov is installed: the CLI execs it and writes its own report")
    jax_report = (REPO / "COVERAGE.md").read_bytes()
    report = tmp_path / "port_coverage.md"
    # without tests/conftest.py, which imports JAX, as the card runs the tests
    argv = ["-o", str(report), SMALL, "-q", "-p", "no:cacheprovider", "--noconftest",
            "-p", "torch_gate"]
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'tests'}")
    out = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.coverage", *argv],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    total = [line for line in out.stdout.splitlines() if line.startswith("coverage: ")]
    assert total == [line for line in total if line.endswith(f"-> {report}")] and len(total) == 1
    assert (REPO / "COVERAGE.md").read_bytes() == jax_report
    text = report.read_text()
    assert "| rapid_tpu_torch/messaging |" in text
    assert "rapid_tpu_torch/messaging/gateway.py" in text
    assert "| rapid_tpu/" not in text
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port_coverage.md"]


def test_without_o_the_totals_are_printed_and_nothing_written(tmp_path, capsys, monkeypatch):
    from rapid_tpu_torch.cli import coverage

    monkeypatch.chdir(tmp_path)
    source = str(REPO / "rapid_tpu_torch" / "cli" / "lintlib.py")
    monkeypatch.setitem(coverage._HITS, source, {1, 2})
    coverage._summarize({source: {1, 2, 3, 4}}, None)
    assert capsys.readouterr().out == "coverage: 2/4 lines (50.0%)\n"
    assert list(tmp_path.iterdir()) == []
