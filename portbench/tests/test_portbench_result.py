"""The result's line: the contract's keys, then ``build_s`` and, last,
``checks``; the no-JAX check compares whole top-level names; no run loads
JAX."""

import json
import subprocess
import sys
from pathlib import Path

from portbench import harness
from portbench.run import forbidden_modules
from portbench.tests.conftest import tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def test_result_keys():
    out = harness.run_cell(tiny_cell("crash-burst"), 3, 1.0, False, lambda: 1.0, device="cpu")
    assert set(out.pop("_timings")) >= {"setup_s", "window_s", "reference_s"}
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "build_s",
                         "checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"view_changes_per_s", "setup_s"}
    for metric in out["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(out)


def test_forbidden_names_are_whole():
    names = ["rapid_tpu_torch", "rapid_tpu_torch.sim.driver", "jaxtyping", "benchmark",
             "numpy", "flaxen"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["rapid_tpu.sim"]) == ["rapid_tpu.sim"]
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax", "bench",
                              "__graft_entry__"]) == [
        "__graft_entry__", "bench", "flax", "jax", "jaxlib.xla_client"]


def test_a_run_loads_no_jax():
    """A whole run of the harness in a fresh process, on the CPU, leaves no
    forbidden module loaded."""
    code = (
        "import sys\n"
        "from portbench import harness\n"
        "from portbench.run import forbidden_modules\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "harness.run_cell(tiny_cell('lossy-burst'), 5, 0.5, False, lambda: 0.0, device='cpu')\n"
        "print(forbidden_modules(list(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    """Without a CUDA device the run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "rapid-100k.crash-burst",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_traced_slice_runs_whole_cycles(mix, monkeypatch):
    """The traced slice follows the mix's own cycle, so the membership stays
    in its band; on the CPU the profiler is stood in for by the slice alone."""
    monkeypatch.setattr(harness.tracing, "profile", lambda fn, marks, spans: fn())
    drv = harness.Driver(tiny_cell(mix, burst_fraction=0.01), 11, "cpu")
    drv.run(drv.gen.failure(), timed=False)
    drv.run(drv.gen.wave(), timed=False)
    rounds = harness._traced_slice(drv)
    assert rounds > 0 and drv.undecided == 0
    assert [ep.kind for ep in drv.log[2:]] == (
        (["failure"] * drv.gen.wave_every + ["wave"]) * harness.TRACE_CYCLES)
