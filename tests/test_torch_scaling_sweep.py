"""The port's scaling sweep (``rapid_tpu_torch.experiments.scaling_sweep``)
against ``experiments/scaling_sweep.py`` and ``bench.py``'s ``warmed_run``
on the CPU: the warmed decision's record exact at 1000 members, without the
host planes and with placement and handoff at 64 partitions; ``run_size``'s
line; and the CLI, which prints one line a size and without a card needs
``--device cpu``."""

import json

import pytest
import torch

import bench
import rapid_tpu.sim.driver as jax_driver
from experiments import scaling_sweep as jax_sweep
from rapid_tpu_torch.experiments import scaling_sweep as port_sweep

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

N, SEED, PARTITIONS = 1000, 42, 64


def _timed_jax(monkeypatch, **planes):
    """``bench.warmed_run`` and the timed simulator it made (its second)."""
    made = []

    class Recorded(jax_driver.Simulator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(jax_driver, "Simulator", Recorded)
    out = bench.warmed_run(N, seed=SEED, **planes)
    return out, made[-1]


def _outcome(record):
    return (sorted(int(c) for c in record.cut), int(record.membership_size),
            int(record.virtual_time_ms), int(record.configuration_id))


def test_warmed_run_equals_bench(monkeypatch):
    (_, want, _, _), _ = _timed_jax(monkeypatch)
    details = {}
    wall_ms, got, build_s, warm_wall = port_sweep.warmed_run(N, SEED, device="cpu",
                                                            details=details)
    assert _outcome(got) == _outcome(want)
    assert wall_ms > 0 and build_s > 0 and warm_wall > 0
    assert details["kernel_builds_steady"] == 0 and details["launches_steady"] == {}
    assert details["sim"].membership_size == N - N // 100


def test_warmed_run_with_placement_and_handoff_equals_bench(monkeypatch):
    planes = {"placement_partitions": PARTITIONS, "handoff_partitions": PARTITIONS}
    (_, want, _, _), jax_sim = _timed_jax(monkeypatch, **planes)
    details = {}
    _, got, _, _ = port_sweep.warmed_run(N, SEED, device="cpu", details=details, **planes)
    port_sim = details["sim"]
    assert _outcome(got) == _outcome(want)
    assert [d.moved for d in port_sim.placement_diffs] == \
        [d.moved for d in jax_sim.placement_diffs]
    for counter in ("handoff.sessions_started", "handoff.sessions_completed"):
        assert port_sim.metrics.get(counter) == jax_sim.metrics.get(counter) > 0


def test_run_size_line_equals_jax():
    got = port_sweep.run_size(N, SEED, device="cpu")
    want = jax_sweep.run_size(N, SEED)
    assert set(got) == set(want)
    got.pop("warmed_wall_ms"), want.pop("warmed_wall_ms")
    assert got == want == {"n": N, "fail_fraction": 0.01, "virtual_ms": 11_100,
                           "cut_ok": True}


def test_cli_prints_the_device_then_a_line_a_size(capsys):
    port_sweep.main(["--sizes", str(N), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert [json.loads(line)["n"] for line in lines[1:]] == [N]
    assert set(json.loads(lines[1])) == {"n", "fail_fraction", "warmed_wall_ms",
                                         "virtual_ms", "cut_ok"}


def test_cli_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_sweep.main(["--sizes", str(N)])
