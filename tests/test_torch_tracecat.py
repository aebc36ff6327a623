"""Twins of ``tests/test_tracing.py``'s tracecat contract for the port's
``rapid_tpu_torch.cli.tracecat``: the port's per-node Chrome traces of one
churn episode, merged by both tools, give byte-equal files, stdout and exit
codes, and the merged file holds the episode across both processes."""

import json

import pytest

from rapid_tpu_torch.cli import tracecat as port_tracecat
from rapid_tpu_torch.harness import ClusterHarness
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.observability import chrome_trace
from tools import tracecat as jax_tracecat

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


@pytest.fixture(scope="module")
def churn():
    """``tests/test_tracing.py``'s ``_staggered_churn_cluster`` on the port:
    three members; node 0 detects the victim alone, node 1 adopts node 0's
    churn trace from the alert batch before its own detector fires, and the
    cut rides the classic fallback. The two survivors' Chrome traces and
    the adopted trace id."""
    h = ClusterHarness(seed=7, use_static_fd=False)
    try:
        bl0, bl1 = set(), set()
        h.start_seed(0, fd=StaticFailureDetectorFactory(bl0))
        h.join(1, fd=StaticFailureDetectorFactory(bl1))
        h.join(2, fd=StaticFailureDetectorFactory(set()))
        h.wait_and_verify_agreement(3)
        victim = h.addr(2)
        svc0 = h.instances[h.addr(0)]._membership_service
        svc1 = h.instances[h.addr(1)]._membership_service
        h.instances.pop(victim).shutdown()
        bl0.add(victim)
        assert h.scheduler.run_until(lambda: svc1._churn_ctx is not None, timeout_ms=600_000)
        adopted = svc1._churn_ctx
        bl1.add(victim)
        h.wait_and_verify_agreement(2, timeout_ms=1_200_000)
        yield [chrome_trace(svc0.tracer), chrome_trace(svc1.tracer)], adopted.trace_id
    finally:
        h.shutdown()


def test_merge_traces_is_equal_and_spans_both_processes(churn):
    traces, trace_id = churn
    merged = [tool.merge_traces(traces, labels=["node0", "node1"], trace_id=trace_id)
              for tool in (jax_tracecat, port_tracecat)]
    assert json.dumps(merged[0]) == json.dumps(merged[1])
    events = [e for e in merged[1]["traceEvents"] if e.get("ph") == "X" and e.get("pid") != 1]
    assert events and all(e["args"]["trace_id"] == trace_id for e in events)
    pids = {e["pid"] for e in events}
    assert len(pids) >= 2, "the churn trace stayed within one process"
    names_of = lambda pid: {e["name"] for e in events if e["pid"] == pid}  # noqa: E731
    assert len([p for p in pids if "view_change" in names_of(p)]) >= 2
    assert any("fd_signal" in names_of(p) for p in pids)
    process_names = {e["args"]["name"] for e in merged[1]["traceEvents"]
                     if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"node0/protocol", "node1/protocol"} <= process_names
    virtual = [e for e in merged[1]["traceEvents"] if e.get("ph") == "M"
               and e.get("args", {}).get("name") == port_tracecat.VIRTUAL_PROCESS_NAME]
    assert len(virtual) == 1  # one shared virtual-time process


@pytest.mark.parametrize("with_trace_id", [True, False], ids=["trace-id", "whole"])
def test_cli_output_file_is_byte_equal(churn, tmp_path, capsys, with_trace_id):
    traces, trace_id = churn
    inputs = [tmp_path / "n0.json", tmp_path / "n1.json"]
    for path, doc in zip(inputs, traces):
        path.write_text(json.dumps(doc))
    extra = ["--trace-id", str(trace_id)] if with_trace_id else []
    outs = []
    for name, tool in (("jax", jax_tracecat), ("port", port_tracecat)):
        out = tmp_path / f"{name}.json"
        rc = tool.main([*map(str, inputs), "-o", str(out), *extra])
        captured = capsys.readouterr()
        outs.append((rc, captured.out, captured.err, out.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0
    merged = json.loads(outs[1][3])
    assert len({e["pid"] for e in merged["traceEvents"]
                if e.get("ph") == "X" and e.get("pid") != 1}) >= 2


def test_cli_stdout_is_byte_equal(churn, tmp_path, capsys):
    traces, _ = churn
    inputs = [tmp_path / "a.json", tmp_path / "b.json"]
    for path, doc in zip(inputs, traces):
        path.write_text(json.dumps(doc))
    outs = []
    for tool in (jax_tracecat, port_tracecat):
        rc = tool.main(list(map(str, inputs)))
        captured = capsys.readouterr()
        outs.append((rc, captured.out, captured.err))
    assert outs[0] == outs[1] and outs[1][0] == 0
    assert json.loads(outs[1][1])["traceEvents"]
