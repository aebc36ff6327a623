"""The port's ``slo`` CLI (``rapid_tpu_torch/cli/slo.py``) against
``tools/slo.py``.

The case of ``tests/test_slo.py::test_tools_slo_renders_burning_and_ok_lines``
and its neighbours are built as the same ``ClusterStatusResponse``s in both
packages; each module's ``fetch_status`` is monkeypatched to answer with
them, and both ``main``s run with the same argv (plain and ``--json``):
stdout, stderr and the exit code are equal. The cases hold a firing alert
attributed to a view-change episode (rc 3), one whose episode is not in
the journal, one attributed to nothing, healthy alerts and a member with
the SLO plane off (rc 0), and an unreachable member (rc 1). The live twin,
both CLIs polling port members over real sockets, is in
``test_torch_statusz.py``."""

import json

import pytest
from test_torch_statusz import UNREACHABLE, load_tool, run_main

import rapid_tpu.types as rtypes
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.cli import slo as port_slo

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

jax_slo = load_tool("slo")

JOURNAL = tuple(json.dumps(e) for e in [
    {"kind": "fd_signal", "virtual_ms": 50, "detail": {"trace_id": 7}},
    {"kind": "view_install", "virtual_ms": 120, "node": "n0",
     "detail": {"trace_id": 7, "removed": 3, "configuration_id": 2}},
    {"kind": "placement_rebalance", "virtual_ms": 110,
     "detail": {"configuration_id": 2, "moved": 41}},
])
NAMES = ("serving.latency:fast", "serving.availability:fast")


def alerts(burn, firing, trace, journal=JOURNAL, names=NAMES):
    return dict(configuration_id=11, membership_size=3, journal=journal, slo_names=names,
                slo_burn_milli=burn, slo_firing=firing, slo_attributed_trace=trace)


# case -> [(target, (sender port, fields) | UNREACHABLE)], the rc JAX gives
CASES = {
    # tests/test_slo.py::test_tools_slo_renders_burning_and_ok_lines
    "firing_attributed": ([("h:1", (1, alerts((42_100, 150), (1, 0), (7, 0))))], 3),
    "firing_episode_not_in_journal": ([("h:1", (1, alerts((42_100, 150), (1, 0), (99, 0))))],
                                      3),
    "firing_unattributed": ([("h:1", (1, alerts((150, 9_900), (0, 1), (0, 0))))], 3),
    "all_ok": ([("h:1", (1, alerts((150, 900), (0, 0), (0, 0)))),
                ("h:2", (2, alerts((10, 0), (0, 0), (0, 0), journal=())))], 0),
    "slo_plane_off": ([("h:1", (1, dict(configuration_id=11, membership_size=3)))], 0),
    "an_unknown_slo_name": ([("h:1", (1, alerts((1500,), (1,), (0,),
                                                names=("custom.slo:slow",))))], 3),
    "unreachable_member": ([("h:1", (1, alerts((150, 900), (0, 0), (0, 0)))),
                            ("h:9", UNREACHABLE)], 1),
    "unreachable_and_firing": ([("h:9", UNREACHABLE),
                                ("h:1", (1, alerts((42_100, 150), (1, 0), (7, 0)))),
                                ("h:2", (2, alerts((42_100, 150), (1, 1), (7, 0))))], 3),
}
ARGVS = {"plain": [], "json": ["--json"]}


def replies(case, T):
    return {target: spec if spec == UNREACHABLE else
            T.ClusterStatusResponse(sender=T.Endpoint.from_parts("h", spec[0]), **spec[1])
            for target, spec in CASES[case][0]}


@pytest.mark.parametrize("argv", ARGVS, ids=list(ARGVS))
@pytest.mark.parametrize("case", CASES)
def test_slo_twin(case, argv, monkeypatch, capsys):
    args = ARGVS[argv] + [target for target, _ in CASES[case][0]]
    want = run_main(jax_slo, args, replies(case, rtypes), monkeypatch, capsys)
    got = run_main(port_slo, args, replies(case, ptypes), monkeypatch, capsys)
    assert got == want
    assert want[0] == CASES[case][1]
    if case == "firing_attributed" and argv == "plain":
        assert ("SLO burning: p99 latency (serving.latency:fast, burn 42.1x), attributed to "
                "view-change episode 7 (3 nodes evicted, 41 partitions moved)") in want[1]


@pytest.mark.parametrize("case", CASES)
def test_render_slo_and_to_json_twin(case):
    for target, spec in CASES[case][0]:
        if spec == UNREACHABLE:
            continue
        jax_status, port_status = replies(case, rtypes)[target], replies(case, ptypes)[target]
        assert port_slo.render_slo(port_status) == jax_slo.render_slo(jax_status)
        assert port_slo.to_json(port_status) == jax_slo.to_json(jax_status)
    assert port_slo.SLO_LABELS == jax_slo.SLO_LABELS
