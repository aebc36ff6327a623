"""The port's ``statusz`` CLI (``rapid_tpu_torch/cli/statusz.py``) against
``tools/statusz.py``.

Every case of JAX's own statusz tests (``tests/test_serving.py``,
``test_handoff.py``, ``test_hierarchy.py``, ``test_placement.py``) and a few
more is built as the same ``ClusterStatusResponse``s in both packages; each
module's ``fetch_status`` is monkeypatched to answer with them, and both
``main``s run with the same argv (plain, ``--json``, ``--journal 0``,
``--journal 5``, ``--history 8``): stdout, stderr and the exit code are
equal. The cases hold an unreachable member (rc 1), each of the five
disagreements (rc 2) and their agreeing counterparts (rc 0). Then the live
twin: three port members in process on the port's TCP transport, polled by
both CLIs over real sockets."""

import importlib.util
import json
import re
from pathlib import Path

import pytest
from golden.scrape_fixtures import HISTORY_LINES

import rapid_tpu.types as rtypes
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.cli import statusz as port_statusz

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = Path(__file__).resolve().parents[1]


def load_tool(name):
    """``tools/<name>.py`` loaded from its file, as the JAX tests load it."""
    spec = importlib.util.spec_from_file_location(
        f"tools.{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_statusz = load_tool("statusz")

UNREACHABLE = "unreachable"

HIER = dict(cell_size=2, parent_configuration_id=777, global_cells=(0, 1),
            global_epochs=(10, 11), global_sizes=(2, 2), global_leaders=("h:1", "h:3"))

JOURNAL = tuple(json.dumps(e) for e in [
    {"kind": "fd_signal", "virtual_ms": 50, "seq": 1, "detail": {"trace_id": 7}},
    {"kind": "view_install", "virtual_ms": 120, "seq": 2, "node": "n0",
     "detail": {"trace_id": 7, "removed": 3, "configuration_id": 2}},
    {"kind": "placement_rebalance", "virtual_ms": 110, "seq": 3,
     "detail": {"configuration_id": 2, "moved": 41}},
])

RICH = dict(
    configuration_id=-6148914691236517206, membership_size=3, reports_tracked=4,
    pre_proposal_size=1, proposal_size=2, updates_in_progress=1, consensus_decided=True,
    consensus_votes=2, metric_names=("rounds", "msg.queue_depth{peer=10.0.0.2:7}",
                                     "msg.queue_depth{peer=10.0.0.3:7}"),
    metric_values=(5, 128, 4096), journal=JOURNAL, history=HISTORY_LINES,
    placement_version=3, placement_partitions=32, placement_owned=11,
    handoff_in_flight=1, handoff_completed=4, handoff_partitions=(0, 1),
    handoff_fingerprints=(10, 20), serving_gets=3, serving_puts=2, serving_put_acks=4,
    serving_partitions=(0, 1), serving_leaders=("h:1", "h:2"), durability_segments=2,
    durability_snapshot_version=9, durability_replayed=17,
    slo_names=("serving.latency:fast", "serving.availability:fast"),
    slo_burn_milli=(42_100, 150), slo_firing=(1, 0), slo_attributed_trace=(7, 0),
    fd_subjects=("h:2", "h:3", "h:4", "h:5"), fd_rtt_micros=(1500, 900, 12, 7),
    fd_suspicion_milli=(2500, 1000, 0, 0), fd_tiers=("local", "remote"),
    fd_tier_interval_ms=(100, 1000), fd_tier_threshold=(3, 5), fd_tier_flush_ms=(5, 50),
    journal_dropped=2, journal_capacity=512,
)


def m(port, **fields):
    return (port, fields)


# case -> [(target, (sender port, fields) | UNREACHABLE)], the rc JAX gives
CASES = {
    # tests/test_serving.py::test_statusz_flags_serving_leader_disagreement
    "serving_leader_split": ([
        ("h1:1", m(1, configuration_id=5, membership_size=2, serving_gets=3, serving_puts=2,
                   serving_put_acks=4, serving_partitions=(0, 1),
                   serving_leaders=("h:1", "h:2"))),
        ("h2:2", m(2, configuration_id=5, membership_size=2, serving_partitions=(1, 2),
                   serving_leaders=("h:9", "h:2")))], 2),
    "serving_leader_agree": ([
        ("h1:1", m(1, configuration_id=5, membership_size=2, serving_gets=3, serving_puts=2,
                   serving_put_acks=4, serving_partitions=(0, 1),
                   serving_leaders=("h:1", "h:2"))),
        ("h2:2", m(2, configuration_id=5, membership_size=2, serving_partitions=(1, 2),
                   serving_leaders=("h:2", "h:3")))], 0),
    # tests/test_handoff.py::test_statusz_surfaces_handoff_and_flags_divergence
    "handoff_fingerprints_torn": ([
        ("h1:1", m(1, configuration_id=5, membership_size=2, handoff_in_flight=1,
                   handoff_completed=4, handoff_partitions=(0, 1),
                   handoff_fingerprints=(10, 20))),
        ("h2:2", m(2, configuration_id=5, membership_size=2, handoff_completed=3,
                   handoff_partitions=(1, 2), handoff_fingerprints=(99, 30)))], 2),
    "handoff_fingerprints_agree": ([
        ("h1:1", m(1, configuration_id=5, membership_size=2, handoff_in_flight=1,
                   handoff_completed=4, handoff_partitions=(0, 1),
                   handoff_fingerprints=(10, 20))),
        ("h2:2", m(2, configuration_id=5, membership_size=2, handoff_partitions=(1, 2),
                   handoff_fingerprints=(20, 30)))], 0),
    # tests/test_hierarchy.py::test_statusz_flags_global_fingerprint_disagreement
    "global_view_diverged": ([
        ("h1:1", m(1, configuration_id=5, membership_size=4, cell_id=1,
                   global_fingerprint=4242, **HIER)),
        ("h2:2", m(2, configuration_id=5, membership_size=4, cell_id=0,
                   global_fingerprint=9999, **dict(HIER, global_epochs=(10, 12))))], 2),
    "global_view_agree_and_a_flat_member": ([
        ("h1:1", m(1, configuration_id=5, membership_size=4, cell_id=1,
                   global_fingerprint=4242, **HIER)),
        ("h2:2", m(2, configuration_id=5, membership_size=4, cell_id=1,
                   global_fingerprint=4242, **HIER)),
        ("h9:9", m(9, configuration_id=5, membership_size=4))], 0),
    # tests/test_hierarchy.py::test_statusz_config_disagreement_is_cell_scoped
    "config_across_cells": ([
        ("h:1", m(1, configuration_id=100, membership_size=1, cell_id=0,
                  global_fingerprint=4242, **HIER)),
        ("h:2", m(2, configuration_id=200, membership_size=1, cell_id=1,
                  global_fingerprint=4242, **HIER))], 0),
    "config_within_a_cell": ([
        ("h:1", m(1, configuration_id=100, membership_size=1, cell_id=0,
                  global_fingerprint=4242, **HIER)),
        ("h:2", m(2, configuration_id=200, membership_size=1, cell_id=0,
                  global_fingerprint=4242, **HIER))], 2),
    "config_flat": ([
        ("h:1", m(1, configuration_id=100, membership_size=1)),
        ("h:2", m(2, configuration_id=200, membership_size=1))], 2),
    # tests/test_placement.py::test_statusz_renders_placement_fields, and a
    # placement version disagreement
    "placement_and_a_placement_free_member": ([
        ("h:1", m(1, configuration_id=8, membership_size=1, placement_version=3,
                  placement_partitions=32, placement_owned=32)),
        ("h:2", m(2, configuration_id=8, membership_size=1))], 0),
    "placement_versions_differ": ([
        ("h:1", m(1, configuration_id=8, membership_size=2, placement_version=3,
                  placement_partitions=32, placement_owned=16)),
        ("h:2", m(2, configuration_id=8, membership_size=2, placement_version=4,
                  placement_partitions=32, placement_owned=16))], 2),
    # every digest line at once, a history ring, and an unreachable member
    "rich_with_history": ([("10.0.0.1:7", m(7, **RICH))], 0),
    "unreachable_member": ([
        ("10.0.0.1:7", m(7, **RICH)), ("10.0.0.9:9", UNREACHABLE),
        ("10.0.0.2:7", m(8, **RICH))], 1),
    "only_unreachable": ([("10.0.0.9:9", UNREACHABLE)], 1),
    # a journal line that is not JSON: the text view prints it as it is,
    # to_json raises in both
    "journal_line_not_json": ([
        ("h:1", m(1, configuration_id=8, membership_size=1, journal=JOURNAL + ("not json",)))],
        0),
}
ARGVS = {"plain": [], "json": ["--json"], "journal_0": ["--journal", "0"],
         "journal_5": ["--journal", "5"], "history_8": ["--history", "8"]}


def replies(case, T):
    return {target: spec if spec == UNREACHABLE else
            T.ClusterStatusResponse(sender=T.Endpoint.from_parts("h", spec[0]), **spec[1])
            for target, spec in CASES[case][0]}


def fake_fetch(answers):
    def fetch_status(client, target, timeout, include_history=0):
        answer = answers[f"{target.hostname.decode()}:{target.port}"]
        if answer == UNREACHABLE:
            raise ConnectionRefusedError("connection refused")
        assert isinstance(answer, (rtypes.ClusterStatusResponse, ptypes.ClusterStatusResponse))
        return answer
    return fetch_status


def run_main(module, argv, answers, monkeypatch, capsys):
    """``module.main(argv)``'s exit code (or what it raised), stdout and
    stderr, with ``fetch_status`` answering from ``answers``."""
    monkeypatch.setattr(module, "fetch_status", fake_fetch(answers))
    try:
        rc = module.main(argv)
    except Exception as exc:  # noqa: BLE001 -- the raise is part of the twin
        rc = (type(exc).__name__, str(exc))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", ARGVS, ids=list(ARGVS))
@pytest.mark.parametrize("case", CASES)
def test_statusz_twin(case, argv, monkeypatch, capsys):
    targets = [target for target, _ in CASES[case][0]]
    args = ARGVS[argv] + targets
    want = run_main(jax_statusz, args, replies(case, rtypes), monkeypatch, capsys)
    got = run_main(port_statusz, args, replies(case, ptypes), monkeypatch, capsys)
    assert got == want
    if case == "journal_line_not_json" and argv == "json":
        assert want[0] == ("JSONDecodeError", "Expecting value: line 1 column 1 (char 0)")
    else:
        assert want[0] == CASES[case][1]
    if argv == "history_8" and case == "rich_with_history":
        assert "cluster timeseries:" in want[1] and "n=2" in want[1]


def test_render_and_to_json_twin():
    for case in CASES:
        for target, spec in CASES[case][0]:
            if spec == UNREACHABLE:
                continue
            jax_status = replies(case, rtypes)[target]
            port_status = replies(case, ptypes)[target]
            for journal_lines in (0, 1, 5):
                assert (port_statusz.render(port_status, journal_lines)
                        == jax_statusz.render(jax_status, journal_lines))
            if "not json" not in jax_status.journal:
                assert port_statusz.to_json(port_status) == jax_statusz.to_json(jax_status)
        statuses = [(replies(case, rtypes)[t], replies(case, ptypes)[t])
                    for t, spec in CASES[case][0] if spec != UNREACHABLE]
        assert (port_statusz.render_timeseries([p for _, p in statuses])
                == jax_statusz.render_timeseries([j for j, _ in statuses]))


def test_fetch_status_refuses_an_unexpected_reply():
    class Client:
        address = ptypes.Endpoint.from_parts("127.0.0.1", 1)

        def send_message(self, target, msg):
            assert isinstance(msg, ptypes.ClusterStatusRequest) and msg.include_history == 4

            class Done:
                def result(self, timeout):
                    return ptypes.Response()
            return Done()

    with pytest.raises(RuntimeError, match="unexpected reply Response"):
        port_statusz.fetch_status(Client(), ptypes.Endpoint.from_parts("h", 2), 1.0,
                                  include_history=4)


# --------------------------------------------------------------------- #
# the live twin: three port members on the port's TCP transport
# --------------------------------------------------------------------- #


def configuration_ids(text):
    return set(re.findall(r"config=(-?\d+)", text))


def test_both_clis_poll_three_live_port_members(capsys):
    import chip_smoke
    from rapid_tpu_torch.cli import slo as port_slo

    jax_slo = load_tool("slo")
    with chip_smoke.port_members(3, transport="tcp") as targets:
        got = {}
        for name, module in (("jax_statusz", jax_statusz), ("port_statusz", port_statusz),
                             ("jax_slo", jax_slo), ("port_slo", port_slo)):
            rc = module.main(targets)
            out = capsys.readouterr()
            got[name] = (rc, out.out, out.err)
    for name, (rc, out, err) in got.items():
        assert rc == 0 and err == "", (name, out, err)
        ids = configuration_ids(out)
        assert len(ids) == 1, (name, out)
        assert out.count("config=") == 3, (name, out)
    assert len({frozenset(configuration_ids(out)) for _, out, _ in got.values()}) == 1
    for name in ("jax_slo", "port_slo"):
        assert got[name][1].count("(no SLO plane -- settings.slo.enabled is off)") == 3
    # the SLO view carries nothing that moves between polls: equal text
    assert got["port_slo"] == got["jax_slo"]
