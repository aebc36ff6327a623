"""``chip_smoke.py``'s gateway phase on the CPU at 1000 virtual members: the
port's own client in its own OS process.

``chip_smoke.gateway_sequence`` starts the port's ``SwarmGateway`` and a
child process (``chip_smoke.py --gateway-member``) whose ``ScriptedMember``
speaks only through the port's wire: its ``TcpClientServer``, a
``GatewayRoutedClient`` and a ``GatewaySwarmBroadcaster``. The member joins
(one full configuration), votes in a closed-form crash and in a crash under
ingress loss 1.0, both run on the gateway's protocol thread, and leaves.
Each configuration id is equal on the gateway, in the member's own view and
on a plain simulator driven alike; this test holds the records the sequence
returns."""

import chip_smoke

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def test_gateway_sequence_with_a_member_in_its_own_process():
    out = chip_smoke.gateway_sequence(1000, "cpu")
    steps = {row["name"]: row for row in out["steps"]}
    assert list(steps) == ["join", "crash, closed form", "crash, scan", "leave"]
    join = steps["join"]
    assert join["event"]["endpoints"] == 1001 and join["event"]["observers"] >= 1
    assert join["member_configuration_id"] == join["configuration_id"] \
        == join["plain_configuration_id"]
    assert join["pump_syncs"] == {"sim.decision_words": 1, "sim.observers": 1}
    for name in ("crash, closed form", "crash, scan"):
        row = steps[name]
        assert row["cut"] == 10 and row["alert_batch"] == 10
        assert row["registered"] == [(1000, True)]
        assert row["vote_senders"] >= row["quorum"] == row["members_before"] - (
            row["members_before"] - 1) // 4
        assert row["member_configuration_id"] == row["configuration_id"] \
            == row["plain_configuration_id"]
        assert row["vote_window_ms"] > 0 and row["dispatch_ms"] > 0
        assert row["codec"]["encodes"] > 0 and row["codec"]["decodes"] > 0
    assert steps["crash, closed form"]["pump_syncs"] == {"sim.decision_words": 2}
    assert steps["crash, scan"]["pump_syncs"]["sim.decision_words"] > 2  # one a round to the announcement
    leave = steps["leave"]
    assert leave["cut"] == 1 and leave["member_removed"]
    assert leave["configuration_id"] == leave["plain_configuration_id"]
    walls = [row["member_wall_ms"] for row in out["steps"]]
    assert all(0 < w < chip_smoke.GATEWAY_WAIT_S * 1e3 for w in walls)
