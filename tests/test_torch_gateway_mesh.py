"""The port's swarm gateway on a mesh, with gossiping agents, and under a
join wave with churn.

Twins of ``tests/test_gateway.py``'s mesh, gossip and 50-joiner cases, with
``rapid_tpu`` agents against ``rapid_tpu_torch``'s ``SwarmGateway``
(harness in ``test_torch_gateway.py``). Every agent's configuration id and
member list equal the gateway's after each phase."""

import threading

from test_torch_gateway import GatewayHarness, crash

from rapid_tpu.messaging.gateway import GatewayGossipBroadcaster
from rapid_tpu.messaging.gossip import GossipBroadcaster
from rapid_tpu_torch.shard.engine import make_mesh

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def test_socket_agents_against_mesh_sharded_swarm():
    """External agents over real sockets against a swarm row-sharded over a
    mesh of 4 (CPU devices): joins, votes and a cut flow through the mesh
    round loop, with configuration-id parity across the wire."""
    h = GatewayHarness(n_virtual=48, seed=16, mesh=make_mesh(devices=["cpu"] * 4), port_block=8)
    try:
        assert h.gateway.bridge.sim.mesh.size == 4
        h.join_agent(1, timeout=90)
        h.join_agent(2, timeout=90)
        assert h.wait_converged(50, timeout=90)
        h.assert_agreement()
        crash(h.gateway, [7, 23])
        assert h.wait_converged(48, timeout=90)
        h.assert_agreement()
    finally:
        h.shutdown()


def test_agents_gossip_among_themselves_behind_gateway():
    """Agents disseminate alert batches and votes to each other by epidemic
    relay (``rapid_tpu``'s GatewayGossipBroadcaster) while the port's swarm
    hears one wildcard copy: joins, a virtual cut and an abrupt agent death
    converge with bit-identical configuration ids."""

    def factory(client, rng):
        return GatewayGossipBroadcaster(
            client, GossipBroadcaster(client, client.address, fanout=3, rng=rng, mode="pushpull"))

    h = GatewayHarness(n_virtual=32, seed=18, broadcaster_factory=factory)
    try:
        agents = [h.join_agent(i) for i in range(1, 7)]
        assert h.wait_converged(38)
        h.assert_agreement()

        crash(h.gateway, [4, 21])
        assert h.wait_converged(36, timeout=90)
        h.assert_agreement()

        victim = agents[-1]
        victim.shutdown()
        h.agents.remove(victim)
        assert h.wait_converged(35, timeout=120)
        assert victim.listen_address not in h.agents[0].get_memberlist()
        h.assert_agreement()
    finally:
        h.shutdown()


def test_joiner_wave_and_churn():
    """The JAX package's 50-joiner wave against a 10 000-member swarm, cut
    to what tier-1 affords on the CPU: 16 agents in two concurrent bursts
    of 8 join a 1000-member swarm (capacity 1064) through its one seed;
    concurrent joiners batch into shared view changes. Then 4 agents die
    abruptly (no leave), the simulated failure detectors cut them, and 4
    fresh agents rejoin on the same addresses. Every party's configuration
    id and member list agree after each phase."""
    n_virtual, wave, burst, churn = 1000, 16, 8, 4
    h = GatewayHarness(n_virtual=n_virtual, seed=17, capacity=n_virtual + 64,
                       fd_interval_ms=200, pump_interval_ms=100)
    h.gateway.warm()
    errors = {}

    def join(i):
        try:
            h.join_agent(i, timeout=120)
        except Exception as exc:  # noqa: BLE001 -- collected and asserted
            errors[i] = exc

    def run_wave(ports):
        threads = [threading.Thread(target=join, args=(i,), daemon=True) for i in ports]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, f"joins failed: {errors}"

    try:
        for start in range(1, wave + 1, burst):
            run_wave(range(start, start + burst))
        assert len(h.agents) == wave
        assert h.wait_converged(n_virtual + wave, timeout=120)
        h.assert_agreement()

        victims, survivors = h.agents[:churn], h.agents[churn:]
        victim_addrs = [a.listen_address for a in victims]
        for a in victims:
            a.shutdown()
        h.agents = list(survivors)
        assert h.wait_converged(n_virtual + wave - churn, timeout=120)
        members = survivors[0].get_memberlist()
        assert all(addr not in members for addr in victim_addrs)
        h.assert_agreement()

        run_wave([addr.port - h.base for addr in victim_addrs])
        assert h.wait_converged(n_virtual + wave, timeout=120)
        h.assert_agreement()
    finally:
        for label, (count, total, worst) in sorted(
                h.gateway.task_stats().items(), key=lambda kv: -kv[1][1]):
            print(f"protocol task {label}: n={count} total={total:.1f}s max={worst:.2f}s")
        h.shutdown()
