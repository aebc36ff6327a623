"""A configuration read racing a view change behind the port's gateway.

``SwarmGateway`` serializes every task that touches the swarm on its protocol
thread. Its ``configuration_id()`` and ``membership_size()`` are read from
other threads: an agent's test, ``cli/gateway.py``'s status line, the load
balancer's check. ``Simulator.configuration_id()`` folds the id lazily and
caches it, and a view change clears the cache before it changes the
membership. A read from another thread that folds inside that window and
stores its result late leaves a stale id in the cache, and the next view
change's record carries it. ``HeldRead`` forces that schedule on the CPU:
the read starts inside one view change and its store is held until the next
one is under way. The gateway now serves the read on its protocol thread, so
it waits for the view change instead.

A call that meets ``shutdown`` runs once, and never beside a task the
protocol thread still holds: it waits for that thread to leave its task and
exit, unless the task drains the queue and runs the call itself.
"""

import threading
import time

import numpy as np
import pytest

from rapid_tpu_torch.messaging.gateway import SwarmGateway
from rapid_tpu_torch.messaging.ports import free_port_base
from rapid_tpu_torch.types import Endpoint

pytest_plugins = ["torch_gate"]

N_VIRTUAL = 24
SEED = 12
VICTIMS = (np.array([3, 17]), np.array([8, 21]))


class HeldRead:
    """At the first view change's install (``_stable_view.decision``, after
    the membership changed and before the record's id is taken) a reader
    thread calls ``gateway.configuration_id()``. A fold on the reader's
    thread is held until the second view change reaches the same point;
    then the reader is released and joined before that view change takes
    its id."""

    def __init__(self, gateway):
        self.gateway, self.sim = gateway, gateway.bridge.sim
        self._fold = self.sim._fold_configuration_id
        self._decision = self.sim._stable_view.decision
        self._folding, self._released = threading.Event(), threading.Event()
        self.reader, self.reads, self.installs = None, [], 0

    def _held_fold(self, active):
        value = self._fold(active)
        if threading.current_thread() is self.reader:
            self._folding.set()
            assert self._released.wait(30), "the held read was never released"
        return value

    def _held_decision(self, virtual_ms):
        self.installs += 1
        if self.installs == 1:
            self.reader = threading.Thread(
                target=lambda: self.reads.append(self.gateway.configuration_id()))
            self.reader.start()
            # the read folds on its own thread, or queues a task behind this
            # one on the protocol thread; either way it has not returned yet
            deadline = time.monotonic() + 30
            while not (self._folding.is_set() or self.gateway._tasks.qsize()):
                assert time.monotonic() < deadline, "the read neither folded nor queued"
                time.sleep(0.001)
        elif self.installs == 2:
            self.release()
        return self._decision(virtual_ms)

    def release(self):
        self._released.set()
        if self._folding.is_set():
            self.reader.join(30)  # the read stores what it folded, then returns

    def __enter__(self):
        self.sim._fold_configuration_id = self._held_fold
        self.sim._stable_view.decision = self._held_decision
        return self

    def __exit__(self, *exc):
        self._released.set()
        if self.reader is not None:
            self.reader.join(30)
        del self.sim._fold_configuration_id
        del self.sim._stable_view.decision


def _as_task(gateway, fn):
    """``fn()`` as a frame-class task on the protocol thread, the way the
    tests inject virtual faults (the parent tree has no public call)."""
    done, out = threading.Event(), []

    def task():
        try:
            out.append(fn())
        finally:
            done.set()

    gateway._put_task(task, gateway.PRIO_FRAME, "test")
    assert done.wait(60), "the protocol thread did not run the task"
    return out[0]


def test_read_during_view_change_leaves_the_next_record_on_the_swarms_id():
    base = free_port_base(2)
    gateway = SwarmGateway(Endpoint.from_parts("127.0.0.1", base), n_virtual=N_VIRTUAL,
                           seed=SEED, pump_interval_ms=3_600_000, device="cpu")
    gateway.start()
    try:
        sim = gateway.bridge.sim
        # as on the card, where the simulator does not speculate by default:
        # a read folds the id itself
        sim.speculate = False
        records = []
        with HeldRead(gateway) as held:
            for victims in VICTIMS:
                def crash_and_pump(v=victims):
                    sim.crash(v)
                    return gateway.bridge.pump(max_rounds=32)
                records.append(_as_task(gateway, crash_and_pump))
                time.sleep(0.05)
        assert all(r is not None for r in records)
        assert held.installs == 2 and len(held.reads) == 1
        fresh = sim._fold_configuration_id(sim.active)
        first, second = records
        assert sorted(second.cut.tolist()) == sorted(VICTIMS[1].tolist())
        # the second view change carries its own membership's id, not the
        # first one's that the late read stored
        assert second.configuration_id != first.configuration_id
        assert second.configuration_id == fresh == gateway.configuration_id()
        assert held.reads[0] == first.configuration_id
        assert gateway.membership_size() == N_VIRTUAL - 4
    finally:
        gateway.shutdown()


def test_reads_run_in_place_when_the_loop_is_not_running():
    base = free_port_base(2)
    gateway = SwarmGateway(Endpoint.from_parts("127.0.0.1", base), n_virtual=8, seed=1,
                           pump_interval_ms=3_600_000, device="cpu")
    before = (gateway.configuration_id(), gateway.membership_size())
    gateway.start()
    try:
        assert (gateway.configuration_id(), gateway.membership_size()) == before
        assert gateway.on_protocol_thread(gateway.configuration_id) == before[0]
    finally:
        gateway.shutdown()
    assert (gateway.configuration_id(), gateway.membership_size()) == before


@pytest.mark.parametrize("queued_before_shutdown", [True, False], ids=["queued", "late"])
@pytest.mark.parametrize("held_task_drains", [False, True], ids=["exits", "drains"])
def test_a_call_across_shutdown_waits_out_the_held_task(queued_before_shutdown,
                                                         held_task_drains):
    base = free_port_base(2)
    gateway = SwarmGateway(Endpoint.from_parts("127.0.0.1", base), n_virtual=8, seed=1,
                           pump_interval_ms=3_600_000, device="cpu")
    gateway.start()
    held, release = threading.Event(), threading.Event()
    events, results = [], []

    def hold():
        held.set()
        assert release.wait(30), "the held task was never released"
        events.append("held task ends")
        if held_task_drains:
            gateway._drain_until(time.monotonic() + 5)

    def fn():
        events.append(("call", threading.current_thread() is caller))
        return gateway.bridge.sim.membership_size

    caller = threading.Thread(target=lambda: results.append(gateway.on_protocol_thread(fn)))
    try:
        gateway._put_task(hold, gateway.PRIO_FRAME, "held")
        assert held.wait(30)
        if queued_before_shutdown:
            caller.start()
            deadline = time.monotonic() + 30
            while not gateway._tasks.qsize():
                assert time.monotonic() < deadline, "the call was never queued"
                time.sleep(0.001)
            gateway.shutdown()
        else:
            gateway.shutdown()
            caller.start()
        time.sleep(0.2)
        assert events == [], "the call ran beside the held task"
    finally:
        release.set()
        caller.join(30)
        gateway.shutdown()
    runs_on_caller = not (queued_before_shutdown and held_task_drains)
    assert events == ["held task ends", ("call", runs_on_caller)]
    assert results == [8]
