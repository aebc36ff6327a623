"""The port's test gate (``tests/torch_gate.py``) and the helpers it needs on
the port's lockdep.

The gate runs in a child pytest on a throwaway test file: a port lock-order
violation recorded on a background thread and swallowed there fails the
test during which it was recorded, and only that one; the same run with the
violation consumed passes; one recorded after the last test fails the
session. The child loads the gate both ways it is loaded: through the
module's ``pytest_plugins`` (as every ``tests/test_torch_*.py`` does), and
with ``-p torch_gate`` under ``--noconftest`` (as on the card). Then
``consume_violations`` and ``reset`` on the port's lockdep are held to the
JAX package's on the same provocation."""

import os
import subprocess
import sys
import threading
import textwrap
from pathlib import Path

import pytest

from rapid_tpu.runtime import lockdep as jax_lockdep
from rapid_tpu_torch.runtime import lockdep as port_lockdep

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

THROWAWAY = '''
import threading

from rapid_tpu_torch.runtime import lockdep

{plugins}


def provoke():
    """A lock-order inversion on a background thread, whose blanket
    handler swallows the raise."""
    a, b = lockdep.make_lock("gate.A"), lockdep.make_lock("gate.B")

    def inverted():
        try:
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        except Exception:
            pass

    t = threading.Thread(target=inverted)
    t.start()
    t.join()


def test_provokes():
    provoke()
    {consume}


def test_after():
    assert lockdep.enabled()
'''

LATE = '''
import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_sessionfinish(session):
    from test_throwaway import provoke

    provoke()
'''


def _run(tmp_path, loaded_by, consume, late=False):
    plugins = 'pytest_plugins = ["torch_gate"]' if loaded_by == "module" else ""
    body = THROWAWAY.format(plugins=plugins,
                            consume="lockdep.consume_violations()" if consume else "")
    (tmp_path / "test_throwaway.py").write_text(textwrap.dedent(body))
    argv = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--noconftest",
            "-p", "no:randomly", "test_throwaway.py"]
    if loaded_by == "-p":
        argv[4:4] = ["-p", "torch_gate"]
    if late:
        (tmp_path / "late_plugin.py").write_text(LATE)
        argv[4:4] = ["-p", "late_plugin"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(TESTS), str(REPO)]))
    env.pop("RAPID_LOCKDEP", None)  # the gate sets it
    env.pop("RAPID_JITWATCH", None)
    proc = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.mark.parametrize("loaded_by", ["module", "-p"])
def test_a_swallowed_violation_fails_the_test_that_recorded_it(tmp_path, loaded_by):
    rc, out = _run(tmp_path, loaded_by, consume=False)
    assert rc == 1, out
    # the call passed and its teardown errs: pytest counts both, and a
    # JUnit report counts the test as an error, not a pass
    assert "2 passed, 1 error" in out, out
    assert "ERROR at teardown of test_provokes" in out, out
    assert "rapid_tpu_torch.runtime.lockdep recorded a violation" in out, out
    assert "'gate.A' while holding 'gate.B' closes a cycle" in out, out


@pytest.mark.parametrize("loaded_by", ["module", "-p"])
def test_a_consumed_violation_passes(tmp_path, loaded_by):
    rc, out = _run(tmp_path, loaded_by, consume=True)
    assert rc == 0, out
    assert "2 passed" in out and "error" not in out, out


def test_a_violation_after_the_last_test_fails_the_session(tmp_path):
    rc, out = _run(tmp_path, "-p", consume=True, late=True)
    assert rc == 1, out
    assert "2 passed" in out, out
    assert "torch_gate: recorded after the last test" in out, out
    assert "'gate.A' while holding 'gate.B' closes a cycle" in out, out


def _provoke_in_thread(lockdep, prefix):
    a, b = lockdep.make_lock(f"{prefix}.A"), lockdep.make_lock(f"{prefix}.B")
    with a:
        with b:
            pass

    def inverted():
        try:
            with b:
                with a:
                    pass
        except Exception:
            pass  # the blanket handler

    t = threading.Thread(target=inverted, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture
def kept_graphs():
    """Each package's order graph as it was, put back after the test: the
    graph is a session-wide invariant that other tests build on."""
    saved = [(m, {k: set(v) for k, v in m._graph.items()}) for m in (jax_lockdep, port_lockdep)]
    yield
    for module, graph in saved:
        with module._graph_lock:
            module._graph.clear()
            module._graph.update(graph)


def test_consume_violations_twin(kept_graphs):
    assert port_lockdep.enabled() and jax_lockdep.enabled()
    got = {}
    for name, lockdep in (("jax", jax_lockdep), ("port", port_lockdep)):
        _provoke_in_thread(lockdep, "t_gate_consume")
        seen = lockdep.violations()
        consumed = lockdep.consume_violations()
        got[name] = (seen, consumed, lockdep.violations(), lockdep.consume_violations())
    assert got["port"] == got["jax"]
    seen, consumed, after, again = got["port"]
    assert len(seen) == 1 and consumed == seen and after == [] and again == []
    assert "'t_gate_consume.A' while holding 't_gate_consume.B' closes a cycle" in seen[0]


def test_reset_twin(kept_graphs):
    got = {}
    for name, lockdep in (("jax", jax_lockdep), ("port", port_lockdep)):
        _provoke_in_thread(lockdep, "t_gate_reset")
        recorded = len(lockdep.violations())
        lockdep.reset()
        cleared = (lockdep.violations(), dict(lockdep._graph))
        # fresh locks of the same classes: the provoking thread's raise left
        # its acquisition of A held
        a, b = lockdep.make_lock("t_gate_reset.A"), lockdep.make_lock("t_gate_reset.B")
        with b:  # the order graph forgot A -> B, so B -> A is a first edge
            with a:
                pass
        got[name] = (recorded, cleared, lockdep.violations(),
                     {k: sorted(v) for k, v in lockdep._graph.items()})
        # the reverse order now closes a cycle again, and is consumed
        with a:
            with pytest.raises(lockdep.LockOrderViolation):
                b.acquire()
        assert len(lockdep.consume_violations()) == 1
    assert got["port"] == got["jax"]
    assert got["port"] == (1, ([], {}), [], {"t_gate_reset.B": ["t_gate_reset.A"]})
