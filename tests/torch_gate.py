"""The port's test gate: a pytest plugin that fails a test during which the
port recorded a lock-order or jitwatch violation.

``rapid_tpu_torch.runtime.lockdep`` and ``rapid_tpu_torch.runtime.jitwatch``
keep registries of their own, apart from the JAX package's (which
``tests/conftest.py`` gates at session end). A violation lands in them even
when a protocol thread's blanket exception handler swallows the raise, so
this plugin reads both after every test:

- after each test (a plain ``pytest_runtest_teardown``, run after the
  test's fixtures are torn down), a non-empty registry fails that test with
  the violations listed, and the plugin consumes them, so one fault fails
  one test and not every later one;
- at session end it reads them once more, for what a background thread
  recorded after the last test, and fails the session on it.

A registry is read only once its module is imported: a session that never
imports the port has nothing to check. The JAX package's registries are
never touched.

It loads itself through ``pytest_plugins = ["torch_gate"]`` in the port's
test modules (one module is enough for a session). Where the tests run
without ``tests/conftest.py`` (``--noconftest``, as on a machine without
JAX), load it first so the switches below are set before anything imports
the port::

    PYTHONPATH=tests python -m pytest --noconftest -p torch_gate -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import pytest

# as tests/conftest.py does: locks made while RAPID_LOCKDEP=1 are
# instrumented, and jitwatch records while RAPID_JITWATCH=1
os.environ.setdefault("RAPID_LOCKDEP", "1")
os.environ.setdefault("RAPID_JITWATCH", "1")

REGISTRIES = ("rapid_tpu_torch.runtime.lockdep", "rapid_tpu_torch.runtime.jitwatch")


def consume() -> Dict[str, List[str]]:
    """The violations each imported registry recorded since the last call,
    by registry; the registries are left empty."""
    found = {}
    for name in REGISTRIES:
        module = sys.modules.get(name)
        if module is not None and module.violations():
            found[name] = module.consume_violations()
    return found


def report(found: Dict[str, List[str]]) -> str:
    return "\n".join(f"{name} recorded a violation: {v}"
                     for name, violations in found.items() for v in violations)


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    found = consume()
    if found:
        pytest.fail(f"{item.nodeid}:\n{report(found)}", pytrace=False)


def pytest_sessionfinish(session, exitstatus):
    found = consume()
    if not found:
        return
    message = f"recorded after the last test:\n{report(found)}"
    sys.stderr.write(f"torch_gate: {message}\n")
    session.exitstatus = pytest.ExitCode.TESTS_FAILED
    workeroutput = getattr(session.config, "workeroutput", None)
    if workeroutput is not None:
        # an xdist worker: its exit status does not reach the controller,
        # its shouldfail does (the controller stops the run on it)
        workeroutput["shouldfail"] = f"torch_gate: {message}"
