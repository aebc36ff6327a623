"""Runtime build / host-sync watchdog for the port's device plane.

The port's counterpart of ``rapid_tpu/runtime/jitwatch.py``, with the same
seams and the same switch: ``RAPID_JITWATCH=1`` turns the bookkeeping on
(read on every call); unset, the seams do their work and record nothing.

- *Compile events.* An eager PyTorch program compiles nothing per call; what
  stands in for an XLA compile is a hand kernel's build (``nvcc``) or the
  load of its library, in ``sim/kernels.py``, which reports each through
  :func:`record_compile`; so does the profiler's capture of its prefixes as
  CUDA graphs (``profiling/phases.py``), the counterpart of JAX's compile of
  its prefix jits. One inside a timed window is a violation: warm the
  kernels before the measured region.
- *Timed windows* (:func:`timed_window`) declare a measured steady-state
  region. On the card they arm ``torch.cuda.set_sync_debug_mode("error")``
  where JAX arms ``jax.transfer_guard("disallow")``, so an implicit
  device->host sync (``.item()``, ``.cpu()``, ``int()`` of a device value,
  indexing by a 0-d device tensor, a blocking copy) raises at the offending
  line. Deliberate syncs go through the audited seams, which lift the mode
  for their own block and count themselves per label: :func:`fetch` (the
  one device->host copy a protocol batch is allowed), :func:`drain` (a
  synchronize outside the measured region) and :func:`host_transfer` (a
  labelled block of other deliberate transfers).
- A collective whose wait blocks the host (a multi-process mesh's gloo
  all-gather, ``shard.engine``) goes through :func:`host_transfer` under its
  own label (``shard.exchange``, ``shard.row_field``), so a timed window
  counts it and does not flag it.
- Unlike JAX's transfer guard, torch's sync debug mode is process-global:
  a thread that syncs while another thread's window is armed raises too,
  and one that syncs while another thread is inside a seam goes unseen.
  The simulator's speculation worker therefore makes no synchronizing call
  at all, and reports a sync error it meets through
  :func:`record_sync_error`. Under mode ``"warn"`` the seams leave the mode alone, so a caller
  counting the warnings sees the audited syncs as well and can hold the two
  counts equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_ERROR = 2  # torch.cuda sync debug mode "error"


class JitwatchViolation(RuntimeError):
    """A kernel build or load inside a timed window."""


def enabled() -> bool:
    """Whether the watchdog records (``RAPID_JITWATCH=1``)."""
    return os.environ.get("RAPID_JITWATCH", "") == "1"


@dataclass(frozen=True)
class CompileEvent:
    """One kernel build or library load."""

    name: str  # what was built or loaded
    wall_s: float  # its wall time
    steady: bool  # a timed window was open on the calling thread
    kind: str  # "nvcc" | "g++" | "load" | "capture"


_LOCK = threading.Lock()
_EVENTS: List[CompileEvent] = []
_SYNCS: Dict[str, int] = {}
_VIOLATIONS: List[str] = []
_TLS = threading.local()


def _windows() -> List[str]:
    stack = getattr(_TLS, "windows", None)
    if stack is None:
        stack = _TLS.windows = []
    return stack


def _count(label: str) -> None:
    if enabled():
        with _LOCK:
            _SYNCS[label] = _SYNCS.get(label, 0) + 1


def record_compile(name: str, wall_s: float, kind: str) -> None:
    """Record a kernel build or load; inside a timed window of this thread
    it is recorded as a violation, then raised (a blanket handler around the
    call cannot make it disappear: ``violations()`` keeps it)."""
    if not enabled():
        return
    steady = bool(_windows())
    with _LOCK:
        _EVENTS.append(CompileEvent(name, wall_s, steady, kind))
    if steady:
        msg = (f"jitwatch: kernel {kind} '{name}' inside timed window "
               f"'{_windows()[-1]}' -- build the kernels before the measured region")
        with _LOCK:
            _VIOLATIONS.append(msg)
        raise JitwatchViolation(msg)


def record_sync_error(where: str, exc: BaseException) -> bool:
    """Record ``exc`` in ``violations()`` when it is a sync debug error
    (on a thread with no timed window of its own, it was armed by another
    thread's: the mode is process-global); returns whether it was one.
    Recorded whether or not the watchdog is on."""
    if "synchroniz" not in str(exc).lower():
        return False
    with _LOCK:
        _VIOLATIONS.append(
            f"jitwatch: unaudited sync in {where}: {str(exc).splitlines()[0]}")
    return True


@contextlib.contextmanager
def _syncs_allowed():
    """Lift sync debug mode "error" for this block (any other mode stays:
    under "warn" the caller is counting syncs)."""
    if not torch.cuda.is_initialized() or torch.cuda.get_sync_debug_mode() != _ERROR:
        yield
        return
    torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("error")


@contextlib.contextmanager
def timed_window(name: str):
    """Declare a measured steady-state region: kernel builds on this thread
    become violations and, on the card, sync debug mode "error" is armed. A
    sync error propagating out is also recorded in ``violations()``."""
    if not enabled():
        yield
        return
    stack = _windows()
    stack.append(name)
    armed = torch.cuda.is_initialized()
    if armed:
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except JitwatchViolation:
        raise
    except Exception as exc:
        record_sync_error(f"timed window '{name}'", exc)
        raise
    finally:
        if armed:
            torch.cuda.set_sync_debug_mode(previous)
        stack.pop()


@contextlib.contextmanager
def host_transfer(label: str):
    """Audited transfer seam: allows syncs for a labelled block inside a
    timed window and counts it."""
    _count(label)
    with _syncs_allowed():
        yield


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return np.asarray(tree)


def fetch(label: str, tree: Any) -> Any:
    """THE audited device->host sync: one ``.cpu()`` a tensor of ``tree``
    (a tensor, or lists, tuples and dicts of them), returned as numpy
    arrays in the same structure, counted per label."""
    _count(label)
    with _syncs_allowed():
        return _to_host(tree)


def _cuda_devices(tree: Any, found: set) -> None:
    if isinstance(tree, torch.Tensor):
        tree = tree.device
    if isinstance(tree, torch.device):
        if tree.type == "cuda":
            found.add(tree.index if tree.index is not None else torch.cuda.current_device())
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _cuda_devices(x, found)
    elif isinstance(tree, dict):
        for x in tree.values():
            _cuda_devices(x, found)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)


def drain(label: str, *trees: Any) -> None:
    """Audited barrier (a synchronize, not a data fetch): waits for the work
    queued on every card that holds a tensor of ``trees`` (tensors, devices,
    dataclasses and containers of them). A no-op without a card."""
    _count(label)
    found: set = set()
    _cuda_devices(trees, found)
    if found:
        with _syncs_allowed():
            for index in sorted(found):
                torch.cuda.synchronize(index)


# --------------------------------------------------------------------- #
# Introspection
# --------------------------------------------------------------------- #


def compile_events() -> List[CompileEvent]:
    with _LOCK:
        return list(_EVENTS)


def compile_count(name: Optional[str] = None) -> int:
    with _LOCK:
        return sum(1 for e in _EVENTS if name is None or e.name == name)


def sync_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_SYNCS)


def stats() -> Dict[str, Any]:
    """Aggregate snapshot: builds and loads so far and their wall time
    (diff two snapshots to scope a phase)."""
    with _LOCK:
        return {
            "compiles": len(_EVENTS),
            "compile_wall_s": sum(e.wall_s for e in _EVENTS),
        }


def violations() -> List[str]:
    with _LOCK:
        return list(_VIOLATIONS)


def consume_violations() -> List[str]:
    global _VIOLATIONS
    with _LOCK:
        out = _VIOLATIONS
        _VIOLATIONS = []
        return out


def reset() -> None:
    """Clear the recorded log (events, syncs, violations)."""
    global _EVENTS, _SYNCS, _VIOLATIONS
    with _LOCK:
        _EVENTS = []
        _SYNCS = {}
        _VIOLATIONS = []
