"""Hand-written CUDA kernels of the round step, their plain PyTorch versions,
their build and their launch counters.

- ``fd_phase_i32`` / ``fd_phase_u8`` (``csrc/fd_phase.cu``) are the two
  instantiations of the FD counter chain, the counterpart of the Pallas kernel
  ``rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel``: ``fd_phase_i32`` is
  the Pallas contract, ``fd_phase_u8`` the engine's saturating counter.
- ``fd_phase_fused`` (``csrc/fd_phase_fused.cu``) is the whole FD phase of one
  scan round, from the state tensors to the destination-indexed alert
  arrivals; the scan path launches it every round.

Each source under ``csrc/`` is compiled with ``nvcc`` on first use into its
own library under ``build/kernels/`` of the checkout (all sources at once, in
parallel), keyed by a hash of every source there, and loaded with ``ctypes``.
The build and the CUDA launch happen only for CUDA tensors; a wrapper given
CPU tensors runs the kernel's plain version, which is also what the tests and
``chip_smoke.py`` hold the kernel against.

``LAUNCHES`` counts launches per kernel: a wrapper adds one where it launches
its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {"fd_phase_i32": 0, "fd_phase_u8": 0, "fd_phase_fused": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fd_phase_i32": [_P] * 8 + [_LL, _I, _P],
    "fd_phase_u8": [_P] * 8 + [_LL, _I, _P],
    "fd_phase_fused": [_P] * 21 + [_LL] + [_I] * 5 + [_P],
}

_functions: Optional[Dict[str, ctypes._CFuncPtr]] = None

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build() -> Dict[str, Path]:
    """Compile every ``.cu`` under ``csrc/`` into its own shared library,
    one ``nvcc`` per source, all started together, unless the build for these
    exact sources already exists. Returns ``{source name: library path}``.
    Raises RuntimeError with nvcc's output when one fails."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    tag = digest.hexdigest()[:16]
    libs = {src.name: BUILD_DIR / f"{src.stem}-{tag}.so"
            for src in _sources() if src.suffix == ".cu"}
    todo = {name: out for name, out in libs.items() if not out.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name, out in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / name)]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs


def _function(name: str):
    """The C entry point ``name`` of the built libraries, typed for ctypes."""
    global _functions
    if _functions is None:
        found = {}
        for path in build().values():
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _ARGTYPES.items():
                if hasattr(lib, fn_name):
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    found[fn_name] = fn
        missing = set(_ARGTYPES) - set(found)
        if missing:
            raise RuntimeError(f"built kernels lack {sorted(missing)}")
        _functions = found
    return _functions[name]


# --------------------------------------------------------------------- #
# Plain versions (the CPU path, and the reference the kernels are held to)
# --------------------------------------------------------------------- #


def fd_phase_plain_i32(
    edge_live: torch.Tensor, observer_up: torch.Tensor, probe_ok: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, threshold: int,
) -> Outputs:
    """The Pallas contract: int32 counter, no saturation."""
    fail = edge_live & observer_up & ~probe_ok
    fd = fd_fail + fail.to(torch.int32)
    new_down = edge_live & observer_up & (fd >= threshold) & ~alerted
    return fd, alerted | new_down, new_down


def fd_phase_plain_u8(
    edge_live: torch.Tensor, observer_up: torch.Tensor, probe_ok: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, threshold: int,
) -> Outputs:
    """The engine's counter: uint8, saturating at 255 (it is only ever
    compared against a threshold <= 255, so clamping preserves semantics)."""
    fail = edge_live & observer_up & ~probe_ok
    fd = fd_fail + (fail & (fd_fail < 255)).to(torch.uint8)
    new_down = edge_live & observer_up & (fd >= threshold) & ~alerted
    return fd, alerted | new_down, new_down


# --------------------------------------------------------------------- #
# Wrappers
# --------------------------------------------------------------------- #


def _launch(
    name: str, counter_dtype: torch.dtype, edge_live: torch.Tensor,
    observer_up: torch.Tensor, probe_ok: torch.Tensor, fd_fail: torch.Tensor,
    alerted: torch.Tensor, threshold: int,
) -> Outputs:
    shape = fd_fail.shape
    if fd_fail.dtype != counter_dtype:
        raise TypeError(f"{name}: fd_fail must be {counter_dtype}, got {fd_fail.dtype}")
    for arg, t in (("edge_live", edge_live), ("observer_up", observer_up),
                   ("probe_ok", probe_ok), ("alerted", alerted)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name}: {arg} must be bool, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {tuple(shape)}")
    args = (edge_live, observer_up, probe_ok, fd_fail, alerted)
    if any(t.device != fd_fail.device for t in args):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not 0 <= threshold <= 0x7FFFFFFF:
        raise ValueError(f"{name}: threshold {threshold} out of int32 range")
    if fd_fail.device.type == "cpu":
        plain = fd_phase_plain_i32 if counter_dtype == torch.int32 else fd_phase_plain_u8
        return plain(*args, threshold)
    if fd_fail.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {fd_fail.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    fd_out = torch.empty_like(fd_fail)
    alerted_out = torch.empty_like(alerted)
    new_down = torch.empty_like(alerted)
    stream = torch.cuda.current_stream(fd_fail.device).cuda_stream
    err = _function(name)(
        *(t.data_ptr() for t in args),
        fd_out.data_ptr(), alerted_out.data_ptr(), new_down.data_ptr(),
        fd_fail.numel(), threshold, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    if fd_fail.numel():
        LAUNCHES[name] += 1
    return fd_out, alerted_out, new_down


def fd_phase_i32(
    edge_live: torch.Tensor, observer_up: torch.Tensor, probe_ok: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, threshold: int,
) -> Outputs:
    """Fused FD phase, int32 counter (the Pallas ``fd_phase`` contract).
    Returns ``(fd_fail, alerted, new_down)``."""
    return _launch("fd_phase_i32", torch.int32, edge_live, observer_up,
                   probe_ok, fd_fail, alerted, threshold)


def fd_phase_u8(
    edge_live: torch.Tensor, observer_up: torch.Tensor, probe_ok: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, threshold: int,
) -> Outputs:
    """Fused FD phase, uint8 counter saturating at 255 (the engine state's
    counter). Returns ``(fd_fail, alerted, new_down)``."""
    return _launch("fd_phase_u8", torch.uint8, edge_live, observer_up,
                   probe_ok, fd_fail, alerted, threshold)


# --------------------------------------------------------------------- #
# The fused FD phase of one scan round
# --------------------------------------------------------------------- #

FusedOutputs = Tuple[torch.Tensor, ...]


def probe_phases(capacity: int, rounds_per_interval: int, device=None) -> torch.Tensor:
    """Each node's fixed probe phase within the FD interval ([C] int32 in
    [0, rounds_per_interval)): the JAX engine's uint32 Knuth multiplicative
    hash of the node index, computed in int64 with an explicit 32-bit mask."""
    idx = torch.arange(capacity, dtype=torch.int64, device=device)
    return (((idx * 2654435761) & 0xFFFFFFFF) % rounds_per_interval).to(torch.int32)


def fd_phase_fused_plain(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: torch.Tensor,
    subjects: torch.Tensor, observers: torch.Tensor, probe_drop: torch.Tensor,
    down_reports: torch.Tensor, draw: Optional[torch.Tensor],
    fd_fail: torch.Tensor, alerted: torch.Tensor, fd_streak: torch.Tensor,
    fd_ok: torch.Tensor, round_: torch.Tensor, *, threshold: int,
    gray_confirm: int = 0, gray_warmup: int = 3, rounds_per_interval: int = 1,
) -> FusedOutputs:
    """The cumulative-policy FD phase of one round in plain PyTorch ops: probe
    evaluation, the saturating counter, the gray streak path (when
    ``gray_confirm > 0``), the alert latch and the dst-indexed alert routing.
    ``draw`` is the round's uniform draw in [0, 1) (``None`` without random
    loss): the kernel relies on it being non-negative, so it skips the
    compare for subjects whose ``drop_prob`` is not positive.
    Returns ``(alive, fd_fail, alerted, fd_streak, fd_ok, down_arrivals)``;
    without the gray path ``fd_streak`` and ``fd_ok`` are the inputs."""
    c = subjects.shape[0]
    subj = subjects.long()
    alive = alive & active  # membership ∩ fault-model liveness
    edge_live = active[:, None] & active[subj]  # edge exists in this config
    observer_up = alive[:, None]
    probe_ok = alive[subj] & ~probe_drop
    if draw is not None:
        probe_ok = probe_ok & ~(draw < drop_prob[subj])
    if rounds_per_interval > 1:
        # staggered FD phases: a node probes only in its own sub-interval
        # round (0-based round t probes nodes with phase == t mod rpi)
        my_turn = probe_phases(c, rounds_per_interval, active.device) == (
            round_ % rounds_per_interval
        )
        observer_up = observer_up & my_turn[:, None]

    fd_fail, alerted_out, new_down = fd_phase_plain_u8(
        edge_live, observer_up, probe_ok, fd_fail, alerted, threshold
    )
    if gray_confirm > 0:
        # gray streak path: a probe that succeeds resets the streak; one that
        # fails extends it, and a streak of gray_confirm on an edge with
        # >= gray_warmup past successes fires like a hard failure
        watching = edge_live & observer_up
        fail_event = watching & ~probe_ok
        ok_event = watching & probe_ok
        streak = fd_streak + (fail_event & (fd_streak < 255)).to(torch.uint8)
        streak = streak.masked_fill(ok_event, 0)
        gray_down = (
            fail_event & (streak >= gray_confirm) & (fd_ok >= gray_warmup) & ~alerted
        )
        fd_ok = fd_ok + (ok_event & (fd_ok < 255)).to(torch.uint8)
        fd_streak = streak
        new_down = new_down | gray_down
        alerted_out = alerted_out | gray_down

    # alert routing (dst-indexed): on ring k the subject and observer maps
    # are inverse permutations over the active set, so "alert from observer
    # i lands at (subjects[i,k], k)" is the gather new_down[observers[d,k], k].
    # Masked to active destinations (joiner rows hold *expected* observers).
    down_arrivals = (
        new_down.gather(0, observers.long()) | down_reports
    ) & active[:, None]
    return alive, fd_fail, alerted_out, fd_streak, fd_ok, down_arrivals


def fd_phase_fused(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: torch.Tensor,
    subjects: torch.Tensor, observers: torch.Tensor, probe_drop: torch.Tensor,
    down_reports: torch.Tensor, draw: Optional[torch.Tensor],
    fd_fail: torch.Tensor, alerted: torch.Tensor, fd_streak: torch.Tensor,
    fd_ok: torch.Tensor, round_: torch.Tensor, *, threshold: int,
    gray_confirm: int = 0, gray_warmup: int = 3, rounds_per_interval: int = 1,
) -> FusedOutputs:
    """The whole FD phase of one scan round in the CUDA kernel
    ``fd_phase_fused`` (its plain version for CPU tensors). Arguments and
    results as ``fd_phase_fused_plain``; ``subjects`` and ``observers`` are
    int32, ``round_`` the state's 0-d int32 round counter, read on the
    device."""
    name = "fd_phase_fused"
    c, k = subjects.shape
    gray = gray_confirm > 0
    want = [
        ("active", active, torch.bool, (c,)), ("alive", alive, torch.bool, (c,)),
        ("drop_prob", drop_prob, torch.float32, (c,)),
        ("subjects", subjects, torch.int32, (c, k)),
        ("observers", observers, torch.int32, (c, k)),
        ("probe_drop", probe_drop, torch.bool, (c, k)),
        ("down_reports", down_reports, torch.bool, (c, k)),
        ("fd_fail", fd_fail, torch.uint8, (c, k)),
        ("alerted", alerted, torch.bool, (c, k)),
        ("fd_streak", fd_streak, torch.uint8, (c, k)),
        ("fd_ok", fd_ok, torch.uint8, (c, k)),
        ("round_", round_, torch.int32, ()),
    ]
    if draw is not None:
        want.append(("draw", draw, torch.float32, (c, k)))
    for arg, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {shape}")
        if t.device != active.device:
            raise ValueError(f"{name}: all inputs must be on one device")
    if not (1 <= threshold <= 255 and 0 <= gray_confirm <= 255
            and 0 <= gray_warmup <= 255 and rounds_per_interval >= 1):
        raise ValueError(f"{name}: threshold, gray counts or rounds_per_interval out of range")
    args = dict(threshold=threshold, gray_confirm=gray_confirm,
                gray_warmup=gray_warmup, rounds_per_interval=rounds_per_interval)
    inputs = (active, alive, drop_prob, subjects, observers, probe_drop,
              down_reports, draw, fd_fail, alerted, fd_streak, fd_ok, round_)
    if active.device.type == "cpu":
        return fd_phase_fused_plain(*inputs, **args)
    if active.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {active.device}")
    if not all(t.is_contiguous() for t in inputs if t is not None):
        raise ValueError(f"{name}: inputs must be contiguous")
    alive_out = torch.empty_like(active)
    fd_out = torch.empty_like(fd_fail)
    alerted_out = torch.empty_like(alerted)
    streak_out = torch.empty_like(fd_streak) if gray else fd_streak
    ok_out = torch.empty_like(fd_ok) if gray else fd_ok
    down_arrivals = torch.empty_like(alerted)
    # the kernel's scratch: the node state planes (2 bits a node) and a flag,
    # and one new_down bit an edge
    node_table = torch.empty(2 * ((c + 31) // 32) + 1, dtype=torch.int32,
                             device=active.device)
    new_down = torch.empty((c * k + 32 + 31) // 32, dtype=torch.int32, device=active.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _function(name)(
        *(ptr(t) for t in inputs),
        alive_out.data_ptr(), fd_out.data_ptr(), alerted_out.data_ptr(),
        streak_out.data_ptr() if gray else None, ok_out.data_ptr() if gray else None,
        down_arrivals.data_ptr(), node_table.data_ptr(), new_down.data_ptr(),
        c, k, threshold, gray_confirm, gray_warmup, rounds_per_interval,
        torch.cuda.current_stream(active.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    if c * k:
        LAUNCHES[name] += 1
    return alive_out, fd_out, alerted_out, streak_out, ok_out, down_arrivals
