"""Hand-written CUDA kernels of the round step, their plain PyTorch versions,
their build and their launch counters.

- ``fd_phase_i32`` / ``fd_phase_u8`` (``csrc/fd_phase.cu``) are the two
  instantiations of the FD counter chain, the counterpart of the Pallas kernel
  ``rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel``: ``fd_phase_i32`` is
  the Pallas contract, ``fd_phase_u8`` the engine's saturating counter.
- ``fd_phase_fused`` (``csrc/fd_phase_fused.cu``) is the whole FD phase of one
  scan round, from the state tensors and the state's random key to the
  destination-indexed alert arrivals and the next key, under either FD
  policy (the cumulative counter, or the paper's window of the last W
  probes); the scan path launches it every round. It splits the key as
  JAX's round does and, under random loss, makes each lossy edge's threefry
  word where it reads it (``csrc/threefry.cuh``).
- ``fd_phase_rows`` and ``fd_gather`` (the same source, the same device
  functions) split that phase around the alert exchange of the multi-device
  round (``rapid_tpu_torch/shard/engine.py``): each device makes one
  ``fd_phase_rows`` call over the observer rows of every shard it holds
  (up to ``MAX_SHARDS_PER_CALL``), writing each shard's new_down bits into
  its segment of a per-shard bitset (``segment_words``), and the home
  device runs ``fd_gather`` over every destination from all the segments.
  Each call splits the key too, and draws each shard's lossy edges under
  the probe key folded with the shard's index, as the sharded JAX round.
- ``threefry_draw`` (``csrc/threefry.cu``) is a round's random ingress-loss
  draw as a block: JAX's threefry key split and uniform ``[rows, K]``, bit
  for bit (the plain version is ``sim/threefry.py``), on one device or for
  the shards of one device's call. No round path launches it; it is the
  form of the bits that the golden vectors hold.
- ``placement_topr`` (``csrc/placement_topr.cu``) is the placement plane's
  rendezvous top-R; its wrapper and plain version live beside the plane,
  in ``rapid_tpu_torch/placement/device.py``, and build and count here.

Each source under ``csrc/`` is compiled with ``nvcc`` on first use into its
own library under ``build/kernels/`` of the checkout (all sources at once, in
parallel), keyed by a hash of every source there, and loaded with ``ctypes``.
The build and the CUDA launch happen only for CUDA tensors; a wrapper given
CPU tensors runs the kernel's plain version, which is also what the tests and
``chip_smoke.py`` hold the kernel against.

``LAUNCHES`` counts launches per kernel, and per policy for
``fd_phase_fused`` and ``fd_phase_rows`` (``fd_phase_fused_windowed`` and
``fd_phase_rows_windowed`` count their windowed instantiations): a wrapper
adds one where it launches its kernel, and nowhere else; a launch captured
in a CUDA graph counts on each replay instead (``captured_launches``,
``count_replay``). Under a running
``torch.profiler`` each launch sits in a host range named after its counter,
so a trace names the kernel whose passes it shows. Every build and library
load is reported to ``runtime.jitwatch`` as a compile event.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..observability import profiler_range
from ..runtime import jitwatch
from . import threefry

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {
    "fd_phase_i32": 0, "fd_phase_u8": 0, "fd_phase_fused": 0, "fd_phase_fused_windowed": 0,
    "fd_phase_rows": 0, "fd_phase_rows_windowed": 0, "fd_gather": 0,
    "threefry_draw": 0, "placement_topr": 0,
}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fd_phase_i32": [_P] * 8 + [_LL, _I, _P],
    "fd_phase_u8": [_P] * 8 + [_LL, _I, _P],
    "fd_phase_fused": [_P] * 27 + [_LL] + [_I] * 7 + [_P],
    "fd_phase_rows": [_P] * 7 + [ctypes.POINTER(_LL), _I, _P, _LL] + [_I] * 7 + [_P],
    "fd_gather": [_P] * 5 + [_LL, _I, _LL, _LL, ctypes.c_uint, _I, _P],
    "threefry_draw": [_P, _P, _P, _P, _LL, ctypes.POINTER(_I), _I, _P],
    "placement_topr": [_P, _LL, _P, _LL, _I, _P, _P, _P, _LL, _P, _P] + [_I] * 5 + [_P],
}
# shards of one fd_phase_rows call: its C entry point takes them as a table
# in the kernel's parameters, which holds 16
MAX_SHARDS_PER_CALL = 16
# the words of fd_phase_rows' node table after its node planes: a probe key
# (two words) for each of the most shards a call takes
_PROBE_WORDS = 2 * 16

_functions: Optional[Dict[str, ctypes._CFuncPtr]] = None

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: the launches the wrappers counted while
    the graph was captured move from ``LAUNCHES`` into the dict this yields.
    A captured kernel runs on each replay and not at capture, so its
    launches count once a replay, through ``count_replay``."""
    before, into = dict(LAUNCHES), {}
    try:
        yield into
    finally:
        for name, count in LAUNCHES.items():
            if count != before[name]:
                into[name] = count - before[name]
                LAUNCHES[name] = before[name]


@contextlib.contextmanager
def no_collection():
    """No cyclic garbage collection inside the block, which holds a CUDA
    graph capture: a dead cycle that holds another graph (a profiler's
    captured prefixes) would be collected there, and freeing that graph or
    its memory pool is a CUDA call that invalidates the capture. Garbage
    left meanwhile is collected after the block."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def count_replay(launches: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture counted ``launches``."""
    for name, count in launches.items():
        LAUNCHES[name] += count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def include_flags() -> Tuple[str, ...]:
    """nvcc's include path for the headers under ``csrc/`` (a source copied
    elsewhere, as a variant build's, still finds them)."""
    return ("-I", str(_CSRC))


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
    t0 = time.perf_counter()
    procs = []
    try:
        for name, out in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, *include_flags(), "-o", tmp, str(_CSRC / name)]
            # once a source digest: build() returns early once the libraries
            # exist  # devlint: jit-cached
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
    jitwatch.record_compile(",".join(sorted(todo)), time.perf_counter() - t0, "nvcc")
    return libs


def _function(name: str):
    """The C entry point ``name`` of the built libraries, typed for ctypes."""
    global _functions
    if _functions is None:
        found = {}
        paths = build().values()
        t0 = time.perf_counter()
        for path in paths:
            lib = ctypes.CDLL(str(path))  # once a process: _functions caches  # devlint: jit-cached
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
        jitwatch.record_compile(",".join(p.name for p in paths),
                                time.perf_counter() - t0, "load")
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
    with profiler_range(name):
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


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each element of an integer tensor whose values lie in
    [0, 2^16) (PyTorch has no population count): a SWAR count, two bits, then
    four, then eight at a time."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def window_update(
    hist: torch.Tensor, seen: torch.Tensor, probed: torch.Tensor,
    fail_event: torch.Tensor, window: int, fire: int,
) -> FusedOutputs:
    """One recorded-probe update of the windowed policy's per-edge state, the
    rule of the JAX engine's ``window_step``: a probed edge shifts its outcome
    into ``hist`` (int32 holding the JAX engine's uint16 bits, masked to the
    last ``window`` probes) and counts it in ``seen`` (uint8, wrapping before
    the clamp at ``window`` as the uint8 plane does); it is crossed once a full
    window holds at least ``fire`` failures. Returns ``(hist, seen,
    crossed)``."""
    mask = (1 << window) - 1
    shifted = ((hist << 1) | fail_event.to(torch.int32)) & mask
    hist = torch.where(probed, shifted, hist)
    seen = torch.where(probed, (seen + 1).clamp(max=window), seen)
    crossed = probed & (seen >= window) & (popcount16(hist) >= fire)
    return hist, seen, crossed


def _observer_rows(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: Optional[torch.Tensor],
    subjects: torch.Tensor, probe_drop: torch.Tensor, probe: Optional[torch.Tensor],
    fd_fail: torch.Tensor, alerted: torch.Tensor, fd_streak: torch.Tensor,
    fd_ok: torch.Tensor, round_: torch.Tensor, row0: int, *, threshold: int,
    gray_confirm: int, gray_warmup: int, rounds_per_interval: int,
    fd_hist: Optional[torch.Tensor], fd_seen: Optional[torch.Tensor],
    window: int, window_fire: int,
) -> FusedOutputs:
    """The observer-indexed part of the FD phase over the observer rows
    ``[row0, row0 + rows)``, in plain PyTorch ops: ``subjects`` and the
    per-edge planes are those rows' ``[rows, K]`` blocks, the node arrays
    ``[C]``. With ``drop_prob`` (random loss on) a probe is lost where the
    uniform ``[rows, K]`` block under the probe key ``probe`` lies below its
    subject's probability. Returns ``(alive, fd_fail, alerted, fd_streak, fd_ok,
    new_down, fd_hist, fd_seen)``, ``alive`` over all C nodes."""
    rows = subjects.shape[0]
    mine = slice(row0, row0 + rows)
    subj = subjects.long()
    alive = alive & active  # membership ∩ fault-model liveness
    edge_live = active[mine, None] & active[subj]  # edge exists in this config
    observer_up = alive[mine, None]
    probe_ok = alive[subj] & ~probe_drop
    if drop_prob is not None:
        probe_ok = probe_ok & ~(threefry.uniform(probe, tuple(subj.shape)) < drop_prob[subj])
    if rounds_per_interval > 1:
        # staggered FD phases: a node probes only in its own sub-interval
        # round (0-based round t probes nodes with phase == t mod rpi)
        phases = probe_phases(active.shape[0], rounds_per_interval, active.device)
        my_turn = phases[mine] == (round_ % rounds_per_interval)
        observer_up = observer_up & my_turn[:, None]

    if window > 0:
        probed = edge_live & observer_up
        fd_hist, fd_seen, crossed = window_update(
            fd_hist, fd_seen, probed, probed & ~probe_ok, window, window_fire
        )
        new_down = crossed & ~alerted
        alerted_out = alerted | new_down
    else:
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
    return alive, fd_fail, alerted_out, fd_streak, fd_ok, new_down, fd_hist, fd_seen


def fd_phase_fused_plain(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: Optional[torch.Tensor],
    subjects: torch.Tensor, observers: torch.Tensor, probe_drop: torch.Tensor,
    down_reports: torch.Tensor, key: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, fd_streak: torch.Tensor,
    fd_ok: torch.Tensor, round_: torch.Tensor, *, threshold: int,
    gray_confirm: int = 0, gray_warmup: int = 3, rounds_per_interval: int = 1,
    fd_hist: Optional[torch.Tensor] = None, fd_seen: Optional[torch.Tensor] = None,
    window: int = 0, window_fire: int = 0, halt: Optional[torch.Tensor] = None,
) -> FusedOutputs:
    """The FD phase of one round in plain PyTorch ops: the key's split,
    probe evaluation, the policy's per-edge state, the alert latch and the
    dst-indexed alert routing. The policy is the cumulative counter with its
    gray streak path (when ``gray_confirm > 0``), or, with ``window > 0``,
    the window of the last ``window`` probes on ``fd_hist``/``fd_seen``,
    firing at ``window_fire`` failures (``window_update``), which leaves
    ``fd_fail`` as it came in.
    ``key`` is the state's int64 ``[2]`` random key, split as JAX's round
    splits it (``threefry.round_keys``: where the 0-d bool ``halt`` holds
    True the new key is ``key`` as it came; ``halt`` changes nothing else).
    With ``drop_prob`` (``None`` without random loss) a probe is lost where
    the round's uniform ``[C, K]`` draw under the probe key lies below its
    subject's probability. The kernel draws only the edges where that can
    change the outcome; the draws lie in [0, 1), so the two agree.
    Returns ``(alive, fd_fail, alerted, fd_streak, fd_ok, down_arrivals,
    fd_hist, fd_seen, key)``; a plane the policy does not update is its
    input."""
    new_key, probe = threefry.round_keys(key, halt)
    alive, fd_fail, alerted_out, fd_streak, fd_ok, new_down, fd_hist, fd_seen = (
        _observer_rows(
            active, alive, drop_prob, subjects, probe_drop, probe, fd_fail, alerted,
            fd_streak, fd_ok, round_, 0, threshold=threshold, gray_confirm=gray_confirm,
            gray_warmup=gray_warmup, rounds_per_interval=rounds_per_interval,
            fd_hist=fd_hist, fd_seen=fd_seen, window=window, window_fire=window_fire,
        )
    )
    # alert routing (dst-indexed): on ring k the subject and observer maps
    # are inverse permutations over the active set, so "alert from observer
    # i lands at (subjects[i,k], k)" is the gather new_down[observers[d,k], k].
    # Masked to active destinations (joiner rows hold *expected* observers).
    down_arrivals = (
        new_down.gather(0, observers.long()) | down_reports
    ) & active[:, None]
    return (alive, fd_fail, alerted_out, fd_streak, fd_ok, down_arrivals, fd_hist, fd_seen,
            new_key)


def segment_words(rows: int, k: int) -> int:
    """Words (int32) of one shard's segment of the new_down bitset: its
    ``rows * k`` bits, local edge e at bit e (LSB first, zeros past the
    last edge), then a flag word, non-zero iff some bit is set. Segments
    start on a word, so shards write theirs independently."""
    return (rows * k + 31) // 32 + 1


def pack_segment(new_down: torch.Tensor) -> torch.Tensor:
    """The bitset segment (``segment_words``) of a shard's ``[rows, K]``
    new_down, as int32 words. Packed into little-endian bytes and viewed as
    words: the kernel's layout on the card and on the host alike."""
    flat = new_down.reshape(-1).to(torch.uint8)
    words = (flat.numel() + 31) // 32
    padded = torch.cat([flat, flat.new_zeros(words * 32 - flat.numel())])
    shifts = torch.arange(8, dtype=torch.uint8, device=flat.device)
    packed = (padded.view(-1, 8) << shifts).sum(dim=1).to(torch.uint8)
    flag = new_down.any().to(torch.int32).reshape(1)
    return torch.cat([packed.view(torch.int32), flag])


def row_reciprocal(rows: int) -> Tuple[int, int]:
    """``(magic, shift)`` with ``o // rows == ((2 * o * magic) >> 32) >> shift``
    for every ``0 <= o < 2**31``: how ``fd_gather`` finds the shard of
    observer o, a multiply-high and a shift on the card. ``shift`` is
    ``ceil(log2(rows))`` and ``magic`` is ``ceil(2**(31 + shift) / rows)``,
    below 2**32. Exact: ``o * magic / 2**(31 + shift)`` exceeds ``o / rows``
    by ``o * e / 2**(31 + shift)`` with ``0 <= e < 1``, less than ``2**-shift
    <= 1 / rows``, and ``o / rows`` lies at least ``1 / rows`` below the next
    integer."""
    if not 1 <= rows <= 1 << 31:
        raise ValueError(f"shard rows {rows} outside [1, 2**31]")
    shift = (rows - 1).bit_length()
    return -(-(1 << (31 + shift)) // rows), shift


def new_node_table(c: int, device) -> torch.Tensor:
    """Scratch for ``fd_phase_rows``' node pass over ``c`` nodes (2 bits a
    node, then a probe key a shard), which a caller may allocate once and
    pass to every call."""
    return torch.empty(2 * ((c + 31) // 32) + _PROBE_WORDS, dtype=torch.int32, device=device)


# the arguments of fd_phase_rows that differ between the shards of a call,
# besides row0 and fold
_SHARD_ARGS = ("subjects", "probe_drop", "fd_fail", "alerted", "fd_streak", "fd_ok", "bits",
               "fd_hist", "fd_seen")


def _shards(name: str, row0, fold, *values) -> list:
    """The per-shard arguments of an ``fd_phase_rows`` call, ``values`` in
    the order of ``_SHARD_ARGS``, as one dict a shard. One shard's call
    gives each as a value and ``row0`` and ``fold`` as ints; a call over
    several shards gives each as a sequence of one value a shard (None where
    no shard has it) and ``row0`` and ``fold`` as sequences."""
    if isinstance(row0, int):
        return [dict(zip(_SHARD_ARGS, values), row0=row0, fold=fold)]
    columns = dict(zip(_SHARD_ARGS, values), row0=list(row0), fold=list(fold))
    n = len(columns["row0"])
    if not n:
        raise ValueError(f"{name}: a call needs a shard")
    for arg, v in columns.items():
        if v is not None and len(v) != n:
            raise ValueError(f"{name}: {arg} has {len(v)} values for {n} shards")
    return [{arg: None if v is None else v[s] for arg, v in columns.items()} for s in range(n)]


def _rows_plain(active, alive, drop_prob, shard: dict, probe, round_, halt,
                **policy) -> FusedOutputs:
    """One shard of ``fd_phase_rows_plain``: its planes, its segment written
    into ``shard["bits"]``."""
    planes_in = tuple(shard[name] for name in ("fd_fail", "alerted", "fd_streak", "fd_ok",
                                               "fd_hist", "fd_seen"))
    _, fd_fail, alerted_out, fd_streak, fd_ok, new_down, fd_hist, fd_seen = _observer_rows(
        active, alive, drop_prob, shard["subjects"], shard["probe_drop"],
        threefry.fold_in(probe, shard["fold"]),
        shard["fd_fail"], shard["alerted"], shard["fd_streak"], shard["fd_ok"], round_,
        shard["row0"], fd_hist=shard["fd_hist"], fd_seen=shard["fd_seen"], **policy,
    )
    planes = (fd_fail, alerted_out, fd_streak, fd_ok, fd_hist, fd_seen)
    segment = pack_segment(new_down)
    if halt is not None:  # a halted round: every plane as it came in, no bit
        planes = tuple(p if p is i else torch.where(halt, i, p) for i, p in zip(planes_in, planes))
        segment = segment.masked_fill(halt, 0)
    shard["bits"].copy_(segment)
    return planes


def fd_phase_rows_plain(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: Optional[torch.Tensor],
    subjects, probe_drop, key: torch.Tensor, fd_fail, alerted, fd_streak, fd_ok,
    round_: torch.Tensor, bits, *, row0, fold, threshold: int, gray_confirm: int = 0,
    gray_warmup: int = 3, rounds_per_interval: int = 1, fd_hist=None, fd_seen=None,
    window: int = 0, window_fire: int = 0, halt: Optional[torch.Tensor] = None,
):
    """The observer side of ``fd_phase_fused_plain`` for the rows of one
    shard, or of several shards of one device, in plain PyTorch ops.

    One shard's call: its rows are ``[row0, row0 + rows)``; ``subjects``
    (global ids), ``probe_drop`` and the per-edge planes are the shard's
    ``[rows, K]`` blocks; ``active``, ``alive`` and ``drop_prob`` (``None``
    without random loss) are ``[C]``. Writes the rows' new_down bits and
    flag into ``bits`` (the shard's segment, see ``segment_words``). A call
    over several shards gives each per-shard argument (``_SHARD_ARGS``,
    ``row0`` and ``fold``) as a sequence, one value a shard, or None where
    no shard has it.

    ``key`` is the state's int64 ``[2]`` random key, split as in
    ``fd_phase_fused_plain``. ``fold`` is the shard's global index: the
    shard draws as the sharded JAX round does, its ``[rows, K]`` block under
    the probe key folded with that index (``threefry.fold_in``).

    ``halt``, a 0-d bool tensor: when it holds True the round is halted, and
    every plane comes out as it went in, every segment with no bit and its
    flag 0, and the new key is ``key``. Returns ``(planes, new key)``:
    ``planes`` the rows' ``(fd_fail, alerted, fd_streak, fd_ok, fd_hist,
    fd_seen)`` (a plane the policy does not update is its input), or for a
    call over several shards a list of each shard's."""
    shards = _shards("fd_phase_rows_plain", row0, fold, subjects, probe_drop, fd_fail,
                     alerted, fd_streak, fd_ok, bits, fd_hist, fd_seen)
    new_key, probe = threefry.round_keys(key, halt)
    outs = [_rows_plain(active, alive, drop_prob, shard, probe, round_, halt,
                        threshold=threshold, gray_confirm=gray_confirm,
                        gray_warmup=gray_warmup, rounds_per_interval=rounds_per_interval,
                        window=window, window_fire=window_fire)
            for shard in shards]
    return (outs[0] if isinstance(row0, int) else outs), new_key


def fd_gather_plain(
    active: torch.Tensor, observers: torch.Tensor, down_reports: torch.Tensor,
    bits: torch.Tensor, shard_rows: int,
) -> torch.Tensor:
    """The destination gather of ``fd_phase_fused_plain`` from the bitset
    segments of ``C / shard_rows`` shards laid end to end, in plain PyTorch
    ops: observer o's new_down is bit ``(o - s * shard_rows) * K + k`` of
    segment ``s = o // shard_rows``, and no bit counts when no segment's flag
    is set (the kernel then reads no bit). Returns ``down_arrivals``."""
    c, k = observers.shape
    seg = bits.view(c // shard_rows, -1)
    data = seg[:, :-1].contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    unpacked = ((data[..., None] >> shifts) & 1).reshape(seg.shape[0], -1)
    new_down = unpacked[:, : shard_rows * k].reshape(c, k).bool() & (seg[:, -1] != 0).any()
    return (new_down.gather(0, observers.long()) | down_reports) & active[:, None]


def _check(name: str, want, device: torch.device) -> None:
    """Raise on an argument of another dtype, shape or device than the
    kernel takes: ``want`` lists ``(argument, tensor, dtype, shape)``."""
    for arg, t, dtype, shape in want:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {shape}")
        if t.device != device:
            raise ValueError(f"{name}: all inputs must be on one device")


def _check_policy(name: str, threshold: int, gray_confirm: int, gray_warmup: int,
                  rounds_per_interval: int, window: int, window_fire: int) -> None:
    if not (1 <= threshold <= 255 and 0 <= gray_confirm <= 255
            and 0 <= gray_warmup <= 255 and rounds_per_interval >= 1):
        raise ValueError(f"{name}: threshold, gray counts or rounds_per_interval out of range")
    if not (0 <= window <= 16 and -(1 << 31) <= window_fire < (1 << 31)):
        raise ValueError(f"{name}: window must be in [0, 16], window_fire an int32")
    if window > 0 and gray_confirm > 0:
        raise ValueError(f"{name}: the gray streak path runs on the cumulative policy only")


def _policy_planes(name: str, rows: int, k: int, fd_hist, fd_seen, window: int) -> list:
    """The windowed policy's planes as ``_check`` entries (none under the
    cumulative policy)."""
    if window == 0:
        return []
    if fd_hist is None or fd_seen is None:
        raise ValueError(f"{name}: the windowed policy needs fd_hist and fd_seen")
    return [("fd_hist", fd_hist, torch.int32, (rows, k)),
            ("fd_seen", fd_seen, torch.uint8, (rows, k))]


def _ptr(t: Optional[torch.Tensor], used: bool = True):
    return t.data_ptr() if used and t is not None else None


def _key_args(key: torch.Tensor, halt: Optional[torch.Tensor]) -> list:
    """The key and the halt flag as ``_check`` entries."""
    want = [("key", key, torch.int64, (2,))]
    if halt is not None:
        want.append(("halt", halt, torch.bool, ()))
    return want


def fd_phase_fused(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: Optional[torch.Tensor],
    subjects: torch.Tensor, observers: torch.Tensor, probe_drop: torch.Tensor,
    down_reports: torch.Tensor, key: torch.Tensor,
    fd_fail: torch.Tensor, alerted: torch.Tensor, fd_streak: torch.Tensor,
    fd_ok: torch.Tensor, round_: torch.Tensor, *, threshold: int,
    gray_confirm: int = 0, gray_warmup: int = 3, rounds_per_interval: int = 1,
    fd_hist: Optional[torch.Tensor] = None, fd_seen: Optional[torch.Tensor] = None,
    window: int = 0, window_fire: int = 0, halt: Optional[torch.Tensor] = None,
) -> FusedOutputs:
    """The whole FD phase of one scan round in the CUDA kernel
    ``fd_phase_fused`` (its plain version for CPU tensors). Arguments and
    results as ``fd_phase_fused_plain``; ``subjects`` and ``observers`` are
    int32, ``round_`` the state's 0-d int32 round counter and ``halt`` a 0-d
    bool, both read on the device; the new key is a fresh tensor. With
    ``window > 0`` the kernel's windowed instantiation runs: it reads and
    writes ``fd_hist`` (int32) and ``fd_seen`` (uint8), and neither reads
    nor writes ``fd_fail``, which is returned as it came in. One launch
    counted a call."""
    name = "fd_phase_fused"
    c, k = subjects.shape
    windowed = window > 0
    want = [
        ("active", active, torch.bool, (c,)), ("alive", alive, torch.bool, (c,)),
        ("subjects", subjects, torch.int32, (c, k)),
        ("observers", observers, torch.int32, (c, k)),
        ("probe_drop", probe_drop, torch.bool, (c, k)),
        ("down_reports", down_reports, torch.bool, (c, k)),
        ("fd_fail", fd_fail, torch.uint8, (c, k)),
        ("alerted", alerted, torch.bool, (c, k)),
        ("fd_streak", fd_streak, torch.uint8, (c, k)),
        ("fd_ok", fd_ok, torch.uint8, (c, k)),
        ("round_", round_, torch.int32, ()),
    ] + _key_args(key, halt)
    if drop_prob is not None:
        want.append(("drop_prob", drop_prob, torch.float32, (c,)))
    want += _policy_planes(name, c, k, fd_hist, fd_seen, window)
    _check(name, want, active.device)
    _check_policy(name, threshold, gray_confirm, gray_warmup, rounds_per_interval,
                  window, window_fire)
    args = dict(threshold=threshold, gray_confirm=gray_confirm,
                gray_warmup=gray_warmup, rounds_per_interval=rounds_per_interval,
                fd_hist=fd_hist, fd_seen=fd_seen, window=window, window_fire=window_fire,
                halt=halt)
    inputs = (active, alive, drop_prob, subjects, observers, probe_drop,
              down_reports, key, fd_fail, alerted, fd_streak, fd_ok, round_)
    if active.device.type == "cpu":
        return fd_phase_fused_plain(*inputs, **args)
    if active.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {active.device}")
    if not all(t.is_contiguous() for _, t, _, _ in want):
        raise ValueError(f"{name}: inputs must be contiguous")
    counter = "fd_phase_fused_windowed" if windowed else name
    with profiler_range(counter):
        outputs = _launch_fused(
            inputs, torch.cuda.current_stream(active.device).cuda_stream, **args)
    LAUNCHES[counter] += 1
    return outputs


def _launch_fused(inputs, stream: int, *, threshold: int, gray_confirm: int,
                  gray_warmup: int, rounds_per_interval: int,
                  fd_hist: Optional[torch.Tensor], fd_seen: Optional[torch.Tensor],
                  window: int, window_fire: int, halt: Optional[torch.Tensor]) -> FusedOutputs:
    """Allocate the outputs and scratch of ``fd_phase_fused`` and call its C
    entry point on ``stream``, for inputs the wrapper has checked."""
    (active, _, _, subjects, _, _, _, key, fd_fail, alerted, fd_streak, fd_ok,
     round_) = inputs
    c, k = subjects.shape
    gray, windowed = gray_confirm > 0, window > 0
    key_out = torch.empty_like(key)
    alive_out = torch.empty_like(active)
    fd_out = fd_fail if windowed else torch.empty_like(fd_fail)
    alerted_out = torch.empty_like(alerted)
    streak_out = torch.empty_like(fd_streak) if gray else fd_streak
    ok_out = torch.empty_like(fd_ok) if gray else fd_ok
    hist_out = torch.empty_like(fd_hist) if windowed else fd_hist
    seen_out = torch.empty_like(fd_seen) if windowed else fd_seen
    down_arrivals = torch.empty_like(alerted)
    # the kernel's scratch: the node state planes (2 bits a node), the probe
    # key and a flag, and one new_down bit an edge
    node_table = torch.empty(2 * ((c + 31) // 32) + 3, dtype=torch.int32,
                             device=active.device)
    new_down = torch.empty((c * k + 32 + 31) // 32, dtype=torch.int32, device=active.device)
    err = _function("fd_phase_fused")(
        *(_ptr(t) for t in inputs[:8]), _ptr(halt), _ptr(fd_fail, not windowed),
        _ptr(alerted), _ptr(fd_streak, gray), _ptr(fd_ok, gray), _ptr(fd_hist, windowed),
        _ptr(fd_seen, windowed), _ptr(round_),
        _ptr(key_out), _ptr(alive_out), _ptr(fd_out, not windowed), _ptr(alerted_out),
        _ptr(streak_out, gray), _ptr(ok_out, gray), _ptr(hist_out, windowed),
        _ptr(seen_out, windowed), _ptr(down_arrivals), _ptr(node_table), _ptr(new_down),
        c, k, threshold, gray_confirm, gray_warmup, rounds_per_interval,
        window, window_fire, stream,
    )
    if err != 0:
        raise RuntimeError(f"fd_phase_fused: kernel launch failed with CUDA error {err}")
    return (alive_out, fd_out, alerted_out, streak_out, ok_out, down_arrivals,
            hist_out, seen_out, key_out)


def fd_phase_rows(
    active: torch.Tensor, alive: torch.Tensor, drop_prob: Optional[torch.Tensor],
    subjects, probe_drop, key: torch.Tensor, fd_fail, alerted, fd_streak, fd_ok,
    round_: torch.Tensor, bits, *, row0, fold, threshold: int, gray_confirm: int = 0,
    gray_warmup: int = 3, rounds_per_interval: int = 1, fd_hist=None, fd_seen=None,
    window: int = 0, window_fire: int = 0, halt: Optional[torch.Tensor] = None,
    node_table: Optional[torch.Tensor] = None,
):
    """The observer side of the FD phase for the rows of one shard, or of
    every shard one device holds (at most ``MAX_SHARDS_PER_CALL``), in the
    CUDA kernel ``fd_phase_rows`` (its plain version for CPU tensors): the
    node pass over all C nodes once, with the key's split and each shard's
    probe key, then one observer pass over every shard's rows. Arguments and
    results as ``fd_phase_rows_plain``; each shard's ``bits`` is an int32
    tensor of ``segment_words(rows, K)`` words, which may be a slice of a
    bitset on the same device, and each shard has at least one row.
    ``halt`` (0-d bool) and ``round_`` are read on the device; the new key
    is a fresh tensor. ``node_table`` is the node pass's scratch
    (``new_node_table``), allocated here when not given. Launched with the
    shards' device current, on its stream; one launch counted a call."""
    name = "fd_phase_rows"
    c = active.shape[0]
    shards = _shards(name, row0, fold, subjects, probe_drop, fd_fail, alerted, fd_streak,
                     fd_ok, bits, fd_hist, fd_seen)
    if len(shards) > MAX_SHARDS_PER_CALL:
        raise ValueError(f"{name}: {len(shards)} shards, at most {MAX_SHARDS_PER_CALL} a call")
    k = shards[0]["subjects"].shape[-1]
    windowed, gray = window > 0, gray_confirm > 0
    want = [
        ("active", active, torch.bool, (c,)), ("alive", alive, torch.bool, (c,)),
        ("round_", round_, torch.int32, ()),
    ] + _key_args(key, halt)
    if drop_prob is not None:
        want.append(("drop_prob", drop_prob, torch.float32, (c,)))
    if node_table is not None:
        want.append(("node_table", node_table, torch.int32,
                     (2 * ((c + 31) // 32) + _PROBE_WORDS,)))
    for shard in shards:
        rows = shard["subjects"].shape[0]
        want += [
            ("subjects", shard["subjects"], torch.int32, (rows, k)),
            ("probe_drop", shard["probe_drop"], torch.bool, (rows, k)),
            ("fd_fail", shard["fd_fail"], torch.uint8, (rows, k)),
            ("alerted", shard["alerted"], torch.bool, (rows, k)),
            ("fd_streak", shard["fd_streak"], torch.uint8, (rows, k)),
            ("fd_ok", shard["fd_ok"], torch.uint8, (rows, k)),
            ("bits", shard["bits"], torch.int32, (segment_words(rows, k),)),
        ]
        want += _policy_planes(name, rows, k, shard["fd_hist"], shard["fd_seen"], window)
        if not (rows >= 1 and 0 <= shard["row0"] <= c - rows):
            raise ValueError(f"{name}: rows [{shard['row0']}, {shard['row0'] + rows}) "
                             f"outside [0, {c}) or empty")
        if not (isinstance(shard["fold"], int) and 0 <= shard["fold"] < 1 << 32):
            raise ValueError(f"{name}: shard index {shard['fold']} outside [0, 2**32)")
    _check(name, want, active.device)
    _check_policy(name, threshold, gray_confirm, gray_warmup, rounds_per_interval,
                  window, window_fire)
    policy = dict(threshold=threshold, gray_confirm=gray_confirm, gray_warmup=gray_warmup,
                  rounds_per_interval=rounds_per_interval, window=window,
                  window_fire=window_fire)
    if active.device.type == "cpu":
        return fd_phase_rows_plain(active, alive, drop_prob, subjects, probe_drop, key,
                                   fd_fail, alerted, fd_streak, fd_ok, round_, bits, row0=row0,
                                   fold=fold, fd_hist=fd_hist, fd_seen=fd_seen, halt=halt,
                                   **policy)
    if active.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {active.device}")
    if not all(t.is_contiguous() for _, t, _, _ in want):
        raise ValueError(f"{name}: inputs must be contiguous")
    if node_table is None:
        node_table = new_node_table(c, active.device)
    key_out = torch.empty_like(key)
    outs, table = [], []
    for shard in shards:
        out = (shard["fd_fail"] if windowed else torch.empty_like(shard["fd_fail"]),
               torch.empty_like(shard["alerted"]),
               torch.empty_like(shard["fd_streak"]) if gray else shard["fd_streak"],
               torch.empty_like(shard["fd_ok"]) if gray else shard["fd_ok"],
               torch.empty_like(shard["fd_hist"]) if windowed else shard["fd_hist"],
               torch.empty_like(shard["fd_seen"]) if windowed else shard["fd_seen"])
        outs.append(out)
        # a row of the C entry point's table (ShardField in the source)
        table += [
            _ptr(shard["subjects"]), _ptr(shard["probe_drop"]),
            _ptr(shard["fd_fail"], not windowed), _ptr(shard["alerted"]),
            _ptr(shard["fd_streak"], gray), _ptr(shard["fd_ok"], gray),
            _ptr(shard["fd_hist"], windowed), _ptr(shard["fd_seen"], windowed),
            _ptr(out[0], not windowed), _ptr(out[1]), _ptr(out[2], gray), _ptr(out[3], gray),
            _ptr(out[4], windowed), _ptr(out[5], windowed), _ptr(shard["bits"]),
            shard["row0"], shard["subjects"].shape[0], shard["fold"],
        ]
    counter = "fd_phase_rows_windowed" if windowed else name
    with torch.cuda.device(active.device), profiler_range(counter):
        err = _function(name)(
            _ptr(active), _ptr(alive), _ptr(drop_prob), _ptr(round_), _ptr(halt), _ptr(key),
            _ptr(key_out), (_LL * len(table))(*(v or 0 for v in table)), len(shards),
            _ptr(node_table), c, k, threshold, gray_confirm, gray_warmup, rounds_per_interval,
            window, window_fire,
            torch.cuda.current_stream(active.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[counter] += 1
    return (outs[0] if isinstance(row0, int) else outs), key_out


def fd_gather(
    active: torch.Tensor, observers: torch.Tensor, down_reports: torch.Tensor,
    bits: torch.Tensor, shard_rows: int,
) -> torch.Tensor:
    """The destination gather of the FD phase in the CUDA kernel
    ``fd_gather`` (its plain version for CPU tensors), from the bitset
    segments that ``fd_phase_rows`` wrote for ``C / shard_rows`` shards, laid
    end to end in ``bits``; the kernel finds an observer's shard with
    ``row_reciprocal(shard_rows)``. Returns ``down_arrivals`` ``[C, K]``.
    Launched with the tensors' device current, on its stream."""
    name = "fd_gather"
    c, k = observers.shape
    if shard_rows <= 0 or c % shard_rows:
        raise ValueError(f"{name}: shards of {shard_rows} rows do not tile {c} rows")
    words = segment_words(shard_rows, k)
    _check(name, [
        ("active", active, torch.bool, (c,)),
        ("observers", observers, torch.int32, (c, k)),
        ("down_reports", down_reports, torch.bool, (c, k)),
        ("bits", bits, torch.int32, (c // shard_rows * words,)),
    ], active.device)
    if active.device.type == "cpu":
        return fd_gather_plain(active, observers, down_reports, bits, shard_rows)
    if active.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {active.device}")
    if not all(t.is_contiguous() for t in (active, observers, down_reports, bits)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if c * k > 1 << 31:
        raise ValueError(f"{name}: C * K = {c * k} exceeds the kernel's 2**31 edges")
    magic, shift = row_reciprocal(shard_rows)
    down_arrivals = torch.empty_like(down_reports)
    with torch.cuda.device(active.device), profiler_range(name):
        err = _function(name)(
            _ptr(active), _ptr(observers), _ptr(down_reports), _ptr(bits),
            _ptr(down_arrivals), c, k, shard_rows, words, magic, shift,
            torch.cuda.current_stream(active.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    if c * k:
        LAUNCHES[name] += 1
    return down_arrivals


def threefry_draw(
    key: torch.Tensor, rows: int, k: int, shards: Optional[Sequence[int]] = None,
    halt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's key split and uniform draw in the CUDA kernel
    ``threefry_draw`` (``threefry.draw_plain`` for a CPU key): ``key`` is the
    state's int64 ``[2]`` key. Returns ``(new key, draw)``, the draw float32
    ``[rows, k]`` from the probe key, or, with ``shards`` (the global shard
    indices of one device's call, at most ``MAX_SHARDS_PER_CALL``), each
    shard's ``[rows, k]`` block from the probe key folded with its index,
    stacked in that order. ``rows`` 0 only splits the key. ``halt``, a 0-d
    bool on the key's device read by the kernel: when it holds True the
    round is halted and the new key is ``key`` as it came (the draw is the
    same either way). Launched on the key's device and stream; one launch
    counted a call."""
    name = "threefry_draw"
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise TypeError(f"{name}: key must be int64 [2], got {key.dtype} {tuple(key.shape)}")
    if halt is not None:
        _check(name, [("halt", halt, torch.bool, ())], key.device)
    if rows < 0 or k < 1:
        raise ValueError(f"{name}: rows {rows} and k {k} out of range")
    if shards is not None:
        shards = [int(s) for s in shards]
        if not 1 <= len(shards) <= MAX_SHARDS_PER_CALL:
            raise ValueError(f"{name}: {len(shards)} shards, 1 to {MAX_SHARDS_PER_CALL} a call")
        if not all(0 <= s < 1 << 31 for s in shards):
            raise ValueError(f"{name}: shard indices {shards} outside [0, 2**31)")
    if key.device.type == "cpu":
        return threefry.draw_plain(key, rows, k, shards, halt)
    if key.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {key.device}")
    if not key.is_contiguous():
        raise ValueError(f"{name}: key must be contiguous")
    n_shards = 0 if shards is None else len(shards)
    key_out = torch.empty_like(key)
    draw = torch.empty((max(n_shards, 1) * rows, k), dtype=torch.float32, device=key.device)
    with torch.cuda.device(key.device), profiler_range(name):
        err = _function(name)(
            _ptr(key), _ptr(key_out), _ptr(halt), _ptr(draw) if draw.numel() else None,
            rows * k,
            (_I * max(n_shards, 1))(*(shards or [0])), n_shards,
            torch.cuda.current_stream(key.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return key_out, draw
