"""ctypes bindings for the port's native host control plane
(``csrc/host/rapid_native.cpp``).

The counterpart of ``rapid_tpu/native.py``, with the same public names and
the same C entry points. The source is compiled with ``g++`` (``$CXX`` if
set) at first use into ``build/native/<stem>-<digest>.so`` of the checkout,
keyed by the source, the flags, the compiler's ``--version`` and the host's
CPU (its model and what the compiler resolves ``-march=native`` to: the
flags hold it, so a library built on one host is never loaded on another
with other features); the build writes a temporary file and renames
it into place, and is reported to ``runtime.jitwatch`` as a ``g++`` compile.
``runtime/native_io.py`` builds the reactor's source the same way
(``open_library``).

Every entry point has a numpy fallback (``hashing`` / ``sim.topology``), so
the port works without the library: a wrapper returns None when the library
cannot be built or loaded, and the caller takes its numpy path. That is not
quiet: the first failure emits one ``RuntimeWarning`` carrying the
compiler's output and leaves it in ``ERRORS`` (keyed by the source's stem)
for a caller to read; ``CALLS`` counts the calls that reached the library,
per entry point, so a run can show which path it took. ``BUILD_WALLS`` holds
the seconds each ``g++`` of this process took.

    python -m rapid_tpu_torch.native    # build, and say whether it loads
    python -m rapid_tpu_torch.native --stress thread address

``build_stress`` / ``run_stress`` build the reactor's source with its stress
harness (``csrc/host/rapid_io_stress.cpp``) under ThreadSanitizer or
AddressSanitizer into an executable under ``build/native/`` and run it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import subprocess
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .runtime import jitwatch

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
SOURCE = "rapid_native.cpp"

CALLS: Dict[str, int] = {
    "xxh64_batch": 0, "ring_hashes": 0, "build_adjacency": 0, "config_fold": 0,
}
ERRORS: Dict[str, str] = {}
BUILD_WALLS: Dict[str, float] = {}

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cxx() -> list:
    return shlex.split(os.environ.get("CXX", "g++"))


def _ask(cmd: list) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable: {exc}"


def _host_cpu(cxx: list) -> str:
    """What ``-march=native`` means on this host: the CPU model and the
    target options the compiler resolves it to (some hosts name no model)."""
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return model + "\0" + _ask([*cxx, "-march=native", "-Q", "--help=target"])


def library_path(source: str, extra_flags: Sequence[str] = ()) -> Tuple[Path, list]:
    """Where ``csrc/host/<source>`` built with these flags lives, and the
    command that builds it there (its output path left out)."""
    src = HOST_SRC / source
    cxx = _cxx()
    flags = [*CXX_FLAGS, *extra_flags]
    version = _ask([*cxx, "--version"])
    digest = hashlib.sha256("\0".join([*cxx, *flags, version, _host_cpu(cxx)]).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so", [*cxx, *flags, str(src)]


def build_library(source: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/host/<source>`` into its shared library unless that
    build exists already; its path. Raises RuntimeError with the compiler's
    output when the build fails."""
    out, cmd = library_path(source, extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run([*cmd[:-1], "-o", tmp, cmd[-1]], capture_output=True,
                                  text=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"{' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    wall = time.perf_counter() - t0
    BUILD_WALLS[Path(source).stem] = wall
    jitwatch.record_compile(source, wall, "g++")
    return out


def open_library(source: str, extra_flags: Sequence[str] = (),
                 auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """The library of ``csrc/host/<source>``, built first unless
    ``auto_build`` is False (then None when no build exists). A failed build
    or load returns None, records why in ``ERRORS`` and warns once."""
    stem = Path(source).stem
    try:
        if auto_build:
            path = build_library(source, extra_flags)
        else:
            path, _ = library_path(source, extra_flags)
            if not path.exists():
                return None
        return ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as exc:
        if isinstance(exc, jitwatch.JitwatchViolation):
            raise
        ERRORS[stem] = str(exc)
        warnings.warn(f"the port's host library {source} is unavailable, so its numpy "
                      f"fallback runs: {exc}", RuntimeWarning, stacklevel=3)
        return None


def build() -> str:
    """Compile the library (if this exact build is not there yet); its path."""
    return str(build_library(SOURCE))


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if unavailable (callers
    fall back to numpy). A failure is tried once a process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    lib = open_library(SOURCE, auto_build=auto_build)
    if lib is None:
        _tried = auto_build
        return None
    _tried = True

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.rapid_xxh64_batch.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_uint64, u64p
    ]
    lib.rapid_endpoint_hash_batch.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_uint64, u64p
    ]
    lib.rapid_ring_hashes.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64, u64p
    ]
    lib.rapid_build_adjacency.argtypes = [
        u64p, u8p, ctypes.c_int64, ctypes.c_int64, i32p, i32p
    ]
    lib.rapid_config_fold.argtypes = [u64p, ctypes.c_int64]
    lib.rapid_config_fold.restype = ctypes.c_uint64
    _lib = lib
    return lib


def available() -> bool:
    return load(auto_build=True) is not None


# -- numpy-compatible wrappers ------------------------------------------------


def xxh64_batch(data: np.ndarray, lengths: np.ndarray, seed: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(data.shape[0], dtype=np.uint64)
    CALLS["xxh64_batch"] += 1
    lib.rapid_xxh64_batch(
        data, data.shape[0], data.shape[1], lengths,
        ctypes.c_uint64(seed & (2**64 - 1)), out,
    )
    return out


def ring_hashes(
    hostnames: np.ndarray, lengths: np.ndarray, ports: np.ndarray, k: int
) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    hostnames = np.ascontiguousarray(hostnames, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    ports = np.ascontiguousarray(ports, dtype=np.int64)
    n = hostnames.shape[0]
    out = np.empty((k, n), dtype=np.uint64)
    CALLS["ring_hashes"] += 1
    lib.rapid_ring_hashes(
        hostnames, n, hostnames.shape[1], lengths, ports, k, out
    )
    return out


def build_adjacency(
    ring_hashes_arr: np.ndarray, active: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    k, capacity = ring_hashes_arr.shape
    ring_hashes_arr = np.ascontiguousarray(ring_hashes_arr, dtype=np.uint64)
    active_u8 = np.ascontiguousarray(active, dtype=np.uint8)
    base = np.tile(np.arange(capacity, dtype=np.int32)[:, None], (1, k))
    subjects = np.ascontiguousarray(base)
    observers = np.ascontiguousarray(base.copy())
    CALLS["build_adjacency"] += 1
    lib.rapid_build_adjacency(ring_hashes_arr, active_u8, capacity, k, subjects, observers)
    return subjects, observers


def config_fold(xs: np.ndarray) -> Optional[int]:
    """Chained configuration-id fold h=1; h=h*37+x (mod 2^64) over the
    already-interleaved element hashes; returns the Java-signed value."""
    lib = load()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.uint64)
    CALLS["config_fold"] += 1
    total = lib.rapid_config_fold(xs, xs.shape[0])
    return int(np.uint64(total).astype(np.int64))


# -- the reactor's sanitizer stress harness ---------------------------------

STRESS_SOURCES = ("rapid_io.cpp", "rapid_io_stress.cpp")
STRESS_FLAGS = ("-O1", "-g", "-std=c++17", "-Wall", "-pthread")
SANITIZERS = ("thread", "address")


_LINKS: Dict[Tuple[str, ...], Optional[str]] = {}


def _links(cxx: list, sanitizer: str) -> Optional[str]:
    """Why ``cxx`` cannot link ``-fsanitize=<sanitizer>`` (a trivial program
    built with the flag alone), or None when it can; asked once a process."""
    key = (*cxx, sanitizer)
    if key not in _LINKS:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "probe.cpp")
            with open(src, "w") as f:
                f.write("int main(){return 0;}")
            try:
                proc = subprocess.run([*cxx, f"-fsanitize={sanitizer}", "-o", src + ".bin",
                                       src], capture_output=True, text=True, timeout=120)
                _LINKS[key] = (None if proc.returncode == 0 else
                               f"{' '.join(cxx)} cannot link -fsanitize={sanitizer}: "
                               f"{proc.stderr.strip()}")
            except (OSError, subprocess.SubprocessError) as exc:
                _LINKS[key] = f"{' '.join(cxx)}: {exc}"
    return _LINKS[key]


def stress_compiler(sanitizer: str) -> Tuple[Optional[list], str]:
    """The compiler that builds the harness under ``sanitizer``: ``$CXX``
    (else ``g++``) when it links the sanitizer, else the ``g++`` on the
    path when that one does (a toolchain whose ``$CXX`` ships no sanitizer
    runtime may have a system compiler that does); ``(None, why)`` when
    none can."""
    reasons = []
    for cxx in [_cxx()] + ([["g++"]] if _cxx() != ["g++"] else []):
        reason = _links(cxx, sanitizer)
        if reason is None:
            return cxx, ""
        reasons.append(reason)
    return None, "; ".join(reasons)


def sanitizer_missing(sanitizer: str) -> Optional[str]:
    """Why no compiler here can link ``-fsanitize=<sanitizer>`` at all (no
    compiler, no libtsan / libasan), or None when one can."""
    return stress_compiler(sanitizer)[1] or None


def stress_path(sanitizer: str) -> Tuple[Path, list]:
    """Where the harness built under ``sanitizer`` lives, and the command
    that builds it there (its output path left out): keyed, as
    ``library_path`` keys a library, by the compiler, its flags, its
    ``--version`` and both sources. Raises RuntimeError when no compiler
    links the sanitizer."""
    if sanitizer not in SANITIZERS:
        raise ValueError(f"sanitizer {sanitizer!r} is not one of {SANITIZERS}")
    cxx, missing = stress_compiler(sanitizer)
    if cxx is None:
        raise RuntimeError(missing)
    flags = [*STRESS_FLAGS, f"-fsanitize={sanitizer}"]
    srcs = [HOST_SRC / name for name in STRESS_SOURCES]
    digest = hashlib.sha256("\0".join([*cxx, *flags, _ask([*cxx, "--version"])]).encode())
    for src in srcs:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"rapid_io_stress-{sanitizer}-{digest.hexdigest()[:16]}"
    return out, [*cxx, *flags, *map(str, srcs)]


def build_stress(sanitizer: str) -> Path:
    """Compile ``csrc/host/rapid_io.cpp`` with the stress harness under
    ``-fsanitize=<sanitizer>`` ("thread" or "address") into an executable,
    unless that build exists already; its path. Raises RuntimeError with the
    compiler's output when the build fails."""
    out, cmd = stress_path(sanitizer)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        n = len(STRESS_SOURCES)
        try:
            proc = subprocess.run([*cmd[:-n], "-o", tmp, *cmd[-n:]], capture_output=True,
                                  text=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"{' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    wall = time.perf_counter() - t0
    BUILD_WALLS[f"rapid_io_stress-{sanitizer}"] = wall
    jitwatch.record_compile(f"rapid_io_stress-{sanitizer}", wall, "g++")
    return out


# gcc's TSAN runtime refuses the address layout of kernels with a high
# vm.mmap_rnd_bits; the harness then runs again with ASLR off
_TSAN_MAPPING = "unexpected memory mapping"


def run_stress(sanitizer: str, timeout_s: float = 300.0) -> Tuple[str, bool]:
    """Build the harness under ``sanitizer`` and run it: its ``stress ok``
    line, and whether it ran under ``setarch <arch> -R`` (ASLR off, after
    TSAN refused the address layout). Raises RuntimeError with the
    harness's output when it exits other than 0 (an assertion or a sanitizer
    report) or prints no ``stress ok``."""
    exe = str(build_stress(sanitizer))
    no_aslr = False
    proc = subprocess.run([exe], capture_output=True, text=True, timeout=timeout_s)
    if proc.returncode != 0 and _TSAN_MAPPING in proc.stderr:
        no_aslr = True
        proc = subprocess.run(["setarch", platform.machine(), "-R", exe],
                              capture_output=True, text=True, timeout=timeout_s)
    ok = [line for line in proc.stdout.splitlines() if line.startswith("stress ok")]
    if proc.returncode != 0 or not ok:
        raise RuntimeError(f"{exe} (-fsanitize={sanitizer}"
                           f"{', ASLR off' if no_aslr else ''}) exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ok[0], no_aslr


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--stress"]:
        # python -m rapid_tpu_torch.native --stress [thread] [address]
        for name in sys.argv[2:] or SANITIZERS:
            missing = sanitizer_missing(name)
            if missing:
                print(f"-fsanitize={name}: absent: {missing}")  # noqa: print-in-lib
                continue
            line, no_aslr = run_stress(name)
            print(f"-fsanitize={name}: {line}"  # noqa: print-in-lib
                  + (" (ASLR off)" if no_aslr else ""))
    else:
        path = build()
        print(f"built {path}")  # noqa: print-in-lib
        print("loadable:", available())  # noqa: print-in-lib
