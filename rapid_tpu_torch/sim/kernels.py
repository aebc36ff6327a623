"""Hand-written CUDA kernels of the round step, their plain PyTorch versions,
their build and their launch counters.

``fd_phase_i32`` / ``fd_phase_u8`` are the two instantiations of the fused
failure-detector phase in ``csrc/fd_phase.cu`` (the counterpart of the Pallas
kernel ``rapid_tpu/sim/pallas_kernels.py::_fd_phase_kernel``). The source is
compiled with ``nvcc`` on first use into ``build/kernels/`` of the checkout,
keyed by a hash of the source, and loaded with ``ctypes``. The build and the
CUDA launch happen only for CUDA tensors; a wrapper given CPU tensors runs
the kernel's plain version, which is also what the tests and ``chip_smoke.py``
hold the kernel against.

``LAUNCHES`` counts kernel launches per instantiation: a wrapper adds one
where it launches its kernel, and nowhere else.
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

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fd_phase.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {"fd_phase_i32": 0, "fd_phase_u8": 0}

_lib: Optional[ctypes.CDLL] = None

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build() -> Path:
    """Compile ``fd_phase.cu`` into a shared library unless the build for
    this exact source already exists; returns the library's path. Raises
    RuntimeError with nvcc's output when it fails."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"fd_phase-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in LAUNCHES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    lib = _library()
    fd_out = torch.empty_like(fd_fail)
    alerted_out = torch.empty_like(alerted)
    new_down = torch.empty_like(alerted)
    stream = torch.cuda.current_stream(fd_fail.device).cuda_stream
    err = getattr(lib, name)(
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
