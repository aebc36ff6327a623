"""recompile-hazard corrected: the build and the load happen once a process,
cached by the caller, and the step is plain eager torch."""
import ctypes
import subprocess

_LIBS = {}


def launch(src, out):
    if out not in _LIBS:
        # once a library path  # devlint: jit-cached
        subprocess.run(["nvcc", "-shared", "-o", out, src], check=True)
        _LIBS[out] = ctypes.CDLL(out)  # devlint: jit-cached
    return _LIBS[out].fd_phase


def step(x):
    return x + 1
