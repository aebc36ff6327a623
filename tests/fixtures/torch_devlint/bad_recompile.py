"""recompile-hazard: a kernel built with nvcc and its library loaded inside
a function body, on every call; a torch.compile in the device plane compiles
behind jitwatch's back."""
import ctypes
import subprocess

import torch


def launch(src, out):
    subprocess.run(["nvcc", "-shared", "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    return lib.fd_phase


@torch.compile
def step(x):
    return x + 1
