"""The fused FD-phase kernel of the PyTorch port: its plain versions against
the Pallas kernel (interpret mode) and a numpy reference, the CPU path of its
wrappers, and, on an NVIDIA GPU, the CUDA kernels against their plain
versions. Exact equality throughout: the phase is integer and boolean only.

Only the Pallas comparison imports JAX, so the CUDA tests also run where JAX
is not installed (see tests/test_torch_cuda.py for the command)."""

import numpy as np
import pytest
import torch

from rapid_tpu_torch.sim import kernels

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _inputs(rng, c, k, counter_lo, counter_hi, dtype):
    return (
        rng.random((c, k)) < 0.9,
        rng.random((c, k)) < 0.95,
        rng.random((c, k)) < 0.5,
        rng.integers(counter_lo, counter_hi, size=(c, k)).astype(dtype),
        rng.random((c, k)) < 0.1,
    )


def _torch(args, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _reference_u8(edge_live, observer_up, probe_ok, fd_fail, alerted, threshold):
    fail = edge_live & observer_up & ~probe_ok
    fd = np.minimum(fd_fail.astype(np.int32) + fail, 255).astype(np.uint8)
    new_down = edge_live & observer_up & (fd >= threshold) & ~alerted
    return fd, alerted | new_down, new_down


@pytest.mark.parametrize("c", [256, 333])
def test_plain_i32_matches_pallas_interpret(c):
    fd_phase = pytest.importorskip("rapid_tpu.sim.pallas_kernels").fd_phase
    args = _inputs(np.random.default_rng(c), c, 10, 0, 12, np.int32)
    want = fd_phase(*args, threshold=10, interpret=True)
    got = kernels.fd_phase_plain_i32(*_torch(args), 10)
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("threshold", [10, 253, 255])
def test_plain_u8_saturates_like_reference(threshold):
    # counters seeded at 250-255 so some edges sit at the 255 ceiling
    args = _inputs(np.random.default_rng(threshold), 512, 10, 250, 256, np.uint8)
    want = _reference_u8(*args, threshold)
    got = kernels.fd_phase_plain_u8(*_torch(args), threshold)
    assert got[0].dtype == torch.uint8
    assert int(got[0].max()) == 255
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ["fd_phase_i32", "fd_phase_u8"])
def test_cpu_wrapper_takes_plain_path_and_counts_no_launch(name):
    dtype = np.int32 if name == "fd_phase_i32" else np.uint8
    args = _torch(_inputs(np.random.default_rng(1), 64, 10, 0, 12, dtype))
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, name)(*args, 10)
    plain = getattr(kernels, name.replace("fd_phase", "fd_phase_plain"))(*args, 10)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == before


def test_wrapper_rejects_bad_arguments():
    args = _torch(_inputs(np.random.default_rng(2), 16, 10, 0, 12, np.uint8))
    with pytest.raises(TypeError):
        kernels.fd_phase_i32(*args, 10)  # u8 counter into the i32 kernel
    bad_shape = list(args)
    bad_shape[0] = bad_shape[0][:8]
    with pytest.raises(ValueError):
        kernels.fd_phase_u8(*bad_shape, 10)
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].to(torch.uint8)
    with pytest.raises(TypeError):
        kernels.fd_phase_u8(*bad_dtype, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 333, 100_000, 1_000_000])
@pytest.mark.parametrize("name, counter_dtype, lo, hi", [
    ("fd_phase_i32", np.int32, 0, 12),
    ("fd_phase_u8", np.uint8, 0, 256),  # counters up to the 255 ceiling
])
def test_cuda_kernel_matches_plain(cuda_device, c, name, counter_dtype, lo, hi):
    args = _torch(_inputs(np.random.default_rng(c), c, 10, lo, hi, counter_dtype), cuda_device)
    before = kernels.LAUNCHES[name]
    got = getattr(kernels, name)(*args, 10)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = getattr(kernels, name.replace("fd_phase", "fd_phase_plain"))(*args, 10)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_wrapper_rejects_non_contiguous(cuda_device):
    args = _torch(_inputs(np.random.default_rng(0), 64, 10, 0, 12, np.uint8), cuda_device)
    args[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError):
        kernels.fd_phase_u8(*args, 10)
