"""The harness's whole path on the card, at a tiny size: the port's view
changes, through its CUDA kernels, equal the reference's."""

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import tiny_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return "cuda"


def test_tiny_cell_on_the_card(cuda_device, mix):
    out = harness.run_cell(tiny_cell(mix, members=4096), 12, 2.0, True, lambda: 0.0,
                           device=cuda_device)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
