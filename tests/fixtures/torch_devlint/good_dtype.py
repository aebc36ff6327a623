"""dtype-discipline corrected: every factory pins its dtype and the narrow
fields widen only through an explicit, audited .to()."""
import torch


def build(n, device):
    hist = torch.zeros((n, 8), dtype=torch.uint8, device=device)
    ticks = torch.arange(n, dtype=torch.int32, device=device)
    return hist, ticks


def decay(state):
    fd_fail = state.fd_fail.to(torch.float32) * 0.5
    rate = state.fd_hist.to(torch.float32) / state.rounds
    return fd_fail, rate
