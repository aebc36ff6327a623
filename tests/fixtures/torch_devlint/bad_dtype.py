"""dtype-discipline: factories without an explicit dtype take the fill
value's or the default dtype; float arithmetic and true division on the
pinned uint8 state fields silently widen them."""
import torch


def build(n, device):
    hist = torch.zeros((n, 8), device=device)
    ticks = torch.arange(n, device=device)
    return hist, ticks


def decay(state):
    fd_fail = state.fd_fail * 0.5
    rate = state.fd_hist / state.rounds
    return fd_fail, rate
