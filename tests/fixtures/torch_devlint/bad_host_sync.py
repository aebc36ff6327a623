"""host-sync: int()/.item()/.cpu() on device state, a python branch on a
tensor, a boolean-mask read, a scalar written into a tensor element and an
index by a 0-d tensor are blocking, un-audited device->host round trips."""
import numpy as np
import torch


def decide(state):
    if int(state.round_no) > 3:
        return np.asarray(state.votes)
    total = state.total.item()
    votes = state.votes.cpu()
    return votes, total


def tally(state, counts: torch.Tensor):
    quorum = counts >= 3
    if quorum.any():
        winners = counts[quorum]
        counts[0] = 0
        best = counts.argmax()
        return winners, state.slots[best]
    torch.cuda.synchronize()
    return None
