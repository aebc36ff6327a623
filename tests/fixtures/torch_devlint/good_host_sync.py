"""host-sync corrected: fetches go through the audited jitwatch seam (or are
declared sync points), the device selects with torch.where, and scalars are
written with fill_."""
import numpy as np
import torch

from rapid_tpu_torch.runtime import jitwatch


def decide(state):
    if int(jitwatch.fetch("fixture.round", state.round_no)) > 3:
        return jitwatch.fetch("fixture.votes", state.votes)
    # a snapshot's copy, off the round loop  # devlint: sync-point
    return np.asarray(state.votes.cpu())


def tally(state, counts: torch.Tensor):
    quorum = counts >= 3
    masked = torch.where(quorum, counts, torch.zeros_like(counts))
    counts.select(0, 0).fill_(0)
    best = counts.argmax()
    with jitwatch.host_transfer("fixture.tally"):
        picked = state.slots.index_select(0, best.reshape(1)).cpu()
    jitwatch.drain("fixture.tally", counts)
    return masked, picked
