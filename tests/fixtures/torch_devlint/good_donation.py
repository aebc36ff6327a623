"""donation-hygiene corrected: the mirror is copied before it crosses, and
the one shared view whose array is never written again is declared."""
import numpy as np
import torch


class Driver:
    def __init__(self, n, device):
        self.alive = np.ones(n, dtype=bool)
        self.frozen = np.zeros(n, dtype=bool)
        self.device = device

    def upload(self):
        self.alive_t = torch.as_tensor(np.array(self.alive), device=self.device)
        self.mask_t = torch.from_numpy(self.alive.copy())
        # written once in __init__, never after  # devlint: host-owned
        self.frozen_t = torch.from_numpy(self.frozen)

    def crash(self, victims):
        self.alive[victims] = False
