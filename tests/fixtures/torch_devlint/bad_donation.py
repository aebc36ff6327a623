"""donation-hygiene: the simulator's host mirror goes to the device through
torch.as_tensor / torch.from_numpy, which on the CPU share its buffer -- the
simulator's next in-place write of the mirror changes the device state under
the tensor (the port's counterpart of a carried state with no donation)."""
import numpy as np
import torch


class Driver:
    def __init__(self, n, device):
        self.alive = np.ones(n, dtype=bool)
        self.device = device

    def upload(self):
        alive = self.alive
        self.alive_t = torch.as_tensor(self.alive, device=self.device)
        self.mask_t = torch.from_numpy(alive)

    def crash(self, victims):
        self.alive[victims] = False
