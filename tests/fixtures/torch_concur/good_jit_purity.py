"""jit-purity corrected: the timestamp comes in as a device tensor, written
before each replay."""
import torch


def stamped_sum(x, started, out):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(x.sum() + started)
    return graph
