"""jit-purity: a wall-clock read and a print inside a CUDA-graph capture run
once at capture and never on replay -- the timestamp is baked into the
graph."""
import time

import torch


def stamped_sum(x, out):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        started = time.time()
        print("capturing", started)
        out.copy_(x.sum() + started)
    return graph
