"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number the reference compared with its limit, which
also end standard error. Without a CUDA device, with fewer than the cell
asks for, or with ``jax``, ``jaxlib``, ``flax``, the JAX package
``rapid_tpu`` or the repo's JAX harness loaded once the window has closed,
it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.perf_counter()


def _since_process_start() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was first run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


# top-level module names that no run may load: JAX, and the JAX package
# and its harness, which the port stands beside
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rapid_tpu", "bench", "__graft_entry__"})


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is forbidden: whole names, so ``rapid_tpu_torch`` is not
    ``rapid_tpu``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one portbench cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one process with few threads: the load the run puts on a shared host
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)

    from . import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           _since_process_start)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    print("portbench: " + " ".join(f"{k} {v}" for k, v in out.pop("_timings").items()),
          file=sys.stderr)
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
