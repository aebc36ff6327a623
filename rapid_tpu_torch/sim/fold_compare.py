"""The folded FD kernel beside the pair of kernels it replaced, on the card.

Before the round's random-loss draw was folded into the FD kernels, a scan
round launched ``threefry_draw`` (the key's split and the uniform ``[C, K]``
block) and then ``fd_phase_fused``, which read that block. This script
builds those two kernels from the sources of commit 86dd490, the last that
has them, and times them beside this tree's ``fd_phase_fused`` (which splits
the key and makes each lossy edge's word itself) on ``fd_bench``'s cases
(cumulative policy, 5% of nodes lossy at fractional probabilities): cold
(input sets rotated through more than the L2) and hot, in a round with
alerts and in a quiet one, and the unfolded kernel alone on the same draw.
It first holds the pair to the folded kernel and to its plain version, bit
for bit. Run from the repo's root:

    mkdir -p build/fold_parent
    git archive 86dd490 rapid_tpu_torch/csrc | tar -x -C build/fold_parent
    python -m rapid_tpu_torch.sim.fold_compare \\
        --parent build/fold_parent/rapid_tpu_torch/csrc

A one-off measurement: the C interfaces below are that commit's, and no
other source builds against them. Prints the card's name and power limit,
then one JSON line a shape and round (the rounds take the forms in turn,
the odd ones in reverse order, so that drift on the card shows). Needs an
NVIDIA GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import fd_bench, kernels

PARENT_SOURCES = {"threefry_draw": "threefry.cu", "fd_phase_fused": "fd_phase_fused.cu"}
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARENT_ARGTYPES = {
    "threefry_draw": [_P, _P, _P, _P, _LL, ctypes.POINTER(_I), _I, _P],
    "fd_phase_fused": [_P] * 25 + [_LL] + [_I] * 7 + [_P],
}
KW = dict(threshold=10, gray_confirm=0, gray_warmup=3, rounds_per_interval=1)


def build_parent(src_dir: Path) -> dict:
    """The parent's two kernels, each built by its own ``nvcc`` (all started
    together) into ``build/kernels/fold_parent/`` and loaded with the
    parent's interface. Returns ``{entry: function}``."""
    out_dir = kernels.BUILD_DIR / "fold_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in PARENT_SOURCES.items():
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src_dir / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    parent = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of the parent's {PARENT_SOURCES[name]} failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes, fn.restype = PARENT_ARGTYPES[name], ctypes.c_int
        parent[name] = fn
    return parent


def _ptr(t):
    return None if t is None else t.data_ptr()


def parent_draw(parent, key: torch.Tensor, c: int, k: int):
    """The parent's ``threefry_draw``: the new key and the ``[c, k]`` block."""
    key_out = torch.empty_like(key)
    block = torch.empty((c, k), dtype=torch.float32, device=key.device)
    err = parent["threefry_draw"](_ptr(key), _ptr(key_out), None, _ptr(block), c * k,
                                  (_I * 1)(0), 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's threefry_draw: CUDA error {err}")
    return key_out, block


def parent_pair(parent, args, draw=None):
    """A callable that runs the parent's scan-round FD phase on a fused case
    (cumulative policy, gray path off): ``threefry_draw``, then the unfolded
    ``fd_phase_fused`` reading its block; with ``draw``, that kernel alone on
    the given block. It returns the folded kernel's nine outputs (None where
    the parent has none: the window planes, and the key with ``draw``)."""
    (active, alive, drop_prob, subjects, observers, probe_drop, down_reports, key, fd_fail,
     alerted, fd_streak, fd_ok, round_) = args
    c, k = subjects.shape

    def run():
        key_out, block = parent_draw(parent, key, c, k) if draw is None else (None, draw)
        outs = (torch.empty_like(active), torch.empty_like(fd_fail), torch.empty_like(alerted),
                fd_streak, fd_ok, torch.empty_like(alerted))
        node_table = torch.empty(2 * ((c + 31) // 32) + 1, dtype=torch.int32, device=key.device)
        new_down = torch.empty((c * k + 63) // 32, dtype=torch.int32, device=key.device)
        err = parent["fd_phase_fused"](
            _ptr(active), _ptr(alive), _ptr(drop_prob), _ptr(subjects), _ptr(observers),
            _ptr(probe_drop), _ptr(down_reports), _ptr(block), _ptr(fd_fail), _ptr(alerted),
            None, None, None, None, _ptr(round_), _ptr(outs[0]), _ptr(outs[1]), _ptr(outs[2]),
            None, None, None, None, _ptr(outs[5]), _ptr(node_table), _ptr(new_down), c, k,
            KW["threshold"], 0, KW["gray_warmup"], KW["rounds_per_interval"], 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's fd_phase_fused: CUDA error {err}")
        return outs + (None, None, key_out)

    return run


def _equal(got, want) -> bool:
    return all(g is None or torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="the parent commit's rapid_tpu_torch/csrc, unpacked")
    parser.add_argument("--sizes", type=int, nargs="+", default=[100_000, 1_000_000])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fold_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent = build_parent(args.parent)
    kernels.build()
    for c in args.sizes:
        sets = fd_bench.cold_sets(c, True, "cuda")
        quiet = fd_bench.quiet(sets)
        for case in (sets[0], quiet[0]):
            want = kernels.fd_phase_fused_plain(*case, **KW)
            if not _equal(kernels.fd_phase_fused(*case, **KW), want):
                raise AssertionError(f"the folded kernel disagrees with its plain version at {c}")
            if not _equal(parent_pair(parent, case)(), want):
                raise AssertionError(f"the parent's pair disagrees with the folded kernel at {c}")
        draws = [parent_draw(parent, a[7], c, 10)[1] for a in sets]
        forms = {
            "folded": lambda a, d: lambda: kernels.fd_phase_fused(*a, **KW),
            "pair": lambda a, d: parent_pair(parent, a),
            "unfolded_alone": lambda a, d: parent_pair(parent, a, d),
        }
        for r in range(args.rounds):
            us = {}
            for name in list(forms)[::-1] if r % 2 else list(forms):
                make = forms[name]
                for label, cases in (("", sets), ("quiet_", quiet)):
                    us[f"{name}_{label}cold"] = 1e3 * fd_bench.graph_ms(
                        [make(a, d) for a, d in zip(cases, draws)])
                    us[f"{name}_{label}hot"] = 1e3 * fd_bench.graph_ms(make(cases[0], draws[0]))
            print(json.dumps({"card": card, "size": [c, 10], "round": r, "input_sets": len(sets),
                              "bit_identical": True, "us": us}), flush=True)
        del sets, quiet, draws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
