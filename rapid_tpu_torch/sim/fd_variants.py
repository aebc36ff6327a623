"""What holds ``fd_phase_fused`` above its byte bound: per-pass device time
of variants of its source, each a textual change to ``csrc/fd_phase_fused.cu``.

    python -m rapid_tpu_torch.sim.fd_variants [--sizes 100000 1000000]

Some variants compute wrong results on purpose (they drop a read the
function needs, to time what that read costs); they are timed only, never
used. Each variant is built with ``nvcc`` into ``build/kernels/variants/``,
swapped in for the real kernel, and profiled as ``fd_bench`` profiles it (input
sets rotated through more than the L2). Prints one JSON line per size and
variant. A patch that no longer applies to the source fails loudly. Needs an
NVIDIA GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from . import fd_bench, kernels

_OBSERVER_LOOKUP = "  for (int i = 0; i < kVec; ++i) ss[i] = node_state(p, subj.i[i]);"
_DROP_LOOKUP = ("if (kRandom && ok && subj_state == 3) "
                "ok = !(draw < __ldg(p.drop_prob + subject));")
_EDGE_STEP_CALL = "p, up[i], ss[i], subj.i[i], drop.b[i], draw.f[i],"
_OBSERVER_BOUNDS = "__global__ void __launch_bounds__(kThreads) observer_pass(Params p)"

VARIANTS = {
    "kernel": [],
    # every subject alive and not lossy: no node-state or drop_prob read
    "no_subject_reads": [(_OBSERVER_LOOKUP, "  for (int i = 0; i < kVec; ++i) ss[i] = 2u;")],
    # lossy subjects never read drop_prob
    "no_drop_read": [(_DROP_LOOKUP, "")],
    # the gather pass always takes its no-alert path
    "no_gather_reads": [("const bool gather = *p.any_down != 0;", "const bool gather = false;")],
    # drop_prob read for every lane beside the node state, not after it
    "drop_read_early": [
        (_DROP_LOOKUP, "if (kRandom && ok && subj_state == 3) "
                       "ok = !(draw < __int_as_float(subject));"),
        (_OBSERVER_LOOKUP, _OBSERVER_LOOKUP + "\n  int32_t dp[kVec];\n#pragma unroll\n"
         "  for (int i = 0; i < kVec; ++i)\n"
         "    dp[i] = kRandom ? __float_as_int(__ldg(p.drop_prob + subj.i[i])) : 0;"),
        (_EDGE_STEP_CALL, _EDGE_STEP_CALL.replace("subj.i[i], drop.b[i],", "dp[i], drop.b[i],")),
    ],
    "two_blocks_per_sm": [(_OBSERVER_BOUNDS, _OBSERVER_BOUNDS.replace(
        "(kThreads)", "(kThreads, 2)"))],
    "threads_256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
}


def build_variants() -> dict:
    """Compile every variant, all at once; returns ``{name: library path}``."""
    source = (kernels._CSRC / "fd_phase_fused.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        libs[name] = out_dir / f"{name}.so"
        procs.append((name, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(libs[name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on variant {name}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[100_000, 1_000_000])
    parser.add_argument("--calls", type=int, default=24)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    libs = build_variants()
    real = kernels._function("fd_phase_fused")
    try:
        for c in args.sizes:
            sets = fd_bench.cold_sets(c, True, "cuda")
            for name, path in libs.items():
                fn = ctypes.CDLL(str(path)).fd_phase_fused
                fn.argtypes = kernels._ARGTYPES["fd_phase_fused"]
                fn.restype = ctypes.c_int
                kernels._functions["fd_phase_fused"] = fn
                us = fd_bench.profile_passes(sets, args.calls)
                print(json.dumps({"card": card, "size": [c, 10], "variant": name,
                                  "us_per_call": us, "total_us": sum(us.values())}), flush=True)
            del sets
            torch.cuda.empty_cache()
    finally:
        kernels._functions["fd_phase_fused"] = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
