"""What holds the FD kernels above their byte bound: device time of variants
of their source, each a textual change to ``csrc/fd_phase_fused.cu``.

    python -m rapid_tpu_torch.sim.fd_variants [--sizes 100000 1000000]
        [--variants kernel no_dependent_launch ...]

Some variants compute wrong results on purpose (they drop a read the
function needs, to time what that read costs); they are timed only, never
used. Each variant is built with ``nvcc`` into ``build/kernels/variants/``
and swapped in for the real kernels. For each size and variant it prints one
JSON line: the per-pass device time of ``fd_phase_fused`` as ``fd_bench``
profiles it, and the mesh's kernels over 8 shards (``fd_bench.split_us``:
the per-device ``fd_phase_rows`` call, one shard's call, ``fd_gather``), all
with input sets rotated through more than the L2. The variants run twice,
the second time in reverse order, so that drift on the card shows. A patch
that no longer applies to the source fails loudly. Needs an NVIDIA GPU;
exits non-zero without one.
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
_DROP_LOOKUP = "const float prob = __ldg(p.drop_prob + __ldg(p.subjects + e));"
_WORD = "jax_threefry::uniform(key, e)"
_DRAW_STEP = """    for (; need != 0; need &= need - 1) {
      const int i = __ffs(need) - 1;
      lost |= static_cast<uint32_t>(lost_probe(p, key, first + i)) << i;
    }"""
_LOST_PROBE = "__device__ __forceinline__ bool lost_probe(const Params& p, uint2 key, int64_t e) {"
_OBSERVER_BOUNDS = "__global__ void __launch_bounds__(kThreads) observer_pass(Params p)"

VARIANTS = {
    "kernel": [],
    # every subject alive and not lossy: no node-state or drop_prob read
    "no_subject_reads": [(_OBSERVER_LOOKUP, "  for (int i = 0; i < kVec; ++i) ss[i] = 2u;")],
    # an edge that draws reads neither its subject again nor the subject's
    # drop_prob (every lossy subject's probability taken as 0.5)
    "no_drop_read": [(_DROP_LOOKUP, "const float prob = 0.5f;")],
    # the gather pass always takes its no-alert path
    "no_gather_reads": [("gather = *p.any_down != 0;", "gather = false;")],
    # no threefry: every word taken as 0.5 (what the draws cost)
    "no_draw": [(_WORD, "0.5f")],
    # two edges a step of the draw loop, their loads and threefry chains
    # side by side (a lane with one edge left takes it twice)
    "two_draws_a_step": [(_DRAW_STEP, """    while (need != 0) {
      const int a = __ffs(need) - 1;
      need &= need - 1;
      const int b = need != 0 ? __ffs(need) - 1 : a;
      need &= need - 1;
      lost |= static_cast<uint32_t>(lost_probe(p, key, first + a)) << a |
              static_cast<uint32_t>(lost_probe(p, key, first + b)) << b;
    }""")],
    # drop_prob read for every lane beside the node state, not in the draw
    "drop_read_early": [
        (_DROP_LOOKUP, "const float prob = early;"),
        (_LOST_PROBE, _LOST_PROBE.replace("int64_t e)", "int64_t e, float early)")),
        (_OBSERVER_LOOKUP, _OBSERVER_LOOKUP + "\n  int32_t dp[kVec];\n#pragma unroll\n"
         "  for (int i = 0; i < kVec; ++i)\n"
         "    dp[i] = kRandom ? __float_as_int(__ldg(p.drop_prob + subj.i[i])) : 0;"),
        ("lost_probe(p, key, first + i)", "lost_probe(p, key, first + i, __int_as_float(dp[i]))"),
    ],
    "two_blocks_per_sm": [(_OBSERVER_BOUNDS, _OBSERVER_BOUNDS.replace(
        "(kThreads)", "(kThreads, 2)"))],
    "threads_256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
    # fd_phase_rows' observer pass launched after the node pass has ended
    "no_dependent_launch": [("constexpr bool kDependentLaunch = true;",
                             "constexpr bool kDependentLaunch = false;")],
    # blocks of 128 threads for the mesh's kernels
    "split_threads_128": [("constexpr int kSplitThreads = 64;",
                           "constexpr int kSplitThreads = 128;")],
}
# the functions each variant library replaces
_SWAPPED = ("fd_phase_fused", "fd_phase_rows", "fd_gather")
SPLIT_SHARDS = 8  # the mesh of chip_smoke.py's split timings


def build_variants(names=tuple(VARIANTS)) -> dict:
    """Compile the variants ``names``, all at once; returns ``{name: library
    path}``."""
    source = (kernels._CSRC / "fd_phase_fused.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for name in names:
        patches = VARIANTS[name]
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        libs[name] = out_dir / f"{name}.so"
        procs.append((name, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *kernels.include_flags(), "-o",
             str(libs[name]), str(src)],
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
    parser.add_argument("--variants", nargs="+", choices=sorted(VARIANTS), default=list(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(args.variants)
    real = {name: kernels._function(name) for name in _SWAPPED}
    try:
        for c in args.sizes:
            sets = fd_bench.cold_sets(c, True, "cuda")
            for r in range(2):
                for name in args.variants[::-1] if r % 2 else args.variants:
                    lib = ctypes.CDLL(str(libs[name]))
                    for fn_name in _SWAPPED:
                        fn = getattr(lib, fn_name)
                        fn.argtypes = kernels._ARGTYPES[fn_name]
                        fn.restype = ctypes.c_int
                        kernels._functions[fn_name] = fn
                    us = fd_bench.profile_passes(sets, args.calls)
                    print(json.dumps({"card": card, "size": [c, 10], "variant": name,
                                      "round": r, "us_per_call": us,
                                      "total_us": sum(us.values()),
                                      "split_us": fd_bench.split_us(sets, SPLIT_SHARDS),
                                      "shards": SPLIT_SHARDS}), flush=True)
            del sets
            torch.cuda.empty_cache()
    finally:
        kernels._functions.update(real)
    return 0


if __name__ == "__main__":
    sys.exit(main())
