"""What holds ``placement_topr`` above its bound: device time of variants of
its source, each a textual change to ``csrc/placement_topr.cu``, and of the
kernel under other launch plans than ``topr_plan``'s.

    python -m rapid_tpu_torch.placement.topr_variants [--shapes full weighted
        merge view] [--variants kernel no_admission ...] [--plans]

The shapes are ``chip_smoke.py``'s: the full build [8192, 100 000] (R 3, one
instance row, 1% inactive), the weighted map [1024, 100 000] (weights 1-8),
the merge of 1000 added columns into 8192 rows, and a view change's 233 rows
x 100 000. Some variants compute wrong results on purpose (they skip work the
function needs, to time what that work costs); they are timed only, never
used, and their lines say ``"exact": false``. Each variant is built with
``nvcc`` into ``build/kernels/variants/`` and swapped in for the real kernel.
With ``--plans`` the kernel also runs under every column split (1, 2, 4, 8)
and cluster size (4, 8, 12, 16) at the plan's tile. Every time is the hot
device time of one call (CUDA-graph replays, ``fd_bench.graph_ms``); the
variants run twice, the second time in reverse order, so that drift on the
card shows. A patch that no longer applies fails loudly. Needs an NVIDIA
GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..sim import fd_bench, kernels
from . import device as pdev

_SCORE = "    score(t_begin + t, t % kStages);"
_ADMIT_ONE = ("        if (__any_sync(0xFFFFFFFFu, group_max(sv) >= thr))\n"
              "          admit<R, kGroup>")
_ADMIT_W = ("        if (__any_sync(0xFFFFFFFFu, group_max(sv) >= thr))\n"
            "          admit<R, kGroupW>")

VARIANTS = {
    "kernel": [],
    # no part takes the floor the parts of its row share
    "no_shared_floor": [("  const bool share = a.prior == nullptr && a.slices * split > 1;",
                         "  const bool share = false;")],
    # never admit: what the admissions cost (wrong results)
    "no_admission": [(_ADMIT_ONE, _ADMIT_ONE.replace(">= thr))", ">= thr) && key == 0x12345u)")),
                     (_ADMIT_W, _ADMIT_W.replace(">= thr))", ">= thr) && key == 0x12345u)"))],
    # each tile scored twice: what one scoring pass costs (wrong results)
    "score_twice": [(_SCORE, _SCORE + "\n" + _SCORE)],
    # no tile scored: the ring, the conversions and the merges alone (wrong results)
    "no_score": [(_SCORE, "    if (key == 0x12345u) score(t_begin + t, t % kStages);")],
    # groups of 8 columns with several instance rows
    "weight_groups_8": [("constexpr int kGroupW = 4;", "constexpr int kGroupW = 8;")],
}
EXACT = {"kernel", "no_shared_floor", "weight_groups_8"}

# (rows, columns, replicas, weights from..to, inactive share, merged columns)
SHAPES = {
    "full": (8192, 100_000, 3, (1, 1), 0.01, None),
    "weighted": (1024, 100_000, 3, (1, 8), 0.01, None),
    "merge": (8192, 100_000, 3, (1, 1), 0.01, 1000),
    "view": (233, 100_000, 3, (1, 1), 0.01, None),
}


def build_variants(names=tuple(VARIANTS)) -> dict:
    """Compile the variants ``names``, all at once; returns ``{name: library
    path}``."""
    source = (kernels._CSRC / "placement_topr.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"topr_{name}.cu"
        src.write_text(text)
        libs[name] = out_dir / f"topr_{name}.so"
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


def shape_inputs(name: str, seed: int = 1) -> tuple:
    """(part, inst, weights, active, replicas, keyword arguments) of a shape,
    made from ``seed`` on the card; the merge's prior is the plain version's
    map of its rows."""
    rows, cols, r, weights, inactive, added = SHAPES[name]
    rng = np.random.default_rng(seed)
    w = rng.integers(weights[0], weights[1] + 1, cols).astype(np.int32)

    def u32(shape):
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).cuda()

    part, inst = u32(rows), u32((int(w.max()), cols))
    active = torch.from_numpy(rng.random(cols) >= inactive).cuda()
    weights_t = torch.from_numpy(w).cuda()
    kw = {}
    if added is not None:
        kw = {"cols": torch.from_numpy(np.sort(rng.choice(cols, added, replace=False))
                                       .astype(np.int32)).cuda(),
              "prior": pdev.placement_topr_plain(part, inst, weights_t, active, r)}
    return part, inst, weights_t, active, r, kw


def other_plans(plan: pdev.ToprPlan, rows: int) -> dict:
    """The kernel's plan and the others at its tile: every column split and
    cluster size of 4, 8, 12 and 16 that the columns allow."""
    plans = {"plan": plan}
    for split in (1, 2, 4, 8):
        for s in (4, 8, 12, 16):
            if s <= plan.col_tiles:
                plans[f"split {split}, {s} slices"] = pdev.ToprPlan(
                    split, -(-rows // (pdev.TOPR_THREADS // split)), s, plan.tile_cols,
                    plan.col_tiles, plan.smem_bytes)
    return plans


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=list(SHAPES))
    parser.add_argument("--variants", nargs="+", choices=sorted(VARIANTS), default=list(VARIANTS))
    parser.add_argument("--plans", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("topr_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(args.variants)
    real = kernels._function("placement_topr")
    try:
        for shape in args.shapes:
            part, inst, w, active, r, kw = shape_inputs(shape)
            mask = None if kw else active
            want = pdev.placement_topr_plain(part, inst, w, mask, r, **kw)
            n_cols = kw["cols"].numel() if kw else inst.shape[1]
            plan = pdev.topr_plan(part.shape[0], n_cols, r, inst.shape[0], bool(kw))
            plans = (other_plans(plan, part.shape[0]) if args.plans
                     else {"plan": plan})
            for rnd in range(2):
                for name in args.variants[::-1] if rnd else args.variants:
                    fn = ctypes.CDLL(str(libs[name])).placement_topr
                    fn.argtypes = kernels._ARGTYPES["placement_topr"]
                    fn.restype = ctypes.c_int
                    kernels._functions["placement_topr"] = fn
                    for label, p in plans.items():
                        if label != "plan" and name != "kernel":
                            continue

                        def call(p=p):
                            return pdev._placement_topr(part, inst, w, mask, r, plan=p, **kw)

                        exact = bool(torch.equal(call(), want))
                        if name in EXACT and not exact:
                            raise RuntimeError(f"{name} disagrees with the plain version: {shape}")
                        us = fd_bench.graph_ms(call, 8, 5) * 1e3
                        print(json.dumps({"card": card, "shape": shape, "variant": name,
                                          "plan": label, "round": rnd, "us": us,
                                          "exact": exact, "grid": p.grid,
                                          "col_split": p.col_split, "slices": p.slices,
                                          "tile_cols": p.tile_cols}), flush=True)
            del part, inst, w, active, kw, want
            torch.cuda.empty_cache()
    finally:
        kernels._functions["placement_topr"] = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
