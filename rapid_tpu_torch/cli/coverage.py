"""Line coverage of the port over its fast test tier.

The port's counterpart of ``tools/coverage.py``: it measures
``rapid_tpu_torch`` over ``tests/test_torch_*.py``. Preferred path:

    python -m pytest tests/test_torch_*.py -q -m 'not slow' --cov=rapid_tpu_torch

when pytest-cov is installed: then it execs exactly that command. Without
it, it measures line coverage itself with a stdlib ``sys.settrace`` collector (installed on
the main thread and, via ``threading.settrace``, on every transport/timer
thread) and runs the same fast tier in-process. Child *processes* (the
multiprocess batteries) are not traced either way -- same blind spot
pytest-cov has without its subprocess rc hook.

Usage:
    JAX_PLATFORMS=cpu python -m rapid_tpu_torch.cli.coverage [-o REPORT.md] [pytest args]

Prints the totals, and writes a per-file / per-package markdown summary only
where ``-o`` says (under pytest-cov, its own terminal report instead);
``COVERAGE.md`` is the JAX package's report, never written here. Exit
status is pytest's.
"""

from __future__ import annotations

import glob
import os
import sys
import threading
from typing import Dict, Optional, Set

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

# filename -> executed line numbers; one set per file, shared across threads
# (set mutation is atomic under the GIL, so no lock on the hot path)
_HITS: Dict[str, Set[int]] = {}
# code object -> its not-yet-hit lines; once empty the code object goes in
# _DONE and its frames are never traced again -- this is what keeps the
# settrace overhead tolerable (~2x instead of ~13x): hot protocol loops pay
# for line events only until every line has been seen once
_REMAINING: Dict[object, Set[int]] = {}
_DONE: Set[object] = set()


def _code_lines(code) -> Set[int]:
    return {line for _, _, line in code.co_lines() if line is not None}


def _trace(frame, event, arg):
    code = frame.f_code
    filename = code.co_filename
    if not filename.startswith(PKG):
        return None  # never re-enter for frames outside the package
    if code in _DONE:
        return None
    remaining = _REMAINING.get(code)
    if remaining is None:
        hits = _HITS.setdefault(filename, set())
        remaining = _REMAINING.setdefault(code, _code_lines(code) - hits)
    if event in ("call", "line"):
        lineno = frame.f_lineno
        _HITS[filename].add(lineno)
        remaining.discard(lineno)
        if not remaining:
            _DONE.add(code)
            frame.f_trace_lines = False
            return None
    return _trace


def _executable_lines(path: str) -> Set[int]:
    """Every line the compiler emits code for, via co_lines() over the whole
    code-object tree -- the same statement universe coverage.py reports."""
    with open(path, "rb") as fh:
        source = fh.read()
    lines: Set[int] = set()
    try:
        top = compile(source, path, "exec")
    except SyntaxError:
        return lines
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, line in code.co_lines():
            if line is not None:
                lines.add(line)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    # the module's synthetic trailing RETURN maps to line 1 even for files
    # whose line 1 is a docstring/comment; keep it, it is executed anyway
    return lines


def _collect_sources() -> Dict[str, Set[int]]:
    out: Dict[str, Set[int]] = {}
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                out[path] = _executable_lines(path)
    return out


def _summarize(sources: Dict[str, Set[int]], out_path: Optional[str]) -> None:
    rows = []
    for path in sorted(sources):
        total = len(sources[path])
        hit = len(_HITS.get(path, set()) & sources[path])
        rows.append((os.path.relpath(path, REPO), total, hit))
    packages: Dict[str, list] = {}
    for rel, total, hit in rows:
        pkg = os.path.dirname(rel)
        packages.setdefault(pkg, [0, 0])
        packages[pkg][0] += total
        packages[pkg][1] += hit

    def pct(hit, total):
        return 100.0 * hit / total if total else 100.0

    grand_total = sum(t for _, t, _ in rows)
    grand_hit = sum(h for _, _, h in rows)
    lines = [
        "# Fast-tier line coverage",
        "",
        "Generated by `python -m rapid_tpu_torch.cli.coverage` (stdlib settrace"
        " collector; `pytest --cov=rapid_tpu_torch` when pytest-cov is"
        " installed) over `pytest tests/test_torch_*.py -m 'not slow'`.",
        "",
        f"**Total: {grand_hit}/{grand_total} lines"
        f" ({pct(grand_hit, grand_total):.1f}%)**",
        "",
        "| package | lines | covered | % |",
        "|---|---:|---:|---:|",
    ]
    for pkg in sorted(packages):
        total, hit = packages[pkg]
        lines.append(f"| {pkg} | {total} | {hit} | {pct(hit, total):.1f} |")
    lines += ["", "| file | lines | covered | % |", "|---|---:|---:|---:|"]
    for rel, total, hit in rows:
        lines.append(f"| {rel} | {total} | {hit} | {pct(hit, total):.1f} |")
    lines.append("")
    if out_path is not None:
        with open(out_path, "w") as fh:
            fh.write("\n".join(lines))
    print(f"coverage: {grand_hit}/{grand_total} lines "
          f"({pct(grand_hit, grand_total):.1f}%)"
          + (f" -> {out_path}" if out_path is not None else ""))


def main() -> int:
    args = sys.argv[1:]
    out_path = None
    if "-o" in args:
        at = args.index("-o")
        out_path = os.path.abspath(args[at + 1])
        del args[at : at + 2]
    os.chdir(REPO)
    pytest_args = args or [
        *sorted(glob.glob("tests/test_torch_*.py")), "-q", "-m", "not slow",
        "--continue-on-collection-errors", "-p", "no:cacheprovider",
    ]
    import importlib.util

    if importlib.util.find_spec("pytest_cov") is not None:
        os.execvp(sys.executable, [
            sys.executable, "-m", "pytest", "--cov=rapid_tpu_torch",
            "--cov-report=term", *pytest_args,
        ])
    sys.path.insert(0, REPO)
    import pytest

    threading.settrace(_trace)
    sys.settrace(_trace)
    try:
        status = pytest.main(pytest_args)
    finally:
        sys.settrace(None)
        threading.settrace(None)  # type: ignore[arg-type]
    sources = _collect_sources()
    _summarize(sources, out_path)
    return int(status)


if __name__ == "__main__":
    raise SystemExit(main())
