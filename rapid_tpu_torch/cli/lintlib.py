"""Shared plumbing for the port's stdlib-only static analyzers.

The port's counterpart of ``tools/lintlib.py``, unchanged in behaviour. The
three analyzers -- ``cli/check.py`` (general code health + the port's catalog
lints), ``cli/concur.py`` (concurrency correctness) and ``cli/devlint.py``
(the device plane's host syncs, builds, dtypes and buffer ownership) --
report through one Finding type, honor the same ``# noqa`` / ``# noqa: RULE``
suppression syntax (rule names case-insensitive, comma-separated), and scan
the same file universe. Keeping that here means a suppression or a path
exclusion behaves identically no matter which tool surfaced the finding, and
``python -m rapid_tpu_torch.cli.check --all`` can merge the reports into one
exit code.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Set

REPO = Path(__file__).resolve().parent.parent.parent

# directories whose .py files are deliberately bad examples (analyzer
# regression fixtures) or generated -- never part of a default scan
EXCLUDED_DIR_NAMES = {"fixtures", "__pycache__", ".git"}


class Finding:
    def __init__(self, path: Path, line: int, rule: str, msg: str) -> None:
        self.path, self.line, self.rule, self.msg = Path(path), line, rule, msg

    def __str__(self) -> str:
        try:
            rel = self.path.relative_to(REPO)
        except ValueError:
            rel = self.path
        return f"{rel}:{self.line}: {self.rule} {self.msg}"

    def __repr__(self) -> str:
        return f"Finding({self})"


def noqa_lines(source: str) -> Dict[int, Set[str]]:
    """line -> suppressed rule names, lowercased ('*' = suppress all)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        if "# noqa" not in line:
            continue
        _, _, tail = line.partition("# noqa")
        tail = tail.strip()
        if tail.startswith(":"):
            out[i] = {r.strip().lower() for r in tail[1:].split(",")}
        else:
            out[i] = {"*"}
    return out


def suppressed(noqa: Dict[int, Set[str]], line: int, rule: str) -> bool:
    rules = noqa.get(line, set())
    return "*" in rules or rule.lower() in rules


def iter_py_files(roots: Iterable[Path]) -> List[Path]:
    """Every .py file under the given roots, fixtures/caches excluded,
    sorted for deterministic reports."""
    files: List[Path] = []
    for root in roots:
        root = (REPO / root) if not root.is_absolute() else root
        if root.is_dir():
            for f in sorted(root.rglob("*.py")):
                if not EXCLUDED_DIR_NAMES & set(f.parts):
                    files.append(f)
        elif root.exists():
            files.append(root)
    return files


def parse(path: Path) -> "tuple[str, ast.Module]":
    source = path.read_text()
    return source, ast.parse(source, filename=str(path))
