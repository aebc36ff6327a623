"""Static-analysis tier of the port (stdlib-only): the merge gate.

The port's counterpart of ``tools/check.py``: the same rules over the port's
own files and catalogs. It byte-compiles every file and enforces a focused,
high-signal AST rule set (unused imports, mutable default arguments, bare
excepts, ``== None`` comparisons, always-true tuple asserts, duplicate dict
keys, debugger/print leftovers in library code), plus the catalog lints,
which read the port's catalogs: ``rapid_tpu_torch/observability.py``'s
METRIC_CATALOG, SPAN_CATALOG and EVENT_CATALOG, ``settings.py``'s
SETTINGS_CATALOG, ``faults.py``'s RULE_CATALOG and ``search/generator.py``'s
GEN_RULES, ``types.py`` and ``messaging/``'s wire tags,
``forensics/timeline.py``'s SIGNATURE_CATALOG, ``slo/burn.py``'s SLO
catalog, and the pinned plans of ``scenarios/corpus/``, each also loaded
through the port's ``FaultPlan.from_json``.

Concurrency hygiene rules that belong with general code health live here too
(thread-daemon, callback-under-lock); the deep concurrency analysis (lock
graphs, write contexts, capture purity) is ``cli/concur.py``, and the
device-plane performance analysis (host syncs, kernel builds, dtype
discipline, host buffer ownership) is ``cli/devlint.py``. ``--all`` runs all
three with one merged exit code (``check+concur+devlint: OK``). Rule names
and one-line rationales: RULE_DOCS below (printed by ``--rules``).

``print`` is the interface of the port's CLIs, experiments, examples and
measurement scripts (PRINT_OK_ROOTS, PRINT_OK_FILES), of the tests and of
``chip_smoke.py``; anywhere else it is a finding.

Suppress a single line with ``# noqa`` or ``# noqa: RULE`` (rule names are
case-insensitive; shared with ``cli/concur.py`` and ``cli/devlint.py``
through ``cli/lintlib.py``).

Usage: python -m rapid_tpu_torch.cli.check [--all|--rules] [paths...]
       (default paths: DEFAULT_PATHS, the port's files)
"""

from __future__ import annotations

import ast
import importlib.util
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lintlib import REPO, Finding, iter_py_files, noqa_lines, suppressed
else:  # pragma: no cover - imported as a package module
    from .lintlib import REPO, Finding, iter_py_files, noqa_lines, suppressed

PKG = REPO / "rapid_tpu_torch"
# the port's files; glob patterns are expanded under the repo root
DEFAULT_PATHS = ["rapid_tpu_torch", "tests/test_torch_*.py", "tests/torch_gate.py",
                 "tests/golden/generate_torch_*.py", "chip_smoke.py"]

# one-line rationale per rule, both analyzers (`--rules` prints this)
RULE_DOCS = {
    # cli/check.py -- code health
    "syntax": "file must byte-compile; everything else assumes it does",
    "unused-import": "dead imports hide real dependencies and slow startup",
    "mutable-default": "def f(x=[]) shares one list across all calls",
    "bare-except": "except: swallows KeyboardInterrupt/SystemExit too",
    "none-compare": "== None matches __eq__ overrides; use 'is None'",
    "assert-tuple": "assert (x, msg) is always true -- a silent no-op test",
    "dup-dict-key": "duplicate literal keys: the first value silently loses",
    "print-in-lib": "library code must log or record, not print",
    "debugger": "breakpoint()/pdb left in committed code",
    "unknown-metric": "metric names outside the catalog fork the series",
    "unknown-span": "span/event names outside the catalog fork the trace",
    "wire-tag": "wire tags must stay unique and append-only across versions",
    "fault-catalog": "fault rules must declare a compiled/absorbed story",
    "plan-corpus": "pinned nemesis plans must stay loadable: known rule "
                   "types, sane windows/probabilities, a known harness",
    "gen-reach": "every fault Rule subclass must be reachable by the search "
                 "generator (GEN_RULES), or new faults stay untested",
    "settings-catalog": "every cataloged settings knob must be in "
                        "SETTINGS_CATALOG with bounds its default "
                        "satisfies, or operators tune blind",
    "metric-emission": "every METRIC_CATALOG name needs an emitting call "
                       "site and every emission a catalog entry, or the "
                       "catalog and the dashboards drift apart",
    "event-emission": "every EVENT_CATALOG kind needs an emitting call site "
                      "and every journal/instant emission a catalog entry, "
                      "or post-mortems grep for events that never happen",
    "signature-catalog": "every anomaly signature needs a detector that "
                         "emits it and every detector finding a catalog "
                         "row, or forensic reports cite undocumented "
                         "signatures",
    "slo-catalog": "every declared SLO must name a cataloged SLI and a "
                   "valid window pair with sane thresholds, or the burn "
                   "alerts evaluate garbage",
    # cli/check.py -- concurrency hygiene
    "thread-daemon": "a non-daemon thread outlives shutdown and hangs exit; "
                     "mark daemon=True or provably join it",
    "messaging-thread": "rapid_tpu_torch/messaging/ runs on the reactor event "
                        "loop; new Thread constructions there (outside "
                        "reactor.py) re-grow the thread-per-message design",
    "callback-under-lock": "user callbacks invoked under a lock can re-enter "
                           "and deadlock; call them after release",
    # cli/concur.py -- concurrency correctness
    "lock-order": "a cycle in the held->acquired lock graph is a potential "
                  "deadlock; keep the hierarchy acyclic",
    "unguarded-write": "an attribute written from >=2 execution contexts "
                       "with no common lock is a data race",
    "blocking-under-lock": "blocking (socket/sleep/result/wait/join) while "
                           "holding a lock stalls every other acquirer",
    "unbalanced-acquire": "manual acquire() without release() in a finally "
                          "leaks the lock on any exception; use 'with'",
    "jit-purity": "side effects in a CUDA-graph capture or a torch.compile/"
                  "torch.jit function run once at capture, then never "
                  "again on replay -- silent wrong results",
    # cli/devlint.py -- device-plane performance
    "recompile-hazard": "a kernel build or library load on every call, or a "
                        "torch.compile behind jitwatch's back, costs seconds "
                        "in steady state",
    "host-sync": ".item()/.cpu()/int()/masks/scalar writes on a tensor are a "
                 "blocking round trip; route through jitwatch.fetch/drain",
    "dtype-discipline": "dtype-less torch factories and silent widening of "
                        "the uint8 state fields change what the kernels read",
    "donation-hygiene": "a tensor over a host array the simulator keeps writing "
                        "aliases it on the CPU; copy, or declare ownership",
}

# where `print` is the intended UI: the port's CLIs, experiments and
# examples, its measurement scripts, the tests and the card's smoke script
PRINT_OK_ROOTS = ("rapid_tpu_torch/cli", "rapid_tpu_torch/experiments",
                  "rapid_tpu_torch/examples", "tests")
PRINT_OK_FILES = {"rapid_tpu_torch/sim/fd_bench.py", "rapid_tpu_torch/sim/fd_variants.py",
                  "rapid_tpu_torch/sim/profile_decision.py",
                  "rapid_tpu_torch/placement/topr_variants.py", "chip_smoke.py"}


def _load_catalogs() -> "tuple[frozenset, tuple, frozenset, frozenset]":
    """METRIC_CATALOG / METRIC_PREFIXES / SPAN_CATALOG / EVENT_CATALOG from
    rapid_tpu_torch/observability.py, loaded as a standalone module
    (observability.py is stdlib-only at module level)."""
    spec = importlib.util.spec_from_file_location(
        "_rapid_torch_observability", PKG / "observability.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclass processing resolves __module__
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return (mod.METRIC_CATALOG, mod.METRIC_PREFIXES, mod.SPAN_CATALOG,
            mod.EVENT_CATALOG)


METRIC_CATALOG, METRIC_PREFIXES, SPAN_CATALOG, EVENT_CATALOG = _load_catalogs()

# tracer/journal call sites whose literal first argument must come from the
# matching catalog: .span/.begin/.remote_span mint spans (SPAN_CATALOG),
# .event mints instants and .record journals flight-recorder entries
# (EVENT_CATALOG). A typo'd name would silently fork a trace/journal series
# exactly like a typo'd metric name.
SPAN_METHODS = ("span", "begin", "remote_span")
EVENT_METHODS = ("event", "record")


class Checker(ast.NodeVisitor):
    def __init__(self, path: Path, source: str, tree: ast.Module) -> None:
        self.path = path
        self.tree = tree
        self.findings: list[Finding] = []
        self._noqa = noqa_lines(source)
        rel = path.relative_to(REPO)
        self.print_ok = (
            rel.as_posix().startswith(tuple(r + "/" for r in PRINT_OK_ROOTS))
            or rel.as_posix() in PRINT_OK_FILES
        )
        # the metric-name lint applies to library code only: test fixtures
        # mint throwaway names, and observability.py defines the catalog
        self.metric_names_checked = (
            rel.parts[0] == "rapid_tpu_torch" and rel.name != "observability.py"
        )

    def report(self, node: ast.AST, rule: str, msg: str) -> None:
        line = getattr(node, "lineno", 0)
        if suppressed(self._noqa, line, rule):
            return
        self.findings.append(Finding(self.path, line, rule, msg))

    # -- unused imports ----------------------------------------------------

    def check_unused_imports(self) -> None:
        nodes = list(ast.walk(self.tree))  # one walk for the three passes
        imported: dict[str, ast.AST] = {}
        for node in nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    imported[name] = node
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    imported[alias.asname or alias.name] = node

        used: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                base = node
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name):
                    used.add(base.id)
        # names re-exported via __all__ count as used
        for node in self.tree.body:
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets
                )
                and isinstance(node.value, (ast.List, ast.Tuple))
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        used.add(elt.value)
        # string annotations (from __future__ import annotations) reference
        # names the walker cannot see; treat annotation strings as usage
        for node in nodes:
            ann = getattr(node, "annotation", None)
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                used.update(
                    part for part in ann.value.replace("[", " ")
                    .replace("]", " ").replace(",", " ").replace(".", " ").split()
                )
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ret = node.returns
                if isinstance(ret, ast.Constant) and isinstance(ret.value, str):
                    used.update(
                        part for part in ret.value.replace("[", " ")
                        .replace("]", " ").replace(",", " ").replace(".", " ").split()
                    )
        for name, node in imported.items():
            if name not in used:
                self.report(node, "unused-import", f"'{name}' imported but unused")

    # -- node rules --------------------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_defaults(self, node) -> None:
        for default in list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                self.report(
                    default, "mutable-default",
                    f"mutable default argument in {node.name}()",
                )

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.report(node, "bare-except", "bare 'except:' hides SystemExit")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        for op, comparator in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)) and (
                isinstance(comparator, ast.Constant) and comparator.value is None
            ):
                self.report(node, "none-compare", "use 'is None' / 'is not None'")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if isinstance(node.test, ast.Tuple) and node.test.elts:
            self.report(node, "assert-tuple", "assert on tuple is always true")
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict) -> None:
        seen: set = set()
        for key in node.keys:
            if isinstance(key, ast.Constant):
                try:
                    if key.value in seen:
                        self.report(key, "dup-dict-key",
                                    f"duplicate dict key {key.value!r}")
                    seen.add(key.value)
                except TypeError:
                    pass
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "print" and not self.print_ok:
            self.report(node, "print-in-lib",
                        "print() in library code; use logging")
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "set_trace"
        ):
            self.report(node, "debugger", "debugger breakpoint left in code")
        if (
            self.metric_names_checked
            and isinstance(func, ast.Attribute)
            and func.attr in ("incr", "observe", "set_gauge")
            and node.args
        ):
            self._check_metric_name(node, node.args[0])
        if (
            self.metric_names_checked
            and isinstance(func, ast.Attribute)
            and func.attr in SPAN_METHODS + EVENT_METHODS
            and node.args
        ):
            self._check_span_name(node, func.attr, node.args[0])
        self.generic_visit(node)

    def _check_span_name(self, call: ast.Call, method: str,
                         arg: ast.expr) -> None:
        """Literal span names must be in SPAN_CATALOG, literal event/journal
        kinds in EVENT_CATALOG. Dynamic names are skipped, same policy as the
        metric lint."""
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            return
        catalog, label = (
            (SPAN_CATALOG, "SPAN_CATALOG")
            if method in SPAN_METHODS
            else (EVENT_CATALOG, "EVENT_CATALOG")
        )
        if arg.value not in catalog:
            self.report(
                call, "unknown-span",
                f"{method}() name {arg.value!r} not in "
                f"observability.{label}",
            )

    def _check_metric_name(self, call: ast.Call, arg: ast.expr) -> None:
        """Every .incr()/.observe()/.set_gauge() call site in library code
        must use a name from observability.METRIC_CATALOG (or a METRIC_PREFIXES
        dynamic family, e.g. f"messages.{...}"). Dynamic names built from
        variables are skipped -- the lint targets the literal call sites
        where a typo would silently fork a metric series."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if name not in METRIC_CATALOG and not name.startswith(METRIC_PREFIXES):
                self.report(
                    call, "unknown-metric",
                    f"metric name {name!r} not in observability.METRIC_CATALOG",
                )
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0] if arg.values else None
            if not (
                isinstance(head, ast.Constant)
                and isinstance(head.value, str)
                and head.value.startswith(METRIC_PREFIXES)
            ):
                self.report(
                    call, "unknown-metric",
                    "f-string metric name must start with a METRIC_PREFIXES "
                    f"prefix ({', '.join(METRIC_PREFIXES)})",
                )


def _module_literals(path: Path, wanted: set) -> dict:
    """Top-level ``NAME = <literal>`` assignments (plain or annotated) from a
    file, without importing it: {name: (value, lineno)}."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            target, value = node.target.id, node.value
        else:
            continue
        if target in wanted and value is not None:
            try:
                out[target] = (ast.literal_eval(value), node.lineno)
            except ValueError:
                pass
    return out


def check_wire_tags() -> list[Finding]:
    """Wire-numbering lint over the messaging schema tables.

    The msgpack codec's tags are _TYPES list indices and the gRPC envelope's
    oneof numbers are hand-maintained literals; a duplicate or colliding
    number would decode one message type as another with no error at the
    call site. Asserts: codec._TYPES entries are unique; every wire_schema
    message uses each field number and name once; each oneof's numbers are
    unique AND contiguous from 1 (so a new message -- e.g. the handoff
    messages after ClusterStatus -- must take the next number, never a gap
    or a reuse), EXCEPT that the request oneof may skip
    the reserved envelope-rider numbers (TRACE_CTX_FIELD_NUMBER,
    HLC_FIELD_NUMBER), which ride outside the oneof on the same envelope
    and whose numbers are therefore reserved; no oneof number collides
    with one of them outright. Msgpack-side: no dataclass field of any
    codec-carried message may start with ``__`` -- decode strips every
    ``__``-prefixed top-level key as an envelope extension, so such a
    field would silently vanish on the wire."""
    findings: list[Finding] = []
    msg_dir = PKG / "messaging"
    codec_path = msg_dir / "codec.py"
    schema_path = msg_dir / "wire_schema.py"
    types_path = PKG / "types.py"

    tree = ast.parse(codec_path.read_text(), filename=str(codec_path))
    codec_type_names: set = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if (
            any(
                isinstance(t, ast.Name) and t.id == "_TYPES"
                for t in targets
            )
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            seen: dict = {}
            for i, elt in enumerate(node.value.elts):
                name = (
                    elt.attr if isinstance(elt, ast.Attribute)
                    else getattr(elt, "id", None)
                )
                if name is None:
                    continue
                if name in seen:
                    findings.append(Finding(
                        codec_path, elt.lineno, "wire-tags",
                        f"codec._TYPES lists {name!r} at tags {seen[name]} "
                        f"and {i}; duplicates make encoding ambiguous",
                    ))
                seen[name] = i
            codec_type_names = set(seen)
            break
    else:
        findings.append(Finding(
            codec_path, 0, "wire-tags", "codec._TYPES not found"
        ))

    # msgpack reserved-key collision: the codec encodes each message as a
    # dict keyed by dataclass field names and decode() strips every
    # "__"-prefixed top-level key (envelope extensions like "__tc"), so a
    # codec-carried dataclass field named "__anything" would be silently
    # dropped by every decoder
    types_tree = ast.parse(types_path.read_text(), filename=str(types_path))
    for node in types_tree.body:
        if not (isinstance(node, ast.ClassDef)
                and node.name in codec_type_names):
            continue
        for stmt in node.body:
            if (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.target.id.startswith("__")
            ):
                findings.append(Finding(
                    types_path, stmt.lineno, "wire-tags",
                    f"{node.name}.{stmt.target.id} collides with the "
                    "codec's reserved '__' envelope-key namespace: decoders "
                    "strip it, so the field never survives the wire",
                ))

    wanted = {"_MESSAGES", "_REQUEST_ONEOF", "_RESPONSE_ONEOF",
              "TRACE_CTX_FIELD_NUMBER", "HLC_FIELD_NUMBER"}
    lits = _module_literals(schema_path, wanted)
    for name in sorted(wanted - lits.keys()):
        findings.append(Finding(
            schema_path, 0, "wire-tags",
            f"wire_schema.{name} not found or not a pure literal",
        ))

    messages = lits.get("_MESSAGES", ({}, 0))[0]
    if messages:
        line = lits["_MESSAGES"][1]
        for msg_name, fields in messages.items():
            numbers = [number for _, _, number, _ in fields]
            names = [field_name for field_name, _, _, _ in fields]
            for number in sorted({n for n in numbers if numbers.count(n) > 1}):
                findings.append(Finding(
                    schema_path, line, "wire-tags",
                    f"{msg_name} uses field number {number} more than once",
                ))
            for field_name in sorted({n for n in names if names.count(n) > 1}):
                findings.append(Finding(
                    schema_path, line, "wire-tags",
                    f"{msg_name} declares field {field_name!r} more than once",
                ))
            for number in numbers:
                if number < 1:
                    findings.append(Finding(
                        schema_path, line, "wire-tags",
                        f"{msg_name} uses invalid field number {number}",
                    ))

    # numbers reserved for the envelope riders (traceCtx, hlc): they sit on
    # RapidRequest outside the oneof, so the oneof must skip them, never
    # reuse them. Each new rider appends its NAME here and its number at
    # the top of the envelope's free space, exactly like a proto
    # `reserved` declaration.
    reserved = {
        name: lits[name][0]
        for name in ("TRACE_CTX_FIELD_NUMBER", "HLC_FIELD_NUMBER")
        if name in lits
    }
    reserved_numbers = set(reserved.values())
    for oneof_name in ("_REQUEST_ONEOF", "_RESPONSE_ONEOF"):
        if oneof_name not in lits:
            continue
        entries, line = lits[oneof_name]
        numbers = [number for _, _, number in entries]
        if len(set(numbers)) != len(numbers):
            findings.append(Finding(
                schema_path, line, "wire-tags",
                f"{oneof_name} reuses a field number: {sorted(numbers)}",
            ))
        # contiguity from 1, with one documented exception: the request
        # oneof skips every reserved envelope-rider number (they live
        # outside the oneof on the same envelope, so reserved, not free)
        expected: list = []
        candidate = 1
        while len(expected) < len(numbers):
            if not (
                oneof_name == "_REQUEST_ONEOF"
                and candidate in reserved_numbers
            ):
                expected.append(candidate)
            candidate += 1
        if sorted(numbers) != expected:
            findings.append(Finding(
                schema_path, line, "wire-tags",
                f"{oneof_name} numbers {sorted(numbers)} are not contiguous "
                "from 1 (modulo the reserved envelope-rider numbers "
                f"{sorted(reserved_numbers)}); new messages must take the "
                "next free number",
            ))
        for rider, number in sorted(reserved.items()):
            if number in numbers:
                findings.append(Finding(
                    schema_path, line, "wire-tags",
                    f"{oneof_name} number {number} collides with "
                    f"{rider} (rides outside the oneof)",
                ))
    if len(reserved_numbers) != len(reserved):
        findings.append(Finding(
            schema_path, 0, "wire-tags",
            "two envelope riders share one reserved field number: "
            f"{sorted(reserved.items())}",
        ))
        if messages:
            for _, type_name, _ in entries:
                if type_name not in messages:
                    findings.append(Finding(
                        schema_path, line, "wire-tags",
                        f"{oneof_name} references unknown message "
                        f"{type_name!r}",
                    ))
    return findings


def check_fault_rules() -> list[Finding]:
    """Fault-rule catalog lint over rapid_tpu_torch/faults.py.

    Every Rule subclass must have a device-plane story: an entry in
    RULE_CATALOG saying whether _device_rules compiles it onto the fault
    arrays ("compiled") or the round model absorbs it ("absorbed"). A rule
    class added without a catalog entry would silently skip the device
    plane's three-way parity contract; a stale entry would document a rule
    that no longer exists. (The companion constraint -- every fd.* /
    nemesis_* metric the fault plane emits is in METRIC_CATALOG -- is
    enforced by the unknown-metric rule on the same files.)"""
    findings: list[Finding] = []
    path = PKG / "faults.py"
    rule_classes = _rule_subclasses(path)

    lits = _module_literals(path, {"RULE_CATALOG"})
    if "RULE_CATALOG" not in lits:
        findings.append(Finding(
            path, 0, "fault-catalog",
            "RULE_CATALOG not found or not a pure literal",
        ))
        return findings
    catalog, line = lits["RULE_CATALOG"]

    for name, lineno in sorted(rule_classes.items()):
        if name not in catalog:
            findings.append(Finding(
                path, lineno, "fault-catalog",
                f"Rule subclass {name!r} missing from RULE_CATALOG: does "
                "_device_rules compile or absorb it?",
            ))
    for name, story in catalog.items():
        if name not in rule_classes:
            findings.append(Finding(
                path, line, "fault-catalog",
                f"RULE_CATALOG lists {name!r} but no such Rule subclass "
                "exists",
            ))
        if story not in ("compiled", "absorbed"):
            findings.append(Finding(
                path, line, "fault-catalog",
                f"RULE_CATALOG[{name!r}] must be 'compiled' or 'absorbed', "
                f"got {story!r}",
            ))
    return findings


def _rule_subclasses(path: Path) -> "dict[str, int]":
    """Transitive Rule subclasses defined in a faults module, by AST walk
    (no import): {class name: lineno}."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rule_classes: dict[str, int] = {}
    known = {"Rule"}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {b.id for b in node.bases if isinstance(b, ast.Name)}
        if bases & known:
            known.add(node.name)
            rule_classes[node.name] = node.lineno
    return rule_classes


def check_generator_reach() -> list[Finding]:
    """Generator-reachability lint (the GEN_RULES sync discipline).

    The nemesis search can only find bugs in faults it can emit:
    rapid_tpu_torch/search/generator.py keeps GEN_RULES, the literal tuple of
    Rule subclasses its sampler draws from, and this lint pins it against
    the Rule subclasses actually defined in rapid_tpu_torch/faults.py -- the
    same two-sided freshness contract RULE_CATALOG has. A new fault rule
    that never enters GEN_RULES would silently stay outside every hunt;
    a GEN_RULES entry with no backing class would crash the sampler."""
    findings: list[Finding] = []
    gen_path = PKG / "search" / "generator.py"
    rule_classes = _rule_subclasses(PKG / "faults.py")

    lits = _module_literals(gen_path, {"GEN_RULES"})
    if "GEN_RULES" not in lits:
        findings.append(Finding(
            gen_path, 0, "gen-reach",
            "GEN_RULES not found or not a pure literal",
        ))
        return findings
    gen_rules, line = lits["GEN_RULES"]

    for name in sorted(set(rule_classes) - set(gen_rules)):
        findings.append(Finding(
            gen_path, line, "gen-reach",
            f"Rule subclass {name!r} missing from GEN_RULES: the nemesis "
            "search can never emit it, so it ships untested",
        ))
    for name in sorted(set(gen_rules) - set(rule_classes)):
        findings.append(Finding(
            gen_path, line, "gen-reach",
            f"GEN_RULES lists {name!r} but no such Rule subclass exists "
            "in rapid_tpu_torch/faults.py",
        ))
    return findings


# SETTINGS_CATALOG namespaces -> the frozen dataclass each one documents.
# A new cataloged settings group registers here; a key outside every
# registered namespace is a finding (the group ships without a dataclass).
SETTINGS_GROUPS = {
    "adaptive_fd": "AdaptiveFdSettings",
    "profiling": "ProfilingSettings",
    "durability": "DurabilitySettings",
    "slo": "SLOSettings",
    "forensics": "ForensicsSettings",
    "hierarchy": "HierarchySettings",
}


def check_settings_catalog() -> list[Finding]:
    """Settings-catalog lint (the knob discipline).

    rapid_tpu_torch/settings.py keeps SETTINGS_CATALOG, the pure-literal table of
    every ``<group>.<knob>`` with its bounds and one-line doc -- the table
    __post_init__ validates against and statusz/docs cite. Two-sided
    freshness, same contract as RULE_CATALOG/GEN_RULES: every field of each
    SETTINGS_GROUPS dataclass must have a catalog entry whose bounds are
    sane (min <= max) and admit the field's default; every catalog key must
    name a real field of its group's dataclass. All by AST walk --
    importing settings would pull in the package."""
    findings: list[Finding] = []
    path = PKG / "settings.py"

    lits = _module_literals(path, {"SETTINGS_CATALOG"})
    if "SETTINGS_CATALOG" not in lits:
        findings.append(Finding(
            path, 0, "settings-catalog",
            "SETTINGS_CATALOG not found or not a pure literal",
        ))
        return findings
    catalog, cat_line = lits["SETTINGS_CATALOG"]

    # each group dataclass's fields with literal defaults, by AST
    by_class: dict = {cls: {} for cls in SETTINGS_GROUPS.values()}
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if not isinstance(node, ast.ClassDef) or node.name not in by_class:
            continue
        for stmt in node.body:
            if (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.value is not None
            ):
                try:
                    by_class[node.name][stmt.target.id] = (
                        ast.literal_eval(stmt.value), stmt.lineno
                    )
                except ValueError:
                    pass

    for group, cls in sorted(SETTINGS_GROUPS.items()):
        fields = by_class[cls]
        if not fields:
            findings.append(Finding(
                path, 0, "settings-catalog",
                f"{cls} not found or has no literal-defaulted fields",
            ))
            continue
        for name, (default, lineno) in sorted(fields.items()):
            key = f"{group}.{name}"
            entry = catalog.get(key)
            if entry is None:
                findings.append(Finding(
                    path, lineno, "settings-catalog",
                    f"{cls}.{name} missing from SETTINGS_CATALOG: "
                    "the knob ships without bounds or doc",
                ))
                continue
            if not ({"min", "max", "doc"} <= set(entry)):
                findings.append(Finding(
                    path, cat_line, "settings-catalog",
                    f"SETTINGS_CATALOG[{key!r}] must carry min/max/doc",
                ))
                continue
            lo, hi = entry["min"], entry["max"]
            if lo > hi:
                findings.append(Finding(
                    path, cat_line, "settings-catalog",
                    f"SETTINGS_CATALOG[{key!r}] bounds inverted: {lo} > {hi}",
                ))
            default_n = float(default) if isinstance(default, bool) else default
            if not (lo <= default_n <= hi):
                findings.append(Finding(
                    path, lineno, "settings-catalog",
                    f"{cls}.{name} default {default!r} outside "
                    f"its own catalog bounds [{lo}, {hi}]",
                ))
    for key in sorted(catalog):
        group = key.split(".", 1)[0]
        cls = SETTINGS_GROUPS.get(group)
        if cls is None:
            findings.append(Finding(
                path, cat_line, "settings-catalog",
                f"SETTINGS_CATALOG key {key!r} outside the namespaces this "
                f"catalog covers ({', '.join(sorted(SETTINGS_GROUPS))})",
            ))
            continue
        if key.split(".", 1)[1] not in by_class[cls]:
            findings.append(Finding(
                path, cat_line, "settings-catalog",
                f"SETTINGS_CATALOG lists {key!r} but {cls} "
                "has no such field",
            ))
    return findings


def check_metric_emission() -> list[Finding]:
    """Catalog-emission lint (the two-sided metric-name discipline).

    The per-file ``unknown-metric`` rule covers one direction at each call
    site: a literal emission must use a cataloged name. This check closes
    the loop repo-wide, the same shape as the settings-catalog lint: every
    METRIC_CATALOG name must have at least one emitting call site
    (.incr/.observe/.set_gauge) somewhere in rapid_tpu_torch/ -- a cataloged name
    nobody emits is a stale doc operators will grep dashboards for in vain
    -- and every literal emission must be cataloged or belong to a
    METRIC_PREFIXES dynamic family. Unlike the per-file rule this scan
    includes observability.py itself (StableViewTimer and MetricsHistory
    emit there); the port's scenario battery (cli/scenarios.py, which emits
    the zone-detection histogram) is inside the package."""
    findings: list[Finding] = []
    obs_path = PKG / "observability.py"
    emitted: dict = {}  # name -> (path, lineno) of first literal emission
    fstring_heads: list = []  # literal heads of f-string emissions

    for path in iter_py_files([PKG]):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue  # the syntax rule already owns this finding
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("incr", "observe", "set_gauge")
                and node.args
            ):
                continue
            # a conditional pick between literals counts for each branch
            # (faults.py: "nemesis_reordered" if ... else "nemesis_delayed")
            args = [node.args[0]]
            if isinstance(node.args[0], ast.IfExp):
                args = [node.args[0].body, node.args[0].orelse]
            for arg in args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    emitted.setdefault(arg.value, (path, node.lineno))
                elif isinstance(arg, ast.JoinedStr) and arg.values and isinstance(
                    arg.values[0], ast.Constant
                ):
                    fstring_heads.append(str(arg.values[0].value))

    for name in sorted(METRIC_CATALOG):
        if name in emitted:
            continue
        if any(name.startswith(head) for head in fstring_heads):
            continue  # covered by a dynamic family emission
        findings.append(Finding(
            obs_path, 0, "metric-emission",
            f"METRIC_CATALOG lists {name!r} but no call site in rapid_tpu_torch/ "
            "emits it",
        ))
    for name, (path, lineno) in sorted(emitted.items()):
        if name not in METRIC_CATALOG and not name.startswith(METRIC_PREFIXES):
            findings.append(Finding(
                path, lineno, "metric-emission",
                f"emitted metric {name!r} is not in "
                "observability.METRIC_CATALOG",
            ))
    return findings


def check_event_emission() -> list[Finding]:
    """Catalog-emission lint for journal/instant events (the two-sided
    EVENT_CATALOG discipline, mirror of check_metric_emission).

    The per-file ``unknown-span`` rule covers one direction at each call
    site: a literal .event()/.record() kind must be cataloged. This check
    closes the loop repo-wide: every EVENT_CATALOG kind must have at least
    one emitting call site somewhere in rapid_tpu_torch/ -- a
    cataloged kind nobody records is a stale doc a post-mortem will grep
    bundles for in vain -- and every literal emission must be cataloged.
    Conditional picks between literals (slo/burn.py's
    ``"slo_alert_fired" if kind == "fired" else "slo_alert_cleared"``)
    count for each branch, same as the metric scan."""
    findings: list[Finding] = []
    obs_path = PKG / "observability.py"
    emitted: dict = {}  # kind -> (path, lineno) of first literal emission

    for path in iter_py_files([PKG]):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue  # the syntax rule already owns this finding
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in EVENT_METHODS
                and node.args
            ):
                continue
            args = [node.args[0]]
            if isinstance(node.args[0], ast.IfExp):
                args = [node.args[0].body, node.args[0].orelse]
            for arg in args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    emitted.setdefault(arg.value, (path, node.lineno))

    for kind in sorted(EVENT_CATALOG):
        if kind not in emitted:
            findings.append(Finding(
                obs_path, 0, "event-emission",
                f"EVENT_CATALOG lists {kind!r} but no .event()/.record() "
                "call site in rapid_tpu_torch/ emits it",
            ))
    for kind, (path, lineno) in sorted(emitted.items()):
        if kind not in EVENT_CATALOG:
            findings.append(Finding(
                path, lineno, "event-emission",
                f"recorded event kind {kind!r} is not in "
                "observability.EVENT_CATALOG",
            ))
    return findings


def check_signature_catalog() -> list[Finding]:
    """Anomaly-signature catalog lint over rapid_tpu_torch/forensics/timeline.py.

    SIGNATURE_CATALOG is the closed set of names forensic findings may
    carry (cli/forensics.py exits 3 on any of them, operators route
    pages by them). Two-sided freshness, same contract as RULE_CATALOG:
    every catalog row needs a detector that emits it (a ``_finding(...)``
    call with that literal name), every emitted name a catalog row with a
    non-empty doc -- else reports cite signatures nobody documented, or
    the catalog documents detectors that no longer exist."""
    findings: list[Finding] = []
    path = PKG / "forensics" / "timeline.py"

    lits = _module_literals(path, {"SIGNATURE_CATALOG"})
    if "SIGNATURE_CATALOG" not in lits:
        findings.append(Finding(
            path, 0, "signature-catalog",
            "SIGNATURE_CATALOG not found or not a pure literal",
        ))
        return findings
    catalog, cat_line = lits["SIGNATURE_CATALOG"]

    emitted: dict = {}  # signature -> lineno of first _finding() literal
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "_finding"
            and node.args
        ):
            continue
        args = [node.args[0]]
        if isinstance(node.args[0], ast.IfExp):
            args = [node.args[0].body, node.args[0].orelse]
        for arg in args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                emitted.setdefault(arg.value, node.lineno)

    for name, spec in sorted(catalog.items()):
        if not (isinstance(spec, dict) and str(spec.get("doc", "")).strip()):
            findings.append(Finding(
                path, cat_line, "signature-catalog",
                f"SIGNATURE_CATALOG[{name!r}] must carry a non-empty doc",
            ))
        if name not in emitted:
            findings.append(Finding(
                path, cat_line, "signature-catalog",
                f"SIGNATURE_CATALOG lists {name!r} but no detector emits "
                "it (_finding call with that literal name)",
            ))
    for name, lineno in sorted(emitted.items()):
        if name not in catalog:
            findings.append(Finding(
                path, lineno, "signature-catalog",
                f"detector emits signature {name!r} missing from "
                "SIGNATURE_CATALOG",
            ))
    return findings


def check_slo_catalog() -> list[Finding]:
    """SLO-target catalog lint over rapid_tpu_torch/slo/burn.py.

    SLI_CATALOG / BURN_WINDOWS / SLO_CATALOG are pure module literals so
    this check reads them by AST, never importing the package. Every
    declared SLO must name a cataloged SLI, carry an objective strictly
    inside (0, 1) (an objective of 1.0 leaves zero error budget and the
    burn-rate division blows up), and reference only declared window
    pairs; every window pair must have 0 < short_s < long_s and a positive
    burn threshold; every fast-availability SLO must declare a positive
    latency_threshold_ms (the predicate is meaningless without one)."""
    findings: list[Finding] = []
    path = PKG / "slo" / "burn.py"
    wanted = {"SLI_CATALOG", "BURN_WINDOWS", "SLO_CATALOG"}
    lits = _module_literals(path, wanted)
    for name in sorted(wanted - set(lits)):
        findings.append(Finding(
            path, 0, "slo-catalog",
            f"{name} not found or not a pure literal",
        ))
    if len(lits) != len(wanted):
        return findings
    slis, sli_line = lits["SLI_CATALOG"]
    windows, win_line = lits["BURN_WINDOWS"]
    slos, slo_line = lits["SLO_CATALOG"]

    for pair, spec in sorted(windows.items()):
        short_s, long_s = spec.get("short_s", 0), spec.get("long_s", 0)
        if not (0 < short_s < long_s):
            findings.append(Finding(
                path, win_line, "slo-catalog",
                f"BURN_WINDOWS[{pair!r}] needs 0 < short_s < long_s, "
                f"got ({short_s}, {long_s})",
            ))
        if spec.get("burn", 0) <= 0:
            findings.append(Finding(
                path, win_line, "slo-catalog",
                f"BURN_WINDOWS[{pair!r}] burn threshold must be positive",
            ))
    for name, spec in sorted(slos.items()):
        sli = spec.get("sli")
        if sli not in slis:
            findings.append(Finding(
                path, slo_line, "slo-catalog",
                f"SLO_CATALOG[{name!r}] names SLI {sli!r}, not in "
                "SLI_CATALOG",
            ))
        objective = spec.get("objective", 0)
        if not (0.0 < objective < 1.0):
            findings.append(Finding(
                path, slo_line, "slo-catalog",
                f"SLO_CATALOG[{name!r}] objective {objective!r} must be "
                "strictly inside (0, 1)",
            ))
        declared = spec.get("windows", ())
        if not declared:
            findings.append(Finding(
                path, slo_line, "slo-catalog",
                f"SLO_CATALOG[{name!r}] declares no window pairs",
            ))
        for pair in declared:
            if pair not in windows:
                findings.append(Finding(
                    path, slo_line, "slo-catalog",
                    f"SLO_CATALOG[{name!r}] references window pair "
                    f"{pair!r}, not in BURN_WINDOWS",
                ))
        if sli == "fast-availability" and not (
            spec.get("latency_threshold_ms", 0) > 0
        ):
            findings.append(Finding(
                path, slo_line, "slo-catalog",
                f"SLO_CATALOG[{name!r}] is a fast-availability SLO but "
                "declares no positive latency_threshold_ms",
            ))
    return findings


def check_plan_corpus() -> list[Finding]:
    """Pinned-plan corpus lint over scenarios/corpus/*.json.

    Each corpus file is the shrunk witness of a violation the nemesis
    search once found, auto-registered by scenarios.py as a regression
    scenario -- so a malformed pin fails silently at the worst moment (the
    regression stops running). Stdlib-only checks: the JSON parses, the
    harness is known, the plan carries an int seed and non-empty rules,
    every rule type is a RULE_CATALOG class, windows are sane
    [start, end|null] pairs, and probabilities sit in (0, 1]. A plan that
    passes them is then loaded through the port's FaultPlan.from_json, which
    re-runs the plan's own validation."""
    findings: list[Finding] = []
    corpus = sorted((REPO / "scenarios" / "corpus").glob("*.json"))
    catalog = set(_rule_subclasses(PKG / "faults.py"))

    def bad(path: Path, msg: str) -> None:
        findings.append(Finding(path, 1, "plan-corpus", msg))

    for path in corpus:
        try:
            spec = json.loads(path.read_text())
        except json.JSONDecodeError as exc:
            bad(path, f"not valid JSON: {exc}")
            continue
        if not isinstance(spec, dict):
            bad(path, "top level must be a probe-spec object")
            continue
        if spec.get("harness") not in ("engine", "sim"):
            bad(path, f"unknown harness {spec.get('harness')!r}")
        plan = spec.get("plan")
        if not isinstance(plan, dict):
            bad(path, "missing 'plan' object (FaultPlan.to_json dict)")
            continue
        if not isinstance(plan.get("seed"), int):
            bad(path, "plan.seed must be an int (determinism anchor)")
        rules = plan.get("rules")
        if not isinstance(rules, list) or not rules:
            bad(path, "plan.rules must be a non-empty list (an empty pin "
                      "witnesses nothing)")
            continue
        for i, rule in enumerate(rules):
            if not isinstance(rule, dict):
                bad(path, f"rules[{i}] is not an object")
                continue
            kind = rule.get("type")
            if kind not in catalog:
                bad(path, f"rules[{i}].type {kind!r} is not a Rule subclass "
                          "in rapid_tpu_torch/faults.py")
            for window in rule.get("windows") or []:
                if (
                    not isinstance(window, list) or len(window) != 2
                    or not isinstance(window[0], int) or window[0] < 0
                    or not (
                        window[1] is None
                        or (isinstance(window[1], int)
                            and window[1] > window[0])
                    )
                ):
                    bad(path, f"rules[{i}] window {window!r} is not a sane "
                              "[start_ms, end_ms|null] pair")
            prob = rule.get("probability")
            if prob is not None and not (
                isinstance(prob, (int, float)) and 0 < prob <= 1
            ):
                bad(path, f"rules[{i}].probability {prob!r} outside (0, 1]")
        if not any(f.path == path for f in findings):
            # and the port's own loader takes it (its validation re-runs on load)
            from rapid_tpu_torch.faults import FaultPlan

            try:
                FaultPlan.from_json(plan)
            except Exception as exc:  # noqa: BLE001 -- every refusal is the finding
                bad(path, f"the port's FaultPlan.from_json refuses it: {exc}")
    return findings


# ---------------------------------------------------------------------------
# concurrency hygiene (library code + analyzer fixtures only: tests, CLIs
# and experiments legitimately make short-lived foreground threads and
# invoke callables however they like)
# ---------------------------------------------------------------------------

CALLBACK_NAMES = {
    "callback", "callbacks", "cb", "fn", "func", "handler", "handlers",
    "subscriber", "subscribers", "listener", "listeners", "notifier",
    "hook", "hooks",
}
_LOCKISH = ("lock", "mutex", "cond")


def _hygiene_target(path: Path) -> bool:
    parts = set(path.parts)
    return "rapid_tpu_torch" in parts or "fixtures" in parts


class _HygieneVisitor(ast.NodeVisitor):
    """thread-daemon + callback-under-lock, tracked through `with` bodies."""

    def __init__(self, path: Path, noqa: "dict[int, set[str]]") -> None:
        self.path = path
        self.noqa = noqa
        self.findings: list[Finding] = []
        self._locks_held = 0

    def _report(self, node: ast.AST, rule: str, msg: str) -> None:
        if not suppressed(self.noqa, node.lineno, rule):
            self.findings.append(Finding(self.path, node.lineno, rule, msg))

    @staticmethod
    def _terminal(expr: ast.expr) -> "str | None":
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            return expr.attr
        return None

    def visit_With(self, node: ast.With) -> None:
        lockish = sum(
            1 for item in node.items
            if (name := self._terminal(item.context_expr)) is not None
            and any(t in name.lower() for t in _LOCKISH)
        )
        self._locks_held += lockish
        self.generic_visit(node)
        self._locks_held -= lockish

    def visit_Call(self, node: ast.Call) -> None:
        name = self._terminal(node.func)
        if name == "Thread":
            daemon = next(
                (kw.value for kw in node.keywords if kw.arg == "daemon"), None
            )
            if not (isinstance(daemon, ast.Constant) and daemon.value is True):
                self._report(
                    node, "thread-daemon",
                    "threading.Thread in library code must be daemon=True "
                    "(or join it on shutdown and suppress this line)",
                )
            if (
                "messaging" in self.path.parts
                and self.path.name != "reactor.py"
            ):
                self._report(
                    node, "messaging-thread",
                    "thread construction in rapid_tpu_torch/messaging/: socket "
                    "I/O belongs on the reactor (messaging/reactor.py); a "
                    "deliberately-owned worker needs an explicit waiver",
                )
        if self._locks_held and name is not None:
            if name in CALLBACK_NAMES or name.startswith("on_"):
                self._report(
                    node, "callback-under-lock",
                    f"calling {name}() while holding a lock: a callback "
                    f"that re-enters this object deadlocks; snapshot under "
                    f"the lock, call after release",
                )
        self.generic_visit(node)


def check_file(path: Path) -> list[Finding]:
    if not path.is_absolute():
        path = REPO / path
    source = path.read_text()
    try:
        # compile() rather than py_compile: Python 3.12 refuses non-regular
        # cfile targets, and we never want the .pyc anyway
        compile(source, str(path), "exec")
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, "syntax", str(exc))]
    tree = ast.parse(source, filename=str(path))
    checker = Checker(path, source, tree)
    checker.check_unused_imports()
    checker.visit(tree)
    findings = checker.findings
    if _hygiene_target(path):
        hygiene = _HygieneVisitor(path, noqa_lines(source))
        hygiene.visit(tree)
        findings.extend(hygiene.findings)
    return findings


def _expand(paths: "list[str]") -> "list[Path]":
    """Paths, with glob patterns expanded under the repo root (sorted)."""
    out: "list[Path]" = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            out.extend(sorted(REPO.glob(p)))
        else:
            out.append(Path(p))
    return out


def run(paths: "list[str] | None" = None) -> list[Finding]:
    """Importable entry point (mirrors concur.run)."""
    files = iter_py_files(_expand(paths or DEFAULT_PATHS))
    findings: list[Finding] = []
    for f in files:
        findings.extend(check_file(f))
    findings.extend(check_wire_tags())
    findings.extend(check_fault_rules())
    findings.extend(check_generator_reach())
    findings.extend(check_settings_catalog())
    findings.extend(check_metric_emission())
    findings.extend(check_event_emission())
    findings.extend(check_signature_catalog())
    findings.extend(check_slo_catalog())
    findings.extend(check_plan_corpus())
    return findings


def main(argv: list[str]) -> int:
    if "--rules" in argv:
        width = max(len(r) for r in RULE_DOCS)
        for rule, why in RULE_DOCS.items():
            print(f"{rule:<{width}}  {why}")
        return 0
    run_all = "--all" in argv
    paths = [a for a in argv if not a.startswith("--")]
    findings = run(paths or None)
    if run_all:
        if __package__ in (None, ""):
            import concur
            import devlint
        else:  # pragma: no cover - imported as a package module
            from . import concur, devlint
        findings.extend(concur.run())  # concur's own default: the port
        findings.extend(devlint.run())  # devlint's own default: device plane
    for finding in findings:
        print(finding)
    label = "check+concur+devlint" if run_all else "check"
    print(f"{label}: {'OK' if not findings else f'{len(findings)} findings'}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
