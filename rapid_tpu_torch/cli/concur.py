"""Concurrency correctness analyzer of the port (stdlib-only, AST-based).

The port's counterpart of ``tools/concur.py``: the same rules, contexts,
``# guarded-by:`` syntax and output (``concur: OK`` / ``concur: N
findings``), over the port by default (``rapid_tpu_torch``, ``chip_smoke.py``
and ``tests/torch_gate.py``). The runtime half is
``rapid_tpu_torch/runtime/lockdep.py``. It inventories every lock attribute
created in the scanned files (``threading.Lock/RLock/Condition`` or the
``make_lock`` / ``make_rlock`` / ``make_condition`` lockdep seam), builds an
interprocedural lock-acquisition graph, classifies which *execution context*
each method runs in (thread target, timer callback, pool submit, transport
callback, the serialized protocol executor, plain caller), and reports:

- ``lock-order``: cycles in the held-lock -> acquired-lock graph (potential
  deadlocks), propagated through resolvable intra-package calls.
- ``unguarded-write``: an attribute written from >= 2 execution contexts with
  no common lock held and no ``# guarded-by: <x>`` declaration; and writes to
  a ``# guarded-by: <lock-attr>``-declared attribute that do not hold that
  lock.
- ``blocking-under-lock``: blocking operations (socket ops, ``sleep``,
  ``.result()``, ``.wait()`` on anything but the held condition, thread
  ``.join()``) reached while a lock is held, directly or through resolvable
  calls.
- ``unbalanced-acquire``: manual ``.acquire()`` outside ``with`` that has no
  matching ``.release()`` in a ``finally`` block of the same function.
- ``jit-purity``: the port has no ``jax.jit``, ``pallas_call`` or
  ``shard_map``, so the rule is pointed at the port's nearest counterpart:
  code that PyTorch stages once and replays. That is the body of a ``with
  torch.cuda.graph(...)`` capture (``sim/fd_bench.py`` times kernels that
  way), a callable handed to ``torch.cuda.make_graphed_callables``, and a
  function decorated with or passed to ``torch.compile``, ``torch.jit.script``
  or ``torch.jit.trace``. Python side effects there (wall-clock reads, host
  ``random``, ``print``, ``global``, attribute mutation, host syncs like
  ``.item()`` / ``np.asarray``) run at capture time and never on replay.
  ``jax.jit`` itself is not recognized: the JAX fixture
  ``tests/fixtures/concur/bad_jit_purity.py`` gives no finding here, and its
  torch translation ``tests/fixtures/torch_concur/bad_jit_purity.py`` gives
  this rule.

Conventions the analyzer understands (see ARCHITECTURE.md "Concurrency
discipline"):

- ``# guarded-by: <attr>`` on an attribute's ``__init__`` assignment, where
  ``<attr>`` names a lock attribute of the same class: every later write must
  hold that lock. Any other value (e.g. ``protocol-executor``,
  ``protocol-thread``, ``sim-loop``) declares a serialization discipline the
  heuristics cannot see and exempts the attribute from the multi-context
  rule. On the ``class X:`` line it covers every attribute of the class.
- A nested ``def task(): ...`` handed to ``*.execute(...)`` runs on the
  single protocol executor: all such tasks share one context.
- ``cond.wait()`` while holding ``cond`` itself is the one legal blocking
  call under a lock.

Suppress single findings with ``# noqa: RULE`` (shared with ``cli/check.py``).

Usage: python -m rapid_tpu_torch.cli.concur [paths...]
       (default: rapid_tpu_torch, chip_smoke.py, tests/torch_gate.py)
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lintlib import Finding, iter_py_files, noqa_lines, parse, suppressed
else:  # pragma: no cover - imported as a package module
    from .lintlib import Finding, iter_py_files, noqa_lines, parse, suppressed

DEFAULT_PATHS = ["rapid_tpu_torch", "chip_smoke.py", "tests/torch_gate.py"]

LOCK_FACTORIES = {
    "Lock": "lock", "RLock": "rlock", "Condition": "cond",
    "make_lock": "lock", "make_rlock": "rlock", "make_condition": "cond",
}
LOCKISH_TOKENS = ("lock", "cond", "mutex")

# attribute types that are safe to share without an explicit guard
THREADSAFE_TYPES = {
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "Event",
    "Semaphore", "BoundedSemaphore", "Barrier", "local", "count",
    "ThreadPoolExecutor", "ContextVar",
} | set(LOCK_FACTORIES)

# method calls that mutate their receiver in place
MUTATORS = {
    "append", "add", "pop", "popitem", "clear", "update", "extend",
    "discard", "remove", "insert", "setdefault", "appendleft", "popleft",
    "move_to_end", "sort", "rotate",
}

SOCKET_BLOCKERS = {"recv", "recvfrom", "recv_into", "accept", "connect",
                   "create_connection", "getaddrinfo", "sendall"}

INIT_CTX = "init"


def _name_of(expr: ast.expr) -> Optional[str]:
    """Terminal name of a Name/Attribute chain ('self._x.frob' -> 'frob')."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _is_lockish(name: Optional[str]) -> bool:
    return name is not None and any(t in name.lower() for t in LOCKISH_TOKENS)


def _unparse(expr: ast.expr) -> str:
    try:
        return ast.unparse(expr)
    except Exception:  # noqa: BLE001 - best-effort label only
        return "<expr>"


def _lock_kind_of_value(value: ast.expr) -> Optional[str]:
    """'lock'/'rlock'/'cond' if the assigned value creates a lock."""
    if isinstance(value, ast.Call):
        fname = _name_of(value.func)
        if fname in LOCK_FACTORIES:
            return LOCK_FACTORIES[fname]
    return None


def _class_names_of_value(value: ast.expr) -> Set[str]:
    """Candidate class names instantiated by an assignment's value
    (handles ``A(...)``, ``mod.A(...)``, ``A(...) if c else B(...)``)."""
    out: Set[str] = set()
    if isinstance(value, ast.Call):
        name = _name_of(value.func)
        if name and name[:1].isupper():
            out.add(name)
    elif isinstance(value, ast.IfExp):
        out |= _class_names_of_value(value.body)
        out |= _class_names_of_value(value.orelse)
    return out


class FuncNode:
    """One function/method/nested-def/lambda, with everything the rules need."""

    def __init__(self, qual: str, path: Path, module: str,
                 cls: Optional["ClassInfo"], name: str, node: ast.AST) -> None:
        self.qual = qual
        self.path = path
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.contexts: Set[str] = set()
        self.inherit_from: List["FuncNode"] = []   # contexts flow from these
        # (descriptor, line, lockids held at the call); descriptor:
        # ("self", m) | ("plain", n) | ("attr", base_attr, m)
        self.calls: List[Tuple[tuple, int, Tuple[str, ...]]] = []
        # calls made while >= 1 lock held: (descriptor, held lockids, line)
        self.calls_under_lock: List[Tuple[tuple, Tuple[str, ...], int]] = []
        self.acquires: Set[str] = set()            # lockids acquired directly
        self.edges: List[Tuple[str, str, int]] = []  # held -> acquired
        # attribute writes: (attr, line, frozenset(held lockids))
        self.writes: List[Tuple[str, int, frozenset]] = []
        # direct blocking ops: (reason, line, held lockids at that point)
        self.blocking: List[Tuple[str, int, Tuple[str, ...]]] = []
        self.manual_acquires: List[Tuple[str, int]] = []   # (recv, line)
        self.finally_releases: Set[str] = set()            # recv strings
        self.trans_acquires: Set[str] = set()
        self.blocks_because: Optional[str] = None

    def __repr__(self) -> str:
        return f"<Func {self.qual} ctx={sorted(self.contexts)}>"


class ClassInfo:
    def __init__(self, name: str, module: str, path: Path,
                 node: ast.ClassDef) -> None:
        self.name = name
        self.module = module
        self.path = path
        self.node = node
        self.methods: Dict[str, FuncNode] = {}
        self.lock_attrs: Dict[str, str] = {}       # attr -> kind
        self.attr_classes: Dict[str, Set[str]] = {}
        self.func_attrs: Dict[str, FuncNode] = {}  # attr -> stored nested def
        self.guards: Dict[str, str] = {}           # attr -> guarded-by value
        self.attr_types_safe: Set[str] = set()     # thread-safe typed attrs
        self.class_guard: Optional[str] = None     # class-wide guarded-by
        self.bases: List[str] = [
            b for b in (_name_of(x) for x in node.bases) if b
        ]


class ModuleInfo:
    def __init__(self, path: Path, stem: str, source: str,
                 tree: ast.Module) -> None:
        self.path = path
        self.stem = stem
        self.source = source
        self.tree = tree
        self.noqa = noqa_lines(source)
        self.guard_comments = _guard_comments(source)
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncNode] = {}
        self.module_locks: Dict[str, str] = {}     # NAME -> kind


def _guard_comments(source: str) -> Dict[int, str]:
    """line -> declared guard from a ``# guarded-by: <x>`` comment."""
    out: Dict[int, str] = {}
    for i, line in enumerate(source.splitlines(), 1):
        if "# guarded-by:" in line:
            _, _, tail = line.partition("# guarded-by:")
            value = tail.split("#")[0].strip()
            if value:
                out[i] = value
    return out


class Analyzer:
    def __init__(self, files: List[Path]) -> None:
        self.modules: List[ModuleInfo] = []
        self.class_registry: Dict[str, List[ClassInfo]] = {}
        self.func_registry: Dict[str, List[FuncNode]] = {}  # by bare name
        self.all_funcs: List[FuncNode] = []
        self.findings: List[Finding] = []
        for f in files:
            try:
                source, tree = parse(f)
            except SyntaxError:
                continue  # cli/check.py owns syntax reporting
            self.modules.append(ModuleInfo(f, f.stem, source, tree))

    # -- reporting ---------------------------------------------------------

    def report(self, mod: ModuleInfo, line: int, rule: str, msg: str) -> None:
        if suppressed(mod.noqa, line, rule):
            return
        self.findings.append(Finding(mod.path, line, rule, msg))

    # -- phase 1: inventory ------------------------------------------------

    def inventory(self) -> None:
        for mod in self.modules:
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    ci = ClassInfo(node.name, mod.stem, mod.path, node)
                    mod.classes[node.name] = ci
                    self.class_registry.setdefault(node.name, []).append(ci)
                    self._inventory_class(mod, ci)
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    value = node.value
                    kind = _lock_kind_of_value(value) if value else None
                    if kind:
                        for t in targets:
                            if isinstance(t, ast.Name):
                                mod.module_locks[t.id] = kind
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = FuncNode(f"{mod.stem}::{node.name}", mod.path,
                                  mod.stem, None, node.name, node)
                    mod.functions[node.name] = fn
                    self.func_registry.setdefault(node.name, []).append(fn)
                    self.all_funcs.append(fn)

    def _inventory_class(self, mod: ModuleInfo, ci: ClassInfo) -> None:
        # a guarded-by on the ``class X:`` line declares one serialization
        # discipline for every attribute of the class (e.g. the sim plane)
        ci.class_guard = mod.guard_comments.get(ci.node.lineno)
        for item in ci.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = FuncNode(f"{mod.stem}::{ci.name}.{item.name}", mod.path,
                              mod.stem, ci, item.name, item)
                ci.methods[item.name] = fn
                self.all_funcs.append(fn)
            elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                # class-level lock attributes (e.g. _SharedAioLoop._lock)
                targets = (item.targets if isinstance(item, ast.Assign)
                           else [item.target])
                value = item.value
                kind = _lock_kind_of_value(value) if value else None
                for t in targets:
                    if isinstance(t, ast.Name):
                        if kind:
                            ci.lock_attrs[t.id] = kind
                        guard = mod.guard_comments.get(item.lineno)
                        if guard:
                            ci.guards[t.id] = guard
        # attribute metadata from every method body (chiefly __init__)
        for meth in ci.methods.values():
            for stmt in ast.walk(meth.node):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                value = stmt.value
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in ("self", "cls")):
                        continue
                    attr = t.attr
                    if value is not None:
                        kind = _lock_kind_of_value(value)
                        if kind:
                            ci.lock_attrs[attr] = kind
                        for cname in _class_names_of_value(value):
                            ci.attr_classes.setdefault(attr, set()).add(cname)
                        if isinstance(value, ast.Call):
                            vname = _name_of(value.func)
                            if vname in THREADSAFE_TYPES:
                                ci.attr_types_safe.add(attr)
                    guard = mod.guard_comments.get(t.lineno)
                    if guard and attr not in ci.guards:
                        ci.guards[attr] = guard

    # -- phase 2: per-function walk ----------------------------------------

    def scan_bodies(self) -> None:
        for mod in self.modules:
            for ci in mod.classes.values():
                for meth in list(ci.methods.values()):
                    self._walk_function(mod, ci, meth)
            for fn in list(mod.functions.values()):
                self._walk_function(mod, None, fn)

    def _lock_id(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                 fn: FuncNode, expr: ast.expr) -> Optional[str]:
        """Identity of the lock denoted by a ``with`` expression, or None if
        the expression is not lock-like."""
        if isinstance(expr, ast.Attribute):
            base, attr = expr.value, expr.attr
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                if ci is not None and attr in ci.lock_attrs:
                    return f"{ci.name}.{attr}"
                if _is_lockish(attr):
                    owner = ci.name if ci else mod.stem
                    return f"{owner}.{attr}"
                return None
            if _is_lockish(attr):
                # obj.lock -- resolve obj's class if we can
                if isinstance(base, ast.Name):
                    for classes in self._param_classes(fn, base.id):
                        if attr in classes.lock_attrs:
                            return f"{classes.name}.{attr}"
                return f"?.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in mod.module_locks:
                return f"{mod.stem}.{expr.id}"
            if _is_lockish(expr.id):
                return f"{mod.stem}.{expr.id}"
            return None
        return None

    def _param_classes(self, fn: FuncNode, pname: str) -> List[ClassInfo]:
        """ClassInfos for a parameter, from its annotation if present."""
        node = fn.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return []
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            if arg.arg != pname or arg.annotation is None:
                continue
            ann = arg.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                name = ann.value.strip().strip('"').strip("'")
            else:
                name = _name_of(ann)
            if name and name in self.class_registry:
                return self.class_registry[name]
        return []

    def _walk_function(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                       fn: FuncNode) -> None:
        node = fn.node
        body = node.body if not isinstance(node, ast.Lambda) else [
            ast.Expr(value=node.body)
        ]
        self._scan_block(mod, ci, fn, body, held=[])

    def _scan_block(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                    fn: FuncNode, stmts: List[ast.stmt],
                    held: List[Tuple[str, str]]) -> None:
        for stmt in stmts:
            self._scan_stmt(mod, ci, fn, stmt, held)

    def _scan_stmt(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                   fn: FuncNode, stmt: ast.stmt,
                   held: List[Tuple[str, str]]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._register_nested(mod, ci, fn, stmt)
            return
        if isinstance(stmt, ast.With):
            pushed = 0
            for item in stmt.items:
                expr = item.context_expr
                lock = self._lock_id(mod, ci, fn, expr)
                if lock is not None:
                    for held_id, _ in held:
                        if held_id != lock:
                            fn.edges.append((held_id, lock, stmt.lineno))
                    fn.acquires.add(lock)
                    held.append((lock, _unparse(expr)))
                    pushed += 1
                else:
                    self._scan_expr(mod, ci, fn, expr, held)
            self._scan_block(mod, ci, fn, stmt.body, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(stmt, ast.Try):
            self._scan_block(mod, ci, fn, stmt.body, held)
            for handler in stmt.handlers:
                self._scan_block(mod, ci, fn, handler.body, held)
            self._scan_block(mod, ci, fn, stmt.orelse, held)
            # note releases that live in a finally block (for the
            # unbalanced-acquire rule)
            for sub in ast.walk(ast.Module(body=stmt.finalbody, type_ignores=[])):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "release"):
                    fn.finally_releases.add(_unparse(sub.func.value))
            self._scan_block(mod, ci, fn, stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(mod, ci, fn, stmt.test, held)
            self._scan_block(mod, ci, fn, stmt.body, held)
            self._scan_block(mod, ci, fn, stmt.orelse, held)
            return
        if isinstance(stmt, ast.For):
            self._scan_expr(mod, ci, fn, stmt.iter, held)
            self._scan_block(mod, ci, fn, stmt.body, held)
            self._scan_block(mod, ci, fn, stmt.orelse, held)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                self._record_write_target(fn, t, held)
                # ``self.X = <nested def or method ref>`` stores a callable
            if isinstance(stmt, ast.Assign) and ci is not None:
                self._note_stored_func(mod, ci, fn, stmt)
            if stmt.value is not None:
                self._scan_expr(mod, ci, fn, stmt.value, held)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._record_write_target(fn, t, held)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._scan_expr(mod, ci, fn, stmt.value, held)
            return
        if isinstance(stmt, ast.Expr):
            self._scan_expr(mod, ci, fn, stmt.value, held)
            return
        # generic: scan any remaining child expressions / blocks
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan_expr(mod, ci, fn, child, held)
            elif isinstance(child, ast.stmt):
                self._scan_stmt(mod, ci, fn, child, held)

    def _record_write_target(self, fn: FuncNode, target: ast.expr,
                             held: List[Tuple[str, str]]) -> None:
        locks = frozenset(h for h, _ in held)
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write_target(fn, elt, held)
            return
        if isinstance(target, ast.Starred):
            self._record_write_target(fn, target.value, held)
            return
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id in ("self", "cls")):
            fn.writes.append((target.attr, target.lineno, locks))
        elif (isinstance(target, ast.Subscript)
              and isinstance(target.value, ast.Attribute)
              and isinstance(target.value.value, ast.Name)
              and target.value.value.id in ("self", "cls")):
            fn.writes.append((target.value.attr, target.lineno, locks))

    def _note_stored_func(self, mod: ModuleInfo, ci: ClassInfo,
                          fn: FuncNode, stmt: ast.Assign) -> None:
        if not (len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Attribute)
                and isinstance(stmt.targets[0].value, ast.Name)
                and stmt.targets[0].value.id == "self"):
            return
        attr = stmt.targets[0].attr
        value = stmt.value
        if isinstance(value, ast.Name):
            nested = getattr(fn, "_locals", {}).get(value.id)
            if nested is not None:
                ci.func_attrs[attr] = nested

    # -- nested defs / context classification ------------------------------

    def _register_nested(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                         parent: FuncNode, node: ast.AST,
                         name: Optional[str] = None) -> FuncNode:
        fname = name or getattr(node, "name", "<lambda>")
        child = FuncNode(f"{parent.qual}.<locals>.{fname}", mod.path,
                         mod.stem, ci, fname, node)
        self.all_funcs.append(child)
        if not hasattr(parent, "_locals"):
            parent._locals = {}
        parent._locals[fname] = child
        self._walk_function(mod, ci, child)
        return child

    def _classify_deferred(self, callee_name: Optional[str],
                           value_name: str) -> str:
        if callee_name is None:
            return f"deferred:{value_name}"
        if callee_name == "Thread":
            return f"thread:{value_name}"
        if callee_name.startswith("schedule"):
            return "timer"
        if callee_name in ("submit", "map"):
            return "pool"
        if callee_name == "execute":
            return "serialized"
        if callee_name in ("add_callback", "add_done_callback"):
            return "callback"
        return f"deferred:{callee_name}"

    def _scan_expr(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                   fn: FuncNode, expr: ast.expr,
                   held: List[Tuple[str, str]]) -> None:
        if isinstance(expr, ast.Lambda):
            child = self._register_nested(mod, ci, fn, expr, name="<lambda>")
            child.inherit_from.append(fn)
            return
        if isinstance(expr, ast.Call):
            self._scan_call(mod, ci, fn, expr, held)
            return
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._scan_expr(mod, ci, fn, child, held)

    def _scan_call(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                   fn: FuncNode, call: ast.Call,
                   held: List[Tuple[str, str]]) -> None:
        func = call.func
        callee_name = _name_of(func)
        lockids = tuple(h for h, _ in held)

        # ---- callee descriptor for the interprocedural passes
        desc: Optional[tuple] = None
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                desc = ("self", func.attr)
            elif (isinstance(base, ast.Attribute)
                  and isinstance(base.value, ast.Name)
                  and base.value.id in ("self", "cls")):
                desc = ("attr", base.attr, func.attr)
        elif isinstance(func, ast.Name):
            desc = ("plain", func.id)
        if desc is not None:
            fn.calls.append((desc, call.lineno, lockids))
            if lockids:
                fn.calls_under_lock.append((desc, lockids, call.lineno))

        # ---- mutating method on self.X counts as a write to X -- unless X
        # is typed as a package class (its own analysis covers its state)
        if (isinstance(func, ast.Attribute) and func.attr in MUTATORS
                and isinstance(func.value, ast.Attribute)
                and isinstance(func.value.value, ast.Name)
                and func.value.value.id in ("self", "cls")):
            recv_attr = func.value.attr
            in_package = ci is not None and any(
                c in self.class_registry
                for c in ci.attr_classes.get(recv_attr, ())
            )
            if not in_package:
                fn.writes.append((recv_attr, call.lineno, frozenset(lockids)))

        # ---- direct blocking operations
        reason = self._blocking_reason(func, call, held)
        if reason is not None:
            fn.blocking.append((reason, call.lineno, lockids))

        # ---- manual acquire
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            recv = _unparse(func.value)
            if _is_lockish(_name_of(func.value)) or _is_lockish(recv):
                fn.manual_acquires.append((recv, call.lineno))

        # ---- deferred-callable classification for args
        for value in list(call.args) + [kw.value for kw in call.keywords]:
            target_fn = self._resolve_func_ref(mod, ci, fn, value)
            if target_fn is not None:
                kw_names = {id(kw.value): kw.arg for kw in call.keywords}
                ctx = self._classify_deferred(
                    callee_name, target_fn.name
                )
                # Thread(target=...) context gets the target's own name
                if callee_name == "Thread" and kw_names.get(id(value)) != "target":
                    ctx = "callback"
                target_fn.contexts.add(ctx)
            elif isinstance(value, ast.Lambda):
                child = self._register_nested(mod, ci, fn, value)
                child.contexts.add(
                    self._classify_deferred(callee_name, "<lambda>")
                )
            else:
                self._scan_expr(mod, ci, fn, value, held)

        # scan the receiver chain too (e.g. self._x().y())
        if isinstance(func, ast.Attribute):
            self._scan_expr(mod, ci, fn, func.value, held)

    def _resolve_func_ref(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                          fn: FuncNode, value: ast.expr) -> Optional[FuncNode]:
        """A bare reference to a method / nested def passed as a value."""
        if (isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id in ("self", "cls") and ci is not None):
            return ci.methods.get(value.attr)
        if isinstance(value, ast.Name):
            local = getattr(fn, "_locals", {}).get(value.id)
            if local is not None:
                return local
        return None

    def _blocking_reason(self, func: ast.expr, call: ast.Call,
                         held: List[Tuple[str, str]]) -> Optional[str]:
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = _unparse(func.value)
            if attr == "sleep":
                return "sleep()"
            if attr in SOCKET_BLOCKERS:
                return f"socket .{attr}()"
            if attr == "result":
                return ".result()"
            if attr == "wait":
                if any(recv == h_expr for _, h_expr in held):
                    return None  # cond.wait() while holding cond: legal
                return ".wait()"
            if attr == "join" and "thread" in recv.lower():
                return "thread .join()"
        elif isinstance(func, ast.Name) and func.id == "sleep":
            return "sleep()"
        return None

    # -- phase 3: context propagation --------------------------------------

    def assign_roots(self) -> None:
        for mod in self.modules:
            for ci in mod.classes.values():
                for name, meth in ci.methods.items():
                    if name == "__init__":
                        meth.contexts.add(INIT_CTX)
                    elif not name.startswith("_") or name.startswith("__"):
                        meth.contexts.add("caller")

    def propagate_contexts(self) -> None:
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for fn in self.all_funcs:
                for src in fn.inherit_from:
                    add = src.contexts - fn.contexts
                    if add:
                        fn.contexts |= add
                        changed = True
                # construction is single-threaded no matter who constructs:
                # calls made from __init__ propagate only the init context
                src_ctx = ({INIT_CTX} if fn.name == "__init__"
                           else fn.contexts)
                for desc, _line, _lk in fn.calls:
                    for callee in self._resolve_call(fn, desc):
                        add = src_ctx - callee.contexts
                        if add:
                            callee.contexts |= add
                            changed = True
        # anything still context-free is only reachable from outside the
        # package: treat as plain caller
        for fn in self.all_funcs:
            if not fn.contexts:
                fn.contexts.add("caller")

    def _resolve_call(self, fn: FuncNode, desc: tuple) -> List[FuncNode]:
        out: List[FuncNode] = []
        ci = fn.cls
        if desc[0] == "self" and ci is not None:
            m = ci.methods.get(desc[1])
            if m is not None:
                out.append(m)
            else:
                stored = ci.func_attrs.get(desc[1])
                if stored is not None:
                    out.append(stored)
                else:
                    for base in ci.bases:
                        for bci in self.class_registry.get(base, []):
                            bm = bci.methods.get(desc[1])
                            if bm is not None:
                                out.append(bm)
        elif desc[0] == "attr" and ci is not None:
            for cname in ci.attr_classes.get(desc[1], ()):
                for tci in self.class_registry.get(cname, []):
                    m = tci.methods.get(desc[2])
                    if m is not None:
                        out.append(m)
        elif desc[0] == "plain":
            name = desc[1]
            if name in self.class_registry:
                for tci in self.class_registry[name]:
                    init = tci.methods.get("__init__")
                    if init is not None:
                        out.append(init)
            else:
                local = getattr(fn, "_locals", {}).get(name)
                if local is not None:
                    out.append(local)
                else:
                    for cand in self.func_registry.get(name, []):
                        if cand.module == fn.module:
                            out.append(cand)
        return out

    # -- phase 4: interprocedural closures ---------------------------------

    def compute_locked_inheritance(self) -> None:
        """Repo convention: a ``*_locked`` method is only called with its
        class's lock already held. Credit its writes with the locks provably
        held at *every* observed call site (intersection), propagated through
        chains of ``*_locked`` helpers."""
        inh: Dict[int, Optional[frozenset]] = {
            id(fn): None for fn in self.all_funcs
            if fn.name.endswith("_locked")
        }
        for _ in range(10):
            changed = False
            for fn in self.all_funcs:
                base = inh.get(id(fn))
                if id(fn) in inh and base is None:
                    # a _locked helper whose own call sites have not been
                    # observed yet: crediting its outgoing calls now would
                    # poison callees with a premature empty intersection
                    # (the intersection only ever shrinks), making results
                    # depend on method definition order -- defer until a
                    # later round resolves its base
                    continue
                base_set = base if base is not None else frozenset()
                for desc, _line, lockids in fn.calls:
                    for callee in self._resolve_call(fn, desc):
                        if id(callee) not in inh:
                            continue
                        eff = frozenset(lockids) | base_set
                        cur = inh[id(callee)]
                        new = eff if cur is None else (cur & eff)
                        if new != cur:
                            inh[id(callee)] = new
                            changed = True
            if not changed:
                break
        self._inherited: Dict[int, frozenset] = {
            k: (v if v is not None else frozenset()) for k, v in inh.items()
        }

    def _effective_locks(self, fn: FuncNode, locks: frozenset) -> frozenset:
        return locks | self._inherited.get(id(fn), frozenset())

    def close_acquires_and_blocking(self) -> None:
        for fn in self.all_funcs:
            fn.trans_acquires = set(fn.acquires)
            if fn.blocking:
                fn.blocks_because = fn.blocking[0][0]
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for fn in self.all_funcs:
                for desc, _line, _lk in fn.calls:
                    for callee in self._resolve_call(fn, desc):
                        add = callee.trans_acquires - fn.trans_acquires
                        if add:
                            fn.trans_acquires |= add
                            changed = True
                        if callee.blocks_because and not fn.blocks_because:
                            fn.blocks_because = (
                                f"{callee.name}() -> {callee.blocks_because}"
                            )
                            changed = True

    # -- phase 5: rules ----------------------------------------------------

    def _module_of(self, fn: FuncNode) -> Optional[ModuleInfo]:
        if not hasattr(self, "_mod_by_path"):
            self._mod_by_path = {m.path: m for m in self.modules}
        return self._mod_by_path.get(fn.path)

    def rule_lock_order(self) -> None:
        edges: Dict[Tuple[str, str], Tuple[ModuleInfo, int]] = {}
        for fn in self.all_funcs:
            mod = self._module_of(fn)
            if mod is None:
                continue
            for h, a, line in fn.edges:
                edges.setdefault((h, a), (mod, line))
            for desc, lockids, line in fn.calls_under_lock:
                for callee in self._resolve_call(fn, desc):
                    for acq in callee.trans_acquires:
                        for h in lockids:
                            if h != acq:
                                edges.setdefault((h, acq), (mod, line))
        graph: Dict[str, Set[str]] = {}
        for (h, a) in edges:
            graph.setdefault(h, set()).add(a)
        # report one finding per edge that participates in a cycle
        for (h, a), (mod, line) in sorted(
            edges.items(), key=lambda kv: (str(kv[1][0].path), kv[1][1])
        ):
            if self._reaches(graph, a, h):
                self.report(
                    mod, line, "lock-order",
                    f"acquiring {a!r} while holding {h!r} closes a "
                    f"lock-order cycle ({a!r} can be held while taking "
                    f"{h!r} elsewhere): potential deadlock",
                )

    @staticmethod
    def _reaches(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
        seen: Set[str] = set()
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(graph.get(n, ()))
        return False

    def rule_unguarded_writes(self) -> None:
        fn_mod = {m.path: m for m in self.modules}
        for mod in self.modules:
            for ci in mod.classes.values():
                self._check_class_writes(fn_mod[mod.path], ci)

    def _class_funcs(self, ci: ClassInfo) -> List[FuncNode]:
        return [fn for fn in self.all_funcs if fn.cls is ci]

    def _check_class_writes(self, mod: ModuleInfo, ci: ClassInfo) -> None:
        if ci.class_guard is not None and ci.class_guard not in ci.lock_attrs:
            return  # class-wide serialization discipline, documented
        per_attr: Dict[str, List[Tuple[str, int, frozenset, FuncNode]]] = {}
        for fn in self._class_funcs(ci):
            eff_ctx = fn.contexts - {INIT_CTX} or {INIT_CTX}
            for attr, line, locks in fn.writes:
                locks = self._effective_locks(fn, locks)
                for ctx in eff_ctx:
                    per_attr.setdefault(attr, []).append((ctx, line, locks, fn))
        for attr, entries in sorted(per_attr.items()):
            if attr in ci.lock_attrs or attr in ci.attr_types_safe:
                continue
            guard = ci.guards.get(attr)
            if guard is not None and guard in ci.lock_attrs:
                want = f"{ci.name}.{guard}"
                for ctx, line, locks, fn in entries:
                    if ctx == INIT_CTX or fn.name == "__init__":
                        continue
                    if want not in locks:
                        self.report(
                            mod, line, "unguarded-write",
                            f"{ci.name}.{attr} is declared guarded-by "
                            f"{guard!r} but this write does not hold it",
                        )
                continue
            if guard is not None:
                continue  # declared serialization discipline (documented)
            contexts = {ctx for ctx, _, _, fn in entries
                        if ctx != INIT_CTX and fn.name != "__init__"}
            if len(contexts) < 2:
                continue
            common = None
            lines = []
            for ctx, line, locks, fn in entries:
                if ctx == INIT_CTX or fn.name == "__init__":
                    continue
                lines.append(line)
                common = locks if common is None else (common & locks)
            if common:
                continue  # every write holds a shared lock
            self.report(
                mod, min(lines), "unguarded-write",
                f"{ci.name}.{attr} is written from multiple execution "
                f"contexts ({', '.join(sorted(contexts))}) with no common "
                f"lock; guard it or declare '# guarded-by: <x>' at its "
                f"__init__ assignment",
            )

    def rule_blocking_under_lock(self) -> None:
        for fn in self.all_funcs:
            mod = self._module_of(fn)
            if mod is None:
                continue
            for reason, line, lockids in fn.blocking:
                if lockids:
                    self.report(
                        mod, line, "blocking-under-lock",
                        f"{reason} while holding {lockids[-1]!r}",
                    )
            for desc, lockids, line in fn.calls_under_lock:
                for callee in self._resolve_call(fn, desc):
                    if callee.blocks_because:
                        self.report(
                            mod, line, "blocking-under-lock",
                            f"call to {callee.name}() (which blocks: "
                            f"{callee.blocks_because}) while holding "
                            f"{lockids[-1]!r}",
                        )
                        break

    def rule_unbalanced_acquire(self) -> None:
        for fn in self.all_funcs:
            mod = self._module_of(fn)
            if mod is None:
                continue
            for recv, line in fn.manual_acquires:
                if recv not in fn.finally_releases:
                    self.report(
                        mod, line, "unbalanced-acquire",
                        f"manual {recv}.acquire() without a matching "
                        f".release() in a finally block; use 'with'",
                    )

    # -- phase 6: jit purity ------------------------------------------------

    def rule_jit_purity(self) -> None:
        for mod in self.modules:
            jitted = _find_jitted(mod.tree)
            for node, how in jitted:
                _JitPurityVisitor(self, mod, how).check(node)

    def run(self) -> List[Finding]:
        self.inventory()
        self.scan_bodies()
        self.assign_roots()
        self.propagate_contexts()
        self.compute_locked_inheritance()
        self.close_acquires_and_blocking()
        self.rule_lock_order()
        self.rule_unguarded_writes()
        self.rule_blocking_under_lock()
        self.rule_unbalanced_acquire()
        self.rule_jit_purity()
        self.findings.sort(key=lambda f: (str(f.path), f.line, f.rule))
        return self.findings


# --------------------------------------------------------------------------- #
# jit-purity, pointed at torch's capture-and-replay (see the module docstring)
# --------------------------------------------------------------------------- #

# dotted names that stage a callable once for replay
STAGING_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                 "torch.cuda.make_graphed_callables"}
# ``with <this>(...):`` captures its body once for replay
CAPTURE_BLOCKS = {"torch.cuda.graph"}


def _dotted(expr: ast.expr) -> str:
    """'torch.jit.script' for the Attribute chain torch.jit.script."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return ""


def _staging_name(expr: ast.expr) -> Optional[str]:
    """The staging call a decorator expression names: ``torch.compile``,
    ``torch.compile(mode=...)``, ``functools.partial(torch.compile, ...)``."""
    if _dotted(expr) in STAGING_CALLS:
        return _dotted(expr)
    if isinstance(expr, ast.Call):
        if _dotted(expr.func) in STAGING_CALLS:
            return _dotted(expr.func)
        if _name_of(expr.func) == "partial" and expr.args:
            if _dotted(expr.args[0]) in STAGING_CALLS:
                return _dotted(expr.args[0])
    return None


def _find_jitted(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    """Every function (or capture block) PyTorch stages once and replays."""
    out: List[Tuple[ast.AST, str]] = []
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    seen: Set[int] = set()

    def mark(node: ast.AST, how: str) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            out.append((node, how))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                how = _staging_name(dec)
                if how:
                    mark(node, how)
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if (isinstance(expr, ast.Call)
                        and _dotted(expr.func) in CAPTURE_BLOCKS):
                    mark(node, _dotted(expr.func))
        if isinstance(node, ast.Call):
            how = _dotted(node.func)
            if how in STAGING_CALLS and node.args:
                targets = node.args[0]
                elts = (targets.elts if isinstance(targets, (ast.Tuple, ast.List))
                        else [targets])
                for target in elts:
                    if isinstance(target, ast.Name):
                        for d in defs.get(target.id, []):
                            mark(d, how)
    return out


class _JitPurityVisitor(ast.NodeVisitor):
    WALL_CLOCK = {"time", "monotonic", "perf_counter", "time_ns",
                  "monotonic_ns", "perf_counter_ns", "now"}
    HOST_SYNC = {"item", "asarray", "array", "frombuffer", "device_get",
                 "block_until_ready", "tolist"}

    def __init__(self, analyzer: Analyzer, mod: ModuleInfo, how: str) -> None:
        self.analyzer = analyzer
        self.mod = mod
        self.how = how

    def check(self, node: ast.AST) -> None:
        self.fname = getattr(node, "name", f"<capture at line {node.lineno}>")
        for stmt in node.body:
            self.visit(stmt)

    def _flag(self, node: ast.AST, what: str) -> None:
        self.analyzer.report(
            self.mod, node.lineno, "jit-purity",
            f"{what} inside {self.how}-staged {self.fname}: run once at "
            f"capture, never replayed -- breaks replay determinism",
        )

    def visit_Global(self, node: ast.Global) -> None:
        self._flag(node, "global statement")

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "print":
            self._flag(node, "print()")
        if isinstance(func, ast.Attribute):
            base = func.value
            base_name = _name_of(base) if isinstance(
                base, (ast.Name, ast.Attribute)) else None
            if func.attr in self.WALL_CLOCK and base_name in (
                    "time", "datetime"):
                self._flag(node, f"wall-clock read {base_name}.{func.attr}()")
            if isinstance(base, ast.Name) and base.id == "random":
                self._flag(node, f"host RNG random.{func.attr}()")
            if (isinstance(base, ast.Attribute) and base.attr == "random"
                    and isinstance(base.value, ast.Name)
                    and base.value.id in ("np", "numpy", "onp")):
                self._flag(node, f"host RNG np.random.{func.attr}()")
            if func.attr in ("asarray", "array", "frombuffer") and isinstance(
                    base, ast.Name) and base.id in ("np", "numpy", "onp"):
                self._flag(node, f"host sync {base.id}.{func.attr}()")
            if func.attr in ("item", "block_until_ready", "tolist"):
                self._flag(node, f"host sync .{func.attr}()")
            if func.attr == "device_get":
                self._flag(node, "host sync jax.device_get()")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Attribute):
                self._flag(node, f"attribute mutation {_unparse(t)} = ...")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Attribute):
            self._flag(node, f"attribute mutation {_unparse(node.target)}")
        self.generic_visit(node)


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #

def run(paths: Optional[List[str]] = None) -> List[Finding]:
    files = iter_py_files([Path(p) for p in (paths or DEFAULT_PATHS)])
    return Analyzer(files).run()


def main(argv: List[str]) -> int:
    findings = run(argv or None)
    for finding in findings:
        print(finding)
    print(f"concur: {'OK' if not findings else f'{len(findings)} findings'}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
