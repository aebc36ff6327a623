"""Device-plane performance analyzer of the port (stdlib-only, AST-based).

The port's counterpart of ``tools/devlint.py``, with torch rules in the same
four slots and the same output (``devlint: OK`` / ``devlint: N findings``).
The runtime half is ``rapid_tpu_torch/runtime/jitwatch.py``. It scans the
modules that own device dispatch and device-resident state -- the sim
engine/driver/classic/kernels/bridge, the placement and handoff device
code, and the sharded engine -- and reports the patterns that silently
destroy steady-state throughput:

- ``host-sync``: undeclared host<->device round trips, the calls torch's
  sync debug mode flags: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` of a tensor, ``int()`` / ``float()`` / ``bool()`` or
  ``np.asarray`` of a tensor, ``torch.cuda.synchronize()`` and
  ``.synchronize()``, the data-dependent shapes (``.nonzero()``,
  ``torch.unique``, ``masked_select``, one-argument ``torch.where`` and
  boolean-mask indexing), a tensor in a Python condition (``if t``,
  ``while t``, ``assert t``, ``and``/``or``/``not``), a Python scalar
  written into a tensor element (``t[i] = 5``: a host tensor and a blocking
  copy) and indexing by a 0-d tensor (a full reduction used as an index).
  Each is a finding outside the audited seams -- an argument of
  ``jitwatch.fetch`` / ``drain`` / ``host_transfer`` or the body of ``with
  jitwatch.host_transfer(...)`` -- unless it carries ``# devlint:
  sync-point``. What is a tensor is decided by a local inference: the result
  of a ``torch.*`` call (but ``torch.device``, ``torch.Generator`` and the
  like), of a tensor method, of indexing or arithmetic on a tensor, a
  parameter annotated ``torch.Tensor``, and the device-state convention of
  ``tools/devlint.py`` (``state``, ``*.state.<field>``, ``*_dev``).
- ``recompile-hazard``: the port compiles nothing per call; what stands in
  for an XLA compile is a kernel build (``nvcc`` through ``subprocess``,
  ``torch.utils.cpp_extension``, ``triton``) or a library load
  (``ctypes.CDLL``). One made inside a function body runs again on every
  call unless the function caches it (tag ``# devlint: jit-cached``). And
  ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` anywhere in
  the device plane: it compiles behind ``jitwatch``'s back, and the port's
  kernels are written by hand.
- ``dtype-discipline``: ``torch.zeros`` / ``ones`` / ``empty`` / ``full`` /
  ``arange`` / ``tensor`` with no ``dtype`` (the result's type then follows
  the fill value or the default dtype); arithmetic that silently widens the
  pinned uint8 state fields (``fd_fail`` / ``fd_hist`` / ``fd_seen``: float
  constants, true division) unless one side converts explicitly (``.to``,
  ``.float``, ``.int``, ``.long``, ``.double``, ``.type``).
- ``donation-hygiene``: torch has no donation, so the slot holds its
  nearest counterpart, buffer ownership across the host boundary.
  ``torch.as_tensor`` / ``torch.from_numpy`` over a host array the simulator
  owns and keeps mutating (an attribute of ``self``, directly or through a
  local bound to it) shares that buffer on the CPU, so a later in-place
  write of the simulator's mirror changes the device state under it (the fault
  fixed in the port's third slice). Copy first (``np.array``,
  ``.copy()``, ``.clone()``), or tag the line when the array is not
  mutated while the tensor lives.

Conventions the analyzer understands (see ARCHITECTURE.md "Device-plane
performance discipline"); a tag on line L covers findings on L..L+3:

- ``# devlint: sync-point`` -- this host sync is deliberate and accounted
  (once a decision, cold path, setup); suppresses ``host-sync``.
- ``# devlint: no-donate`` / ``# devlint: host-owned`` -- the host array is
  not written while the tensor over it lives; suppresses
  ``donation-hygiene``.
- ``# devlint: jit-cached`` -- the build or load here is cached by the
  caller (one per key, not per call); suppresses ``recompile-hazard``.

``tools/devlint.py``'s ``static-shape`` has no subject here: the port's
kernels take their shapes as arguments and build once.

Suppress single findings with ``# noqa: RULE`` (shared with ``cli/check.py``).

Usage: python -m rapid_tpu_torch.cli.devlint [paths...]
       (default: the device plane, DEVICE_PLANE)
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, List, Optional, Set

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lintlib import Finding, iter_py_files, noqa_lines, parse, suppressed
else:  # pragma: no cover - imported as a package module
    from .lintlib import Finding, iter_py_files, noqa_lines, parse, suppressed

DEVICE_PLANE = [
    "rapid_tpu_torch/sim/engine.py",
    "rapid_tpu_torch/sim/driver.py",
    "rapid_tpu_torch/sim/classic.py",
    "rapid_tpu_torch/sim/kernels.py",
    "rapid_tpu_torch/sim/bridge.py",
    "rapid_tpu_torch/placement/device.py",
    "rapid_tpu_torch/handoff/device.py",
    "rapid_tpu_torch/shard/engine.py",
]

# ``# devlint: <tag>`` -> the rule it suppresses
TAG_RULES = {
    "sync-point": "host-sync",
    "no-donate": "donation-hygiene",
    "host-owned": "donation-hygiene",
    "jit-cached": "recompile-hazard",
}
TAG_WINDOW = 3  # a tag on line L covers findings on L..L+TAG_WINDOW

# the pinned narrow state fields (engine state catalog: uint8)
NARROW_FIELDS = {"fd_fail", "fd_hist", "fd_seen"}

# torch factories whose result type follows the fill value or the default
# dtype unless ``dtype=`` pins it
DTYPE_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor"}

# explicit conversions that make a widening deliberate
EXPLICIT_CASTS = {"to", "float", "int", "long", "double", "type", "half",
                  "bfloat16", "short", "byte", "bool"}

HOST_CASTS = {"int", "float", "bool"}

# attributes of ``torch`` that do not produce a tensor
TORCH_NON_TENSORS = {
    "device", "Generator", "dtype", "Size", "cuda", "is_tensor", "numel",
    "get_default_dtype", "manual_seed", "no_grad", "inference_mode",
    "float32", "float64", "int32", "int64", "uint8", "int8", "int16",
    "bool", "uint64", "uint32", "float16", "bfloat16", "profiler",
    "autograd", "utils", "distributed", "backends", "iinfo", "finfo",
    "set_num_threads", "get_num_threads", "use_deterministic_algorithms",
    "compile", "jit", "library", "ops", "testing", "version",
}

# tensor methods and attributes whose result is not a tensor
TENSOR_NON_TENSORS = {
    "item", "tolist", "numpy", "dim", "size", "numel", "data_ptr", "stride",
    "is_contiguous", "element_size", "get_device", "nelement", "ndimension",
    "shape", "device", "dtype", "ndim", "is_cuda", "nbytes", "itemsize",
    "untyped_storage", "storage_offset", "is_pinned", "record_stream",
}

# full reductions: with no dim argument they return a 0-d tensor
REDUCTIONS = {"sum", "max", "min", "argmax", "argmin", "prod", "mean",
              "any", "all", "count_nonzero"}

# calls whose output shape depends on the data (a sync to size the result)
DATA_DEPENDENT = {"nonzero", "unique", "masked_select", "argwhere",
                  "unique_consecutive"}

SEAMS = ("fetch", "drain", "host_transfer")

BUILD_CALLS = {
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "cpp_extension.load", "cpp_extension.load_inline",
    "triton.compile",
}
STAGING_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}


def _name_of(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _base_name(expr: ast.expr) -> Optional[str]:
    """Root name of an attribute chain ('torch.cuda.synchronize' -> 'torch')."""
    while isinstance(expr, (ast.Attribute, ast.Call, ast.Subscript)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _dotted(expr: ast.expr) -> str:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return ""


def _unparse(expr: ast.expr) -> str:
    try:
        return ast.unparse(expr)
    except Exception:  # noqa: BLE001 - best-effort label only
        return "<expr>"


def devlint_tags(source: str) -> Dict[int, Set[str]]:
    """line -> declared ``# devlint:`` tags on that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        if "# devlint:" not in line:
            continue
        _, _, tail = line.partition("# devlint:")
        tags = {t.strip().lower() for t in tail.split("#")[0].split(",")}
        tags = {t.split()[0] for t in tags if t.split()}
        tags = {t for t in tags if t in TAG_RULES}
        if tags:
            out[i] = tags
    return out


def _tagged(tags: Dict[int, Set[str]], line: int, rule: str) -> bool:
    for tag_line in range(max(1, line - TAG_WINDOW), line + 1):
        for tag in tags.get(tag_line, ()):
            if TAG_RULES[tag] == rule:
                return True
    return False


def _contains(expr: ast.AST, pred) -> bool:
    return any(pred(sub) for sub in ast.walk(expr))


def _device_rooted(expr: ast.expr) -> bool:
    """``tools/devlint.py``'s convention: the expression reads device state
    (the engine state, a field of it, or a ``*_dev`` cached tensor)."""
    def devy(sub: ast.AST) -> bool:
        if isinstance(sub, ast.Attribute):
            return sub.attr == "state" or sub.attr.endswith("_dev")
        if isinstance(sub, ast.Name):
            return sub.id == "state" or sub.id.endswith("_dev")
        return False
    return _contains(expr, devy)


def _is_seam_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and _base_name(node.func) == "jitwatch"
            and node.func.attr in SEAMS)


def _is_full_reduction(expr: ast.expr) -> bool:
    """``t.sum()`` / ``torch.sum(t)`` with no dim: a 0-d tensor."""
    if not isinstance(expr, ast.Call) or not isinstance(expr.func, ast.Attribute):
        return False
    if expr.func.attr not in REDUCTIONS:
        return False
    if any(kw.arg == "dim" for kw in expr.keywords):
        return False
    if _dotted(expr.func).startswith("torch."):
        return len(expr.args) == 1
    return not expr.args


class _Scope:
    """The names a function binds to tensors, 0-d tensors and boolean masks."""

    def __init__(self, parent: Optional["_Scope"] = None) -> None:
        self.tensors: Set[str] = set(parent.tensors) if parent else set()
        self.scalars: Set[str] = set(parent.scalars) if parent else set()
        self.masks: Set[str] = set(parent.masks) if parent else set()

    def is_tensor(self, expr: Optional[ast.expr]) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.tensors or expr.id.endswith("_dev")
        if isinstance(expr, ast.Attribute):
            if expr.attr in TENSOR_NON_TENSORS:
                return False
            if expr.attr.endswith("_dev"):
                return True
            # a field of the engine state: ``self.state.alive``, ``state.round``
            value = expr.value
            return (isinstance(value, ast.Attribute) and value.attr == "state") or (
                isinstance(value, ast.Name) and value.id == "state")
        if isinstance(expr, ast.Call):
            func = expr.func
            dotted = _dotted(func)
            if dotted.startswith("torch."):
                return dotted.split(".")[1] not in TORCH_NON_TENSORS
            if isinstance(func, ast.Attribute):
                if func.attr in TENSOR_NON_TENSORS:
                    return False
                return self.is_tensor(func.value)
            return False
        if isinstance(expr, ast.Subscript):
            return self.is_tensor(expr.value)
        if isinstance(expr, ast.BinOp):
            return self.is_tensor(expr.left) or self.is_tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
                return False
            return self.is_tensor(expr.left) or any(
                self.is_tensor(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return self.is_tensor(expr.body) and self.is_tensor(expr.orelse)
        return False

    def is_scalar(self, expr: ast.expr) -> bool:
        """A 0-d tensor: a full reduction, or a name bound to one."""
        if isinstance(expr, ast.Name):
            return expr.id in self.scalars
        return _is_full_reduction(expr) and self.is_tensor(expr)

    def is_mask(self, expr: ast.expr) -> bool:
        """A boolean tensor used as an index: a comparison of a tensor, its
        negation or conjunction, ``.bool()``, or a name bound to one."""
        if isinstance(expr, ast.Name):
            return expr.id in self.masks
        if isinstance(expr, ast.Compare):
            return self.is_tensor(expr)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return self.is_mask(expr.operand)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(expr.left) or self.is_mask(expr.right)
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
            return expr.func.attr == "bool" and self.is_tensor(expr.func.value)
        return False

    def bind(self, target: ast.expr, value: Optional[ast.expr]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self.bind(t, v)
            else:
                tensor = self.is_tensor(value) if value is not None else False
                for t in target.elts:
                    self._set(t, tensor, False, False)
            return
        if value is None:
            self._set(target, False, False, False)
            return
        self._set(target, self.is_tensor(value), self.is_scalar(value), self.is_mask(value))

    def _set(self, target: ast.expr, tensor: bool, scalar: bool, mask: bool) -> None:
        if isinstance(target, ast.Starred):
            target = target.value
        if not isinstance(target, ast.Name):
            return
        for names, on in ((self.tensors, tensor), (self.scalars, scalar), (self.masks, mask)):
            if on:
                names.add(target.id)
            else:
                names.discard(target.id)


class Module:
    def __init__(self, path: Path, source: str, tree: ast.Module) -> None:
        self.path = path
        self.source = source
        self.tree = tree
        self.noqa = noqa_lines(source)
        self.tags = devlint_tags(source)


class Analyzer:
    def __init__(self, files: List[Path]) -> None:
        self.modules: List[Module] = []
        self.findings: List[Finding] = []
        for f in files:
            try:
                source, tree = parse(f)
            except SyntaxError:
                continue  # cli/check.py owns syntax reporting
            self.modules.append(Module(f, source, tree))

    def report(self, mod: Module, line: int, rule: str, msg: str) -> None:
        if suppressed(mod.noqa, line, rule) or _tagged(mod.tags, line, rule):
            return
        self.findings.append(Finding(mod.path, line, rule, msg))

    # -- rule: host-sync ----------------------------------------------------

    def rule_host_sync(self) -> None:
        for mod in self.modules:
            _SyncVisitor(self, mod).visit(mod.tree)

    # -- rule: recompile-hazard --------------------------------------------

    def rule_recompile(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        target = dec.func if isinstance(dec, ast.Call) else dec
                        if _dotted(target) in STAGING_CALLS:
                            self._staging(mod, node.lineno, _dotted(target))
                if isinstance(node, ast.Call) and _dotted(node.func) in STAGING_CALLS:
                    self._staging(mod, node.lineno, _dotted(node.func))
            for outer in ast.walk(mod.tree):
                if not isinstance(outer, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                names_nvcc = _contains(outer, _mentions_nvcc)
                for node in ast.walk(outer):
                    what = self._build_call(node, names_nvcc)
                    if what and node is not outer:
                        self.report(
                            mod, node.lineno, "recompile-hazard",
                            f"{what} inside {outer.name}(): a build or load on "
                            f"every call unless the function caches it (tag "
                            f"'# devlint: jit-cached' if it does)",
                        )

    def _staging(self, mod: Module, line: int, what: str) -> None:
        self.report(
            mod, line, "recompile-hazard",
            f"{what} in the device plane compiles behind jitwatch's back; the "
            f"port's kernels are written by hand (rapid_tpu_torch/csrc/)",
        )

    @staticmethod
    def _build_call(node: ast.AST, names_nvcc: bool) -> Optional[str]:
        """What ``node`` builds or loads: a library load, or a ``subprocess``
        call in a function that names ``nvcc``."""
        if not isinstance(node, ast.Call):
            return None
        dotted = _dotted(node.func)
        if dotted in BUILD_CALLS:
            return f"{dotted}()"
        if names_nvcc and _base_name(node.func) == "subprocess":
            return f"an nvcc build through {dotted}()"
        return None

    # -- rule: dtype-discipline --------------------------------------------

    def rule_dtype(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    self._dtype_construction(mod, node)
                elif isinstance(node, ast.BinOp):
                    self._narrow_widening(mod, node)

    def _dtype_construction(self, mod: Module, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if not (dotted.startswith("torch.") and dotted.count(".") == 1
                and node.func.attr in DTYPE_FACTORIES):
            return
        if any(kw.arg == "dtype" for kw in node.keywords):
            return
        self.report(
            mod, node.lineno, "dtype-discipline",
            f"torch.{node.func.attr}() without an explicit dtype: the result's "
            f"type follows the fill value or the default dtype; pin it",
        )

    def _narrow_widening(self, mod: Module, node: ast.BinOp) -> None:
        def narrow(sub: ast.AST) -> bool:
            return (isinstance(sub, (ast.Attribute, ast.Name))
                    and _name_of(sub) in NARROW_FIELDS)

        sides = [node.left, node.right]
        if not any(_contains(s, narrow) for s in sides):
            return
        if any(_contains(s, lambda n: isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr in EXPLICIT_CASTS) for s in sides):
            return
        field = next(_name_of(sub) for s in sides for sub in ast.walk(s)
                     if narrow(sub))
        if isinstance(node.op, ast.Div):
            self.report(
                mod, node.lineno, "dtype-discipline",
                f"true division on narrow state field {field!r} silently "
                f"widens the pinned uint8 to float; use // or an explicit "
                f".to()",
            )
            return
        for s in sides:
            if _contains(s, lambda n: isinstance(n, ast.Constant)
                         and isinstance(n.value, float)):
                self.report(
                    mod, node.lineno, "dtype-discipline",
                    f"float constant in arithmetic on narrow state field "
                    f"{field!r} silently widens the pinned uint8; use an "
                    f"explicit .to()",
                )
                return

    # -- rule: donation-hygiene (buffer ownership across the host boundary)

    def rule_ownership(self) -> None:
        for mod in self.modules:
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                owned = _self_bound_locals(fn)
                for node in ast.walk(fn):
                    if not (isinstance(node, ast.Call)
                            and _dotted(node.func) in ("torch.as_tensor", "torch.from_numpy")
                            and node.args):
                        continue
                    arg = node.args[0]
                    if _self_owned(arg, owned):
                        self.report(
                            mod, node.lineno, "donation-hygiene",
                            f"{_dotted(node.func)}({_unparse(arg)}) shares the "
                            f"simulator's host array: on the CPU the tensor aliases "
                            f"it, and a later in-place write of the mirror changes "
                            f"the device state; copy it first, or tag "
                            f"'# devlint: host-owned' if it is not written while "
                            f"the tensor lives",
                        )

    # -- run -------------------------------------------------------------

    def run(self) -> List[Finding]:
        self.rule_recompile()
        self.rule_host_sync()
        self.rule_dtype()
        self.rule_ownership()
        seen: Set[str] = set()
        unique: List[Finding] = []
        for f in sorted(self.findings,
                        key=lambda f: (str(f.path), f.line, f.rule, f.msg)):
            if str(f) not in seen:
                seen.add(str(f))
                unique.append(f)
        self.findings = unique
        return self.findings


def _mentions_nvcc(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "nvcc" in node.value
    return isinstance(node, (ast.Name, ast.Attribute)) and "nvcc" in (_name_of(node) or "").lower()


def _self_bound_locals(fn: ast.AST) -> Set[str]:
    """Locals bound directly to an attribute of ``self`` (``a = self.alive``)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name) and _is_self_attr(node.value):
            out.add(node.targets[0].id)
    return out


def _is_self_attr(expr: ast.expr) -> bool:
    return (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self")


def _self_owned(arg: ast.expr, owned: Set[str]) -> bool:
    """``self.x`` / ``self.x[...]`` / a local bound to ``self.x``, with no copy
    on the way (a call of any kind is taken as one)."""
    while isinstance(arg, ast.Subscript):
        arg = arg.value
    if isinstance(arg, ast.Name):
        return arg.id in owned
    return _is_self_attr(arg)


class _SyncVisitor(ast.NodeVisitor):
    """host-sync over one module, one tensor scope a function."""

    def __init__(self, analyzer: Analyzer, mod: Module) -> None:
        self.analyzer = analyzer
        self.mod = mod
        self.scope = _Scope()
        self.seam_depth = 0

    def _flag(self, node: ast.AST, what: str) -> None:
        if self.seam_depth:
            return
        self.analyzer.report(
            self.mod, node.lineno, "host-sync",
            f"{what} blocks on the device queue; route it through "
            f"jitwatch.fetch()/drain()/host_transfer() or tag "
            f"'# devlint: sync-point' with its reason",
        )

    # scopes

    def _function(self, node) -> None:
        saved = self.scope
        self.scope = _Scope(saved)
        for arg in node.args.args + node.args.kwonlyargs + node.args.posonlyargs:
            ann = arg.annotation
            text = _unparse(ann) if ann is not None else ""
            self.scope._set(ast.Name(id=arg.arg), "Tensor" in text and "[" not in text,
                            False, False)
        for stmt in node.body:
            self.visit(stmt)
        self.scope = saved

    def visit_FunctionDef(self, node) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        self._function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved = self.scope
        self.scope = _Scope(saved)
        self.visit(node.body)
        self.scope = saved

    # bindings

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                self._element_write(target, node.value)
                self.visit(target.value)
                self.visit(target.slice)
            elif isinstance(target, (ast.Name, ast.Tuple, ast.List, ast.Starred)):
                self.scope.bind(target, node.value)
            else:
                self.visit(target)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self.scope.bind(node.target, node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        self.visit(node.target)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self.scope.bind(node.target, None)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_With(self, node: ast.With) -> None:
        seams = 0
        for item in node.items:
            if _is_seam_call(item.context_expr):
                seams += 1
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.scope.bind(item.optional_vars, None)
        self.seam_depth += seams
        for stmt in node.body:
            self.visit(stmt)
        self.seam_depth -= seams

    # the syncs

    def _element_write(self, target: ast.Subscript, value: ast.expr) -> None:
        if not self.scope.is_tensor(target.value):
            return
        if self.scope.is_mask(target.slice):
            self._flag(target, f"boolean-mask write {_unparse(target)} = ... "
                               f"(a nonzero to size the index)")
        elif _python_scalar(value):
            self._flag(target, f"python scalar written into tensor element "
                               f"{_unparse(target)} (a host tensor and a blocking copy)")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.scope.is_tensor(node.value):
            index = node.slice
            elts = index.elts if isinstance(index, ast.Tuple) else [index]
            if any(self.scope.is_mask(e) for e in elts):
                self._flag(node, f"boolean-mask indexing {_unparse(node)} "
                                 f"(a nonzero to size the result)")
            elif any(self.scope.is_scalar(e) for e in elts):
                self._flag(node, f"indexing {_unparse(node.value)} by a 0-d tensor "
                                 f"(read back as a python int)")
        self.generic_visit(node)

    def _test(self, test: ast.expr) -> None:
        exprs = test.values if isinstance(test, ast.BoolOp) else [test]
        for expr in exprs:
            if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
                expr = expr.operand
            if self.scope.is_tensor(expr) or _device_rooted_value(expr):
                self._flag(expr, f"tensor {_unparse(expr)} in a python condition "
                                 f"(bool() of a device value)")

    def visit_If(self, node: ast.If) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if _is_seam_call(node):
            self.seam_depth += 1
            self.generic_visit(node)
            self.seam_depth -= 1
            return
        self._sync_call(node)
        self.generic_visit(node)

    def _sync_call(self, node: ast.Call) -> None:
        func = node.func
        dotted = _dotted(func)
        tensor_arg = bool(node.args) and (
            self.scope.is_tensor(node.args[0]) or _device_rooted_value(node.args[0]))
        if isinstance(func, ast.Attribute):
            recv = func.value
            if func.attr in ("item", "tolist"):
                if self.scope.is_tensor(recv) or _device_rooted_value(recv):
                    self._flag(node, f".{func.attr}() of tensor {_unparse(recv)}")
                return
            if func.attr == "cpu" and not node.args:
                self._flag(node, f".cpu() of {_unparse(recv)}")
                return
            if func.attr == "numpy" and not node.args:
                if not (isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "cpu"):
                    self._flag(node, f".numpy() of {_unparse(recv)}")
                return
            if func.attr == "synchronize":
                self._flag(node, f"{_unparse(func)}()")
                return
            if func.attr in ("asarray", "array") and _base_name(func) in ("np", "numpy"):
                if tensor_arg:
                    self._flag(node, f"np.{func.attr}() of tensor {_unparse(node.args[0])}")
                return
            if func.attr in DATA_DEPENDENT and (
                    dotted.startswith("torch.") or self.scope.is_tensor(recv)):
                self._flag(node, f"{func.attr}() (its output shape depends on the data)")
                return
            if dotted == "torch.where" and len(node.args) == 1:
                self._flag(node, "one-argument torch.where() (a nonzero)")
                return
        if isinstance(func, ast.Name) and func.id in HOST_CASTS and tensor_arg:
            self._flag(node, f"{func.id}() of tensor {_unparse(node.args[0])}")


def _python_scalar(expr: ast.expr) -> bool:
    """A host number: a literal, its negation, or ``int()``/``float()``/``bool()``."""
    if isinstance(expr, ast.UnaryOp):
        expr = expr.operand
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (int, float, bool))
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id in HOST_CASTS)


def _device_rooted_value(expr: ast.expr) -> bool:
    """A read of device state that is a value, not metadata: ``state.x`` but
    not ``state.x.shape`` nor a method call's non-tensor result."""
    if isinstance(expr, ast.Attribute) and expr.attr in TENSOR_NON_TENSORS:
        return False
    if isinstance(expr, ast.Call):
        return False
    if isinstance(expr, (ast.Constant, ast.Compare, ast.BoolOp)):
        return False
    return _device_rooted(expr) and not _contains(
        expr, lambda s: isinstance(s, ast.Attribute) and s.attr in TENSOR_NON_TENSORS)


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #

def run(paths: Optional[List[str]] = None) -> List[Finding]:
    files = iter_py_files([Path(p) for p in (paths or DEVICE_PLANE)])
    return Analyzer(files).run()


def main(argv: List[str]) -> int:
    findings = run(argv or None)
    for finding in findings:
        print(finding)
    print(f"devlint: {'OK' if not findings else f'{len(findings)} findings'}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
