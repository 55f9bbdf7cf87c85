"""Conservative intra-package call graph seeded from ``steady`` markers.

The trace-safety and donation rules need to know (a) which functions run
on the port's *steady* paths, where nothing may wait for the card, and
(b) which of their values are tensors (whose value lives on the card)
and which are host config.  Both are answered here without importing the
package:

* **Seeds** — a ``# opslint: steady`` comment on a ``def`` line (any
  line of the signature) marks a function whose every call must only
  enqueue device work: the engine's executable bodies and
  ``Model.decode_step``.  ``# opslint: steady static=a,b`` names host
  parameters, as ``static_argnames`` does for ``jax.jit`` in the
  reference.  ``# opslint: donates=<param>[ if <kwarg>]`` marks a
  function that consumes the buffer passed as ``<param>`` (always, or
  only when the call passes ``<kwarg>`` as something other than
  ``False``/``None``); it feeds the donation registry, in the role of
  the reference's ``donate_argnums``.
* **Propagation** — inside a steady function, a call to a function we
  can resolve (same scope chain, same module, ``self.method``, or an
  imported module of the project) marks the callee steady too.  Taint is
  per *call site*: only parameters that receive tensor arguments become
  tainted, so a schedule tuple threaded through a steady caller stays
  static and ``if not rows_cap:`` branches on it are not flagged.  A
  project function handed to a call as an argument (``_scan_blocks(step,
  ...)``, ``functools.partial(self._ssm_step, in_place=donate)``) is
  steady with every parameter tainted, except ``self`` and those a
  ``partial`` binds to host values.
* **Taint** — results of ``torch.*`` calls, tensor methods on a tainted
  value, tainted parameters, and attribute loads of *tensor fields* off
  a tainted value (``A.rpt``, ``lease.i32``: class fields annotated
  ``torch.Tensor``, or ``__init__`` parameters so annotated and stored
  under their own name).  Tensor metadata is static: ``.shape``,
  ``.dtype``, ``.device``, ``.ndim``, ``.is_cuda``, ``.numel()``,
  ``.size()``, ``.dim()``, ``len()``; so is any other attribute load
  (``A.nrows``, ``A.capacity``).  Unlike the reference, where every
  attribute load is static pytree aux data under ``jax.jit``, a tensor
  field is a device value: ``if A.rpt[-1] > 0:`` waits for the card.
* **Plain branches** — every kernel wrapper of the port runs its plain
  version on CPU tensors (``if not x.is_cuda: return x_plain(...)``),
  and the plain versions (``kernels/ref.py``, ``*_plain``) read the host
  freely.  A branch taken only for CPU tensors (the body of ``if not
  x.is_cuda:`` / ``if x.device.type != "cuda":``, the ``else`` of ``if
  x.is_cuda:``) is therefore not followed and not checked: the card never
  runs it.  ``tests/test_torch_opslint.py`` pins that every call of a
  plain version in the port sits in such a branch.

Resolution is deliberately conservative: other higher-order flow is not
followed, method calls on receivers other than ``self`` and module
aliases are not resolved, and unresolvable calls add no edges.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Project, SourceFile

# Module names whose call results are tensors.
_TRACED_NAMESPACES = {
    "torch", "torch.nn.functional", "torch.linalg", "torch.fft",
    "torch.special", "torch.nn.init",
}

# torch.* calls in those namespaces whose result is a host value.
_HOST_TORCH = {
    "device", "dtype", "finfo", "iinfo", "Size", "is_tensor",
    "is_floating_point", "is_complex", "numel", "get_default_dtype",
    "is_grad_enabled", "is_inference_mode_enabled",
    "are_deterministic_algorithms_enabled", "promote_types", "result_type",
    "broadcast_shapes", "no_grad", "enable_grad", "inference_mode",
    "Generator", "get_rng_state", "manual_seed", "set_grad_enabled",
}

# Host coercions: their *call* on a tensor is a sync (TRC001 reports
# int/float/bool) but the result is a host value, so taint does not flow
# through them; the rest are host-valued builtins.
_HOST_COERCIONS = {"int", "float", "bool", "len", "str", "isinstance",
                   "issubclass", "hasattr", "callable", "type", "id", "repr",
                   "range"}

# torch factories: a CPU tensor unless given `device=`.
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor", "eye",
              "linspace", "logspace", "rand", "randn", "randint", "randperm",
              "empty_strided"}

# Tensor metadata methods (static).  Metadata attributes (.shape,
# .dtype, .device, ...) need no list: only tensor fields taint.
_STATIC_METHODS = {"numel", "size", "dim", "element_size", "stride",
                   "is_contiguous", "data_ptr", "get_device", "nelement",
                   "is_floating_point", "is_complex", "ndimension",
                   "storage_offset", "untyped_storage"}

# `# opslint: steady static=a,b` / `# opslint: donates=caches if donate`;
# several directives on one comment are separated by `;`.
_MARKER_RE = re.compile(r"#\s*opslint:\s*(?P<body>.*)$")
_STEADY_RE = re.compile(
    r"^steady(?:\s*\[?\s*static\s*=\s*(?P<static>[A-Za-z_][\w\s,]*?)\s*\]?)?$")
_DONATES_RE = re.compile(
    r"^donates\s*=\s*(?P<names>[A-Za-z_][\w\s,]*?)"
    r"(?:\s+if\s+(?P<cond>[A-Za-z_]\w*))?$")


@dataclass(eq=False)
class FuncInfo:
    """One function or method definition anywhere in the project."""

    node: ast.AST                      # FunctionDef / AsyncFunctionDef
    sf: SourceFile
    qualname: str                      # "Class.method" / "outer.inner"
    cls: Optional[str] = None          # enclosing class name, if a method

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def params(self) -> List[str]:
        """Positional parameter names (``self`` included)."""
        a = self.node.args
        names = [p.arg for p in getattr(a, "posonlyargs", [])]
        names += [p.arg for p in a.args]
        return names

    @property
    def all_params(self) -> List[str]:
        """Positional and keyword-only parameter names."""
        return self.params + [p.arg for p in self.node.args.kwonlyargs]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<FuncInfo {self.sf.modname}:{self.qualname}>"


class Scope:
    """Lexical scope for name → definition resolution (class scopes are
    skipped on lookup, matching Python semantics)."""

    def __init__(self, kind: str, parent: Optional["Scope"] = None):
        self.kind = kind               # "module" | "class" | "function"
        self.parent = parent
        self.defs: Dict[str, FuncInfo] = {}

    def lookup(self, name: str) -> Optional[FuncInfo]:
        scope: Optional[Scope] = self
        while scope is not None:
            if scope.kind != "class" and name in scope.defs:
                return scope.defs[name]
            scope = scope.parent
        return None


@dataclass
class Marker:
    """The ``# opslint:`` directives on one ``def``."""

    steady: bool = False
    static_names: Tuple[str, ...] = ()
    donate_names: Tuple[str, ...] = ()
    donate_if: Optional[str] = None    # keyword that turns donation on


@dataclass
class ModuleIndex:
    sf: SourceFile
    scope: Scope
    # import alias -> full module name ("np" -> "numpy", "F" -> "torch...")
    module_aliases: Dict[str, str] = field(default_factory=dict)
    # from-imported symbol -> (module, symbol)
    symbol_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    classes: Dict[str, Dict[str, FuncInfo]] = field(default_factory=dict)
    # every FuncInfo in the module, with its *enclosing* scope for lookups
    functions: List[Tuple[FuncInfo, Scope]] = field(default_factory=list)
    class_nodes: List[ast.ClassDef] = field(default_factory=list)


@dataclass
class CallGraph:
    project: Project
    modules: Dict[str, ModuleIndex] = field(default_factory=dict)
    # steady function -> names of parameters carrying tensors
    traced: Dict[FuncInfo, Set[str]] = field(default_factory=dict)
    # functions marked `steady`, in project order
    seeds: List[FuncInfo] = field(default_factory=list)
    # functions marked `donates=` (call sites use the def or method name)
    donor_defs: Dict[FuncInfo, Marker] = field(default_factory=dict)
    # attribute names of tensor-valued fields across the project
    tensor_fields: Set[str] = field(default_factory=set)
    # memos: (fn, tainted params) -> returns a tensor; fn -> (plain-branch
    # node ids, the nodes of its own body outside them)
    returns: Dict[Tuple[FuncInfo, frozenset], bool] = field(
        default_factory=dict, repr=False)
    walks: Dict[FuncInfo, Tuple[Set[int], List[ast.AST]]] = field(
        default_factory=dict, repr=False)
    # nested def -> tensor-valued free variables from its enclosing def
    closure: Dict[FuncInfo, Set[str]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Name / attribute resolution helpers
# ---------------------------------------------------------------------------

def resolve_dotted(node: ast.AST, mi: ModuleIndex) -> Optional[str]:
    """Best-effort dotted name for an expression like ``torch.nn.functional.
    relu`` or ``F.relu`` (aliases expanded), else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        base = cur.id
        full = mi.module_aliases.get(base)
        if full is not None:
            parts.append(full)
        elif base in mi.symbol_imports:
            mod, sym = mi.symbol_imports[base]
            parts.append(f"{mod}.{sym}")
        else:
            parts.append(base)
        return ".".join(reversed(parts))
    return None


def _is_partial(node: ast.AST, mi: ModuleIndex) -> bool:
    dotted = resolve_dotted(node, mi)
    return dotted in {"functools.partial", "partial"}


def torch_call_is_tensor(call: ast.Call, mi: ModuleIndex) -> bool:
    """A ``torch.*`` call whose result is a tensor."""
    dotted = resolve_dotted(call.func, mi)
    if not dotted or "." not in dotted:
        return False
    head, tail = dotted.rsplit(".", 1)
    return head in _TRACED_NAMESPACES and tail not in _HOST_TORCH


def parse_marker(fn_node: ast.AST, sf: SourceFile) -> Optional[Marker]:
    """The ``# opslint: steady`` / ``donates=`` directives on the lines of
    *fn_node*'s signature, or None."""
    last = fn_node.body[0].lineno - 1 if fn_node.body else fn_node.lineno
    marker = Marker()
    found = False
    for lineno in range(fn_node.lineno, max(last, fn_node.lineno) + 1):
        m = _MARKER_RE.search(sf.line_text(lineno))
        if not m:
            continue
        for directive in m.group("body").split(";"):
            directive = directive.strip()
            s = _STEADY_RE.match(directive)
            if s:
                marker.steady = found = True
                if s.group("static"):
                    marker.static_names = tuple(
                        n.strip() for n in s.group("static").split(",")
                        if n.strip())
                continue
            d = _DONATES_RE.match(directive)
            if d:
                found = True
                marker.donate_names = tuple(
                    n.strip() for n in d.group("names").split(",")
                    if n.strip())
                marker.donate_if = d.group("cond")
    return marker if found else None


# ---------------------------------------------------------------------------
# Plain branches: code that runs only for CPU tensors
# ---------------------------------------------------------------------------

def _device_test(test: ast.AST) -> Optional[bool]:
    """True if *test* holds exactly for CUDA tensors (``x.is_cuda``,
    ``x.device.type == "cuda"``, ``... != "cpu"``), False if exactly for
    CPU ones (``not x.is_cuda``, ``... != "cuda"``, ``== "cpu"``), else
    None."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _device_test(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) \
            and test.left.attr == "type" \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value in ("cuda", "cpu"):
        is_eq = isinstance(test.ops[0], ast.Eq)
        if not is_eq and not isinstance(test.ops[0], ast.NotEq):
            return None
        return is_eq == (test.comparators[0].value == "cuda")
    return None


def plain_nodes(fn_node: ast.AST) -> Set[int]:
    """ids of every node of *fn_node* that lies in a branch taken only
    for CPU tensors (the kernel wrappers' plain-version dispatch)."""
    out: Set[int] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        on_cuda = _device_test(node.test)
        if on_cuda is None:
            continue
        branch = node.orelse if on_cuda else node.body
        for stmt in (branch if isinstance(branch, list) else [branch]):
            out.update(id(n) for n in ast.walk(stmt))
    return out


def walk_function(fn_node: ast.AST, skip: Set[int]):
    """``ast.walk`` over *fn_node*'s own body: nested defs and the nodes
    in *skip* (plain branches) are left out; lambdas are walked, since
    they run where they are handed (``tree_map(lambda a: ..., x)``)."""
    stack = [fn_node]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if id(child) in skip:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# Module indexing
# ---------------------------------------------------------------------------

class _Indexer(ast.NodeVisitor):
    def __init__(self, mi: ModuleIndex):
        self.mi = mi
        self.scope_stack: List[Scope] = [mi.scope]
        self.class_stack: List[str] = []
        self.name_stack: List[str] = []     # enclosing classes and defs

    @property
    def scope(self) -> Scope:
        return self.scope_stack[-1]

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mi.module_aliases[alias.asname or alias.name.split(".")[0]] = (
                alias.name if alias.asname else alias.name.split(".")[0]
            )
            if alias.asname:
                self.mi.module_aliases[alias.asname] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if node.level:  # relative import: resolve against this module's package
            pkg = self.mi.sf.modname.split(".")
            if not self.mi.sf.relpath.endswith("__init__.py"):
                pkg = pkg[:-1]
            pkg = pkg[:len(pkg) - (node.level - 1)]
            mod = ".".join(p for p in pkg + [mod] if p)
        if not mod:
            return
        for alias in node.names:
            local = alias.asname or alias.name
            self.mi.symbol_imports[local] = (mod, alias.name)

    def _visit_func(self, node) -> None:
        info = FuncInfo(
            node=node, sf=self.mi.sf,
            qualname=".".join(self.name_stack + [node.name]),
            cls=self.class_stack[-1] if self.class_stack else None,
        )
        self.scope.defs[node.name] = info
        self.mi.functions.append((info, self.scope))
        if self.class_stack and self.scope.kind == "class":
            self.mi.classes.setdefault(self.class_stack[-1], {})[node.name] = info
        inner = Scope("function", parent=self.scope)
        info.inner_scope = inner  # type: ignore[attr-defined]
        self.scope_stack.append(inner)
        self.name_stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self.name_stack.pop()
        self.scope_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.mi.classes.setdefault(node.name, {})
        self.mi.class_nodes.append(node)
        cls_scope = Scope("class", parent=self.scope)
        self.scope_stack.append(cls_scope)
        self.class_stack.append(node.name)
        self.name_stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self.name_stack.pop()
        self.class_stack.pop()
        self.scope_stack.pop()


def index_module(sf: SourceFile) -> ModuleIndex:
    mi = ModuleIndex(sf=sf, scope=Scope("module"))
    _Indexer(mi).visit(sf.tree)
    return mi


def _mentions_tensor(annotation: Optional[ast.AST]) -> bool:
    if annotation is None:
        return False
    for node in ast.walk(annotation):
        if isinstance(node, ast.Name) and node.id == "Tensor":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "Tensor":
            return True
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "Tensor" in node.value:
            return True
    return False


def _tensor_fields(mi: ModuleIndex) -> Set[str]:
    """Field names of a module's classes that hold tensors: class-body
    annotations naming ``Tensor``, and ``self.<p> = <p>`` in ``__init__``
    for a parameter ``p`` so annotated."""
    out: Set[str] = set()
    for cls in mi.class_nodes:
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and _mentions_tensor(stmt.annotation):
                out.add(stmt.target.id)
            elif isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
                args = stmt.args
                annotated = {a.arg for a in (list(args.posonlyargs)
                                             + list(args.args)
                                             + list(args.kwonlyargs))
                             if _mentions_tensor(a.annotation)}
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                        tgt = sub.targets[0]
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self" \
                                and isinstance(sub.value, ast.Name) \
                                and sub.value.id in annotated:
                            out.add(tgt.attr)
    return out


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------

def _seed(graph: CallGraph, fn: FuncInfo,
          static_names: Sequence[str] = ()) -> None:
    tainted = {name for name in fn.all_params
               if name not in static_names and name != "self"}
    graph.traced[fn] = graph.traced.get(fn, set()) | tainted


# ---------------------------------------------------------------------------
# Taint analysis inside one function
# ---------------------------------------------------------------------------

class TaintResult:
    def __init__(self, tainted_names: Set[str],
                 calls: List[Tuple[ast.Call, Optional[FuncInfo], Set[int], Set[str]]],
                 passed: List[Tuple[FuncInfo, Set[str]]], skip: Set[int],
                 expr_tainted, test_tainted):
        self.tainted_names = tainted_names
        # (call node, resolved callee, tainted positional idxs, tainted kwarg names)
        self.calls = calls
        # functions handed to a call as an argument, with the params a
        # partial binds to host values
        self.passed = passed
        # node ids in plain branches
        self.skip = skip
        # expression -> tensor-valued?  test_tainted is the branch-test
        # form: a call the linter cannot see into is a host predicate
        self.expr_tainted = expr_tainted
        self.test_tainted = test_tainted


def resolve_call(call: ast.Call, scope: Scope, mi: ModuleIndex,
                 graph: CallGraph, cls: Optional[str]) -> Optional[FuncInfo]:
    """Resolve a call's target to a project FuncInfo when possible."""
    return resolve_callable(call.func, scope, mi, graph, cls)


def resolve_callable(func: ast.AST, scope: Scope, mi: ModuleIndex,
                     graph: CallGraph, cls: Optional[str]) -> Optional[FuncInfo]:
    """Resolve a callable expression (``f``, ``self.m``, ``mod.f``)."""
    if isinstance(func, ast.Name):
        fn = scope.lookup(func.id)
        if fn is not None:
            return fn
        if func.id in mi.symbol_imports:
            mod, sym = mi.symbol_imports[func.id]
            other = graph.modules.get(mod)
            if other is not None:
                return other.scope.defs.get(sym)
        return None
    if isinstance(func, ast.Attribute):
        base = func.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                methods = mi.classes.get(cls, {})
                return methods.get(func.attr)
            target_mod = mi.module_aliases.get(base.id)
            if target_mod is None and base.id in mi.symbol_imports:
                mod, sym = mi.symbol_imports[base.id]
                target_mod = f"{mod}.{sym}"
            if target_mod is not None:
                other = graph.modules.get(target_mod)
                if other is not None:
                    return other.scope.defs.get(func.attr)
    return None


def _callee_taint(call: ast.Call, callee: FuncInfo, t_pos: Set[int],
                  t_kw: Set[str]) -> Set[str]:
    """The callee's parameters that receive tensors at *call*."""
    params = callee.params
    offset = 1 if params[:1] == ["self"] and _is_method_call(call) else 0
    out = {params[i + offset] for i in t_pos if i + offset < len(params)}
    out |= {kw for kw in t_kw if kw in callee.all_params}
    return out


def returns_tensor(graph: CallGraph, fn: FuncInfo, tainted: Set[str]) -> bool:
    """Whether *fn* can return a tensor when *tainted* params hold tensors
    (memoized; a recursive call is assumed to)."""
    memo = graph.returns
    key = (fn, frozenset(tainted))
    if key in memo:
        return memo[key]
    memo[key] = True
    mi = graph.modules[fn.sf.modname]
    taint = analyze_taint(fn, tainted, function_scope(graph, fn), mi, graph)
    memo[key] = any(
        node.value is not None and taint.expr_tainted(node.value)
        for node in walk_function(fn.node, taint.skip)
        if isinstance(node, (ast.Return, ast.Yield)))
    return memo[key]


def _is_torch_factory(call: ast.Call, mi: ModuleIndex) -> bool:
    """``torch.zeros(...)`` and the like with no ``device=``: a CPU
    tensor, never the card's."""
    dotted = resolve_dotted(call.func, mi)
    if dotted is None or not dotted.startswith("torch."):
        return False
    if dotted.rsplit(".", 1)[1] not in _FACTORIES:
        return False
    return not any(kw.arg == "device" for kw in call.keywords)


def _is_str_membership(node: ast.Compare) -> bool:
    """``"key" in p``: a string is never an element of a tensor, so this
    is a container lookup."""
    return isinstance(node.left, ast.Constant) \
        and isinstance(node.left.value, str) \
        and all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)


def make_expr_tainted(tainted: Set[str], mi: ModuleIndex, graph: CallGraph,
                      scope: Scope, cls: Optional[str], strict: bool = False):
    """The tensor-valued test for expressions of one function, given the
    set of its tainted names.  ``strict`` is the branch-test form: a call
    of anything the linter cannot see into (a callable parameter, a
    library predicate such as ``dataclasses.is_dataclass``) is taken as
    a host value."""
    fields = graph.tensor_fields

    def expr_tainted(node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Subscript):
            return expr_tainted(node.value)
        if isinstance(node, ast.Attribute):
            # a tensor field off a tainted value is a device value; any
            # other attribute (metadata, host config) is static
            return node.attr in fields and expr_tainted(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in _HOST_COERCIONS:
                return False
            if _is_torch_factory(node, mi):
                return False
            if torch_call_is_tensor(node, mi):
                return True
            if isinstance(func, ast.Attribute) and expr_tainted(func.value):
                # tensor method of a tainted value (x.sum(), A.nnz())
                return func.attr not in _STATIC_METHODS
            t_pos = {i for i, a in enumerate(node.args) if expr_tainted(a)}
            t_kw = {kw.arg for kw in node.keywords
                    if kw.arg is not None and expr_tainted(kw.value)}
            if not t_pos and not t_kw:
                # fed only static args, a call returns a host value
                return False
            callee = resolve_call(node, scope, mi, graph, cls)
            if callee is not None:
                return returns_tensor(
                    graph, callee, _callee_taint(node, callee, t_pos, t_kw))
            return not strict
        if isinstance(node, ast.BinOp):
            return expr_tainted(node.left) or expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return expr_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(expr_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is structural, never a sync
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) \
                    and all(isinstance(c, ast.Constant) and c.value is None
                            for c in node.comparators):
                return False
            if _is_str_membership(node):
                return False
            return expr_tainted(node.left) or \
                any(expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return expr_tainted(node.body) or expr_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(expr_tainted(v) for v in node.values)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return expr_tainted(node.elt)
        if isinstance(node, ast.DictComp):
            return expr_tainted(node.value)
        if isinstance(node, ast.Starred):
            return expr_tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return expr_tainted(node.value)
        return False

    return expr_tainted


def host_narrowed(fn_node: ast.AST) -> Dict[int, Set[str]]:
    """Names known not to hold a tensor, per node: after ``if
    isinstance(x, torch.Tensor): ... return``, and in the ``else`` of
    such a test, ``x`` is a host value (``int(pos)`` in ``_pos_vec``)."""
    out: Dict[int, Set[str]] = {}

    def mark(stmts, name: str) -> None:
        for stmt in stmts:
            for n in ast.walk(stmt):
                out.setdefault(id(n), set()).add(name)

    for parent in ast.walk(fn_node):
        for fieldname in ("body", "orelse", "finalbody"):
            block = getattr(parent, fieldname, None)
            if not isinstance(block, list):
                continue
            for i, stmt in enumerate(block):
                if not isinstance(stmt, ast.If):
                    continue
                name = _tensor_check(stmt.test)
                if name is None:
                    continue
                mark(stmt.orelse, name)
                if stmt.body and isinstance(stmt.body[-1],
                                            (ast.Return, ast.Raise)):
                    mark(block[i + 1:], name)
    return out


def _tensor_check(test: ast.AST) -> Optional[str]:
    """``x`` for ``isinstance(x, torch.Tensor)`` / ``torch.is_tensor(x)``."""
    if not (isinstance(test, ast.Call) and test.args
            and isinstance(test.args[0], ast.Name)):
        return None
    func = test.func
    if isinstance(func, ast.Name) and func.id == "isinstance" \
            and len(test.args) == 2 and _mentions_tensor(test.args[1]):
        return test.args[0].id
    if isinstance(func, ast.Attribute) and func.attr == "is_tensor":
        return test.args[0].id
    return None


_BINDERS = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.NamedExpr, ast.For,
            ast.comprehension, ast.withitem, ast.Lambda)


def analyze_taint(fn: FuncInfo, tainted_params: Set[str], scope: Scope,
                  mi: ModuleIndex, graph: CallGraph) -> TaintResult:
    """Flow-insensitive taint: a name ever assigned a tensor is tainted
    for the whole function (iterated to a small fixpoint).  Plain
    branches are left out."""
    tainted: Set[str] = set(tainted_params) | graph.closure.get(fn, set())
    expr_tainted = make_expr_tainted(tainted, mi, graph, scope, fn.cls)
    if fn not in graph.walks:
        skip = plain_nodes(fn.node)
        graph.walks[fn] = (skip, list(walk_function(fn.node, skip)))
    skip, own = graph.walks[fn]
    binders = [n for n in own if isinstance(n, _BINDERS)]

    def bind_targets(target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                bind_targets(elt)
        elif isinstance(target, ast.Starred):
            bind_targets(target.value)

    def bind_iter(target: ast.AST, it: ast.AST) -> None:
        """Loop targets: enumerate's index is a host int, zip pairs its
        targets with its arguments."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and isinstance(target, (ast.Tuple, ast.List)) \
                and len(target.elts) == 2 and it.func.id == "enumerate" \
                and it.args:
            bind_iter(target.elts[1], it.args[0])
            return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "zip" \
                and isinstance(target, (ast.Tuple, ast.List)) \
                and len(target.elts) == len(it.args):
            for elt, arg in zip(target.elts, it.args):
                bind_iter(elt, arg)
            return
        if expr_tainted(it):
            bind_targets(target)

    for _ in range(8):  # fixpoint over out-of-order assignments
        before = len(tainted)
        for node in binders:
            if isinstance(node, ast.Assign) and expr_tainted(node.value):
                for t in node.targets:
                    bind_targets(t)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and expr_tainted(node.value):
                bind_targets(node.target)
            elif isinstance(node, ast.AugAssign) and \
                    (expr_tainted(node.value) or expr_tainted(node.target)):
                bind_targets(node.target)
            elif isinstance(node, ast.NamedExpr) and expr_tainted(node.value):
                bind_targets(node.target)
            elif isinstance(node, (ast.For, ast.comprehension)):
                bind_iter(node.target, node.iter)
            elif isinstance(node, ast.withitem) and node.optional_vars is not None \
                    and expr_tainted(node.context_expr):
                bind_targets(node.optional_vars)
            elif isinstance(node, ast.Lambda):
                # a lambda's arguments are the leaves it is mapped over
                tainted.update(a.arg for a in node.args.args)
                if node.args.vararg is not None:
                    tainted.add(node.args.vararg.arg)
        if len(tainted) == before:
            break

    calls: List[Tuple[ast.Call, Optional[FuncInfo], Set[int], Set[str]]] = []
    passed: List[Tuple[FuncInfo, Set[str]]] = []
    for node in own:
        if not isinstance(node, ast.Call):
            continue
        if _is_partial(node.func, mi):
            target = resolve_callable(node.args[0], scope, mi, graph, fn.cls) \
                if node.args else None
            if target is not None:
                bound = {kw.arg for kw in node.keywords
                         if kw.arg is not None and not expr_tainted(kw.value)}
                passed.append((target, bound))
            continue
        callee = resolve_call(node, scope, mi, graph, fn.cls)
        t_pos = {i for i, a in enumerate(node.args) if expr_tainted(a)}
        t_kw = {kw.arg for kw in node.keywords
                if kw.arg is not None and expr_tainted(kw.value)}
        calls.append((node, callee, t_pos, t_kw))
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, (ast.Name, ast.Attribute)):
                target = resolve_callable(arg, scope, mi, graph, fn.cls)
                if target is not None:
                    passed.append((target, set()))

    test_tainted = make_expr_tainted(tainted, mi, graph, scope, fn.cls,
                                     strict=True)
    return TaintResult(tainted, calls, passed, skip, expr_tainted,
                       test_tainted)


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------

def build_callgraph(project: Project) -> CallGraph:
    graph = CallGraph(project=project)

    for sf in project.iter_files():
        mi = graph.modules[sf.modname] = index_module(sf)
        graph.tensor_fields |= _tensor_fields(mi)

    # seeds and donors: the `# opslint:` markers on def lines
    for mi in graph.modules.values():
        for fn, _scope in mi.functions:
            marker = parse_marker(fn.node, mi.sf)
            if marker is None:
                continue
            if marker.steady:
                graph.seeds.append(fn)
                _seed(graph, fn, static_names=marker.static_names)
            if marker.donate_names:
                graph.donor_defs[fn] = marker

    nested: Dict[FuncInfo, List[FuncInfo]] = {}
    for mi in graph.modules.values():
        owner = {id(getattr(fn, "inner_scope", None)): fn
                 for fn, _ in mi.functions}
        for fn, scope in mi.functions:
            if id(scope) in owner:
                nested.setdefault(owner[id(scope)], []).append(fn)

    # propagate steadiness through resolvable calls, per-call-site taint
    worklist = list(graph.traced.keys())
    seen_rounds = 0
    while worklist and seen_rounds < 10000:
        seen_rounds += 1
        fn = worklist.pop()
        mi = graph.modules.get(fn.sf.modname)
        if mi is None:
            continue
        scope = function_scope(graph, fn)
        taint = analyze_taint(fn, graph.traced.get(fn, set()), scope, mi, graph)
        updates: List[Tuple[FuncInfo, Set[str]]] = []
        for call, callee, t_pos, t_kw in taint.calls:
            if callee is None or callee is fn:
                continue
            updates.append((callee, _callee_taint(call, callee, t_pos, t_kw)))
        for target, bound in taint.passed:
            if target is fn:
                continue
            updates.append((target, {p for p in target.all_params
                                     if p != "self" and p not in bound}))
        for inner in nested.get(fn, ()):
            free = _free_names(inner.node) & taint.tainted_names
            if not free <= graph.closure.get(inner, set()):
                graph.closure[inner] = graph.closure.get(inner, set()) | free
                graph.returns.clear()   # summaries may have changed
                if inner in graph.traced:
                    worklist.append(inner)
        for callee, new_tainted in updates:
            prev = graph.traced.get(callee)
            if prev is None:
                graph.traced[callee] = set(new_tainted)
                worklist.append(callee)
            elif not new_tainted <= prev:
                prev |= new_tainted
                worklist.append(callee)
    return graph


def _free_names(fn_node: ast.AST) -> Set[str]:
    """Names a def loads but neither takes as a parameter nor binds."""
    a = fn_node.args
    bound = {p.arg for p in list(a.posonlyargs) + list(a.args)
             + list(a.kwonlyargs)}
    bound |= {p.arg for p in (a.vararg, a.kwarg) if p is not None}
    loads = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Name):
            (loads if isinstance(node.ctx, ast.Load) else bound).add(node.id)
    return loads - bound


def _is_method_call(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute)


def function_scope(graph: CallGraph, fn: FuncInfo) -> Scope:
    mi = graph.modules[fn.sf.modname]
    return getattr(fn, "inner_scope", mi.scope)
