"""LCK — lock-order cycles and guarded-field races.

The engine now has four lock-holding subsystems (``Arena``,
``PlanCache``, ``Telemetry``'s registry/event log, ``SpgemmService``)
whose locks nest across objects (cache eviction forfeits arena leases
while holding the cache lock).  Two mechanical checks keep that safe:

* ``LCK001`` — **ordering cycles**: a lock graph with an edge
  ``(C, L) -> (D, M)`` whenever a method of class ``C`` can call into a
  lock-acquiring method of class ``D`` while holding ``L``.  Any cycle
  is a potential deadlock under concurrent callers.  Cross-object
  attribute types are inferred from ``__init__`` (constructor calls,
  annotated parameters, and factory calls with return annotations).
* ``LCK002`` — **guarded-field races**: fields annotated
  ``# guarded-by: <lock>`` on their ``__init__`` assignment (or class
  body) must only be written inside a ``with self.<lock>:`` block.
  ``__init__`` is exempt (no concurrency before construction returns)
  and so are methods named ``*_locked`` — the repo convention for
  "caller already holds the lock" helpers (``PlanCache._insert_locked``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, FuncInfo, resolve_dotted
from .core import GUARDED_BY_RE, Finding, Project, SourceFile

RULES = {
    "LCK001": "lock-ordering cycle across lock-holding classes",
    "LCK002": "write to a guarded-by field outside its lock",
}

# self.<field>.<mutator>(...) counts as a write to the field
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop", "popitem",
    "popleft", "clear", "update", "add", "discard", "setdefault", "sort",
    "reverse",
}

_LOCK_FACTORIES = {"threading.Lock", "threading.RLock", "Lock", "RLock"}


@dataclass
class ClassLocks:
    name: str
    sf: SourceFile
    node: ast.ClassDef
    locks: Set[str] = field(default_factory=set)             # attr names
    guarded: Dict[str, str] = field(default_factory=dict)    # field -> lock
    # attr -> class name (for cross-object lock edges)
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)

    def acquiring_methods(self) -> Dict[str, Set[str]]:
        """method name -> set of own locks it acquires anywhere."""
        out: Dict[str, Set[str]] = {}
        for name, node in self.methods.items():
            acquired = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        lock = _self_lock_attr(item.context_expr, self.locks)
                        if lock:
                            acquired.add(lock)
            if acquired:
                out[name] = acquired
        return out


def _self_lock_attr(expr: ast.AST, locks: Set[str]) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and expr.attr in locks:
        return expr.attr
    return None


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip("'\" ")
    if isinstance(node, ast.Subscript):  # Optional[Arena] and friends
        inner = node.slice
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return _annotation_name(inner)
    return None


def _collect_classes(project: Project, graph: CallGraph) -> Dict[str, ClassLocks]:
    """All classes that own a threading lock, keyed by class name
    (class names are unique across this package)."""
    classes: Dict[str, ClassLocks] = {}
    factories: Dict[str, str] = {}  # function name -> returned class name

    for sf in project.iter_files():
        mi = graph.modules[sf.modname]
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ret = _annotation_name(node.returns)
                if ret:
                    factories[node.name] = ret

    for sf in project.iter_files():
        mi = graph.modules[sf.modname]
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = ClassLocks(name=node.name, sf=sf, node=node)
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[stmt.name] = stmt
                elif isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    m = GUARDED_BY_RE.search(sf.line_text(stmt.lineno))
                    if m:
                        info.guarded[stmt.target.id] = m.group(1)
                    ann = _annotation_name(stmt.annotation)
                    if ann:
                        info.attr_types[stmt.target.id] = ann

            init = info.methods.get("__init__")
            if init is not None:
                param_ann = {}
                all_args = list(getattr(init.args, "posonlyargs", [])) \
                    + list(init.args.args) + list(init.args.kwonlyargs)
                for a in all_args:
                    ann = _annotation_name(a.annotation)
                    if ann:
                        param_ann[a.arg] = ann
                for stmt in ast.walk(init):
                    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        continue
                    targets = stmt.targets if isinstance(stmt, ast.Assign) \
                        else [stmt.target]
                    value = stmt.value
                    for tgt in targets:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        attr = tgt.attr
                        m = GUARDED_BY_RE.search(sf.line_text(tgt.lineno))
                        if m:
                            info.guarded[attr] = m.group(1)
                        if value is None:
                            continue
                        if isinstance(value, ast.Call):
                            dotted = resolve_dotted(value.func, mi) or ""
                            tail = dotted.split(".")[-1] if dotted else ""
                            if dotted in _LOCK_FACTORIES or \
                                    (dotted.startswith("threading.")
                                     and tail in {"Lock", "RLock"}):
                                info.locks.add(attr)
                            elif tail in factories:
                                info.attr_types[attr] = factories[tail]
                            elif tail and tail[0].isupper():
                                info.attr_types[attr] = tail
                        elif isinstance(value, ast.Name) and \
                                value.id in param_ann:
                            info.attr_types[attr] = param_ann[value.id]
                        elif isinstance(value, (ast.IfExp, ast.BoolOp)):
                            for sub in ast.walk(value):
                                if isinstance(sub, ast.Name) and \
                                        sub.id in param_ann:
                                    info.attr_types[attr] = param_ann[sub.id]
                                    break
            if info.locks:
                classes[info.name] = info
    return classes


class _HeldLockVisitor(ast.NodeVisitor):
    """Walks a method body tracking which of the class's own locks are
    held, invoking ``on_node(node, held)`` for every statement/expr."""

    def __init__(self, info: ClassLocks, on_node):
        self.info = info
        self.on_node = on_node
        self.held: List[str] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lock = _self_lock_attr(item.context_expr, self.info.locks)
            if lock:
                acquired.append(lock)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_FunctionDef(self, node) -> None:
        # a nested def runs later, possibly without the lock: analyze it
        # with an empty held-set (conservative for LCK002's purposes)
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def generic_visit(self, node) -> None:
        self.on_node(node, tuple(self.held))
        super().generic_visit(node)


def run(project: Project, graph: CallGraph) -> List[Finding]:
    classes = _collect_classes(project, graph)
    findings: List[Finding] = []
    findings.extend(_check_guarded_writes(classes))
    findings.extend(_check_lock_order(classes))
    return findings


# ---------------------------------------------------------------------------
# LCK002 — guarded-field writes
# ---------------------------------------------------------------------------

def _check_guarded_writes(classes: Dict[str, ClassLocks]) -> List[Finding]:
    findings: List[Finding] = []
    for info in classes.values():
        if not info.guarded:
            continue
        for mname, mnode in sorted(info.methods.items()):
            if mname == "__init__":
                continue
            caller_holds = set(info.locks) if mname.endswith("_locked") else set()

            def on_node(node, held, _m=mname):
                held_set = set(held) | caller_holds
                write = _guarded_write(node, info)
                if write is None:
                    return
                fieldname, lock = write
                if lock in held_set:
                    return
                findings.append(Finding(
                    rule="LCK002", path=info.sf.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=f"`{info.name}.{_m}` writes `self.{fieldname}` "
                            f"(guarded-by: {lock}) without holding "
                            f"`self.{lock}`",
                    hint=f"wrap the write in `with self.{lock}:`, or rename "
                         "the method with a `_locked` suffix if every caller "
                         "already holds the lock",
                ))

            _HeldLockVisitor(info, on_node).visit(mnode)
    return findings


def _guarded_write(node: ast.AST, info: ClassLocks) -> Optional[Tuple[str, str]]:
    """(field, guarding lock) when *node* writes a guarded self-field."""

    def self_field(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and expr.attr in info.guarded:
            return expr.attr
        return None

    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            f = self_field(tgt)
            if f is None and isinstance(tgt, ast.Subscript):
                f = self_field(tgt.value)  # self.d[k] = v
            if f is not None:
                return f, info.guarded[f]
    elif isinstance(node, ast.Delete):
        for tgt in node.targets:
            f = self_field(tgt)
            if f is None and isinstance(tgt, ast.Subscript):
                f = self_field(tgt.value)
            if f is not None:
                return f, info.guarded[f]
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        f = self_field(node.func.value)
        if f is not None:
            return f, info.guarded[f]
    return None


# ---------------------------------------------------------------------------
# LCK001 — lock-order cycles
# ---------------------------------------------------------------------------

def _check_lock_order(classes: Dict[str, ClassLocks]) -> List[Finding]:
    # edges: (cls, lock) -> set of ((cls, lock), site) it may acquire while held
    edges: Dict[Tuple[str, str], Dict[Tuple[str, str], Tuple[str, int]]] = {}
    acquiring = {name: info.acquiring_methods() for name, info in classes.items()}

    for info in classes.values():
        for mname, mnode in info.methods.items():
            base_held = [(info.name, lk) for lk in sorted(info.locks)] \
                if mname.endswith("_locked") else []

            def on_node(node, held, _base=tuple(base_held)):
                held_keys = list(_base) + [(info.name, lk) for lk in held]
                if not held_keys or not isinstance(node, ast.Call):
                    return
                for target in _call_lock_targets(node, info, classes, acquiring):
                    site = (info.sf.relpath, node.lineno)
                    for src in held_keys:
                        if src == target:
                            continue
                        edges.setdefault(src, {}).setdefault(target, site)

            _HeldLockVisitor(info, on_node).visit(mnode)

    # DFS for cycles over the (class, lock) graph
    findings: List[Finding] = []
    seen_cycles: Set[Tuple[Tuple[str, str], ...]] = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt, site in sorted(edges.get(cur, {}).items()):
                if nxt == path[0]:
                    cycle = tuple(sorted(path))
                    if cycle in seen_cycles:
                        continue
                    seen_cycles.add(cycle)
                    order = " -> ".join(f"{c}.{l}" for c, l in path + [nxt])
                    findings.append(Finding(
                        rule="LCK001", path=site[0], line=site[1], col=0,
                        message=f"lock-ordering cycle: {order} — concurrent "
                                "callers entering from different points can "
                                "deadlock",
                        hint="impose a global acquisition order (acquire the "
                             "outer lock first everywhere) or release the "
                             "first lock before calling into the other class",
                    ))
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return findings


def _call_lock_targets(call: ast.Call, info: ClassLocks,
                       classes: Dict[str, ClassLocks],
                       acquiring: Dict[str, Dict[str, Set[str]]]):
    """(class, lock) pairs this call may acquire."""
    func = call.func
    out = []
    if isinstance(func, ast.Attribute):
        base = func.value
        # self.other.method(...) where self.other: KnownLockClass
        if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name) \
                and base.value.id == "self":
            target_cls = info.attr_types.get(base.attr)
            if target_cls in classes:
                for lk in acquiring.get(target_cls, {}).get(func.attr, ()):  # type: ignore[arg-type]
                    out.append((target_cls, lk))
        # self.method(...) acquiring a (different) own lock
        elif isinstance(base, ast.Name) and base.id == "self":
            for lk in acquiring.get(info.name, {}).get(func.attr, ()):
                out.append((info.name, lk))
    return out
