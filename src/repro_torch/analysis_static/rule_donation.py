"""DON001 — donation discipline (the reference's arena-alias contract).

A buffer passed to a donating function is consumed: the function may
write it in place or hand it back rewritten, so any later read of the
old binding observes what the function left there, not what was passed.
In the reference these are ``donate_argnums`` buffers (XLA aliases
their memory); in the port they are marked on the ``def`` line:

* ``exclusive_sum_in_place(buf)``  ``# opslint: donates=buf`` — the
  counts buffer becomes the row pointers (the reference's
  ``_exclusive_sum`` donation);
* ``bin_rows_into(sizes, buf, ...)``  ``# opslint: donates=buf`` — the
  fused metadata buffer is written in place;
* ``Model.decode_step(..., caches, ..., donate=True)``
  ``# opslint: donates=caches if donate`` — the caches are updated in
  place and returned; the donation holds only when the call passes
  ``donate`` as something other than ``False`` / ``None``.

At each call site the donated parameters are mapped to argument
expressions (positionally or by keyword; a method donor matches any
``<obj>.<name>(...)`` call), and any later load of that binding inside
the same function is flagged, stopping at a rebind (``x = f(x)`` is the
blessed pattern: the old binding dies at the call).  The path analysis
is a linear source-order approximation, which is exactly how the
engine's straight-line dispatch bodies read.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .callgraph import CallGraph, FuncInfo, Marker, walk_function
from .core import Finding, Project

RULES = {
    "DON001": "read of a donated binding after the donating call",
}


def run(project: Project, graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    methods = {fn.name: fn for fn in graph.donor_defs if fn.cls is not None}
    for modname, mi in sorted(graph.modules.items()):
        for fn, scope in mi.functions:
            findings.extend(_check_function(fn, mi, graph, methods))
    return findings


def _donor_for_call(call: ast.Call, mi, graph: CallGraph,
                    methods: Dict[str, FuncInfo]) -> Optional[FuncInfo]:
    func = call.func
    if isinstance(func, ast.Attribute):
        if isinstance(func.value, ast.Name):
            # module-qualified call to a donating def: mod.f(x)
            target_mod = mi.module_aliases.get(func.value.id)
            if target_mod is None and func.value.id in mi.symbol_imports:
                m, s = mi.symbol_imports[func.value.id]
                target_mod = f"{m}.{s}"
            other = graph.modules.get(target_mod) if target_mod else None
            if other is not None:
                target = other.scope.defs.get(func.attr)
                return target if target in graph.donor_defs else None
        # a donating method, on any receiver: model.decode_step(...)
        return methods.get(func.attr)
    if not isinstance(func, ast.Name):
        return None
    name = func.id
    # donating defs, resolved through imports or local scope
    if name in mi.symbol_imports:
        mod, sym = mi.symbol_imports[name]
        other = graph.modules.get(mod)
        if other is not None:
            target = other.scope.defs.get(sym)
            if target is not None and target in graph.donor_defs:
                return target
        return None
    for candidate in graph.donor_defs:
        if candidate.sf.modname == mi.sf.modname and candidate.name == name \
                and candidate.cls is None:
            return candidate
    return None


def _chain_str(node: ast.AST) -> Optional[str]:
    """Dotted string for a Name or simple attribute chain
    (``lease.i32`` -> "lease.i32"); None for anything more complex."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _donates(call: ast.Call, marker: Marker) -> bool:
    """Whether this call turns the conditional donation on."""
    if marker.donate_if is None:
        return True
    for kw in call.keywords:
        if kw.arg == marker.donate_if:
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value in (False, None, 0))
    return False


def _donated_arg_names(call: ast.Call, donor: FuncInfo,
                       marker: Marker) -> List[str]:
    """Bindings (names or simple attribute chains) in donated positions."""
    if not _donates(call, marker):
        return []
    params = donor.params
    offset = 1 if params[:1] == ["self"] else 0
    out = []
    for pname in marker.donate_names:
        arg = None
        for kw in call.keywords:
            if kw.arg == pname:
                arg = kw.value
        if arg is None and pname in params:
            pos = params.index(pname) - offset
            if 0 <= pos < len(call.args):
                arg = call.args[pos]
        if arg is not None:
            chain = _chain_str(arg)
            if chain is not None:
                out.append(chain)
    return out


def _check_function(fn: FuncInfo, mi, graph: CallGraph,
                    methods: Dict[str, FuncInfo]) -> List[Finding]:
    findings: List[Finding] = []
    # gather (position, kind, name, node) events for every interesting name
    donations: List[Tuple[Tuple[int, int], str, ast.Call]] = []
    # own body only: a nested def's calls are checked with the nested def
    for node in walk_function(fn.node, set()):
        if isinstance(node, ast.Call):
            donor = _donor_for_call(node, mi, graph, methods)
            if donor is None:
                continue
            for name in _donated_arg_names(node, donor,
                                           graph.donor_defs[donor]):
                donations.append(((node.lineno, node.col_offset), name, node))
    if not donations:
        return findings

    loads: Dict[str, List[Tuple[Tuple[int, int], ast.AST]]] = {}
    stores: Dict[str, List[Tuple[int, int]]] = {}
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Name):
            pos = (node.lineno, node.col_offset)
            if isinstance(node.ctx, ast.Load):
                loads.setdefault(node.id, []).append((pos, node))
            else:  # Store / Del both kill the old binding
                stores.setdefault(node.id, []).append(pos)
        elif isinstance(node, ast.Attribute):
            chain = _chain_str(node)
            if chain is None or "." not in chain:
                continue
            pos = (node.lineno, node.col_offset)
            if isinstance(node.ctx, ast.Load):
                loads.setdefault(chain, []).append((pos, node))
            else:
                stores.setdefault(chain, []).append(pos)

    for call_pos, name, call in donations:
        # first rebind at/after the donating statement kills the binding
        # (covers the `x = f(x)` idiom: the Assign target shares the call's
        # line but sits at an earlier column, so compare by line only)
        kill = min((p for p in stores.get(name, []) if p[0] >= call_pos[0]),
                   default=None)
        for pos, load in sorted(loads.get(name, [])):
            if pos <= call_pos:
                continue
            if _inside(call, load):
                continue  # the donating call's own argument
            if kill is not None and pos > kill:
                break
            findings.append(Finding(
                rule="DON001", path=fn.sf.relpath,
                line=load.lineno, col=load.col_offset,
                message=f"`{name}` is read after being donated at line "
                        f"{call.lineno}: the callee consumes the buffer "
                        "(writes it in place or returns it rewritten)",
                hint="rebind the result over the donated name "
                     f"(`{name} = ...`), or drop donation for this argument",
            ))
    return findings


def _inside(outer: ast.AST, node: ast.AST) -> bool:
    return any(child is node for child in ast.walk(outer))
