"""INT001 — host-int width discipline (the reference's host-int audit).

The card's index arrays are int32, so anything fetched to the host as
an array — ``t.numpy()``, ``np.asarray(...)``, an explicit
``np.int32(...)``, a host tensor cast with ``.int()`` /
``.to(torch.int32)`` — carries 32-bit scalars whose arithmetic stays
32-bit and silently wraps near 2**31.  Host capacity / flop / byte
accumulators must therefore widen at the fetch boundary (``int(...)`` /
``np.int64(...)`` / ``.long()`` / ``.to(torch.int64)``) before
arithmetic: 2 * nnz * 8 bytes overflows int32 for matrices this engine
already serves.  ``.item()`` and ``.tolist()`` give Python ints, which
do not wrap, so they are not producers.

The rule tracks names assigned from narrowing producers and flags
arithmetic flowing into accumulator-named targets (``*_bytes``,
``*flops*``, ``total_*``, ``*nnz*``, ``cap*``, ...) when the narrow
subexpression is not wrapped in a widening call.  Steady functions are
skipped — device math is int32 by design; the rule polices the host
side only.  The reference's numpy (and ``jax.device_get``) producers
and wideners are kept unchanged, so both linters agree on the
reference's fixtures; the torch forms are added to them.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from .callgraph import CallGraph, resolve_dotted, walk_function
from .core import Finding, Project

RULES = {
    "INT001": "int32 host value (numpy or torch) flows into a host "
              "accumulator unwidened",
}

_ACC_RE = re.compile(
    r"(bytes|flop|nnz|prod|cap|total|count|acc|size|sum)", re.IGNORECASE)

_WIDENERS = {"int", "numpy.int64", "numpy.uint64", "float"}
_NARROW_PRODUCERS = {"jax.device_get", "numpy.asarray", "numpy.array",
                     "numpy.int32", "numpy.uint32"}
# torch forms: t.numpy() / t.int() / t.to(torch.int32) narrow,
# t.long() / t.to(torch.int64) widen
_NARROW_METHODS = {"numpy", "int"}
_NARROW_TORCH = {"torch.int32", "torch.uint32", "torch.int"}
_WIDE_TORCH = {"torch.int64", "torch.long", "torch.uint64", "torch.float64",
               "torch.double"}


def run(project: Project, graph: CallGraph) -> List[Finding]:
    traced_nodes = {fn.node for fn in graph.traced}
    findings: List[Finding] = []
    for sf in sorted(project.iter_files(), key=lambda s: s.relpath):
        mi = graph.modules[sf.modname]
        for fn, scope in mi.functions:
            if fn.node in traced_nodes:
                continue
            findings.extend(_check_function(fn, mi))
    return findings


def _torch_cast(node: ast.Call, mi, dtypes) -> bool:
    """``x.to(torch.int32)`` / ``x.to(dtype=torch.int32)`` for a dtype in
    *dtypes*."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "dtype"]
    return any(resolve_dotted(a, mi) in dtypes for a in args)


def _is_narrow_call(node: ast.Call, mi) -> bool:
    dotted = resolve_dotted(node.func, mi)
    if dotted in _NARROW_PRODUCERS:
        return True
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _NARROW_METHODS:
        return True
    if _torch_cast(node, mi, _NARROW_TORCH):
        return True
    # x.astype(np.int32) / x.astype("int32")
    if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
        for arg in node.args:
            d = resolve_dotted(arg, mi)
            if d in {"numpy.int32", "numpy.uint32"}:
                return True
            if isinstance(arg, ast.Constant) and arg.value in ("int32", "uint32"):
                return True
    return False


def _is_widener(node: ast.Call, mi) -> bool:
    if isinstance(node.func, ast.Name) and node.func.id in {"int", "float"}:
        return True
    if isinstance(node.func, ast.Attribute) and node.func.attr == "long":
        return True
    if _torch_cast(node, mi, _WIDE_TORCH):
        return True
    dotted = resolve_dotted(node.func, mi)
    return dotted in _WIDENERS


def _check_function(fn, mi) -> List[Finding]:
    findings: List[Finding] = []
    narrow_vars: Set[str] = set()

    def expr_narrow(node: ast.AST, widened: bool = False) -> bool:
        """True if *node* contains an unwidened narrow value."""
        if isinstance(node, ast.Call):
            if _is_widener(node, mi):
                return False  # everything below is widened
            if _is_narrow_call(node, mi):
                return not widened
            return any(expr_narrow(a, widened) for a in node.args)
        if isinstance(node, ast.Name):
            return node.id in narrow_vars and not widened
        if isinstance(node, ast.Subscript):
            return expr_narrow(node.value, widened)
        if isinstance(node, ast.BinOp):
            return expr_narrow(node.left, widened) or \
                expr_narrow(node.right, widened)
        if isinstance(node, ast.UnaryOp):
            return expr_narrow(node.operand, widened)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(expr_narrow(e, widened) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return expr_narrow(node.body, widened) or \
                expr_narrow(node.orelse, widened)
        if isinstance(node, ast.Attribute):
            # attribute chains off narrow values (e.g. fetched.sum())
            return expr_narrow(node.value, widened)
        return False

    # a def's own body: nested defs are checked on their own (the
    # reference walks them with their parent too, reporting them twice)
    own = list(walk_function(fn.node, set()))

    # pass 1: which locals hold narrow values?
    for _ in range(4):
        before = len(narrow_vars)
        for node in own:
            if isinstance(node, ast.Assign) and expr_narrow(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        narrow_vars.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name) \
                    and expr_narrow(node.value):
                narrow_vars.add(node.target.id)
        if len(narrow_vars) == before:
            break

    # pass 2: narrow arithmetic flowing into accumulator-named targets
    for node in own:
        target_name = None
        rhs = None
        arithmetic = False
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            target_name, rhs, arithmetic = node.target.id, node.value, True
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target_name, rhs = node.targets[0].id, node.value
            arithmetic = isinstance(rhs, ast.BinOp)
        if target_name is None or rhs is None or not arithmetic:
            continue
        if not _ACC_RE.search(target_name):
            continue
        if expr_narrow(rhs):
            findings.append(Finding(
                rule="INT001", path=fn.sf.relpath,
                line=node.lineno, col=node.col_offset,
                message=f"accumulator `{target_name}` absorbs a narrow "
                        "(int32) value without widening: host arithmetic "
                        "wraps at 2**31",
                hint="widen at the fetch boundary: wrap the device-fetched "
                     "subscript/scalar in int(...) or np.int64(...) before "
                     "the arithmetic",
            ))
    return findings
