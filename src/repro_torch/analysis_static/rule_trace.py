"""TRC — sync-freedom rules for the port's steady paths.

The reference's TRC rules hold ``jax.jit``-traced code to no host sync;
the port has no trace, and its invariant is that the steady dispatch and
the decode step only *enqueue* device work (``chip_smoke.py`` checks it
on the card under ``torch.cuda.set_sync_debug_mode("error")``, for the
paths a run takes).  These rules check it statically for every path
reachable from a ``# opslint: steady`` function (see ``callgraph``).

* ``TRC001``: a host sync inside a steady function.  Anywhere in one:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and any
  ``.synchronize()`` (``torch.cuda.synchronize()``, an event's, a
  stream's).  On a tensor: ``int()`` / ``float()`` / ``bool()``
  coercion and ``np.asarray`` / ``np.array``.  And torch's implicit
  syncs, whose output size depends on the data (JAX cannot trace them
  without ``size=``, so the reference has no counterpart):
  ``nonzero`` / ``torch.nonzero`` (``torch.nonzero_static`` is fine),
  ``torch.unique`` / ``.unique()``, ``masked_select``, loads through a
  boolean mask (``x[x > 0]``), and ``repeat_interleave`` with tensor
  repeats and no ``output_size``.
* ``TRC002``: a Python branch on a tensor's value inside a steady
  function (``if`` / ``while`` / ternary): the test calls
  ``Tensor.__bool__``, which waits for the card.  ``x is None`` is
  structural and exempt, as are branches on ``static=`` parameters,
  closure-captured host config and tensor metadata (``.shape``).

Branches taken only for CPU tensors (the kernel wrappers' plain
versions) are not checked: the card never runs them.
"""

from __future__ import annotations

import ast
from typing import List

from .callgraph import (
    CallGraph,
    analyze_taint,
    function_scope,
    host_narrowed,
    resolve_dotted,
    torch_call_is_tensor,
    walk_function,
)
from .core import Finding, Project

RULES = {
    "TRC001": "host sync inside a steady (sync-free) function",
    "TRC002": "Python branch on a tensor's value inside a steady function",
}

# Methods that read the card from the host, on any receiver.
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_NP_MATERIALIZERS = {"asarray", "array"}
_COERCIONS = {"int", "float", "bool"}
# Data-dependent output sizes: the host waits for the count.
_SIZE_SYNCS = {"nonzero", "unique", "masked_select", "argwhere"}
# Elementwise ops whose result is a boolean mask.
_MASK_METHODS = {"eq", "ne", "lt", "le", "gt", "ge", "bool", "isnan",
                 "isinf", "isfinite", "logical_and", "logical_or",
                 "logical_not", "logical_xor"}


def run(project: Project, graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    for fn, tainted_params in sorted(
            graph.traced.items(), key=lambda kv: (kv[0].sf.relpath, kv[0].node.lineno)):
        mi = graph.modules[fn.sf.modname]
        scope = function_scope(graph, fn)
        taint = analyze_taint(fn, tainted_params, scope, mi, graph)
        expr_tainted = taint.expr_tainted
        host = host_narrowed(fn.node)
        containers = _container_names(fn)

        def branch_on_tensor(test: ast.AST) -> bool:
            """A branch test that calls Tensor.__bool__: the truth of a
            list, tuple or dict of tensors does not."""
            if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
                return branch_on_tensor(test.operand)
            if isinstance(test, ast.BoolOp):
                return any(branch_on_tensor(v) for v in test.values)
            if isinstance(test, ast.Name) and test.id in containers:
                return False
            return taint.test_tainted(test)
        masks = _mask_names(fn, taint.skip, expr_tainted, mi)

        where = f"steady function `{fn.qualname}`"
        for node in walk_function(fn.node, taint.skip):
            if isinstance(node, ast.Call):
                narrowed = host.get(id(node), set())
                findings.extend(_check_call(
                    node, fn, mi, where,
                    lambda e: expr_tainted(e) and not (
                        isinstance(e, ast.Name) and e.id in narrowed)))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and expr_tainted(node.value) \
                    and _is_mask(node.slice, masks, expr_tainted, mi):
                findings.append(Finding(
                    rule="TRC001", path=fn.sf.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=f"boolean-mask indexing in {where}: the result's "
                            "size depends on the data, so the host waits "
                            "for the mask's count",
                    hint="keep the shape fixed: torch.where(mask, x, fill), "
                         "or a sort/scatter into a capacity bucket",
                ))
            elif isinstance(node, (ast.If, ast.While)):
                if branch_on_tensor(node.test):
                    findings.append(Finding(
                        rule="TRC002", path=fn.sf.relpath,
                        line=node.test.lineno, col=node.test.col_offset,
                        message=f"Python branch on a tensor in {where}: the "
                                "condition calls Tensor.__bool__, which "
                                "waits for the card",
                        hint="use torch.where / a masked write, or branch on "
                             "host config (mark the driving parameter "
                             "static= if it is one)",
                    ))
            elif isinstance(node, ast.IfExp):
                if branch_on_tensor(node.test):
                    findings.append(Finding(
                        rule="TRC002", path=fn.sf.relpath,
                        line=node.test.lineno, col=node.test.col_offset,
                        message=f"ternary on a tensor in {where}: the "
                                "condition calls Tensor.__bool__, which "
                                "waits for the card",
                        hint="use torch.where on the tensor condition",
                    ))
    return findings


_CONTAINER_TYPES = {"List", "Tuple", "Sequence", "Dict", "Mapping", "Iterable",
                    "list", "tuple", "dict"}


def _container_names(fn) -> set:
    """Parameters annotated as a list, tuple or dict, and locals assigned
    a display or comprehension of one."""
    out = set()
    a = fn.node.args
    for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = p.annotation
        while isinstance(ann, ast.Subscript):
            head = ann.value
            name = head.attr if isinstance(head, ast.Attribute) else \
                getattr(head, "id", None)
            if name in _CONTAINER_TYPES:
                out.add(p.arg)
                break
            ann = ann.slice     # Optional[List[...]]
        if isinstance(ann, ast.Name) and ann.id in _CONTAINER_TYPES:
            out.add(p.arg)
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.List, ast.Tuple, ast.Dict, ast.ListComp,
                             ast.DictComp)):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _is_mask(node: ast.AST, masks, expr_tainted, mi) -> bool:
    """A boolean tensor: a comparison of tensors, a logical op of masks,
    a mask method's result, or a name in *masks*."""
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.Compare):
        return expr_tainted(node) and not all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in node.ops)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, masks, expr_tainted, mi)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(node.left, masks, expr_tainted, mi) \
            or _is_mask(node.right, masks, expr_tainted, mi)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MASK_METHODS:
        return expr_tainted(node.func.value) or torch_call_is_tensor(node, mi)
    return False


def _mask_names(fn, skip, expr_tainted, mi) -> set:
    """Names assigned a boolean tensor somewhere in *fn*."""
    out: set = set()
    for _ in range(4):
        before = len(out)
        for node in walk_function(fn.node, skip):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_mask(node.value, out, expr_tainted, mi):
                out.add(node.targets[0].id)
        if len(out) == before:
            break
    return out


def _repeats_arg(node: ast.Call, mi):
    """The repeats argument of a ``repeat_interleave`` call."""
    for kw in node.keywords:
        if kw.arg == "repeats":
            return kw.value
    dotted = resolve_dotted(node.func, mi)
    if dotted == "torch.repeat_interleave":
        # torch.repeat_interleave(repeats) or (input, repeats, ...)
        if len(node.args) == 1:
            return node.args[0]
        return node.args[1] if len(node.args) > 1 else None
    return node.args[0] if node.args else None


def _check_call(node: ast.Call, fn, mi, where: str, expr_tainted) -> List[Finding]:
    out: List[Finding] = []
    func = node.func
    loc = dict(path=fn.sf.relpath, line=node.lineno, col=node.col_offset)
    dotted = resolve_dotted(func, mi)
    tail = func.attr if isinstance(func, ast.Attribute) else None
    is_torch_fn = dotted is not None and dotted.startswith("torch.")

    if tail in _SYNC_ATTRS:
        out.append(Finding(
            rule="TRC001", message=f".{tail}() host sync in {where}",
            hint="keep the value on the card (a 0-d tensor); read it once "
                 "at the finalize boundary that already reads the host",
            **loc))
    elif tail in _SIZE_SYNCS and (is_torch_fn or expr_tainted(func.value)):
        out.append(Finding(
            rule="TRC001",
            message=f"{'torch.' if is_torch_fn else '.'}{tail}() in {where}: "
                    "its output size depends on the data, so the host waits "
                    "for the count",
            hint="use a fixed-size form (torch.nonzero_static, a sort into "
                 "a capacity bucket, torch.where) on the steady path",
            **loc))
    elif tail == "repeat_interleave" \
            and (is_torch_fn or expr_tainted(func.value)) \
            and not any(kw.arg == "output_size" for kw in node.keywords):
        repeats = _repeats_arg(node, mi)
        if repeats is not None and expr_tainted(repeats):
            out.append(Finding(
                rule="TRC001",
                message=f"repeat_interleave with tensor repeats and no "
                        f"output_size in {where}: the host waits for the "
                        "repeats' sum",
                hint="pass output_size= (a capacity bucket the plan knows)",
                **loc))
    elif dotted is not None and dotted.startswith("numpy.") \
            and dotted.split(".")[-1] in _NP_MATERIALIZERS \
            and any(expr_tainted(a) for a in node.args):
        out.append(Finding(
            rule="TRC001",
            message=f"{dotted.replace('numpy', 'np')}() in {where} "
                    "copies a tensor to the host",
            hint="keep tensors on the card on the steady path; np.* belongs "
                 "on the cold/host planning path only",
            **loc))
    elif isinstance(func, ast.Name) and func.id in _COERCIONS:
        if any(expr_tainted(a) for a in node.args):
            out.append(Finding(
                rule="TRC001",
                message=f"{func.id}() coerces a tensor to a host value in "
                        f"{where}",
                hint="keep device scalars as 0-d tensors on the steady "
                     "path; coerce on the host after finalize's one read",
                **loc))
    return out
