"""KRN — kernel tile/bucket budget invariants.

The port keeps the reference's ladder constants (``core/binning_ranges``:
table sizes, bin buckets, ``PACK_TILE_ENTRIES = 8 * 128``), and its CUDA
kernels and plan buckets are built from them, so the reference's two
module-level invariants hold for the port's copies too:

* every table size, bin bucket, tile and block constant is a **power of
  two** — the pow-2 bucket ladder is what lets schedules round-trip
  through ``next_bucket`` bit-for-bit and lets ``rows_per_block_of``
  pack rows with exact divisibility (``KRN001``);
* pack/tile **entry budgets** are multiples of 128 and at most 64K
  entries (``KRN002``).

Both limits of ``KRN002`` come from the reference's Pallas tiles, not
from the card: 128 is the TPU VPU's lane width, ``8 * 128`` its
smallest int32 VMEM tile, and 64K entries the VMEM tile budget past
which Mosaic spills.  The port keeps them so that its buckets and packs
stay the reference's, bucket for bucket.

Both checks evaluate module-level ALL_CAPS constants whose names match
the tile/bucket vocabulary; simple constant arithmetic (``8 * 128``)
is folded.  Deliberately non-pow-2 constants (the GPU-shaved
``NUMERIC_TABLE_SIZES = (31, 255, ...)``) are suppressed inline with a
documented reason rather than special-cased here.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .callgraph import CallGraph
from .core import Finding, Project

RULES = {
    "KRN001": "tile/bucket constant is not a power of two",
    "KRN002": "pack/tile entry budget is not lane-aligned or exceeds VMEM",
}

_POW2_NAME_RE = re.compile(
    r"(TABLE_SIZES|BUCKET|TILE|BLOCK|PACK)", re.IGNORECASE)
_BUDGET_NAME_RE = re.compile(r"(PACK|ENTRIES)", re.IGNORECASE)

_LANE = 128
# One int32 VMEM tile budget for packed tables: beyond this the pack
# ladder would overrun a tile and Mosaic starts spilling.
_MAX_TILE_ENTRIES = 64 * 1024


def _fold(node: ast.AST) -> Optional[int]:
    """Fold simple constant integer arithmetic (8 * 128, 1 << 10)."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) \
            and not isinstance(node.value, bool) else None
    if isinstance(node, ast.BinOp):
        left, right = _fold(node.left), _fold(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.Pow):
                return left ** right
            if isinstance(node.op, ast.LShift):
                return left << right
        except (ZeroDivisionError, OverflowError, ValueError):
            return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _fold(node.operand)
        return -inner if inner is not None else None
    return None


def _values(node: ast.AST) -> List[Optional[int]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return [_fold(e) for e in node.elts]
    return [_fold(node)]


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def run(project: Project, graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    for sf in sorted(project.iter_files(), key=lambda s: s.relpath):
        for node in sf.tree.body:
            targets = []
            value = None
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                targets = [node.target]
                value = node.value
            if not targets or value is None:
                continue
            for tgt in targets:
                name = tgt.id
                if not name.isupper():
                    continue
                vals = [v for v in _values(value) if v is not None]
                if not vals:
                    continue
                if _POW2_NAME_RE.search(name):
                    bad = [v for v in vals if not _is_pow2(v)]
                    if bad:
                        findings.append(Finding(
                            rule="KRN001", path=sf.relpath,
                            line=node.lineno, col=node.col_offset,
                            message=f"`{name}` contains non-power-of-two "
                                    f"value(s) {bad}: the pow-2 bucket ladder "
                                    "(next_bucket / rows_per_block_of) "
                                    "assumes exact pow-2 divisibility",
                            hint="round to the nearest power of two, or "
                                 "suppress with a documented reason if the "
                                 "size is deliberately shaved",
                        ))
                if _BUDGET_NAME_RE.search(name):
                    for v in vals:
                        if v % _LANE != 0:
                            findings.append(Finding(
                                rule="KRN002", path=sf.relpath,
                                line=node.lineno, col=node.col_offset,
                                message=f"`{name}` = {v} is not a multiple "
                                        f"of the {_LANE}-wide VPU lane: "
                                        "packed tiles would straddle lanes",
                                hint=f"size entry budgets in units of {_LANE}",
                            ))
                        elif v > _MAX_TILE_ENTRIES:
                            findings.append(Finding(
                                rule="KRN002", path=sf.relpath,
                                line=node.lineno, col=node.col_offset,
                                message=f"`{name}` = {v} exceeds the "
                                        f"{_MAX_TILE_ENTRIES}-entry VMEM "
                                        "tile budget",
                                hint="shrink the pack budget or split the "
                                     "tile across grid steps",
                            ))
    return findings
