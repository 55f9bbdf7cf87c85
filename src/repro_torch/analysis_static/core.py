"""Core opslint machinery: findings, project loading, suppressions, baseline.

Everything here is pure AST/text work — the analyzed package is never
imported, so the linter runs in any environment (no torch or JAX
needed) and is safe to point at broken or half-written code.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# `# opslint: disable=TRC001` or `# opslint: disable=TRC001,LCK002 -- reason`.
# The ``-- reason`` tail is strongly encouraged (review-enforced): a
# suppression without a reason is a finding waiting to come back.
_SUPPRESS_RE = re.compile(
    r"#\s*opslint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:--\s*(?P<reason>.*))?$"
)

# `self.field = ...  # guarded-by: _lock` — ground truth for LCK002.
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One lint finding, stable enough to diff against a baseline."""

    rule: str          # e.g. "TRC001"
    path: str          # project-relative, posix separators
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    hint: str = ""     # concrete fix suggestion

    def key(self) -> Tuple[str, str, int, int]:
        return (self.rule, self.path, self.line, self.col)

    def format_text(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
        }


@dataclass
class SourceFile:
    """A parsed module plus the raw text the comment-level checks need."""

    path: Path                 # absolute
    relpath: str               # relative to the project root, posix
    modname: str               # dotted module name ("repro_torch.engine.cache")
    text: str
    lines: List[str]
    tree: ast.Module
    # line -> set of rule ids suppressed there ({"*"} = all rules)
    suppressions: Dict[int, set] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class Project:
    """All source files under analysis, keyed by relpath and modname."""

    root: Path
    files: Dict[str, SourceFile] = field(default_factory=dict)
    by_modname: Dict[str, SourceFile] = field(default_factory=dict)

    def add(self, sf: SourceFile) -> None:
        self.files[sf.relpath] = sf
        self.by_modname[sf.modname] = sf

    def iter_files(self) -> Iterable[SourceFile]:
        return self.files.values()


def _modname_for(path: Path, root: Path) -> str:
    """Dotted module name for *path*, stripping a leading ``src/`` layer."""
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else path.stem


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, set]:
    """Map line numbers to suppressed rule ids.

    A trailing comment suppresses its own line; a standalone comment
    suppresses itself and the next non-comment line (so a multi-line
    explanation can sit between the directive and the statement).
    """
    out: Dict[int, set] = {}
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not rules:
            continue
        out.setdefault(i, set()).update(rules)
        if raw.lstrip().startswith("#"):  # standalone comment line
            j = i  # 0-based index of the line after the directive
            while j < len(lines) and lines[j].lstrip().startswith("#"):
                j += 1
            out.setdefault(j + 1, set()).update(rules)
    return out


def load_source(path: Path, root: Path) -> Optional[SourceFile]:
    """Parse one .py file; returns None on syntax errors (reported by caller)."""
    text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError:
        return None
    try:
        relpath = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        relpath = path.name
    lines = text.splitlines()
    return SourceFile(
        path=path,
        relpath=relpath,
        modname=_modname_for(path, root),
        text=text,
        lines=lines,
        tree=tree,
        suppressions=_parse_suppressions(lines),
    )


def load_project(paths: Sequence[str], root: Optional[str] = None) -> Project:
    """Load every .py file under *paths* (files or directories)."""
    root_path = Path(root) if root is not None else Path.cwd()
    project = Project(root=root_path)
    seen = set()
    for p in paths:
        base = Path(p)
        if base.is_dir():
            candidates = sorted(base.rglob("*.py"))
        else:
            candidates = [base]
        for cand in candidates:
            key = cand.resolve()
            if key in seen or not cand.suffix == ".py":
                continue
            seen.add(key)
            sf = load_source(cand, root_path)
            if sf is not None:
                project.add(sf)
    return project


def is_suppressed(sf: SourceFile, finding: Finding) -> bool:
    rules = sf.suppressions.get(finding.line)
    if not rules:
        return False
    return "*" in rules or "all" in rules or finding.rule in rules


# ---------------------------------------------------------------------------
# Baseline: fail CI only on NEW findings.
# ---------------------------------------------------------------------------

def save_baseline(findings: Sequence[Finding], path: str) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "findings": [f.to_json() for f in sorted(findings, key=lambda f: f.key())],
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def load_baseline(path: str) -> List[Finding]:
    payload = json.loads(Path(path).read_text(encoding="utf-8"))
    version = payload.get("version")
    if version != BASELINE_VERSION:
        raise ValueError(f"unsupported opslint baseline version: {version!r}")
    out = []
    for row in payload.get("findings", []):
        out.append(Finding(
            rule=row["rule"], path=row["path"], line=int(row["line"]),
            col=int(row.get("col", 0)), message=row.get("message", ""),
            hint=row.get("hint", ""),
        ))
    return out
