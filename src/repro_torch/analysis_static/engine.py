"""Rule registry, runner, and baseline diffing for the port's opslint."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import rule_donation, rule_intwidth, rule_kernel, rule_locks, rule_trace
from .callgraph import build_callgraph
from .core import Finding, Project, is_suppressed, load_project

_RULE_MODULES = (rule_trace, rule_donation, rule_locks, rule_intwidth,
                 rule_kernel)

ALL_RULES: Dict[str, str] = {}
for _mod in _RULE_MODULES:
    ALL_RULES.update(_mod.RULES)


def run_project(project: Project,
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every rule family over *project*; suppressions applied."""
    graph = build_callgraph(project)
    selected = set(rules) if rules else None
    findings: List[Finding] = []
    for mod in _RULE_MODULES:
        if selected is not None and not (set(mod.RULES) & selected):
            continue
        for f in mod.run(project, graph):
            if selected is not None and f.rule not in selected:
                continue
            sf = project.files.get(f.path)
            if sf is not None and is_suppressed(sf, f):
                continue
            findings.append(f)
    findings.sort(key=lambda f: f.key())
    return findings


def run_paths(paths: Sequence[str], root: Optional[str] = None,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    return run_project(load_project(paths, root=root), rules=rules)


def diff_against_baseline(
        findings: Sequence[Finding],
        baseline: Sequence[Finding]) -> Tuple[List[Finding], List[Finding]]:
    """(new, fixed): findings not in the baseline, and baseline entries
    no longer present (candidates for a baseline refresh)."""
    base_keys = {f.key() for f in baseline}
    cur_keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in base_keys]
    fixed = [f for f in baseline if f.key() not in cur_keys]
    return new, fixed
