"""opslint for the port (repro_torch.analysis_static) — rule fixtures,
parity with the reference's linter, mutations of the real tree, and the
baseline pin.

The reference's 28 tests (tests/test_opslint.py) are ported with torch
fixtures for the TRC and DON rules; the LCK, INT and KRN fixtures are the
reference's, and every one of them goes through both linters, which must
report the same (rule, line, col) lists.  Fixtures are plain text
analyzed by AST: nothing here runs torch.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis_static import run_paths as ref_run_paths
from repro_torch.analysis_static import (
    diff_against_baseline,
    load_baseline,
    load_project,
    run_paths,
    run_project,
)
from repro_torch.analysis_static.__main__ import main as opslint_main
from repro_torch.analysis_static.callgraph import (
    build_callgraph,
    plain_nodes,
    resolve_call,
    walk_function,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def port_project():
    return load_project([str(PORT)], root=str(REPO_ROOT))


@pytest.fixture(scope="module")
def port_graph(port_project):
    return build_callgraph(port_project)


def lint(tmp_path, source, name="fixture.py", rules=None):
    (tmp_path / name).write_text(textwrap.dedent(source), encoding="utf-8")
    return run_paths([str(tmp_path)], root=str(tmp_path), rules=rules)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def keys(findings):
    return [(f.rule, f.line, f.col) for f in findings]


# ---------------------------------------------------------------------------
# TRC — sync-freedom of the steady paths
# ---------------------------------------------------------------------------

TRC_BAD = """
    import torch

    def bad(x):  # opslint: steady
        if x > 0:
            x = x + 1
        n = x.sum().item()
        return int(x) + n
"""

TRC_CLEAN = """
    import torch

    def good(x, m):  # opslint: steady static=m
        if m:
            x = x + 1
        vals = None
        vals = vals if vals is None else vals
        if x.shape[0] > 0 and x.numel() and x.dim() == 1:
            x = x * 2
        return torch.where(x > 0, x, 0)

    def host_only(x):
        return int(x.sum().item())
"""

TRC_SUPPRESSED = """
    import torch

    def tolerated(x):  # opslint: steady
        if x > 0:  # opslint: disable=TRC002 -- a 1-element CPU tensor in tests
            x = x + 1
        return x
"""


def test_trc_flags_host_sync_and_branch(tmp_path):
    findings = lint(tmp_path, TRC_BAD)
    assert "TRC001" in rules_of(findings)
    assert "TRC002" in rules_of(findings)
    # .item() and int(x) are two separate syncs
    assert sum(f.rule == "TRC001" for f in findings) == 2


def test_trc_clean_static_branch_and_host_code(tmp_path):
    findings = lint(tmp_path, TRC_CLEAN)
    assert rules_of(findings) == []


def test_trc_suppressed_inline(tmp_path):
    findings = lint(tmp_path, TRC_SUPPRESSED)
    assert rules_of(findings) == []


def test_trc_propagates_through_call_graph(tmp_path):
    findings = lint(tmp_path, """
        def helper(y):
            if y > 0:
                return y
            return -y

        def entry(x):  # opslint: steady
            return helper(x)
    """)
    assert [f.rule for f in findings] == ["TRC002"]


def test_trc_static_args_do_not_taint_callees(tmp_path):
    # schedule tuples threaded through a steady caller stay static
    findings = lint(tmp_path, """
        def schedule(x, buckets):
            for cap in buckets:
                if not cap:
                    continue
                x = x + cap
            return x

        def entry(x):  # opslint: steady
            return schedule(x, (8, 16))
    """)
    assert rules_of(findings) == []


# The torch forms: tensor fields are device values, metadata is static,
# torch's implicit syncs, plain branches, closures and isinstance tests.

TRC_TORCH_CASES = {
    "tensor_field_branch": ("""
        import torch

        class CSR:
            rpt: torch.Tensor
            col: torch.Tensor

        def run(A):  # opslint: steady
            if A.rpt[-1] > 0:
                return A.col
            return A.nrows
    """, [("TRC002", 9)]),
    "metadata_is_static": ("""
        import torch

        def run(x, A):  # opslint: steady
            if x.shape[0] > 1 and x.ndim == 2 and x.is_cuda:
                x = x[: x.size(0)]
            if A.nrows and len(x) and x.numel() > 3:
                x = x * A.capacity
            return x
    """, []),
    "implicit_syncs": ("""
        import torch

        def run(x, r):  # opslint: steady
            a = torch.nonzero(x)
            b = x.nonzero()
            c = torch.unique(x)
            d = x.masked_select(x > 0)
            e = x[x > 0]
            mask = x < 3
            f = x[~mask]
            g = x.repeat_interleave(r)
            h = torch.repeat_interleave(x, r, output_size=8)
            i = x.repeat_interleave(2)
            j = torch.nonzero_static(x, size=4)
            k = x[:2]
            return a, b, c, d, e, f, g, h, i, j, k
    """, [("TRC001", 5), ("TRC001", 6), ("TRC001", 7), ("TRC001", 8),
          ("TRC001", 9), ("TRC001", 11), ("TRC001", 12)]),
    "syncs_anywhere": ("""
        import torch

        def run(x, config):  # opslint: steady static=config
            torch.cuda.synchronize()
            ev = torch.cuda.Event()
            ev.synchronize()
            a = config.tolist()
            b = x.cpu()
            return a, b.numpy()
    """, [("TRC001", 5), ("TRC001", 7), ("TRC001", 8), ("TRC001", 9),
          ("TRC001", 10)]),
    "plain_branch_not_followed": ("""
        import torch

        def kernel_plain(x):
            return torch.tensor(x.tolist())

        def kernel(x):
            if not x.is_cuda:
                return kernel_plain(x)
            if x.device.type != "cuda":
                print(int(x.sum()))
            return x + 1

        def run(x):  # opslint: steady
            return kernel(x) if x.is_cuda else x.cpu()
    """, []),
    "closure_taint": ("""
        import torch

        def outer(x, positions):  # opslint: steady
            def step(y):
                if positions[0] > 0:
                    return y
                return y + 1
            return _scan(step, x)

        def _scan(fn, x):
            return fn(x)
    """, [("TRC002", 6)]),
    "host_factories_and_narrowing": ("""
        import torch

        def _pos(pos, b, device):
            if isinstance(pos, torch.Tensor):
                return pos.expand(b)
            return torch.full((b,), int(pos), device=device)

        def _probe():
            out = torch.zeros(1, dtype=torch.int32)
            return int(out[0])

        def run(x, pos, p):  # opslint: steady
            if "q_norm" in p and _probe() > 0:
                x = x + p["q_norm"]
            return _pos(pos, x.shape[0], x.device) + x
    """, []),
}


@pytest.mark.parametrize("case", sorted(TRC_TORCH_CASES))
def test_trc_torch_forms(tmp_path, case):
    source, want = TRC_TORCH_CASES[case]
    findings = lint(tmp_path, source)
    assert [(f.rule, f.line) for f in findings] == want, \
        "\n".join(f.format_text() for f in findings)


# ---------------------------------------------------------------------------
# DON — donation discipline
# ---------------------------------------------------------------------------

DON_BAD = """
    import torch

    def exclusive_sum_in_place(buf):  # opslint: donates=buf
        out = torch.zeros_like(buf)
        out[1:] = torch.cumsum(buf[:-1], 0)
        return out

    def use(nnz_buf):
        rpt = exclusive_sum_in_place(nnz_buf)
        return nnz_buf + rpt
"""

DON_CLEAN = """
    import torch

    def exclusive_sum_in_place(buf):  # opslint: donates=buf
        out = torch.zeros_like(buf)
        out[1:] = torch.cumsum(buf[:-1], 0)
        return out

    def use(nnz_buf):
        nnz_buf = exclusive_sum_in_place(nnz_buf)
        return nnz_buf
"""

DON_SUPPRESSED = """
    import torch

    def exclusive_sum_in_place(buf):  # opslint: donates=buf
        out = torch.zeros_like(buf)
        out[1:] = torch.cumsum(buf[:-1], 0)
        return out

    def use(nnz_buf):
        rpt = exclusive_sum_in_place(nnz_buf)
        return nnz_buf + rpt  # opslint: disable=DON001 -- a copy in tests
"""


def test_don_flags_read_after_donation(tmp_path):
    findings = lint(tmp_path, DON_BAD)
    assert [f.rule for f in findings] == ["DON001"]
    assert "donated at line" in findings[0].message


def test_don_clean_rebind_idiom(tmp_path):
    assert lint(tmp_path, DON_CLEAN) == []


def test_don_suppressed_inline(tmp_path):
    assert lint(tmp_path, DON_SUPPRESSED) == []


def test_don_decorated_def_and_attribute_chain(tmp_path):
    # the marker may sit on any line of a multi-line signature
    findings = lint(tmp_path, """
        def bin_rows_into(sizes,
                          buf, *,  # opslint: donates=buf
                          m):
            buf[:m] = sizes
            return buf

        def use(lease, sizes):
            out = bin_rows_into(sizes, lease.i32, m=4)
            return lease.i32 + out
    """)
    assert [f.rule for f in findings] == ["DON001"]
    assert "`lease.i32`" in findings[0].message


DON_DECODE = """
    class Model:
        def decode_step(self, params, token, caches, pos, *,  # opslint: steady static=donate
                        donate=False):  # opslint: donates=caches if donate
            return token, caches

    def serve_donated(model, params, token, caches):
        logits, new = model.decode_step(params, token, caches, 0, donate=True)
        return logits, caches

    def serve_copied(model, params, token, caches):
        logits, new = model.decode_step(params, token, caches, 0)
        off = model.decode_step(params, token, caches, 0, donate=False)
        return logits, caches, off

    def serve_rebound(model, params, token, caches):
        logits, caches = model.decode_step(params, token, caches=caches, pos=0,
                                           donate=True)
        return logits, caches
"""


def test_don_conditional_method_donation(tmp_path):
    findings = lint(tmp_path, DON_DECODE)
    assert [(f.rule, f.line) for f in findings] == [("DON001", 9)]
    assert "`caches`" in findings[0].message


# ---------------------------------------------------------------------------
# LCK — lock order / guarded fields (the reference's fixtures)
# ---------------------------------------------------------------------------

LCK_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def bump(self):
            self.count += 1
"""

LCK_CLEAN = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def bump(self):
            with self._lock:
                self.count += 1

        def _bump_locked(self):
            self.count += 1
"""

LCK_SUPPRESSED = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def bump_unsafe(self):
            self.count += 1  # opslint: disable=LCK002 -- single-thread path
"""

LCK_CYCLE = """
    import threading

    class Alpha:
        def __init__(self, other: "Beta" = None):
            self._lock = threading.Lock()
            self.other = other

        def poke(self):
            with self._lock:
                self.other.poke()

    class Beta:
        def __init__(self, other: "Alpha" = None):
            self._lock = threading.Lock()
            self.other = other

        def poke(self):
            with self._lock:
                self.other.poke()
"""

LCK_ORDERED = """
    import threading

    class Alpha:
        def __init__(self, other: "Beta" = None):
            self._lock = threading.Lock()
            self.other = other

        def poke(self):
            with self._lock:
                self.other.poke()

    class Beta:
        def __init__(self):
            self._lock = threading.Lock()

        def poke(self):
            with self._lock:
                pass
"""

LCK_MUTATOR = """
    import threading

    class Roster:
        def __init__(self):
            self._lock = threading.Lock()
            self._members = []  # guarded-by: _lock

        def add(self, m):
            self._members.append(m)
"""


def test_lck_flags_unlocked_guarded_write(tmp_path):
    findings = lint(tmp_path, LCK_BAD)
    assert [f.rule for f in findings] == ["LCK002"]
    assert "guarded-by: _lock" in findings[0].message


def test_lck_clean_with_lock_and_locked_convention(tmp_path):
    assert lint(tmp_path, LCK_CLEAN) == []


def test_lck_suppressed_inline(tmp_path):
    assert lint(tmp_path, LCK_SUPPRESSED) == []


def test_lck_detects_lock_order_cycle(tmp_path):
    findings = lint(tmp_path, LCK_CYCLE)
    assert [f.rule for f in findings] == ["LCK001"]
    assert "Alpha._lock" in findings[0].message
    assert "Beta._lock" in findings[0].message


def test_lck_one_directional_nesting_is_clean(tmp_path):
    assert lint(tmp_path, LCK_ORDERED) == []


def test_lck_mutator_call_counts_as_write(tmp_path):
    findings = lint(tmp_path, LCK_MUTATOR)
    assert [f.rule for f in findings] == ["LCK002"]


# ---------------------------------------------------------------------------
# INT — host-int width (the reference's fixtures, then the torch forms)
# ---------------------------------------------------------------------------

INT_BAD = """
    import jax

    def tally(x):
        fetched = jax.device_get(x)
        total_bytes = 0
        total_bytes += fetched[0] * 8
        return total_bytes
"""

INT_CLEAN = """
    import jax

    def tally(x):
        fetched = jax.device_get(x)
        total_bytes = 0
        total_bytes += int(fetched[0]) * 8
        return total_bytes
"""

INT_SUPPRESSED = """
    import jax

    def tally(x):
        fetched = jax.device_get(x)
        total_bytes = 0
        total_bytes += fetched[0] * 8  # opslint: disable=INT001 -- tiny fixture counts
        return total_bytes
"""

INT_TORCH = """
    import torch

    def tally(t):
        fetched = t.numpy()
        narrow = t.int()
        cast = t.to(torch.int32)
        total_bytes = 0
        total_bytes += fetched[0] * 8
        total_bytes += narrow[0] * 8
        total_bytes += cast[0] * 8
        total_bytes += narrow.long()[0] * 8
        total_bytes += cast.to(torch.int64)[0] * 8
        total_bytes += t.item() * 8 + sum(t.tolist())
        return total_bytes
"""


def test_int_flags_unwidened_accumulator(tmp_path):
    findings = lint(tmp_path, INT_BAD)
    assert [f.rule for f in findings] == ["INT001"]
    assert "total_bytes" in findings[0].message


def test_int_clean_when_widened_at_fetch(tmp_path):
    assert lint(tmp_path, INT_CLEAN) == []


def test_int_suppressed_inline(tmp_path):
    assert lint(tmp_path, INT_SUPPRESSED) == []


def test_int_torch_producers_and_wideners(tmp_path):
    findings = lint(tmp_path, INT_TORCH)
    assert [(f.rule, f.line) for f in findings] == [
        ("INT001", 9), ("INT001", 10), ("INT001", 11)]


# ---------------------------------------------------------------------------
# KRN — kernel budgets (the reference's fixtures)
# ---------------------------------------------------------------------------

KRN_BAD = """
    BAD_TABLE_SIZES = (16, 24)
    FOO_ENTRIES = 192
"""

KRN_CLEAN = """
    GOOD_TABLE_SIZES = (16, 32)
    PACK_TILE_ENTRIES = 8 * 128
    lowercase_sizes = (3, 5)
"""

KRN_SUPPRESSED = """
    # opslint: disable=KRN001 -- deliberately shaved sizes (paper Table 2)
    BAD_TABLE_SIZES = (15, 31)
    BIG_ENTRIES = 128 * 1024  # opslint: disable=KRN002 -- HBM-resident table
"""

KRN_HUGE = "HUGE_ENTRIES = 128 * 1024\n"


def test_krn_flags_non_pow2_and_lane_misaligned(tmp_path):
    findings = lint(tmp_path, KRN_BAD)
    assert rules_of(findings) == ["KRN001", "KRN002"]


def test_krn_clean_constants_with_folding(tmp_path):
    assert lint(tmp_path, KRN_CLEAN) == []


def test_krn_suppressed_inline(tmp_path):
    assert lint(tmp_path, KRN_SUPPRESSED) == []


def test_krn_flags_over_budget_entries(tmp_path):
    findings = lint(tmp_path, KRN_HUGE)
    assert [f.rule for f in findings] == ["KRN002"]
    assert "VMEM" in findings[0].message


# ---------------------------------------------------------------------------
# engine: baseline diffing + CLI
# ---------------------------------------------------------------------------

LCK_BAD_TWICE = LCK_BAD + """
        def bump_again(self):
            self.count += 1
"""


def test_fail_on_new_diffs_against_baseline(tmp_path, capsys):
    fixture = tmp_path / "mod.py"
    fixture.write_text(textwrap.dedent(LCK_BAD), encoding="utf-8")
    baseline = tmp_path / "base.json"

    # write a baseline containing the finding -> gate passes
    rc = opslint_main([str(fixture), "--root", str(tmp_path),
                       "--write-baseline", str(baseline)])
    assert rc == 0
    rc = opslint_main([str(fixture), "--root", str(tmp_path),
                       "--fail-on-new", "--baseline", str(baseline)])
    assert rc == 0

    # a NEW finding (second unlocked write) must fail the gate
    fixture.write_text(textwrap.dedent(LCK_BAD_TWICE), encoding="utf-8")
    rc = opslint_main([str(fixture), "--root", str(tmp_path),
                       "--fail-on-new", "--baseline", str(baseline)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "1 new" in out


def test_json_format_is_machine_readable(tmp_path, capsys):
    fixture = tmp_path / "mod.py"
    fixture.write_text(textwrap.dedent(TRC_BAD), encoding="utf-8")
    rc = opslint_main([str(fixture), "--root", str(tmp_path),
                       "--format", "json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == 3
    assert {f["rule"] for f in payload["findings"]} == {"TRC001", "TRC002"}
    assert all(f["line"] > 0 and f["hint"] for f in payload["findings"])


def test_rule_selection(tmp_path):
    findings = lint(tmp_path, TRC_BAD, rules=["TRC002"])
    assert rules_of(findings) == ["TRC002"]


def test_diff_against_baseline_reports_fixed(tmp_path):
    findings = lint(tmp_path, LCK_BAD)
    assert len(findings) == 1
    stale = findings + [findings[0].__class__(
        rule="LCK002", path="gone.py", line=9, col=0,
        message="no longer reproduces")]
    new, fixed = diff_against_baseline(findings, stale)
    assert new == []
    assert [f.path for f in fixed] == ["gone.py"]


def test_cli_catalog_and_usage_errors(tmp_path, capsys):
    assert opslint_main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == ["DON001", "INT001", "KRN001", "KRN002", "LCK001",
                      "LCK002", "TRC001", "TRC002"]
    assert opslint_main([str(tmp_path), "--rules", "TRC009"]) == 2
    assert opslint_main([str(tmp_path / "missing")]) == 2


# ---------------------------------------------------------------------------
# parity: the reference's LCK / INT / KRN fixtures through both linters
# ---------------------------------------------------------------------------

PARITY_FIXTURES = {
    "LCK_BAD": LCK_BAD, "LCK_CLEAN": LCK_CLEAN,
    "LCK_SUPPRESSED": LCK_SUPPRESSED, "LCK_CYCLE": LCK_CYCLE,
    "LCK_ORDERED": LCK_ORDERED, "LCK_MUTATOR": LCK_MUTATOR,
    "LCK_BAD_TWICE": LCK_BAD_TWICE, "INT_BAD": INT_BAD,
    "INT_CLEAN": INT_CLEAN, "INT_SUPPRESSED": INT_SUPPRESSED,
    "KRN_BAD": KRN_BAD, "KRN_CLEAN": KRN_CLEAN,
    "KRN_SUPPRESSED": KRN_SUPPRESSED, "KRN_HUGE": KRN_HUGE,
}


@pytest.mark.parametrize("name", sorted(PARITY_FIXTURES))
def test_parity_with_reference_on_its_fixtures(tmp_path, name):
    (tmp_path / "fixture.py").write_text(
        textwrap.dedent(PARITY_FIXTURES[name]), encoding="utf-8")
    ours = run_paths([str(tmp_path)], root=str(tmp_path))
    theirs = ref_run_paths([str(tmp_path)], root=str(tmp_path))
    assert keys(ours) == keys(theirs)
    if not name.endswith(("CLEAN", "SUPPRESSED", "ORDERED")):
        assert ours, f"{name} should flag"


def test_parity_with_reference_on_the_port(port_project):
    rules = ["LCK001", "LCK002", "KRN001", "KRN002"]
    ours = run_project(port_project, rules=rules)
    theirs = ref_run_paths([str(PORT)], root=str(REPO_ROOT), rules=rules)
    assert [f.key() for f in ours] == [f.key() for f in theirs]


# ---------------------------------------------------------------------------
# mutations of a copy of src/repro_torch
# ---------------------------------------------------------------------------

# (name, file, anchor line text, occurrence, planted lines, rule[, lines
# the anchor's statement runs on]); each plant goes after the anchor's
# statement, at the anchor's indentation.
MUTATIONS = [
    ("hot_item", "engine/executor.py", "total_nprod = nprod.sum()", 0,
     "_ = total_nprod.item()", "TRC001"),
    ("hash_item", "engine/executor.py", "total_nprod = nprod.sum()", 1,
     "_ = total_nprod.item()", "TRC001"),
    ("fused_item", "engine/executor.py", "total_nprod = nprod.sum()", 2,
     "_ = total_nprod.item()", "TRC001"),
    ("merge_item", "engine/executor.py", "nnzs = torch.stack(", 0,
     "_ = nnzs[0].item()", "TRC001"),
    ("decode_item", "models/model.py", "b = token.shape[0]", 0,
     "_ = token[0, 0].item()", "TRC001"),
    ("fused_branch", "engine/executor.py", "total_nnz = nnz.sum()", 2,
     "if nnz.sum() > 0:\n    pass", "TRC002"),
    ("nnz_buf_after_sum", "engine/executor.py",
     "rpt = exclusive_sum_in_place(nnz_buf)", 0,
     "_ = nnz_buf[:m]", "DON001"),
    ("caches_after_decode", "launch/steps.py",
     "logits, new_caches = model.decode_step(", 0, "_ = caches", "DON001",
     1),
]


@pytest.fixture(scope="module")
def mutated(tmp_path_factory):
    """Every plant in one copy of the tree, linted once:
    (findings, {name: (relpath, planted line)})."""
    root = tmp_path_factory.mktemp("mutated")
    dst = root / "src" / "repro_torch"
    shutil.copytree(PORT, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    where = {}
    for name, rel, anchor, nth, text, _rule, *more in MUTATIONS:
        path = dst / rel
        lines = path.read_text(encoding="utf-8").split("\n")
        at = [i for i, ln in enumerate(lines) if anchor in ln][nth]
        indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
        at += more[0] if more else 0
        planted = [indent + ln for ln in text.split("\n")]
        lines[at + 1:at + 1] = planted
        path.write_text("\n".join(lines), encoding="utf-8")
        relpath = f"src/repro_torch/{rel}"
        for other, (orel, oline) in where.items():
            if orel == relpath and oline > at + 1:
                where[other] = (orel, oline + len(planted))
        where[name] = (relpath, at + 2)
    for relpath in {r for r, _ in where.values()}:
        ast.parse((root / relpath).read_text(encoding="utf-8"))
    return run_paths([str(dst)], root=str(root)), where


@pytest.mark.parametrize("case", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_mutation_is_reported_at_its_line(mutated, case):
    findings, where = mutated
    name, rule = case[0], case[5]
    relpath, line = where[name]
    hits = [f for f in findings if (f.path, f.line) == (relpath, line)]
    assert [f.rule for f in hits] == [rule], (
        f"{name}: want {rule} at {relpath}:{line}, got\n"
        + "\n".join(f.format_text() for f in findings))


def test_mutations_report_nothing_else(mutated):
    findings, where = mutated
    planted = set(where.values())
    baseline = load_baseline(REPO_ROOT / "opslint_torch_baseline.json")
    extra = [f for f in findings if (f.path, f.line) not in planted]
    # the copy's unplanted lines move, so compare by rule and file only
    assert sorted((f.rule, f.path) for f in extra) == \
        sorted((f.rule, f.path) for f in baseline)


# ---------------------------------------------------------------------------
# pins
# ---------------------------------------------------------------------------

def test_shipped_baseline_matches_fresh_run(port_project):
    findings = run_project(port_project)
    baseline = load_baseline(REPO_ROOT / "opslint_torch_baseline.json")
    new, fixed = diff_against_baseline(findings, baseline)
    assert new == [], (
        "opslint found NEW findings vs the checked-in baseline — fix them "
        "or (for documented false positives) suppress inline:\n"
        + "\n".join(f.format_text() for f in new))
    assert fixed == [], (
        "baseline entries no longer reproduce — refresh "
        "opslint_torch_baseline.json with --write-baseline")


def test_guarded_by_ground_truth_is_present():
    """The port carries the reference's guarded-by annotations on the
    four lock-holding subsystems (ground truth for LCK002)."""
    expectations = {
        "core/workspace.py": "bytes_in_use",
        "engine/cache.py": "_entries",
        "engine/telemetry.py": "_metrics",
        "serve/spgemm_service.py": "_http",
    }
    for rel, field in expectations.items():
        text = (PORT / rel).read_text(encoding="utf-8")
        guarded = [ln for ln in text.splitlines()
                   if "guarded-by:" in ln and field in ln]
        assert guarded, f"{rel}: expected a guarded-by annotation on {field}"
    total = sum(p.read_text(encoding="utf-8").count("# guarded-by:")
                for p in PORT.rglob("*.py")
                if "analysis_static" not in p.parts)
    assert total >= 18


def test_steady_seeds_and_donors_are_marked(port_graph):
    graph = port_graph
    seeds = sorted(f"{fn.sf.modname}:{fn.qualname}" for fn in graph.seeds)
    assert seeds == [
        "repro_torch.engine.executor:_build_fused_hash_executable.body",
        "repro_torch.engine.executor:_build_hash_executable.body",
        "repro_torch.engine.executor:_build_hot_executable.body",
        "repro_torch.engine.executor:_build_merge_executable.run",
        "repro_torch.models.model:Model.decode_step",
    ]
    donors = sorted((fn.qualname, m.donate_names, m.donate_if)
                    for fn, m in graph.donor_defs.items())
    assert donors == [
        ("Model.decode_step", ("caches",), "donate"),
        ("bin_rows_into", ("buf",), None),
        ("exclusive_sum_in_place", ("buf",), None),
    ]
    # the kernel wrappers of both paths are reached from the seeds
    steady = {fn.qualname for fn in graph.traced}
    assert {"fused_bin_call", "symbolic_bin_call", "numeric_bin_call",
            "scatter_kept", "count_into", "segment_sum", "attention",
            "moe", "Model._block", "Model._forward.step"} <= steady


def test_plain_versions_are_called_only_for_cpu_tensors(port_graph):
    """The call graph does not follow a branch taken only for CPU tensors;
    this pins that the port calls its plain versions (``kernels/ref.py``,
    ``*_plain``, ``*_ref``) only from such branches (or from one another),
    so a CUDA tensor never reaches them."""
    graph = port_graph

    def is_plain(fn):
        return fn.name.endswith(("_plain", "_ref")) \
            or fn.sf.modname == "repro_torch.kernels.ref"

    sites = 0
    for mi in graph.modules.values():
        for fn, _scope in mi.functions:
            if is_plain(fn):
                continue
            cpu_only = plain_nodes(fn.node)
            scope = getattr(fn, "inner_scope", mi.scope)
            for node in walk_function(fn.node, set()):
                if not isinstance(node, ast.Call):
                    continue
                callee = resolve_call(node, scope, mi, graph, fn.cls)
                if callee is not None and is_plain(callee):
                    sites += 1
                    assert id(node) in cpu_only, (
                        f"{fn.sf.relpath}:{node.lineno}: {callee.name} "
                        "called outside a CPU-tensor branch")
    assert sites >= 8


def test_linter_imports_no_torch_jax_or_repro():
    allowed = set(sys.stdlib_module_names)
    for path in sorted((PORT / "analysis_static").glob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, f"{path.name}: {name}"
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    probe = ("import sys; from repro_torch.analysis_static.__main__ import "
             "main; assert main(['--list-rules']) == 0; "
             "print(sorted({'torch', 'jax', 'numpy', 'repro'} "
             "& set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.splitlines()[-1] == "[]"
