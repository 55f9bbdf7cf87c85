"""Fig. 9 on the port against the reference's bench (CPU).

``bench_hashing`` runs the reference's three cases on its own matrices
(``PRNGKey(1)`` / ``PRNGKey(2)``) through the plain versions, which count
table accesses as the reference's Pallas kernels do: every access count
and ratio in its rows equals the reference bench's (run here in interpret
mode).  Timings are not compared: both benches' ``timeit`` is replaced by
a stub, which also keeps the reference's interpret-mode reps out of the
run.
"""
import re

import torch

from benchmarks import bench_hashing as ref_hashing
from benchmarks.torch import bench_hashing

# A row without its timings (the second field and the time speed-up).
_TIMES = re.compile(r"(^[^,]*,)[^,]*,|sym_time_speedup=[^;]*")


def _untimed(row: str) -> str:
    return _TIMES.sub(lambda m: m.group(1) or "", row)


def test_bench_hashing_rows_are_the_reference_rows(monkeypatch):
    """Fig. 9: the three cases' access counts, single and check-then-CAS,
    symbolic, numeric and fused, and their ratios, as the reference's."""
    for mod in (ref_hashing, bench_hashing):
        monkeypatch.setattr(mod, "timeit", lambda *a, **k: 1.0)
    want = ref_hashing.run()
    got = bench_hashing.run("cpu")
    assert [_untimed(r) for r in got] == [_untimed(r) for r in want]
    for row in got:
        n = dict(kv.split("=") for kv in row.split(",", 2)[2].split(";"))
        assert int(n["sym_accesses_single"]) < int(n["sym_accesses_multi"])
        assert int(n["fused_accesses_single"]) < (
            int(n["sym_accesses_single"]) + int(n["num_accesses_single"]))


def test_row_accesses_hold_the_figure_invariants():
    """Per row: at least one access a product on every row of a launched
    bin, and single access never above check-then-CAS in total."""
    A, B = bench_hashing.case_matrices(96, 256, 6.0, "powerlaw", "cpu")
    for kind in ("symbolic_bin", "numeric_bin", "fused_bin"):
        single, nprod, built = bench_hashing.row_accesses(A, B, kind, True)
        multi, _, built_multi = bench_hashing.row_accesses(A, B, kind,
                                                           False)
        assert torch.equal(built, built_multi)
        assert bool(built.any())
        assert bool((single[built] >= nprod[built]).all())
        assert bool((multi[built] >= nprod[built]).all())
        assert int(single.sum()) < int(multi.sum())
