"""The port's Fig. 5/6 benchmark (``benchmarks/torch/``) on the CPU at a
tiny scale: the Table-3 analogs are the same in every process and equal to
``random_csr`` with the same int seed, the scale cut halves the rows until
A·A fits the product limit, ``run()`` gives well-formed rows whose C
agrees with scipy's, the C check catches a wrong value, and
``benchmarks/torch`` (a namespace package) never shadows the real
``torch``.
"""
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.torch import bench_overall as bo
from benchmarks.torch import matrices as mx
from repro_torch.core import SpgemmConfig, random_csr, spgemm
from repro_torch.core.analysis import total_nprod

ROOT = Path(__file__).resolve().parent.parent
SMALL = [mx.BY_NAME["m133-b3"], mx.BY_NAME["scircuit"]]
SCALE = 512


def _arrays(A):
    return tuple(np.asarray(x) for x in A.to_numpy())


def test_table3_is_the_reference_table():
    from benchmarks.matrices import TABLE3 as REF
    assert [(m.name, m.rows, m.avg_nnz, m.max_nnz, m.dist, m.large,
             m.paper_cr) for m in mx.TABLE3] == [
        (m.name, m.rows, m.avg_nnz, m.max_nnz, m.dist, m.large, m.paper_cr)
        for m in REF]
    assert sum(m.large for m in mx.TABLE3) == 7 and len(mx.TABLE3) == 26


def test_generate_is_random_csr_with_the_crc32_seed():
    spec = mx.BY_NAME["scircuit"]
    A = mx.generate(spec, scale=SCALE, seed=3, device="cpu")
    n = spec.rows // SCALE
    B = random_csr(zlib.crc32(b"scircuit") + 3, n, n,
                   avg_nnz_per_row=spec.avg_nnz,
                   max_nnz_per_row=spec.max_nnz, distribution=spec.dist,
                   device="cpu")
    assert A.shape == B.shape == (n, n)
    for a, b in zip(_arrays(A), _arrays(B)):
        np.testing.assert_array_equal(a, b)


def test_generate_is_the_same_in_another_process():
    spec = mx.BY_NAME["patents_main"]
    with mx.pool(1) as ex:
        rpt, col, val, shape = ex.submit(mx.host_arrays, spec, SCALE,
                                         1).result(timeout=120)
    A = mx.generate(spec, scale=SCALE, seed=1, device="cpu")
    assert shape == A.shape
    for a, b in zip((rpt, col, val), _arrays(A)):
        np.testing.assert_array_equal(a, b)


def test_default_scale_is_full_rows_on_the_card_only():
    spec = mx.BY_NAME["cage15"]
    assert mx.default_scale(spec, "cpu") == mx.LARGE_SCALE
    assert mx.default_scale(mx.BY_NAME["cant"], "cpu") == mx.DEFAULT_SCALE
    if torch.cuda.is_available():
        assert mx.default_scale(spec, "cuda") == 1


def test_fit_scale_halves_rows_until_under_the_limit():
    spec = mx.BY_NAME["cant"]
    s0 = 16
    full = mx.generate(spec, scale=s0, device="cpu")
    npd_full = int(total_nprod(full, full))
    s, npd, (rpt, col, val, shape) = bo.fit_scale(spec, s0, npd_full // 3)
    assert s in (4 * s0, 8 * s0) and npd <= npd_full // 3
    A = mx.generate(spec, scale=s, device="cpu")
    assert npd == int(total_nprod(A, A)) and shape == A.shape
    # Under the limit already: no cut.
    assert bo.fit_scale(spec, s0, npd_full)[:2] == (s0, npd_full)
    assert bo.fit_scale(spec, s0, None)[:2] == (s0, npd_full)


def test_run_rows_are_well_formed_and_c_matches():
    rows = bo.run(SMALL, methods=("esc", "hash"), scale=SCALE,
                  device="cpu", reps=1, log=lambda s: None)
    assert [(r["matrix"], r["method"]) for r in rows] == [
        (spec.name, m) for spec in SMALL for m in ("esc", "hash")]
    for r in rows:
        spec = mx.BY_NAME[r["matrix"]]
        A = mx.generate(spec, scale=SCALE, device="cpu")
        assert (r["scale"], r["rows"], r["nnz"]) == (SCALE, A.nrows,
                                                     int(A.nnz()))
        assert r["n_prod"] == int(total_nprod(A, A))
        assert r["reference"] == "torch.sparse"
        assert r["cr"] == pytest.approx(r["n_prod"] / r["c_nnz"])
        for name in ("opsparse", "opsparse-fused", "torch.sparse"):
            e = r[name]
            assert e["ms"] > 0 and e["gflops"] == pytest.approx(
                2 * r["n_prod"] / (e["ms"] * 1e-3) / 1e9)
            assert e["peak_gib"] is None        # no device memory on CPU
        for name in ("opsparse", "opsparse-fused"):
            assert r[name]["match"] is True
            assert r[name]["speedup_vs_sparse"] == pytest.approx(
                r["torch.sparse"]["ms"] / r[name]["ms"])
        assert bo._line(r).startswith(f"bench_overall/{r['matrix']}[")
    table = bo.markdown(rows).splitlines()
    assert len(table) == 2 + len(SMALL)       # one line a matrix
    assert all(line.count("|") == table[0].count("|") for line in table)
    assert all(line.endswith("yes/yes vs torch.sparse |")
               for line in table[2:])


@pytest.mark.parametrize("method", ["esc", "hash"])
def test_c_equals_scipy(method):
    for spec in SMALL:
        A = mx.generate(spec, scale=SCALE, device="cpu")
        ref = bo.scipy_reference(A)
        C = spgemm(A, A, SpgemmConfig(method=method)).C
        assert bo.check_c(C, ref)["match"] is True
        # The library's C is the same reference.
        T = bo.library_tensor(A)
        Tabs = bo.library_tensor(A, A.val[:int(A.rpt[-1])].abs())
        C_lib = T @ T
        lib = bo._host_reference(C_lib.crow_indices(), C_lib.col_indices(),
                                 A.ncols, C_lib.values(),
                                 (Tabs @ Tabs).values())
        np.testing.assert_array_equal(lib["rpt"], ref["rpt"])
        np.testing.assert_array_equal(lib["col"], ref["col"])
        np.testing.assert_allclose(lib["val"], ref["val"], rtol=1e-4,
                                   atol=1e-6)


def test_check_c_catches_a_wrong_value_and_pattern():
    A = mx.generate(SMALL[1], scale=SCALE, device="cpu")
    ref = bo.scipy_reference(A)
    C = spgemm(A, A, SpgemmConfig(method="esc")).C
    i = int(np.argmax(ref["absval"]))
    bad = C.val.clone()
    bad[i] += 1e-3 * float(ref["absval"][i]) + 1e-5
    got = bo.check_c(type(C)(rpt=C.rpt, col=C.col, val=bad, shape=C.shape),
                     ref)
    assert got["match"] is False and got["why"] == "values out of tolerance"
    col = C.col.clone()
    col[0] += 1
    got = bo.check_c(type(C)(rpt=C.rpt, col=col, val=C.val, shape=C.shape),
                     ref)
    assert got["match"] is False and got["why"] == "col differs"


def test_unsorted_library_columns_are_sorted_per_row():
    crow = torch.tensor([0, 3, 3, 5])
    col = torch.tensor([4, 0, 2, 1, 0])
    val = torch.arange(5.0)
    got_col, got_val = bo._sorted_rows(crow, col, 5, val)
    assert got_col.tolist() == [0, 2, 4, 0, 1]
    assert got_val.tolist() == [1.0, 2.0, 0.0, 4.0, 3.0]


def test_benchmarks_on_sys_path_still_imports_the_real_torch():
    code = ("import sys; sys.path.insert(0, 'benchmarks'); import torch; "
            "assert hasattr(torch, 'Tensor'), torch.__path__; "
            "print(torch.__file__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "benchmarks" not in out.stdout
    assert not (ROOT / "benchmarks" / "torch" / "__init__.py").exists()
