"""The yardstick on the CPU: Table 3 against the port's benches, the
generator against its Table-3 rows, the reference against a dense
product, the counts against hand counts, the operand from the seed."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opbench import counts, reference
from opbench.matrices import (BY_NAME, TABLE3, row_sizes,
                              table3_structure)
from opbench import operands
from opbench.operands import STRUCTURE_KEYS, base_structure, make_operand

ROOT = Path(__file__).resolve().parents[2]


def test_table3_equals_the_ports_benches():
    import dataclasses
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks.torch.matrices import TABLE3 as ports
    assert [dataclasses.astuple(m) for m in TABLE3] == [
        dataclasses.astuple(m) for m in ports]


def config_of(name):
    return json.loads((ROOT / "opbench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["mono_500Hz", "cant"])
def test_config_states_its_table3_row(name):
    config = config_of(name)
    spec = BY_NAME[name]
    assert (config["matrix"], config["rows"], config["avg_nnz_per_row"],
            config["max_nnz_per_row"], config["distribution"],
            config["paper_compression"]) == (
        spec.name, spec.rows, spec.avg_nnz, spec.max_nnz, spec.dist,
        spec.paper_cr)
    assert config["name"] == name and config["dtype"] == "float32"
    assert config["spgemm"] == {"method": "hash"}


@pytest.mark.parametrize("name", ["mono_500Hz", "cant"])
def test_row_sizes_hit_the_table3_row_at_full_size(name):
    spec = BY_NAME[name]
    rng = np.random.default_rng(5)
    sizes = row_sizes(rng, spec.dist, spec.rows, spec.avg_nnz, spec.max_nnz)
    assert sizes.shape == (spec.rows,)
    assert int(sizes.sum()) == round(spec.rows * spec.avg_nnz)
    assert sizes.min() >= 1 and sizes.max() == spec.max_nnz


@pytest.mark.parametrize("name,rows,tolerance", [("cant", 8000, 0.05),
                                                  ("mono_500Hz", 20000, 0.05)])
def test_structure_keeps_to_its_window_and_compression(name, rows,
                                                       tolerance):
    """At a part of the rows (the window is local, so the compression
    hardly moves with the row count): sorted distinct columns inside
    each row's window, the entries exact, and A·A's compression near the
    paper's (the card reads it at full size in every run)."""
    import scipy.sparse as sp
    config = config_of(name)
    args = dict((k, config[k]) for k in STRUCTURE_KEYS)
    args["rows"] = rows
    rpt, col = table3_structure(*args.values())
    sizes = np.diff(rpt).astype(np.int64)
    assert rpt[-1] == round(rows * config["avg_nnz_per_row"])
    rows_of = np.repeat(np.arange(rows), sizes)
    assert np.all(np.diff(col.astype(np.int64) + rows_of * rows) > 0)
    width = np.minimum(rows, np.maximum(
        sizes, np.ceil(config["window"] * sizes).astype(np.int64)))
    lo = np.clip(np.arange(rows) - width // 2, 0, rows - width)
    assert np.all(col >= lo[rows_of]) and np.all(col < (lo + width)[rows_of])
    a = sp.csr_matrix((np.ones(len(col)), col, rpt), shape=(rows, rows))
    nprod = int(sizes[col].sum())
    cr = nprod / (a @ a).nnz
    assert abs(cr / config["paper_compression"] - 1) < tolerance


def csr_of_dense(d):
    rows, cols = np.nonzero(d)
    rpt = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                     minlength=d.shape[0]))])
    return (torch.tensor(rpt, dtype=torch.int32),
            torch.tensor(cols, dtype=torch.int32),
            torch.tensor(d[rows, cols], dtype=torch.float32))


def random_dense(n, density, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n)).astype(np.float32)
    d[rng.random((n, n)) > density] = 0
    d[n // 3] = 0                                   # an empty row
    return d


@pytest.mark.parametrize("n,density,block",
                         [(40, 0.1, 1 << 25), (64, 0.3, 97), (17, 0.6, 1)])
def test_reference_equals_dense(n, density, block, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_PRODUCTS", block)
    d = random_dense(n, density, n)
    rpt, col, val = csr_of_dense(d)
    want = d.astype(np.float64) @ d.astype(np.float64)
    pattern = (np.abs(d) > 0).astype(np.int64) @ (np.abs(d) > 0)
    got = np.zeros_like(want)
    sizes = []
    for ref in reference.reference_blocks(rpt, col, val):
        rows = np.repeat(np.arange(ref.r0, ref.r1), ref.sizes.numpy())
        got[rows, ref.col.numpy()] = ref.val.numpy()
        sizes.append(ref.sizes.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.concatenate(sizes),
                                  (pattern > 0).sum(1))
    np.testing.assert_array_equal(
        reference.row_products(rpt, col).numpy(), pattern.sum(1))


def test_compare_finds_each_fault():
    d = random_dense(48, 0.15, 1)
    rpt, col, val = csr_of_dense(d)
    c = d.astype(np.float64) @ d.astype(np.float64)
    c[np.abs(((np.abs(d) > 0) * 1) @ ((np.abs(d) > 0) * 1)) == 0] = 0
    c_rpt, c_col, c_val = csr_of_dense(c.astype(np.float32))
    nnz = int(c_rpt[-1])
    ok = reference.compare(rpt, col, val, [(c_rpt, c_col, c_val, nnz)])[0]
    assert ok.pattern_mismatch == 0 and ok.val_err < 1e-6
    v2 = c_val.clone()
    v2[5] += 1.0
    col2 = c_col.clone()
    col2[3] = (col2[3] + 1) % 48
    half = c_rpt.clone()
    half[24:] = half[24]
    checks = reference.compare(rpt, col, val, [
        (c_rpt, c_col, v2, nnz), (c_rpt, col2, c_val, nnz),
        (half, c_col, c_val, int(half[-1]))])
    assert checks[0].pattern_mismatch == 0 and checks[0].val_err > 1e-3
    assert checks[1].pattern_mismatch >= 1
    assert checks[2].pattern_mismatch >= 24


def test_counts_equal_hand_counts():
    # A = [[1 2 . .], [. 3 . .], [. . . .], [4 . 5 6]]; B = A.
    d = np.array([[1, 2, 0, 0], [0, 3, 0, 0], [0, 0, 0, 0], [4, 0, 5, 6]],
                 np.float32)
    rpt, col, val = csr_of_dense(d)
    nprod = reference.row_products(rpt, col)
    # Row 0: A row sizes of columns 0, 1 -> 2 + 1; row 1: 1; row 3: 2+0+3.
    assert nprod.tolist() == [3, 1, 0, 5]
    # C = A·A: row 0 -> cols {0, 1}; row 1 -> {1}; row 3 -> {0, 1, 2, 3}.
    c_sizes = torch.tensor([2, 1, 0, 4])
    w = counts.product_work(4, 6, 7, 9, 4)
    assert (w.bytes, w.flops) == (2 * (20 + 48) + (20 + 56), 18)
    # Table rows: products 1..3 -> rows 0 and 1.  Read: 2 row pointer
    # pairs, 3 A entries, the distinct B rows 0 and 1 (pointers, 3 entries);
    # written: 3 C entries and 2 sizes.
    t = counts.table_rows_work(rpt, col, nprod, c_sizes, 3, 4)
    assert t.bytes == 16 + 24 + 16 + 24 + 24 + 8
    assert t.flops == 8
    peaks = counts.PEAKS["H100"]
    assert t.least_s(peaks, "float32") == (t.bytes / 3.35e12, "bytes")
    assert counts.Work(8, 10 ** 9).least_s(peaks, "float32")[1] == "flops"


def test_structure_is_drawn_once_per_checkout(tmp_path, monkeypatch):
    monkeypatch.setattr(operands, "CACHE_DIR", tmp_path)
    config = dict(config_of("mono_500Hz"), rows=150)
    rpt, col = base_structure(config)
    files = list(tmp_path.glob("mono_500Hz-150-*.npz"))
    assert len(files) == 1
    assert base_structure(dict(config, window=3.0)) is not None
    assert len(list(tmp_path.glob("mono_500Hz-150-*.npz"))) == 2
    again = base_structure(config)
    want = table3_structure(*[config[k] for k in STRUCTURE_KEYS])
    for got in ((rpt, col), again):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_operand_same_structure_values_from_the_seed():
    config = dict(config_of("cant"), rows=200)
    a = make_operand(config, 2 ** 31 + 5, torch.device("cpu"))
    b = make_operand(config, 2 ** 31 + 5, torch.device("cpu"))
    c = make_operand(config, 11, torch.device("cpu"))
    assert torch.equal(a.rpt, b.rpt) and torch.equal(a.col, b.col)
    assert torch.equal(a.val, b.val)
    assert torch.equal(a.rpt, c.rpt) and torch.equal(a.col, c.col)
    assert not torch.equal(a.val, c.val)
