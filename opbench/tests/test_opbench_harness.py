"""The harness on the CPU at a tiny size: files found by name, the last
line's schema, what the run may load, and ``correct`` coming out false
for the control and for each fault a cell can have."""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from opbench import harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TINY = {"name": "tiny", "matrix": "tiny", "rows": 96, "avg_nnz_per_row": 3.0,
        "max_nnz_per_row": 4, "distribution": "banded", "window": 8.0,
        "paper_compression": 1.0, "product": "A@A", "dtype": "float32",
        "spgemm": {"method": "hash"}, "table_rows_max_nprod": 20480}


def committed_limits():
    config = json.loads((ROOT / "opbench" / "configs" /
                         "mono_500Hz.json").read_text())
    return config["limits"]


def tiny_root(tmp_path, traffic="steady", extra_metric=False):
    """A checkout-like tree: the committed opbench files, a tiny
    configuration, and a cell ``tiny.<traffic>`` naming it."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "opbench", root / "opbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "opbench" / "configs" / "tiny.json").write_text(json.dumps(
        dict(TINY, limits=committed_limits())))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "opbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    cell = f"tiny.{traffic}"
    bench["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": traffic, "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if any(w.endswith("." + traffic) for w in m.get("workloads", [])):
            m["workloads"].append(cell)
    if extra_metric:
        (root / "opbench" / "metrics" / "tiny.products.py").write_text(
            "def read(ctx):\n    return float(ctx.products)\n")
        bench["per_layer"].append({
            "name": "tiny.products", "unit": "count", "better": "higher",
            "source": "host_clock", "layer": "entry", "moves": "gflops",
            "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cell


def run_tiny(root, cell, *, trace=False, seconds=0.5, seed=2 ** 31 + 9,
             warmup=2, control=None):
    c = harness.load_cell(cell, root)
    c.traffic = dict(c.traffic, warmup=warmup)
    return harness.run_cell(c, seed=seed, seconds=seconds, trace=trace,
                            device=CPU, t_process=time.perf_counter(),
                            control=control)


@pytest.mark.parametrize("traffic", ["steady", "oneshot"])
def test_files_dropped_in_are_found_by_name(tmp_path, traffic):
    root, cell = tiny_root(tmp_path, traffic, extra_metric=True)
    # A driver of its own, and a traffic mix naming it, as files only.
    drivers = root / "opbench" / "drivers"
    base = "fresh_engine" if traffic == "oneshot" else "shared_engine"
    (drivers / "counted.py").write_text(
        (drivers / f"{base}.py").read_text()
        + "\n\nclass Driver(Driver):\n"
          "    def product(self):\n"
          "        self.made = getattr(self, 'made', 0) + 1\n"
          "        return super().product()\n")
    (root / "opbench" / "traffic" / "burst.json").write_text(json.dumps(
        {"driver": "counted", "warmup": 1, "sample_first": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == cell:
            w["traffic"] = "burst"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(cell, root)
    assert c.config["matrix"] == "tiny" and c.traffic["sample_first"] == 2
    r = harness.run_cell(c, seed=5, seconds=0.3, trace=True, device=CPU,
                         t_process=time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["tiny.products"]["value"] == r["attempted"]
    assert r["matrix"]["nnz"] == 288 and r["matrix"]["compression"] >= 1


@pytest.mark.parametrize("traffic", ["steady", "oneshot"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(tmp_path, monkeypatch, trace, traffic):
    # Cycles of one product: a product traced on the CPU is far slower
    # than the warm-up's, by which the cycle's length is set.
    monkeypatch.setattr(harness, "TRACE_CHUNK_S", 1e-6)
    root, cell = tiny_root(tmp_path, traffic)
    r = run_tiny(root, cell, trace=trace, seconds=2.0 if trace else 0.5)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    c = harness.load_cell(cell, root)
    want = [m["name"] for m in c.metrics(
        "per_layer" if trace else "end_to_end")]
    assert set(r["metrics"]) <= set(want)
    if not trace:
        assert set(r["metrics"]) == set(want)
        cold = traffic == "oneshot"
        assert ("cold_gflops" in want) == cold
        assert ("gflops" in want) == (not cold)
    for m in r["metrics"].values():
        assert isinstance(m["value"], (int, float)) and m["unit"]
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    for name, check in r["checks"].items():
        assert set(check) == {"value", "limit"}, name
    json.dumps(r)


def _alter(monkeypatch, how):
    """Break the program's finalize: every product it returns is wrong
    in the way ``how`` says; "stale" returns the product before it."""
    from repro_torch.engine import executor
    original = executor.SpgemmEngine._finalize_record
    made = []

    def broken(self, rec):
        res = original(self, rec)
        made.append(res)
        C = res.C
        if how == "stale":                  # the state left unchanged
            return made[-2] if len(made) > 1 else res
        if how == "value":
            val = C.val.clone()
            val[int(C.rpt[-1]) // 2] += 1.0
            C = dataclasses.replace(C, val=val)
        elif how == "column":
            col = C.col.clone()
            i = int(C.rpt[-1]) // 2
            col[i] = (col[i] + 1) % C.ncols
            C = dataclasses.replace(C, col=col)
        elif how == "half_rows":
            rpt = C.rpt.clone()
            m = C.nrows // 2
            rpt[m:] = rpt[m]
            C = dataclasses.replace(C, rpt=rpt)
            res = dataclasses.replace(res, total_nnz=int(rpt[-1]))
        return dataclasses.replace(res, C=C)
    monkeypatch.setattr(executor.SpgemmEngine, "_finalize_record", broken)


@pytest.mark.parametrize("traffic", ["steady", "oneshot"])
@pytest.mark.parametrize("how", ["value", "column", "half_rows", "stale"])
def test_a_broken_product_is_not_correct(tmp_path, monkeypatch, traffic,
                                         how):
    root, cell = tiny_root(tmp_path, traffic)
    _alter(monkeypatch, how)
    r = run_tiny(root, cell)
    assert r["correct"] is False
    checks = r["checks"]
    if how in ("value", "stale"):
        assert checks["val_err"]["value"] > checks["val_err"]["limit"]
    else:
        assert checks["pattern_mismatch"]["value"] > 0


@pytest.mark.parametrize("traffic", ["steady", "oneshot"])
def test_control_is_not_correct(tmp_path, traffic):
    """The program's bfloat16 path against the float32 reference fails
    the committed limit; the float32 program on the same seed passes."""
    root, cell = tiny_root(tmp_path, traffic)
    ok = run_tiny(root, cell, seed=31)
    bad = run_tiny(root, cell, seed=31, control="bfloat16")
    assert ok["correct"] is True
    assert bad["correct"] is False
    assert bad["checks"]["pattern_mismatch"]["value"] == 0
    assert bad["checks"]["val_err"]["value"] > bad["checks"]["val_err"][
        "limit"]


def harness_sources():
    return [p for p in (ROOT / "opbench").rglob("*.py")
            if "tests" not in p.relative_to(ROOT / "opbench").parts]


def test_sources_import_neither_jax_nor_the_reference_package():
    for path in harness_sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in harness.FORBIDDEN + ("benchmarks",), (
                    f"{path}: imports {name}")


def test_a_run_loads_neither_jax_nor_the_reference_package(tmp_path):
    root, cell = tiny_root(tmp_path)
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import opbench.run, opbench.limits\n"
        "from opbench import harness\n"
        f"c = harness.load_cell({cell!r}, __import__('pathlib').Path("
        f"{str(root)!r}))\n"
        "c.traffic = dict(c.traffic, warmup=1)\n"
        "r = harness.run_cell(c, seed=1, seconds=0.2, trace=True, "
        "device=torch.device('cpu'), t_process=time.perf_counter(), "
        ")\n"
        "assert r['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "opbench.run", "--workload", "cant.steady",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_without_the_port_no_result(tmp_path, card):
    """In a directory holding only BENCHMARK.json and opbench/, a run on
    the card exits non-zero and prints no result."""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "opbench", bare / "opbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "opbench.run", "--workload", "cant.steady",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=bare, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", ["steady", "oneshot"])
def test_control_is_not_correct_on_the_card(tmp_path, card, traffic):
    """The control on the card, at 4,096 rows of the mono analog's
    shape: the program passes, its bfloat16 path does not."""
    root, cell = tiny_root(tmp_path, traffic)
    config = json.loads((ROOT / "opbench" / "configs" /
                         "mono_500Hz.json").read_text())
    (root / "opbench" / "configs" / "tiny.json").write_text(json.dumps(
        dict(config, rows=4096)))
    c = harness.load_cell(cell, root)
    for control, want in ((None, True), ("bfloat16", False)):
        r = harness.run_cell(c, seed=77, seconds=1.0, trace=False,
                             device=card, t_process=time.perf_counter(),
                             control=control)
        assert r["correct"] is want, r["checks"]
