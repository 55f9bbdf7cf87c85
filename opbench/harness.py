"""One run of one cell: the benchmark's description, the traffic's
driver, the check and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration and traffic mix, whose
files sit under ``opbench/configs/<config>.json`` and
``opbench/traffic/<traffic>.json``.  The traffic file names its driver,
``opbench/drivers/<driver>.py``, whose ``Driver`` makes each product, and
gives the driver's parameters:

  driver         the module under ``opbench/drivers/``;
  warmup         products made before the window, in set-up;
  sample_first   the product of the window whose output is checked
                 beside the window's last is drawn from the seed among
                 the window's first ``sample_first``.

Each per-layer metric is read by ``opbench/metrics/<metric>.py``, whose
``read(ctx)`` returns the value (or None where it finds nothing to
read).

``ClosedLoop``, the drivers' base, is one caller in a closed loop: each
product is called once the last one's C is ready
(``torch.cuda.synchronize()``), and its time runs from the call to that
point.  Before each product, outside its time, A's values are set to the
seed's values times a power of two drawn from the seed and the product's
index, never the previous product's factor, as a caller who recomputes a
product of fixed pattern hands it new values; the check divides the
output by the factor's square, which is exact.  A driver may replace the
loop (``window``) where its traffic is no closed loop.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from . import counts, reference
from .operands import DTYPES, Operand, make_operand

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_CHUNK_S = 1.0
FACTOR_EXPONENTS = 5                      # factors 2^-2 .. 2^2


# ---------------------------------------------------------------------------
# The description, found by name.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    root: Path

    def metrics(self, kind: str) -> List[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "opbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    return Cell(name, bench, wl, config, traffic, root)


def load_module(root: Path, folder: str, name: str):
    """The module ``opbench/<folder>/<name>.py`` of the checkout ``root``."""
    path = root / "opbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"opbench_{folder}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: Path, metric: str) -> Callable:
    """``read`` of ``opbench/metrics/<metric>.py``."""
    return load_module(root, "metrics", metric).read


# ---------------------------------------------------------------------------
# The traffic's driver.
# ---------------------------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _draw(tag: str, seed: int) -> int:
    digest = hashlib.sha256(f"{tag}:{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def sample_index(seed: int, first: int) -> int:
    return _draw("sample", seed) % max(first, 1)


def value_factor(seed: int, i: int) -> float:
    """The power of two A's values are scaled by for product ``i``: a
    cycle through 2^-2 .. 2^2 from a start drawn from the seed, so two
    products in a row never share a factor."""
    return 2.0 ** ((_draw("factor", seed) + i) % FACTOR_EXPONENTS - 2)


@dataclasses.dataclass
class Window:
    latencies_s: List[float]
    window_s: float
    failed: int
    kept: Dict[str, Tuple[object, float]]  # label -> (SpgemmResult, factor)
    counters: Optional[Dict[str, int]]     # engine counters over the window
    spans: List[dict]                      # fresh engines' spans (traced)


class ClosedLoop:
    """The program side of a cell: A as the program's CSR, its config,
    and products in a closed loop.  A driver defines ``product()``, and
    ``counters()`` where it reads the engine's."""

    def __init__(self, cell: Cell, op: Operand, device: torch.device, *,
                 seed: int, telemetry: bool = False,
                 value_dtype: Optional[torch.dtype] = None):
        from repro_torch import CSR, SpgemmConfig
        self.val0 = op.val if value_dtype is None else op.val.to(value_dtype)
        self.A = CSR(rpt=op.rpt, col=op.col, val=self.val0.clone(),
                     shape=(op.n, op.n))
        self.config = SpgemmConfig(**cell.config["spgemm"])
        self.traffic = cell.traffic
        self.device = device
        self.seed = seed
        self.telemetry = telemetry
        self.spans: List[dict] = []
        self.calls = 0

    def product(self):
        raise NotImplementedError

    def counters(self) -> Optional[Dict[str, int]]:
        return None

    def call(self):
        """New values for A, then one product, ended by a synchronize;
        returns ``(result, factor, seconds)``."""
        factor = value_factor(self.seed, self.calls)
        self.calls += 1
        torch.mul(self.val0, factor, out=self.A.val)
        sync(self.device)
        t0 = time.perf_counter()
        with record_function("opbench.product"):
            res = self.product()
            sync(self.device)
        return res, factor, time.perf_counter() - t0

    def warmup(self) -> List[float]:
        """The traffic's warm-up products; their times in ms."""
        return [self.call()[2] * 1e3
                for _ in range(int(self.traffic["warmup"]))]

    def window(self, seconds: float, sample: int,
               step: Callable[[], None] = lambda: None) -> Window:
        """Products in a closed loop until ``seconds`` have passed; keeps
        the output of product ``sample`` and of the last.  ``step()``
        runs after each product, outside its time (the profiler's
        cycle)."""
        before = self.counters()
        self.spans.clear()
        lat, kept, failed = [], {}, 0
        sync(self.device)
        t_start = time.perf_counter()
        out, i = None, 0
        while True:
            t0 = time.perf_counter()
            try:
                res, factor, dt = self.call()
                out = (res, factor)
            except Exception as exc:        # a failed product, counted
                print(f"opbench: product {i} failed: {exc!r}",
                      file=sys.stderr)
                failed += 1
                out, dt = None, time.perf_counter() - t0
            lat.append(dt)
            t1 = time.perf_counter()
            step()
            if i == sample and out is not None:
                kept["sampled"] = out
            i += 1
            if t1 - t_start >= seconds:
                break
            out = None
        if out is not None:
            kept["last"] = out
        after = self.counters()
        delta = (None if before is None
                 else {k: after[k] - before[k] for k in after})
        return Window(lat, t1 - t_start, failed, kept, delta,
                      list(self.spans))

    def release(self) -> None:
        """Drop the program's state (plans, pipelines, workspaces)."""
        from repro_torch.core.workspace import reset_default_arena
        from repro_torch.engine.executor import reset_default_engine
        reset_default_engine()
        reset_default_arena()
        self.A = self.val0 = None


def make_driver(cell: Cell, op: Operand, device: torch.device, **kw):
    """The driver that the cell's traffic file names."""
    module = load_module(cell.root, "drivers", cell.traffic["driver"])
    return module.Driver(cell, op, device, **kw)


# ---------------------------------------------------------------------------
# A run.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: Cell
    window: Window
    trace: Optional[object]                # trace.TraceSummary
    products: int
    work: Dict[str, counts.Work]           # "product", "table_rows"
    peaks: Optional[dict]
    dtype: str
    power: str                             # the card and its power limit
    extra: Dict[str, dict]                 # keys a reader adds to its metric
    values: Dict[str, float]               # the window's end-to-end values
    metric: str = ""                       # the metric being read


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the harness may not
    load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float,
             control: Optional[str] = None) -> dict:
    """One run of ``cell``; returns the result line's object.

    ``control`` names a value type (``"bfloat16"``) that the program is
    handed A's values in, its own 16-bit path: the check's control, run
    by ``opbench.limits`` and the tests, never by a benchmark run.  A
    traced run records cycles of products of about a 32nd of the window
    and at most ``TRACE_CHUNK_S`` (the last warm-up product's time sets
    how many products that is)."""
    from . import trace as trace_mod
    t_in = time.perf_counter()
    op = make_operand(cell.config, seed, device)
    nprod_rows = reference.row_products(op.rpt, op.col)
    nprod = int(nprod_rows.sum())
    driver = make_driver(cell, op, device, seed=seed, telemetry=trace,
                         value_dtype=(None if control is None
                                      else DTYPES[control]))
    t_warm = time.perf_counter()
    warm_ms = driver.warmup()
    driver.spans.clear()
    warm_counters = driver.counters()
    gc.collect()
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sample = sample_index(seed, int(cell.traffic["sample_first"]))
    setup_s = time.perf_counter() - t_process

    summary = None
    if trace:
        chunk_ms = min(TRACE_CHUNK_S, seconds / 32) * 1e3
        active = max(1, round(chunk_ms / warm_ms[-1]))
        win, summary = trace_mod.trace_window(
            lambda step: driver.window(seconds, sample, step),
            active=active)
    else:
        win = driver.window(seconds, sample)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # The check, once the program's state is freed but what it returned;
    # each output divided by its factor's square (a power of two: exact).
    outputs = [(r.C.rpt, r.C.col, r.C.val.float() / (f * f), r.total_nnz)
               for r, f in win.kept.values()]
    nprod_seen = [int(r.total_nprod) for r, _ in win.kept.values()]
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c_sizes = torch.zeros_like(nprod_rows)

    def on_block(ref):
        c_sizes[ref.r0:ref.r1] = ref.sizes

    checks = reference.compare(op.rpt, op.col, op.val, outputs, on_block)
    limits = cell.config["limits"]
    worst = reference.Check()
    for c in checks:
        worst = worst.merge(c)
    bad_nprod = sum(1 for x in nprod_seen if x != nprod)
    compared = {
        "outputs_checked": {"value": len(outputs), "limit": 2},
        "pattern_mismatch": {"value": worst.pattern_mismatch,
                             "limit": limits["pattern_mismatch"]},
        "nprod_mismatch": {"value": bad_nprod, "limit": 0},
        "val_err": {"value": worst.val_err, "limit": limits["val_err"]},
    }
    correct = (len(outputs) == 2
               and worst.pattern_mismatch <= limits["pattern_mismatch"]
               and bad_nprod == 0 and worst.val_err <= limits["val_err"]
               and win.failed == 0)

    value_bytes = op.val.element_size()
    c_nnz = int(c_sizes.sum())
    work = {"product": counts.product_work(op.n, op.nnz, c_nnz, nprod,
                                           value_bytes)}
    products = len(win.latencies_s)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    card = power_limit() if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    metrics = {}
    result = {"correct": bool(correct), "attempted": products,
              "failed": win.failed, "metrics": metrics,
              "device": device_info}
    values = {
        "gflops": 2.0 * nprod * (products - win.failed) / win.window_s / 1e9,
        "product_ms_p90": percentile(win.latencies_s, 90) * 1e3,
        "peak_gib": window_peak / 2 ** 30,
        "setup_s": setup_s,
    }
    if trace:
        work["table_rows"] = counts.table_rows_work(
            op.rpt, op.col, nprod_rows, c_sizes,
            int(cell.config["table_rows_max_nprod"]), value_bytes)
    ctx = Context(cell, win, summary, products, work,
                  counts.peaks_of(name) if cuda else None,
                  cell.config["dtype"], card, {}, values)
    # An end-to-end metric is one of the window's values or, where it has
    # a reader of its own, what that reads; a per-layer metric, its reader.
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        ctx.metric = m["name"]
        if not trace and m["name"] in values:
            value = values[m["name"]]
        else:
            value = load_reader(cell.root, m["name"])(ctx)
        if value is None:
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"],
                              **ctx.extra.get(m["name"], {})}
        if m["unit"] == "%" and "roofline" in m["name"] and value > 100:
            print(f"opbench: {m['name']} reads {value} % (above 100 %): "
                  f"its bytes or operations are counted too high, or "
                  f"the time leaves out part of the work", file=sys.stderr)
    if not trace:
        result["window"] = {
            "products": products, "seconds": win.window_s,
            "product_ms_median": statistics.median(win.latencies_s) * 1e3,
            "product_ms_quartiles": [
                q * 1e3 for q in statistics.quantiles(win.latencies_s, n=4)]
            if products >= 2 else None}
    elif summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
        result["trace"] = {"products": summary.products,
                           "unlinked_device_ops": summary.unlinked_ops}
    result["setup"] = {"start_s": t_in - t_process,
                       "operand_s": t_warm - t_in, "warmup_ms": warm_ms,
                       "warmup_counters": warm_counters}
    result["matrix"] = {"rows": op.n, "nnz": op.nnz, "nprod": nprod,
                        "c_nnz": c_nnz,
                        "compression": nprod / max(c_nnz, 1)}
    result["card"] = card
    result["checks"] = compared
    return result
