"""The port's one tracing system, on the CPU: every ``with``-span of the
engine is a ``torch.profiler`` range (enabled telemetry or not), the
ranges of a hash product partition its device work, and every wait of the
host on the device is a span marked ``sync=True`` and counted in
``EngineStats.host_syncs``.

A product's device work falls into exactly one range of :data:`PARTITION`
(or a host read's ``sync:*`` / ``step_wait:*`` range); the engine's
phases (``plan_lookup``, ``cold_steps``, ``dispatch``, ``finalize``) and
the host-only ranges (``engine_init``, ``lease``, ``plan_specialize``)
wrap them from outside.
On the CPU a torch op stands for the device work it would launch on the
card, so the check is that no top-level op of a product runs outside the
partition, views aside.
"""
import json
import os
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import CSR, SpgemmConfig
from repro_torch.engine import SpgemmEngine, Telemetry, prometheus_text
from repro_torch.engine import telemetry as telemetry_mod
from repro_torch.engine.telemetry import NULL_SPAN, profiler_range
from repro_torch.kernels import spgemm_hash

PARTITION = ("hash_setup", "hash_binning", "hash_rungs", "hash_fallback",
             "hash_alloc", "hash_epilogue", "operand_pad", "verify_sync")
READS = ("sync:", "step_wait:")
ENGINE_PHASES = ("plan_lookup", "cold_steps", "dispatch", "finalize",
                 "engine_init", "lease", "plan_specialize")
# Ops that launch no device work: views of a tensor's storage.
VIEWS = ("aten::slice", "aten::view", "aten::select", "aten::as_strided",
         "aten::reshape", "aten::alias")
# A cold hash product's host waits: six step waits and six reads (the
# n_prod total, each phase's max(sizes) and bin sizes, the nnz total),
# and one more read of the fallback rung's products in each phase that
# has fallback rows.
COLD_SYNCS = 12


def _csr(rows, ncols, gen):
    rpt = torch.zeros(len(rows) + 1, dtype=torch.int32)
    rpt[1:] = torch.cumsum(torch.tensor([len(r) for r in rows]), 0)
    col = torch.cat(rows).to(torch.int32)
    return CSR(rpt=rpt, col=col, val=torch.randn(col.shape[0], generator=gen),
               shape=(len(rows), ncols))


def _operands(fallback: bool):
    """A (32 x 256) @ (256 x 8192) pair.  With ``fallback`` row 0 of A has
    210 entries: 21,000 products (past the symbolic ladder's 20,480) into
    ~7,600 columns (past the numeric ladder's 4,096), so it takes the
    fallback rung in both phases; every other row has 300 products."""
    gen = torch.Generator().manual_seed(31)
    m, k, n = 32, 256, 8192
    A = _csr([torch.randperm(k, generator=gen)[:(210 if i == 0 and fallback
                                                 else 3)].sort().values
              for i in range(m)], k, gen)
    B = _csr([torch.randperm(n, generator=gen)[:100].sort().values
              for _ in range(k)], n, gen)
    return A, B


def _config():
    return SpgemmConfig(method="hash")


def _complete_events(prof):
    """The profiler's trace as Chrome trace events, complete ones only."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


@pytest.fixture(scope="module")
def traced():
    """A cold product on a fresh engine and a steady one on a specialised
    plan, under the profiler (host only), each inside a range of its own;
    returns the trace's complete events."""
    A, B = _operands(fallback=True)
    engine = SpgemmEngine(_config())
    for _ in range(2):
        engine.execute(A, B)           # cold, then the pipeline's build
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.cold"):
            SpgemmEngine(_config()).execute(A, B)
        with record_function("test.steady"):
            engine.execute(A, B)
    return _complete_events(prof)


def _ranges(events, name=None):
    return [e for e in events if e["cat"] == "user_annotation"
            and (name is None or e["name"] == name)]


def _within(e, r):
    return r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]


def _in_partition(name):
    return name in PARTITION or name.startswith(READS)


def _top_level_ops(events, product):
    ops = sorted((e for e in events if e["cat"] == "cpu_op"
                  and _within(e, product)), key=lambda e: (e["ts"], -e["dur"]))
    top, end = [], float("-inf")
    for e in ops:
        if e["ts"] >= end:
            top.append(e)
            end = e["ts"] + e["dur"]
    return top


def test_every_partition_and_read_range_is_traced(traced):
    names = {e["name"] for e in _ranges(traced)}
    for name in PARTITION + ("sync:nprod", "sync:max", "sync:bins",
                             "sync:fall", "sync:nnz", "step_wait:setup",
                             "step_wait:numeric") + ENGINE_PHASES:
        assert name in names, name


@pytest.mark.parametrize("product", ["test.cold", "test.steady"])
def test_no_op_of_a_product_outside_the_partition(traced, product):
    (window,) = _ranges(traced, product)
    owners = [r for r in _ranges(traced) if _in_partition(r["name"])]
    outside = [e["name"] for e in _top_level_ops(traced, window)
               if e["name"] not in VIEWS
               and not any(_within(e, r) for r in owners)]
    assert outside == []


@pytest.mark.parametrize("product", ["test.cold", "test.steady"])
def test_partition_ranges_do_not_nest_and_sit_two_deep(traced, product):
    """No range of the partition lies inside another, and under the
    product at most one engine phase wraps one range of the partition."""
    (window,) = _ranges(traced, product)
    mine = [r for r in _ranges(traced) if _within(r, window)
            and r is not window]
    part = [r for r in mine if _in_partition(r["name"])]
    assert part
    for r in part:
        outer = [o["name"] for o in mine if o is not r and _within(r, o)]
        assert not any(_in_partition(o) for o in outer), (r["name"], outer)
        assert set(outer) <= set(ENGINE_PHASES) and len(outer) <= 1, \
            (r["name"], outer)


def test_range_helper_off_runs_no_torch_op_and_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("ran with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(telemetry_mod.time, "perf_counter", boom)
    assert not torch.autograd._profiler_enabled()
    assert profiler_range("hash_rungs") is NULL_SPAN
    tel = Telemetry(enabled=False)
    span = tel.span("verify_sync", sync=True)
    assert span is NULL_SPAN
    with span as s:
        s.set(hit=True)
    assert tel.start_span("request") is NULL_SPAN
    assert tel.finished_spans() == []


def test_untraced_product_runs_no_range(monkeypatch):
    """With the profiler off, a cold and a steady product of the engine
    (telemetry off) open no ``record_function`` anywhere."""
    A, B = _operands(fallback=True)
    engine = SpgemmEngine(_config())
    engine.execute(A, B)

    def boom(*a, **k):
        raise AssertionError("record_function with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    for _ in range(2):
        engine.execute(A, B)
    SpgemmEngine(_config()).execute(A, B)
    spgemm_hash.host_schedule(A, B, engine.execute(A, B).sym_binning,
                              _config().ladders()[0])


def test_profiler_on_gives_ranges_and_records_by_telemetry():
    """A disabled handle's ``with``-span is a range and no record; an
    enabled one is both, under ``range_name`` where given."""
    off, on = Telemetry(enabled=False), Telemetry(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off.span("plan_lookup") as s:
            s.set(hit=True)
        with on.span("symbolic", range_name="step_wait:symbolic"):
            pass
        kept = on.start_span("request")
        on.end_span(kept)
    names = [e["name"] for e in _ranges(_complete_events(prof))]
    assert "plan_lookup" in names and "step_wait:symbolic" in names
    assert "request" not in names and "symbolic" not in names
    assert off.finished_spans() == []
    assert [s["name"] for s in on.finished_spans()] == ["symbolic",
                                                        "request"]


@pytest.mark.parametrize("fallback", [False, True])
def test_host_syncs_count_every_wait(fallback):
    """A cold product adds ``COLD_SYNCS`` (+1 a phase with fallback rows)
    to ``host_syncs``, as many as its spans marked ``sync``; a steady
    product on the specialised plan adds 1, its verify read."""
    A, B = _operands(fallback)
    engine = SpgemmEngine(_config(), telemetry=True)
    res = engine.execute(A, B)
    want = COLD_SYNCS + (2 if fallback else 0)
    assert int(res.sym_binning.bin_size[-1] > 0) \
        + int(res.num_binning.bin_size[-1] > 0) == want - COLD_SYNCS
    assert engine.stats.host_syncs == want
    syncs = [s for s in engine.telemetry.finished_spans()
             if s["attrs"].get("sync")]
    assert len(syncs) == want
    before = engine.stats.host_syncs
    engine.execute(A, B)
    engine.execute(A, B)
    assert engine.stats.host_syncs - before == 2
    quiet = SpgemmEngine(_config())            # telemetry off: still counted
    quiet.execute(A, B)
    assert quiet.stats.host_syncs == want
    assert f"opsparse_engine_host_syncs_total {want}" in prometheus_text(quiet)


def test_read_spans_nest_under_their_phase():
    """The cold path's reads and waits are children of ``cold_steps``,
    the verify read a child of ``finalize``; the step spans keep their
    names."""
    A, B = _operands(fallback=False)
    engine = SpgemmEngine(_config(), telemetry=True)
    engine.execute(A, B)
    engine.execute(A, B)
    spans = engine.telemetry.finished_spans()
    by_id = {s["span_id"]: s for s in spans}
    parents = {(s["name"], by_id[s["parent_id"]]["name"])
               for s in spans if s["attrs"].get("sync")}
    assert parents == {(n, "cold_steps") for n in (
        "setup", "sync:nprod", "sync:max", "symbolic_binning", "sync:bins",
        "symbolic", "sync:nnz", "alloc", "numeric_binning", "numeric")} | {
        ("verify_sync", "finalize")}
