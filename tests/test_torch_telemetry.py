"""The reference's telemetry tests (``tests/test_telemetry.py``) on the
port, on the CPU: registry-backed stats (counter names, histogram bucket
edges), spans and their nesting under the sharded fan-out, ring-buffer
overflow accounting, the exporters (JSONL parses, Chrome trace_event
validates, Prometheus text), the disabled-mode no-op guarantee, the
empty-state edge cases of ``stats.render()``, and the artifact stamps.

Only the imports and ``device="cpu"`` differ from the reference's cases
(and ``git_rev`` is asked about this checkout, wherever it lies).  Added:
the sharded engine's span names and counts, the quantile and the merge of
sample blocks, each against the reference's on the same inputs.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import csr as jcsr
from repro.core.spgemm import SpgemmConfig as JConfig
from repro import engine as jengine
from repro.engine import telemetry as jtelemetry
from repro_torch.core import SpgemmConfig, random_csr
from repro_torch.engine import (LATENCY_BUCKETS_S, EngineStats, EventLog,
                                MetricsRegistry, PlanStats, SpgemmEngine,
                                Telemetry, engine_sample_blocks,
                                histogram_quantile, merge_sample_blocks,
                                plan_label, prometheus_text, render,
                                resolve_telemetry, validate_chrome_trace)
from repro_torch.engine import stats as stats_mod
from repro_torch.engine.telemetry import (NULL_SPAN, UTC_TIMESTAMP_FORMAT,
                                          git_rev, utc_now_iso)

REPO = Path(__file__).resolve().parent.parent


def _pair(seed, m=32, k=28, n=36, avg=3.0):
    A = random_csr(seed, m, k, avg_nnz_per_row=avg, device="cpu")
    B = random_csr(seed + 1, k, n, avg_nnz_per_row=avg, device="cpu")
    return A, B


@pytest.fixture(scope="module")
def traced_engine():
    """One traced engine that served a small unsharded stream."""
    tel = Telemetry(enabled=True)
    engine = SpgemmEngine(SpgemmConfig(method="esc"), telemetry=tel)
    A, B = _pair(0)
    for _ in range(3):
        engine.submit(A, B)
    results = engine.drain()
    assert len(results) == 3
    return engine


@pytest.fixture(scope="module")
def sharded_traced_engine():
    """One traced engine that served a stream with shards=2 fan-out."""
    tel = Telemetry(enabled=True)
    engine = SpgemmEngine(SpgemmConfig(method="esc"), shards=2,
                          telemetry=tel)
    A, B = _pair(10, m=48, k=40, n=40)
    for _ in range(2):
        engine.submit(A, B)
    results = engine.drain()
    assert len(results) == 2
    return engine


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

def test_registry_get_or_create_and_kinds():
    reg = MetricsRegistry()
    c = reg.counter("x_total")
    c.inc()
    c.inc(2)
    assert reg.counter("x_total") is c and c.value == 3
    g = reg.gauge("y")
    g.set(7)
    assert reg.get("y").value == 7
    h = reg.histogram("z_seconds")
    assert reg.get("missing") is None
    snap = reg.snapshot()
    assert snap["x_total"] == {"kind": "counter", "value": 3}
    assert snap["z_seconds"]["kind"] == "histogram"
    # A name registered as one kind cannot be fetched as another.
    with pytest.raises(AssertionError):
        reg.gauge("x_total")


def test_histogram_pow2_bucket_edges():
    # The fixed ladder is 2^-14 .. 2^6 seconds, strictly doubling.
    assert LATENCY_BUCKETS_S[0] == 2.0 ** -14
    assert LATENCY_BUCKETS_S[-1] == 2.0 ** 6
    assert all(b == 2 * a for a, b in zip(LATENCY_BUCKETS_S,
                                          LATENCY_BUCKETS_S[1:]))
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds")
    h.observe(2.0 ** -14)        # lands exactly ON the first edge
    h.observe(0.5)
    h.observe(1e9)               # +Inf overflow bucket
    assert h.count == 3
    assert h.counts[0] == 1      # on-edge observation is <= the edge
    assert h.counts[-1] == 1     # overflow accounted
    assert h.mean == pytest.approx((2.0 ** -14 + 0.5 + 1e9) / 3)
    # Prometheus rendering: cumulative buckets, le="+Inf" is the count.
    lines = reg.render_lines()
    assert "# TYPE lat_seconds histogram" in lines
    assert any(line.startswith('lat_seconds_bucket{le="+Inf"} 3')
               for line in lines)
    assert "lat_seconds_count 3" in lines


def test_empty_histogram_renders_without_division():
    reg = MetricsRegistry()
    reg.histogram("empty_seconds")
    assert reg.get("empty_seconds").mean == 0.0
    text = reg.render_prometheus()
    assert "empty_seconds_count 0" in text


# ---------------------------------------------------------------------------
# Registry-backed stats (the subsume-not-duplicate satellite).
# ---------------------------------------------------------------------------

def test_engine_stats_fields_are_registry_metrics():
    s = EngineStats()
    s.requests += 2
    s.peak_inflight = 5
    # The attribute and the registry metric are ONE number.
    assert s.registry.get("opsparse_engine_requests_total").value == 2
    assert s.registry.get("opsparse_engine_peak_inflight").value == 5
    # Every declared field resolves to a prefixed metric name.
    for field in EngineStats._COUNTERS:
        assert EngineStats.metric_name(field).startswith("opsparse_engine_")
        assert EngineStats.metric_name(field).endswith("_total")


def test_plan_stats_metric_names():
    s = PlanStats()
    s.time_s += 0.25
    assert s.registry.get("opsparse_plan_time_seconds_total").value == 0.25
    assert PlanStats.metric_name("calls") == "opsparse_plan_calls_total"


def test_stats_reset_clears_trace_counters():
    stats_mod.record_trace("some-plan-key")
    assert stats_mod.total_traces() >= 1
    stats_mod.reset()
    assert stats_mod.total_traces() == 0
    assert stats_mod.traces_for("some-plan-key") == 0


# ---------------------------------------------------------------------------
# Spans and the event log.
# ---------------------------------------------------------------------------

def test_span_nesting_and_uid_inheritance():
    tel = Telemetry(enabled=True)
    with tel.span("outer", uid=7) as outer:
        with tel.span("inner") as inner:
            assert tel.current_span() is inner
        tel.event("ping")
    spans = tel.finished_spans()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    inner_d, outer_d = spans
    assert inner_d["parent_id"] == outer_d["span_id"]
    assert inner_d["uid"] == 7            # inherited from the parent
    assert outer_d["parent_id"] is None
    assert all(s["dur"] >= 0 for s in spans)
    events = [e for e in tel.events.snapshot() if e["type"] == "event"]
    assert events[0]["name"] == "ping"


def test_end_span_is_idempotent():
    tel = Telemetry(enabled=True)
    span = tel.start_span("once")
    tel.end_span(span)
    t1 = span.t1
    tel.end_span(span)
    assert span.t1 == t1
    assert len(tel.finished_spans()) == 1


def test_event_log_ring_overflow_accounting():
    log = EventLog(capacity=4)
    for i in range(10):
        log.append({"i": i})
    assert len(log) == 4
    assert log.appended == 10
    assert log.dropped == 6
    assert [e["i"] for e in log.snapshot()] == [6, 7, 8, 9]
    log.clear()
    assert len(log) == 0 and log.appended == 0 and log.dropped == 0


def test_disabled_mode_is_a_noop():
    tel = resolve_telemetry(None)
    assert not tel.enabled
    span = tel.span("anything", uid=1)
    assert span is NULL_SPAN
    with span as s:
        assert s.set(x=1) is s
    tel.end_span(span)
    tel.event("nothing", uid=2)
    assert len(tel.events) == 0 and tel.events.appended == 0
    assert tel.finished_spans() == []
    # resolve_telemetry never aliases registries across engines.
    assert resolve_telemetry(None).registry is not tel.registry
    assert resolve_telemetry(tel) is tel
    assert resolve_telemetry(True).enabled


# ---------------------------------------------------------------------------
# Engine integration: nested request pipeline spans.
# ---------------------------------------------------------------------------

def test_engine_spans_cover_the_pipeline(traced_engine):
    spans = traced_engine.telemetry.finished_spans()
    names = {s["name"] for s in spans}
    for required in ("drain", "request", "plan_lookup", "cold_steps",
                     "symbolic", "numeric", "dispatch", "verify_sync",
                     "finalize"):
        assert required in names, f"missing span {required!r}"
    by_id = {s["span_id"]: s for s in spans}
    # plan_lookup always nests under its request; kernel phases under
    # cold_steps; verify_sync under finalize.
    for child, parent in (("plan_lookup", "request"),
                          ("symbolic", "cold_steps"),
                          ("numeric", "cold_steps"),
                          ("verify_sync", "finalize")):
        cs = [s for s in spans if s["name"] == child]
        assert cs, child
        assert all(by_id[s["parent_id"]]["name"] == parent for s in cs)
    # Request latency histogram observed one sample per request.
    hist = traced_engine.telemetry.registry.get(
        "opsparse_request_latency_seconds")
    assert hist.count == traced_engine.stats.requests == 3


def test_plan_cache_lifecycle_events():
    tel = Telemetry(enabled=True)
    engine = SpgemmEngine(SpgemmConfig(method="esc"), cache_capacity=1,
                          telemetry=tel)
    A, B = _pair(20)
    engine.execute(A, B)
    A2, B2 = _pair(22, m=16, k=16, n=16)
    engine.execute(A2, B2)          # evicts the first plan (capacity 1)
    events = {e["name"] for e in tel.events.snapshot()
              if e["type"] == "event"}
    assert {"plan_insert", "plan_specialize", "plan_evict"} <= events


# ---------------------------------------------------------------------------
# Exporters.
# ---------------------------------------------------------------------------

def test_jsonl_export_parses(traced_engine, tmp_path):
    path = tmp_path / "events.jsonl"
    n = traced_engine.telemetry.export_jsonl(path)
    lines = path.read_text().splitlines()
    assert len(lines) == n > 0
    rows = [json.loads(line) for line in lines]
    assert all(row["type"] in ("span", "event") for row in rows)


# ---------------------------------------------------------------------------
# render() guards + consumers.
# ---------------------------------------------------------------------------

def test_render_zero_state_has_no_division_errors():
    engine = SpgemmEngine(SpgemmConfig(method="esc"))
    out = render(engine)
    assert "0 requests" in out and "hit rate 0.0%" in out


def test_render_unspecialized_plan_and_telemetry_lines():
    tel = Telemetry(enabled=True)
    engine = SpgemmEngine(SpgemmConfig(method="esc"), telemetry=tel)
    # An inserted-but-never-executed plan has no buckets/policy/schedule.
    from repro_torch.engine import MatrixSig, plan
    A, B = _pair(30)
    engine.cache.insert(plan(MatrixSig.of(A), MatrixSig.of(B),
                             engine.config))
    out = render(engine)
    assert "prod=None" in out
    assert "telemetry:" in out           # enabled engines report the ring
    engine.execute(A, B)
    out = render(engine)
    assert "latency: 1 finalized requests" in out
    assert plan_label(engine.cache.items()[0][1].plan) in out


# ---------------------------------------------------------------------------
# The sharded fan-out's spans.
# ---------------------------------------------------------------------------

def test_engine_sharded_fanout_span_nesting(sharded_traced_engine):
    spans = sharded_traced_engine.telemetry.finished_spans()
    names = {s["name"] for s in spans}
    assert {"partition", "shard", "verify_slices", "shard_merge"} <= names
    request_ids = {s["span_id"] for s in spans if s["name"] == "request"}
    shard_spans = [s for s in spans if s["name"] == "shard"]
    # Two requests x two shards, each shard span a child of ITS request.
    assert len(shard_spans) == 4
    assert all(s["parent_id"] in request_ids for s in shard_spans)
    assert {s["attrs"]["shard"] for s in shard_spans} == {0, 1}
    # Shard sub-dispatches must not inflate the request histogram.
    hist = sharded_traced_engine.telemetry.registry.get(
        "opsparse_request_latency_seconds")
    assert hist.count == sharded_traced_engine.stats.requests == 2


def test_sharded_span_counts_equal_reference(sharded_traced_engine):
    """The reference's engine, fed the same stream, records the same
    sharding spans (as many of each) and the same sharding counters."""
    tel = jtelemetry.Telemetry(enabled=True)
    jeng = jengine.SpgemmEngine(JConfig(method="esc"), shards=2,
                                telemetry=tel)
    jA = jcsr.random_csr(10, 48, 40, avg_nnz_per_row=3.0)
    jB = jcsr.random_csr(11, 40, 40, avg_nnz_per_row=3.0)
    for _ in range(2):
        jeng.submit(jA, jB)
    assert len(jeng.drain()) == 2
    names = ("request", "shard", "partition", "verify_slices",
             "shard_merge", "drain", "finalize")

    def counts(spans):
        return {n: sum(1 for s in spans if s["name"] == n) for n in names}

    assert counts(sharded_traced_engine.telemetry.finished_spans()) \
        == counts(tel.finished_spans())
    for field in ("requests", "sharded_requests", "shard_grows",
                  "auto_requests", "policy_revisions"):
        assert getattr(sharded_traced_engine.stats, field) \
            == getattr(jeng.stats, field), field


# ---------------------------------------------------------------------------
# Exporters.
# ---------------------------------------------------------------------------

def test_chrome_trace_export_validates(traced_engine, tmp_path):
    path = tmp_path / "trace.json"
    payload = traced_engine.telemetry.export_chrome_trace(path)
    assert validate_chrome_trace(payload) == len(payload["traceEvents"])
    assert validate_chrome_trace(path) > 0       # re-read from disk
    # "X" complete events carry rebased non-negative microsecond stamps.
    xs = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)
    # Parentage rides in args so Perfetto queries can rebuild the tree.
    assert all("span_id" in e["args"] for e in xs)


def test_sharded_chrome_trace_validates(sharded_traced_engine, tmp_path):
    payload = sharded_traced_engine.telemetry.export_chrome_trace(
        tmp_path / "sharded.json")
    assert validate_chrome_trace(payload) == len(payload["traceEvents"])
    assert {"shard", "shard_merge"} <= {e["name"]
                                        for e in payload["traceEvents"]}


def test_validate_chrome_trace_rejects_bad_payloads():
    with pytest.raises(ValueError):
        validate_chrome_trace([])                    # wrong container
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X"}]})  # missing req
    bad_dur = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "pid": 1, "tid": 1, "dur": -1}]}
    with pytest.raises(ValueError):
        validate_chrome_trace(bad_dur)
    unmatched = {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1}]}
    with pytest.raises(ValueError):
        validate_chrome_trace(unmatched)
    matched = {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
        {"name": "a", "ph": "E", "ts": 1, "pid": 1, "tid": 1}]}
    assert validate_chrome_trace(matched) == 2


def test_prometheus_text_content(traced_engine):
    text = prometheus_text(traced_engine)
    assert "# TYPE opsparse_engine_requests_total counter" in text
    assert "opsparse_engine_requests_total 3" in text
    assert "opsparse_plan_cache_hits_total" in text
    assert "opsparse_request_latency_seconds_bucket" in text
    # Per-plan samples are labeled; exactly ONE TYPE header per name.
    assert 'opsparse_plan_calls_total{plan="' in text
    assert text.count("# TYPE opsparse_plan_calls_total counter") == 1
    # Exposition text must not contain blank samples.
    assert all(line.startswith("#") or " " in line
               for line in text.strip().splitlines())


def test_prometheus_text_empty_engine():
    engine = SpgemmEngine(SpgemmConfig(method="esc"))
    text = prometheus_text(engine)
    assert "opsparse_engine_requests_total 0" in text
    assert "opsparse_plan_cache_size 0" in text


def test_prometheus_text_sharding_and_arena(sharded_traced_engine):
    """The sharded engine's scrape carries the sharding counters, the
    arena gauges (refreshed at the scrape) and the parent plan's label;
    every sample line parses as ``name{labels} value`` under one TYPE
    header per name."""
    text = prometheus_text(sharded_traced_engine)
    assert "opsparse_engine_sharded_requests_total 2" in text
    assert "opsparse_engine_shard_grows_total 0" in text
    assert "# TYPE opsparse_arena_bytes_reserved gauge" in text
    arena = sharded_traced_engine.arena
    assert f"opsparse_arena_bytes_reserved {arena.bytes_reserved}" in text
    assert "/sh2" in text
    typed = set()
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert name not in typed and kind in ("counter", "gauge",
                                                  "histogram")
            typed.add(name)
            continue
        sample, value = line.rsplit(" ", 1)
        float(value)
        base = sample.split("{")[0]
        assert any(base == n or base.startswith(n + "_") for n in typed)
        if "{" in sample:
            assert sample.endswith("}")


def test_engine_sample_blocks_merge_under_one_header(traced_engine,
                                                     sharded_traced_engine):
    text = merge_sample_blocks([
        engine_sample_blocks(traced_engine, 'tenant="a"'),
        engine_sample_blocks(sharded_traced_engine, 'tenant="b"')])
    assert text.count("# TYPE opsparse_engine_requests_total counter") == 1
    assert 'opsparse_engine_requests_total{tenant="a"} 3' in text
    assert 'opsparse_engine_requests_total{tenant="b"} 2' in text


def test_merge_sample_blocks_equals_reference():
    blocks = [{"x_total": ("counter", ['x_total{t="a"} 1']),
               "g": ("gauge", ['g{t="a"} 2'])},
              {"x_total": ("counter", ['x_total{t="b"} 3'])}]
    assert merge_sample_blocks(blocks) \
        == jtelemetry.merge_sample_blocks(blocks)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_equals_reference(q):
    reg, jreg = MetricsRegistry(), jtelemetry.MetricsRegistry()
    h, jh = reg.histogram("lat_seconds"), jreg.histogram("lat_seconds")
    assert histogram_quantile(h, q) is None       # empty: admit blind
    assert histogram_quantile(None, q) is None
    for v in np.random.default_rng(5).exponential(0.01, 200).tolist() \
            + [100.0]:                            # one in the +Inf bucket
        h.observe(v)
        jh.observe(v)
    got = histogram_quantile(h, q)
    assert got == jtelemetry.histogram_quantile(jh, q)
    assert got in LATENCY_BUCKETS_S or got == 2.0 * LATENCY_BUCKETS_S[-1]


def test_plan_label_shapes_and_shards():
    from repro_torch.engine import MatrixSig, plan
    A, B = _pair(40)
    p = plan(MatrixSig.of(A), MatrixSig.of(B), SpgemmConfig(method="hash"))
    label = plan_label(p)
    assert label.startswith(f"{A.nrows}x{A.ncols}")
    assert label.endswith("/hash")
    p2 = plan(MatrixSig.of(A), MatrixSig.of(B),
              SpgemmConfig(method="esc", shards=2))
    assert plan_label(p2).endswith("/sh2")


# ---------------------------------------------------------------------------
# Artifact stamps.
# ---------------------------------------------------------------------------

def test_utc_timestamp_and_git_rev():
    ts = utc_now_iso()
    assert ts.endswith("Z") and "T" in ts and len(ts) == 20
    assert UTC_TIMESTAMP_FORMAT == jtelemetry.UTC_TIMESTAMP_FORMAT
    rev = git_rev(REPO)            # a revision, or "unknown" off-git
    assert isinstance(rev, str) and rev
    assert git_rev("/") == "unknown"         # not a git repository
