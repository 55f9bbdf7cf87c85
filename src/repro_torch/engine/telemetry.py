"""Structured tracing and metrics for the port's SpGEMM engine.

A port of ``repro/engine/telemetry.py`` (it imports nothing of the
engine, and torch only at the first profiler range, so stats, cache and
executor depend on it freely):

:class:`Telemetry`
    One handle per engine: a span tracer, a :class:`MetricsRegistry` and a
    bounded :class:`EventLog`.  Disabled by default: every span or event
    call returns at once, reads no clock and, with the profiler off, runs
    no torch op, so the steady dispatch stays free of host work; the
    registry still backs ``EngineStats`` and ``PlanStats``.

Spans
    Wall-clock intervals with explicit parent/child links and a request
    ``uid``, so nesting survives the completion-order drain.  The request
    span stays open across dispatch and finalize on the engine's record.
    Spans time the host: a span around a dispatch measures the enqueue,
    and only a span that ends in a host read (``verify_sync``) covers the
    device work before it.  A ``with``-span is also a ``torch.profiler``
    range while the profiler records, enabled or not
    (:func:`profiler_range`, the port's one range helper): the trace
    names what the host did and which range launched each device
    operation, on the trace's own clock.

Metrics
    Counters, gauges and histograms with fixed pow-2 latency buckets.

Exporters
    JSON Lines, Chrome ``trace_event`` (Perfetto; checked by
    :func:`validate_chrome_trace`) and :func:`prometheus_text`, the
    Prometheus exposition text of a whole engine: its registry (the
    engine counters, the sharding counters and the arena gauges), the
    plan-cache counters and the per-plan counters labeled by plan.
"""
from __future__ import annotations

import bisect
import itertools
import json
import subprocess
import threading
import time
from collections import deque
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

# Fixed pow-2 latency bucket edges, in seconds: 2^-14 s (~61 us) .. 2^6 s
# (64 s).  Pow-2 edges mirror every other capacity in the engine — a
# latency that moves one bucket is a real regime change, not jitter.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(2.0 ** e for e in range(-14, 7))


# ---------------------------------------------------------------------------
# Metrics: counters, gauges, pow-2 histograms, and their registry.
# ---------------------------------------------------------------------------

class Counter:
    """Monotone (by convention) numeric metric; ``value`` is plain host
    Python int/float, so accumulating device scalars can't wrap."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, v=1):
        self.value += v


class Gauge:
    """Point-in-time numeric metric (peaks, sizes)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v


class Histogram:
    """Fixed-bucket histogram (pow-2 latency edges by default).

    ``counts[i]`` counts observations with ``v <= buckets[i]`` (and above
    the previous edge); ``counts[-1]`` is the +Inf overflow bucket.
    """

    __slots__ = ("buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = LATENCY_BUCKETS_S):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        assert self.buckets, "histogram needs at least one bucket edge"
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and a Prometheus
    text renderer.  One per :class:`Telemetry` (and hence per engine)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}  # guarded-by: _lock

    def _get_or_create(self, name: str, factory):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = factory()
            return metric

    def counter(self, name: str) -> Counter:
        metric = self._get_or_create(name, Counter)
        assert isinstance(metric, Counter), name
        return metric

    def gauge(self, name: str) -> Gauge:
        metric = self._get_or_create(name, Gauge)
        assert isinstance(metric, Gauge), name
        return metric

    def histogram(self, name: str,
                  buckets: Iterable[float] = LATENCY_BUCKETS_S) -> Histogram:
        metric = self._get_or_create(name, lambda: Histogram(buckets))
        assert isinstance(metric, Histogram), name
        return metric

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready view of every metric (tests, JSONL footers)."""
        out: Dict[str, dict] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Histogram):
                out[name] = {"kind": m.kind, "buckets": list(m.buckets),
                             "counts": list(m.counts), "sum": m.sum,
                             "count": m.count}
            else:
                out[name] = {"kind": m.kind, "value": m.value}
        return out

    def render_lines(self, labels: str = "") -> List[str]:
        """Prometheus exposition lines for every registered metric.

        ``labels`` (e.g. ``plan="64x64·64x64/esc"``) is merged into each
        sample; histogram ``le`` labels compose with it.
        """
        lines: List[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(render_metric_samples(name, m, labels))
        return lines

    def render_prometheus(self) -> str:
        return "\n".join(self.render_lines()) + "\n"

    def sample_blocks(self, labels: str = ""
                      ) -> "Dict[str, Tuple[str, List[str]]]":
        """``name -> (kind, sample lines)`` for every metric, with
        ``labels`` merged into each sample: the per-source blocks that a
        scrape of several registries merges under one TYPE header each."""
        out: "Dict[str, Tuple[str, List[str]]]" = {}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            out[name] = (m.kind, render_metric_samples(name, m, labels))
        return out


def _labelset(*parts: str) -> str:
    inner = ",".join(p for p in parts if p)
    return "{" + inner + "}" if inner else ""


def render_metric_samples(name: str, metric, labels: str = "") -> List[str]:
    """Sample lines (no TYPE header) for one metric, with ``labels``
    merged in; :meth:`MetricsRegistry.render_lines` adds the header."""
    if isinstance(metric, Histogram):
        lines = []
        cum = 0
        for edge, c in zip(metric.buckets, metric.counts):
            cum += c
            le = 'le="%g"' % edge
            lines.append(f"{name}_bucket{_labelset(labels, le)} {cum}")
        le_inf = 'le="+Inf"'
        lines.append(f"{name}_bucket{_labelset(labels, le_inf)} "
                     f"{metric.count}")
        lines.append(f"{name}_sum{_labelset(labels)} {metric.sum:g}")
        lines.append(f"{name}_count{_labelset(labels)} {metric.count}")
        return lines
    return [f"{name}{_labelset(labels)} {metric.value:g}"
            if isinstance(metric.value, float)
            else f"{name}{_labelset(labels)} {metric.value}"]


def histogram_quantile(hist: Optional[Histogram], q: float
                       ) -> Optional[float]:
    """Conservative quantile estimate from a fixed-bucket histogram.

    The smallest bucket upper edge whose cumulative count covers a ``q``
    fraction of the observations (Prometheus' ``histogram_quantile``,
    rounded UP to the edge: the right bias for deadline admission).  An
    empty or missing histogram gives ``None``; observations in the +Inf
    bucket resolve to twice the top edge.
    """
    if hist is None or not hist.count:
        return None
    target = max(0.0, min(1.0, q)) * hist.count
    cum = 0
    for edge, c in zip(hist.buckets, hist.counts):
        cum += c
        if cum >= target:
            return edge
    return 2.0 * hist.buckets[-1]


def merge_sample_blocks(
        blocks_list: "Iterable[Dict[str, Tuple[str, List[str]]]]") -> str:
    """Merge per-source sample blocks into one exposition document: ONE
    ``# TYPE`` header per metric name, then every source's samples for
    that name (each source renders with its own label set)."""
    merged: "Dict[str, Tuple[str, List[str]]]" = {}
    for blocks in blocks_list:
        for name, (kind, samples) in blocks.items():
            have = merged.get(name)
            if have is None:
                merged[name] = (kind, list(samples))
            else:
                have[1].extend(samples)
    lines: List[str] = []
    for name in sorted(merged):
        kind, samples = merged[name]
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Spans and the bounded event log.
# ---------------------------------------------------------------------------

class Span:
    """One wall-clock interval with explicit parentage.

    Usable as a context manager (pushes onto the telemetry's thread-local
    stack so inner spans nest under it, and opens the span's profiler
    range, ``range_name`` or its name, for as long) or held open across
    async boundaries and closed with :meth:`Telemetry.end_span` — the
    engine keeps each request's span on its pending record until finalize.
    """

    __slots__ = ("_tel", "name", "span_id", "parent_id", "uid", "t0", "t1",
                 "attrs", "range_name", "_range")

    def __init__(self, tel: "Telemetry", name: str, span_id: int,
                 parent_id: Optional[int], uid: Optional[int], t0: float,
                 attrs: dict):
        self._tel = tel
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.uid = uid
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.range_name: Optional[str] = None
        self._range = NULL_SPAN

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tel._push(self)
        self._range = profiler_range(self.range_name or self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self._tel._pop(self)
        self._tel.end_span(self)
        return False

    def to_dict(self) -> dict:
        return {"type": "span", "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "uid": self.uid,
                "t0": self.t0, "t1": self.t1, "dur": self.dur,
                "attrs": dict(self.attrs)}


class _NullSpan:
    """The disabled-mode span: a shared, attribute-frozen no-op."""

    __slots__ = ()
    name = None
    span_id = None
    parent_id = None
    uid = None
    t0 = 0.0
    t1 = None
    dur = 0.0

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

_torch = None   # the torch module, imported at the first range


def profiler_range(name: str):
    """A ``torch.profiler.record_function(name)`` range while the profiler
    records, else :data:`NULL_SPAN`.

    The one range helper of the port: the engine's ``with``-spans and the
    drivers' ranges all open theirs here, so a range lands in the
    profiler's trace, on its clock, and a run that is not traced pays one
    bool check (``torch.autograd._profiler_enabled()``) and no torch op.
    torch is imported at the first call, so this module loads without it.
    """
    global _torch
    if _torch is None:
        import torch as _torch
    if not _torch.autograd._profiler_enabled():
        return NULL_SPAN
    return _torch.profiler.record_function(name)


class _RangeSpan(_NullSpan):
    """A disabled handle's ``with``-span while the profiler records: the
    span's profiler range, and no record."""

    __slots__ = ("_range",)

    def __init__(self, rng):
        self._range = rng

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)


class EventLog:
    """Bounded ring buffer of telemetry records with overflow accounting:
    the oldest record is dropped when full, and ``dropped`` says how many
    were lost (silent truncation would read as "covered everything")."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self.appended = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=self.capacity)  # guarded-by: _lock

    def append(self, item) -> None:
        """Append a record: a dict, or a closed :class:`Span` (kept as-is
        and rendered to a dict lazily at :meth:`snapshot` — dict-building
        is the dominant per-span cost on the engine hot path)."""
        with self._lock:
            self.appended += 1
            self._buf.append(item)

    @property
    def dropped(self) -> int:
        return self.appended - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = list(self._buf)
        return [it.to_dict() if isinstance(it, Span) else it for it in items]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.appended = 0


# ---------------------------------------------------------------------------
# The telemetry handle.
# ---------------------------------------------------------------------------

class Telemetry:
    """Tracer + metrics registry + event ring buffer for one engine.

    ``enabled=False`` (the default the engine resolves to) makes every
    span/event call a no-op returning the shared :data:`NULL_SPAN` —
    the metrics registry still works (the engine's counters are backed
    by it), but nothing is recorded and no clock is read.
    """

    def __init__(self, enabled: bool = True, *, events_capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events = EventLog(events_capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- span stack (thread-local synchronous nesting) ----------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- recording ----------------------------------------------------------
    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   uid: Optional[int] = None, **attrs):
        """Open a span to keep and :meth:`end_span` later (async
        finalize): a record, and no profiler range.  With no explicit
        ``parent`` the current thread's innermost ``with``-span is the
        parent; ``uid`` defaults to the parent's."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None or isinstance(parent, _NullSpan):
            parent = self.current_span()
        return Span(self, name, next(self._ids),
                    parent.span_id if parent is not None else None,
                    uid if uid is not None
                    else (parent.uid if parent is not None else None),
                    time.perf_counter(), attrs)

    def span(self, name: str, *, parent: Optional[Span] = None,
             uid: Optional[int] = None, range_name: Optional[str] = None,
             **attrs):
        """Open a span for a ``with`` block: a record (as
        :meth:`start_span`) and, while ``torch.profiler`` records, a range
        named ``range_name`` or ``name`` (:func:`profiler_range`).  A
        disabled handle records nothing: it gives the range alone, or,
        with the profiler off, :data:`NULL_SPAN` (no clock, no torch
        op)."""
        if not self.enabled:
            rng = profiler_range(range_name or name)
            return rng if rng is NULL_SPAN else _RangeSpan(rng)
        span = self.start_span(name, parent=parent, uid=uid, **attrs)
        span.range_name = range_name
        return span

    def end_span(self, span, **attrs) -> None:
        """Close an open span and commit it to the event log (idempotent;
        no-op for the disabled-mode NULL span)."""
        if not isinstance(span, Span):
            return
        if span.t1 is not None:
            return
        span.t1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        self.events.append(span)

    def event(self, name: str, *, uid: Optional[int] = None, **attrs) -> None:
        """Record a point event (overflow, trim, policy decision, ...)."""
        if not self.enabled:
            return
        self.events.append({"type": "event", "name": name,
                            "t": time.perf_counter(), "uid": uid,
                            "attrs": attrs})

    # -- views ---------------------------------------------------------------
    def finished_spans(self) -> List[dict]:
        return [e for e in self.events.snapshot() if e.get("type") == "span"]

    # -- exporters ------------------------------------------------------------
    def export_jsonl(self, path) -> int:
        """Write the event log as JSON Lines; returns lines written."""
        items = self.events.snapshot()
        with open(path, "w") as f:
            for item in items:
                f.write(json.dumps(item, default=str) + "\n")
        return len(items)

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` payload (Perfetto / ``chrome://tracing``).

        Spans become ``"X"`` complete events with microsecond timestamps
        rebased to the earliest record; each request uid gets its own
        ``tid`` track (engine-level spans ride track 0), so cold vs
        steady requests are visually separable.
        Explicit ``span_id``/``parent_id`` ride in ``args``.
        """
        items = self.events.snapshot()
        t_min = min((it.get("t0", it.get("t", 0.0)) for it in items),
                    default=0.0)

        def us(t):
            return round((t - t_min) * 1e6, 3)

        trace_events = []
        for it in items:
            tid = it.get("uid")
            tid = 0 if tid is None else int(tid) + 1
            if it.get("type") == "span":
                trace_events.append({
                    "name": it["name"], "ph": "X", "ts": us(it["t0"]),
                    "dur": round(max(it["dur"], 0.0) * 1e6, 3),
                    "pid": 1, "tid": tid,
                    "args": {"span_id": it["span_id"],
                             "parent_id": it["parent_id"],
                             "uid": it["uid"], **it["attrs"]}})
            else:
                trace_events.append({
                    "name": it["name"], "ph": "i", "ts": us(it["t"]),
                    "s": "t", "pid": 1, "tid": tid,
                    "args": {"uid": it.get("uid"), **it["attrs"]}})
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> dict:
        payload = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        return payload


def resolve_telemetry(arg: Union["Telemetry", bool, None]) -> "Telemetry":
    """Engine-constructor sugar: ``None``/``False`` -> a fresh disabled
    handle (per-engine, so registries never alias), ``True`` -> a fresh
    enabled one, a :class:`Telemetry` -> itself."""
    if isinstance(arg, Telemetry):
        return arg
    return Telemetry(enabled=bool(arg))


# A shared do-nothing handle for call sites that only *emit* (events from
# the cache when no engine telemetry was threaded through).
# Never hand its registry to stats objects — it is process-global.
NULL = Telemetry(enabled=False, events_capacity=1)


# ---------------------------------------------------------------------------
# Chrome trace_event schema validation.
# ---------------------------------------------------------------------------

_ALLOWED_PH = {"X", "B", "E", "i", "I", "M", "C"}


def validate_chrome_trace(payload_or_path) -> int:
    """Validate a Chrome ``trace_event`` payload (or a file holding one);
    returns the event count.

    Checks the container, each event's required fields, known phase
    types, a non-negative ``dur`` on ``"X"`` complete events, and matched
    ``B``/``E`` pairs per ``(pid, tid)`` track.  Raises
    :class:`ValueError` on the first violation.
    """
    payload = payload_or_path
    if isinstance(payload, (str, Path)):
        with open(payload) as f:
            payload = json.load(f)
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("trace payload must be an object with 'traceEvents'")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    open_be: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing '{field}'")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} 'ts' is not numeric")
        ph = ev["ph"]
        if ph not in _ALLOWED_PH:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        track = (ev["pid"], ev["tid"])
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} ('X') needs numeric dur >= 0")
        elif ph == "B":
            open_be[track] = open_be.get(track, 0) + 1
        elif ph == "E":
            depth = open_be.get(track, 0)
            if depth <= 0:
                raise ValueError(f"event {i}: 'E' without matching 'B' "
                                 f"on track {track}")
            open_be[track] = depth - 1
    unbalanced = {k: v for k, v in open_be.items() if v}
    if unbalanced:
        raise ValueError(f"unmatched 'B' events on tracks {unbalanced}")
    return len(events)


# ---------------------------------------------------------------------------
# Stamps for measurement artifacts.
# ---------------------------------------------------------------------------

# Timezone-aware UTC ISO-8601 with seconds precision and the literal 'Z'
# suffix (the reference's benchmark-artifact format).
UTC_TIMESTAMP_FORMAT = "%Y-%m-%dT%H:%M:%SZ"


def utc_now_iso() -> str:
    """Timezone-aware UTC timestamp in :data:`UTC_TIMESTAMP_FORMAT`."""
    return datetime.now(timezone.utc).strftime(UTC_TIMESTAMP_FORMAT)


def git_rev(cwd=None) -> str:
    """Short git revision of ``cwd`` (or the working directory);
    ``"unknown"`` outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=str(cwd) if cwd is not None else None,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            timeout=10, check=True)
        rev = out.stdout.decode().strip()
        return rev or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ---------------------------------------------------------------------------
# Prometheus text for a whole engine.
# ---------------------------------------------------------------------------

def engine_sample_blocks(engine, labels: str = ""
                         ) -> "Dict[str, Tuple[str, List[str]]]":
    """Sample blocks (``name -> (kind, lines)``) for one engine.

    The engine registry (EngineStats counters, the sharding counters, the
    latency histograms, the arena gauges), the plan-cache counters, the
    per-plan counters labeled by plan, and the event-log accounting, with
    ``labels`` (e.g. ``tenant="acme"``) merged into every sample.  The
    arena gauges are refreshed first, so an engine idle since its last
    lease reports the arena as it is now.  A multi-tenant front end merges
    one block set per engine with :func:`merge_sample_blocks`.
    """
    tel = engine.telemetry
    cache = engine.cache
    refresh = getattr(engine, "_update_arena_gauges", None)
    if refresh is not None:
        refresh()
    blocks = tel.registry.sample_blocks(labels)

    for name, kind, value in (
            ("opsparse_plan_cache_hits_total", "counter", cache.hits),
            ("opsparse_plan_cache_misses_total", "counter", cache.misses),
            ("opsparse_plan_cache_evictions_total", "counter",
             cache.evictions),
            ("opsparse_plan_cache_size", "gauge", len(cache)),
            ("opsparse_plan_cache_capacity", "gauge", cache.capacity),
            ("opsparse_telemetry_events_appended_total", "counter",
             tel.events.appended),
            ("opsparse_telemetry_events_dropped_total", "counter",
             tel.events.dropped),
    ):
        blocks.setdefault(name, (kind, []))[1].append(
            f"{name}{_labelset(labels)} {value}")

    # Per-plan counters: a sample per plan label under one shared name.
    entries = list(cache.items())
    if entries:
        from .stats import PlanStats, plan_label  # here: stats imports us
        for _, entry in entries:
            label = ",".join(p for p in (
                labels, f'plan="{plan_label(entry.plan)}"') if p)
            for field in PlanStats._COUNTERS:
                name = entry.stats.metric_name(field)
                blocks.setdefault(name, ("counter", []))[1].extend(
                    render_metric_samples(
                        name, entry.stats.metric(field), label))
    return blocks


def prometheus_text(engine) -> str:
    """Prometheus exposition text for one engine (the single-tenant view:
    :func:`engine_sample_blocks` with no labels), what a ``/metrics``
    endpoint returns verbatim."""
    return merge_sample_blocks([engine_sample_blocks(engine)])
