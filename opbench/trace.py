"""Reduction of a ``torch.profiler`` trace (Chrome trace format, as
``export_chrome_trace`` writes it) to what the per-layer metrics read.

A traced run records a sample of the window's products: cycles of
``active`` products, each after ``3 * active - 1`` untraced ones and one
the profiler warms up on, so about a quarter of the window is traced and
no trace holds more than about a second of work.  Each cycle's trace is
reduced as it comes and deleted; the summaries add up.  The traced
window is the time inside the traced products (the harness's
``opbench.product`` range): the harness's own steps between products
are left out.  Device operations are kernels, copies and fills.  A
device operation belongs to a profiler range when the host call that
launched it (linked by its correlation id) ran inside that range on the
same thread; every range the trace holds is reduced, so a range the
program adds is read by a metric with no change here.  The device is
busy where any device operation runs; an idle gap is named by what the
products' thread was doing at its middle: the ranges and the innermost
host call open there.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

PRODUCT = "opbench.product"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    products: int                         # products traced
    range_device_s: Dict[str, float]      # device seconds a range launched
    op_device_s: Dict[str, float]         # device seconds by operation name
    idle_by_host: Dict[str, float]        # idle seconds by host activity
    unlinked_ops: int                     # device ops with no launch found

    def __add__(self, other: "TraceSummary") -> "TraceSummary":
        def add(a, b):
            out = defaultdict(float, a)
            for k, v in b.items():
                out[k] += v
            return dict(out)
        return TraceSummary(
            self.window_s + other.window_s, self.busy_s + other.busy_s,
            self.products + other.products,
            add(self.range_device_s, other.range_device_s),
            add(self.op_device_s, other.op_device_s),
            add(self.idle_by_host, other.idle_by_host),
            self.unlinked_ops + other.unlinked_ops)

    def device_s_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.op_device_s.items()
                   if rx.search(name))

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.op_device_s),
                "idle_gaps": top(self.idle_by_host)}


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list (template arguments kept), cut to ``NAME_CHARS``."""
    name = re.sub(r"^void ", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:NAME_CHARS]
    return name[:NAME_CHARS]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _intersect(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys):
    """The parts of the intervals ``xs`` that no interval of ``ys``
    covers (both sorted and disjoint)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, start = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > start:
                out.append((start, ys[k][0]))
            start = max(start, ys[k][1])
            k += 1
        if start < b:
            out.append((start, b))
    return out


def summarize(events: Iterable[dict]) -> Optional[TraceSummary]:
    """The summary of one trace's events, or None where it holds no
    whole product."""
    window, products = None, 0
    device, launches, host = [], {}, defaultdict(list)
    annotations = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, args.get("correlation")))
            continue
        tid = ev.get("tid")
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (tid, ts)
        if cat == "user_annotation":
            if name == PRODUCT:
                products += 1
                window = (ts, ts + dur, tid) if window is None else (
                    min(window[0], ts), max(window[1], ts + dur), tid)
            annotations[name].append((ts, ts + dur, tid))
        if cat in HOST_CATS:
            host[tid].append((ts, ts + dur, name))
    if window is None:
        return None
    w0, w1, wtid = window
    inside = [(max(a, w0), min(b, w1), name, corr)
              for a, b, name, corr in device if b > w0 and a < w1]
    spans_of_products = _union([(a, b) for a, b, _ in
                                annotations[PRODUCT]])
    busy = _intersect(_union([(a, b) for a, b, _, _ in inside]),
                      spans_of_products)
    busy_us = sum(b - a for a, b in busy)

    ops: Dict[str, float] = defaultdict(float)
    for a, b, name, _ in inside:
        ops[short_name(name)] += (b - a) * 1e-6

    per_range: Dict[str, float] = {}
    unlinked = sum(1 for *_, corr in inside if corr not in launches)
    for rname, marks in annotations.items():
        if rname == PRODUCT:
            continue
        spans = defaultdict(list)
        for a, b, tid in marks:
            spans[tid].append((a, b))
        starts = {tid: ([a for a, _ in _union(v)], _union(v))
                  for tid, v in spans.items()}
        total = 0.0
        for a, b, _, corr in inside:
            launch = launches.get(corr)
            if launch is None or launch[0] not in starts:
                continue
            firsts, merged = starts[launch[0]]
            i = bisect.bisect_right(firsts, launch[1]) - 1
            if i >= 0 and merged[i][0] <= launch[1] <= merged[i][1]:
                total += (b - a) * 1e-6
        per_range[rname] = total

    gaps = _subtract(spans_of_products, busy)
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, _host_at(host.get(wtid, []),
                                            [(a + b) / 2 for a, b in gaps])):
        idle[label] += (b - a) * 1e-6
    window_us = sum(b - a for a, b in spans_of_products)
    return TraceSummary(window_us * 1e-6, busy_us * 1e-6, products,
                        per_range, dict(ops), dict(idle), unlinked)


def _host_at(events: List[Tuple[float, float, str]],
             points: List[float]) -> List[str]:
    """For each time point, the host calls open there on one thread: the
    ranges and the innermost call, joined by " > "."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    labels = [""] * len(points)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(events) and events[j][0] <= t:
            while stack and stack[-1][1] <= events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        open_ = [e for e in stack if e[1] >= t]
        if not open_:
            labels[i] = "host: no call open"
            continue
        names = [e[2] for e in open_[:-1]
                 if not e[2].startswith(("aten::", "ProfilerStep#"))]
        names.append(open_[-1][2])
        labels[i] = " > ".join(dict.fromkeys(names))[:160]
    return labels


def trace_window(run, *, active: int = 1):
    """``run(step)`` under ``torch.profiler`` (host and device), where
    ``run`` calls ``step()`` after each product; returns ``(run's value,
    TraceSummary or None)``.  Cycles of ``active`` products are traced;
    each cycle's trace goes through a file under ``TMPDIR`` and is
    deleted once reduced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    parts: List[TraceSummary] = []

    def ready(prof):
        fd, path = tempfile.mkstemp(prefix="opbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        part = summarize(events)
        if part is not None:
            parts.append(part)

    cycle = schedule(wait=3 * active - 1, warmup=1, active=active)
    with profile(activities=acts, schedule=cycle,
                 on_trace_ready=ready) as prof:
        out = run(prof.step)
    total = None
    for part in parts:
        total = part if total is None else total + part
    return out, total
